"""Build the port's CUDA sources into plain-C shared libraries.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/<hash>/lib<name>.so`` under the repository root, keyed by
a hash of the source and the flags, at first use. No PyTorch headers are
involved (the library exports ``extern "C"`` entry points loaded with
``ctypes``), which keeps a cold build to seconds. Nothing here runs at
import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: -fmad=false: the score arithmetic must round op for op like the plain
#: torch version on the card (no FMA contraction); no fast-math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


@dataclass(frozen=True)
class BuiltLibrary:
    path: Path
    log: str          # nvcc/ptxas output of the build (registers, spills)
    cached: bool      # True when an earlier build of the same key served


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                       "build the port's kernels")


def build_library(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (or reuse the build of the same key)."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / f"lib{name}.so"
    log_path = out_dir / f"{name}.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuiltLibrary(lib, log, cached=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build into a temporary name, then rename: a concurrent build or
    # an interrupted build never leaves a half-written library behind
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuiltLibrary(lib, log, cached=False)
