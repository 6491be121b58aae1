"""Artifact fetching into task directories.

Reference behavior: client/allocrunner/taskrunner/artifact_hook.go +
getter/getter.go (go-getter). Supported sources:

- http(s)://...           urllib download
- git::<url> or *.git     ``git clone`` (depth 1; ``ref`` option)
- file paths / file://    copy (file or tree)

Options (the go-getter subset the reference jobs actually use):
- checksum: "<algo>:<hex>" or "<hex>" (md5/sha1/sha256/sha512),
  verified before the artifact is exposed to the task
- archive: "false" disables auto-unpacking; otherwise .zip/.tar.gz/
  .tgz/.tar.bz2/.tar are extracted into the destination (go-getter's
  default unarchiving)

Destinations resolve inside the task directory and are containment-
checked (escapingfs semantics, like the template hook): a jobspec
cannot write outside its sandbox.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tarfile
import urllib.parse
import urllib.request
import zipfile
from typing import Dict, Optional


class ArtifactError(Exception):
    """Download/verify failure -> task setup failure (restartable per
    the restart policy, artifact_hook.go wraps as recoverable)."""

    recoverable = True


_ALGOS = {"md5", "sha1", "sha256", "sha512"}
_HEX_LEN_TO_ALGO = {32: "md5", 40: "sha1", 64: "sha256", 128: "sha512"}


def _safe_join(root: str, *parts: str) -> str:
    """Containment-checked join (escapingfs; CVE-2022-24683 class)."""
    path = os.path.realpath(os.path.join(root, *parts))
    rootr = os.path.realpath(root)
    if path != rootr and not path.startswith(rootr + os.sep):
        raise ArtifactError(f"artifact destination escapes task dir: {parts}")
    return path


def _verify_checksum(path: str, spec: str) -> None:
    spec = spec.strip()
    if ":" in spec:
        algo, want = spec.split(":", 1)
        algo = algo.lower()
    else:
        want = spec
        algo = _HEX_LEN_TO_ALGO.get(len(spec), "")
    if algo not in _ALGOS:
        raise ArtifactError(f"unsupported checksum spec: {spec!r}")
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    got = h.hexdigest()
    if got.lower() != want.lower():
        raise ArtifactError(
            f"checksum mismatch: want {algo}:{want}, got {algo}:{got}"
        )


def _unpack(path: str, dest_dir: str) -> bool:
    """Extract recognized archives; True when extraction happened."""
    lower = path.lower()
    try:
        if lower.endswith(".zip"):
            with zipfile.ZipFile(path) as z:
                for name in z.namelist():
                    _safe_join(dest_dir, name)     # zip-slip guard
                z.extractall(dest_dir)
            return True
        if lower.endswith((".tar.gz", ".tgz", ".tar.bz2", ".tbz2", ".tar")):
            with tarfile.open(path) as t:
                members = t.getmembers()
                for m in members:
                    _safe_join(dest_dir, m.name)   # tar-slip guard
                try:
                    t.extractall(dest_dir, filter="data")
                except TypeError:
                    # pre-3.12 tarfile has no filter: the name guard
                    # above cannot catch symlink-member escapes
                    # ("lnk" -> "/" then "lnk/evil"), so reject links
                    # and special files outright
                    for m in members:
                        if not (m.isreg() or m.isdir()):
                            raise ArtifactError(
                                f"archive member {m.name!r} is not a "
                                "regular file/dir (links need "
                                "Python >= 3.12)")
                    t.extractall(dest_dir)
            return True
    except (OSError, zipfile.BadZipFile, tarfile.TarError) as e:
        raise ArtifactError(f"extracting {os.path.basename(path)}: {e}")
    return False


def fetch_artifact(artifact: Dict, task_dir: str,
                   timeout: float = 300.0) -> str:
    """Download one artifact stanza into the task dir; returns the
    destination path. Raises ArtifactError on any failure."""
    source = str(artifact.get("source", "")).strip()
    if not source:
        raise ArtifactError("artifact has no source")
    destination = str(artifact.get("destination", "local/")).strip() or "local/"
    options = artifact.get("options") or {}
    checksum = options.get("checksum", "")
    unarchive = str(options.get("archive", "true")).lower() not in (
        "false", "0")

    dest_dir = _safe_join(task_dir, destination)
    os.makedirs(dest_dir, exist_ok=True)

    # --- git ---
    is_git = source.startswith("git::") or source.endswith(".git")
    if is_git:
        if checksum:
            # silently skipping a declared checksum would be worse
            # than failing; pin git artifacts by ref instead
            raise ArtifactError(
                "checksum verification is not supported for git "
                "sources; pin a ref instead")
        url = source[5:] if source.startswith("git::") else source
        ref = options.get("ref", "")
        cmd = ["git", "clone", "--depth", "1"]
        if ref:
            cmd += ["--branch", ref]
        cmd += [url, dest_dir]
        try:
            if os.listdir(dest_dir):
                # idempotent under prestart retries: a completed clone
                # is kept; anything else in the way is an error
                if os.path.isdir(os.path.join(dest_dir, ".git")):
                    return dest_dir
                raise ArtifactError(
                    f"git destination {destination!r} is not empty")
            proc = subprocess.run(cmd, capture_output=True, timeout=timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise ArtifactError(f"git clone {url}: {e}")
        if proc.returncode != 0:
            raise ArtifactError(
                f"git clone {url}: {proc.stderr.decode(errors='replace')[:300]}"
            )
        return dest_dir

    parsed = urllib.parse.urlparse(source)
    name = os.path.basename(parsed.path) or "artifact"
    fetched = _safe_join(dest_dir, name)

    if parsed.scheme in ("http", "https"):
        try:
            req = urllib.request.Request(source)
            with urllib.request.urlopen(req, timeout=timeout) as resp, \
                    open(fetched, "wb") as out:
                shutil.copyfileobj(resp, out)
        except OSError as e:
            raise ArtifactError(f"GET {source}: {e}")
    elif parsed.scheme in ("", "file"):
        src_path = parsed.path if parsed.scheme == "file" else source
        if not os.path.exists(src_path):
            raise ArtifactError(f"artifact source not found: {src_path}")
        if os.path.isdir(src_path):
            if checksum:
                # a declared checksum cannot be verified against a
                # directory tree; hard-error like the git-source path
                # rather than silently skipping verification
                raise ArtifactError(
                    "checksum verification is not supported for "
                    f"directory sources: {src_path}"
                )
            shutil.copytree(src_path, dest_dir, dirs_exist_ok=True)
            return dest_dir
        shutil.copy2(src_path, fetched)
    else:
        raise ArtifactError(f"unsupported artifact scheme: {parsed.scheme}")

    if checksum:
        try:
            _verify_checksum(fetched, checksum)
        except ArtifactError:
            # never leave an unverified artifact in the task dir
            try:
                os.unlink(fetched)
            except OSError:
                pass
            raise

    if unarchive and _unpack(fetched, dest_dir):
        os.unlink(fetched)
    return dest_dir
