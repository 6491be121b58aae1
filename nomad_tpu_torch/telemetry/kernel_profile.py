"""Wave-level instrumentation of the port's placement launches.

Counterpart of ``nomad_tpu/telemetry/kernel_profile.py``. Every profiled
launch is split into the stages that cost wall time on the card:

- ``kernel.h2d``      host-to-device upload of the launch's host leaves
- ``kernel.compile``  a launch that is a miss (see below)
- ``kernel.dispatch`` the launch call of a key already seen
- ``kernel.execute``  until the card is done (``torch.cuda.synchronize``)

(``kernel.d2h``, the readback of the result, is recorded by the caller
around its copy; its bytes come here through ``add_bytes``.)

A miss has no jit cache to consult here. It is the first launch of a
``(kernel, key)`` in the process, unless ``ops/warmup`` launched that key
first and marked it warm, or a launch during which
``ops/cuda_kernel.load_library`` built or loaded a library. The set of
keys seen lives for the process, like a jit cache, and ``reset`` keeps
it; ``clear_seen`` gives the state of a fresh process. The JAX
profiler's ``cache_growth`` cross-check reads the jit cache's size and
has no counterpart: nothing here reports it.

When disabled, ``call`` tests one attribute and calls through: the
callee uploads its own host leaves and nothing synchronizes the card.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Tuple

import torch

from nomad_tpu_torch.telemetry.trace import tracer

__all__ = ["KernelProfiler", "profiler"]


def _library_loads() -> int:
    from nomad_tpu_torch.ops import cuda_kernel

    return cuda_kernel.library_loads


class KernelProfiler:
    def __init__(self) -> None:
        self._enabled = False
        self._lock = threading.Lock()
        #: (kernel, key) launched since reset -> launch count
        self._launches: Dict[Tuple[str, tuple], int] = {}
        #: (kernel, key) -> miss count since reset
        self._misses: Dict[Tuple[str, tuple], int] = {}
        #: (kernel, key) launched or warmed in this process
        self._seen: set = set()
        #: per-stage cumulative seconds
        self.stage_s: Dict[str, float] = {
            "h2d": 0.0, "compile": 0.0, "dispatch": 0.0, "execute": 0.0,
        }
        #: cumulative transfer bytes per direction: h2d counts host
        #: leaves uploaded (resident tensors cost nothing) and the device
        #: state's uploads; d2h counts the readbacks of wave results
        self.transfer_bytes: Dict[str, int] = {"h2d": 0, "d2h": 0}
        #: device interactions on the wave path, keyed by program: every
        #: ``call`` counts one under its kernel name; the wave launcher
        #: adds "topk_drain" for the deferred top-k fetch, and warmup
        #: counts its launches under "warmup_<kernel>"
        self.dispatches: Dict[str, int] = {}

    # --- control --------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        """Zero the counts of the window; the keys seen stay."""
        with self._lock:
            self._launches.clear()
            self._misses.clear()
            for k in self.stage_s:
                self.stage_s[k] = 0.0
            for k in self.transfer_bytes:
                self.transfer_bytes[k] = 0
            self.dispatches.clear()

    def clear_seen(self) -> None:
        """Forget every key seen or warmed: the next launch of each is a
        miss again, as in a fresh process."""
        with self._lock:
            self._seen.clear()

    def mark_warm(self, kernel: str, key: tuple) -> None:
        """Record that ``ops/warmup`` launched ``(kernel, key)``: a later
        launch of it is no miss. Recorded whether or not the profiler is
        on, like a jit cache filled by a warmup."""
        with self._lock:
            self._seen.add((kernel, key))

    # --- accounting -----------------------------------------------------

    def summary(self) -> Dict:
        with self._lock:
            per_key = [
                {
                    "Kernel": kernel,
                    "Key": "/".join(str(p) for p in key),
                    "Launches": n,
                    "Misses": self._misses.get((kernel, key), 0),
                }
                for (kernel, key), n in sorted(self._launches.items(),
                                               key=lambda kv: repr(kv[0]))
            ]
            return {
                "Launches": sum(self._launches.values()),
                "Misses": sum(self._misses.values()),
                "StageSeconds": {k: round(v, 6)
                                 for k, v in self.stage_s.items()},
                "TransferBytes": dict(self.transfer_bytes),
                "Dispatches": dict(self.dispatches),
                "PerKey": per_key,
            }

    def misses_for(self, kernel: str) -> int:
        with self._lock:
            return sum(n for (k, _), n in self._misses.items()
                       if k == kernel)

    def add_bytes(self, direction: str, n: int) -> None:
        """Account ``n`` transfer bytes under ``direction`` ("h2d" or
        "d2h"); a no-op when disabled."""
        if not self._enabled or n <= 0:
            return
        with self._lock:
            self.transfer_bytes[direction] = \
                self.transfer_bytes.get(direction, 0) + int(n)

    def add_stage(self, stage: str, dur_s: float) -> None:
        """Account ``dur_s`` under ``stage``; a no-op when disabled (the
        wave launcher's uploads report here)."""
        if not self._enabled:
            return
        with self._lock:
            self.stage_s[stage] += dur_s

    def count_dispatch(self, program: str, n: int = 1) -> None:
        """Account ``n`` wave-path device interactions under
        ``program``; a no-op when disabled."""
        if not self._enabled or n <= 0:
            return
        with self._lock:
            self.dispatches[program] = \
                self.dispatches.get(program, 0) + int(n)

    def keys(self) -> list:
        """Every (kernel, key) launched since reset: the raw material of
        the warmup manifest (ops/warmup.py)."""
        with self._lock:
            return list(self._launches)

    # --- the profiled launch -------------------------------------------

    def call(self, kernel: str, fn: Callable, dev_args: tuple,
             static_args: tuple, key: tuple, device: torch.device):
        """Run ``fn(*dev_args, *static_args)`` split into h2d, compile or
        dispatch, and execute. ``dev_args`` holds the launch's arrays
        (host numpy, or tensors already on ``device``); ``static_args``
        pass through. ``key`` is the bucket identity of the launch."""
        if not self._enabled:
            return fn(*dev_args, *static_args)
        dev = torch.device(device)
        cuda = dev.type == "cuda"

        from nomad_tpu_torch.ops.kernel import upload_args

        with tracer.span("kernel.h2d"):
            t0 = time.perf_counter()
            dev_args, up_bytes = upload_args(dev_args, dev)
            if up_bytes and cuda:
                torch.cuda.synchronize(dev)
            self._bump_stage("h2d", time.perf_counter() - t0)
        self.add_bytes("h2d", up_bytes)

        full_key = (kernel, key)
        loads0 = _library_loads()
        with self._lock:
            seen = full_key in self._seen
            self._seen.add(full_key)
            self._launches[full_key] = self._launches.get(full_key, 0) + 1
            self.dispatches[kernel] = self.dispatches.get(kernel, 0) + 1
        t0 = time.perf_counter()
        out = fn(*dev_args, *static_args)
        call_s = time.perf_counter() - t0
        miss = not seen or _library_loads() != loads0
        stage = "compile" if miss else "dispatch"
        tracer.record(f"kernel.{stage}", call_s)
        self._bump_stage(stage, call_s)
        if miss:
            with self._lock:
                self._misses[full_key] = self._misses.get(full_key, 0) + 1

        with tracer.span("kernel.execute"):
            t0 = time.perf_counter()
            if cuda:
                torch.cuda.synchronize(dev)
            self._bump_stage("execute", time.perf_counter() - t0)
        return out

    def _bump_stage(self, stage: str, dur_s: float) -> None:
        with self._lock:
            self.stage_s[stage] += dur_s


#: process-wide profiler; enabled together with the tracer by
#: telemetry.enable()
profiler = KernelProfiler()
