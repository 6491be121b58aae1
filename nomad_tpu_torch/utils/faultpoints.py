"""Deterministic fault-injection plane.

The failure half of the capability bar: the cluster's soundness story
is not "nothing fails" but "the pipeline converges when things die
mid-flight" (Raft failover, crashed eval threads, rejected plan
commits, missed heartbeats). This module is the seam layer that lets
the chaos cell (bench/trace_report.run_chaos_burst) and pinned-seed
regression tests exercise those failures ON PURPOSE, at the exact
points where real ones land, without any test-only forks of the
production code paths.

Cost discipline — the ``witness_lock`` pattern (utils/witness.py):

- **Disarmed (the default):** ``fault("name")`` is one module-global
  boolean check and an immediate return. No dict lookup, no lock, no
  allocation. The steady-burst CI gates (0 jit misses, plan-group
  size, h2d share) run with every point compiled in and disarmed.
- **Armed** (``arm(schedule, seed=...)``): each hit takes the small
  registry lock, bumps the point's hit counter, and consults its
  deterministic schedule. Sleeps (latency injection) happen OUTSIDE
  the registry lock.

Schedules are DETERMINISTIC AND SEEDED: each point draws its
per-hit decisions from ``random.Random(crc32(point) ^ seed)``, so
re-arming the same ``(schedule, seed)`` pair replays the same
decision at each HIT INDEX. ``nth``/``every`` triggers therefore fire
at exactly the same crossings run to run; for ``p``-based triggers on
points crossed by multiple threads, WHICH crossing maps to which hit
index depends on OS scheduling, so the fire pattern is
seed-deterministic per index but not per wall-clock crossing — pinned
regression schedules use ``nth``/``every``
(docs/ROBUSTNESS.md "Reproducing a chaos failure from its seed").
Spec keys per point::

    {"kind": "error"}                      # raise FaultError every hit
    {"kind": "error", "nth": 3}            # raise on hit #3 exactly
    {"kind": "error", "every": 5}          # raise on every 5th hit
    {"kind": "error", "p": 0.1}            # seeded Bernoulli per hit
    {"kind": "latency", "sleep_s": 0.01, "p": 0.5}   # seeded stalls
    {"kind": "kill", "nth": 4}             # FaultThreadKill on hit #4
    {..., "max_fires": 2}                  # cap total fires (kill: 1)

``kind="kill"`` raises :class:`FaultThreadKill`, deliberately a
``BaseException`` subclass: the eval workers confine ``Exception``
(ack/nack + keep the loop alive), so an injected kill sails past that
confinement and the thread dies exactly like a crashed one —
``finally`` blocks still unwind (rendezvous slots are released, pool
bookkeeping runs), but nothing acks, nacks, or responds. Recovery
must come from the TIMEOUT machinery (broker nack deadlines, plan
futures, the group-commit abnormal unwind), which is the point.

Per-point hit/fire counters are served by :func:`stats` and exported
as ``nomad_tpu_fault_hits_total{point=...}`` /
``nomad_tpu_fault_fires_total{point=...,kind=...}`` plus the
``nomad_tpu_fault_armed`` gauge (telemetry/exporter.py). The wired
point catalog lives in docs/ROBUSTNESS.md.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "FaultError", "FaultThreadKill", "fault", "arm", "disarm", "armed",
    "reset", "stats", "fires", "fire_log",
]


class FaultError(RuntimeError):
    """Raised by an armed fault point with ``kind="error"``. A
    RuntimeError on purpose: every seam's existing error handling
    (worker nack, plan-future respond, replicator retry) must treat it
    exactly like the real failure it stands in for."""

    def __init__(self, point: str) -> None:
        super().__init__(f"injected fault at {point!r}")
        self.point = point


class FaultThreadKill(BaseException):
    """Kills the current thread (``kind="kill"``). A BaseException so
    ``except Exception`` confinement does NOT catch it — the thread
    dies as a crashed one would, with only ``finally`` unwinding."""

    def __init__(self, point: str) -> None:
        super().__init__(f"injected thread kill at {point!r}")
        self.point = point


#: the one disarmed-path cost: a module-global boolean read
_ARMED = False

_lock = threading.Lock()
_seed = 0
#: point name -> _Point (created at arm() for scheduled points, and
#: lazily on first hit for wired-but-unscheduled ones, so stats()
#: reports hit counts for every point the run actually crossed)
_points: Dict[str, "_Point"] = {}
#: bounded log of FIRED faults (the failover timeline
#: merges firings with the consensus event stream). Only appended
#: while armed — the disarmed path stays one boolean check.
_fire_log: deque = deque(maxlen=1024)


class _Point:
    __slots__ = ("name", "spec", "kind", "nth", "every", "p", "sleep_s",
                 "max_fires", "rng", "hits", "fires")

    def __init__(self, name: str, spec: Optional[Dict], seed: int) -> None:
        import random

        self.name = name
        self.spec = spec
        self.hits = 0
        self.fires = 0
        if spec is None:
            self.kind = None
            return
        self.kind = spec.get("kind", "error")
        if self.kind not in ("error", "latency", "kill"):
            raise ValueError(
                f"fault point {name!r}: unknown kind {self.kind!r}")
        self.nth = spec.get("nth")
        self.every = spec.get("every")
        self.p = spec.get("p")
        self.sleep_s = float(spec.get("sleep_s", 0.0))
        default_cap = 1 if (self.kind == "kill" or self.nth) else None
        self.max_fires = spec.get("max_fires", default_cap)
        # deterministic per-point stream: decisions depend only on
        # (schedule seed, point name, hit index) — re-arming the same
        # pair replays the same decisions hit for hit
        self.rng = random.Random(zlib.crc32(name.encode()) ^ seed)

    def decide(self) -> Optional[str]:
        """Called under _lock at each hit; returns the action to take
        ("error"/"latency"/"kill") or None."""
        self.hits += 1
        if self.kind is None:
            return None
        if self.max_fires is not None and self.fires >= self.max_fires:
            return None
        if self.nth is not None:
            if self.hits != self.nth:
                return None
        elif self.every is not None:
            if self.hits % self.every != 0:
                return None
        if self.p is not None and self.rng.random() >= self.p:
            return None
        self.fires += 1
        return self.kind


def arm(schedule: Dict[str, Dict], seed: int = 0) -> None:
    """Arm the plane with a (schedule, seed) pair. Replaces any prior
    schedule; counters reset so a run's stats are its own."""
    global _ARMED, _seed
    with _lock:
        _seed = seed
        _points.clear()
        _fire_log.clear()
        for name, spec in schedule.items():
            _points[name] = _Point(name, dict(spec), seed)
        _ARMED = True


def disarm() -> None:
    """Back to the no-op path. Counters survive for post-run stats();
    reset() clears them."""
    global _ARMED
    _ARMED = False


def armed() -> bool:
    return _ARMED


def reset() -> None:
    global _ARMED
    with _lock:
        _ARMED = False
        _points.clear()
        _fire_log.clear()


def stats() -> Dict[str, Dict]:
    """{point: {"hits": n, "fires": n, "kind": k}} for every point the
    run scheduled or crossed."""
    with _lock:
        return {
            name: {"hits": p.hits, "fires": p.fires, "kind": p.kind}
            for name, p in sorted(_points.items())
        }


def fires() -> int:
    with _lock:
        return sum(p.fires for p in _points.values())


def fire_log() -> List[Dict]:
    """Every fired fault this arming window, oldest first:
    ``{"t": monotonic, "point": name, "kind": action}`` — the failover
    timeline's fault feed (telemetry/timeline.py). Cleared by arm()
    and reset()."""
    with _lock:
        return [dict(f) for f in _fire_log]


def fault(name: str) -> None:
    """A named fault point. Disarmed: one boolean check. Armed: bump
    the point's counters and execute its scheduled action — raise
    :class:`FaultError`, sleep, or raise :class:`FaultThreadKill`.

    Call-site discipline: place the point OUTSIDE any held lock where
    possible (failures land at the seam boundary, and latency
    injection must not stretch critical sections the R2 rule keeps
    clean)."""
    if not _ARMED:
        return
    with _lock:
        point = _points.get(name)
        if point is None:
            point = _points[name] = _Point(name, None, _seed)
        action = point.decide()
        sleep_s = point.sleep_s if action == "latency" else 0.0
        if action is not None:
            _fire_log.append({"t": time.monotonic(), "point": name,
                              "kind": action})
    if action is None:
        return
    if action == "error":
        raise FaultError(name)
    if action == "kill":
        raise FaultThreadKill(name)
    # latency: sleep OUTSIDE the registry lock
    if sleep_s > 0.0:
        time.sleep(sleep_s)
