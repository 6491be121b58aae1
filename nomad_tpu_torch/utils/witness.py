"""Runtime lock witness: FreeBSD-WITNESS-style order checking.

graftcheck's R2 builds a lock-acquisition-order graph STATICALLY —
but static naming cannot unify every lock identity (two modules
reaching the same store lock through different attribute chains), and
it only sees orders the source spells out lexically. This module is
the runtime companion: a drop-in wrapper for the project's locks that
records the cross-thread acquisition orders that ACTUALLY execute,
fails fast on order-inversion cycles (the A→B / B→A pattern that is a
deadlock the interleaving just hasn't hit yet), and feeds per-lock
hold-time distributions into the streaming-histogram /
Prometheus-exporter infrastructure
(``nomad_tpu_latency_seconds{op="lock_hold_<name>"}``).

Cost model:

- **Disabled (the default):** ``witness_lock(name)`` returns a plain
  ``threading.Lock`` / ``RLock`` — literally zero overhead, no
  wrapper object anywhere on the hot path.
- **Enabled** (``NOMAD_TPU_WITNESS=1`` at process start, or
  ``witness.enable()`` before constructing the objects under test):
  each acquire walks the held-lock stack (almost always depth ≤ 2),
  consults the order graph under its own small mutex, and each
  release records one histogram sample.

The stress tier (``pytest -m stress``) constructs its brokers /
coalescers / membership under an enabled witness and asserts ZERO
inversion reports; ``NOMAD_TPU_WITNESS_RAISE=1`` additionally raises
``WitnessInversion`` at the offending acquire for fail-fast
debugging. See docs/ANALYSIS.md ("The runtime lock witness").
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "WitnessInversion", "enable", "disable", "enabled", "reset",
    "violations", "order_edges", "witness_lock", "WitnessLock",
]


class WitnessInversion(RuntimeError):
    """Raised at acquire time (opt-in) when the acquisition would
    close a cycle in the observed lock-order graph."""


_ENABLED = os.environ.get("NOMAD_TPU_WITNESS", "") not in ("", "0")
_RAISE = os.environ.get("NOMAD_TPU_WITNESS_RAISE", "") not in ("", "0")

#: witness bookkeeping mutex (never held while blocking on a wrapped
#: lock — order checks run BEFORE the inner acquire, updates after)
_graph_lock = threading.Lock()
#: observed order edges: name -> names acquired while it was held
_edges: Dict[str, Set[str]] = {}
#: inversion reports: (held, acquiring, cycle path, thread name)
_violations: List[Tuple[str, str, Tuple[str, ...], str]] = []

_tls = threading.local()


def enable() -> None:
    """Instrument locks created from now on (existing plain locks stay
    plain — construct the objects under test AFTER enabling)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Clear the order graph and the violation reports (test cells)."""
    with _graph_lock:
        _edges.clear()
        del _violations[:]


def violations() -> List[Tuple[str, str, Tuple[str, ...], str]]:
    with _graph_lock:
        return list(_violations)


def order_edges() -> Dict[str, Set[str]]:
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


#: witness names where nesting two DIFFERENT instances of the same
#: name is sanctioned (FreeBSD WITNESS's DUPOK): order between
#: same-name instances is inherently ambiguous at name granularity,
#: so it is flagged unless listed here. Empty on purpose — nothing in
#: the tree nests same-name locks today.
DUP_OK: Set[str] = set()


def _held_stack() -> List[Tuple[str, int, float]]:
    """Per-thread stack of (name, id(inner lock), acquire time)."""
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _reachable(src: str, dst: str) -> Optional[Tuple[str, ...]]:
    """Path src→…→dst in the edge graph (caller holds _graph_lock)."""
    seen = {src}
    stack: List[Tuple[str, Tuple[str, ...]]] = [(src, (src,))]
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + (nxt,)))
    return None


def _before_acquire(name: str, key: int) -> None:
    held = _held_stack()
    if not held:
        return
    if any(k == key for _, k, _ in held):
        # reentrant re-acquire of the SAME lock instance (RLock):
        # no new ordering information
        return
    held_names = {h for h, _, _ in held}
    if name in held_names:
        # a DIFFERENT instance under the same witness name: order
        # between same-name instances is ambiguous at name
        # granularity — a cross-instance ABBA here would otherwise
        # hide behind the reentrancy skip, so flag it (DUPOK-style)
        # unless the name is explicitly sanctioned
        if name not in DUP_OK:
            with _graph_lock:
                _violations.append(
                    (name, name, ("DUPOK", name),
                     threading.current_thread().name))
                if _RAISE:
                    raise WitnessInversion(
                        f"nesting two instances of witness lock "
                        f"{name!r}: same-name order is unverifiable — "
                        f"give the instances distinct names or add "
                        f"the name to witness.DUP_OK")
        return
    with _graph_lock:
        for h in held_names:
            # adding edge h→name closes a cycle iff name already
            # reaches h; record the inversion with the witness path
            path = _reachable(name, h)
            if path is not None:
                _violations.append(
                    (h, name, path + (name,),
                     threading.current_thread().name))
                if _RAISE:
                    raise WitnessInversion(
                        f"lock order inversion: acquiring {name!r} "
                        f"while holding {h!r}, but the observed order "
                        f"is {' -> '.join(path + (name,))}")
        for h in held_names:
            _edges.setdefault(h, set()).add(name)


def _on_acquired(name: str, key: int) -> None:
    _held_stack().append((name, key, time.perf_counter()))


def _on_release(name: str, key: int) -> Optional[float]:
    """Pop the held entry; returns the hold duration. The caller
    records it AFTER releasing the inner lock — the histogram's own
    lock and record cost must not run inside the witnessed critical
    section (it would lengthen the very hold times being measured)."""
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][1] == key:
            _, _, t0 = held.pop(i)
            return time.perf_counter() - t0
    return None


def _record_hold(name: str, dt: Optional[float]) -> None:
    if dt is None:
        return
    try:
        from nomad_tpu_torch.telemetry.histogram import histograms

        histograms.get(f"lock_hold_{name}").record(dt)
    except Exception:                       # noqa: BLE001 - metric only
        pass


class WitnessLock:
    """Order-checked, hold-timed wrapper over a threading lock.

    Duck-compatible with ``threading.Lock``/``RLock`` including the
    private hooks ``threading.Condition`` uses, so
    ``threading.Condition(witness_lock("X"))`` works and the wait/
    notify fast path keeps witness bookkeeping consistent across the
    release-reacquire inside ``wait()``.
    """

    __slots__ = ("_name", "_inner")

    def __init__(self, name: str, inner) -> None:
        self._name = name
        self._inner = inner

    # -- core lock protocol ----------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        _before_acquire(self._name, id(self._inner))
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _on_acquired(self._name, id(self._inner))
        return ok

    def release(self) -> None:
        dt = _on_release(self._name, id(self._inner))
        self._inner.release()
        _record_hold(self._name, dt)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration (delegates preserve RLock semantics) ------

    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        dt = _on_release(self._name, id(self._inner))
        inner = self._inner
        if hasattr(inner, "_release_save"):
            state = inner._release_save()
        else:
            inner.release()
            state = None
        _record_hold(self._name, dt)
        return state

    def _acquire_restore(self, state) -> None:
        _before_acquire(self._name, id(self._inner))
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        _on_acquired(self._name, id(self._inner))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessLock {self._name} over {self._inner!r}>"


def witness_lock(name: str, rlock: bool = False):
    """A lock for project hot-path objects: plain when the witness is
    disabled (zero overhead), order-checked + hold-timed when enabled.
    ``name`` should be stable and unique-ish (``Class.attr``) — it is
    the lock's identity in the order graph and its histogram label."""
    inner = threading.RLock() if rlock else threading.Lock()
    if not _ENABLED:
        return inner
    return WitnessLock(name, inner)
