"""Live log monitoring and process introspection.

Reference behavior: command/agent/monitor/monitor.go -- `/v1/agent/
monitor` streams the agent's logs at a chosen level to HTTP clients
(the `nomad monitor` CLI); command/agent/pprof/pprof.go serves live
profiles. The Python analogs: a logging.Handler fan-out for the
monitor, a thread-stack dump for goroutine profiles, and a sampling
wall-clock profiler (10ms ticks over all threads) for CPU profiles.
"""

from __future__ import annotations

import collections
import logging
import queue
import sys
import threading
import time
import traceback
from typing import Dict, Iterator, List, Optional


class LogMonitor(logging.Handler):
    """Fan logging records out to stream subscribers (monitor.go)."""

    _installed: Optional["LogMonitor"] = None

    def __init__(self) -> None:
        super().__init__()
        self._lock2 = threading.Lock()
        self._subs: List[queue.Queue] = []
        self._saved_root_level: Optional[int] = None
        self.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
        ))

    @classmethod
    def install(cls) -> "LogMonitor":
        """Attach one shared handler to the root logger."""
        if cls._installed is None:
            cls._installed = cls()
            logging.getLogger().addHandler(cls._installed)
        return cls._installed

    def emit(self, record: logging.LogRecord) -> None:
        with self._lock2:
            subs = list(self._subs)
        if not subs:
            return
        try:
            line = self.format(record)
        except Exception:                       # noqa: BLE001
            return
        for q in subs:
            try:
                q.put_nowait((record.levelno, line))
            except queue.Full:
                pass   # slow consumer drops lines, never blocks logging

    def subscribe(self, level: str = "info") -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=512)
        q.min_level = getattr(logging, level.upper(), logging.INFO)
        root = logging.getLogger()
        with self._lock2:
            if not self._subs:
                self._saved_root_level = root.level
            self._subs.append(q)
            self._apply_root_level(root)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        root = logging.getLogger()
        with self._lock2:
            if q in self._subs:
                self._subs.remove(q)
            self._apply_root_level(root)

    def _apply_root_level(self, root: logging.Logger) -> None:
        """The unconfigured root logger gates at WARNING, which would
        suppress INFO/DEBUG records before they ever reach this handler
        (Go's monitor filters at the sink instead). While subscribers
        exist, lower the root level to the lowest subscribed level;
        restore the original level once the last one leaves. Stderr
        doesn't get noisier: logging.lastResort stays at WARNING."""
        if self._subs:
            floor = min(s.min_level for s in self._subs)
            if root.getEffectiveLevel() > floor:
                root.setLevel(floor)
        elif self._saved_root_level is not None:
            root.setLevel(self._saved_root_level)
            self._saved_root_level = None

    def stream(self, level: str = "info",
               stop: Optional[threading.Event] = None) -> Iterator[str]:
        """Yield formatted lines until `stop` is set."""
        q = self.subscribe(level)
        try:
            while stop is None or not stop.is_set():
                try:
                    levelno, line = q.get(timeout=0.5)
                except queue.Empty:
                    yield ""   # keepalive tick
                    continue
                if levelno >= q.min_level:
                    yield line
        finally:
            self.unsubscribe(q)


def thread_dump() -> str:
    """All live thread stacks (pprof goroutine analog)."""
    frames = sys._current_frames()
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = names.get(ident)
        name = t.name if t else f"thread-{ident}"
        daemon = "daemon" if (t and t.daemon) else "main"
        out.append(f"thread {name} [{daemon}] (ident {ident}):")
        out.extend(l.rstrip() for l in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def sample_profile(seconds: float = 1.0, hz: int = 100) -> str:
    """Statistical wall-clock profile across all threads (pprof
    profile analog): sample stacks at `hz`, aggregate by frame."""
    interval = 1.0 / hz
    counts: Dict[str, int] = collections.Counter()
    deadline = time.time() + seconds
    n_samples = 0
    me = threading.get_ident()
    while time.time() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            stack = traceback.extract_stack(frame)
            if not stack:
                continue
            leaf = stack[-1]
            counts[f"{leaf.name} ({leaf.filename}:{leaf.lineno})"] += 1
        n_samples += 1
        time.sleep(interval)
    total = sum(counts.values()) or 1
    lines = [f"samples: {n_samples} over {seconds:.1f}s at {hz}Hz", ""]
    for frame_id, n in sorted(counts.items(), key=lambda kv: -kv[1])[:60]:
        lines.append(f"{n:6d} {100.0 * n / total:5.1f}%  {frame_id}")
    return "\n".join(lines)


def heap_summary(top: int = 40) -> str:
    """Object counts by type (pprof heap analog)."""
    import gc

    counts: Dict[str, int] = collections.Counter()
    for obj in gc.get_objects():
        counts[type(obj).__name__] += 1
    lines = [f"live objects: {sum(counts.values())}", ""]
    for name, n in sorted(counts.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"{n:8d}  {name}")
    return "\n".join(lines)
