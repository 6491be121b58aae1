"""Node heartbeat tracking on the leader.

Reference behavior: nomad/heartbeat.go (:34-260). The leader arms a TTL
timer per node; a client heartbeat (Node.UpdateStatus) resets it; expiry
marks the node down through the Raft boundary, which triggers
node-update evaluations so the scheduler reschedules the node's allocs
(reconcile marks them lost/disconnecting).

Counterpart of ``nomad_tpu/server/heartbeat.py`` with the same interface
and semantics, but one timer thread for all nodes instead of a
``threading.Timer`` (a thread) per node: in a process that has loaded
the CUDA libraries every thread carries their static thread-local
storage, and a server that armed one thread for each of 10,000 nodes
was killed for its memory. Deadlines sit in a heap; a reset or a clear
supersedes a node's entry, which the timer thread skips when it comes
due.
"""

from __future__ import annotations

import heapq
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class HeartbeatTimers:
    def __init__(
        self,
        on_expire: Callable[[str], None],
        ttl: float = 10.0,
        ttl_jitter: float = 0.1,
    ) -> None:
        self._on_expire = on_expire
        self.ttl = ttl
        self.ttl_jitter = ttl_jitter
        self._cv = threading.Condition(threading.Lock())
        #: node id -> its armed deadline (time.monotonic)
        self._deadlines: Dict[str, float] = {}
        #: (deadline, node id); entries whose deadline no longer matches
        #: ``_deadlines`` were superseded and are skipped
        self._heap: List[Tuple[float, str]] = []
        self._enabled = False
        self._thread: Optional[threading.Thread] = None

    def set_enabled(self, enabled: bool) -> None:
        with self._cv:
            self._enabled = enabled
            if not enabled:
                self._deadlines.clear()
                self._heap.clear()
            elif self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="heartbeat-timers")
                self._thread.start()
            self._cv.notify_all()

    def reset(self, node_id: str) -> float:
        """Arm/re-arm the node's TTL; returns the granted TTL
        (heartbeat.go:56 resetHeartbeatTimer). Jitter decorrelates
        thundering-herd heartbeats after a leader transition."""
        ttl = self.ttl * (1.0 + random.random() * self.ttl_jitter)
        with self._cv:
            if not self._enabled:
                return ttl
            deadline = time.monotonic() + ttl
            self._deadlines[node_id] = deadline
            heapq.heappush(self._heap, (deadline, node_id))
            if self._heap[0][1] == node_id:
                self._cv.notify_all()     # a new earliest deadline
        return ttl

    def clear(self, node_id: str) -> None:
        with self._cv:
            self._deadlines.pop(node_id, None)

    def _run(self) -> None:
        while True:
            with self._cv:
                due: List[str] = []
                while not due:
                    if not self._enabled:
                        self._thread = None
                        return
                    now = time.monotonic()
                    while self._heap and self._heap[0][0] <= now:
                        deadline, node_id = heapq.heappop(self._heap)
                        if self._deadlines.get(node_id) == deadline:
                            del self._deadlines[node_id]
                            due.append(node_id)
                    if not due:
                        wait = self._heap[0][0] - now if self._heap else None
                        self._cv.wait(wait)
            for node_id in due:
                with self._cv:
                    if not self._enabled:
                        break
                self._on_expire(node_id)

    def count(self) -> int:
        with self._cv:
            return len(self._deadlines)
