"""TimeTable: map state indexes to wall-clock time.

Reference behavior: nomad/timetable.go (134 LoC) -- the leader
witnesses (raft index, time) pairs so GC can translate "older than 1
hour" into "modify_index <= N".
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import List, Tuple


class TimeTable:
    def __init__(self, limit: int = 4096) -> None:
        self._lock = threading.Lock()
        self._entries: List[Tuple[float, int]] = []   # (when, index) ascending
        self.limit = limit

    def witness(self, index: int, when: float = None) -> None:
        when = time.time() if when is None else when
        with self._lock:
            if self._entries and index <= self._entries[-1][1]:
                return
            self._entries.append((when, index))
            if len(self._entries) > self.limit:
                del self._entries[: len(self._entries) - self.limit]

    def nearest_index(self, when: float) -> int:
        """Largest witnessed index at or before `when` (0 if none)."""
        with self._lock:
            pos = bisect.bisect_right(self._entries, (when, float("inf")))
            if pos == 0:
                return 0
            return self._entries[pos - 1][1]
