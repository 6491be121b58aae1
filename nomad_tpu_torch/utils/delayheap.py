"""Time-ordered heap of waiting items.

Reference behavior: lib/delayheap/delay_heap.go -- used by the eval
broker for WaitUntil evaluations (nomad/eval_broker.go:758-809) and by
the drainer for deadlines. Items are keyed by id so they can be removed
or have their wait time updated in place.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, List, Optional, Tuple


class DelayHeap:
    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, str]] = []
        self._entries: dict = {}          # id -> (wait_until, seq, item)
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, item_id: str) -> bool:
        return item_id in self._entries

    def push(self, item_id: str, wait_until: float, item: Any) -> None:
        if item_id in self._entries:
            self.remove(item_id)
        seq = next(self._seq)
        self._entries[item_id] = (wait_until, seq, item)
        heapq.heappush(self._heap, (wait_until, seq, item_id))

    def remove(self, item_id: str) -> bool:
        # lazy deletion: entry dropped from the map; stale heap nodes are
        # skipped on pop (delay_heap.go uses container/heap Fix/Remove;
        # lazy deletion is equivalent and simpler)
        return self._entries.pop(item_id, None) is not None

    def update(self, item_id: str, wait_until: float) -> bool:
        entry = self._entries.get(item_id)
        if entry is None:
            return False
        self.push(item_id, wait_until, entry[2])
        return True

    def peek(self) -> Optional[Tuple[str, float, Any]]:
        """Earliest (id, wait_until, item) or None."""
        while self._heap:
            wait_until, seq, item_id = self._heap[0]
            entry = self._entries.get(item_id)
            if entry is None or entry[1] != seq:
                heapq.heappop(self._heap)   # stale
                continue
            return item_id, wait_until, entry[2]
        return None

    def pop_due(self, now: float) -> List[Tuple[str, Any]]:
        """Pop every item whose wait time has passed."""
        due: List[Tuple[str, Any]] = []
        while True:
            head = self.peek()
            if head is None or head[1] > now:
                break
            item_id, _, item = head
            heapq.heappop(self._heap)
            del self._entries[item_id]
            due.append((item_id, item))
        return due
