"""Bounded top-K score heap.

Reference behavior: lib/kheap/score_heap.go -- keeps the K highest-score
items; used for the per-eval AllocMetric's top node scores
(nomad/structs/structs.go AllocMetric.TopScores).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, List, Tuple


class ScoreHeap:
    def __init__(self, capacity: int = 5) -> None:
        self.capacity = capacity
        self._heap: List[Tuple[float, int, Any]] = []   # min-heap of scores
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, score: float, item: Any) -> None:
        entry = (score, next(self._seq), item)
        if len(self._heap) < self.capacity:
            heapq.heappush(self._heap, entry)
        elif score > self._heap[0][0]:
            heapq.heapreplace(self._heap, entry)

    def items(self) -> List[Tuple[float, Any]]:
        """Descending by score."""
        return [(s, it) for s, _, it in sorted(self._heap, key=lambda e: -e[0])]
