"""Preemption: evicting lower-priority allocs to place higher-priority work.

Reference behavior: scheduler/preemption.go (Preemptor, :96;
PreemptForTaskGroup :199; filterSuperset :702; basicResourceDistance
:608; scoreForTaskGroup :641; filterAndGroupPreemptibleAllocs :666) and
rank.go (PreemptionScoringIterator :799, netPriority :835,
preemptionScore :858). Only allocations whose job priority is more than
PRIORITY_DELTA below the placing job's are eligible; selection greedily
minimizes multi-dimensional resource distance, then a superset-filter
pass drops evictions another pick already covers.

TPU reformulation: the reference runs the Preemptor inside
BinPackIterator for every candidate node as iteration reaches it. Here
the *candidate filter* is vectorized — numpy planes of per-node
preemptible cpu/mem/disk are added to the free planes and the
binpack+preemption score is computed for every node at once — and the
exact greedy eviction-set selection runs host-side only for the ranked
top candidates (the same host-exact/device-wide split as the port and
device assigners in stack.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch.structs.resources import ComparableResources

# score penalty once a job/tg's in-plan preemptions exceed its migrate
# max_parallel (preemption.go:14 maxParallelPenalty)
MAX_PARALLEL_PENALTY = 50.0
# jobPriority - alloc priority must exceed this for eligibility
# (preemption.go:663 "within a delta of 10")
PRIORITY_DELTA = 10
# logistic preemption-score curve constants (rank.go:858-868)
_PREEMPTION_SCORE_RATE = 0.0048
_PREEMPTION_SCORE_ORIGIN = 2048.0


def basic_resource_distance(ask: ComparableResources,
                            used: ComparableResources) -> float:
    """Euclidean distance in normalized (cpu, mem, disk) space
    (preemption.go:608). Lower is a closer fit."""
    mem_c = cpu_c = disk_c = 0.0
    if ask.memory_mb > 0:
        mem_c = (float(ask.memory_mb) - float(used.memory_mb)) / float(ask.memory_mb)
    if ask.cpu_shares > 0:
        cpu_c = (float(ask.cpu_shares) - float(used.cpu_shares)) / float(ask.cpu_shares)
    if ask.disk_mb > 0:
        disk_c = (float(ask.disk_mb) - float(used.disk_mb)) / float(ask.disk_mb)
    return math.sqrt(mem_c * mem_c + cpu_c * cpu_c + disk_c * disk_c)


def score_for_task_group(ask: ComparableResources, used: ComparableResources,
                         max_parallel: int, num_preempted: int) -> float:
    """Distance plus a penalty when the alloc's job already has >=
    max_parallel in-plan preemptions (preemption.go:641)."""
    penalty = 0.0
    if max_parallel > 0 and num_preempted >= max_parallel:
        penalty = float((num_preempted + 1) - max_parallel) * MAX_PARALLEL_PENALTY
    return basic_resource_distance(ask, used) + penalty


def net_priority(allocs: List) -> float:
    """max priority + sum/max ratio penalty over the eviction set
    (rank.go:835)."""
    total = 0
    mx = 0.0
    for a in allocs:
        pri = float(_alloc_priority(a))
        if pri > mx:
            mx = pri
        total += int(pri)
    if mx <= 0:
        return 0.0
    return mx + float(total) / mx


def preemption_score(netp: float) -> float:
    """Logistic decay: low net-priority eviction sets score near 1,
    inflection at 2048 (rank.go:858)."""
    return 1.0 / (1.0 + math.exp(_PREEMPTION_SCORE_RATE * (netp - _PREEMPTION_SCORE_ORIGIN)))


def _alloc_priority(alloc) -> int:
    job = getattr(alloc, "job", None)
    if job is not None:
        return job.priority
    return 50


def _alloc_max_parallel(alloc) -> int:
    job = getattr(alloc, "job", None)
    if job is None:
        return 0
    tg = job.lookup_task_group(alloc.task_group)
    if tg is not None and tg.migrate is not None:
        return tg.migrate.max_parallel
    return 0


def filter_and_group_preemptible(job_priority: int, allocs: List) -> List[Tuple[int, List]]:
    """Group eligible allocs by job priority, ascending (lowest-priority
    victims first; preemption.go:666)."""
    by_pri: Dict[int, List] = {}
    for a in allocs:
        if getattr(a, "job", None) is None:
            continue
        pri = _alloc_priority(a)
        if job_priority - pri < PRIORITY_DELTA:
            continue
        by_pri.setdefault(pri, []).append(a)
    return sorted(by_pri.items(), key=lambda kv: kv[0])


class Preemptor:
    """Finds the eviction set for one node (preemption.go:96).

    Construct once per placement attempt, then per candidate node call
    ``set_node`` + ``set_candidates`` + ``preempt_for_task_group``.
    ``set_preemptions`` folds in the allocs already staged for
    preemption elsewhere in the plan so the max_parallel penalty sees
    cross-node evictions of the same job.
    """

    def __init__(self, job_priority: int, namespace: str, job_id: str) -> None:
        self.job_priority = job_priority
        self.namespace = namespace
        self.job_id = job_id
        self._current_preemptions: Dict[Tuple[str, str, str], int] = {}
        self._details: Dict[str, ComparableResources] = {}
        self._max_parallel: Dict[str, int] = {}
        self._node_remaining: Optional[ComparableResources] = None
        self._current_allocs: List = []

    def set_node(self, node) -> None:
        remaining = node.comparable_resources()
        reserved = node.comparable_reserved_resources()
        if reserved is not None:
            remaining.subtract(reserved)
        self._node_remaining = remaining

    def set_candidates(self, allocs: List) -> None:
        self._current_allocs = []
        for a in allocs:
            # never preempt the job being placed (or its plan placements)
            if a.job_id == self.job_id and a.namespace == self.namespace:
                continue
            self._details[a.id] = a.comparable_resources()
            self._max_parallel[a.id] = _alloc_max_parallel(a)
            self._current_allocs.append(a)

    def set_preemptions(self, allocs: List) -> None:
        self._current_preemptions.clear()
        for a in allocs:
            key = (a.namespace, a.job_id, a.task_group)
            self._current_preemptions[key] = self._current_preemptions.get(key, 0) + 1

    def _num_preemptions(self, alloc) -> int:
        return self._current_preemptions.get(
            (alloc.namespace, alloc.job_id, alloc.task_group), 0
        )

    def preempt_for_task_group(self, ask: ComparableResources) -> List:
        """Greedy multi-dim knapsack: repeatedly take the eligible alloc
        with the lowest resource distance until the ask fits, walking
        priority groups lowest-first; then drop superset picks
        (preemption.go:199-265)."""
        if self._node_remaining is None:
            return []
        needed = ask.copy()

        remaining = self._node_remaining.copy()
        for a in self._current_allocs:
            remaining.subtract(self._details[a.id])

        groups = filter_and_group_preemptible(self.job_priority, self._current_allocs)

        best: List = []
        met = False
        available = remaining.copy()
        for _pri, group in groups:
            group = list(group)
            while group and not met:
                best_idx = -1
                best_dist = float("inf")
                for idx, a in enumerate(group):
                    dist = score_for_task_group(
                        needed, self._details[a.id],
                        self._max_parallel[a.id], self._num_preemptions(a),
                    )
                    if dist < best_dist:
                        best_dist = dist
                        best_idx = idx
                chosen = group.pop(best_idx)
                res = self._details[chosen.id]
                available.add(res)
                met, _ = available.superset(ask)
                best.append(chosen)
                needed.subtract(res)
            if met:
                break
        if not met:
            return []
        return self._filter_superset(best, remaining, ask)

    def _filter_superset(self, best: List, node_remaining: ComparableResources,
                         ask: ComparableResources) -> List:
        """Second pass dropping evictions whose resources other picks
        already cover: add picks largest-distance-first and stop at the
        first prefix that satisfies the ask (preemption.go:702)."""
        best = sorted(
            best,
            key=lambda a: basic_resource_distance(ask, self._details[a.id]),
            reverse=True,
        )
        available = node_remaining.copy()
        filtered: List = []
        for a in best:
            filtered.append(a)
            available.add(self._details[a.id])
            ok, _ = available.superset(ask)
            if ok:
                break
        return filtered


def preemptible_planes(cluster, snapshot, ctx, job_priority: int,
                       namespace: str, job_id: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized candidate filter: per-node planes of total preemptible
    cpu/mem/disk plus the net-priority-derived preemption score of
    evicting *everything* eligible (an upper bound on reclaimable
    capacity; the exact greedy set is computed host-side only for
    ranked candidates). Replaces the reference's per-node Preemptor
    invocation inside BinPackIterator with one numpy sweep."""
    n = cluster.n_pad
    pre_cpu = np.zeros(n, np.float32)
    pre_mem = np.zeros(n, np.float32)
    pre_disk = np.zeros(n, np.float32)
    pre_score = np.zeros(n, np.float32)
    by_row: Dict[int, List] = {}
    for a in snapshot.allocs_iter():
        if a.terminal_status():
            continue
        row = cluster.index.get(a.node_id)
        if row is None:
            continue
        if a.job_id == job_id and a.namespace == namespace:
            continue
        if getattr(a, "job", None) is None:
            continue
        if job_priority - _alloc_priority(a) < PRIORITY_DELTA:
            continue
        by_row.setdefault(row, []).append(a)
    for row, allocs in by_row.items():
        for a in allocs:
            cr = a.comparable_resources()
            pre_cpu[row] += cr.cpu_shares
            pre_mem[row] += cr.memory_mb
            pre_disk[row] += cr.disk_mb
        pre_score[row] = preemption_score(net_priority(allocs))
    return pre_cpu, pre_mem, pre_disk, pre_score
