"""Plan-skeleton cache: the per-(job, tg) scaffold evals rebuild.

Every evaluation (and every retry attempt inside one) re-derives the
same job/tg-shaped state before it can launch a kernel: the flattened
``AskTensor``, the merged constraint list, the affinity list, the
distinct-hosts flags, and (post-feasibility-compiler) the compiled
mask program. None of it depends on the evaluation — only on the job
spec — so a wave of 32 members re-deriving it 32 times is pure
sched-host overhead (ROADMAP lever #1, "cache plan skeletons").

Two-level lookup:

- identity fast path: scaffolds are memoized per TaskGroup OBJECT
  (state-store job rows are immutable and shared by every eval of the
  job, so the tg's identity is stable across wave members, retry
  attempts, and follow-up evals); entries pin the tg and re-check
  identity, so a recycled ``id()`` can never alias a dead group;
- spec-shared slow path: scaffolds key the compiled mask program by
  the structural signature, so DIFFERENT jobs with equal constraint
  trees still share one program and one cached mask.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.tensors.schema import AskTensor
from nomad_tpu_torch.utils.witness import witness_lock

__all__ = ["TGScaffold", "scaffold_for", "MetricsSkeleton"]

_LOCK = witness_lock("scaffold._LOCK")
_CACHE: "OrderedDict[int, Tuple[object, TGScaffold]]" = OrderedDict()
_CACHE_MAX = 512


class TGScaffold:
    """Spec-derived, eval-independent state for one (job, tg)."""

    __slots__ = ("ask", "affinities", "distinct_hosts_job",
                 "distinct_hosts_tg", "has_devices", "program",
                 "program_compiled", "lean_assign", "lean_ports",
                 "static_port_mask", "_tg", "_lean_res", "_lean_lock")

    def __init__(self, job, tg) -> None:
        from nomad_tpu_torch.structs import consts

        self.ask: AskTensor = AskTensor.build(tg)
        affinities = list(job.affinities) + list(tg.affinities)
        for task in tg.tasks:
            affinities.extend(task.affinities)
        self.affinities: List = affinities
        self.distinct_hosts_job = any(
            con.operand == consts.CONSTRAINT_DISTINCT_HOSTS
            for con in job.constraints)
        self.distinct_hosts_tg = any(
            con.operand == consts.CONSTRAINT_DISTINCT_HOSTS
            for con in tg.constraints)
        self.has_devices = any(t.resources.devices for t in tg.tasks)
        # lean assignment: no group/task networks, devices, or reserved
        # cores anywhere in the group. For such asks the exact per-node
        # assignment (_NodeAssigner.assign) is PURE struct building —
        # it reads no node state and cannot fail — so placement
        # materialization shares ONE frozen resources skeleton per
        # (job, tg) instead of rebuilding the same structs per slot
        # (the vectorized-assembly move).
        self.lean_assign = (
            not tg.networks
            and not any(t.resources.networks for t in tg.tasks)
            and not any(t.resources.devices for t in tg.tasks)
            and not any(t.resources.cores > 0 for t in tg.tasks)
        )
        # static-port lean: ONE group network asking only
        # for concrete in-range reserved ports — no dynamic ports (the
        # stochastic picker reads node state), no bandwidth, no task
        # networks/devices/cores. For such asks the exact assigner's
        # only node-dependent work is the collision re-check, which the
        # kernel's port-conflict plane + the usage index's live port
        # bitmaps already prove — so placement can skip the
        # NetworkIndex build entirely (stack.select_many) and the plan
        # applier's ports-aware group check re-validates the claim.
        # Duplicate ports in the ask stay on the exact path.
        self.lean_ports = False
        self.static_port_mask = 0
        if (not self.lean_assign and len(tg.networks) == 1
                and not any(t.resources.networks for t in tg.tasks)
                and not any(t.resources.devices for t in tg.tasks)
                and not any(t.resources.cores > 0 for t in tg.tasks)):
            net = tg.networks[0]
            vals = [p.value for p in net.reserved_ports]
            if (vals and not net.dynamic_ports and not net.mbits
                    and all(0 <= v < 65536 for v in vals)
                    and len(set(vals)) == len(vals)):
                self.lean_ports = True
                for v in vals:
                    self.static_port_mask |= 1 << v
        self._tg = tg
        self._lean_res: Dict[bool, Tuple] = {}
        self._lean_lock = witness_lock("TGScaffold._lean_lock")
        # compiled mask program (None = Python-builder fallback); the
        # program cache dedupes by signature across jobs
        from nomad_tpu_torch.feasibility import default_mask_cache

        self.program = default_mask_cache.program_for(job, tg)
        self.program_compiled = self.program is not None

    def lean_planes(self, oversub: bool) -> Tuple:  # graft: frozen
        """(task_resources, task_lifecycles, AllocatedResources) for a
        lean placement, built once per (job, tg, oversub) and shared BY
        REFERENCE across every slot, wave member, and retry attempt.

        Sound because allocated resources are replaced, never mutated
        in place, repo-wide (the convention ``Allocation.fit_meta``'s
        identity-keyed cache already relies on); the non-lean paths
        (networks/devices/cores) keep building per-slot structs."""
        ent = self._lean_res.get(bool(oversub))
        if ent is not None:
            return ent
        from nomad_tpu_torch.structs.resources import (
            AllocatedCpuResources,
            AllocatedMemoryResources,
            AllocatedResources,
            AllocatedSharedResources,
            AllocatedTaskResources,
        )

        tg = self._tg
        task_resources = {}
        task_lifecycles = {}
        for task in tg.tasks:
            r = task.resources
            task_resources[task.name] = AllocatedTaskResources(
                cpu=AllocatedCpuResources(cpu_shares=int(r.cpu)),
                memory=AllocatedMemoryResources(
                    memory_mb=int(r.memory_mb),
                    memory_max_mb=(int(r.memory_max_mb)
                                   if oversub else 0),
                ),
            )
            task_lifecycles[task.name] = task.lifecycle
        resources = AllocatedResources(
            tasks=task_resources,
            task_lifecycles=task_lifecycles,
            shared=AllocatedSharedResources(
                disk_mb=tg.ephemeral_disk.size_mb),
        )
        with self._lean_lock:
            return self._lean_res.setdefault(
                bool(oversub),
                (task_resources, task_lifecycles, resources))


class MetricsSkeleton:
    """One kernel launch's shared AllocMetric header + lazy top-k.

    Every slot of a ``select_many`` call reports the same header counts
    (nodes evaluated/filtered/exhausted — they come from one mask
    reduction); only score_meta differs per slot. The skeleton holds
    the header ONCE plus the launch's top-k planes (possibly still
    device-resident — coalesce._TopKSlice), and materializes per-slot
    ``AllocMetric``s cheaply: dicts are copied only when non-empty, and
    the top-k -> score_meta fill is deferred onto the plan window
    (Plan.deferred_work), where the first slot's access triggers the
    wave's single shared d2h fetch.
    """

    __slots__ = ("nodes_evaluated", "nodes_filtered", "nodes_exhausted",
                 "constraint_filtered", "dimension_exhausted",
                 "topk_idx", "topk_scores", "_host")

    def __init__(self, nodes_evaluated: int, nodes_filtered: int,
                 nodes_exhausted: int, constraint_filtered: Dict,
                 dimension_exhausted: Dict, topk_idx, topk_scores) -> None:
        self.nodes_evaluated = nodes_evaluated
        self.nodes_filtered = nodes_filtered
        self.nodes_exhausted = nodes_exhausted
        self.constraint_filtered = constraint_filtered
        self.dimension_exhausted = dimension_exhausted
        self.topk_idx = topk_idx
        self.topk_scores = topk_scores
        self._host = None

    def materialize(self):
        """A per-slot AllocMetric carrying the shared header."""
        from nomad_tpu_torch.structs.alloc import AllocMetric

        m = AllocMetric()
        m.nodes_evaluated = self.nodes_evaluated
        m.nodes_filtered = self.nodes_filtered
        m.nodes_exhausted = self.nodes_exhausted
        if self.constraint_filtered:
            m.constraint_filtered = dict(self.constraint_filtered)
        if self.dimension_exhausted:
            m.dimension_exhausted.update(self.dimension_exhausted)
        return m

    def slot_topk(self, slot: int):
        """(rows, scores) numpy for one slot; resolves the launch's
        top-k planes to host ONCE for all slots (runs inside the plan
        window's deferred drain, off the wave-critical path)."""
        if self._host is None:
            import numpy as np

            self._host = (np.asarray(self.topk_idx),
                          np.asarray(self.topk_scores))
        return self._host[0][slot], self._host[1][slot]


def scaffold_for(job, tg) -> TGScaffold:
    """The (job, tg) scaffold, memoized per tg object.

    AskTensor.build can raise AskLimitError — it happens before the
    cache insert, so the limit error surfaces per eval exactly as
    before and never caches a half-built scaffold."""
    key = id(tg)
    ent = _CACHE.get(key)
    if ent is not None and ent[0] is tg:
        return ent[1]
    built = TGScaffold(job, tg)
    with _LOCK:
        ent = _CACHE.get(key)
        if ent is not None and ent[0] is tg:
            return ent[1]
        _CACHE[key] = (tg, built)
        _CACHE.move_to_end(key)
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return built
