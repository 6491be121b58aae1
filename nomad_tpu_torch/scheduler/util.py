"""Scheduler utilities (reference: scheduler/util.go).

taintedNodes (:427), updateNonTerminalAllocsToLost (:—), tasksUpdated
(:488), genericAllocUpdateFn (:1118), adjustQueuedAllocations,
setStatus helpers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import Allocation


def tainted_nodes(state, allocs: List[Allocation]) -> Dict[str, object]:
    """Nodes (by id) that are draining/down/disconnected/missing, for the
    set of nodes hosting these allocs (util.go:427)."""
    out: Dict[str, object] = {}
    seen = set()
    for a in allocs:
        if a.node_id in seen:
            continue
        seen.add(a.node_id)
        node = state.node_by_id(a.node_id)
        if node is None:
            out[a.node_id] = None
            continue
        if node.drain or node.status in (
            consts.NODE_STATUS_DOWN, consts.NODE_STATUS_DISCONNECTED
        ):
            out[a.node_id] = node
    return out


def update_non_terminal_allocs_to_lost(plan, tainted: Dict[str, object],
                                       allocs: List[Allocation]) -> None:
    """Mark non-terminal allocs on down nodes lost (util.go
    updateNonTerminalAllocsToLost)."""
    for a in allocs:
        if a.node_id not in tainted:
            continue
        node = tainted[a.node_id]
        if node is not None and node.status != consts.NODE_STATUS_DOWN:
            continue
        if a.desired_status in (consts.ALLOC_DESIRED_STOP, consts.ALLOC_DESIRED_EVICT) \
                and a.client_status in (consts.ALLOC_CLIENT_RUNNING, consts.ALLOC_CLIENT_PENDING):
            plan.append_stopped_alloc(
                a, "alloc lost since its node is down", consts.ALLOC_CLIENT_LOST
            )


def networks_updated(a: List, b: List) -> bool:
    if len(a) != len(b):
        return True
    for an, bn in zip(a, b):
        if an.mode != bn.mode or an.mbits != bn.mbits:
            return True
        aports = [(p.label, p.value, p.to) for p in an.reserved_ports] + [
            (p.label, 0, p.to) for p in an.dynamic_ports
        ]
        bports = [(p.label, p.value, p.to) for p in bn.reserved_ports] + [
            (p.label, 0, p.to) for p in bn.dynamic_ports
        ]
        if sorted(aports) != sorted(bports):
            return True
    return False


def tasks_updated(job_a, job_b, group_name: str) -> bool:
    """Whether the group requires a destructive update (util.go:488)."""
    a = job_a.lookup_task_group(group_name)
    b = job_b.lookup_task_group(group_name)
    if a is None or b is None:
        return True
    if len(a.tasks) != len(b.tasks):
        return True
    if (a.ephemeral_disk.size_mb, a.ephemeral_disk.sticky, a.ephemeral_disk.migrate) != (
        b.ephemeral_disk.size_mb, b.ephemeral_disk.sticky, b.ephemeral_disk.migrate
    ):
        return True
    if networks_updated(a.networks, b.networks):
        return True
    # affinities/spreads at job+tg level
    if repr(job_a.affinities) != repr(job_b.affinities):
        return True
    if repr(a.affinities) != repr(b.affinities):
        return True
    if repr(job_a.spreads) != repr(job_b.spreads):
        return True
    if repr(a.spreads) != repr(b.spreads):
        return True
    if repr(a.volumes) != repr(b.volumes):
        return True
    for at in a.tasks:
        bt = b.lookup_task(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver or at.user != bt.user:
            return True
        if at.config != bt.config or at.env != bt.env:
            return True
        if repr(at.artifacts) != repr(bt.artifacts):
            return True
        if repr(at.templates) != repr(bt.templates):
            return True
        if networks_updated(at.resources.networks, bt.resources.networks):
            return True
        ar, br = at.resources, bt.resources
        if (ar.cpu, ar.cores, ar.memory_mb, ar.memory_max_mb) != (
            br.cpu, br.cores, br.memory_mb, br.memory_max_mb
        ):
            return True
        if repr(ar.devices) != repr(br.devices):
            return True
        if repr(at.constraints) != repr(bt.constraints):
            return True
    return False


def generic_alloc_update_fn(ctx, stack, eval_id: str):
    """allocUpdateType factory (util.go:1118 genericAllocUpdateFn):
    decides ignore / destructive / in-place for an existing alloc vs the
    new job version.
    """

    def update_fn(existing: Allocation, new_job, new_tg) -> Tuple[bool, bool, Optional[Allocation]]:
        ejob = existing.job
        if ejob is not None and ejob.job_modify_index == new_job.job_modify_index:
            return True, False, None
        if ejob is not None and tasks_updated(new_job, ejob, new_tg.name):
            return False, True, None
        if existing.terminal_status():
            return True, False, None

        node = ctx.state.node_by_id(existing.node_id)
        if node is None:
            return False, True, None
        if node.datacenter not in new_job.datacenters:
            return False, True, None

        # In-place resource re-check (util.go:1158-1168 stages an
        # eviction then runs a single-node Select). The tensorized build
        # does the equivalent host-side with no kernel launch: the new
        # resources must fit alongside the node's proposed allocs minus
        # the alloc being updated -- networks/devices/ports carry over
        # unchanged (guarded by tasks_updated), so cpu/mem/disk/cores
        # arithmetic is the entire question.
        from nomad_tpu_torch.scheduler.scaffold import scaffold_for
        from nomad_tpu_torch.structs.alloc import Allocation as _Alloc
        from nomad_tpu_torch.structs.resources import (
            AllocatedCpuResources,
            AllocatedMemoryResources,
            AllocatedResources,
            AllocatedSharedResources,
            AllocatedTaskResources,
            allocs_fit,
        )

        try:
            scaffold = scaffold_for(new_job, new_tg)
        except Exception:                       # noqa: BLE001
            # ask-limit overruns surface on the placement path, not
            # here — an in-place update stays possible without one
            scaffold = None
        ecr, euses_ports, euses_devices = existing.fit_meta()
        if scaffold is not None and scaffold.lean_assign \
                and not euses_ports \
                and not euses_devices and not ecr.reserved_cores:
            # lean in-place update (no networks/ports/devices/cores to
            # carry over): ride the (job, tg)-shared frozen skeleton —
            # this path runs once per updated alloc per eval
            _, _, new_resources = scaffold.lean_planes(False)
        else:
            new_resources = AllocatedResources(
                tasks={},
                task_lifecycles={},
                shared=AllocatedSharedResources(disk_mb=new_tg.ephemeral_disk.size_mb),
            )
            for task in new_tg.tasks:
                r = task.resources
                tr = AllocatedTaskResources(
                    cpu=AllocatedCpuResources(cpu_shares=int(r.cpu)),
                    memory=AllocatedMemoryResources(memory_mb=int(r.memory_mb)),
                )
                new_resources.tasks[task.name] = tr
                new_resources.task_lifecycles[task.name] = task.lifecycle
            if existing.allocated_resources is not None:
                for task_name, tr in new_resources.tasks.items():
                    old_tr = existing.allocated_resources.tasks.get(task_name)
                    if old_tr is not None:
                        tr.networks = [n.copy() for n in old_tr.networks]
                        tr.devices = list(old_tr.devices)
                        tr.cpu.reserved_cores = list(old_tr.cpu.reserved_cores)
                new_resources.shared.networks = list(
                    existing.allocated_resources.shared.networks
                )
                new_resources.shared.ports = list(existing.allocated_resources.shared.ports)

        proposed = [
            a for a in ctx.proposed_allocs(existing.node_id) if a.id != existing.id
        ]
        probe = _Alloc(id="_inplace_probe", allocated_resources=new_resources)
        fit, _, _ = allocs_fit(node, proposed + [probe])
        if not fit:
            return False, True, None

        new_alloc = existing.copy_skip_job()
        new_alloc.eval_id = eval_id
        new_alloc.job = None  # use the job in the plan
        new_alloc.allocated_resources = new_resources
        new_alloc.metrics = existing.metrics.copy() if existing.metrics else None
        return False, False, new_alloc

    return update_fn


def adjust_queued_allocations(result, queued: Dict[str, int]) -> None:
    """Decrement queued counts by successfully planned allocs
    (util.go adjustQueuedAllocations)."""
    if result is None:
        return
    for allocs in result.node_allocation.values():
        for a in allocs:
            if a.create_index != result.alloc_index:
                continue
            if a.task_group in queued:
                queued[a.task_group] -= 1
