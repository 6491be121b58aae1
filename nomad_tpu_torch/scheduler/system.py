"""SystemScheduler: one alloc per eligible node (system + sysbatch).

Reference behavior: scheduler/scheduler_system.go (:27-527): per-node
diff instead of the reconciler -- place on every feasible node missing
an alloc, stop allocs on ineligible/removed nodes, update on job change.

TPU formulation: feasibility for ALL nodes computes in one kernel pass
(the mask planes), then exact host assignment runs per placed node --
there is no scoring/argmax because system jobs place everywhere feasible.

Counterpart of ``nomad_tpu/scheduler/system.py``. The feasibility pass
is ``_feasible_mask``, a torch op on the scheduler's ``device`` (the card
unless the caller names the CPU): the eval's planes, with the snapshot's
shared planes taken from their resident twins, through the composite's
``_feasible`` with every feature on, and the mask and the six fit planes
read back in one copy. The cluster comes from the device's
``default_cluster_cache`` when no provider is given.
"""

from __future__ import annotations

import threading
import time as _time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.ops.kernel import (
    FULL_FEATURES,
    KernelIn,
    _feasible,
    _resident_kin,
    _upload_kin,
    build_kernel_in,
)
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.scheduler import (
    Planner,
    Scheduler,
    SchedulerState,
    SetStatusError,
    progress_made,
    register_scheduler,
    retry_max,
)
from nomad_tpu_torch.scheduler.stack import XLAGenericStack, _NodeAssigner
from nomad_tpu_torch.scheduler.util import (
    tainted_nodes,
    tasks_updated,
    update_non_terminal_allocs_to_lost,
)
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import AllocMetric, Allocation
from nomad_tpu_torch.structs.eval_plan import Evaluation
from nomad_tpu_torch.tensors.schema import ClusterTensors

MAX_SYSTEM_ATTEMPTS = 5     # scheduler_system.go:20
MAX_SYSBATCH_ATTEMPTS = 2


#: calls of ``_feasible_mask`` in this process (one per task group of
#: a system or sysbatch eval attempt)
mask_launches = 0
_MASK_LAUNCHES_LOCK = threading.Lock()


def _mask_stack(kin: KernelIn):
    """``(planes, names)``: the full-feature feasibility mask of ``kin``
    and its per-dimension fit planes, stacked bool[7, N] on the planes'
    device, and the fit planes' names."""
    st = dict(
        used_cpu=kin.used_cpu, used_mem=kin.used_mem, used_disk=kin.used_disk,
        used_cores=kin.used_cores, used_mbits=kin.used_mbits,
        free_dyn=kin.free_dyn, port_conflict=kin.port_conflict,
        dev_free=kin.dev_free, job_tg_count=kin.job_tg_count,
        job_any_count=kin.job_any_count, spread_counts=kin.spread_counts,
    )
    feasible, _, dims = _feasible(kin, st, FULL_FEATURES)
    return torch.stack([feasible, *dims.values()]), list(dims)


def _feasible_mask(kin: KernelIn, device: DeviceLike = None):
    """``(mask, dims)`` of one eval on ``device``: the full-feature
    feasibility mask bool[N] and the per-dimension fit planes (cpu, mem,
    disk, cores, ports, devices), as host numpy from one readback."""
    global mask_launches
    dev = resolve_device(device)
    planes, names = _mask_stack(_upload_kin(_resident_kin(kin, dev), dev))
    flat = planes.cpu().numpy()
    with _MASK_LAUNCHES_LOCK:
        mask_launches += 1
    return flat[0], {n: flat[i + 1] for i, n in enumerate(names)}


class SystemScheduler(Scheduler):
    def __init__(self, state: SchedulerState, planner: Planner,
                 sysbatch: bool = False, events_cb=None,
                 kernel_launch=None, cluster_provider=None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.state = state
        self.planner = planner
        self.sysbatch = sysbatch
        self.events_cb = events_cb
        self.kernel_launch = kernel_launch
        self.cluster_provider = cluster_provider
        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan = None
        self.plan_result = None
        self.ctx: Optional[EvalContext] = None
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}
        self.queued_allocs: Dict[str, int] = {}

    def process(self, evaluation: Evaluation) -> None:
        self.eval = evaluation
        valid = {
            consts.EVAL_TRIGGER_JOB_REGISTER, consts.EVAL_TRIGGER_JOB_DEREGISTER,
            consts.EVAL_TRIGGER_NODE_UPDATE, consts.EVAL_TRIGGER_NODE_DRAIN,
            consts.EVAL_TRIGGER_ALLOC_STOP, consts.EVAL_TRIGGER_ROLLING_UPDATE,
            consts.EVAL_TRIGGER_PERIODIC_JOB, consts.EVAL_TRIGGER_MAX_PLAN_ATTEMPTS,
            consts.EVAL_TRIGGER_QUEUED_ALLOCS, consts.EVAL_TRIGGER_SCALING,
            consts.EVAL_TRIGGER_RECONNECT,
        }
        if evaluation.triggered_by not in valid:
            self._set_status(
                consts.EVAL_STATUS_FAILED,
                f"scheduler cannot handle '{evaluation.triggered_by}' evaluation reason",
            )
            return
        limit = MAX_SYSBATCH_ATTEMPTS if self.sysbatch else MAX_SYSTEM_ATTEMPTS
        try:
            retry_max(limit, self._process, lambda: progress_made(self.plan_result))
        except SetStatusError as e:
            self._set_status(e.eval_status, e.desc)
            return
        self._set_status(consts.EVAL_STATUS_COMPLETE, "")

    def _process(self):
        self.job = self.state.job_by_id(self.eval.namespace, self.eval.job_id)
        self.plan = self.eval.make_plan(self.job)
        self.failed_tg_allocs = {}
        self.queued_allocs = {}
        self.ctx = EvalContext(self.state, self.plan, events_cb=self.events_cb,
                               kernel_launch=self.kernel_launch,
                               device=self.device)
        # decorrelate concurrent evals' dynamic-port picks, like the
        # generic scheduler (network.go:598 stochastic selection)
        import zlib

        self.ctx.port_seed = zlib.crc32(
            f"{self.eval.id}:{self.state.latest_index()}".encode()
        )

        allocs = self.state.allocs_by_job(self.eval.namespace, self.eval.job_id)
        tainted = tainted_nodes(self.state, allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

        live_allocs = [a for a in allocs if not a.terminal_status()]

        stopped = self.job is None or self.job.stopped()
        if stopped:
            for a in live_allocs:
                self.plan.append_stopped_alloc(a, "alloc not needed due to job update")
        else:
            self._compute_system_placements(live_allocs, tainted)

        if self.plan.is_no_op():
            return True, None
        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result
        if new_state is not None:
            self.state = new_state
            return False, None
        full, _, _ = result.full_commit(self.plan)
        if not full:
            return False, None
        return True, None

    def _compute_system_placements(self, live_allocs: List[Allocation], tainted) -> None:
        if self.cluster_provider is not None:
            cluster = self.cluster_provider(self.state)
        else:
            from nomad_tpu_torch.parallel.coalesce import default_cluster_cache

            cluster = default_cluster_cache(self.device).get(self.state)
        stack = XLAGenericStack(False, self.ctx, cluster)
        stack.set_job(self.job)
        now = _time.time()

        by_node_tg: Dict[tuple, List[Allocation]] = {}
        for a in live_allocs:
            by_node_tg.setdefault((a.node_id, a.task_group), []).append(a)

        eligible_rows = set()
        for tg in self.job.task_groups:
            ev = stack._build_eval_tensors(tg, np.zeros(cluster.n_pad, bool))
            kin = build_kernel_in(cluster, ev, 1)
            feasible, dims = _feasible_mask(kin, self.device)
            feasible = np.asarray(feasible)

            placed = 0
            for i in range(cluster.n_real):
                nid = cluster.node_ids[i]
                node = self.state.node_by_id(nid)
                existing = by_node_tg.get((nid, tg.name), [])
                node_ok = node is not None and node.ready() and nid not in tainted

                if existing:
                    if not node_ok:
                        # drain/down handling: reschedule via lost marking
                        for a in existing:
                            if node is None or node.status == consts.NODE_STATUS_DOWN:
                                self.plan.append_stopped_alloc(
                                    a, "alloc lost since its node is down",
                                    consts.ALLOC_CLIENT_LOST,
                                )
                            else:
                                self.plan.append_stopped_alloc(
                                    a, "alloc not needed as node is tainted"
                                )
                        continue
                    # job version update check
                    a0 = existing[0]
                    if a0.job is not None and a0.job.job_modify_index != self.job.job_modify_index:
                        if tasks_updated(self.job, a0.job, tg.name):
                            # evict first so the fit check sees the node
                            # without the old alloc (scheduler_system.go
                            # evictAndPlace ordering)
                            self.plan.append_stopped_alloc(
                                a0, "alloc is being updated due to job update"
                            )
                            if self._fits_after_evict(node, tg):
                                self._place_on(cluster, tg, i, now)
                                placed += 1
                            else:
                                m = self.failed_tg_allocs.setdefault(
                                    tg.name, AllocMetric()
                                )
                                m.exhausted_node(node, "resources")
                        else:
                            update = a0.copy_skip_job()
                            update.eval_id = self.eval.id
                            update.job = None
                            self.plan.append_alloc(update, None)
                    continue

                if not node_ok or not ev.base_mask[i]:
                    continue
                if not feasible[i]:
                    # preemption attempt (scheduler_system.go: system
                    # preemption defaults on) before reporting exhaustion
                    if self.state.scheduler_config.preemption_enabled(
                        self.job.type
                    ) and self._place_preempting(cluster, tg, i, now):
                        placed += 1
                        continue
                    # resource-exhausted eligible node -> failed placement
                    m = self.failed_tg_allocs.setdefault(tg.name, AllocMetric())
                    m.exhausted_node(node, "resources")
                    self.queued_allocs[tg.name] = self.queued_allocs.get(tg.name, 0)
                    continue
                self._place_on(cluster, tg, i, now)
                placed += 1
            self.queued_allocs.setdefault(tg.name, 0)

    def _fits_after_evict(self, node, tg) -> bool:
        """Host-side fit re-check with plan-staged evictions excluded."""
        from nomad_tpu_torch.structs.resources import allocs_fit
        from nomad_tpu_torch.tensors.schema import AskTensor

        ask = AskTensor.build(tg)
        proposed = self.ctx.proposed_allocs(node.id)
        probe = Allocation(
            id="_probe",
            allocated_resources=_ask_to_allocated(ask),
        )
        fit, _, _ = allocs_fit(node, proposed + [probe])
        return fit

    def _place_preempting(self, cluster, tg, row: int, now: float) -> bool:
        """Evict lower-priority allocs on this node so the system alloc
        fits (the SystemScheduler preemption branch)."""
        from nomad_tpu_torch.scheduler.preemption import Preemptor
        from nomad_tpu_torch.scheduler.stack import _tg_comparable_ask

        node = self.state.node_by_id(cluster.node_ids[row])
        if node is None:
            return False
        proposed = self.ctx.proposed_allocs(node.id)
        preemptor = Preemptor(self.job.priority, self.job.namespace, self.job.id)
        preemptor.set_node(node)
        preemptor.set_candidates(proposed)
        preemptor.set_preemptions(
            [a for allocs in self.plan.node_preemptions.values() for a in allocs]
        )
        victims = preemptor.preempt_for_task_group(_tg_comparable_ask(tg))
        if not victims:
            return False
        victim_ids = {a.id for a in victims}
        remaining = [a for a in proposed if a.id not in victim_ids]
        return self._place_on(cluster, tg, row, now,
                              proposed=remaining, victims=victims)

    def _place_on(self, cluster, tg, row: int, now: float,
                  proposed=None, victims=None) -> bool:
        node = self.state.node_by_id(cluster.node_ids[row])
        assigner = _NodeAssigner(node, self.ctx, proposed=proposed)
        option = assigner.assign(tg, 0.0)
        if option is None:
            # the preempting path's caller records the exhaustion on
            # fall-through; recording here too would double count
            if victims is None:
                m = self.failed_tg_allocs.setdefault(tg.name, AllocMetric())
                m.exhausted_node(node, "resources")
            return False
        from nomad_tpu_torch.structs.resources import (
            AllocatedResources,
            AllocatedSharedResources,
        )

        resources = AllocatedResources(
            tasks=option.task_resources,
            task_lifecycles=option.task_lifecycles,
            shared=AllocatedSharedResources(disk_mb=tg.ephemeral_disk.size_mb),
        )
        if option.alloc_resources is not None:
            resources.shared.networks = option.alloc_resources.networks
            resources.shared.ports = option.alloc_resources.ports
        alloc = Allocation(
            id=str(uuid.uuid4()),
            namespace=self.job.namespace,
            eval_id=self.eval.id,
            name=f"{self.job.id}.{tg.name}[0]",
            job_id=self.job.id,
            job_version=self.job.version,
            task_group=tg.name,
            metrics=AllocMetric(),
            node_id=option.node_id,
            node_name=node.name,
            allocated_resources=resources,
            desired_status=consts.ALLOC_DESIRED_RUN,
            client_status=consts.ALLOC_CLIENT_PENDING,
            create_time_ns=int(now * 1e9),
            modify_time_ns=int(now * 1e9),
        )
        if victims:
            preempted_ids = []
            for stop in victims:
                self.plan.append_preempted_alloc(stop, alloc.id)
                preempted_ids.append(stop.id)
            alloc.preempted_allocations = preempted_ids
        self.plan.append_alloc(alloc, None)
        return True

    def _set_status(self, status: str, desc: str) -> None:
        new_eval = self.eval.copy()
        new_eval.status = status
        new_eval.status_description = desc
        if self.failed_tg_allocs:
            new_eval.failed_tg_allocs = dict(self.failed_tg_allocs)
        if self.queued_allocs:
            new_eval.queued_allocations = dict(self.queued_allocs)
        self.planner.update_eval(new_eval)


def _ask_to_allocated(ask):
    from nomad_tpu_torch.structs.resources import (
        AllocatedCpuResources,
        AllocatedMemoryResources,
        AllocatedResources,
        AllocatedSharedResources,
        AllocatedTaskResources,
    )

    return AllocatedResources(
        tasks={
            "_probe": AllocatedTaskResources(
                cpu=AllocatedCpuResources(cpu_shares=int(ask.cpu)),
                memory=AllocatedMemoryResources(memory_mb=int(ask.mem)),
            )
        },
        shared=AllocatedSharedResources(disk_mb=int(ask.disk)),
    )


def _system_factory(state, planner, **kw):
    return SystemScheduler(state, planner, sysbatch=False, **kw)


def _sysbatch_factory(state, planner, **kw):
    return SystemScheduler(state, planner, sysbatch=True, **kw)


register_scheduler(consts.JOB_TYPE_SYSTEM, _system_factory)
register_scheduler(consts.JOB_TYPE_SYSBATCH, _sysbatch_factory)
