"""GenericScheduler: service + batch evaluation processing.

Reference behavior: scheduler/generic_sched.go (:94-843). Process runs
the retry loop (5 service / 2 batch attempts, :16-23), each attempt:
job + deployment lookup -> reconciler -> batched placements through the
XLA stack -> plan submit; failed placements create/reuse a blocked eval
(:219), delayed reschedules create WaitUntil follow-up evals (:63-69).

TPU deviation (the whole point): computePlacements (:499) collapses the
per-alloc Select loop into one ``select_many`` kernel launch per task
group, carrying per-placement penalty/preferred planes.

Counterpart of ``nomad_tpu/scheduler/generic.py``. ``device`` names
where the default single-eval launcher runs (the card unless the caller
asks for the CPU); it is resolved when the scheduler is made, so a
machine without a card fails there rather than inside an eval.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.reconcile import (
    AllocReconciler,
    AllocPlaceResult,
    ReconcileResults,
)
from nomad_tpu_torch.scheduler.scheduler import (
    Planner,
    Scheduler,
    SchedulerState,
    SetStatusError,
    progress_made,
    register_scheduler,
    retry_max,
)
from nomad_tpu_torch.scheduler.stack import SelectRequest, XLAGenericStack
from nomad_tpu_torch.scheduler.util import (
    adjust_queued_allocations,
    generic_alloc_update_fn,
    tainted_nodes,
    update_non_terminal_allocs_to_lost,
)
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import AllocMetric, Allocation, RescheduleEvent, RescheduleTracker
from nomad_tpu_torch.structs.eval_plan import Evaluation, Plan, generate_uuid
from nomad_tpu_torch.telemetry.trace import tracer
from nomad_tpu_torch.tensors.schema import AskLimitError, ClusterTensors

MAX_SERVICE_ATTEMPTS = 5    # generic_sched.go:16
MAX_BATCH_ATTEMPTS = 2      # generic_sched.go:20

_VALID_TRIGGERS = frozenset({
    consts.EVAL_TRIGGER_JOB_REGISTER, consts.EVAL_TRIGGER_JOB_DEREGISTER,
    consts.EVAL_TRIGGER_NODE_DRAIN, consts.EVAL_TRIGGER_NODE_UPDATE,
    consts.EVAL_TRIGGER_ALLOC_STOP, consts.EVAL_TRIGGER_ROLLING_UPDATE,
    consts.EVAL_TRIGGER_QUEUED_ALLOCS, consts.EVAL_TRIGGER_PERIODIC_JOB,
    consts.EVAL_TRIGGER_MAX_PLAN_ATTEMPTS, consts.EVAL_TRIGGER_DEPLOYMENT_WATCHER,
    consts.EVAL_TRIGGER_RETRY_FAILED_ALLOC, consts.EVAL_TRIGGER_FAILED_FOLLOW_UP,
    consts.EVAL_TRIGGER_PREEMPTION, consts.EVAL_TRIGGER_SCALING,
    consts.EVAL_TRIGGER_MAX_DISCONNECT_TIMEOUT, consts.EVAL_TRIGGER_RECONNECT,
})
BLOCKED_EVAL_MAX_PLAN = "created due to placement conflicts"
BLOCKED_EVAL_FAILED_PLACEMENTS = "created to place remaining allocations"


class GenericScheduler(Scheduler):
    def __init__(self, state: SchedulerState, planner: Planner, batch: bool = False,
                 events_cb=None, kernel_launch=None, cluster_provider=None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.state = state
        self.planner = planner
        self.batch = batch
        self.events_cb = events_cb
        self.kernel_launch = kernel_launch
        self.cluster_provider = cluster_provider
        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan: Optional[Plan] = None
        self.plan_result = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[XLAGenericStack] = None
        self.deployment = None
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}
        self.queued_allocs: Dict[str, int] = {}
        self.followup_evals: List[Evaluation] = []
        self._cluster: Optional[ClusterTensors] = None

    # -- entry (generic_sched.go:144 Process) ----------------------------

    def process(self, evaluation: Evaluation) -> None:
        self.eval = evaluation
        if evaluation.triggered_by not in _VALID_TRIGGERS:
            self._set_status(
                consts.EVAL_STATUS_FAILED,
                f"scheduler cannot handle '{evaluation.triggered_by}' evaluation reason",
            )
            return

        limit = MAX_BATCH_ATTEMPTS if self.batch else MAX_SERVICE_ATTEMPTS
        try:
            retry_max(limit, self._process, lambda: progress_made(self.plan_result))
        except SetStatusError as e:
            # no forward progress: blocked eval + failed status
            self._create_blocked_eval(plan_failure=True)
            self._set_status(e.eval_status, e.desc)
            return
        except AskLimitError as e:
            self._set_status(consts.EVAL_STATUS_FAILED, str(e))
            return

        if self.eval.status == consts.EVAL_STATUS_BLOCKED and self.failed_tg_allocs:
            # reblock (generic_sched.go:205-215)
            e = self.ctx.eligibility
            new_eval = self.eval.copy()
            new_eval.escaped_computed_class = e.has_escaped()
            new_eval.class_eligibility = e.get_classes()
            new_eval.quota_limit_reached = e.quota_reached
            self.planner.reblock_eval(new_eval)
            return

        self._set_status(consts.EVAL_STATUS_COMPLETE, "")

    # -- one attempt (generic_sched.go:248 process) ----------------------

    def _process(self):
        self.job = self.state.job_by_id(self.eval.namespace, self.eval.job_id)
        self.queued_allocs = {}
        self.followup_evals = []
        self.plan = self.eval.make_plan(self.job)
        self.deployment = None
        if not self.batch and self.job is not None:
            self.deployment = self.state.latest_deployment_by_job_id(
                self.eval.namespace, self.eval.job_id
            )
        self.failed_tg_allocs = {}
        self.ctx = EvalContext(self.state, self.plan, events_cb=self.events_cb,
                               kernel_launch=self.kernel_launch,
                               device=self.device)
        self._cluster = self._build_cluster()
        self.stack = XLAGenericStack(self.batch, self.ctx, self._cluster)
        # decorrelate concurrent evals' tie-breaking (shuffleNodes
        # util.go:464: seeded by plan id + state index) and their
        # dynamic-port picks (network.go:598 stochastic selection)
        import zlib

        seed = zlib.crc32(
            f"{self.eval.id}:{self.state.latest_index()}".encode()
        )
        self.stack.shuffle_seed = seed
        self.ctx.port_seed = seed
        if self.job is not None and not self.job.stopped():
            self.stack.set_job(self.job)

        err = self._compute_job_allocs()
        if err is not None:
            return False, err

        delay_instead = bool(self.followup_evals) and self.eval.wait_until_s == 0.0

        if (
            self.eval.status != consts.EVAL_STATUS_BLOCKED
            and self.failed_tg_allocs
            and self.blocked is None
            and not delay_instead
        ):
            self._create_blocked_eval(plan_failure=False)

        if self.plan.is_no_op() and not self.eval.annotate_plan:
            return True, None

        if delay_instead:
            for ev in self.followup_evals:
                ev.previous_eval = self.eval.id
                self.planner.create_eval(ev)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        adjust_queued_allocations(result, self.queued_allocs)

        if new_state is not None:
            self.state = new_state
            return False, None

        full, expected, actual = result.full_commit(self.plan)
        if not full:
            return False, None
        return True, None

    def _build_cluster(self) -> ClusterTensors:
        if self.cluster_provider is not None:
            return self.cluster_provider(self.state)
        from nomad_tpu_torch.parallel.coalesce import default_cluster_cache

        return default_cluster_cache(self.device).get(self.state)

    # -- reconcile + placements (generic_sched.go:358,499) ---------------

    def _compute_job_allocs(self) -> Optional[Exception]:
        # the reconcile slice of sched-host, spanned on its own: the
        # largest single Python cost of the steady state
        # (TRACE_DECOMP stage "sched-reconcile"; see docs/PERF.md
        # "The reconcile fast path")
        with tracer.span("sched.reconcile"):
            allocs = self.state.allocs_by_job(
                self.eval.namespace, self.eval.job_id)
            tainted = tainted_nodes(self.state, allocs)
            update_non_terminal_allocs_to_lost(self.plan, tainted, allocs)

            job = self.job if self.job is not None else _dead_job_stub(self.eval)
            reconciler = AllocReconciler(
                generic_alloc_update_fn(self.ctx, self.stack, self.eval.id),
                self.batch, self.eval.job_id, job, self.deployment, allocs,
                tainted, self.eval.id, self.eval.priority,
            )
            results = reconciler.compute()

        if self.eval.annotate_plan:
            from nomad_tpu_torch.structs.eval_plan import PlanAnnotations

            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=results.desired_tg_updates
            )

        self.plan.deployment = results.deployment
        self.plan.deployment_updates = results.deployment_updates
        for evals in results.desired_followup_evals.values():
            self.followup_evals.extend(evals)
        if results.deployment is not None:
            self.deployment = results.deployment

        for stop in results.stop:
            self.plan.append_stopped_alloc(
                stop.alloc, stop.status_description, stop.client_status,
                stop.followup_eval_id,
            )
        for aid, update in results.disconnect_updates.items():
            self.plan.append_alloc(update, None)
        for update in results.inplace_update:
            if self.deployment is not None and update.deployment_id != self.deployment.id:
                update.deployment_id = self.deployment.id
                update.deployment_status = None
            self.plan.append_alloc(update, None)
        for update in results.attribute_updates.values():
            self.plan.append_alloc(update, None)

        if not results.place and not results.destructive_update:
            if self.job is not None:
                for tg in self.job.task_groups:
                    self.queued_allocs[tg.name] = 0
            return None

        for p in results.place:
            self.queued_allocs[p.task_group.name] = (
                self.queued_allocs.get(p.task_group.name, 0) + 1
            )
        for p in results.destructive_update:
            self.queued_allocs[p.place_task_group.name] = (
                self.queued_allocs.get(p.place_task_group.name, 0) + 1
            )
        return self._compute_placements(results)

    def _compute_placements(self, results: ReconcileResults) -> Optional[Exception]:
        """Destructive updates first (their resources free up), then new
        placements; each task group's asks batch into one kernel call."""
        deployment_id = ""
        if self.deployment is not None and self.deployment.active():
            deployment_id = self.deployment.id

        import time as _time

        now = _time.time()

        # group placement results by task group, preserving order
        ordered = list(results.destructive_update) + list(results.place)
        by_tg: Dict[str, List] = {}
        for missing in ordered:
            tg = missing.task_group if not hasattr(missing, "place_task_group") else missing.place_task_group
            by_tg.setdefault(tg.name, []).append(missing)

        for tg_name, missings in by_tg.items():
            tg = self.job.lookup_task_group(tg_name)
            if tg is None:
                continue
            if tg_name in self.failed_tg_allocs:
                self.failed_tg_allocs[tg_name].coalesced_failures += len(missings)
                continue

            requests = []
            for missing in missings:
                prev = missing.previous_alloc if hasattr(missing, "previous_alloc") else None
                penalty: List[str] = []
                preferred = ""
                if prev is not None:
                    is_resched = getattr(missing, "reschedule", False)
                    if is_resched:
                        penalty.append(prev.node_id)
                        if prev.reschedule_tracker:
                            for ev in prev.reschedule_tracker.events:
                                if ev.prev_node_id:
                                    penalty.append(ev.prev_node_id)
                    preferred = self._find_preferred_node(tg, prev) or ""
                # destructive updates stop their previous alloc first
                stop_prev, stop_desc = missing.stop_previous_alloc()
                if stop_prev and prev is not None:
                    self.plan.append_stopped_alloc(prev, stop_desc)
                requests.append(
                    SelectRequest(
                        name=missing.name,
                        prev_alloc=prev,
                        penalty_nodes=tuple(penalty),
                        preferred_node=preferred,
                    )
                )

            options = self.stack.select_many(tg, requests)
            preempt_ok = self._preemption_enabled()

            # the alloc-construction tail is the "plan build" slice of
            # the sched-host decomposition (bench/trace_report.py)
            self._append_placements(
                tg, tg_name, missings, requests, options, preempt_ok,
                deployment_id, now)
        return None

    def _append_placements(self, tg, tg_name, missings, requests,
                           options, preempt_ok, deployment_id,
                           now) -> None:
        with tracer.span("sched.planbuild"):
            self._append_placements_inner(
                tg, tg_name, missings, requests, options, preempt_ok,
                deployment_id, now)

    def _append_placements_inner(self, tg, tg_name, missings, requests,
                                 options, preempt_ok, deployment_id,
                                 now) -> None:
        for missing, req, option in zip(missings, requests, options):
            prev = req.prev_alloc
            if option is None and preempt_ok:
                # preemption second pass (generic_sched.go:800-819
                # selectNextOption), one slot at a time INSIDE the
                # placement loop: each call sees the plan with the
                # previous slots' placements and staged evictions,
                # so freed capacity and victims are never counted
                # twice across slots
                option = self.stack.select_preempting(tg, req)
            if option is None:
                if tg_name not in self.failed_tg_allocs:
                    m = self.ctx.metrics().copy()
                    m.nodes_in_pool = self._cluster.n_real
                    self.failed_tg_allocs[tg_name] = m
                else:
                    self.failed_tg_allocs[tg_name].coalesced_failures += 1
                # back out the staged stop of the previous alloc
                stop_prev, _ = missing.stop_previous_alloc()
                if stop_prev and prev is not None:
                    updates = self.plan.node_update.get(prev.node_id, [])
                    for i in range(len(updates) - 1, -1, -1):
                        if updates[i].id == prev.id:
                            updates.pop(i)
                            break
                continue

            if option.resources is not None:
                # lean fast path: the (job, tg)-shared frozen skeleton
                # (scheduler/scaffold.py) — no per-slot struct builds
                resources = option.resources
            else:
                from nomad_tpu_torch.structs.resources import (
                    AllocatedResources,
                    AllocatedSharedResources,
                )

                resources = AllocatedResources(
                    tasks=option.task_resources,
                    task_lifecycles=option.task_lifecycles,
                    shared=AllocatedSharedResources(
                        disk_mb=tg.ephemeral_disk.size_mb
                    ),
                )
                if option.alloc_resources is not None:
                    resources.shared.networks = \
                        option.alloc_resources.networks
                    resources.shared.ports = option.alloc_resources.ports

            alloc = Allocation(
                id=generate_uuid(),
                namespace=self.job.namespace,
                eval_id=self.eval.id,
                name=missing.name if not hasattr(missing, "place_name") else missing.place_name,
                job_id=self.job.id,
                job_version=self.job.version,
                task_group=tg.name,
                metrics=option.metrics,
                node_id=option.node_id,
                node_name=option.node.name,
                deployment_id=deployment_id,
                allocated_resources=resources,
                desired_status=consts.ALLOC_DESIRED_RUN,
                client_status=consts.ALLOC_CLIENT_PENDING,
                create_time_ns=int(now * 1e9),
                modify_time_ns=int(now * 1e9),
            )
            if prev is not None:
                alloc.previous_allocation = prev.id
                if getattr(missing, "reschedule", False):
                    _update_reschedule_tracker(alloc, prev, now)
            # handlePreemptions (generic_sched.go:821-843)
            if option.preempted_allocs:
                preempted_ids = []
                for stop in option.preempted_allocs:
                    self.plan.append_preempted_alloc(stop, alloc.id)
                    preempted_ids.append(stop.id)
                    if self.eval.annotate_plan and self.plan.annotations is not None:
                        desired = self.plan.annotations.desired_tg_updates.get(tg.name)
                        if desired is not None:
                            desired.preemptions += 1
                alloc.preempted_allocations = preempted_ids
            if getattr(missing, "canary", False) and self.deployment is not None:
                from nomad_tpu_torch.structs.alloc import AllocDeploymentStatus

                alloc.deployment_status = AllocDeploymentStatus(canary=True)
                dstate = self.deployment.task_groups.get(tg.name)
                if dstate is not None:
                    dstate.placed_canaries.append(alloc.id)

            self.plan.append_alloc(alloc, None)

    def _preemption_enabled(self) -> bool:
        """Scheduler-config preemption toggle for this job type
        (generic_sched.go:802-812; defaults: service/batch off)."""
        sched_type = self.job.type if self.job is not None else consts.JOB_TYPE_SERVICE
        return self.state.scheduler_config.preemption_enabled(sched_type)

    def _find_preferred_node(self, tg, prev) -> Optional[str]:
        """Sticky ephemeral disk prefers the previous node
        (generic_sched.go findPreferredNode)."""
        if prev is not None and tg.ephemeral_disk.sticky and not prev.should_migrate():
            return prev.node_id
        return None

    # -- status/blocked plumbing -----------------------------------------

    def _create_blocked_eval(self, plan_failure: bool) -> None:
        e = self.ctx.eligibility
        escaped = e.has_escaped()
        class_elig = None if escaped else e.get_classes()
        self.blocked = self.eval.create_blocked_eval(
            class_elig, escaped, e.quota_reached, self.failed_tg_allocs
        )
        if plan_failure:
            self.blocked.triggered_by = consts.EVAL_TRIGGER_MAX_PLAN_ATTEMPTS
            self.blocked.status_description = BLOCKED_EVAL_MAX_PLAN
        else:
            self.blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS
        self.planner.create_eval(self.blocked)

    def _set_status(self, status: str, desc: str) -> None:
        new_eval = self.eval.copy()
        new_eval.status = status
        new_eval.status_description = desc
        if self.blocked is not None:
            new_eval.blocked_eval = self.blocked.id
        if self.failed_tg_allocs:
            new_eval.failed_tg_allocs = dict(self.failed_tg_allocs)
        if self.queued_allocs:
            new_eval.queued_allocations = dict(self.queued_allocs)
        if self.deployment is not None:
            new_eval.deployment_id = self.deployment.id
        self.planner.update_eval(new_eval)


def _update_reschedule_tracker(alloc: Allocation, prev: Allocation, now: float) -> None:
    """generic_sched.go updateRescheduleTracker: carry forward events
    within the policy interval."""
    job = prev.job
    policy = job.reschedule_policy_for(prev.task_group) if job else None
    events: List[RescheduleEvent] = []
    if policy is not None:
        interval = policy.interval_s
        if prev.reschedule_tracker:
            for ev in prev.reschedule_tracker.events:
                if policy.unlimited or (
                    interval > 0 and now - ev.reschedule_time_ns / 1e9 <= interval
                ):
                    events.append(ev)
    events.append(
        RescheduleEvent(
            reschedule_time_ns=int(now * 1e9),
            prev_alloc_id=prev.id,
            prev_node_id=prev.node_id,
        )
    )
    alloc.reschedule_tracker = RescheduleTracker(events=events)


def _dead_job_stub(evaluation: Evaluation):
    """A stopped-job stand-in when the job was purged (the reconciler
    stops everything)."""
    from nomad_tpu_torch.structs.job import Job

    return Job(id=evaluation.job_id, namespace=evaluation.namespace, stop=True)


def _service_factory(state, planner, **kw):
    return GenericScheduler(state, planner, batch=False, **kw)


def _batch_factory(state, planner, **kw):
    return GenericScheduler(state, planner, batch=True, **kw)


register_scheduler(consts.JOB_TYPE_SERVICE, _service_factory)
register_scheduler(consts.JOB_TYPE_BATCH, _batch_factory)
# the BASELINE.json north star: the XLA-batched binpack path IS the
# generic scheduler; the name registers explicitly for API parity
register_scheduler("xla-binpack", _service_factory)
