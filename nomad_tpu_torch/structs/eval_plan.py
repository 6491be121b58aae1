"""Evaluation, Plan, PlanResult, Deployment.

Reference behavior: nomad/structs/structs.go Evaluation (:10739),
Plan (:11120), PlanResult (:11375), Deployment/DeploymentState.
"""

from __future__ import annotations

import copy as _copy
import time as _time
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nomad_tpu_torch.structs.alloc import Allocation
from nomad_tpu_torch.structs.consts import (
    ALLOC_DESIRED_EVICT,
    ALLOC_DESIRED_STOP,
    DEPLOYMENT_STATUS_RUNNING,
    EVAL_STATUS_CANCELLED,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    EVAL_STATUS_PENDING,
)


import random as _random
import threading as _threading

#: process-local RNG seeded from real entropy ONCE. ``uuid.uuid4``
#: reads os.urandom per call — an entropy syscall that costs ~0.5ms on
#: common container kernels, and the scheduling hot path mints an id
#: per allocation, per dequeue token, and per eval copy: at bench
#: batch sizes that was several milliseconds of wall per evaluation
#: spent in getrandom(2). These ids are resource NAMES — they need
#: uniqueness, not unpredictability; a 128-bit Mersenne draw seeded
#: from urandom keeps the collision odds identical in practice.
_UUID_RNG = _random.Random(_uuid.uuid4().int)
_UUID_LOCK = _threading.Lock()


def generate_uuid() -> str:
    with _UUID_LOCK:
        bits = _UUID_RNG.getrandbits(128)
    return str(_uuid.UUID(int=bits, version=4))


@dataclass
class Evaluation:
    """A request to (re)schedule a job (structs.go:10739)."""

    id: str = field(default_factory=generate_uuid)
    namespace: str = "default"
    priority: int = 50
    type: str = "service"           # scheduler type
    triggered_by: str = ""
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""
    wait_until_s: float = 0.0        # delayed eval (epoch seconds)
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    related_evals: List[str] = field(default_factory=list)
    # tg -> {node_id} that failed placement; used by blocked-eval dedup
    failed_tg_allocs: Dict[str, object] = field(default_factory=dict)
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    quota_limit_reached: str = ""
    queued_allocations: Dict[str, int] = field(default_factory=dict)
    annotate_plan: bool = False
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    create_time_ns: int = 0
    modify_time_ns: int = 0
    leader_ack: str = ""             # broker token

    def terminal_status(self) -> bool:
        return self.status in (
            EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED, EVAL_STATUS_CANCELLED
        )

    def should_enqueue(self) -> bool:
        return self.status in (EVAL_STATUS_PENDING,)

    def should_block(self) -> bool:
        return self.status == "blocked"

    def make_plan(self, job) -> "Plan":
        """structs.go Evaluation.MakePlan."""
        return Plan(
            eval_id=self.id,
            priority=self.priority,
            job=job,
            all_at_once=bool(job and job.all_at_once),
        )

    def copy(self) -> "Evaluation":
        # targeted copy instead of deepcopy: the worker copies every
        # dequeued eval before mutating status (worker.py), so this
        # runs once per eval on the hot path. Scalars ride a shallow
        # copy; the four mutable containers are rebuilt; only
        # failed_tg_allocs holds nested mutable state (AllocMetric)
        # and is usually empty outside blocked evals.
        new = _copy.copy(self)
        new.related_evals = list(self.related_evals)
        new.class_eligibility = dict(self.class_eligibility)
        new.queued_allocations = dict(self.queued_allocations)
        new.failed_tg_allocs = {
            tg: _copy.deepcopy(m) for tg, m in self.failed_tg_allocs.items()
        }
        return new

    def create_blocked_eval(self, class_eligibility, escaped, quota_reached, failed_tg_allocs) -> "Evaluation":
        """structs.go Evaluation.CreateBlockedEval."""
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by="queued-allocs",
            job_id=self.job_id,
            status="blocked",
            previous_eval=self.id,
            class_eligibility=dict(class_eligibility or {}),
            escaped_computed_class=escaped,
            quota_limit_reached=quota_reached,
            failed_tg_allocs=dict(failed_tg_allocs or {}),
            # inherited so BlockedEvals' missed-unblock check compares
            # against the snapshot this eval was actually scheduled from
            snapshot_index=self.snapshot_index,
        )

    def create_failed_follow_up_eval(self, wait_s: float) -> "Evaluation":
        """``wait_s`` is a delay from now; wait_until_s stores absolute
        epoch seconds (structs.go CreateFailedFollowUpEval uses
        now.Add(wait))."""
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by="failed-follow-up",
            job_id=self.job_id,
            status=EVAL_STATUS_PENDING,
            wait_until_s=_time.time() + wait_s,
            previous_eval=self.id,
        )


@dataclass
class Plan:
    """The scheduler's proposed state mutation (structs.go:11120).

    Per-node lists keep the leader's plan applier able to re-validate each
    node independently (plan_apply.go:644).
    """

    eval_id: str = ""
    eval_token: str = ""
    priority: int = 50
    all_at_once: bool = False
    job: Optional[object] = None
    # node_id -> allocs to stop/evict on that node (with updated statuses)
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    # node_id -> new/updated allocs on that node
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    # node_id -> allocs preempted to make room
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    annotations: Optional["PlanAnnotations"] = None
    deployment: Optional["Deployment"] = None
    # deployment id -> status update
    deployment_updates: List[Dict] = field(default_factory=list)
    snapshot_index: int = 0
    #: deferred host-side post-processing (AllocMetric top-k
    #: materialization, scheduler/stack.py): thunks that must run
    #: before the plan is applied but NOT on the wave-critical eval
    #: path — the batching worker runs them inside its plan window,
    #: overlapping the next wave's execute. Never serialized.
    deferred_work: List = field(default_factory=list, repr=False,
                                compare=False)

    def run_deferred(self) -> None:
        """Run + drain the deferred post-processing (idempotent; every
        submit_plan entry point calls it, first caller does the
        work). Own span: this CPU runs inside the batching worker's
        plan window — overlapping the next wave's execute — so the
        decomposition attributes it as plan post-processing, not
        wave-critical scheduling."""
        if not self.deferred_work:
            return
        from nomad_tpu_torch.telemetry.trace import tracer

        with tracer.span("plan.deferred"):
            while self.deferred_work:
                fn = self.deferred_work.pop()
                fn()

    def append_stopped_alloc(self, alloc: Allocation, desired_desc: str, client_status: str = "", follow_up_eval_id: str = "") -> None:
        """structs.go Plan.AppendStoppedAlloc."""
        new = alloc.copy_skip_job()
        new.desired_status = ALLOC_DESIRED_STOP
        new.desired_description = desired_desc
        if client_status:
            new.client_status = client_status
        if follow_up_eval_id:
            new.follow_up_eval_id = follow_up_eval_id
        self.node_update.setdefault(alloc.node_id, []).append(new)

    def append_alloc(self, alloc: Allocation, job=None) -> None:
        """structs.go Plan.AppendAlloc."""
        if job is not None:
            alloc.job = job
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_preempted_alloc(self, alloc: Allocation, preempting_alloc_id: str) -> None:
        """structs.go Plan.AppendPreemptedAlloc."""
        new = alloc.copy_skip_job()
        new.desired_status = ALLOC_DESIRED_EVICT
        new.preempted_by_allocation = preempting_alloc_id
        new.desired_description = f"Preempted by alloc ID {preempting_alloc_id}"
        self.node_preemptions.setdefault(alloc.node_id, []).append(new)

    def is_no_op(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and self.deployment is None
            and not self.deployment_updates
        )


@dataclass
class PlanResult:
    """What the plan applier actually committed (structs.go:11375)."""

    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    deployment: Optional["Deployment"] = None
    deployment_updates: List[Dict] = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0

    def full_commit(self, plan: Plan):
        """Returns (fully_committed, expected, actual)."""
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual, expected, actual

    def is_no_op(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and not self.deployment_updates
            and self.deployment is None
        )


@dataclass
class PlanAnnotations:
    """`job plan` dry-run annotations (structs.go PlanAnnotations)."""

    desired_tg_updates: Dict[str, "DesiredUpdates"] = field(default_factory=dict)
    preempted_allocs: List[Dict] = field(default_factory=list)


@dataclass
class DesiredUpdates:
    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
    canary: int = 0
    preemptions: int = 0


@dataclass
class DeploymentState:
    """Per-task-group deployment progress (structs.go DeploymentState)."""

    placed_canaries: List[str] = field(default_factory=list)
    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline_s: float = 600.0
    require_progress_by_s: float = 0.0


@dataclass
class Deployment:
    """A rolling update of a job version (structs.go Deployment)."""

    id: str = field(default_factory=generate_uuid)
    namespace: str = "default"
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    job_spec_modify_index: int = 0
    job_create_index: int = 0
    is_multiregion: bool = False
    task_groups: Dict[str, DeploymentState] = field(default_factory=dict)
    status: str = DEPLOYMENT_STATUS_RUNNING
    status_description: str = "Deployment is running"
    create_index: int = 0
    modify_index: int = 0

    def active(self) -> bool:
        return self.status in ("running", "paused", "blocked", "unblocking", "pending")

    def requires_promotion(self) -> bool:
        return any(
            s.desired_canaries > 0 and not s.promoted for s in self.task_groups.values()
        )

    def has_auto_promote(self) -> bool:
        return bool(self.task_groups) and all(
            s.auto_promote for s in self.task_groups.values() if s.desired_canaries > 0
        )

    def copy(self) -> "Deployment":
        return _copy.deepcopy(self)


def new_deployment(job) -> Deployment:
    """structs.go NewDeployment. Per-TG DeploymentState is populated by the
    reconciler as it computes placements, matching the reference."""
    d = Deployment(
        namespace=job.namespace,
        job_id=job.id,
        job_version=job.version,
        job_modify_index=job.modify_index,
        job_create_index=job.create_index,
        status="running",
    )
    return d
