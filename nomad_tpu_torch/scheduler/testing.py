"""Scheduler test harness.

Reference behavior: scheduler/testing.go Harness (:48-301) -- a real
StateStore plus a fake Planner that applies submitted plans directly to
the store (SubmitPlan :90), capturing plans/evals for assertions. The
whole scheduler runs against it without a server or raft.

Counterpart of ``nomad_tpu/scheduler/testing.py``: ``device`` is the
one every scheduler the harness makes runs its default launcher on (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.scheduler.scheduler import new_scheduler
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs.eval_plan import Evaluation, Plan, PlanResult


class Harness:
    def __init__(self, state: Optional[StateStore] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.state = state or StateStore()
        self.plans: List[Plan] = []
        self.planner_calls: List[str] = []
        self.evals: List[Evaluation] = []
        self.create_evals: List[Evaluation] = []
        self.reblock_evals: List[Evaluation] = []
        self.reject_plan = False          # fault injection (testing.go:19)
        self._lock = threading.Lock()

    # -- Planner interface (testing.go:90 SubmitPlan) --------------------

    def submit_plan(self, plan: Plan) -> Tuple[Optional[PlanResult], Optional[object]]:
        plan.run_deferred()
        with self._lock:
            self.plans.append(plan)
            if self.reject_plan:
                result = PlanResult(refresh_index=self.state.latest_index())
                return result, self.state.snapshot()
            result = PlanResult(
                node_update=plan.node_update,
                node_allocation=plan.node_allocation,
                node_preemptions=plan.node_preemptions,
                deployment=plan.deployment,
                deployment_updates=plan.deployment_updates,
            )
            index = self.state.upsert_plan_results(
                0, plan, plan.node_allocation, plan.node_update,
                plan.node_preemptions, plan.deployment, plan.deployment_updates,
            )
            result.alloc_index = index
            return result, None

    def update_eval(self, evaluation: Evaluation) -> None:
        with self._lock:
            self.evals.append(evaluation)

    def create_eval(self, evaluation: Evaluation) -> None:
        with self._lock:
            self.create_evals.append(evaluation)

    def reblock_eval(self, evaluation: Evaluation) -> None:
        with self._lock:
            self.reblock_evals.append(evaluation)

    def serve_rs_meet_minimum_version(self) -> bool:
        return True

    # -- driving ---------------------------------------------------------

    def process(self, scheduler_name: str, evaluation: Evaluation) -> None:
        """testing.go Process: snapshot state, run the named scheduler."""
        snap = self.state.snapshot()
        sched = new_scheduler(scheduler_name, snap, self, device=self.device)
        sched.process(evaluation)

    # -- assertion helpers ----------------------------------------------

    def placed_allocs(self) -> List:
        return [
            a
            for plan in self.plans
            for allocs in plan.node_allocation.values()
            for a in allocs
        ]

    def stopped_allocs(self) -> List:
        return [
            a
            for plan in self.plans
            for allocs in plan.node_update.values()
            for a in allocs
        ]
