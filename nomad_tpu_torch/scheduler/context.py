"""Evaluation context: shared caches, proposed-alloc algebra, metrics.

Reference behavior: scheduler/context.go -- ``EvalContext`` (:127),
``ProposedAllocs`` (:173: existing - stopped/preempted + planned per
node), ``EvalEligibility`` class-level feasibility memoization (:254).
Counterpart of ``nomad_tpu/scheduler/context.py``; the context also
binds the device that its default launcher runs on.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.structs.alloc import AllocMetric, Allocation, remove_allocs
from nomad_tpu_torch.structs.eval_plan import Plan


# EvalEligibility tri-state (context.go:243-251)
ELIGIBILITY_UNKNOWN = 0
ELIGIBLE = 1
INELIGIBLE = 2


class EvalEligibility:
    """Tracks feasibility per computed node class so whole classes are
    checked once per eval (context.go:254; feasible.go:1050)."""

    def __init__(self) -> None:
        self.job: Dict[str, int] = {}           # computed class -> tri-state
        self.tgs: Dict[str, Dict[str, int]] = {}  # tg -> class -> tri-state
        self._has_escaped = False               # constraint not class-checkable
        self.quota_reached = ""

    def set_job(self, job) -> None:
        """Determine if the job + tgs contain 'escaping' constraints --
        ones on unique (per-node) properties that the class cache cannot
        memoize (context.go SetJob)."""
        self._has_escaped = _constraints_escape(job.constraints)
        for tg in job.task_groups:
            esc = _constraints_escape(tg.constraints)
            for task in tg.tasks:
                esc = esc or _constraints_escape(task.constraints)
            if esc:
                self._has_escaped = True

    def has_escaped(self) -> bool:
        return self._has_escaped

    def get_classes(self) -> Dict[str, bool]:
        """Merged class eligibility for blocked evals (context.go GetClasses)."""
        out: Dict[str, bool] = {}
        for cls, st in self.job.items():
            if st == INELIGIBLE:
                out[cls] = False
            elif st == ELIGIBLE:
                out[cls] = True
        for tg_classes in self.tgs.values():
            for cls, st in tg_classes.items():
                if st == INELIGIBLE and cls not in out:
                    out[cls] = False
                elif st == ELIGIBLE:
                    out[cls] = True
        return out

    def job_status(self, cls: str) -> int:
        if not cls:
            return ELIGIBILITY_UNKNOWN
        return self.job.get(cls, ELIGIBILITY_UNKNOWN)

    def set_job_eligibility(self, eligible: bool, cls: str) -> None:
        if cls:
            self.job[cls] = ELIGIBLE if eligible else INELIGIBLE

    def tg_status(self, tg: str, cls: str) -> int:
        if not cls:
            return ELIGIBILITY_UNKNOWN
        return self.tgs.get(tg, {}).get(cls, ELIGIBILITY_UNKNOWN)

    def set_tg_eligibility(self, eligible: bool, tg: str, cls: str) -> None:
        if cls:
            self.tgs.setdefault(tg, {})[cls] = ELIGIBLE if eligible else INELIGIBLE


def _constraints_escape(constraints) -> bool:
    for c in constraints:
        for target in (c.ltarget, c.rtarget):
            if "${node.unique." in target or "${attr.unique." in target or "${meta.unique." in target:
                return True
    return False


class PortCollisionEvent:
    """Operator-visible scheduler-state inconsistency (context.go:81;
    emitted from binpack when the NetworkIndex collides on node state,
    rank.go:213-236)."""

    def __init__(self, reason: str, node=None, allocations=None) -> None:
        self.reason = reason
        self.node = node
        self.allocations = allocations or []


class EvalContext:
    """Per-evaluation context (context.go:127)."""

    def __init__(self, state, plan: Plan, logger=None, events_cb=None,
                 kernel_launch=None, device: DeviceLike = None) -> None:
        self.state = state
        self.plan = plan
        self.logger = logger
        self.events_cb = events_cb
        self.eligibility = EvalEligibility()
        self.metrics_obj = AllocMetric()
        # per-eval decorrelation seed for stochastic dynamic-port
        # assignment (network.go:598); None = precise selection
        self.port_seed: Optional[int] = None
        # the placement-kernel dispatch point: defaults to the direct
        # candidate-set/full dispatcher on ``device`` (the card unless
        # the caller names the CPU); a batching worker injects a
        # LaunchCoalescer so concurrent evals share one joint launch
        # (parallel/coalesce.py)
        if kernel_launch is None:
            from nomad_tpu_torch.ops.kernel import default_kernel_launch

            kernel_launch = functools.partial(
                default_kernel_launch, device=resolve_device(device))
        self.kernel_launch = kernel_launch

    def metrics(self) -> AllocMetric:
        return self.metrics_obj

    def reset_metrics(self) -> None:
        self.metrics_obj = AllocMetric()

    def send_event(self, event) -> None:
        if self.events_cb is not None:
            self.events_cb(event)

    def proposed_allocs(self, node_id: str) -> List[Allocation]:
        """Allocs expected on the node after this plan applies
        (context.go:173): existing non-terminal, minus plan stops and
        preemptions, plus plan placements."""
        existing = [
            a for a in self.state.allocs_by_node(node_id)
            if not a.terminal_status()
        ]
        stopping = self.plan.node_update.get(node_id, [])
        preempting = self.plan.node_preemptions.get(node_id, [])
        proposed = remove_allocs(existing, list(stopping) + list(preempting))
        # index by ID so an in-place update (same ID in state and in
        # plan.node_allocation) overrides instead of double counting
        # (context.go:193-207)
        by_id = {a.id: a for a in proposed}
        for a in self.plan.node_allocation.get(node_id, []):
            by_id[a.id] = a
        return list(by_id.values())
