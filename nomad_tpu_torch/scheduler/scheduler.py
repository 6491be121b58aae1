"""Scheduler interface and factory registry.

Reference behavior: scheduler/scheduler.go -- ``BuiltinSchedulers``
(:24-38), ``NewScheduler`` factory (:42-61), the ``State`` (:67) and
``Planner`` (:105) interfaces that decouple the scheduler from the
server. The TPU build registers the same four builtin types plus
``xla-binpack`` (the BASELINE.json north star): the generic scheduler
*is* the XLA path, so ``xla-binpack`` is an alias that forces the
batched kernel; the host fallback is available for differential tests.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Protocol, Tuple

from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation, Plan, PlanResult


class SchedulerState(Protocol):
    """Immutable snapshot the scheduler reads (scheduler.go:67-103)."""

    def nodes(self) -> List: ...
    def node_by_id(self, node_id: str): ...
    def job_by_id(self, namespace: str, job_id: str): ...
    def allocs_by_job(self, namespace: str, job_id: str, anyCreateIndex: bool = True) -> List: ...
    def allocs_by_node(self, node_id: str) -> List: ...
    def latest_deployment_by_job_id(self, namespace: str, job_id: str): ...
    def latest_index(self) -> int: ...


class Planner(Protocol):
    """How the scheduler submits work (scheduler.go:105-141)."""

    def submit_plan(self, plan: Plan) -> Tuple[Optional[PlanResult], Optional[SchedulerState]]: ...
    def update_eval(self, eval: Evaluation) -> None: ...
    def create_eval(self, eval: Evaluation) -> None: ...
    def reblock_eval(self, eval: Evaluation) -> None: ...
    def serve_rs_meet_minimum_version(self) -> bool: ...


class SetStatusError(Exception):
    """Terminal scheduling failure carrying the eval status to set
    (reference scheduler/util.go SetStatusError)."""

    def __init__(self, status: str, desc: str) -> None:
        super().__init__(desc)
        self.eval_status = status
        self.desc = desc


class Scheduler:
    """Base interface (scheduler.go:51-61)."""

    def process(self, evaluation: Evaluation) -> None:
        raise NotImplementedError


SchedulerFactory = Callable[..., Scheduler]

BUILTIN_SCHEDULERS: Dict[str, SchedulerFactory] = {}


def register_scheduler(name: str, factory: SchedulerFactory) -> None:
    BUILTIN_SCHEDULERS[name] = factory


def new_scheduler(name: str, state: SchedulerState, planner: Planner, **kw) -> Scheduler:
    """scheduler.go:42 NewScheduler."""
    factory = BUILTIN_SCHEDULERS.get(name)
    if factory is None:
        raise ValueError(f"unknown scheduler '{name}'")
    return factory(state=state, planner=planner, **kw)


def retry_max(limit: int, fn: Callable[[], Tuple[bool, Optional[Exception]]],
              reset: Optional[Callable[[], bool]] = None) -> None:
    """Run fn up to `limit` times, resetting attempts on progress
    (reference scheduler/util.go:391 retryMax)."""
    attempts = 0
    while attempts < limit:
        done, err = fn()
        if err is not None:
            raise err
        if done:
            return
        if reset is not None and reset():
            attempts = 0
        else:
            attempts += 1
    raise SetStatusError(
        consts.EVAL_STATUS_FAILED,
        f"maximum attempts reached ({limit})",
    )


def progress_made(result: Optional[PlanResult]) -> bool:
    """scheduler/util.go progressMade."""
    return result is not None and (
        bool(result.node_update)
        or bool(result.node_allocation)
        or result.deployment is not None
        or bool(result.deployment_updates)
    )
