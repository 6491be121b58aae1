"""Scheduler package: the capability layer around the placement kernels.

Counterpart of ``nomad_tpu/scheduler/``: the Scheduler factory registry
(reference scheduler.go:24-61), the reconciler (reconcile.go), the
placement stack (stack.go), host-side feasibility and eligibility
caching (feasible.go), preemption, and the test harness (testing.go).
``service`` and ``batch`` (and the ``xla-binpack`` alias) are
registered; the system scheduler is not ported yet, and
``new_scheduler("system", ...)`` raises a ``ValueError`` naming it.
"""

from nomad_tpu_torch.scheduler.scheduler import (  # noqa: F401
    BUILTIN_SCHEDULERS,
    Planner,
    Scheduler,
    SchedulerState,
    SetStatusError,
    new_scheduler,
)
from nomad_tpu_torch.scheduler.generic import GenericScheduler  # noqa: F401
