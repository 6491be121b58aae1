"""PlanQueue: the leader's serialized queue of submitted plans.

Reference behavior: nomad/plan_queue.go (:30-259). Workers submit plans
with a future; the single plan-applier goroutine pops them in priority
order (then FIFO) and resolves the future with the PlanResult after
Raft commit. Serialization here is what makes optimistic scheduler
concurrency safe.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs.eval_plan import Plan, PlanResult
from nomad_tpu_torch.utils.faultpoints import fault
from nomad_tpu_torch.utils.metrics import global_registry
from nomad_tpu_torch.utils.wavecohort import wave_cohorts
from nomad_tpu_torch.utils.witness import witness_lock


class PendingPlan:
    def __init__(self, plan: Plan) -> None:
        self.plan = plan
        self.enqueued_at = time.monotonic()   # applier stage timing
        self._done = threading.Event()
        self._result: Optional[PlanResult] = None
        self._error: Optional[Exception] = None

    # future (plan_queue.go planFuture)
    def respond(self, result: Optional[PlanResult], err: Optional[Exception]) -> None:
        self._result = result
        self._error = err
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        if not self._done.wait(timeout):
            raise TimeoutError("plan result timeout")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class PlanQueue:
    def __init__(self) -> None:
        self._lock = witness_lock("PlanQueue._lock")
        self._cond = threading.Condition(self._lock)
        self._enabled = False
        self._heap: List[Tuple[int, int, PendingPlan]] = []
        self._seq = itertools.count()

    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev, self._enabled = self._enabled, enabled
            if prev and not enabled:
                self._flush_locked()
            self._cond.notify_all()

    def _update_depth_gauge(self) -> None:
        # nomad.plan.queue_depth (plan_queue.go Stats/EmitStats):
        # sustained depth means the serialized applier is the
        # bottleneck. Updated on every transition — a gauge set only
        # on enqueue would report the last burst's depth forever.
        global_registry.set_gauge(
            "nomad.plan.queue_depth", float(len(self._heap)))

    def _flush_locked(self) -> None:
        for _, _, pending in self._heap:
            pending.respond(None, RuntimeError("plan queue flushed"))
        self._heap.clear()
        self._update_depth_gauge()

    def enqueue(self, plan: Plan) -> PendingPlan:
        # submit seam (chaos plane): an injected error is a plan that
        # never reached the applier — the worker nacks its eval and the
        # broker redelivers (outside the lock on purpose: latency
        # injection must not stretch the queue's critical section)
        fault("plan.queue.enqueue")
        with self._lock:
            if not self._enabled:
                raise RuntimeError("plan queue is disabled")
            pending = PendingPlan(plan)
            heapq.heappush(
                self._heap, (-plan.priority, next(self._seq), pending)
            )
            # drain the wave cohort BEFORE the notify: the waiter in
            # dequeue_batch re-checks the tracker on wakeup, so the
            # cohort's last plan must already be accounted or the
            # applier would sleep its full window for nothing
            wave_cohorts.note_plan()
            self._update_depth_gauge()
            self._cond.notify_all()
            return pending

    def dequeue(self, timeout: Optional[float] = None) -> Optional[PendingPlan]:
        with self._lock:
            if not self._heap:
                self._cond.wait(timeout)
            if not self._heap:
                return None
            out = heapq.heappop(self._heap)[2]
            self._update_depth_gauge()
            return out

    def dequeue_batch(self, max_n: int,
                      timeout: Optional[float] = None) -> List[PendingPlan]:
        """Pop up to ``max_n`` plans in priority order.

        A burst of optimistically-scheduled evals lands a burst of
        plans; draining them together lets the applier evaluate the
        whole burst against one view and commit it as ONE raft entry
        (the TPU build's plan-side analog of eval batching). An empty
        list means the timeout passed with nothing queued.

        Wave-boundary drain: while a fired wave's plan
        cohort is still landing (utils/wavecohort — armed by the
        coalescer, drained per enqueue, bounded by the adaptive
        deadline), the pop WAITS for the stragglers instead of
        committing a wave as ~6 raft entries. The deadline caps the
        added latency; cohort shortfalls expire it.
        """
        with self._lock:
            if not self._heap:
                self._cond.wait(timeout)
            if self._heap:
                while len(self._heap) < max_n and self._enabled:
                    wait_s = wave_cohorts.pending_wait_s()
                    if wait_s <= 0.0:
                        break
                    self._cond.wait(wait_s)
            out = []
            while self._heap and len(out) < max_n:
                out.append(heapq.heappop(self._heap)[2])
            if out:
                self._update_depth_gauge()
            return out

    def stats(self) -> Dict:
        with self._lock:
            return {"depth": len(self._heap)}
