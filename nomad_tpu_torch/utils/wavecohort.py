"""Wave-boundary plan-drain rendezvous.

A batched worker's wave of B evals lands ~B plans on the leader's plan
queue, but staggered: each member resumes from the kernel rendezvous,
builds its allocations, and submits on its own thread. The applier's
``dequeue_batch`` historically popped whatever had arrived when it woke
— ~5.6 plans per raft entry at batch 32 — so one wave cost ~6 raft
entries and ~6 FSM applies instead of one.

This tracker is the hint that closes the gap. The coalescer arms it
when a wave's device launch completes (``note_wave`` — the members are
about to build plans); every plan enqueue drains it (``note_plan``).
``PlanQueue.dequeue_batch`` keeps its condition-wait open while a
cohort is still landing (``pending_wait_s``), bounded by an adaptive
deadline — an EWMA of how long a cohort actually takes to drain, the
same self-correcting-window idea as the coalescer's adaptive park
deadline — so members that never submit (failed placements, no-op
plans) cost at most the window, never a hang.

Latency discipline: the deadline is the ONLY added wait, it is capped
(``WINDOW_MAX_S``), and it applies only while a wave is in flight;
single-plan traffic and idle queues behave exactly as before. The
steady-state e2e p99 gate (bench ``trace_e2e_p99_ms``) is the
regression guard.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from nomad_tpu_torch.utils.witness import witness_lock


class WaveCohortTracker:
    """Process-wide wave -> plan-queue drain accounting."""

    #: drain window = drain EWMA x this factor (headroom for jitter)
    WINDOW_FACTOR = 2.0
    WINDOW_MIN_S = 0.002
    WINDOW_MAX_S = 0.150
    #: first-cohort window before any drain sample exists
    WINDOW_DEFAULT_S = 0.025
    #: each landing plan keeps the window open this much longer (the
    #: cohort is visibly still draining); a shortfall therefore costs
    #: at most this gap past the LAST real plan
    ARRIVAL_GAP_S = 0.015
    #: absolute bound per armed cohort, whatever the flow does
    HARD_CAP_S = 0.250
    EWMA_ALPHA = 0.25

    def __init__(self) -> None:
        self._lock = witness_lock("WaveCohortTracker._lock")
        self._due = 0                 # plans still expected from fired waves
        self._deadline = 0.0
        self._hard = 0.0
        self._fire_t = 0.0
        self._drain_ewma: Optional[float] = None
        self.waves = 0
        self.cohort_plans = 0
        self.drained_cohorts = 0
        self.expired_cohorts = 0
        self.hard_cap_hits = 0

    def _window_s(self) -> float:
        if self._drain_ewma is None:
            return self.WINDOW_DEFAULT_S
        return min(max(self._drain_ewma * self.WINDOW_FACTOR,
                       self.WINDOW_MIN_S), self.WINDOW_MAX_S)

    def note_wave(self, members: int) -> None:
        """A wave of ``members`` evals just finished its device launch:
        ~that many plans are about to land on the queue."""
        if members <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self.waves += 1
            if self._due <= 0:
                self._fire_t = now
            self._due += members
            self._hard = max(self._hard, now + self.HARD_CAP_S)
            want = max(self._deadline, now + self._window_s())
            if want > self._hard:
                self.hard_cap_hits += 1
            self._deadline = min(want, self._hard)

    def note_plan(self) -> None:
        """One plan enqueued. A flowing cohort keeps its window open
        (arrival extension, hard-capped); when the whole cohort has
        landed, record the drain latency sample and release it."""
        with self._lock:
            if self._due <= 0:
                return
            self._due -= 1
            self.cohort_plans += 1
            now = time.monotonic()
            if self._due == 0:
                sample = now - self._fire_t
                if self._drain_ewma is None:
                    self._drain_ewma = sample
                else:
                    self._drain_ewma += self.EWMA_ALPHA * (
                        sample - self._drain_ewma)
                self.drained_cohorts += 1
                self._deadline = 0.0
            else:
                want = max(self._deadline, now + self.ARRIVAL_GAP_S)
                if want > self._hard:
                    self.hard_cap_hits += 1
                self._deadline = min(want, self._hard)

    def pending_wait_s(self) -> float:
        """Seconds the applier should keep its drain window open
        (0.0 = nothing outstanding, commit what you have)."""
        now = time.monotonic()
        with self._lock:
            if self._due <= 0:
                return 0.0
            if now >= self._deadline:
                # cohort shortfall (failed placements / no-op plans):
                # expire rather than stall the applier
                self._due = 0
                self._deadline = 0.0
                self.expired_cohorts += 1
                return 0.0
            return self._deadline - now

    def reset_stats(self) -> None:
        """Counters only — the learned drain EWMA survives (it is
        timing calibration, not burst data)."""
        with self._lock:
            self.waves = 0
            self.cohort_plans = 0
            self.drained_cohorts = 0
            self.expired_cohorts = 0
            self.hard_cap_hits = 0

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "waves": self.waves,
                "cohort_plans": self.cohort_plans,
                "drained_cohorts": self.drained_cohorts,
                "expired_cohorts": self.expired_cohorts,
                "hard_cap_hits": self.hard_cap_hits,
                "drain_ewma_ms": (self._drain_ewma or 0.0) * 1e3,
                "due": self._due,
            }


#: process-wide (the coalescer arms it, the plan queue drains it)
wave_cohorts = WaveCohortTracker()
