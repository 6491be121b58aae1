"""BlockedEvals: evals that failed placement, waiting for capacity.

Reference behavior: nomad/blocked_evals.go. Evals whose placements were
exhausted are captured (one per job -- duplicates are surfaced for
cancellation), classified by computed node class eligibility, and
re-enqueued into the EvalBroker when capacity changes: a node update or
alloc stop calls ``unblock(computed_class, index)``; escaped evals (ones
whose constraints escaped class-level feasibility caching) unblock on
any change. ``unblock_indexes`` guards the race where capacity changed
after the scheduler's snapshot but before Block() (blocked_evals.go
missedUnblock semantics).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation


class BlockedStats:
    def __init__(self) -> None:
        self.total_blocked = 0
        self.total_escaped = 0
        self.total_quota_limit = 0


class BlockedEvals:
    def __init__(self, enqueue_fn: Callable[[Evaluation], None]) -> None:
        # enqueue_fn feeds unblocked evals back to the broker
        # (reference wires evalBroker directly, blocked_evals.go:93)
        self._enqueue = enqueue_fn
        self._lock = threading.Lock()
        self._enabled = False
        # eval id -> eval (captured, blocked_evals.go `captured`)
        self._captured: Dict[str, Evaluation] = {}
        # eval id -> eval with escaped computed class (`escaped`)
        self._escaped: Dict[str, Evaluation] = {}
        # (ns, job) -> eval id, one blocked eval per job (`jobs`)
        self._jobs: Dict[Tuple[str, str], str] = {}
        # duplicates awaiting cancellation (`duplicates`)
        self._duplicates: List[Evaluation] = []
        self._dup_cond = threading.Condition(self._lock)
        # computed class -> last unblock index (`unblockIndexes`)
        self._unblock_indexes: Dict[str, int] = {}
        # quota id -> blocked eval ids
        self._quota: Dict[str, set] = {}

    # --- lifecycle ------------------------------------------------------

    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev, self._enabled = self._enabled, enabled
        if prev and not enabled:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            self._captured.clear()
            self._escaped.clear()
            self._jobs.clear()
            self._duplicates.clear()
            self._unblock_indexes.clear()
            self._quota.clear()
            self._dup_cond.notify_all()

    # --- block (blocked_evals.go Block/processBlock) --------------------

    def block(self, ev: Evaluation) -> None:
        with self._lock:
            if not self._enabled:
                return
            if ev.id in self._captured or ev.id in self._escaped:
                return
            ns_job = (ev.namespace, ev.job_id)
            existing_id = self._jobs.get(ns_job)
            if existing_id is not None and existing_id != ev.id:
                # one blocked eval per job: newer eval wins, older is a
                # duplicate surfaced for cancellation
                old = self._captured.pop(existing_id, None) or \
                    self._escaped.pop(existing_id, None)
                if old is not None:
                    if old.quota_limit_reached:
                        self._quota.get(old.quota_limit_reached, set()).discard(old.id)
                    self._duplicates.append(old)
                    self._dup_cond.notify_all()
            # missed-unblock check: if capacity changed at an index newer
            # than this eval's snapshot, re-enqueue immediately
            if self._missed_unblock(ev):
                self._jobs.pop(ns_job, None)
                self._enqueue(ev)
                return
            self._jobs[ns_job] = ev.id
            if ev.quota_limit_reached:
                self._quota.setdefault(ev.quota_limit_reached, set()).add(ev.id)
            if ev.escaped_computed_class:
                self._escaped[ev.id] = ev
            else:
                self._captured[ev.id] = ev

    def reblock(self, ev: Evaluation) -> None:
        """Re-block an eval the broker still holds unacked
        (blocked_evals.go Reblock): same tracking, Ack-side handled by
        the worker path."""
        self.block(ev)

    def _missed_unblock(self, ev: Evaluation) -> bool:
        for cls, index in self._unblock_indexes.items():
            if index <= ev.snapshot_index:
                continue
            elig = ev.class_eligibility.get(cls)
            if elig is False:
                continue          # class known-infeasible for this eval
            if elig is True or ev.escaped_computed_class or elig is None:
                return True
        return False

    # --- unblock (blocked_evals.go Unblock/unblock) ---------------------

    def unblock(self, computed_class: str, index: int) -> int:
        with self._lock:
            if not self._enabled:
                return 0
            self._unblock_indexes[computed_class] = max(
                self._unblock_indexes.get(computed_class, 0), index
            )
            unblock: List[Evaluation] = list(self._escaped.values())
            for ev in list(self._captured.values()):
                elig = ev.class_eligibility.get(computed_class)
                if elig is False:
                    continue
                unblock.append(ev)
            return self._release_locked(unblock)

    def unblock_quota(self, quota: str, index: int) -> int:
        with self._lock:
            if not self._enabled:
                return 0
            ids = self._quota.get(quota, set())
            unblock = [
                self._captured.get(i) or self._escaped.get(i) for i in ids
            ]
            return self._release_locked([e for e in unblock if e is not None])

    def unblock_failed(self) -> int:
        """Periodic unblock of evals blocked due to scheduler failures
        (leader.go periodicUnblockFailedEvals)."""
        with self._lock:
            unblock = [
                e
                for e in list(self._captured.values()) + list(self._escaped.values())
                if e.triggered_by == consts.EVAL_TRIGGER_MAX_PLAN_ATTEMPTS
            ]
            return self._release_locked(unblock)

    def unblock_node(self, node_id: str, index: int) -> int:
        """Unblock evals blocked on a specific node (system scheduler
        exhaustion; blocked_evals_system.go)."""
        with self._lock:
            unblock = [
                e
                for e in list(self._captured.values()) + list(self._escaped.values())
                if e.node_id == node_id
            ]
            return self._release_locked(unblock)

    def _release_locked(self, evals: List[Evaluation]) -> int:
        n = 0
        for ev in evals:
            if self._captured.pop(ev.id, None) is None and \
               self._escaped.pop(ev.id, None) is None:
                continue
            self._jobs.pop((ev.namespace, ev.job_id), None)
            if ev.quota_limit_reached:
                self._quota.get(ev.quota_limit_reached, set()).discard(ev.id)
            self._enqueue(ev)
            n += 1
        return n

    def untrack(self, namespace: str, job_id: str) -> None:
        """Job deregistered: drop its blocked eval (UntrackJob)."""
        with self._lock:
            eval_id = self._jobs.pop((namespace, job_id), None)
            if eval_id:
                old = self._captured.pop(eval_id, None) or \
                    self._escaped.pop(eval_id, None)
                if old is not None and old.quota_limit_reached:
                    self._quota.get(old.quota_limit_reached, set()).discard(eval_id)

    # --- duplicates (blocked_evals.go GetDuplicates) --------------------

    def get_duplicates(self, timeout: float = 0.0) -> List[Evaluation]:
        deadline = time.time() + timeout
        with self._lock:
            while not self._duplicates:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return []
                self._dup_cond.wait(remaining)
            dups, self._duplicates = self._duplicates, []
            return dups

    # --- stats ----------------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            return {
                "total_blocked": len(self._captured) + len(self._escaped),
                "total_escaped": len(self._escaped),
                "total_quota_limit": sum(len(v) for v in self._quota.values()),
            }
