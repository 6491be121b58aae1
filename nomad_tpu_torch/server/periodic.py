"""Periodic dispatcher: cron-launched child jobs.

Reference behavior: nomad/periodic.go (628 LoC) -- the leader tracks
periodic jobs in a time-ordered heap; at each launch time it derives a
child job named ``<id>/periodic-<epoch>`` and registers it (creating
the eval). ``prohibit_overlap`` skips a launch while a previous child
is still running. The tracker is restored on leadership change
(leader.go:684 restorePeriodicDispatcher).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Tuple

from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.utils.cron import CronExpr
from nomad_tpu_torch.utils.delayheap import DelayHeap

LOG = logging.getLogger(__name__)


def periodic_child_id(parent_id: str, launch_time: float) -> str:
    return f"{parent_id}/periodic-{int(launch_time)}"


class PeriodicDispatcher:
    def __init__(self, server) -> None:
        self.server = server
        self._lock = threading.Lock()
        self._enabled = False
        # (ns, job_id) -> (job, CronExpr)
        self._tracked: Dict[Tuple[str, str], Tuple[object, CronExpr]] = {}
        self._heap = DelayHeap()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev, self._enabled = self._enabled, enabled
            if not enabled:
                self._tracked.clear()
                self._heap = DelayHeap()
        if enabled and not prev:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="periodic-dispatcher"
            )
            self._thread.start()
        self._wake.set()

    def restore(self, snapshot) -> None:
        """leader.go restorePeriodicDispatcher: re-track all periodic
        jobs from replicated state; any job whose next launch after its
        recorded last launch has already passed is force-run to catch
        up (the periodic_launch ledger survives leader failover)."""
        now = time.time()
        for job in snapshot.jobs():
            if not (job.is_periodic() and not job.stop):
                continue
            self.add(job)
            last = self.server.state.periodic_launch_by_id(
                job.namespace, job.id
            )
            if last <= 0:
                continue
            with self._lock:
                entry = self._tracked.get((job.namespace, job.id))
            if entry is None:   # add() rejected the spec
                continue
            _job, expr = entry
            if expr.next_after(last) < now:
                try:
                    self._dispatch(job)
                except Exception as e:          # noqa: BLE001
                    LOG.warning("periodic catch-up %s failed: %s", job.id, e)

    # --- tracking (periodic.go Add/Remove) ------------------------------

    def add(self, job) -> None:
        if not job.is_periodic() or job.stop:
            self.remove(job.namespace, job.id)
            return
        try:
            expr = CronExpr(job.periodic.spec)
        except (ValueError, IndexError) as e:
            LOG.warning("periodic job %s: bad spec %r: %s",
                        job.id, job.periodic.spec, e)
            return
        key = (job.namespace, job.id)
        with self._lock:
            if not self._enabled:
                return
            self._tracked[key] = (job, expr)
            next_t = expr.next_after(time.time())
            self._heap.push(f"{key[0]}/{key[1]}", next_t, key)
        self._wake.set()

    def remove(self, namespace: str, job_id: str) -> None:
        with self._lock:
            self._tracked.pop((namespace, job_id), None)
            self._heap.remove(f"{namespace}/{job_id}")

    def tracked_count(self) -> int:
        with self._lock:
            return len(self._tracked)

    # --- launch loop ----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._lock:
                if not self._enabled:
                    return
                due = self._heap.pop_due(time.time())
                launches = []
                for _hid, key in due:
                    entry = self._tracked.get(key)
                    if entry is None:
                        continue
                    job, expr = entry
                    launches.append(job)
                    self._heap.push(
                        f"{key[0]}/{key[1]}",
                        expr.next_after(time.time()),
                        key,
                    )
                head = self._heap.peek()
            for job in launches:
                try:
                    self._dispatch(job)
                except Exception as e:          # noqa: BLE001
                    LOG.warning("periodic launch %s failed: %s", job.id, e)
            wait = max(head[1] - time.time(), 0.02) if head else 0.5
            self._wake.wait(wait)
            self._wake.clear()

    def force_run(self, parent) -> str:
        """periodic_endpoint.go Force: launch the child now regardless
        of schedule; returns the child job id."""
        return self._dispatch(parent, force=True) or ""

    def _dispatch(self, parent, force: bool = False) -> Optional[str]:
        """periodic.go createEval: derive + register the child job."""
        now = time.time()
        if not force and parent.periodic.prohibit_overlap \
                and self._child_running(parent):
            LOG.info("periodic job %s: skipping launch (overlap prohibited)",
                     parent.id)
            return None
        child = parent.copy()
        child.id = periodic_child_id(parent.id, now)
        child.parent_id = parent.id
        child.periodic = None
        child.stop = False
        from nomad_tpu_torch.server import fsm as fsm_msgs
        from nomad_tpu_torch.structs.eval_plan import Evaluation

        ev = Evaluation(
            namespace=child.namespace,
            priority=child.priority,
            type=child.type,
            triggered_by=consts.EVAL_TRIGGER_PERIODIC_JOB,
            job_id=child.id,
            status=consts.EVAL_STATUS_PENDING,
        )
        self.server.raft_apply(
            fsm_msgs.JOB_REGISTER, {"job": child, "evals": [ev]}
        )
        # ledger write so a new leader knows the last launch
        # (periodic.go createEval -> UpsertPeriodicLaunch)
        self.server.raft_apply(fsm_msgs.PERIODIC_LAUNCH_UPSERT, {
            "namespace": parent.namespace, "job_id": parent.id,
            "launch_time": now,
        })
        return child.id

    def _child_running(self, parent) -> bool:
        snap = self.server.state.snapshot()
        for job in snap.jobs():
            if getattr(job, "parent_id", "") != parent.id:
                continue
            allocs = snap.allocs_by_job(job.namespace, job.id)
            if any(not a.client_terminal_status() for a in allocs):
                return True
            evals = snap.evals_by_job(job.namespace, job.id)
            if any(not e.terminal_status() for e in evals):
                return True
        return False
