"""Deployment watcher: drives rolling updates, canaries, auto-revert.

Reference behavior: nomad/deploymentwatcher/ -- one watcher per active
deployment on the leader. Each watcher observes the deployment's allocs
via blocking queries, records health transitions through the Raft
boundary (UpdateDeploymentAllocHealth), promotes canaries when
auto_promote is set, creates follow-up evals so the scheduler places
the next batch, marks the deployment successful when every group hits
its desired healthy count, fails it on unhealthy allocs or a blown
progress deadline, and rolls the job back to the latest stable version
when auto_revert is set.

Deliberate redesign vs the reference: the reference runs one goroutine
per deployment; goroutines are cheap, Python threads are not. Here ONE
loop blocks on alloc/deployment state changes and ticks every active
deployment's rollout state machine from direct locked row reads — no
per-deployment thread, no per-tick whole-state snapshot. At bench
burst rates (hundreds of live deployments) the thread-per-deployment
design made the watcher tier the leader's dominant GIL load: every
plan commit woke every watcher thread and each copied the full state.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation

LOG = logging.getLogger(__name__)


class _TrackedDeployment:
    """One deployment's rollout-tracking state between ticks."""

    __slots__ = ("deadline", "last_healthy", "promoted")

    def __init__(self) -> None:
        self.deadline: Optional[float] = None
        self.last_healthy = -1
        self.promoted = False


class DeploymentsWatcher:
    """Tracks active deployments, all ticked by one loop
    (deployments_watcher.go Watcher)."""

    def __init__(self, server) -> None:
        self.server = server
        self._lock = threading.Lock()
        self._tracked: Dict[str, _TrackedDeployment] = {}
        self._health_seen: Dict[str, Dict[str, bool]] = {}
        self._enabled = False
        self._thread: Optional[threading.Thread] = None
        # idle-tick gates, mirroring the drainer/volume-watcher fix:
        # every alloc commit wakes the loop (the allocs watch drives
        # health progress), but with nothing tracked and no active
        # deployments the tick must not re-scan the deployments table.
        # The no-work proof is cached against the deployment table
        # index — alloc commits then return immediately, and only a
        # deployment write re-checks. -1 = unproven.
        self._idle_idx = -1
        self._mr_idle_idx = -1
        # multiregion terminal-transition work, derived from the
        # deployments table (NOT from watcher lifecycles): survives
        # leader restarts and retry exhaustion. deployment id ->
        # (next_attempt_monotonic, backoff_s); _mr_done holds ids whose
        # transition was delivered or proven unnecessary.
        self._mr_pending: Dict[str, List[float]] = {}
        self._mr_done: set = set()

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev, self._enabled = self._enabled, enabled
            self._idle_idx = -1
            self._mr_idle_idx = -1
            if not enabled:
                self._tracked.clear()
                self._health_seen.clear()
                # pending kicks re-derive from state on the next
                # leadership; _mr_done persists only as a memo
                self._mr_pending.clear()
        if enabled and not prev:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="deployments-watcher"
            )
            self._thread.start()

    def _run(self) -> None:
        index = 0
        while self._enabled:
            # health reports land on allocs; rollout counters on the
            # deployment rows — either should wake a tick
            index = self.server.state.block_until(
                ["allocs", "deployment"], index, timeout=0.5
            )
            if not self._enabled:
                return
            from nomad_tpu_torch.telemetry.trace import tracer

            with tracer.span("bg.deployments"):
                try:
                    self._tick_all()
                except Exception as e:          # noqa: BLE001
                    LOG.warning("deployments tick: %s", e)
                try:
                    self._scan_multiregion()
                except Exception as e:          # noqa: BLE001
                    LOG.warning("multiregion scan: %s", e)

    def _tick_all(self) -> None:
        # indexed early-out: with nothing tracked, an unchanged
        # deployments table proves there is still nothing to do — the
        # alloc-commit wakeups of a placement burst return here
        # without the active_deployments() table scan. Tracked
        # deployments always tick (progress deadlines fire on wall
        # time, not on state changes).
        state = self.server.state
        dep_idx = state.table_index(["deployment"])
        with self._lock:
            if not self._tracked and dep_idx == self._idle_idx:
                return
        active = state.active_deployments()
        active_ids = {d.id for d in active}
        with self._lock:
            if not self._enabled:
                return
            if not active and not self._tracked:
                self._idle_idx = dep_idx
            else:
                self._idle_idx = -1
            for did in list(self._tracked):
                if did not in active_ids:
                    # terminal or GC'd: multiregion follow-ups are the
                    # state-derived scan's job, nothing else to keep
                    self._tracked.pop(did, None)
                    self._health_seen.pop(did, None)
            work = [(d, self._tracked.setdefault(d.id, _TrackedDeployment()))
                    for d in active]
        for d, st in work:
            if d.status == consts.DEPLOYMENT_STATUS_BLOCKED:
                # multiregion gate: wait for an earlier region's kick;
                # the progress deadline starts when we unblock
                st.deadline = None
                continue
            if st.deadline is None:
                st.deadline = time.time() + max(
                    (s.progress_deadline_s for s in d.task_groups.values()),
                    default=600.0,
                )
            try:
                self._tick_one(d, st)
            except Exception as e:              # noqa: BLE001
                LOG.warning("deployment %s watcher: %s", d.id, e)

    def _tick_one(self, d, st: _TrackedDeployment) -> None:
        """One pass over the deployment's rolled-up counters (the store
        maintains them from client health reports,
        updateDeploymentWithAlloc). Terminal transitions change the
        row's status, so the next ``_tick_all`` pass drops it from the
        tracked set on its own."""
        if any(s.unhealthy_allocs > 0 for s in d.task_groups.values()):
            self._fail(d, "Failed due to unhealthy allocations")
            return
        if time.time() > st.deadline:
            self._fail(d, "Failed due to progress deadline")
            return

        # auto-promote canaries once they are all healthy
        if not st.promoted and d.requires_promotion() \
                and d.has_auto_promote():
            if all(
                s.healthy_allocs >= s.desired_canaries
                for s in d.task_groups.values() if s.desired_canaries > 0
            ):
                self.server.raft_apply(
                    fsm_msgs.DEPLOYMENT_PROMOTE,
                    {"deployment_id": d.id, "groups": None,
                     "evals": [self._new_eval(d)]},
                )
                st.promoted = True
                return

        # success when every group hit its target
        if d.task_groups and all(
            s.healthy_allocs >= s.desired_total
            for s in d.task_groups.values()
        ):
            self.server.raft_apply(
                fsm_msgs.DEPLOYMENT_STATUS_UPDATE,
                {
                    "deployment_id": d.id,
                    "status": consts.DEPLOYMENT_STATUS_SUCCESSFUL,
                    "description": "Deployment completed successfully",
                },
            )
            # the multiregion kick fires from the state-derived scan,
            # which also covers scheduler-marked successes
            return

        # progress: newly healthy allocs unblock the next rolling batch
        healthy_now = sum(s.healthy_allocs for s in d.task_groups.values())
        if healthy_now > st.last_healthy:
            if st.last_healthy >= 0:
                self.server.update_eval(self._new_eval(d))
            st.last_healthy = healthy_now

    def _new_eval(self, d) -> Evaluation:
        return Evaluation(
            namespace=d.namespace,
            priority=50,
            type=consts.JOB_TYPE_SERVICE,
            triggered_by=consts.EVAL_TRIGGER_DEPLOYMENT_WATCHER,
            job_id=d.job_id,
            deployment_id=d.id,
            status=consts.EVAL_STATUS_PENDING,
        )

    def _fail(self, d, reason: str) -> None:
        LOG.info("deployment %s failed: %s", d.id, reason)
        auto_revert = any(s.auto_revert for s in d.task_groups.values())
        self.server.raft_apply(
            fsm_msgs.DEPLOYMENT_STATUS_UPDATE,
            {
                "deployment_id": d.id,
                "status": consts.DEPLOYMENT_STATUS_FAILED,
                "description": reason,
                "evals": [self._new_eval(d)],
            },
        )
        if auto_revert:
            self._revert_job(d)

    def _revert_job(self, d) -> None:
        """deployments_watcher.go auto-revert: re-register the latest
        stable prior version."""
        snap = self.server.state.snapshot()
        current = snap.job_by_id(d.namespace, d.job_id)
        if current is None:
            return
        target = None
        for version in range(current.version - 1, -1, -1):
            job = snap.job_by_id_and_version(d.namespace, d.job_id, version)
            if job is not None and getattr(job, "stable", False):
                target = job
                break
        if target is None:
            LOG.info("deployment %s: no stable version to revert to", d.id)
            return
        reverted = target.copy()
        LOG.info("deployment %s: auto-reverting %s to version %d",
                 d.id, d.job_id, target.version)
        self.server.job_register(reverted)

    # -- multiregion terminal transitions (state-derived, persistent) ----

    def _scan_multiregion(self) -> None:
        """Derive pending cross-region work from the deployments table.

        Reference behavior: nomad/deploymentwatcher multiregion kicks
        (enterprise). A SUCCESSFUL multiregion deployment admits the
        region max_parallel positions later; a FAILED one propagates
        per the job's on_failure strategy. Deriving from state (rather
        than from the in-memory watcher that observed the transition)
        means a leader restart or transient federation outage cannot
        strand a downstream region: the work item is re-created from
        the table and retried with capped backoff until the target
        region acknowledges or proves the kick unnecessary."""
        now = time.monotonic()
        # indexed early-out first (same discipline as _tick_all): with
        # no pending/memoized multiregion work, an unchanged
        # deployments table proves the candidate scan would come back
        # empty — skip it entirely on alloc-commit wakeups
        state = self.server.state
        dep_idx = state.table_index(["deployment"])
        with self._lock:
            if not self._mr_pending and not self._mr_done \
                    and dep_idx == self._mr_idle_idx:
                return
        # cheap gate second: zero multiregion candidates (the common
        # single-region cluster) must not cost a whole-state snapshot
        # on every state change
        candidates = state.multiregion_terminal_deployment_ids()
        with self._lock:
            if not self._enabled:
                return
            if not candidates and not self._mr_pending \
                    and not self._mr_done:
                self._mr_idle_idx = dep_idx
                return
            self._mr_idle_idx = -1
            # the memo only matters while the deployment row exists;
            # prune GC'd ids so a long-lived leader doesn't accumulate
            # every terminal multiregion deployment forever
            self._mr_done &= set(candidates)
            for did in candidates:
                if did not in self._mr_done \
                        and did not in self._mr_pending:
                    self._mr_pending[did] = [0.0, 0.5]
            due = [did for did, e in self._mr_pending.items()
                   if e[0] <= now]
        if not due:
            return
        snap = self.server.state.snapshot()
        for did in due:
            d = snap.deployment_by_id(did)
            if d is None:                        # GC'd: drop the work
                with self._lock:
                    self._mr_pending.pop(did, None)
                continue
            try:
                done = self._mr_transition(snap, d)
            except Exception as e:              # noqa: BLE001
                LOG.warning("multiregion transition %s: %s", did, e)
                done = False
            with self._lock:
                if not self._enabled:
                    return
                entry = self._mr_pending.get(did)
                if entry is None:
                    continue
                if done:
                    del self._mr_pending[did]
                    self._mr_done.add(did)
                else:
                    entry[0] = time.monotonic() + entry[1]
                    entry[1] = min(entry[1] * 2, 30.0)

    def _mr_transition(self, snap, d) -> bool:
        """Deliver one multiregion terminal transition; True when done."""
        job = snap.job_by_id(d.namespace, d.job_id)
        if job is None or not job.multiregion:
            return True
        if job.version != d.job_version:
            return True                          # superseded rollout
        regions = [str(r.get("name", "")) for r in job.multiregion_regions()]
        idx = job.multiregion_region_index()
        if idx < 0:
            return True
        if d.status == consts.DEPLOYMENT_STATUS_SUCCESSFUL:
            mp = job.multiregion_max_parallel()
            if mp <= 0:
                return True
            nxt = idx + mp
            if nxt >= len(regions):
                return True
            return self._kick_region(d, regions[nxt], "unblock")
        # FAILED: propagate per strategy (structs.go:4133 on_failure)
        on_failure = job.multiregion_on_failure()
        if on_failure == "fail_local":
            return True                          # others stay as they are
        targets = regions if on_failure == "fail_all" else regions[idx + 1:]
        ok = True
        for region in targets:
            if region == regions[idx]:
                continue
            if not self._kick_region(d, region, "fail"):
                ok = False
        return ok

    def _kick_region(self, d, target: str, verb: str) -> bool:
        """Deliver unblock/fail for the job's deployment in `target`.

        True when the target acknowledged, or its deployment state
        proves the kick unnecessary (already past the gate / already
        terminal); False asks the caller to retry."""
        import urllib.parse

        if target == self.server.config.region:
            if verb == "unblock":
                _, unblocked = self.server.unblock_job_deployment(
                    d.namespace, d.job_id)
                if unblocked:
                    return True
            else:
                _, failed = self.server.fail_job_deployment(
                    d.namespace, d.job_id,
                    "Failed because of an unsuccessful deployment in a "
                    "federated region")
                if failed:
                    return True
            local = self.server.state.snapshot().latest_deployment_by_job_id(
                d.namespace, d.job_id)
            # nothing to act on AND a row FOR THIS ROLLOUT exists in a
            # state that cannot need the kick any more -> done; no row
            # yet, or only a stale prior-version row (the kick raced
            # the target's scheduler creating it) -> retry
            return local is not None and self._kick_moot(
                local, verb, d.job_version)

        from nomad_tpu_torch.api.client import APIClient, APIError, QueryOptions

        addr = self.server.region_addr(target)
        if addr is None:
            LOG.warning("multiregion: no path to region %s for %s %s",
                        target, verb, d.job_id)
            return False
        tls = getattr(self.server, "tls_api", None) or {}
        token = getattr(self.server.config, "replication_token", "")
        job_q = urllib.parse.quote(d.job_id, safe="")
        opts = QueryOptions(region=target, namespace=d.namespace)
        api = APIClient(addr, token=token, **tls)
        try:
            body = api.post(f"/v1/job/{job_q}/deployment/{verb}", {}, opts)
            if body.get("Unblocked") or body.get("Failed"):
                return True
            remote = api.get(f"/v1/job/{job_q}/deployment", opts)
            return bool(remote) and self._kick_moot_json(
                remote, verb, d.job_version)
        except (APIError, OSError) as e:
            LOG.warning("multiregion: %s kick to %s failed: %s",
                        verb, target, e)
            return False

    @staticmethod
    def _kick_moot(dep, verb: str, job_version: int) -> bool:
        # a row from a DIFFERENT job version is not this rollout's:
        # the target's scheduler hasn't created its row yet -> retry
        if dep.job_version != job_version:
            return False
        if verb == "unblock":
            return dep.status != consts.DEPLOYMENT_STATUS_BLOCKED
        return not dep.active()

    @staticmethod
    def _kick_moot_json(dep: Dict, verb: str, job_version: int) -> bool:
        if int(dep.get("JobVersion", -1)) != job_version:
            return False
        status = str(dep.get("Status", ""))
        if verb == "unblock":
            return status != consts.DEPLOYMENT_STATUS_BLOCKED
        return status in (consts.DEPLOYMENT_STATUS_SUCCESSFUL,
                          consts.DEPLOYMENT_STATUS_FAILED,
                          consts.DEPLOYMENT_STATUS_CANCELLED)

    def _record(self, deployment_id: str, healthy: List[str], unhealthy: List[str]) -> None:
        with self._lock:
            seen = self._health_seen.setdefault(deployment_id, {})
            for i in healthy:
                seen[i] = True
            for i in unhealthy:
                seen[i] = False

    def _recorded_health(self, deployment_id: str, alloc_id: str) -> Optional[bool]:
        with self._lock:
            return self._health_seen.get(deployment_id, {}).get(alloc_id)

    def num_watchers(self) -> int:
        with self._lock:
            return len(self._tracked)

    # -- operator RPCs (deployment_endpoint.go Fail/Pause/Promote) -------

    def _get_active(self, deployment_id: str):
        snap = self.server.state.snapshot()
        d = snap.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment '{deployment_id}' not found")
        if not d.active():
            raise ValueError(f"deployment '{deployment_id}' is terminal")
        return d

    def fail_deployment(self, deployment_id: str) -> int:
        d = self._get_active(deployment_id)
        return self.server.raft_apply(
            fsm_msgs.DEPLOYMENT_STATUS_UPDATE,
            {
                "deployment_id": d.id,
                "status": consts.DEPLOYMENT_STATUS_FAILED,
                "description": "Deployment marked as failed",
                "evals": [_operator_eval(d)],
            },
        )

    def pause_deployment(self, deployment_id: str, pause: bool) -> int:
        d = self._get_active(deployment_id)
        status = (consts.DEPLOYMENT_STATUS_PAUSED if pause
                  else consts.DEPLOYMENT_STATUS_RUNNING)
        desc = ("Deployment is paused" if pause
                else "Deployment is resuming")
        return self.server.raft_apply(
            fsm_msgs.DEPLOYMENT_STATUS_UPDATE,
            {
                "deployment_id": d.id,
                "status": status,
                "description": desc,
                "evals": [] if pause else [_operator_eval(d)],
            },
        )

    def promote_deployment(self, deployment_id: str, groups=None,
                           all_groups: bool = True) -> int:
        d = self._get_active(deployment_id)
        return self.server.raft_apply(
            fsm_msgs.DEPLOYMENT_PROMOTE,
            {
                "deployment_id": d.id,
                "groups": None if all_groups else groups,
                "evals": [_operator_eval(d)],
            },
        )


def _operator_eval(d) -> Evaluation:
    return Evaluation(
        namespace=d.namespace,
        priority=50,
        type=consts.JOB_TYPE_SERVICE,
        triggered_by=consts.EVAL_TRIGGER_DEPLOYMENT_WATCHER,
        job_id=d.job_id,
        deployment_id=d.id,
        status=consts.EVAL_STATUS_PENDING,
    )
