"""CoreScheduler: garbage collection as `_core` evaluations.

Reference behavior: nomad/core_sched.go (:44-805) -- the leader
periodically enqueues evals of type ``_core`` whose job id names the GC
to run (eval-gc, job-gc, node-gc, deployment-gc); workers route them
here instead of a placement scheduler. Thresholds default to hours in
the reference; they are configurable for tests.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation

LOG = logging.getLogger(__name__)

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"
CORE_JOB_CSI_VOLUME_CLAIM_GC = "csi-volume-claim-gc"
CORE_JOB_ONE_TIME_TOKEN_GC = "one-time-token-gc"
CORE_JOB_FORCE_GC = "force-gc"

ALL_CORE_JOBS = [
    CORE_JOB_EVAL_GC, CORE_JOB_JOB_GC, CORE_JOB_NODE_GC,
    CORE_JOB_DEPLOYMENT_GC, CORE_JOB_CSI_VOLUME_CLAIM_GC,
    CORE_JOB_ONE_TIME_TOKEN_GC,
]


def new_core_eval(core_job: str, priority: int = consts.CORE_JOB_PRIORITY) -> Evaluation:
    """leader.go schedulePeriodic: core evals carry the GC name as job."""
    return Evaluation(
        namespace="-",
        priority=priority,
        type=consts.JOB_TYPE_CORE,
        triggered_by=consts.EVAL_TRIGGER_SCHEDULED,
        job_id=core_job,
        status=consts.EVAL_STATUS_PENDING,
    )


class CoreScheduler:
    """Processes `_core` evals (core_sched.go NewCoreScheduler)."""

    def __init__(self, snapshot, planner, server) -> None:
        self.snapshot = snapshot
        self.planner = planner
        self.server = server
        cfg = server.config
        self.eval_gc_threshold = getattr(cfg, "eval_gc_threshold", 3600.0)
        self.job_gc_threshold = getattr(cfg, "job_gc_threshold", 4 * 3600.0)
        self.node_gc_threshold = getattr(cfg, "node_gc_threshold", 24 * 3600.0)
        self.deployment_gc_threshold = getattr(
            cfg, "deployment_gc_threshold", 3600.0
        )

    def process(self, evaluation: Evaluation) -> None:
        job = evaluation.job_id
        force = job == CORE_JOB_FORCE_GC
        if job in (CORE_JOB_EVAL_GC,) or force:
            self.eval_gc(force)
        if job in (CORE_JOB_JOB_GC,) or force:
            self.job_gc(force)
        if job in (CORE_JOB_NODE_GC,) or force:
            self.node_gc(force)
        if job in (CORE_JOB_DEPLOYMENT_GC,) or force:
            self.deployment_gc(force)
        if job in (CORE_JOB_CSI_VOLUME_CLAIM_GC,) or force:
            self.csi_volume_claim_gc(force)
        if job in (CORE_JOB_ONE_TIME_TOKEN_GC,) or force:
            self.one_time_token_gc(force)
        done = evaluation.copy()
        done.status = consts.EVAL_STATUS_COMPLETE
        self.planner.update_eval(done)

    # --- collectors (core_sched.go evalGC/jobGC/nodeGC/deploymentGC) ----

    def _cutoff_index(self, threshold: float, force: bool) -> int:
        """Translate an age threshold into a state index via the
        leader's TimeTable (core_sched.go getThreshold)."""
        if force:
            return 2 ** 62
        return self.server.time_table.nearest_index(time.time() - threshold)

    def eval_gc(self, force: bool = False) -> int:
        """Terminal evals (older than the threshold) whose allocs are
        all terminal."""
        cutoff = self._cutoff_index(self.eval_gc_threshold, force)
        gc_evals: List[str] = []
        gc_allocs: List[str] = []
        for ev in self.snapshot.evals_iter():
            if ev.type == consts.JOB_TYPE_CORE:
                continue
            if ev.status not in (
                consts.EVAL_STATUS_COMPLETE, consts.EVAL_STATUS_FAILED,
                consts.EVAL_STATUS_CANCELLED,
            ):
                continue
            if ev.modify_index > cutoff:
                continue
            allocs = self.snapshot.allocs_by_eval(ev.id)
            if all(a.terminal_status() and a.client_terminal_status()
                   for a in allocs):
                gc_evals.append(ev.id)
                gc_allocs.extend(a.id for a in allocs)
        if gc_evals:
            self.server.raft_apply(
                fsm_msgs.EVAL_DELETE, {"eval_ids": gc_evals}
            )
        if gc_allocs:
            self.server.raft_apply(
                fsm_msgs.ALLOC_DELETE, {"alloc_ids": gc_allocs}
            )
        if gc_evals or gc_allocs:
            LOG.info("eval GC: %d evals, %d allocs", len(gc_evals), len(gc_allocs))
        return len(gc_evals)

    def job_gc(self, force: bool = False) -> int:
        """Dead jobs (older than the threshold) with no live evals or
        allocs."""
        cutoff = self._cutoff_index(self.job_gc_threshold, force)
        n = 0
        for job in self.snapshot.jobs():
            if job.status != consts.JOB_STATUS_DEAD and not job.stop:
                continue
            if job.is_periodic() or job.is_parameterized():
                continue
            if job.modify_index > cutoff:
                continue
            evals = self.snapshot.evals_by_job(job.namespace, job.id)
            allocs = self.snapshot.allocs_by_job(job.namespace, job.id)
            if any(not e.terminal_status() for e in evals):
                continue
            if any(not (a.terminal_status() and a.client_terminal_status())
                   for a in allocs):
                continue
            self.server.raft_apply(
                fsm_msgs.JOB_DEREGISTER,
                {"namespace": job.namespace, "job_id": job.id,
                 "purge": True, "evals": []},
            )
            if evals:
                self.server.raft_apply(
                    fsm_msgs.EVAL_DELETE, {"eval_ids": [e.id for e in evals]}
                )
            if allocs:
                self.server.raft_apply(
                    fsm_msgs.ALLOC_DELETE, {"alloc_ids": [a.id for a in allocs]}
                )
            n += 1
        if n:
            LOG.info("job GC: %d jobs", n)
        return n

    def node_gc(self, force: bool = False) -> int:
        """Down nodes (older than the threshold) with no allocs."""
        cutoff = self._cutoff_index(self.node_gc_threshold, force)
        n = 0
        for node in self.snapshot.nodes():
            if node.status != consts.NODE_STATUS_DOWN:
                continue
            if node.modify_index > cutoff:
                continue
            if self.snapshot.allocs_by_node(node.id):
                continue
            self.server.raft_apply(
                fsm_msgs.NODE_DEREGISTER, {"node_id": node.id}
            )
            n += 1
        if n:
            LOG.info("node GC: %d nodes", n)
        return n

    def deployment_gc(self, force: bool = False) -> int:
        """Terminal deployments older than the threshold."""
        cutoff = self._cutoff_index(self.deployment_gc_threshold, force)
        gc: List[str] = []
        for d in self.snapshot.deployments_iter():
            if d.active() or d.modify_index > cutoff:
                continue
            gc.append(d.id)
        if gc:
            self.server.raft_apply(
                fsm_msgs.DEPLOYMENT_DELETE, {"deployment_ids": gc}
            )
            LOG.info("deployment GC: %d deployments", len(gc))
        return len(gc)


    def csi_volume_claim_gc(self, force: bool = False) -> int:
        """Claims held by GC'd or terminal allocs get released so the
        volume watcher unpublishes them (core_sched.go
        csiVolumeClaimGC). Live claims only -- past claims already in
        the unpublish pipeline belong to the watcher (re-releasing them
        from a stale snapshot would rewind their state)."""
        n = 0
        for vol in self.snapshot.csi_volumes_iter():
            for claims in (vol.read_claims, vol.write_claims):
                for alloc_id, claim in list(claims.items()):
                    alloc = self.snapshot.alloc_by_id(alloc_id)
                    if alloc is not None and not (
                        alloc.terminal_status() or alloc.client_terminal_status()
                    ):
                        continue
                    self.server.raft_apply(fsm_msgs.CSI_VOLUME_CLAIM, {
                        "namespace": vol.namespace, "volume_id": vol.id,
                        "claim": claim.release_copy(),
                    })
                    n += 1
        if n:
            LOG.info("csi volume claim GC: %d claims released", n)
        return n

    def one_time_token_gc(self, force: bool = False) -> int:
        """Expired one-time tokens (core_sched.go expiredOneTimeTokenGC)."""
        expire = getattr(self.server, "expire_one_time_tokens", None)
        return expire(force) if expire is not None else 0


def install(server) -> None:
    """Register the factory on the server (worker.go routes _core)."""
    server._core_scheduler_factory = (
        lambda snapshot, planner, srv: CoreScheduler(snapshot, planner, srv)
    )
