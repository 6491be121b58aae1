"""RPC endpoint logic beyond the core Server methods.

Reference: nomad/job_endpoint.go (Plan :1500s, Dispatch, Scale, Revert,
Stable), nomad/alloc_endpoint.go (Stop), nomad/node_endpoint.go
(Deregister/purge), nomad/eval_endpoint.go (List/Allocs). These sit on
top of Server.raft_apply + StateStore exactly as the reference endpoints
sit on top of raftApply + the FSM.
"""

from __future__ import annotations

import copy
import time
import uuid
from typing import Dict, List, Optional

from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation


def job_plan(server, job, diff: bool = False) -> Dict:
    """Job.Plan: dry-run the scheduler against a copy of current state;
    nothing commits (job_endpoint.go Plan)."""
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs.diff import job_diff

    # clone state so the dry-run planner can locally apply without
    # touching the authoritative store
    shadow = StateStore()
    shadow.restore_from_bytes(server.state.to_snapshot_bytes())
    existing = shadow.snapshot().job_by_id(job.namespace, job.id)

    ev = Evaluation(
        namespace=job.namespace,
        priority=job.priority,
        type=job.type,
        triggered_by=consts.EVAL_TRIGGER_JOB_REGISTER,
        job_id=job.id,
        status=consts.EVAL_STATUS_PENDING,
        annotate_plan=True,
    )
    job = copy.deepcopy(job)
    job.version = (existing.version + 1) if existing is not None else 0
    shadow.upsert_job(job)
    shadow.upsert_evals([ev])

    h = Harness(state=shadow, device=server.device)
    sched_name = job.type if job.type in (
        consts.JOB_TYPE_SERVICE, consts.JOB_TYPE_BATCH,
        consts.JOB_TYPE_SYSTEM, consts.JOB_TYPE_SYSBATCH,
    ) else consts.JOB_TYPE_SERVICE
    h.process(sched_name, ev)

    annotations = None
    failed_tg_allocs = {}
    for p in h.plans:
        if p.annotations is not None:
            annotations = p.annotations
    for e in h.evals:
        if e.failed_tg_allocs:
            failed_tg_allocs = e.failed_tg_allocs
    d = job_diff(existing, job) if diff else None
    return {
        "annotations": annotations,
        "failed_tg_allocs": failed_tg_allocs,
        "diff": d,
        "created_evals": h.create_evals,
        "job_modify_index": existing.job_modify_index if existing is not None else 0,
    }


def job_dispatch(server, namespace: str, parent_id: str,
                 payload: bytes = b"", meta: Optional[Dict[str, str]] = None) -> Dict:
    """Job.Dispatch: instantiate a parameterized job
    (job_endpoint.go Dispatch)."""
    snap = server.state.snapshot()
    parent = snap.job_by_id(namespace, parent_id)
    if parent is None:
        raise KeyError(f"job '{parent_id}' not found")
    if parent.parameterized is None:
        raise ValueError("job is not parameterized")
    if parent.stopped():
        raise ValueError("can't dispatch a stopped job")
    cfg = parent.parameterized
    meta = dict(meta or {})
    # validate meta against required/optional sets
    required = set(cfg.meta_required or [])
    optional = set(cfg.meta_optional or [])
    keys = set(meta)
    missing = required - keys
    if missing:
        raise ValueError(f"missing required dispatch meta: {sorted(missing)}")
    unexpected = keys - required - optional
    if unexpected:
        raise ValueError(f"dispatch meta not allowed: {sorted(unexpected)}")
    if payload and cfg.payload == "forbidden":
        raise ValueError("payload is not allowed for this job")
    if not payload and cfg.payload == "required":
        raise ValueError("payload is required for this job")

    child = copy.deepcopy(parent)
    child.id = f"{parent.id}/dispatch-{int(time.time())}-{uuid.uuid4().hex[:8]}"
    child.parent_id = parent.id
    child.dispatched = True
    child.parameterized = None
    child.meta = {**(parent.meta or {}), **meta}
    child.payload = payload
    child.status = consts.JOB_STATUS_PENDING
    child.version = 0

    result = server.job_register(child)
    result["dispatched_job_id"] = child.id
    return result


def job_scale(server, namespace: str, job_id: str, group: str,
              count: Optional[int], message: str = "", error: bool = False,
              meta: Optional[Dict] = None) -> Dict:
    """Job.Scale: adjust one task group's count and record a scaling
    event (job_endpoint.go Scale)."""
    snap = server.state.snapshot()
    job = snap.job_by_id(namespace, job_id)
    if job is None:
        raise KeyError(f"job '{job_id}' not found")
    tg = job.lookup_task_group(group)
    if tg is None:
        raise KeyError(f"task group '{group}' not found")
    result = {"eval_id": "", "index": 0}
    if count is not None and not error:
        job = copy.deepcopy(job)
        job.lookup_task_group(group).count = int(count)
        result = server.job_register(job)
    server.raft_apply(
        fsm_msgs.SCALING_EVENT,
        {
            "namespace": namespace, "job_id": job_id, "group": group,
            "event": {
                "time_ns": int(time.time() * 1e9),
                "count": count,
                "message": message,
                "error": error,
                "meta": meta or {},
                "eval_id": result.get("eval_id", ""),
            },
        },
    )
    return result


def job_revert(server, namespace: str, job_id: str, version: int,
               enforce_prior_version: Optional[int] = None) -> Dict:
    """Job.Revert: re-register a prior job version
    (job_endpoint.go Revert)."""
    snap = server.state.snapshot()
    cur = snap.job_by_id(namespace, job_id)
    if cur is None:
        raise KeyError(f"job '{job_id}' not found")
    if enforce_prior_version is not None and cur.version != enforce_prior_version:
        raise ValueError(
            f"current version {cur.version} != enforced prior {enforce_prior_version}"
        )
    if version == cur.version:
        raise ValueError("cannot revert to current version")
    prior = snap.job_by_id_and_version(namespace, job_id, version)
    if prior is None:
        raise KeyError(f"version {version} not found for job '{job_id}'")
    reverted = copy.deepcopy(prior)
    reverted.stop = False
    return server.job_register(reverted)


def job_stable(server, namespace: str, job_id: str, version: int,
               stable: bool) -> Dict:
    """Job.Stable: mark a job version (un)stable."""
    snap = server.state.snapshot()
    job = snap.job_by_id_and_version(namespace, job_id, version)
    if job is None:
        raise KeyError(f"version {version} not found for job '{job_id}'")
    index = server.raft_apply(
        fsm_msgs.JOB_STABILITY,
        {"namespace": namespace, "job_id": job_id, "version": version,
         "stable": stable},
    )
    return {"index": index}


def alloc_stop(server, alloc_id: str) -> Dict:
    """Alloc.Stop: set desired transition and create an eval
    (alloc_endpoint.go Stop)."""
    snap = server.state.snapshot()
    alloc = snap.alloc_by_id(alloc_id)
    if alloc is None:
        raise KeyError(f"alloc '{alloc_id}' not found")
    job = snap.job_by_id(alloc.namespace, alloc.job_id) or alloc.job
    ev = Evaluation(
        namespace=alloc.namespace,
        priority=job.priority if job is not None else 50,
        type=job.type if job is not None else "service",
        triggered_by=consts.EVAL_TRIGGER_ALLOC_STOP,
        job_id=alloc.job_id,
        status=consts.EVAL_STATUS_PENDING,
    )
    index = server.raft_apply(
        fsm_msgs.ALLOC_UPDATE_DESIRED_TRANSITION,
        {"allocs": {alloc_id: {"migrate": True}}, "evals": [ev]},
    )
    return {"eval_id": ev.id, "index": index}


def node_deregister(server, node_id: str) -> Dict:
    """Node.Deregister (purge): remove node + create node-update evals."""
    snap = server.state.snapshot()
    node = snap.node_by_id(node_id)
    if node is None:
        raise KeyError(f"node '{node_id}' not found")
    eval_ids = server._create_node_evals(node_id, node.modify_index)
    index = server.raft_apply(
        fsm_msgs.NODE_DEREGISTER, {"node_id": node_id, "evals": eval_ids}
    )
    return {"eval_ids": eval_ids, "index": index}


def node_evaluate(server, node_id: str) -> Dict:
    """Node.Evaluate: force evals for all jobs with allocs on the node."""
    snap = server.state.snapshot()
    node = snap.node_by_id(node_id)
    if node is None:
        raise KeyError(f"node '{node_id}' not found")
    eval_ids = server._create_node_evals(node_id, node.modify_index)
    return {"eval_ids": eval_ids, "index": server.state.latest_index()}
