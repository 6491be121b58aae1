"""Host-side feasibility: the ragged checks that feed the kernel's base mask.

Reference behavior: scheduler/feasible.go. The per-node iterator checkers
become one vectorized mask build:

- ready/DC membership: readyNodesInDCs (util.go:351) as numpy selects
- ConstraintChecker (:730) for job + task group + task constraints,
  memoized per computed node class via EvalEligibility (the
  FeasibilityWrapper cache, :1050); 'escaping' constraints on unique
  properties are evaluated per node, exactly like the reference's
  escaped-class path
- DriverChecker (:454): required drivers healthy (class-level)
- HostVolumeChecker (:135): per-node host volume presence
- CSIVolumeChecker (:212): per-node plugin presence (volume claims land
  with the CSI subsystem)
- DeviceChecker (:1193): device existence/count via the device planes
- DistinctHostsIterator (:526) / DistinctPropertyIterator (:625):
  proposed-alloc-dependent masks built from the job's allocations
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch.scheduler.context import ELIGIBILITY_UNKNOWN, ELIGIBLE, INELIGIBLE, EvalContext
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.constraints import (
    Constraint,
    node_meets_constraints,
    resolve_target,
)
from nomad_tpu_torch.tensors.schema import ClusterTensors

FILTER_CONSTRAINT_HOST_VOLUMES = "missing compatible host volumes"
FILTER_CONSTRAINT_CSI_PLUGINS = "missing CSI plugins"
FILTER_CONSTRAINT_DRIVERS = "missing drivers"
FILTER_CONSTRAINT_DEVICES = "missing devices"


def merged_tg_constraints(tg) -> List[Constraint]:
    """Task-group-level constraint set: tg constraints + each task's
    (the reference wires these as separate checkers in the same
    FeasibilityWrapper, stack.go:365-377)."""
    out = list(tg.constraints)
    for task in tg.tasks:
        out.extend(task.constraints)
    return out


def required_drivers(tg) -> List[str]:
    return sorted({task.driver for task in tg.tasks})


def driver_ok(node, drivers: List[str]) -> bool:
    """DriverChecker (feasible.go:454): driver fingerprinted healthy."""
    for d in drivers:
        info = node.drivers.get(d)
        if info is not None:
            if not (info.detected and info.healthy):
                return False
            continue
        # fall back to attribute-based detection (driver.<name> = "1")
        raw = node.attributes.get(f"driver.{d}")
        if raw is None or str(raw) not in ("1", "true", "True"):
            return False
    return True


def host_volumes_ok(node, tg) -> bool:
    """HostVolumeChecker (feasible.go:135)."""
    for req in tg.volumes.values():
        if req.type != "host":
            continue
        vol = node.host_volumes.get(req.source)
        if vol is None:
            return False
        if vol.read_only and not req.read_only:
            return False
    return True


def csi_ok(node, tg, snapshot=None, namespace: str = "default") -> bool:
    """CSIVolumeChecker (feasible.go:212): the node must run a healthy
    instance of each claimed volume's plugin, and the volume itself must
    have claim capacity for the requested mode (csi.go
    WriteSchedulable/ReadSchedulable)."""
    from nomad_tpu_torch.structs import csi as csi_structs

    for req in tg.volumes.values():
        if req.type != "csi":
            continue
        vol = None
        if snapshot is not None and hasattr(snapshot, "csi_volume_by_id"):
            vol = snapshot.csi_volume_by_id(namespace, req.source)
        if vol is None:
            # no registered volume: fall back to plugin presence keyed
            # by source (pre-registration dev mode)
            if req.source not in node.csi_node_plugins:
                return False
            continue
        info = node.csi_node_plugins.get(vol.plugin_id)
        if info is None or not info.get("healthy", False):
            return False
        mode = csi_structs.CLAIM_READ if req.read_only \
            else csi_structs.CLAIM_WRITE
        if not vol.claimable(mode):
            return False
    return True


def devices_exist(node, tg) -> bool:
    """DeviceChecker.hasDevices (feasible.go:1238) -- count-aware
    existence check; precise availability is the kernel's dev planes."""
    from nomad_tpu_torch.scheduler.device import node_device_matches

    required = []
    for task in tg.tasks:
        required.extend(task.resources.devices)
    if not required:
        return True
    if not node.node_resources.devices:
        return False
    available = {d.id_string(): len(d.available_ids()) for d in node.node_resources.devices}
    groups = {d.id_string(): d for d in node.node_resources.devices}
    for req in required:
        placed = False
        for gid, unused in available.items():
            if unused < req.count:
                continue
            if node_device_matches(groups[gid], req):
                available[gid] -= req.count
                placed = True
                break
        if not placed:
            return False
    return True


def eligible_in_dcs(c: ClusterTensors, datacenters: List[str],
                    node_pool: str = "default") -> np.ndarray:
    """readyNodesInDCs (util.go:351) as a mask; a job's node_pool
    restricts to matching nodes ('all' is the match-everything pool).

    Module-level so the feasibility compiler's evaluation engine
    (nomad_tpu_torch/feasibility/runtime.py) runs EXACTLY this code for its
    cached masks — bit-identity with the per-eval builder holds by
    construction, not by reimplementation."""
    mask = c.ready.copy()
    dcs = set(datacenters)
    wildcard = any("*" in dc for dc in dcs)
    if not wildcard and hasattr(c, "dc_pool_arrays"):
        # vectorized fast path (no glob patterns in the job's DCs)
        dc_arr, pool_arr = c.dc_pool_arrays()
        mask &= np.isin(dc_arr, list(dcs))
        if node_pool and node_pool != "all":
            mask &= pool_arr == node_pool
        return mask
    for i in range(c.n_real):
        if c.datacenters[i] not in dcs:
            if not (wildcard and _dc_glob_match(dcs, c.datacenters[i])):
                mask[i] = False
                continue
        if node_pool and node_pool != "all" and c.node_pools[i] != node_pool:
            mask[i] = False
    return mask


class FeasibilityBuilder:
    """Builds base_mask[n_pad] for one (job, task group)."""

    def __init__(self, cluster: ClusterTensors, snapshot, ctx: EvalContext) -> None:
        self.cluster = cluster
        self.snapshot = snapshot
        self.ctx = ctx
        # rows grouped by computed class, built lazily once per eval
        self._class_rows: Optional[Dict[str, List[int]]] = None

    def _classes(self) -> Dict[str, List[int]]:
        if self._class_rows is None:
            self._class_rows = self.cluster.class_rows()
        return self._class_rows

    def eligible_in_dcs(self, datacenters: List[str], node_pool: str = "default") -> np.ndarray:
        return eligible_in_dcs(self.cluster, datacenters, node_pool)

    def base_mask(self, job, tg, job_allocs_by_node: Dict[str, List]) -> np.ndarray:
        """The full host-side feasibility plane."""
        c = self.cluster
        mask = self.eligible_in_dcs(job.datacenters, job.node_pool)
        elig = self.ctx.eligibility
        metrics = self.ctx.metrics()

        job_cons = list(job.constraints)
        tg_cons = merged_tg_constraints(tg)
        drivers = required_drivers(tg)
        escaped = elig.has_escaped()

        # node objects are immutable per snapshot; the cluster build's
        # map avoids an O(N) dict rebuild per evaluation
        nodes_by_id = c.nodes_by_id or {
            nid: self.snapshot.node_by_id(nid) for nid in c.node_ids
        }

        # class-memoized job + tg checks
        for cls, rows in self._classes().items():
            live = [i for i in rows if i < c.n_real and mask[i]]
            if not live:
                continue
            rep = nodes_by_id.get(c.node_ids[live[0]])
            if rep is None:
                for i in live:
                    mask[i] = False
                continue

            # job-level constraints
            st = elig.job_status(cls) if not escaped else ELIGIBILITY_UNKNOWN
            if st == ELIGIBILITY_UNKNOWN:
                ok = node_meets_constraints(rep, job_cons)
                if not escaped:
                    elig.set_job_eligibility(ok, cls)
            else:
                ok = st == ELIGIBLE
            if not ok and not escaped:
                for i in live:
                    mask[i] = False
                    metrics.filter_node(nodes_by_id.get(c.node_ids[i]), "job constraints")
                continue

            # tg-level constraints + drivers + device existence
            st = elig.tg_status(tg.name, cls) if not escaped else ELIGIBILITY_UNKNOWN
            if st == ELIGIBILITY_UNKNOWN:
                ok_tg = (
                    node_meets_constraints(rep, tg_cons)
                    and driver_ok(rep, drivers)
                    and devices_exist(rep, tg)
                )
                if not escaped:
                    elig.set_tg_eligibility(ok_tg, tg.name, cls)
            else:
                ok_tg = st == ELIGIBLE
            if not escaped:
                if not ok_tg:
                    for i in live:
                        mask[i] = False
                        metrics.filter_node(nodes_by_id.get(c.node_ids[i]), "task group constraints")
                    continue
            else:
                # escaped: evaluate everything per node
                for i in live:
                    node = nodes_by_id.get(c.node_ids[i])
                    if node is None or not (
                        node_meets_constraints(node, job_cons)
                        and node_meets_constraints(node, tg_cons)
                        and driver_ok(node, drivers)
                        and devices_exist(node, tg)
                    ):
                        mask[i] = False
                        if node is not None:
                            metrics.filter_node(node, "constraints")

        # per-node ragged checks (cheap dict lookups)
        has_host_vols = any(v.type == "host" for v in tg.volumes.values())
        has_csi_vols = any(v.type == "csi" for v in tg.volumes.values())
        if has_host_vols or has_csi_vols:
            for i in range(c.n_real):
                if not mask[i]:
                    continue
                node = nodes_by_id.get(c.node_ids[i])
                if node is None:
                    mask[i] = False
                    continue
                if has_host_vols and not host_volumes_ok(node, tg):
                    mask[i] = False
                    metrics.filter_node(node, FILTER_CONSTRAINT_HOST_VOLUMES)
                elif has_csi_vols and not csi_ok(
                    node, tg, self.snapshot, job.namespace
                ):
                    mask[i] = False
                    metrics.filter_node(node, FILTER_CONSTRAINT_CSI_PLUGINS)

        # distinct_hosts / distinct_property
        self._apply_distinct(mask, job, tg, job_allocs_by_node, nodes_by_id)
        return mask

    # -- distinct constraints --------------------------------------------

    def _apply_distinct(self, mask, job, tg, job_allocs_by_node, nodes_by_id) -> None:
        c = self.cluster
        job_distinct = any(
            con.operand == consts.CONSTRAINT_DISTINCT_HOSTS for con in job.constraints
        )
        tg_distinct = any(
            con.operand == consts.CONSTRAINT_DISTINCT_HOSTS for con in tg.constraints
        )
        if job_distinct or tg_distinct:
            # DistinctHostsIterator (feasible.go:526): no co-location with
            # the job's (or group's) other live allocs
            for i in range(c.n_real):
                if not mask[i]:
                    continue
                allocs = job_allocs_by_node.get(c.node_ids[i], ())
                for a in allocs:
                    if a.terminal_status():
                        continue
                    if job_distinct and a.job_id == job.id:
                        mask[i] = False
                        break
                    if tg_distinct and a.job_id == job.id and a.task_group == tg.name:
                        mask[i] = False
                        break

        # DistinctPropertyIterator (feasible.go:625)
        for con in list(job.constraints) + list(tg.constraints):
            if con.operand != consts.CONSTRAINT_DISTINCT_PROPERTY:
                continue
            limit = 1
            if con.rtarget:
                try:
                    limit = int(con.rtarget)
                except ValueError:
                    limit = 1
            tg_scope = con in tg.constraints
            counts: Dict[str, int] = {}
            for nid, allocs in job_allocs_by_node.items():
                node = nodes_by_id.get(nid) or self.snapshot.node_by_id(nid)
                if node is None:
                    continue
                val, ok = resolve_target(con.ltarget, node)
                if not ok:
                    continue
                for a in allocs:
                    if a.terminal_status() or a.job_id != job.id:
                        continue
                    if tg_scope and a.task_group != tg.name:
                        continue
                    counts[val] = counts.get(val, 0) + 1
            for i in range(c.n_real):
                if not mask[i]:
                    continue
                node = nodes_by_id.get(c.node_ids[i])
                if node is None:
                    continue
                val, ok = resolve_target(con.ltarget, node)
                if not ok:
                    mask[i] = False
                    continue
                if counts.get(val, 0) >= limit:
                    mask[i] = False


def _dc_glob_match(patterns, dc: str) -> bool:
    import fnmatch

    return any(fnmatch.fnmatch(dc, p) for p in patterns if "*" in p)
