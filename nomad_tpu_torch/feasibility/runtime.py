"""Mask-program evaluation + the per-eval epilogue.

``evaluate_program`` runs a compiled ``MaskProgram`` against one node
structure and produces the cached ``MaskEntry``: the static feasibility
plane, the per-reason filter tallies, and the per-class eligibility the
Python builder would have produced eval by eval. Phase order and the
predicate implementations are the Python builder's own helpers
(``eligible_in_dcs``, ``node_meets_constraints``, ``driver_ok``,
``devices_exist``, ``host_volumes_ok``) invoked per class
representative or per distinct interned value — bit-identity with
``FeasibilityBuilder.base_mask`` is by construction, and property-
tested in tests/test_feasibility_compiler.py.

``apply_program`` is the per-eval hot path: a cache lookup, a metrics/
eligibility tally replay, and — only when the eval actually needs them
— the dynamic epilogue (exclude rows, CSI claims, distinct_hosts/
distinct_property). An eval with no dynamic state returns the cached
FROZEN mask itself: every member of a wave then carries the same array
by identity, the wave launcher ships it unbatched (one plane per wave,
parallel/coalesce job-sharing group), and the device-resident state's
frozen registry uploads it once per (structure, signature) ever — the
wave's base masks are produced by one broadcast on device instead of B
host builds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nomad_tpu_torch.feasibility.attr_planes import default_attr_plane_cache
from nomad_tpu_torch.feasibility.cache import MaskEntry, default_mask_cache
from nomad_tpu_torch.feasibility.compiler import MaskProgram
from nomad_tpu_torch.scheduler.feasible import (
    FILTER_CONSTRAINT_CSI_PLUGINS,
    FILTER_CONSTRAINT_HOST_VOLUMES,
    csi_ok,
    devices_exist,
    driver_ok,
    eligible_in_dcs,
    host_volumes_ok,
)
from nomad_tpu_torch.structs.constraints import check_constraint

__all__ = ["evaluate_program", "apply_program"]


def _nodes_by_id(cluster, snapshot):
    return cluster.nodes_by_id or {
        nid: snapshot.node_by_id(nid) for nid in cluster.node_ids
    }


def _escaped_constraint_mask(program: MaskProgram, cluster,
                             usage) -> np.ndarray:
    """Per-node merged-constraint mask over the interned vocabulary:
    each constraint's predicate runs once per DISTINCT left value
    (regex compiles once, matches |vocab| times) through the exact
    ``check_constraint`` operand evaluation."""
    planes = default_attr_plane_cache.get(cluster, usage)
    mask = np.ones(cluster.n_real, bool)
    for con in list(program.job_constraints) + list(program.tg_constraints):
        col = planes.column(con.ltarget)
        op, rt = con.operand, con.rtarget
        mask &= col.lut_mask(
            lambda val, found, op=op, rt=rt:
            check_constraint(op, val, rt, found, True))
        if not mask.any():
            break
    return mask


def evaluate_program(program: MaskProgram, cluster, snapshot,
                     usage=None) -> MaskEntry:
    """One full static evaluation (the cache-miss path)."""
    from nomad_tpu_torch.telemetry.trace import tracer

    with tracer.span("feas.evaluate"):
        return _evaluate(program, cluster, snapshot, usage)


def _evaluate(program: MaskProgram, cluster, snapshot,
              usage=None) -> MaskEntry:
    c = cluster
    mask = eligible_in_dcs(c, list(program.datacenters),
                           program.node_pool)
    filter_counts = []
    class_job = {}
    class_tg = {}
    nodes_by_id = _nodes_by_id(c, snapshot)
    tg = program.tg

    def tally(rows, reason) -> None:
        # replicate metrics.filter_node per dropped node, aggregated
        # by node_class (the dict key the AllocMetric tallies use)
        by_class = {}
        for i in rows:
            node = nodes_by_id.get(c.node_ids[i])
            cls = node.node_class if node is not None else ""
            by_class[cls] = by_class.get(cls, 0) + 1
        for cls, n in by_class.items():
            filter_counts.append((reason, cls, n))

    if not program.escaped:
        # class-memoized phase: representative-based, exactly the
        # Python builder's walk (one rep per computed class)
        for cls, rows in c.class_rows().items():
            live = [i for i in rows if i < c.n_real and mask[i]]
            if not live:
                continue
            rep = nodes_by_id.get(c.node_ids[live[0]])
            if rep is None:
                for i in live:
                    mask[i] = False
                continue
            ok = _job_ok(program, rep)
            class_job[cls] = ok
            if not ok:
                for i in live:
                    mask[i] = False
                tally(live, "job constraints")
                continue
            ok_tg = _tg_ok(program, rep)
            class_tg[cls] = ok_tg
            if not ok_tg:
                for i in live:
                    mask[i] = False
                tally(live, "task group constraints")
    else:
        # escaped phase: every check per node. Constraints run
        # vectorized over the vocabulary; drivers/devices per node
        # (they read ragged node state the vocabulary doesn't carry).
        con_mask = _escaped_constraint_mask(program, c, usage)
        dropped = []
        for i in range(c.n_real):
            if not mask[i]:
                continue
            node = nodes_by_id.get(c.node_ids[i])
            if node is None or not con_mask[i] \
                    or not driver_ok(node, list(program.drivers)) \
                    or (program.has_device_asks
                        and not devices_exist(node, tg)):
                mask[i] = False
                if node is not None:
                    dropped.append(i)
        tally(dropped, "constraints")

    # per-node ragged volume phase (host volumes only: CSI claims are
    # snapshot state, applied by the dynamic epilogue)
    if program.host_volumes:
        dropped = []
        for i in range(c.n_real):
            if not mask[i]:
                continue
            node = nodes_by_id.get(c.node_ids[i])
            if node is None:
                mask[i] = False
                continue
            if not host_volumes_ok(node, tg):
                mask[i] = False
                dropped.append(i)
        tally(dropped, FILTER_CONSTRAINT_HOST_VOLUMES)

    return MaskEntry(mask, filter_counts, class_job, class_tg, c)


def _job_ok(program: MaskProgram, rep) -> bool:
    from nomad_tpu_torch.structs.constraints import node_meets_constraints

    return node_meets_constraints(rep, list(program.job_constraints))


def _tg_ok(program: MaskProgram, rep) -> bool:
    from nomad_tpu_torch.structs.constraints import node_meets_constraints

    return (node_meets_constraints(rep, list(program.tg_constraints))
            and driver_ok(rep, list(program.drivers))
            and (not program.has_device_asks
                 or devices_exist(rep, program.tg)))


def apply_program(program: MaskProgram, cluster, snapshot, ctx,
                  job, tg, job_allocs_by_node, exclude,
                  feas_builder) -> np.ndarray:
    """The per-eval entry: cached static mask + metrics/eligibility
    replay + dynamic epilogue. Returns the FROZEN cached array itself
    when the eval has no dynamic state (identity is the wave-sharing
    and device-residency contract); any dynamic state copies first.

    ``feas_builder`` supplies the distinct-constraint epilogue (the
    proposed-alloc-dependent masks stay the Python implementation —
    they are per-eval by nature)."""
    cache = default_mask_cache
    usage = getattr(snapshot, "usage", None)
    entry = cache.entry_for(program, cluster, snapshot, usage)

    # ALL fallible work (the dynamic epilogue) runs before anything
    # mutates ctx state: an exception here falls back to the Python
    # builder in stack._base_mask, and a half-replayed tally would
    # then double-count the same filtered nodes in the eval's
    # AllocMetric. CSI drops are staged for the same reason.
    mask = entry.mask
    dynamic = (exclude.any() or program.has_csi_volumes
               or program.distinct_hosts_job or program.distinct_hosts_tg
               or program.distinct_property)
    csi_dropped = []
    if dynamic:
        mask = mask.copy()
        mask &= ~exclude
        if program.has_csi_volumes:
            c = cluster
            nodes_by_id = _nodes_by_id(c, snapshot)
            for i in range(c.n_real):
                if not mask[i]:
                    continue
                node = nodes_by_id.get(c.node_ids[i])
                if node is None:
                    mask[i] = False
                    continue
                if not csi_ok(node, tg, snapshot, job.namespace):
                    mask[i] = False
                    csi_dropped.append(node)
        if program.distinct_hosts_job or program.distinct_hosts_tg \
                or program.distinct_property:
            feas_builder._apply_distinct(
                mask, job, tg, job_allocs_by_node,
                _nodes_by_id(cluster, snapshot))
        cache.note_dynamic()

    # metrics + eligibility replay (what the per-eval builder tallied)
    metrics = ctx.metrics()
    for reason, cls, n in entry.filter_counts:
        metrics.nodes_filtered += n
        if cls:
            metrics.class_filtered[cls] = \
                metrics.class_filtered.get(cls, 0) + n
        if reason:
            metrics.constraint_filtered[reason] = \
                metrics.constraint_filtered.get(reason, 0) + n
    if not program.escaped:
        elig = ctx.eligibility
        for cls, ok in entry.class_job_elig.items():
            elig.set_job_eligibility(ok, cls)
        for cls, ok in entry.class_tg_elig.items():
            elig.set_tg_eligibility(ok, tg.name, cls)
    for node in csi_dropped:
        metrics.filter_node(node, FILTER_CONSTRAINT_CSI_PLUGINS)
    return mask
