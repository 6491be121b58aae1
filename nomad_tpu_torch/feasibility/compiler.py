"""Compile a (job, task group) constraint tree into a mask program.

The per-eval Python ``FeasibilityBuilder.base_mask`` re-walks every
constraint, driver, volume and distinct rule per evaluation. But almost
none of that depends on the evaluation: for a fixed node structure the
result is a pure function of the constraint tree. This module compiles
the tree ONCE per distinct tree (keyed by a structural signature, so
two jobs with equal specs share one program) into a ``MaskProgram`` —
an ordered list of phase ops mirroring the Python builder's phases
exactly:

- ``dc``: ready/datacenter/node-pool mask (readyNodesInDCs, incl. DC
  glob patterns);
- ``class``: job- then tg-level constraint + driver + device-existence
  checks evaluated once per computed node class on a representative
  (the EvalEligibility memoization, feasible.go:1050), applied to the
  class's rows vectorized;
- ``escaped``: constraints on unique properties escape the class cache
  — the whole merged set is evaluated per node, vectorized over the
  interned attribute vocabulary (attr_planes.py) so regex/semver parse
  once per DISTINCT value;
- ``volumes``: host-volume presence per node.

Proposed-alloc-dependent rules (distinct_hosts/distinct_property) and
snapshot-claim-dependent CSI checks cannot be compiled into the cached
mask; the program carries them as DYNAMIC flags the per-eval epilogue
(runtime.apply_program) applies on top.

``compile_program`` returns None for trees the compiler cannot express
(today: escaped sets whose right-hand targets are themselves node
interpolations — the value-pair case the vocabulary LUT cannot
vectorize). The caller falls back to the Python builder, and the
fallback is property-tested bit-identical (tests/
test_feasibility_compiler.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from nomad_tpu_torch.scheduler.feasible import (
    merged_tg_constraints,
    required_drivers,
)
from nomad_tpu_torch.structs import consts

__all__ = ["MaskProgram", "compile_program", "program_signature"]

#: operands the vectorized escaped path evaluates through the interned
#: vocabulary LUT (everything check_constraint handles; distinct_* pass
#: through it as always-true exactly like checkConstraint does)
_DISTINCT_OPERANDS = (consts.CONSTRAINT_DISTINCT_HOSTS,
                      consts.CONSTRAINT_DISTINCT_PROPERTY)


def _con_key(c) -> Tuple[str, str, str]:
    return (c.ltarget, c.operand, c.rtarget)


def _vol_key(req) -> Tuple:
    return (req.type, req.source, bool(req.read_only))


def _dev_key(tg) -> Tuple:
    out = []
    for task in tg.tasks:
        for d in task.resources.devices:
            out.append((d.name, int(d.count),
                        tuple(_con_key(c) for c in
                              getattr(d, "constraints", ()) or ()),
                        tuple((a.ltarget, a.operand, a.rtarget,
                               int(a.weight)) for a in
                              getattr(d, "affinities", ()) or ())))
    return tuple(out)


def program_signature(job, tg) -> Tuple:
    """Structural fingerprint of everything the cached mask depends
    on. Jobs with equal trees share one compiled program AND one
    evaluated mask per node structure — which is what pushes the
    steady-burst cache hit ratio toward 1.0 under homogeneous
    traffic."""
    return (
        tuple(job.datacenters),
        job.node_pool,
        tuple(_con_key(c) for c in job.constraints),
        tuple(_con_key(c) for c in merged_tg_constraints(tg)),
        tuple(required_drivers(tg)),
        tuple(sorted(_vol_key(r) for r in tg.volumes.values())),
        _dev_key(tg),
    )


@dataclass
class MaskProgram:
    """Compiled constraint tree for one (job, tg) shape."""

    signature: Tuple
    datacenters: Tuple[str, ...]
    node_pool: str
    job_constraints: Tuple = ()
    tg_constraints: Tuple = ()          # tg + task constraints, merged
    drivers: Tuple[str, ...] = ()
    #: a task group carrying device asks (existence checked per class
    #: rep / per node, like DeviceChecker.hasDevices)
    has_device_asks: bool = False
    #: constraints escape the class cache (unique-property targets):
    #: the merged set evaluates per node over the vocabulary planes
    escaped: bool = False
    host_volumes: Tuple = ()            # host-volume reqs (ragged objs)
    #: DYNAMIC epilogue flags — per-eval state the cached mask cannot
    #: carry
    has_csi_volumes: bool = False
    distinct_hosts_job: bool = False
    distinct_hosts_tg: bool = False
    distinct_property: bool = False
    #: the live tg/job objects the evaluation phases need (ragged
    #: checks reuse the Python helpers verbatim for bit-identity)
    job: object = field(default=None, repr=False)
    tg: object = field(default=None, repr=False)


def _escapes(constraints) -> bool:
    from nomad_tpu_torch.scheduler.context import _constraints_escape

    return _constraints_escape(constraints)


def compile_program(job, tg) -> Optional[MaskProgram]:
    """Compile or refuse (None -> Python-builder fallback)."""
    job_cons = tuple(job.constraints)
    tg_cons = tuple(merged_tg_constraints(tg))
    escaped = _escapes(job_cons) or any(
        _escapes(t.constraints) for t in [tg] + list(tg.tasks))
    if escaped:
        # the vectorized escaped path resolves the LEFT target through
        # the vocabulary; a right target that is itself a node
        # interpolation is a value-pair predicate the LUT cannot
        # express — fall back to the per-node Python builder
        for c in list(job_cons) + list(tg_cons):
            if c.operand in _DISTINCT_OPERANDS:
                continue
            if c.rtarget.startswith("${"):
                return None
    host_vols = tuple(r for r in tg.volumes.values() if r.type == "host")
    has_csi = any(r.type == "csi" for r in tg.volumes.values())
    has_devs = any(t.resources.devices for t in tg.tasks)
    return MaskProgram(
        signature=program_signature(job, tg),
        datacenters=tuple(job.datacenters),
        node_pool=job.node_pool,
        job_constraints=job_cons,
        tg_constraints=tg_cons,
        drivers=tuple(required_drivers(tg)),
        has_device_asks=has_devs,
        escaped=escaped,
        host_volumes=host_vols,
        has_csi_volumes=has_csi,
        distinct_hosts_job=any(
            c.operand == consts.CONSTRAINT_DISTINCT_HOSTS
            for c in job.constraints),
        distinct_hosts_tg=any(
            c.operand == consts.CONSTRAINT_DISTINCT_HOSTS
            for c in tg.constraints),
        distinct_property=any(
            c.operand == consts.CONSTRAINT_DISTINCT_PROPERTY
            for c in list(job.constraints) + list(tg.constraints)),
        job=job,
        tg=tg,
    )
