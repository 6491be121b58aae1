"""Sharded placement: the node axis split over a mesh of devices.

Counterpart of ``nomad_tpu/parallel/sharded.py``. The JAX package lets
GSPMD partition its placement programs and writes the fused wave's
per-shard body under ``shard_map``; here one process drives every shard.
Which route runs where:

- the fused sharded wave (``fused_sharded_entry``) on CUDA shards is one
  call of the hand kernel ``ops/cuda_kernel.sharded_wave_place``
  (``csrc/sharded_wave.cu``): one cluster launch a card, the cards
  trading each step's result through mailboxes;
- the joint sharded wave (``joint_sharded_entry``: spreads, devices,
  cores and network, outside the fused envelope, and shards of any
  width) on CUDA shards is one call of the hand kernel
  ``ops/cuda_kernel.joint_sharded_wave_place``
  (``csrc/joint_sharded_wave.cu``), as the joint kernel runs beside B1 on
  one device;
- on CPU shards both run ``_sharded_wave``, the kernels' plain version
  (which ``chip_smoke.py`` also holds the kernels against on the card).

``_sharded_wave`` is torch ops:

- a leaf is *placed* (``place``) as a tuple of per-position tensors, one
  per mesh position, each a contiguous tensor of its own: node-axis
  planes hold their shard's rows, other leaves a copy per device;
- each shard runs the port's composite functions (``ops/kernel``'s
  ``_feasible``, ``_score``, ``_spread_score``, ``_deduct``,
  ``topk_ordered``) on its own rows, and the per-step choice is merged
  across shards with the collectives of ``parallel/mesh``.

Selection is bit-identical to the one-device wave, not only in score.
The composite picks the lowest index among the maxima (or, under
shuffle, the lowest permutation rank); each shard offers its maximum,
the lowest rank among its maxima and that node's global index, and the
merge takes the largest value, then the lowest rank, then the lowest
index: the reference's pmax / pmin / pmin cascade (sharded.py:390-397)
over one gather. The top-k is each shard's top-k in (value desc, index
asc) order, gathered in shard order, and ``topk_ordered`` again, which
keeps the composite's tie order. Integer metrics are local sums and
one exact sum across shards. Nothing is read to the host inside the
step loop: the step maps and each member's step count are read once
before it, and an inactive step's outputs are the constants the
composite computes for it.

``make_place_batch`` is the batched placement over an (evals, nodes)
mesh: evals split over ``evals``, nodes over ``nodes``. Each eval is a
placement problem of its own: in the fused envelope a one-member wave
through ``sharded_wave_place`` over its evals row's node shards, or
through B1 (``fused_wave_place``) on a row of one shard, where their
cluster holds its rows (``sharded_wave_fits``, ``fused_wave_fits``); any
other eval through the joint hand kernels, ``joint_sharded_wave_place``
over the row's shards or ``joint_wave_place`` on a row of one.
"""

from __future__ import annotations

import threading
import weakref
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from nomad_tpu_torch.device import DeviceLike
from nomad_tpu_torch.ops.cuda_kernel import (
    fused_wave_fits,
    fused_wave_place,
    joint_sharded_wave_place,
    joint_wave_place,
    raise_on_wave_error,
    sharded_wave_fits,
    sharded_wave_place,
    wave_active_steps,
    wave_kernel_out,
)
from nomad_tpu_torch.ops.kernel import (
    FULL_FEATURES,
    NEG_INF,
    TOPK,
    JointOut,
    KernelFeatures,
    KernelIn,
    KernelOut,
    _argmax_first,
    _bump_spread,
    _deduct,
    _feasible,
    _member_view,
    _score,
    _spread_onehot,
    fused_pack_len,
    fused_wave_supported,
    topk_ordered,
)
from nomad_tpu_torch.parallel import mesh as _mesh
from nomad_tpu_torch.parallel.mesh import (
    AXIS_EVALS,
    AXIS_NODES,
    Mesh,
    available_devices,
)

_B = AXIS_EVALS
_N = AXIS_NODES

#: the largest int64: "no candidate" in the rank and index reductions
_BIG = torch.iinfo(torch.int64).max


class P(tuple):
    """A partition spec: for each leading dim of a leaf, the mesh axis it
    splits over, or None (replicated). Dims past the spec replicate."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A spec bound to a mesh: how one leaf is placed."""

    mesh: Mesh
    spec: P


# PartitionSpec per KernelIn field for the BATCHED layout (leading B dim).
_IN_SPECS = dict(
    # [B, N] node planes
    cap_cpu=P(_B, _N), cap_mem=P(_B, _N), cap_disk=P(_B, _N),
    free_cores=P(_B, _N), shares_per_core=P(_B, _N), free_dyn=P(_B, _N),
    base_mask=P(_B, _N), used_cpu=P(_B, _N), used_mem=P(_B, _N),
    used_disk=P(_B, _N), used_cores=P(_B, _N), used_mbits=P(_B, _N),
    avail_mbits=P(_B, _N), port_conflict=P(_B, _N),
    dev_aff_score=P(_B, _N), job_tg_count=P(_B, _N), penalty=P(_B, _N),
    aff_score=P(_B, _N), job_any_count=P(_B, _N),
    # [B, N, D]
    dev_free=P(_B, _N, None),
    # [B] scalars
    has_dev_affinity=P(_B), distinct_hosts_job=P(_B), distinct_hosts_tg=P(_B),
    ask_cpu=P(_B), ask_mem=P(_B), ask_disk=P(_B), ask_cores=P(_B),
    ask_dyn_ports=P(_B), ask_has_reserved_ports=P(_B), ask_mbits=P(_B),
    desired_count=P(_B), algorithm_spread=P(_B), n_steps=P(_B),
    # tie-break permutation [B, N] (replicated over nodes: it indexes
    # the global node axis, so it cannot shard with it)
    node_perm=P(_B, None),
    # per-step planes [B, K, ...]
    step_penalty=P(_B, None, None), step_preferred=P(_B, None),
    # spreads
    spread_active=P(_B, None), spread_even=P(_B, None),
    spread_weight=P(_B, None),
    spread_bucket=P(_B, None, _N),
    spread_counts=P(_B, None, None), spread_desired=P(_B, None, None),
    # [B, D]
    ask_dev=P(_B, None),
)

assert set(_IN_SPECS) == set(KernelIn._fields)


def batched_in_shardings(mesh: Mesh) -> KernelIn:
    return KernelIn(**{f: NamedSharding(mesh, s) for f, s in _IN_SPECS.items()})


def batched_out_shardings(mesh: Mesh) -> KernelOut:
    # outputs are small (per-placement rows); shard only the batch axis
    return KernelOut(
        **{f: NamedSharding(mesh, P(_B)) for f in KernelOut._fields}
    )


def stack_kernel_ins(kins: Sequence[KernelIn]) -> KernelIn:
    """Stack B single-problem inputs into one batched KernelIn (host
    numpy).

    All problems must share the same padded node axis (the bucketed
    static shapes from tensors/schema.pad_bucket guarantee few distinct
    buckets; the broker batches compatible evals together).
    """
    return KernelIn(*[np.stack([np.asarray(x) for x in xs])
                      for xs in zip(*kins)])


# PartitionSpec per stacked KernelIn field of a joint WAVE ([B, ...]
# member axis replicated, node axis sharded).
_JOINT_SPECS = dict(
    cap_cpu=P(None, _N), cap_mem=P(None, _N), cap_disk=P(None, _N),
    free_cores=P(None, _N), shares_per_core=P(None, _N),
    free_dyn=P(None, _N), base_mask=P(None, _N), used_cpu=P(None, _N),
    used_mem=P(None, _N), used_disk=P(None, _N), used_cores=P(None, _N),
    used_mbits=P(None, _N), avail_mbits=P(None, _N),
    port_conflict=P(None, _N), dev_aff_score=P(None, _N),
    job_tg_count=P(None, _N), penalty=P(None, _N), aff_score=P(None, _N),
    job_any_count=P(None, _N),
    dev_free=P(None, _N, None),
    has_dev_affinity=P(None), distinct_hosts_job=P(None),
    distinct_hosts_tg=P(None),
    ask_cpu=P(None), ask_mem=P(None), ask_disk=P(None), ask_cores=P(None),
    ask_dyn_ports=P(None), ask_has_reserved_ports=P(None),
    ask_mbits=P(None), desired_count=P(None), algorithm_spread=P(None),
    n_steps=P(None),
    node_perm=P(None, None),        # indexes the GLOBAL node axis
    step_penalty=P(None, None, None), step_preferred=P(None, None),
    spread_active=P(None, None), spread_even=P(None, None),
    spread_weight=P(None, None),
    spread_bucket=P(None, None, _N),
    spread_counts=P(None, None, None), spread_desired=P(None, None, None),
    ask_dev=P(None, None),
)

assert set(_JOINT_SPECS) == set(KernelIn._fields)


def shared_field_spec(field: str) -> P:
    """PartitionSpec of a WAVE-SHARED (unbatched) KernelIn leaf: the
    stacked layout's spec minus the leading member axis. The single
    source of truth for the sharded launcher, the device-resident
    state's frozen-singleton placement and the warmup: a resident plane
    placed by another spec would be placed again on every wave."""
    return P(*tuple(_JOINT_SPECS[field])[1:])


def node_axis_sharding(mesh: Mesh) -> NamedSharding:
    """The [n_pad] node-plane sharding: rows split over the mesh's
    nodes axis (tensors/device_state.py places resident generations
    with this)."""
    return NamedSharding(mesh, P(_N))


def joint_in_shardings(mesh: Mesh, shared: bool = False,
                       neutral_shared: bool = False,
                       job_shared: bool = False):
    """(KernelIn-of-NamedSharding, replicated) for a wave layout: a
    field that ships UNBATCHED under the layout flags loses the member
    axis and keeps its node-axis split; stacked fields keep the full
    joint spec."""
    from nomad_tpu_torch.parallel.coalesce import wave_field_is_shared

    kin = KernelIn(**{
        f: NamedSharding(
            mesh,
            shared_field_spec(f)
            if wave_field_is_shared(f, shared, neutral_shared, job_shared)
            else s)
        for f, s in _JOINT_SPECS.items()
    })
    return kin, NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# Placement: host arrays and tensors split into per-position tensors.
# ---------------------------------------------------------------------------

def _position_slices(shape, spec: P, mesh: Mesh) -> list:
    """For each mesh position (row-major), the leaf's index there."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than shape {shape}")
    out = []
    for idx in np.ndindex(mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, idx))
        sl = []
        for dim, axis in enumerate(spec):
            if axis is None:
                sl.append(slice(None))
                continue
            parts = mesh.axis_size(axis)
            if shape[dim] % parts:
                raise ValueError(
                    f"dim {dim} of {tuple(shape)} does not split over "
                    f"{parts} {axis!r} shards")
            size = shape[dim] // parts
            i = coord.get(axis, 0)
            sl.append(slice(i * size, (i + 1) * size))
        out.append(tuple(sl))
    return out


def _place(leaf, spec: P, mesh: Mesh) -> tuple:
    """``(parts, bytes moved)``: ``leaf`` (host numpy or a tensor) as one
    contiguous tensor per mesh position. Positions that hold the same
    slice on the same device share one tensor (a read-only replica)."""
    src = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    made: dict = {}
    parts = []
    moved = 0
    for sl, dev in zip(_position_slices(tuple(src.shape), spec, mesh),
                       mesh.devices.flat):
        key = (tuple((s.start, s.stop) for s in sl), dev)
        t = made.get(key)
        if t is None:
            piece = src[sl]
            if isinstance(piece, torch.Tensor):
                if piece.device != dev:
                    moved += piece.numel() * piece.element_size()
                t = piece.to(device=dev, copy=True,
                             memory_format=torch.contiguous_format)
            else:
                piece = np.ascontiguousarray(piece)
                moved += piece.nbytes
                t = torch.tensor(piece, device=dev)
            made[key] = t
        parts.append(t)
    return tuple(parts), moved


def place(leaf, spec: P, mesh: Mesh) -> tuple:
    """``leaf`` split by ``spec`` over ``mesh``: a tuple of tensors, one
    per mesh position (row-major), each a contiguous tensor of its own."""
    return _place(leaf, spec, mesh)[0]


def _is_placed(leaf, mesh: Mesh) -> bool:
    """Whether ``leaf`` is already a placed leaf of ``mesh``."""
    return isinstance(leaf, tuple) and len(leaf) == mesh.size and all(
        isinstance(t, torch.Tensor) and t.device == d
        for t, d in zip(leaf, mesh.devices.flat))


def place_args(kin: KernelIn, shardings: KernelIn) -> tuple:
    """``(KernelIn of placed leaves, bytes moved)``: leaves already placed
    (resident twins) pass as they are; a host array held under several
    fields with one spec is placed once."""
    done: dict = {}
    leaves = []
    moved = 0
    for name, x, sh in zip(KernelIn._fields, kin, shardings):
        if isinstance(x, tuple):
            if not _is_placed(x, sh.mesh):
                raise ValueError(f"{name}: a placed leaf of another mesh")
            leaves.append(x)
            continue
        key = (id(x), sh.spec) if isinstance(x, np.ndarray) else None
        got = done.get(key) if key is not None else None
        if got is None:
            got, n = _place(x, sh.spec, sh.mesh)
            moved += n
            if key is not None:
                done[key] = got
        leaves.append(got)
    return KernelIn(*leaves), moved


def _shards_of(placed: KernelIn, positions: Sequence[int]) -> List[KernelIn]:
    return [KernelIn(*[leaf[p] for leaf in placed]) for p in positions]


def _to_positions(parts_row: Sequence[torch.Tensor], mesh: Mesh) -> tuple:
    """Node-sharded parts of one evals row as a placed leaf of ``mesh``
    (each evals row holds the same node shards)."""
    rows = mesh.node_rows()
    out: list = [None] * mesh.size
    for row in rows:
        for shard, p in enumerate(row):
            t = parts_row[shard]
            d = mesh.devices.flat[p]
            out[p] = t if t.device == d else t.to(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# The per-shard wave body, shared by the fused and the joint entries.
# ---------------------------------------------------------------------------

class _ShardWave:
    """One shard of a joint wave: its rows' view of every member, its
    carries, and its local candidates for each step."""

    def __init__(self, kin: KernelIn, shard: int, b: int,
                 f: KernelFeatures) -> None:
        self.kin = kin
        self.dev = kin.cap_cpu.device
        n_loc = kin.cap_cpu.shape[-1]
        self.n_loc = n_loc
        self.g0 = shard * n_loc
        self.giota = torch.arange(self.g0, self.g0 + n_loc,
                                  dtype=torch.int64, device=self.dev)
        self.views: dict = {}
        self.onehots: dict = {}
        self.ranks: dict = {}

        def _bat(x, rank):
            # carried leaves need a member axis even when shipped shared;
            # the copy is this shard's own, so in-place updates never
            # touch an input
            if x.dim() == rank + 1:
                return x.clone()
            return x.expand((b,) + tuple(x.shape)).clone()

        zf = torch.zeros(n_loc, dtype=torch.float32, device=self.dev)
        zi = torch.zeros(n_loc, dtype=torch.int32, device=self.dev)
        st = dict(a_cpu=zf, a_mem=zf, a_disk=zf,
                  job_tg_count=_bat(kin.job_tg_count, 1))
        if f.with_cores:
            st["a_cores"] = zi
        if f.with_network:
            st["a_mbits"] = zi
        if f.with_ports:
            st["a_dyn"] = zi
            st["port_conflict"] = _bat(kin.port_conflict, 1)
        if f.with_devices:
            st["a_dev"] = torch.zeros((n_loc, kin.dev_free.shape[-1]),
                                      dtype=torch.float32, device=self.dev)
        if f.with_distinct:
            st["job_any_count"] = _bat(kin.job_any_count, 1)
        if f.n_spreads > 0:
            st["spread_counts"] = _bat(kin.spread_counts, 2)
        self.st = st

    def view(self, m: int) -> KernelIn:
        kin_m = self.views.get(m)
        if kin_m is None:
            kin_m = self.views[m] = _member_view(self.kin, m)
        return kin_m

    def member_state(self, m: int, kin_m: KernelIn,
                     f: KernelFeatures) -> dict:
        st = self.st
        st_m = dict(
            used_cpu=kin_m.used_cpu + st["a_cpu"],
            used_mem=kin_m.used_mem + st["a_mem"],
            used_disk=kin_m.used_disk + st["a_disk"],
            job_tg_count=st["job_tg_count"][m],
        )
        if f.with_cores:
            st_m["used_cores"] = kin_m.used_cores + st["a_cores"]
        if f.with_network:
            st_m["used_mbits"] = kin_m.used_mbits + st["a_mbits"]
        if f.with_ports:
            st_m["free_dyn"] = kin_m.free_dyn - st["a_dyn"]
            st_m["port_conflict"] = st["port_conflict"][m]
        if f.with_devices:
            st_m["dev_free"] = kin_m.dev_free - st["a_dev"]
        if f.with_distinct:
            st_m["job_any_count"] = st["job_any_count"][m]
        if f.n_spreads > 0:
            st_m["spread_counts"] = st["spread_counts"][m]
        return st_m

    def onehot(self, m: int, kin_m: KernelIn, f: KernelFeatures):
        oh = self.onehots.get(m)
        if oh is None:
            oh = self.onehots[m] = _spread_onehot(kin_m.spread_bucket,
                                                  f.n_spreads)
        return oh

    def rank(self, m: int, kin_m: KernelIn, inverses: dict):
        """This shard's rows of inv(node_perm): the permutation is
        replicated (it indexes the global axis), so its inverse is
        computed in full once per device and member, then sliced."""
        r = self.ranks.get(m)
        if r is None:
            key = (self.dev, m)
            inv = inverses.get(key)
            if inv is None:
                perm = kin_m.node_perm.to(torch.int64)
                inv = torch.empty_like(perm)
                inv[perm] = torch.arange(perm.shape[0], dtype=torch.int64,
                                         device=self.dev)
                inverses[key] = inv
            r = self.ranks[m] = inv[self.g0:self.g0 + self.n_loc]
        return r


def _local_candidates(masked: torch.Tensor, rank: Optional[torch.Tensor],
                      giota: torch.Tensor, g0: int, k_loc: int) -> tuple:
    """This shard's offer for one step: ``(value, rank, global index)``
    of its winner (its maximum, the lowest rank among its maxima, that
    node), and with ``k_loc`` its top ``k_loc`` values and their global
    indices in (value desc, index asc) order, the composite's stable
    sort. ``rank`` None ranks by the global index. Every index is
    tensor arithmetic: indexing with a 0-d tensor would read it to the
    host."""
    tv = gi = None
    if k_loc:
        sv, si = torch.sort(masked, dim=-1, descending=True, stable=True)
        tv, gi = sv[..., :k_loc], si[..., :k_loc] + g0
        lmax = sv[..., 0]
        first = gi[..., 0]
    else:
        lmax = masked.amax(dim=-1)
        first = _argmax_first(masked) + g0
    if rank is None:
        return lmax, first, first, tv, gi
    is_max = masked == lmax.unsqueeze(-1)
    lrank = torch.where(is_max, rank, _BIG).amin(dim=-1)
    lidx = torch.where(is_max & (rank == lrank.unsqueeze(-1)), giota,
                       _BIG).amin(dim=-1)
    return lmax, lrank, lidx, tv, gi


def _merge_best(vals: torch.Tensor, ranks: torch.Tensor,
                idxs: torch.Tensor) -> tuple:
    """The cascade over the gathered winners ([D, ...]): the largest
    value, then the lowest rank among it, then the lowest index."""
    vmax = vals.amax(dim=0)
    tie = vals == vmax
    rwin = torch.where(tie, ranks, _BIG).amin(dim=0)
    best = torch.where(tie & (ranks == rwin), idxs, _BIG).amin(dim=0)
    return vmax, best


def _merge_topk(tv: torch.Tensor, gi: torch.Tensor) -> tuple:
    """Top-k of the gathered local top-k lists ([D, ..., k] values and
    global indices), in shard order: value desc, then global index
    asc, as the composite's stable sort orders them."""
    lead = tv.shape[1:-1]
    tv_all = tv.movedim(0, -2).reshape(lead + (-1,))
    gi_all = gi.movedim(0, -2).reshape(lead + (-1,))
    topv, pos = topk_ordered(tv_all, TOPK)
    return topv, torch.gather(gi_all, -1, pos)


def _wave_metrics(sw: _ShardWave, b: int, f: KernelFeatures) -> torch.Tensor:
    """This shard's i32 AllocMetric partial sums, [8, B] in
    FUSED_METRIC_FIELDS order, from the pre-wave state."""
    metrics = []
    for m in range(b):
        kin_m = sw.view(m)
        st0 = dict(
            used_cpu=kin_m.used_cpu, used_mem=kin_m.used_mem,
            used_disk=kin_m.used_disk, job_tg_count=kin_m.job_tg_count,
            used_cores=kin_m.used_cores, used_mbits=kin_m.used_mbits,
            free_dyn=kin_m.free_dyn, port_conflict=kin_m.port_conflict,
            dev_free=kin_m.dev_free, job_any_count=kin_m.job_any_count,
        )
        feas0, _, dims0 = _feasible(kin_m, st0, f)
        base_i = kin_m.base_mask

        def ex(fit):
            return torch.sum(base_i & ~fit).to(torch.int32)

        metrics.append(torch.stack([
            torch.sum(base_i).to(torch.int32),
            torch.sum(feas0).to(torch.int32),
            ex(dims0["fit_cpu"]), ex(dims0["fit_mem"]), ex(dims0["fit_disk"]),
            ex(dims0["fit_ports"]), ex(dims0["fit_dev"]),
            ex(dims0["fit_cores"]),
        ]))
    return torch.stack(metrics, dim=1)


def _sharded_wave(shards: List[KernelIn], step_member, step_local,
                  t_steps: int, features: KernelFeatures):
    """The joint wave over node shards (``shards[s]`` holds global rows
    ``[s * n_loc, (s + 1) * n_loc)``): the composite's
    ``place_taskgroups_joint`` with its per-step choice merged across
    shards. Returns a JointOut on the first shard's device whose a_*
    carries are per-shard lists."""
    f = features
    n_shards = len(shards)
    devs = [s.cap_cpu.device for s in shards]
    root = devs[0]
    b = int(shards[0].n_steps.shape[0])   # n_steps is always member-stacked
    # an inactive step (padding, or past its member's count) masks every
    # node: the composite then returns the idle constants and commits
    # nothing
    active = {t: (m, j) for t, m, j in wave_active_steps(
        step_member, step_local, shards[0].n_steps, t_steps,
        int(shards[0].step_preferred.shape[-1]))}
    sws = [_ShardWave(kin, s, b, f) for s, kin in enumerate(shards)]
    n_loc = sws[0].n_loc
    n_glob = n_loc * n_shards
    k_loc = min(TOPK, n_loc)
    inverses: dict = {}

    idle_topi = (torch.arange(TOPK, dtype=torch.int32, device=root)
                 if f.with_topk
                 else torch.zeros(TOPK, dtype=torch.int32, device=root))
    idle = (torch.tensor(-1, dtype=torch.int32, device=root),
            torch.tensor(0.0, dtype=torch.float32, device=root),
            torch.tensor(False, device=root), idle_topi,
            torch.full((TOPK,), NEG_INF, dtype=torch.float32, device=root))

    outs = []
    for t in range(t_steps):
        if t not in active:
            outs.append(idle)
            continue
        m, jj = active[t]
        fparts, iparts, steps = [], [], []
        for sw in sws:
            kin_m = sw.view(m)
            st_m = sw.member_state(m, kin_m, f)
            feasible, ask_cpu_total, _ = _feasible(kin_m, st_m, f)
            penalty = kin_m.penalty
            if f.with_step_penalties:
                pen_ids = kin_m.step_penalty[jj].to(torch.int64)  # global
                penalty = penalty | torch.any(
                    sw.giota[:, None] == pen_ids[None, :], dim=1)
            onehot = sw.onehot(m, kin_m, f) if f.n_spreads > 0 else None
            final = _score(kin_m, st_m, ask_cpu_total, penalty, f, onehot)
            masked = torch.where(feasible, final, NEG_INF)
            rank = sw.rank(m, kin_m, inverses) if f.with_shuffle else None
            lmax, lrank, lidx, tv, gi = _local_candidates(
                masked, rank, sw.giota, sw.g0, k_loc if f.with_topk else 0)
            fp, ip = [lmax.reshape(1)], [lrank.reshape(1), lidx.reshape(1)]
            if f.with_preferred:
                # the pin is replicated: shard 0's copy lies on the root
                pref = kin_m.step_preferred[jj].to(torch.int64)
                if sw is sws[0]:
                    pref_root = pref
                off = (torch.clamp(pref, 0, n_glob - 1) - sw.g0).reshape(1)
                inside = (off >= 0) & (off < n_loc)
                offc = torch.clamp(off, 0, n_loc - 1)
                fp.append(torch.where(inside, masked.gather(0, offc),
                                      float("-inf")))
                ip.append((feasible.gather(0, offc) & inside)
                          .to(torch.int64))
            if f.with_topk:
                fp.append(tv)
                ip.append(gi)
            fparts.append(torch.cat(fp))
            iparts.append(torch.cat(ip))
            steps.append((kin_m, ask_cpu_total, onehot))
        fall = _mesh.all_gather(fparts)            # [D, nf] on root
        iall = _mesh.all_gather(iparts)            # [D, ni] on root
        vmax, best = _merge_best(fall[:, 0], iall[:, 0], iall[:, 1])
        if f.with_preferred:
            pref_ok = (pref_root >= 0) & torch.any(iall[:, 2] > 0)
            idx = torch.where(pref_ok,
                              torch.clamp(pref_root, 0, n_glob - 1), best)
            val = torch.where(pref_ok, fall[:, 1].amax(), vmax)
            f0, i0 = 2, 3
        else:
            idx, val = best, vmax
            f0, i0 = 1, 2
        found = val > NEG_INF / 2
        if f.with_topk:
            topv, topi = _merge_topk(fall[:, f0:], iall[:, i0:])
        else:
            topv = torch.full((TOPK,), NEG_INF, dtype=torch.float32,
                              device=root)
            topi = torch.zeros(TOPK, dtype=torch.int64, device=root)

        # the choice back to every shard; each commits its own rows
        sel = _mesh.broadcast(torch.stack([idx, found.to(torch.int64)]),
                              devs)
        bumps = []
        for sw, (kin_m, ask_cpu_total, onehot), sel_s in zip(sws, steps,
                                                              sel):
            st = sw.st
            at = sw.giota == sel_s[0]
            onei = at.to(torch.int32) * sel_s[1].to(torch.int32)
            one = at.to(torch.float32) * sel_s[1].to(torch.float32)
            st["a_cpu"] = st["a_cpu"] + one * ask_cpu_total
            st["a_mem"] = st["a_mem"] + one * kin_m.ask_mem
            st["a_disk"] = st["a_disk"] + one * kin_m.ask_disk
            st["job_tg_count"][m] += onei
            if f.with_cores:
                st["a_cores"] = st["a_cores"] + onei * kin_m.ask_cores
            if f.with_network:
                st["a_mbits"] = st["a_mbits"] + onei * kin_m.ask_mbits
            if f.with_ports:
                st["a_dyn"] = st["a_dyn"] + onei * kin_m.ask_dyn_ports
                st["port_conflict"][m] |= (
                    (one > 0) & kin_m.ask_has_reserved_ports)
            if f.with_devices:
                st["a_dev"] = (st["a_dev"]
                               + one[:, None] * kin_m.ask_dev[None, :])
            if f.with_distinct:
                st["job_any_count"][m] += onei
            if f.n_spreads > 0:
                # this shard's one-hot contribution; the sum over
                # shards is the composite's bump (0/1 counts: exact)
                counts = st["spread_counts"][m]
                bumps.append(_bump_spread(kin_m, torch.zeros_like(counts),
                                          one, onehot, f.n_spreads))
        if bumps:
            for sw, bump in zip(sws, _mesh.broadcast(_mesh.psum(bumps),
                                                     devs)):
                sw.st["spread_counts"][m] = sw.st["spread_counts"][m] + bump
        outs.append((
            torch.where(found, idx, -1).to(torch.int32),
            torch.where(found, val, 0.0),
            found,
            topi.to(torch.int32),
            topv,
        ))

    chosen, scores, found, topk_idx, topk_scores = (
        torch.stack([o[i] for o in outs]) for i in range(5))
    met = _mesh.psum([_wave_metrics(sw, b, f) for sw in sws])   # i32[8, B]
    carries = {name: [sw.st[name] for sw in sws]
               for name in ("a_cpu", "a_mem", "a_disk")}
    out = JointOut(
        chosen, scores, found, topk_idx, topk_scores, *met.unbind(0),
        a_cpu=carries["a_cpu"], a_mem=carries["a_mem"],
        a_disk=carries["a_disk"])
    return out


# keyed by the live mesh OBJECT (weakly): a freed mesh's entry evicts
# itself. Each mesh maps sharing-layout flags -> the entry (the sharing
# groups change which leaves carry the member axis, so every layout has
# its own shardings).
_joint_sharded_cache: "weakref.WeakKeyDictionary" = \
    weakref.WeakKeyDictionary()


def joint_sharded_entry(mesh: Mesh, shared: bool = False,
                        neutral_shared: bool = False,
                        job_shared: bool = False):
    """(fn, KernelIn-of-NamedSharding, replicated) for the joint wave
    with the node axis split over ``mesh``'s nodes axis under the given
    sharing layout: ``fn(kin, step_member, step_local, t_steps,
    features) -> FusedWaveOut`` takes any feature union (spreads, devices,
    cores and network included) and any shard width
    (``ops/cuda_kernel.joint_sharded_wave_place``: the hand kernel on CUDA
    shards, ``_sharded_wave`` on CPU ones). Its ``packed`` buffer and top-k
    planes lie on the mesh's first device, its carries node-sharded
    (placed leaves of ``node_axis_sharding(mesh)``), as
    ``fused_sharded_entry``'s. Cached per (mesh, layout)."""
    layouts = _joint_sharded_cache.get(mesh)
    if layouts is None:
        layouts = _joint_sharded_cache[mesh] = {}
    key = (shared, neutral_shared, job_shared)
    hit = layouts.get(key)
    if hit is not None:
        return hit
    kin_shardings, repl = joint_in_shardings(
        mesh, shared, neutral_shared, job_shared)

    def fn(kin, step_member, step_local, t_steps, features):
        placed, _ = place_args(kin, kin_shardings)
        shards = _shards_of(placed, mesh.node_rows()[0])
        out = joint_sharded_wave_place(shards, step_member, step_local,
                                       t_steps, features)
        return out._replace(**{name: _to_positions(getattr(out, name), mesh)
                               for name in ("a_cpu", "a_mem", "a_disk")})

    entry = (fn, kin_shardings, repl)
    layouts[key] = entry
    return entry


def make_joint_sharded(mesh: Mesh, shared: bool = False,
                       neutral_shared: bool = False,
                       job_shared: bool = False):
    """The joint wave's function alone (see ``joint_sharded_entry``)."""
    return joint_sharded_entry(mesh, shared, neutral_shared,
                               job_shared)[0]


#: fused sharded entries, cached per live mesh object like
#: _joint_sharded_cache
_fused_sharded_cache: "weakref.WeakKeyDictionary" = \
    weakref.WeakKeyDictionary()


def fused_sharded_entry(mesh: Mesh, shared: bool = False,
                        neutral_shared: bool = False,
                        job_shared: bool = False):
    """(fn, KernelIn-of-NamedSharding, replicated) for the FUSED wave
    with the node axis split over ``mesh``: ``fn(kin, step_member,
    step_local, t_steps, features) -> FusedWaveOut`` for a feature union
    in the fused envelope (``ops/cuda_kernel.sharded_wave_place``: the
    kernel on CUDA shards, ``_sharded_wave`` on CPU ones; it refuses a
    union outside the envelope), its ``packed`` buffer and top-k planes
    on the mesh's first device and its carries node-sharded (placed
    leaves of ``node_axis_sharding(mesh)``). The shardings are
    ``shared_field_spec``'s layout, so resident twins placed by the
    device state pass through as they are."""
    layouts = _fused_sharded_cache.get(mesh)
    if layouts is None:
        layouts = _fused_sharded_cache[mesh] = {}
    key = (shared, neutral_shared, job_shared)
    hit = layouts.get(key)
    if hit is not None:
        return hit
    kin_shardings, repl = joint_in_shardings(
        mesh, shared, neutral_shared, job_shared)

    def fn(kin, step_member, step_local, t_steps, features):
        placed, _ = place_args(kin, kin_shardings)
        shards = _shards_of(placed, mesh.node_rows()[0])
        out = sharded_wave_place(shards, step_member, step_local, t_steps,
                                 features)
        return out._replace(**{name: _to_positions(getattr(out, name), mesh)
                               for name in ("a_cpu", "a_mem", "a_disk")})

    entry = (fn, kin_shardings, repl)
    layouts[key] = entry
    return entry


def wave_mesh(n_devices: int = 0, devices=None,
              device: DeviceLike = None) -> Mesh:
    """A 1D nodes-axis mesh for live waves (the coalescer's multi-card
    routing; evals parallelism comes from wave batching, so every
    device goes to the node axis), over ``devices`` or
    ``available_devices(device)``."""
    devs = list(devices if devices is not None
                else available_devices(device))
    if n_devices:
        devs = devs[:n_devices]
    grid = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(grid, (_N,))


def unstack_kernel_outs(out: KernelOut) -> List[KernelOut]:
    """Split a batched KernelOut back into per-problem results (host
    numpy)."""
    host = KernelOut(*[
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x) for x in out])
    b = host.chosen.shape[0]
    return [KernelOut(*[f[i] for f in host]) for i in range(b)]


# ---------------------------------------------------------------------------
# Batched placement over an (evals, nodes) mesh.
# ---------------------------------------------------------------------------

class _PlaceBatchStats:
    """``make_place_batch``'s routes, counted per eval as it is sent:
    ``fused_calls`` calls of B1 (``fused_wave_place``: an eval in the
    fused envelope on an evals row of one node shard, which B1's cluster
    holds), ``joint_calls`` calls of the joint kernel
    (``joint_wave_place``: any other eval on a row of one),
    ``sharded_calls`` calls of the sharded kernels on a row of two or
    more (``sharded_wave_place`` for an eval in the envelope whose shards
    it takes, ``joint_sharded_wave_place`` for any other), ``plain_evals`` evals
    through the wave body as torch ops (every eval of a ``plain`` step).
    On CPU shards the four wrappers run their plain versions and are
    counted the same."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.fused_calls = 0
        self.joint_calls = 0
        self.sharded_calls = 0
        self.plain_evals = 0

    def note(self, fused: int = 0, joint: int = 0, sharded: int = 0,
             plain: int = 0) -> None:
        with self._lock:
            self.fused_calls += fused
            self.joint_calls += joint
            self.sharded_calls += sharded
            self.plain_evals += plain

    def reset(self) -> None:
        with self._lock:
            self.fused_calls = self.joint_calls = 0
            self.sharded_calls = self.plain_evals = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"fused_calls": self.fused_calls,
                    "joint_calls": self.joint_calls,
                    "sharded_calls": self.sharded_calls,
                    "kernel_calls": (self.fused_calls + self.joint_calls
                                     + self.sharded_calls),
                    "plain_evals": self.plain_evals}


#: process-wide make_place_batch route counts
place_batch_stats = _PlaceBatchStats()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def eval_features(kin: KernelIn,
                  features: KernelFeatures = FULL_FEATURES) -> list:
    """For each eval of a batched KernelIn, ``features`` without the
    spread, device, core and bandwidth work its planes make neutral: no
    active spread stanza; no device ask and no device affinity; no core
    ask (over finite shares a core, so the cpu total is the cpu ask); no
    bandwidth ask. The dropped work adds nothing to a score, masks no
    node and exhausts none, so the eval places as under ``features``;
    ``fused_wave_supported`` then says whether it fits the kernels."""
    spread = _host(kin.spread_active).reshape(
        _host(kin.n_steps).shape[0], -1).any(axis=-1)
    dev = (_host(kin.ask_dev) > 0).any(axis=-1) | _host(
        kin.has_dev_affinity).astype(bool)
    cores = (_host(kin.ask_cores) != 0) | ~np.isfinite(
        _host(kin.shares_per_core)).all(axis=-1)
    net = _host(kin.ask_mbits) > 0
    return [features._replace(
        n_spreads=features.n_spreads if spread[e] else 0,
        with_devices=features.with_devices and bool(dev[e]),
        with_cores=features.with_cores and bool(cores[e]),
        with_network=features.with_network and bool(net[e]))
        for e in range(len(spread))]


def _one_eval(shards: List[KernelIn], e: int) -> List[KernelIn]:
    """Eval ``e`` of each shard as a one-member wave's planes: its own
    leaves unbatched (x[e] of a contiguous placed leaf is contiguous),
    ``n_steps`` with its member axis."""
    return [KernelIn(*[x[e:e + 1] if name == "n_steps" else x[e]
                       for name, x in zip(KernelIn._fields, s)])
            for s in shards]


def _plain_eval(one: List[KernelIn], k_steps: int,
                f: KernelFeatures) -> KernelOut:
    """One eval through the wave body as torch ops: a one-member wave of
    ``k_steps`` steps, its member axis stripped."""
    step_member = np.zeros(k_steps, np.int32)
    step_local = np.arange(k_steps, dtype=np.int32)
    out = _sharded_wave(one, step_member, step_local, k_steps, f)
    return KernelOut(out.chosen, out.scores, out.found, out.topk_idx,
                     out.topk_scores,
                     *[getattr(out, name)[0]
                       for name in KernelOut._fields[5:]])


def make_place_batch(
    mesh: Mesh, k_steps: int, features: KernelFeatures = FULL_FEATURES,
    plain: bool = False,
):
    """The batched, sharded placement step for ``mesh``.

    Returns ``fn(kin_batched) -> KernelOut`` (batched, on the mesh's
    first device): B evals split over the ``evals`` axis (B must divide
    by it), each eval's node planes over ``nodes``. Each eval is a
    placement problem of its own (its own planes, its own carry), never
    one member of a joint wave with another. Each eval runs as a
    one-member wave of ``k_steps`` steps under the features its planes
    need (``eval_features``): on an evals row of one node shard through
    ``fused_wave_place`` (B1) when they fit the fused envelope, else
    through ``joint_wave_place``; on a row of two or more through
    ``sharded_wave_place`` when they fit the envelope, else through
    ``joint_sharded_wave_place``. On CUDA shards the wrappers launch the
    hand kernels, on CPU shards they run their plain versions. Every
    row's kernel calls are enqueued on its cards before any eval that
    reads the host; a sharded call's error word is read once at the end,
    and a set one raises. ``plain`` runs every eval through the torch-op
    body under ``features``: the plain version the route is held
    against.
    """
    shardings = batched_in_shardings(mesh)
    e_par = mesh.axis_size(_B)
    rows = mesh.node_rows()

    def fn(kin: KernelIn) -> KernelOut:
        b = int(tuple(kin.n_steps.shape)[0])
        if b % e_par:
            raise ValueError(f"a batch of {b} evals does not split over "
                             f"{e_par} {_B!r} shards")
        b_loc = b // e_par
        feats = [features] * b if plain else eval_features(kin, features)
        placed, _ = place_args(kin, shardings)
        row_shards = [_shards_of(placed, row) for row in rows]
        if plain:
            outs = [[_plain_eval(_one_eval(shards, e), k_steps,
                                 feats[r * b_loc + e])
                     for e in range(b_loc)]
                    for r, shards in enumerate(row_shards)]
            place_batch_stats.note(plain=b)
            errs = []
        else:
            outs, errs = _launch_rows(row_shards, feats, b_loc, k_steps)
        root = outs[0][0].chosen.device
        _raise_on_errors(errs, k_steps, root)
        return KernelOut(*[torch.stack([getattr(o, name).to(root)
                                        for row in outs for o in row])
                           for name in KernelOut._fields])

    return fn


def _launch_rows(row_shards: list, feats: list, b_loc: int,
                 k_steps: int) -> tuple:
    """Send every eval to its row's kernel, row after row, reading nothing
    back. Returns the KernelOuts by row and the sharded calls' packed
    buffers, whose error words are still to be read."""
    outs: list = [[None] * b_loc for _ in row_shards]
    errs = []
    maps: dict = {}
    for r, shards in enumerate(row_shards):
        for e in range(b_loc):
            f = feats[r * b_loc + e]
            one = _one_eval(shards, e)
            # the fused kernels where the eval is in their envelope and
            # their cluster holds its rows, else the joint hand kernels
            n_loc = int(one[0].cap_cpu.shape[-1])
            fused = fused_wave_supported(f) and (
                fused_wave_fits(one[0].cap_cpu.device, n_loc, 1,
                                f.with_shuffle) if len(one) == 1
                else n_loc >= TOPK and sharded_wave_fits(
                    [s.cap_cpu.device for s in one], n_loc, 1,
                    f.with_shuffle))
            if len(one) == 1:
                dev = one[0].cap_cpu.device
                sm_sl = maps.get(dev)
                if sm_sl is None:
                    # the step maps on the card once: a copy from the
                    # host inside the loop would wait on the launches
                    sm_sl = maps[dev] = (
                        torch.zeros(k_steps, dtype=torch.int32, device=dev),
                        torch.arange(k_steps, dtype=torch.int32,
                                     device=dev))
                place = fused_wave_place if fused else joint_wave_place
                got = place(one[0], *sm_sl, k_steps, f)
                place_batch_stats.note(fused=int(fused), joint=int(not fused))
                if not fused and got.packed.device.type == "cuda":
                    errs.append(got.packed)
            else:
                place = (sharded_wave_place if fused
                         else joint_sharded_wave_place)
                got = place(one, np.zeros(k_steps, np.int32),
                            np.arange(k_steps, dtype=np.int32), k_steps, f)
                place_batch_stats.note(sharded=1)
                if got.packed.device.type == "cuda":
                    errs.append(got.packed)
            outs[r][e] = wave_kernel_out(got, k_steps)
    return outs, errs


def _raise_on_errors(errs: list, k_steps: int, root: torch.device) -> None:
    """Read every sharded or joint call's error word in one readback;
    raise on the first set one (``raise_on_wave_error``)."""
    if not errs:
        return
    at = fused_pack_len(k_steps, 1)
    words = torch.stack([p[at].to(root) for p in errs]).cpu().numpy()
    for p, w in zip(errs, words):
        if w != 0:
            raise_on_wave_error(p.cpu().numpy(), k_steps, 1)
