"""The placement wave: host-side plane assembly and the torch composite.

Counterpart of ``nomad_tpu/ops/kernel.py``. Two halves:

- Host half (numpy): ``KernelIn`` assembly (``build_kernel_in``), the
  frozen neutral planes that wave members share BY IDENTITY, feature
  flags, and the packed fused-wave readback layout. ``KernelIn`` leaves
  stay numpy until the wave launcher uploads them, so identical planes
  are recognisable by ``is`` and ship once per wave.
- Device half (torch): ``place_taskgroups_joint``, the composite wave
  over the full feature set (spreads, devices, cores and network
  included), and ``place_taskgroup``, one eval. They are the plain
  versions of the CUDA wave kernels (ops/cuda_kernel.py: B1 inside the
  fused envelope, the joint kernel under any union) and of the single
  eval's full-width route through the joint kernel. JAX's ``lax.scan``
  over steps is a Python loop here and ``vmap`` over members is a
  written-out member axis.

Semantics (Go reference -> tensor formulation) are those of the JAX
module: resource fit as mask algebra, ScoreFitBinPack/ScoreFitSpread
normalised by 18, job anti-affinity, rescheduling penalty, node affinity
and spread boosts averaged over *appended* planes, global argmax
selection with first-index ties (lowest permutation rank under shuffle).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.tensors.schema import (
    MAX_DEV_REQS,
    MAX_SPREADS,
    SPREAD_BUCKETS,
    AskLimitError,
    ClusterTensors,
    EvalTensors,
)

NEG_INF = -1.0e30
TOPK = 8          # top-K score metadata returned per placement (AllocMetric)
MAX_PENALTY_NODES = 4   # previous nodes penalized per rescheduled placement
_STEP_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def pad_steps(k: int) -> int:
    for b in _STEP_BUCKETS:
        if k <= b:
            return b
    return ((k + 4095) // 4096) * 4096


#: live-path floor for the placement-axis bucket (follow-up evals placing
#: 1-2 leftovers share the primary evals' step bucket)
MIN_STEP_BUCKET = 8


def pad_steps_live(k: int) -> int:
    return pad_steps(max(k, MIN_STEP_BUCKET))


class NeutralPlanes(NamedTuple):
    """Read-only neutral planes shared BY IDENTITY across evaluations.

    One frozen singleton per padded node size serves every eval whose
    ask leaves these planes neutral; the wave coalescer recognises the
    shared object and ships it once. The arrays are non-writeable, so a
    writer that forgets copy-on-write raises instead of corrupting a
    neighbour eval.
    """

    zeros_f32: np.ndarray       # [N]
    zeros_i32: np.ndarray       # [N]
    zeros_bool: np.ndarray      # [N]
    zeros_dev: np.ndarray       # [N, MAX_DEV_REQS] f32
    neg1_spread_bucket: np.ndarray   # [S, N] i32
    zeros_spread_counts: np.ndarray  # [S, SPREAD_BUCKETS] f32
    neg1_spread_desired: np.ndarray  # [S, SPREAD_BUCKETS] f32
    zeros_spread_flags: np.ndarray   # [S] bool
    zeros_spread_weight: np.ndarray  # [S] f32
    arange_i32: np.ndarray      # [N] identity node_perm


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


_NEUTRAL_CACHE: dict = {}


def neutral_planes(n: int) -> NeutralPlanes:
    got = _NEUTRAL_CACHE.get(n)
    if got is None:
        got = NeutralPlanes(
            zeros_f32=_frozen(np.zeros(n, np.float32)),
            zeros_i32=_frozen(np.zeros(n, np.int32)),
            zeros_bool=_frozen(np.zeros(n, bool)),
            zeros_dev=_frozen(np.zeros((n, MAX_DEV_REQS), np.float32)),
            neg1_spread_bucket=_frozen(
                np.full((MAX_SPREADS, n), -1, np.int32)),
            zeros_spread_counts=_frozen(
                np.zeros((MAX_SPREADS, SPREAD_BUCKETS), np.float32)),
            neg1_spread_desired=_frozen(
                np.full((MAX_SPREADS, SPREAD_BUCKETS), -1.0, np.float32)),
            zeros_spread_flags=_frozen(np.zeros(MAX_SPREADS, bool)),
            zeros_spread_weight=_frozen(np.zeros(MAX_SPREADS, np.float32)),
            arange_i32=_frozen(np.arange(n, dtype=np.int32)),
        )
        # threads racing to the first call all keep the first stored:
        # members that hold one singleton by identity share it in a wave
        got = _NEUTRAL_CACHE.setdefault(n, got)
    return got


_NEUTRAL_WORDS_CACHE: dict = {}


def neutral_port_words(n: int, w: int) -> np.ndarray:
    """Frozen all-zero [N, W] u32 port-conflict words."""
    got = _NEUTRAL_WORDS_CACHE.get((n, w))
    if got is None:
        got = _frozen(np.zeros((n, w), np.uint32))
        got = _NEUTRAL_WORDS_CACHE.setdefault((n, w), got)
    return got


_NEUTRAL_STEP_CACHE: dict = {}


def neutral_step_planes(k_pad: int):
    """(step_penalty[k,P]=-1, step_preferred[k]=-1) singletons."""
    got = _NEUTRAL_STEP_CACHE.get(k_pad)
    if got is None:
        got = (
            _frozen(np.full((k_pad, MAX_PENALTY_NODES), -1, np.int32)),
            _frozen(np.full(k_pad, -1, np.int32)),
        )
        got = _NEUTRAL_STEP_CACHE.setdefault(k_pad, got)
    return got


class KernelFeatures(NamedTuple):
    """Static specialization flags. Disabling a feature removes its
    planes from the computation; the host disables only features whose
    inputs are neutral, so semantics are unchanged."""

    n_spreads: int = MAX_SPREADS
    with_topk: bool = True        # per-step top-K score metadata (AllocMetric)
    with_devices: bool = True
    with_ports: bool = True
    with_cores: bool = True
    with_network: bool = True     # bandwidth accounting
    with_distinct: bool = True    # distinct_hosts masks in the scan
    with_step_penalties: bool = True  # per-placement penalty node ids
    with_preferred: bool = True   # per-placement preferred-node pins
    # per-eval node-order decorrelation (shuffleNodes util.go:464): ties
    # resolve in the eval's seeded permutation order
    with_shuffle: bool = False


FULL_FEATURES = KernelFeatures()


def canonical_features(f: KernelFeatures) -> KernelFeatures:
    """Round a feature set up onto a coarser lattice: ``n_spreads`` is 0
    or MAX_SPREADS, step penalties and preferred pins travel together.
    Enabling a feature for an ask with neutral planes never changes
    placements."""
    aux = f.with_step_penalties or f.with_preferred
    return f._replace(
        n_spreads=0 if f.n_spreads == 0 else MAX_SPREADS,
        with_step_penalties=aux,
        with_preferred=aux,
    )


#: the lean cpu/mem/disk binpack envelope
LEAN_FEATURES = KernelFeatures(
    n_spreads=0, with_topk=False, with_devices=False, with_ports=False,
    with_cores=False, with_network=False, with_distinct=False,
    with_step_penalties=False, with_preferred=False,
)


class KernelIn(NamedTuple):
    """Planes for one (eval, task group): numpy on the host, torch
    tensors once a wave uploads them. Stacked waves add a leading
    member axis to any leaf (see KIN_UNBATCHED_RANKS)."""

    # cluster planes (f32/i32/bool over padded node axis)
    cap_cpu: object
    cap_mem: object
    cap_disk: object
    free_cores: object
    shares_per_core: object
    free_dyn: object
    # eval planes
    base_mask: object
    used_cpu: object
    used_mem: object
    used_disk: object
    used_cores: object
    used_mbits: object
    avail_mbits: object
    port_conflict: object       # bool[N]: ask reserved port already used
    dev_free: object            # f32[N, MAX_DEV_REQS]
    dev_aff_score: object       # f32[N]
    has_dev_affinity: object    # bool scalar
    job_tg_count: object        # i32[N]
    penalty: object             # bool[N]
    aff_score: object           # f32[N]
    node_perm: object           # i32[N]: seeded tie-break permutation
    # per-step planes (placement axis K)
    step_penalty: object        # i32[K, MAX_PENALTY_NODES], -1 pad
    step_preferred: object      # i32[K], -1 none
    # distinct_hosts enforcement inside the scan (feasible.go:526)
    job_any_count: object       # i32[N] job allocs on node (any tg)
    distinct_hosts_job: object  # bool scalar
    distinct_hosts_tg: object   # bool scalar
    # spreads, stacked [S, ...]
    spread_active: object       # bool[S]
    spread_even: object         # bool[S]
    spread_weight: object       # f32[S]
    spread_bucket: object       # i32[S, N]
    spread_counts: object       # f32[S, B]
    spread_desired: object      # f32[S, B]
    # ask scalars
    ask_cpu: object
    ask_mem: object
    ask_disk: object
    ask_cores: object
    ask_dyn_ports: object
    ask_has_reserved_ports: object  # bool scalar
    ask_dev: object             # f32[MAX_DEV_REQS]
    ask_mbits: object
    desired_count: object       # i32 scalar (anti-affinity denominator)
    algorithm_spread: object    # bool scalar: ScoreFitSpread mode
    n_steps: object             # i32 scalar: real placements wanted


#: rank of each KernelIn leaf in the single-problem (unbatched) layout;
#: a leaf whose rank is this +1 carries a leading member axis
KIN_UNBATCHED_RANKS = KernelIn(
    cap_cpu=1, cap_mem=1, cap_disk=1, free_cores=1, shares_per_core=1,
    free_dyn=1, base_mask=1, used_cpu=1, used_mem=1, used_disk=1,
    used_cores=1, used_mbits=1, avail_mbits=1, port_conflict=1,
    dev_free=2, dev_aff_score=1, has_dev_affinity=0, job_tg_count=1,
    penalty=1, aff_score=1, node_perm=1, step_penalty=2,
    step_preferred=1, job_any_count=1, distinct_hosts_job=0,
    distinct_hosts_tg=0, spread_active=1, spread_even=1, spread_weight=1,
    spread_bucket=2, spread_counts=2, spread_desired=2, ask_cpu=0,
    ask_mem=0, ask_disk=0, ask_cores=0, ask_dyn_ports=0,
    ask_has_reserved_ports=0, ask_dev=1, ask_mbits=0, desired_count=0,
    algorithm_spread=0, n_steps=0,
)


class KernelOut(NamedTuple):
    chosen: object          # i32[K]: node row per placement (-1 none)
    scores: object          # f32[K]: final normalized score
    found: object           # bool[K]
    topk_idx: object        # i32[K, TOPK]
    topk_scores: object     # f32[K, TOPK]
    # metrics from the first step's masks (AllocMetric inputs)
    nodes_evaluated: object     # i32: base-eligible nodes
    nodes_feasible: object      # i32: passed all resource checks
    exhausted_cpu: object
    exhausted_mem: object
    exhausted_disk: object
    exhausted_ports: object
    exhausted_devices: object
    exhausted_cores: object


class JointOut(NamedTuple):
    """Outputs of a joint wave: per-step placements + per-member metrics."""

    chosen: torch.Tensor          # i32[T]
    scores: torch.Tensor          # f32[T]
    found: torch.Tensor           # bool[T]
    topk_idx: torch.Tensor        # i32[T, TOPK]
    topk_scores: torch.Tensor     # f32[T, TOPK]
    nodes_evaluated: torch.Tensor     # i32[B]
    nodes_feasible: torch.Tensor      # i32[B]
    exhausted_cpu: torch.Tensor       # i32[B]
    exhausted_mem: torch.Tensor
    exhausted_disk: torch.Tensor
    exhausted_ports: torch.Tensor
    exhausted_devices: torch.Tensor
    exhausted_cores: torch.Tensor
    # final shared-capacity carry: total resources the wave consumed
    a_cpu: torch.Tensor               # f32[N]
    a_mem: torch.Tensor               # f32[N]
    a_disk: torch.Tensor              # f32[N]


# ---------------------------------------------------------------------------
# Device half: the torch composite.
# ---------------------------------------------------------------------------

def _feasible(kin: KernelIn, st, f: KernelFeatures) -> tuple:
    """Resource-fit mask planes for the current carry state."""
    true_plane = torch.ones_like(kin.base_mask)
    free_cpu = kin.cap_cpu - st["used_cpu"]
    free_mem = kin.cap_mem - st["used_mem"]
    free_disk = kin.cap_disk - st["used_disk"]
    # optional dimensions apply only when the ask requests them
    # (rank.go:270-492), which also makes the lean variants exact
    if f.with_cores:
        ask_cpu_total = (
            kin.ask_cpu + kin.ask_cores.to(torch.float32) * kin.shares_per_core)
        fit_cores = (kin.ask_cores <= 0) | (
            (kin.free_cores - st["used_cores"]) >= kin.ask_cores)
    else:
        ask_cpu_total = kin.ask_cpu
        fit_cores = true_plane
    fit_cpu = free_cpu >= ask_cpu_total
    fit_mem = free_mem >= kin.ask_mem
    fit_disk = free_disk >= kin.ask_disk
    if f.with_ports:
        fit_dyn = (kin.ask_dyn_ports <= 0) | (
            st["free_dyn"] >= kin.ask_dyn_ports)
        fit_ports = ~(st["port_conflict"] & kin.ask_has_reserved_ports) & fit_dyn
    else:
        fit_ports = true_plane
    if f.with_devices:
        # [.., 1, D] against [.., N, D]: one eval or a leading eval axis
        ask = kin.ask_dev.unsqueeze(-2)
        fit_dev = torch.all((ask <= 0) | (st["dev_free"] >= ask), dim=-1)
    else:
        fit_dev = true_plane
    if f.with_network:
        fit_bw = (kin.ask_mbits <= 0) | (
            (st["used_mbits"] + kin.ask_mbits) <= kin.avail_mbits)
    else:
        fit_bw = true_plane
    if f.with_distinct:
        distinct_ok = ~(
            (kin.distinct_hosts_job & (st["job_any_count"] > 0))
            | (kin.distinct_hosts_tg & (st["job_tg_count"] > 0)))
    else:
        distinct_ok = true_plane
    feasible = (
        kin.base_mask
        & fit_cpu & fit_mem & fit_disk & fit_cores
        & fit_ports & fit_dev & fit_bw & distinct_ok)
    return feasible, ask_cpu_total, dict(
        fit_cpu=fit_cpu, fit_mem=fit_mem, fit_disk=fit_disk,
        fit_cores=fit_cores, fit_ports=fit_ports, fit_dev=fit_dev,
    )


def _score(kin: KernelIn, st, ask_cpu_total, penalty,
           f: KernelFeatures, spread_onehot=None) -> torch.Tensor:
    """Score planes + appended-mask normalization (rank.go semantics)."""
    util_cpu = st["used_cpu"] + ask_cpu_total
    util_mem = st["used_mem"] + kin.ask_mem

    # computeFreePercentage (funcs.go:235) with zero-capacity guard
    fc = torch.where(kin.cap_cpu > 0, 1.0 - util_cpu / kin.cap_cpu, 0.0)
    fm = torch.where(kin.cap_mem > 0, 1.0 - util_mem / kin.cap_mem, 0.0)
    total = torch.pow(10.0, fc) + torch.pow(10.0, fm)
    binpack = torch.clamp(20.0 - total, 0.0, 18.0)        # funcs.go:259
    spreadfit = torch.clamp(total - 2.0, 0.0, 18.0)       # funcs.go:286
    fit = torch.where(kin.algorithm_spread, spreadfit, binpack) / 18.0

    # plane sum with per-plane appended masks (rank.go:764)
    score_sum = fit
    nplanes = torch.ones_like(fit)

    if f.with_devices:                     # rank.go:549-554
        dev_on = kin.has_dev_affinity
        score_sum = score_sum + torch.where(dev_on, kin.dev_aff_score, 0.0)
        nplanes = nplanes + dev_on.to(torch.float32)

    # job anti-affinity (rank.go:588-607)
    collisions = st["job_tg_count"].to(torch.float32)
    denom = torch.clamp_min(kin.desired_count.to(torch.float32), 1.0)
    anti = -(collisions + 1.0) / denom
    anti_on = collisions > 0
    score_sum = score_sum + torch.where(anti_on, anti, 0.0)
    nplanes = nplanes + anti_on.to(torch.float32)

    # rescheduling penalty (rank.go:655-663)
    score_sum = score_sum + torch.where(penalty, -1.0, 0.0)
    nplanes = nplanes + penalty.to(torch.float32)

    # node affinity (rank.go:730-745): appended where nonzero
    aff_on = kin.aff_score != 0.0
    score_sum = score_sum + torch.where(aff_on, kin.aff_score, 0.0)
    nplanes = nplanes + aff_on.to(torch.float32)

    if f.n_spreads > 0:                    # spread.go:116-245
        spread_total = _spread_score(kin, st, spread_onehot, f.n_spreads)
        spread_on = spread_total != 0.0
        score_sum = score_sum + torch.where(spread_on, spread_total, 0.0)
        nplanes = nplanes + spread_on.to(torch.float32)

    return score_sum / nplanes


def _spread_onehot(spread_bucket: torch.Tensor, n_spreads: int):
    """Node -> bucket one-hot [S, N, SPREAD_BUCKETS] (zero rows for
    bucket-less nodes)."""
    sb = spread_bucket[:n_spreads].long()
    oh = torch.nn.functional.one_hot(
        torch.clamp(sb, 0, SPREAD_BUCKETS - 1), SPREAD_BUCKETS)
    return oh.to(torch.float32) * (sb >= 0)[..., None].to(torch.float32)


def _exact_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # The one-hot projections must run in full f32: a TF32 product keeps
    # ~10 mantissa bits and would break score parity on close boosts.
    # This sets the process-wide flag on purpose (it is also torch's
    # default); the JAX package pins the same product to HIGHEST.
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a, b)


def _spread_score(kin: KernelIn, st, spread_onehot,
                  n_spreads: int) -> torch.Tensor:
    """Sum of per-stanza spread boosts for every node, computed over the
    bucket axis and projected to nodes with one one-hot product."""
    n = kin.cap_cpu.shape[0]
    total = torch.zeros(n, dtype=torch.float32, device=kin.cap_cpu.device)
    counts = st["spread_counts"]  # [S, B]
    inf = torch.tensor(float("inf"), device=counts.device)
    for s in range(n_spreads):
        counts_b = counts[s]
        # desired-count path (spread.go:158-183): usedCount+1
        des_b = kin.spread_desired[s]
        desired_b = torch.where(
            des_b > 0.0,
            ((des_b - (counts_b + 1.0)) / des_b) * kin.spread_weight[s],
            -1.0)
        # even-spread path (spread.go evenSpreadScoreBoost :193)
        present = counts_b > 0.0
        any_alloc = torch.any(present)
        minc = torch.min(torch.where(present, counts_b, inf))
        maxc = torch.max(torch.where(present, counts_b, -inf))
        delta_b = torch.where(
            minc > 0, (minc - counts_b) / torch.clamp_min(minc, 1.0), -1.0)
        even_b = torch.where(
            counts_b != minc,
            delta_b,
            torch.where(
                minc == maxc,
                -1.0,
                torch.where(minc == 0, 1.0,
                            (maxc - minc) / torch.clamp_min(minc, 1.0))))
        even_b = torch.where(any_alloc, even_b, 0.0)
        stanza_b = torch.where(kin.spread_even[s], even_b, desired_b)
        node_boost = _exact_f32_matmul(spread_onehot[s], stanza_b)   # f32[N]
        missing = kin.spread_bucket[s] < 0
        stanza = torch.where(missing, -1.0, node_boost)
        total = total + torch.where(kin.spread_active[s], stanza, 0.0)
    return total


def _bump_spread(kin: KernelIn, counts, one, spread_onehot, n_spreads: int):
    """counts[s, bucket_of_chosen] += 1 for active stanzas (``one`` is
    the chosen node's one-hot plane, zeros when nothing placed)."""
    bump = torch.zeros_like(counts)
    for s in range(n_spreads):
        row = _exact_f32_matmul(one, spread_onehot[s])       # f32[B]
        bump[s] = torch.where(kin.spread_active[s], row, 0.0)
    return counts + bump


def _member_view(kin: KernelIn, m: int) -> KernelIn:
    """The member's single-problem KernelIn: stacked leaves index the
    member axis, unbatched (shared) leaves are used as they are."""
    return KernelIn(*[
        x[m] if x.dim() == r + 1 else x
        for x, r in zip(kin, KIN_UNBATCHED_RANKS)])


def _as_host_ints(x) -> list:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    return np.asarray(x).tolist()


def place_taskgroups_joint(
    kin: KernelIn,
    step_member,
    step_local,
    t_steps: int,
    features: KernelFeatures = FULL_FEATURES,
) -> JointOut:
    """Place a WAVE of task-group asks with a shared capacity carry.

    ``kin`` is a stacked KernelIn of torch tensors on one device (leading
    member axis B on stacked leaves; shared leaves unbatched). Step t
    belongs to member ``step_member[t]`` (-1 = padding) at member-local
    placement ``step_local[t]``. Every step's feasibility and score see
    the capacity consumed by ALL previous steps, other members' included
    (cpu/mem/disk, cores, bandwidth, dynamic ports, devices); job-local
    planes (anti-affinity and distinct-hosts counts, spread counts,
    the member's own reserved-port conflicts) stay per member. The step
    maps are read on the host once; everything else stays on ``kin``'s
    device.
    """
    n = kin.cap_cpu.shape[-1]
    b = kin.n_steps.shape[0]       # n_steps is always member-stacked
    f = features
    dev = kin.cap_cpu.device
    members = _as_host_ints(step_member)[:t_steps]
    locals_ = _as_host_ints(step_local)[:t_steps]

    def _bat(x, rank):
        # carried leaves need a member axis even when shipped shared;
        # the copy is ours, so the in-place updates below never touch
        # the caller's tensors
        if x.dim() == rank + 1:
            return x.clone()
        return x.expand((b,) + tuple(x.shape)).clone()

    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
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
        st["a_dev"] = torch.zeros((n, kin.dev_free.shape[-1]),
                                  dtype=torch.float32, device=dev)
    if f.with_distinct:
        st["job_any_count"] = _bat(kin.job_any_count, 1)
    if f.n_spreads > 0:
        st["spread_counts"] = _bat(kin.spread_counts, 2)

    iota = torch.arange(n, dtype=torch.int64, device=dev)
    views: dict = {}
    onehots: dict = {}
    outs = []
    for member, j in zip(members, locals_):
        m = min(max(member, 0), b - 1)
        kin_m = views.get(m)
        if kin_m is None:
            kin_m = views[m] = _member_view(kin, m)
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

        jj = min(max(j, 0), kin_m.step_preferred.shape[0] - 1)
        feasible, ask_cpu_total, _ = _feasible(kin_m, st_m, f)
        penalty = kin_m.penalty
        if f.with_step_penalties:
            pen_ids = kin_m.step_penalty[jj].to(torch.int64)
            penalty = penalty | torch.any(
                iota[:, None] == pen_ids[None, :], dim=1)
        spread_onehot = None
        if f.n_spreads > 0:
            spread_onehot = onehots.get(m)
            if spread_onehot is None:
                spread_onehot = onehots[m] = _spread_onehot(
                    kin_m.spread_bucket, f.n_spreads)
        final = _score(kin_m, st_m, ask_cpu_total, penalty, f, spread_onehot)
        active = (kin_m.n_steps > j) & (member >= 0)
        masked = torch.where(feasible & active, final, NEG_INF)
        if f.with_shuffle:
            perm = kin_m.node_perm.to(torch.int64)
            best = perm[torch.argmax(masked[perm])]
        else:
            best = torch.argmax(masked)
        if f.with_preferred:
            pref = kin_m.step_preferred[jj].to(torch.int64)
            pc = torch.clamp(pref, 0, n - 1)
            pref_ok = (pref >= 0) & feasible[pc] & active
            idx = torch.where(pref_ok, pc, best)
        else:
            idx = best
        found = masked[idx] > NEG_INF / 2

        if f.with_topk:
            # stable descending sort == lax.top_k's lowest-index ties
            topv, topi = torch.sort(masked, descending=True, stable=True)
            topv, topi = topv[:TOPK], topi[:TOPK]
        else:
            topv = torch.full((TOPK,), NEG_INF, dtype=torch.float32,
                              device=dev)
            topi = torch.zeros(TOPK, dtype=torch.int64, device=dev)

        upd = found & active
        onei = (iota == idx).to(torch.int32) * upd.to(torch.int32)
        one = (iota == idx).to(torch.float32) * upd.to(torch.float32)
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
            st["port_conflict"][m] |= (one > 0) & kin_m.ask_has_reserved_ports
        if f.with_devices:
            st["a_dev"] = st["a_dev"] + one[:, None] * kin_m.ask_dev[None, :]
        if f.with_distinct:
            st["job_any_count"][m] += onei
        if f.n_spreads > 0:
            st["spread_counts"][m] = _bump_spread(
                kin_m, st["spread_counts"][m], one, spread_onehot,
                f.n_spreads)
        outs.append((
            torch.where(found, idx, -1).to(torch.int32),
            torch.where(found, masked[idx], 0.0),
            found & active,
            topi.to(torch.int32),
            topv,
        ))

    chosen, scores, found, topk_idx, topk_scores = (
        torch.stack([o[i] for o in outs]) for i in range(5))

    # per-member first-step metrics (AllocMetric inputs), from the
    # pre-wave state
    metrics = []
    for m in range(b):
        kin_m = _member_view(kin, m)
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
    met = torch.stack(metrics, dim=1)            # i32[8, B]

    return JointOut(
        chosen, scores, found, topk_idx, topk_scores,
        *met.unbind(0),
        a_cpu=st["a_cpu"], a_mem=st["a_mem"], a_disk=st["a_disk"],
    )


# ---------------------------------------------------------------------------
# Per-eval placement: place_taskgroup and place_taskgroup_topk.
#
# One eval when ``n_steps`` is a scalar (the whole feature set), or a batch
# of independent evals against one snapshot when ``n_steps`` is i32[B]:
# JAX's ``vmap`` written out as a leading eval axis. Per-eval leaves
# (asks, ``n_steps``, used planes) carry that axis; shared planes are [N]
# and broadcast.
# ---------------------------------------------------------------------------

#: node-axis KernelIn leaves (the node axis first when unbatched)
_NODE_PLANES = (
    "cap_cpu", "cap_mem", "cap_disk", "free_cores", "shares_per_core",
    "free_dyn", "base_mask", "used_cpu", "used_mem", "used_disk",
    "used_cores", "used_mbits", "avail_mbits", "port_conflict", "dev_free",
    "dev_aff_score", "job_tg_count", "penalty", "aff_score",
    "job_any_count",
)


def batched_supported(f: KernelFeatures) -> bool:
    """Whether the eval-batched form takes ``f``: the lean envelope plus
    devices and top-k metadata. Spreads, ports, cores, network,
    distinct_hosts, step penalties, preferred pins and shuffle read
    per-eval step planes or counts and run one eval at a time."""
    return f.n_spreads == 0 and not (
        f.with_ports or f.with_cores or f.with_network or f.with_distinct
        or f.with_step_penalties or f.with_preferred or f.with_shuffle)


def _eval_axis(kin: KernelIn, f: KernelFeatures):
    """``(kin, batch shape)``: ``()`` for one eval; for ``n_steps`` i32[B]
    the per-eval scalar leaves become [B, 1] so that they broadcast
    against [N] planes. Raises for a feature set the batched form does
    not take."""
    if kin.n_steps.dim() == 0:
        return kin, ()
    if not batched_supported(f):
        raise ValueError(
            f"features {f} need one eval at a time: the eval-batched form "
            "takes the lean envelope plus devices and top-k only")
    b = kin.n_steps.shape[0]
    return KernelIn(*[
        x.reshape(b, 1) if r == 0 and x.dim() == 1 else x
        for x, r in zip(kin, KIN_UNBATCHED_RANKS)]), (b,)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last axis: ``x`` is [M] (shared) or
    [B, M] with ``idx`` [B, ..]."""
    if x.dim() == 1:
        return x[idx]
    return torch.gather(x, -1, idx.reshape(x.shape[0], -1)).reshape(
        idx.shape)


def _gather_nodes(x: torch.Tensor, idx: torch.Tensor, rank: int):
    """Node rows ``idx`` of a node-axis leaf of unbatched ``rank``
    (shared, or with a leading eval axis)."""
    if x.dim() == rank:
        return x[idx]
    ix = idx.reshape(idx.shape + (1,) * (rank - 1)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, ix)


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """Index of the maximum along the last axis, the lowest among ties
    (``jnp.argmax``'s rule, stated rather than assumed)."""
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    hit = x == x.amax(dim=-1, keepdim=True)
    return torch.where(hit, iota, n).amin(dim=-1)


def topk_ordered(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis,
    ordered by value descending then index ascending: ``lax.top_k``'s
    order, and that of ``approx_max_k`` on the CPU, where it is exact.
    ``torch.topk`` leaves the order of equal values unspecified, and the
    candidate lane order decides which of two equal scores a scan takes,
    so the boundary tie goes to the lowest indices explicitly."""
    n = x.shape[-1]
    thr = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > thr
    at = x == thr
    need = k - above.sum(dim=-1, keepdim=True)
    pick = above | (at & (torch.cumsum(at.to(torch.int32), dim=-1) <= need))
    iota = torch.arange(n, device=x.device)
    # the k picked indices, ascending: the largest keys n - index
    idx = n - torch.topk(torch.where(pick, n - iota, -1), k, dim=-1).values
    vals = torch.gather(x, -1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)


def _carry_init(kin: KernelIn, f: KernelFeatures) -> dict:
    st = dict(used_cpu=kin.used_cpu, used_mem=kin.used_mem,
              used_disk=kin.used_disk, job_tg_count=kin.job_tg_count)
    if f.with_cores:
        st["used_cores"] = kin.used_cores
    if f.with_network:
        st["used_mbits"] = kin.used_mbits
    if f.with_ports:
        st["free_dyn"] = kin.free_dyn
        st["port_conflict"] = kin.port_conflict
    if f.with_devices:
        st["dev_free"] = kin.dev_free
    if f.with_distinct:
        st["job_any_count"] = kin.job_any_count
    if f.n_spreads > 0:
        st["spread_counts"] = kin.spread_counts
    return st


def _deduct(kin: KernelIn, st: dict, one, onei, ask_cpu_total,
            f: KernelFeatures, spread_onehot) -> dict:
    """The carry after the chosen node's rows (``one``/``onei``, zero
    when nothing placed) take the ask. New tensors: nothing is written
    in place."""
    st2 = dict(
        used_cpu=st["used_cpu"] + one * ask_cpu_total,
        used_mem=st["used_mem"] + one * kin.ask_mem,
        used_disk=st["used_disk"] + one * kin.ask_disk,
        job_tg_count=st["job_tg_count"] + onei,
    )
    if f.with_cores:
        st2["used_cores"] = st["used_cores"] + onei * kin.ask_cores
    if f.with_network:
        st2["used_mbits"] = st["used_mbits"] + onei * kin.ask_mbits
    if f.with_ports:
        st2["free_dyn"] = st["free_dyn"] - onei * kin.ask_dyn_ports
        # the same reserved ports collide on the chosen node next step
        st2["port_conflict"] = st["port_conflict"] | (
            (one > 0) & kin.ask_has_reserved_ports)
    if f.with_devices:
        st2["dev_free"] = st["dev_free"] - (
            one.unsqueeze(-1) * kin.ask_dev.unsqueeze(-2))
    if f.with_distinct:
        st2["job_any_count"] = st["job_any_count"] + onei
    if f.n_spreads > 0:
        st2["spread_counts"] = _bump_spread(
            kin, st["spread_counts"], one, spread_onehot, f.n_spreads)
    return st2


def _first_step(kin: KernelIn, init: dict, f: KernelFeatures, bshape):
    """Pre-placement feasibility and the AllocMetric counts of ``init``."""
    feas0, ask_cpu_total0, dims0 = _feasible(kin, init, f)
    n = kin.cap_cpu.shape[-1]
    base = kin.base_mask

    def count(plane):
        return torch.broadcast_to(plane, bshape + (n,)).sum(
            dim=-1).to(torch.int32)

    metrics = dict(nodes_evaluated=count(base), nodes_feasible=count(feas0))
    for name, dim in (("cpu", "fit_cpu"), ("mem", "fit_mem"),
                      ("disk", "fit_disk"), ("ports", "fit_ports"),
                      ("devices", "fit_dev"), ("cores", "fit_cores")):
        metrics[f"exhausted_{name}"] = count(base & ~dims0[dim])
    return feas0, ask_cpu_total0, metrics


def _place_scan(kin: KernelIn, k_steps: int, f: KernelFeatures, bshape,
                node_ids: torch.Tensor, spread_onehot=None, k_cand: int = 0,
                rest_max: Optional[torch.Tensor] = None):
    """The K placement steps over ``kin``'s node axis, whose rows are the
    nodes ``node_ids`` (all nodes, or a candidate set): mask, score,
    first argmax, deduct every row of the chosen node. With ``rest_max``
    (the candidate form) preferred pins sit at rows ``k_cand + i`` and
    ``ok`` tracks the bound: the best candidate must still reach what
    the rest of the cluster offers. Returns (chosen, scores, found,
    topk_idx, topk_scores, ok)."""
    n = kin.cap_cpu.shape[-1]
    dev = kin.cap_cpu.device
    st = _carry_init(kin, f)
    ok = torch.ones(bshape, dtype=torch.bool, device=dev)
    outs = []
    for i in range(k_steps):
        feasible, ask_cpu_total, _ = _feasible(kin, st, f)
        penalty = kin.penalty
        if f.with_step_penalties:
            pen_ids = kin.step_penalty[i].to(node_ids.dtype)
            penalty = penalty | torch.any(
                node_ids[..., None] == pen_ids, dim=-1)
        final = _score(kin, st, ask_cpu_total, penalty, f, spread_onehot)
        active = (kin.n_steps > i).reshape(bshape)
        masked = torch.where(feasible & active[..., None], final, NEG_INF)
        if f.with_shuffle:
            # equal scores resolve in permutation order (util.go:464)
            perm = kin.node_perm.to(torch.int64)
            best = perm[_argmax_first(masked[perm])]
        else:
            best = _argmax_first(masked)
        pref_ok = None
        if f.with_preferred:
            # preferred-node pin: taken when feasible (stack.go:120-139)
            pref = kin.step_preferred[i].to(torch.int64)
            row = (torch.clamp(pref, 0, n - 1) if rest_max is None
                   else torch.tensor(k_cand + i, device=dev))
            pref_ok = (pref >= 0) & feasible[row] & active
            idx = torch.where(pref_ok, row, best)
        else:
            idx = best
        val = _rows(masked, idx)
        found = val > NEG_INF / 2
        if rest_max is not None:
            # preferred picks are taken regardless of score in the
            # full-width form too, so the bound does not bind them
            bound = ~active | ~found | (val >= rest_max)
            ok = ok & (bound if pref_ok is None else bound | pref_ok)
        if f.with_topk:
            # stable descending sort == lax.top_k's lowest-index ties
            topv, topi = torch.sort(masked, dim=-1, descending=True,
                                    stable=True)
            topv, topi = topv[..., :TOPK], _rows(node_ids, topi[..., :TOPK])
        else:
            topv = torch.full(bshape + (TOPK,), NEG_INF, device=dev)
            topi = torch.zeros(bshape + (TOPK,), dtype=torch.int64,
                               device=dev)
        upd = found & active
        node = _rows(node_ids, idx)
        hit = (node_ids == node[..., None]) & upd[..., None]
        st = _deduct(kin, st, hit.to(torch.float32), hit.to(torch.int32),
                     ask_cpu_total, f, spread_onehot)
        outs.append((torch.where(found, node, -1).to(torch.int32),
                     torch.where(found, val, 0.0), upd,
                     topi.to(torch.int32), topv))
    chosen, scores, found = (torch.stack([o[j] for o in outs], dim=-1)
                             for j in range(3))
    topk_idx, topk_scores = (torch.stack([o[j] for o in outs], dim=-2)
                             for j in (3, 4))
    return chosen, scores, found, topk_idx, topk_scores, ok


def place_taskgroup(kin: KernelIn, k_steps: int,
                    features: KernelFeatures = FULL_FEATURES) -> KernelOut:
    """Place up to ``k_steps`` allocations of one task group (or of B
    evals, see the section note): each step masks, scores, takes the
    first argmax and deducts the chosen node's planes before the next.
    Steps past ``n_steps`` are inactive. ``features`` removes planes the
    ask does not use."""
    f = features
    kin, bshape = _eval_axis(kin, f)
    n = kin.cap_cpu.shape[-1]
    dev = kin.cap_cpu.device
    spread_onehot = (_spread_onehot(kin.spread_bucket, f.n_spreads)
                     if f.n_spreads > 0 else None)
    _, _, metrics = _first_step(kin, _carry_init(kin, f), f, bshape)
    chosen, scores, found, topi, topv, _ = _place_scan(
        kin, k_steps, f, bshape, torch.arange(n, device=dev),
        spread_onehot)
    return KernelOut(chosen, scores, found, topi, topv, **metrics)


def place_taskgroup_topk(kin: KernelIn, k_steps: int,
                         features: KernelFeatures = FULL_FEATURES):
    """Candidate-set placement: one full-width scoring pass, then the
    K-step scan over the top ``k_cand`` candidates only.

    The (k_cand+1)-th initial score bounds everything outside the set
    while placements only move non-chosen scores down (utilization,
    anti-affinity, penalties); the scan checks that bound against the
    exact ``rest_max`` and returns ``valid=False`` where it breaks, or
    where a placement is missing while the rest of the cluster could
    still take it. The caller then re-runs ``place_taskgroup``. Spread
    stanzas can raise non-candidate scores, so they are refused.

    Returns ``(KernelOut, valid)``; ``valid`` is a bool scalar, or [B]."""
    f = features
    if f.n_spreads > 0:
        raise ValueError("the top-K path requires no spread stanzas")
    kin, bshape = _eval_axis(kin, f)
    n = kin.cap_cpu.shape[-1]
    dev = kin.cap_cpu.device
    k_cand = min(n, max(2 * k_steps, k_steps + 8, TOPK))

    init = _carry_init(kin, f)
    feas0, ask_cpu_total0, metrics = _first_step(kin, init, f, bshape)
    final0 = _score(kin, init, ask_cpu_total0, kin.penalty, f, None)
    masked0 = torch.broadcast_to(torch.where(feas0, final0, NEG_INF),
                                 bshape + (n,))
    _, cand_idx = topk_ordered(masked0, k_cand)
    rest_max = masked0.scatter(-1, cand_idx, NEG_INF).amax(dim=-1)

    # preferred nodes stay selectable outside the top-K: appended rows
    # (a duplicate of a top-K node shares its deductions in the scan)
    pref_pad = torch.zeros(bshape + (k_cand,), dtype=torch.bool, device=dev)
    if f.with_preferred:
        prefs = kin.step_preferred[:k_steps].to(torch.int64)
        cand_idx = torch.cat([cand_idx, torch.clamp(prefs, 0, n - 1)])
        pref_pad = torch.cat([pref_pad, prefs < 0])
    if f.with_shuffle:
        # per-eval random candidate order from the node permutation
        cand_perm = torch.argsort(
            kin.node_perm.to(torch.int64)[cand_idx], stable=True)
    else:
        cand_perm = torch.arange(cand_idx.shape[-1], device=dev)
    planes = {name: _gather_nodes(getattr(kin, name), cand_idx,
                                  getattr(KIN_UNBATCHED_RANKS, name))
              for name in _NODE_PLANES}
    planes["base_mask"] = planes["base_mask"] & ~pref_pad
    kin_c = kin._replace(node_perm=cand_perm, **planes)

    chosen, scores, found, topi, topv, ok = _place_scan(
        kin_c, k_steps, f, bshape, cand_idx, k_cand=k_cand,
        rest_max=rest_max)
    # a placement missing while the rest of the cluster could still
    # take one also invalidates the candidate set
    steps = torch.arange(k_steps, device=dev)
    missing = torch.any((steps < kin.n_steps) & ~found, dim=-1)
    ok = ok & (~missing | (rest_max <= NEG_INF / 2))
    return KernelOut(chosen, scores, found, topi, topv, **metrics), ok


# ---------------------------------------------------------------------------
# Fused wave layout: ONE kernel launch and ONE packed readback per wave.
# ---------------------------------------------------------------------------

#: JointOut metric fields in packed-segment order (8 x [B] after the two
#: [T] rows). Single source of truth for pack (device) and unpack (host).
FUSED_METRIC_FIELDS = (
    "nodes_evaluated", "nodes_feasible",
    "exhausted_cpu", "exhausted_mem", "exhausted_disk",
    "exhausted_ports", "exhausted_devices", "exhausted_cores",
)


class FusedWaveOut(NamedTuple):
    """One fused wave's device outputs.

    ``packed`` is flat f32[2*T + 8*B]: ``[0:T)`` chosen (exact as f32
    below 2**24; ``found`` is ``chosen >= 0``), ``[T:2T)`` scores, then
    the eight B-wide metric segments in FUSED_METRIC_FIELDS order."""

    packed: torch.Tensor          # f32[2*T + 8*B]
    topk_idx: torch.Tensor        # i32[T, TOPK]
    topk_scores: torch.Tensor     # f32[T, TOPK]
    a_cpu: torch.Tensor           # f32[N] final shared-capacity carry
    a_mem: torch.Tensor           # f32[N]
    a_disk: torch.Tensor          # f32[N]


def fused_wave_supported(f: KernelFeatures) -> bool:
    """Whether a wave's (canonical) feature union fits the fused kernel's
    envelope: ports, penalties, preferred pins, distinct_hosts, shuffle
    and top-k are in; spreads, devices, cores and bandwidth are not
    (those waves are counted as fallbacks, the reference's meaning, and
    run the joint kernel, ``joint_wave_supported``)."""
    return (f.n_spreads == 0 and not f.with_devices
            and not f.with_cores and not f.with_network)


def joint_wave_supported(f: KernelFeatures) -> bool:
    """Whether the joint kernel (csrc/joint_wave.cu) takes a feature
    union: every union, up to MAX_SPREADS spread stanzas."""
    return 0 <= f.n_spreads <= MAX_SPREADS


def fused_pack_len(t_steps: int, b: int) -> int:
    return 2 * t_steps + 8 * b


def pack_fused_wave(out: JointOut, t_steps: int, b: int) -> torch.Tensor:
    """Pack a JointOut's eagerly-fetched planes into the flat f32 buffer."""
    parts = [out.chosen.to(torch.float32), out.scores]
    parts += [getattr(out, name).to(torch.float32)
              for name in FUSED_METRIC_FIELDS]
    return torch.cat(parts)


def unpack_fused_wave(packed, t_steps: int, b: int) -> dict:
    """Host-side inverse of ``pack_fused_wave``: chosen/scores/found and
    the eight metric fields as numpy arrays."""
    flat = np.asarray(packed)
    chosen = flat[:t_steps].astype(np.int32)
    host = {
        "chosen": chosen,
        "scores": flat[t_steps:2 * t_steps].astype(np.float32),
        "found": chosen >= 0,
    }
    off = 2 * t_steps
    for name in FUSED_METRIC_FIELDS:
        host[name] = flat[off:off + b].astype(np.int32)
        off += b
    return host


# ---------------------------------------------------------------------------
# Host half: KernelIn assembly.
# ---------------------------------------------------------------------------

def infer_features(ev, any_penalty: bool = True, any_preferred: bool = True,
                   with_topk: bool = True,
                   with_shuffle: bool = False) -> KernelFeatures:
    """Derive the lean static variant for one EvalTensors' ask."""
    ask = ev.ask
    return KernelFeatures(
        n_spreads=len(ev.spreads),
        with_topk=with_topk,
        with_devices=bool(ask.n_dev_reqs > 0 or ev.has_dev_affinity),
        with_ports=bool(ask.n_dyn_ports > 0 or ask.reserved_ports),
        with_cores=bool(ask.cores > 0),
        with_network=bool(ask.total_mbits > 0),
        with_distinct=bool(ev.distinct_hosts_job or ev.distinct_hosts_tg),
        with_step_penalties=bool(any_penalty),
        with_preferred=bool(any_preferred),
        with_shuffle=bool(with_shuffle),
    )


def build_kernel_in(
    cluster: ClusterTensors,
    ev: EvalTensors,
    n_steps: int,
    step_penalty: Optional[np.ndarray] = None,
    step_preferred: Optional[np.ndarray] = None,
    node_perm: Optional[np.ndarray] = None,
) -> KernelIn:
    """Assemble kernel inputs from the host-side tensor schema.

    ``step_penalty``/``step_preferred`` are per-placement planes sized to
    ``pad_steps(n_steps)``; None means none. ``node_perm`` is the seeded
    tie-break permutation (identity when shuffling is off). Leaves stay
    numpy: the wave launcher uploads each distinct plane once.
    """
    S, N = MAX_SPREADS, cluster.n_pad
    if len(ev.spreads) > S:
        raise AskLimitError(
            f"task group has {len(ev.spreads)} spread stanzas; kernel "
            f"supports {S}")
    neutral = neutral_planes(N)
    if ev.spreads:
        sp_active = np.zeros(S, bool)
        sp_even = np.zeros(S, bool)
        sp_weight = np.zeros(S, np.float32)
        sp_bucket = np.full((S, N), -1, np.int32)
        sp_counts = np.zeros((S, SPREAD_BUCKETS), np.float32)
        sp_desired = np.full((S, SPREAD_BUCKETS), -1.0, np.float32)
        for s, sp in enumerate(ev.spreads[:S]):
            sp_active[s] = True
            sp_even[s] = sp.even
            sp_weight[s] = sp.weight_frac
            sp_bucket[s] = sp.bucket_id
            sp_counts[s] = sp.counts
            sp_desired[s] = sp.desired
    else:
        # frozen singletons: identity-shared across wave members
        sp_active = sp_even = neutral.zeros_spread_flags
        sp_weight = neutral.zeros_spread_weight
        sp_bucket = neutral.neg1_spread_bucket
        sp_counts = neutral.zeros_spread_counts
        sp_desired = neutral.neg1_spread_desired

    # reserved-port conflict: ask bits already set in node planes or the
    # in-plan conflict words
    if ev.ask.reserved_ports:
        words = cluster.port_words | ev.port_conflict_words
        conflict = np.any(words & ev.ask.port_mask[None, :], axis=1)
        if ev.port_live_conflict is not None:
            conflict = conflict | ev.port_live_conflict
        has_res = True
    else:
        conflict = neutral.zeros_bool
        has_res = False

    k_pad = pad_steps(n_steps)
    if step_penalty is None or step_preferred is None:
        np_pen, np_pref = neutral_step_planes(k_pad)
        if step_penalty is None:
            step_penalty = np_pen
        if step_preferred is None:
            step_preferred = np_pref
    if node_perm is None:
        node_perm = neutral.arange_i32

    return KernelIn(
        cap_cpu=np.asarray(cluster.cap_cpu, np.float32),
        cap_mem=np.asarray(cluster.cap_mem, np.float32),
        cap_disk=np.asarray(cluster.cap_disk, np.float32),
        free_cores=np.asarray(cluster.free_cores, np.int32),
        shares_per_core=np.asarray(cluster.shares_per_core, np.float32),
        # identity-preserving when no in-plan dyn ports: wave members
        # then share the cluster's plane (shipped once per wave)
        free_dyn=(np.asarray(cluster.free_dyn, np.int32)
                  if not ev.free_dyn_delta.any()
                  else np.asarray(cluster.free_dyn - ev.free_dyn_delta,
                                  np.int32)),
        base_mask=np.asarray(ev.base_mask, bool),
        used_cpu=np.asarray(ev.used_cpu, np.float32),
        used_mem=np.asarray(ev.used_mem, np.float32),
        used_disk=np.asarray(ev.used_disk, np.float32),
        used_cores=np.asarray(ev.used_cores, np.int32),
        used_mbits=np.asarray(ev.used_mbits, np.int32),
        avail_mbits=np.asarray(ev.avail_mbits, np.int32),
        port_conflict=np.asarray(conflict, bool),
        dev_free=np.asarray(ev.dev_free, np.float32),
        dev_aff_score=np.asarray(ev.dev_aff_score, np.float32),
        has_dev_affinity=np.asarray(ev.has_dev_affinity, bool),
        job_tg_count=np.asarray(ev.job_tg_count, np.int32),
        penalty=np.asarray(ev.penalty, bool),
        aff_score=np.asarray(ev.aff_score, np.float32),
        node_perm=np.asarray(node_perm, np.int32),
        step_penalty=np.asarray(step_penalty, np.int32),
        step_preferred=np.asarray(step_preferred, np.int32),
        job_any_count=np.asarray(ev.job_any_count, np.int32),
        distinct_hosts_job=np.asarray(ev.distinct_hosts_job, bool),
        distinct_hosts_tg=np.asarray(ev.distinct_hosts_tg, bool),
        spread_active=np.asarray(sp_active, bool),
        spread_even=np.asarray(sp_even, bool),
        spread_weight=np.asarray(sp_weight, np.float32),
        spread_bucket=np.asarray(sp_bucket, np.int32),
        spread_counts=np.asarray(sp_counts, np.float32),
        spread_desired=np.asarray(sp_desired, np.float32),
        ask_cpu=np.asarray(ev.ask.cpu, np.float32),
        ask_mem=np.asarray(ev.ask.mem, np.float32),
        ask_disk=np.asarray(ev.ask.disk, np.float32),
        ask_cores=np.asarray(ev.ask.cores, np.int32),
        ask_dyn_ports=np.asarray(ev.ask.n_dyn_ports, np.int32),
        ask_has_reserved_ports=np.asarray(has_res, bool),
        ask_dev=np.asarray(ev.ask.dev_counts, np.float32),
        ask_mbits=np.asarray(ev.ask.total_mbits, np.int32),
        desired_count=np.asarray(ev.desired_count, np.int32),
        algorithm_spread=np.asarray(ev.algorithm == "spread", bool),
        n_steps=np.asarray(n_steps, np.int32),
    )


# ---------------------------------------------------------------------------
# Single-eval dispatch: the stack's direct (non-coalesced) launcher.
# ---------------------------------------------------------------------------

class _SingleEvalStats:
    """``default_kernel_launch`` accounting: ``topk`` candidate-set runs,
    ``breaches`` among them whose bound broke (each re-run full width),
    ``full`` full-width runs (breaches included)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.topk = 0
        self.breaches = 0
        self.full = 0

    def note(self, topk: bool = False, breach: bool = False,
             full: bool = False) -> None:
        with self._lock:
            self.topk += int(topk)
            self.breaches += int(breach)
            self.full += int(full)

    def reset(self) -> None:
        with self._lock:
            self.topk = self.breaches = self.full = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"topk": self.topk, "breaches": self.breaches,
                    "full": self.full}


single_eval_stats = _SingleEvalStats()


# ---------------------------------------------------------------------------
# Uploads: the one host -> device move of launch arguments. The wave
# launcher (parallel/coalesce._upload), the single-eval dispatch and the
# kernel profiler all go through it.
# ---------------------------------------------------------------------------

def on_device(x: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``x`` lies on ``dev``; ``cuda`` without an index names any
    card (the current one, as ``resolve_device`` returns it)."""
    return x.device.type == dev.type and (
        dev.index is None or x.device.index == dev.index)


def upload_leaf(x, dev: torch.device, done: Optional[dict] = None):
    """``(tensor on dev, bytes moved)`` for one launch argument. A tensor
    already on ``dev`` (a resident plane) moves nothing, a tensor on
    another device raises, and host numpy is copied with its dtype. A
    leaf placed over a mesh (a tuple of per-shard tensors,
    ``parallel/sharded.place``) stays where its mesh put it.
    ``done`` maps ``id`` of a host array already uploaded in this call to
    its tensor, so an array held under several fields goes up once."""
    if isinstance(x, torch.Tensor):
        if not on_device(x, dev):
            raise ValueError(f"plane on {x.device}, wave on {dev}")
        return x, 0
    if isinstance(x, tuple):
        return x, 0
    if done is not None:
        got = done.get(id(x))
        if got is not None:
            return got, 0
    arr = np.asarray(x)
    t = torch.tensor(arr, device=dev)
    if done is not None:
        done[id(x)] = t
    return t, arr.nbytes


def upload_args(args: tuple, dev: torch.device):
    """Every host leaf of ``args`` on ``dev``: a NamedTuple (a
    ``KernelIn``) field by field, any other argument as one leaf. Returns
    the new arguments and the bytes uploaded."""
    done: dict = {}
    out = []
    moved = 0
    for a in args:
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            leaves = []
            for x in a:
                t, n = upload_leaf(x, dev, done)
                leaves.append(t)
                moved += n
            out.append(type(a)(*leaves))
        else:
            t, n = upload_leaf(a, dev, done)
            out.append(t)
            moved += n
    return tuple(out), moved


def _upload_kin(kin: KernelIn, dev: torch.device) -> KernelIn:
    """Every leaf of one eval's planes on ``dev``; a plane the eval holds
    under several fields by identity (the neutral singletons) goes once,
    and a leaf already on ``dev`` (a resident plane) stays as it is."""
    return upload_args((kin,), dev)[0][0]


def _resident_kin(kin: KernelIn, dev: torch.device) -> KernelIn:
    """Swap the shared-plane leaves for their twins resident on ``dev``
    (tensors/device_state.py), so the dispatch uploads only the eval's
    own planes. All or nothing across the three sharing groups, as in
    the JAX package: an eval with any group not resident (forked job
    planes, a stale snapshot) ships every leaf from the host."""
    from nomad_tpu_torch.parallel.coalesce import (
        _JOB_SHAREABLE_FIELDS,
        _NEUTRAL_SHAREABLE_FIELDS,
        _SHAREABLE_FIELDS,
    )
    from nomad_tpu_torch.tensors.device_state import default_device_state

    default_device_state.advance_pending(dev)
    subs = {}
    for group in (_SHAREABLE_FIELDS, _NEUTRAL_SHAREABLE_FIELDS,
                  _JOB_SHAREABLE_FIELDS):
        for f in group:
            res = default_device_state.lookup(
                getattr(kin, f), dev,
                frozen_ok=group is not _SHAREABLE_FIELDS)
            if res is None:
                return kin
            subs[f] = res
    return kin._replace(**subs)


def _place_topk(kin: KernelIn, k_steps: int, features: KernelFeatures,
                dev: torch.device):
    return place_taskgroup_topk(_upload_kin(kin, dev), k_steps, features)


def _place_full(kin: KernelIn, k_steps: int, features: KernelFeatures,
                dev: torch.device):
    # on the card the joint kernel as a one-member wave, on the CPU its
    # plain version, place_taskgroup
    from nomad_tpu_torch.ops.cuda_kernel import joint_eval_place

    return joint_eval_place(_upload_kin(kin, dev), k_steps, features)


def _read_single(out: KernelOut, ok: Optional[torch.Tensor], k: int):
    """``(KernelOut of host numpy and ints, ok)`` through one device-to-host
    copy of a flat f32 buffer ``[ok, chosen[K], scores[K], found[K],
    topk_idx[K*TOPK], topk_scores[K*TOPK], the 8 metrics]``; ``ok`` None
    reads as True. Indices are exact in f32 below 2**24."""
    f32 = torch.float32
    dev = out.chosen.device
    head = (torch.ones(1, dtype=f32, device=dev) if ok is None
            else ok.to(f32).reshape(1))
    parts = [head, out.chosen.to(f32), out.scores.to(f32), out.found.to(f32),
             out.topk_idx.to(f32).reshape(-1),
             out.topk_scores.to(f32).reshape(-1)]
    parts += [getattr(out, name).to(f32).reshape(1)
              for name in FUSED_METRIC_FIELDS]
    flat = torch.cat(parts).cpu().numpy()
    chosen = flat[1:1 + k].astype(np.int32)
    scores = flat[1 + k:1 + 2 * k].astype(np.float32)
    found = flat[1 + 2 * k:1 + 3 * k] > 0.5
    off = 1 + 3 * k
    topk_idx = flat[off:off + k * TOPK].astype(np.int32).reshape(k, TOPK)
    off += k * TOPK
    topk_scores = flat[off:off + k * TOPK].astype(np.float32).reshape(
        k, TOPK)
    off += k * TOPK
    metrics = {name: int(flat[off + i])
               for i, name in enumerate(FUSED_METRIC_FIELDS)}
    return KernelOut(chosen, scores, found, topk_idx, topk_scores,
                     **metrics), bool(flat[0] > 0.5)


def default_kernel_launch(kin: KernelIn, k_steps: int,
                          features: KernelFeatures,
                          device: DeviceLike = None) -> KernelOut:
    """The stack's direct (non-coalesced) dispatch on ``device`` (the card
    unless the caller asks for the CPU): the eval's planes go up once,
    the candidate-set placement runs when its preconditions hold (no
    spread stanzas, binpack scoring), and the full-width placement runs
    otherwise or where the candidate set's bound broke (``valid`` False),
    the reference's rule, counted in ``single_eval_stats``. On the card
    the full-width placement is one launch of the joint kernel
    (``ops/cuda_kernel.joint_eval_place``). The result comes back as host
    numpy in one packed readback, top-k planes included. Shared planes
    resident on ``dev`` are not uploaded again, and both placements are
    profiled under the ``single_topk`` and ``single_full`` keys
    ``(n_pad, k_steps, features)``."""
    from nomad_tpu_torch.telemetry.kernel_profile import profiler

    dev = resolve_device(device)
    features = canonical_features(features)
    n_pad = int(kin.cap_cpu.shape[0])
    kin = _resident_kin(kin, dev)
    key = (n_pad, k_steps, features)
    if features.n_spreads == 0 and not bool(np.asarray(kin.algorithm_spread)):
        out, ok = profiler.call("single_topk", _place_topk, (kin,),
                                (k_steps, features, dev), key, dev)
        host, valid = _read_single(out, ok, k_steps)
        single_eval_stats.note(topk=True, breach=not valid, full=not valid)
        if valid:
            return host
    else:
        single_eval_stats.note(full=True)
    out = profiler.call("single_full", _place_full, (kin,),
                        (k_steps, features, dev), key, dev)
    host, _ = _read_single(out, None, k_steps)
    return host

