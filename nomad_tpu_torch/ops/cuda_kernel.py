"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Counterpart of ``nomad_tpu/ops/pallas_kernel.py``. Three kernels, each
built at first use by ``ops/build.py`` from ``csrc/`` and launched through
a plain C entry point loaded with ctypes:

- B1 ``fused_wave_place`` (``csrc/fused_wave.cu``; pallas_kernel.py
  :553-603, ``make_fused_wave_apply`` :618): the joint placement wave.
  Plain version: ``fused_wave_place_reference``, the torch composite
  ``place_taskgroups_joint`` packed the same way.
- B3 ``place_batch`` (``csrc/place_batch.cu``; ``pallas_place_batch``
  :165-238): lean full-width placement of B evals against one snapshot.
  Plain version: ``place_batch_reference``.
- B2 ``topk_place_batch`` (``csrc/cand_scan.cu``; ``pallas_topk_place_batch``
  :377-496): a torch full-width pass and candidate top-k
  (``candidate_pass``), then the K-step candidate scan, the kernel.
  Plain version: ``topk_place_batch_reference``, whose scan is
  ``cand_scan_reference``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors. ``launches``,
``place_batch_launches`` and ``cand_scan_launches`` count kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

from nomad_tpu_torch.ops.build import BuiltLibrary, build_library
from nomad_tpu_torch.ops.kernel import (
    KIN_UNBATCHED_RANKS,
    MAX_PENALTY_NODES,
    NEG_INF,
    TOPK,
    FusedWaveOut,
    KernelFeatures,
    KernelIn,
    fused_pack_len,
    fused_wave_supported,
    pack_fused_wave,
    _argmax_first,
    _rows,
    place_taskgroups_joint,
    topk_ordered,
)

#: CUDA kernel launches made by ``fused_wave_place`` (plain int; the
#: chip smoke zeroes it before driving the main path)
launches = 0
_LAUNCH_LOCK = threading.Lock()

#: KernelIn leaves the kernel reads, in csrc/fused_wave.cu ``Leaf`` order,
#: with the dtype each must have
_LEAVES = (
    ("cap_cpu", torch.float32), ("cap_mem", torch.float32),
    ("cap_disk", torch.float32),
    ("used_cpu", torch.float32), ("used_mem", torch.float32),
    ("used_disk", torch.float32),
    ("aff_score", torch.float32),
    ("free_dyn", torch.int32), ("job_tg_count", torch.int32),
    ("job_any_count", torch.int32), ("node_perm", torch.int32),
    ("base_mask", torch.bool), ("port_conflict", torch.bool),
    ("penalty", torch.bool),
    ("step_penalty", torch.int32),
    ("step_preferred", torch.int32),
    ("ask_cpu", torch.float32), ("ask_mem", torch.float32),
    ("ask_disk", torch.float32),
    ("ask_dyn_ports", torch.int32), ("desired_count", torch.int32),
    ("n_steps", torch.int32),
    ("ask_has_reserved_ports", torch.bool),
    ("algorithm_spread", torch.bool),
    ("distinct_hosts_job", torch.bool), ("distinct_hosts_tg", torch.bool),
)
_N_LEAVES = len(_LEAVES)


class _FusedArgs(ctypes.Structure):
    """Mirror of ``struct FusedArgs`` in csrc/fused_wave.cu."""

    _fields_ = [
        ("leaf", ctypes.c_void_p * _N_LEAVES),
        ("stride", ctypes.c_int64 * _N_LEAVES),
        ("step_member", ctypes.c_void_p),
        ("step_local", ctypes.c_void_p),
        ("packed", ctypes.c_void_p),
        ("topk_idx", ctypes.c_void_p),
        ("topk_scores", ctypes.c_void_p),
        ("a_cpu", ctypes.c_void_p),
        ("a_mem", ctypes.c_void_p),
        ("a_disk", ctypes.c_void_p),
        ("a_dyn", ctypes.c_void_p),
        ("jtc", ctypes.c_void_p),
        ("jac", ctypes.c_void_p),
        ("pc", ctypes.c_void_p),
        ("inv_perm", ctypes.c_void_p),
        ("n", ctypes.c_int), ("b", ctypes.c_int), ("t", ctypes.c_int),
        ("k", ctypes.c_int), ("p", ctypes.c_int), ("bp", ctypes.c_int),
        ("with_topk", ctypes.c_int), ("with_ports", ctypes.c_int),
        ("with_distinct", ctypes.c_int), ("with_step_pen", ctypes.c_int),
        ("with_pref", ctypes.c_int), ("with_shuffle", ctypes.c_int),
    ]


#: C entry point of each library under csrc/
_ENTRY = {"fused_wave": "fused_wave_launch",
          "place_batch": "place_batch_launch",
          "cand_scan": "cand_scan_launch"}
_LIBS: dict = {}          # name -> (entry point, BuiltLibrary)
_LIB_LOCK = threading.Lock()


def load_library(name: str) -> BuiltLibrary:
    """Build (or reuse) and load ``lib<name>.so``; returns the build
    record, whose ``log`` carries ptxas's register/spill report."""
    with _LIB_LOCK:
        got = _LIBS.get(name)
    if got is not None:
        return got[1]
    built = build_library(name)       # concurrent builds are safe
    with _LIB_LOCK:
        if name not in _LIBS:
            fn = getattr(ctypes.CDLL(str(built.path)), _ENTRY[name])
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _LIBS[name] = (fn, built)
        return _LIBS[name][1]


def load_libraries() -> dict:
    """Build every library at once (one ``nvcc`` each, started
    together); returns ``{name: BuiltLibrary}``."""
    with ThreadPoolExecutor(len(_ENTRY)) as pool:
        return dict(zip(_ENTRY, pool.map(load_library, _ENTRY)))


def _call(name: str, args, dev: torch.device, what: str) -> None:
    load_library(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIBS[name][0](ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _check_envelope(features: KernelFeatures) -> None:
    if not fused_wave_supported(features):
        raise ValueError(
            f"feature union {features} is outside the fused envelope "
            "(spreads, devices, cores and network run the composite)")


def fused_wave_place_reference(kin: KernelIn, step_member, step_local,
                               t_steps: int,
                               features: KernelFeatures) -> FusedWaveOut:
    """The plain torch version: the composite wave, packed."""
    b = int(kin.n_steps.shape[0])
    out = place_taskgroups_joint(kin, step_member, step_local, t_steps,
                                 features)
    return FusedWaveOut(
        packed=pack_fused_wave(out, t_steps, b),
        topk_idx=out.topk_idx, topk_scores=out.topk_scores,
        a_cpu=out.a_cpu, a_mem=out.a_mem, a_disk=out.a_disk,
    )


def fused_wave_place(kin: KernelIn, step_member, step_local, t_steps: int,
                     features: KernelFeatures) -> FusedWaveOut:
    """One fused wave: stacked KernelIn of torch tensors + step maps ->
    FusedWaveOut. CUDA tensors launch the kernel (or raise); CPU tensors
    run the plain version."""
    _check_envelope(features)
    dev = kin.cap_cpu.device
    if dev.type == "cpu":
        return fused_wave_place_reference(kin, step_member, step_local,
                                          t_steps, features)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(kin, step_member, step_local, t_steps, features)


def _member_stride(name: str, x: torch.Tensor, b: int, dev) -> int:
    """0 for a leaf shared by every member, its per-member element count
    for a stacked one. Checks device, dtype, contiguity and rank."""
    rank = getattr(KIN_UNBATCHED_RANKS, name)
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the wave on {dev}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.dim() == rank:
        return 0
    if x.dim() == rank + 1 and x.shape[0] == b:
        return x[0].numel()
    raise ValueError(f"{name} has shape {tuple(x.shape)}; want rank {rank} "
                     f"or a leading member axis of {b}")


def _launch(kin: KernelIn, step_member, step_local, t_steps: int,
            f: KernelFeatures) -> FusedWaveOut:
    global launches
    dev = kin.cap_cpu.device
    b = int(kin.n_steps.shape[0])
    n = int(kin.cap_cpu.shape[-1])
    k = int(kin.step_preferred.shape[-1])
    if n >= 1 << 24:
        raise ValueError("node ids are packed as f32: N must stay below 2**24")
    sm = torch.as_tensor(step_member, dtype=torch.int32, device=dev)
    sl = torch.as_tensor(step_local, dtype=torch.int32, device=dev)
    if sm.shape != (t_steps,) or sl.shape != (t_steps,):
        raise ValueError("step_member/step_local must be i32[t_steps]")
    if kin.step_penalty.shape[-1] != MAX_PENALTY_NODES:
        raise ValueError("step_penalty must be [.., K, MAX_PENALTY_NODES]")

    args = _FusedArgs()
    for slot, (name, dtype) in enumerate(_LEAVES):
        x = getattr(kin, name)
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}; want {dtype}")
        args.stride[slot] = _member_stride(name, x, b, dev)
        args.leaf[slot] = x.data_ptr()
    for name in ("cap_cpu", "base_mask"):
        if getattr(kin, name).shape[-1] != n:
            raise ValueError(f"{name} node axis differs from cap_cpu's")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    bp = b if kin.node_perm.dim() == 2 else 1
    out = FusedWaveOut(
        packed=f32(fused_pack_len(t_steps, b)),
        topk_idx=i32(t_steps, TOPK), topk_scores=f32(t_steps, TOPK),
        a_cpu=f32(n), a_mem=f32(n), a_disk=f32(n))
    scratch = dict(
        a_dyn=i32(n if f.with_ports else 1),
        jtc=i32(b, n),
        jac=i32(b, n) if f.with_distinct else i32(1),
        pc=(torch.empty((b, n), dtype=torch.bool, device=dev)
            if f.with_ports else i32(1)),
        inv_perm=i32(bp, n) if f.with_shuffle else i32(1),
    )
    args.step_member = sm.data_ptr()
    args.step_local = sl.data_ptr()
    for name in FusedWaveOut._fields:
        setattr(args, name, getattr(out, name).data_ptr())
    for name, x in scratch.items():
        setattr(args, name, x.data_ptr())
    args.n, args.b, args.t, args.k = n, b, t_steps, k
    args.p, args.bp = MAX_PENALTY_NODES, bp
    args.with_topk = int(f.with_topk)
    args.with_ports = int(f.with_ports)
    args.with_distinct = int(f.with_distinct)
    args.with_step_pen = int(f.with_step_penalties)
    args.with_pref = int(f.with_preferred)
    args.with_shuffle = int(f.with_shuffle)

    _call("fused_wave", args, dev, "fused_wave_kernel")
    with _LAUNCH_LOCK:
        launches += 1
    # scratch freed here is reused only by work queued later on this
    # stream, so the caching allocator keeps it alive for the kernel
    return out


def fused_wave_apply(kin: KernelIn, used_cpu: torch.Tensor,
                     used_mem: torch.Tensor, used_disk: torch.Tensor,
                     step_member, step_local, t_steps: int,
                     features: KernelFeatures):
    """Fused wave + carry commit: runs the wave with the given shared used
    planes and returns ``(FusedWaveOut, used_cpu', used_mem', used_disk')``
    where ``used_* + a_*`` are NEW tensors: the caller's tensors are never
    written (the counterpart of make_fused_wave_apply's owned-buffer
    rule). Unlike the JAX counterpart it also commits disk, which the
    capacity checks read."""
    kin2 = kin._replace(used_cpu=used_cpu, used_mem=used_mem,
                        used_disk=used_disk)
    out = fused_wave_place(kin2, step_member, step_local, t_steps, features)
    return (out, used_cpu + out.a_cpu, used_mem + out.a_mem,
            used_disk + out.a_disk)


# ---------------------------------------------------------------------------
# B3 and B2: lean batch placement against one shared snapshot.
# ---------------------------------------------------------------------------

#: CUDA kernel launches made by ``place_batch`` (B3) and by the candidate
#: scan of ``topk_place_batch`` (B2)
place_batch_launches = 0
cand_scan_launches = 0

MAX_K = 128           # placement steps per eval, and candidates per eval

#: the lean arguments, in ``pallas_place_batch``'s order, with the dtype
#: each must have: shared [N] planes, then per-eval [B] asks, then the
#: three that may also be one scalar for the whole batch
LEAN_ARGS = (
    ("cap_cpu", torch.float32), ("cap_mem", torch.float32),
    ("cap_disk", torch.float32),
    ("used_cpu", torch.float32), ("used_mem", torch.float32),
    ("used_disk", torch.float32),
    ("base_mask", torch.bool), ("job_tg_count", torch.int32),
    ("penalty", torch.bool), ("aff_score", torch.float32),
    ("ask_cpu", torch.float32), ("ask_mem", torch.float32),
    ("ask_disk", torch.float32),
    ("n_steps", torch.int32), ("desired_count", torch.int32),
    ("algorithm_spread", torch.bool),
)
_N_PLANES = 10
_SCALAR_OR_B = ("ask_disk", "desired_count", "algorithm_spread")


class PlaceOut(NamedTuple):
    chosen: torch.Tensor     # i32[B, K] node rows (-1 none)
    scores: torch.Tensor     # f32[B, K]
    found: torch.Tensor      # bool[B, K]


def _lean_inputs(lean: tuple, k_steps: int) -> dict:
    """Check the lean arguments (device, dtype, shape, contiguity, K)
    and broadcast the scalar ones to [B]; returns them by name."""
    if len(lean) != len(LEAN_ARGS):
        raise ValueError(f"{len(lean)} lean arguments; want {len(LEAN_ARGS)}")
    if not 0 < k_steps <= MAX_K:
        raise ValueError(f"k_steps={k_steps}: want 1..{MAX_K}")
    v = dict(zip((name for name, _ in LEAN_ARGS), lean))
    dev = v["cap_cpu"].device
    n = int(v["cap_cpu"].shape[0])
    b = int(v["ask_cpu"].shape[0])
    for slot, (name, dtype) in enumerate(LEAN_ARGS):
        x = v[name]
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{name} must be a torch tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, cap_cpu on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}; want {dtype}")
        if name in _SCALAR_OR_B and x.dim() == 0:
            x = v[name] = x.expand(b).contiguous()
        want = (n,) if slot < _N_PLANES else (b,)
        if tuple(x.shape) != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}; want {want}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return v


def _per_eval(v: dict):
    """The per-eval scalars as [B, 1] columns: ask cpu/mem/disk, spread
    flag, anti-affinity denominator max(desired, 1), n_steps."""
    return (v["ask_cpu"][:, None], v["ask_mem"][:, None],
            v["ask_disk"][:, None], v["algorithm_spread"][:, None],
            torch.clamp_min(v["desired_count"].to(torch.float32),
                            1.0)[:, None],
            v["n_steps"][:, None])


def _lean_static(pen: torch.Tensor, aff: torch.Tensor):
    """(aff_sum, extra planes) of the lean score: pallas_kernel.py
    :100-104, csrc/lean_score.cuh ``lean_node``."""
    aff_on = aff != 0.0
    aff_sum = torch.where(aff_on, aff, 0.0) + torch.where(pen, -1.0, 0.0)
    extra = pen.to(torch.float32) + aff_on.to(torch.float32)
    return aff_sum, extra


def _lean_fit(uc, um, cc, cm, a_cpu, a_mem, spread):
    fc = torch.where(cc > 0, 1.0 - (uc + a_cpu) / cc, 0.0)
    fm = torch.where(cm > 0, 1.0 - (um + a_mem) / cm, 0.0)
    total = torch.pow(10.0, fc) + torch.pow(10.0, fm)
    binpack = torch.clamp(20.0 - total, 0.0, 18.0)       # funcs.go:259
    spreadfit = torch.clamp(total - 2.0, 0.0, 18.0)      # funcs.go:286
    return torch.where(spread, spreadfit, binpack) / 18.0


def _lean_score(uc, um, coll, cc, cm, a_cpu, a_mem, spread, denom,
                aff_sum, extra):
    """The lean score in the kernels' operation order (pallas_kernel.py
    :115-126, csrc/lean_score.cuh ``lean_score``)."""
    fit = _lean_fit(uc, um, cc, cm, a_cpu, a_mem, spread)
    anti_on = coll > 0
    ssum = fit + torch.where(anti_on, -(coll + 1.0) / denom, 0.0) + aff_sum
    nplanes = 1.0 + anti_on.to(torch.float32) + extra
    return ssum / nplanes


def _lean_feasible(base, cc, cm, cd, uc, um, ud, a_cpu, a_mem, a_disk):
    return (base & ((cc - uc) >= a_cpu) & ((cm - um) >= a_mem)
            & ((cd - ud) >= a_disk))


def _place_batch_plain(v: dict, k_steps: int) -> PlaceOut:
    cc, cm, cd = v["cap_cpu"], v["cap_mem"], v["cap_disk"]
    a_cpu, a_mem, a_disk, spread, denom, n_steps = _per_eval(v)
    b, n = a_cpu.shape[0], cc.shape[0]
    aff_sum, extra = _lean_static(v["penalty"], v["aff_score"])
    uc, um, ud = (v[k].expand(b, n) for k in
                  ("used_cpu", "used_mem", "used_disk"))
    utg = v["job_tg_count"].expand(b, n)
    iota = torch.arange(n, device=cc.device)
    outs = []
    for i in range(k_steps):
        feas = _lean_feasible(v["base_mask"], cc, cm, cd, uc, um, ud,
                              a_cpu, a_mem, a_disk)
        final = _lean_score(uc, um, utg.to(torch.float32), cc, cm, a_cpu,
                            a_mem, spread, denom, aff_sum, extra)
        masked = torch.where(feas & (n_steps > i), final, NEG_INF)
        idx = _argmax_first(masked)
        amax = _rows(masked, idx)
        fnd = amax > NEG_INF / 2
        one = (iota == idx[:, None]) & fnd[:, None]
        onef = one.to(torch.float32)
        uc, um, ud = uc + onef * a_cpu, um + onef * a_mem, ud + onef * a_disk
        utg = utg + one.to(torch.int32)
        outs.append((torch.where(fnd, idx, -1).to(torch.int32),
                     torch.where(fnd, amax, 0.0), fnd))
    return PlaceOut(*(torch.stack([o[j] for o in outs], dim=1)
                      for j in range(3)))


def place_batch_reference(*lean, k_steps: int) -> PlaceOut:
    """The plain torch version of ``place_batch``: the same K steps over
    [B, N] carries."""
    return _place_batch_plain(_lean_inputs(lean, k_steps), k_steps)


def place_batch(*lean, k_steps: int) -> PlaceOut:
    """Place ``k_steps`` allocations for each of B lean evals against one
    snapshot (``pallas_place_batch`` without ``interpret``): the 16
    ``LEAN_ARGS`` in order; ``ask_disk``, ``desired_count`` and
    ``algorithm_spread`` may be 0-d. Outputs are [B, K], unpadded. CUDA
    tensors launch csrc/place_batch.cu (or raise); CPU tensors run the
    plain version."""
    global place_batch_launches
    v = _lean_inputs(lean, k_steps)
    dev = v["cap_cpu"].device
    if dev.type == "cpu":
        return _place_batch_plain(v, k_steps)
    b = int(v["ask_cpu"].shape[0])
    out = PlaceOut(
        chosen=torch.empty((b, k_steps), dtype=torch.int32, device=dev),
        scores=torch.empty((b, k_steps), dtype=torch.float32, device=dev),
        found=torch.empty((b, k_steps), dtype=torch.bool, device=dev))
    if b == 0:
        return out
    args = _PlaceArgs()
    _fill_lean(args, v)
    for name in PlaceOut._fields:
        setattr(args, name, getattr(out, name).data_ptr())
    args.n, args.b, args.k = int(v["cap_cpu"].shape[0]), b, k_steps
    _call("place_batch", args, dev, "place_batch_kernel")
    with _LAUNCH_LOCK:
        place_batch_launches += 1
    return out


def candidate_pass(v: dict, k_cand: int):
    """The full-width pass of ``pallas_topk_place_batch`` (:410-437), in
    torch ops for both routes: masked scores [B, N] in that pass's
    operation order, the ``k_cand`` best nodes per eval ordered by
    (score desc, node asc) as i32 [B, k_cand], and the exact best score
    outside them, f32[B]."""
    cc, cm, cd = v["cap_cpu"], v["cap_mem"], v["cap_disk"]
    uc, um, ud = v["used_cpu"], v["used_mem"], v["used_disk"]
    a_cpu, a_mem, a_disk, spread, denom, _ = _per_eval(v)
    feas = _lean_feasible(v["base_mask"], cc, cm, cd, uc, um, ud,
                          a_cpu, a_mem, a_disk)
    fit = _lean_fit(uc, um, cc, cm, a_cpu, a_mem, spread)
    coll = v["job_tg_count"].to(torch.float32)
    anti_on = coll > 0
    pen, aff = v["penalty"], v["aff_score"]
    aff_on = aff != 0.0
    ssum = (fit + torch.where(anti_on, -(coll + 1.0) / denom, 0.0)
            + torch.where(aff_on, aff, 0.0) + torch.where(pen, -1.0, 0.0))
    nplanes = (1.0 + anti_on.to(torch.float32) + aff_on.to(torch.float32)
               + pen.to(torch.float32))
    masked0 = torch.where(feas, ssum / nplanes, NEG_INF)
    _, cand = topk_ordered(masked0, k_cand)
    rest_max = masked0.scatter(-1, cand, NEG_INF).amax(dim=-1)
    return cand.to(torch.int32), rest_max


def cand_scan_reference(cand: torch.Tensor, rest_max: torch.Tensor,
                        v: dict, k_steps: int):
    """The plain torch version of the candidate scan (the body of
    ``_cand_scan_kernel``): ``(chosen, scores, found, valid)``."""
    nid = cand.to(torch.int64)
    g = {k: v[k][nid] for k in ("cap_cpu", "cap_mem", "cap_disk",
                                "used_cpu", "used_mem", "used_disk",
                                "base_mask", "job_tg_count", "penalty",
                                "aff_score")}
    cc, cm, cd = g["cap_cpu"], g["cap_mem"], g["cap_disk"]
    uc, um, ud = g["used_cpu"], g["used_mem"], g["used_disk"]
    utg = g["job_tg_count"].to(torch.float32)
    aff_sum, extra = _lean_static(g["penalty"], g["aff_score"])
    a_cpu, a_mem, a_disk, spread, denom, n_steps = _per_eval(v)
    ok = torch.ones(nid.shape[0], dtype=torch.bool, device=nid.device)
    outs = []
    for i in range(k_steps):
        feas = _lean_feasible(g["base_mask"], cc, cm, cd, uc, um, ud,
                              a_cpu, a_mem, a_disk)
        final = _lean_score(uc, um, utg, cc, cm, a_cpu, a_mem, spread,
                            denom, aff_sum, extra)
        active = (n_steps > i)[:, 0]
        masked = torch.where(feas & active[:, None], final, NEG_INF)
        lane = _argmax_first(masked)
        rowmax = _rows(masked, lane)
        fnd = rowmax > NEG_INF / 2
        node = torch.gather(nid, 1, lane[:, None])[:, 0]
        placed = fnd & active
        # rows of one node share deductions (pallas_kernel.py:324-333)
        share = ((nid == node[:, None]) & placed[:, None]).to(torch.float32)
        uc, um, ud = uc + share * a_cpu, um + share * a_mem, ud + share * a_disk
        utg = utg + share
        ok = ok & (~active | ~fnd | (rowmax >= rest_max))
        outs.append((torch.where(placed, node, -1).to(torch.int32),
                     torch.where(placed, rowmax, 0.0), placed))
    chosen, scores, found = (torch.stack([o[j] for o in outs], dim=1)
                             for j in range(3))
    steps = torch.arange(k_steps, device=nid.device)
    missing = torch.any((steps < n_steps) & ~found, dim=1)
    valid = ok & (~missing | (rest_max <= NEG_INF / 2))
    return chosen, scores, found, valid


def _cand_scan(cand, rest_max, v: dict, k_steps: int):
    global cand_scan_launches
    dev = cand.device
    if dev.type == "cpu":
        return cand_scan_reference(cand, rest_max, v, k_steps)
    b, kc = cand.shape
    if not (cand.dtype == torch.int32 and cand.is_contiguous()
            and rest_max.dtype == torch.float32 and rest_max.shape == (b,)
            and rest_max.is_contiguous() and 0 < kc <= MAX_K):
        raise ValueError("candidates must be contiguous i32[B, <=128] with "
                         "a contiguous f32[B] rest max")
    out = (torch.empty((b, k_steps), dtype=torch.int32, device=dev),
           torch.empty((b, k_steps), dtype=torch.float32, device=dev),
           torch.empty((b, k_steps), dtype=torch.bool, device=dev),
           torch.empty((b,), dtype=torch.bool, device=dev))
    if b == 0:
        return out
    args = _ScanArgs()
    _fill_lean(args, v)
    args.cand, args.rest_max = cand.data_ptr(), rest_max.data_ptr()
    for name, x in zip(("chosen", "scores", "found", "valid"), out):
        setattr(args, name, x.data_ptr())
    args.n, args.b, args.k, args.kc = (int(v["cap_cpu"].shape[0]), b,
                                       k_steps, kc)
    _call("cand_scan", args, dev, "cand_scan_kernel")
    with _LAUNCH_LOCK:
        cand_scan_launches += 1
    return out


def _candidates(lean: tuple, k_steps: int, k_cand: int):
    v = _lean_inputs(lean, k_steps)
    k_cand = min(k_cand, int(v["cap_cpu"].shape[0]), MAX_K)
    return (*candidate_pass(v, k_cand), v)


def topk_place_batch(*lean, k_steps: int, k_cand: int = 64):
    """Candidate-set placement for B lean evals
    (``pallas_topk_place_batch`` without ``interpret``): the torch
    ``candidate_pass`` to min(k_cand, N, 128) candidates, then the K-step
    scan, on the card csrc/cand_scan.cu (or raise), on the CPU its plain
    version. Returns ``(chosen i32[B,K] node rows, scores f32[B,K],
    found bool[B,K], valid bool[B])``; ``valid=False`` rows must re-run
    through the full-width path."""
    return _cand_scan(*_candidates(lean, k_steps, k_cand), k_steps)


def topk_place_batch_reference(*lean, k_steps: int, k_cand: int = 64):
    """The plain torch version of ``topk_place_batch``: the same pass,
    then ``cand_scan_reference``."""
    return cand_scan_reference(*_candidates(lean, k_steps, k_cand), k_steps)


_LEAN_FIELDS = [(name, ctypes.c_void_p) for name, _ in LEAN_ARGS]


class _PlaceArgs(ctypes.Structure):
    """Mirror of ``struct PlaceArgs`` in csrc/place_batch.cu."""

    _fields_ = _LEAN_FIELDS + [
        ("chosen", ctypes.c_void_p), ("scores", ctypes.c_void_p),
        ("found", ctypes.c_void_p),
        ("n", ctypes.c_int), ("b", ctypes.c_int), ("k", ctypes.c_int),
    ]


class _ScanArgs(ctypes.Structure):
    """Mirror of ``struct ScanArgs`` in csrc/cand_scan.cu."""

    _fields_ = [("cand", ctypes.c_void_p), ("rest_max", ctypes.c_void_p)] \
        + _LEAN_FIELDS + [
        ("chosen", ctypes.c_void_p), ("scores", ctypes.c_void_p),
        ("found", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("n", ctypes.c_int), ("b", ctypes.c_int), ("k", ctypes.c_int),
        ("kc", ctypes.c_int),
    ]


def _fill_lean(args, v: dict) -> None:
    for name, _ in LEAN_ARGS:
        setattr(args, name, v[name].data_ptr())
