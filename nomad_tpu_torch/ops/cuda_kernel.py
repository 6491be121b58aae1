"""The fused placement wave: a hand-written CUDA kernel and its plain version.

Counterpart of ``nomad_tpu/ops/pallas_kernel.py`` ``fused_wave_place``
(:553-603) and ``make_fused_wave_apply`` (:618-637). The kernel lives in
``csrc/fused_wave.cu`` (one thread block runs the wave's T steps; see
the note at the top of the source) and is built at first use by
``ops/build.py``. Its plain version is ``fused_wave_place_reference``:
the torch composite ``place_taskgroups_joint`` packed the same way.

``fused_wave_place`` launches the kernel for CUDA tensors and runs the
plain version only for CPU tensors. ``launches`` counts kernel launches
and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from nomad_tpu_torch.ops.build import BuiltLibrary, build_library
from nomad_tpu_torch.ops.kernel import (
    KIN_UNBATCHED_RANKS,
    MAX_PENALTY_NODES,
    TOPK,
    FusedWaveOut,
    KernelFeatures,
    KernelIn,
    fused_pack_len,
    fused_wave_supported,
    pack_fused_wave,
    place_taskgroups_joint,
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


_LIB: Optional[ctypes.CDLL] = None
_BUILT: Optional[BuiltLibrary] = None
_LIB_LOCK = threading.Lock()


def load_library() -> BuiltLibrary:
    """Build (or reuse) and load ``libfused_wave.so``; returns the build
    record, whose ``log`` carries ptxas's register/spill report."""
    global _LIB, _BUILT
    with _LIB_LOCK:
        if _LIB is None:
            built = build_library("fused_wave")
            lib = ctypes.CDLL(str(built.path))
            lib.fused_wave_launch.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p]
            lib.fused_wave_launch.restype = ctypes.c_int
            _LIB, _BUILT = lib, built
        return _BUILT


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

    load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _LIB.fused_wave_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"fused_wave_kernel launch failed: cudaError {err}")
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
