"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Counterpart of ``nomad_tpu/ops/pallas_kernel.py``, and of the XLA
programs on a main path that became kernels. Six kernels, each built at
first use by ``ops/build.py`` from ``csrc/`` and launched through a plain
C entry point loaded with ctypes:

- B1 ``fused_wave_place`` (``csrc/fused_wave.cu``; pallas_kernel.py
  :553-603, ``make_fused_wave_apply`` :618): the joint placement wave.
  Plain version: ``fused_wave_place_reference``, the torch composite
  ``place_taskgroups_joint`` packed the same way.
- B3 ``place_batch`` (``csrc/place_batch.cu``; ``pallas_place_batch``
  :165-238): lean full-width placement of B evals against one snapshot.
  Plain version: ``place_batch_reference``.
- B2 ``topk_place_batch`` (``csrc/topk_place_batch.cu``;
  ``pallas_topk_place_batch`` :377-496 whole): one kernel for the
  full-width pass, the exact candidate top-k and rest max, and the K-step
  candidate scan. Plain version: ``topk_place_batch_reference``, the torch
  ``candidate_pass`` then ``cand_scan_reference``.
- ``joint_wave_place`` (``csrc/joint_wave.cu``; the XLA programs
  ``nomad_tpu/ops/kernel.py`` ``place_taskgroups_joint_jit`` :1060-1279
  and ``place_taskgroup_jit`` :565-723): the joint wave under any feature
  union (spreads, devices, reserved cores, bandwidth), for the waves
  outside B1's envelope and for the waves too wide for B1's cluster
  (``fused_wave_fits``); ``joint_eval_place`` runs one eval through it as
  ``place_taskgroup`` does. One launch a wave of the clusters its plan
  picks from the node axis and the card (``joint_clusters``); a wave
  whose node ranges do not fit shared memory even then runs its
  global-row instantiation (``joint_rows_global``). Plain versions:
  ``fused_wave_place_reference`` and ``place_taskgroup``.
- ``sharded_wave_place`` (``csrc/sharded_wave.cu``; the XLA program
  ``nomad_tpu/parallel/sharded.py`` ``_fused_sharded_core`` :291-505,
  under ``fused_sharded_entry`` :507): the fused wave over a mesh of node
  shards, one C call a wave and one cluster launch a card. Plain version:
  ``sharded_wave_place_reference``, ``parallel/sharded._sharded_wave``
  packed the same way.
- ``joint_sharded_wave_place`` (``csrc/joint_sharded_wave.cu``; the XLA
  program ``nomad_tpu/parallel/sharded.py`` ``joint_sharded_entry`` :207,
  GSPMD over ``place_taskgroups_joint``): the joint wave under any feature
  union over a mesh of node shards of any width, one C call a wave and
  one launch a card of the clusters its plan picks from the card's rows
  (``joint_sharded_plan``), its rows in a global scratch past what those
  clusters' shared memory holds. Plain version:
  ``joint_sharded_wave_place_reference``, ``_sharded_wave`` packed.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors. ``launches``, ``joint_launches``
(of those ``joint_global_calls``, the global-row instantiation's),
``place_batch_launches``, ``topk_place_batch_launches``,
``sharded_launches`` and ``joint_sharded_launches`` (of those
``joint_sharded_global_calls``) count kernel calls and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from nomad_tpu_torch.ops.build import BuiltLibrary, build_library
from nomad_tpu_torch.ops.kernel import (
    FUSED_METRIC_FIELDS,
    KIN_UNBATCHED_RANKS,
    MAX_PENALTY_NODES,
    NEG_INF,
    TOPK,
    FusedWaveOut,
    KernelFeatures,
    KernelIn,
    KernelOut,
    fused_pack_len,
    fused_wave_supported,
    joint_wave_supported,
    pack_fused_wave,
    _argmax_first,
    _as_host_ints,
    _rows,
    place_taskgroup,
    place_taskgroups_joint,
    topk_ordered,
)
from nomad_tpu_torch.tensors.schema import (
    MAX_DEV_REQS,
    MAX_SPREADS,
    SPREAD_BUCKETS,
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
        ("n", ctypes.c_int), ("b", ctypes.c_int), ("t", ctypes.c_int),
        ("k", ctypes.c_int), ("p", ctypes.c_int), ("bp", ctypes.c_int),
        ("with_topk", ctypes.c_int), ("with_ports", ctypes.c_int),
        ("with_distinct", ctypes.c_int), ("with_step_pen", ctypes.c_int),
        ("with_pref", ctypes.c_int), ("with_shuffle", ctypes.c_int),
    ]


#: C entry point of each library under csrc/
_ENTRY = {"fused_wave": "fused_wave_launch",
          "joint_wave": "joint_wave_launch",
          "place_batch": "place_batch_launch",
          "topk_place_batch": "topk_place_batch_launch",
          "sharded_wave": "sharded_wave_launch",
          "joint_sharded_wave": "joint_sharded_wave_launch"}
#: the entry points' arguments: (args, stream) unless listed (the sharded
#: waves carry each card's stream in their args)
_ARGTYPES = {"sharded_wave": [ctypes.c_void_p],
             "joint_sharded_wave": [ctypes.c_void_p]}
_LIBS: dict = {}          # name -> (entry point, BuiltLibrary, CDLL)
_LIB_LOCK = threading.Lock()
#: name -> lock held while that library is built and loaded
_BUILD_LOCKS = {name: threading.Lock() for name in _ENTRY}
#: libraries loaded in this process (the kernel profiler counts a launch
#: during which this grew as a miss)
library_loads = 0


def load_library(name: str) -> BuiltLibrary:
    """Build (or reuse) and load ``lib<name>.so``; returns the build
    record, whose ``log`` carries ptxas's register/spill report. Threads
    that race for one library (a wave beside the warmup thread) wait for
    the first one's build and load it once."""
    global library_loads
    with _LIB_LOCK:
        got = _LIBS.get(name)
    if got is not None:
        return got[1]
    with _BUILD_LOCKS[name]:
        with _LIB_LOCK:
            got = _LIBS.get(name)
        if got is not None:
            return got[1]
        built = build_library(name)
        lib = ctypes.CDLL(str(built.path))
        fn = getattr(lib, _ENTRY[name])
        fn.argtypes = _ARGTYPES.get(name, [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        with _LIB_LOCK:
            _LIBS[name] = (fn, built, lib)
            library_loads += 1
        return built


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


def fused_wave_cluster_size() -> int:
    """CTAs in the thread-block cluster that runs one fused wave (a
    constant of csrc/fused_wave.cu)."""
    load_library("fused_wave")
    return int(_LIBS["fused_wave"][2].fused_wave_cluster())


_PLANS: dict = {}         # (device, n, b, shuffle) -> fused_wave_plan's out


def _fused_plan(dev: torch.device, n: int, b: int, shuffle: bool) -> tuple:
    """``fused_wave_plan`` on the card, once per shape: (cluster, shared
    memory the wave needs, the most a block may take, clusters the card
    holds at once)."""
    key = (dev.index, n, b, bool(shuffle))
    plan = _PLANS.get(key)
    if plan is None:
        load_library("fused_wave")
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = _LIBS["fused_wave"][2].fused_wave_plan(
                ctypes.c_int(n), ctypes.c_int(b), ctypes.c_int(int(shuffle)),
                out)
        if err != 0:
            raise RuntimeError(f"fused_wave_plan failed: cudaError {err}")
        plan = _PLANS[key] = tuple(out)
    return plan


def _check_cluster_fits(dev: torch.device, n: int, b: int,
                        shuffle: bool) -> None:
    """Raise unless one cluster can hold the wave: each CTA keeps its
    node range's score row (and shuffle ranks) in shared memory (the wave
    launcher sends a wave that does not fit to the joint kernel,
    ``fused_wave_fits``)."""
    cluster, smem, limit, clusters = _fused_plan(dev, n, b, shuffle)
    if smem > limit:
        raise ValueError(
            f"N={n} does not fit the fused wave: each of the {cluster} CTAs "
            f"keeps {-(-n // cluster)} nodes' scores in shared memory, "
            f"{smem} B with B={b}, over the limit of {limit} B a block may "
            "take on this card")
    if clusters == 0:
        raise RuntimeError(f"the card runs no cluster of {cluster} CTAs with "
                           f"{smem} B of shared memory each")


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
    _check_cluster_fits(dev, n, b, f.with_shuffle)

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
# The joint wave under any feature union.
# ---------------------------------------------------------------------------

#: CUDA kernel launches made by ``joint_wave_place`` and
#: ``joint_eval_place`` (csrc/joint_wave.cu)
joint_launches = 0

#: CTAs in each cluster of a joint wave (CLUSTER in csrc/joint_wave.cu)
JOINT_CLUSTER = 16
#: the most clusters one joint wave spreads its node axis over
#: (MAX_CLUSTERS in csrc/joint_wave.cu)
JOINT_MAX_CLUSTERS = 8
#: the rows a CTA of one cluster keeps before the joint wave takes every
#: cluster the card holds: with no spread stanza (every step reads cached
#: rows) and with one (a spread member re-derives its rows each step).
#: Measured by nomad_tpu_torch/tools/joint_split.py on an NVIDIA H100 80GB
#: HBM3 at 700 W, every union at N=16384-524288 over 1-7 clusters: on one
#: cluster a step costs ~0.7 ns more a row a CTA on cached rows and ~1.6
#: ns on spread rows; the exchange between clusters adds ~2 us a step.
#: Seven clusters overtake one from ~4400 rows a CTA on cached waves (at
#: 4096 one cluster is 2.4-5.6% faster) and from ~2000 on a wave of
#: spread members (at 2048 the two tie); a count between one and the
#: card's seven was never faster than seven by more than 1.5%.
JOINT_ROWS_CACHED = 4096
JOINT_ROWS_SPREAD = 2048

#: how long a cluster waits on another's step (a card's on another card's
#: in the sharded waves) before the wave fails
SPIN_S = 5.0

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
#: every KernelIn leaf in its field order (csrc/joint_wave.cu ``JLeaf``),
#: with the dtype it must have
_JOINT_LEAVES = tuple((name, {
    "cap_cpu": _F32, "cap_mem": _F32, "cap_disk": _F32, "free_cores": _I32,
    "shares_per_core": _F32, "free_dyn": _I32, "base_mask": _BOOL,
    "used_cpu": _F32, "used_mem": _F32, "used_disk": _F32,
    "used_cores": _I32, "used_mbits": _I32, "avail_mbits": _I32,
    "port_conflict": _BOOL, "dev_free": _F32, "dev_aff_score": _F32,
    "has_dev_affinity": _BOOL, "job_tg_count": _I32, "penalty": _BOOL,
    "aff_score": _F32, "node_perm": _I32, "step_penalty": _I32,
    "step_preferred": _I32, "job_any_count": _I32,
    "distinct_hosts_job": _BOOL, "distinct_hosts_tg": _BOOL,
    "spread_active": _BOOL, "spread_even": _BOOL, "spread_weight": _F32,
    "spread_bucket": _I32, "spread_counts": _F32, "spread_desired": _F32,
    "ask_cpu": _F32, "ask_mem": _F32, "ask_disk": _F32, "ask_cores": _I32,
    "ask_dyn_ports": _I32, "ask_has_reserved_ports": _BOOL, "ask_dev": _F32,
    "ask_mbits": _I32, "desired_count": _I32, "algorithm_spread": _BOOL,
    "n_steps": _I32,
}[name]) for name in KernelIn._fields)


def _joint_shapes(n: int, k: int) -> dict:
    """The single-problem shape of every leaf with more than one axis or
    a fixed width (the rest are [N] node planes or scalars)."""
    s = MAX_SPREADS
    return {"dev_free": (n, MAX_DEV_REQS), "ask_dev": (MAX_DEV_REQS,),
            "step_penalty": (k, MAX_PENALTY_NODES), "step_preferred": (k,),
            "spread_active": (s,), "spread_even": (s,),
            "spread_weight": (s,), "spread_bucket": (s, n),
            "spread_counts": (s, SPREAD_BUCKETS),
            "spread_desired": (s, SPREAD_BUCKETS)}


def _joint_strides(kin: KernelIn, b: int, n: int, n_glob: int, k: int,
                   ctx: str = "") -> list:
    """The member stride of each leaf (``_JOINT_LEAVES`` order), its
    dtype, device, contiguity and shape checked: node planes hold ``n``
    rows (a mesh position's), ``node_perm`` all ``n_glob`` nodes; ``ctx``
    prefixes a refusal."""
    dev = kin.cap_cpu.device
    shapes = _joint_shapes(n, k)
    strides = []
    for name, dtype in _JOINT_LEAVES:
        x = getattr(kin, name)
        if x.dtype != dtype:
            raise ValueError(f"{ctx}{name} has dtype {x.dtype}; want "
                             f"{dtype}")
        stride = _member_stride(name, x, b, dev)
        want = (n_glob,) if name == "node_perm" else shapes.get(name)
        if want is None:
            want = (n,) if getattr(KIN_UNBATCHED_RANKS, name) == 1 else ()
        got = tuple(x.shape[1:] if stride else x.shape)
        if name != "n_steps" and got != want:
            raise ValueError(f"{ctx}{name} has shape {tuple(x.shape)}; "
                             f"want {want}, or a leading member axis of {b}")
        strides.append(stride)
    return strides


class _JointArgs(ctypes.Structure):
    """Mirror of ``struct JointArgs`` in csrc/joint_wave.cu."""

    _fields_ = [
        ("leaf", ctypes.c_void_p * len(_JOINT_LEAVES)),
        ("stride", ctypes.c_int64 * len(_JOINT_LEAVES)),
        ("step_member", ctypes.c_void_p),
        ("step_local", ctypes.c_void_p),
        ("packed", ctypes.c_void_p),
        ("topk_idx", ctypes.c_void_p),
        ("topk_scores", ctypes.c_void_p),
        ("a_cpu", ctypes.c_void_p),
        ("a_mem", ctypes.c_void_p),
        ("a_disk", ctypes.c_void_p),
        ("a_dyn", ctypes.c_void_p),
        ("a_cores", ctypes.c_void_p),
        ("a_mbits", ctypes.c_void_p),
        ("a_dev", ctypes.c_void_p),
        ("jtc", ctypes.c_void_p),
        ("jac", ctypes.c_void_p),
        ("pc", ctypes.c_void_p),
        ("spc", ctypes.c_void_p),
        ("n", ctypes.c_int), ("b", ctypes.c_int), ("t", ctypes.c_int),
        ("k", ctypes.c_int), ("p", ctypes.c_int), ("bp", ctypes.c_int),
        ("ns", ctypes.c_int),
        ("with_topk", ctypes.c_int), ("with_ports", ctypes.c_int),
        ("with_distinct", ctypes.c_int), ("with_step_pen", ctypes.c_int),
        ("with_pref", ctypes.c_int), ("with_shuffle", ctypes.c_int),
        ("with_devices", ctypes.c_int), ("with_cores", ctypes.c_int),
        ("with_network", ctypes.c_int), ("single", ctypes.c_int),
        ("rows", ctypes.c_void_p),
    ]


assert ctypes.sizeof(_JointArgs) == 896, "csrc/joint_node.cuh's JointArgs"


def joint_wave_place(kin: KernelIn, step_member, step_local, t_steps: int,
                     features: KernelFeatures) -> FusedWaveOut:
    """One joint wave under any feature union: stacked KernelIn of torch
    tensors + step maps -> FusedWaveOut, packed as a fused wave. CUDA
    tensors launch csrc/joint_wave.cu (or raise); CPU tensors run the
    plain version, ``fused_wave_place_reference``."""
    dev = kin.cap_cpu.device
    if dev.type == "cpu":
        return fused_wave_place_reference(kin, step_member, step_local,
                                          t_steps, features)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _joint_launch(kin, step_member, step_local, t_steps, features)


def joint_wave_apply(kin: KernelIn, used_cpu: torch.Tensor,
                     used_mem: torch.Tensor, used_disk: torch.Tensor,
                     step_member, step_local, t_steps: int,
                     features: KernelFeatures):
    """``fused_wave_apply`` through ``joint_wave_place``: the wave with
    the given shared used planes, and NEW tensors ``used_* + a_*``. A
    wave whose error word is set (``raise_on_wave_error``) commits
    nothing: the new tensors are the given planes, chosen on the device
    in stream order, so a wave queued behind it reads no partial
    carries."""
    kin2 = kin._replace(used_cpu=used_cpu, used_mem=used_mem,
                        used_disk=used_disk)
    out = joint_wave_place(kin2, step_member, step_local, t_steps, features)
    n = fused_pack_len(t_steps, int(kin.n_steps.shape[0]))
    if out.packed.shape[0] == n:   # the plain version: no error word
        return (out, used_cpu + out.a_cpu, used_mem + out.a_mem,
                used_disk + out.a_disk)
    ok = out.packed[n] == 0
    return (out, torch.where(ok, used_cpu + out.a_cpu, used_cpu),
            torch.where(ok, used_mem + out.a_mem, used_mem),
            torch.where(ok, used_disk + out.a_disk, used_disk))


def wave_kernel_out(got: FusedWaveOut, k_steps: int) -> KernelOut:
    """A one-member wave's FusedWaveOut as its eval's KernelOut, on its
    device: ``unpack_fused_wave``'s layout (chosen and scores over the
    steps, then the eight metrics, one each) read by slicing, so nothing
    comes back to the host."""
    packed = got.packed
    chosen = packed[:k_steps].to(torch.int32)
    metrics = packed[2 * k_steps:2 * k_steps + len(FUSED_METRIC_FIELDS)]
    return KernelOut(chosen, packed[k_steps:2 * k_steps], chosen >= 0,
                     got.topk_idx, got.topk_scores,
                     *metrics.to(torch.int32).unbind(0))


def joint_eval_place(kin: KernelIn, k_steps: int,
                     features: KernelFeatures) -> KernelOut:
    """One eval's ``k_steps`` placements under any feature union, as
    ``place_taskgroup`` places them: ``kin`` is one eval's planes (torch
    tensors, ``n_steps`` a scalar). On the card a one-member wave of
    csrc/joint_wave.cu whose f32 carries add each placement to the used
    planes in turn, the reference's order (or raise); on the CPU the plain
    version, ``place_taskgroup``. The KernelOut stays on the device."""
    if kin.n_steps.dim() != 0:
        raise ValueError("joint_eval_place takes one eval: n_steps must be "
                         "a scalar")
    dev = kin.cap_cpu.device
    if dev.type == "cpu":
        return place_taskgroup(kin, k_steps, features)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    one = kin._replace(n_steps=kin.n_steps.reshape(1))
    sm = torch.zeros(k_steps, dtype=torch.int32, device=dev)
    sl = torch.arange(k_steps, dtype=torch.int32, device=dev)
    got = _joint_launch(one, sm, sl, k_steps, features, single=True)
    if joint_plan(dev, int(kin.cap_cpu.shape[-1]), 1, features.with_shuffle,
                  int(features.n_spreads)).clusters > 1:
        # only waits between clusters can set the error word
        raise_on_wave_error(got.packed.cpu().numpy(), k_steps, 1)
    return wave_kernel_out(got, k_steps)


#: sizeof(CEntry) and sizeof(JEntry): one cluster's result for one step
_JOINT_ENTRY_BYTES = 96


def _joint_mail(clusters: int, b: int) -> int:
    """The joint wave's mailbox (``joint_mail_bytes``; the joint sharded
    wave's a card, ``jsw_mail_bytes``, with a participant a cluster of
    each card): each cluster's step entry by parity, then a tag, an error
    flag and the metric partial sums a cluster."""
    return (2 * clusters * _JOINT_ENTRY_BYTES
            + 4 * clusters * (2 + len(FUSED_METRIC_FIELDS) * b))


def _joint_cta_rows(n: int, clusters: int, shuffle: bool, ns: int) -> int:
    """A CTA's rows (``joint_cta_rows``): its node range rounded to four,
    13 B a node with shuffle (9 without) and a bucket byte a stanza."""
    ctas = clusters * JOINT_CLUSTER
    c4 = (-(-n // ctas) + 3) & ~3
    return c4 * 4 * (2 + int(bool(shuffle))) + c4 * (1 + ns)


class JointPlan(NamedTuple):
    """How one joint wave runs (``joint_clusters``)."""

    clusters: int      # clusters of JOINT_CLUSTER CTAs over the node axis
    smem: int          # dynamic shared memory a CTA takes
    global_rows: int   # the global-row scratch (0: rows in shared memory)
    spc: int           # f32 spread-count scratch (0: no stanza)
    mail: int          # the clusters' mailbox (0: one cluster)


def joint_layout(n: int, b: int, shuffle: bool, ns: int, limit: int,
                 clusters: int) -> JointPlan:
    """The joint wave's layout on ``clusters`` clusters: its CTAs' rows in
    shared memory where a CTA's range fits the ``limit`` a block may take,
    else in a global scratch (``kGlobal``); the scratch a CTA, the
    spread-count swap and the mailbox scale with clusters x 16.

    Mirrors csrc/joint_wave.cu's ``joint_wave_layout``: the plan must say
    where the rows live and what the scratch takes without a card, so the
    CPU tests (tests/test_torch_joint_plan.py) hold it over every width;
    ``test_cuda_joint_layout_mirrors_the_kernel`` holds this copy to the
    C side's."""
    member = b * (len(FUSED_METRIC_FIELDS) + 1) * 4
    rows = _joint_cta_rows(n, clusters, shuffle, ns)
    smem, global_rows = rows + member, 0
    if smem > limit:
        smem = member
        global_rows = clusters * JOINT_CLUSTER * ((rows + 15) & ~15)
        if smem > limit:
            raise RuntimeError(f"a joint wave of B={b} takes {smem} B of "
                               f"shared memory a CTA; the card gives "
                               f"{limit} B")
    spc = (clusters * JOINT_CLUSTER * b * MAX_SPREADS * SPREAD_BUCKETS
           if ns else 0)
    return JointPlan(clusters, smem, global_rows, spc,
                     _joint_mail(clusters, b) if clusters > 1 else 0)


def joint_clusters(n: int, b: int, shuffle: bool, ns: int, limit: int,
                   max_clusters: int) -> JointPlan:
    """The joint wave's plan from its widths and the card's figures (the
    shared memory a block may take, the clusters it holds at once): one
    cluster while its CTAs' ranges stay at or under ``JOINT_ROWS_CACHED``
    rows (``JOINT_ROWS_SPREAD`` with a spread stanza), so to N=65536
    (N=32768) and the live width, N=16384; past that every cluster the
    card holds at once, at most ``JOINT_MAX_CLUSTERS``. Then
    ``joint_layout``'s rows: in shared memory wherever those clusters
    hold them, past that in the global scratch."""
    if n >= 1 << 24:
        raise ValueError("node ids are packed as f32: N must stay below 2**24")
    cap = min(max_clusters, JOINT_MAX_CLUSTERS)
    if cap < 1:
        raise RuntimeError(f"the card holds no cluster of {JOINT_CLUSTER} "
                           f"CTAs of the joint wave")
    rows = JOINT_ROWS_SPREAD if ns else JOINT_ROWS_CACHED
    one = -(-n // JOINT_CLUSTER) <= rows
    return joint_layout(n, b, shuffle, ns, limit, 1 if one else cap)


_JOINT_CARDS: dict = {}   # device index -> (limit, clusters)


def _joint_card(dev: torch.device) -> tuple:
    """``joint_wave_plan`` on the card, once per device: (the shared
    memory a block may take, the clusters it holds at once)."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    card = _JOINT_CARDS.get(key)
    if card is None:
        load_library("joint_wave")
        lib = _LIBS["joint_wave"][2]
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = lib.joint_wave_plan(out)
        if err != 0:
            raise RuntimeError(f"joint_wave_plan failed: cudaError {err}")
        if (out[0], out[3]) != (JOINT_CLUSTER, JOINT_MAX_CLUSTERS):
            raise RuntimeError(f"csrc/joint_wave.cu runs clusters of {out[0]} "
                               f"CTAs, at most {out[3]}; the wrapper says "
                               f"{JOINT_CLUSTER}, {JOINT_MAX_CLUSTERS}")
        card = _JOINT_CARDS[key] = (out[1], out[2])
    return card


def joint_plan(dev: torch.device, n: int, b: int, shuffle: bool,
               ns: int) -> JointPlan:
    """The plan of a joint wave on card ``dev`` (``joint_clusters`` on
    the card's figures)."""
    return joint_clusters(n, b, shuffle, ns, *_joint_card(dev))


def fused_wave_fits(dev: torch.device, n: int, b: int,
                    shuffle: bool) -> bool:
    """Whether B1's cluster holds a wave of ``n`` nodes and ``b`` members
    in shared memory, by its plan on the card. A wave that does not fit
    runs the joint kernel, whose plan spreads it over several clusters
    (``joint_plan``). CPU tensors run the plain versions, which hold any
    width: B1's route."""
    if dev.type != "cuda":
        return True
    _, smem, limit, _ = _fused_plan(dev, n, b, shuffle)
    return smem <= limit


def joint_rows_global(dev: torch.device, n: int, b: int, shuffle: bool,
                      ns: int) -> bool:
    """Whether the joint kernel keeps a wave's rows in its global-row
    scratch (its CTAs' ranges do not fit shared memory even over the
    plan's clusters); never on CPU tensors."""
    return (dev.type == "cuda"
            and joint_plan(dev, n, b, shuffle, ns).global_rows > 0)


#: launches of the joint kernel's global-row instantiation (a wave or a
#: single eval too wide for its shared memory), counted with
#: ``joint_launches``
joint_global_calls = 0


class _JointLaunch(ctypes.Structure):
    """Mirror of ``struct JLaunch`` in csrc/joint_wave.cu."""

    _fields_ = [
        ("a", _JointArgs),
        ("mail", ctypes.c_void_p),
        ("spin_ns", ctypes.c_int64),
        ("clusters", ctypes.c_int),
        ("absent", ctypes.c_int),
    ]


def _joint_launch(kin: KernelIn, step_member, step_local, t_steps: int,
                  f: KernelFeatures, single: bool = False) -> FusedWaveOut:
    """One launch of csrc/joint_wave.cu over the plan's clusters. The
    packed buffer carries one error word after ``pack_fused_wave``'s
    layout (``raise_on_wave_error``): the clusters whose waits on another
    cluster ran past ``SPIN_S``."""
    global joint_launches, joint_global_calls
    dev = kin.cap_cpu.device
    b = int(kin.n_steps.shape[0])
    n = int(kin.cap_cpu.shape[-1])
    k = int(kin.step_preferred.shape[-1])
    ns = int(f.n_spreads)
    if not joint_wave_supported(f):
        raise ValueError(f"n_spreads={ns}: want 0..{MAX_SPREADS}")
    if n >= 1 << 24:
        raise ValueError("node ids are packed as f32: N must stay below 2**24")
    if single and b != 1:
        raise ValueError("a single eval is a one-member wave")
    sm = torch.as_tensor(step_member, dtype=torch.int32, device=dev)
    sl = torch.as_tensor(step_local, dtype=torch.int32, device=dev)
    if sm.shape != (t_steps,) or sl.shape != (t_steps,):
        raise ValueError("step_member/step_local must be i32[t_steps]")
    w = _JointLaunch()
    args = w.a
    for slot, stride in enumerate(_joint_strides(kin, b, n, n, k)):
        args.stride[slot] = stride
        args.leaf[slot] = getattr(kin, _JOINT_LEAVES[slot][0]).data_ptr()
    plan = joint_plan(dev, n, b, f.with_shuffle, ns)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = FusedWaveOut(
        # the packed layout, then the error word (raise_on_wave_error)
        packed=f32(fused_pack_len(t_steps, b) + 1),
        topk_idx=i32(t_steps, TOPK), topk_scores=f32(t_steps, TOPK),
        a_cpu=f32(n), a_mem=f32(n), a_disk=f32(n))
    scratch = dict(
        a_dyn=i32(n if f.with_ports else 1),
        a_cores=i32(n if f.with_cores else 1),
        a_mbits=i32(n if f.with_network else 1),
        a_dev=f32(n * MAX_DEV_REQS if f.with_devices else 1),
        jtc=i32(b, n),
        jac=i32(b, n) if f.with_distinct else i32(1),
        pc=(torch.empty((b, n), dtype=torch.bool, device=dev)
            if f.with_ports else i32(1)),
        spc=f32(max(plan.spc, 1)),
    )
    if plan.global_rows:
        # the global-row instantiation: every CTA's range of row keys,
        # ranks, partial sums, counts and buckets
        scratch["rows"] = torch.empty(plan.global_rows, dtype=torch.uint8,
                                      device=dev)
    mail = (torch.empty(plan.mail, dtype=torch.uint8, device=dev)
            if plan.mail else None)
    args.step_member = sm.data_ptr()
    args.step_local = sl.data_ptr()
    for name in FusedWaveOut._fields:
        setattr(args, name, getattr(out, name).data_ptr())
    for name, x in scratch.items():
        setattr(args, name, x.data_ptr())
    args.n, args.b, args.t, args.k = n, b, t_steps, k
    args.p, args.ns = MAX_PENALTY_NODES, ns
    args.bp = b if kin.node_perm.dim() == 2 else 1
    for name in ("with_topk", "with_ports", "with_distinct", "with_shuffle",
                 "with_devices", "with_cores", "with_network"):
        setattr(args, name, int(getattr(f, name)))
    args.with_step_pen = int(f.with_step_penalties)
    args.with_pref = int(f.with_preferred)
    args.single = int(single)
    w.mail = mail.data_ptr() if mail is not None else None
    w.spin_ns = int(SPIN_S * 1e9)
    w.clusters = plan.clusters
    w.absent = -1

    _call("joint_wave", w, dev, "joint_wave_kernel")
    with _LAUNCH_LOCK:
        joint_launches += 1
        joint_global_calls += int(plan.global_rows > 0)
    return out


# ---------------------------------------------------------------------------
# The fused wave over a mesh of node shards.
# ---------------------------------------------------------------------------

#: kernel calls made by ``sharded_wave_place``: one C call a wave, which
#: launches csrc/sharded_wave.cu's kernel once on every card of the mesh
#: (``sharded_kernel_launches`` counts those)
sharded_launches = 0

#: CTAs in the cluster that runs one card's share of a sharded wave
#: (CLUSTER in csrc/sharded_wave.cu)
SHARDED_CLUSTER = 16
#: the most cards, and mesh positions, one sharded wave spans (MAX_CARDS,
#: MAX_SHARDS)
MAX_SHARDED_CARDS = 8
MAX_POSITIONS = 64
_ENTRY_BYTES = 96         # sizeof(Entry): one card's result for one step

#: the node planes the kernel reads at the shard's own rows
_NODE_LEAVES = ("cap_cpu", "cap_mem", "cap_disk", "used_cpu", "used_mem",
                "used_disk", "aff_score", "free_dyn", "job_tg_count",
                "job_any_count", "base_mask", "port_conflict", "penalty")


class _Pos(ctypes.Structure):
    """Mirror of ``struct Pos`` in csrc/sharded_wave.cu: one mesh
    position's leaves (in ``_LEAVES`` order), carries and scratch."""

    _fields_ = [
        ("leaf", ctypes.c_void_p * _N_LEAVES),
        ("a_cpu", ctypes.c_void_p), ("a_mem", ctypes.c_void_p),
        ("a_disk", ctypes.c_void_p), ("a_dyn", ctypes.c_void_p),
        ("jtc", ctypes.c_void_p), ("jac", ctypes.c_void_p),
        ("pc", ctypes.c_void_p),
        ("g0", ctypes.c_int), ("pad", ctypes.c_int),
    ]


class _Shape(ctypes.Structure):
    """Mirror of ``struct Shape`` in csrc/sharded_wave.cu."""

    _fields_ = [
        ("stride", ctypes.c_int64 * _N_LEAVES),
        ("n_loc", ctypes.c_int), ("n_glob", ctypes.c_int),
        ("b", ctypes.c_int), ("k", ctypes.c_int), ("p", ctypes.c_int),
        ("bp", ctypes.c_int), ("t", ctypes.c_int),
        ("with_topk", ctypes.c_int), ("with_ports", ctypes.c_int),
        ("with_distinct", ctypes.c_int), ("with_step_pen", ctypes.c_int),
        ("with_pref", ctypes.c_int), ("with_shuffle", ctypes.c_int),
    ]


class _Card(ctypes.Structure):
    """Mirror of ``struct Card`` in csrc/sharded_wave.cu: one card of the
    mesh and its buffers."""

    _fields_ = [
        ("ordinal", ctypes.c_int), ("n_pos", ctypes.c_int),
        ("stream", ctypes.c_void_p), ("table", ctypes.c_void_p),
        ("mail", ctypes.c_void_p),
    ]


class _ShardedArgs(ctypes.Structure):
    """Mirror of ``struct ShardedArgs`` in csrc/sharded_wave.cu."""

    _fields_ = [
        ("s", _Shape), ("n_cards", ctypes.c_int), ("card", ctypes.c_void_p),
        ("packed", ctypes.c_void_p),
        ("topk_idx", ctypes.c_void_p), ("topk_scores", ctypes.c_void_p),
        ("spin_ns", ctypes.c_int64),
    ]


def _mail_bytes(n_cards: int, b: int) -> int:
    """A card's mailbox (``mail_bytes`` in csrc/sharded_wave.cu): every
    card's step entry by parity, then each card's metric tag, error flag
    and partial sums."""
    return 2 * n_cards * _ENTRY_BYTES + 4 * n_cards * (2 + 6 * b)


def sharded_smem_bytes(n_pos: int, n_loc: int, b: int,
                       shuffle: bool) -> int:
    """Dynamic shared memory each CTA of a card holding ``n_pos``
    positions of ``n_loc`` rows takes (``sharded_smem_bytes`` in
    csrc/sharded_wave.cu): the card's position table, its range's score
    keys (and shuffle ranks), and seven i32 a member."""
    chunk = -(-n_pos * n_loc // SHARDED_CLUSTER)
    return (n_pos * ctypes.sizeof(_Pos) + chunk * 4 * (2 if shuffle else 1)
            + b * 7 * 4)


def sharded_row_plan(g0s, n_loc: int, ctas: int = SHARDED_CLUSTER) -> list:
    """How the sharded kernels split one card's rows among its ``ctas``
    CTAs (the sharded kernel's one cluster; the joint sharded kernel's
    clusters x ``JOINT_CLUSTER``). ``g0s`` are the first global rows of
    the positions the card holds, ascending; card row r is row ``r %
    n_loc`` of position ``r // n_loc``. CTA c owns the card rows
    ``[c*chunk, (c+1)*chunk)``, walked one position segment at a time:
    returns, for each CTA, its segments ``(position index on the card,
    first row, end row, g0)``."""
    rows = len(g0s) * n_loc
    chunk = -(-rows // ctas)
    plan = []
    for c in range(ctas):
        lo = min(c * chunk, rows)
        hi = min(lo + chunk, rows)
        segs = []
        while lo < hi:
            lp = lo // n_loc
            end = min(hi, (lp + 1) * n_loc)
            segs.append((lp, lo - lp * n_loc, end - lp * n_loc, g0s[lp]))
            lo = end
        plan.append(segs)
    return plan


def check_sharded_plan(plan: tuple, rows: int, b: int) -> None:
    """Raise unless one card's cluster can hold its rows: ``plan`` is
    ``sharded_wave_plan``'s (cluster, shared memory a CTA needs, the most
    a block may take, clusters the card holds at once)."""
    cluster, smem, limit, clusters = plan
    if smem > limit:
        raise ValueError(
            f"{rows} rows on one card do not fit the sharded wave: each of "
            f"the {cluster} CTAs keeps {-(-rows // cluster)} rows' scores in "
            f"shared memory, {smem} B with B={b}, over the limit of {limit} "
            "B a block may take on this card")
    if clusters == 0:
        raise RuntimeError(f"the card runs no cluster of {cluster} CTAs with "
                           f"{smem} B of shared memory each")


#: (ordinal, n_pos, n_loc, b, shuffle) -> plan. Shared with no lock by a
#: warm pass on its own thread and live waves (ops/warmup.py): two
#: threads may both build one key's plan, which is the same tuple, and
#: both ask for peer access, which the C side takes as already enabled;
#: the C side enqueues one wave's launches on every card at a time
_SHARDED_PLANS: dict = {}


def _sharded_plan(ordinal: int, n_pos: int, n_loc: int, b: int,
                  shuffle: bool) -> tuple:
    """``sharded_wave_plan`` on card ``ordinal``, once per shape."""
    key = (ordinal, n_pos, n_loc, b, bool(shuffle))
    plan = _SHARDED_PLANS.get(key)
    if plan is None:
        load_library("sharded_wave")
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(ordinal):
            err = _LIBS["sharded_wave"][2].sharded_wave_plan(
                ctypes.c_int(n_pos), ctypes.c_int(n_loc), ctypes.c_int(b),
                ctypes.c_int(int(shuffle)), out)
        if err != 0:
            raise RuntimeError(f"sharded_wave_plan failed: cudaError {err}")
        if out[0] != SHARDED_CLUSTER:
            raise RuntimeError(f"csrc/sharded_wave.cu runs clusters of "
                               f"{out[0]} CTAs; SHARDED_CLUSTER says "
                               f"{SHARDED_CLUSTER}")
        plan = _SHARDED_PLANS[key] = tuple(out)
    return plan


_PEERS: set = set()        # card tuples whose pairs have peer access


def _enable_peers(ordinals: tuple) -> None:
    """Enable peer access between every pair of the mesh's cards, once;
    raise where a pair has none (the cards exchange each step's result
    through each other's memory)."""
    if len(ordinals) < 2 or ordinals in _PEERS:
        return
    load_library("sharded_wave")
    ords = (ctypes.c_int * len(ordinals))(*ordinals)
    bad = (ctypes.c_int * 2)()
    err = _LIBS["sharded_wave"][2].sharded_wave_enable_peers(
        ords, ctypes.c_int(len(ordinals)), bad)
    if err == -1:
        raise RuntimeError(
            f"cards {bad[0]} and {bad[1]} cannot access each other's memory "
            "(cudaDeviceCanAccessPeer is 0): a sharded wave over them needs "
            "peer access")
    if err != 0:
        raise RuntimeError(f"sharded_wave_enable_peers failed: cudaError "
                           f"{err}")
    _PEERS.add(ordinals)


def sharded_kernel_launches() -> int:
    """Kernel launches csrc/sharded_wave.cu has made in this process,
    every card's: one a card a wave."""
    load_library("sharded_wave")
    fn = _LIBS["sharded_wave"][2].sharded_wave_kernel_launches
    fn.restype = ctypes.c_ulonglong
    return int(fn())


def raise_on_wave_error(packed, t_steps: int, b: int) -> None:
    """Raise where a wave's packed buffer, read back, carries a set error
    word after ``pack_fused_wave``'s layout: the mask of the cards (a
    sharded wave) or of the clusters on one card (a joint wave) where a
    wait on another one's step ran past ``SPIN_S``. The plain versions'
    packed buffers have no such word."""
    n = fused_pack_len(t_steps, b)
    if len(packed) > n and packed[n] != 0:
        word = int(packed[n])
        at = [c for c in range(32) if word >> c & 1]
        raise RuntimeError(
            f"wave failed: a wait on another card's or cluster's step ran "
            f"past {SPIN_S} s (cards {at} of a sharded wave; of a joint "
            f"wave on one card, its clusters)")


def wave_active_steps(step_member, step_local, n_steps, t_steps: int,
                      k: int) -> list:
    """``[(t, m, j)]`` for each step of a wave that places: its member
    ``step_member[t]`` is not negative and its local step
    ``step_local[t]`` is below that member's ``n_steps``; ``m`` and ``j``
    are clamped to the member axis and the ``k`` steps. Every other step
    masks every node: its outputs are constants and it commits nothing."""
    counts = _as_host_ints(n_steps)
    b = len(counts)
    out = []
    for t, (member, j) in enumerate(zip(_as_host_ints(step_member)[:t_steps],
                                        _as_host_ints(step_local)[:t_steps])):
        m = min(max(member, 0), b - 1)
        if member >= 0 and j < counts[m]:
            out.append((t, m, min(max(j, 0), k - 1)))
    return out


def group_positions(cards) -> list:
    """Mesh positions grouped by the card each lies on: ``[(card,
    [positions])]`` in order of first appearance, so position 0's card
    (the root) comes first. A virtual mesh repeats one card."""
    groups: dict = {}
    for p, card in enumerate(cards):
        groups.setdefault(card, []).append(p)
    return list(groups.items())


def _host_i32(x, n: int) -> np.ndarray:
    """A step map (host array or CPU tensor) as contiguous i32 [n]."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    out = np.ascontiguousarray(np.asarray(x, dtype=np.int32)[:n])
    if out.shape != (n,):
        raise ValueError(f"a step map of shape {out.shape}; want ({n},)")
    return out


def _card_of(dev: torch.device) -> tuple:
    """``(ordinal, current stream handle)`` of a CUDA device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(torch.device("cuda",
                                                      idx)).cuda_stream


def sharded_wave_place_reference(shards, step_member, step_local,
                                 t_steps: int,
                                 features: KernelFeatures) -> FusedWaveOut:
    """The plain torch version: ``parallel/sharded._sharded_wave`` over the
    shards, packed; the carries stay lists, one tensor a shard."""
    from nomad_tpu_torch.parallel.sharded import _sharded_wave

    out = _sharded_wave(list(shards), step_member, step_local, t_steps,
                        features)
    b = int(out.nodes_evaluated.shape[0])
    return FusedWaveOut(
        packed=pack_fused_wave(out, t_steps, b),
        topk_idx=out.topk_idx, topk_scores=out.topk_scores,
        a_cpu=out.a_cpu, a_mem=out.a_mem, a_disk=out.a_disk)


def sharded_wave_place(shards, step_member, step_local, t_steps: int,
                       features: KernelFeatures) -> FusedWaveOut:
    """One fused wave over a mesh of node shards. ``shards[s]`` is a
    stacked KernelIn on mesh position s's device whose node planes hold
    the global rows ``[s * n_loc, (s + 1) * n_loc)`` (every other leaf
    whole); the step maps are host arrays. Returns a FusedWaveOut whose
    ``packed`` buffer and top-k planes lie on ``shards[0]``'s device and
    whose carries are lists, one tensor a shard on its device. CUDA shards
    run csrc/sharded_wave.cu in one C call, one cluster launch a card (or
    raise), its ``packed`` buffer one error word longer
    (``raise_on_wave_error``); CPU shards run the plain version."""
    _check_envelope(features)
    types = {s.cap_cpu.device.type for s in shards}
    if types == {"cpu"}:
        return sharded_wave_place_reference(shards, step_member, step_local,
                                            t_steps, features)
    if types != {"cuda"}:
        raise ValueError(f"shards on {sorted(types)}: want every shard on "
                         "the CPU or every shard on a CUDA card")
    return _sharded_launch(shards, step_member, step_local, t_steps,
                           features)


def _shard_strides(shards, b: int, n_loc: int, n_glob: int) -> list:
    """The member stride of each leaf, equal on every shard: shard 0's
    devices, dtypes, contiguity and node axes checked in full, every other
    shard's leaves against shard 0's (dtype, shape, device, contiguity)."""
    first = shards[0]
    dev = first.cap_cpu.device
    strides, want = [], []
    for name, dtype in _LEAVES:
        x = getattr(first, name)
        if x.dtype != dtype:
            raise ValueError(f"shard 0: {name} has dtype {x.dtype}; "
                             f"want {dtype}")
        strides.append(_member_stride(name, x, b, dev))
        want.append((x.dtype, x.shape))
    for name in _NODE_LEAVES:
        if getattr(first, name).shape[-1] != n_loc:
            raise ValueError(f"shard 0: {name} holds "
                             f"{getattr(first, name).shape[-1]} rows; "
                             f"want the shard's {n_loc}")
    if first.node_perm.shape[-1] != n_glob:
        raise ValueError(f"shard 0: node_perm must index all {n_glob} nodes")
    for s in range(1, len(shards)):
        kin = shards[s]
        dev = kin.cap_cpu.device
        for (name, _), (dtype, shape) in zip(_LEAVES, want):
            x = getattr(kin, name)
            if x.dtype != dtype or x.shape != shape:
                raise ValueError(
                    f"shard {s}: {name} is {x.dtype} {tuple(x.shape)}; "
                    f"shard 0's is {dtype} {tuple(shape)}")
            if x.device != dev or not x.is_contiguous():
                raise ValueError(f"shard {s}: {name} must be contiguous on "
                                 f"the shard's {dev}")
    return strides


def _sharded_launch(shards, step_member, step_local, t_steps: int,
                    f: KernelFeatures) -> FusedWaveOut:
    global sharded_launches
    first = shards[0]
    n_shards = len(shards)
    b = int(first.n_steps.shape[0])
    n_loc = int(first.cap_cpu.shape[-1])
    n_glob = n_loc * n_shards
    k = int(first.step_preferred.shape[-1])
    if n_glob >= 1 << 24:
        raise ValueError("node ids are packed as f32: N must stay below 2**24")
    if n_loc < TOPK:
        raise ValueError(f"a shard of {n_loc} rows is under the top-{TOPK} "
                         "merge's floor")
    if n_shards > MAX_POSITIONS:
        raise ValueError(f"a mesh of {n_shards} positions: the sharded wave "
                         f"takes at most {MAX_POSITIONS}")
    if first.step_penalty.shape[-1] != MAX_PENALTY_NODES:
        raise ValueError("step_penalty must be [.., K, MAX_PENALTY_NODES]")
    strides = _shard_strides(shards, b, n_loc, n_glob)
    # the step maps as the kernel reads them after a card's position
    # table: it finds the active steps itself (``wave_active_steps``'s
    # rule), so nothing is read back from the card before the launch
    maps = np.stack([_host_i32(step_member, t_steps),
                     _host_i32(step_local, t_steps)])
    root = first.cap_cpu.device
    cards = [_card_of(s.cap_cpu.device) for s in shards]
    groups = group_positions([c[0] for c in cards])
    if len(groups) > MAX_SHARDED_CARDS:
        raise ValueError(f"a mesh over {len(groups)} cards: the sharded "
                         f"wave spans at most {MAX_SHARDED_CARDS}")
    for ordinal, positions in groups:
        check_sharded_plan(_sharded_plan(ordinal, len(positions), n_loc, b,
                                         f.with_shuffle),
                           len(positions) * n_loc, b)
    multi = len(groups) > 1
    if multi:
        _enable_peers(tuple(ordinal for ordinal, _ in groups))
    bp = b if first.node_perm.dim() == 2 else 1

    def buf(n, dtype, dev):
        return torch.empty(max(n, 1), dtype=dtype, device=dev)

    out = FusedWaveOut(
        # the packed layout, then the error word (raise_on_wave_error)
        packed=buf(fused_pack_len(t_steps, b) + 1, torch.float32, root),
        topk_idx=torch.empty((t_steps, TOPK), dtype=torch.int32,
                             device=root),
        topk_scores=torch.empty((t_steps, TOPK), dtype=torch.float32,
                                device=root),
        a_cpu=[None] * n_shards, a_mem=[None] * n_shards,
        a_disk=[None] * n_shards)
    keep = []       # every buffer the call reads or writes
    rows = (_Card * len(groups))()
    for c, (ordinal, positions) in enumerate(groups):
        dev = shards[positions[0]].cap_cpu.device
        n_pos = len(positions)
        table = (_Pos * n_pos)()
        # one buffer a card for each carry and scratch, a slice a position
        carry = torch.empty((3, n_pos, n_loc), dtype=torch.float32,
                            device=dev)
        rows_b = b * n_loc
        ports, distinct = int(f.with_ports), int(f.with_distinct)
        scratch = dict(     # name: (buffer, bytes a position; 0: unused)
            a_dyn=(buf(ports * n_pos * n_loc, torch.int32, dev),
                   ports * 4 * n_loc),
            jtc=(buf(n_pos * rows_b, torch.int32, dev), 4 * rows_b),
            jac=(buf(distinct * n_pos * rows_b, torch.int32, dev),
                 distinct * 4 * rows_b),
            pc=(buf(ports * n_pos * rows_b, torch.uint8, dev),
                ports * rows_b))
        keep.append(carry)
        keep += [x for x, _ in scratch.values()]
        for lp, p in enumerate(positions):
            kin, row = shards[p], table[lp]
            for slot, (name, _) in enumerate(_LEAVES):
                row.leaf[slot] = getattr(kin, name).data_ptr()
            for q, name in enumerate(("a_cpu", "a_mem", "a_disk")):
                getattr(out, name)[p] = x = carry[q, lp]
                setattr(row, name, x.data_ptr())
            for name, (x, step) in scratch.items():
                setattr(row, name, x.data_ptr() + lp * step)
            row.g0 = p * n_loc
        # the table and the step maps go up from pinned memory on the
        # card's current stream (a copy, not a launch)
        staged = torch.empty(ctypes.sizeof(table) + maps.nbytes,
                             dtype=torch.uint8, pin_memory=dev.type == "cuda")
        ctypes.memmove(staged.data_ptr(), ctypes.addressof(table),
                       ctypes.sizeof(table))
        ctypes.memmove(staged.data_ptr() + ctypes.sizeof(table),
                       maps.ctypes.data, maps.nbytes)
        dev_table = staged.to(dev, non_blocking=True)
        mail = (buf(_mail_bytes(len(groups), b), torch.uint8, dev)
                if multi else None)
        keep += [dev_table, mail]
        rows[c] = _Card(ordinal, n_pos, cards[positions[0]][1],
                        dev_table.data_ptr(),
                        mail.data_ptr() if multi else None)

    args = _ShardedArgs()
    s = args.s
    for slot, stride in enumerate(strides):
        s.stride[slot] = stride
    s.n_loc, s.n_glob, s.b, s.k, s.p = n_loc, n_glob, b, k, MAX_PENALTY_NODES
    s.bp, s.t = bp, t_steps
    s.with_topk = int(f.with_topk)
    s.with_ports = int(f.with_ports)
    s.with_distinct = int(f.with_distinct)
    s.with_step_pen = int(f.with_step_penalties)
    s.with_pref = int(f.with_preferred)
    s.with_shuffle = int(f.with_shuffle)
    args.n_cards = len(groups)
    args.card = ctypes.addressof(rows)
    for name in ("packed", "topk_idx", "topk_scores"):
        setattr(args, name, getattr(out, name).data_ptr())
    args.spin_ns = int(SPIN_S * 1e9)

    load_library("sharded_wave")
    err = _LIBS["sharded_wave"][0](ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"sharded_wave launch failed: cudaError {err}")
    with _LAUNCH_LOCK:
        sharded_launches += 1
    # buffers freed here are reused only by work queued later on their
    # card's stream; over several cards the C call has made that stream
    # wait on the end of every card's kernel (also where it failed after
    # launching on some), so a mailbox has taken its last peer store
    return out


# ---------------------------------------------------------------------------
# The joint wave over a mesh of node shards.
# ---------------------------------------------------------------------------

#: kernel calls made by ``joint_sharded_wave_place``: one C call a wave,
#: which launches csrc/joint_sharded_wave.cu's kernel once on every card of
#: the mesh (``joint_sharded_kernel_launches`` counts those); of them
#: ``joint_sharded_global_calls`` ran its global-row instantiation
joint_sharded_launches = 0
joint_sharded_global_calls = 0

#: the most participants (cards x clusters a card) that trade one joint
#: sharded wave's steps (MAX_PARTS in csrc/joint_sharded_wave.cu: one lane
#: of the polling warp each)
JOINT_SHARDED_MAX_PARTS = 32
#: the rows a CTA of one cluster a card keeps before the joint sharded
#: wave takes every cluster the card holds, with no spread stanza and with
#: one (``joint_clusters``' switch points, for this kernel)
JOINT_SHARDED_ROWS_CACHED = 4096
JOINT_SHARDED_ROWS_SPREAD = 2048


class _JCard(ctypes.Structure):
    """Mirror of ``struct JCard`` in csrc/joint_sharded_wave.cu."""

    _fields_ = [
        ("ordinal", ctypes.c_int), ("n_pos", ctypes.c_int),
        ("stream", ctypes.c_void_p), ("table", ctypes.c_void_p),
        ("mail", ctypes.c_void_p), ("spc", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
    ]


class _JShardedArgs(ctypes.Structure):
    """Mirror of ``struct JShardedArgs`` in csrc/joint_sharded_wave.cu."""

    _fields_ = [
        ("n_glob", ctypes.c_int), ("n_loc", ctypes.c_int),
        ("n_cards", ctypes.c_int), ("b", ctypes.c_int), ("t", ctypes.c_int),
        ("p", ctypes.c_int), ("ns", ctypes.c_int),
        ("with_shuffle", ctypes.c_int), ("clusters", ctypes.c_int),
        ("absent", ctypes.c_int),
        ("card", ctypes.c_void_p), ("packed", ctypes.c_void_p),
        ("topk_idx", ctypes.c_void_p), ("topk_scores", ctypes.c_void_p),
        ("spin_ns", ctypes.c_int64),
    ]


def joint_sharded_layout(rows: int, b: int, shuffle: bool, ns: int,
                         limit: int, clusters: int,
                         n_cards: int) -> JointPlan:
    """The joint sharded wave's layout on each card of ``rows`` rows as
    ``clusters`` clusters: ``joint_layout``'s rows, counts scratch and
    global-row scratch over the card's rows (the kernel's CTAs own card
    rows as the joint kernel's own nodes), and a mailbox a card with a
    slot for each of the wave's ``n_cards * clusters`` participants,
    ``_joint_mail``'s layout (0: one participant, no exchange). Mirrors csrc/joint_sharded_wave.cu's
    ``joint_sharded_layout``
    (``test_cuda_joint_sharded_layout_mirrors_the_kernel``)."""
    parts = n_cards * clusters
    return joint_layout(rows, b, shuffle, ns, limit, clusters)._replace(
        mail=_joint_mail(parts, b) if parts > 1 else 0)


def joint_sharded_clusters(rows: int, b: int, shuffle: bool, ns: int,
                           limit: int, most: int,
                           n_cards: int) -> JointPlan:
    """The joint sharded wave's plan, the same on every card, from the
    most rows a card holds, the wave's widths and the cards' figures (the
    shared memory a block may take, the clusters each holds at once): one
    cluster a card while its CTAs' ranges stay at or under
    ``JOINT_SHARDED_ROWS_CACHED`` rows (``JOINT_SHARDED_ROWS_SPREAD`` with
    a spread stanza), past that every cluster a card holds, at most
    ``JOINT_MAX_CLUSTERS`` and at most ``JOINT_SHARDED_MAX_PARTS`` over
    the cards (a mesh of five cards or more takes fewer a card). Then
    ``joint_sharded_layout``: the rows in shared memory wherever those
    clusters hold them, past that in the global scratch."""
    cap = min(most, JOINT_MAX_CLUSTERS, JOINT_SHARDED_MAX_PARTS // n_cards)
    if cap < 1:
        raise RuntimeError(f"the cards hold no cluster of {JOINT_CLUSTER} "
                           f"CTAs of the joint sharded wave")
    per_cta = JOINT_SHARDED_ROWS_SPREAD if ns else JOINT_SHARDED_ROWS_CACHED
    one = -(-rows // JOINT_CLUSTER) <= per_cta
    return joint_sharded_layout(rows, b, shuffle, ns, limit,
                                1 if one else cap, n_cards)


_JOINT_SHARDED_CARDS: dict = {}   # ordinal -> (limit, clusters)


def _joint_sharded_card(ordinal: int) -> tuple:
    """``joint_sharded_wave_plan`` on card ``ordinal``, once: (the shared
    memory a block may take, the clusters it holds at once). The first
    call also holds the library's struct sizes and bounds against their
    mirrors."""
    card = _JOINT_SHARDED_CARDS.get(ordinal)
    if card is None:
        load_library("joint_sharded_wave")
        lib = _LIBS["joint_sharded_wave"][2]
        sizes = (ctypes.c_int * 4)()
        lib.joint_sharded_sizes(sizes)
        want = (ctypes.sizeof(_JointArgs), ctypes.sizeof(_JCard),
                ctypes.sizeof(_JShardedArgs), _JOINT_ENTRY_BYTES)
        if tuple(sizes) != want:
            raise RuntimeError(f"csrc/joint_sharded_wave.cu's structs are "
                               f"{tuple(sizes)} B; their mirrors {want}")
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(ordinal):
            err = lib.joint_sharded_wave_plan(out)
        if err != 0:
            raise RuntimeError(f"joint_sharded_wave_plan failed: cudaError "
                               f"{err}")
        bounds = (JOINT_CLUSTER, JOINT_MAX_CLUSTERS, JOINT_SHARDED_MAX_PARTS)
        if (out[0], out[3], out[4]) != bounds:
            raise RuntimeError(f"csrc/joint_sharded_wave.cu runs clusters "
                               f"of {out[0]} CTAs, at most {out[3]} a card "
                               f"and {out[4]} a wave; the wrapper says "
                               f"{bounds}")
        card = _JOINT_SHARDED_CARDS[ordinal] = (out[1], out[2])
    return card


def joint_sharded_plan(ordinals, rows: int, b: int, shuffle: bool,
                       ns: int) -> JointPlan:
    """The plan of a joint sharded wave over the cards ``ordinals`` whose
    largest share is ``rows`` rows (``joint_sharded_clusters`` on the
    smallest of the cards' figures)."""
    figures = [_joint_sharded_card(o) for o in ordinals]
    return joint_sharded_clusters(rows, b, shuffle, ns,
                                  min(f[0] for f in figures),
                                  min(f[1] for f in figures), len(ordinals))


def joint_sharded_plan_of(shards, features: KernelFeatures) -> JointPlan:
    """``joint_sharded_plan`` of a wave over ``shards`` (CUDA KernelIns,
    one a mesh position), as the wrapper launches it."""
    return _groups_plan(
        group_positions([_card_of(s.cap_cpu.device)[0] for s in shards]),
        shards[0], features)


def _groups_plan(groups, first: KernelIn, f: KernelFeatures) -> JointPlan:
    """The plan over the cards of ``groups`` (``group_positions``), whose
    largest holds that many positions of ``first``'s rows."""
    rows = max(len(positions) for _, positions in groups) * int(
        first.cap_cpu.shape[-1])
    return joint_sharded_plan([ordinal for ordinal, _ in groups], rows,
                              int(first.n_steps.shape[0]), f.with_shuffle,
                              int(f.n_spreads))


def sharded_wave_fits(devices, n_loc: int, b: int, shuffle: bool) -> bool:
    """Whether the sharded kernel holds a wave of ``b`` members over the
    mesh positions on ``devices`` (``n_loc`` rows each): every card's
    rows fit one cluster's shared memory by its plan on that card
    (``check_sharded_plan``'s test). A wave that does not fit runs the
    joint sharded kernel, whose plan spreads a card's rows over several
    clusters or a global scratch (``joint_sharded_plan``). CPU shards run
    the plain versions, which hold any width: the sharded kernel's
    route."""
    devices = list(devices)
    if any(d.type != "cuda" for d in devices):
        return True
    for ordinal, positions in group_positions(
            [_card_of(d)[0] for d in devices]):
        _, smem, limit, _ = _sharded_plan(ordinal, len(positions), n_loc, b,
                                          shuffle)
        if smem > limit:
            return False
    return True


def joint_sharded_kernel_launches() -> int:
    """Kernel launches csrc/joint_sharded_wave.cu has made in this
    process, every card's: one a card a wave."""
    load_library("joint_sharded_wave")
    fn = _LIBS["joint_sharded_wave"][2].joint_sharded_wave_kernel_launches
    fn.restype = ctypes.c_ulonglong
    return int(fn())


#: the plain torch version of ``joint_sharded_wave_place``: the body of
#: ``sharded_wave_place_reference`` takes any feature union
joint_sharded_wave_place_reference = sharded_wave_place_reference


def joint_sharded_wave_place(shards, step_member, step_local, t_steps: int,
                             features: KernelFeatures) -> FusedWaveOut:
    """One joint wave over a mesh of node shards under any feature union
    (spreads, devices, reserved cores, bandwidth), laid out as for
    ``sharded_wave_place``: ``shards[s]`` a stacked KernelIn on position
    s's device whose node planes (``spread_bucket`` and ``dev_free``
    included) hold the global rows ``[s * n_loc, (s + 1) * n_loc)``; the
    step maps host arrays. Returns a FusedWaveOut whose ``packed`` buffer
    (one error word longer on the card, ``raise_on_wave_error``) and top-k
    planes lie on ``shards[0]``'s device and whose carries are lists, one
    tensor a shard on its device. CUDA shards run
    csrc/joint_sharded_wave.cu in one C call, one launch a card of the
    clusters ``joint_sharded_plan`` picks (or raise); CPU shards run the
    plain version."""
    if not joint_wave_supported(features):
        raise ValueError(f"n_spreads={features.n_spreads}: want "
                         f"0..{MAX_SPREADS}")
    types = {s.cap_cpu.device.type for s in shards}
    if types == {"cpu"}:
        return joint_sharded_wave_place_reference(
            shards, step_member, step_local, t_steps, features)
    if types != {"cuda"}:
        raise ValueError(f"shards on {sorted(types)}: want every shard on "
                         "the CPU or every shard on a CUDA card")
    return _joint_sharded_launch(shards, step_member, step_local, t_steps,
                                 features)


def _joint_shard_strides(shards, b: int, n_loc: int, n_glob: int,
                         k: int) -> list:
    """The member stride of each leaf, equal on every shard: shard 0's
    leaves checked in full (``_joint_strides``), every other shard's
    against shard 0's (dtype, shape) and its own device and contiguity,
    so a wave's check costs one shard's and a comparison a leaf more."""
    strides = _joint_strides(shards[0], b, n_loc, n_glob, k, "shard 0: ")
    want = [(getattr(shards[0], name).dtype, getattr(shards[0], name).shape)
            for name, _ in _JOINT_LEAVES]
    for i in range(1, len(shards)):
        dev = shards[i].cap_cpu.device
        for (name, _), (dtype, shape) in zip(_JOINT_LEAVES, want):
            x = getattr(shards[i], name)
            if x.dtype != dtype or x.shape != shape:
                raise ValueError(
                    f"shard {i}: {name} is {x.dtype} {tuple(x.shape)}; "
                    f"shard 0's is {dtype} {tuple(shape)}")
            if x.device != dev or not x.is_contiguous():
                raise ValueError(f"shard {i}: {name} must be contiguous on "
                                 f"the shard's {dev}")
    return strides


def _joint_sharded_launch(shards, step_member, step_local, t_steps: int,
                          f: KernelFeatures) -> FusedWaveOut:
    global joint_sharded_launches, joint_sharded_global_calls
    first = shards[0]
    n_shards = len(shards)
    b = int(first.n_steps.shape[0])
    n_loc = int(first.cap_cpu.shape[-1])
    n_glob = n_loc * n_shards
    k = int(first.step_preferred.shape[-1])
    ns = int(f.n_spreads)
    if n_glob >= 1 << 24:
        raise ValueError("node ids are packed as f32: N must stay below 2**24")
    if n_shards > MAX_POSITIONS:
        raise ValueError(f"a mesh of {n_shards} positions: the joint sharded "
                         f"wave takes at most {MAX_POSITIONS}")
    strides = _joint_shard_strides(shards, b, n_loc, n_glob, k)
    maps = np.stack([_host_i32(step_member, t_steps),
                     _host_i32(step_local, t_steps)])
    root = first.cap_cpu.device
    cards = [_card_of(s.cap_cpu.device) for s in shards]
    groups = group_positions([c[0] for c in cards])
    if len(groups) > MAX_SHARDED_CARDS:
        raise ValueError(f"a mesh over {len(groups)} cards: the joint "
                         f"sharded wave spans at most {MAX_SHARDED_CARDS}")
    plan = _groups_plan(groups, first, f)
    multi = len(groups) > 1
    if multi:
        _enable_peers(tuple(ordinal for ordinal, _ in groups))
    bp = b if first.node_perm.dim() == 2 else 1

    def buf(n, dtype, dev):
        return torch.empty(max(n, 1), dtype=dtype, device=dev)

    out = FusedWaveOut(
        # the packed layout, then the error word (raise_on_wave_error)
        packed=buf(fused_pack_len(t_steps, b) + 1, torch.float32, root),
        topk_idx=torch.empty((t_steps, TOPK), dtype=torch.int32,
                             device=root),
        topk_scores=torch.empty((t_steps, TOPK), dtype=torch.float32,
                                device=root),
        a_cpu=[None] * n_shards, a_mem=[None] * n_shards,
        a_disk=[None] * n_shards)
    flags = dict(with_topk=f.with_topk, with_ports=f.with_ports,
                 with_distinct=f.with_distinct,
                 with_step_pen=f.with_step_penalties,
                 with_pref=f.with_preferred, with_shuffle=f.with_shuffle,
                 with_devices=f.with_devices, with_cores=f.with_cores,
                 with_network=f.with_network)
    keep = []       # every buffer the call reads or writes
    rows = (_JCard * len(groups))()
    for c, (ordinal, positions) in enumerate(groups):
        dev = shards[positions[0]].cap_cpu.device
        n_pos = len(positions)
        table = (_JointArgs * n_pos)()
        # one buffer a card for each carry and scratch, a slice a position
        carry = torch.empty((3, n_pos, n_loc), dtype=torch.float32,
                            device=dev)
        rows_b = b * n_loc

        def per_pos(on, count, dtype, size):
            # (buffer, bytes a position; 0: unused)
            return (buf(on * n_pos * count, dtype, dev), on * size * count)

        scratch = dict(
            a_dyn=per_pos(f.with_ports, n_loc, torch.int32, 4),
            a_cores=per_pos(f.with_cores, n_loc, torch.int32, 4),
            a_mbits=per_pos(f.with_network, n_loc, torch.int32, 4),
            a_dev=per_pos(f.with_devices, n_loc * MAX_DEV_REQS,
                          torch.float32, 4),
            jtc=per_pos(1, rows_b, torch.int32, 4),
            jac=per_pos(f.with_distinct, rows_b, torch.int32, 4),
            pc=per_pos(f.with_ports, rows_b, torch.uint8, 1))
        # the plan's counts scratch, global-row scratch and mailbox a card
        spc = buf(plan.spc, torch.float32, dev) if plan.spc else None
        grows = (buf(plan.global_rows, torch.uint8, dev)
                 if plan.global_rows else None)
        mail = buf(plan.mail, torch.uint8, dev) if plan.mail else None
        keep += [carry, spc, grows, mail] + [x for x, _ in scratch.values()]
        g0s = np.full(MAX_POSITIONS, -1, dtype=np.int32)
        for lp, p in enumerate(positions):
            kin, row = shards[p], table[lp]
            for slot, (name, _) in enumerate(_JOINT_LEAVES):
                row.leaf[slot] = getattr(kin, name).data_ptr()
                row.stride[slot] = strides[slot]
            for q, name in enumerate(("a_cpu", "a_mem", "a_disk")):
                getattr(out, name)[p] = x = carry[q, lp]
                setattr(row, name, x.data_ptr())
            for name, (x, step) in scratch.items():
                setattr(row, name, x.data_ptr() + lp * step)
            row.n, row.b, row.t, row.k = n_loc, b, t_steps, k
            row.p, row.bp, row.ns = MAX_PENALTY_NODES, bp, ns
            for name, on in flags.items():
                setattr(row, name, int(on))
            g0s[lp] = p * n_loc
        # the table, the first global rows and the step maps go up from
        # pinned memory on the card's current stream (a copy, not a launch)
        parts = [bytes(table), g0s.tobytes(), maps.tobytes()]
        staged = torch.empty(sum(len(x) for x in parts), dtype=torch.uint8,
                             pin_memory=dev.type == "cuda")
        at = 0
        for x in parts:
            ctypes.memmove(staged.data_ptr() + at, x, len(x))
            at += len(x)
        dev_table = staged.to(dev, non_blocking=True)
        keep.append(dev_table)
        rows[c] = _JCard(ordinal, n_pos, cards[positions[0]][1],
                         dev_table.data_ptr(),
                         *[x.data_ptr() if x is not None else None
                           for x in (mail, spc, grows)])

    args = _JShardedArgs()
    args.n_glob, args.n_loc, args.n_cards = n_glob, n_loc, len(groups)
    args.b, args.t, args.p, args.ns = b, t_steps, MAX_PENALTY_NODES, ns
    args.with_shuffle = int(f.with_shuffle)
    args.clusters, args.absent = plan.clusters, -1
    args.card = ctypes.addressof(rows)
    for name in ("packed", "topk_idx", "topk_scores"):
        setattr(args, name, getattr(out, name).data_ptr())
    args.spin_ns = int(SPIN_S * 1e9)

    load_library("joint_sharded_wave")
    err = _LIBS["joint_sharded_wave"][0](ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"joint_sharded_wave launch failed: cudaError "
                           f"{err}")
    with _LAUNCH_LOCK:
        joint_sharded_launches += 1
        joint_sharded_global_calls += int(plan.global_rows > 0)
    # buffers freed here are reused only by work queued later on their
    # card's stream; over several cards the C call has made that stream
    # wait on the end of every card's kernel (join_cards)
    return out


# ---------------------------------------------------------------------------
# B3 and B2: lean batch placement against one shared snapshot.
# ---------------------------------------------------------------------------

#: CUDA kernel launches made by ``place_batch`` (B3) and
#: ``topk_place_batch`` (B2)
place_batch_launches = 0
topk_place_batch_launches = 0

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


def pass_scores(v: dict) -> torch.Tensor:
    """The masked score of every (eval, node), f32[B, N], in the
    full-width pass's operation order (pallas_kernel.py :410-433;
    csrc/lean_score.cuh ``lean_pass_score``): the affinity and the
    penalty are added one at a time, where the scans add their sum."""
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
    return torch.where(feas, ssum / nplanes, NEG_INF)


def candidate_pass(v: dict, k_cand: int):
    """The full-width pass of ``pallas_topk_place_batch`` (:410-437) in
    torch ops, the plain version of the kernel's first half: the
    ``k_cand`` best nodes per eval by ``pass_scores``, ordered by (score
    desc, node asc) as i32 [B, k_cand], and the exact best score outside
    them, f32[B] (NEG_INF when no node is outside)."""
    masked0 = pass_scores(v)
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


def _candidates(lean: tuple, k_steps: int, k_cand: int):
    v = _lean_inputs(lean, k_steps)
    return v, min(k_cand, int(v["cap_cpu"].shape[0]), MAX_K)


def topk_place_batch(*lean, k_steps: int, k_cand: int = 64):
    """Candidate-set placement for B lean evals
    (``pallas_topk_place_batch`` without ``interpret``): the full-width
    pass to min(k_cand, N, 128) candidates and the exact rest max, then
    the K-step scan; on the card one launch of csrc/topk_place_batch.cu
    (or raise), on the CPU its plain version. Returns ``(chosen i32[B,K]
    node rows, scores f32[B,K], found bool[B,K], valid bool[B])``;
    ``valid=False`` rows must re-run through the full-width path."""
    global topk_place_batch_launches
    v, kc = _candidates(lean, k_steps, k_cand)
    dev = v["cap_cpu"].device
    if dev.type == "cpu":
        return cand_scan_reference(*candidate_pass(v, kc), v, k_steps)
    n = int(v["cap_cpu"].shape[0])
    b = int(v["ask_cpu"].shape[0])
    out = (torch.empty((b, k_steps), dtype=torch.int32, device=dev),
           torch.empty((b, k_steps), dtype=torch.float32, device=dev),
           torch.empty((b, k_steps), dtype=torch.bool, device=dev),
           torch.empty((b,), dtype=torch.bool, device=dev))
    if b == 0:
        return out
    args = _TopkArgs()
    _fill_lean(args, v)
    for name, x in zip(("chosen", "scores", "found", "valid"), out):
        setattr(args, name, x.data_ptr())
    args.n, args.b, args.k, args.kc = n, b, k_steps, kc
    _call("topk_place_batch", args, dev, "topk_place_batch_kernel")
    with _LAUNCH_LOCK:
        topk_place_batch_launches += 1
    return out


def topk_place_batch_reference(*lean, k_steps: int, k_cand: int = 64):
    """The plain torch version of ``topk_place_batch``: the full-width
    ``candidate_pass``, then ``cand_scan_reference``."""
    v, kc = _candidates(lean, k_steps, k_cand)
    return cand_scan_reference(*candidate_pass(v, kc), v, k_steps)


_LEAN_FIELDS = [(name, ctypes.c_void_p) for name, _ in LEAN_ARGS]


class _PlaceArgs(ctypes.Structure):
    """Mirror of ``struct PlaceArgs`` in csrc/place_batch.cu."""

    _fields_ = _LEAN_FIELDS + [
        ("chosen", ctypes.c_void_p), ("scores", ctypes.c_void_p),
        ("found", ctypes.c_void_p),
        ("n", ctypes.c_int), ("b", ctypes.c_int), ("k", ctypes.c_int),
    ]


class _TopkArgs(ctypes.Structure):
    """Mirror of ``struct TopkArgs`` in csrc/topk_place_batch.cu."""

    _fields_ = _LEAN_FIELDS + [
        ("chosen", ctypes.c_void_p), ("scores", ctypes.c_void_p),
        ("found", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("n", ctypes.c_int), ("b", ctypes.c_int), ("k", ctypes.c_int),
        ("kc", ctypes.c_int),
    ]


def _fill_lean(args, v: dict) -> None:
    for name, _ in LEAN_ARGS:
        setattr(args, name, v[name].data_ptr())
