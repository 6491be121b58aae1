"""Cross-eval kernel-launch coalescing: one device launch per wave.

Counterpart of ``nomad_tpu/parallel/coalesce.py``. A worker runs B
evaluations concurrently, each on its own thread against one shared
snapshot. When an eval reaches its placement launch it parks here; once
every still-running eval of the batch is parked (or finished, or its
adaptive deadline expired) the wave fires as ONE device call and each
thread resumes with its slice of the output.

Batching is exact: ``KernelIn`` always carries every plane and
``KernelFeatures`` only selects which planes the computation reads. A
wave runs the union of its members' features; members that did not ask
for a feature carry neutral planes, which the kernel defines as no-ops.

``ClusterCache`` hands the evals of a batch one ``ClusterTensors`` per
snapshot structure (an identity hit, or a dirty-row delta build) and
requests that snapshot's wave-shared planes resident on its device
(``tensors/device_state``); the wave launcher advances them before it
assembles a wave, then finds every shared leaf resident on the wave's
device and uploads nothing for it.

A batching worker wraps each eval's plan submission in the coalescer's
``plan_window()``: the eval yields its rendezvous slot while it waits on
the plan applier, so the next wave fires without it. A fired wave arms
the plan queue's drain window (``wave_cohorts.note_wave``) before its
members resume, so the wave's plans commit as one entry.

Where several processes place against one store (the worker processes of
``server/workerproc``), a coalescer may be given a placement turn: a
wave takes it before it launches and reads the newest committed usage
the turn hands it, and the turn is given back once every member of the
wave has submitted its plan (or finished). Waves of different processes
then never place against each other's uncommitted capacity.

A wave given a device mesh (``mesh=``; a coalescer passes its server's
``Server.wave_mesh``) runs with its node axis split over the mesh's devices
(``parallel/sharded``): the fused sharded wave (on the card, the hand
kernel ``csrc/sharded_wave.cu``) when the union is in the fused envelope,
each shard holds at least TOPK rows and each card's rows fit its cluster
(``sharded_kernel_fits``), else the joint sharded wave (on the card, the
hand kernel ``csrc/joint_sharded_wave.cu``, any union and any width),
counted as a fused fallback. On one device a wave whose
union leaves the fused envelope, or whose node axis B1's cluster does not
hold in shared memory (``fused_wave_fits``), runs the joint kernel
(``csrc/joint_wave.cu``, any union; one launch of the clusters its plan
picks for the node axis, ``cuda_kernel.joint_plan``, and its global-row
instantiation past what they hold in shared memory; a wait between its
clusters past the bound raises through its error word), counted as a
fused fallback, the reference's meaning,
and in ``joint_wave_stats``. ``configure_fused_wave(False)`` sends every
wave to the joint kernel, or to the joint sharded kernel, uncounted as
fallbacks.
A mesh that does not divide the node axis, or has one device, runs the
wave on ``device`` and counts a sharded fallback in
``sharded_wave_stats``. The results equal the
one-device wave's bit for bit.

The fault points ``wave.launch`` and ``wave.d2h.drain`` and the tracer
spans ``wave.assemble``, ``wave.park``, ``wave.launch`` and
``kernel.d2h`` sit where the JAX launcher has them, and the kernel
profiler (``telemetry/kernel_profile``) times each wave's B1, joint
or sharded dispatch under its bucket key and meters its uploads and
readbacks.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.ops.cuda_kernel import (
    fused_wave_apply,
    fused_wave_fits,
    fused_wave_place,
    joint_rows_global,
    joint_wave_apply,
    joint_wave_place,
    raise_on_wave_error,
    sharded_wave_fits,
)
from nomad_tpu_torch.ops.kernel import (
    TOPK,
    KernelFeatures,
    KernelIn,
    KernelOut,
    canonical_features,
    fused_wave_supported,
    neutral_step_planes,
    pad_steps,
    unpack_fused_wave,
    upload_leaf,
)
from nomad_tpu_torch.telemetry.kernel_profile import profiler
from nomad_tpu_torch.telemetry.trace import tracer
from nomad_tpu_torch.tensors.device_state import (
    default_device_state,
    device_key,
)
from nomad_tpu_torch.utils.faultpoints import fault
from nomad_tpu_torch.utils.wavecohort import wave_cohorts
from nomad_tpu_torch.utils.witness import witness_lock

#: B is bucketed to bound the number of wave shapes; 32 is the default
#: worker batch size
_WAVE_BUCKETS = (1, 4, 16, 32, 64, 256)


def _percentile(values, q: float) -> float:
    """Exact nearest-rank percentile (q in [0, 1]) of a small sample."""
    if not values:
        return 0.0
    vs = sorted(values)
    if q <= 0.0:
        return vs[0]
    rank = min(math.ceil(q * len(vs)), len(vs))
    return vs[max(rank, 1) - 1]


class _FusedWaveStats:
    """Fused-dispatch accounting. ``launches`` counts waves that ran the
    fused kernel; ``fallbacks`` counts waves whose feature union left the
    envelope (spreads, devices, cores, network), the reference's
    meaning: they run the joint kernel (``joint_wave_stats``). Steady
    live traffic fits the envelope. ``failures`` counts waves whose
    launch raised: the error reaches every member (a worker nacks their
    evals), and no other version runs in its place."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0
        self.fallbacks = 0
        self.failures = 0

    def note_launch(self) -> None:
        with self._lock:
            self.launches += 1

    def note_fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def note_failure(self) -> None:
        with self._lock:
            self.failures += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.fallbacks = 0
            self.failures = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"launches": self.launches, "fallbacks": self.fallbacks,
                    "failures": self.failures}


#: process-wide fused-wave stats (coalescers are per batch and too
#: short-lived to carry their own history)
fused_wave_stats = _FusedWaveStats()


class _JointWaveStats:
    """The port's own count of the waves outside B1's one-device route:
    ``launches`` one-device waves that ran the joint kernel
    (``csrc/joint_wave.cu``, one launch each), of those ``global_rows``
    the waves too wide for B1's and its own shared memory, which its
    global-row instantiation runs (by the card's plan; never on CPU
    tensors, whose plain versions hold any width);
    ``sharded_launches`` mesh waves that ran the joint sharded kernel
    (``csrc/joint_sharded_wave.cu``, one C call each); ``torch_waves``
    waves that ran torch ops instead (the plain versions on CPU tensors).
    On the card ``torch_waves`` stays 0."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0
        self.sharded_launches = 0
        self.global_rows = 0
        self.torch_waves = 0

    def note(self, kernel: bool, sharded: bool = False,
             global_rows: bool = False) -> None:
        with self._lock:
            if not kernel:
                self.torch_waves += 1
            elif sharded:
                self.sharded_launches += 1
            else:
                self.launches += 1
            self.global_rows += int(global_rows)

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.sharded_launches = 0
            self.global_rows = 0
            self.torch_waves = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"launches": self.launches,
                    "sharded_launches": self.sharded_launches,
                    "global_rows": self.global_rows,
                    "torch_waves": self.torch_waves}


#: process-wide joint-wave stats
joint_wave_stats = _JointWaveStats()


class _ShardedWaveStats:
    """Sharded-dispatch accounting (exported as the
    ``nomad_tpu_wave_sharded_*`` series by telemetry/exporter.py; reset
    with telemetry.reset()).

    ``launches`` counts waves whose node axis was split over a mesh (on
    the card through the sharded kernel, ``csrc/sharded_wave.cu``, or for
    a union outside the fused envelope or shards under TOPK rows the joint
    sharded kernel, ``csrc/joint_sharded_wave.cu``);
    ``fallbacks`` counts waves that had a mesh but ran on one device (a
    mesh of one device, or a node axis its device count does not
    divide): on a healthy mesh server this sits at zero. ``mesh_devices``
    is the device count of the newest sharded launch or fallback (0 =
    never)."""

    def __init__(self) -> None:
        self._lock = witness_lock("ShardedWaveStats._lock")
        self.launches = 0
        self.fallbacks = 0
        self.mesh_devices = 0

    def note_launch(self, devices: int) -> None:
        with self._lock:
            self.launches += 1
            self.mesh_devices = devices

    def note_fallback(self, devices: int) -> None:
        with self._lock:
            self.fallbacks += 1
            self.mesh_devices = devices

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.fallbacks = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "launches": self.launches,
                "fallbacks": self.fallbacks,
                "mesh_devices": self.mesh_devices,
            }


#: process-wide sharded-wave stats
sharded_wave_stats = _ShardedWaveStats()

#: The fused-wave switch (the JAX package's knob). On (the default): a
#: wave whose feature union fits the fused envelope runs B1, or the fused
#: sharded kernel over a mesh; the rest run the joint kernel (the joint
#: sharded wave over a mesh), counted as fallbacks. Off: every wave runs
#: the joint kernel (or the joint sharded wave), and nothing counts as a
#: fallback.
_FUSED_WAVE = True


def configure_fused_wave(on: bool) -> None:
    """Turn the fused wave on or off process-wide (a joint-kernel arm of a
    benchmark flips this)."""
    global _FUSED_WAVE
    _FUSED_WAVE = bool(on)


def fused_wave_enabled() -> bool:
    return _FUSED_WAVE


class _UploadStats:
    """Host -> device uploads made by the wave launcher: one per distinct
    plane per wave (a shared leaf counts once, a stacked leaf once for
    the whole member stack)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.uploads = 0
        self.bytes = 0

    def note(self, nbytes: int) -> None:
        with self._lock:
            self.uploads += 1
            self.bytes += nbytes

    def reset(self) -> None:
        with self._lock:
            self.uploads = 0
            self.bytes = 0


upload_stats = _UploadStats()


def _upload(x, device: torch.device) -> torch.Tensor:
    """One plane to the wave's device (``ops/kernel.upload_leaf``). A
    tensor already there (a resident plane) moves nothing; host numpy is
    copied once and counted, and timed into the profiler's h2d stage
    when it is on."""
    if isinstance(x, torch.Tensor):
        return upload_leaf(x, device)[0]
    t0 = time.perf_counter()
    t, nbytes = upload_leaf(x, device)
    upload_stats.note(nbytes)
    if profiler.enabled:
        profiler.add_stage("h2d", time.perf_counter() - t0)
        profiler.add_bytes("h2d", nbytes)
    return t


class _WaveTopK:
    """One wave's top-k planes, resident on device until first use. All
    members share the holder; the first reader fetches both planes once
    and caches the host copy for the rest."""

    __slots__ = ("_idx", "_scores", "_host", "_lock", "_fetching", "_done")

    def __init__(self, idx_dev, scores_dev) -> None:
        self._idx = idx_dev
        self._scores = scores_dev
        self._host = None
        self._lock = threading.Lock()
        self._fetching = False
        self._done = threading.Event()

    def host(self):
        # claim-then-fetch: the lock only decides WHO fetches; the copy
        # runs unlocked and the losers wait on the claim's event
        while True:
            with self._lock:
                if self._host is not None:
                    return self._host
                if not self._fetching:
                    self._fetching = True
                    done = self._done = threading.Event()
                    break
                done = self._done
            done.wait()
        try:
            # deferred-drain seam (chaos plane): the shared fetch runs in
            # the plan window; a failure hits the member that claimed it
            # and the others retry the claim
            fault("wave.d2h.drain")
            host = (self._idx.cpu().numpy(), self._scores.cpu().numpy())
            profiler.add_bytes("d2h", host[0].nbytes + host[1].nbytes)
            # off the wave-critical path: the drain runs in the plan
            # window, beside the next wave
            profiler.count_dispatch("topk_drain")
            with self._lock:
                self._host = host
                self._idx = self._scores = None
        finally:
            with self._lock:
                self._fetching = False
            done.set()
        return self._host


class _TopKSlice:
    """A member's lazy [k, TOPK] view of the wave's top-k plane."""

    __slots__ = ("_wave", "_field", "_start", "_stop")

    def __init__(self, wave: _WaveTopK, field: int, start: int,
                 stop: int) -> None:
        self._wave = wave
        self._field = field          # 0 = idx, 1 = scores
        self._start = start
        self._stop = stop

    def _resolve(self):
        return self._wave.host()[self._field][self._start:self._stop]

    def __array__(self, dtype=None, copy=None):
        a = self._resolve()
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, item):
        return self._resolve()[item]

    def __len__(self) -> int:
        return self._stop - self._start


#: node planes shipped once per wave (unbatched) when every member
#: shares them by identity: cluster-static planes plus the snapshot's
#: utilization
_SHAREABLE_FIELDS = (
    "cap_cpu", "cap_mem", "cap_disk", "free_cores", "shares_per_core",
    "avail_mbits", "free_dyn",
    "used_cpu", "used_mem", "used_disk", "used_cores", "used_mbits",
)

#: second group: the wide ask planes that stay neutral for the common
#: ask (frozen singletons). ``node_perm`` is seeded per eval and ships
#: always stacked.
_NEUTRAL_SHAREABLE_FIELDS = (
    "port_conflict", "dev_free", "dev_aff_score",
    "step_penalty", "step_preferred",
    "spread_active", "spread_even", "spread_weight",
    "spread_bucket", "spread_counts", "spread_desired",
)

#: third group: the job-local [N] planes (a follow-up eval forks them)
_JOB_SHAREABLE_FIELDS = (
    "job_tg_count", "job_any_count", "penalty", "aff_score",
    "base_mask",
)


def wave_field_is_shared(field: str, shared: bool,
                         neutral_shared: bool,
                         job_shared: bool = True) -> bool:
    """Whether a KernelIn field ships UNBATCHED under the given wave
    layout flags: the single source of truth for the three groups."""
    return (shared and field in _SHAREABLE_FIELDS) or (
        neutral_shared and field in _NEUTRAL_SHAREABLE_FIELDS) or (
        job_shared and field in _JOB_SHAREABLE_FIELDS)


def pad_wave(b: int) -> int:
    for w in _WAVE_BUCKETS:
        if b <= w:
            return w
    return ((b + 255) // 256) * 256


def union_features(features: List[KernelFeatures]) -> KernelFeatures:
    """Smallest feature set that serves every member, canonicalized."""
    return canonical_features(KernelFeatures(
        n_spreads=max(f.n_spreads for f in features),
        with_topk=any(f.with_topk for f in features),
        with_devices=any(f.with_devices for f in features),
        with_ports=any(f.with_ports for f in features),
        with_cores=any(f.with_cores for f in features),
        with_network=any(f.with_network for f in features),
        with_distinct=any(f.with_distinct for f in features),
        with_step_penalties=any(f.with_step_penalties for f in features),
        with_preferred=any(f.with_preferred for f in features),
        with_shuffle=any(f.with_shuffle for f in features),
    ))


def _pad_kin_steps(kin: KernelIn, k_max: int) -> KernelIn:
    """Pad the per-step planes to the wave's step count (neutral rows)."""
    k = int(kin.step_penalty.shape[0])
    if k == k_max:
        return kin
    n_pen, n_pref = neutral_step_planes(k)
    if kin.step_penalty is n_pen and kin.step_preferred is n_pref:
        # neutral singletons pad to the neutral singleton of the wave's
        # step count: identity (and so wave sharing) survives padding
        pen, pref = neutral_step_planes(k_max)
        return kin._replace(step_penalty=pen, step_preferred=pref)
    pen = np.full((k_max, kin.step_penalty.shape[1]), -1, np.int32)
    pen[:k] = np.asarray(kin.step_penalty)
    pref = np.full(k_max, -1, np.int32)
    pref[:k] = np.asarray(kin.step_preferred)
    return kin._replace(step_penalty=pen, step_preferred=pref)


class WaveStats:
    """Process-wide wave-shape observability: ``fill_ratio`` = real
    members / padded wave slots; ``park_latency`` is the rendezvous cost
    an eval thread pays waiting for its wave; ``assemble_latency`` is
    launch_wave's host time stacking and uploading the wave before its
    dispatch; ``wave_latency`` is launch_wave's host time from dispatch
    to the end of the blocking packed readback."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests = 0
        self.launches = 0
        self.full_launches = 0
        self.deadline_launches = 0
        self.members_sum = 0
        self.slots_sum = 0
        self._park_s: deque = deque(maxlen=4096)
        self._assemble_s: deque = deque(maxlen=4096)
        self._wave_s: deque = deque(maxlen=4096)

    def observe_wave(self, members: int, deadline_fired: bool) -> None:
        with self._lock:
            self.launches += 1
            self.members_sum += members
            self.slots_sum += pad_wave(members)
            if deadline_fired:
                self.deadline_launches += 1
            else:
                self.full_launches += 1

    def observe_park(self, seconds: float) -> None:
        with self._lock:
            self.requests += 1
            self._park_s.append(seconds)

    def observe_assemble(self, seconds: float) -> None:
        with self._lock:
            self._assemble_s.append(seconds)

    def observe_wave_latency(self, seconds: float) -> None:
        with self._lock:
            self._wave_s.append(seconds)

    def reset(self) -> None:
        with self._lock:
            self.requests = 0
            self.launches = 0
            self.full_launches = 0
            self.deadline_launches = 0
            self.members_sum = 0
            self.slots_sum = 0
            self._park_s.clear()
            self._assemble_s.clear()
            self._wave_s.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests,
                "launches": self.launches,
                "full_launches": self.full_launches,
                "deadline_launches": self.deadline_launches,
                "fill_ratio": (self.members_sum / self.slots_sum
                               if self.slots_sum else 0.0),
                "park_latency_p50_ms": _percentile(self._park_s, 0.5) * 1e3,
                "park_latency_p99_ms": _percentile(self._park_s, 0.99) * 1e3,
                "assemble_latency_p50_ms":
                    _percentile(self._assemble_s, 0.5) * 1e3,
                "assemble_latency_p99_ms":
                    _percentile(self._assemble_s, 0.99) * 1e3,
                "wave_latency_p50_ms": _percentile(self._wave_s, 0.5) * 1e3,
                "wave_latency_p99_ms": _percentile(self._wave_s, 0.99) * 1e3,
            }


wave_stats = WaveStats()


class _LatencyEWMA:
    """Exponentially-weighted wave latency: the adaptive coalescer's
    deadline is a fraction of what a launch actually costs."""

    def __init__(self, alpha: float = 0.2) -> None:
        self._lock = threading.Lock()
        self._alpha = alpha
        self._value: Optional[float] = None

    def update(self, seconds: float) -> None:
        with self._lock:
            if self._value is None:
                self._value = seconds
            else:
                self._value += self._alpha * (seconds - self._value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


#: EWMA of launch_wave wall seconds
wave_latency_ewma = _LatencyEWMA()
#: EWMA of "this launch was deadline-fired" (0/1): widens the window
#: back toward the cap while deadline fires fragment waves
wave_deadline_ewma = _LatencyEWMA(alpha=0.25)

#: launches currently executing, token -> perf_counter start; a long
#: in-flight launch (a cold kernel build) disarms the adaptive deadline
_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT_STARTS: dict = {}


def _oldest_inflight_age_s() -> float:
    with _INFLIGHT_LOCK:
        if not _INFLIGHT_STARTS:
            return 0.0
        oldest = min(_INFLIGHT_STARTS.values())
    return time.perf_counter() - oldest


class ResidentUsage:
    """Used cpu/mem/disk planes resident on the device, which waves read
    as their shared utilization and commit into (``fused_wave_apply``):
    a wave-by-wave device commit for callers that keep no store (the
    live path of phase 3 in chip_smoke.py). A server's waves read the
    store's snapshot planes from ``tensors/device_state`` instead.
    Commits make NEW tensors; readers of an older generation keep
    theirs."""

    def __init__(self, used_cpu, used_mem, used_disk,
                 device: DeviceLike = None) -> None:
        dev = resolve_device(device)
        self.device = dev
        self.used_cpu = torch.tensor(np.asarray(used_cpu), device=dev)
        self.used_mem = torch.tensor(np.asarray(used_mem), device=dev)
        self.used_disk = torch.tensor(np.asarray(used_disk), device=dev)
        #: held from a wave's read of the planes to its commit
        self.lock = threading.Lock()
        self.commits = 0


class Wave(NamedTuple):
    """One assembled wave, uploaded to its device (or placed over its
    mesh: then every leaf is a placed leaf, ``parallel/sharded.place``,
    and the step maps stay on the host, where the sharded body reads
    them)."""

    kin: KernelIn                # stacked: shared leaves unbatched
    step_member: torch.Tensor    # i32[t_pad], -1 = padding
    step_local: torch.Tensor     # i32[t_pad]
    t_pad: int
    b_pad: int
    features: KernelFeatures     # the members' canonical union
    offsets: List[int]           # first step of each real member
    #: (shareable, neutral_shareable, job_shareable): which groups ship
    #: unbatched
    layout: tuple
    mesh: object = None          # the mesh of a sharded wave


def _wave_layout(kins: List[KernelIn], k_steps: List[int],
                 features: List[KernelFeatures]):
    """The host half of a wave: members padded to the wave's step count
    and bucket, the feature union, the sharing layout and the step maps.
    Returns ``(padded, feats, b_pad, t_pad, layout, step_member,
    step_local, offsets)``."""
    k_max = max(k_steps)
    feats = union_features(features)
    padded = [_pad_kin_steps(kin, k_max) for kin in kins]
    b_pad = pad_wave(len(padded))
    if b_pad > len(padded):
        # inert filler rows: first member with zero active steps
        filler = padded[0]._replace(n_steps=np.asarray(0, np.int32))
        padded = padded + [filler] * (b_pad - len(padded))

    def _group_shared(fields) -> bool:
        return all(all(getattr(k, f) is getattr(padded[0], f)
                       for k in padded[1:]) for f in fields)

    layout = (_group_shared(_SHAREABLE_FIELDS),
              _group_shared(_NEUTRAL_SHAREABLE_FIELDS),
              _group_shared(_JOB_SHAREABLE_FIELDS))

    # step layout: member 0's steps, then member 1's, ... The step axis
    # is sized from the PADDED wave so the shape depends only on (wave
    # bucket, step bucket).
    t_pad = pad_steps(b_pad * k_max)
    ks = np.asarray(k_steps, np.int64)
    starts = np.concatenate(([0], np.cumsum(ks)[:-1]))
    total = int(ks.sum())
    step_member = np.full(t_pad, -1, np.int32)
    step_local = np.zeros(t_pad, np.int32)
    step_member[:total] = np.repeat(np.arange(len(ks)), ks)
    step_local[:total] = np.arange(total) - np.repeat(starts, ks)
    return (padded, feats, b_pad, t_pad, layout, step_member, step_local,
            starts.tolist())


def assemble_wave(kins: List[KernelIn], k_steps: List[int],
                  features: List[KernelFeatures], dev: torch.device) -> Wave:
    """Host stacking, the three sharing groups and the step layout; each
    distinct plane is uploaded once, and a shared plane resident on
    ``dev`` is not uploaded at all."""
    # the snapshot planes the members' evals asked for go resident now,
    # on this thread, before the lookups below (keyed once per wave)
    dkey = device_key(dev)
    default_device_state.advance_pending(dkey)
    padded, feats, b_pad, t_pad, layout, step_member, step_local, \
        offsets = _wave_layout(kins, k_steps, features)

    def _stack_field(f, xs):
        if wave_field_is_shared(f, *layout):
            # the resident twin on THIS device when one exists (the
            # snapshot's planes advanced above, frozen neutral
            # singletons uploaded once). The snapshot group is
            # registry-only: a stale snapshot's read-only gathered planes
            # must ship as host planes, not pass for singletons.
            res = default_device_state.lookup(
                xs[0], dkey, frozen_ok=f not in _SHAREABLE_FIELDS)
            if res is not None:
                return res
            return _upload(xs[0], dev)      # ONE upload for every member
        if any(isinstance(x, torch.Tensor) for x in xs):
            return torch.stack([_upload(x, dev) for x in xs])
        return _upload(np.stack([np.asarray(x) for x in xs]), dev)

    stacked = KernelIn(*[
        _stack_field(f, [getattr(k, f) for k in padded])
        for f in KernelIn._fields])
    return Wave(stacked, _upload(step_member, dev),
                _upload(step_local, dev), t_pad, b_pad, feats, offsets,
                layout)


def _place(x, sharding, done: Optional[dict] = None) -> tuple:
    """One leaf placed over its mesh (``parallel/sharded._place``), the
    bytes counted as ``_upload`` counts them. With ``done`` (members'
    arrays, alive for the whole wave), a host array placed under several
    fields with one spec moves once."""
    from nomad_tpu_torch.parallel.sharded import _place as place_leaf

    key = ((id(x), sharding.spec)
           if done is not None and isinstance(x, np.ndarray) else None)
    got = done.get(key) if key is not None else None
    if got is not None:
        return got
    t0 = time.perf_counter()
    parts, nbytes = place_leaf(x, sharding.spec, sharding.mesh)
    if nbytes:
        upload_stats.note(nbytes)
        if profiler.enabled:
            profiler.add_stage("h2d", time.perf_counter() - t0)
            profiler.add_bytes("h2d", nbytes)
    if key is not None:
        done[key] = parts
    return parts


def assemble_sharded_wave(kins: List[KernelIn], k_steps: List[int],
                          features: List[KernelFeatures], mesh) -> Wave:
    """``assemble_wave`` over a mesh: each leaf placed by the layout's
    shardings (``parallel/sharded.joint_in_shardings``); a shared leaf
    whose twin the device state holds split over ``mesh`` is not placed
    again. The step maps stay on the host."""
    from nomad_tpu_torch.parallel.sharded import joint_in_shardings

    default_device_state.advance_pending(mesh)
    padded, feats, b_pad, t_pad, layout, step_member, step_local, \
        offsets = _wave_layout(kins, k_steps, features)
    shardings, _ = joint_in_shardings(mesh, *layout)
    done: dict = {}

    def _stack_field(f, xs, sh):
        if wave_field_is_shared(f, *layout):
            # the twin split over THIS mesh when the device state holds
            # one; the snapshot group is registry-only, as in
            # assemble_wave
            res = default_device_state.lookup(
                xs[0], frozen_ok=f not in _SHAREABLE_FIELDS, spec=sh.spec,
                mesh=mesh)
            if res is not None:
                return res
            return _place(xs[0], sh, done)
        return _place(np.stack([np.asarray(x) for x in xs]), sh)

    stacked = KernelIn(*[
        _stack_field(f, [getattr(k, f) for k in padded], sh)
        for f, sh in zip(KernelIn._fields, shardings)])
    return Wave(stacked, torch.from_numpy(step_member),
                torch.from_numpy(step_local), t_pad, b_pad, feats, offsets,
                layout, mesh)


def _dispatch(stacked, sm, sl, t_pad, feats, resident, fused):
    """B1 when ``fused`` (the union fits its envelope), else the joint
    kernel (on CPU tensors, each its plain version). With ``resident`` the
    wave reads its used planes and commits ``used + a_*`` back into it (a
    joint wave whose error word is set commits nothing, so the failure
    ``launch_wave`` raises leaves the planes as they were)."""
    if resident is None:
        place = fused_wave_place if fused else joint_wave_place
        return place(stacked, sm, sl, t_pad, feats)
    apply = fused_wave_apply if fused else joint_wave_apply
    with resident.lock:
        r = resident
        fout, r.used_cpu, r.used_mem, r.used_disk = apply(
            stacked, r.used_cpu, r.used_mem, r.used_disk, sm, sl, t_pad,
            feats)
        r.commits += 1
    return fout


def mesh_splits(mesh, n_nodes: int) -> bool:
    """Whether a wave of ``n_nodes`` rows splits its node axis over
    ``mesh``: only when the mesh's device count divides it (the pad
    buckets' powers of two cover every power-of-two mesh)."""
    return mesh is not None and mesh.size >= 2 and n_nodes % mesh.size == 0


def sharded_kernel_fits(mesh, n_nodes: int, b: int, shuffle: bool) -> bool:
    """Whether the sharded kernel takes a wave of ``b`` members over
    ``mesh``'s node split of ``n_nodes``: TOPK rows a shard or more (its
    local top-k merge), and every card's rows in its cluster's shared
    memory (``sharded_wave_fits``). ``launch_wave``'s rule, and the warm
    mesh pass's."""
    devices = [mesh.devices.flat[p] for p in mesh.node_rows()[0]]
    n_loc = n_nodes // len(devices)
    return n_loc >= TOPK and sharded_wave_fits(devices, n_loc, b, shuffle)


def _dispatch_sharded(stacked, sm, sl, t_pad, feats, mesh, layout, fused):
    """The fused sharded wave when ``fused``, else the joint sharded wave:
    on CUDA shards their hand kernels (``csrc/sharded_wave.cu``,
    ``csrc/joint_sharded_wave.cu``), each packed as a fused wave with its
    carries node-sharded."""
    from nomad_tpu_torch.parallel.sharded import (
        fused_sharded_entry,
        joint_sharded_entry,
    )

    entry = fused_sharded_entry if fused else joint_sharded_entry
    return entry(mesh, *layout)[0](stacked, sm, sl, t_pad, feats)


def launch_wave(kins: List[KernelIn], k_steps: List[int],
                features: List[KernelFeatures],
                device: DeviceLike = None,
                resident: Optional[ResidentUsage] = None,
                mesh=None) -> List[KernelOut]:
    """Fire B launch requests as ONE device call; split the results.

    Members' placement steps run in arrival order over a shared capacity
    carry, so members see each other's placements (the serialized plan
    applier's semantics, on device). A leaf that every member shares by
    identity is uploaded once per wave; the per-member result comes back
    in one packed device-to-host copy. An error from the kernel
    propagates to every member.

    Which kernel a wave takes on the card: on one device B1
    (``csrc/fused_wave.cu``) for a union in the fused envelope whose node
    axis its cluster holds, else the joint kernel (``csrc/joint_wave.cu``;
    its global-row instantiation for a node axis too wide for its shared
    memory). Over a mesh, the sharded kernel (``csrc/sharded_wave.cu``) for
    a union in the envelope with TOPK rows a shard or more whose cards'
    rows its cluster holds (``sharded_kernel_fits``), else the joint
    sharded kernel (``csrc/joint_sharded_wave.cu``). CPU tensors run each
    kernel's plain version.

    ``mesh``: split the node axis over this mesh's devices (see the
    module doc; None runs on ``device``). A sharded wave commits into no
    ``resident`` usage: the two together raise.
    """
    dev = resolve_device(device)
    if resident is not None and resident.device != dev:
        raise ValueError("resident usage lives on another device")
    if resident is not None and mesh is not None:
        raise ValueError("a wave over a mesh commits into no resident "
                         "usage: pass mesh=None with resident=")
    # wave-launch seam (chaos plane): an injected failure lands on every
    # member of the wave
    fault("wave.launch")
    # a wave that cannot split over the mesh runs on ``dev``, counted
    n_nodes = int(kins[0].cap_cpu.shape[-1])
    mesh_size = int(mesh.size) if mesh is not None else 0
    sharded = mesh_splits(mesh, n_nodes)
    t_assemble = time.perf_counter()
    with tracer.span("wave.assemble"):
        if sharded:
            wave = assemble_sharded_wave(kins, k_steps, features, mesh)
        else:
            wave = assemble_wave(kins, k_steps, features, dev)
        stacked, sm, sl, t_pad, b_pad, feats, offsets, layout, _ = wave
        if profiler.enabled and dev.type == "cuda":
            # the uploads are done once the card has them
            t0 = time.perf_counter()
            torch.cuda.synchronize(dev)
            profiler.add_stage("h2d", time.perf_counter() - t0)
    t_launch = time.perf_counter()
    wave_stats.observe_assemble(t_launch - t_assemble)
    # the bucket identity of the launch: a repeat of this key is no
    # miss (the profiler counts first launches per key)
    wave_key = (b_pad, t_pad, n_nodes, *layout, feats)
    # B1 takes a one-device wave its cluster holds in shared memory (a
    # wider one runs the joint kernel); the sharded kernel a mesh wave
    # with TOPK rows a shard for its local top-k merge whose cards' rows
    # its cluster holds (any other runs the joint sharded kernel)
    want_fused = _FUSED_WAVE
    fused = want_fused and fused_wave_supported(feats) and (
        sharded_kernel_fits(mesh, n_nodes, b_pad, feats.with_shuffle)
        if sharded
        else fused_wave_fits(dev, n_nodes, b_pad, feats.with_shuffle))
    if sharded:
        sharded_wave_stats.note_launch(mesh_size)
    elif mesh is not None:
        sharded_wave_stats.note_fallback(mesh_size)
    token = object()
    with _INFLIGHT_LOCK:
        _INFLIGHT_STARTS[token] = t_launch
    try:
        try:
            if sharded:
                # the step maps pass as host arrays, beside the statics
                fout = profiler.call(
                    "fused_wave_sharded" if fused else "joint_sharded",
                    _dispatch_sharded, (stacked,),
                    (sm, sl, t_pad, feats, mesh, layout, fused),
                    wave_key + (tuple(mesh.devices.flat),),
                    mesh.devices.flat[0])
            else:
                fout = profiler.call(
                    "fused_wave" if fused else "joint", _dispatch,
                    (stacked, sm, sl), (t_pad, feats, resident, fused),
                    wave_key, dev)
            # the single wave-critical readback (synchronizes with the
            # wave, so an error of the kernel surfaces here)
            with tracer.span("kernel.d2h"):
                packed = fout.packed.cpu().numpy()
            profiler.add_bytes("d2h", packed.nbytes)
            # a sharded or joint wave's error word comes back with the
            # outputs
            raise_on_wave_error(packed, t_pad, b_pad)
        except BaseException:
            fused_wave_stats.note_failure()
            raise
        host = unpack_fused_wave(packed, t_pad, b_pad)
    finally:
        with _INFLIGHT_LOCK:
            _INFLIGHT_STARTS.pop(token, None)
    if fused:
        fused_wave_stats.note_launch()
    else:
        root = mesh.devices.flat[0] if sharded else dev
        joint_wave_stats.note(
            kernel=root.type == "cuda", sharded=sharded,
            global_rows=not sharded and joint_rows_global(
                dev, n_nodes, b_pad, feats.with_shuffle, feats.n_spreads))
        if want_fused:
            fused_wave_stats.note_fallback()
    elapsed = time.perf_counter() - t_launch
    wave_latency_ewma.update(elapsed)
    wave_stats.observe_wave_latency(elapsed)
    wave_topk = _WaveTopK(fout.topk_idx, fout.topk_scores)
    results = []
    for i, k in enumerate(k_steps):
        o = offsets[i]
        results.append(KernelOut(
            chosen=host["chosen"][o:o + k],
            scores=host["scores"][o:o + k],
            found=host["found"][o:o + k],
            topk_idx=_TopKSlice(wave_topk, 0, o, o + k),
            topk_scores=_TopKSlice(wave_topk, 1, o, o + k),
            nodes_evaluated=host["nodes_evaluated"][i],
            nodes_feasible=host["nodes_feasible"][i],
            exhausted_cpu=host["exhausted_cpu"][i],
            exhausted_mem=host["exhausted_mem"][i],
            exhausted_disk=host["exhausted_disk"][i],
            exhausted_ports=host["exhausted_ports"][i],
            exhausted_devices=host["exhausted_devices"][i],
            exhausted_cores=host["exhausted_cores"][i],
        ))
    return results


class _Request:
    __slots__ = ("kin", "k_steps", "features", "out", "error", "event",
                 "thread")

    def __init__(self, kin, k_steps, features):
        self.kin = kin
        self.k_steps = k_steps
        self.features = features
        self.out: Optional[KernelOut] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        #: the member's thread: it holds the wave's placement turn until
        #: its plan is submitted
        self.thread = threading.get_ident()


class _PlanWindow:
    """Context manager a batching worker wraps around plan submission:
    the participant yields its rendezvous slot while it blocks on the
    serialized applier, so the next wave fires without waiting for it
    (plan submission pipelines behind wave N instead of serializing
    wave N+1)."""

    __slots__ = ("_coalescer",)

    def __init__(self, coalescer: "LaunchCoalescer") -> None:
        self._coalescer = coalescer

    def __enter__(self) -> "_PlanWindow":
        self._coalescer.suspend()
        return self

    def __exit__(self, *exc) -> None:
        self._coalescer.resume()
        # the plan is in: this member no longer holds its wave's turn
        self._coalescer.release_turn()


class LaunchCoalescer:
    """Rendezvous point for one batch of concurrently-scheduled evals.

    Every participant must end with ``done()`` (use try/finally). A wave
    fires when every not-yet-done (and not suspended) participant is
    parked in ``launch``, or when a parked request's adaptive deadline
    expires (a fraction of the EWMA wave latency clamped to
    ``[window_min_s, window_max_s]``). The thread that completes the
    rendezvous runs the device call; there is no dispatcher thread.

    ``turn`` (optional) serializes placement with other processes: an
    object with ``begin(kins) -> kins``, which blocks until this process
    may place and returns the members' inputs with their shared usage
    planes brought up to the newest committed state, and ``end()``. The
    wave's members hold it from the launch until each has left its plan
    window, launched again or finished.

    ``mesh`` (optional) is the owning server's device mesh: every wave
    is launched over it (``launch_wave(mesh=)``).
    """

    #: deadline = EWMA wave latency x this fraction (clamped)
    WINDOW_FRACTION = 0.5
    #: deadlines disarm while EWMA x fraction exceeds this multiple of
    #: window_max (cold builds in flight)
    TRANSIENT_FACTOR = 4.0

    def __init__(self, participants: int, device: DeviceLike = None,
                 resident: Optional[ResidentUsage] = None,
                 window_min_s: float = 0.001,
                 window_max_s: float = 0.050,
                 adaptive: bool = True, turn=None, mesh=None) -> None:
        if mesh is not None and resident is not None:
            raise ValueError("a coalescer over a mesh commits into no "
                             "resident usage")
        self._cv = threading.Condition(
            witness_lock("LaunchCoalescer._lock"))
        self._active = participants
        self.device = resolve_device(device)
        self.resident = resident
        #: the owning server's device mesh (None: one device)
        self.mesh = mesh
        self._pending: List[_Request] = []
        self.window_min_s = window_min_s
        self.window_max_s = window_max_s
        self.adaptive = adaptive
        self.turn = turn
        #: threads of the members that hold the placement turn
        self._holds: set = set()
        # stats (asserted by tests, reported by the worker)
        self.launches = 0
        self.requests = 0
        self.max_wave = 0
        self.deadline_launches = 0

    def _window_s(self) -> Optional[float]:
        """Deadline for a parked request, or None to park until the
        rendezvous completes."""
        ewma = wave_latency_ewma.value
        if ewma is None:
            return None
        target = ewma * self.WINDOW_FRACTION
        if target > self.window_max_s * self.TRANSIENT_FACTOR:
            return None
        if _oldest_inflight_age_s() > \
                self.window_max_s * self.TRANSIENT_FACTOR:
            return None
        frag = wave_deadline_ewma.value or 0.0
        target *= 1.0 + 3.0 * frag
        return min(max(target, self.window_min_s), self.window_max_s)

    def launch(self, kin: KernelIn, k_steps: int,
               features: KernelFeatures) -> KernelOut:
        self.release_turn()
        req = _Request(kin, k_steps, features)
        wave: Optional[List[_Request]] = None
        with self._cv:
            self.requests += 1
            self._pending.append(req)
            if len(self._pending) >= self._active:
                wave = self._pending
                self._pending = []
        if wave is not None:
            self._fire(wave)
        else:
            t0 = time.perf_counter()
            with tracer.span("wave.park"):
                if self.adaptive:
                    fired = claimed = False
                    while not (fired or claimed):
                        window = self._window_s()
                        if window is None:
                            fired = req.event.wait(0.05)
                            continue
                        fired = req.event.wait(window)
                        if fired:
                            break
                        if self._window_s() is None:
                            continue
                        with self._cv:
                            if req in self._pending:
                                wave = self._pending
                                self._pending = []
                                self.deadline_launches += 1
                        claimed = True
                    if wave is None and not fired:
                        # claimed by another member mid-timeout
                        req.event.wait()
                else:
                    req.event.wait()
            wave_stats.observe_park(time.perf_counter() - t0)
            if wave is not None:
                self._fire(wave, deadline_fired=True)
        if req.error is not None:
            raise req.error
        return req.out

    def done(self) -> None:
        self.release_turn()
        self._leave()

    def _leave(self) -> None:
        wave: Optional[List[_Request]] = None
        with self._cv:
            self._active -= 1
            if self._pending and len(self._pending) >= self._active:
                wave = self._pending
                self._pending = []
            holder = threading.get_ident() in self._holds
        if wave is None:
            return
        if holder:
            # a member entering its plan window holds the turn the next
            # wave waits for: that wave fires on a thread of its own
            threading.Thread(target=self._fire, args=(wave,), daemon=True,
                             name="wave-fire").start()
        else:
            self._fire(wave)

    def suspend(self) -> None:
        """Temporarily yield this participant's rendezvous slot."""
        self._leave()

    def resume(self) -> None:
        """Re-take the slot released by ``suspend``."""
        with self._cv:
            self._active += 1

    def plan_window(self) -> _PlanWindow:
        return _PlanWindow(self)

    def release_turn(self) -> None:
        """The calling member gives up its hold on the placement turn; the
        last holder of a wave gives the turn back."""
        if not self._holds:
            return
        me = threading.get_ident()
        with self._cv:
            if me not in self._holds:
                return
            self._holds.discard(me)
            last = not self._holds
        if last:
            self.turn.end()

    def _take_turn(self, wave: List[_Request]) -> bool:
        """Wait for the placement turn and give the members the newest
        usage; on an error every member fails with it."""
        try:
            kins = self.turn.begin([r.kin for r in wave])
        except BaseException as e:   # noqa: BLE001 - re-raised per member
            for r in wave:
                r.error = e
                r.event.set()
            return False
        for r, kin in zip(wave, kins):
            r.kin = kin
        with self._cv:
            self._holds.update(r.thread for r in wave)
        return True

    def _fire(self, wave: List[_Request], deadline_fired: bool = False) -> None:
        if self.turn is not None and not self._take_turn(wave):
            return
        # members may sit on different node-axis pad buckets after a
        # snapshot refresh; a joint launch needs one node axis
        groups: dict = {}
        for r in wave:
            groups.setdefault(int(r.kin.cap_cpu.shape[0]), []).append(r)
        wave_deadline_ewma.update(1.0 if deadline_fired else 0.0)
        for grp in groups.values():
            self.launches += 1
            self.max_wave = max(self.max_wave, len(grp))
            wave_stats.observe_wave(len(grp), deadline_fired)
            try:
                with tracer.span("wave.launch"):
                    outs = launch_wave(
                        [r.kin for r in grp], [r.k_steps for r in grp],
                        [r.features for r in grp], device=self.device,
                        resident=self.resident, mesh=self.mesh)
                for r, out in zip(grp, outs):
                    r.out = out
                # wave-boundary plan batching: the members are about to
                # resume and submit ~len(grp) plans; arm the plan queue's
                # drain window before releasing them, so the whole wave
                # commits as one entry (utils/wavecohort and
                # PlanQueue.dequeue_batch)
                wave_cohorts.note_wave(len(grp))
            except BaseException as e:   # noqa: BLE001 - re-raised per member
                for r in grp:
                    r.error = e
            for r in grp:
                r.event.set()


_CLUSTER_LRU_MAX = 8


class ClusterCache:
    """ClusterTensors memo shared by a batch's evals.

    When the store publishes usage planes, the process-wide incremental
    cache serves the build: an unchanged ``structure_version`` is an
    identity hit, a bumped one applies dirty-node deltas from the
    store's change log instead of a full O(nodes) rebuild
    (tensors/schema.IncrementalClusterCache). Snapshot-identity keying
    is the fallback for states without usage planes.

    Each snapshot's wave-shared planes are requested resident on the
    cache's device (``DeviceClusterState.request``), the card unless the
    caller names the CPU; the wave launcher advances them before its next
    wave. A failed advance is counted in the device state's ``errors``
    and its waves ship host planes."""

    def __init__(self, device: DeviceLike = None) -> None:
        self._lock = threading.Lock()
        self._cache = {}
        #: where the snapshots' wave-shared planes are made resident
        self.device = resolve_device(device)

    def get(self, state):
        from nomad_tpu_torch.tensors.schema import (
            ClusterTensors,
            default_incremental_cluster_cache,
        )

        u = getattr(state, "usage", None)
        if u is not None and u.uid:
            built = default_incremental_cluster_cache.get(state)
            # ask for this snapshot's planes; the wave launcher advances
            # them before it assembles the next wave
            default_device_state.request(built, u, self.device)
            return built
        key = id(state)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and hit[0] is state:
                return hit[1]
        built = ClusterTensors.build(state.nodes())
        with self._lock:
            self._cache[key] = (state, built)
            while len(self._cache) > _CLUSTER_LRU_MAX:
                self._cache.pop(next(iter(self._cache)))
        return built


#: device -> the process-wide cache of schedulers outside batch mode
_DEFAULT_CACHES: dict = {}
_DEFAULT_CACHES_LOCK = threading.Lock()


def default_cluster_cache(device: DeviceLike = None) -> ClusterCache:
    """The process-wide ``ClusterCache`` of ``device`` (the card unless
    the caller names the CPU), used by schedulers outside batch mode."""
    dev = resolve_device(device)
    with _DEFAULT_CACHES_LOCK:
        cache = _DEFAULT_CACHES.get(dev)
        if cache is None:
            cache = _DEFAULT_CACHES[dev] = ClusterCache(dev)
        return cache

