"""Start-up kernel warmup: launch the live path's kernels before an eval.

Counterpart of ``nomad_tpu/ops/warmup.py``. On the card there is no jit
to compile, but the first launch of a bucket still pays for things a
scheduling deadline should not: building or loading the kernel's
library (``ops/cuda_kernel.load_library``), the CUDA module load of the
kernel, B1's cluster-fit plan per (N, B), the caching allocator's first
blocks of the wave's shapes, the first upload of the frozen neutral
planes of that node size (``tensors/device_state``) and the first
dirty-row scatter. A warm launch of each bucket at ``Server.start()``
pays them on a background thread instead.

The buckets come from a **warmup manifest**: the keys a server launched,
taken from the kernel profiler (``telemetry/kernel_profile``) at
shutdown. A server warms the keys as they were observed. The JAX
package widens them with ``expand_lattice`` over the wave, step, layout
and feature axes, because each bucket there is a program to compile;
here every bucket runs the same loaded library, and a bucket's first
live launch costs about 5 ms more than a seen key's, against ~22 ms for
a warm launch of its dummy wave (NVIDIA H100 80GB HBM3, chip_smoke.py
phase 12), so the lattice (216 entries for 4 observed keys at 10,000
nodes) is there only for a caller that passes its entries to
``warmup_entries``. Each warmed key is marked warm in the profiler, so
its first live launch counts no miss. Warm launches go through the
profiler under ``warmup_<kernel>`` and are counted in ``warmup_stats``,
apart from the waves' own counts.

A server with a device mesh also warms the **mesh pass** (the JAX
package's ``mesh=`` pass): each joint entry launched once over the mesh,
through the sharded hand kernel (``csrc/sharded_wave.cu``) where the
entry fits the fused envelope and the mesh leaves each shard at least
TOPK rows, else through the joint sharded wave, as ``launch_wave``
routes it. A process's first sharded wave pays what the mesh needs once:
the CUDA contexts of the other cards, the library, each card's plan,
peer access and the caching allocator's first blocks on every card
(PERF.md §5 splits it); the warm launch pays them instead and marks the
key ``launch_wave`` uses (the wave key and the mesh's devices) warm. The
manifest keeps no mesh: a sharded key folds into the same ``joint``
entry as its one-device wave, and each start warms it over whatever
mesh the server has then.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch.device import DeviceLike, resolve_device

LOG = logging.getLogger(__name__)

MANIFEST_VERSION = 1

#: default manifest location (a server overrides it with
#: ServerConfig.warmup_manifest_path). The port's own file: its bucket
#: keys are not the JAX package's.
DEFAULT_MANIFEST_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "nomad_tpu_torch_warmup.json")


class _WarmupStats:
    """Warm launches per kernel name (never counted as the waves' own)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches: Dict[str, int] = {}

    def note(self, kernel: str) -> None:
        with self._lock:
            self.launches[kernel] = self.launches.get(kernel, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.launches.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.launches)


warmup_stats = _WarmupStats()


def _features_to_dict(f) -> Dict:
    return dict(f._asdict())


def _features_from_dict(d: Dict):
    from nomad_tpu_torch.ops.kernel import KernelFeatures

    return KernelFeatures(**{k: v for k, v in d.items()
                             if k in KernelFeatures._fields})


def manifest_from_profiler(profiler=None) -> List[Dict]:
    """Flatten the kernel profiler's (kernel, key) launches into JSON-able
    manifest entries. Fused-wave keys fold into the same ``joint`` entries
    as the joint kernel's: the launcher keys both alike, and warmup derives
    from an entry's features which of the two its waves run. Sharded
    keys (the wave key and the mesh's devices) fold into the same
    mesh-agnostic entries, their devices dropped: the next start warms
    them on its device and over its own mesh."""
    if profiler is None:
        from nomad_tpu_torch.telemetry.kernel_profile import profiler as _p

        profiler = _p
    entries: List[Dict] = []
    for kernel, key in profiler.keys():
        if kernel in ("fused_wave_sharded", "joint_sharded") \
                and len(key) == 8:
            kernel, key = "joint", key[:7]
        if kernel in ("fused_wave", "joint") and len(key) == 7:
            b_pad, t_pad, n_nodes, shared, neutral_shared, job_shared, \
                feats = key
            entries.append({
                "kernel": "joint",
                "wave": int(b_pad), "steps": int(t_pad),
                "nodes": int(n_nodes),
                "shared": bool(shared),
                "neutral_shared": bool(neutral_shared),
                "job_shared": bool(job_shared),
                "features": _features_to_dict(feats),
            })
        elif kernel in ("single_topk", "single_full") and len(key) == 3:
            n_pad, k_steps, feats = key
            entries.append({
                "kernel": kernel,
                "nodes": int(n_pad), "steps": int(k_steps),
                "features": _features_to_dict(feats),
            })
    return _dedupe(entries)


def _entry_key(e: Dict) -> Tuple:
    return (e.get("kernel"), e.get("wave"), e.get("steps"),
            e.get("nodes"), e.get("shared"), e.get("neutral_shared"),
            e.get("job_shared", True),
            tuple(sorted((e.get("features") or {}).items())))


def _dedupe(entries: List[Dict]) -> List[Dict]:
    seen = set()
    out = []
    for e in entries:
        k = _entry_key(e)
        if k not in seen:
            seen.add(k)
            out.append(e)
    return out


def load_manifest(path: str) -> List[Dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        return list(data.get("entries", []))
    return list(data)


def save_manifest(entries: List[Dict], path: str,
                  merge: bool = True) -> int:
    """Persist ``entries`` (unioned with an existing manifest when
    ``merge``); returns the entry count written. Written to a temporary
    name and renamed."""
    if merge and os.path.exists(path):
        try:
            entries = list(load_manifest(path)) + list(entries)
        except (OSError, ValueError) as err:
            LOG.warning("warmup manifest %s unreadable, replaced: %s",
                        path, err)
    entries = _dedupe(entries)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": MANIFEST_VERSION, "entries": entries},
                  f, indent=2)
        f.write("\n")
    os.replace(tmp, path)
    return len(entries)


def expand_lattice(entries: List[Dict],
                   max_wave: Optional[int] = None) -> List[Dict]:
    """Widen joint-wave entries across the bucket lattice a steady state
    reaches from an observed key:

    - wave axis: every smaller wave bucket (tail and deadline-fired
      waves), and, given ``max_wave`` (the worker's batch), larger ones
      up to the full wave;
    - step axis: every step bucket from the live floor
      (MIN_STEP_BUCKET) up to the observed one;
    - layout axis: all eight sharing layouts for multi-member waves, the
      fully shared one for 1-waves;
    - feature axis: the rescheduling variant (step penalties and
      preferred pins together);
    - plus the ``single_topk``/``single_full`` placements a 1-eval batch
      dispatches directly."""
    from nomad_tpu_torch.ops.kernel import MIN_STEP_BUCKET, pad_steps
    from nomad_tpu_torch.parallel.coalesce import _WAVE_BUCKETS, pad_wave

    out = list(entries)
    for e in entries:
        if e.get("kernel") != "joint":
            continue
        b_pad = int(e["wave"])
        ceiling = max(b_pad, pad_wave(max_wave) if max_wave else 0)
        k_max = max(int(e["steps"]) // max(b_pad, 1), 1)
        k_buckets = sorted({pad_steps(k_max),
                            *(b for b in range(1, k_max + 1)
                              if b == pad_steps(b)
                              and b >= MIN_STEP_BUCKET)})
        feats_variants = [dict(e["features"])]
        aux = dict(e["features"])
        if not (aux.get("with_step_penalties")
                and aux.get("with_preferred")):
            aux["with_step_penalties"] = True
            aux["with_preferred"] = True
            feats_variants.append(aux)
        for feats in feats_variants:
            for k in k_buckets:
                for w in _WAVE_BUCKETS:
                    if w > ceiling:
                        continue
                    base = {**e, "features": feats, "wave": w,
                            "steps": pad_steps(w * k)}
                    if w == 1:
                        # a lone member shares every field with itself
                        out.append({**base, "shared": True,
                                    "neutral_shared": True,
                                    "job_shared": True})
                    else:
                        for sh in (True, False):
                            for ns in (True, False):
                                for js in (True, False):
                                    out.append({
                                        **base, "shared": sh,
                                        "neutral_shared": ns,
                                        "job_shared": js})
                out.append({"kernel": "single_topk",
                            "nodes": int(e["nodes"]), "steps": k,
                            "features": feats})
                out.append({"kernel": "single_full",
                            "nodes": int(e["nodes"]), "steps": k,
                            "features": feats})
    return _dedupe(out)


# --- dummy planes ------------------------------------------------------


def _dummy_kin(n: int, k_pad: int):
    """A neutral KernelIn with build_kernel_in's exact dtypes and shapes,
    over the frozen neutral singletons of node size ``n``."""
    from nomad_tpu_torch.ops.kernel import (
        KernelIn,
        neutral_planes,
        neutral_step_planes,
    )
    from nomad_tpu_torch.tensors.schema import MAX_DEV_REQS

    neutral = neutral_planes(n)
    pen, pref = neutral_step_planes(k_pad)
    return KernelIn(
        cap_cpu=neutral.zeros_f32, cap_mem=neutral.zeros_f32,
        cap_disk=neutral.zeros_f32,
        free_cores=neutral.zeros_i32,
        shares_per_core=neutral.zeros_f32,
        free_dyn=neutral.zeros_i32,
        base_mask=neutral.zeros_bool,
        used_cpu=neutral.zeros_f32, used_mem=neutral.zeros_f32,
        used_disk=neutral.zeros_f32,
        used_cores=neutral.zeros_i32, used_mbits=neutral.zeros_i32,
        avail_mbits=neutral.zeros_i32,
        port_conflict=neutral.zeros_bool,
        dev_free=neutral.zeros_dev,
        dev_aff_score=neutral.zeros_f32,
        has_dev_affinity=np.asarray(False, bool),
        job_tg_count=neutral.zeros_i32,
        penalty=neutral.zeros_bool,
        aff_score=neutral.zeros_f32,
        node_perm=neutral.arange_i32,
        step_penalty=pen, step_preferred=pref,
        job_any_count=neutral.zeros_i32,
        distinct_hosts_job=np.asarray(False, bool),
        distinct_hosts_tg=np.asarray(False, bool),
        spread_active=neutral.zeros_spread_flags,
        spread_even=neutral.zeros_spread_flags,
        spread_weight=neutral.zeros_spread_weight,
        spread_bucket=neutral.neg1_spread_bucket,
        spread_counts=neutral.zeros_spread_counts,
        spread_desired=neutral.neg1_spread_desired,
        ask_cpu=np.asarray(0.0, np.float32),
        ask_mem=np.asarray(0.0, np.float32),
        ask_disk=np.asarray(0.0, np.float32),
        ask_cores=np.asarray(0, np.int32),
        ask_dyn_ports=np.asarray(0, np.int32),
        ask_has_reserved_ports=np.asarray(False, bool),
        ask_dev=np.zeros(MAX_DEV_REQS, np.float32),
        ask_mbits=np.asarray(0, np.int32),
        desired_count=np.asarray(1, np.int32),
        algorithm_spread=np.asarray(False, bool),
        n_steps=np.asarray(0, np.int32),
    )


def _entry_members(e: Dict) -> Tuple:
    """One joint entry's dummy members, as the live launcher receives
    them: ``wave`` members of ``steps / wave`` inert steps each, where a
    group the entry does not share holds its own copy in every member, so
    the wave assembles with exactly the entry's layout. Returns ``(kins,
    k_steps, features)``."""
    from nomad_tpu_torch.parallel.coalesce import (
        _JOB_SHAREABLE_FIELDS,
        _NEUTRAL_SHAREABLE_FIELDS,
        _SHAREABLE_FIELDS,
    )

    b_pad = int(e["wave"])
    t_pad = int(e["steps"])
    layout = _entry_layout(e)
    feats = _features_from_dict(e["features"])
    k_max = max(t_pad // max(b_pad, 1), 1)
    kin = _dummy_kin(int(e["nodes"]), k_max)
    own = [f for group, shared in zip(
        (_SHAREABLE_FIELDS, _NEUTRAL_SHAREABLE_FIELDS,
         _JOB_SHAREABLE_FIELDS), layout) if not shared for f in group]
    kins = [kin._replace(**{f: np.array(getattr(kin, f)) for f in own})
            for _ in range(b_pad)]
    return kins, [k_max] * b_pad, [feats] * b_pad


def _entry_layout(e: Dict) -> Tuple[bool, bool, bool]:
    return (bool(e.get("shared", True)),
            bool(e.get("neutral_shared", True)),
            bool(e.get("job_shared", True)))


def _check_bucket(wave, e: Dict) -> None:
    """Raise when an assembled dummy wave is not the entry's bucket."""
    want = (int(e["wave"]), int(e["steps"]), _entry_layout(e))
    if (wave.b_pad, wave.t_pad, wave.layout) != want:
        raise ValueError(
            f"entry {e} assembles as wave {wave.b_pad}, steps {wave.t_pad}, "
            f"layout {wave.layout}")


def _entry_wave(e: Dict, dev: torch.device):
    """One joint entry's dummy wave, assembled by the live launcher's own
    ``assemble_wave`` on ``dev``. Raises when the assembled wave is not
    the entry's bucket."""
    from nomad_tpu_torch.parallel.coalesce import assemble_wave

    wave = assemble_wave(*_entry_members(e), dev)
    _check_bucket(wave, e)
    return wave


def _warm_wave(kernel: str, fn, e: Dict, dev: torch.device) -> bool:
    """Launch one entry's dummy wave through ``fn`` and mark its key warm.
    The JAX package launches each entry again with committed and with
    mixed arguments (``_call_both_placements``): a torch launch has one
    signature, its leaves all tensors on the device, so one launch warms
    the key."""
    from nomad_tpu_torch.telemetry.kernel_profile import profiler

    wave = _entry_wave(e, dev)
    key = (wave.b_pad, wave.t_pad, int(wave.kin.cap_cpu.shape[-1]),
           *wave.layout, wave.features)
    profiler.call(f"warmup_{kernel}", fn,
                  (wave.kin, wave.step_member, wave.step_local),
                  (wave.t_pad, wave.features), key, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warmup_stats.note(kernel)
    profiler.mark_warm(kernel, key)
    return True


def _warm_fused(e: Dict, dev: torch.device) -> bool:
    """B1 for a joint entry whose features fit the fused envelope and
    whose node axis B1's cluster holds (``launch_wave``'s rule; the kernel
    itself, never ``launch_wave``: its launches are not waves)."""
    from nomad_tpu_torch.ops.cuda_kernel import (
        fused_wave_fits,
        fused_wave_place,
    )
    from nomad_tpu_torch.ops.kernel import fused_wave_supported

    feats = _features_from_dict(e["features"])
    if not fused_wave_supported(feats) or not fused_wave_fits(
            dev, int(e["nodes"]), int(e["wave"]), feats.with_shuffle):
        return False
    return _warm_wave("fused_wave", fused_wave_place, e, dev)


def _warm_joint(e: Dict, dev: torch.device) -> bool:
    """The joint kernel (csrc/joint_wave.cu; on the CPU its plain version)
    for a joint entry that B1 does not take, as ``launch_wave`` runs it:
    its error word read back and raised on."""
    from nomad_tpu_torch.ops import cuda_kernel as ck

    def place(kin, sm, sl, t_pad, feats):
        out = ck.joint_wave_place(kin, sm, sl, t_pad, feats)
        ck.raise_on_wave_error(out.packed.cpu().numpy(), t_pad,
                               int(kin.n_steps.shape[0]))
        return out

    return _warm_wave("joint", place, e, dev)


def _warm_sharded(kernel: str, e: Dict, mesh, fused: bool) -> bool:
    """Launch one entry's dummy wave over ``mesh`` exactly as a live
    sharded wave runs: assembled by ``assemble_sharded_wave``, dispatched
    by ``_dispatch_sharded`` under the profiler, its packed result read
    back and its error word checked; then every card of the mesh is
    synchronized and the key ``launch_wave`` uses is marked warm."""
    from nomad_tpu_torch.ops.cuda_kernel import raise_on_wave_error
    from nomad_tpu_torch.parallel.coalesce import (
        _dispatch_sharded,
        assemble_sharded_wave,
    )
    from nomad_tpu_torch.telemetry.kernel_profile import profiler

    wave = assemble_sharded_wave(*_entry_members(e), mesh)
    _check_bucket(wave, e)
    key = (wave.b_pad, wave.t_pad, int(e["nodes"]), *wave.layout,
           wave.features, tuple(mesh.devices.flat))
    fout = profiler.call(
        f"warmup_{kernel}", _dispatch_sharded, (wave.kin,),
        (wave.step_member, wave.step_local, wave.t_pad, wave.features, mesh,
         wave.layout, fused), key, mesh.devices.flat[0])
    raise_on_wave_error(fout.packed.cpu().numpy(), wave.t_pad, wave.b_pad)
    for d in dict.fromkeys(mesh.devices.flat):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    warmup_stats.note(kernel)
    profiler.mark_warm(kernel, key)
    return True


def _warm_fused_sharded(e: Dict, mesh) -> bool:
    """The sharded hand kernel for a joint entry, where ``launch_wave``
    would take it: the entry fits the fused envelope, the mesh splits its
    node axis, each shard keeps at least TOPK rows for the local top-k
    merge (the reference's rule, ``nomad_tpu/ops/warmup.py``) and each
    card's rows fit the kernel's cluster (``sharded_kernel_fits``); an
    entry it does not hold warms the joint sharded kernel."""
    from nomad_tpu_torch.ops.kernel import fused_wave_supported
    from nomad_tpu_torch.parallel.coalesce import (
        mesh_splits,
        sharded_kernel_fits,
    )

    feats = _features_from_dict(e["features"])
    if not fused_wave_supported(feats):
        return False
    n = int(e["nodes"])
    if not mesh_splits(mesh, n) or not sharded_kernel_fits(
            mesh, n, int(e["wave"]), feats.with_shuffle):
        return False
    return _warm_sharded("fused_wave_sharded", e, mesh, True)


def _warm_joint_sharded(e: Dict, mesh) -> bool:
    """The joint sharded kernel (csrc/joint_sharded_wave.cu; on CPU shards
    its plain version) for a joint entry the sharded kernel does not take,
    as ``launch_wave`` runs it; skipped where the mesh does not split the
    node axis (the live wave then runs on one device)."""
    from nomad_tpu_torch.parallel.coalesce import mesh_splits

    if not mesh_splits(mesh, int(e["nodes"])):
        return False
    return _warm_sharded("joint_sharded", e, mesh, False)


def _warm_single(e: Dict, dev: torch.device) -> bool:
    """The direct single-eval placement of a ``single_topk`` or
    ``single_full`` entry, with the shared planes resident as the live
    dispatch has them (``_resident_kin``); one launch warms the key (no
    ``_call_both_placements``, as in ``_warm_wave``)."""
    from nomad_tpu_torch.ops.kernel import (
        _place_full,
        _place_topk,
        _resident_kin,
    )
    from nomad_tpu_torch.telemetry.kernel_profile import profiler

    n = int(e["nodes"])
    k_steps = int(e["steps"])
    feats = _features_from_dict(e["features"])
    kernel = e["kernel"]
    if kernel == "single_topk" and feats.n_spreads != 0:
        return False                    # the topk path never runs these
    fn = _place_topk if kernel == "single_topk" else _place_full
    kin = _resident_kin(_dummy_kin(n, k_steps), dev)
    key = (n, k_steps, feats)
    profiler.call(f"warmup_{kernel}", fn, (kin,), (k_steps, feats, dev),
                  key, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warmup_stats.note(kernel)
    profiler.mark_warm(kernel, key)
    return True


def warmup_entries(entries: List[Dict], device: DeviceLike = None,
                   stop: Optional[threading.Event] = None, mesh=None,
                   mesh_only: bool = False) -> Tuple[int, int]:
    """Warm every manifest entry on ``device`` (the card unless the caller
    names the CPU; the mesh's first device when only ``mesh`` is given);
    returns ``(warmed, failed)``, an entry counted once whatever it
    warmed. A failed entry is logged, counted and skipped: warmup never
    stops a server, and never changes the route a live wave takes.
    ``stop`` ends the pass between entries (a server shutting down).

    ``mesh``: first the mesh pass, every joint entry over ``mesh`` as a
    live wave over it runs (the waves' route), then the one-device pass.
    ``mesh_only`` skips the one-device pass: the joint entries on one
    device and the single-eval entries (a server that adopts a mesh after
    its start-up warmup covered them)."""
    from nomad_tpu_torch.parallel.coalesce import fused_wave_enabled
    from nomad_tpu_torch.tensors.device_state import default_device_state

    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.devices.flat[0])
    entries = _dedupe(entries)
    did = [False] * len(entries)
    bad = [False] * len(entries)

    def one_pass(warm) -> None:
        for i, e in enumerate(entries):
            if stop is not None and stop.is_set():
                return
            if bad[i]:
                continue
            try:
                did[i] = warm(e) or did[i]
            except Exception as err:            # noqa: BLE001 - counted, logged
                bad[i] = True
                LOG.warning("kernel warmup entry failed (%s): %s", e, err)

    def sharded(e: Dict) -> bool:
        # the route launch_wave takes over the mesh: the sharded kernel
        # when the switch is on and the entry fits it, else the joint
        # sharded wave
        if e.get("kernel") != "joint":
            return False
        return (fused_wave_enabled() and _warm_fused_sharded(e, mesh)) \
            or _warm_joint_sharded(e, mesh)

    def one_device(e: Dict) -> bool:
        if e.get("kernel") == "joint":
            # B1 when the switch is on and the entry fits its envelope,
            # else the joint kernel
            return (fused_wave_enabled() and _warm_fused(e, dev)) \
                or _warm_joint(e, dev)
        if e.get("kernel") in ("single_topk", "single_full"):
            return _warm_single(e, dev)
        return False

    if mesh is not None:
        one_pass(sharded)
    if not mesh_only:
        one_pass(one_device)
    warmed = sum(d and not b for d, b in zip(did, bad))
    failed = sum(bad)
    # the resident state's dirty-row scatter rides the same node shapes
    # (split over the state's mesh when it has one)
    for n in sorted({int(e["nodes"]) for e, d, b in zip(entries, did, bad)
                     if d and not b}):
        try:
            default_device_state.warm_scatter(n, dev)
        except Exception as err:                # noqa: BLE001 - counted, logged
            failed += 1
            LOG.warning("scatter warmup failed (n=%d): %s", n, err)
    return warmed, failed


def warmup_from_manifest(path: str, device: DeviceLike = None,
                         stop: Optional[threading.Event] = None, mesh=None,
                         mesh_only: bool = False) -> Tuple[int, int]:
    """Load ``path`` and warm its entries as they were observed (a caller
    that wants the lattice passes ``expand_lattice`` of the entries to
    ``warmup_entries``; see it for ``mesh`` and ``mesh_only``). A missing
    manifest warms nothing; an unreadable one counts one failure."""
    try:
        entries = load_manifest(path)
    except FileNotFoundError:
        return (0, 0)
    except (OSError, ValueError) as err:
        LOG.warning("warmup manifest %s unreadable: %s", path, err)
        return (0, 1)
    return warmup_entries(entries, device=device, stop=stop, mesh=mesh,
                          mesh_only=mesh_only)


def start_background_warmup(path: str, device: DeviceLike = None,
                            stop: Optional[threading.Event] = None,
                            on_done=None, mesh=None,
                            mesh_only: bool = False) -> threading.Thread:
    """Server-start entry point: warm the manifest on a daemon thread; the
    server keeps serving, and a wave that races the warmup loads its
    kernel first (``load_library`` builds and loads each library once).
    ``on_done(warmed, failed, seconds)`` runs when the pass ends; an
    error that ends the pass early counts one failure. ``mesh`` and
    ``mesh_only`` as in ``warmup_entries``."""
    dev = resolve_device(device)

    def run() -> None:
        t0 = time.perf_counter()
        warmed = failed = 0
        try:
            warmed, failed = warmup_from_manifest(
                path, device=dev, stop=stop, mesh=mesh, mesh_only=mesh_only)
            if warmed or failed:
                LOG.info("kernel warmup%s: %d warmed, %d failed (%s)",
                         " (mesh)" if mesh_only else "", warmed, failed,
                         path)
        except Exception as err:                # noqa: BLE001 - counted, logged
            failed += 1
            LOG.warning("kernel warmup failed: %s", err)
        if on_done is not None:
            on_done(warmed, failed, time.perf_counter() - t0)

    t = threading.Thread(target=run, daemon=True,
                         name="mesh-kernel-warmup" if mesh_only
                         else "kernel-warmup")
    t.start()
    return t
