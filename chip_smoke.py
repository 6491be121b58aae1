#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's placement paths on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

The quickest proof that the port (``nomad_tpu_torch``) starts and is right
on the GPU. It imports nothing of JAX or of ``nomad_tpu``. Phases:

1. card and build: the card's name and power limit (nvidia-smi), then the
   three kernels built from csrc/ at once (one nvcc each) with ptxas's
   register/spill report;
2. kernel against its plain torch version at the live shape: a C2M
   cluster of 10k nodes (N=16384) with 100k resident allocs, waves of 32
   members x 10 placements (T=512), six variants of the fused envelope;
3. the main path: 32 threads submit evals through ``LaunchCoalescer`` for
   64 rounds; every wave commits into device-resident used planes; each
   thread's round is split by the host clock into building its member and
   waiting in the launch (park and wave), beside 32 member builds on one
   thread with no other running;
4. one wave with a spread member runs the torch composite on the card;
5. scale: two waves at 100k nodes (N=131072) with 1M allocs, kernel
   against plain;
6. times: CUDA-event time of the kernel and of the plain version at the
   live shape, and the bound;
7. B3, the lean full-width batch kernel, against its plain version on the
   bench's throughput problem (10k nodes, N=16384, B=512, K=10) and at
   100k nodes (N=131072), then the schedule-apply step with the kernel
   inside (the B3 path, 4 batches) against the plain step: same committed
   planes;
8. B2, the candidate-set placement kernel (pass, top-k, rest max and
   scan in one launch), and the batched loop at the bench shape (B=8192,
   25 batches, K=10): the kernel against its plain version on one batch,
   its peak allocation over that batch, then the ``kernel_topk`` loop (the
   B2 path) against the ``torch`` loop, with evals/s of both and the split
   of a batch (kernel, commit, the rest; fallback rows);
9. the replay form: the same loop with ``reset_every=1`` on a C2M cluster
   of 10k nodes with 100k resident allocs;
10. the scheduler path: the C2M replay state (10k nodes, 100k allocs)
    built into the port's ``StateStore`` (``parallel/c2m.generate``), its
    first and incremental ``ClusterTensors`` builds timed; 8 rounds of 32
    new C2M lean jobs, each round's evals run by 32 threads through
    ``new_scheduler`` with ``LaunchCoalescer.launch`` as the launcher and
    plans committed through the ``Harness`` (every wave one B1 launch, 0
    fallbacks, every eval complete with its 10 placements, no node over
    capacity; the resident state's counters, 0 errors, and the upload
    bytes per wave); B1 against its plain version on one wave of round 1's
    recorded members, in a fixed order; then 8 evals one at a time
    through ``default_kernel_launch``. Each thread's round is split by the
    host clock into the scheduler before its launch, the launch (park and
    wave) and plan assembly and submit; one ``sched: {...}`` line;
11. the server: phase 10's store, taken as bytes with
    ``to_snapshot_bytes()``, restored into the store of a ``Server`` on
    the card (one worker, batch 32, the JAX bench's e2e shape); 40
    warm-up jobs, then a timed burst of 200 C2M lean jobs registered with
    ``job_register``: the eval broker hands them out in batches, the
    worker's coalescer fires each wave as one B1 launch, and plans commit
    through the plan queue and the applier's group commit. Run three
    times: ``gc_tuning`` off, then on (``gc.freeze()`` runs once per
    process, so the order is fixed), then on with the coalescer's
    adaptive window off; one ``server: {...}`` line per arm (evals/s,
    e2e and plan latency p50/p99, B1 launches, waves and their mean fill,
    fallbacks, plans and rejected node plans, full collections and their
    pause, group commits, the restore's time). Every timed job must have
    its 10 allocations, no node may be over capacity, the broker must end
    empty with no failed eval, and B1 must have launched fewer times than
    there were evals. Each arm also reports the device-resident cluster
    state's counters over the burst (hits, scatter advances, rows, full
    uploads, forks, evictions, errors: any error fails the run) and the
    wave launcher's upload bytes per wave; after the window-off arm, the
    resident generation of the store's final snapshot must equal a fresh
    ``ClusterTensors.build`` of it uploaded whole (``torch.equal``, plane
    by plane), and the dirty-row scatter is timed on the card (320 rows
    of the five usage planes, CUDA events);
12. the warm start: phase 11's snapshot bytes, written once to a
    temporary file, restored in three fresh Python processes (no CUDA
    context, no kernel library loaded) into a server with
    ``kernel_warmup=True``, one manifest path, the window off and the
    kernel profiler on; each runs the 200-job timed burst. Run A finds no
    manifest and persists one at shutdown; run B warms it at ``start()``
    and waits for the warmup before its burst; run C warms it and bursts
    at once. Each reports the time from ``start()`` to the first wave's
    completion, the first wave's latency and assembly, the profiler's
    stages, bytes, dispatches and misses in the burst, evals/s, e2e
    p50/p99, and B1 launches against waves; runs B and C must warm at
    least one entry and fail none, and run B must miss no key in its
    burst. One ``warm start: {...}`` line per run.

Any mismatch exits non-zero without the final line. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit, and before that the kernels' JSON line (B1's entry
counts its launches on the main path of phase 3 under ``launches``, on
the scheduler path of phase 10 under ``sched_launches`` and on phase 11's
timed server bursts under ``server_launches``; the warm-up launches of
phase 12 are counted apart, in its child processes). A full record
goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops.kernel import (
    FUSED_METRIC_FIELDS,
    LEAN_FEATURES,
    MAX_PENALTY_NODES,
    build_kernel_in,
    neutral_planes,
    pad_steps,
    single_eval_stats,
    unpack_fused_wave,
)
from nomad_tpu_torch.parallel import batching, c2m, coalesce
from nomad_tpu_torch.parallel.synthetic import (
    C2M_SHAPE_CPU,
    C2M_SHAPE_MEM,
    C2M_SHAPE_P,
    c2m_cluster,
    c2m_pack_usage,
    synthetic_eval,
    throughput_problem,
)
from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.server.plan_apply import plan_group_stats
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.ops import warmup as kernel_warmup
from nomad_tpu_torch.telemetry.histogram import histograms, percentile
from nomad_tpu_torch.telemetry.kernel_profile import profiler
from nomad_tpu_torch.tensors.device_state import (
    DeviceClusterState,
    default_device_state,
)
from nomad_tpu_torch.tensors.schema import (
    MAX_DEV_REQS,
    SPREAD_BUCKETS,
    AskTensor,
    ClusterTensors,
    EvalTensors,
    default_incremental_cluster_cache,
)

SEED = 20261016
B_WAVE = 32          # members per wave (the default worker batch size)
K_PLACE = 10         # placements per eval (n_steps)
K_STEPS = 16         # the eval's step bucket, pad_steps(K_PLACE): T = 512
MAIN_ROUNDS = 64     # rounds of each eval thread; waves at least as many
ATOL = 1e-5          # scores, top-k scores and carries: kernel vs plain
NEAR_TIE = 1e-5      # a differing choice is excused only below this gap
HBM_BYTES_S = 3.35e12            # H100 SXM device memory rate
F32_OPS_S = 67e12                # H100 SXM f32 rate outside tensor cores
#: f32 operations of one (member, node) score: used + carry (3), fit
#: subtractions and compares (6), utilization adds (2), two divides and
#: two pow for the free fractions, the fit sum, clamps and select (6),
#: normalisation (anti-affinity, penalty, affinity planes and the final
#: divide: 6), and the mask (2)
OPS_PER_NODE_SCORE = 25
#: per (active step, node): the argmax compare and the top-8 compares
OPS_PER_NODE_SELECT = 3
#: per (member, node) for the pre-wave metrics pass
OPS_PER_NODE_METRIC = 10


def bound(nbytes: int, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of the byte time at HBM_BYTES_S
    and the operation time at F32_OPS_S."""
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / F32_OPS_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")

VARIANTS = ("lean", "shuffle", "penalty_preferred", "distinct", "ports",
            "kitchen_sink")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def variant_features(variant: str):
    f = LEAN_FEATURES._replace(with_topk=True)
    if variant in ("shuffle", "penalty_preferred", "kitchen_sink"):
        f = f._replace(with_shuffle=True)
    if variant in ("penalty_preferred", "kitchen_sink"):
        f = f._replace(with_step_penalties=True, with_preferred=True)
    if variant in ("distinct", "kitchen_sink"):
        f = f._replace(with_distinct=True)
    if variant in ("ports", "kitchen_sink"):
        f = f._replace(with_ports=True)
    return f


def base_kin(cluster, used):
    """One eval's KernelIn over the cluster whose wave-shared planes (the
    cluster's, the resident usage, the neutral singletons) every member
    holds by identity."""
    neutral = neutral_planes(cluster.n_pad)
    ev = EvalTensors(
        base_mask=cluster.ready, used_cpu=used[0], used_mem=used[1],
        used_disk=used[2], used_mbits=neutral.zeros_i32,
        avail_mbits=cluster.avail_mbits, used_cores=neutral.zeros_i32,
        port_conflict_words=None, free_dyn_delta=neutral.zeros_i32,
        dev_free=neutral.zeros_dev, dev_aff_score=neutral.zeros_f32,
        has_dev_affinity=False, job_tg_count=neutral.zeros_i32,
        job_any_count=neutral.zeros_i32, distinct_hosts_job=False,
        distinct_hosts_tg=False, penalty=neutral.zeros_bool,
        aff_score=neutral.zeros_f32, has_affinities=False, spreads=[],
        ask=AskTensor(cpu=500.0, mem=256.0, disk=150.0, reserved_ports=[],
                      dev_counts=np.zeros(MAX_DEV_REQS, np.int32)),
        desired_count=K_PLACE)
    return build_kernel_in(cluster, ev, K_PLACE)


def make_member(base, cluster, variant: str, rng):
    """One member of ``variant``: a C2M job shape's ask plus the
    variant's per-member planes."""
    n, n_pad = cluster.n_real, cluster.n_pad
    shape = rng.choice(len(C2M_SHAPE_CPU), p=C2M_SHAPE_P / C2M_SHAPE_P.sum())
    kin = base._replace(
        ask_cpu=np.asarray(C2M_SHAPE_CPU[shape], np.float32),
        ask_mem=np.asarray(C2M_SHAPE_MEM[shape], np.float32),
        desired_count=np.asarray(int(rng.integers(K_PLACE, 4 * K_PLACE)),
                                 np.int32))
    f = variant_features(variant)
    if f.with_shuffle:
        kin = kin._replace(node_perm=rng.permutation(n_pad).astype(np.int32))
    if f.with_step_penalties:
        kp = pad_steps(K_PLACE)
        pen = np.full((kp, MAX_PENALTY_NODES), -1, np.int32)
        pen[:3, 0] = rng.integers(0, n, 3)
        pref = np.full(kp, -1, np.int32)
        pref[int(rng.integers(0, K_PLACE))] = rng.integers(0, n)
        kin = kin._replace(step_penalty=pen, step_preferred=pref)
    if f.with_ports:
        kin = kin._replace(
            port_conflict=rng.random(n_pad) < 0.3,
            ask_has_reserved_ports=np.asarray(True),
            ask_dyn_ports=np.asarray(2, np.int32))
    if f.with_distinct:
        kin = kin._replace(
            job_tg_count=rng.integers(0, 2, n_pad).astype(np.int32),
            job_any_count=rng.integers(0, 3, n_pad).astype(np.int32),
            distinct_hosts_job=np.asarray(variant == "kitchen_sink"),
            distinct_hosts_tg=np.asarray(True))
    return kin, f


def spread_member(base, cluster):
    """A member with one even-spread stanza over the rack attribute."""
    racks = np.full(cluster.n_pad, -1, np.int32)
    racks[:cluster.n_real] = [int(c.split("-")[1]) % SPREAD_BUCKETS
                              for c in cluster.computed_classes]
    s = base.spread_active.shape[0]
    active = np.zeros(s, bool)
    active[0] = True
    bucket = np.full((s, cluster.n_pad), -1, np.int32)
    bucket[0] = racks
    kin = base._replace(
        spread_active=active, spread_even=active.copy(),
        spread_weight=active.astype(np.float32), spread_bucket=bucket,
        spread_counts=np.zeros((s, SPREAD_BUCKETS), np.float32),
        spread_desired=np.full((s, SPREAD_BUCKETS), -1.0, np.float32))
    return kin, variant_features("shuffle")._replace(n_spreads=1)


def wave_of(base, cluster, variant: str, rng, dev):
    members = [make_member(base, cluster, variant, rng)
               for _ in range(B_WAVE)]
    return coalesce.assemble_wave([m[0] for m in members],
                                  [K_STEPS] * B_WAVE,
                                  [m[1] for m in members], dev)


def compare(got, want, wave, ctx: str) -> dict:
    """Kernel against plain on one wave. Exact: choices, found, top-k
    indices, metrics; scores, top-k scores and carries within ATOL. The
    first differing step is excused only as a near-tie (the plain
    version's values at the differing top-k position within NEAR_TIE);
    the wave's later steps then run on other carries and are not
    compared."""
    t, b = wave.t_pad, wave.b_pad
    g = unpack_fused_wave(got.packed.cpu().numpy(), t, b)
    w = unpack_fused_wave(want.packed.cpu().numpy(), t, b)
    for name in FUSED_METRIC_FIELDS:
        check(np.array_equal(g[name], w[name]), f"{ctx}: {name} differs")
    gi, wi = got.topk_idx.cpu().numpy(), want.topk_idx.cpu().numpy()
    gs, ws = got.topk_scores.cpu().numpy(), want.topk_scores.cpu().numpy()
    differs = (g["chosen"] != w["chosen"]) | (g["found"] != w["found"]) \
        | np.any(gi != wi, axis=1)
    bad = np.nonzero(differs)[0]
    near_ties = 0
    upto = t
    if len(bad):
        s = int(bad[0])
        q = int(np.nonzero(gi[s] != wi[s])[0][0]) if np.any(
            gi[s] != wi[s]) else 0
        row = ws[s]
        gaps = [abs(row[q] - row[q + 1])] if q + 1 < len(row) else []
        if q > 0:
            gaps.append(abs(row[q - 1] - row[q]))
        check(min(gaps) < NEAR_TIE,
              f"{ctx}: step {s} differs at top-k slot {q} and is no "
              f"near-tie (plain values {row.tolist()})")
        near_ties, upto = 1, s
    errs = [np.abs(g["scores"][:upto] - w["scores"][:upto]).max(initial=0.0),
            np.abs(gs[:upto] - ws[:upto]).max(initial=0.0)]
    if not len(bad):
        for name in ("a_cpu", "a_mem", "a_disk"):
            errs.append(float((getattr(got, name)
                               - getattr(want, name)).abs().max()))
    err = float(max(errs))
    check(err <= ATOL, f"{ctx}: max abs error {err} > {ATOL}")
    return {"ctx": ctx, "near_ties": near_ties,
            "steps_not_compared": t - upto, "max_abs_err": err,
            "placed": int(g["found"].sum()),
            "active_steps": active_steps(wave)}


def active_steps(wave) -> int:
    """Steps that place for a real member (the rest are padding)."""
    sm = wave.step_member.cpu().numpy()
    n_steps = wave.kin.n_steps.cpu().numpy()
    ok = sm >= 0
    return int(np.sum(ok & (wave.step_local.cpu().numpy()
                            < n_steps[np.clip(sm, 0, None)])))


def capacity_ok(cluster, resident, ctx: str) -> None:
    for plane, cap in (("used_cpu", cluster.cap_cpu),
                       ("used_mem", cluster.cap_mem),
                       ("used_disk", cluster.cap_disk)):
        used = getattr(resident, plane).cpu().numpy()
        over = int(np.sum(used > cap + 1e-3))
        check(over == 0, f"{ctx}: {over} nodes over capacity in {plane}")


def wave_ops(wave) -> int:
    """f32 operations the fused wave needs: a step changes only the
    chosen node's carries, so each member with a step scores every node
    once; each active step then selects over every node (argmax and
    top-8 compares) and rescores the chosen node and its penalty nodes;
    plus the metrics pass over every (member, node)."""
    n = wave.kin.cap_cpu.shape[-1]
    sm = wave.step_member.cpu().numpy()
    members = len(np.unique(sm[sm >= 0]))
    active = active_steps(wave)
    return (members * n * OPS_PER_NODE_SCORE
            + active * (n * OPS_PER_NODE_SELECT
                        + (1 + MAX_PENALTY_NODES) * OPS_PER_NODE_SCORE)
            + wave.b_pad * n * OPS_PER_NODE_METRIC)


def wave_bytes(wave, out) -> int:
    """Bytes the fused wave must move: each input leaf the kernel reads
    once (shared leaves once, stacked ones per member), the step maps,
    and each output written once."""
    total = wave.step_member.nbytes + wave.step_local.nbytes
    for name, _ in ck._LEAVES:
        total += getattr(wave.kin, name).nbytes
    return total + sum(x.nbytes for x in out)


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if sys.argv[1:2] == ["--warm-start"]:
        return warm_start_child(*sys.argv[2:6])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    record: dict = {}
    t_start = time.perf_counter()

    # ---- 1. card and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    t0 = time.perf_counter()
    builds = ck.load_libraries()
    record["build_s"] = time.perf_counter() - t0
    ptxas = [ln.strip() for b in builds.values() for ln in b.log.splitlines()
             if any(k in ln for k in ("registers", "spill", "smem",
                                      "Compiling entry"))]
    for ln in ptxas:
        log(f"ptxas: {ln}")
    record["ptxas"] = ptxas
    for name, b in builds.items():
        log(f"build: {b.path} (cached={b.cached})")
    log(f"build: {len(builds)} libraries in {record['build_s']:.2f} s")

    kline = run_phases(dev, record)
    kline["kernels"] += run_batch_phases(dev, record)
    sched, state_bytes = run_sched_phase(dev, record)
    kline["kernels"][0]["sched_launches"] = sched["b1_launches"]
    server = run_server_phase(dev, record, state_bytes)
    run_warm_start_phase(record, state_bytes)
    del state_bytes
    kline["kernels"][0]["server_launches"] = sum(
        arm["b1_launches"] for arm in server)
    record["card"] = smi
    record["total_s"] = time.perf_counter() - t_start
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total: {record['total_s']:.1f} s")

    print(json.dumps(kline))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(dev: torch.device, record: dict) -> dict:
    """Phases 2-6 on ``dev``; returns the kernels' JSON line."""
    # ---- 2. kernel against plain at the live shape ----
    rng = np.random.default_rng(SEED)
    cluster = c2m_cluster(10_000, seed=SEED)
    ucpu, umem, udisk, clipped = c2m_pack_usage(cluster, 100_000, seed=SEED)
    log(f"cluster: {cluster.n_real} nodes, N={cluster.n_pad}, "
        f"100000 allocs, {clipped} nodes clipped at 90%")
    base = base_kin(cluster, (ucpu, umem, udisk))
    live = []
    waves = {}
    for variant in VARIANTS:
        wave = wave_of(base, cluster, variant, rng, dev)
        check(wave.t_pad == 512 and wave.kin.cap_cpu.dim() == 1,
              f"{variant}: unexpected wave layout")
        got = ck.fused_wave_place(wave.kin, wave.step_member,
                                  wave.step_local, wave.t_pad,
                                  wave.features)
        want = ck.fused_wave_place_reference(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features)
        torch.cuda.synchronize()
        res = compare(got, want, wave, f"live/{variant}")
        log(f"live {variant}: {json.dumps(res)}")
        check(res["placed"] > 0, f"live/{variant}: nothing placed")
        live.append(res)
        waves[variant] = wave
    live_steps = sum(r["active_steps"] for r in live)
    live_ties = sum(r["near_ties"] for r in live)
    log(f"live near-ties: {live_ties} of {live_steps} active steps")
    record["live"] = live

    # ---- 3. the main path: coalesced waves into resident usage ----
    resident = coalesce.ResidentUsage(ucpu, umem, udisk, device=dev)
    init = [x.copy() for x in (ucpu, umem, udisk)]
    co = coalesce.LaunchCoalescer(B_WAVE, device=dev, resident=resident)
    placed = [[] for _ in range(B_WAVE)]
    prep_s = [0.0] * B_WAVE       # host seconds building members, per thread
    launch_s = [0.0] * B_WAVE     # host seconds inside co.launch, per thread
    errors: list = []
    mix = ("shuffle",) * 6 + ("ports", "ports", "penalty_preferred",
                              "distinct")

    # 32 member builds on this thread alone: what one round's preparation
    # costs when the builds cannot overlap
    srng = np.random.default_rng(SEED + 999)
    t0 = time.perf_counter()
    for r in range(B_WAVE):
        make_member(base, cluster, mix[r % len(mix)], srng)
    serial_prep_s = time.perf_counter() - t0

    def evaluator(tid: int) -> None:
        trng = np.random.default_rng(SEED + 1000 + tid)
        try:
            for r in range(MAIN_ROUNDS):
                variant = mix[(tid + r) % len(mix)]
                t_a = time.perf_counter()
                kin, f = make_member(base, cluster, variant, trng)
                t_b = time.perf_counter()
                out = co.launch(kin, K_STEPS, f)
                t_c = time.perf_counter()
                prep_s[tid] += t_b - t_a
                launch_s[tid] += t_c - t_b
                if len(out.chosen) != K_STEPS:
                    errors.append(f"thread {tid}: slice of "
                                  f"{len(out.chosen)} steps")
                rows = np.asarray(out.chosen)[np.asarray(out.found)]
                placed[tid].append((rows, float(kin.ask_cpu),
                                    float(kin.ask_mem),
                                    float(kin.ask_disk)))
        except Exception as e:      # noqa: BLE001 - checked after join
            errors.append(f"thread {tid}: {e!r}")
        finally:
            co.done()

    ck.launches = 0
    coalesce.fused_wave_stats.reset()
    coalesce.wave_stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=evaluator, args=(i,))
               for i in range(B_WAVE)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = ck.launches
    check(not any(th.is_alive() for th in threads), "main path hung")
    check(not errors, f"main path errors: {errors[:3]}")
    fstats = coalesce.fused_wave_stats.snapshot()
    wstats = coalesce.wave_stats.snapshot()
    check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
          f"composite fallbacks or failed waves: {fstats}")
    check(main_launches == fstats["launches"] == co.launches,
          f"kernel launches {main_launches} != fused waves {fstats} / "
          f"coalescer waves {co.launches}")
    check(co.launches >= MAIN_ROUNDS, f"only {co.launches} waves")
    check(main_launches > 0, "the main path never launched the kernel")
    capacity_ok(cluster, resident, "main path")
    # every member got its own slice: replaying each member's own
    # placements with its own ask reproduces the committed usage
    want = [x.astype(np.float64) for x in init]
    n_placed = 0
    for rows_list in placed:
        for rows, ac, am, ad in rows_list:
            check(np.all((rows >= 0) & (rows < cluster.n_real)),
                  "placement outside the real nodes")
            np.add.at(want[0], rows, ac)
            np.add.at(want[1], rows, am)
            np.add.at(want[2], rows, ad)
            n_placed += len(rows)
    for plane, w in zip(("used_cpu", "used_mem", "used_disk"), want):
        got = getattr(resident, plane).cpu().numpy()
        err = float(np.abs(got - w).max())
        check(err <= 1e-2, f"main path: {plane} differs from the members' "
              f"own placements by {err}")
    check(n_placed > 0, "main path placed nothing")
    evals = B_WAVE * MAIN_ROUNDS
    main = {"waves": co.launches, "kernel_launches": main_launches,
            "fallbacks": fstats["fallbacks"], "evals": evals,
            "placements": n_placed, "wall_s": wall,
            "evals_per_s": evals / wall,
            "round_ms": wall * 1e3 / MAIN_ROUNDS,
            "member_prep_ms_per_round": float(np.mean(prep_s)) * 1e3
            / MAIN_ROUNDS,
            "launch_ms_per_round": float(np.mean(launch_s)) * 1e3
            / MAIN_ROUNDS,
            "serial_32_member_builds_ms": serial_prep_s * 1e3,
            "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
            "wave_latency_p99_ms": wstats["wave_latency_p99_ms"],
            "park_latency_p50_ms": wstats["park_latency_p50_ms"],
            "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
            "assemble_latency_p99_ms": wstats["assemble_latency_p99_ms"],
            "fill_ratio": wstats["fill_ratio"],
            "deadline_launches": wstats["deadline_launches"]}
    log(f"main path: {json.dumps(main)}")
    record["main"] = main

    # ---- 4. the composite on the card: one wave with a spread member ----
    coalesce.fused_wave_stats.reset()
    before = ck.launches
    members = [spread_member(base, cluster)] + [
        make_member(base, cluster, "shuffle", rng)
        for _ in range(B_WAVE - 1)]
    t0 = time.perf_counter()
    outs = coalesce.launch_wave([m[0] for m in members],
                                [K_STEPS] * B_WAVE,
                                [m[1] for m in members], device=dev,
                                resident=resident)
    comp_s = time.perf_counter() - t0
    fstats = coalesce.fused_wave_stats.snapshot()
    check(fstats == {"launches": 0, "fallbacks": 1, "failures": 0},
          f"composite wave stats {fstats}")
    check(ck.launches == before, "the composite wave launched the kernel")
    check(all(len(o.chosen) == K_STEPS for o in outs), "composite slices")
    check(sum(int(np.asarray(o.found).sum()) for o in outs) > 0,
          "composite wave placed nothing")
    capacity_ok(cluster, resident, "composite")
    record["composite"] = {"fallbacks": 1, "wave_s": comp_s}
    log(f"composite: spread wave in {comp_s:.3f} s, 1 fallback")

    # ---- 5. scale: 100k nodes, 1M allocs ----
    big = c2m_cluster(100_000, seed=SEED + 1)
    bc, bm, bd, bclip = c2m_pack_usage(big, 1_000_000, seed=SEED + 1)
    bbase = base_kin(big, (bc, bm, bd))
    scale = []
    for variant in ("shuffle", "kitchen_sink"):
        wave = wave_of(bbase, big, variant, rng, dev)
        check(wave.kin.cap_cpu.shape[-1] == 131072, "scale N")
        got = ck.fused_wave_place(wave.kin, wave.step_member,
                                  wave.step_local, wave.t_pad, wave.features)
        want = ck.fused_wave_place_reference(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features)
        torch.cuda.synchronize()
        res = compare(got, want, wave, f"scale/{variant}")
        log(f"scale {variant}: {json.dumps(res)}")
        scale.append(res)
        ms_big = cuda_ms(lambda: ck.fused_wave_place(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features), 3)
        res["ms"] = ms_big
    record["scale"] = {"nodes": 100_000, "n_pad": big.n_pad,
                       "allocs": 1_000_000, "clipped": bclip,
                       "waves": scale}
    ties = live_ties + sum(r["near_ties"] for r in scale)
    steps = live_steps + sum(r["active_steps"] for r in scale)
    log(f"near-ties: {ties} of {steps} active steps")
    check(ties <= 0.01 * steps, f"near-ties {ties} > 1% of {steps} steps")

    # ---- 6. times at the live shape (the main path's wave union) ----
    wave = waves["kitchen_sink"]

    def kernel():
        return ck.fused_wave_place(wave.kin, wave.step_member,
                                   wave.step_local, wave.t_pad,
                                   wave.features)

    def plain():
        return ck.fused_wave_place_reference(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features)

    for _ in range(3):
        out = kernel()
    kernel_ms = cuda_ms(kernel, 20)
    plain()
    plain_ms = cuda_ms(plain, 2)
    n = wave.kin.cap_cpu.shape[-1]
    active = active_steps(wave)
    nbytes = wave_bytes(wave, out)
    ops = wave_ops(wave)
    bound_ms, bound_by = bound(nbytes, ops)
    max_err = max(r["max_abs_err"] for r in live + scale)
    cluster_ctas = ck.fused_wave_cluster_size()
    us_per_step = kernel_ms * 1e3 / active
    log(f"b1: {kernel_ms:.4f} ms per live wave, {us_per_step:.3f} us per "
        f"active step ({active} active of {wave.t_pad}), cluster of "
        f"{cluster_ctas} CTAs; scale waves "
        f"{[round(r['ms'], 4) for r in scale]} ms")
    kline = {"kernels": [{
        "name": "fused_wave_place",
        "route": "cuda",
        "source": "nomad_tpu_torch/csrc/fused_wave.cu",
        "replaces": "nomad_tpu/ops/pallas_kernel.py:600",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "cluster": cluster_ctas,
    }]}
    record["times"] = {"bytes": nbytes, "ops": ops, "active_steps": active,
                       "us_per_active_step": us_per_step,
                       "cluster": cluster_ctas,
                       "n": n, "b": wave.b_pad, "t": wave.t_pad}
    record["kernels"] = kline["kernels"]
    return kline


# ---------------------------------------------------------------------------
# Phases 7-9: the batched schedule-apply path (B3 and B2).
# ---------------------------------------------------------------------------

BATCH_B3 = 512       # bench.py BATCH: the full-width kernel's batch
STEPS_B3 = 4         # kernel-step batches on the B3 path
SCALE_NODES = 100_000   # B3's second width: N=131072
BATCH_B2 = 8192      # bench.py _bench_batch on an accelerator
BATCHES_B2 = 25      # 8192 x 25 evals, the bench's burst
REPLAY_BATCHES = 4
K_CAND = 64          # pallas_topk_place_batch's default candidate count
B2_MEMORY_LIMIT = 64 << 20   # B2's peak allocation over one batch, bytes
#: f32 operations of the lean score of one node: fit compares (6),
#: utilization adds and free fractions (6), two pow, the fit sum, clamps,
#: select and scale (7), anti-affinity (4), plane sums and the final
#: divide (4)
OPS_PER_LEAN_SCORE = 27


def lean_ops(n_steps, k_steps: int, scored: int, width: int) -> int:
    """f32 operations a lean batch placement needs over ``width`` nodes,
    ``scored`` of them in the base mask: a step changes only the chosen
    node's carries, so each eval scores every base node once and tests
    the mask of the rest, then each active step takes one argmax compare
    per base node and rescores the chosen node. A node outside the base
    mask (the padding, or a node no eval may use) needs its mask test
    and nothing more."""
    evals = int((n_steps > 0).sum())
    active = int(np.minimum(n_steps, k_steps).sum())
    return evals * (scored * OPS_PER_LEAN_SCORE + width - scored) + active * (
        scored + OPS_PER_LEAN_SCORE)


def topk_ops(n_steps, k_steps: int, kc: int, scored: int, width: int) -> int:
    """f32 operations B2 needs: per eval every base node scored once and
    compared once for the selection, the mask of every other node tested,
    then each active step one argmax compare per candidate and one
    rescore of the chosen node."""
    evals = int((n_steps > 0).sum())
    active = int(np.minimum(n_steps, k_steps).sum())
    return evals * (scored * (OPS_PER_LEAN_SCORE + 1) + width - scored) + (
        active * (kc + OPS_PER_LEAN_SCORE))


def compare_lean(got, want, n_steps, ctx: str) -> dict:
    """A batch kernel against its plain version: chosen and found exact,
    scores within ATOL. An eval whose choices differ is excused only as a
    near-tie (at its first differing step both picks score within
    NEAR_TIE); its later steps run on other carries and are not
    compared."""
    gc, wc = got[0].cpu().numpy(), want[0].cpu().numpy()
    gs, ws = got[1].cpu().numpy(), want[1].cpu().numpy()
    gf, wf = got[2].cpu().numpy(), want[2].cpu().numpy()
    keep = np.ones(gc.shape, bool)
    near_ties = 0
    for r in np.nonzero(((gc != wc) | (gf != wf)).any(axis=1))[0]:
        s = int(np.nonzero((gc[r] != wc[r]) | (gf[r] != wf[r]))[0][0])
        check(gf[r, s] and wf[r, s] and abs(gs[r, s] - ws[r, s]) < NEAR_TIE,
              f"{ctx}: eval {r} differs at step {s} and is no near-tie "
              f"({gc[r, s]}: {gs[r, s]} vs {wc[r, s]}: {ws[r, s]})")
        near_ties += 1
        keep[r, s:] = False
    err = float(np.abs(gs - ws)[keep].max(initial=0.0))
    check(err <= ATOL, f"{ctx}: max abs error {err} > {ATOL}")
    active = int(np.minimum(n_steps.cpu().numpy(), gc.shape[1]).sum())
    return {"ctx": ctx, "near_ties": near_ties, "active_steps": active,
            "max_abs_err": err, "placed": int(gf.sum())}


def lean_bytes(v: dict, out) -> int:
    """Bytes a batch kernel must move: each lean argument once (the
    shared planes once, not once per eval) and each output once."""
    return sum(x.nbytes for x in v.values()) + sum(x.nbytes for x in out)


def over_capacity(kin, uc, um) -> int:
    """Nodes whose committed cpu or mem exceeds their capacity."""
    return int(np.sum((uc.cpu().numpy() > kin.cap_cpu + 1e-3)
                      | (um.cpu().numpy() > kin.cap_mem + 1e-3)))


def best_of_2(fn) -> tuple:
    """(seconds, result): host clock ending in synchronize, best of 2."""
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), res


def run_batch_phases(dev: torch.device, record: dict) -> list:
    """Phases 7-9 on ``dev``; returns the B3 and B2 kernel entries."""
    # ---- 7. B3: place_batch against plain, then the kernel step ----
    prob = throughput_problem(STEPS_B3, BATCH_B3, seed=7)
    shared = batching.device_put_shared(prob.kin, dev)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    uc0, um0, ns = on(prob.used_cpu), on(prob.used_mem), on(prob.n_steps)
    asks = (on(prob.ask_cpu), on(prob.ask_mem))
    check(shared.cap_cpu.shape[0] == 16384, "throughput N")
    lean = batching._lean_args(shared, uc0, um0, asks[0][0], asks[1][0], ns)
    got = ck.place_batch(*lean, k_steps=K_PLACE)
    want = ck.place_batch_reference(*lean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    b3 = compare_lean(got, want, ns, "b3/place_batch")
    log(f"b3 kernel vs plain: {json.dumps(b3)}")
    check(b3["placed"] > 0, "b3: nothing placed")
    check(b3["near_ties"] <= 0.01 * b3["active_steps"],
          f"b3 near-ties {b3['near_ties']} > 1% of {b3['active_steps']}")
    big = throughput_problem(1, BATCH_B3, n_nodes=SCALE_NODES, seed=8)
    bshared = batching.device_put_shared(big.kin, dev)
    check(bshared.cap_cpu.shape[0] == 131072, "B3 scale N")
    blean = batching._lean_args(bshared, on(big.used_cpu), on(big.used_mem),
                                on(big.ask_cpu[0]), on(big.ask_mem[0]),
                                on(big.n_steps))
    bgot = ck.place_batch(*blean, k_steps=K_PLACE)
    bwant = ck.place_batch_reference(*blean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    b3_big = compare_lean(bgot, bwant, on(big.n_steps), "b3/n131072")
    check(b3_big["placed"] > 0, "b3 scale: nothing placed")
    check(b3_big["near_ties"] <= 0.01 * b3_big["active_steps"],
          f"b3 scale near-ties {b3_big['near_ties']}")
    b3_big["ms"] = cuda_ms(lambda: ck.place_batch(*blean, k_steps=K_PLACE),
                           5)
    log(f"b3 at N=131072: {json.dumps(b3_big)}")
    del bshared, blean, bgot, bwant

    kstep = batching.make_schedule_apply_step_kernel(K_PLACE)
    pstep = batching.make_schedule_apply_step(K_PLACE, LEAN_FEATURES)
    ku, km = pu, pm = uc0, um0
    kstep(shared, ku, km, asks[0][0], asks[1][0], ns)   # first-call costs
    ck.place_batch_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(STEPS_B3):
        out, ku, km = kstep(shared, ku, km, asks[0][t], asks[1][t], ns)
    torch.cuda.synchronize()
    kstep_s = time.perf_counter() - t0
    b3_launches = ck.place_batch_launches
    check(b3_launches == STEPS_B3,
          f"b3 path: {b3_launches} kernel launches for {STEPS_B3} steps")
    for t in range(STEPS_B3):
        _, pu, pm = pstep(shared, pu, pm, asks[0][t], asks[1][t], ns)
    plane_err = max(float((ku - pu).abs().max()), float((km - pm).abs().max()))
    check(plane_err <= 1e-2, f"b3 path: committed planes differ by "
          f"{plane_err}")
    check(torch.equal(uc0, on(prob.used_cpu)), "b3 path wrote its input")
    b3.update(steps=STEPS_B3, launches=b3_launches, plane_err=plane_err,
              step_s=kstep_s / STEPS_B3,
              over_capacity=over_capacity(prob.kin, ku, km),
              n131072=b3_big)
    log(f"b3 path: {json.dumps(b3)}")
    record["b3"] = b3

    v3 = ck._lean_inputs(lean, K_PLACE)
    for _ in range(3):
        ck.place_batch(*lean, k_steps=K_PLACE)
    b3_ms = cuda_ms(lambda: ck.place_batch(*lean, k_steps=K_PLACE), 20)
    b3_plain_ms = cuda_ms(
        lambda: ck.place_batch_reference(*lean, k_steps=K_PLACE), 3)
    b3_bound, b3_by = bound(
        lean_bytes(v3, got),
        lean_ops(prob.n_steps, K_PLACE, int(v3["base_mask"].sum()),
                 v3["cap_cpu"].shape[0]))

    # ---- 8. B2 and the loop at the bench shape ----
    prob = throughput_problem(BATCHES_B2, BATCH_B2, seed=7)
    ns = on(prob.n_steps)
    asks = (on(prob.ask_cpu), on(prob.ask_mem))
    lean = batching._lean_args(shared, uc0, um0, asks[0][0], asks[1][0], ns)
    ck.topk_place_batch(*lean, k_steps=K_PLACE)      # first-call costs
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = ck.topk_place_batch(*lean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    log(f"b2 peak allocation over one batch: {peak} B above {base_mem} B")
    check(peak <= B2_MEMORY_LIMIT,
          f"b2: {peak} B allocated over one batch > {B2_MEMORY_LIMIT}")
    want = ck.topk_place_batch_reference(*lean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    for name, g, w in zip(("chosen", "found", "valid"),
                          (got[0], got[2], got[3]), (want[0], want[2], want[3])):
        check(torch.equal(g, w), f"b2/topk_place_batch: {name} differs")
    b2_err = float((got[1] - want[1]).abs().max())
    check(b2_err <= ATOL, f"b2: max abs error {b2_err} > {ATOL}")
    b2 = {"max_abs_err": b2_err, "invalid": int((~got[3]).sum()),
          "placed": int(got[2].sum()), "peak_alloc_bytes": peak}
    log(f"b2 kernel vs plain: {json.dumps(b2)}")

    kloop = batching.make_schedule_apply_loop(
        K_PLACE, LEAN_FEATURES, topk=True, backend="kernel_topk")
    tloop = batching.make_schedule_apply_loop(K_PLACE, LEAN_FEATURES,
                                              topk=True)
    ck.topk_place_batch_launches = 0
    k_s, kres = best_of_2(lambda: kloop(shared, uc0, um0, *asks, ns))
    b2_launches = ck.topk_place_batch_launches
    check(b2_launches == 2 * BATCHES_B2,
          f"b2 path: {b2_launches} kernel launches for the 2 x {BATCHES_B2} "
          "batches run")
    t_s, tres = best_of_2(lambda: tloop(shared, uc0, um0, *asks, ns))
    loop = compare_loops(kres, tres, prob.kin, "loop")
    evals = BATCH_B2 * BATCHES_B2
    loop.update(batches=BATCHES_B2, runs=2, evals=evals,
                launches=b2_launches,
                kernel_topk_s=k_s, torch_s=t_s,
                kernel_topk_evals_per_s=evals / k_s,
                torch_evals_per_s=evals / t_s)
    log(f"loop: {json.dumps(loop)}")
    record["b2"] = {**b2, "loop": loop}

    v2 = ck._lean_inputs(lean, K_PLACE)
    for _ in range(3):
        out = ck.topk_place_batch(*lean, k_steps=K_PLACE)
    b2_ms = cuda_ms(lambda: ck.topk_place_batch(*lean, k_steps=K_PLACE), 20)
    b2_plain_ms = cuda_ms(
        lambda: ck.topk_place_batch_reference(*lean, k_steps=K_PLACE), 3)
    commit_ms = cuda_ms(lambda: batching.commit_placements(
        uc0, um0, out[0], out[2], asks[0][0], asks[1][0]), 20)
    b2_bound, b2_by = bound(
        lean_bytes(v2, out),
        topk_ops(prob.n_steps, K_PLACE, K_CAND, int(v2["base_mask"].sum()),
                 v2["cap_cpu"].shape[0]))
    batch_ms = k_s / BATCHES_B2 * 1e3
    split = {"kernel_ms": b2_ms, "commit_ms": commit_ms,
             "batch_ms": batch_ms,
             "rest_of_batch_ms": batch_ms - b2_ms - commit_ms,
             "fallback_rows": loop["fallback_kernel_topk"]}
    log(f"b2 batch split: {json.dumps(split)}")
    record["b2"]["split"] = split

    # ---- 9. the replay form: reset_every=1 on a C2M cluster ----
    c2m = c2m_cluster(10_000, seed=SEED)
    ucpu, umem, udisk, _ = c2m_pack_usage(c2m, 100_000, seed=SEED)
    rkin = synthetic_kin_for(c2m, udisk)
    rshared = batching.device_put_shared(rkin, dev)
    rng = np.random.default_rng(SEED + 9)
    shapes = rng.choice(len(C2M_SHAPE_CPU), (REPLAY_BATCHES, BATCH_B2),
                        p=C2M_SHAPE_P / C2M_SHAPE_P.sum())
    rasks = (on(C2M_SHAPE_CPU[shapes]), on(C2M_SHAPE_MEM[shapes]))
    rloop = batching.make_schedule_apply_loop(
        K_PLACE, LEAN_FEATURES, topk=True, backend="kernel_topk",
        reset_every=1)
    ck.topk_place_batch_launches = 0
    r_s, rres = best_of_2(lambda: rloop(rshared, on(ucpu), on(umem), *rasks,
                                        ns))
    check(ck.topk_place_batch_launches == 2 * REPLAY_BATCHES,
          f"replay: {ck.topk_place_batch_launches} kernel launches")
    tres = batching.make_schedule_apply_loop(
        K_PLACE, LEAN_FEATURES, topk=True, reset_every=1)(
        rshared, on(ucpu), on(umem), *rasks, ns)
    replay = compare_loops(rres, tres, rkin, "replay")
    check(replay["placed"] > 0, "replay placed nothing")
    evals = BATCH_B2 * REPLAY_BATCHES
    replay.update(batches=REPLAY_BATCHES, evals=evals,
                  evals_per_s=evals / r_s)
    log(f"replay: {json.dumps(replay)}")
    record["replay"] = replay

    return [
        {"name": "place_batch", "route": "cuda",
         "source": "nomad_tpu_torch/csrc/place_batch.cu",
         "replaces": "nomad_tpu/ops/pallas_kernel.py:218",
         "launches": b3_launches, "max_abs_err": b3["max_abs_err"],
         "ms": b3_ms, "plain_ms": b3_plain_ms, "bound_ms": b3_bound,
         "bound_by": b3_by, "library_ms": None},
        {"name": "topk_place_batch", "route": "cuda",
         "source": "nomad_tpu_torch/csrc/topk_place_batch.cu",
         "replaces": "nomad_tpu/ops/pallas_kernel.py:377",
         "launches": b2_launches, "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None},
    ]


def synthetic_kin_for(cluster, used_disk):
    """The replay's shared planes (bench.py ``run_replay``): one lean
    eval over ``cluster`` with the resident disk usage and 150 MB disk
    asks."""
    ev = synthetic_eval(cluster, desired_count=K_PLACE)
    kin = build_kernel_in(cluster, ev, K_PLACE)
    return kin._replace(used_disk=used_disk,
                        ask_disk=np.asarray(150.0, np.float32))


def compare_loops(kres, tres, kin, ctx: str) -> dict:
    """The kernel_topk loop against the torch loop: placed exact,
    score_sum to rel 1e-5, final used planes within 1e-2. Both commit
    every accepted placement of a batch (optimistic concurrency), so a
    node may end over capacity in both; the counts must agree."""
    ks, kp, kf, ku, km = kres
    ts, tp_, tf, tu, tm = tres
    check(int(kp) == int(tp_), f"{ctx}: placed {int(kp)} vs {int(tp_)}")
    rel = abs(float(ks) - float(ts)) / max(abs(float(ts)), 1e-30)
    check(rel <= 1e-5, f"{ctx}: score_sum rel error {rel}")
    err = max(float((ku - tu).abs().max()), float((km - tm).abs().max()))
    check(err <= 1e-2, f"{ctx}: final planes differ by {err}")
    check(bool(torch.isfinite(ku).all() and torch.isfinite(km).all()),
          f"{ctx}: non-finite planes")
    over = (over_capacity(kin, ku, km), over_capacity(kin, tu, tm))
    check(over[0] == over[1], f"{ctx}: over-capacity nodes {over}")
    return {"placed": int(kp), "score_sum": float(ks),
            "score_sum_rel_err": rel, "plane_err": err,
            "fallback_kernel_topk": int(kf), "fallback_torch": int(tf),
            "over_capacity_nodes": over[0]}


# ---------------------------------------------------------------------------
# Phase 10: the scheduler path, from evaluations to committed plans.
# ---------------------------------------------------------------------------

SCHED_NODES = c2m.N_NODES     # the C2M replay cluster: 10,000 nodes
SCHED_ALLOCS = c2m.N_ALLOCS   # and 100,000 live allocations
SCHED_ROUNDS = 8
SCHED_EVALS = 32     # evals per round, one thread each (the worker batch)
SCHED_SINGLE = 8     # evals through the single-eval launcher


def store_over_capacity(state, clusters) -> int:
    """Nodes whose committed cpu, memory or disk in the store's usage
    planes exceeds their capacity net of the agent's reserve."""
    snap = state.snapshot()
    c = clusters.get(snap)
    used = c.gathered_usage(snap.usage)
    over = np.zeros(c.n_pad, bool)
    for plane, cap in zip(used[:3], (c.cap_cpu, c.cap_mem, c.cap_disk)):
        over |= plane > cap + 1e-3
    return int(over.sum())


class TimedHarness(Harness):
    """The ``Harness`` with its plan commit timed in two parts: the plan's
    deferred work (allocation metrics, read from the wave's top-k) and
    the store's commit, the wait for the harness lock included."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.deferred_s: list = []
        self.commit_s: list = []

    def submit_plan(self, plan):
        t0 = time.perf_counter()
        plan.run_deferred()
        t1 = time.perf_counter()
        out = super().submit_plan(plan)
        self.deferred_s.append(t1 - t0)
        self.commit_s.append(time.perf_counter() - t1)
        return out


class GcPauses:
    """A ``gc.callbacks`` entry: collections of the oldest generation and
    the seconds spent in all collections while it is registered."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.full = 0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.full += int(info["generation"] == 2)


def check_evals(harness, jobs, evals, ctx: str) -> None:
    """Every eval complete, no blocked eval, each job with its
    placements live in the store."""
    status = {e.id: e.status for e in harness.evals}
    bad = [e.id for e in evals
           if status.get(e.id) != consts.EVAL_STATUS_COMPLETE]
    check(not bad, f"{ctx}: {len(bad)} evals not complete, e.g. "
          f"{[status.get(b) for b in bad[:3]]}")
    check(not harness.create_evals,
          f"{ctx}: {len(harness.create_evals)} blocked or follow-up evals")
    snap = harness.state.snapshot()
    for job in jobs:
        live = [a for a in snap.allocs_by_job(job.namespace, job.id)
                if not a.terminal_status()]
        check(len(live) == c2m.BURST_COUNT,
              f"{ctx}: job {job.id} has {len(live)} live allocs")


def new_evals(harness, rng, first: int, n: int):
    """``n`` burst jobs registered in the store, one eval each."""
    jobs = [c2m.burst_job(rng, first + i, prefix="smoke") for i in range(n)]
    for job in jobs:
        harness.state.upsert_job(job)
    evals = [mock.eval(job_id=j.id, namespace=j.namespace, type=j.type,
                       priority=j.priority) for j in jobs]
    harness.state.upsert_evals(evals)
    return jobs, evals


def run_sched_phase(dev: torch.device, record: dict) -> dict:
    """Phase 10: the C2M replay state in the port's store, then rounds of
    evals through ``new_scheduler`` with ``LaunchCoalescer.launch`` as the
    launcher (``Worker._process_batch`` without the broker), plans
    committed through the ``Harness``; B1 against its plain version on a
    wave of the members round 1 built; then evals one at a time through
    the default single-eval launcher."""
    t0 = time.perf_counter()
    store = c2m.generate(SCHED_NODES, SCHED_ALLOCS)
    state_s = time.perf_counter() - t0
    snap = store.snapshot()
    n_allocs = sum(1 for _ in snap.allocs_iter())
    t0 = time.perf_counter()
    cluster = default_incremental_cluster_cache.get(snap)
    first_build_s = time.perf_counter() - t0
    # one node's attributes change: the next snapshot's cluster planes
    # come from a dirty-row delta build
    node = store.snapshot().node_by_id(cluster.node_ids[17]).copy()
    node.attributes = dict(node.attributes, **{"smoke.touched": "1"})
    node.compute_class()
    store.upsert_node(node)
    deltas = default_incremental_cluster_cache.delta_builds
    t0 = time.perf_counter()
    cluster = default_incremental_cluster_cache.get(store.snapshot())
    incremental_build_s = time.perf_counter() - t0
    check(default_incremental_cluster_cache.delta_builds == deltas + 1,
          "the node update did not take the delta build")
    log(f"sched state: {SCHED_NODES} nodes, {n_allocs} allocs, "
        f"N={cluster.n_pad}; generate {state_s:.2f} s, first build "
        f"{first_build_s:.3f} s, incremental build "
        f"{incremental_build_s:.4f} s")

    harness = TimedHarness(state=store, device=dev)
    rng = np.random.default_rng(SEED + 10)
    members: list = []          # round 1's (thread, seq, kin, k, f)
    split = {"before_launch": [], "in_launch": [], "after_launch": []}
    round_s, waves, errors = [], 0, []
    ck.launches = 0
    coalesce.fused_wave_stats.reset()
    coalesce.wave_stats.reset()
    coalesce.upload_stats.reset()
    default_device_state.reset_stats()
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    for r in range(SCHED_ROUNDS):
        jobs, evals = new_evals(harness, rng, r * SCHED_EVALS, SCHED_EVALS)
        snap = harness.state.snapshot()
        clusters = coalesce.ClusterCache(dev)
        co = coalesce.LaunchCoalescer(SCHED_EVALS, device=dev,
                                      adaptive=False)

        def evaluator(i: int, job, ev) -> None:
            spans = []

            def launch(kin, k_steps, features):
                if r == 0:
                    members.append((i, len(spans), kin, k_steps, features))
                t_a = time.perf_counter()
                try:
                    return co.launch(kin, k_steps, features)
                finally:
                    spans.append((t_a, time.perf_counter()))

            t_start = time.perf_counter()
            try:
                new_scheduler(job.type, snap, harness, device=dev,
                              kernel_launch=launch,
                              cluster_provider=clusters.get).process(ev)
            except Exception as e:      # noqa: BLE001 - checked after join
                errors.append(f"round {r} eval {i}: {e!r}")
            finally:
                co.done()
            total = time.perf_counter() - t_start
            before = spans[0][0] - t_start if spans else total
            inside = sum(b - a for a, b in spans)
            split["before_launch"].append(before)
            split["in_launch"].append(inside)
            split["after_launch"].append(total - before - inside)

        threads = [threading.Thread(target=evaluator, args=(i, j, e))
                   for i, (j, e) in enumerate(zip(jobs, evals))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        round_s.append(time.perf_counter() - t0)
        check(not any(th.is_alive() for th in threads), f"round {r} hung")
        check(not errors, f"scheduler path errors: {errors[:3]}")
        waves += co.launches
        check_evals(harness, jobs, evals, f"round {r}")
        over = store_over_capacity(harness.state, clusters)
        check(over == 0, f"round {r}: {over} nodes over capacity")
    b1_launches = ck.launches
    gc.callbacks.remove(pauses)
    deferred_s, commit_s = sum(harness.deferred_s), sum(harness.commit_s)
    fstats = coalesce.fused_wave_stats.snapshot()
    wstats = coalesce.wave_stats.snapshot()
    dstate = default_device_state.snapshot()
    uploads = (coalesce.upload_stats.uploads, coalesce.upload_stats.bytes)
    check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
          f"scheduler waves fell back or failed: {fstats}")
    check(dstate["errors"] == 0, f"scheduler path: device state errors: "
          f"{dstate}")
    check(b1_launches == fstats["launches"] == waves,
          f"B1 launches {b1_launches} != fused waves {fstats} / "
          f"coalescer waves {waves}")
    check(b1_launches > 0, "the scheduler path never launched B1")
    evals_total = SCHED_ROUNDS * SCHED_EVALS
    log(f"sched burst: {evals_total} evals in {waves} waves, "
        f"{b1_launches} B1 launches, 0 fallbacks")

    # B1 against its plain version on round 1's members, in a fixed order
    members.sort(key=lambda m: (m[0], m[1]))
    check(all(m[4].with_shuffle for m in members),
          "a scheduler member without its shuffle plane")
    wave = coalesce.assemble_wave([m[2] for m in members],
                                  [m[3] for m in members],
                                  [m[4] for m in members], dev)
    got = ck.fused_wave_place(wave.kin, wave.step_member, wave.step_local,
                              wave.t_pad, wave.features)
    want = ck.fused_wave_place_reference(
        wave.kin, wave.step_member, wave.step_local, wave.t_pad,
        wave.features)
    torch.cuda.synchronize()
    vs_plain = compare(got, want, wave, "sched/round1")
    check(vs_plain["placed"] == len(members) * c2m.BURST_COUNT,
          f"sched/round1 wave placed {vs_plain['placed']}")
    log(f"sched b1 vs plain: {json.dumps(vs_plain)}")

    # the single-eval route: one eval at a time, default launcher on dev
    single_eval_stats.reset()
    single_s = []
    for i in range(SCHED_SINGLE):
        jobs, evals = new_evals(harness, rng, 10_000 + i, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        harness.process(jobs[0].type, evals[0])
        single_s.append(time.perf_counter() - t0)
        check_evals(harness, jobs, evals, f"single eval {i}")
    single = single_eval_stats.snapshot()
    check(single["topk"] + single["full"] - single["breaches"]
          == SCHED_SINGLE, f"single-eval launches {single}")
    over = store_over_capacity(harness.state, coalesce.ClusterCache(dev))
    check(over == 0, f"single evals: {over} nodes over capacity")

    sched = {
        "nodes": SCHED_NODES, "allocs": n_allocs, "n_pad": cluster.n_pad,
        "state_s": state_s, "first_build_s": first_build_s,
        "incremental_build_s": incremental_build_s,
        "rounds": SCHED_ROUNDS, "evals": evals_total,
        "placements": evals_total * c2m.BURST_COUNT,
        "waves": waves, "b1_launches": b1_launches,
        "fallbacks": fstats["fallbacks"],
        "evals_per_s": evals_total / sum(round_s),
        "round_ms": float(np.mean(round_s)) * 1e3,
        "round_ms_each": [x * 1e3 for x in round_s],
        "round_ms_median": float(np.median(round_s)) * 1e3,
        "thread_ms": {k: float(np.mean(v)) * 1e3 for k, v in split.items()},
        # inside the threads' after-launch part, per eval: the plan's
        # deferred work and the store's commit (the harness lock's wait
        # included)
        "plan_deferred_ms": deferred_s / evals_total * 1e3,
        "plan_commit_ms": commit_s / evals_total * 1e3,
        "gc_s": pauses.seconds, "gc_full": pauses.full,
        "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
        "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
        "park_latency_p50_ms": wstats["park_latency_p50_ms"],
        # the rounds' waves only (the comparison wave and the single
        # evals come after these were read)
        "device_state": dstate,
        "wave_uploads": uploads[0], "wave_upload_bytes": uploads[1],
        "wave_upload_bytes_per_wave": uploads[1] / waves if waves else 0.0,
        "single_eval_ms": float(np.mean(single_s)) * 1e3,
        "single_eval_ms_each": [x * 1e3 for x in single_s],
        "single_eval_stats": single,
        "b1_vs_plain": vs_plain,
    }
    log(f"sched: {json.dumps(sched)}")
    record["sched"] = sched
    t0 = time.perf_counter()
    state_bytes = harness.state.to_snapshot_bytes()
    sched["snapshot_bytes_s"] = time.perf_counter() - t0
    return sched, state_bytes


# ---------------------------------------------------------------------------
# Phase 11: the server, from job registration to the group commit.
# ---------------------------------------------------------------------------

SERVER_WARMUP_JOBS = 40     # the JAX bench's E2E_WARMUP_JOBS
SERVER_JOBS = 200           # the timed burst (E2E_JOBS)
SERVER_BATCH = 32           # worker_batch_size (E2E_BATCH_SIZE)
SERVER_DEADLINE_S = 300.0   # per burst; a burst that takes longer fails
#: (gc_tuning, coalesce_adaptive) of each arm, in this order
SERVER_ARMS = ((False, True), (True, True), (True, False))


def rss_gb() -> float:
    """This process's resident memory (``VmRSS``), in GB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024 / 1e9
    return 0.0


def server_converged(srv, jobs, deadline: float) -> float:
    """Wait until the broker is empty, no worker holds an eval and every
    job has its allocations in the store (``bench/trace_report.py``'s
    steady burst waits on the broker the same way); returns the host
    clock at that moment. An eval leaves the worker's live set after its
    e2e sample is recorded."""
    want = len(jobs) * c2m.BURST_COUNT
    while time.time() < deadline:
        bs = srv.eval_broker.stats()
        if (bs["total_ready"] == 0 and bs["total_unacked"] == 0
                and bs["total_waiting"] == 0
                and not any(w._live for w in srv.workers)):
            t_done = time.perf_counter()
            snap = srv.state.snapshot()
            placed = sum(len(snap.allocs_by_job(j.namespace, j.id))
                         for j in jobs)
            if placed >= want:
                return t_done
        time.sleep(0.005)
    snap = srv.state.snapshot()
    statuses: dict = {}
    for e in snap.evals_iter():
        statuses[e.status] = statuses.get(e.status, 0) + 1
    fail(f"server burst of {len(jobs)} jobs did not converge: "
         f"{srv.eval_broker.stats()}, blocked {srv.blocked_evals.stats()}, "
         f"eval statuses {statuses}, waves {coalesce.wave_stats.snapshot()}, "
         f"device state {default_device_state.snapshot()}, "
         f"plan groups {plan_group_stats.snapshot()}")


def check_server_burst(srv, jobs, ctx: str) -> None:
    """Every job has its placements live, no eval failed, none is left in
    the broker (its failed queue included), no node is over capacity."""
    snap = srv.state.snapshot()
    for job in jobs:
        live = [a for a in snap.allocs_by_job(job.namespace, job.id)
                if not a.terminal_status()]
        check(len(live) == c2m.BURST_COUNT,
              f"{ctx}: job {job.id} has {len(live)} live allocs")
    failed = [e.id for e in snap.evals_iter()
              if e.status == consts.EVAL_STATUS_FAILED]
    check(not failed, f"{ctx}: {len(failed)} failed evals")
    bs = srv.eval_broker.stats()
    check(bs["total_ready"] == bs["total_unacked"] == bs["total_waiting"]
          == 0, f"{ctx}: broker not empty: {bs}")
    errors = [w.last_error for w in srv.workers if w.last_error]
    check(not errors, f"{ctx}: worker errors: {errors[:1]}")
    over = store_over_capacity(srv.state, coalesce.ClusterCache(srv.device))
    check(over == 0, f"{ctx}: {over} nodes over capacity")


def server_arm(dev: torch.device, state_bytes: bytes, gc_tuning: bool,
               adaptive: bool, rng) -> dict:
    """One ``Server`` on ``dev`` over the restored state: warm-up, then the
    timed burst, with every count set to 0 just before it."""
    ctx = f"server gc_tuning={gc_tuning} coalesce_adaptive={adaptive}"
    srv = Server(ServerConfig(num_workers=1, worker_batch_size=SERVER_BATCH,
                              heartbeat_ttl=3600.0, gc_tuning=gc_tuning,
                              coalesce_adaptive=adaptive),
                 device=dev)
    t0 = time.perf_counter()
    srv.state.restore_from_bytes(state_bytes)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    threads = threading.active_count()
    w = srv.workers[0]
    try:
        tag = ("gcon" if gc_tuning else "gcoff") + (
            "" if adaptive else "-full")
        warm = [c2m.burst_job(rng, i, prefix=f"{tag}-warm")
                for i in range(SERVER_WARMUP_JOBS)]
        t0 = time.perf_counter()
        for job in warm:
            srv.job_register(job)
        warmup_s = server_converged(
            srv, warm, time.time() + SERVER_DEADLINE_S) - t0
        check_server_burst(srv, warm, f"{ctx} warm-up")

        jobs = [c2m.burst_job(rng, i, prefix=f"{tag}-burst")
                for i in range(SERVER_JOBS)]
        histograms.get("e2e").reset()
        srv.plan_latencies.clear()
        plan_group_stats.reset()
        coalesce.fused_wave_stats.reset()
        coalesce.wave_stats.reset()
        coalesce.upload_stats.reset()
        default_device_state.reset_stats()
        waves0, requests0 = w.batch_launches, w.batch_requests
        pauses = GcPauses()
        ck.launches = 0
        gc.callbacks.append(pauses)
        t0 = time.perf_counter()
        for job in jobs:
            srv.job_register(job)
        t_done = server_converged(srv, jobs,
                                  time.time() + SERVER_DEADLINE_S)
        gc.callbacks.remove(pauses)
        b1_launches = ck.launches
        burst_s = t_done - t0
        dstate = default_device_state.snapshot()
        uploads = (coalesce.upload_stats.uploads,
                   coalesce.upload_stats.bytes)
        fstats = coalesce.fused_wave_stats.snapshot()
        e2e = histograms.get("e2e")
        e2e_n = e2e.count
        e2e_p50, e2e_p99 = e2e.quantiles((0.5, 0.99))
        plan_lat = list(srv.plan_latencies)
        group = plan_group_stats.snapshot()
        wstats = coalesce.wave_stats.snapshot()
        rss = rss_gb()
        ineligible = sum(
            1 for n in srv.state.snapshot().nodes()
            if n.scheduling_eligibility == consts.NODE_SCHEDULING_INELIGIBLE)
        check_server_burst(srv, jobs, ctx)
        resident = None if adaptive else check_resident(srv, dev, ctx)
    finally:
        t0 = time.perf_counter()
        srv.shutdown()
        shutdown_s = time.perf_counter() - t0
    # the worker's run loop has ended, so its last chunk is reaped
    waves = w.batch_launches - waves0
    requests = w.batch_requests - requests0
    check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
          f"{ctx}: waves fell back or failed: {fstats}")
    check(b1_launches == fstats["launches"],
          f"{ctx}: B1 launches {b1_launches} != fused waves {fstats}")
    check(1 <= b1_launches < SERVER_JOBS,
          f"{ctx}: {b1_launches} B1 launches for {SERVER_JOBS} evals")
    # an eval processed again (a blocked eval released) adds a sample
    check(e2e_n >= SERVER_JOBS, f"{ctx}: {e2e_n} e2e samples")
    check(dstate["errors"] == 0,
          f"{ctx}: device state errors: {dstate}")
    return {
        "gc_tuning": gc_tuning, "coalesce_adaptive": adaptive,
        "restore_s": restore_s, "start_s": start_s,
        "threads_after_start": threads, "rss_gb": rss,
        "warmup_s": warmup_s, "shutdown_s": shutdown_s,
        "evals": SERVER_JOBS, "e2e_samples": e2e_n, "burst_s": burst_s,
        "evals_per_s": SERVER_JOBS / burst_s,
        "e2e_p50_ms": e2e_p50 * 1e3, "e2e_p99_ms": e2e_p99 * 1e3,
        "plan_p50_ms": percentile(plan_lat, 0.5) * 1e3,
        "plan_p99_ms": percentile(plan_lat, 0.99) * 1e3,
        "plans": len(plan_lat),
        "b1_launches": b1_launches, "waves": waves,
        "wave_fill": requests / waves if waves else 0.0,
        "deadline_waves": wstats["deadline_launches"],
        "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
        "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
        "fallbacks": fstats["fallbacks"],
        "gc_full": pauses.full, "gc_s": pauses.seconds,
        "group_commits": group["commit_batches"],
        "group_size_avg": group["group_size_avg"],
        "vector_plans": group["vector_plans"],
        "fallback_plans": group["fallback_plans"],
        "rejected_node_plans": group["rejected_node_plans"],
        "ineligible_nodes": ineligible,
        "device_state": dstate,
        "wave_uploads": uploads[0], "wave_upload_bytes": uploads[1],
        "wave_upload_bytes_per_wave": uploads[1] / waves if waves else 0.0,
        "resident_check": resident,
    }


#: rows of one scatter advance timed below: a committed wave of 32 evals
#: x 10 placements moves at most 320 rows of the five usage planes
SCATTER_ROWS = 320


def check_resident(srv, dev: torch.device, ctx: str) -> dict:
    """The resident generation of the store's final snapshot, advanced to
    it by dirty-row scatter, must equal a fresh ``ClusterTensors.build``
    of that snapshot uploaded whole (``torch.equal``, plane by plane,
    dtype by dtype). Then the scatter's time per advance on the card:
    ``SCATTER_ROWS`` rows of the five usage planes, from the host buffer
    (one packed upload, five ``index_copy``) and on the card alone."""
    snap = srv.state.snapshot()
    cluster = coalesce.ClusterCache(dev).get(snap)
    default_device_state.advance_pending(dev)
    planes = default_device_state.planes_for(snap.usage, dev)
    check(planes is not None, f"{ctx}: no resident generation of the "
          "final snapshot")
    t0 = time.perf_counter()
    fresh = ClusterTensors.build(snap.nodes()).wave_shared_planes(snap.usage)
    build_s = time.perf_counter() - t0
    check(set(planes) == set(fresh), f"{ctx}: resident planes {set(planes)}")
    for f, arr in fresh.items():
        want = torch.tensor(arr, device=dev)
        check(planes[f].dtype == want.dtype and torch.equal(planes[f], want),
              f"{ctx}: resident {f} differs from a fresh upload")
    usage_host = {f: fresh[f] for f in ClusterTensors.WAVE_USAGE_FIELDS}
    step = max(cluster.n_real // SCATTER_ROWS, 1)
    rows = set(range(0, step * SCATTER_ROWS, step))
    private = DeviceClusterState()      # keeps the server's stats clean
    advance_ms = cuda_ms(
        lambda: private._scatter(planes, usage_host, rows, dev), 50)
    rows_d = torch.tensor(sorted(rows), dtype=torch.long, device=dev)
    vals = {f: planes[f][rows_d] for f in usage_host}
    device_ms = cuda_ms(lambda: [planes[f].index_copy(0, rows_d, vals[f])
                                 for f in usage_host], 200)
    n = int(cluster.n_pad)
    return {"planes": len(planes), "build_s": build_s,
            "scatter_rows": len(rows), "scatter_planes": len(usage_host),
            "scatter_bytes": private.bytes_uploaded // 50,
            "scatter_advance_ms": advance_ms,
            "scatter_device_ms": device_ms,
            # each out-of-place index_copy reads and writes its plane
            "scatter_bound_ms": bound(
                len(usage_host) * (2 * 4 * n + 4 * len(rows)) + 8 * len(rows),
                0)[0]}


def run_server_phase(dev: torch.device, record: dict,
                     state_bytes: bytes) -> list:
    """Phase 11: ``gc_tuning`` off, then on, then on with the coalescer's
    adaptive window off (a wave waits for every member of its batch).
    The server's GC treatment freezes what is alive once per process, so
    the "off" arm must come first, and each arm's server is dropped and
    collected before the next one starts (the third arm's heap is not
    frozen: a server started again in a process is not frozen either)."""
    if os.environ.pop("NOMAD_TPU_GC_TUNING", None) is not None:
        log("server: NOMAD_TPU_GC_TUNING was set; unset for phase 11")
    # the arms warm nothing: no manifest outside this run may be read
    kernel_warmup.DEFAULT_MANIFEST_PATH = str(
        Path(__file__).resolve().parent / "build" / "no_manifest.json")
    log(f"server state: {len(state_bytes) / 1e6:.1f} MB of snapshot bytes")
    rng = np.random.default_rng(SEED + 11)
    arms = []
    for gc_tuning, adaptive in SERVER_ARMS:
        arm = server_arm(dev, state_bytes, gc_tuning, adaptive, rng)
        t0 = time.perf_counter()
        gc.collect()
        arm["collect_after_s"] = time.perf_counter() - t0
        log(f"server: {json.dumps(arm)}")
        arms.append(arm)
    record["server"] = arms
    return arms


# ---------------------------------------------------------------------------
# Phase 12: the warm start on the server path, in fresh processes.
# ---------------------------------------------------------------------------

WARM_CHILD_TIMEOUT_S = 420.0    # per child process; killed when it is over
WARMUP_WAIT_S = 240.0           # the child's wait for its warmup thread


def run_warm_start_phase(record: dict, state_bytes: bytes) -> list:
    """Phase 12: fresh Python processes (no CUDA context, no library
    loaded) each restore phase 11's snapshot bytes into a server with
    ``kernel_warmup=True`` and one manifest path, the profiler on, and run
    the timed burst. Run A finds no manifest, warms nothing and persists
    one at shutdown; run B warms it at ``start()``, waits for the warmup,
    then bursts; run C warms it too but bursts at once, as a server that
    does not wait for its warmup. Runs B and C must warm at least one
    entry and fail none, and run B must miss no key in its burst (run
    C's waves may race the warmup to a key; its misses are reported)."""
    runs = []
    with tempfile.TemporaryDirectory(prefix="warm_start_") as tmp:
        state_path = Path(tmp) / "state.bin"
        state_path.write_bytes(state_bytes)
        manifest = Path(tmp) / "warmup.json"
        for run in ("A", "B", "C"):
            check((run != "A") == manifest.exists(),
                  f"warm start {run}: manifest exists={manifest.exists()}")
            out = Path(tmp) / f"run{run}.json"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--warm-start", run, str(state_path), str(manifest),
                     str(out)], capture_output=True, text=True,
                    timeout=WARM_CHILD_TIMEOUT_S,
                    cwd=str(Path(__file__).resolve().parent))
            except subprocess.TimeoutExpired:
                fail(f"warm start {run}: over {WARM_CHILD_TIMEOUT_S} s")
            for line in proc.stdout.splitlines():
                log(f"warm start {run}: {line}")
            check(proc.returncode == 0,
                  f"warm start {run} failed (exit {proc.returncode}): "
                  f"{proc.stderr[-3000:]}")
            res = json.loads(out.read_text())
            res["process_s"] = time.perf_counter() - t0
            runs.append(res)
        entries = len(kernel_warmup.load_manifest(str(manifest)))
    a, b, c = runs
    check(a["warmup"]["warmed"] == 0 and a["warmup"]["failed"] == 0,
          f"warm start A warmed {a['warmup']}")
    for r in (b, c):
        check(r["warmup"]["failed"] == 0 and r["warmup"]["warmed"] >= 1,
              f"warm start {r['run']}: warmup {r['warmup']}")
    check(b["burst_profile"]["Misses"] == 0,
          f"warm start B: misses in the burst: {b['burst_profile']['PerKey']}")
    for r in runs:
        r["manifest_entries"] = entries
        log(f"warm start: {json.dumps(r)}")
    record["warm_start"] = runs
    return runs


def warm_start_child(run: str, state_path: str, manifest: str,
                     out_path: str, device: str = "cuda") -> int:
    """One run of phase 12 in its own process: restore, ``start()``
    (run B then waits for the warmup; runs A and C do not), the timed
    burst with every count set to 0 just before it, shutdown (which
    persists the manifest); the result goes to ``out_path`` as JSON.
    A warmup that overlaps the burst (run C) is joined before the counts
    are read, and its B1 launches are taken out of the burst's.
    ``device`` is the card; a rehearsal on the CPU names ``cpu``."""
    dev = torch.device(device)
    check(dev.type != "cuda" or torch.cuda.is_available(),
          "warm start: no CUDA card")
    ctx = f"warm start {run}"
    profiler.enable()
    srv = Server(ServerConfig(num_workers=1, worker_batch_size=SERVER_BATCH,
                              heartbeat_ttl=3600.0, coalesce_adaptive=False,
                              kernel_warmup=True,
                              warmup_manifest_path=manifest),
                 device=dev)
    t0 = time.perf_counter()
    srv.state.restore_from_bytes(Path(state_path).read_bytes())
    restore_s = time.perf_counter() - t0
    first_done = []
    real_launch = coalesce.launch_wave

    def timed_launch(*args, **kwargs):
        out = real_launch(*args, **kwargs)
        if not first_done:
            first_done.append(time.perf_counter())
        return out

    coalesce.launch_wave = timed_launch
    ck.launches = 0
    kernel_warmup.warmup_stats.reset()
    t_start = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t_start
    w = srv.workers[0]
    try:
        warm = {"warmed": 0, "failed": 0, "seconds": 0.0, "wait_s": 0.0,
                "launches": {}, "b1_launches": 0}

        def join_warmup() -> None:
            if srv._warmup_thread is None:
                return
            srv._warmup_thread.join(timeout=WARMUP_WAIT_S)
            check(not srv._warmup_thread.is_alive(),
                  f"{ctx}: warmup still running after {WARMUP_WAIT_S} s")
            warm.update(srv.warmup_stats or {"failed": 1})

        if run == "B":
            join_warmup()
            warm["wait_s"] = time.perf_counter() - t_start
            warm["launches"] = kernel_warmup.warmup_stats.snapshot()
            warm["b1_launches"] = ck.launches
            warm["profile"] = profiler.summary()
            del warm["profile"]["PerKey"]

        rng = np.random.default_rng(SEED + 12)
        jobs = [c2m.burst_job(rng, i, prefix=f"warm{run}")
                for i in range(SERVER_JOBS)]
        histograms.get("e2e").reset()
        srv.plan_latencies.clear()
        profiler.reset()
        coalesce.fused_wave_stats.reset()
        coalesce.wave_stats.reset()
        coalesce.upload_stats.reset()
        default_device_state.reset_stats()
        waves0, requests0 = w.batch_launches, w.batch_requests
        if run != "C":
            ck.launches = 0     # run C counts from start(): see below
        t0 = time.perf_counter()
        for job in jobs:
            srv.job_register(job)
        t_done = server_converged(srv, jobs,
                                  time.time() + SERVER_DEADLINE_S)
        burst_s = t_done - t0
        warm_b1 = 0
        if run == "C":
            # the warmup overlapped the burst: once it has ended, every
            # B1 launch since start() less its dummy waves is the burst's
            join_warmup()
            warm["launches"] = kernel_warmup.warmup_stats.snapshot()
            warm_b1 = warm["b1_launches"] = warm["launches"].get(
                "fused_wave", 0)
        b1_launches = ck.launches - warm_b1
        # first launches of the live kernels (a racing warmup's own
        # first launches count under warmup_<kernel>)
        live_misses = sum(profiler.misses_for(k) for k in (
            "fused_wave", "joint", "single_topk", "single_full"))
        fstats = coalesce.fused_wave_stats.snapshot()
        wstats = coalesce.wave_stats.snapshot()
        first_wave_ms = coalesce.wave_stats._wave_s[0] * 1e3
        first_assemble_ms = coalesce.wave_stats._assemble_s[0] * 1e3
        prof = profiler.summary()
        dstate = default_device_state.snapshot()
        uploads = (coalesce.upload_stats.uploads,
                   coalesce.upload_stats.bytes)
        e2e_p50, e2e_p99 = histograms.get("e2e").quantiles((0.5, 0.99))
        check_server_burst(srv, jobs, ctx)
    finally:
        srv.shutdown()
        coalesce.launch_wave = real_launch
    waves = w.batch_launches - waves0
    requests = w.batch_requests - requests0
    check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
          f"{ctx}: waves fell back or failed: {fstats}")
    check(b1_launches == fstats["launches"] == waves,
          f"{ctx}: B1 launches {b1_launches}, fused {fstats}, waves {waves}")
    check(dstate["errors"] == 0, f"{ctx}: device state errors: {dstate}")
    check(Path(manifest).exists(), f"{ctx}: no manifest after shutdown")
    res = {
        "run": run, "restore_s": restore_s, "start_s": start_s,
        "warmup": warm,
        "start_to_first_wave_s": first_done[0] - t_start,
        "burst_to_first_wave_s": first_done[0] - t0,
        "first_wave_latency_ms": first_wave_ms,
        "first_wave_assemble_ms": first_assemble_ms,
        "evals": SERVER_JOBS, "burst_s": burst_s,
        "evals_per_s": SERVER_JOBS / burst_s,
        "e2e_p50_ms": e2e_p50 * 1e3, "e2e_p99_ms": e2e_p99 * 1e3,
        "b1_launches": b1_launches, "waves": waves,
        "wave_fill": requests / waves if waves else 0.0,
        "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
        "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
        "warmup_b1_in_burst": warm_b1, "live_misses": live_misses,
        "burst_profile": prof, "device_state": dstate,
        "wave_uploads": uploads[0], "wave_upload_bytes": uploads[1],
    }
    Path(out_path).write_text(json.dumps(res))
    log(f"burst: {b1_launches} B1 launches in {waves} waves, misses "
        f"{live_misses}, {SERVER_JOBS / burst_s:.1f} evals/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
