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
   bench's throughput problem (10k nodes, N=16384, B=512, K=10), then the
   schedule-apply step with the kernel inside (the B3 path, 4 batches)
   against the plain step: same committed planes;
8. B2 and the batched loop at the bench shape (B=8192, 25 batches, K=10):
   the candidate scan against its plain version on one batch, then the
   ``kernel_topk`` loop (the B2 path) against the ``torch`` loop, with
   evals/s of both and the split of a batch (full-width pass vs scan);
9. the replay form: the same loop with ``reset_every=1`` on a C2M cluster
   of 10k nodes with 100k resident allocs.

Any mismatch exits non-zero without the final line. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit, and before that the kernels' JSON line. A full record
goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops.kernel import (
    FUSED_METRIC_FIELDS,
    LEAN_FEATURES,
    MAX_PENALTY_NODES,
    build_kernel_in,
    neutral_planes,
    pad_steps,
    unpack_fused_wave,
)
from nomad_tpu_torch.parallel import batching, coalesce
from nomad_tpu_torch.parallel.synthetic import (
    C2M_SHAPE_CPU,
    C2M_SHAPE_MEM,
    C2M_SHAPE_P,
    c2m_cluster,
    c2m_pack_usage,
    synthetic_eval,
    throughput_problem,
)
from nomad_tpu_torch.tensors.schema import (
    MAX_DEV_REQS,
    SPREAD_BUCKETS,
    AskTensor,
    EvalTensors,
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
    check(fstats["fallbacks"] == 0, f"composite fallbacks: {fstats}")
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
    check(fstats == {"launches": 0, "fallbacks": 1},
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
BATCH_B2 = 8192      # bench.py _bench_batch on an accelerator
BATCHES_B2 = 25      # 8192 x 25 evals, the bench's burst
REPLAY_BATCHES = 4
K_CAND = 64          # pallas_topk_place_batch's default candidate count
#: f32 operations of the lean score of one node: fit compares (6),
#: utilization adds and free fractions (6), two pow, the fit sum, clamps,
#: select and scale (7), anti-affinity (4), plane sums and the final
#: divide (4)
OPS_PER_LEAN_SCORE = 27


def lean_ops(n_steps, k_steps: int, width: int) -> int:
    """f32 operations a lean batch placement needs over ``width`` nodes
    (or candidates): a step changes only the chosen node's carries, so
    each eval scores every node once, then each active step takes one
    argmax compare per node and rescores the chosen node. The kernels
    rescore every node at every step; that is their design's redundancy,
    not the function's floor."""
    evals = int((n_steps > 0).sum())
    active = int(np.minimum(n_steps, k_steps).sum())
    return evals * width * OPS_PER_LEAN_SCORE + active * (
        width + OPS_PER_LEAN_SCORE)


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
              over_capacity=over_capacity(prob.kin, ku, km))
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
        lean_ops(prob.n_steps, K_PLACE, v3["cap_cpu"].shape[0]))

    # ---- 8. B2 and the loop at the bench shape ----
    prob = throughput_problem(BATCHES_B2, BATCH_B2, seed=7)
    ns = on(prob.n_steps)
    asks = (on(prob.ask_cpu), on(prob.ask_mem))
    lean = batching._lean_args(shared, uc0, um0, asks[0][0], asks[1][0], ns)
    got = ck.topk_place_batch(*lean, k_steps=K_PLACE)
    want = ck.topk_place_batch_reference(*lean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    for name, g, w in zip(("chosen", "found", "valid"),
                          (got[0], got[2], got[3]), (want[0], want[2], want[3])):
        check(torch.equal(g, w), f"b2/topk_place_batch: {name} differs")
    b2_err = float((got[1] - want[1]).abs().max())
    check(b2_err <= ATOL, f"b2: max abs error {b2_err} > {ATOL}")
    b2 = {"max_abs_err": b2_err, "invalid": int((~got[3]).sum()),
          "placed": int(got[2].sum())}
    log(f"b2 kernel vs plain: {json.dumps(b2)}")

    kloop = batching.make_schedule_apply_loop(
        K_PLACE, LEAN_FEATURES, topk=True, backend="kernel_topk")
    tloop = batching.make_schedule_apply_loop(K_PLACE, LEAN_FEATURES,
                                              topk=True)
    ck.cand_scan_launches = 0
    k_s, kres = best_of_2(lambda: kloop(shared, uc0, um0, *asks, ns))
    b2_launches = ck.cand_scan_launches
    check(b2_launches == 2 * BATCHES_B2,
          f"b2 path: {b2_launches} scan launches for the 2 x {BATCHES_B2} "
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
    cand, rest = ck.candidate_pass(v2, K_CAND)
    for _ in range(3):
        ck._cand_scan(cand, rest, v2, K_PLACE)
    b2_ms = cuda_ms(lambda: ck._cand_scan(cand, rest, v2, K_PLACE), 20)
    b2_plain_ms = cuda_ms(
        lambda: ck.cand_scan_reference(cand, rest, v2, K_PLACE), 3)
    pass_ms = cuda_ms(lambda: ck.candidate_pass(v2, K_CAND), 5)
    scan_out = ck._cand_scan(cand, rest, v2, K_PLACE)
    b2_bound, b2_by = bound(
        lean_bytes(v2, scan_out) + cand.nbytes + rest.nbytes,
        lean_ops(prob.n_steps, K_PLACE, K_CAND))
    split = {"full_width_pass_ms": pass_ms, "scan_ms": b2_ms,
             "batch_ms": k_s / BATCHES_B2 * 1e3}
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
    ck.cand_scan_launches = 0
    r_s, rres = best_of_2(lambda: rloop(rshared, on(ucpu), on(umem), *rasks,
                                        ns))
    check(ck.cand_scan_launches == 2 * REPLAY_BATCHES,
          f"replay: {ck.cand_scan_launches} scan launches")
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
        {"name": "topk_place_batch (cand_scan)", "route": "cuda",
         "source": "nomad_tpu_torch/csrc/cand_scan.cu",
         "replaces": "nomad_tpu/ops/pallas_kernel.py:478",
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


if __name__ == "__main__":
    sys.exit(main())
