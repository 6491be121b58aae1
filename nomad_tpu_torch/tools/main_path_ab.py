"""Phase 3 of chip_smoke.py alone, repeated, for one tree of the repo.

Runs the main path (32 eval threads building C2M members and placing
them through one ``LaunchCoalescer`` into ``ResidentUsage``, 64 rounds)
``--reps`` times in one process after one discarded warm-up run, on the
card, and prints one JSON line per timed run. ``--tree`` names the repo
checkout whose ``chip_smoke.py`` helpers and ``nomad_tpu_torch`` are
used, so two commits are compared by running this script once per tree,
alternating, on one card. ``--stub lookups`` makes the device
state's per-wave calls (``advance_pending`` and ``lookup``) no-ops, so
every shared leaf ships from the host as it did before the state
existed; ``--stub frozen`` keeps the lookups but makes no frozen neutral
singleton resident (those planes ship from the host every wave).

    python3 nomad_tpu_torch/tools/main_path_ab.py --tree . --label change
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stub", choices=("none", "lookups", "frozen"),
                    default="none")
    ap.add_argument("--device", default="cuda",
                    help="cpu for a rehearsal at a small --nodes")
    ap.add_argument("--nodes", type=int, default=10_000)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    import chip_smoke as cs
    from nomad_tpu_torch.ops import cuda_kernel as ck
    from nomad_tpu_torch.parallel import coalesce

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    if args.stub != "none":
        from nomad_tpu_torch.tensors.device_state import default_device_state

        real_lookup = default_device_state.lookup
        if args.stub == "lookups":
            default_device_state.advance_pending = lambda *a, **k: None
            default_device_state.lookup = lambda *a, **k: None
        else:
            default_device_state.lookup = (
                lambda arr, device, frozen_ok=True:
                real_lookup(arr, device, frozen_ok=False))
    cluster = cs.c2m_cluster(args.nodes, seed=cs.SEED)
    ucpu, umem, udisk, _ = cs.c2m_pack_usage(cluster, 10 * args.nodes,
                                             seed=cs.SEED)
    base = cs.base_kin(cluster, (ucpu, umem, udisk))
    mix = ("shuffle",) * 6 + ("ports", "ports", "penalty_preferred",
                              "distinct")

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def one_run(rep: int) -> dict:
        resident = coalesce.ResidentUsage(ucpu, umem, udisk, device=dev)
        co = coalesce.LaunchCoalescer(cs.B_WAVE, device=dev,
                                      resident=resident)
        errors: list = []
        srng = np.random.default_rng(cs.SEED + 999)
        t0 = time.perf_counter()
        for r in range(cs.B_WAVE):
            cs.make_member(base, cluster, mix[r % len(mix)], srng)
        serial_s = time.perf_counter() - t0

        def evaluator(tid: int) -> None:
            trng = np.random.default_rng(cs.SEED + 1000 + tid + 97 * rep)
            try:
                for r in range(cs.MAIN_ROUNDS):
                    kin, f = cs.make_member(base, cluster,
                                            mix[(tid + r) % len(mix)], trng)
                    co.launch(kin, cs.K_STEPS, f)
            except Exception as e:      # noqa: BLE001 - reported
                errors.append(repr(e))
            finally:
                co.done()

        ck.launches = 0
        coalesce.wave_stats.reset()
        sync()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=evaluator, args=(i,))
                   for i in range(cs.B_WAVE)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        sync()
        wall = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in threads):
            raise SystemExit(f"main path failed: {errors[:2]}")
        w = coalesce.wave_stats.snapshot()
        evals = cs.B_WAVE * cs.MAIN_ROUNDS
        return {"label": args.label, "stub": args.stub, "rep": rep,
                "evals_per_s": evals / wall, "waves": co.launches,
                "b1_launches": ck.launches,
                "assemble_p50_ms": w["assemble_latency_p50_ms"],
                "wave_p50_ms": w["wave_latency_p50_ms"],
                "fill": w["fill_ratio"],
                "serial_32_builds_ms": serial_s * 1e3}

    one_run(-1)                     # loads the library, warms the host
    for rep in range(args.reps):
        print(json.dumps(one_run(rep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
