#!/usr/bin/env python3
"""Does a burst converge through concurrent scheduler worker processes?

Builds the C2M replay cluster (``nomad_tpu_torch/parallel/c2m.py``) at the
given size, restores it into a server with ``scheduler_workers`` processes
(phase 11's window-off shape: one in-process worker, batch 32), registers
warm-up jobs, then the burst, and prints one JSON line per arm: whether
every job placed, the failed and blocked evals, the rejected node plans,
the burst's time.

    python3 tests/workerproc_witness.py --package jax --workers 2,4
    python3 tests/workerproc_witness.py --package port --device cpu
    python3 tests/workerproc_witness.py --package port --no-turn

``--package jax`` runs the JAX package's server (its processes place on
the CPU), with the replay generator's source read for ``nomad_tpu``'s
modules of the same names. ``--no-turn`` runs the port's processes
without their placement turn, for comparison with the port as it is.
The defaults are a reduced cluster; ``--nodes 10000 --allocs 100000
--jobs 200 --warm 40`` is phase 13's.
"""

import argparse
import json
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ["NOMAD_TPU_GC_TUNING"] = "0"


def load_package(name: str, no_turn: bool):
    """``(c2m, Server, ServerConfig, consts, plan_group_stats)`` of the
    package."""
    if name == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        src = (ROOT / "nomad_tpu_torch" / "parallel" / "c2m.py").read_text()
        c2m = types.ModuleType("c2m_reference")
        exec(compile(src.replace("nomad_tpu_torch", "nomad_tpu"),
                     "c2m_reference", "exec"), c2m.__dict__)
        from nomad_tpu.server.plan_apply import plan_group_stats
        from nomad_tpu.server.server import Server, ServerConfig
        from nomad_tpu.structs import consts
        return c2m, Server, ServerConfig, consts, plan_group_stats
    from nomad_tpu_torch.parallel import c2m
    from nomad_tpu_torch.server import workerproc
    from nomad_tpu_torch.server.plan_apply import plan_group_stats
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.structs import consts
    if no_turn:
        workerproc._TurnLock = lambda: None
    return c2m, Server, ServerConfig, consts, plan_group_stats


def burst(srv, jobs, per_job: int, deadline_s: float) -> tuple:
    """``(converged, seconds)`` for ``jobs`` registered now."""
    t0 = time.perf_counter()
    for job in jobs:
        srv.job_register(job)
    deadline = time.time() + deadline_s
    want = len(jobs) * per_job
    while time.time() < deadline:
        bs = srv.eval_broker.stats()
        if bs["total_ready"] == bs["total_unacked"] == bs["total_waiting"] \
                == 0:
            snap = srv.state.snapshot()
            if sum(len(snap.allocs_by_job(j.namespace, j.id))
                   for j in jobs) >= want:
                return True, time.perf_counter() - t0
        time.sleep(0.01)
    return False, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), default="port")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--workers", default="2,4")
    ap.add_argument("--no-turn", action="store_true")
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--allocs", type=int, default=10000)
    ap.add_argument("--jobs", type=int, default=100)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--deadline", type=float, default=120.0)
    args = ap.parse_args()
    c2m, Server, ServerConfig, consts, plan_group_stats = load_package(
        args.package, args.no_turn)
    import numpy as np

    state_bytes = c2m.generate(args.nodes, args.allocs).to_snapshot_bytes()
    rng = np.random.default_rng(args.seed)
    for workers in (int(w) for w in args.workers.split(",")):
        cfg = ServerConfig(num_workers=1, worker_batch_size=32,
                           heartbeat_ttl=3600.0, coalesce_adaptive=False,
                           scheduler_workers=workers, gc_tuning=False)
        srv = (Server(cfg) if args.package == "jax"
               else Server(cfg, device=args.device))
        srv.state.restore_from_bytes(state_bytes)
        srv.start()
        try:
            warm = [c2m.burst_job(rng, i, prefix=f"w{workers}-warm")
                    for i in range(args.warm)]
            warm_ok, _ = burst(srv, warm, c2m.BURST_COUNT, args.deadline)
            jobs = [c2m.burst_job(rng, i, prefix=f"w{workers}-burst")
                    for i in range(args.jobs)]
            plan_group_stats.reset()
            ok, seconds = burst(srv, jobs, c2m.BURST_COUNT, args.deadline)
            rejected = plan_group_stats.snapshot()["rejected_node_plans"]
            statuses: dict = {}
            for e in srv.state.snapshot().evals_iter():
                statuses[e.status] = statuses.get(e.status, 0) + 1
        finally:
            srv.shutdown()
        print(json.dumps({
            "package": args.package, "device": args.device,
            "turn": args.package == "port" and not args.no_turn,
            "workers": workers, "nodes": args.nodes, "allocs": args.allocs,
            "jobs": args.jobs, "seed": args.seed,
            "warm_converged": warm_ok, "converged": ok,
            "failed_evals": statuses.get(consts.EVAL_STATUS_FAILED, 0),
            "blocked_evals": statuses.get(consts.EVAL_STATUS_BLOCKED, 0),
            "rejected_node_plans": rejected, "burst_s": seconds}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
