"""Time the joint kernels' waves by part, width and cluster count.

    python3 nomad_tpu_torch/tools/joint_split.py
    python3 nomad_tpu_torch/tools/joint_split.py --parts scale \\
        --nodes 20000,50000 --unions spread,everything --clusters 1,2,4,7
    python3 nomad_tpu_torch/tools/joint_split.py --tree DIR --label parent
    python3 nomad_tpu_torch/tools/joint_split.py --sharded 4 --parts scale \\
        --clusters 1,2,4,7
    python3 nomad_tpu_torch/tools/joint_split.py --sharded 0 --parts scale

``--sharded D`` times the joint sharded kernel (csrc/joint_sharded_wave.cu,
``joint_sharded_wave_place``) on the same waves over D virtual shards of
the one card, or with ``--sharded 0`` over one shard on each card of the
host, where the joint kernel is timed otherwise; ``--clusters`` then
forces its clusters a card (``chip_smoke.forced_sharded_clusters``; a
tree without that plan times its own one cluster a card), and a wave the
tree's wrapper refuses gives a row with its error.

Runs on one CUDA card. ``--tree`` names the repository root whose
``nomad_tpu_torch`` (its csrc/joint_wave.cu built into that tree's build
directory) and ``chip_smoke`` helpers are measured, so an unpacked
``git archive`` of another commit is timed with the same waves. Every
time is CUDA events over ``--reps`` launches of ``joint_wave_place`` after
one warm launch; each row also gives the microseconds an active step.

- ``split``: the everything wave (32 members x 10 placements, every
  feature; C2M clusters of 10,000 nodes, N=16384, and of 1,500, N=2048)
  with no spread stanza, one, and four, each with and without top-k, and
  one stanza no member has active: what the spread step's boost build,
  row pass and top-8 rebuild cost, apart from a member's counts swap;
- ``scale``: chip_smoke.py phase 4's waves (``--unions``: a spread member
  among 31 shuffle members; 32 members asking devices, cores or
  bandwidth; 32 asking everything; 32 shuffle members) over C2M clusters
  of ``--nodes`` nodes (``NODES``: 10,000 is N=16384, 100,000 N=131072,
  300,000 N=524288, 600,000 N=1048576);
- ``--clusters`` runs each scale wave over each forced cluster count the
  card holds (``chip_smoke.forced_clusters``), its outputs held bit for
  bit against the first count's, and gives the plan's own row its
  cluster count and rows' placement; it needs a tree with the cluster
  plan (``cuda_kernel.joint_clusters``).

Rows go to stdout as JSON lines, the card's name and power limit first,
and to ``chiprun_out/joint_split_<label>.json``. ``--reps`` sets the
launches timed after the warm one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
STANZAS = 4
#: nodes -> (allocs packed on them, seed offset from chip_smoke.SEED)
NODES = {10_000: (100_000, 0), 20_000: (200_000, 2), 50_000: (500_000, 3),
         100_000: (1_000_000, 1), 200_000: (1_000_000, 5),
         300_000: (1_000_000, 4), 600_000: (2_000_000, 6)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--parts", default="split,scale")
    ap.add_argument("--nodes", default="10000,100000,300000")
    ap.add_argument("--unions",
                    default="spread,devices,cores,network,everything")
    ap.add_argument("--clusters", default="")
    ap.add_argument("--sharded", type=int, default=-1)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from nomad_tpu_torch.ops import cuda_kernel as ck
    from nomad_tpu_torch.parallel import coalesce, sharded

    if not torch.cuda.is_available():
        print("joint_split: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows: list = []

    def emit(row: dict) -> None:
        row = {"label": args.label, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    mesh_on = args.sharded >= 0
    devices = ([dev] * args.sharded if args.sharded > 0 else
               [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())])
    emit({"card": smi, "tree": str(Path(args.tree).resolve()),
          "kernel": "joint_sharded" if mesh_on else "joint",
          "shards": len(devices) if mesh_on else None,
          "cards": len(set(devices)) if mesh_on else 1})
    t0 = time.perf_counter()
    ck.load_library("joint_sharded_wave" if mesh_on else "joint_wave")
    emit({"build_s": time.perf_counter() - t0})
    forced = [int(c) for c in args.clusters.split(",") if c]
    rng = np.random.default_rng(cs.SEED + 77)
    # the tree's cluster plan and its forcing (none: one cluster a card)
    if mesh_on:
        planned = hasattr(ck, "joint_sharded_clusters")
        force = cs.forced_sharded_clusters if planned else None
        most = (min(ck._joint_sharded_card(dev.index or 0)[1],
                    ck.JOINT_MAX_CLUSTERS) if planned else 1)
    else:
        planned, force = True, cs.forced_clusters
        most = min(ck._joint_card(dev)[1], ck.JOINT_MAX_CLUSTERS)

    def cluster_of(nodes: int):
        allocs, seed = NODES[nodes]
        cluster = cs.c2m_cluster(nodes, seed=cs.SEED + seed)
        used = cs.c2m_pack_usage(cluster, allocs, seed=cs.SEED + seed)[:3]
        return cluster, cs.base_kin(cluster, used)

    class Wave:
        """One wave as its kernel takes it: assembled on the card (the
        joint kernel) or over the mesh's shards (the joint sharded)."""

        def __init__(self, kins, feats):
            steps = [cs.K_STEPS] * len(kins)
            if mesh_on:
                mesh = sharded.wave_mesh(devices=devices)
                w = coalesce.assemble_sharded_wave(kins, steps, feats, mesh)
                self.args = (sharded._shards_of(w.kin, mesh.node_rows()[0]),
                             w.step_member, w.step_local, w.t_pad,
                             w.features)
                self.active = cs.sharded_active_steps(self.args)
                self.n = int(self.args[0][0].cap_cpu.shape[-1]) * len(
                    devices)
            else:
                w = coalesce.assemble_wave(kins, steps, feats, dev)
                self.args = (w.kin, w.step_member, w.step_local, w.t_pad,
                             w.features)
                self.active = cs.active_steps(w)
                self.n = int(w.kin.cap_cpu.shape[-1])

        def run(self):
            if mesh_on:
                return ck.joint_sharded_wave_place(*self.args)
            return ck.joint_wave_place(*self.args)

        def plan(self) -> dict:
            if not planned:
                return {}
            if mesh_on:
                p = ck.joint_sharded_plan_of(self.args[0], self.args[4])
            else:
                p = ck.joint_plan(dev, self.n, int(self.args[0].n_steps.shape[0]),
                                  self.args[4].with_shuffle,
                                  self.args[4].n_spreads)
            return {"clusters": p.clusters, "rows_shared": p.global_rows == 0}

    def timed(wave) -> tuple:
        out = wave.run()
        return out, cs.cuda_ms(wave.run, args.reps)

    def device_ms(wave) -> dict:
        """The kernel's own time a launch from the profiler's device
        trace (CUPTI), beside the host's time to enqueue a call: the
        event time of back-to-back calls is the larger of the two."""
        name = "joint_sharded_kernel" if mesh_on else "joint_wave_kernel"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            wave.run()
        host = (time.perf_counter() - t0) * 1e3 / args.reps
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                wave.run()
            torch.cuda.synchronize()
        total = sum(getattr(e, "device_time_total", 0) or
                    getattr(e, "cuda_time_total", 0)
                    for e in prof.key_averages() if name in e.key)
        launches = sum(e.count for e in prof.key_averages()
                       if name in e.key)
        return {"device_ms": total / 1e3 / args.reps if total else None,
                "kernel_launches": launches, "host_ms": host}

    def stanzas(kins, cluster):
        """Each member's rack stanza and three more over coarser racks."""
        racks = cs.rack_buckets(cluster)
        out = []
        for kin in kins:
            active = np.ones(STANZAS, bool)
            bucket = np.array(kin.spread_bucket)
            counts = np.array(kin.spread_counts)
            desired = np.array(kin.spread_desired)
            even = np.array(kin.spread_even)
            for s in range(1, STANZAS):
                bucket[s] = np.where(racks >= 0, racks // (s + 1), -1)
                counts[s] = rng.integers(0, 4, counts.shape[-1])
                even[s] = s % 2 == 0
                desired[s] = (-1.0 if even[s] else
                              rng.integers(1, 6, desired.shape[-1]))
            out.append(kin._replace(
                spread_active=active, spread_even=even,
                spread_weight=active.astype(np.float32),
                spread_bucket=bucket, spread_counts=counts,
                spread_desired=desired))
        return out

    def row_of(part, width, name, wave, ms, **extra) -> dict:
        return {"part": part, "n": wave.n, "nodes": width, "wave": name,
                "ms": ms, "active_steps": wave.active,
                "us_per_step": ms * 1e3 / wave.active, **extra}

    if "split" in args.parts:
        for nodes, allocs in ((10_000, 100_000), (1_500, 15_000)):
            cluster = cs.c2m_cluster(nodes, seed=cs.SEED)
            base = cs.base_kin(cluster, cs.c2m_pack_usage(
                cluster, allocs, seed=cs.SEED)[:3])
            kins, feats, _, _ = cs.joint_wave(base, cluster, "everything",
                                              rng, dev)
            four = stanzas(kins, cluster)
            idle = [k._replace(spread_active=np.zeros_like(
                np.asarray(k.spread_active))) for k in kins]
            for ns in (0, 1, STANZAS):
                for topk in (True, False):
                    f = feats[0]._replace(n_spreads=ns, with_topk=topk)
                    wave = Wave(four if ns == STANZAS else kins,
                                [f] * len(kins))
                    _, ms = timed(wave)
                    emit(row_of("split", nodes, "everything", wave, ms,
                                stanzas=ns, topk=topk))
                    del wave
            # one stanza that no member has active: the counts still swap
            # at each member's first step, and no step re-derives its rows
            wave = Wave(idle, [feats[0]._replace(with_topk=False)]
                        * len(idle))
            _, ms = timed(wave)
            emit(row_of("split", nodes, "everything", wave, ms, stanzas=1,
                        topk=False, active=False))
            del wave, idle, kins, four, base, cluster
            torch.cuda.empty_cache()

    if "scale" in args.parts:
        for nodes in (int(x) for x in args.nodes.split(",")):
            cluster, base = cluster_of(nodes)
            for union in args.unions.split(","):
                kins, feats, _, _ = cs.joint_wave(base, cluster, union, rng,
                                                  dev)
                wave = Wave(kins, feats)
                try:
                    _, ms = timed(wave)
                except (RuntimeError, ValueError) as err:
                    # the tree's wrapper refuses the wave (its width)
                    emit(row_of("scale", nodes, union, wave, float("nan"),
                                error=str(err)[:200]))
                    continue
                emit(row_of("scale", nodes, union, wave, ms, forced=None,
                            **wave.plan(), **device_ms(wave)))
                want = None
                for c in forced if force else ():
                    if c > most:
                        continue
                    with force(c):
                        got, ms = timed(wave)
                        shared = wave.plan()["rows_shared"]
                    same = None
                    if want is None:
                        want = got
                    else:
                        same = all(torch.equal(getattr(got, f),
                                               getattr(want, f))
                                   if isinstance(getattr(got, f),
                                                 torch.Tensor)
                                   else all(torch.equal(x, y) for x, y in
                                            zip(getattr(got, f),
                                                getattr(want, f)))
                                   for f in got._fields)
                    emit(row_of("scale", nodes, union, wave, ms, forced=c,
                                rows_shared=shared, same_as_first=same))
                    if same is False:
                        print(f"joint_split: {union} at {nodes} nodes over "
                              f"{c} clusters differs", file=sys.stderr)
                        return 1
                del want, wave, kins
            del base, cluster
            torch.cuda.empty_cache()

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"joint_split_{args.label}.json").write_text(
        json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
