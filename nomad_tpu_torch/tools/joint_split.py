"""Time the joint kernel's waves by part, width and cluster count.

    python3 nomad_tpu_torch/tools/joint_split.py
    python3 nomad_tpu_torch/tools/joint_split.py --parts scale \\
        --nodes 20000,50000 --unions spread,everything --clusters 1,2,4,7
    python3 nomad_tpu_torch/tools/joint_split.py --tree DIR --label parent

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
  300,000 N=524288);
- ``--clusters`` runs each scale wave over each forced cluster count the
  card holds (``chip_smoke.forced_clusters``), its outputs held bit for
  bit against the first count's, and gives the plan's own row its
  cluster count and rows' placement; it needs a tree with the cluster
  plan (``cuda_kernel.joint_clusters``).

Rows go to stdout as JSON lines, the card's name and power limit first,
and to ``chiprun_out/joint_split_<label>.json``.
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
         300_000: (1_000_000, 4)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--parts", default="split,scale")
    ap.add_argument("--nodes", default="10000,100000,300000")
    ap.add_argument("--unions",
                    default="spread,devices,cores,network,everything")
    ap.add_argument("--clusters", default="")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from nomad_tpu_torch.ops import cuda_kernel as ck
    from nomad_tpu_torch.parallel import coalesce

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

    emit({"card": smi, "tree": str(Path(args.tree).resolve())})
    t0 = time.perf_counter()
    ck.load_library("joint_wave")
    emit({"build_s": time.perf_counter() - t0})
    forced = [int(c) for c in args.clusters.split(",") if c]
    rng = np.random.default_rng(cs.SEED + 77)

    def cluster_of(nodes: int):
        allocs, seed = NODES[nodes]
        cluster = cs.c2m_cluster(nodes, seed=cs.SEED + seed)
        used = cs.c2m_pack_usage(cluster, allocs, seed=cs.SEED + seed)[:3]
        return cluster, cs.base_kin(cluster, used)

    def run(wave):
        return ck.joint_wave_place(wave.kin, wave.step_member,
                                   wave.step_local, wave.t_pad,
                                   wave.features)

    def timed(wave) -> tuple:
        out = run(wave)
        return out, cs.cuda_ms(lambda: run(wave), args.reps)

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

    def assemble(kins, feats):
        return coalesce.assemble_wave(kins, [cs.K_STEPS] * len(kins),
                                      [feats] * len(kins), dev)

    def row_of(part, width, name, wave, ms, **extra) -> dict:
        active = cs.active_steps(wave)
        return {"part": part, "n": int(wave.kin.cap_cpu.shape[-1]),
                "nodes": width, "wave": name, "ms": ms,
                "active_steps": active, "us_per_step": ms * 1e3 / active,
                **extra}

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
                    wave = assemble(four if ns == STANZAS else kins, f)
                    _, ms = timed(wave)
                    emit(row_of("split", nodes, "everything", wave, ms,
                                stanzas=ns, topk=topk))
                    del wave
            # one stanza that no member has active: the counts still swap
            # at each member's first step, and no step re-derives its rows
            wave = assemble(idle, feats[0]._replace(with_topk=False))
            _, ms = timed(wave)
            emit(row_of("split", nodes, "everything", wave, ms, stanzas=1,
                        topk=False, active=False))
            del wave, idle, kins, four, base, cluster
            torch.cuda.empty_cache()

    if "scale" in args.parts:
        most = ck._joint_card(dev)[1] if forced else 0
        for nodes in (int(x) for x in args.nodes.split(",")):
            cluster, base = cluster_of(nodes)
            for union in args.unions.split(","):
                _, _, wave, _ = cs.joint_wave(base, cluster, union, rng, dev)
                _, ms = timed(wave)
                plan = {}
                if forced:
                    p = cs.joint_plan_of(wave, dev)
                    plan = {"clusters": p.clusters,
                            "rows_shared": p.global_rows == 0}
                emit(row_of("scale", nodes, union, wave, ms, forced=None,
                            **plan))
                want = None
                for c in forced:
                    if c > min(most, ck.JOINT_MAX_CLUSTERS):
                        continue
                    with cs.forced_clusters(c):
                        got, ms = timed(wave)
                        shared = cs.joint_plan_of(wave, dev).global_rows == 0
                    same = None
                    if want is None:
                        want = got
                    else:
                        same = all(torch.equal(getattr(got, f),
                                               getattr(want, f))
                                   for f in got._fields)
                    emit(row_of("scale", nodes, union, wave, ms, forced=c,
                                rows_shared=shared, same_as_first=same))
                    if same is False:
                        print(f"joint_split: {union} at {nodes} nodes over "
                              f"{c} clusters differs", file=sys.stderr)
                        return 1
                del want, wave
            del base, cluster
            torch.cuda.empty_cache()

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"joint_split_{args.label}.json").write_text(
        json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
