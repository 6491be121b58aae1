"""Time the single eval's candidate-set kernel by launch, width and steps.

    python3 nomad_tpu_torch/tools/candidate_split.py
    python3 nomad_tpu_torch/tools/candidate_split.py --nodes 10000 \\
        --steps 16,64 --variants shuffle --active 10 --reps 20

Runs on one CUDA card. For each C2M cluster of ``--nodes`` nodes
(``chip_smoke.c2m_cluster``, 10 allocs a node packed on it: 10,000 nodes
is N=16384, 100,000 is N=131072), each member variant (``--variants``,
chip_smoke.py's builders; ``everything`` without its spread stanza) and
each step count (``--steps``; step planes past the member's own are
neutral; ``--active`` of them active, all when 0), one eval's candidate
set through ``ck.candidate_eval_place`` (csrc/candidate_set.cu) is held
bit for bit to its plain version, then timed over ``--reps`` calls:

- ``pass_us`` / ``scan_us``: each launch's device time a call, from the
  profiler's device trace (CUPTI): the grid pass, and the one-CTA
  selection, rows and steps;
- ``call_ms``: CUDA events around back-to-back calls, which the wrapper's
  host work bounds when it is longer than the kernel;
- ``joint_us``: the full-width joint kernel (``ck.joint_eval_place``) on
  the same planes, its device time a call;
- ``plain_ms``: the plain version (torch ops), CUDA events, at up to 64
  steps.

Rows go to stdout as JSON lines, the card's name and power limit first,
and to ``chiprun_out/candidate_split.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", default="10000,100000")
    ap.add_argument("--steps", default="16,64,256,600")
    ap.add_argument("--variants", default="shuffle,kitchen_sink,everything")
    ap.add_argument("--active", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from nomad_tpu_torch.ops import cuda_kernel as ck
    from nomad_tpu_torch.ops.kernel import (
        _upload_kin,
        canonical_features,
        neutral_step_planes,
        pad_steps,
        place_taskgroup_topk,
    )

    if not torch.cuda.is_available():
        print("candidate_split: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    rows = []
    for nodes in map(int, args.nodes.split(",")):
        rng = np.random.default_rng(cs.SEED + nodes)
        cluster = cs.c2m_cluster(nodes, seed=cs.SEED)
        used = cs.c2m_pack_usage(cluster, 10 * nodes, seed=cs.SEED)[:3]
        base = cs.base_kin(cluster, used)
        for variant in args.variants.split(","):
            kin, f = cs.make_member(base, cluster, variant, rng)
            f = canonical_features(f._replace(n_spreads=0))
            for k in map(int, args.steps.split(",")):
                if k > int(np.asarray(kin.step_preferred).shape[0]):
                    pen, pref = neutral_step_planes(pad_steps(k))
                    kin = kin._replace(step_penalty=pen, step_preferred=pref)
                active = min(args.active, k) if args.active else k
                one = _upload_kin(kin._replace(
                    n_steps=np.asarray(active, np.int32)), dev)
                err = cs.candidate_vs_plain(one, k, f,
                                            f"{nodes}/{variant}/{k}")

                def kernel():
                    return ck.candidate_eval_place(one, k, f)

                def full():
                    return ck.joint_eval_place(one, k, f)

                kernel()
                full()
                pass_ms, _ = cs.kernel_device_ms(kernel, ("cand_pass",),
                                                 args.reps)
                scan_ms, _ = cs.kernel_device_ms(kernel, ("cand_scan",),
                                                 args.reps)
                joint_ms, _ = cs.kernel_device_ms(
                    full, ("joint_wave_kernel",), args.reps)
                row = {
                    "nodes": nodes, "n": int(one.cap_cpu.shape[-1]),
                    "variant": variant, "k_steps": k,
                    "active_steps": active,
                    "rows_in_shared": ck.candidate_plan(
                        one.cap_cpu.device, int(one.cap_cpu.shape[-1]), k,
                        min(int(one.cap_cpu.shape[-1]),
                            max(2 * k, k + 8, 8)), f.with_preferred)[1] > 0,
                    "max_abs_err": err,
                    "pass_us": pass_ms * 1e3 if pass_ms else None,
                    "scan_us": scan_ms * 1e3 if scan_ms else None,
                    "call_ms": cs.cuda_ms(kernel, args.reps),
                    "joint_us": joint_ms * 1e3 if joint_ms else None,
                }
                if k <= 64:
                    place_taskgroup_topk(one, k, f)
                    row["plain_ms"] = cs.cuda_ms(
                        lambda: place_taskgroup_topk(one, k, f), 3)
                print(json.dumps(row), flush=True)
                rows.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "candidate_split.json").write_text(
        json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
