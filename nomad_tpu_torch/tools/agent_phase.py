"""Phase 15 of chip_smoke.py alone: the agent on the card over HTTP.

Builds the C2M replay state (``--state sched``, the default: phase 10's
scheduler path, its evals still pending in the store, as phase 15 gets
it in the smoke; ``--state c2m``: ``parallel/c2m.generate()`` alone,
quicker), then runs phase 15 (``chip_smoke.run_agent_phase``) ``--runs``
times, each with a new agent process, and prints one JSON line per run.
The whole record goes to ``chiprun_out/agent_phase.json``.

    python3 nomad_tpu_torch/tools/agent_phase.py --state c2m --runs 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", choices=("sched", "c2m"), default="sched")
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import subprocess

    import torch

    import chip_smoke as cs
    from nomad_tpu_torch.ops import cuda_kernel as ck
    from nomad_tpu_torch.parallel import c2m

    if not torch.cuda.is_available():
        print("agent_phase: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ck.load_libraries()
    t0 = time.perf_counter()
    if args.state == "sched":
        _, state_bytes = cs.run_sched_phase(dev, {})
    else:
        state_bytes = c2m.generate().to_snapshot_bytes()
    print(json.dumps({"state": args.state,
                      "state_s": time.perf_counter() - t0,
                      "state_bytes": len(state_bytes)}), flush=True)
    runs = []
    for i in range(args.runs):
        record: dict = {}
        res = cs.run_agent_phase(dev, record, state_bytes, {}, card)
        runs.append(res)
        print(json.dumps({"run": i, "phase_s": res["phase_s"],
                          "evals_per_s": res["evals_per_s"],
                          "agent_launches": res["agent_launches"]}),
              flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "agent_phase.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
