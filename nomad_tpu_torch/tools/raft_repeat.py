"""Phase 14 of chip_smoke.py alone, repeated, on phase 10's state.

Builds the state that phase 14 gets in the smoke (phase 10's scheduler
path on the C2M replay cluster, its evals still pending in the store),
then runs the phase-14 child (``chip_smoke.py --raft-cluster``) ``--runs``
times, one process each, and prints one JSON line per run: its exit
code and seconds, the leader wins and the worker errors before the
burst, the failover and the evals/s, or the end of its standard error
when it failed. A run's own record goes to
``chiprun_out/raft_repeat_<i>.json``. Phase 14's gates are timing
dependent (leadership churn under the interpreter lock), so one smoke
run shows little; this shows how often a run passes.

    python3 nomad_tpu_torch/tools/raft_repeat.py --runs 4
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: the run's record keys printed on its line
KEYS = ("seeding_leader_wins", "seeding_worker_errors", "warmup_leader_wins",
        "warmup_worker_errors", "pre_burst_worker_errors", "first_leader",
        "new_leader", "evals_per_s_before_kill", "evals_per_s_after_kill",
        "failover", "thread_error_count", "phase_s")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from nomad_tpu_torch.ops import cuda_kernel as ck

    if not torch.cuda.is_available():
        print("raft_repeat: no CUDA card", file=sys.stderr)
        return 2
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    ck.load_libraries()
    t0 = time.perf_counter()
    _, state_bytes = cs.run_sched_phase(torch.device("cuda"), {})
    print(json.dumps({"state_s": time.perf_counter() - t0,
                      "state_bytes": len(state_bytes)}), flush=True)
    state = out_dir / "raft_repeat_state.bin"
    state.write_bytes(state_bytes)
    del state_bytes
    failed = 0
    try:
        for i in range(args.runs):
            out = out_dir / f"raft_repeat_{i}.json"
            out.unlink(missing_ok=True)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--raft-cluster", str(state), str(out)],
                capture_output=True, text=True,
                timeout=cs.RAFT_CHILD_TIMEOUT_S, cwd=str(ROOT))
            line = {"run": i, "rc": proc.returncode,
                    "process_s": time.perf_counter() - t0}
            if proc.returncode == 0:
                res = json.loads(out.read_text())
                line.update({k: res.get(k) for k in KEYS})
            else:
                failed += 1
                line["stderr_tail"] = proc.stderr[-2000:]
            print(json.dumps(line), flush=True)
    finally:
        state.unlink(missing_ok=True)
    print(json.dumps({"runs": args.runs, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
