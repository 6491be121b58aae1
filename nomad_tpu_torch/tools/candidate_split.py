"""Time the single eval's candidate-set kernel by phase, width and steps.

    python3 nomad_tpu_torch/tools/candidate_split.py
    python3 nomad_tpu_torch/tools/candidate_split.py --nodes 10000 \\
        --steps 16,64 --variants shuffle --active 10 --reps 20
    python3 nomad_tpu_torch/tools/candidate_split.py --root OTHER_CHECKOUT

Runs on one CUDA card. For each C2M cluster of ``--nodes`` nodes
(``chip_smoke.c2m_cluster``, 10 allocs a node packed on it: 10,000 nodes
is N=16384, 100,000 is N=131072), each member variant (``--variants``,
chip_smoke.py's builders; ``everything`` without its spread stanza) and
each step count (``--steps``; step planes past the member's own are
neutral; ``--active`` of them active, all when 0), one eval's candidate
set through ``ck.candidate_eval_place`` (csrc/candidate_set.cu) is held
bit for bit to its plain version, then timed over ``--reps`` calls:

- ``device_us``: the call's device time, ``5 * reps`` back-to-back C
  calls between CUDA events (``chip_smoke.c_call_ms``): every launch of
  the call and what lies between them on the stream;
- ``pass_us`` and ``scan_us``: each launch's own device time in one
  profiler trace (CUPTI); the scan, the pass's programmatic dependent
  launch, may start while the pass runs, so the two may overlap;
- ``call_ms``: CUDA events around back-to-back wrapper calls, which the
  host's work bounds when it is longer than the kernel;
- ``joint_us``: the full-width joint kernel (``ck.joint_eval_place``) on
  the same planes, its device time a call in the trace;
- ``selection_us``, ``rows_us``, ``steps_us``: ``scan_us`` split in the
  ratio of the scan's own ``clock64`` stamps (``ck.candidate_args``'s
  ``stamps``) at the ends of the selection (partial counts, the m-th key,
  the ordered keys), of the rows (refs, heads and their keys) and of the
  steps, with the raw cycles beside them;
- host: ``wrapper_us`` a call of ``ck.candidate_eval_place`` without the
  C call, ``dispatch_us`` the C call (both launches), ``readback_us``
  ``ck.candidate_readback`` once the card is idle (its one copy and the
  numpy views);
- ``plain_ms``: the plain version (torch ops), CUDA events, at up to 64
  steps.

First of all one line shows a single eval's ``single_topk`` route
(``ops/kernel.default_kernel_launch``) as the device sees it
(``readback_trace``: its device operations from the kernel's first launch
on, in order): the two launches, then one copy to the host.

``--root`` times the port of another checkout (an earlier commit unpacked
beside this one) on the same planes with this checkout's chip_smoke.py
builders and timers: its rows hold what any design of the kernel has
(``max_abs_err``, ``device_us``, ``pass_us``, ``scan_us``, ``call_ms``,
``joint_us``), so two designs compare in one run.

Rows go to stdout as JSON lines, the card's name and power limit first,
and to ``chiprun_out/candidate_split.json`` (``--out`` names another
file there).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", default="10000,100000")
    ap.add_argument("--steps", default="16,64,256,600")
    ap.add_argument("--variants", default="shuffle,kitchen_sink,everything")
    ap.add_argument("--active", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--out", default="candidate_split.json")
    args = ap.parse_args()
    root = args.root.resolve()
    own = root == ROOT
    # the port (and its kernels' build) from --root; chip_smoke.py's
    # builders and timers always from this checkout
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from nomad_tpu_torch.ops import cuda_kernel as ck
    from nomad_tpu_torch.ops import kernel as tk

    if not torch.cuda.is_available():
        print("candidate_split: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "root": str(root)}), flush=True)

    def host_split(kernel, k):
        """(wrapper us, dispatch us, readback us) a call."""
        real = ck._call
        spent = []

        def timed(*a):
            t0 = time.perf_counter()
            real(*a)
            spent.append(time.perf_counter() - t0)

        torch.cuda.synchronize()
        ck._call = timed
        try:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                out = kernel()
            total = time.perf_counter() - t0
        finally:
            ck._call = real
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            ck.candidate_readback(*out, k)
        back = time.perf_counter() - t0
        us = 1e6 / args.reps
        return (total - sum(spent)) * us, sum(spent) * us, back * us

    def scan_cycles(one, k, f):
        """The scan's cycles in its selection, rows and steps."""
        stamps = torch.zeros(4, dtype=torch.int64, device=dev)
        w, buf = ck.candidate_args(one, k, f, stamps=stamps)
        ck._call("candidate_set", w, dev, "candidate_set_kernel")
        s = stamps.tolist()
        del buf
        return [s[1] - s[0], s[2] - s[1], s[3] - s[2]]

    rows = []
    traced = not own
    for nodes in map(int, args.nodes.split(",")):
        rng = np.random.default_rng(cs.SEED + nodes)
        cluster = cs.c2m_cluster(nodes, seed=cs.SEED)
        used = cs.c2m_pack_usage(cluster, 10 * nodes, seed=cs.SEED)[:3]
        base = cs.base_kin(cluster, used)
        for variant in args.variants.split(","):
            kin, f = cs.make_member(base, cluster, variant, rng)
            f = tk.canonical_features(f._replace(n_spreads=0))
            for k in map(int, args.steps.split(",")):
                if k > int(np.asarray(kin.step_preferred).shape[0]):
                    pen, pref = tk.neutral_step_planes(tk.pad_steps(k))
                    kin = kin._replace(step_penalty=pen, step_preferred=pref)
                active = min(args.active, k) if args.active else k
                host_kin = kin._replace(n_steps=np.asarray(active, np.int32))
                one = tk._upload_kin(host_kin, dev)
                err = cs.candidate_vs_plain(one, k, f,
                                            f"{nodes}/{variant}/{k}")

                def kernel():
                    return ck.candidate_eval_place(one, k, f)

                def full():
                    return ck.joint_eval_place(one, k, f)

                if not traced:
                    traced = True
                    tk.default_kernel_launch(host_kin, k, f, device=dev)
                    torch.cuda.synchronize()
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        tk.default_kernel_launch(host_kin, k, f, device=dev)
                        torch.cuda.synchronize()
                    ops = [e.name for e in sorted(
                        (e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)]
                    first = next((i for i, name in enumerate(ops)
                                  if "cand_pass" in name), len(ops))
                    ops = ops[first:]
                    line = {"readback_trace": ops,
                            "one_copy_after_the_kernel": len(ops) == 3
                            and "cand_scan" in ops[1]
                            and "DtoH" in ops[2]}
                    print(json.dumps(line), flush=True)
                    rows.append(line)

                kernel()
                full()
                parts, _ = cs.kernel_device_parts(
                    kernel, ("cand_pass", "cand_scan"), args.reps)
                joint_ms, _ = cs.kernel_device_ms(
                    full, ("joint_wave_kernel",), args.reps)
                n = int(one.cap_cpu.shape[-1])
                row = {
                    "nodes": nodes, "n": n, "variant": variant,
                    "k_steps": k, "active_steps": active,
                    "max_abs_err": err,
                    "device_us": cs.c_call_ms(kernel, 5 * args.reps) * 1e3,
                    "pass_us": parts["cand_pass"] and parts["cand_pass"] * 1e3,
                    "scan_us": parts["cand_scan"] and parts["cand_scan"] * 1e3,
                    "call_ms": cs.cuda_ms(kernel, args.reps),
                    "joint_us": joint_ms * 1e3 if joint_ms else None,
                }
                if own:
                    cycles = scan_cycles(one, k, f)
                    row["rows_in_shared"] = ck.candidate_plan(
                        dev, n, k, min(n, max(2 * k, k + 8, 8)),
                        f.with_preferred)[1] > 0
                    row["scan_cycles"] = cycles
                    if row["scan_us"]:
                        for name, c in zip(("selection_us", "rows_us",
                                            "steps_us"), cycles):
                            row[name] = row["scan_us"] * c / max(sum(cycles),
                                                                 1)
                    (row["wrapper_us"], row["dispatch_us"],
                     row["readback_us"]) = host_split(kernel, k)
                    if k <= 64:
                        tk.place_taskgroup_topk(one, k, f)
                        row["plain_ms"] = cs.cuda_ms(
                            lambda: tk.place_taskgroup_topk(one, k, f), 3)
                print(json.dumps(row), flush=True)
                rows.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / args.out).write_text(
        json.dumps({"card": card, "root": str(root), "rows": rows},
                   indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
