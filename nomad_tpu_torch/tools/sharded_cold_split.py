"""Split the cold cost of a process's first sharded wave by stage.

    python3 nomad_tpu_torch/tools/sharded_cold_split.py          # 4 virtual shards, one card
    python3 nomad_tpu_torch/tools/sharded_cold_split.py --cards  # a mesh over every card
    python3 nomad_tpu_torch/tools/sharded_cold_split.py --device cpu --nodes 1000 --allocs 10000

Builds the C2M replay state (``parallel/c2m.generate``) once, then runs
fresh Python processes that restore it and place one wave of 32 lean
C2M members x 10 over a mesh through ``launch_wave(mesh=)``, with the
store's wave-shared planes resident split over the mesh, as a mesh
server's first wave has them. Each process has the root card's context
before it starts (a server has it), and runs one of two modes:

- ``cold``: the first sharded wave with nothing done before it; its
  time is the whole cold cost;
- ``staged``: the cold cost paid stage by stage, each timed on the host
  clock with every card of the mesh synchronized after it: the CUDA
  contexts of the mesh's other cards; ``load_library("sharded_wave")``;
  ``_sharded_plan`` for each card at the wave's shape; ``_enable_peers``
  (several cards only); the caching allocator's first blocks on each card
  (``_sharded_launch``'s buffers and the wave's placed leaves, allocated
  and freed, and one pinned staging buffer); the split resident
  generation's first upload (``configure_mesh``, ``request``,
  ``advance_pending``); then the first wave, which is left with the
  launch and its readback.

Both modes then repeat the wave three times (warm). Modes alternate over
``--runs`` pairs; each child prints one JSON line, and the whole record
goes to ``chiprun_out/sharded_cold_split.json``. The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WAVE = 32
WARM_REPEATS = 3


def _sync(devs) -> None:
    import torch

    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _timed(stages: dict, name: str, devs, fn) -> None:
    t0 = time.perf_counter()
    fn()
    _sync(devs)
    stages[name] = (time.perf_counter() - t0) * 1e3


def _segments(devs) -> dict:
    import torch

    return {str(d): torch.cuda.memory_stats(d).get(
        "segment.all.allocated", 0) for d in devs if d.type == "cuda"}


def child(mode: str, state_path: str, shards: int, cards: bool,
          device: str) -> dict:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from nomad_tpu_torch.ops import cuda_kernel as ck
    from nomad_tpu_torch.parallel import coalesce, sharded
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.tensors.device_state import default_device_state
    from nomad_tpu_torch.tensors.schema import (
        default_incremental_cluster_cache,
    )

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    store = StateStore()
    store.restore_from_bytes(Path(state_path).read_bytes())
    snap = store.snapshot()
    cluster = default_incremental_cluster_cache.get(snap)
    planes = cluster.wave_shared_planes(snap.usage)
    mask = cluster.ready.copy()
    mask.setflags(write=False)
    base = cs.base_kin(cluster, (planes["used_cpu"], planes["used_mem"],
                                 planes["used_disk"]))._replace(
        base_mask=mask, **planes)
    rng = np.random.default_rng(cs.SEED + 16)
    members = [cs.make_member(base, cluster, "lean", rng)
               for _ in range(WAVE)]
    kins, feats = [m[0] for m in members], [m[1] for m in members]
    steps = [cs.K_STEPS] * WAVE
    host_s = time.perf_counter() - t0

    mesh = (sharded.wave_mesh(device=dev) if cards
            else sharded.wave_mesh(devices=[dev] * shards))
    devs = list(dict.fromkeys(mesh.devices.flat))
    groups = ck.group_positions([d.index for d in mesh.devices.flat])
    n_loc = cluster.n_pad // mesh.size
    union = coalesce.union_features(feats)
    ds = default_device_state
    stages: dict = {}
    cuda = dev.type == "cuda"

    def contexts():
        for d in devs[1:]:
            torch.zeros(1, device=d)

    def plans():
        for ordinal, positions in groups:
            ck._sharded_plan(ordinal, len(positions), n_loc,
                             coalesce.pad_wave(WAVE), union.with_shuffle)

    def peers():
        ck._enable_peers(tuple(ordinal for ordinal, _ in groups))

    def allocator():
        # the wave's placed leaves, shaped by an assembly over a CPU mesh
        # of the same size, then _sharded_launch's own buffers
        cpu_mesh = sharded.wave_mesh(devices=[torch.device("cpu")]
                                     * mesh.size)
        wave = coalesce.assemble_sharded_wave(kins, steps, feats, cpu_mesh)
        flat = list(mesh.devices.flat)
        held = []
        for parts in wave.kin:
            for p, x in enumerate(parts):
                held.append(torch.empty_like(x, device=flat[p]))
        b, t = wave.b_pad, wave.t_pad
        for ordinal, positions in groups:
            d = flat[positions[0]]
            n_pos = len(positions)
            held += [torch.empty((3, n_pos, n_loc), device=d),
                     torch.empty(n_pos * b * n_loc, dtype=torch.int32,
                                 device=d)]
            if len(groups) > 1:
                held.append(torch.empty(ck._mail_bytes(len(groups), b),
                                        dtype=torch.uint8, device=d))
        held += [torch.empty(ck.fused_pack_len(t, b) + 1, device=dev),
                 torch.empty((t, 8), dtype=torch.int32, device=dev),
                 torch.empty((t, 8), device=dev),
                 torch.empty(4096, dtype=torch.uint8, pin_memory=True)]
        del held

    def resident():
        ds.configure_mesh(mesh)
        ds.request(cluster, snap.usage, dev)
        ds.advance_pending(mesh)

    if mode == "staged":
        if cuda:
            _timed(stages, "contexts", devs, contexts)
            _timed(stages, "library", devs,
                   lambda: ck.load_library("sharded_wave"))
            _timed(stages, "plans", devs, plans)
            _timed(stages, "peers", devs, peers)
            _timed(stages, "allocator", devs, allocator)
        _timed(stages, "resident", devs, resident)
    else:
        ds.configure_mesh(mesh)
        ds.request(cluster, snap.usage, dev)

    def wave():
        return coalesce.launch_wave(kins, steps, feats, device=dev, mesh=mesh)

    seg0 = _segments(devs) if cuda else {}
    loads0, plans0 = ck.library_loads, len(ck._SHARDED_PLANS)
    st0 = ds.snapshot()
    first: dict = {}
    _timed(first, "ms", devs, wave)
    st1 = ds.snapshot()
    seg1 = _segments(devs) if cuda else {}
    warm = []
    for _ in range(WARM_REPEATS):
        w: dict = {}
        _timed(w, "ms", devs, wave)
        warm.append(w["ms"])
    sstats = coalesce.sharded_wave_stats.snapshot()
    if sstats["launches"] != 1 + WARM_REPEATS or sstats["fallbacks"]:
        raise RuntimeError(f"the waves did not all run sharded: {sstats}")
    if ds.snapshot()["errors"]:
        raise RuntimeError(f"device state errors: {ds.snapshot()}")
    return {
        "mode": mode, "mesh": [str(d) for d in mesh.devices.flat],
        "cards": len(devs), "nodes": cluster.n_real, "n_pad": cluster.n_pad,
        "host_prep_s": host_s, "stages_ms": stages,
        "first_ms": first["ms"],
        "staged_plus_first_ms": sum(stages.values()) + first["ms"],
        "warm_ms": warm, "warm_median_ms": float(np.median(warm)),
        "first_library_loads": ck.library_loads - loads0,
        "first_plans_built": len(ck._SHARDED_PLANS) - plans0,
        "first_full_uploads": st1["full_uploads"] - st0["full_uploads"],
        "first_new_segments": {k: seg1[k] - seg0.get(k, 0) for k in seg1},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", nargs=2, metavar=("MODE", "STATE"))
    ap.add_argument("--cards", action="store_true",
                    help="a mesh over every card instead of virtual shards")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--allocs", type=int, default=100_000)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child[0], args.child[1], args.shards,
                               args.cards, args.device)), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import torch

    from nomad_tpu_torch.parallel import c2m

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        print(f"card: {card}", flush=True)
        from nomad_tpu_torch.ops.build import build_library

        build_library("sharded_wave")          # the .so on disk
    record = {"args": vars(args), "runs": []}
    with tempfile.TemporaryDirectory(prefix="cold_split_") as tmp:
        state = Path(tmp) / "state.bin"
        t0 = time.perf_counter()
        state.write_bytes(c2m.generate(args.nodes,
                                       args.allocs).to_snapshot_bytes())
        print(f"state: {args.nodes} nodes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for _ in range(args.runs):
            for mode in ("staged", "cold"):
                cmd = [sys.executable, str(Path(__file__).resolve()),
                       "--child", mode, str(state), "--shards",
                       str(args.shards), "--device", args.device]
                if args.cards:
                    cmd.append("--cards")
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600, cwd=str(ROOT))
                if proc.returncode != 0:
                    print(proc.stderr[-3000:], file=sys.stderr)
                    return proc.returncode
                line = proc.stdout.strip().splitlines()[-1]
                print(line, flush=True)
                record["runs"].append(json.loads(line))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "sharded_cold_split" + ("_cards" if args.cards else "")
    (out / f"{name}.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
