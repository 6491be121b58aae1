"""Entry points of the port, the counterparts of the repository root's
``__graft_entry__.py``.

- ``entry(device=None)``: one single-eval placement step and its example
  arguments (``ops/kernel.place_taskgroup`` over a synthetic problem of
  300 nodes, 16 steps and a spread).
- ``dryrun_multichip(n_devices, devices=None)``: the batched placement
  step over an ``(evals, nodes)`` mesh of ``n_devices``
  (``parallel/sharded.make_place_batch``: each eval through the hand
  kernels where it fits their envelope), then a live server whose
  placement waves run over a mesh of the same devices.

Both run on the card unless the caller passes CPU devices:
``dryrun_multichip(8, devices=["cpu"] * 8)`` runs the plain versions over
an eight-entry CPU mesh, as the tests do.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from nomad_tpu_torch.device import DeviceLike, resolve_device

#: the dry run's placements an eval
DRYRUN_STEPS = 4
#: the live half: nodes registered, jobs of two allocations each
DRYRUN_NODES = 12
DRYRUN_JOBS = 4
DRYRUN_DEADLINE_S = 180.0


def entry(device: DeviceLike = None):
    """Return ``(fn, example_args)``: one placement step and its
    arguments on ``device`` (the card unless the caller asks for the
    CPU)."""
    from nomad_tpu_torch.ops.kernel import _upload_kin, place_taskgroup
    from nomad_tpu_torch.parallel.synthetic import synthetic_kernel_in

    k_steps = 16
    kin = synthetic_kernel_in(n_nodes=300, n_steps=k_steps, with_spread=True)

    def forward(kernel_in):
        return place_taskgroup(kernel_in, k_steps)

    return forward, (_upload_kin(kin, resolve_device(device)),)


def _require(cond, msg: str) -> None:
    """The dry run's checks, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """Run the batched placement step over an ``(evals, nodes)`` mesh of
    ``n_devices`` (the first cards, or ``devices``; raises when there are
    fewer), check it as ``__graft_entry__.dryrun_multichip`` does, then
    place a few jobs through a live server whose waves run over a mesh
    of the same devices. Returns the batch's outputs (one host-numpy
    KernelOut an eval), its routes and the live half's counts."""
    from nomad_tpu_torch.ops.kernel import pad_steps
    from nomad_tpu_torch.parallel.mesh import make_mesh
    from nomad_tpu_torch.parallel.sharded import (
        make_place_batch,
        place_batch_stats,
        stack_kernel_ins,
        unstack_kernel_outs,
    )
    from nomad_tpu_torch.parallel.synthetic import synthetic_kernel_in

    mesh = make_mesh(n_devices, devices=devices)
    evals_par = mesh.shape["evals"]
    nodes_par = mesh.shape["nodes"]
    # independent placement problems whose padded node axis divides over
    # the nodes axis, a spread on every even one
    batch = max(2 * evals_par, 4)
    n_nodes = max(64 * nodes_par, 128)
    n_pad = -(-n_nodes // nodes_par) * nodes_par
    k_pad = pad_steps(DRYRUN_STEPS)
    kins = [
        synthetic_kernel_in(
            n_nodes=n_nodes, n_steps=DRYRUN_STEPS, with_spread=(i % 2 == 0),
            used_frac=0.4, seed=i, n_pad=n_pad,
        )
        for i in range(batch)
    ]

    routes0 = place_batch_stats.snapshot()
    step = make_place_batch(mesh, k_pad)
    out = step(stack_kernel_ins(kins))
    routes1 = place_batch_stats.snapshot()
    host = type(out)(*[x.detach().cpu().numpy() for x in out])

    chosen, found, scores = host.chosen, host.found, host.scores
    _require(chosen.shape == (batch, k_pad), str(chosen.shape))
    # the cluster is nearly empty: every real step must place
    _require(bool(found[:, :DRYRUN_STEPS].all()),
             "placements missing in dryrun")
    _require(not found[:, DRYRUN_STEPS:].any(),
             "padded steps must be inactive")
    _require(np.isfinite(scores[found]).all(), "scores not finite")
    _require((chosen[found] >= 0).all() and (chosen[found] < n_nodes).all(),
             "a choice outside the real nodes")

    live = _dryrun_server(list(mesh.devices.flat))
    return {
        "mesh": dict(mesh.shape), "batch": batch, "k_pad": k_pad,
        "outs": unstack_kernel_outs(host),
        "routes": {k: routes1[k] - routes0[k] for k in routes1},
        **live,
    }


def _dryrun_server(devices: list) -> dict:
    """The dry run's live half: a server on the mesh's first device whose
    placement waves run over a nodes mesh of every device, adopted after
    ``start()`` as a server adopts a virtual mesh; 12 nodes, 4 jobs of 2
    allocations; the sharded waves must grow."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel import coalesce
    from nomad_tpu_torch.parallel.sharded import wave_mesh
    from nomad_tpu_torch.server.server import Server, ServerConfig

    before = coalesce.sharded_wave_stats.snapshot()["launches"]
    # a short-lived server in the caller's process: no interpreter GC
    # treatment and no warmup manifest read or written
    server = Server(ServerConfig(
        num_workers=1, worker_batch_size=4, heartbeat_ttl=3600.0,
        use_device_mesh=False, gc_tuning=False, kernel_warmup=False,
    ), device=devices[0])
    server.start()
    try:
        server._adopt_wave_mesh(wave_mesh(devices=devices))
        _require(server.wave_mesh is not None,
                 "server did not adopt the mesh")
        for _ in range(DRYRUN_NODES):
            server.node_register(mock.node())
        jobs = []
        for _ in range(DRYRUN_JOBS):
            job = mock.simple_job()
            job.task_groups[0].count = 2
            jobs.append(job)
            server.job_register(job)
        want = 2 * DRYRUN_JOBS
        deadline = time.time() + DRYRUN_DEADLINE_S
        placed = 0
        while time.time() < deadline:
            snap = server.state.snapshot()
            placed = sum(len(snap.allocs_by_job(j.namespace, j.id))
                         for j in jobs)
            if placed >= want:
                break
            time.sleep(0.1)
        _require(placed >= want,
                 f"live sharded placement incomplete: {placed}/{want}")
        launches = coalesce.sharded_wave_stats.snapshot()["launches"] - before
        _require(launches > 0, "live path did not use the sharded wave")
    finally:
        server.shutdown()
    return {"placed": placed, "sharded_waves": launches}
