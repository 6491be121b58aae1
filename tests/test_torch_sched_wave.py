"""Scheduler-built wave members: the port's against the JAX package's.

Eight evals of mixed lean jobs run their stacks against one snapshot in
each package (``_torch_twin.Twin`` keeps the stores and seeds equal). A
recording launcher takes each eval's member ``(kin, k_steps, features)``
and stops the eval there, so arrival order plays no part: the members
must be equal plane by plane, and one ``launch_wave`` per package over
them in the same order must place exactly alike (scores within 1e-5).

A threaded burst of 16 evals through the port's
``LaunchCoalescer(adaptive=False)`` is checked for its invariants only:
every eval complete with its placements, one fused wave, no node over
capacity.
"""

import numpy as np
import pytest

import _torch_parity as tp
from _torch_twin import Twin
from nomad_tpu import mock, structs
from nomad_tpu.parallel import coalesce as ref_coalesce
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.structs import consts
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import c2m
from nomad_tpu_torch.parallel import coalesce as pc
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.scheduler.testing import Harness as PortHarness
from nomad_tpu_torch.structs import consts as port_consts

N_NODES = 90
SEED = 11


class _Captured(Exception):
    pass


def _job(i):
    kind = i % 8
    job = mock.batch_job() if kind == 1 else mock.simple_job()
    tg = job.task_groups[0]
    tg.count = 3 + i % 4
    tg.tasks[0].resources = structs.Resources(cpu=250 * (1 + i % 3),
                                              memory_mb=128 * (1 + i % 2))
    if kind == 2:
        job.constraints = [structs.Constraint(
            operand=consts.CONSTRAINT_DISTINCT_HOSTS)]
    elif kind == 3:
        tg.networks = [structs.NetworkResource(
            mode="host", reserved_ports=[structs.Port(label="p",
                                                      value=7000 + i)])]
    elif kind == 4:
        job.affinities = [structs.Affinity(
            ltarget="${node.datacenter}", rtarget="dc2", operand="=",
            weight=50)]
    elif kind == 5:
        job.datacenters = ["dc1", "dc3"]
    return job


def _twin():
    rng = np.random.default_rng(SEED)
    tw = Twin()
    for i in range(N_NODES):
        n = mock.node(datacenter=f"dc{1 + i % 3}")
        n.node_resources.cpu.cpu_shares = int(rng.choice([4000, 8000]))
        n.compute_class()
        tw.upsert_node(n)
    return tw


def _capture(new_scheduler, h, snap, job, ev, **kw):
    got = []

    def record(kin, k_steps, features):
        got.append((kin, k_steps, features))
        raise _Captured

    sched = new_scheduler(job.type, snap, h, kernel_launch=record, **kw)
    with pytest.raises(_Captured):
        sched.process(ev)
    return got[0]


def test_scheduler_members_and_wave_match_reference():
    tw = _twin()
    jobs = [_job(i) for i in range(8)]
    evs = []
    for job in jobs:
        tw.upsert_job(job)
        evs.append(mock.eval(job_id=job.id, namespace=job.namespace,
                             type=job.type, priority=job.priority))
    port_evs = [tw.conv(e) for e in evs]
    tw.ref.state.upsert_evals(evs)
    tw.port.state.upsert_evals(port_evs)
    rsnap, psnap = tw.ref.state.snapshot(), tw.port.state.snapshot()
    assert rsnap.latest_index() == psnap.latest_index()

    ref_m, port_m = [], []
    for job, ev, pev in zip(jobs, evs, port_evs):
        ref_m.append(_capture(ref_new_scheduler, tw.ref, rsnap, job, ev))
        port_m.append(_capture(port_new_scheduler, tw.port, psnap,
                               tw.conv(job), pev, device="cpu"))
    for i, ((rk, rks, rf), (pk, pks, pf)) in enumerate(zip(ref_m, port_m)):
        assert rks == pks == tk.pad_steps_live(jobs[i].task_groups[0].count)
        assert rf._asdict() == pf._asdict()
        assert pf.with_shuffle, "every scheduler member carries a shuffle"
        for f in tk.KernelIn._fields:
            a, b = np.asarray(getattr(rk, f)), np.asarray(getattr(pk, f))
            assert a.dtype == b.dtype and a.shape == b.shape, (i, f)
            np.testing.assert_array_equal(a, b, err_msg=f"member {i} {f}")
    # the shuffle planes differ between evals: one seed per eval
    assert not np.array_equal(port_m[0][0].node_perm, port_m[1][0].node_perm)

    ref_outs = ref_coalesce.launch_wave(
        [m[0] for m in ref_m], [m[1] for m in ref_m], [m[2] for m in ref_m])
    pc.fused_wave_stats.reset()
    port_outs = pc.launch_wave(
        [m[0] for m in port_m], [m[1] for m in port_m],
        [m[2] for m in port_m], device="cpu")
    assert pc.fused_wave_stats.snapshot() == {"launches": 1, "fallbacks": 0,
                                              "failures": 0}
    placed = 0
    for i, (p, r) in enumerate(zip(port_outs, ref_outs)):
        for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(p, name)), np.asarray(getattr(r, name)),
                err_msg=f"member {i} {name}")
        for name in ("scores", "topk_scores"):
            np.testing.assert_allclose(
                np.asarray(getattr(p, name)), np.asarray(getattr(r, name)),
                rtol=0, atol=tp.SCORE_ATOL, err_msg=f"member {i} {name}")
        placed += int(np.asarray(p.found).sum())
    assert placed == sum(j.task_groups[0].count for j in jobs)


def test_threaded_burst_through_the_coalescer():
    rng = np.random.default_rng(SEED)
    h = PortHarness(device="cpu")
    for i in range(60):
        h.state.upsert_node(port_mock.node(datacenter=f"dc{1 + i % 10}"))
    jobs = [c2m.burst_job(rng, i) for i in range(16)]
    for job in jobs:
        job.task_groups[0].count = 4
    ck.launches = 0
    pc.fused_wave_stats.reset()
    evals, co, errors = tp.sched_round(h, jobs, "cpu")
    assert not errors, errors
    assert co.requests == 16 and co.launches == 1 and co.max_wave == 16
    assert pc.fused_wave_stats.snapshot() == {"launches": 1, "fallbacks": 0,
                                              "failures": 0}
    assert ck.launches == 0, "a CPU wave runs the plain version"
    status = {e.id: e.status for e in h.evals}
    assert all(status[e.id] == port_consts.EVAL_STATUS_COMPLETE
               for e in evals), status
    assert not h.create_evals
    snap = h.state.snapshot()
    for job in jobs:
        live = [a for a in snap.allocs_by_job(job.namespace, job.id)
                if not a.terminal_status()]
        assert len(live) == 4, job.id
    assert tp.over_capacity_nodes(h.state) == 0
