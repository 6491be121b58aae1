"""The port's GenericScheduler against the JAX package's, eval by eval.

The service and batch scenarios of ``tests/test_generic_sched.py`` (the
system scheduler's are in ``tests/test_torch_system.py``) run on two
harnesses in lockstep (``_torch_twin.Twin``): the same nodes, jobs, evals
and alloc updates go to both stores, and after every eval the new plans
and evals must agree.
Placements and stops by alloc name, eval statuses, blocked and follow-up
evals and every ``AllocMetric`` counter exactly; scores within 1e-5. The
reference runs its jitted kernels on the CPU, the port its plain torch
placement on the CPU. The single-eval launcher, ``default_kernel_launch``,
is also held against the reference's on the wave variants' planes.
"""

import time

import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_twin import Twin
from nomad_tpu import mock, structs
from nomad_tpu.structs import consts


def _twin(n_nodes=10):
    tw = Twin()
    tw.add_nodes(n_nodes)
    return tw


def place_all(tw):
    tw.add_nodes(10)
    job = mock.simple_job()
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(tw.port.placed_allocs()) == 10
    assert tw.port.evals[-1].status == consts.EVAL_STATUS_COMPLETE


def anti_affinity(tw):
    tw.add_nodes(5)
    job = mock.simple_job()
    job.task_groups[0].count = 5
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len({a.node_id for a in tw.port.placed_allocs()}) == 5


def ports_assigned(tw):
    tw.add_nodes(3)
    job = mock.job()
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(tw.port.placed_allocs()) == 10


def failed_placement(tw):
    tw.add_nodes(2)
    job = mock.simple_job()
    job.task_groups[0].tasks[0].resources.cpu = 100000
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(tw.port.create_evals) == 1


def partial_placement(tw):
    tw.add_nodes(2)
    job = mock.simple_job()
    job.task_groups[0].tasks[0].resources.cpu = 3000
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(tw.port.placed_allocs()) == 2


def no_nodes(tw):
    job = mock.simple_job()
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(tw.port.create_evals) == 1


def constraint_filters(tw):
    tw.add_nodes(4)
    windows = mock.node()
    windows.attributes["kernel.name"] = "windows"
    windows.compute_class()
    tw.upsert_node(windows)
    job = mock.job()
    job.task_groups[0].tasks[0].resources.networks = []
    tw.upsert_job(job)
    tw.run_eval(job)
    assert windows.id not in {a.node_id for a in tw.port.placed_allocs()}


def _registered(tw, n_nodes=10, count=None):
    tw.add_nodes(n_nodes)
    job = mock.simple_job()
    if count is not None:
        job.task_groups[0].count = count
    tw.upsert_job(job)
    tw.run_eval(job)
    return job


def scale_up(tw):
    job = _registered(tw)
    job2 = job.copy()
    job2.task_groups[0].count = 15
    tw.upsert_job(job2)
    tw.run_eval(job2, trigger=consts.EVAL_TRIGGER_SCALING)


def scale_down(tw):
    job = _registered(tw)
    job2 = job.copy()
    job2.task_groups[0].count = 3
    tw.upsert_job(job2)
    tw.run_eval(job2, trigger=consts.EVAL_TRIGGER_SCALING)
    assert sum(len(v) for v in tw.port.plans[-1].node_update.values()) == 7


def stop_job(tw):
    job = _registered(tw, 5)
    job2 = job.copy()
    job2.stop = True
    tw.upsert_job(job2)
    tw.run_eval(job2, trigger=consts.EVAL_TRIGGER_JOB_DEREGISTER)


def inplace_update(tw):
    job = _registered(tw)
    job2 = job.copy()
    job2.task_groups[0].meta = {"new": "meta"}
    tw.upsert_job(job2)
    tw.run_eval(job2)


def destructive_update(tw):
    job = _registered(tw)
    job2 = job.copy()
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    tw.upsert_job(job2)
    tw.run_eval(job2)


def destructive_max_parallel(tw):
    job = _registered(tw)

    def running(b):
        b.client_status = consts.ALLOC_CLIENT_RUNNING

    tw.update_allocs(job, lambda allocs: allocs, running)
    job2 = job.copy()
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    job2.task_groups[0].update = structs.UpdateStrategy(max_parallel=3)
    tw.upsert_job(job2)
    tw.run_eval(job2)
    assert tw.port.plans[-1].deployment is not None


def node_drain(tw):
    job = _registered(tw, 4, count=4)
    victim = tw.ref.placed_allocs()[0].node_id

    def migrate(b):
        b.desired_transition = structs.DesiredTransition(migrate=True)

    tw.update_node_drain(victim, True)
    n = tw.update_allocs(
        job, lambda allocs: [a for a in allocs if a.node_id == victim],
        migrate)
    tw.run_eval(job, trigger=consts.EVAL_TRIGGER_NODE_DRAIN)
    places = [a for v in tw.port.plans[-1].node_allocation.values()
              for a in v]
    assert len(places) == n and all(a.node_id != victim for a in places)


def node_down(tw):
    job = _registered(tw, 4, count=4)
    victim = tw.ref.placed_allocs()[0].node_id
    tw.update_node_status(victim, consts.NODE_STATUS_DOWN)
    tw.run_eval(job, trigger=consts.EVAL_TRIGGER_NODE_UPDATE)


def _failed_once(tw, delay_s):
    tw.add_nodes(3)
    job = mock.simple_job()
    job.task_groups[0].count = 1
    job.task_groups[0].reschedule_policy = structs.ReschedulePolicy(
        attempts=3, interval_s=3600, delay_s=delay_s,
        delay_function="constant")
    tw.upsert_job(job)
    tw.run_eval(job)
    now = int(time.time() * 1e9)

    def failed(b):
        b.client_status = consts.ALLOC_CLIENT_FAILED
        b.modify_time_ns = now

    tw.update_allocs(job, lambda allocs: allocs, failed)
    tw.run_eval(job, trigger=consts.EVAL_TRIGGER_RETRY_FAILED_ALLOC)


def reschedule_penalty(tw):
    _failed_once(tw, 0)
    new = [a for v in tw.port.plans[-1].node_allocation.values() for a in v]
    assert len(new) == 1 and new[0].reschedule_tracker is not None


def delayed_reschedule(tw):
    _failed_once(tw, 300)
    assert [e for e in tw.port.create_evals if e.wait_until_s > 0]


def spread_across_dcs(tw):
    for dc in ("dc1", "dc2"):
        tw.add_nodes(4, datacenter=dc)
    job = mock.simple_job()
    job.datacenters = ["dc1", "dc2"]
    job.task_groups[0].count = 6
    job.task_groups[0].spreads = [structs.Spread(
        attribute="${node.datacenter}", weight=100, spread_target=[
            structs.SpreadTarget(value="dc1", percent=50),
            structs.SpreadTarget(value="dc2", percent=50)])]
    tw.upsert_job(job)
    tw.run_eval(job)


def distinct_hosts(tw):
    tw.add_nodes(4)
    job = mock.simple_job()
    job.constraints = [structs.Constraint(
        operand=consts.CONSTRAINT_DISTINCT_HOSTS)]
    job.task_groups[0].count = 6
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(tw.port.placed_allocs()) == 4


def affinity(tw):
    for cls, n in (("big", 2), ("small", 4)):
        for _ in range(n):
            nd = mock.node()
            nd.attributes["machine.class"] = cls
            nd.compute_class()
            tw.upsert_node(nd)
    job = mock.simple_job()
    job.task_groups[0].count = 2
    job.affinities = [structs.Affinity(
        ltarget="${attr.machine.class}", rtarget="big", operand="=",
        weight=100)]
    tw.upsert_job(job)
    tw.run_eval(job)


def reject_plan(tw):
    tw.add_nodes(2)
    tw.set_reject_plan(True)
    job = mock.simple_job()
    tw.upsert_job(job)
    tw.run_eval(job)
    assert tw.port.evals[-1].status == consts.EVAL_STATUS_FAILED


def _port_job(port=8080, count=3):
    job = mock.simple_job()
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = [structs.NetworkResource(
        mode="host", reserved_ports=[structs.Port(label="http", value=port)])]
    return job


def static_port(tw):
    tw.add_nodes(5)
    job = _port_job(count=3)
    tw.upsert_job(job)
    tw.run_eval(job)


def live_port_occupancy(tw):
    tw.add_nodes(4)
    for _ in range(2):
        job = _port_job(count=2)
        tw.upsert_job(job)
        tw.run_eval(job)


def port_exhaustion(tw):
    tw.add_nodes(2)
    job = _port_job(count=3)
    tw.upsert_job(job)
    tw.run_eval(job)
    assert tw.port.create_evals


def batch_register(tw):
    tw.add_nodes(6)
    job = mock.batch_job()
    job.task_groups[0].count = 8
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(tw.port.placed_allocs()) == 8


def batch_partial(tw):
    tw.add_nodes(2)
    job = mock.batch_job()
    job.task_groups[0].tasks[0].resources = structs.Resources(
        cpu=1500, memory_mb=256)
    tw.upsert_job(job)
    tw.run_eval(job)
    assert tw.port.create_evals


SCENARIOS = [
    place_all, anti_affinity, ports_assigned, failed_placement,
    partial_placement, no_nodes, constraint_filters, scale_up, scale_down,
    stop_job, inplace_update, destructive_update, destructive_max_parallel,
    node_drain, node_down, reschedule_penalty, delayed_reschedule,
    spread_across_dcs, distinct_hosts, affinity, reject_plan, static_port,
    live_port_occupancy, port_exhaustion, batch_register, batch_partial,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_scheduler_matches_reference(scenario):
    tw = Twin()
    scenario(tw)
    assert tw.port.plans or tw.port.evals


# -- the single-eval launcher -------------------------------------------------

LAUNCH_VARIANTS = tp.FUSED_VARIANTS + tp.COMPOSITE_VARIANTS


@pytest.mark.parametrize("variant,n_nodes", LAUNCH_VARIANTS,
                         ids=[v for v, _ in LAUNCH_VARIANTS])
def test_default_kernel_launch_matches_reference(variant, n_nodes):
    """The port's ``default_kernel_launch`` against the JAX package's on
    the same planes: host numpy out, choices, found, top-k indices and
    metrics exact, scores within 1e-5; the candidate-set route for every
    variant without spreads, the full-width one with them."""
    from nomad_tpu.ops.kernel import default_kernel_launch as ref_launch
    from nomad_tpu_torch.ops import kernel as tk

    kins, feats = tp.wave_members(21, variant, n_nodes, b=2, k=6)
    tk.single_eval_stats.reset()
    for m, kin in enumerate(kins):
        ref = ref_launch(kin, 6, feats)
        port = tk.default_kernel_launch(kin, 6, tp.port_features(feats),
                                        device="cpu")
        for name in tk.KernelOut._fields:
            got, want = getattr(port, name), np.asarray(getattr(ref, name))
            assert not isinstance(got, torch.Tensor), name
            if name in ("scores", "topk_scores"):
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=tp.SCORE_ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{variant} {m} {name}")
    spread = variant == "spread"
    assert tk.single_eval_stats.snapshot() == {
        "topk": 0 if spread else 2, "breaches": 0, "full": 2 if spread else 0}


def test_default_kernel_launch_reruns_a_breach_full_width(monkeypatch):
    """Where the candidate set's bound breaks (``valid`` False), the
    launcher hands back the full-width placement and counts the breach."""
    from nomad_tpu_torch.ops import kernel as tk

    kins, feats = tp.wave_members(22, "lean", 200, b=1, k=6)
    pf = tp.port_features(feats)
    want = tk.default_kernel_launch(kins[0], 6, pf, device="cpu")
    topk = tk.place_taskgroup_topk

    def breached(kin, k_steps, features, n_candidates=0):
        out, ok = topk(kin, k_steps, features, n_candidates)
        # the candidate set's own answer, spoiled: it must not come back
        return out._replace(chosen=torch.zeros_like(out.chosen)), ~ok

    monkeypatch.setattr(tk, "place_taskgroup_topk", breached)
    tk.single_eval_stats.reset()
    got = tk.default_kernel_launch(kins[0], 6, pf, device="cpu")
    assert tk.single_eval_stats.snapshot() == {"topk": 1, "breaches": 1,
                                               "full": 1}
    for name in tk.KernelOut._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
