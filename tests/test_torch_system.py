"""The port's SystemScheduler against the JAX package's, eval by eval.

The three ``TestSystemSched`` scenarios of ``tests/test_generic_sched.py``
and four more (a job update that evicts and places, a preemption that
succeeds, a node that does not fit, a node that goes down) run on two
harnesses in lockstep (``_torch_twin.Twin``), each as a ``system`` and as
a ``sysbatch`` job. After every eval the plans and evals must agree
exactly: placements, stops and preemptions by alloc name and node,
statuses, ``failed_tg_allocs`` and ``queued_allocations``.
``_feasible_mask`` (a torch op) is held against the reference's
``_feasible_mask_jit`` on the same numpy ``KernelIn`` over several seeds
and feature sets: mask and fit planes exact.
"""

import numpy as np
import pytest

import _torch_parity as tp
from _torch_twin import Twin
from nomad_tpu import mock
from nomad_tpu.structs import consts
from nomad_tpu_torch.ops import kernel as tk

JOB_TYPES = (consts.JOB_TYPE_SYSTEM, consts.JOB_TYPE_SYSBATCH)


def _system_job(job_type, **kw):
    job = mock.system_job(**kw)
    job.type = job_type
    return job


def _placed(h):
    return h.placed_allocs()


def places_on_all_nodes(tw, job_type):
    # scheduler_system_test.go TestSystemSched_JobRegister
    tw.add_nodes(6)
    job = _system_job(job_type)
    tw.upsert_job(job)
    tw.run_eval(job)
    placed = _placed(tw.port)
    assert len(placed) == 6
    assert len({a.node_id for a in placed}) == 6


def skips_ineligible(tw, job_type):
    nodes = tw.add_nodes(4)
    tw.update_node_drain(nodes[0].id, True)
    tw.update_node_status(nodes[1].id, consts.NODE_STATUS_DOWN)
    job = _system_job(job_type)
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(_placed(tw.port)) == 2


def stops_on_drained(tw, job_type):
    nodes = tw.add_nodes(3)
    job = _system_job(job_type)
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(_placed(tw.port)) == 3
    tw.update_node_drain(nodes[0].id, True)
    tw.run_eval(job, trigger=consts.EVAL_TRIGGER_NODE_UPDATE)
    stops = [a for allocs in tw.port.plans[-1].node_update.values()
             for a in allocs]
    assert [a.node_id for a in stops] == [nodes[0].id]


def update_evicts_and_places(tw, job_type):
    """A job update whose tasks changed stops each node's alloc and
    places its successor there (the evict-and-place order)."""
    tw.add_nodes(3)
    job = _system_job(job_type)
    tw.upsert_job(job)
    tw.run_eval(job)
    job2 = job.copy()
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    tw.upsert_job(job2)
    tw.run_eval(job2)
    plan = tw.port.plans[-1]
    assert sum(len(v) for v in plan.node_update.values()) == 3
    assert sum(len(v) for v in plan.node_allocation.values()) == 3


def unchanged_update_is_in_place(tw, job_type):
    """A job update that leaves the tasks alone updates each alloc in
    place: no stop, the same alloc names on the same nodes."""
    tw.add_nodes(3)
    job = _system_job(job_type)
    tw.upsert_job(job)
    tw.run_eval(job)
    job2 = job.copy()
    job2.meta = {"owner": "ops"}
    tw.upsert_job(job2)
    tw.run_eval(job2)
    plan = tw.port.plans[-1]
    assert not plan.node_update


def _fillers(tw, nodes, cpu, mem, priority):
    """One running alloc per node, of a filler job of ``priority``, that
    takes ``cpu`` MHz and ``mem`` MB (tests/test_preemption.py's
    ``_alloc_on``)."""
    filler = mock.job()
    filler.priority = priority
    tw.upsert_job(filler)
    allocs = []
    for i, n in enumerate(nodes):
        a = mock.alloc(job=filler, job_id=filler.id, node_id=n.id,
                       name=f"{filler.id}.web[{i}]",
                       client_status=consts.ALLOC_CLIENT_RUNNING)
        a.job = filler
        tr = a.allocated_resources.tasks["web"]
        tr.cpu.cpu_shares = cpu
        tr.memory.memory_mb = mem
        a.allocated_resources.shared.disk_mb = 10
        allocs.append(a)
    tw.upsert_allocs(allocs)
    return allocs


def preemption_succeeds(tw, job_type):
    """Nodes packed by a low-priority alloc each: the system job preempts
    it on every node (system preemption is on by default)."""
    nodes = tw.add_nodes(2)
    _fillers(tw, nodes, 3500, 7000, priority=10)
    job = _system_job(job_type, priority=100)
    job.task_groups[0].tasks[0].resources.cpu = 2000
    job.task_groups[0].tasks[0].resources.memory_mb = 4000
    tw.upsert_job(job)
    tw.run_eval(job)
    plan = tw.port.plans[-1]
    placed = [a for v in plan.node_allocation.values() for a in v]
    assert len(placed) == 2 and all(a.preempted_allocations for a in placed)
    assert sum(len(v) for v in plan.node_preemptions.values()) == 2


def node_exhausted(tw, job_type):
    """A node packed by an alloc that cannot be preempted gets nothing and
    is counted in ``failed_tg_allocs``; the others are placed."""
    nodes = tw.add_nodes(3)
    _fillers(tw, nodes[:1], 3500, 7000, priority=100)
    job = _system_job(job_type, priority=50)
    job.task_groups[0].tasks[0].resources.cpu = 2000
    tw.upsert_job(job)
    tw.run_eval(job)
    assert len(_placed(tw.port)) == 2
    ev = tw.port.evals[-1]
    assert ev.status == consts.EVAL_STATUS_COMPLETE
    assert ev.failed_tg_allocs["web"].nodes_exhausted == 1


def node_down(tw, job_type):
    """A node that goes down has its alloc stopped as lost."""
    nodes = tw.add_nodes(3)
    job = _system_job(job_type)
    tw.upsert_job(job)
    tw.run_eval(job)
    tw.update_node_status(nodes[1].id, consts.NODE_STATUS_DOWN)
    tw.run_eval(job, trigger=consts.EVAL_TRIGGER_NODE_UPDATE)
    stops = [a for v in tw.port.plans[-1].node_update.values() for a in v]
    assert [a.node_id for a in stops] == [nodes[1].id]
    assert stops[0].client_status == consts.ALLOC_CLIENT_LOST


SCENARIOS = [
    places_on_all_nodes, skips_ineligible, stops_on_drained,
    update_evicts_and_places, unchanged_update_is_in_place,
    preemption_succeeds, node_exhausted, node_down,
]


@pytest.mark.parametrize("job_type", JOB_TYPES)
@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_system_scheduler_matches_reference(scenario, job_type):
    tw = Twin()
    scenario(tw, job_type)
    assert tw.port.evals[-1].status == consts.EVAL_STATUS_COMPLETE
    assert tw.port.evals[-1].queued_allocations == {"web": 0}


def test_system_scheduler_takes_a_device():
    from nomad_tpu_torch.scheduler import SystemScheduler, new_scheduler
    from nomad_tpu_torch.scheduler.testing import Harness

    h = Harness(device="cpu")
    for name in JOB_TYPES:
        sched = new_scheduler(name, h.state.snapshot(), h, device="cpu")
        assert isinstance(sched, SystemScheduler)
        assert sched.sysbatch == (name == consts.JOB_TYPE_SYSBATCH)
        assert sched.device.type == "cpu"


# -- _feasible_mask against _feasible_mask_jit ---------------------------------

MASK_VARIANTS = ("lean", "ports", "distinct", "devices", "cores", "network",
                 "kitchen_sink")


@pytest.mark.parametrize("variant", MASK_VARIANTS)
@pytest.mark.parametrize("seed", range(3))
def test_feasible_mask_matches_reference(variant, seed):
    from nomad_tpu.scheduler.system import _feasible_mask_jit
    from nomad_tpu_torch.scheduler import system as port_system

    kins, _ = tp.wave_members(seed, variant, 200, b=1, lib="ref")
    rng = np.random.default_rng(seed)
    n_pad = kins[0].cap_cpu.shape[0]
    # nodes from half full to full: some fit the ask, some do not
    kin = kins[0]._replace(
        used_cpu=(kins[0].cap_cpu * rng.uniform(0.5, 1.0, n_pad)).astype(
            np.float32),
        used_mem=(kins[0].cap_mem * rng.uniform(0.5, 1.0, n_pad)).astype(
            np.float32))
    want_mask, want_dims = _feasible_mask_jit(kin)
    before = port_system.mask_launches
    mask, dims = port_system._feasible_mask(
        tk.KernelIn(**{f: np.asarray(v) for f, v in kin._asdict().items()}),
        "cpu")
    assert port_system.mask_launches == before + 1
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    assert mask.dtype == np.bool_ and mask.shape == (kin.cap_cpu.shape[0],)
    assert dims.keys() == want_dims.keys()
    for name in dims:
        np.testing.assert_array_equal(dims[name], np.asarray(want_dims[name]),
                                      err_msg=name)
    # the mask is neither all nor nothing: the comparison tells something
    assert 0 < int(mask.sum()) < int(np.asarray(kin.base_mask).sum())


def test_feasible_mask_reads_resident_planes():
    """On a snapshot whose planes are resident, the mask is the same as on
    the host planes; the resident twins are what it reads."""
    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.parallel.coalesce import ClusterCache
    from nomad_tpu_torch.scheduler import system as port_system
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.stack import XLAGenericStack
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.tensors.device_state import default_device_state

    store = StateStore()
    for _ in range(20):
        store.upsert_node(port_mock.node())
    job = port_mock.system_job()
    snap = store.snapshot()
    cluster = ClusterCache("cpu").get(snap)
    ctx = EvalContext(snap, port_mock.eval().make_plan(job), device="cpu")
    stack = XLAGenericStack(False, ctx, cluster)
    stack.set_job(job)
    ev = stack._build_eval_tensors(job.task_groups[0],
                                   np.zeros(cluster.n_pad, bool))
    kin = tk.build_kernel_in(cluster, ev, 1)
    default_device_state.advance_pending("cpu")
    assert tk._resident_kin(kin, "cpu") is not kin
    mask, dims = port_system._feasible_mask(kin, "cpu")
    host = tk.KernelIn(**{f: np.array(v, copy=True)
                          for f, v in kin._asdict().items()})
    mask_h, dims_h = port_system._feasible_mask(host, "cpu")
    np.testing.assert_array_equal(mask, mask_h)
    assert int(mask.sum()) == 20
