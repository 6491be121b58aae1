"""The port's struct -> plane builders against the JAX package's.

A mixed cluster of 200 nodes (four datacenters, three node classes,
racks, agent-reserved ports, GPU devices on some nodes) with live
allocations (some holding static and dynamic ports) goes into both
packages' stores through ``_torch_twin.Twin``. ``ClusterTensors.build``,
``gathered_usage``, ``usage_perm``, ``AskTensor.build`` and the
``IncrementalClusterCache`` after a node update, a drain and alloc churn
(each also against a fresh build of the same snapshot) must give exactly
equal planes.
"""

import numpy as np
import pytest

from _torch_twin import Twin
from nomad_tpu import mock, structs
from nomad_tpu.structs import consts
from nomad_tpu.tensors import schema as ref_schema
from nomad_tpu_torch.tensors import schema as port_schema

N_NODES = 200
SEED = 5

PLANES = port_schema.ClusterTensors._PLANE_FIELDS
RAGGED = port_schema.ClusterTensors._RAGGED_FIELDS


def _node(rng, i):
    cls = ("standard", "large", "gpu")[i % 3]
    n = mock.node(name=f"mixed-{i}", datacenter=f"dc{1 + i % 4}",
                  node_class=cls)
    n.attributes = dict(n.attributes)
    n.attributes["platform.aws.placement.rack"] = f"r{int(rng.integers(8))}"
    if cls == "large":
        n.node_resources.cpu = structs.NodeCpuResources(
            cpu_shares=16000, total_core_count=16,
            reservable_cpu_cores=list(range(16)))
        n.node_resources.memory = structs.NodeMemoryResources(
            memory_mb=32768)
    if cls == "gpu":
        n.node_resources.devices = [structs.NodeDeviceResource(
            vendor="nvidia", type="gpu", name="A100",
            instance_ids=[f"gpu-{i}-{g}" for g in range(4)])]
    if i % 5 == 0:
        n.reserved_resources = structs.NodeReservedResources(
            cpu_shares=200, memory_mb=512, disk_mb=4096,
            reserved_cpu_cores=[0], networks_ports=[22, 8080 + i % 3])
    n.compute_class()
    return n


def _alloc(rng, job, node, slot):
    tr = structs.AllocatedTaskResources(
        cpu=structs.AllocatedCpuResources(
            cpu_shares=int(rng.choice([100, 250, 500]))),
        memory=structs.AllocatedMemoryResources(
            memory_mb=int(rng.choice([64, 128, 256]))))
    if slot % 4 == 0:
        tr.networks = [structs.NetworkResource(
            device="eth0", ip="192.168.0.100", mbits=10,
            reserved_ports=[structs.Port(label="http",
                                         value=9000 + slot % 7)],
            dynamic_ports=[structs.Port(label="dyn",
                                        value=21000 + slot)])]
    return structs.Allocation(
        id=f"live-{job.id}-{slot}", eval_id="e", node_id=node.id,
        namespace=job.namespace, job_id=job.id, job=job,
        task_group=job.task_groups[0].name,
        name=f"{job.id}.web[{slot}]",
        desired_status=consts.ALLOC_DESIRED_RUN,
        client_status=consts.ALLOC_CLIENT_RUNNING,
        allocated_resources=structs.AllocatedResources(
            tasks={"web": tr},
            shared=structs.AllocatedSharedResources(disk_mb=150)))


def _make_twin():
    rng = np.random.default_rng(SEED)
    tw = Twin()
    nodes = [_node(rng, i) for i in range(N_NODES)]
    for n in nodes:
        tw.upsert_node(n)
    job = mock.simple_job(id="live-job")
    job.task_groups[0].count = 300
    tw.upsert_job(job)
    allocs = [_alloc(rng, job, nodes[int(rng.integers(N_NODES))], s)
              for s in range(300)]
    port_allocs = [tw.conv(a) for a in allocs]
    tw.ref.state.upsert_allocs(allocs)
    tw.port.state.upsert_allocs(port_allocs)
    tw.nodes, tw.job, tw.rng = nodes, job, rng
    return tw


@pytest.fixture(scope="module")
def twin():
    return _make_twin()


def assert_cluster_equal(r, p):
    assert (r.n_real, r.n_pad) == (p.n_real, p.n_pad)
    for f in PLANES:
        a, b = getattr(r, f), getattr(p, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in RAGGED:
        assert list(getattr(r, f)) == list(getattr(p, f)), f
    assert r.index == p.index


def assert_usage_equal(rc, rs, pc, ps):
    for a, b in zip(rc.gathered_usage(rs.usage), pc.gathered_usage(ps.usage)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert not b.flags.writeable
    for a, b in zip(rc.usage_perm(rs.usage), pc.usage_perm(ps.usage)):
        np.testing.assert_array_equal(a, b)


def _builds(tw):
    rs, ps = tw.ref.state.snapshot(), tw.port.state.snapshot()
    rc = ref_schema.ClusterTensors.build(rs.nodes())
    pc = port_schema.ClusterTensors.build(ps.nodes())
    return rs, ps, rc, pc


def test_cluster_build_matches_reference(twin):
    rs, ps, rc, pc = _builds(twin)
    assert pc.n_real == N_NODES and pc.n_pad == 256
    assert_cluster_equal(rc, pc)
    assert set(pc.datacenters) == {"dc1", "dc2", "dc3", "dc4"}
    # agent-reserved ports reach the node plane
    assert pc.port_words[:, 22 >> 5].any()
    for a, b in zip(rc.dc_pool_arrays(), pc.dc_pool_arrays()):
        np.testing.assert_array_equal(a, b)
    assert rc.class_rows() == pc.class_rows()


def test_gathered_usage_and_perm_match_reference(twin):
    rs, ps, rc, pc = _builds(twin)
    assert_usage_equal(rc, rs, pc, ps)
    used = pc.gathered_usage(ps.usage)
    assert used[0].sum() > 0 and used[4].sum() > 0
    # one object per usage version: the wave shares it by identity
    assert pc.gathered_usage(ps.usage) is used
    shared = pc.wave_shared_planes(ps.usage)
    assert shared["used_cpu"] is used[0]
    assert shared["cap_cpu"] is pc.cap_cpu


def _ask_groups():
    dev = mock.job()
    dev.task_groups[0].tasks[0].resources.devices = [
        structs.RequestedDevice(name="nvidia/gpu", count=2)]
    cores = mock.simple_job()
    cores.task_groups[0].tasks[0].resources = structs.Resources(
        cores=2, memory_mb=512)
    ports = mock.simple_job()
    ports.task_groups[0].networks = [structs.NetworkResource(
        mode="host", mbits=20,
        reserved_ports=[structs.Port(label="a", value=8080),
                        structs.Port(label="b", value=40000)],
        dynamic_ports=[structs.Port(label="d")])]
    return {"ports_task": mock.job(), "simple": mock.simple_job(),
            "devices": dev, "cores": cores, "group_ports": ports}


@pytest.mark.parametrize("name", sorted(_ask_groups()))
def test_ask_tensor_matches_reference(twin, name):
    job = _ask_groups()[name]
    tg = job.task_groups[0]
    r = ref_schema.AskTensor.build(tg)
    p = port_schema.AskTensor.build(twin.conv(tg))
    for f in ("cpu", "mem", "disk", "cores", "n_dyn_ports", "reserved_ports",
              "n_dev_reqs", "total_mbits"):
        assert getattr(r, f) == getattr(p, f), f
    np.testing.assert_array_equal(r.port_mask, p.port_mask)
    np.testing.assert_array_equal(r.dev_counts, p.dev_counts)


def _churn_node_update(tw):
    node = tw.nodes[7]
    node2 = node.copy()
    node2.reserved_resources = structs.NodeReservedResources(
        cpu_shares=500, memory_mb=1024, networks_ports=[22, 443])
    tw.upsert_node(node2)


def _churn_drain(tw):
    tw.update_node_drain(tw.nodes[11].id, True)


def _churn_allocs(tw):
    def stop(b):
        b.desired_status = consts.ALLOC_DESIRED_STOP
        b.client_status = consts.ALLOC_CLIENT_COMPLETE

    tw.update_allocs(tw.job, lambda allocs: allocs[::9], stop)
    extra = [_alloc(tw.rng, tw.job, tw.nodes[3 * s % N_NODES], 300 + s)
             for s in range(12)]
    port_extra = [tw.conv(a) for a in extra]
    tw.ref.state.upsert_allocs(extra)
    tw.port.state.upsert_allocs(port_extra)


def _churn_new_node(tw):
    node = _node(tw.rng, N_NODES + 1)
    tw.nodes.append(node)
    tw.upsert_node(node)


#: each churn with the cache path it must take: a structure change is a
#: dirty-row delta build, alloc churn keeps the structure (a hit) and
#: moves only the usage planes
CHURNS = [(_churn_node_update, "delta"), (_churn_drain, "delta"),
          (_churn_allocs, "hit"), (_churn_new_node, "delta")]


@pytest.mark.parametrize("churn,path", CHURNS,
                         ids=["node_update", "drain", "alloc_churn",
                              "node_added"])
def test_incremental_cache_matches_fresh_build(twin, churn, path):
    caches = (ref_schema.IncrementalClusterCache(),
              port_schema.IncrementalClusterCache())
    before = [c.get(h.state.snapshot()) for c, h in zip(caches, twin.sides)]
    assert_cluster_equal(*before)
    churn(twin)
    rs, ps = twin.ref.state.snapshot(), twin.port.state.snapshot()
    rc, pc = caches[0].get(rs), caches[1].get(ps)
    assert caches[1].full_builds == caches[0].full_builds == 1
    assert caches[1].delta_builds == caches[0].delta_builds == int(
        path == "delta")
    assert caches[1].hits == caches[0].hits == int(path == "hit")
    fresh = port_schema.ClusterTensors.build(ps.nodes())
    assert_cluster_equal(fresh, pc)
    assert_cluster_equal(rc, pc)
    assert_usage_equal(rc, rs, pc, ps)
    # the same snapshot structure is one object for every caller
    assert caches[1].get(ps) is pc


def test_structs_from_reference_keeps_sharing():
    """A reference object graph becomes the port's dataclasses field for
    field, and an object reached twice (an alloc's job, a node held in a
    list and a dict) stays one object in the copy, across calls that
    share the memo."""
    from nomad_tpu_torch import structs as port_structs
    from nomad_tpu_torch.convert import structs_from_reference

    job = mock.job()
    allocs = [mock.alloc(job=job, job_id=job.id) for _ in range(3)]
    node = mock.node()
    memo = {}
    got = structs_from_reference({"allocs": allocs, "nodes": [node],
                                  "by_id": {node.id: node}}, memo)
    got_job = structs_from_reference(job, memo)
    assert type(got_job) is port_structs.Job
    assert all(type(a) is port_structs.Allocation for a in got["allocs"])
    assert all(a.job is got_job for a in got["allocs"])
    assert got["nodes"][0] is got["by_id"][node.id]
    assert type(got["nodes"][0].node_resources) is port_structs.NodeResources
    assert got_job.task_groups[0].tasks[0].resources.cpu == (
        job.task_groups[0].tasks[0].resources.cpu)
    assert [a.name for a in got["allocs"]] == [a.name for a in allocs]
    # the port's class computes what the reference's does
    assert got["nodes"][0].compute_class() == node.compute_class()
