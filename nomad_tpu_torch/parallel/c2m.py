"""The C2M replay cluster, built through the port's own state store.

The port's copy of ``bench/c2m.py``'s generator (modelled on the
reference's real-cluster replay bench,
scheduler/benchmarks/benchmarks_test.go:16-24): 10,000 heterogeneous
nodes (standard / large / compute / gpu classes over 10 datacenters and
64 racks) and 100,000 live allocations of a service/batch job mix,
placed feasibly by a capacity-checked deduction. The node classes, job
shapes, shares and seed are the same; ``generate`` returns the
``StateStore`` instead of persisting a snapshot.

``burst_job`` draws the jobs of a scheduling burst from the mix's lean
kinds (no spreads, no devices), each placing ``BURST_COUNT`` allocations
over all ten datacenters.
"""

from __future__ import annotations

import numpy as np

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs import consts

N_NODES = 10_000
N_ALLOCS = 100_000
SEED = 20260730

NODE_CLASSES = (
    # (name, share, cpu_shares, cores, mem_mb, disk_mb, gpus)
    ("standard", 0.60, 4_000, 4, 8_192, 100 * 1024, 0),
    ("large", 0.25, 16_000, 16, 32_768, 200 * 1024, 0),
    ("compute", 0.10, 32_000, 32, 65_536, 400 * 1024, 0),
    ("gpu", 0.05, 16_000, 16, 65_536, 400 * 1024, 4),
)

# (share, cpu, mem, count_range, kind)
JOB_SHAPES = (
    (0.35, 250, 128, (5, 20), "service"),
    (0.25, 500, 256, (5, 30), "service"),
    (0.15, 1_000, 1_024, (3, 15), "service-spread"),
    (0.15, 500, 512, (10, 60), "batch"),
    (0.07, 2_000, 4_096, (2, 8), "service-distinct"),
    (0.03, 4_000, 8_192, (1, 4), "gpu"),
)

#: the lean kinds of the mix: no spread stanza, no device ask
LEAN_SHAPES = tuple(s for s in JOB_SHAPES
                    if s[4] in ("service", "batch", "service-distinct"))
BURST_COUNT = 10


def _make_node(rng, i: int, cls) -> structs.Node:
    name, _share, cpu, cores, mem, disk, gpus = cls
    dc = f"dc{int(rng.integers(1, 11))}"
    rack = f"r{int(rng.integers(0, 64))}"
    n = mock.node(
        name=f"c2m-{name}-{i}",
        datacenter=dc,
        node_class=name,
    )
    n.attributes = dict(n.attributes)
    n.attributes["platform.aws.placement.rack"] = rack
    n.attributes["cpu.numcores"] = str(cores)
    n.node_resources = structs.NodeResources(
        cpu=structs.NodeCpuResources(
            cpu_shares=cpu, total_core_count=cores,
            reservable_cpu_cores=list(range(cores)),
        ),
        memory=structs.NodeMemoryResources(memory_mb=mem),
        disk=structs.NodeDiskResources(disk_mb=disk),
        networks=[structs.NetworkResource(
            device="eth0", cidr=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}/32",
            ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}", mbits=10_000,
        )],
    )
    if gpus:
        n.node_resources.devices = [structs.NodeDeviceResource(
            vendor="nvidia", type="gpu", name="A100",
            instance_ids=[f"gpu-{i}-{g}" for g in range(gpus)],
        )]
    n.compute_class()
    return n


def _make_job(rng, i: int, shape) -> structs.Job:
    _share, cpu, mem, count_range, kind = shape
    count = int(rng.integers(count_range[0], count_range[1] + 1))
    job = mock.simple_job(id=f"c2m-{kind}-{i}")
    job.datacenters = [f"dc{d}" for d in range(1, 11)]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources = structs.Resources(cpu=cpu, memory_mb=mem)
    if kind == "batch":
        job.type = consts.JOB_TYPE_BATCH
        job.priority = int(rng.integers(20, 60))
    elif kind == "service-spread":
        attr = ("${node.datacenter}" if rng.random() < 0.5
                else "${attr.platform.aws.placement.rack}")
        tg.spreads = [structs.Spread(attribute=attr, weight=50)]
    elif kind == "service-distinct":
        tg.constraints = list(tg.constraints) + [
            structs.Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS)]
    elif kind == "gpu":
        job.constraints = list(job.constraints) + [structs.Constraint(
            ltarget="${node.class}", rtarget="gpu", operand="=")]
        tg.tasks[0].resources.devices = [
            structs.RequestedDevice(name="nvidia/gpu", count=1)]
    return job


def burst_job(rng, i: int, prefix: str = "burst") -> structs.Job:
    """One job of a scheduling burst: a lean kind of the mix drawn by its
    renormalised share, ``BURST_COUNT`` allocations, datacenters
    dc1-dc10."""
    shares = np.array([s[0] for s in LEAN_SHAPES])
    shape = LEAN_SHAPES[int(rng.choice(len(LEAN_SHAPES),
                                       p=shares / shares.sum()))]
    job = _make_job(rng, i, shape)
    job.id = f"{prefix}-{shape[4]}-{i}"
    job.task_groups[0].count = BURST_COUNT
    return job


def generate(n_nodes: int = N_NODES, n_allocs: int = N_ALLOCS,
             seed: int = SEED) -> StateStore:
    """Build the replay cluster into a new ``StateStore``."""
    rng = np.random.default_rng(seed)
    store = StateStore()

    # -- nodes ----------------------------------------------------------
    shares = np.array([c[1] for c in NODE_CLASSES])
    cls_idx = rng.choice(len(NODE_CLASSES), n_nodes, p=shares / shares.sum())
    nodes = [_make_node(rng, i, NODE_CLASSES[cls_idx[i]])
             for i in range(n_nodes)]
    for n in nodes:
        store.upsert_node(n)

    # free capacity tracker for feasible alloc placement
    free_cpu = np.array([n.node_resources.cpu.cpu_shares
                         - n.reserved_resources.cpu_shares
                         for n in nodes], np.float64)
    free_mem = np.array([n.node_resources.memory.memory_mb
                         - n.reserved_resources.memory_mb
                         for n in nodes], np.float64)
    gpu_free = np.array([sum(len(d.instance_ids)
                             for d in n.node_resources.devices)
                         for n in nodes], np.float64)

    # -- jobs + allocations --------------------------------------------
    jshares = np.array([s[0] for s in JOB_SHAPES])
    allocs = []
    ji = 0
    no_fit_streak = 0
    while len(allocs) < n_allocs:
        shape = JOB_SHAPES[int(rng.choice(len(JOB_SHAPES),
                                          p=jshares / jshares.sum()))]
        job = _make_job(rng, ji, shape)
        ji += 1
        tg = job.task_groups[0]
        cpu = float(tg.tasks[0].resources.cpu)
        mem = float(tg.tasks[0].resources.memory_mb)
        needs_gpu = bool(tg.tasks[0].resources.devices)
        fits = (free_cpu >= cpu) & (free_mem >= mem)
        if needs_gpu:
            fits &= gpu_free >= 1
        rows = np.nonzero(fits)[0]
        if rows.size == 0:
            # cluster saturated for this shape; if NO shape has fit for
            # a while, stop at whatever count the capacity allowed
            no_fit_streak += 1
            if no_fit_streak >= 10 * len(JOB_SHAPES):
                break
            continue
        no_fit_streak = 0
        take = min(tg.count, rows.size, n_allocs - len(allocs))
        # binpack-flavoured placement: prefer fuller nodes with noise so
        # utilization spreads instead of packing rank 0 (distinct_hosts
        # holds: ``rows`` are unique)
        util = 1.0 - free_cpu[rows] / np.maximum(free_cpu[rows].max(), 1.0)
        pick = rows[np.argsort(-(util + rng.random(rows.size)))[:take]]
        job.status = consts.JOB_STATUS_RUNNING
        store.upsert_job(job)
        for slot, row in enumerate(pick):
            node = nodes[row]
            free_cpu[row] -= cpu
            free_mem[row] -= mem
            tr = structs.AllocatedTaskResources(
                cpu=structs.AllocatedCpuResources(cpu_shares=int(cpu)),
                memory=structs.AllocatedMemoryResources(memory_mb=int(mem)),
            )
            if needs_gpu:
                gpu_free[row] -= 1
                dev = node.node_resources.devices[0]
                tr.devices = [structs.AllocatedDeviceResource(
                    vendor="nvidia", type="gpu", name=dev.name,
                    device_ids=[dev.instance_ids[int(gpu_free[row])]],
                )]
            allocs.append(structs.Allocation(
                id=f"c2m-a-{len(allocs)}",
                eval_id=f"c2m-e-{ji}",
                node_id=node.id,
                namespace=job.namespace,
                job_id=job.id,
                job=job,
                task_group=tg.name,
                name=f"{job.id}.{tg.name}[{slot}]",
                desired_status=consts.ALLOC_DESIRED_RUN,
                client_status=consts.ALLOC_CLIENT_RUNNING,
                allocated_resources=structs.AllocatedResources(
                    tasks={tg.tasks[0].name: tr},
                    shared=structs.AllocatedSharedResources(
                        disk_mb=tg.ephemeral_disk.size_mb),
                ),
            ))
    bulk = 5_000
    for i in range(0, len(allocs), bulk):
        store.upsert_allocs(allocs[i:i + bulk])
    return store
