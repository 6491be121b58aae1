"""Synthetic placement problems for tests, the chip smoke and entry points.

Counterpart of ``nomad_tpu/parallel/synthetic.py`` (mock-node clusters of
4000 MHz / 8192 MB and 500 MHz / 256 MB service asks, after the
reference benchmark grid scheduler/benchmarks/benchmarks_test.go:71-124),
plus the C2M-shaped heterogeneous cluster and resident-alloc packing of
``bench/trace_report.py`` (``_MESH_NODE_CLASSES``, ``_mesh_cluster``,
``_mesh_pack_allocs``). Everything here is numpy made from a seed.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from nomad_tpu_torch.ops.kernel import KernelIn, build_kernel_in
from nomad_tpu_torch.tensors.schema import (
    MAX_DEV_REQS,
    PORT_WORDS,
    SPREAD_BUCKETS,
    AskTensor,
    ClusterTensors,
    EvalTensors,
    SpreadTensor,
    pad_bucket,
)


def synthetic_cluster(
    n_nodes: int,
    cpu: float = 4000.0,
    mem: float = 8192.0,
    disk: float = 100 * 1024.0,
    seed: int = 0,
    n_pad: Optional[int] = None,
    n_racks: int = 50,
) -> ClusterTensors:
    """Uniform node planes without the structs round-trip. ``n_pad``
    overrides the power-of-two bucket."""
    rng = np.random.default_rng(seed)
    npad = n_pad if n_pad is not None else pad_bucket(n_nodes)
    if npad < n_nodes:
        raise ValueError(f"n_pad {npad} < n_nodes {n_nodes}")
    ready = np.zeros(npad, bool)
    ready[:n_nodes] = True
    cap_cpu = np.zeros(npad, np.float32)
    cap_mem = np.zeros(npad, np.float32)
    cap_disk = np.zeros(npad, np.float32)
    cap_cpu[:n_nodes] = cpu
    cap_mem[:n_nodes] = mem
    cap_disk[:n_nodes] = disk
    free_cores = np.zeros(npad, np.int32)
    free_cores[:n_nodes] = 4
    spc = np.zeros(npad, np.float32)
    spc[:n_nodes] = cpu / 4.0
    free_dyn = np.zeros(npad, np.int32)
    free_dyn[:n_nodes] = 12001
    ids = [f"node-{i:06d}" for i in range(n_nodes)]
    racks = rng.integers(0, n_racks, size=n_nodes)
    return ClusterTensors(
        n_real=n_nodes,
        n_pad=npad,
        node_ids=ids,
        index={nid: i for i, nid in enumerate(ids)},
        cap_cpu=cap_cpu,
        cap_mem=cap_mem,
        cap_disk=cap_disk,
        ready=ready,
        port_words=np.zeros((npad, PORT_WORDS), np.uint32),
        free_dyn=free_dyn,
        free_cores=free_cores,
        shares_per_core=spc,
        datacenters=[f"dc{r % 3}" for r in racks],
        node_classes=[""] * n_nodes,
        computed_classes=[f"rack-{r}" for r in racks],
        node_pools=["default"] * n_nodes,
    )


def synthetic_eval(
    cluster: ClusterTensors,
    ask_cpu: float = 500.0,
    ask_mem: float = 256.0,
    ask_disk: float = 150.0,
    desired_count: int = 10,
    with_spread: bool = False,
    used_frac: float = 0.0,
    seed: int = 0,
) -> EvalTensors:
    """One task group's eval planes over ``cluster``. ``used_frac``
    pre-loads utilization; ``with_spread`` adds one even-spread stanza
    over the rack attribute."""
    rng = np.random.default_rng(seed + 1)
    n = cluster.n_pad
    ask = AskTensor(
        cpu=ask_cpu, mem=ask_mem, disk=ask_disk, cores=0, n_dyn_ports=0,
        reserved_ports=[], port_mask=np.zeros(PORT_WORDS, np.uint32),
        n_dev_reqs=0, dev_counts=np.zeros(MAX_DEV_REQS, np.int32),
        total_mbits=0,
    )
    used_cpu = np.zeros(n, np.float32)
    used_mem = np.zeros(n, np.float32)
    if used_frac > 0.0:
        used_cpu[: cluster.n_real] = (
            cluster.cap_cpu[: cluster.n_real]
            * rng.uniform(0, used_frac, cluster.n_real)
        ).astype(np.float32)
        used_mem[: cluster.n_real] = (
            cluster.cap_mem[: cluster.n_real]
            * rng.uniform(0, used_frac, cluster.n_real)
        ).astype(np.float32)

    spreads: List[SpreadTensor] = []
    if with_spread:
        bucket_id = np.full(n, -1, np.int32)
        for i in range(cluster.n_real):
            rack = int(cluster.computed_classes[i].split("-")[1])
            bucket_id[i] = rack % SPREAD_BUCKETS
        spreads.append(SpreadTensor(
            bucket_id=bucket_id,
            counts=np.zeros(SPREAD_BUCKETS, np.float32),
            desired=np.full(SPREAD_BUCKETS, -1.0, np.float32),
            weight_frac=1.0,
            even=True,
        ))

    return EvalTensors(
        base_mask=cluster.ready.copy(),
        used_cpu=used_cpu,
        used_mem=used_mem,
        used_disk=np.zeros(n, np.float32),
        used_mbits=np.zeros(n, np.int32),
        avail_mbits=np.full(n, 1000, np.int32),
        used_cores=np.zeros(n, np.int32),
        port_conflict_words=np.zeros((n, PORT_WORDS), np.uint32),
        free_dyn_delta=np.zeros(n, np.int32),
        dev_free=np.zeros((n, MAX_DEV_REQS), np.float32),
        dev_aff_score=np.zeros(n, np.float32),
        has_dev_affinity=False,
        job_tg_count=np.zeros(n, np.int32),
        job_any_count=np.zeros(n, np.int32),
        distinct_hosts_job=False,
        distinct_hosts_tg=False,
        penalty=np.zeros(n, bool),
        aff_score=np.zeros(n, np.float32),
        has_affinities=False,
        spreads=spreads,
        ask=ask,
        desired_count=desired_count,
        algorithm="binpack",
    )


def synthetic_kernel_in(
    n_nodes: int = 300,
    n_steps: int = 16,
    with_spread: bool = False,
    used_frac: float = 0.5,
    seed: int = 0,
    n_pad: Optional[int] = None,
) -> KernelIn:
    cluster = synthetic_cluster(n_nodes, seed=seed, n_pad=n_pad)
    ev = synthetic_eval(
        cluster, with_spread=with_spread, used_frac=used_frac, seed=seed)
    return build_kernel_in(cluster, ev, n_steps)


#: C2M heterogeneous node classes (share, cpu MHz, cores, mem MB, disk
#: MB): 60% 4-core/8 GB, 25% 16/32, 10% 32/64, 5% 16/64. Copied from
#: bench/trace_report.py ``_MESH_NODE_CLASSES`` (the bench/c2m.py mix).
C2M_NODE_CLASSES = (
    (0.60, 4_000.0, 4, 8_192.0, 100 * 1024.0),
    (0.25, 16_000.0, 16, 32_768.0, 200 * 1024.0),
    (0.10, 32_000.0, 32, 65_536.0, 400 * 1024.0),
    (0.05, 16_000.0, 16, 65_536.0, 400 * 1024.0),
)

#: the bench/c2m.py JOB_SHAPES cpu/mem mix of resident allocs
C2M_SHAPE_CPU = np.array([250, 500, 1000, 500, 2000, 4000], np.float32)
C2M_SHAPE_MEM = np.array([128, 256, 1024, 512, 4096, 8192], np.float32)
C2M_SHAPE_P = np.array([0.35, 0.25, 0.15, 0.15, 0.07, 0.03])


def c2m_cluster(n_nodes: int, seed: int = 0) -> ClusterTensors:
    """A heterogeneous C2M-shaped ClusterTensors, built vectorized.

    Source: ``bench/trace_report.py`` ``_mesh_cluster`` (the mesh cell's
    100k-node C2M replay) over ``C2M_NODE_CLASSES``. The port-word plane
    is allocated zeroed and stays untouched unless an ask reserves
    ports."""
    rng = np.random.default_rng(seed)
    npad = pad_bucket(n_nodes)
    shares = np.array([c[0] for c in C2M_NODE_CLASSES])
    cls = rng.choice(len(C2M_NODE_CLASSES), size=n_nodes,
                     p=shares / shares.sum())
    cpu = np.array([c[1] for c in C2M_NODE_CLASSES])[cls]
    cores = np.array([c[2] for c in C2M_NODE_CLASSES])[cls]
    mem = np.array([c[3] for c in C2M_NODE_CLASSES])[cls]
    disk = np.array([c[4] for c in C2M_NODE_CLASSES])[cls]

    def plane(vals, dtype):
        out = np.zeros(npad, dtype)
        out[:n_nodes] = vals
        return out

    ready = np.zeros(npad, bool)
    ready[:n_nodes] = True
    ids = [f"c2m-node-{i:06d}" for i in range(n_nodes)]
    racks = rng.integers(0, 64, size=n_nodes)
    return ClusterTensors(
        n_real=n_nodes, n_pad=npad, node_ids=ids,
        index={nid: i for i, nid in enumerate(ids)},
        cap_cpu=plane(cpu, np.float32),
        cap_mem=plane(mem, np.float32),
        cap_disk=plane(disk, np.float32),
        ready=ready,
        port_words=np.zeros((npad, PORT_WORDS), np.uint32),
        free_dyn=plane(np.full(n_nodes, 12001), np.int32),
        free_cores=plane(cores, np.int32),
        shares_per_core=plane(cpu / np.maximum(cores, 1), np.float32),
        datacenters=[f"dc{r % 10}" for r in racks],
        node_classes=[""] * n_nodes,
        computed_classes=[f"rack-{r}" for r in racks],
        node_pools=["default"] * n_nodes,
        avail_mbits=plane(np.full(n_nodes, 1000), np.int32),
    )


def c2m_pack_usage(cluster: ClusterTensors, n_allocs: int,
                   seed: int = 0) -> tuple:
    """``n_allocs`` C2M-shaped resident allocations as used planes.

    Source: ``bench/trace_report.py`` ``_mesh_pack_allocs``: allocs land
    capacity-weighted over the heterogeneous nodes with the bench/c2m.py
    JOB_SHAPES cpu/mem mix and 150 MB disk each, and cpu/mem are clipped
    at 90% of each node's capacity. Returns ``(used_cpu, used_mem,
    used_disk, clipped)``: f32[n_pad] planes and the number of nodes
    the clip touched (reported, not hidden)."""
    rng = np.random.default_rng(seed + 1)
    n = cluster.n_real
    used_cpu = np.zeros(cluster.n_pad, np.float32)
    used_mem = np.zeros(cluster.n_pad, np.float32)
    used_disk = np.zeros(cluster.n_pad, np.float32)
    cap_cpu = cluster.cap_cpu[:n].astype(np.float64)
    picks = rng.choice(n, size=n_allocs, p=cap_cpu / cap_cpu.sum())
    shapes = rng.choice(len(C2M_SHAPE_CPU), size=n_allocs,
                        p=C2M_SHAPE_P / C2M_SHAPE_P.sum())
    np.add.at(used_cpu, picks, C2M_SHAPE_CPU[shapes])
    np.add.at(used_mem, picks, C2M_SHAPE_MEM[shapes])
    np.add.at(used_disk, picks, np.float32(150.0))
    clip_cpu = cluster.cap_cpu[:n] * 0.9
    clip_mem = cluster.cap_mem[:n] * 0.9
    clipped = int(np.sum((used_cpu[:n] > clip_cpu)
                         | (used_mem[:n] > clip_mem)))
    np.minimum(used_cpu[:n], clip_cpu, out=used_cpu[:n])
    np.minimum(used_mem[:n], clip_mem, out=used_mem[:n])
    return used_cpu, used_mem, used_disk, clipped
