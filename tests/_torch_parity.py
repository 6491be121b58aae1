"""Shared inputs for the port-vs-reference tests (tests/test_torch_*.py).

Members are built the way tests/test_fused_kernel.py builds them:
``synthetic_cluster`` + ``synthetic_eval`` + ``build_kernel_in``, then
randomized from a numpy seed. ``lib="ref"`` builds them with the JAX
package (the parity tests); ``lib="port"`` with the port alone, for the
card-only tests that run where JAX is not installed. Continuous random used
planes keep scores away from exact ties, so a last-ulp difference in
``pow`` or division between XLA and torch cannot flip a placement.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import synthetic as tsyn

#: the planes here are a few hundred nodes wide, too small to gain from
#: intra-op threads; one thread keeps these tests from crowding the
#: suite's timing-sensitive tests that run beside them in other workers
torch.set_num_threads(1)

K = 4
B = 4

#: the fused envelope's lattice (tests/test_fused_kernel.py _VARIANTS),
#: each pinned to a node count in a different pad bucket
FUSED_VARIANTS = (
    ("lean", 60),
    ("shuffle", 200),
    ("penalty_preferred", 383),
    ("distinct", 60),
    ("ports", 200),
    ("kitchen_sink", 383),
)

#: composite-only variants: outside the fused envelope
COMPOSITE_VARIANTS = (
    ("spread", 200),
    ("devices", 60),
    ("cores", 200),
    ("network", 383),
)

#: the joint kernel's variants: each composite feature alone, then all
#: four with the kitchen sink's (ports, penalties, pins, distinct_hosts,
#: shuffle)
JOINT_VARIANTS = COMPOSITE_VARIANTS + (("everything", 383),)

#: the variants that carry the kitchen sink's planes
_SINK = ("kitchen_sink", "everything")


def _lib(lib):
    """(kernel module, synthetic module) of the reference or the port;
    the reference is imported only when asked for."""
    if lib == "ref":
        from nomad_tpu.ops import kernel
        from nomad_tpu.parallel import synthetic
        return kernel, synthetic
    return tk, tsyn


def variant_features(variant, lib="ref"):
    f = _lib(lib)[0].LEAN_FEATURES._replace(with_topk=True)
    if variant in ("shuffle", "penalty_preferred") + _SINK:
        f = f._replace(with_shuffle=True)
    if variant in ("penalty_preferred",) + _SINK:
        f = f._replace(with_step_penalties=True, with_preferred=True)
    if variant in ("distinct",) + _SINK:
        f = f._replace(with_distinct=True)
    if variant in ("ports",) + _SINK:
        f = f._replace(with_ports=True)
    if variant in ("spread", "everything"):
        f = f._replace(n_spreads=4, with_shuffle=True)
    if variant in ("devices", "everything"):
        f = f._replace(with_devices=True)
    if variant in ("cores", "everything"):
        f = f._replace(with_cores=True)
    if variant in ("network", "everything"):
        f = f._replace(with_network=True)
    return f


def port_features(f) -> tk.KernelFeatures:
    return tk.KernelFeatures(**f._asdict())


def wave_members(seed, variant, n_nodes, b=B, k=K, lib="ref", n_pad=None):
    """``b`` randomized member kins (numpy leaves) and the variant's
    features, built with ``lib``'s modules; ``n_pad`` overrides the
    power-of-two node axis."""
    kmod, smod = _lib(lib)
    rng = np.random.default_rng(seed * 1000 + n_nodes)
    cluster = smod.synthetic_cluster(
        n_nodes, cpu=3900.0, mem=7936.0, disk=98304.0,
        seed=int(rng.integers(0, 99)), n_pad=n_pad)
    n_pad = cluster.n_pad
    kp = kmod.pad_steps(k)
    kins = []
    for _ in range(b):
        ev = smod.synthetic_eval(cluster, desired_count=k,
                            with_spread=variant in ("spread", "everything"))
        if variant in ("spread", "everything"):
            sp = ev.spreads[0]
            sp.counts = rng.integers(0, 4, sp.counts.shape).astype(
                np.float32)
            if rng.random() < 0.5:
                sp.even = False
                sp.desired = rng.integers(1, 6, sp.desired.shape).astype(
                    np.float32)
        kwargs = {"node_perm": rng.permutation(n_pad).astype(np.int32)}
        if variant in ("penalty_preferred",) + _SINK:
            pen = np.full((kp, kmod.MAX_PENALTY_NODES), -1, np.int32)
            pen[0, 0] = rng.integers(0, n_nodes)
            pen[1, 0] = rng.integers(0, n_nodes)
            pref = np.full(kp, -1, np.int32)
            pref[int(rng.integers(0, k))] = rng.integers(0, n_nodes)
            kwargs.update(step_penalty=pen, step_preferred=pref)
        kin = kmod.build_kernel_in(cluster, ev, k, **kwargs)
        uc = (3900.0 * 0.6 * rng.random(n_pad)).astype(np.float32)
        um = (7936.0 * 0.6 * rng.random(n_pad)).astype(np.float32)
        kin = kin._replace(
            used_cpu=uc, used_mem=um,
            ask_cpu=np.float32(rng.choice([250, 500, 900])),
            ask_mem=np.float32(rng.choice([128, 256, 700])))
        if variant in ("ports",) + _SINK:
            kin = kin._replace(
                port_conflict=(rng.random(n_pad) < 0.3),
                ask_has_reserved_ports=np.asarray(True),
                ask_dyn_ports=np.asarray(2, np.int32))
        if variant in ("distinct",) + _SINK:
            kin = kin._replace(
                job_tg_count=rng.integers(0, 2, n_pad).astype(np.int32),
                job_any_count=rng.integers(0, 3, n_pad).astype(np.int32),
                distinct_hosts_job=np.asarray(variant in _SINK),
                distinct_hosts_tg=np.asarray(True))
        if variant in ("devices", "everything"):
            kin = kin._replace(
                dev_free=rng.integers(0, 3, (n_pad, 4)).astype(np.float32),
                ask_dev=np.asarray([1, 0, 1, 0], np.float32),
                has_dev_affinity=np.asarray(True),
                dev_aff_score=(rng.random(n_pad) * 0.5).astype(np.float32))
        if variant in ("cores", "everything"):
            kin = kin._replace(
                used_cores=rng.integers(0, 3, n_pad).astype(np.int32),
                ask_cores=np.asarray(1, np.int32),
                aff_score=np.where(rng.random(n_pad) < 0.2,
                                   rng.random(n_pad), 0.0).astype(
                                       np.float32))
        if variant in ("network", "everything"):
            kin = kin._replace(
                used_mbits=rng.integers(0, 900, n_pad).astype(np.int32),
                ask_mbits=np.asarray(100, np.int32),
                penalty=rng.random(n_pad) < 0.1)
        kins.append(kin)
    return kins, variant_features(variant, lib)


def stack_wave(kins, k=K):
    """All-stacked KernelIn (numpy, of the members' own type) + the step
    layout."""
    stacked = type(kins[0])(*[
        np.stack([np.asarray(getattr(x, f)) for x in kins])
        for f in kins[0]._fields])
    t_pad = tk.pad_steps(len(kins) * k)
    step_member = np.full(t_pad, -1, np.int32)
    step_local = np.zeros(t_pad, np.int32)
    for i in range(len(kins)):
        step_member[i * k:(i + 1) * k] = i
        step_local[i * k:(i + 1) * k] = np.arange(k)
    return stacked, step_member, step_local, t_pad


#: node axes (real nodes, padded width) that no cluster count's CTA ranges
#: divide evenly: N is not a multiple of C x 16 x 4, and with eight
#: clusters some CTAs hold no row at all
BOUNDARY_WIDTHS = ((997, 1000), (3000, 3001))
#: the cluster counts the boundary waves are laid out for
BOUNDARY_CLUSTERS = (1, 2, 4, 8)


def boundary_wave(clusters, n_nodes, n_pad, lib="ref", seed=60):
    """The everything wave over ``n_pad`` nodes laid out for ``clusters``
    clusters of 16 CTAs (the joint kernel's ranges of ceil(N / (16 C))
    nodes): every member's pin and penalty nodes in the last range that
    holds real nodes, and stanza 0's buckets runs of nodes that straddle
    the ranges' edges. ``(kins, features)``."""
    kins, feats = wave_members(seed, "everything", n_nodes, lib=lib,
                               n_pad=n_pad)
    chunk = -(-n_pad // (clusters * 16))
    tail = np.arange(((n_nodes - 1) // chunk) * chunk, n_nodes)
    run = chunk // 2 + 3
    nodes = np.arange(n_pad)
    bucket = np.where(nodes < n_nodes, (nodes // run) % 128, -1)
    out = []
    for i, kin in enumerate(kins):
        pen = np.full_like(np.asarray(kin.step_penalty), -1)
        pen[0, 0] = tail[0]
        pen[1, 0] = tail[-1]
        pen[2, :2] = tail[-2:]
        pref = np.full_like(np.asarray(kin.step_preferred), -1)
        pref[i % K] = tail[-1]
        sb = np.array(kin.spread_bucket)
        sb[0] = bucket
        out.append(kin._replace(step_penalty=pen, step_preferred=pref,
                                spread_bucket=sb.astype(np.int32)))
    return out, feats


#: waves built around what the fused kernel's incremental design leans
#: on: a member's cached score row must see the members before it, a step
#: penalty or a pin must override the cached value, tied scores must keep
#: their order across the cluster's node ranges
FUSED_CASES = ("filled_by_previous", "penalty_on_best", "pin_on_loaded",
               "ties_across_ranges", "no_feasible_member")

_CASE_VARIANT = {"filled_by_previous": "shuffle",
                 "penalty_on_best": "penalty_preferred",
                 "pin_on_loaded": "penalty_preferred",
                 "ties_across_ranges": "shuffle",
                 "no_feasible_member": "kitchen_sink"}

ASK_CPU, ASK_MEM = 250.0, 128.0


def _room(kin, nodes, slots):
    """Load ``nodes`` in the member's used planes so that exactly
    ``slots`` more allocations of the case's ask fit there."""
    uc, um = np.array(kin.used_cpu), np.array(kin.used_mem)
    uc[nodes] = kin.cap_cpu[nodes] - slots * ASK_CPU
    um[nodes] = kin.cap_mem[nodes] - slots * ASK_MEM
    return kin._replace(used_cpu=uc, used_mem=um)


def fused_case(case, lib="ref", n_nodes=200, n_pad=None):
    """``(kins, features, x)``: a wave of ``B`` members x ``K`` steps
    (member i at steps i*K..i*K+K-1) built for ``case``; ``x`` is the
    node the case turns on. Every member asks ASK_CPU/ASK_MEM, and step
    penalties and pins are cleared except where the case sets them."""
    kins, feats = wave_members(11, _CASE_VARIANT[case], n_nodes, lib=lib,
                               n_pad=n_pad)
    kp = kins[0].step_preferred.shape[0]
    x = n_nodes // 3
    kins = [k._replace(ask_cpu=np.float32(ASK_CPU),
                       ask_mem=np.float32(ASK_MEM),
                       step_penalty=np.full_like(k.step_penalty, -1),
                       step_preferred=np.full(kp, -1, np.int32))
            for k in kins]
    if case == "filled_by_previous":
        # x scores 1.0 for every member and takes one allocation
        kins = [_room(k, [x], 1) for k in kins]
    elif case == "penalty_on_best":
        # member 1's best is x; its steps 0 and 1 penalise x. Member 2's
        # best is x + 7; its step 1 penalises the node step 0 chose
        pen1 = np.array(kins[1].step_penalty)
        pen1[0, 0] = pen1[1, 0] = x
        pen2 = np.array(kins[2].step_penalty)
        pen2[1, 0] = x + 7
        kins[1] = _room(kins[1], [x], 2)._replace(step_penalty=pen1)
        kins[2] = _room(kins[2], [x + 7], 3)._replace(step_penalty=pen2)
    elif case == "pin_on_loaded":
        # x is the best of members 0 and 1 and takes three allocations:
        # member 0 places there at step 0 and is pinned there at step 2,
        # member 1 fills it at step 0 and is pinned onto it, full, at 2
        kins = [_room(k, [x], 3) for k in kins]
        for i in (0, 1):
            pref = np.full(kp, -1, np.int32)
            pref[2] = x
            kins[i] = kins[i]._replace(step_preferred=pref)
    elif case == "ties_across_ranges":
        # equal top scores on both sides of every N/16 boundary
        n = kins[0].cap_cpu.shape[-1]
        edge = np.arange(n // 16, n, n // 16)
        tied = np.concatenate([edge - 1, edge])
        kins = [_room(k, tied, 3) for k in kins]
        x = int(n // 16)
    elif case == "no_feasible_member":
        kins[1] = kins[1]._replace(ask_cpu=np.float32(1e6))
    return kins, feats, x


def check_case(case, x, chosen, found, topk_idx, nodes_feasible, k=K):
    """Assert that a wave's outputs (numpy, from either implementation)
    show the situation ``case`` was built for."""
    step = lambda m, j: m * k + j                       # noqa: E731
    if case == "filled_by_previous":
        assert chosen[step(0, 0)] == x
        assert x not in chosen[step(0, 1):step(B, 0)]
        assert x not in topk_idx[step(1, 0)]
    elif case == "penalty_on_best":
        assert chosen[step(1, 0)] != x and chosen[step(1, 1)] != x
        assert chosen[step(1, 2)] == x
        assert chosen[step(2, 0)] == x + 7 != chosen[step(2, 1)]
    elif case == "pin_on_loaded":
        assert chosen[step(0, 0)] == x and chosen[step(0, 2)] == x
        assert chosen[step(0, 1)] != x
        assert chosen[step(1, 0)] == x and chosen[step(1, 2)] != x
    elif case == "ties_across_ranges":
        n16 = x
        want = [n16 - 1, n16, 2 * n16 - 1, 2 * n16, 3 * n16 - 1, 3 * n16,
                4 * n16 - 1, 4 * n16]
        np.testing.assert_array_equal(topk_idx[step(0, 0)], want)
        assert found[:step(B, 0)].all()
    elif case == "no_feasible_member":
        assert not found[step(1, 0):step(2, 0)].any()
        assert nodes_feasible[1] == 0
        assert found[step(0, 0):step(1, 0)].all()


#: waves built around what the joint kernel's design leans on: a bump
#: that moves the even-spread min (every node's boost changes), a
#: desired-count stanza, nodes with no bucket, a step penalty and a pin
#: on a spread wave, a per-node cpu total under a core ask, a device ask
#: that exhausts nodes
JOINT_CASES = ("even_min_moves", "desired_counts", "missing_buckets",
               "spread_penalty_pin", "cores_total", "devices_exhausted")

_JOINT_CASE_VARIANT = {"even_min_moves": "spread",
                       "desired_counts": "spread",
                       "missing_buckets": "spread",
                       "spread_penalty_pin": "spread",
                       "cores_total": "cores",
                       "devices_exhausted": "devices"}


def joint_case(case, lib="ref", n_nodes=200, n_pad=None):
    """``(kins, features, info)``: a wave of ``B`` members x ``K`` steps
    built for ``case``; ``info`` holds what ``check_joint_case`` reads
    (the nodes the case turns on). Every member asks ASK_CPU/ASK_MEM."""
    kins, feats = wave_members(12, _JOINT_CASE_VARIANT[case], n_nodes,
                               lib=lib, n_pad=n_pad)
    kins = [k._replace(ask_cpu=np.float32(ASK_CPU),
                       ask_mem=np.float32(ASK_MEM)) for k in kins]
    rng = np.random.default_rng(77)
    real = np.arange(n_nodes)
    info = {}
    if feats.n_spreads:
        bucket = np.array(kins[0].spread_bucket)
        racks = np.unique(bucket[0][bucket[0] >= 0])
        info["bucket"] = bucket[0]

        def stanza(k, counts, even=True, desired=None):
            c = np.zeros_like(k.spread_counts)
            c[0] = counts
            d = np.full_like(k.spread_desired, -1.0)
            if desired is not None:
                d[0] = desired
            ev = np.array(k.spread_even)
            ev[0] = even
            return k._replace(spread_counts=c, spread_desired=d,
                              spread_even=ev)

    if case == "even_min_moves":
        # r0 the one least-filled bucket, r1 the fullest: r0's first
        # placement moves the min, and with it every bucket's boost
        counts = np.zeros(kins[0].spread_counts.shape[-1], np.float32)
        counts[racks] = 2.0
        counts[racks[0]], counts[racks[1]] = 1.0, 3.0
        kins = [stanza(k, counts) for k in kins]
        info["r0"] = int(racks[0])
    elif case == "desired_counts":
        # r0 wants 10 and holds none; every other bucket is at its 1
        counts = np.zeros(kins[0].spread_counts.shape[-1], np.float32)
        counts[racks] = 1.0
        counts[racks[0]] = 0.0
        desired = np.ones_like(counts)
        desired[racks[0]] = 10.0
        kins = [stanza(k, counts, even=False, desired=desired)
                for k in kins]
        info["r0"] = int(racks[0])
    elif case == "missing_buckets":
        counts = np.zeros(kins[0].spread_counts.shape[-1], np.float32)
        gone = rng.choice(real, n_nodes * 3 // 10, replace=False)
        bucket = np.array(kins[0].spread_bucket)
        bucket[0][gone] = -1
        kins = [stanza(k, counts)._replace(spread_bucket=bucket)
                for k in kins]
        info["bucket"] = bucket[0]
    elif case == "spread_penalty_pin":
        # x is every member's best; member 0's step 0 penalises it and
        # its step 2 is pinned on it
        feats = feats._replace(with_step_penalties=True,
                               with_preferred=True)
        counts = np.zeros(kins[0].spread_counts.shape[-1], np.float32)
        x = int(real[n_nodes // 3:][info["bucket"][n_nodes // 3:n_nodes]
                                    >= 0][0])
        kp = kins[0].step_preferred.shape[0]
        kins = [_room(stanza(k, counts), [x], 3)._replace(
            step_penalty=np.full_like(k.step_penalty, -1),
            step_preferred=np.full(kp, -1, np.int32)) for k in kins]
        pen = np.array(kins[0].step_penalty)
        pen[0, 0] = x
        pref = np.full(kp, -1, np.int32)
        pref[2] = x
        kins[0] = kins[0]._replace(step_penalty=pen, step_preferred=pref)
        info["x"] = x
    elif case == "cores_total":
        # a core of 500 or 1000 MHz; 900 MHz free everywhere: the cpu
        # ask plus one core fits only where a core is 500
        spc = np.array(kins[0].shares_per_core)
        spc[real] = np.where(real % 2 == 0, 500.0, 1000.0)
        kins = [k._replace(
            shares_per_core=spc, used_cores=np.zeros_like(k.used_cores),
            used_cpu=np.where(np.arange(len(spc)) < n_nodes,
                              k.cap_cpu - 900.0, 0.0).astype(np.float32))
            for k in kins]
        info["spc"] = spc
    elif case == "devices_exhausted":
        # one instance of each asked device on 40 nodes, none elsewhere:
        # each of those takes one placement, then is exhausted
        held = np.zeros(kins[0].dev_free.shape, np.float32)
        hosts = rng.choice(real, 40, replace=False)
        held[hosts, 0] = held[hosts, 2] = 1.0
        kins = [k._replace(dev_free=held) for k in kins]
        info["hosts"] = np.sort(hosts)
    return kins, feats, info


def check_joint_case(case, info, chosen, found, topk_idx, metrics, k=K):
    """Assert that a wave's outputs (numpy, from either implementation;
    ``metrics`` by FUSED_METRIC_FIELDS name) show the situation ``case``
    was built for."""
    step = lambda m, j: m * k + j                       # noqa: E731
    first = chosen[:step(1, 0)]
    if case == "even_min_moves":
        assert info["bucket"][chosen[step(0, 0)]] == info["r0"]
    elif case == "desired_counts":
        assert (info["bucket"][first] == info["r0"]).all()
    elif case == "missing_buckets":
        assert found[:step(1, 0)].all()
        assert (info["bucket"][first] >= 0).all()
        assert (info["bucket"][topk_idx[step(0, 0)]] >= 0).all()
    elif case == "spread_penalty_pin":
        assert chosen[step(0, 0)] != info["x"]
        assert chosen[step(0, 2)] == info["x"]
    elif case == "cores_total":
        placed = chosen[found]
        assert len(placed) == B * k
        assert (info["spc"][placed] == 500.0).all()
        n_big = int((info["spc"] == 1000.0).sum())
        assert (metrics["exhausted_cpu"] == n_big).all()
        assert (metrics["exhausted_cores"] == 0).all()
    elif case == "devices_exhausted":
        placed = chosen[found]
        assert len(placed) == B * k == len(set(placed.tolist()))
        assert set(placed.tolist()) <= set(info["hosts"].tolist())
        assert (metrics["exhausted_devices"]
                == metrics["nodes_evaluated"] - len(info["hosts"])).all()


#: score tolerance: XLA-CPU and torch round ``pow`` and division in
#: their own ways, a few ulps of values in [-2, 1]
SCORE_ATOL = 1e-5


@pytest.fixture
def cuda_device():
    """The card, decided inside the fixture (never at collection, so
    every xdist worker collects the same tests); skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available")
    return torch.device("cuda")


#: the batched-path inputs of tests/test_pallas_kernel.py: 200 nodes
#: (N=256), batches of 8 evals, 5 placements each
LEAN_NODES = 200
LEAN_B = 8
LEAN_K = 5

#: lean-batch scenarios: ``random`` used planes (0-50%), ``tied`` zero
#: usage (every node scores alike: pins the tie order), ``planes``
#: penalty/affinity/job-count planes with the spread fit,
#: ``one_per_node`` zero usage and 1200 MHz asks (a node takes one),
#: ``pen_aff`` random usage with a penalty and a non-zero affinity on
#: every node (the full-width pass adds them one at a time, the scans as
#: one precomputed sum: the two orders round apart)
LEAN_SCENARIOS = ("random", "tied", "planes", "one_per_node", "pen_aff")


def lean_case(seed, scenario, b=LEAN_B, k=LEAN_K, t=None, lib="ref",
              nodes=LEAN_NODES):
    """``(kin, used_cpu, used_mem, ask_cpu, ask_mem, n_steps)``, numpy,
    for one lean batch (asks [b], or [t, b] with ``t``) over ``nodes``
    nodes."""
    kmod, smod = _lib(lib)
    rng = np.random.default_rng(seed)
    cluster = smod.synthetic_cluster(nodes, cpu=2000.0, mem=4096.0,
                                     disk=50000.0, seed=3)
    kin = kmod.build_kernel_in(
        cluster, smod.synthetic_eval(cluster, desired_count=k), k)
    n, npad = nodes, cluster.n_pad
    uc = np.zeros(npad, np.float32)
    um = np.zeros(npad, np.float32)
    if scenario in ("random", "planes", "pen_aff"):
        uc[:n] = 2000.0 * 0.5 * rng.random(n, dtype=np.float32)
        um[:n] = 4096.0 * 0.5 * rng.random(n, dtype=np.float32)
    if scenario == "pen_aff":
        aff = rng.uniform(0.05, 1.0, npad) * rng.choice([-1.0, 1.0], npad)
        kin = kin._replace(penalty=np.ones(npad, bool),
                           aff_score=aff.astype(np.float32))
    if scenario == "planes":
        aff = np.where(rng.random(npad) < 0.2, rng.uniform(-0.5, 1.0, npad),
                       0.0).astype(np.float32)
        kin = kin._replace(
            penalty=rng.random(npad) < 0.1, aff_score=aff,
            job_tg_count=rng.integers(0, 3, npad).astype(np.int32),
            algorithm_spread=np.asarray(True),
            desired_count=np.asarray(3, np.int32))
    shape = (b,) if t is None else (t, b)
    if scenario == "one_per_node":
        ac = np.full(shape, 1200.0, np.float32)
        am = np.full(shape, 64.0, np.float32)
    else:
        ac = rng.choice([100.0, 250.0, 500.0], shape).astype(np.float32)
        am = rng.choice([64.0, 128.0, 256.0], shape).astype(np.float32)
    ns = np.full(b, k, np.int32)
    ns[-1] = k // 2             # inactive steps past n_steps
    return kin, uc, um, ac, am, ns


#: the tie-straddle case: three nodes score best, then a run of twelve
#: scores alike, so 8 candidates end inside the run
TIE_BEST = [3, 50, 77]
TIE_RUN = [5, 9, 20, 21, 40, 60, 61, 90, 100, 130, 150, 199]


def tie_straddle_case(seed, k=10, lib="ref"):
    """``lean_case``'s random batch with TIE_BEST at 70% usage and TIE_RUN
    at 60% (binpack prefers the fuller nodes)."""
    kin, uc, um, ac, am, ns = lean_case(seed, "random", k=k, lib=lib)
    uc[TIE_BEST], um[TIE_BEST] = 0.7 * 2000.0, 0.7 * 4096.0
    uc[TIE_RUN], um[TIE_RUN] = 0.6 * 2000.0, 0.6 * 4096.0
    return kin, uc, um, ac, am, ns


def lean_args(kin, uc, um, ac, am, ns):
    """The 16 lean arguments in ``pallas_place_batch`` order (numpy)."""
    return [np.asarray(x) for x in (
        kin.cap_cpu, kin.cap_mem, kin.cap_disk, uc, um, kin.used_disk,
        kin.base_mask, kin.job_tg_count, kin.penalty, kin.aff_score,
        ac, am, kin.ask_disk, ns, kin.desired_count,
        kin.algorithm_spread)]


def torch_args(args, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in args]


def sched_round(harness, jobs, device, seed=0):
    """One coalesced scheduling round on the port alone: ``jobs`` are
    registered, one eval each is created, and one thread per eval runs
    ``new_scheduler`` against one snapshot with a
    ``LaunchCoalescer(len(jobs), adaptive=False)`` as its launcher and one
    ``ClusterCache``; plans commit through ``harness``. Returns
    ``(evals, coalescer, errors)``."""
    import threading

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel.coalesce import ClusterCache, LaunchCoalescer
    from nomad_tpu_torch.scheduler import new_scheduler

    evals = []
    for job in jobs:
        harness.state.upsert_job(job)
        evals.append(mock.eval(job_id=job.id, namespace=job.namespace,
                               type=job.type, priority=job.priority))
    harness.state.upsert_evals(evals)
    snap = harness.state.snapshot()
    clusters = ClusterCache(device)
    co = LaunchCoalescer(len(jobs), device=device, adaptive=False)
    errors = []

    def run(job, ev):
        try:
            new_scheduler(job.type, snap, harness, device=device,
                          kernel_launch=co.launch,
                          cluster_provider=clusters.get).process(ev)
        except Exception as e:      # noqa: BLE001 - asserted by the caller
            errors.append(repr(e))
        finally:
            co.done()

    threads = [threading.Thread(target=run, args=(j, e))
               for j, e in zip(jobs, evals)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads), "round hung"
    return evals, co, errors


def over_capacity_nodes(state) -> int:
    """Nodes whose committed cpu, memory or disk exceeds their capacity
    net of the agent's reserve, read from the store's usage planes."""
    from nomad_tpu_torch.tensors.schema import ClusterTensors

    snap = state.snapshot()
    c = ClusterTensors.build(snap.nodes())
    used = c.gathered_usage(snap.usage)
    over = np.zeros(c.n_pad, bool)
    for plane, cap in zip(used[:3], (c.cap_cpu, c.cap_mem, c.cap_disk)):
        over |= plane > cap + 1e-3
    return int(over.sum())
