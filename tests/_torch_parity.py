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
    if variant in ("shuffle", "penalty_preferred", "kitchen_sink"):
        f = f._replace(with_shuffle=True)
    if variant in ("penalty_preferred", "kitchen_sink"):
        f = f._replace(with_step_penalties=True, with_preferred=True)
    if variant in ("distinct", "kitchen_sink"):
        f = f._replace(with_distinct=True)
    if variant in ("ports", "kitchen_sink"):
        f = f._replace(with_ports=True)
    if variant == "spread":
        f = f._replace(n_spreads=4, with_shuffle=True)
    if variant == "devices":
        f = f._replace(with_devices=True)
    if variant == "cores":
        f = f._replace(with_cores=True)
    if variant == "network":
        f = f._replace(with_network=True)
    return f


def port_features(f) -> tk.KernelFeatures:
    return tk.KernelFeatures(**f._asdict())


def wave_members(seed, variant, n_nodes, b=B, k=K, lib="ref"):
    """``b`` randomized member kins (numpy leaves) and the variant's
    features, built with ``lib``'s modules."""
    kmod, smod = _lib(lib)
    rng = np.random.default_rng(seed * 1000 + n_nodes)
    cluster = smod.synthetic_cluster(
        n_nodes, cpu=3900.0, mem=7936.0, disk=98304.0,
        seed=int(rng.integers(0, 99)))
    n_pad = cluster.n_pad
    kp = kmod.pad_steps(k)
    kins = []
    for _ in range(b):
        ev = smod.synthetic_eval(cluster, desired_count=k,
                            with_spread=variant == "spread")
        if variant == "spread":
            sp = ev.spreads[0]
            sp.counts = rng.integers(0, 4, sp.counts.shape).astype(
                np.float32)
            if rng.random() < 0.5:
                sp.even = False
                sp.desired = rng.integers(1, 6, sp.desired.shape).astype(
                    np.float32)
        kwargs = {"node_perm": rng.permutation(n_pad).astype(np.int32)}
        if variant in ("penalty_preferred", "kitchen_sink"):
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
        if variant in ("ports", "kitchen_sink"):
            kin = kin._replace(
                port_conflict=(rng.random(n_pad) < 0.3),
                ask_has_reserved_ports=np.asarray(True),
                ask_dyn_ports=np.asarray(2, np.int32))
        if variant in ("distinct", "kitchen_sink"):
            kin = kin._replace(
                job_tg_count=rng.integers(0, 2, n_pad).astype(np.int32),
                job_any_count=rng.integers(0, 3, n_pad).astype(np.int32),
                distinct_hosts_job=np.asarray(variant == "kitchen_sink"),
                distinct_hosts_tg=np.asarray(True))
        if variant == "devices":
            kin = kin._replace(
                dev_free=rng.integers(0, 3, (n_pad, 4)).astype(np.float32),
                ask_dev=np.asarray([1, 0, 1, 0], np.float32),
                has_dev_affinity=np.asarray(True),
                dev_aff_score=(rng.random(n_pad) * 0.5).astype(np.float32))
        if variant == "cores":
            kin = kin._replace(
                used_cores=rng.integers(0, 3, n_pad).astype(np.int32),
                ask_cores=np.asarray(1, np.int32),
                aff_score=np.where(rng.random(n_pad) < 0.2,
                                   rng.random(n_pad), 0.0).astype(
                                       np.float32))
        if variant == "network":
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
