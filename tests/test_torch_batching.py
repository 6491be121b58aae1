"""The port's batched schedule-apply path against JAX, on the CPU.

The same numpy inputs (those of tests/test_pallas_kernel.py: 200 nodes,
batches of 8 evals, 5 placements) go through ``nomad_tpu.parallel.batching``
(Pallas in ``interpret=True``) and ``nomad_tpu_torch.parallel.batching``
on ``device="cpu"``. Tolerances: ``chosen``, ``found``, ``placed`` and the
fallback count exact; scores, score sums and committed planes rtol 1e-5 /
atol 1e-6 (tests/test_pallas_kernel.py's; the scatter-add order and
``pow`` rounding differ between XLA and torch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.ops.kernel import LEAN_FEATURES as REF_LEAN
from nomad_tpu.ops.pallas_kernel import make_schedule_apply_step_pallas
from nomad_tpu.parallel import batching as rb
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops.kernel import FULL_FEATURES, LEAN_FEATURES
from nomad_tpu_torch.parallel import batching as tb

RTOL, ATOL = 1e-5, 1e-6
T = 3          # batches per loop call

#: (port backend, topk) -> the JAX loop's (backend, topk)
LOOPS = {("torch", False): ("xla", False), ("torch", True): ("xla", True),
         ("kernel_topk", True): ("pallas_topk", True)}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _both(kin):
    return rb.device_put_shared(kin), tb.device_put_shared(kin, "cpu")


@pytest.mark.parametrize("scenario", tp.LEAN_SCENARIOS)
def test_schedule_apply_step_matches_reference(scenario):
    kin, uc, um, ac, am, ns = tp.lean_case(4, scenario)
    ref_shared, shared = _both(kin)
    ref = rb.make_schedule_apply_step(tp.LEAN_K, REF_LEAN)(
        ref_shared, jnp.asarray(uc), jnp.asarray(um), jnp.asarray(ac),
        jnp.asarray(am), jnp.asarray(ns))
    uct, umt = torch.from_numpy(uc), torch.from_numpy(um)
    got = tb.make_schedule_apply_step(tp.LEAN_K, LEAN_FEATURES)(
        shared, uct, umt, torch.from_numpy(ac), torch.from_numpy(am),
        torch.from_numpy(ns))
    for name in ("chosen", "found", "nodes_evaluated", "nodes_feasible",
                 "exhausted_cpu", "exhausted_mem", "exhausted_disk"):
        np.testing.assert_array_equal(getattr(got[0], name).numpy(),
                                      np.asarray(getattr(ref[0], name)),
                                      err_msg=name)
    _close(got[0].scores, ref[0].scores, "scores")
    _close(got[1], ref[1], "used_cpu")
    _close(got[2], ref[2], "used_mem")
    # the caller's planes are never written
    assert np.array_equal(uct.numpy(), uc) and np.array_equal(umt.numpy(), um)


@pytest.mark.parametrize("scenario", tp.LEAN_SCENARIOS)
def test_kernel_step_matches_pallas_step(scenario):
    kin, uc, um, ac, am, ns = tp.lean_case(5, scenario)
    ref_shared, shared = _both(kin)
    ref = make_schedule_apply_step_pallas(tp.LEAN_K, interpret=True)(
        ref_shared, jnp.asarray(uc), jnp.asarray(um), jnp.asarray(ac),
        jnp.asarray(am), jnp.asarray(ns))
    got = tb.make_schedule_apply_step_kernel(tp.LEAN_K)(
        shared, torch.from_numpy(uc), torch.from_numpy(um),
        torch.from_numpy(ac), torch.from_numpy(am), torch.from_numpy(ns))
    np.testing.assert_array_equal(got[0].chosen.numpy(),
                                  np.asarray(ref[0].chosen))
    np.testing.assert_array_equal(got[0].found.numpy(),
                                  np.asarray(ref[0].found))
    _close(got[0].scores, ref[0].scores, "scores")
    _close(got[1], ref[1], "used_cpu")
    _close(got[2], ref[2], "used_mem")


def _loops(kin, uc, um, ac, am, ns, k, backend, topk, reset):
    ref_backend, ref_topk = LOOPS[(backend, topk)]
    ref_shared, shared = _both(kin)
    ref = rb.make_schedule_apply_loop(
        k, REF_LEAN, topk=ref_topk, backend=ref_backend, interpret=True,
        reset_every=reset)(ref_shared, jnp.asarray(uc), jnp.asarray(um),
                           jnp.asarray(ac), jnp.asarray(am), jnp.asarray(ns))
    got = tb.make_schedule_apply_loop(
        k, LEAN_FEATURES, topk=topk, backend=backend, reset_every=reset)(
        shared, torch.from_numpy(uc), torch.from_numpy(um),
        torch.from_numpy(ac), torch.from_numpy(am), torch.from_numpy(ns))
    return ref, got


def _assert_loop(ref, got, ctx):
    assert int(got[1]) == int(ref[1]), f"placed {ctx}"
    assert int(got[2]) == int(ref[2]), f"fallback {ctx}"
    _close(float(got[0]), float(ref[0]), f"score_sum {ctx}")
    _close(got[3], ref[3], f"used_cpu {ctx}")
    _close(got[4], ref[4], f"used_mem {ctx}")


@pytest.mark.parametrize("reset", (0, 1))
@pytest.mark.parametrize("backend,topk", list(LOOPS),
                         ids=[f"{b}-topk{int(k)}" for b, k in LOOPS])
@pytest.mark.parametrize("scenario", ("random", "tied", "planes"))
def test_schedule_apply_loop_matches_reference(scenario, backend, topk,
                                               reset):
    case = tp.lean_case(6, scenario, t=T)
    before = ck.cand_scan_launches
    ref, got = _loops(*case, tp.LEAN_K, backend, topk, reset)
    assert ck.cand_scan_launches == before, "CPU tensors never launch"
    assert int(got[1]) > 0
    _assert_loop(ref, got, f"{scenario} {backend} topk={topk} reset={reset}")


@pytest.mark.parametrize("backend,topk", (("torch", True),
                                          ("kernel_topk", True)))
def test_loop_fallback_fires_on_breached_bounds(backend, topk):
    """96 one-per-node placements per eval: the kernel route's 64
    candidates run out while the rest of the cluster could still place,
    so its evals fall back to the full-width composite inside the loop;
    the totals stay those of JAX's loop."""
    k = 96
    case = tp.lean_case(7, "one_per_node", k=k, t=2)
    ref, got = _loops(*case, k, backend, topk, 0)
    _assert_loop(ref, got, backend)
    if backend == "kernel_topk":
        assert int(got[2]) > 0, "no eval fell back"


def test_loop_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        tb.make_schedule_apply_loop(tp.LEAN_K, LEAN_FEATURES,
                                    backend="pallas_topk")


@pytest.mark.parametrize("features,topk", ((FULL_FEATURES, True),
                                           (LEAN_FEATURES, False)),
                         ids=("full-features", "no-topk"))
def test_kernel_topk_loop_rejects_other_score_functions(features, topk):
    """The kernel scores the lean envelope over candidates; its breached
    rows fall back with the caller's features, so any other set would
    score primary and fallback rows by different functions."""
    with pytest.raises(ValueError, match="kernel_topk"):
        tb.make_schedule_apply_loop(tp.LEAN_K, features, topk=topk,
                                    backend="kernel_topk")


@pytest.mark.parametrize("reset", (0, 1))
def test_device_apply_loop_matches_reference(reset):
    kin, uc, um, ac, am, ns = tp.lean_case(8, "random", t=T)
    rng = np.random.default_rng(8)
    npad = uc.shape[0]
    dev_free = np.zeros((npad, 4), np.float32)
    dev_free[:tp.LEAN_NODES, 0] = rng.integers(0, 4, tp.LEAN_NODES)
    kin = kin._replace(dev_aff_score=(rng.random(npad) * 0.5).astype(
        np.float32), has_dev_affinity=np.asarray(True))
    gpu = rng.integers(1, 3, ac.shape).astype(np.float32)
    ref_shared, shared = _both(kin)
    ref = rb.make_device_apply_loop(tp.LEAN_K, reset_every=reset)(
        ref_shared, *map(jnp.asarray, (uc, um, dev_free, ac, am, gpu, ns)))
    got = tb.make_device_apply_loop(tp.LEAN_K, reset_every=reset)(
        shared, *map(torch.from_numpy, (uc, um, dev_free, ac, am, gpu, ns)))
    assert int(got[1]) == int(ref[1]) > 0
    _close(float(got[0]), float(ref[0]), "score_sum")
    for i, name in ((2, "used_cpu"), (3, "used_mem"), (4, "dev_free")):
        _close(got[i], ref[i], name)


@pytest.mark.parametrize("reset", (0, 1))
def test_preemption_apply_loop_matches_reference(reset):
    kin, uc, um, ac, am, ns = tp.lean_case(9, "random", t=T)
    rng = np.random.default_rng(9)
    npad, n = uc.shape[0], tp.LEAN_NODES
    # a crowded cluster: few nodes fit an ask, so normal fits run out
    # and preemption takes over
    uc[:n] = 2000.0 * rng.uniform(0.975, 1.0, n).astype(np.float32)
    uc[:2] = 1000.0
    pre_cpu = np.zeros(npad, np.float32)
    pre_mem = np.zeros(npad, np.float32)
    pre_cpu[:n] = np.where(rng.random(n) < 0.5, 600.0, 0.0)
    pre_mem[:n] = np.where(pre_cpu[:n] > 0, 256.0, 0.0)
    pre_score = (rng.random(npad) * 0.5).astype(np.float32)
    args = (uc, um, pre_cpu, pre_mem, pre_score, ac, am, ns)
    ref_shared, shared = _both(kin)
    ref = rb.make_preemption_apply_loop(tp.LEAN_K, reset_every=reset)(
        ref_shared, *map(jnp.asarray, args))
    got = tb.make_preemption_apply_loop(tp.LEAN_K, reset_every=reset)(
        shared, *map(torch.from_numpy, args))
    assert int(got[1]) == int(ref[1]) > 0
    assert int(got[2]) == int(ref[2]) > 0, "no preemption exercised"
    _close(float(got[0]), float(ref[0]), "score_sum")
    _close(got[3], ref[3], "used_cpu")
    _close(got[4], ref[4], "used_mem")
