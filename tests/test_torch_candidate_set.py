"""The single eval's candidate set against JAX, on the CPU.

Same numpy inputs through ``nomad_tpu``'s ``place_taskgroup_topk_jit``
and through ``nomad_tpu_torch``'s ``ops/cuda_kernel.candidate_eval_place``
on ``device="cpu"``, where the wrapper runs its plain version,
``ops/kernel.place_taskgroup_topk``, and launches nothing. Tolerances:
``chosen``, ``found``, ``topk_idx``, the metrics and ``valid`` exact;
scores and top-k scores rtol 1e-5 / atol 1e-6 (XLA and torch round
``pow`` and division in their own ways). The kernel itself is held to the
plain version bit for bit on the card (tests/test_torch_gpu.py -k
candidate).
"""

import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.ops import kernel as rk
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk

RTOL, ATOL = 1e-5, 1e-6
EXACT = ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS
STEPS = (1, 4, 12, 40)


def _check(kin, k, feats, n_candidates=0):
    """The wrapper on CPU tensors against the JAX reference on the same
    numpy planes; returns ``(out, valid)``."""
    ref, ref_ok = rk.place_taskgroup_topk_jit(kin, k, feats, n_candidates)
    before = ck.candidate_launches
    got, ok = ck.candidate_eval_place(kernel_in_from_numpy(kin, device="cpu"),
                                      k, tp.port_features(feats),
                                      n_candidates)
    assert ck.candidate_launches == before, "CPU tensors never launch"
    assert bool(ok) == bool(ref_ok)
    for name in tk.KernelOut._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    return got, bool(ok)


@pytest.mark.parametrize("k", STEPS)
@pytest.mark.parametrize("variant,n_nodes", tp.CANDIDATE_VARIANTS,
                         ids=[v for v, _ in tp.CANDIDATE_VARIANTS])
def test_candidate_eval_matches_reference(variant, n_nodes, k):
    kin, feats = tp.candidate_member(60, variant, n_nodes, k)
    got, ok = _check(kin, k, feats)
    assert ok and got.found.any()


def test_every_node_a_candidate():
    """N=20, K=12: k_cand == N, so the rest max is NEG_INF."""
    kin, feats = tp.candidate_member(61, "shuffle", 20, 12, n_pad=20)
    assert min(20, max(2 * 12, 12 + 8, tk.TOPK)) == 20
    got, ok = _check(kin, 12, feats)
    assert ok and got.found.all()


def test_steps_past_n_steps_place_nothing():
    """16 steps, 10 active (the live bucket of 10 placements): the rest
    place nothing and list the first candidate rows at NEG_INF."""
    kin, feats = tp.candidate_member(65, "kitchen_sink", 383, 16)
    got, ok = _check(kin._replace(n_steps=np.asarray(10, np.int32)), 16,
                     feats)
    assert ok and got.found[:10].all() and not got.found[10:].any()


def test_pins_repeat_candidates_under_shuffle():
    kin, feats, k = tp.candidate_pinned_case()
    pins = np.asarray(kin.step_preferred)[:k]
    got, ok = _check(kin, k, feats)
    assert ok and got.found.all()
    # a pin is taken where it is still feasible (distinct_hosts refuses
    # one already placed on): some are, each a node of the candidate set
    assert (got.chosen.numpy()[pins >= 0] == pins[pins >= 0]).any()


@pytest.mark.parametrize("case", ("missing", "bound"))
def test_valid_false(case):
    """Both of ``valid``'s conditions, reached with few candidates: a
    placement missing while the rest could take it, and a found placement
    below the rest max."""
    make = {"missing": tp.candidate_missing_case,
            "bound": tp.candidate_bound_case}[case]
    kin, feats, k, n_candidates = make()
    got, ok = _check(kin, k, feats, n_candidates)
    assert not ok
    found = got.found.numpy()
    assert found.all() == (case == "bound")


def test_default_candidates_are_the_live_rule():
    """``n_candidates=0`` is today's candidate set: the plain version
    called without it, bit for bit."""
    kin, feats = tp.candidate_member(62, "kitchen_sink", 383, 12, lib="port")
    one = kernel_in_from_numpy(kin, device="cpu")
    got, ok = ck.candidate_eval_place(one, 12, feats)
    want, want_ok = tk.place_taskgroup_topk(one, 12, feats)
    assert bool(ok) == bool(want_ok)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    kin, feats = tp.candidate_member(63, "lean", 60, 4, lib="port")
    one = kernel_in_from_numpy(kin, device="cpu")
    with pytest.raises(ValueError, match="one eval"):
        ck.candidate_eval_place(
            one._replace(n_steps=torch.tensor([4, 4], dtype=torch.int32)),
            4, feats)
    with pytest.raises(ValueError, match="spread"):
        ck.candidate_eval_place(one, 4, feats._replace(n_spreads=4))


def test_default_kernel_launch_places_through_the_candidate_set():
    """The slice on the CPU: ``default_kernel_launch`` of a lean eval runs
    the candidate set (its wrapper's plain route, no launch), whose answer
    is the JAX reference's, read back as host arrays."""
    kin, feats = tp.candidate_member(64, "shuffle", 200, 12)
    pf = tk.canonical_features(tp.port_features(feats))
    ref, ref_ok = rk.place_taskgroup_topk_jit(
        kin, 12, rk.canonical_features(feats), 0)
    assert bool(ref_ok)
    tk.single_eval_stats.reset()
    before = (ck.candidate_launches, ck.joint_launches)
    got = tk.default_kernel_launch(kin, 12, pf, device="cpu")
    assert (ck.candidate_launches, ck.joint_launches) == before
    assert tk.single_eval_stats.snapshot() == {"topk": 1, "breaches": 0,
                                               "full": 0}
    for name in tk.KernelOut._fields:
        g, w = getattr(got, name), np.asarray(getattr(ref, name))
        assert not isinstance(g, torch.Tensor), name
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
