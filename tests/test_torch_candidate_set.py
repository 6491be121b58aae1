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


#: every union at each of STEPS, then ``churn``: the kitchen sink's member
#: at K=64 whose step penalties hit candidate rows at every step and change
#: from step to step, its pins repeating candidates and each other
#: (``tp.candidate_churn_case``)
REFERENCE_CASES = [(v, n, k) for v, n in tp.CANDIDATE_VARIANTS
                   for k in STEPS] + [("churn", 383, 64)]


@pytest.mark.parametrize("variant,n_nodes,k", REFERENCE_CASES,
                         ids=[f"{v}-{k}" for v, _, k in REFERENCE_CASES])
def test_candidate_eval_matches_reference(variant, n_nodes, k):
    if variant == "churn":
        kin, feats = tp.candidate_churn_case(66, n_nodes, k)
    else:
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


@pytest.mark.parametrize("variant,n_nodes", tp.CANDIDATE_VARIANTS,
                         ids=[v for v, _ in tp.CANDIDATE_VARIANTS])
def test_rows_outside_the_rescoring_set_keep_their_scores(variant, n_nodes):
    """The fact csrc/candidate_set.cu's cached rows rest on, through the
    port's own ``_feasible``, ``_score`` and ``_deduct``: after one
    placement, a node that is neither the one placed on nor a penalty node
    of step 0 or step 1 keeps a bit-identical masked score; and each
    node's score at a step is its score without or with the penalty (the
    two keys a head caches), as the node is a penalty node or not."""
    kin, feats = tp.candidate_churn_case(67, n_nodes, 4, variant, lib="port")
    f = tp.port_features(feats)
    kin = kernel_in_from_numpy(kin, device="cpu")
    n = kin.cap_cpu.shape[-1]
    ids = torch.arange(n)

    def masked(st, pen_ids):
        feasible, act, _ = tk._feasible(kin, st, f)
        pen = kin.penalty | torch.any(ids[:, None] == pen_ids.long(), dim=-1)
        final = tk._score(kin, st, act, pen, f)
        return torch.where(feasible, final, tk.NEG_INF), act

    def bits(x):
        return x.contiguous().view(torch.int32)

    st0 = tk._carry_init(kin, f)
    m0, act0 = masked(st0, kin.step_penalty[0])
    x = int(tk._argmax_first(m0))
    assert m0[x] > tk.NEG_INF / 2
    one = (ids == x).to(torch.float32)
    st1 = tk._deduct(kin, st0, one, one.to(torch.int32), act0, f, None)
    m1, _ = masked(st1, kin.step_penalty[1])
    rescored = torch.zeros(n, dtype=torch.bool)
    rescored[x] = True
    for step in (0, 1):
        pen = kin.step_penalty[step].long()
        rescored[pen[pen >= 0]] = True
    assert rescored.sum() < n
    assert torch.equal(bits(m1[~rescored]), bits(m0[~rescored]))
    assert not torch.equal(bits(m1[x:x + 1]), bits(m0[x:x + 1]))
    # without and with the penalty: the keys of a head at step 1
    none = torch.full_like(kin.step_penalty[1], -1)
    m1_off, _ = masked(st1, none)
    m1_on, _ = masked(st1, ids[:, None].to(torch.int32))
    pen1 = torch.any(ids[:, None] == kin.step_penalty[1].long(), dim=-1)
    assert torch.equal(bits(m1), bits(torch.where(pen1, m1_on, m1_off)))


@pytest.mark.parametrize("variant,k", [("kitchen_sink", 16),
                                       ("no_spread", 3), ("lean", 1)])
def test_packed_outputs_read_back_as_the_torch_op_route(variant, k):
    """``ck.candidate_views`` lays a call's outputs in one buffer and
    ``ck.candidate_readback`` reads them in one copy: the plain version's
    outputs written through those views read back as ``_read_single``
    reads the plain tensors through torch ops, dtypes and shapes too; it
    refuses tensors that are not views of one such buffer."""
    kin, feats = tp.candidate_member(58, variant, 383, k, lib="port")
    want, want_ok = tk.place_taskgroup_topk(
        kernel_in_from_numpy(kin, device="cpu"), k, feats)
    lay = ck.candidate_layout(k)
    buf = torch.full((lay.scratch,), 0xA5, dtype=torch.uint8)
    out, ok = ck.candidate_views(buf, k)
    for dst, src in zip(out, want):
        dst.copy_(src)
    ok.copy_(want_ok)
    with pytest.raises(ValueError):
        ck.candidate_readback(want, want_ok, k)
    got = ck.candidate_readback(out, ok, k)
    for host in (got, tk._read_single(out, ok, k)):
        (g, g_ok), (w, w_ok) = host, tk._read_single(want, want_ok, k)
        assert g_ok == w_ok
        for name in tk.KernelOut._fields:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(b, int):
                assert type(a) is int and a == b, name
            else:
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a, b, err_msg=name)
