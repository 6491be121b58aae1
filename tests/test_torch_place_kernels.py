"""The port's per-eval placement and its batch kernels against JAX, on the CPU.

Same numpy inputs through ``nomad_tpu``'s ``place_taskgroup``,
``place_taskgroup_topk``, ``pallas_place_batch`` and
``pallas_topk_place_batch`` (Pallas in ``interpret=True``) and through
``nomad_tpu_torch``'s counterparts on ``device="cpu"``, where the
wrappers run their plain versions. Tolerances: ``chosen``, ``found``,
``valid``, top-k indices and i32 metrics exact; scores rtol 1e-5 / atol
1e-6 (the tolerance of tests/test_pallas_kernel.py: XLA and torch round
``pow`` and division in their own ways).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.ops import kernel as rk
from nomad_tpu.ops.pallas_kernel import (
    pallas_place_batch,
    pallas_topk_place_batch,
)
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import build
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk

RTOL, ATOL = 1e-5, 1e-6
EXACT = ("chosen", "found", "topk_idx", "nodes_evaluated", "nodes_feasible",
         "exhausted_cpu", "exhausted_mem", "exhausted_disk",
         "exhausted_ports", "exhausted_devices", "exhausted_cores")
ALL_VARIANTS = tp.FUSED_VARIANTS + tp.COMPOSITE_VARIANTS
TOPK_VARIANTS = tuple(v for v in ALL_VARIANTS if v[0] != "spread")


def _assert_out(port, ref, ctx):
    for name in rk.KernelOut._fields:
        got, want = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {ctx}")
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {ctx}")


@pytest.mark.parametrize("variant,n_nodes", ALL_VARIANTS,
                         ids=[v for v, _ in ALL_VARIANTS])
def test_place_taskgroup_matches_reference(variant, n_nodes):
    kins, feats = tp.wave_members(11, variant, n_nodes, b=2, k=6)
    for m, kin in enumerate(kins):
        ref = rk.place_taskgroup_jit(kin, 6, feats)
        port = tk.place_taskgroup(kernel_in_from_numpy(kin, device="cpu"), 6,
                                  tp.port_features(feats))
        _assert_out(port, ref, f"{variant} member {m}")
        assert port.found.any()


@pytest.mark.parametrize("variant,n_nodes", TOPK_VARIANTS,
                         ids=[v for v, _ in TOPK_VARIANTS])
def test_place_taskgroup_topk_matches_reference(variant, n_nodes):
    kins, feats = tp.wave_members(12, variant, n_nodes, b=2, k=6)
    for m, kin in enumerate(kins):
        ref, ref_ok = rk.place_taskgroup_topk_jit(kin, 6, feats, 0)
        port, ok = tk.place_taskgroup_topk(
            kernel_in_from_numpy(kin, device="cpu"), 6,
            tp.port_features(feats))
        assert bool(ok) == bool(ref_ok), f"{variant} member {m}"
        _assert_out(port, ref, f"{variant} member {m}")


def test_place_taskgroup_topk_refuses_spreads():
    kins, feats = tp.wave_members(13, "spread", 200, b=1)
    with pytest.raises(ValueError, match="spread"):
        tk.place_taskgroup_topk(kernel_in_from_numpy(kins[0], device="cpu"),
                                tp.K, tp.port_features(feats))


def test_batched_form_refuses_other_features():
    kin, uc, um, ac, am, ns = tp.lean_case(0, "random")
    port = kernel_in_from_numpy(kin, device="cpu")._replace(
        ask_cpu=torch.from_numpy(ac), ask_mem=torch.from_numpy(am),
        n_steps=torch.from_numpy(ns))
    for f in (tk.FULL_FEATURES, tk.LEAN_FEATURES._replace(with_shuffle=True)):
        with pytest.raises(ValueError, match="one eval at a time"):
            tk.place_taskgroup(port, tp.LEAN_K, f)


@pytest.mark.parametrize("scenario", tp.LEAN_SCENARIOS)
@pytest.mark.parametrize("k_steps", (tp.LEAN_K, 10))
def test_place_batch_matches_pallas(scenario, k_steps):
    args = tp.lean_args(*tp.lean_case(1, scenario, k=k_steps))
    ref = pallas_place_batch(*map(jnp.asarray, args), k_steps=k_steps,
                             interpret=True)
    before = ck.place_batch_launches
    got = ck.place_batch(*tp.torch_args(args), k_steps=k_steps)
    assert ck.place_batch_launches == before, "CPU tensors never launch"
    np.testing.assert_array_equal(got.chosen.numpy(), np.asarray(ref.chosen))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               rtol=RTOL, atol=ATOL)
    assert got.found.any()
    if scenario == "one_per_node":     # in-kernel deduction: distinct nodes
        for row, fnd in zip(got.chosen.numpy(), got.found.numpy()):
            assert len(set(row[fnd].tolist())) == fnd.sum()


def _topk_matches_pallas(args, k_steps, k_cand):
    """B2 on the CPU against ``pallas_topk_place_batch(interpret=True)``
    and against its own plain version; returns the port's outputs."""
    ref = pallas_topk_place_batch(*map(jnp.asarray, args), k_steps=k_steps,
                                  k_cand=k_cand, interpret=True)
    before = ck.topk_place_batch_launches
    got = ck.topk_place_batch(*tp.torch_args(args), k_steps=k_steps,
                              k_cand=k_cand)
    assert ck.topk_place_batch_launches == before, "CPU tensors never launch"
    for name, g, r in zip(("chosen", "scores", "found", "valid"), got, ref):
        if name == "scores":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                       atol=ATOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=name)
    want = ck.topk_place_batch_reference(*tp.torch_args(args),
                                         k_steps=k_steps, k_cand=k_cand)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("scenario", tp.LEAN_SCENARIOS)
@pytest.mark.parametrize("k_steps,k_cand",
                         ((tp.LEAN_K, 64), (10, 8), (10, 128)))
def test_topk_place_batch_matches_pallas(scenario, k_steps, k_cand):
    args = tp.lean_args(*tp.lean_case(2, scenario, k=k_steps))
    assert args[0].shape[0] > k_cand     # a rest max beyond the candidates
    got = _topk_matches_pallas(args, k_steps, k_cand)
    if scenario == "one_per_node" and k_cand < k_steps:
        # 8 candidates cannot hold 10 one-per-node placements while the
        # rest of the cluster could: the bound breaks
        assert not got[3][:-1].any()


def _scan_order_scores(v):
    """Every (eval, node) scored in the scans' operation order."""
    a_cpu, a_mem, _, spread, denom, _ = ck._per_eval(v)
    aff_sum, extra = ck._lean_static(v["penalty"], v["aff_score"])
    return ck._lean_score(v["used_cpu"], v["used_mem"],
                          v["job_tg_count"].to(torch.float32),
                          v["cap_cpu"], v["cap_mem"], a_cpu, a_mem, spread,
                          denom, aff_sum, extra)


@pytest.mark.parametrize("k_cand", (8, 64))
def test_topk_pen_aff_pins_the_pass_order(k_cand):
    """A penalty and a non-zero affinity on every node: the pass's order
    and the scans' round apart on some nodes, and the candidates and rest
    max still give JAX's choices and ``valid`` exactly."""
    args = tp.lean_args(*tp.lean_case(40, "pen_aff", k=10))
    v = ck._lean_inputs(tp.torch_args(args), 10)
    passed = ck.pass_scores(v)
    feas = passed > tk.NEG_INF / 2
    assert feas.any()
    assert (passed != _scan_order_scores(v))[feas].any()
    got = _topk_matches_pallas(args, 10, k_cand)
    assert got[2].any()


def test_topk_tie_run_straddles_the_candidate_edge():
    """Three nodes score best, then twelve score alike: 8 candidates take
    the three and the five lowest-indexed of the run, and the rest max is
    the run's score (the 9th key, a tie with the 8th)."""
    best, run = tp.TIE_BEST, tp.TIE_RUN
    args = tp.lean_args(*tp.tie_straddle_case(41))
    v = ck._lean_inputs(tp.torch_args(args), 10)
    cand, rest = ck.candidate_pass(v, 8)
    passed = ck.pass_scores(v)
    for e in range(cand.shape[0]):
        assert sorted(cand[e, :3].tolist()) == best
        assert cand[e, 3:].tolist() == run[:5]
        assert rest[e] == passed[e, run[5]] == passed[e, run[4]]
    _topk_matches_pallas(args, 10, 8)


@pytest.mark.parametrize("scenario", ("random", "pen_aff"))
def test_topk_every_node_a_candidate(scenario):
    """N == k_cand == 128: every node is a candidate and the rest max is
    NEG_INF, so a breached bound never sends an eval back."""
    args = tp.lean_args(*tp.lean_case(42, scenario, k=10, nodes=100))
    v = ck._lean_inputs(tp.torch_args(args), 10)
    assert v["cap_cpu"].shape[0] == 128
    _, rest = ck.candidate_pass(v, 128)
    assert bool((rest == tk.NEG_INF).all())
    got = _topk_matches_pallas(args, 10, 128)
    assert got[3].all()


def test_topk_ordered_breaks_ties_by_index():
    x = torch.tensor([[1.0, 5.0, 3.0, 5.0, 3.0, 3.0, 0.0],
                      [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = tk.topk_ordered(x, 4)
    assert idx.tolist() == [[1, 3, 2, 4], [0, 1, 2, 3]]
    assert vals.tolist() == [[5.0, 5.0, 3.0, 3.0], [2.0] * 4]
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 4, (5, 50)).astype(np.float32))
    want = torch.sort(y, dim=-1, descending=True, stable=True)
    got = tk.topk_ordered(y, 9)
    assert torch.equal(got[0], want.values[:, :9])
    assert torch.equal(got[1], want.indices[:, :9])


def test_lean_wrappers_reject_bad_inputs():
    args = tp.torch_args(tp.lean_args(*tp.lean_case(3, "random")))
    for fn in (ck.place_batch, ck.topk_place_batch):
        bad = list(args)
        bad[0] = bad[0].double()
        with pytest.raises(ValueError, match="dtype"):
            fn(*bad, k_steps=tp.LEAN_K)
        bad = list(args)
        bad[3] = torch.stack([bad[3], bad[3]], dim=1)[:, 0]
        assert not bad[3].is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            fn(*bad, k_steps=tp.LEAN_K)
        with pytest.raises(ValueError, match="k_steps"):
            fn(*args, k_steps=129)
        with pytest.raises(ValueError, match="shape"):
            fn(*(args[:10] + [args[10][:3]] + args[11:]), k_steps=tp.LEAN_K)


def test_build_key_covers_included_headers(tmp_path):
    """A header edit gives a new build key, so no stale library loads
    (no nvcc runs here)."""
    src = tmp_path / "k.cu"
    src.write_text('#include "shared.cuh"\n#include <math.h>\n')
    keys = []
    for body in ("// one\n", "// two\n", "// one\n"):
        (tmp_path / "shared.cuh").write_text(body)
        keys.append(build.source_key(src))
    assert keys[0] != keys[1] and keys[0] == keys[2]
    src.write_text('#include "shared.cuh"\n// edited\n')
    assert build.source_key(src) != keys[0]
    for name in ("fused_wave", "place_batch", "topk_place_batch"):
        assert len(build.source_key(build.CSRC / f"{name}.cu")) == 16
