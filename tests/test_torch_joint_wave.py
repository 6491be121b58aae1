"""The joint kernel's routes against the JAX reference, on the CPU.

``ops/cuda_kernel.joint_wave_place`` (csrc/joint_wave.cu on the card) on
CPU tensors is its plain version, the composite packed as a fused wave;
it is held against the reference's ``place_taskgroups_joint_jit`` on
every feature union and on waves built around what the kernel's spread
design leans on. The single eval's full-width route
(``ops/kernel._place_full``, one launch of the kernel on the card) is
held against the reference's ``place_taskgroup_jit``. Choices, found,
top-k indices and i32 metrics match exactly; scores and carries within
``SCORE_ATOL``. The kernel itself runs against the same plain versions
in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.ops.kernel import (
    build_kernel_in as ref_build_kernel_in,
    place_taskgroup_jit,
    place_taskgroups_joint_jit,
)
from nomad_tpu.parallel import synthetic as ref_synthetic
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import coalesce as pc

CPU = torch.device("cpu")


def _wave(kins, feats):
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    ref = place_taskgroups_joint_jit(
        stacked, jnp.asarray(sm), jnp.asarray(sl), t_pad, feats)
    launches = ck.joint_launches
    got = ck.joint_wave_place(
        kernel_in_from_numpy(stacked, device="cpu"), torch.from_numpy(sm),
        torch.from_numpy(sl), t_pad, tp.port_features(feats))
    assert ck.joint_launches == launches, "CPU tensors never launch it"
    host = tk.unpack_fused_wave(got.packed.numpy(), t_pad, len(kins))
    for name in ("chosen", "found") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(host[name], np.asarray(getattr(
            ref, name)).astype(host[name].dtype), err_msg=name)
    np.testing.assert_allclose(host["scores"], np.asarray(ref.scores),
                               rtol=0, atol=tp.SCORE_ATOL)
    np.testing.assert_array_equal(got.topk_idx.numpy(),
                                  np.asarray(ref.topk_idx))
    for name in ("topk_scores", "a_cpu", "a_mem", "a_disk"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=0, atol=tp.SCORE_ATOL, err_msg=name)
    return host, got.topk_idx.numpy()


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("variant,n_nodes", tp.JOINT_VARIANTS,
                         ids=[v for v, _ in tp.JOINT_VARIANTS])
def test_joint_wave_matches_reference(variant, n_nodes, seed):
    kins, feats = tp.wave_members(30 + seed, variant, n_nodes)
    host, _ = _wave(kins, feats)
    assert host["found"].any()


@pytest.mark.parametrize("case", tp.JOINT_CASES)
def test_joint_case_matches_reference(case):
    kins, feats, info = tp.joint_case(case)
    host, topk_idx = _wave(kins, feats)
    tp.check_joint_case(case, info, host["chosen"], host["found"], topk_idx,
                        host)


@pytest.mark.parametrize("clusters", tp.BOUNDARY_CLUSTERS)
@pytest.mark.parametrize("n_nodes,n_pad", tp.BOUNDARY_WIDTHS,
                         ids=[f"n{n}" for _, n in tp.BOUNDARY_WIDTHS])
def test_joint_wave_at_the_plans_range_edges(n_nodes, n_pad, clusters):
    """The waves the card tests run over forced cluster counts, laid out
    at that count's CTA ranges (a width no range count divides, the pin
    and penalty nodes in the last range, buckets across the ranges'
    edges): the port's route held against the reference."""
    kins, feats = tp.boundary_wave(clusters, n_nodes, n_pad)
    host, _ = _wave(kins, feats)
    assert host["found"].any()


def _port_kin(kin):
    """A reference KernelIn's numpy leaves as the port's KernelIn."""
    return tk.KernelIn(**kin._asdict())


def _single(kin, feats, k):
    """One eval through the port's full-width route on the CPU and the
    reference's ``place_taskgroup_jit``: KernelOuts of numpy."""
    ref = place_taskgroup_jit(kin, k, feats)
    got = tk._place_full(_port_kin(kin), k, tp.port_features(feats), CPU)
    for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            err_msg=name)
    for name in ("scores", "topk_scores"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            rtol=0, atol=tp.SCORE_ATOL, err_msg=name)
    return got


@pytest.mark.parametrize("variant,n_nodes", tp.JOINT_VARIANTS,
                         ids=[v for v, _ in tp.JOINT_VARIANTS])
def test_single_eval_route_matches_reference(variant, n_nodes):
    """Each member of a variant's wave as a single eval of K placements
    (several on one node: the f32 carries add each placement in turn)."""
    kins, feats = tp.wave_members(40, variant, n_nodes)
    placed = 0
    for kin in kins:
        got = _single(kin, feats, tp.K)
        placed += int(np.asarray(got.found).sum())
    assert placed > 0


@pytest.mark.parametrize("case", tp.JOINT_CASES)
def test_single_eval_route_on_joint_cases(case):
    kins, feats, _ = tp.joint_case(case)
    got = _single(kins[0], feats, tp.K)
    assert np.asarray(got.found).any()


def test_default_launch_of_a_spread_eval_takes_the_full_route():
    """A spread eval through ``default_kernel_launch`` on the CPU: the
    full-width route (no candidate set), equal to the reference's."""
    cluster = ref_synthetic.synthetic_cluster(150, seed=3)
    ev = ref_synthetic.synthetic_eval(cluster, with_spread=True,
                                      used_frac=0.5, seed=3)
    kin = ref_build_kernel_in(cluster, ev, 6)
    feats = tp.variant_features("spread")
    ref = place_taskgroup_jit(kin, 8, feats)
    tk.single_eval_stats.reset()
    got = tk.default_kernel_launch(_port_kin(kin), 8,
                                   tp.port_features(feats), device="cpu")
    assert tk.single_eval_stats.snapshot() == {"topk": 0, "breaches": 0,
                                               "full": 1}
    np.testing.assert_array_equal(got.chosen, np.asarray(ref.chosen))
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores), rtol=0,
                               atol=tp.SCORE_ATOL)
    assert got.found[:6].all() and not got.found[6:].any()


def test_launch_wave_counts_an_out_of_envelope_wave():
    """A spread wave through ``launch_wave`` on the CPU: one fused
    fallback (the reference's count), no joint-kernel launch, one wave of
    torch ops (the plain version), its members' outputs the reference's."""
    kins, feats = tp.wave_members(50, "spread", 200)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    ref = place_taskgroups_joint_jit(
        stacked, jnp.asarray(sm), jnp.asarray(sl), t_pad, feats)
    port_kins = [_port_kin(k) for k in kins]
    pc.fused_wave_stats.reset()
    pc.joint_wave_stats.reset()
    outs = pc.launch_wave(port_kins, [tp.K] * len(kins),
                          [tp.port_features(feats)] * len(kins),
                          device="cpu")
    assert pc.fused_wave_stats.snapshot() == {
        "launches": 0, "fallbacks": 1, "failures": 0}
    assert pc.joint_wave_stats.snapshot() == {
        "launches": 0, "sharded_launches": 0, "global_rows": 0,
        "torch_waves": 1}
    chosen = np.concatenate([o.chosen for o in outs])
    np.testing.assert_array_equal(chosen,
                                  np.asarray(ref.chosen)[:len(chosen)])


def test_joint_predicate_takes_every_union():
    """The joint kernel takes every feature union; B1's envelope stays
    the reference's (test_torch_kernel holds that)."""
    for variant, _ in tp.FUSED_VARIANTS + tp.JOINT_VARIANTS:
        f = tp.port_features(tp.variant_features(variant))
        assert tk.joint_wave_supported(f)
        assert tk.joint_wave_supported(tk.canonical_features(f))
    assert not tk.fused_wave_supported(
        tp.port_features(tp.variant_features("everything")))


def test_joint_wrapper_checks_before_it_builds():
    """The wrapper's checks run before any library is built: a leaf of
    the wrong dtype or width raises ValueError."""
    kins, feats = tp.wave_members(51, "devices", 60, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device="cpu")
    f = tp.port_features(feats)
    with pytest.raises(ValueError, match="dev_free has dtype"):
        ck._joint_launch(kin._replace(dev_free=kin.dev_free.double()), sm,
                         sl, t_pad, f)
    with pytest.raises(ValueError, match="dev_free has shape"):
        ck._joint_launch(kin._replace(dev_free=kin.dev_free[..., :3]
                                      .contiguous()), sm, sl, t_pad, f)
    with pytest.raises(ValueError, match="n_spreads"):
        ck._joint_launch(kin, sm, sl, t_pad, f._replace(n_spreads=5))
    with pytest.raises(ValueError, match="one eval"):
        ck.joint_eval_place(kin, tp.K, f)


def test_warmup_warms_a_joint_entry_through_the_joint_route(monkeypatch):
    """A one-device ``joint`` manifest entry outside B1's envelope is
    warmed through ``joint_wave_place``, the route its live waves take
    (the joint kernel on the card, its plain version here)."""
    from nomad_tpu_torch.ops import warmup

    calls = []
    real = ck.joint_wave_place

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ck, "joint_wave_place", counting)
    feats = tp.port_features(tp.variant_features("spread"))
    entry = {"kernel": "joint", "wave": 4, "steps": 16, "nodes": 256,
             "shared": True, "neutral_shared": True, "job_shared": True,
             "features": dict(tk.canonical_features(feats)._asdict())}
    warmup.warmup_stats.reset()
    assert warmup.warmup_entries([entry], device="cpu") == (1, 0)
    assert calls == [1]
    assert warmup.warmup_stats.snapshot() == {"joint": 1}
