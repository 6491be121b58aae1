"""The port's wave math against the JAX reference, on the CPU.

Same numpy inputs through ``nomad_tpu``'s ``place_taskgroups_joint_jit``
/ ``fused_wave_place(interpret=True)`` and ``nomad_tpu_torch``'s
counterparts. Choices, found, top-k indices and i32 metrics must match
exactly; scores within ``SCORE_ATOL`` (XLA-CPU and torch-CPU round
``pow`` and division differently); carries within the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.ops.kernel import place_taskgroups_joint_jit
from nomad_tpu.ops.pallas_kernel import fused_wave_place as jax_fused
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk

ALL_VARIANTS = tp.FUSED_VARIANTS + tp.COMPOSITE_VARIANTS


def _port_stacked(stacked):
    return kernel_in_from_numpy(stacked, device="cpu")


def _assert_joint(port, ref, ctx):
    for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=f"{name} {ctx}")
    for name in ("scores", "topk_scores", "a_cpu", "a_mem", "a_disk"):
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=0, atol=tp.SCORE_ATOL, err_msg=f"{name} {ctx}")


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("variant,n_nodes", ALL_VARIANTS,
                         ids=[v for v, _ in ALL_VARIANTS])
def test_joint_matches_reference(variant, n_nodes, seed):
    kins, feats = tp.wave_members(seed, variant, n_nodes)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    ref = place_taskgroups_joint_jit(
        stacked, jnp.asarray(sm), jnp.asarray(sl), t_pad, feats)
    port = tk.place_taskgroups_joint(
        _port_stacked(stacked), torch.from_numpy(sm), torch.from_numpy(sl),
        t_pad, tp.port_features(feats))
    _assert_joint(port, ref, f"variant={variant} seed={seed}")
    assert port.found.any()


@pytest.mark.parametrize("variant,n_nodes", tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.FUSED_VARIANTS])
def test_fused_cpu_matches_pallas_interpret(variant, n_nodes):
    kins, feats = tp.wave_members(7, variant, n_nodes)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    ref = jax_fused(stacked, jnp.asarray(sm), jnp.asarray(sl), t_pad,
                    feats, interpret=True)
    launches = ck.launches
    port = ck.fused_wave_place(
        _port_stacked(stacked), torch.from_numpy(sm), torch.from_numpy(sl),
        t_pad, tp.port_features(feats))
    assert ck.launches == launches, "CPU tensors never launch the kernel"
    host = tk.unpack_fused_wave(port.packed.numpy(), t_pad, tp.B)
    ref_host = tk.unpack_fused_wave(np.asarray(ref.packed), t_pad, tp.B)
    for name in ("chosen", "found") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(host[name], ref_host[name],
                                      err_msg=name)
    np.testing.assert_allclose(host["scores"], ref_host["scores"],
                               rtol=0, atol=tp.SCORE_ATOL)
    np.testing.assert_array_equal(port.topk_idx.numpy(),
                                  np.asarray(ref.topk_idx))
    for name in ("topk_scores", "a_cpu", "a_mem", "a_disk"):
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=0, atol=tp.SCORE_ATOL, err_msg=name)


def test_padding_steps_emit_neutral_topk():
    """Padding steps (step_member == -1) are inactive and still emit a
    top-k over an all-NEG_INF plane: indices 0..7, scores NEG_INF."""
    kins, feats = tp.wave_members(3, "lean", 60, b=2, k=3)
    stacked, sm, sl, t_pad = tp.stack_wave(kins, k=3)
    assert (sm == -1).any()
    port = tk.place_taskgroups_joint(
        _port_stacked(stacked), torch.from_numpy(sm), torch.from_numpy(sl),
        t_pad, tp.port_features(feats))
    pad = torch.from_numpy(sm == -1)
    assert not port.found[pad].any()
    assert (port.chosen[pad] == -1).all()
    np.testing.assert_array_equal(
        port.topk_idx[pad].numpy(),
        np.tile(np.arange(tk.TOPK, dtype=np.int32), (int(pad.sum()), 1)))
    assert (port.topk_scores[pad] == tk.NEG_INF).all()


def test_lean_without_topk_emits_neg_inf():
    kins, feats = tp.wave_members(4, "lean", 60)
    feats = feats._replace(with_topk=False)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    port = tk.place_taskgroups_joint(
        _port_stacked(stacked), sm, sl, t_pad, tp.port_features(feats))
    assert (port.topk_scores == tk.NEG_INF).all()
    assert (port.topk_idx == 0).all()


def test_fused_envelope_is_the_reference_envelope():
    from nomad_tpu.ops.kernel import fused_wave_supported as ref_supported

    for variant, _ in ALL_VARIANTS:
        f = tp.variant_features(variant)
        assert tk.fused_wave_supported(tp.port_features(f)) == \
            ref_supported(f), variant


def test_fused_rejects_unsupported_union():
    kins, feats = tp.wave_members(5, "spread", 200)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    with pytest.raises(ValueError, match="envelope"):
        ck.fused_wave_place(_port_stacked(stacked), sm, sl, t_pad,
                            tp.port_features(feats))


def test_pack_unpack_roundtrip():
    kins, feats = tp.wave_members(6, "kitchen_sink", 383)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    out = tk.place_taskgroups_joint(
        _port_stacked(stacked), sm, sl, t_pad, tp.port_features(feats))
    host = tk.unpack_fused_wave(
        tk.pack_fused_wave(out, t_pad, tp.B).numpy(), t_pad, tp.B)
    assert len(tk.pack_fused_wave(out, t_pad, tp.B)) == \
        tk.fused_pack_len(t_pad, tp.B)
    np.testing.assert_array_equal(host["chosen"], out.chosen.numpy())
    np.testing.assert_array_equal(host["found"], out.found.numpy())
    for name in tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(host[name],
                                      getattr(out, name).numpy())


def test_build_kernel_in_matches_reference():
    """The port's host-side assembly gives the reference's planes (ports
    and spreads exercise the non-neutral branches)."""
    from nomad_tpu.ops.kernel import build_kernel_in as ref_build
    from nomad_tpu.parallel.synthetic import (
        synthetic_cluster,
        synthetic_eval,
    )
    from nomad_tpu_torch.convert import cluster_from_numpy, eval_from_numpy

    cluster = synthetic_cluster(100, seed=3)
    ev = synthetic_eval(cluster, with_spread=True, used_frac=0.4, seed=3)
    ev.ask.reserved_ports = [8080]
    ev.ask.port_mask[8080 >> 5] |= np.uint32(1 << (8080 & 31))
    cluster.port_words[5, 8080 >> 5] |= np.uint32(1 << (8080 & 31))
    ref = ref_build(cluster, ev, 5)
    port = tk.build_kernel_in(cluster_from_numpy(cluster),
                              eval_from_numpy(ev), 5)
    for name in tk.KernelIn._fields:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert bool(port.port_conflict[5]) and port.port_conflict.sum() == 1


def test_features_helpers_match_reference():
    from nomad_tpu.ops import kernel as rk
    from nomad_tpu.parallel.coalesce import pad_wave as ref_pad_wave
    from nomad_tpu_torch.parallel.coalesce import pad_wave

    for k in (1, 3, 8, 9, 500, 5000):
        assert tk.pad_steps(k) == rk.pad_steps(k)
        assert tk.pad_steps_live(k) == rk.pad_steps_live(k)
    for b in (1, 2, 5, 17, 33, 65, 300):
        assert pad_wave(b) == ref_pad_wave(b)
    f = rk.KernelFeatures(n_spreads=2, with_step_penalties=True,
                          with_preferred=False)
    assert tk.canonical_features(tp.port_features(f))._asdict() == \
        rk.canonical_features(f)._asdict()
    assert tk.KIN_UNBATCHED_RANKS == tuple(rk.KIN_UNBATCHED_RANKS)
    assert tk.KernelIn._fields == rk.KernelIn._fields


def test_infer_features_matches_reference():
    from nomad_tpu.ops.kernel import infer_features as ref_infer
    from nomad_tpu.parallel.synthetic import (
        synthetic_cluster,
        synthetic_eval,
    )
    from nomad_tpu_torch.convert import eval_from_numpy

    cluster = synthetic_cluster(70, seed=5)
    for spread in (False, True):
        ev = synthetic_eval(cluster, with_spread=spread, seed=5)
        ev.ask.n_dyn_ports = int(spread)
        ev.ask.cores = 2 * int(spread)
        ev.distinct_hosts_tg = spread
        for kw in ({}, {"any_penalty": False, "with_shuffle": True}):
            assert tk.infer_features(eval_from_numpy(ev), **kw)._asdict() \
                == ref_infer(ev, **kw)._asdict()

