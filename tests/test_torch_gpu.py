"""The CUDA fused-wave kernel against its plain torch version, on the card.

Imports nothing of JAX or of ``nomad_tpu`` (members come from the port's
own synthetic builders), so it runs where only the port is installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py

Every test takes the ``cuda_device`` fixture, which skips without a card.
Choices, found, top-k indices and metrics must match exactly; scores,
top-k scores and carries within 1e-5.
"""

import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import cuda_device  # noqa: F401 - fixture
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import coalesce as pc

ATOL = 1e-5


def _assert_fused(got, want, t_pad, b):
    g = tk.unpack_fused_wave(got.packed.cpu().numpy(), t_pad, b)
    w = tk.unpack_fused_wave(want.packed.cpu().numpy(), t_pad, b)
    for name in ("chosen", "found") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.topk_idx.cpu().numpy(),
                                  want.topk_idx.cpu().numpy())
    for name in ("topk_scores", "a_cpu", "a_mem", "a_disk"):
        np.testing.assert_allclose(
            getattr(got, name).cpu().numpy(),
            getattr(want, name).cpu().numpy(), rtol=0, atol=ATOL,
            err_msg=name)
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("variant,n_nodes", tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.FUSED_VARIANTS])
def test_cuda_kernel_matches_plain_version(variant, n_nodes, cuda_device):
    kins, feats = tp.wave_members(8, variant, n_nodes, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    smt = torch.from_numpy(sm).to(cuda_device)
    slt = torch.from_numpy(sl).to(cuda_device)
    before = ck.launches
    got = ck.fused_wave_place(kin, smt, slt, t_pad, feats)
    assert ck.launches == before + 1
    want = ck.fused_wave_place_reference(kin, smt, slt, t_pad, feats)
    torch.cuda.synchronize()
    g = _assert_fused(got, want, t_pad, tp.B)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_padding_steps_and_no_topk(cuda_device):
    """Padding steps emit top-k indices 0..7 at NEG_INF; with top-k off
    the planes are NEG_INF / 0."""
    kins, feats = tp.wave_members(9, "shuffle", 200, b=2, k=3, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins, k=3)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    for f in (feats, feats._replace(with_topk=False)):
        got = ck.fused_wave_place(kin, sm, sl, t_pad, f)
        want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, f)
        torch.cuda.synchronize()
        _assert_fused(got, want, t_pad, 2)


@pytest.mark.gpu
def test_cuda_launch_wave_one_kernel_launch(cuda_device):
    """One fused wave is one kernel launch; its members match the plain
    version's wave on the CPU."""
    kins, feats = tp.wave_members(20, "kitchen_sink", 383, b=4, lib="port")
    kins = [k._replace(**{f: getattr(kins[0], f)
                          for f in pc._SHAREABLE_FIELDS}) for k in kins]
    before = ck.launches
    got = pc.launch_wave(kins, [tp.K] * 4, [feats] * 4, device=cuda_device)
    assert ck.launches == before + 1
    want = pc.launch_wave(kins, [tp.K] * 4, [feats] * 4, device="cpu")
    for g, w in zip(got, want):
        for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(w, name)))
        np.testing.assert_allclose(np.asarray(g.scores),
                                   np.asarray(w.scores), rtol=0, atol=ATOL)


@pytest.mark.gpu
def test_cuda_apply_leaves_inputs_untouched(cuda_device):
    kins, feats = tp.wave_members(21, "ports", 200, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    n = kin.cap_cpu.shape[-1]
    uc = torch.full((n,), 100.0, device=cuda_device)
    um = torch.full((n,), 64.0, device=cuda_device)
    ud = torch.zeros(n, device=cuda_device)
    copies = [x.clone() for x in (uc, um, ud) + tuple(kin)]
    out, uc2, um2, ud2 = ck.fused_wave_apply(kin, uc, um, ud, sm, sl,
                                             t_pad, feats)
    torch.cuda.synchronize()
    for x, c in zip((uc, um, ud) + tuple(kin), copies):
        assert torch.equal(x, c)
    assert torch.equal(uc2, uc + out.a_cpu)
    assert out.a_cpu.sum() > 0


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    kins, feats = tp.wave_members(22, "lean", 60, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        ck.fused_wave_place(kin._replace(cap_cpu=kin.cap_cpu.double()),
                            sm, sl, t_pad, feats)
    strided = kin.used_cpu.t().contiguous().t()      # [B, N], transposed
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ck.fused_wave_place(kin._replace(used_cpu=strided), sm, sl, t_pad,
                            feats)
    with pytest.raises(ValueError, match="envelope"):
        ck.fused_wave_place(kin, sm, sl, t_pad,
                            feats._replace(with_cores=True))
