"""The port's fused wave against the JAX reference on the situations the
fused kernel's incremental design leans on, on the CPU.

The CUDA kernel keeps each member's masked score row cached between its
steps and rescores only the chosen node, the step's penalty nodes and the
pin; its node ranges are split over a thread-block cluster. These waves
pin what that must not change: a member's first step sees the members
before it, a step penalty or a pin overrides the cached value, and tied
scores keep their order across node-range boundaries. Each wave goes
through ``place_taskgroups_joint_jit`` or ``fused_wave_place(
interpret=True)`` and through the port's ``fused_wave_place`` on CPU
tensors (its plain version, the card kernel's yardstick). Choices, found,
top-k indices and metrics must match exactly; scores, top-k scores and
carries within ``SCORE_ATOL``. ``tests/test_torch_gpu.py`` runs the same
waves through the kernel on the card.
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


def _reference(ref, stacked, sm, sl, t_pad, feats):
    """The JAX wave as host arrays: chosen, scores, found, metrics (by
    name), top-k and carries."""
    if ref == "joint":
        out = place_taskgroups_joint_jit(stacked, jnp.asarray(sm),
                                         jnp.asarray(sl), t_pad, feats)
        host = {name: np.asarray(getattr(out, name))
                for name in ("chosen", "scores", "found")
                + tk.FUSED_METRIC_FIELDS}
    else:
        out = jax_fused(stacked, jnp.asarray(sm), jnp.asarray(sl), t_pad,
                        feats, interpret=True)
        host = tk.unpack_fused_wave(np.asarray(out.packed), t_pad,
                                    len(stacked.n_steps))
    for name in ("topk_idx", "topk_scores", "a_cpu", "a_mem", "a_disk"):
        host[name] = np.asarray(getattr(out, name))
    return host


def _port(stacked, sm, sl, t_pad, feats):
    launches = ck.launches
    out = ck.fused_wave_place(
        kernel_in_from_numpy(stacked, device="cpu"), torch.from_numpy(sm),
        torch.from_numpy(sl), t_pad, tp.port_features(feats))
    assert ck.launches == launches, "CPU tensors never launch the kernel"
    host = tk.unpack_fused_wave(out.packed.numpy(), t_pad,
                                len(stacked.n_steps))
    for name in ("topk_idx", "topk_scores", "a_cpu", "a_mem", "a_disk"):
        host[name] = getattr(out, name).numpy()
    return host


def _assert_same(port, ref, ctx):
    for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(port[name], ref[name],
                                      err_msg=f"{name} {ctx}")
    for name in ("scores", "topk_scores", "a_cpu", "a_mem", "a_disk"):
        np.testing.assert_allclose(port[name], ref[name], rtol=0,
                                   atol=tp.SCORE_ATOL,
                                   err_msg=f"{name} {ctx}")


@pytest.mark.parametrize("ref", ("joint", "interpret"))
@pytest.mark.parametrize("case", tp.FUSED_CASES)
def test_fused_case_matches_reference(case, ref):
    kins, feats, x = tp.fused_case(case)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    want = _reference(ref, stacked, sm, sl, t_pad, feats)
    tp.check_case(case, x, want["chosen"], want["found"], want["topk_idx"],
                  want["nodes_feasible"])
    _assert_same(_port(stacked, sm, sl, t_pad, feats), want,
                 f"case={case} ref={ref}")


@pytest.mark.parametrize("n", (72, 1000))
def test_ragged_width_matches_reference(n):
    """A node axis that is no power of two (and not a multiple of a
    cluster's 8 or 16 node ranges)."""
    kins, feats = tp.wave_members(12, "kitchen_sink", n - 5, n_pad=n)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    assert stacked.cap_cpu.shape[-1] == n
    want = _reference("joint", stacked, sm, sl, t_pad, feats)
    assert want["found"].any()
    _assert_same(_port(stacked, sm, sl, t_pad, feats), want, f"n={n}")
