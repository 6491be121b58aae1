"""The port's batched placement step over an (evals, nodes) mesh, and its
entry points, against the JAX package's (CPU).

``parallel/sharded.make_place_batch`` sends each eval whose planes fit
the fused envelope to a kernel wrapper as a one-member wave: the sharded
wave over an evals row of two or more node shards, B1 over a row of one.
On CPU shards those wrappers run their plain versions; the route, the
features each eval is given and the outputs read from the packed buffer
are the card's. Every other eval runs the wave body as torch ops.

Held here, on the conftest's 8 virtual JAX devices and an 8-entry CPU
mesh for the port: the route against JAX's ``make_place_batch`` at
meshes (2, 4), (4, 2) and (8, 1) over a batch of lean, spread, device,
core and bandwidth evals (choices, found, top-k indices and i32 metrics
exact, scores within one f32 ulp at 1.0); the route against the port's
plain step (every eval through the torch-op body) exactly; the narrowed
features against the full ones on the plain body; evals that stay
independent inside one row; and ``nomad_tpu_torch/entry.py`` against
``__graft_entry__.py``.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.ops.kernel import pad_steps
from nomad_tpu.parallel import mesh as ref_mesh
from nomad_tpu.parallel import sharded as ref_sharded
from nomad_tpu.parallel.synthetic import synthetic_kernel_in
from nomad_tpu_torch import entry
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import mesh as pmesh
from nomad_tpu_torch.parallel import sharded

CPU = torch.device("cpu")
CPU8 = [CPU] * 8
#: scores against JAX: one f32 ulp at 1.0, as tests/test_torch_mesh.py
SCORE_ATOL = 1.19e-7
INT_FIELDS = ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS
#: the batch's node axis: 256 rows, 32 a shard at the most shards
N_PAD = 256
K = 4
#: the mixed batch, in eval order: which evals fit the fused envelope
MIX = ("kitchen_sink", "spread", "lean", "devices", "penalty_preferred",
       "cores", "distinct", "network")
IN_ENVELOPE = [v not in ("spread", "devices", "cores", "network")
               for v in MIX]


@pytest.fixture(autouse=True)
def _eight_devices():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"


@pytest.fixture(scope="module")
def mixed():
    """Eight evals of their own clusters on one padded node axis (JAX
    numpy KernelIns), one of each variant in ``MIX``."""
    return [tp.wave_members(20 + i, v, 200, b=1, k=K, n_pad=N_PAD)[0][0]
            for i, v in enumerate(MIX)]


def _port(kins):
    return sharded.stack_kernel_ins(
        [kernel_in_from_numpy(k, keep_numpy=True) for k in kins])


def _ref_outs(kins, shape, k_pad, features=None):
    mesh = ref_mesh.make_mesh(shape[0] * shape[1], evals_parallel=shape[0])
    args = (mesh, k_pad) if features is None else (mesh, k_pad, features)
    out = ref_sharded.make_place_batch(*args)(
        ref_sharded.stack_kernel_ins(kins))
    jax.block_until_ready(out)
    return ref_sharded.unstack_kernel_outs(out)


def _port_step(shape, k_pad, **kw):
    mesh = pmesh.make_mesh(shape[0] * shape[1], evals_parallel=shape[0],
                           devices=CPU8)
    return sharded.make_place_batch(mesh, k_pad, **kw)


def _assert_outs(got, want, exact: bool, ctx: str):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=f"{name} {ctx}")
    for name in ("scores", "topk_scores"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=0, atol=0.0 if exact else SCORE_ATOL,
            err_msg=f"{name} {ctx}")


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1)],
                         ids=["2x4", "4x2", "8x1"])
def test_route_matches_reference(mixed, shape):
    """Each eval through its route against JAX's ``make_place_batch`` on
    the same mesh shape, and against the port's plain step; the
    envelope's evals count as kernel calls (the sharded wave on rows of
    several shards, B1 on rows of one), the rest as joint-kernel calls
    on rows of one and as sharded calls (the joint sharded wave) on rows
    of several: no eval runs the plain body."""
    k_pad = pad_steps(K)
    refs = _ref_outs(mixed, shape, k_pad)
    stacked = _port(mixed)
    before = sharded.place_batch_stats.snapshot()
    out = _port_step(shape, k_pad)(stacked)
    after = sharded.place_batch_stats.snapshot()
    assert out.chosen.shape == (len(MIX), k_pad)
    outs = sharded.unstack_kernel_outs(out)
    for i, (got, ref) in enumerate(zip(outs, refs)):
        _assert_outs(got, ref, exact=False, ctx=f"eval {i} ({MIX[i]})")
    plain = sharded.unstack_kernel_outs(
        _port_step(shape, k_pad, plain=True)(stacked))
    for i, (got, want) in enumerate(zip(outs, plain)):
        _assert_outs(got, want, exact=True, ctx=f"eval {i} ({MIX[i]})")
    kernel = sum(IN_ENVELOPE)
    routed = {k: after[k] - before[k] for k in after}
    one = shape[1] == 1
    assert routed["fused_calls"] == (kernel if one else 0)
    assert routed["joint_calls"] == (len(MIX) - kernel if one else 0)
    assert routed["sharded_calls"] == (0 if one else len(MIX))
    assert routed["plain_evals"] == 0
    assert all(np.asarray(o.found)[:K].any() for o in outs)


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)], ids=["8x1", "2x4"])
def test_evals_past_the_fused_plans_run_the_joint_kernels(mixed, shape,
                                                         monkeypatch):
    """An eval in the fused envelope whose row B1's plan (a row of one
    shard) or the sharded kernel's plan (a row of several) does not hold,
    as the card's plans do not at N=524288 with shuffle: the step sends
    it to the joint hand kernels, ``joint_wave_place`` on a row of one and
    ``joint_sharded_wave_place`` on wider rows, asked before any launch;
    every eval equals JAX's ``make_place_batch`` on the same mesh (i32
    exact, scores within one f32 ulp)."""
    asked, calls = [], {"joint": 0, "joint_sharded": 0}

    def no_b1(dev, n, b, shuffle):
        asked.append(("b1", n, b))
        return False

    def no_sharded(devices, n_loc, b, shuffle):
        asked.append(("sharded", len(devices), n_loc, b))
        return False

    def counted(name, real):
        def place(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return place

    def refused(*a, **k):
        pytest.fail("a fused kernel whose plan does not hold the eval")

    monkeypatch.setattr(sharded, "fused_wave_fits", no_b1)
    monkeypatch.setattr(sharded, "sharded_wave_fits", no_sharded)
    monkeypatch.setattr(sharded, "fused_wave_place", refused)
    monkeypatch.setattr(sharded, "sharded_wave_place", refused)
    for name in calls:
        monkeypatch.setattr(sharded, f"{name}_wave_place", counted(
            name, getattr(sharded, f"{name}_wave_place")))
    k_pad = pad_steps(K)
    refs = _ref_outs(mixed, shape, k_pad)
    before = sharded.place_batch_stats.snapshot()
    out = _port_step(shape, k_pad)(_port(mixed))
    after = sharded.place_batch_stats.snapshot()
    for i, (got, ref) in enumerate(zip(sharded.unstack_kernel_outs(out),
                                       refs)):
        _assert_outs(got, ref, exact=False, ctx=f"eval {i} ({MIX[i]})")
    routed = {k: after[k] - before[k] for k in after}
    one = shape[1] == 1
    assert routed == {"fused_calls": 0,
                      "joint_calls": len(MIX) if one else 0,
                      "sharded_calls": 0 if one else len(MIX),
                      "kernel_calls": len(MIX), "plain_evals": 0}
    assert calls == {"joint": len(MIX) if one else 0,
                     "joint_sharded": 0 if one else len(MIX)}
    kernel = sum(IN_ENVELOPE)
    assert asked == ([("b1", N_PAD, 1)] * kernel if one
                     else [("sharded", shape[1], N_PAD // shape[1], 1)]
                     * kernel)


@pytest.mark.parametrize("variant", MIX)
def test_narrowed_features_change_nothing(mixed, variant):
    """The plain body gives an eval the same outputs under
    ``FULL_FEATURES`` and under ``eval_features``' narrowing; an eval
    whose spread, device, core or bandwidth planes are not neutral keeps
    that feature."""
    i = MIX.index(variant)
    stacked = _port(mixed)
    f = sharded.eval_features(stacked)[i]
    assert tk.fused_wave_supported(f) == IN_ENVELOPE[i]
    assert (f.n_spreads > 0) == (variant == "spread")
    assert f.with_devices == (variant == "devices")
    assert f.with_cores == (variant == "cores")
    assert f.with_network == (variant == "network")
    one = tk.KernelIn(*[torch.tensor(np.asarray(x)[i:i + 1]) if name ==
                        "n_steps" else torch.tensor(np.asarray(x)[i])
                        for name, x in zip(tk.KernelIn._fields, stacked)])
    k_pad = pad_steps(K)
    narrow = sharded._plain_eval([one], k_pad, f)
    full = sharded._plain_eval([one], k_pad, tk.FULL_FEATURES)
    _assert_outs(narrow, full, exact=True, ctx=variant)


def test_evals_stay_independent():
    """Two evals with identical planes on one evals row place
    identically: each is a problem of its own, never a member of one
    joint wave with a shared carry (which would steer the second away
    from the first's nodes)."""
    kins = [synthetic_kernel_in(n_nodes=200, n_steps=K, used_frac=0.5,
                                seed=s, n_pad=N_PAD) for s in (3, 3, 4, 4)]
    out = sharded.unstack_kernel_outs(
        _port_step((2, 4), pad_steps(K))(_port(kins)))
    for a, b in ((0, 1), (2, 3)):
        _assert_outs(out[a], out[b], exact=True, ctx=f"evals {a}, {b}")
    assert np.asarray(out[0].found)[:K].all()


def test_error_word_raises():
    """A sharded call's error word, read once at the end, raises."""
    k_pad = 4
    at = tk.fused_pack_len(k_pad, 1)
    ok = torch.zeros(at + 1)
    bad = ok.clone()
    bad[at] = 2.0
    sharded._raise_on_errors([ok], k_pad, CPU)
    with pytest.raises(RuntimeError, match=r"cards \[1\]"):
        sharded._raise_on_errors([ok, bad], k_pad, CPU)


def test_entry_step_matches_reference():
    """``entry.entry``'s step and example arguments against
    ``__graft_entry__.entry``'s: the same planes, the same placements."""
    import __graft_entry__ as graft

    ref_fn, ref_args = graft.entry()
    ref = jax.jit(ref_fn)(*ref_args)
    fn, args = entry.entry(CPU)
    for name, x, want in zip(tk.KernelIn._fields, args[0], ref_args[0]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(want),
                                      err_msg=name)
    got = fn(*args)
    _assert_outs(got, ref, exact=False, ctx="entry")
    assert np.asarray(got.found).all()


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip_matches_reference(n_devices):
    """``entry.dryrun_multichip`` over CPU entries passes its checks (the
    batch, then the live server over the mesh), and its batch's outputs
    equal JAX's ``make_place_batch`` on the dry run's batch and mesh."""
    res = entry.dryrun_multichip(n_devices, devices=CPU8)
    mesh = ref_mesh.make_mesh(n_devices)
    assert res["mesh"] == dict(mesh.shape)
    evals_par, nodes_par = mesh.shape["evals"], mesh.shape["nodes"]
    batch = max(2 * evals_par, 4)
    n_nodes = max(64 * nodes_par, 128)
    kins = [synthetic_kernel_in(n_nodes=n_nodes, n_steps=4,
                                with_spread=(i % 2 == 0), used_frac=0.4,
                                seed=i, n_pad=n_nodes)
            for i in range(batch)]
    k_pad = pad_steps(4)
    refs = ref_sharded.unstack_kernel_outs(
        ref_sharded.make_place_batch(mesh, k_pad)(
            ref_sharded.stack_kernel_ins(kins)))
    assert len(res["outs"]) == batch
    for i, (got, ref) in enumerate(zip(res["outs"], refs)):
        _assert_outs(got, ref, exact=False, ctx=f"eval {i}")
    # odd evals are lean: the sharded wave; even ones carry a spread:
    # the joint sharded wave, also a sharded call
    assert res["routes"] == {"fused_calls": 0, "joint_calls": 0,
                             "sharded_calls": batch,
                             "kernel_calls": batch,
                             "plain_evals": 0}
    assert res["placed"] == 8 and res["sharded_waves"] > 0


def test_entry_points_refuse_a_missing_card():
    """No device means the card: on a host without one both entry points
    raise, as does a mesh over more devices than given."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="requested 9 devices"):
        entry.dryrun_multichip(9, devices=CPU8)
