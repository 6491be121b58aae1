"""The port's device mesh and sharded placement against the JAX package's.

Counterparts of ``tests/test_parallel.py`` (mesh shapes, the batched
sharded placement on a 2x4 mesh and on a nodes-only mesh) and of the
sharded half of ``tests/test_fused_kernel.py`` (the fused sharded wave
per variant), plus the joint sharded wave with spreads, devices, cores
and network. The JAX package runs on the conftest's 8 virtual CPU
devices; the port on an 8-entry CPU mesh (``devices=[cpu] * 8``, the
``cpu8`` fixture). Both get the same numpy inputs, made from a
seed. Integer outputs (choices, found, top-k indices, metrics) and the
carries must match exactly; scores within ``SCORE_ATOL`` (one f32 ulp
at 1.0) against JAX, and exactly against the port's own one-device
composite on the same inputs.

Every shard holds a multiple of 16 rows (N of 256 and more): torch's CPU
kernels run an elementwise op's last few elements (fewer than 16 f32
lanes) through scalar code, whose ``pow`` may round a last bit apart
from the vector code's, so a narrower shard would score some nodes by
another path than the whole plane does. A CUDA kernel computes every
element alike; the card holds the sharded waves exact at any width
(``chip_smoke.py`` phase 17).
"""

import weakref

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.ops.kernel import (
    KernelIn as RefKernelIn,
    KernelOut as RefKernelOut,
    pad_steps,
    place_taskgroup_jit,
)
from nomad_tpu.parallel import mesh as ref_mesh
from nomad_tpu.parallel import sharded as ref_sharded
from nomad_tpu.parallel.synthetic import synthetic_kernel_in
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import mesh as pmesh
from nomad_tpu_torch.parallel import sharded

CPU = torch.device("cpu")
#: scores against JAX: one f32 ulp at 1.0 (XLA's and torch's pow and
#: division may round a last bit apart); against the port's own
#: composite: exact
SCORE_ATOL = 1.19e-7


#: the port's virtual mesh: eight CPU entries, as the conftest gives JAX
#: eight virtual CPU devices
CPU8 = [CPU] * 8


@pytest.fixture()
def cpu8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return CPU8


#: the node axis of the waves: at least 256 rows (32 a shard)
MIN_PAD = 256


def _port_kin(kin):
    return kernel_in_from_numpy(kin, keep_numpy=True)


def _tensors(kin):
    return tk.KernelIn(*[torch.tensor(np.asarray(x)) for x in kin])


def _members(seed, variant, n_nodes, b=tp.B):
    """``tp.wave_members`` with the node axis padded to ``MIN_PAD`` rows
    at least (the real nodes then lie unevenly over the shards)."""
    return tp.wave_members(seed, variant, n_nodes, b=b,
                           n_pad=MIN_PAD if n_nodes <= MIN_PAD else None)


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

class TestMesh:
    def test_mesh_shapes(self, cpu8):
        mesh = pmesh.make_mesh(8, devices=CPU8)
        assert mesh.shape == {"evals": 2, "nodes": 4}
        assert mesh.shape == dict(ref_mesh.make_mesh(8).shape)
        mesh = pmesh.make_mesh(1, devices=CPU8)
        assert mesh.shape == {"evals": 1, "nodes": 1}
        mesh = pmesh.make_mesh(8, evals_parallel=4, devices=CPU8)
        assert mesh.shape == {"evals": 4, "nodes": 2}
        assert mesh.size == 8 and mesh.devices.shape == (4, 2)
        assert all(d == CPU for d in mesh.devices.flat)

    def test_make_mesh_errors_match_reference(self, cpu8):
        with pytest.raises(ValueError, match="requested 9 devices"):
            pmesh.make_mesh(9, devices=CPU8)
        with pytest.raises(ValueError, match="requested 9 devices"):
            ref_mesh.make_mesh(9)
        with pytest.raises(ValueError, match="not divisible"):
            pmesh.make_mesh(6, evals_parallel=4, devices=CPU8)
        with pytest.raises(ValueError, match="not divisible"):
            ref_mesh.make_mesh(6, evals_parallel=4)

    def test_available_devices(self, monkeypatch):
        assert pmesh.available_devices("cpu") == [CPU]
        assert sharded.wave_mesh(device="cpu").size == 1
        assert sharded.wave_mesh(devices=CPU8).shape == {"nodes": 8}
        assert sharded.wave_mesh(3, devices=CPU8).size == 3
        # on the card: every card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        cards = [torch.device("cuda", i) for i in range(4)]
        assert pmesh.available_devices("cuda") == cards
        assert list(sharded.wave_mesh(device="cuda").devices.flat) == cards

    def test_mesh_is_keyed_by_identity_and_matched_by_value(self, cpu8):
        a = sharded.wave_mesh(devices=CPU8)
        b = sharded.wave_mesh(devices=CPU8)
        assert a != b and hash(a) != hash(b)
        assert pmesh.mesh_match(a, b) and pmesh.mesh_match(None, None)
        assert not pmesh.mesh_match(a, None)
        assert not pmesh.mesh_match(a, sharded.wave_mesh(4, devices=CPU8))
        cache = weakref.WeakKeyDictionary({a: 1})
        assert b not in cache and cache[a] == 1

    def test_node_rows(self, cpu8):
        assert sharded.wave_mesh(devices=CPU8).node_rows() == [
            list(range(8))]
        assert pmesh.make_mesh(8, devices=CPU8).node_rows() == [
            [0, 1, 2, 3], [4, 5, 6, 7]]

    def test_collectives(self):
        parts = [torch.tensor([1, 5], dtype=torch.int32),
                 torch.tensor([4, 2], dtype=torch.int32)]
        total = pmesh.psum(parts)
        assert total.tolist() == [5, 7] and total.dtype == torch.int32
        assert pmesh.all_gather(parts).shape == (2, 2)
        out = pmesh.broadcast(total, [CPU, CPU])
        assert out[0] is out[1] is total


class TestPlacement:
    def test_place_splits_node_axis_into_own_tensors(self, cpu8):
        mesh = sharded.wave_mesh(devices=CPU8)
        plane = np.arange(64, dtype=np.float32)
        parts = sharded.place(plane, sharded.P("nodes"), mesh)
        assert len(parts) == 8
        for s, t in enumerate(parts):
            assert t.is_contiguous() and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), plane[8 * s:8 * s + 8])
        # own storage: a write into one shard touches no other, nor the
        # host array
        parts[0][0] = -1.0
        assert parts[1][0] == 8.0 and plane[0] == 0.0
        repl = sharded.place(plane, sharded.P(), mesh)
        assert all(t is repl[0] for t in repl)   # one copy per device

    def test_place_refuses_an_uneven_split(self, cpu8):
        mesh = sharded.wave_mesh(3, devices=CPU8)
        with pytest.raises(ValueError, match="does not split"):
            sharded.place(np.zeros(64, np.float32), sharded.P("nodes"),
                          mesh)

    def test_specs_cover_every_field_as_the_reference(self):
        assert set(sharded._IN_SPECS) == set(tk.KernelIn._fields)
        for f in tk.KernelIn._fields:
            assert tuple(sharded._IN_SPECS[f]) == tuple(
                ref_sharded._IN_SPECS[f]), f
            assert tuple(sharded._JOINT_SPECS[f]) == tuple(
                ref_sharded._JOINT_SPECS[f]), f
            assert tuple(sharded.shared_field_spec(f)) == tuple(
                ref_sharded.shared_field_spec(f)), f


# ---------------------------------------------------------------------------
# make_place_batch (tests/test_parallel.py)
# ---------------------------------------------------------------------------

N_STEPS = 4


@pytest.fixture(scope="module")
def problems():
    return [
        synthetic_kernel_in(
            n_nodes=200, n_steps=N_STEPS, with_spread=(i % 2 == 0),
            used_frac=0.5, seed=i,
        )
        for i in range(4)
    ]


def _assert_outs(got, want, exact_scores: bool, ctx=""):
    for name in ("chosen", "found", "topk_idx", "nodes_evaluated",
                 "nodes_feasible", "exhausted_cpu", "exhausted_mem",
                 "exhausted_disk", "exhausted_ports", "exhausted_devices",
                 "exhausted_cores"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=f"{name} {ctx}")
    for name in ("scores", "topk_scores"):
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        if exact_scores:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {ctx}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=SCORE_ATOL,
                                       err_msg=f"{name} {ctx}")


@pytest.mark.parametrize("evals_parallel", [2, 1])
def test_sharded_matches_single_device(problems, cpu8, evals_parallel):
    """The 2x4 mesh (and the nodes-only 1x8 mesh) against JAX's
    ``make_place_batch`` on its mesh, and against the port's one-device
    ``place_taskgroup`` per problem, with every feature (spreads
    included: one eval at a time)."""
    k_pad = pad_steps(N_STEPS)
    ref_step = ref_sharded.make_place_batch(
        ref_mesh.make_mesh(8, evals_parallel=evals_parallel), k_pad)
    ref_out = ref_step(ref_sharded.stack_kernel_ins(problems))
    jax.block_until_ready(ref_out)
    refs = ref_sharded.unstack_kernel_outs(ref_out)

    mesh = pmesh.make_mesh(8, evals_parallel=evals_parallel, devices=CPU8)
    step = sharded.make_place_batch(mesh, k_pad)
    out = step(sharded.stack_kernel_ins([_port_kin(k) for k in problems]))
    assert out.chosen.shape == (4, k_pad)
    outs = sharded.unstack_kernel_outs(out)
    for i, (got, ref, kin) in enumerate(zip(outs, refs, problems)):
        _assert_outs(got, ref, exact_scores=False, ctx=f"problem {i}")
        one = tk.place_taskgroup(_tensors(_port_kin(kin)), k_pad)
        _assert_outs(got, one, exact_scores=True, ctx=f"problem {i}")
    assert all(np.asarray(o.found)[:N_STEPS].all() for o in outs)


def test_sharded_batched_envelope_runs_batched(cpu8):
    """A feature set inside the one-device batched form's envelope
    (lean, devices and top-k), placed eval by eval over the mesh: equal
    to the one-device batched ``place_taskgroup`` and to JAX's batch."""
    feats = tp.variant_features("devices")
    kins, _ = _members(5, "devices", 200, b=8)
    k_pad = pad_steps(tp.K)
    ref_out = ref_sharded.make_place_batch(
        ref_mesh.make_mesh(8), k_pad, feats)(
            ref_sharded.stack_kernel_ins(kins))
    refs = ref_sharded.unstack_kernel_outs(ref_out)
    pf = tp.port_features(feats)
    port_kins = [_port_kin(k) for k in kins]
    stacked = sharded.stack_kernel_ins(port_kins)
    out = sharded.make_place_batch(
        pmesh.make_mesh(8, devices=CPU8), k_pad, pf)(stacked)
    one = tk.place_taskgroup(_tensors(stacked), k_pad, pf)
    for i, (got, ref) in enumerate(zip(sharded.unstack_kernel_outs(out),
                                       refs)):
        _assert_outs(got, ref, exact_scores=False, ctx=f"eval {i}")
        _assert_outs(got, tk.KernelOut(*[x[i] for x in one]),
                     exact_scores=True, ctx=f"eval {i}")
    assert np.asarray(out.found).any()


def test_batch_must_split_over_the_evals_axis(problems, cpu8):
    step = sharded.make_place_batch(pmesh.make_mesh(8, devices=CPU8),
                                    pad_steps(N_STEPS))
    with pytest.raises(ValueError, match="does not split"):
        step(sharded.stack_kernel_ins([_port_kin(k) for k in problems[:3]]))


# ---------------------------------------------------------------------------
# The fused and the joint sharded waves (tests/test_fused_kernel.py)
# ---------------------------------------------------------------------------

def _ref_entry(entry, stacked, sm, sl, t_pad, feats, d=8):
    mesh = ref_sharded.wave_mesh(d)
    fn, kin_sh, repl = entry(mesh)
    kin_dev = RefKernelIn(*[jax.device_put(x, s)
                            for x, s in zip(stacked, kin_sh)])
    return fn(kin_dev, jax.device_put(sm, repl), jax.device_put(sl, repl),
              t_pad, feats)


def _wave_host(out, t_pad, b):
    """Host arrays of a FusedWaveOut (packed) or a JointOut, by name."""
    if hasattr(out, "packed"):
        host = tk.unpack_fused_wave(np.asarray(out.packed), t_pad, b)
    else:
        host = {name: np.asarray(getattr(out, name))
                for name in ("chosen", "scores", "found")
                + tk.FUSED_METRIC_FIELDS}
    for name in ("topk_idx", "topk_scores", "a_cpu", "a_mem", "a_disk"):
        x = getattr(out, name)
        if isinstance(x, (tuple, list)):
            x = torch.cat(list(x))
        host[name] = np.asarray(x)
    return host


#: the joint sharded wave's scores against JAX: one f32 ulp in [1, 2),
#: 2**-23 (an affinity term lifts a score over 1.0, and in [0.5, 1) it is
#: two ulps); SCORE_ATOL is that ulp rounded down to 1.19e-7
ULP_ATOL = 2.0 ** -23


def _assert_wave(got, want, exact_scores: bool, ctx="", atol=SCORE_ATOL):
    for name, w in want.items():
        g = got[name]
        if name in ("scores", "topk_scores") and not exact_scores:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{name} {ctx}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {ctx}")


@pytest.mark.parametrize("seed", range(2 * len(tp.FUSED_VARIANTS)))
def test_fused_sharded_bit_identity(seed, cpu8):
    """``fused_sharded_entry`` on the 8-entry mesh against JAX's on its 8
    virtual devices and against the port's one-device composite; its
    carries come back split by node shard."""
    variant, n_nodes = tp.FUSED_VARIANTS[seed % len(tp.FUSED_VARIANTS)]
    kins, feats = _members(seed + 77, variant, n_nodes)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    n_pad = stacked.cap_cpu.shape[-1]
    assert n_pad // 8 >= tk.TOPK, "local top-k merge floor"
    ref = _wave_host(_ref_entry(ref_sharded.fused_sharded_entry, stacked,
                                sm, sl, t_pad, feats), t_pad, tp.B)
    mesh = sharded.wave_mesh(devices=CPU8)
    fn, kin_sh, _ = sharded.fused_sharded_entry(mesh)
    assert sharded.fused_sharded_entry(mesh)[0] is fn     # cached
    pf = tp.port_features(feats)
    fo = fn(_port_kin(stacked), sm, sl, t_pad, pf)
    assert len(fo.a_cpu) == 8 and all(
        p.shape == (n_pad // 8,) for p in fo.a_cpu)
    got = _wave_host(fo, t_pad, tp.B)
    _assert_wave(got, ref, exact_scores=False, ctx=f"{variant} vs JAX")
    one = ck.fused_wave_place_reference(
        _tensors(_port_kin(stacked)), torch.from_numpy(sm),
        torch.from_numpy(sl), t_pad, pf)
    _assert_wave(got, _wave_host(one, t_pad, tp.B), exact_scores=True,
                 ctx=f"{variant} vs the one-device composite")
    assert got["found"].any()


@pytest.mark.parametrize("variant,n_nodes", tp.COMPOSITE_VARIANTS)
def test_joint_sharded_outside_the_fused_envelope(variant, n_nodes, cpu8):
    """``joint_sharded_entry`` takes spreads, devices, cores and network
    (GSPMD's partition of the joint program in the JAX package)."""
    kins, feats = _members(31, variant, n_nodes)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    ref = _wave_host(_ref_entry(ref_sharded.joint_sharded_entry, stacked,
                                sm, sl, t_pad, feats), t_pad, tp.B)
    pf = tp.port_features(feats)
    fn = sharded.make_joint_sharded(sharded.wave_mesh(devices=CPU8))
    out = fn(_port_kin(stacked), sm, sl, t_pad, pf)
    got = _wave_host(out, t_pad, tp.B)
    _assert_wave(got, ref, exact_scores=False, ctx=f"{variant} vs JAX")
    one = tk.place_taskgroups_joint(
        _tensors(_port_kin(stacked)), torch.from_numpy(sm),
        torch.from_numpy(sl), t_pad, pf)
    _assert_wave(got, _wave_host(one, t_pad, tp.B), exact_scores=True,
                 ctx=f"{variant} vs the one-device composite")
    assert got["found"].any()


def _port_parts(stacked, d):
    """The port's wave split over ``d`` CPU entries, as
    ``joint_sharded_entry`` hands it to the kernel's wrapper."""
    mesh = sharded.wave_mesh(devices=[CPU] * d)
    placed, _ = sharded.place_args(_port_kin(stacked),
                                   sharded.joint_in_shardings(mesh)[0])
    return sharded._shards_of(placed, mesh.node_rows()[0])


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("variant,n_nodes", tp.JOINT_VARIANTS,
                         ids=[v for v, _ in tp.JOINT_VARIANTS])
def test_joint_sharded_kernel_plain_version_matches_jax(variant, n_nodes,
                                                        shards, cpu8):
    """``ck.joint_sharded_wave_place_reference`` (the plain version the
    joint sharded kernel is held against on the card) over D CPU entries
    against JAX's ``joint_sharded_entry`` over D virtual devices, for each
    union outside the fused envelope: i32 outputs exact, scores within
    ``ULP_ATOL``; and exactly the port's one-device composite. The packed
    buffer and the carries are the wrapper's layout."""
    kins, feats = _members(40 + shards, variant, n_nodes)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    ref = _wave_host(_ref_entry(ref_sharded.joint_sharded_entry, stacked,
                                sm, sl, t_pad, feats, d=shards), t_pad, tp.B)
    pf = tp.port_features(feats)
    parts = _port_parts(stacked, shards)
    out = ck.joint_sharded_wave_place_reference(parts, sm, sl, t_pad, pf)
    assert out.packed.numel() == tk.fused_pack_len(t_pad, tp.B)
    n_loc = parts[0].cap_cpu.shape[-1:]
    assert [p.shape for p in out.a_cpu] == [n_loc] * shards
    got = _wave_host(out, t_pad, tp.B)
    _assert_wave(got, ref, exact_scores=False, ctx=f"{variant} vs JAX",
                 atol=ULP_ATOL)
    one = tk.place_taskgroups_joint(
        _tensors(_port_kin(stacked)), torch.from_numpy(sm),
        torch.from_numpy(sl), t_pad, pf)
    _assert_wave(got, _wave_host(one, t_pad, tp.B), exact_scores=True,
                 ctx=f"{variant} vs the one-device composite")
    assert got["found"].any()
    # the wrapper takes CPU shards to the same plain version
    _assert_wave(_wave_host(ck.joint_sharded_wave_place(
        parts, sm, sl, t_pad, pf), t_pad, tp.B), got, exact_scores=True)


@pytest.mark.parametrize("n_pad,shards", [(32, 8), (16, 4)],
                         ids=["n32-d8", "n16-d4"])
def test_joint_sharded_narrow_shards_match_jax(n_pad, shards, cpu8):
    """Shards of four rows, under TOPK: each offers its top four, and the
    merged top-8 is JAX's over the whole axis. Against JAX and the
    one-device composite within ``ULP_ATOL`` (a shard this narrow runs
    torch's scalar tail, see the module doc)."""
    kins, feats = tp.wave_members(47, "everything", n_pad - 2, n_pad=n_pad)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    ref = _wave_host(_ref_entry(ref_sharded.joint_sharded_entry, stacked,
                                sm, sl, t_pad, feats, d=shards), t_pad, tp.B)
    pf = tp.port_features(feats)
    got = _wave_host(ck.joint_sharded_wave_place_reference(
        _port_parts(stacked, shards), sm, sl, t_pad, pf), t_pad, tp.B)
    _assert_wave(got, ref, exact_scores=False, ctx="narrow vs JAX",
                 atol=ULP_ATOL)
    one = tk.place_taskgroups_joint(
        _tensors(_port_kin(stacked)), torch.from_numpy(sm),
        torch.from_numpy(sl), t_pad, pf)
    _assert_wave(got, _wave_host(one, t_pad, tp.B), exact_scores=False,
                 ctx="narrow vs the one-device composite", atol=ULP_ATOL)
    assert got["found"].any()


@pytest.mark.parametrize("shards", [2, 4])
def test_fused_sharded_any_shard_count(shards, cpu8):
    """Two and four shards give the same wave as eight and as one."""
    kins, feats = _members(3, "kitchen_sink", 383)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    pf = tp.port_features(feats)
    fo = sharded.fused_sharded_entry(
        sharded.wave_mesh(shards, devices=CPU8))[0](
            _port_kin(stacked), sm, sl, t_pad, pf)
    one = ck.fused_wave_place_reference(
        _tensors(_port_kin(stacked)), torch.from_numpy(sm),
        torch.from_numpy(sl), t_pad, pf)
    _assert_wave(_wave_host(fo, t_pad, tp.B), _wave_host(one, t_pad, tp.B),
                 exact_scores=True, ctx=f"{shards} shards")


def test_fused_sharded_refuses_outside_its_envelope(cpu8):
    kins, feats = _members(3, "spread", 200)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    fn = sharded.fused_sharded_entry(sharded.wave_mesh(devices=CPU8))[0]
    with pytest.raises(ValueError, match="envelope"):
        fn(_port_kin(stacked), sm, sl, t_pad, tp.port_features(feats))


def test_unstack_matches_reference_layout(problems, cpu8):
    k_pad = pad_steps(N_STEPS)
    out = sharded.make_place_batch(pmesh.make_mesh(8, devices=CPU8),
                                   k_pad)(
        sharded.stack_kernel_ins([_port_kin(k) for k in problems]))
    outs = sharded.unstack_kernel_outs(out)
    assert len(outs) == 4
    single = RefKernelOut(*[np.asarray(x) for x in place_taskgroup_jit(
        problems[0], k_pad)])
    for name in tk.KernelOut._fields:
        assert np.shape(getattr(outs[0], name)) == np.shape(
            getattr(single, name)), name
