"""The fused sharded wave's kernel route, on the CPU.

``ops/cuda_kernel.sharded_wave_place`` runs ``csrc/sharded_wave.cu`` on
CUDA shards and its plain version, ``parallel/sharded._sharded_wave``, on
CPU shards. Here:

- the plain route against the JAX package's ``fused_sharded_entry`` over
  D = 2, 4 and 8 of the conftest's virtual CPU devices, for the six
  variants of the fused envelope: choices, found, top-k indices, i32
  metrics and carries exact, scores within ``SCORE_ATOL`` (one f32 ulp
  at 1.0: XLA's and torch's ``pow`` may round a last bit apart);
- the argument packing of the CUDA route, run against a fake library put
  in place of ``libsharded_wave.so`` that records what it is given: the
  per-shard leaf pointers and offsets, stride 0 for shared leaves,
  positions grouped by card (a mailbox and peer access for several), and
  the active steps, which must be the reference's rule (``step_member >=
  0`` and the local step under the member's ``n_steps``) and exactly the
  steps the plain version does not give the idle outputs;
- the kernel's split of a card's rows among its cluster's CTAs, through
  the Python mirror of its plan, and a plan that does not fit raising;
- the error word a sharded wave hands back, raised by the launcher and
  counted as a failure;
- a CUDA request on a host without a card raises, and never runs the
  plain version;
- the fused-wave switch (``configure_fused_wave``), held against the JAX
  package's: off, a wave runs the composite (over a mesh, the joint
  sharded wave) and counts no fallback.

The card's own cases are in ``tests/test_torch_gpu.py``.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.ops.kernel import KernelIn as RefKernelIn
from nomad_tpu.parallel import coalesce as ref_coalesce
from nomad_tpu.parallel import sharded as ref_sharded
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import coalesce
from nomad_tpu_torch.parallel import sharded

CPU = torch.device("cpu")
SCORE_ATOL = 1.19e-7
#: the node axis of the waves: at least 256 rows (32 a shard at D=8; see
#: tests/test_torch_mesh.py on the CPU's scalar tail)
MIN_PAD = 256


def _members(seed, variant, n_nodes, b=tp.B):
    return tp.wave_members(seed, variant, n_nodes, b=b,
                           n_pad=MIN_PAD if n_nodes <= MIN_PAD else None)


def _port_shards(stacked, d, layout=(False, False, False)):
    """The stacked numpy wave placed over a d-entry CPU mesh: one KernelIn
    a node shard, as ``fused_sharded_entry`` hands them to the wrapper."""
    mesh = sharded.wave_mesh(devices=[CPU] * d)
    shardings, _ = sharded.joint_in_shardings(mesh, *layout)
    placed, _ = sharded.place_args(
        kernel_in_from_numpy(stacked, keep_numpy=True), shardings)
    return sharded._shards_of(placed, mesh.node_rows()[0])


def _ref_wave(stacked, sm, sl, t_pad, feats, d):
    """JAX's fused sharded wave over d virtual devices, as host arrays."""
    fn, kin_sh, repl = ref_sharded.fused_sharded_entry(
        ref_sharded.wave_mesh(d))
    out = fn(RefKernelIn(*[jax.device_put(x, s)
                           for x, s in zip(stacked, kin_sh)]),
             jax.device_put(sm, repl), jax.device_put(sl, repl), t_pad,
             feats)
    host = tk.unpack_fused_wave(np.asarray(out.packed), t_pad,
                                len(stacked.n_steps))
    for name in ("topk_idx", "topk_scores", "a_cpu", "a_mem", "a_disk"):
        host[name] = np.asarray(getattr(out, name))
    return host


def _port_host(out, t_pad, b):
    host = tk.unpack_fused_wave(out.packed.numpy(), t_pad, b)
    host["topk_idx"] = out.topk_idx.numpy()
    host["topk_scores"] = out.topk_scores.numpy()
    for name in ("a_cpu", "a_mem", "a_disk"):
        host[name] = torch.cat(list(getattr(out, name))).numpy()
    return host


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("variant,n_nodes", tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.FUSED_VARIANTS])
def test_plain_route_matches_jax_fused_sharded(variant, n_nodes, shards):
    kins, feats = _members(41 + shards, variant, n_nodes)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    want = _ref_wave(stacked, sm, sl, t_pad, feats, shards)
    launches = ck.sharded_launches
    out = ck.sharded_wave_place(_port_shards(stacked, shards), sm, sl,
                                t_pad, tp.port_features(feats))
    assert ck.sharded_launches == launches, "CPU shards launch nothing"
    assert len(out.a_cpu) == shards
    got = _port_host(out, t_pad, tp.B)
    for name, w in want.items():
        if name in ("scores", "topk_scores"):
            np.testing.assert_allclose(got[name], w, rtol=0, atol=SCORE_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert got["found"].any()


# ---------------------------------------------------------------------------
# The CUDA route's argument packing, against a fake library.
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """Stands in for ``sharded_wave_launch``: records the structure it is
    given, launches nothing, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, ref):
        args = ref._obj
        cards = (ck._Card * args.n_cards).from_address(args.card)
        got = {"shape": args.s, "cards": [], "spin_ns": args.spin_ns,
               "packed": args.packed}
        for c in cards:
            # CPU shards: the card's table buffer is host memory
            table = (ck._Pos * c.n_pos).from_address(c.table)
            t = args.s.t
            maps = np.ctypeslib.as_array((ctypes.c_int * (2 * t)).from_address(
                c.table + ctypes.sizeof(table))).reshape(2, t).copy()
            got["cards"].append({
                "ordinal": c.ordinal, "n_pos": c.n_pos,
                "g0": [p.g0 for p in table],
                "leaves": [list(p.leaf) for p in table],
                "a_cpu": [p.a_cpu for p in table],
                "jtc": [p.jtc for p in table], "maps": maps,
                "mail": c.mail})
        got["stride"] = list(args.s.stride)
        self.calls.append(got)
        return 0


#: the most dynamic shared memory a block takes on an H100 beside the
#: kernel's static part (what ``sharded_wave_plan`` reports there)
_H100_LIMIT = 227 * 1024 - 4096


def _mirror_plan(ordinal, n_pos, n_loc, b, shuffle, limit=_H100_LIMIT):
    """``sharded_wave_plan`` as the wrapper reads it, from the Python
    mirror of the kernel's shared-memory need."""
    return (ck.SHARDED_CLUSTER,
            ck.sharded_smem_bytes(n_pos, n_loc, b, shuffle), limit, 1)


@pytest.fixture()
def fake_library(monkeypatch):
    fake = _FakeLibrary()
    fake.peers = []
    monkeypatch.setitem(ck._LIBS, "sharded_wave", (fake, None, None))
    monkeypatch.setattr(ck, "_sharded_plan", _mirror_plan)
    monkeypatch.setattr(ck, "_enable_peers", fake.peers.append)
    return fake


def _wave_with_idle_steps():
    """A shuffle wave whose members want fewer steps than the bucket: the
    step maps hold padding (member -1) and steps past a member's count."""
    kins, feats = _members(5, "kitchen_sink", 200)
    kins = [k._replace(n_steps=np.asarray(n, np.int32))
            for k, n in zip(kins, (4, 0, 2, 3))]
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    return stacked, sm, sl, t_pad, tp.port_features(feats)


def test_packing_per_shard_pointers_offsets_and_steps(fake_library,
                                                      monkeypatch):
    stacked, sm, sl, t_pad, feats = _wave_with_idle_steps()
    shards = _port_shards(stacked, 4)
    monkeypatch.setattr(ck, "_card_of", lambda dev: (0, 0))
    launches = ck.sharded_launches
    out = ck._sharded_launch(shards, sm, sl, t_pad, feats)
    assert ck.sharded_launches == launches + 1
    (call,) = fake_library.calls
    n_loc = int(shards[0].cap_cpu.shape[-1])
    shape = call["shape"]
    assert (shape.n_loc, shape.n_glob, shape.b) == (n_loc, 4 * n_loc, tp.B)
    assert shape.t == t_pad and shape.bp == tp.B
    assert call["spin_ns"] == int(ck.SPIN_S * 1e9)
    # the packed layout and one error word, on the root
    assert call["packed"] == out.packed.data_ptr()
    assert out.packed.numel() == tk.fused_pack_len(t_pad, tp.B) + 1
    # a virtual mesh: one card holds every position, and has no mailbox
    (card,) = call["cards"]
    assert (card["ordinal"], card["n_pos"]) == (0, 4)
    assert card["mail"] is None
    assert fake_library.peers == []
    assert card["g0"] == [p * n_loc for p in range(4)]
    for p, leaves in enumerate(card["leaves"]):
        assert leaves == [getattr(shards[p], name).data_ptr()
                          for name, _ in ck._LEAVES]
    assert card["a_cpu"] == [t.data_ptr() for t in out.a_cpu]
    # each position's scratch: its own slice of the card's buffer
    jtc = card["jtc"]
    assert [q - jtc[0] for q in jtc] == [4 * p * tp.B * n_loc
                                         for p in range(4)]
    # every leaf stacked: a member stride of its per-member size
    for (name, _), stride in zip(ck._LEAVES, call["stride"]):
        assert stride == getattr(shards[0], name)[0].numel(), name
    # the step maps after the card's position table, and the active
    # steps the kernel finds in them (its rule mirrored by
    # wave_active_steps, over the n_steps leaf it is handed): the
    # reference's rule, computed apart
    np.testing.assert_array_equal(card["maps"], np.stack([sm, sl]))
    n_steps = stacked.n_steps
    m = np.clip(sm, 0, tp.B - 1)
    active = np.nonzero((sm >= 0) & (sl < n_steps[m]))[0]
    n_steps_leaf = ck._LEAVES.index(("n_steps", torch.int32))
    assert card["leaves"][0][n_steps_leaf] == shards[0].n_steps.data_ptr()
    kernel_rule = ck.wave_active_steps(card["maps"][0], card["maps"][1],
                                       shards[0].n_steps, t_pad, tp.K)
    assert [t for t, _, _ in kernel_rule] == active.tolist()
    assert [(mm, j) for _, mm, j in kernel_rule] == [
        (int(m[t]), int(sl[t])) for t in active]
    assert len(active) == 9
    # and the plain version's idle steps are exactly the others
    plain = ck.sharded_wave_place(shards, sm, sl, t_pad, feats)
    host = tk.unpack_fused_wave(plain.packed.numpy(), t_pad, tp.B)
    idle = np.setdiff1d(np.arange(t_pad), active)
    assert not host["found"][idle].any()
    assert (plain.topk_idx.numpy()[idle] == np.arange(tk.TOPK)).all()
    assert (plain.topk_scores.numpy()[idle] == tk.NEG_INF).all()
    assert host["found"][active].any()


class _FakeJointLibrary:
    """Stands in for ``joint_sharded_wave_launch``: records the shape, the
    cards and each card's table (one JointArgs a position, the first
    global rows, the step maps), launches nothing, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, ref):
        a = ref._obj
        cards = (ck._JCard * a.n_cards).from_address(a.card)
        got = {"shape": (a.n_glob, a.n_loc, a.n_cards, a.b, a.t, a.p, a.ns,
                         a.with_shuffle),
               "clusters": a.clusters, "absent": a.absent,
               "spin_ns": a.spin_ns, "packed": a.packed, "cards": []}
        for c in cards:
            table = (ck._JointArgs * c.n_pos).from_address(c.table)
            at = c.table + ctypes.sizeof(table)
            g0 = list((ctypes.c_int * ck.MAX_POSITIONS).from_address(at))
            maps = np.ctypeslib.as_array(
                (ctypes.c_int * (2 * a.t)).from_address(
                    at + 4 * ck.MAX_POSITIONS)).reshape(2, a.t).copy()
            got["cards"].append({
                "n_pos": c.n_pos, "g0": g0[:c.n_pos], "maps": maps,
                "mail": c.mail, "spc": c.spc, "rows": c.rows,
                "leaves": [list(p.leaf) for p in table],
                "strides": [list(p.stride) for p in table],
                "shape": [(p.n, p.b, p.t, p.k, p.p, p.bp, p.ns, p.single,
                           p.rows) for p in table],
                "flags": [(p.with_topk, p.with_ports, p.with_distinct,
                           p.with_shuffle, p.with_devices, p.with_cores,
                           p.with_network) for p in table],
                "a_cpu": [p.a_cpu for p in table],
                "a_dev": [p.a_dev for p in table],
                "jtc": [p.jtc for p in table]})
        self.calls.append(got)
        return 0


def test_joint_packing_one_jointargs_a_position(monkeypatch):
    """The joint sharded kernel's arguments: each position's JointArgs
    holds its own shard's leaves (node planes, spread buckets and device
    planes its rows), the shape with ``n`` its rows, the flags, and its
    own slices of the card's carries and scratch; the first global rows
    and the step maps follow the table; the plan's one cluster on one
    card: a counts scratch where the wave spreads, no mailbox and no
    global-row scratch."""
    fake = _FakeJointLibrary()
    monkeypatch.setitem(ck._LIBS, "joint_sharded_wave", (fake, None, None))
    monkeypatch.setattr(ck, "_joint_sharded_card",
                        lambda o: (_H100_LIMIT, 7))
    monkeypatch.setattr(ck, "_card_of", lambda dev: (0, 0))
    monkeypatch.setattr(ck, "_enable_peers",
                        lambda c: pytest.fail("one card needs no peers"))
    kins, feats = _members(6, "everything", 200)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    pf = tp.port_features(feats)
    shards = _port_shards(stacked, 4)
    launches = ck.joint_sharded_launches
    out = ck._joint_sharded_launch(shards, sm, sl, t_pad, pf)
    assert ck.joint_sharded_launches == launches + 1
    (call,) = fake.calls
    n_loc = int(shards[0].cap_cpu.shape[-1])
    assert call["shape"] == (4 * n_loc, n_loc, 1, tp.B, t_pad,
                             tk.MAX_PENALTY_NODES, pf.n_spreads, 1)
    assert call["packed"] == out.packed.data_ptr()
    assert out.packed.numel() == tk.fused_pack_len(t_pad, tp.B) + 1
    assert (call["clusters"], call["absent"]) == (1, -1)
    assert call["spin_ns"] == int(ck.SPIN_S * 1e9)
    (card,) = call["cards"]
    assert card["n_pos"] == 4 and card["mail"] is None
    assert card["spc"] is not None and card["rows"] is None
    assert card["g0"] == [p * n_loc for p in range(4)]
    np.testing.assert_array_equal(card["maps"], np.stack([sm, sl]))
    for p in range(4):
        assert card["leaves"][p] == [getattr(shards[p], name).data_ptr()
                                     for name, _ in ck._JOINT_LEAVES]
        assert card["strides"][p] == card["strides"][0]
        assert card["shape"][p] == (n_loc, tp.B, t_pad, tp.K,
                                    tk.MAX_PENALTY_NODES, tp.B,
                                    pf.n_spreads, 0, None)
        assert card["flags"][p] == (1, 1, 1, 1, 1, 1, 1)
    for (name, _), stride in zip(ck._JOINT_LEAVES, card["strides"][0]):
        assert stride == getattr(shards[0], name)[0].numel(), name
    assert card["a_cpu"] == [t.data_ptr() for t in out.a_cpu]
    jtc, dev = card["jtc"], card["a_dev"]
    assert [q - jtc[0] for q in jtc] == [4 * p * tp.B * n_loc
                                         for p in range(4)]
    assert [q - dev[0] for q in dev] == [4 * p * n_loc * 4
                                         for p in range(4)]


def test_joint_wrapper_takes_cpu_shards_to_its_plain_version():
    """CPU shards run ``_sharded_wave`` packed, whatever the union; a
    union past MAX_SPREADS raises."""
    kins, feats = _members(7, "spread", 200)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    pf = tp.port_features(feats)
    shards = _port_shards(stacked, 4)
    launches = ck.joint_sharded_launches
    got = ck.joint_sharded_wave_place(shards, sm, sl, t_pad, pf)
    assert ck.joint_sharded_launches == launches
    want = ck.joint_sharded_wave_place_reference(shards, sm, sl, t_pad, pf)
    np.testing.assert_array_equal(got.packed.numpy(), want.packed.numpy())
    with pytest.raises(ValueError, match="n_spreads"):
        ck.joint_sharded_wave_place(shards, sm, sl, t_pad,
                                    pf._replace(n_spreads=5))


def test_packing_shared_leaves_have_stride_zero(fake_library, monkeypatch):
    """A wave whose three sharing groups ship unbatched (the live stack's
    layout): those leaves' member strides are 0, the stacked ones' their
    per-member size."""
    stacked, sm, sl, t_pad, feats = _wave_with_idle_steps()
    layout = (True, True, True)
    first = tk.KernelIn(*[
        x[0] if coalesce.wave_field_is_shared(name, *layout) else x
        for name, x in zip(tk.KernelIn._fields, stacked)])
    shards = _port_shards(first, 2, layout)
    monkeypatch.setattr(ck, "_card_of", lambda dev: (0, 0))
    ck._sharded_launch(shards, sm, sl, t_pad, feats)
    (call,) = fake_library.calls
    shared = 0
    for (name, _), stride in zip(ck._LEAVES, call["stride"]):
        if coalesce.wave_field_is_shared(name, *layout):
            assert stride == 0, name
            shared += 1
        else:
            assert stride == getattr(shards[0], name)[0].numel(), name
    assert shared >= 10


def test_packing_groups_repeated_cards(fake_library, monkeypatch):
    """Positions on cards 0, 1, 0, 1: two cards, the root (position 0's)
    first holding positions 0 and 2 in ascending order, each card with a
    mailbox, peer access asked for the pair."""
    stacked, sm, sl, t_pad, feats = _wave_with_idle_steps()
    shards = _port_shards(stacked, 4)
    ordinals = iter([0, 1, 0, 1])
    monkeypatch.setattr(ck, "_card_of", lambda dev: (next(ordinals), 0))
    ck._sharded_launch(shards, sm, sl, t_pad, feats)
    (call,) = fake_library.calls
    n_loc = int(shards[0].cap_cpu.shape[-1])
    assert [(c["ordinal"], c["n_pos"]) for c in call["cards"]] \
        == [(0, 2), (1, 2)]
    assert [c["g0"] for c in call["cards"]] == [[0, 2 * n_loc],
                                                [n_loc, 3 * n_loc]]
    assert all(c["mail"] for c in call["cards"])
    np.testing.assert_array_equal(call["cards"][0]["maps"],
                                  call["cards"][1]["maps"])
    assert fake_library.peers == [(0, 1)]
    assert ck.group_positions(["a", "b", "a", "c", "b"]) == [
        ("a", [0, 2]), ("b", [1, 4]), ("c", [3])]


def test_packing_refuses_what_the_kernel_does_not_take(fake_library,
                                                      monkeypatch):
    stacked, sm, sl, t_pad, feats = _wave_with_idle_steps()
    monkeypatch.setattr(ck, "_card_of", lambda dev: (0, 0))
    shards = _port_shards(stacked, 4)
    bad = [shards[0]._replace(cap_cpu=shards[0].cap_cpu.double())] \
        + shards[1:]
    with pytest.raises(ValueError, match="dtype"):
        ck._sharded_launch(bad, sm, sl, t_pad, feats)
    narrow = [s._replace(cap_mem=s.cap_mem[..., :-1].contiguous())
              for s in shards]
    with pytest.raises(ValueError, match="rows"):
        ck._sharded_launch(narrow, sm, sl, t_pad, feats)
    with pytest.raises(ValueError, match="floor"):
        ck._sharded_launch(_port_shards(stacked, 64), sm, sl, t_pad, feats)
    assert fake_library.calls == []


def test_failed_call_raises_and_counts_no_launch(fake_library,
                                                 monkeypatch):
    """A C call that returns an error (a launch refused on one card after
    others were launched, which the C side has joined first) raises, and
    the wave is not counted as a sharded launch."""
    stacked, sm, sl, t_pad, feats = _wave_with_idle_steps()
    shards = _port_shards(stacked, 4)
    ordinals = iter([0, 1, 0, 1])
    monkeypatch.setattr(ck, "_card_of", lambda dev: (next(ordinals), 0))

    def refused(ref):
        fake_library(ref)
        return 1  # cudaErrorInvalidValue

    monkeypatch.setitem(ck._LIBS, "sharded_wave", (refused, None, None))
    launches = ck.sharded_launches
    with pytest.raises(RuntimeError, match="cudaError 1"):
        ck._sharded_launch(shards, sm, sl, t_pad, feats)
    assert ck.sharded_launches == launches
    (call,) = fake_library.calls
    assert [c["ordinal"] for c in call["cards"]] == [0, 1]


# ---------------------------------------------------------------------------
# The row partition: each card's rows among its cluster's CTAs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cards,d,n_loc", [
    ([0] * 4, 4, 1001),             # a virtual mesh; ranges cross at 1001
    ([0] * 16, 16, 32),             # D=16 on one card: a CTA a position
    ([0] * 3, 3, 1000),             # a boundary inside CTA 5's range
    ([0, 1, 0, 1], 4, 777),         # interleaved cards
    ([0, 1, 2, 3], 4, 10),          # one position a card, CTAs left empty
], ids=["virtual-d4", "virtual-d16", "virtual-d3", "interleaved",
        "one-a-card"])
def test_row_plan_owns_every_row_once(cards, d, n_loc):
    """Through the Python mirror of the kernel's split: every global row
    is owned by exactly one CTA of its card, and a CTA range that crosses
    a position boundary maps each row to its own position and g0."""
    owner = {}
    crossings = inside = 0
    for card, positions in ck.group_positions(cards):
        chunk = -(-len(positions) * n_loc // ck.SHARDED_CLUSTER)
        # position boundaries that fall inside a CTA's range
        inside += sum(p * n_loc % chunk != 0
                      for p in range(1, len(positions)))
        g0s = [p * n_loc for p in positions]
        plan = ck.sharded_row_plan(g0s, n_loc)
        assert len(plan) == ck.SHARDED_CLUSTER
        card_row = 0
        for cta, segs in enumerate(plan):
            crossings += len(segs) > 1
            for lp, x_lo, x_hi, g0 in segs:
                assert g0 == positions[lp] * n_loc
                # segments walk the card's rows in order, within a position
                assert lp * n_loc + x_lo == card_row
                assert 0 <= x_lo < x_hi <= n_loc
                for x in range(x_lo, x_hi):
                    g = g0 + x
                    assert g not in owner, g
                    owner[g] = (card, cta)
                card_row += x_hi - x_lo
        assert card_row == len(positions) * n_loc
    assert sorted(owner) == list(range(d * n_loc))
    assert crossings == inside


def test_row_plan_crosses_a_boundary_off_the_warp_grid():
    """N=4004 over four virtual shards: CTA 3's range [753, 1004) holds
    the last rows of position 0 and the first of position 1, the
    boundary at row 1001 (not a multiple of 32)."""
    plan = ck.sharded_row_plan([0, 1001, 2002, 3003], 1001)
    assert plan[3] == [(0, 753, 1001, 0), (1, 0, 3, 1001)]
    assert 1001 % 32 != 0


def test_plan_that_does_not_fit_raises(fake_library, monkeypatch):
    """A card whose rows' score keys overflow a CTA's shared memory: the
    wrapper raises before any launch, as B1's plan does."""
    rows, b = 131072, 32
    need = ck.sharded_smem_bytes(8, rows // 8, b, True)
    assert need == 8 * 272 + 8192 * 8 + b * 28
    ck.check_sharded_plan((16, need, need, 1), rows, b)   # fits exactly
    with pytest.raises(ValueError, match="do not fit"):
        ck.check_sharded_plan((16, need, need - 1, 1), rows, b)
    with pytest.raises(RuntimeError, match="no cluster"):
        ck.check_sharded_plan((16, need, need, 0), rows, b)
    stacked, sm, sl, t_pad, feats = _wave_with_idle_steps()
    monkeypatch.setattr(ck, "_card_of", lambda dev: (0, 0))
    monkeypatch.setattr(ck, "_sharded_plan",
                        lambda *a: _mirror_plan(*a, limit=64))
    with pytest.raises(ValueError, match="do not fit"):
        ck._sharded_launch(_port_shards(stacked, 4), sm, sl, t_pad, feats)
    assert fake_library.calls == []


def test_cards_without_peer_access_raise(monkeypatch):
    """A mesh over two cards that cannot reach each other's memory: the
    wrapper raises before any launch; no quiet return to another route."""
    class Lib:
        def sharded_wave_enable_peers(self, ordinals, n, bad):
            bad[0], bad[1] = ordinals[0], ordinals[1]
            return -1

    monkeypatch.setitem(ck._LIBS, "sharded_wave", (None, None, Lib()))
    monkeypatch.setattr(ck, "_PEERS", set())
    with pytest.raises(RuntimeError, match="cards 0 and 1 cannot access"):
        ck._enable_peers((0, 1))
    assert ck._PEERS == set()
    ck._enable_peers((3,))            # one card: nothing to enable


def test_error_word_raises_and_counts_a_failure(monkeypatch):
    """The kernel's trailing error word (a card waited past the bound)
    reaches the launcher with the packed readback: the wave raises and
    counts one failure; a clear word and B1's buffer pass."""
    t_pad, b = 16, 4
    n = tk.fused_pack_len(t_pad, b)
    ck.raise_on_wave_error(np.zeros(n), t_pad, b)
    ck.raise_on_wave_error(np.zeros(n + 1), t_pad, b)
    bad = np.zeros(n + 1)
    bad[n] = 0b101
    with pytest.raises(RuntimeError, match=r"cards \[0, 2\]"):
        ck.raise_on_wave_error(bad, t_pad, b)

    real = sharded.sharded_wave_place

    def failing(*a, **k):
        out = real(*a, **k)
        flag = torch.tensor([1.0], dtype=out.packed.dtype)
        return out._replace(packed=torch.cat([out.packed, flag]))

    monkeypatch.setattr(sharded, "sharded_wave_place", failing)
    _, _, kins, feats, steps = _switch_wave(seed=11)
    coalesce.fused_wave_stats.reset()
    try:
        with pytest.raises(RuntimeError, match="ran past"):
            coalesce.launch_wave(kins, steps, feats, device="cpu",
                                 mesh=sharded.wave_mesh(devices=[CPU] * 2))
        assert coalesce.fused_wave_stats.snapshot()["failures"] == 1
    finally:
        coalesce.fused_wave_stats.reset()
        coalesce.sharded_wave_stats.reset()


def test_cuda_request_without_a_card_raises(monkeypatch):
    """A mesh of CUDA devices on a host without one fails at once; the
    plain version never runs in the kernel's place."""
    ran = []
    real = sharded._sharded_wave

    def counted(*a, **k):
        ran.append(1)
        return real(*a, **k)

    monkeypatch.setattr(sharded, "_sharded_wave", counted)
    stacked, sm, sl, t_pad, feats = _wave_with_idle_steps()
    mesh = sharded.wave_mesh(devices=[torch.device("cuda", 0)] * 2)
    fn = sharded.fused_sharded_entry(mesh)[0]
    with pytest.raises((RuntimeError, AssertionError)):
        fn(kernel_in_from_numpy(stacked, keep_numpy=True), sm, sl, t_pad,
           feats)
    # CPU shards handed to the CUDA route: no card to launch on
    with pytest.raises((RuntimeError, AssertionError)):
        ck._sharded_launch(_port_shards(stacked, 2), sm, sl, t_pad, feats)
    assert ran == []


# ---------------------------------------------------------------------------
# The fused-wave switch, against the JAX package's.
# ---------------------------------------------------------------------------

@pytest.fixture()
def switch():
    """Both packages' switches and wave counters given back as they were."""
    prior = (coalesce.fused_wave_enabled(), ref_coalesce.fused_wave_enabled())
    yield
    coalesce.configure_fused_wave(prior[0])
    ref_coalesce.configure_fused_wave(prior[1])
    for mod in (coalesce, ref_coalesce):
        mod.fused_wave_stats.reset()
        mod.sharded_wave_stats.reset()


def _switch_wave(seed=9):
    ref_kins, ref_feats = _members(seed, "kitchen_sink", 383)
    kins = [kernel_in_from_numpy(k, keep_numpy=True) for k in ref_kins]
    return (ref_kins, [ref_feats] * len(kins), kins,
            [tp.port_features(ref_feats)] * len(kins), [tp.K] * len(kins))


def _same(a_outs, b_outs, exact=True):
    for a, b in zip(a_outs, b_outs):
        for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)), name)
        np.testing.assert_allclose(np.asarray(a.scores), np.asarray(b.scores),
                                   rtol=0, atol=0 if exact else SCORE_ATOL)


@pytest.mark.parametrize("on", [True, False])
def test_fused_switch_routes_and_counts_as_the_reference(on, switch):
    """One wave with the switch on and off in both packages: on, one fused
    launch; off, the composite and no fallback; the same placements
    either way and in both packages."""
    ref_kins, ref_feats, kins, feats, steps = _switch_wave()
    coalesce.configure_fused_wave(on)
    ref_coalesce.configure_fused_wave(on)
    assert coalesce.fused_wave_enabled() is on
    for mod in (coalesce, ref_coalesce):
        mod.fused_wave_stats.reset()
    port = coalesce.launch_wave(kins, steps, feats, device="cpu")
    ref = ref_coalesce.launch_wave(ref_kins, steps, ref_feats, mesh=None)
    _same(port, ref, exact=False)
    want = {"launches": int(on), "fallbacks": 0}
    assert ref_coalesce.fused_wave_stats.snapshot() == want
    assert coalesce.fused_wave_stats.snapshot() == dict(want, failures=0)
    # the composite and the fused wave place alike
    coalesce.configure_fused_wave(not on)
    _same(coalesce.launch_wave(kins, steps, feats, device="cpu"), port)


def test_fused_switch_off_runs_the_joint_sharded_wave(switch):
    """Off, a wave over a mesh runs the joint sharded wave: still one
    sharded launch, no fused launch or fallback, as the reference's."""
    ref_kins, ref_feats, kins, feats, steps = _switch_wave(seed=10)
    coalesce.configure_fused_wave(False)
    ref_coalesce.configure_fused_wave(False)
    for mod in (coalesce, ref_coalesce):
        mod.fused_wave_stats.reset()
        mod.sharded_wave_stats.reset()
    port = coalesce.launch_wave(
        kins, steps, feats, device="cpu",
        mesh=sharded.wave_mesh(devices=[CPU] * 8))
    ref = ref_coalesce.launch_wave(ref_kins, steps, ref_feats,
                                   mesh=ref_sharded.wave_mesh(8))
    _same(port, ref, exact=False)
    assert coalesce.fused_wave_stats.snapshot() == {
        "launches": 0, "fallbacks": 0, "failures": 0}
    assert ref_coalesce.fused_wave_stats.snapshot() == {
        "launches": 0, "fallbacks": 0}
    assert coalesce.sharded_wave_stats.snapshot()["launches"] == 1 == \
        ref_coalesce.sharded_wave_stats.snapshot()["launches"]


# ---------------------------------------------------------------------------
# The routes: a wave or an eval the sharded kernel's cluster cannot hold
# goes to the joint sharded kernel, decided from the plan before a launch.
# ---------------------------------------------------------------------------

def test_sharded_wave_fits_checks_every_card(monkeypatch):
    """``sharded_wave_fits`` asks the sharded kernel's plan of each card
    for its own positions: it holds a wave only where every card's rows
    fit one cluster's shared memory; CPU devices hold any width."""
    asked = []

    def plan(ordinal, n_pos, n_loc, b, shuffle):
        asked.append((ordinal, n_pos, n_loc))
        return _mirror_plan(ordinal, n_pos, n_loc, b, shuffle)

    monkeypatch.setattr(ck, "_sharded_plan", plan)
    monkeypatch.setattr(ck, "_card_of", lambda dev: (dev.index, 0))
    two = [torch.device("cuda", i) for i in (0, 1, 0, 1)]
    one = [torch.device("cuda", 0)] * 4
    b = tp.B
    # two positions a card of 2**17 rows fit; four on one card do not
    assert ck.sharded_wave_fits(two, 1 << 17, b, True)
    assert asked == [(0, 2, 1 << 17), (1, 2, 1 << 17)]
    assert not ck.sharded_wave_fits(one, 1 << 17, b, True)
    assert not ck.sharded_wave_fits(two, 1 << 18, b, True)
    # without shuffle a row takes 4 B, not 8
    assert ck.sharded_wave_fits(one, 1 << 17, b, False)
    assert ck.sharded_wave_fits([CPU] * 4, 1 << 22, b, True)
    for n_loc in (1 << 16, 1 << 17, 1 << 18):
        need = ck.sharded_smem_bytes(4, n_loc, b, True)
        assert ck.sharded_wave_fits(one, n_loc, b, True) == (
            need <= _H100_LIMIT)


def _wide_wave_stats():
    return (coalesce.fused_wave_stats.snapshot(),
            coalesce.joint_wave_stats.snapshot(),
            coalesce.sharded_wave_stats.snapshot()["launches"])


def _count_joint_sharded(monkeypatch):
    """Count the joint sharded kernel's wrapper calls; the sharded
    kernel's wrapper fails the test if it is called."""
    calls = []
    real = sharded.joint_sharded_wave_place
    monkeypatch.setattr(sharded, "joint_sharded_wave_place",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(
        sharded, "sharded_wave_place",
        lambda *a, **k: pytest.fail("the sharded kernel cannot hold it"))
    return calls


def test_wave_past_the_sharded_plan_runs_the_joint_sharded_kernel(
        switch, monkeypatch):
    """A mesh wave in the fused envelope whose cards' rows the sharded
    kernel's cluster does not hold (its plan answering so, as a card's
    does at N=524288 over four positions): ``launch_wave`` runs the joint
    sharded kernel, one counted fused fallback and one sharded launch;
    the members' outputs equal the JAX package's wave over the same mesh
    (i32 exact, scores within one f32 ulp)."""
    ref_kins, ref_feats, kins, feats, steps = _switch_wave(seed=12)
    asked = []

    def fits(devices, n_loc, b, shuffle):
        asked.append((len(devices), n_loc, b))
        return False

    monkeypatch.setattr(coalesce, "sharded_wave_fits", fits)
    calls = _count_joint_sharded(monkeypatch)
    for mod in (coalesce, ref_coalesce):
        mod.fused_wave_stats.reset()
        mod.sharded_wave_stats.reset()
    coalesce.joint_wave_stats.reset()
    port = coalesce.launch_wave(kins, steps, feats, device="cpu",
                                mesh=sharded.wave_mesh(devices=[CPU] * 4))
    ref = ref_coalesce.launch_wave(ref_kins, steps, ref_feats,
                                   mesh=ref_sharded.wave_mesh(4))
    _same(port, ref, exact=False)
    n_pad = int(kins[0].cap_cpu.shape[-1])
    assert asked == [(4, n_pad // 4, len(kins))]
    assert calls == [1]
    # the joint sharded wave on CPU shards: its plain version, counted
    # as a torch-op wave (on the card, a sharded launch)
    assert _wide_wave_stats() == (
        {"launches": 0, "fallbacks": 1, "failures": 0},
        {"launches": 0, "sharded_launches": 0, "global_rows": 0,
         "torch_waves": 1}, 1)
    assert ref_coalesce.fused_wave_stats.snapshot()["launches"] == 1
    coalesce.joint_wave_stats.reset()


def test_warm_mesh_pass_past_the_sharded_plan_warms_the_joint_sharded(
        monkeypatch):
    """The warm mesh pass makes ``launch_wave``'s choice: a lean entry the
    sharded kernel's plan does not hold warms the joint sharded kernel,
    once; held, the sharded kernel."""
    from nomad_tpu_torch.ops import warmup

    feats = tk.LEAN_FEATURES._replace(with_topk=True)
    entry = {"kernel": "joint", "wave": 4, "steps": 64, "nodes": 256,
             "shared": True, "neutral_shared": True, "job_shared": True,
             "features": dict(feats._asdict())}
    mesh = sharded.wave_mesh(devices=[CPU] * 4)
    warmup.warmup_stats.reset()
    assert warmup.warmup_entries([entry], device="cpu", mesh=mesh,
                                 mesh_only=True) == (1, 0)
    assert warmup.warmup_stats.snapshot() == {"fused_wave_sharded": 1}
    asked = []

    def fits(devices, n_loc, b, shuffle):
        asked.append((len(devices), n_loc, b))
        return False

    monkeypatch.setattr(coalesce, "sharded_wave_fits", fits)
    calls = _count_joint_sharded(monkeypatch)
    warmup.warmup_stats.reset()
    assert warmup.warmup_entries([entry], device="cpu", mesh=mesh,
                                 mesh_only=True) == (1, 0)
    assert asked == [(4, 64, 4)] and calls == [1]
    assert warmup.warmup_stats.snapshot() == {"joint_sharded": 1}
    warmup.warmup_stats.reset()
