"""The joint sharded kernel's plan and packing, on the CPU.

``ops/cuda_kernel.joint_sharded_clusters`` picks how many clusters of 16
CTAs each card of a mesh spreads its rows over, from the most rows a card
holds, the wave's widths, the mesh's cards and the cards' figures (the
shared memory a block may take, the clusters one holds at once), and where
the CTAs keep their rows; ``joint_sharded_layout`` sizes the scratch and
the mailbox. Both are pure functions, held here without a card over every
width below 2**24; ``sharded_row_plan`` mirrors how the kernel's CTAs walk
a card's rows segment by segment across the positions. The wrapper's
packing of a plan of several clusters, and of its global-row
instantiation, is held against a fake library. The kernel itself
(csrc/joint_sharded_wave.cu) runs in tests/test_torch_gpu.py, which also
holds this layout against the C side's.
"""

import ctypes

import pytest
import torch

import _torch_parity as tp
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import sharded

#: an H100's figures for the joint sharded kernel: the dynamic shared
#: memory a block may take (the opt-in limit less its static part), and
#: a co-resident count of clusters of 16
LIMIT = 232448 - 12576
MOST = 7
#: rows a card: every power of two to 2**23 and some widths between
ROWS = [1 << e for e in range(2, 24)] + [1000, 4004, 40000, 300000,
                                         (1 << 24) - 1]
MEMBER = 32 * (len(tk.FUSED_METRIC_FIELDS) + 1) * 4


def _plan(rows, b=32, shuffle=True, ns=4, limit=LIMIT, most=MOST,
          n_cards=1):
    return ck.joint_sharded_clusters(rows, b, shuffle, ns, limit, most,
                                     n_cards)


@pytest.mark.parametrize("n_cards", [1, 2, 4, 8])
@pytest.mark.parametrize("most", [1, 3, 7, 8, 20])
def test_clusters_grow_with_the_cards_rows_to_the_card(most, n_cards):
    """One cluster a card while a CTA's range stays at or under the rows
    of its kind of wave (cached, or with a spread stanza), past that every
    cluster a card holds, at most the kernel's most and at most 32
    participants over the cards; never fewer for a wider card."""
    cap = min(most, ck.JOINT_MAX_CLUSTERS, 32 // n_cards)
    for ns in (0, 1, 4):
        per_cta = (ck.JOINT_SHARDED_ROWS_SPREAD if ns
                   else ck.JOINT_SHARDED_ROWS_CACHED)
        last = 0
        for rows in sorted(ROWS):
            c = _plan(rows, ns=ns, most=most, n_cards=n_cards).clusters
            assert c == (1 if -(-rows // 16) <= per_cta else cap), (rows, c)
            assert c >= last and c * n_cards <= ck.JOINT_SHARDED_MAX_PARTS
            last = c
        assert last == cap


@pytest.mark.parametrize("ns", [0, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_rows_stay_in_shared_memory_while_the_clusters_hold_them(shuffle,
                                                                 ns):
    """A CTA keeps its card rows (13 B a row with shuffle, a bucket byte a
    stanza more) in shared memory wherever the plan's clusters hold them,
    N=524288 on one card and N=1048576 over four cards included; past
    that the global-row scratch, and never back for a wider card."""
    for n_cards in (1, 4):
        seen_global = False
        for rows in sorted(ROWS):
            p = _plan(rows, shuffle=shuffle, ns=ns, n_cards=n_cards)
            need = ck._joint_cta_rows(rows, p.clusters, shuffle, ns)
            assert (p.global_rows == 0) == (need + MEMBER <= LIMIT), rows
            assert p.smem == (MEMBER if p.global_rows else need + MEMBER)
            assert not (seen_global and p.global_rows == 0), rows
            seen_global = seen_global or p.global_rows > 0
        assert seen_global
    assert _plan(1 << 19, shuffle=shuffle, ns=ns).global_rows == 0
    assert _plan(1 << 18, shuffle=shuffle, ns=ns, n_cards=4).global_rows == 0


@pytest.mark.parametrize("n_cards", [1, 2, 4])
@pytest.mark.parametrize("clusters", [1, 2, 5, 7])
@pytest.mark.parametrize("ns", [0, 2])
def test_scratch_and_mailbox_scale_with_the_clusters(clusters, ns, n_cards):
    """The counts scratch and the global-row scratch are sized a card for
    clusters x 16 CTAs; the mailbox a card has a slot for each of the
    wave's cards x clusters participants, and there is none with one."""
    b = 32
    ctas = 16 * clusters
    for rows, limit in ((300000, LIMIT), (1 << 22, LIMIT), (5000, 2000)):
        p = ck.joint_sharded_layout(rows, b, True, ns, limit, clusters,
                                    n_cards)
        assert p.clusters == clusters
        assert p.spc == (ctas * b * tk.MAX_SPREADS * tk.SPREAD_BUCKETS
                         if ns else 0)
        stride = (ck._joint_cta_rows(rows, clusters, True, ns) + 15) & ~15
        assert p.global_rows in (0, ctas * stride)
        parts = clusters * n_cards
        assert p.mail == (2 * parts * 96 + parts * (2 + 8 * b) * 4
                          if parts > 1 else 0)


@pytest.mark.parametrize("clusters", [1, 2, 3, 7])
@pytest.mark.parametrize("cards,n_loc", [
    ([0] * 4, 1001),             # a virtual mesh, edges off the warp grid
    ([0] * 4, 4096),             # the live width, D=4
    ([0] * 16, 32),              # D=16: many positions a range
    ([0] * 64, 1),               # 64 positions of one row
    ([0] * 64, 7),
    ([0, 1, 0, 1], 777),         # interleaved cards
    ([0, 1, 2, 3], 10),          # one position a card, CTAs left empty
], ids=["virtual-d4", "live-d4", "virtual-d16", "d64-one-row", "d64",
        "interleaved", "one-a-card"])
def test_segments_own_every_card_row_once(cards, n_loc, clusters):
    """Through the Python mirror of the kernel's split over clusters x 16
    CTAs: every global row is owned by exactly one CTA of its card, a
    range that crosses positions walks one segment a position with that
    position's first global row, and no range touches more positions than
    the kernel's segment table holds (MAX_SEGS, 5)."""
    ctas = 16 * clusters
    owner = {}
    most = 0
    for card, positions in ck.group_positions(cards):
        g0s = [p * n_loc for p in positions]
        plan = ck.sharded_row_plan(g0s, n_loc, ctas)
        assert len(plan) == ctas
        card_row = 0
        for cta, segs in enumerate(plan):
            most = max(most, len(segs))
            for lp, x_lo, x_hi, g0 in segs:
                assert g0 == positions[lp] * n_loc
                assert lp * n_loc + x_lo == card_row
                assert 0 <= x_lo < x_hi <= n_loc
                for x in range(x_lo, x_hi):
                    assert g0 + x not in owner, g0 + x
                    owner[g0 + x] = (card, cta)
                card_row += x_hi - x_lo
        assert card_row == len(positions) * n_loc
    assert sorted(owner) == list(range(len(cards) * n_loc))
    assert most <= 5


@pytest.mark.parametrize("n_cards", [1, 2, 4, 8])
def test_no_width_below_2_24_is_refused(n_cards):
    """Every card width below 2**24 nodes gets a plan, whatever the
    stanzas, members and shuffle: its rows in shared memory or in the
    global scratch. Only a card that runs no cluster, or members whose
    sums alone overflow a block, are refused."""
    for rows in ROWS:
        for b, shuffle, ns in ((1, False, 0), (32, True, 4), (256, True, 1)):
            p = _plan(rows, b=b, shuffle=shuffle, ns=ns, n_cards=n_cards)
            assert p.clusters >= 1 and p.smem <= LIMIT
    with pytest.raises(RuntimeError, match="no cluster"):
        _plan(1024, most=0)
    with pytest.raises(RuntimeError, match="shared memory a CTA"):
        _plan(1024, b=8192)


# ---------------------------------------------------------------------------
# The wrapper's packing of the plan, against a fake library.
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for ``joint_sharded_wave_launch``: records the plan's
    clusters and each card's buffers, launches nothing, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, ref):
        a = ref._obj
        cards = (ck._JCard * a.n_cards).from_address(a.card)
        self.calls.append({
            "clusters": a.clusters, "absent": a.absent,
            "n_cards": a.n_cards,
            "cards": [(c.ordinal, c.n_pos, c.mail is not None,
                       c.spc is not None, c.rows is not None)
                      for c in cards]})
        return 0


def _wave(variant, n_nodes, n_pad, d):
    kins, feats = tp.wave_members(70, variant, n_nodes, lib="port",
                                  n_pad=n_pad)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    mesh = sharded.wave_mesh(devices=[torch.device("cpu")] * d)
    shardings, _ = sharded.joint_in_shardings(mesh)
    from nomad_tpu_torch.convert import kernel_in_from_numpy
    placed, _ = sharded.place_args(
        kernel_in_from_numpy(stacked, keep_numpy=True), shardings)
    return (sharded._shards_of(placed, mesh.node_rows()[0]), sm, sl, t_pad,
            feats)


@pytest.fixture()
def recorder(monkeypatch):
    fake = _Recorder()
    monkeypatch.setitem(ck._LIBS, "joint_sharded_wave", (fake, None, None))
    monkeypatch.setattr(ck, "_enable_peers", lambda cards: None)
    return fake


@pytest.mark.parametrize("ordinals,n_pad,clusters", [
    ([0, 0, 0, 0], 65536, 7),   # one card of 65536 rows: every cluster
    ([0, 1, 2, 3], 65536, 1),   # four cards of 16384: one each
    ([0, 1, 0, 1], 65536, 1),   # two cards of 32768: 2048 rows a CTA
    ([0, 1, 0, 1], 131072, 7),  # two cards of 65536: every cluster
])
def test_launch_takes_the_plans_clusters_and_buffers(recorder, monkeypatch,
                                                     ordinals, n_pad,
                                                     clusters):
    """A spread wave over four positions: the plan's clusters a card (a
    spread wave takes the card's past 2048 rows a CTA), the same on
    every card; a mailbox a card wherever the wave has two participants
    or more, a counts scratch (it spreads), no global-row scratch, no
    participant absent."""
    at = iter(ordinals)
    monkeypatch.setattr(ck, "_card_of", lambda dev: (next(at), 0))
    monkeypatch.setattr(ck, "_joint_sharded_card", lambda o: (LIMIT, MOST))
    args = _wave("spread", n_pad - 1000, n_pad, 4)
    n_cards = len(set(ordinals))
    rows = n_pad // n_cards
    want = ck.joint_sharded_clusters(rows, tp.B, True, args[4].n_spreads,
                                     LIMIT, MOST, n_cards)
    assert want.clusters == clusters
    calls = ck.joint_sharded_launches
    ck._joint_sharded_launch(*args)
    assert ck.joint_sharded_launches == calls + 1
    (call,) = recorder.calls
    assert (call["clusters"], call["absent"], call["n_cards"]) == (
        clusters, -1, n_cards)
    mail = clusters * n_cards > 1
    assert [c[2:] for c in call["cards"]] == [(mail, True, False)] * n_cards


def test_launch_past_shared_memory_takes_the_global_rows(recorder,
                                                         monkeypatch):
    """Where the plan's clusters cannot hold a card's rows (a card whose
    block takes only the members' sums), every card gets the global-row
    scratch, counted as one global-row call."""
    monkeypatch.setattr(ck, "_card_of", lambda dev: (0, 0))
    monkeypatch.setattr(ck, "_joint_sharded_card",
                        lambda o: (tp.B * 9 * 4, MOST))
    args = _wave("everything", 383, None, 4)
    calls = ck.joint_sharded_global_calls
    ck._joint_sharded_launch(*args)
    assert ck.joint_sharded_global_calls == calls + 1
    (call,) = recorder.calls
    assert call["clusters"] == 1
    assert call["cards"] == [(0, 4, False, True, True)]


def test_struct_mirrors():
    """The launch structs' mirrors: JCard with its global-row scratch,
    JShardedArgs with the plan's clusters and the absent participant."""
    assert ctypes.sizeof(ck._JCard) == 48
    assert ctypes.sizeof(ck._JShardedArgs) == 80
    assert ck._JShardedArgs.card.offset == 40
