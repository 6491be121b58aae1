"""The joint kernel's plan and error word, on the CPU.

``ops/cuda_kernel.joint_clusters`` picks how many clusters of 16 CTAs a
joint wave spreads its node axis over, from the wave's widths and the
card's figures (the shared memory a block may take, the clusters it holds
at once), and where the CTAs keep their rows; ``joint_layout`` sizes the
scratch. Both are pure functions, so they are held here without a card;
the kernel itself (csrc/joint_wave.cu) runs in tests/test_torch_gpu.py,
which also holds this layout against the C side's. The error word a wave
over several clusters carries reaches ``launch_wave``'s caller as an
exception.
"""

import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import coalesce as pc

#: an H100's figures: the dynamic shared memory a block of the joint
#: kernel may take (the opt-in limit less its static part), and a
#: co-resident count of clusters of 16
LIMIT = 232448 - 8192
MOST = 7
WIDTHS = [1 << e for e in range(6, 24)] + [1000, 3001, 40000, 300000]


def _plan(n, b=32, shuffle=True, ns=4, limit=LIMIT, most=MOST):
    return ck.joint_clusters(n, b, shuffle, ns, limit, most)


@pytest.mark.parametrize("ns", [0, 1, 4])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("b", [1, 32])
def test_one_cluster_up_to_the_live_width(b, shuffle, ns):
    """Every width up to N=16384 (the live one) runs as one cluster, its
    rows in shared memory, with no mailbox."""
    for n in [w for w in WIDTHS if w <= 16384]:
        p = _plan(n, b, shuffle, ns)
        assert (p.clusters, p.global_rows, p.mail) == (1, 0, 0), (n, p)


@pytest.mark.parametrize("most", [1, 3, 7, 8, 20])
def test_clusters_grow_with_the_node_axis_to_the_card(most):
    """One cluster while a CTA's range stays at or under the rows of its
    kind of wave (cached, or with a spread stanza), past that every
    cluster the card holds at once, at most the kernel's most; never
    fewer for a wider axis."""
    cap = min(most, ck.JOINT_MAX_CLUSTERS)
    for ns in (0, 1, 4):
        rows = ck.JOINT_ROWS_SPREAD if ns else ck.JOINT_ROWS_CACHED
        last = 0
        for n in sorted(WIDTHS):
            c = _plan(n, ns=ns, most=most).clusters
            assert c == (1 if -(-n // 16) <= rows else cap), (n, ns, c)
            assert c >= last
            last = c
        assert last == cap


@pytest.mark.parametrize("n,cached,spread", [
    (16384, 1, 1), (32768, 1, 1), (40000, 1, 7), (65536, 1, 7),
    (65537, 7, 7), (131072, 7, 7), (1 << 19, 7, 7)])
def test_spread_waves_take_the_card_from_a_narrower_axis(n, cached, spread):
    """A spread member's step costs more a row than a cached one, so a
    wave with a stanza takes the card's clusters from N=32768 on, a
    cached wave only past N=65536."""
    assert _plan(n, ns=0).clusters == cached
    assert _plan(n, ns=1).clusters == spread


@pytest.mark.parametrize("ns", [0, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_rows_stay_in_shared_memory_while_the_clusters_hold_them(shuffle,
                                                                 ns):
    """A CTA keeps its rows (13 B a node with shuffle, a bucket byte a
    stanza more) in shared memory wherever the plan's clusters hold them,
    N=524288 included; past that the global-row scratch, and never back
    for a wider axis."""
    seen_global = False
    for n in sorted(WIDTHS):
        p = _plan(n, shuffle=shuffle, ns=ns)
        rows = ck._joint_cta_rows(n, p.clusters, shuffle, ns)
        member = 32 * 9 * 4
        assert (p.global_rows == 0) == (rows + member <= LIMIT), (n, p)
        assert p.smem == (member if p.global_rows else rows + member)
        assert not (seen_global and p.global_rows == 0), n
        seen_global = seen_global or p.global_rows > 0
    assert _plan(1 << 19, shuffle=shuffle, ns=ns).global_rows == 0
    assert seen_global


def test_a_node_axis_past_2_24_raises():
    _plan((1 << 24) - 1)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        _plan(1 << 24)
    with pytest.raises(RuntimeError, match="holds no cluster"):
        _plan(1024, most=0)
    with pytest.raises(RuntimeError, match="shared memory a CTA"):
        _plan(1024, b=8192)


@pytest.mark.parametrize("clusters", [1, 2, 5, 8])
@pytest.mark.parametrize("ns", [0, 2])
def test_scratch_scales_with_the_clusters(clusters, ns):
    """The spread-count swap, the global-row scratch and the mailbox are
    sized for clusters x 16 CTAs."""
    b = 32
    ctas = 16 * clusters
    for n, limit in ((300000, LIMIT), (1 << 22, LIMIT), (5000, 2000)):
        p = ck.joint_layout(n, b, True, ns, limit, clusters)
        assert p.clusters == clusters
        assert p.spc == (ctas * b * tk.MAX_SPREADS * tk.SPREAD_BUCKETS
                         if ns else 0)
        stride = (ck._joint_cta_rows(n, clusters, True, ns) + 15) & ~15
        assert p.global_rows in (0, ctas * stride)
        assert p.mail == (2 * clusters * 96 + clusters * (2 + 8 * b) * 4
                          if clusters > 1 else 0)


def test_launch_takes_the_plans_clusters_and_scratch(monkeypatch):
    """The wrapper hands the C side the plan's cluster count, a mailbox
    and the spread-count swap sized for them, the bound on a wait, and a
    packed buffer one error word longer; it counts one launch."""
    calls = []
    monkeypatch.setattr(ck, "_joint_card", lambda dev: (LIMIT, 3))

    def call(name, w, dev, what):
        calls.append((name, w.clusters, w.absent, w.spin_ns, w.mail,
                      w.a.rows, w.a.n))

    monkeypatch.setattr(ck, "_call", call)
    kins, feats = tp.wave_members(70, "spread", 30000, lib="port",
                                  n_pad=40000)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device="cpu")
    launches = ck.joint_launches
    out = ck._joint_launch(kin, torch.from_numpy(sm), torch.from_numpy(sl),
                           t_pad, feats)
    ((name, clusters, absent, spin, mail, rows, n),) = calls
    assert (name, clusters, absent, rows, n) == ("joint_wave", 3, -1, None,
                                                 40000)
    assert mail is not None and spin == int(ck.SPIN_S * 1e9)
    assert out.packed.shape == (tk.fused_pack_len(t_pad, tp.B) + 1,)
    assert ck.joint_launches == launches + 1


@pytest.mark.parametrize("word,at", [(0, None), (1, [0]), (5, [0, 2]),
                                     (128, [7])])
def test_error_word_of_a_one_device_wave(word, at):
    """A joint wave's packed buffer ends in one error word, the mask of
    the clusters that waited past ``SPIN_S``: 0 reads clean, any bit
    raises naming the clusters; a plain version's buffer has no word."""
    t, b = 16, 4
    n = tk.fused_pack_len(t, b)
    ck.raise_on_wave_error(np.zeros(n, np.float32), t, b)
    packed = np.zeros(n + 1, np.float32)
    packed[n] = word
    if at is None:
        ck.raise_on_wave_error(packed, t, b)
        return
    with pytest.raises(RuntimeError, match="ran past") as err:
        ck.raise_on_wave_error(packed, t, b)
    assert str(at) in str(err.value)


def test_launch_wave_raises_on_a_joint_error_word(monkeypatch):
    """A one-device wave outside B1's envelope whose error word is set:
    ``launch_wave`` raises and counts a failure, and no result reaches
    the members."""
    real = pc.joint_wave_place

    def failing(*a, **k):
        out = real(*a, **k)
        word = torch.tensor([2.0], dtype=out.packed.dtype)
        return out._replace(packed=torch.cat([out.packed, word]))

    monkeypatch.setattr(pc, "joint_wave_place", failing)
    kins, feats = tp.wave_members(71, "spread", 200, lib="port")
    pc.fused_wave_stats.reset()
    try:
        with pytest.raises(RuntimeError, match=r"ran past.*\[1\]"):
            pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                           device="cpu")
        assert pc.fused_wave_stats.snapshot()["failures"] == 1
    finally:
        pc.fused_wave_stats.reset()
        pc.joint_wave_stats.reset()


@pytest.mark.parametrize("word", [0.0, 2.0])
def test_a_failed_joint_wave_commits_nothing_into_resident_usage(
        monkeypatch, word):
    """A one-device joint wave into resident usage: with its error word
    clear it commits ``used + a_*``; with it set ``launch_wave`` raises and
    the resident planes stay as they were, so no later wave reads the
    failed wave's carries."""
    real = ck.joint_wave_place
    outs = []

    def worded(*a, **k):
        out = real(*a, **k)
        out = out._replace(packed=torch.cat(
            [out.packed, torch.tensor([word], dtype=out.packed.dtype)]))
        outs.append(out)
        return out

    monkeypatch.setattr(ck, "joint_wave_place", worded)
    kins, feats = tp.wave_members(72, "spread", 200, lib="port")
    resident = pc.ResidentUsage(kins[0].used_cpu, kins[0].used_mem,
                                kins[0].used_disk, device="cpu")
    before = [resident.used_cpu, resident.used_mem, resident.used_disk]
    pc.fused_wave_stats.reset()
    try:
        if word:
            with pytest.raises(RuntimeError, match="ran past"):
                pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                               device="cpu", resident=resident)
            assert pc.fused_wave_stats.snapshot()["failures"] == 1
            want = before
        else:
            pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                           device="cpu", resident=resident)
            (out,) = outs
            assert float(out.a_cpu.sum()) > 0
            want = [before[0] + out.a_cpu, before[1] + out.a_mem,
                    before[2] + out.a_disk]
        got = [resident.used_cpu, resident.used_mem, resident.used_disk]
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    finally:
        pc.fused_wave_stats.reset()
        pc.joint_wave_stats.reset()
