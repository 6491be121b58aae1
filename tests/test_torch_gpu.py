"""The CUDA kernels against their plain torch versions, on the card.

Imports nothing of JAX or of ``nomad_tpu`` (members come from the port's
own synthetic builders), so it runs where only the port is installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py

Every test takes the ``cuda_device`` fixture, which skips without a card.
Choices, found, ``valid``, top-k indices and metrics must match exactly;
scores, top-k scores and carries within 1e-5.
"""

import ctypes

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


def _assert_fused(got, want, t_pad, b, atol=ATOL):
    g = tk.unpack_fused_wave(got.packed.cpu().numpy(), t_pad, b)
    w = tk.unpack_fused_wave(want.packed.cpu().numpy(), t_pad, b)
    for name in ("chosen", "found") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=atol)
    np.testing.assert_array_equal(got.topk_idx.cpu().numpy(),
                                  want.topk_idx.cpu().numpy())
    for name in ("topk_scores", "a_cpu", "a_mem", "a_disk"):
        np.testing.assert_allclose(
            getattr(got, name).cpu().numpy(),
            getattr(want, name).cpu().numpy(), rtol=0, atol=atol,
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", tp.FUSED_CASES)
def test_cuda_fused_case_matches_plain(case, cuda_device):
    """The waves of tests/test_torch_fused_cases.py through the cluster
    kernel: cached rows across members, penalties and pins over cached
    values, ties across the CTAs' node ranges."""
    kins, feats, x = tp.fused_case(case, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    got = ck.fused_wave_place(kin, sm, sl, t_pad, feats)
    want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, feats)
    torch.cuda.synchronize()
    g = _assert_fused(got, want, t_pad, tp.B)
    tp.check_case(case, x, g["chosen"], g["found"],
                  got.topk_idx.cpu().numpy(), g["nodes_feasible"])


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes,n_pad", ((200, 256), (995, 1000),
                                           (100_000, 131072)),
                         ids=("n256", "n1000", "n131072"))
def test_cuda_kernel_widths(n_nodes, n_pad, cuda_device):
    """A node range smaller than a CTA's threads, a ragged N, and the
    scale width."""
    kins, feats = tp.wave_members(24, "kitchen_sink", n_nodes, lib="port",
                                  n_pad=n_pad)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    assert kin.cap_cpu.shape[-1] == n_pad
    got = ck.fused_wave_place(kin, sm, sl, t_pad, feats)
    want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, feats)
    torch.cuda.synchronize()
    assert _assert_fused(got, want, t_pad, tp.B)["found"].any()


@pytest.mark.gpu
def test_cuda_kernel_reads_perm_at_any_offset(cuda_device):
    """A contiguous permutation view that starts 4 bytes into its storage
    (N a multiple of 4) is read element by element, not with 16-byte
    loads."""
    kins, feats = tp.wave_members(26, "shuffle", 250, lib="port", n_pad=256)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    perm = kin.node_perm
    buf = torch.empty(perm.numel() + 1, dtype=perm.dtype, device=cuda_device)
    buf[1:] = perm.reshape(-1)
    shifted = buf[1:].view(perm.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    kin = kin._replace(node_perm=shifted)
    got = ck.fused_wave_place(kin, sm, sl, t_pad, feats)
    want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, feats)
    torch.cuda.synchronize()
    assert _assert_fused(got, want, t_pad, tp.B)["found"].any()


@pytest.mark.gpu
def test_cuda_wrapper_raises_when_row_does_not_fit(cuda_device):
    """Each of B1's CTAs keeps its node range's scores and ranks in shared
    memory: 2**19 nodes over one cluster do not fit, and B1's wrapper says
    so before launching. ``launch_wave`` sends such a wave (~300k real
    nodes, padded to 524288) to the joint kernel instead, over the
    clusters its plan picks with its rows in shared memory, counted as a
    fused fallback: exact against the plain version, no failure."""
    assert ck.fused_wave_cluster_size() == 16
    kins, feats = tp.wave_members(25, "shuffle", 300_000, lib="port",
                                  n_pad=1 << 19)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    before = ck.launches
    with pytest.raises(ValueError, match="limit of [0-9]+ B"):
        ck.fused_wave_place(kin, sm, sl, t_pad, feats)
    assert ck.launches == before
    assert not ck.fused_wave_fits(cuda_device, 1 << 19, tp.B, True)
    assert not ck.joint_rows_global(cuda_device, 1 << 19, tp.B, True, 0)
    assert ck.joint_plan(cuda_device, 1 << 19, tp.B, True, 0).clusters > 1
    pc.fused_wave_stats.reset()
    pc.joint_wave_stats.reset()
    j0, g0 = ck.joint_launches, ck.joint_global_calls
    got = pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                         device=cuda_device)
    assert (ck.launches, ck.joint_launches - j0,
            ck.joint_global_calls - g0) == (before, 1, 0)
    assert pc.fused_wave_stats.snapshot() == {
        "launches": 0, "fallbacks": 1, "failures": 0}
    assert pc.joint_wave_stats.snapshot() == {
        "launches": 1, "sharded_launches": 0, "global_rows": 0,
        "torch_waves": 0}
    want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, feats)
    g = tk.unpack_fused_wave(want.packed.cpu().numpy(), t_pad, tp.B)
    top_i, top_s = want.topk_idx.cpu().numpy(), want.topk_scores.cpu().numpy()
    for i, o in enumerate(got):
        at = slice(i * tp.K, (i + 1) * tp.K)
        np.testing.assert_array_equal(o.chosen, g["chosen"][at])
        np.testing.assert_array_equal(o.scores, g["scores"][at])
        np.testing.assert_array_equal(np.asarray(o.topk_idx), top_i[at])
        np.testing.assert_array_equal(np.asarray(o.topk_scores), top_s[at])
        for name in tk.FUSED_METRIC_FIELDS:
            assert getattr(o, name) == g[name][i], name
    assert g["found"].any()


def _lean_on(scenario, seed, device, k=tp.LEAN_K, b=tp.LEAN_B,
             nodes=tp.LEAN_NODES):
    args = tp.lean_args(*tp.lean_case(seed, scenario, b=b, k=k, lib="port",
                                      nodes=nodes))
    return tp.torch_args(args, device)


#: the batch kernels' widths on the card: N = 256, 16384 and 131072
LEAN_WIDTHS = (200, 10_000, 100_000)
LEAN_WIDTH_IDS = ("n256", "n16384", "n131072")
#: evals per card test: a multiple neither of B2's 16-eval block nor of
#: its 4-eval warp
CARD_B = 37


@pytest.mark.gpu
@pytest.mark.parametrize("k_steps", (5, 10))
@pytest.mark.parametrize("nodes", LEAN_WIDTHS, ids=LEAN_WIDTH_IDS)
@pytest.mark.parametrize("scenario", tp.LEAN_SCENARIOS)
def test_cuda_place_batch_matches_plain(scenario, nodes, k_steps,
                                        cuda_device):
    args = _lean_on(scenario, 30, cuda_device, k=k_steps, b=CARD_B,
                    nodes=nodes)
    copies = [a.clone() for a in args]
    before = ck.place_batch_launches
    got = ck.place_batch(*args, k_steps=k_steps)
    assert ck.place_batch_launches == before + 1
    want = ck.place_batch_reference(*args, k_steps=k_steps)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(args, copies))
    assert torch.equal(got.chosen, want.chosen)
    assert torch.equal(got.found, want.found)
    np.testing.assert_allclose(got.scores.cpu().numpy(),
                               want.scores.cpu().numpy(), rtol=0, atol=ATOL)
    assert got.found.any()


@pytest.mark.gpu
@pytest.mark.parametrize("k_steps,k_cand", ((5, 8), (10, 8), (5, 64),
                                            (10, 64), (5, 128), (10, 128)))
@pytest.mark.parametrize("nodes", LEAN_WIDTHS, ids=LEAN_WIDTH_IDS)
@pytest.mark.parametrize("scenario", tp.LEAN_SCENARIOS)
def test_cuda_topk_place_batch_matches_plain(scenario, nodes, k_steps,
                                             k_cand, cuda_device):
    args = _lean_on(scenario, 31, cuda_device, k=k_steps, b=CARD_B,
                    nodes=nodes)
    copies = [a.clone() for a in args]
    before = ck.topk_place_batch_launches
    got = ck.topk_place_batch(*args, k_steps=k_steps, k_cand=k_cand)
    assert ck.topk_place_batch_launches == before + 1
    want = ck.topk_place_batch_reference(*args, k_steps=k_steps,
                                         k_cand=k_cand)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(args, copies))
    for name, g, w in zip(("chosen", "scores", "found", "valid"), got, want):
        if name == "scores":
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=0, atol=ATOL)
        else:
            assert torch.equal(g, w), name
    assert got[2].any()


@pytest.mark.gpu
def test_cuda_topk_tie_run_straddles_the_candidate_edge(cuda_device):
    """Eight candidates end inside a run of equal scores: the kernel keeps
    the run's lowest-indexed nodes and the run's score as rest max, as the
    plain version does."""
    args = tp.torch_args(tp.lean_args(*tp.tie_straddle_case(41, lib="port")),
                         cuda_device)
    got = ck.topk_place_batch(*args, k_steps=10, k_cand=8)
    want = ck.topk_place_batch_reference(*args, k_steps=10, k_cand=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_topk_every_node_a_candidate(cuda_device):
    """N == k_cand == 128: the rest max is NEG_INF on the card too."""
    args = _lean_on("random", 34, cuda_device, k=10, b=CARD_B, nodes=100)
    got = ck.topk_place_batch(*args, k_steps=10, k_cand=128)
    want = ck.topk_place_batch_reference(*args, k_steps=10, k_cand=128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[3].all())


@pytest.mark.gpu
def test_cuda_topk_place_batch_allocates_no_score_row(cuda_device):
    """One B2 batch at B=1024, N=16384 allocates its [B, K] outputs, [B]
    ``valid`` and the [B] copies of the scalar asks only: a [B, N] buffer
    of even one byte a pair would be 16 MB."""
    b, k = 1024, 10
    args = _lean_on("random", 35, cuda_device, k=k, b=b, nodes=10_000)
    ck.topk_place_batch(*args, k_steps=k)          # build and load first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    out = ck.topk_place_batch(*args, k_steps=k)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    n = args[0].shape[0]
    assert peak <= sum(x.nbytes for x in out) + 65536, peak
    assert peak < b * n // 8


@pytest.mark.gpu
def test_cuda_lean_wrappers_reject_bad_inputs(cuda_device):
    args = _lean_on("random", 32, cuda_device)
    for fn in (ck.place_batch, ck.topk_place_batch):
        bad = list(args)
        bad[4] = bad[4].double()
        with pytest.raises(ValueError, match="dtype"):
            fn(*bad, k_steps=tp.LEAN_K)
        bad = list(args)
        bad[10] = torch.stack([bad[10], bad[10]], dim=1)[:, 0]
        with pytest.raises(ValueError, match="contiguous"):
            fn(*bad, k_steps=tp.LEAN_K)
        with pytest.raises(ValueError, match="k_steps"):
            fn(*args, k_steps=129)
        mixed = list(args)
        mixed[1] = mixed[1].cpu()
        with pytest.raises(ValueError, match="is on"):
            fn(*mixed, k_steps=tp.LEAN_K)


@pytest.mark.gpu
def test_cuda_kernel_loop_matches_torch_loop(cuda_device):
    from nomad_tpu_torch.ops.kernel import LEAN_FEATURES
    from nomad_tpu_torch.parallel import batching as tb

    kin, uc, um, ac, am, ns = tp.lean_case(33, "random", t=3, lib="port")
    shared = tb.device_put_shared(kin, cuda_device)
    ins = [torch.from_numpy(x).to(cuda_device) for x in (uc, um, ac, am, ns)]
    before = ck.topk_place_batch_launches
    got = tb.make_schedule_apply_loop(tp.LEAN_K, LEAN_FEATURES, topk=True,
                                      backend="kernel_topk")(shared, *ins)
    assert ck.topk_place_batch_launches == before + 3
    want = tb.make_schedule_apply_loop(tp.LEAN_K, LEAN_FEATURES,
                                       topk=True)(shared, *ins)
    assert int(got[1]) == int(want[1]) > 0
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5)


@pytest.mark.gpu
def test_cuda_scheduler_burst_through_fused_waves(cuda_device):
    """A small scheduling burst on the card: 16 evals of C2M lean jobs
    through ``LaunchCoalescer`` make one fused B1 launch; every eval
    completes with its placements and no node ends over capacity. Then
    one eval through the default single-eval launcher."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.kernel import single_eval_stats
    from nomad_tpu_torch.parallel import c2m
    from nomad_tpu_torch.scheduler.testing import Harness

    rng = np.random.default_rng(3)
    h = Harness(device=cuda_device)
    for i in range(120):
        h.state.upsert_node(mock.node(datacenter=f"dc{1 + i % 10}"))
    jobs = [c2m.burst_job(rng, i) for i in range(16)]
    before = ck.launches
    pc.fused_wave_stats.reset()
    evals, co, errors = tp.sched_round(h, jobs, cuda_device)
    assert not errors, errors
    assert co.launches == 1 and ck.launches == before + 1
    assert pc.fused_wave_stats.snapshot() == {"launches": 1, "fallbacks": 0,
                                              "failures": 0}
    status = {e.id: e.status for e in h.evals}
    assert all(status[e.id] == "complete" for e in evals), status
    assert len(h.placed_allocs()) == 16 * c2m.BURST_COUNT
    assert tp.over_capacity_nodes(h.state) == 0

    job = c2m.burst_job(rng, 99)
    h.state.upsert_job(job)
    ev = mock.eval(job_id=job.id, type=job.type, priority=job.priority)
    single_eval_stats.reset()
    h.process(job.type, ev)
    assert h.evals[-1].status == "complete"
    assert single_eval_stats.snapshot()["topk"] == 1
    assert len(h.placed_allocs()) == 17 * c2m.BURST_COUNT
    assert tp.over_capacity_nodes(h.state) == 0


@pytest.mark.gpu
def test_cuda_server_burst_through_b1(cuda_device):
    """The port's ``Server`` on the card: 200 C2M nodes, one worker with
    batches of 8, 8 jobs x 4 registered together. Every job is placed, no
    node ends over capacity, the waves launch B1, and none falls back."""
    import time

    from nomad_tpu_torch.parallel import c2m
    from nomad_tpu_torch.server.server import Server, ServerConfig

    # no mesh: a host of several cards would adopt one by default
    srv = Server(ServerConfig(num_workers=1, worker_batch_size=8,
                              heartbeat_ttl=60.0, gc_tuning=False,
                              use_device_mesh=False),
                 device=cuda_device)
    srv.state.restore_from_bytes(c2m.generate(200, 400).to_snapshot_bytes())
    pc.fused_wave_stats.reset()
    before = ck.launches
    srv.start()
    try:
        rng = np.random.default_rng(8)
        jobs = []
        for i in range(8):
            job = c2m.burst_job(rng, i, prefix="card")
            job.task_groups[0].count = 4
            jobs.append(job)
        w = srv.workers[0]
        w.stop()                        # the jobs go out in full batches
        for job in jobs:
            srv.job_register(job)
        w.start()

        def placed():
            snap = srv.state.snapshot()
            return all(len(snap.allocs_by_job(j.namespace, j.id)) == 4
                       for j in jobs)

        deadline = time.time() + 120
        while time.time() < deadline and not placed():
            time.sleep(0.02)
        assert placed(), w.last_error
        assert w.last_error is None
        stats = pc.fused_wave_stats.snapshot()
        assert stats["fallbacks"] == 0 and stats["failures"] == 0
        assert ck.launches - before >= 1
        assert stats["launches"] == ck.launches - before
        assert tp.over_capacity_nodes(srv.state) == 0
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# The device-resident cluster state, the profiler and the warmup on the card.
# ---------------------------------------------------------------------------

def _port_store(n_nodes=64):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state.store import StateStore

    store = StateStore()
    for _ in range(n_nodes):
        store.upsert_node(mock.node())
    return store


def _assert_resident_is_fresh(ds, snap, cluster, dev):
    planes = ds.planes_for(snap.usage, dev)
    assert planes is not None
    fresh = type(cluster).build(snap.nodes()).wave_shared_planes(snap.usage)
    assert set(planes) == set(fresh)
    for f, arr in fresh.items():
        want = torch.tensor(arr, device=dev)
        assert planes[f].device.type == dev.type, f
        assert planes[f].dtype == want.dtype, f
        assert torch.equal(planes[f], want), f


@pytest.mark.gpu
def test_cuda_scatter_advance_matches_fresh_upload(cuda_device):
    """Alloc churn advanced by the dirty-row scatter, then a structural
    update forked by scatter, on the card: each resident generation is
    bit-identical to a fresh build uploaded whole."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.tensors.device_state import DeviceClusterState
    from nomad_tpu_torch.tensors.schema import IncrementalClusterCache

    store = _port_store()
    ds = DeviceClusterState()
    cache = IncrementalClusterCache()

    def ensure():
        snap = store.snapshot()
        cluster = cache.get(snap)
        ds.ensure(cluster, snap.usage, cuda_device)
        return snap, cluster

    ensure()
    nodes = store.snapshot().nodes()
    store.upsert_allocs([mock.alloc(node_id=nodes[i % 9].id)
                         for i in range(30)])
    snap, cluster = ensure()
    assert ds.delta_advances == 1 and ds.full_uploads == 1
    _assert_resident_is_fresh(ds, snap, cluster, cuda_device)
    node = nodes[3].copy()
    node.node_resources.cpu.cpu_shares = 4321
    store.upsert_node(node)
    snap, cluster = ensure()
    assert ds.fork_deltas == 1 and ds.full_uploads == 1
    _assert_resident_is_fresh(ds, snap, cluster, cuda_device)
    assert ds.snapshot()["errors"] == 0


@pytest.mark.gpu
def test_cuda_evicted_generation_read_in_flight_stays_intact(cuda_device):
    """A wave launched on a generation's resident planes, whose every
    reference is then dropped (the generation evicted, the wave's inputs
    released) while the kernel may still run; new tensors then take the
    freed memory and are overwritten. Stream order keeps the wave's
    inputs intact: its result equals the plain version's on copies taken
    before the launch."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.warmup import _dummy_kin
    from nomad_tpu_torch.tensors.device_state import default_device_state

    store = _port_store(200)
    snap = store.snapshot()
    cluster = pc.ClusterCache(device=cuda_device).get(snap)
    host = cluster.wave_shared_planes(snap.usage)
    n = cluster.n_pad
    rng = np.random.default_rng(5)
    kin = _dummy_kin(n, 16)._replace(
        **host, n_steps=np.asarray(10, np.int32),
        ask_cpu=np.asarray(200.0, np.float32),
        ask_mem=np.asarray(128.0, np.float32),
        base_mask=np.arange(n) < cluster.n_real)
    kins = [kin._replace(node_perm=rng.permutation(n).astype(np.int32))
            for _ in range(4)]
    feats = tk.LEAN_FEATURES._replace(with_topk=True)
    wave = pc.assemble_wave(kins, [16] * 4, [feats] * 4, cuda_device)
    assert wave.kin.used_cpu is default_device_state.lookup(
        host["used_cpu"], cuda_device, frozen_ok=False)
    cpu_kin = tk.KernelIn(*[x.cpu() for x in wave.kin])
    want = ck.fused_wave_place_reference(
        cpu_kin, wave.step_member.cpu(), wave.step_local.cpu(), wave.t_pad,
        wave.features)
    got = ck.fused_wave_place(wave.kin, wave.step_member, wave.step_local,
                              wave.t_pad, wave.features)
    t_pad, b = wave.t_pad, wave.b_pad
    del wave, kin, kins
    for _ in range(default_device_state.max_generations + 1):
        store.upsert_node(mock.node())
        pc.ClusterCache(device=cuda_device).get(store.snapshot())
        default_device_state.advance_pending(cuda_device)
    assert default_device_state.lookup(host["used_cpu"], cuda_device,
                                       frozen_ok=False) is None
    del host
    junk = [torch.full((n,), -7.0, device=cuda_device) for _ in range(64)]
    torch.cuda.synchronize()
    del junk
    g = _assert_fused(got, want, t_pad, b)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_warmup_marks_the_live_key_warm(cuda_device):
    """A warmed joint entry launches B1 once (counted as a warm launch,
    not a wave); a live wave of the same bucket then counts no miss."""
    from nomad_tpu_torch import telemetry
    from nomad_tpu_torch.ops import warmup
    from nomad_tpu_torch.telemetry.kernel_profile import profiler

    feats = tk.LEAN_FEATURES._replace(with_topk=True)
    kins, _ = tp.wave_members(9, "lean", 200, b=4, lib="port")
    kins = [k._replace(**{f: getattr(kins[0], f)
                          for f in pc._SHAREABLE_FIELDS}) for k in kins]
    ks = [int(kins[0].step_preferred.shape[0])] * 4
    # the bucket of this wave, as the launcher assembles it
    w = pc.assemble_wave(kins, ks, [feats] * 4, torch.device("cpu"))
    entry = {"kernel": "joint", "wave": w.b_pad, "steps": w.t_pad,
             "nodes": int(w.kin.cap_cpu.shape[-1]), "shared": w.layout[0],
             "neutral_shared": w.layout[1], "job_shared": w.layout[2],
             "features": dict(w.features._asdict())}
    telemetry.enable()
    try:
        telemetry.reset()
        profiler.clear_seen()
        before = ck.launches
        assert warmup.warmup_entries([entry], device=cuda_device) == (1, 0)
        assert ck.launches == before + 1
        telemetry.reset()
        pc.launch_wave(kins, ks, [feats] * 4, device=cuda_device)
        s = profiler.summary()
        assert s["PerKey"][0]["Kernel"] == "fused_wave", s
        assert s["Misses"] == 0, s
        assert s["StageSeconds"]["execute"] > 0.0
        assert s["TransferBytes"]["d2h"] > 0
    finally:
        telemetry.disable()
        telemetry.reset()


# ---------------------------------------------------------------------------
# System jobs and worker processes on the card.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["lean", "ports", "distinct", "devices",
                                     "cores", "network", "kitchen_sink"])
def test_cuda_feasible_mask_matches_cpu(variant, cuda_device):
    """``_feasible_mask`` on the card against the same ``KernelIn`` on the
    CPU, nodes half full to full: mask and fit planes exact."""
    from nomad_tpu_torch.scheduler import system

    kins, _ = tp.wave_members(5, variant, 383, b=1, lib="port")
    rng = np.random.default_rng(5)
    n_pad = kins[0].cap_cpu.shape[0]
    kin = kins[0]._replace(
        used_cpu=(kins[0].cap_cpu * rng.uniform(0.5, 1.0, n_pad)).astype(
            np.float32),
        used_mem=(kins[0].cap_mem * rng.uniform(0.5, 1.0, n_pad)).astype(
            np.float32))
    mask_d, dims_d = system._feasible_mask(kin, cuda_device)
    mask_c, dims_c = system._feasible_mask(kin, "cpu")
    np.testing.assert_array_equal(mask_d, mask_c)
    assert dims_d.keys() == dims_c.keys()
    for name in dims_c:
        np.testing.assert_array_equal(dims_d[name], dims_c[name],
                                      err_msg=name)
    assert 0 < int(mask_c.sum()) < int(np.asarray(kin.base_mask).sum())


@pytest.mark.gpu
def test_cuda_system_job_places_like_the_cpu(cuda_device):
    """A system job through ``new_scheduler("system", ...)`` on the card
    places on the same nodes as on the CPU, one alloc per feasible ready
    node, through one mask on the card."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel import c2m
    from nomad_tpu_torch.scheduler import system
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.state.store import StateStore

    blob = c2m.generate(200, 600).to_snapshot_bytes()
    # too big for a standard node with its allocs; too low a priority
    # to preempt any
    job = mock.system_job(priority=10,
                          datacenters=[f"dc{i}" for i in range(1, 11)])
    job.task_groups[0].tasks[0].resources.cpu = 3500
    ev = mock.eval(job_id=job.id, type=job.type, priority=job.priority)
    placed = {}
    for dev in ("cpu", cuda_device):
        store = StateStore()
        store.restore_from_bytes(blob)
        h = Harness(state=store, device=dev)
        h.state.upsert_job(job.copy())
        h.state.upsert_evals([ev.copy()])
        before = system.mask_launches
        h.process(job.type, ev.copy())
        assert system.mask_launches == before + 1
        assert h.evals[-1].status == "complete"
        nodes = [a.node_id for a in h.placed_allocs()]
        assert len(nodes) == len(set(nodes))
        placed[str(dev)] = sorted(nodes)
        assert tp.over_capacity_nodes(h.state) == 0
    assert placed["cpu"] == placed[str(cuda_device)]
    assert 0 < len(placed["cpu"]) < 200


@pytest.mark.gpu
def test_cuda_worker_processes_place_through_b1(cuda_device):
    """``Server(scheduler_workers=2)`` on the card, 200 C2M nodes, 8 jobs
    x 4 in two leases of 4: each worker process reports the card, places
    its lease through B1 (no fallback, no failure, no device-state
    error), and its resident planes equal a fresh upload."""
    import time

    from nomad_tpu_torch.parallel import c2m
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.state.store import leased_generation_count
    from nomad_tpu_torch.state.usage import usage_rebuild_diff

    srv = Server(ServerConfig(num_workers=1, worker_batch_size=4,
                              heartbeat_ttl=60.0, gc_tuning=False,
                              coalesce_adaptive=False, scheduler_workers=2),
                 device=cuda_device)
    srv.state.restore_from_bytes(c2m.generate(200, 400).to_snapshot_bytes())
    rng = np.random.default_rng(8)
    jobs = []
    for i in range(8):
        job = c2m.burst_job(rng, i, prefix="card-wp")
        job.task_groups[0].count = 4
        jobs.append(job)
        # registered before start: leadership restores the 8 evals and
        # the supervisor leases them in two batches of 4, one each
        srv.job_register(job)
    srv.start()
    try:
        def placed():
            snap = srv.state.snapshot()
            return all(len(snap.allocs_by_job(j.namespace, j.id)) == 4
                       for j in jobs)

        deadline = time.time() + 180
        while time.time() < deadline and not placed():
            time.sleep(0.05)
        assert placed(), srv.stats()["worker_procs"]
        time.sleep(1.0)
        sup = srv.worker_supervisor
        counters = sup.child_counters()
        name = torch.cuda.get_device_name(cuda_device)
        assert [c["device"] for c in counters] == [name, name]
        for c in counters:
            assert c["b1_launches"] >= 1, c
            assert c["fused"]["launches"] == c["b1_launches"], c
            assert c["fused"]["fallbacks"] == 0, c
            assert c["fused"]["failures"] == 0, c
            assert c["device_state"]["errors"] == 0, c
        # each wave took the placement turn
        assert sum(c["turn"]["grants"] for c in counters) == \
            sup.turn.grants >= 2
        for h in sup.handles:
            h.sync_state()
            res = h.probe("resident")
            assert res["resident"] and res["differ"] == [], res
        assert usage_rebuild_diff(srv.state) == []
        assert tp.over_capacity_nodes(srv.state) == 0
    finally:
        srv.shutdown()
    assert leased_generation_count() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("variant,n_nodes", tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.FUSED_VARIANTS])
def test_cuda_sharded_wave_matches_b1(variant, n_nodes, cuda_device):
    """The fused sharded wave over four virtual shards on the card against
    B1 on the same inputs: no B1 launch, the same wave (every shard
    computes its rows as the whole plane does, at any width)."""
    from nomad_tpu_torch.parallel import sharded

    kins, feats = tp.wave_members(9, variant, n_nodes, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    want = ck.fused_wave_place(kin, torch.from_numpy(sm).to(cuda_device),
                               torch.from_numpy(sl).to(cuda_device), t_pad,
                               feats)
    mesh = sharded.wave_mesh(devices=[cuda_device] * 4)
    before, calls = ck.launches, ck.sharded_launches
    fo = sharded.fused_sharded_entry(mesh)[0](
        kernel_in_from_numpy(stacked, keep_numpy=True), sm, sl, t_pad, feats)
    assert ck.launches == before and ck.sharded_launches == calls + 1
    assert len(fo.a_cpu) == 4 and fo.a_cpu[0].device.type == "cuda"
    got = fo._replace(**{name: torch.cat(getattr(fo, name))
                         for name in ("a_cpu", "a_mem", "a_disk")})
    torch.cuda.synchronize()
    g = _assert_fused(got, want, t_pad, tp.B)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_launch_wave_over_a_virtual_mesh(cuda_device):
    """``launch_wave(mesh=)`` on the card: one sharded launch, no B1
    launch, the members' slices equal to the unsharded wave's."""
    from nomad_tpu_torch.parallel import sharded

    kins, feats = tp.wave_members(10, "kitchen_sink", 383, lib="port")
    steps = [tp.K] * len(kins)
    pc.sharded_wave_stats.reset()
    want = pc.launch_wave(kins, steps, [feats] * len(kins),
                          device=cuda_device)
    before, calls = ck.launches, ck.sharded_launches
    got = pc.launch_wave(kins, steps, [feats] * len(kins),
                         device=cuda_device,
                         mesh=sharded.wave_mesh(devices=[cuda_device] * 8))
    assert ck.launches == before and ck.sharded_launches == calls + 1
    assert pc.sharded_wave_stats.snapshot()["launches"] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.chosen, w.chosen)
        np.testing.assert_array_equal(np.asarray(g.topk_idx),
                                      np.asarray(w.topk_idx))
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# The fused sharded wave's kernel (csrc/sharded_wave.cu)
# ---------------------------------------------------------------------------

def _shards_on(stacked, devices):
    """The stacked numpy wave split over a mesh of ``devices``: one
    KernelIn a node shard, as ``fused_sharded_entry`` hands them over."""
    from nomad_tpu_torch.parallel import sharded

    mesh = sharded.wave_mesh(devices=devices)
    shardings, _ = sharded.joint_in_shardings(mesh)
    placed, _ = sharded.place_args(
        kernel_in_from_numpy(stacked, keep_numpy=True), shardings)
    return sharded._shards_of(placed, mesh.node_rows()[0])


def _whole(out, root):
    """A sharded FusedWaveOut with its carries gathered on ``root``."""
    return out._replace(**{name: torch.cat([p.to(root)
                                            for p in getattr(out, name)])
                           for name in ("a_cpu", "a_mem", "a_disk")})


def _kernel_against_plain_and_b1(stacked, sm, sl, t_pad, feats, devices):
    """The kernel over ``devices`` against its plain version on the same
    shards and against B1 on the whole wave: equal bit for bit. One
    kernel call, no B1 launch."""
    root = devices[0]
    parts = _shards_on(stacked, devices)
    before, calls = ck.launches, ck.sharded_launches
    clusters = ck.sharded_kernel_launches()
    got = _whole(ck.sharded_wave_place(parts, sm, sl, t_pad, feats), root)
    assert ck.sharded_launches == calls + 1 and ck.launches == before
    # one cluster launch a card, counted on the C side
    assert ck.sharded_kernel_launches() - clusters == len(set(devices))
    b = len(stacked.n_steps)
    ck.raise_on_wave_error(got.packed.cpu().numpy(), t_pad, b)
    plain = _whole(ck.sharded_wave_place_reference(parts, sm, sl, t_pad,
                                                   feats), root)
    kin = kernel_in_from_numpy(stacked, device=root)
    b1 = ck.fused_wave_place(kin, torch.from_numpy(sm).to(root),
                             torch.from_numpy(sl).to(root), t_pad, feats)
    torch.cuda.synchronize()
    _assert_fused(got, plain, t_pad, b, atol=0.0)
    return _assert_fused(got, b1, t_pad, b, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("variant,n_nodes", tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.FUSED_VARIANTS])
def test_cuda_sharded_kernel_matches_plain_and_b1(variant, n_nodes, shards,
                                                 cuda_device):
    kins, feats = tp.wave_members(12, variant, n_nodes, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _kernel_against_plain_and_b1(stacked, sm, sl, t_pad, feats,
                                     [cuda_device] * shards)
    assert g["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", tp.FUSED_CASES)
def test_cuda_sharded_kernel_fused_cases(case, cuda_device):
    """tests/test_torch_fused_cases.py's waves over four shards: members
    seeing the ones before them, penalties and pins, ties across the
    shards' and the blocks' row ranges."""
    kins, feats, x = tp.fused_case(case, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    root = cuda_device
    parts = _shards_on(stacked, [root] * 4)
    got = _whole(ck.sharded_wave_place(parts, sm, sl, t_pad, feats), root)
    kin = kernel_in_from_numpy(stacked, device=root)
    want = ck.fused_wave_place(kin, torch.from_numpy(sm).to(root),
                               torch.from_numpy(sl).to(root), t_pad, feats)
    torch.cuda.synchronize()
    g = _assert_fused(got, want, t_pad, tp.B, atol=0.0)
    tp.check_case(case, x, g["chosen"], g["found"],
                  got.topk_idx.cpu().numpy(), g["nodes_feasible"])


@pytest.mark.gpu
def test_cuda_sharded_kernel_idle_steps_and_no_topk(cuda_device):
    """Members with fewer steps than the bucket (and one with none):
    padding and inactive steps give the idle outputs; with top-k off the
    planes are 0 / NEG_INF."""
    kins, feats = tp.wave_members(9, "shuffle", 200, lib="port")
    kins = [k._replace(n_steps=np.asarray(n, np.int32))
            for k, n in zip(kins, (4, 0, 2, 3))]
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    for f in (feats, feats._replace(with_topk=False)):
        _kernel_against_plain_and_b1(stacked, sm, sl, t_pad, f,
                                     [cuda_device] * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes,n_pad,shards", (
    (995, 1024, 4), (5000, 8192, 2), (100_000, 131072, 8)),
    ids=("n1024", "n8192-d2", "n131072-d8"))
def test_cuda_sharded_kernel_widths(n_nodes, n_pad, shards, cuda_device):
    """Several step blocks a shard (N/D over 1024 rows) and the scale
    width, against B1."""
    kins, feats = tp.wave_members(24, "kitchen_sink", n_nodes, lib="port",
                                  n_pad=n_pad)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _kernel_against_plain_and_b1(stacked, sm, sl, t_pad, feats,
                                     [cuda_device] * shards)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_sharded_kernel_sixteen_virtual_shards(cuda_device):
    """D=16 on one card: one cluster over all sixteen positions, a CTA
    a position."""
    kins, feats = tp.wave_members(25, "kitchen_sink", 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _kernel_against_plain_and_b1(stacked, sm, sl, t_pad, feats,
                                     [cuda_device] * 16)
    assert g["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["shuffle", "kitchen_sink"])
def test_cuda_sharded_kernel_range_crosses_a_position(variant, cuda_device):
    """N=4004 over four shards: CTA 3's rows [753, 1004) end position 0
    and begin position 1 at row 1001, off the warps' 32-row grid; each
    row keeps its own position's planes, carries and global index."""
    assert ck.sharded_row_plan([0, 1001, 2002, 3003], 1001)[3] == [
        (0, 753, 1001, 0), (1, 0, 3, 1001)]
    kins, feats = tp.wave_members(26, variant, 3990, lib="port", n_pad=4004)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _kernel_against_plain_and_b1(stacked, sm, sl, t_pad, feats,
                                     [cuda_device] * 4)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_sharded_wave_is_one_launch_a_card(cuda_device):
    """A ``launch_wave`` over a virtual mesh of eight: one C call and
    exactly one kernel launch on the card, read from the C side's count;
    no per-step launch."""
    from nomad_tpu_torch.parallel import sharded

    kins, feats = tp.wave_members(27, "kitchen_sink", 383, lib="port")
    steps = [tp.K] * len(kins)
    mesh = sharded.wave_mesh(devices=[cuda_device] * 8)
    pc.launch_wave(kins, steps, [feats] * len(kins), device=cuda_device,
                   mesh=mesh)
    calls, clusters = ck.sharded_launches, ck.sharded_kernel_launches()
    pc.launch_wave(kins, steps, [feats] * len(kins), device=cuda_device,
                   mesh=mesh)
    assert ck.sharded_launches - calls == 1
    assert ck.sharded_kernel_launches() - clusters == 1


def _two_clusters_on_one_card(monkeypatch, dev, groups, same_stream=False,
                              root_second=False, fail_second=False,
                              lib_name="sharded_wave", card=None):
    """Run the several-card path on one card: the wrapper sees the mesh's
    positions grouped as ``groups`` on two "cards" that are one device
    and two streams (one stream with ``same_stream``), so two clusters
    exchange every step through their mailboxes as cards do over NVLink.
    The wrapper copies both cards' tables and allocates every buffer on
    the device's current stream; the second stream first waits on it.
    The root runs on the current stream, or on the second with
    ``root_second``. With ``fail_second`` the C side refuses the second
    card's launch (its table claims more rows than a block's shared
    memory holds) after it has launched the first. Returns the current
    stream and the second."""
    s0 = torch.cuda.current_stream(dev)
    s1 = s0 if same_stream else torch.cuda.Stream(dev)
    fn, built, lib = ck._LIBS[lib_name]

    def launch(ref):
        s1.wait_stream(s0)
        if fail_second:
            cards = ctypes.cast(ref._obj.card,
                                ctypes.POINTER(card or ck._Card))
            cards[1].n_pos = 1 << 20
        return fn(ref)

    first, second = (s1, s0) if root_second else (s0, s1)
    stream = {p: (first if c == 0 else second).cuda_stream
              for c, (_, ps) in enumerate(groups) for p in ps}
    order = iter(range(len(stream)))
    monkeypatch.setitem(ck._LIBS, lib_name, (launch, built, lib))
    monkeypatch.setattr(ck, "_card_of",
                        lambda d: (d.index or 0, stream[next(order)]))
    monkeypatch.setattr(ck, "group_positions", lambda cards: groups)
    monkeypatch.setattr(ck, "_enable_peers", lambda cards: None)
    return s0, s1


def _assert_joined(s0, s1):
    """Work queued on ``s0`` after a wave's C call runs only once every
    card's kernel has ended: nothing of ``s1``'s is still running."""
    after = torch.cuda.Event()
    after.record(s0)
    after.synchronize()
    assert s1.query(), "a card's kernel outlived another card's stream"


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [[(0, [0, 2]), (0, [1, 3])],
                                    [(0, [0, 1]), (0, [2, 3])]],
                         ids=["interleaved", "halves"])
@pytest.mark.parametrize("variant,n_nodes", tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.FUSED_VARIANTS])
def test_cuda_sharded_kernel_exchange_on_one_card(variant, n_nodes, groups,
                                                  cuda_device, monkeypatch):
    """The several-card kernel (mailboxes, tags, the cards' merge, the
    root's top-k and metrics from every card) as two clusters on one
    card: bit for bit B1's wave, two kernel launches, no error word."""
    ck.load_library("sharded_wave")
    s0, s1 = _two_clusters_on_one_card(monkeypatch, cuda_device, groups)
    kins, feats = tp.wave_members(30, variant, n_nodes, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    parts = _shards_on(stacked, [cuda_device] * 4)
    clusters = ck.sharded_kernel_launches()
    out = ck.sharded_wave_place(parts, sm, sl, t_pad, feats)
    _assert_joined(s0, s1)
    got = _whole(out, cuda_device)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    b1 = ck.fused_wave_place(kin, torch.from_numpy(sm).to(cuda_device),
                             torch.from_numpy(sl).to(cuda_device), t_pad,
                             feats)
    torch.cuda.synchronize()
    assert ck.sharded_kernel_launches() - clusters == 2
    ck.raise_on_wave_error(got.packed.cpu().numpy(), t_pad, tp.B)
    g = _assert_fused(got, b1, t_pad, tp.B, atol=0.0)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_sharded_kernel_wait_is_bounded(cuda_device, monkeypatch):
    """Two "cards" on one stream: the first card's cluster waits for the
    second, which cannot start before it ends. Each wait gives up at the
    bound, the wave ends, and its error word raises."""
    import time

    ck.load_library("sharded_wave")
    _two_clusters_on_one_card(monkeypatch, cuda_device,
                              [(0, [0, 1]), (0, [2, 3])], same_stream=True)
    monkeypatch.setattr(ck, "SPIN_S", 0.25)
    kins, feats = tp.wave_members(31, "kitchen_sink", 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    parts = _shards_on(stacked, [cuda_device] * 4)
    t0 = time.perf_counter()
    got = ck.sharded_wave_place(parts, sm, sl, t_pad, feats)
    packed = got.packed.cpu().numpy()
    took = time.perf_counter() - t0
    assert took < 30, took
    with pytest.raises(RuntimeError, match="ran past"):
        ck.raise_on_wave_error(packed, t_pad, tp.B)


@pytest.mark.gpu
def test_cuda_sharded_kernel_buffers_outlive_every_card(cuda_device,
                                                        monkeypatch):
    """The first card's kernel is launched, the second card's launch
    fails, and the call raises while the first still waits for the second
    (up to the bound) and stores into its mailbox. The wrapper frees that
    mailbox in the second card's stream order, so that stream must not
    run on before the first card's kernel has ended: an event on it
    completes only after, and tensors allocated there at once keep what
    is written into them."""
    ck.load_library("sharded_wave")
    s0, s1 = _two_clusters_on_one_card(
        monkeypatch, cuda_device, [(0, [0, 1]), (0, [2, 3])],
        root_second=True, fail_second=True)
    monkeypatch.setattr(ck, "SPIN_S", 0.25)
    kins, feats = tp.wave_members(31, "kitchen_sink", 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    parts = _shards_on(stacked, [cuda_device] * 4)
    torch.cuda.synchronize()
    clusters = ck.sharded_kernel_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        ck.sharded_wave_place(parts, sm, sl, t_pad, feats)
    assert ck.sharded_kernel_launches() - clusters == 1
    n = ck._mail_bytes(2, len(stacked.n_steps))
    held = [torch.full((n,), 0x5A, dtype=torch.uint8, device=cuda_device)
            for _ in range(64)]
    _assert_joined(s0, s1)
    torch.cuda.synchronize()
    assert all(bool((x == 0x5A).all()) for x in held)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["cards", "interleaved"])
def test_cuda_sharded_kernel_over_several_cards(layout, cuda_device):
    """A mesh of real cards (every card, or cards 0, 1, 0, 1): one
    cluster launch a card, each step's result pushed into every card's
    mailbox over NVLink; the wave equals B1's on the first card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards or more; this host has {n}")
    cards = [torch.device("cuda", i) for i in range(n)]
    devices = cards if layout == "cards" else [cards[0], cards[1]] * 2
    kins, feats = tp.wave_members(30, "kitchen_sink", 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _kernel_against_plain_and_b1(stacked, sm, sl, t_pad, feats, devices)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_default_server_places_over_the_cards_mesh(cuda_device):
    """On a host of several cards a server with the default
    ``use_device_mesh`` splits its waves over every card, as the JAX
    package's does: every wave one sharded kernel call and no B1 launch,
    every job placed, no node over capacity."""
    import time

    from nomad_tpu_torch.parallel import c2m
    from nomad_tpu_torch.server.server import Server, ServerConfig

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards or more; this host has {n}")
    srv = Server(ServerConfig(num_workers=1, worker_batch_size=8,
                              heartbeat_ttl=60.0, gc_tuning=False,
                              coalesce_adaptive=False),
                 device=cuda_device)
    srv.state.restore_from_bytes(c2m.generate(200, 400).to_snapshot_bytes())
    srv.start()
    try:
        assert list(srv.wave_mesh.devices.flat) == [
            torch.device("cuda", i) for i in range(n)]
        pc.fused_wave_stats.reset()
        pc.sharded_wave_stats.reset()
        b1, calls = ck.launches, ck.sharded_launches
        rng = np.random.default_rng(9)
        jobs = []
        for i in range(8):
            job = c2m.burst_job(rng, i, prefix="cards")
            job.task_groups[0].count = 4
            jobs.append(job)
        w = srv.workers[0]
        w.stop()
        for job in jobs:
            srv.job_register(job)
        w.start()

        def placed():
            snap = srv.state.snapshot()
            return all(len(snap.allocs_by_job(j.namespace, j.id)) == 4
                       for j in jobs)

        deadline = time.time() + 120
        while time.time() < deadline and not placed():
            time.sleep(0.02)
        assert placed(), w.last_error
        assert w.last_error is None
        waves = pc.sharded_wave_stats.snapshot()
        assert waves["launches"] >= 1 and waves["fallbacks"] == 0, waves
        assert ck.sharded_launches - calls == waves["launches"]
        assert ck.launches == b1
        fused = pc.fused_wave_stats.snapshot()
        assert fused == {"launches": waves["launches"], "fallbacks": 0,
                         "failures": 0}, fused
        assert tp.over_capacity_nodes(srv.state) == 0
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# The warmup's mesh pass on the card (ops/warmup.warmup_entries(mesh=))
# ---------------------------------------------------------------------------

def _mesh_of(layout, cuda_device):
    """A virtual 4-shard mesh on the card, or a mesh over every card
    (skipped on a host of one)."""
    from nomad_tpu_torch.parallel import sharded

    if layout == "virtual":
        return sharded.wave_mesh(devices=[cuda_device] * 4)
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards or more; this host has {n}")
    return sharded.wave_mesh(device=cuda_device)


def _entry_of(kins, steps, feats):
    """The manifest entry of the bucket ``launch_wave`` gives these
    members."""
    _, union, b_pad, t_pad, layout, *_ = pc._wave_layout(kins, steps, feats)
    return {"kernel": "joint", "wave": b_pad, "steps": t_pad,
            "nodes": int(kins[0].cap_cpu.shape[-1]), "shared": layout[0],
            "neutral_shared": layout[1], "job_shared": layout[2],
            "features": dict(union._asdict())}


def _assert_exact(got, want):
    for g, w in zip(got, want):
        for name in ("chosen", "found", "scores"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name), name)
        np.testing.assert_array_equal(np.asarray(g.topk_idx),
                                      np.asarray(w.topk_idx))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["virtual", "cards"])
def test_cuda_mesh_warmup_then_live_wave(layout, cuda_device, monkeypatch):
    """The mesh pass launches the sharded kernel once over the mesh and
    marks the live key warm: afterwards the plan of every card and (over
    several cards) peer access are in place, and the first live wave over
    the mesh loads no library, builds no plan, enables no peer and counts
    no miss; it places exactly as B1 on the first card."""
    from nomad_tpu_torch import telemetry
    from nomad_tpu_torch.ops import warmup
    from nomad_tpu_torch.telemetry.kernel_profile import profiler

    mesh = _mesh_of(layout, cuda_device)
    ordinals = tuple(dict.fromkeys(d.index for d in mesh.devices.flat))
    kins, feats = tp.wave_members(31, "kitchen_sink", 1000, b=8, lib="port")
    steps = [tp.K] * len(kins)
    entry = _entry_of(kins, steps, [feats] * len(kins))
    n_loc = entry["nodes"] // mesh.size
    # as in a fresh process: no plan at this shape, peers not recorded
    for key in [k for k in ck._SHARDED_PLANS if k[2] == n_loc]:
        del ck._SHARDED_PLANS[key]
    ck._PEERS.discard(ordinals)
    profiler.clear_seen()
    calls = ck.sharded_launches
    assert warmup.warmup_entries([entry], device=cuda_device, mesh=mesh,
                                 mesh_only=True) == (1, 0)
    assert ck.sharded_launches == calls + 1
    assert len(ordinals) < 2 or ordinals in ck._PEERS
    planned = {k[0] for k in ck._SHARDED_PLANS if k[2] == n_loc}
    assert planned == set(ordinals)

    lib = ck._LIBS["sharded_wave"][2]
    asked = []
    for name in ("sharded_wave_plan", "sharded_wave_enable_peers"):
        real = getattr(lib, name)

        def counted(*a, _real=real, _name=name):
            asked.append(_name)
            return _real(*a)

        monkeypatch.setattr(lib, name, counted)
    loads, plans = ck.library_loads, len(ck._SHARDED_PLANS)
    telemetry.enable()
    try:
        telemetry.reset()
        got = pc.launch_wave(kins, steps, [feats] * len(kins),
                             device=cuda_device, mesh=mesh)
        assert profiler.misses_for("fused_wave_sharded") == 0, \
            profiler.summary()["PerKey"]
    finally:
        telemetry.disable()
        telemetry.reset()
    assert asked == [] and ck.library_loads == loads
    assert len(ck._SHARDED_PLANS) == plans
    assert ck.sharded_launches == calls + 2
    want = pc.launch_wave(kins, steps, [feats] * len(kins),
                          device=cuda_device)
    _assert_exact(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["virtual", "cards"])
def test_cuda_warm_pass_racing_live_waves(layout, cuda_device):
    """A mesh pass on another thread (as a server's, after it adopts a
    mesh) while live waves run over the same mesh: the plans, the peer
    set and the library are shared by both threads, and every live wave
    places exactly as B1; the warm passes warm and fail as one alone."""
    import threading

    from nomad_tpu_torch.ops import warmup

    mesh = _mesh_of(layout, cuda_device)
    kins, feats = tp.wave_members(32, "shuffle", 1000, b=8, lib="port")
    steps = [tp.K] * len(kins)
    fl = [feats] * len(kins)
    entries = [_entry_of(kins, steps, fl),
               dict(_entry_of(kins, steps, fl), wave=4,
                    steps=tk.pad_steps(4 * tp.K))]
    want = pc.launch_wave(kins, steps, fl, device=cuda_device)
    stop = threading.Event()
    passes = []

    def warm():
        while not stop.is_set():
            passes.append(warmup.warmup_entries(
                entries, device=cuda_device, mesh=mesh, mesh_only=True))

    t = threading.Thread(target=warm)
    t.start()
    try:
        for _ in range(8):
            _assert_exact(pc.launch_wave(kins, steps, fl,
                                         device=cuda_device, mesh=mesh),
                          want)
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive()
    assert passes and set(passes) == {(2, 0)}


#: make_place_batch's card check: one eval of each variant, own clusters
#: on one node axis of 256 rows
PLACE_BATCH_MIX = ("kitchen_sink", "spread", "lean", "devices",
                   "penalty_preferred", "cores", "distinct", "network")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4), (8, 1)], ids=["2x4", "8x1"])
def test_cuda_place_batch_route_matches_plain(shape, cuda_device):
    """``make_place_batch`` over a virtual (evals, nodes) mesh on the
    card: each eval in the fused envelope is one call of the sharded
    kernel (rows of four shards) or of B1 (rows of one), the others one
    call of the joint sharded kernel (rows of four) or of the joint
    kernel (rows of one); no eval runs torch ops; every eval equals the
    plain step's, which runs each through the torch-op body."""
    from nomad_tpu_torch.parallel import mesh as pm
    from nomad_tpu_torch.parallel import sharded

    kins = [tp.wave_members(20 + i, v, 200, b=1, lib="port", n_pad=256)[0][0]
            for i, v in enumerate(PLACE_BATCH_MIX)]
    stacked = sharded.stack_kernel_ins(kins)
    mesh = pm.make_mesh(8, evals_parallel=shape[0],
                        devices=[cuda_device] * 8)
    k_pad = tk.pad_steps(tp.K)
    fused = sum(tk.fused_wave_supported(f)
                for f in sharded.eval_features(stacked))
    l0, s0, j0 = ck.launches, ck.sharded_launches, ck.joint_launches
    js0, p0 = ck.joint_sharded_launches, sharded.place_batch_stats.plain_evals
    got = sharded.make_place_batch(mesh, k_pad)(stacked)
    torch.cuda.synchronize()
    assert (ck.launches - l0, ck.sharded_launches - s0,
            ck.joint_launches - j0, ck.joint_sharded_launches - js0) == (
        (fused, 0, len(kins) - fused, 0) if shape[1] == 1
        else (0, fused, 0, len(kins) - fused))
    assert sharded.place_batch_stats.plain_evals == p0
    want = sharded.make_place_batch(mesh, k_pad, plain=True)(stacked)
    assert got.chosen.device == want.chosen.device == mesh.devices.flat[0]
    for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name).cpu().numpy(),
                                      err_msg=name)
    for name in ("scores", "topk_scores"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(want, name).cpu().numpy(),
                                   rtol=0, atol=ATOL, err_msg=name)
    assert got.found.any()


# ---------------------------------------------------------------------------
# The joint kernel (csrc/joint_wave.cu): every feature union, bit for bit
# against its plain versions (the composite; place_taskgroup for one eval).
# ---------------------------------------------------------------------------

def _joint_pair(kins, feats, dev, k=tp.K):
    """One wave through ``joint_wave_place`` (one launch) and its plain
    version on the card; exact: the kernel rounds as the torch ops do."""
    stacked, sm, sl, t_pad = tp.stack_wave(kins, k)
    kin = kernel_in_from_numpy(stacked, device=dev)
    before = ck.joint_launches
    got = ck.joint_wave_place(kin, sm, sl, t_pad, feats)
    assert ck.joint_launches == before + 1
    want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, feats)
    torch.cuda.synchronize()
    return _assert_fused(got, want, t_pad, len(kins), atol=0.0), got


@pytest.mark.gpu
@pytest.mark.parametrize("variant,n_nodes",
                         tp.JOINT_VARIANTS + tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.JOINT_VARIANTS
                              + tp.FUSED_VARIANTS])
def test_cuda_joint_kernel_matches_plain_version(variant, n_nodes,
                                                 cuda_device):
    kins, feats = tp.wave_members(8, variant, n_nodes, lib="port")
    g, _ = _joint_pair(kins, feats, cuda_device)
    assert g["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", tp.JOINT_CASES)
def test_cuda_joint_case_matches_plain(case, cuda_device):
    kins, feats, info = tp.joint_case(case, lib="port")
    g, got = _joint_pair(kins, feats, cuda_device)
    tp.check_joint_case(case, info, g["chosen"], g["found"],
                        got.topk_idx.cpu().numpy(), g)


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes,n_pad", ((300, 512), (1000, 16384),
                                           (2100, 131072), (2100, 262144)),
                         ids=("n512", "n16384", "n131072", "n262144"))
def test_cuda_joint_kernel_widths(n_nodes, n_pad, cuda_device):
    """The everything wave (four spread stanzas, shuffle) over padded node
    axes up to N=262144, the widest that fits, where a CTA keeps 16384
    nodes' keys, sums, counts and ranks; members in an interleaved step
    order, so each member's counts leave and come back."""
    kins, feats = tp.wave_members(26, "everything", n_nodes, lib="port",
                                  n_pad=n_pad)
    stacked, _, _, _ = tp.stack_wave(kins)
    order = np.array([0, 1, 0, 2, 1, 3, 0, 3, 2, 1, 3, 2, 0, 1, 2, 3],
                     np.int32)
    local = np.zeros_like(order)
    for m in range(tp.B):
        local[order == m] = np.arange(tp.K)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    got = ck.joint_wave_place(kin, order, local, len(order), feats)
    want = ck.fused_wave_place_reference(kin, order, local, len(order),
                                         feats)
    torch.cuda.synchronize()
    g = _assert_fused(got, want, len(order), tp.B, atol=0.0)
    assert g["found"].any()


def _assert_single(got, want):
    for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name).cpu().numpy(),
                                      err_msg=name)
    for name in ("scores", "topk_scores"):
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name).cpu().numpy(),
                                      err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,n_nodes", tp.JOINT_VARIANTS,
                         ids=[v for v, _ in tp.JOINT_VARIANTS])
def test_cuda_joint_eval_matches_place_taskgroup(variant, n_nodes,
                                                 cuda_device):
    """One eval through ``joint_eval_place`` (a one-member wave whose f32
    carries add each placement in turn) against ``place_taskgroup`` on
    the card, bit for bit; 12 placements over 20 nodes land several on
    one node, where the two carry orders would round apart."""
    kins, feats = tp.wave_members(41, variant, n_nodes, lib="port")
    few, _ = tp.wave_members(42, variant, 20, k=12, lib="port")
    for kin, k in [(x, tp.K) for x in kins] + [(few[0], 12)]:
        one = kernel_in_from_numpy(kin, device=cuda_device)
        before = ck.joint_launches
        got = ck.joint_eval_place(one, k, feats)
        assert ck.joint_launches == before + 1
        want = tk.place_taskgroup(one, k, feats)
        _assert_single(got, want)


@pytest.mark.gpu
def test_cuda_default_launch_full_route_is_one_launch(cuda_device):
    """``default_kernel_launch`` of a spread eval on the card: the
    full-width route, one joint launch, the CPU route's outputs."""
    kins, feats = tp.wave_members(43, "spread", 200, lib="port")
    feats = tk.canonical_features(feats)
    before = ck.joint_launches
    got = tk.default_kernel_launch(kins[0], tp.K, feats, device=cuda_device)
    assert ck.joint_launches == before + 1
    want = tk.default_kernel_launch(kins[0], tp.K, feats, device="cpu")
    for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=ATOL)


@pytest.mark.gpu
def test_cuda_launch_wave_outside_the_envelope_is_one_joint_launch(
        cuda_device):
    """A spread wave through ``launch_wave`` with resident usage: one
    joint launch, one fused fallback (the reference's count), no torch-op
    wave, the committed usage the plain wave's."""
    kins, feats = tp.wave_members(44, "everything", 383, lib="port")
    kins = [k._replace(**{f: getattr(kins[0], f)
                          for f in pc._SHAREABLE_FIELDS}) for k in kins]
    used = [np.asarray(getattr(kins[0], f)) for f in
            ("used_cpu", "used_mem", "used_disk")]
    res = pc.ResidentUsage(*used, device=cuda_device)
    pc.fused_wave_stats.reset()
    pc.joint_wave_stats.reset()
    before = (ck.launches, ck.joint_launches)
    got = pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                         device=cuda_device, resident=res)
    assert (ck.launches, ck.joint_launches) == (before[0], before[1] + 1)
    assert pc.fused_wave_stats.snapshot() == {
        "launches": 0, "fallbacks": 1, "failures": 0}
    assert pc.joint_wave_stats.snapshot() == {
        "launches": 1, "sharded_launches": 0, "global_rows": 0,
        "torch_waves": 0}
    cpu = pc.ResidentUsage(*used, device="cpu")
    want = pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                          device="cpu", resident=cpu)
    for g, w in zip(got, want):
        for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(w, name)))
    np.testing.assert_allclose(res.used_cpu.cpu().numpy(),
                               cpu.used_cpu.numpy(), rtol=0, atol=ATOL)


@pytest.mark.gpu
def test_cuda_joint_failure_raises_instead_of_torch_ops(cuda_device,
                                                        monkeypatch):
    """A joint launch the C side refuses, then a joint build that fails:
    each raises through ``launch_wave`` and counts a failure, and no
    torch-op wave runs in its place."""
    kins, feats = tp.wave_members(45, "spread", 200, lib="port")
    ck.load_library("joint_wave")
    plain = []
    monkeypatch.setattr(ck, "fused_wave_place_reference",
                        lambda *a, **k: plain.append(1))
    pc.fused_wave_stats.reset()
    pc.joint_wave_stats.reset()
    _, built, lib = ck._LIBS["joint_wave"]
    monkeypatch.setitem(ck._LIBS, "joint_wave",
                        (lambda *a: 1, built, lib))
    with pytest.raises(RuntimeError, match="joint_wave_kernel launch"):
        pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                       device=cuda_device)

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.delitem(ck._LIBS, "joint_wave")
    monkeypatch.setattr(ck, "build_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                       device=cuda_device)
    assert pc.fused_wave_stats.snapshot()["failures"] == 2
    assert pc.joint_wave_stats.snapshot() == {
        "launches": 0, "sharded_launches": 0, "global_rows": 0,
        "torch_waves": 0}
    assert not plain


def _force_clusters(monkeypatch, dev, clusters):
    """Force the joint plan to ``clusters`` clusters ("max": every
    cluster the card holds at once, at most the kernel's most), laid out
    as the plan lays them out; returns the count."""
    if clusters == "max":
        clusters = min(ck._joint_card(dev)[1], ck.JOINT_MAX_CLUSTERS)
    monkeypatch.setattr(
        ck, "joint_clusters",
        lambda n, b, shuffle, ns, limit, most: ck.joint_layout(
            n, b, shuffle, ns, limit, clusters))
    return clusters


def _interleaved(b=tp.B, k=tp.K):
    """Members' steps interleaved, so each one's counts leave and come
    back."""
    order = np.array([0, 1, 0, 2, 1, 3, 0, 3, 2, 1, 3, 2, 0, 1, 2, 3],
                     np.int32)
    local = np.zeros_like(order)
    for m in range(b):
        local[order == m] = np.arange(k)
    return order, local


def _assert_same(got, want):
    """Two kernel runs' outputs equal bit for bit, the error word 0."""
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert torch.equal(g, w), name
    assert float(got.packed[-1]) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["spread", "everything"])
def test_cuda_joint_wrapper_raises_when_row_does_not_fit(variant,
                                                         cuda_device,
                                                         monkeypatch):
    """2**19 nodes with spreads and shuffle do not fit one cluster's
    shared memory: the plan spreads them over the clusters the card holds
    (each CTA's keys, sums, counts, buckets and ranks in its shared
    memory), bit for bit the plain version, members interleaved so each
    one's counts leave and come back; one full-width single eval too.
    Forced to one cluster, the kernel's global-row instantiation (the
    same rows in a global scratch) gives the same bits."""
    kins, feats = tp.wave_members(27, variant, 300_000, lib="port",
                                  n_pad=1 << 19)
    stacked, _, _, _ = tp.stack_wave(kins)
    order, local = _interleaved()
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    plan = ck.joint_plan(cuda_device, 1 << 19, tp.B, True, feats.n_spreads)
    assert plan.clusters == min(ck._joint_card(cuda_device)[1],
                                ck.JOINT_MAX_CLUSTERS) > 1
    assert plan.global_rows == 0
    before = (ck.joint_launches, ck.joint_global_calls)
    got = ck.joint_wave_place(kin, order, local, len(order), feats)
    assert (ck.joint_launches, ck.joint_global_calls) == (
        before[0] + 1, before[1])
    want = ck.fused_wave_place_reference(kin, order, local, len(order),
                                         feats)
    torch.cuda.synchronize()
    g = _assert_fused(got, want, len(order), tp.B, atol=0.0)
    assert g["found"].any()
    one = kernel_in_from_numpy(kins[0], device=cuda_device)
    single = ck.joint_eval_place(one, tp.K, feats)
    _assert_single(single, tk.place_taskgroup(one, tp.K, feats))
    _force_clusters(monkeypatch, cuda_device, 1)
    assert ck.joint_rows_global(cuda_device, 1 << 19, tp.B, True,
                                feats.n_spreads)
    calls = ck.joint_global_calls
    _assert_same(ck.joint_wave_place(kin, order, local, len(order), feats),
                 got)
    _assert_single(ck.joint_eval_place(one, tp.K, feats), single)
    assert ck.joint_global_calls == calls + 2


@pytest.mark.gpu
@pytest.mark.parametrize("clusters", [2, 4, "max"])
@pytest.mark.parametrize("variant,n_nodes",
                         tp.JOINT_VARIANTS + tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.JOINT_VARIANTS
                              + tp.FUSED_VARIANTS])
def test_cuda_joint_clusters_match_one_cluster(variant, n_nodes, clusters,
                                               cuda_device, monkeypatch):
    """The wave over several clusters on one card (each step's result,
    pin and buckets traded through the mailbox): one launch, bit for bit
    the one-cluster wave and the plain version, the error word 0."""
    kins, feats = tp.wave_members(8, variant, n_nodes, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    one = ck.joint_wave_place(kin, sm, sl, t_pad, feats)
    c = _force_clusters(monkeypatch, cuda_device, clusters)
    assert ck.joint_plan(cuda_device, kin.cap_cpu.shape[-1], tp.B,
                         feats.with_shuffle, feats.n_spreads).clusters == c
    before = ck.joint_launches
    got = ck.joint_wave_place(kin, sm, sl, t_pad, feats)
    assert ck.joint_launches == before + 1
    want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, feats)
    torch.cuda.synchronize()
    _assert_same(got, one)
    g = _assert_fused(got, want, t_pad, tp.B, atol=0.0)
    assert g["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("clusters", [2, 4, "max"])
@pytest.mark.parametrize("mode", ["interleaved", "idle", "no_topk",
                                  "single"])
def test_cuda_joint_clusters_step_orders(mode, clusters, cuda_device,
                                         monkeypatch):
    """The everything wave over several clusters with members'
    steps interleaved, with idle steps (padding members and local steps
    past a member's count), without top-k, and one eval's ``single``
    carries: bit for bit one cluster's and the plain version's."""
    kins, feats = tp.wave_members(33, "everything", 2100, lib="port",
                                  n_pad=16384)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    if mode == "interleaved":
        sm, sl = _interleaved()
        t_pad = len(sm)
    elif mode == "idle":
        sm, sl = sm.copy(), sl.copy()
        sm[1::5] = -1
        sl[2::7] = tp.K + 3
    elif mode == "no_topk":
        feats = feats._replace(with_topk=False)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    if mode == "single":
        one = kernel_in_from_numpy(kins[1], device=cuda_device)
        base = ck.joint_eval_place(one, tp.K, feats)
        _force_clusters(monkeypatch, cuda_device, clusters)
        got = ck.joint_eval_place(one, tp.K, feats)
        _assert_single(got, base)
        _assert_single(got, tk.place_taskgroup(one, tp.K, feats))
        return
    base = ck.joint_wave_place(kin, sm, sl, t_pad, feats)
    _force_clusters(monkeypatch, cuda_device, clusters)
    got = ck.joint_wave_place(kin, sm, sl, t_pad, feats)
    want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, feats)
    torch.cuda.synchronize()
    _assert_same(got, base)
    _assert_fused(got, want, t_pad, tp.B, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("clusters", tp.BOUNDARY_CLUSTERS)
@pytest.mark.parametrize("n_nodes,n_pad", tp.BOUNDARY_WIDTHS,
                         ids=[f"n{n}" for _, n in tp.BOUNDARY_WIDTHS])
def test_cuda_joint_clusters_at_range_edges(n_nodes, n_pad, clusters,
                                            cuda_device, monkeypatch):
    """The waves laid out at a cluster count's CTA ranges (no range count
    divides the width, the pin and penalty nodes in the last range,
    buckets across the ranges' edges), over that many clusters (at most
    the card's): bit for bit one cluster's and the plain version's."""
    kins, feats = tp.boundary_wave(clusters, n_nodes, n_pad, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    base = ck.joint_wave_place(kin, sm, sl, t_pad, feats)
    _force_clusters(monkeypatch, cuda_device,
                    min(clusters, ck._joint_card(cuda_device)[1]))
    got = ck.joint_wave_place(kin, sm, sl, t_pad, feats)
    want = ck.fused_wave_place_reference(kin, sm, sl, t_pad, feats)
    torch.cuda.synchronize()
    _assert_same(got, base)
    assert _assert_fused(got, want, t_pad, tp.B, atol=0.0)["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("clusters", [2, "max"])
def test_cuda_joint_global_rows_over_clusters(clusters, cuda_device,
                                              monkeypatch):
    """The global-row instantiation over several clusters: a layout whose
    shared-memory limit holds only the members' sums puts every CTA's rows
    in the global scratch. The everything wave with members interleaved
    and one eval's ``single`` carries: bit for bit one cluster's
    shared-memory run and the plain version."""
    kins, feats = tp.wave_members(33, "everything", 2100, lib="port",
                                  n_pad=16384)
    stacked, _, _, _ = tp.stack_wave(kins)
    order, local = _interleaved()
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    one = kernel_in_from_numpy(kins[1], device=cuda_device)
    base = ck.joint_wave_place(kin, order, local, len(order), feats)
    base_single = ck.joint_eval_place(one, tp.K, feats)
    if clusters == "max":
        clusters = min(ck._joint_card(cuda_device)[1], ck.JOINT_MAX_CLUSTERS)

    def layout(n, b, shuffle, ns, limit, most):
        member = b * (len(ck.FUSED_METRIC_FIELDS) + 1) * 4
        return ck.joint_layout(n, b, shuffle, ns, member, clusters)

    monkeypatch.setattr(ck, "joint_clusters", layout)
    plan = ck.joint_plan(cuda_device, 16384, tp.B, True, feats.n_spreads)
    assert plan.clusters == clusters and plan.global_rows > 0
    calls = ck.joint_global_calls
    got = ck.joint_wave_place(kin, order, local, len(order), feats)
    single = ck.joint_eval_place(one, tp.K, feats)
    assert ck.joint_global_calls == calls + 2
    want = ck.fused_wave_place_reference(kin, order, local, len(order),
                                         feats)
    torch.cuda.synchronize()
    _assert_same(got, base)
    assert _assert_fused(got, want, len(order), tp.B,
                         atol=0.0)["found"].any()
    _assert_single(single, base_single)
    _assert_single(single, tk.place_taskgroup(one, tp.K, feats))


@pytest.mark.gpu
@pytest.mark.parametrize("n_pad", [1 << 17, 1 << 19])
def test_cuda_joint_plan_at_scale(n_pad, cuda_device):
    """At N=131072 and N=524288 the plan takes every cluster the card
    holds (at most the kernel's most), its rows in shared memory, for
    every union's stanza count."""
    most = min(ck._joint_card(cuda_device)[1], ck.JOINT_MAX_CLUSTERS)
    assert most >= 2
    for ns in (0, 1, 4):
        for shuffle in (False, True):
            p = ck.joint_plan(cuda_device, n_pad, 32, shuffle, ns)
            assert (p.clusters, p.global_rows) == (most, 0), (ns, p)


@pytest.mark.gpu
def test_cuda_joint_layout_mirrors_the_kernel(cuda_device):
    """``joint_layout``'s shared memory, global-row scratch and mailbox,
    and the launch struct, as csrc/joint_wave.cu computes them."""
    ck.load_library("joint_wave")
    lib = ck._LIBS["joint_wave"][2]
    out = (ctypes.c_longlong * 4)()
    for n, b, shuffle, ns, c in ((16384, 32, 1, 1, 1), (131072, 32, 1, 4, 8),
                                 (1000, 4, 0, 0, 3), (3001, 1, 1, 2, 8),
                                 (1 << 19, 32, 1, 4, 7)):
        lib.joint_wave_layout(n, b, shuffle, ns, c, out)
        member = b * 9 * 4
        shared = ck.joint_layout(n, b, shuffle, ns, 1 << 30, c)
        spilled = ck.joint_layout(n, b, shuffle, ns, member, c)
        assert (out[0], out[1]) == (shared.smem, spilled.global_rows)
        assert out[2] == ck._joint_mail(c, b)
        assert out[3] == ctypes.sizeof(ck._JointLaunch)


@pytest.mark.gpu
def test_cuda_joint_clusters_wait_is_bounded(cuda_device, monkeypatch):
    """One of two clusters never publishes its entries: the other's wait
    gives up at the bound, every cluster waits no more, the wave ends,
    and ``launch_wave`` raises through the error word and counts a
    failure; nothing hangs."""
    import time

    ck.load_library("joint_wave")
    _force_clusters(monkeypatch, cuda_device, 2)
    monkeypatch.setattr(ck, "SPIN_S", 0.25)
    fn, built, lib = ck._LIBS["joint_wave"]

    def launch(ref, stream):
        ref._obj.absent = 1
        return fn(ref, stream)

    monkeypatch.setitem(ck._LIBS, "joint_wave", (launch, built, lib))
    kins, feats = tp.wave_members(31, "everything", 383, lib="port")
    pc.fused_wave_stats.reset()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="ran past"):
        pc.launch_wave(kins, [tp.K] * tp.B, [feats] * tp.B,
                       device=cuda_device)
    assert time.perf_counter() - t0 < 30
    assert pc.fused_wave_stats.snapshot()["failures"] == 1


@pytest.mark.gpu
def test_cuda_warmup_launches_the_joint_kernel(cuda_device):
    """A one-device ``joint`` entry outside B1's envelope warms with one
    launch of the joint kernel, and the live key it marks warm is the one
    ``launch_wave`` uses."""
    from nomad_tpu_torch.ops import warmup
    from nomad_tpu_torch.telemetry.kernel_profile import profiler

    feats = tk.canonical_features(tp.variant_features("spread", lib="port"))
    entry = {"kernel": "joint", "wave": 4, "steps": 16, "nodes": 256,
             "shared": True, "neutral_shared": True, "job_shared": True,
             "features": dict(feats._asdict())}
    before = ck.joint_launches
    assert warmup.warmup_entries([entry], device=cuda_device) == (1, 0)
    assert ck.joint_launches == before + 1
    assert ("joint", (4, 16, 256, True, True, True, feats)) in \
        profiler._seen


# ---------------------------------------------------------------------------
# The joint sharded kernel (csrc/joint_sharded_wave.cu): every feature union
# over a mesh of positions, bit for bit against its plain version and the
# one-device joint kernel.
# ---------------------------------------------------------------------------

def _joint_sharded_check(stacked, sm, sl, t_pad, feats, devices):
    """The joint sharded kernel over ``devices`` against its plain version
    on the same shards and against the one-device joint kernel on the
    whole wave: equal bit for bit. One C call, one cluster launch a card,
    no other kernel launched by the call."""
    root = devices[0]
    parts = _shards_on(stacked, devices)
    before = (ck.launches, ck.joint_launches, ck.sharded_launches)
    calls = ck.joint_sharded_launches
    clusters = ck.joint_sharded_kernel_launches()
    got = _whole(ck.joint_sharded_wave_place(parts, sm, sl, t_pad, feats),
                 root)
    assert ck.joint_sharded_launches == calls + 1
    assert (ck.launches, ck.joint_launches, ck.sharded_launches) == before
    assert ck.joint_sharded_kernel_launches() - clusters == len(set(devices))
    b = len(stacked.n_steps)
    ck.raise_on_wave_error(got.packed.cpu().numpy(), t_pad, b)
    plain = _whole(ck.joint_sharded_wave_place_reference(
        parts, sm, sl, t_pad, feats), root)
    kin = kernel_in_from_numpy(stacked, device=root)
    one = ck.joint_wave_place(kin, torch.from_numpy(sm).to(root),
                              torch.from_numpy(sl).to(root), t_pad, feats)
    torch.cuda.synchronize()
    _assert_fused(got, plain, t_pad, b, atol=0.0)
    return _assert_fused(got, one, t_pad, b, atol=0.0)


JOINT_UNIONS = tuple(v for v, _ in tp.JOINT_VARIANTS) + ("kitchen_sink",)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8, 16])
@pytest.mark.parametrize("variant", JOINT_UNIONS)
def test_cuda_joint_sharded_kernel_matches_plain_and_joint(variant, shards,
                                                          cuda_device):
    """Every union (each of spreads, devices, cores and bandwidth alone,
    all four with the kitchen sink's planes, and the fused envelope's
    kitchen sink) at N=16384 over 2, 4, 8 and 16 virtual shards."""
    kins, feats = tp.wave_members(12, variant, 10_000, lib="port",
                                  n_pad=16384)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _joint_sharded_check(stacked, sm, sl, t_pad, feats,
                             [cuda_device] * shards)
    assert g["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["spread", "everything"])
def test_cuda_joint_sharded_kernel_at_scale(variant, cuda_device):
    """N=131072 over eight virtual shards: 8192 rows a CTA."""
    kins, feats = tp.wave_members(13, variant, 100_000, lib="port",
                                  n_pad=131072)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _joint_sharded_check(stacked, sm, sl, t_pad, feats,
                             [cuda_device] * 8)
    assert g["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["spread", "everything"])
def test_cuda_joint_sharded_kernel_range_crosses_a_position(variant,
                                                           cuda_device):
    """N=4004 over four shards: a CTA's range ends one position and
    begins the next off the warps' grid; each row keeps its own
    position's planes, buckets, carries and global index."""
    kins, feats = tp.wave_members(26, variant, 3990, lib="port", n_pad=4004)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _joint_sharded_check(stacked, sm, sl, t_pad, feats,
                             [cuda_device] * 4)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_joint_sharded_kernel_members_interleave(cuda_device):
    """The everything wave with its members' steps interleaved: each
    member's spread counts go to the CTAs' scratch and come back, and a
    pending bump lands before the next member's row is built."""
    kins, feats = tp.wave_members(28, "everything", 2000, lib="port",
                                  n_pad=4096)
    stacked, _, _, _ = tp.stack_wave(kins)
    order = np.array([0, 1, 0, 2, 1, 3, 0, 3, 2, 1, 3, 2, 0, 1, 2, 3],
                     np.int32)
    local = np.zeros_like(order)
    for m in range(tp.B):
        local[order == m] = np.arange(tp.K)
    g = _joint_sharded_check(stacked, order, local, len(order), feats,
                             [cuda_device] * 4)
    assert g["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["spread", "everything"])
def test_cuda_joint_sharded_kernel_idle_steps_and_no_topk(variant,
                                                          cuda_device):
    """Members with fewer steps than the bucket (and one with none): the
    idle outputs; with top-k off the planes are 0 / NEG_INF."""
    kins, feats = tp.wave_members(9, variant, 200, lib="port")
    kins = [k._replace(n_steps=np.asarray(n, np.int32))
            for k, n in zip(kins, (4, 0, 2, 3))]
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    for f in (feats, feats._replace(with_topk=False)):
        _joint_sharded_check(stacked, sm, sl, t_pad, f, [cuda_device] * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pad,shards", ((64, 16), (32, 8), (16, 4)),
                         ids=("n64-d16", "n32-d8", "n16-d4"))
def test_cuda_joint_sharded_kernel_narrow_shards(n_pad, shards, cuda_device):
    """Shards of four rows, under TOPK: the merged top-8 is the plain
    version's merge of each shard's top four."""
    kins, feats = tp.wave_members(29, "everything", n_pad - 2, lib="port",
                                  n_pad=n_pad)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _joint_sharded_check(stacked, sm, sl, t_pad, feats,
                             [cuda_device] * shards)
    assert g["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [[(0, [0, 2]), (0, [1, 3])],
                                    [(0, [0, 1]), (0, [2, 3])]],
                         ids=["interleaved", "halves"])
@pytest.mark.parametrize("variant", ["spread", "devices", "everything"])
def test_cuda_joint_sharded_kernel_exchange_on_one_card(variant, groups,
                                                        cuda_device,
                                                        monkeypatch):
    """The several-card kernel (mailboxes, tags, the buckets handed on
    with each card's argmax and pin, the root's top-k and metrics from
    every card) as two clusters on one card: bit for bit the one-device
    joint kernel, two kernel launches, no error word."""
    ck.load_library("joint_sharded_wave")
    s0, s1 = _two_clusters_on_one_card(monkeypatch, cuda_device, groups,
                                       lib_name="joint_sharded_wave")
    kins, feats = tp.wave_members(30, variant, 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    parts = _shards_on(stacked, [cuda_device] * 4)
    clusters = ck.joint_sharded_kernel_launches()
    out = ck.joint_sharded_wave_place(parts, sm, sl, t_pad, feats)
    _assert_joined(s0, s1)
    got = _whole(out, cuda_device)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    one = ck.joint_wave_place(kin, torch.from_numpy(sm).to(cuda_device),
                              torch.from_numpy(sl).to(cuda_device), t_pad,
                              feats)
    torch.cuda.synchronize()
    assert ck.joint_sharded_kernel_launches() - clusters == 2
    ck.raise_on_wave_error(got.packed.cpu().numpy(), t_pad, tp.B)
    g = _assert_fused(got, one, t_pad, tp.B, atol=0.0)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_joint_sharded_kernel_wait_is_bounded(cuda_device, monkeypatch):
    """Two "cards" on one stream: the first waits for the second, which
    cannot start before it ends; each wait gives up at the bound and the
    error word raises."""
    import time

    ck.load_library("joint_sharded_wave")
    _two_clusters_on_one_card(monkeypatch, cuda_device,
                              [(0, [0, 1]), (0, [2, 3])], same_stream=True,
                              lib_name="joint_sharded_wave")
    monkeypatch.setattr(ck, "SPIN_S", 0.25)
    kins, feats = tp.wave_members(31, "everything", 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    parts = _shards_on(stacked, [cuda_device] * 4)
    t0 = time.perf_counter()
    got = ck.joint_sharded_wave_place(parts, sm, sl, t_pad, feats)
    packed = got.packed.cpu().numpy()
    assert time.perf_counter() - t0 < 30
    with pytest.raises(RuntimeError, match="ran past"):
        ck.raise_on_wave_error(packed, t_pad, tp.B)


@pytest.mark.gpu
def test_cuda_joint_sharded_kernel_buffers_outlive_every_card(
        cuda_device, monkeypatch):
    """The first card's kernel is launched, the second card's launch
    fails: the stream that frees the second card's mailbox waits for the
    first card's kernel, which stores into it up to the bound."""
    ck.load_library("joint_sharded_wave")
    s0, s1 = _two_clusters_on_one_card(
        monkeypatch, cuda_device, [(0, [0, 1]), (0, [2, 3])],
        root_second=True, fail_second=True, lib_name="joint_sharded_wave",
        card=ck._JCard)
    monkeypatch.setattr(ck, "SPIN_S", 0.25)
    kins, feats = tp.wave_members(31, "everything", 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    parts = _shards_on(stacked, [cuda_device] * 4)
    torch.cuda.synchronize()
    clusters = ck.joint_sharded_kernel_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        ck.joint_sharded_wave_place(parts, sm, sl, t_pad, feats)
    assert ck.joint_sharded_kernel_launches() - clusters == 1
    n = ck._joint_mail(2, len(stacked.n_steps))
    held = [torch.full((n,), 0x5A, dtype=torch.uint8, device=cuda_device)
            for _ in range(64)]
    _assert_joined(s0, s1)
    torch.cuda.synchronize()
    assert all(bool((x == 0x5A).all()) for x in held)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["cards", "interleaved"])
@pytest.mark.parametrize("variant", ["spread", "everything"])
def test_cuda_joint_sharded_kernel_over_several_cards(variant, layout,
                                                      cuda_device):
    """A mesh of real cards (every card, or cards 0, 1, 0, 1): one
    cluster launch a card, each step's result and buckets pushed into
    every card's mailbox over NVLink; the wave equals the one-device joint
    kernel's on the first card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards or more; this host has {n}")
    cards = [torch.device("cuda", i) for i in range(n)]
    devices = cards if layout == "cards" else [cards[0], cards[1]] * 2
    kins, feats = tp.wave_members(30, variant, 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _joint_sharded_check(stacked, sm, sl, t_pad, feats, devices)
    assert g["found"].any()


def _force_sharded_clusters(monkeypatch, dev, clusters, limit=None):
    """Force the joint sharded plan to ``clusters`` clusters a card
    ("max": every cluster the card holds, at most the kernel's most),
    laid out as the plan lays them out; with ``limit`` the shared memory a
    block may take is that (a limit under a CTA's rows puts them in the
    global scratch). Returns the count."""
    if clusters == "max":
        clusters = min(ck._joint_sharded_card(dev.index or 0)[1],
                       ck.JOINT_MAX_CLUSTERS)
    monkeypatch.setattr(
        ck, "joint_sharded_clusters",
        lambda rows, b, shuffle, ns, lim, most, n_cards:
        ck.joint_sharded_layout(rows, b, shuffle, ns,
                                lim if limit is None else limit, clusters,
                                n_cards))
    return clusters


def _joint_sharded_run(stacked, sm, sl, t_pad, feats, devices):
    """The joint sharded kernel's whole output over ``devices`` (carries
    gathered on the first), its error word read; one C call."""
    parts = _shards_on(stacked, devices)
    calls = ck.joint_sharded_launches
    got = _whole(ck.joint_sharded_wave_place(parts, sm, sl, t_pad, feats),
                 devices[0])
    assert ck.joint_sharded_launches == calls + 1
    ck.raise_on_wave_error(got.packed.cpu().numpy(), t_pad,
                           len(stacked.n_steps))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("clusters", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("shards", [2, 4, 8, 16])
@pytest.mark.parametrize("variant", JOINT_UNIONS)
def test_cuda_joint_sharded_clusters_match_one_cluster(variant, shards,
                                                       clusters, cuda_device,
                                                       monkeypatch):
    """Every union at N=16384 over D virtual shards on one card, as each
    forced count of clusters (at most the card's): one launch, its CTAs'
    ranges crossing the positions' edges, the clusters trading each step
    through the card's mailbox; bit for bit the one-cluster run, which
    equals the one-device joint kernel."""
    kins, feats = tp.wave_members(12, variant, 10_000, lib="port",
                                  n_pad=16384)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    devices = [cuda_device] * shards
    if clusters > ck._joint_sharded_card(cuda_device.index or 0)[1]:
        pytest.skip(f"the card holds fewer than {clusters} clusters")
    _force_sharded_clusters(monkeypatch, cuda_device, 1)
    base = _joint_sharded_run(stacked, sm, sl, t_pad, feats, devices)
    _force_sharded_clusters(monkeypatch, cuda_device, clusters)
    launches = ck.joint_sharded_kernel_launches()
    got = _joint_sharded_run(stacked, sm, sl, t_pad, feats, devices)
    assert ck.joint_sharded_kernel_launches() - launches == 1
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    one = ck.joint_wave_place(kin, torch.from_numpy(sm).to(cuda_device),
                              torch.from_numpy(sl).to(cuda_device), t_pad,
                              feats)
    torch.cuda.synchronize()
    _assert_same(got, base)
    assert _assert_fused(got, one, t_pad, tp.B, atol=0.0)["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("clusters", [1, 2, "max"])
@pytest.mark.parametrize("mode", ["interleaved", "idle", "no_topk"])
def test_cuda_joint_sharded_global_rows(mode, clusters, cuda_device,
                                        monkeypatch):
    """The global-row instantiation: a shared-memory limit that holds
    only the members' sums puts every CTA's rows in the card's global
    scratch. The everything wave over four shards with members
    interleaved, with idle steps, and without top-k: bit for bit the
    shared-memory run on one cluster, and the plain version."""
    kins, feats = tp.wave_members(33, "everything", 2100, lib="port",
                                  n_pad=16384)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    if mode == "interleaved":
        sm, sl = _interleaved()
        t_pad = len(sm)
    elif mode == "idle":
        sm, sl = sm.copy(), sl.copy()
        sm[1::5] = -1
        sl[2::7] = tp.K + 3
    else:
        feats = feats._replace(with_topk=False)
    devices = [cuda_device] * 4
    _force_sharded_clusters(monkeypatch, cuda_device, 1)
    base = _joint_sharded_run(stacked, sm, sl, t_pad, feats, devices)
    member = tp.B * (len(ck.FUSED_METRIC_FIELDS) + 1) * 4
    c = _force_sharded_clusters(monkeypatch, cuda_device, clusters,
                                limit=member)
    plan = ck.joint_sharded_plan([cuda_device.index or 0], 16384, tp.B,
                                 True, feats.n_spreads)
    assert plan.clusters == c and plan.global_rows > 0
    calls = ck.joint_sharded_global_calls
    got = _joint_sharded_run(stacked, sm, sl, t_pad, feats, devices)
    assert ck.joint_sharded_global_calls == calls + 1
    plain = _whole(ck.joint_sharded_wave_place_reference(
        _shards_on(stacked, devices), sm, sl, t_pad, feats), cuda_device)
    torch.cuda.synchronize()
    _assert_same(got, base)
    _assert_fused(got, plain, t_pad, tp.B, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["shuffle", "everything"])
def test_cuda_joint_sharded_kernel_past_one_cluster(variant, cuda_device):
    """N=524288 over four virtual shards on one card, which one cluster's
    shared memory does not hold (the parent's wrapper raised here): the
    plan takes every cluster the card holds with the rows in shared
    memory; one launch, bit for bit the one-device joint kernel."""
    kins, feats = tp.wave_members(27, variant, 300_000, lib="port",
                                  n_pad=1 << 19)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    plan = ck.joint_sharded_plan([cuda_device.index or 0], 1 << 19, tp.B,
                                 feats.with_shuffle, feats.n_spreads)
    assert plan.clusters == min(
        ck._joint_sharded_card(cuda_device.index or 0)[1],
        ck.JOINT_MAX_CLUSTERS) > 1
    assert plan.global_rows == 0
    launches = ck.joint_sharded_kernel_launches()
    got = _joint_sharded_run(stacked, sm, sl, t_pad, feats,
                             [cuda_device] * 4)
    assert ck.joint_sharded_kernel_launches() - launches == 1
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    one = ck.joint_wave_place(kin, torch.from_numpy(sm).to(cuda_device),
                              torch.from_numpy(sl).to(cuda_device), t_pad,
                              feats)
    torch.cuda.synchronize()
    assert _assert_fused(got, one, t_pad, tp.B, atol=0.0)["found"].any()


@pytest.mark.gpu
def test_cuda_joint_sharded_layout_mirrors_the_kernel(cuda_device):
    """``joint_sharded_layout``'s shared memory, global-row scratch and
    mailbox, as csrc/joint_sharded_wave.cu computes them; the structs
    and bounds are held at the first plan (``_joint_sharded_card``)."""
    ck._joint_sharded_card(cuda_device.index or 0)
    lib = ck._LIBS["joint_sharded_wave"][2]
    out = (ctypes.c_longlong * 3)()
    for rows, b, shuffle, ns, c, cards in (
            (16384, 32, 1, 1, 1, 1), (131072, 32, 1, 4, 7, 1),
            (1000, 4, 0, 0, 3, 2), (4004, 1, 1, 2, 8, 4),
            (1 << 19, 32, 1, 4, 7, 1), (262144, 32, 1, 4, 7, 4)):
        lib.joint_sharded_layout(rows, b, shuffle, ns, c, c * cards, out)
        member = b * 9 * 4
        shared = ck.joint_sharded_layout(rows, b, shuffle, ns, 1 << 30, c,
                                         cards)
        spilled = ck.joint_sharded_layout(rows, b, shuffle, ns, member, c,
                                          cards)
        assert (out[0], out[1]) == (shared.smem, spilled.global_rows)
        assert out[2] == ck._joint_mail(c * cards, b)
        assert shared.mail == (out[2] if c * cards > 1 else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("clusters", [2, 3])
@pytest.mark.parametrize("variant", ["spread", "everything"])
def test_cuda_joint_sharded_clusters_on_two_cards_of_one(variant, clusters,
                                                        cuda_device,
                                                        monkeypatch):
    """The several-card kernel with several clusters a card (every
    cluster of every card a participant of the flat exchange) as two
    "cards" on two streams of one card: bit for bit the one-device joint
    kernel and the one-cluster run, no error word."""
    ck.load_library("joint_sharded_wave")
    kins, feats = tp.wave_members(12, variant, 10_000, lib="port",
                                  n_pad=16384)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    devices = [cuda_device] * 4
    _force_sharded_clusters(monkeypatch, cuda_device, 1)
    base = _joint_sharded_run(stacked, sm, sl, t_pad, feats, devices)
    s0, s1 = _two_clusters_on_one_card(
        monkeypatch, cuda_device, [(0, [0, 2]), (0, [1, 3])],
        lib_name="joint_sharded_wave")
    _force_sharded_clusters(monkeypatch, cuda_device, clusters)
    launches = ck.joint_sharded_kernel_launches()
    got = _joint_sharded_run(stacked, sm, sl, t_pad, feats, devices)
    _assert_joined(s0, s1)
    assert ck.joint_sharded_kernel_launches() - launches == 2
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    one = ck.joint_wave_place(kin, torch.from_numpy(sm).to(cuda_device),
                              torch.from_numpy(sl).to(cuda_device), t_pad,
                              feats)
    torch.cuda.synchronize()
    _assert_same(got, base)
    assert _assert_fused(got, one, t_pad, tp.B, atol=0.0)["found"].any()


@pytest.mark.gpu
@pytest.mark.parametrize("clusters", [1, 2, 4, 7])
def test_cuda_joint_sharded_clusters_over_several_cards(clusters,
                                                        cuda_device,
                                                        monkeypatch):
    """Every card of the host as a mesh position, at N=131072, forced to
    each count of clusters a card: bit for bit the one-device joint
    kernel on the first card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards or more; this host has {n}")
    cards = [torch.device("cuda", i) for i in range(n)]
    if clusters * n > ck.JOINT_SHARDED_MAX_PARTS:
        pytest.skip(f"{clusters} clusters on {n} cards is over the wave's "
                    f"{ck.JOINT_SHARDED_MAX_PARTS} participants")
    _force_sharded_clusters(monkeypatch, cuda_device, clusters)
    kins, feats = tp.wave_members(13, "everything", 100_000, lib="port",
                                  n_pad=131072)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    g = _joint_sharded_check(stacked, sm, sl, t_pad, feats, cards)
    assert g["found"].any()


@pytest.mark.gpu
def test_cuda_joint_sharded_clusters_wait_is_bounded(cuda_device,
                                                     monkeypatch):
    """One of two clusters on one card never publishes its entries: the
    other's wait gives up at the bound, every cluster waits no more, the
    wave ends, and the error word raises; nothing hangs."""
    import time

    ck.load_library("joint_sharded_wave")
    _force_sharded_clusters(monkeypatch, cuda_device, 2)
    monkeypatch.setattr(ck, "SPIN_S", 0.25)
    fn, built, lib = ck._LIBS["joint_sharded_wave"]

    def launch(ref):
        ref._obj.absent = 1
        return fn(ref)

    monkeypatch.setitem(ck._LIBS, "joint_sharded_wave", (launch, built, lib))
    kins, feats = tp.wave_members(31, "everything", 383, lib="port")
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    parts = _shards_on(stacked, [cuda_device] * 4)
    t0 = time.perf_counter()
    got = ck.joint_sharded_wave_place(parts, sm, sl, t_pad, feats)
    packed = got.packed.cpu().numpy()
    assert time.perf_counter() - t0 < 30
    with pytest.raises(RuntimeError, match=r"ran past.*\[0\]"):
        ck.raise_on_wave_error(packed, t_pad, tp.B)


@pytest.mark.gpu
def test_cuda_launch_wave_spread_over_a_virtual_mesh(cuda_device):
    """A spread wave through ``launch_wave`` over a virtual mesh of four:
    one call of the joint sharded kernel and one cluster launch, counted
    as a fused fallback and a sharded joint launch, no torch-op wave;
    its members' outputs the one-device wave's."""
    from nomad_tpu_torch.parallel import sharded

    kins, feats = tp.wave_members(32, "spread", 383, lib="port")
    steps = [tp.K] * len(kins)
    mesh = sharded.wave_mesh(devices=[cuda_device] * 4)
    pc.fused_wave_stats.reset()
    pc.joint_wave_stats.reset()
    calls = ck.joint_sharded_launches
    clusters = ck.joint_sharded_kernel_launches()
    got = pc.launch_wave(kins, steps, [feats] * len(kins),
                         device=cuda_device, mesh=mesh)
    assert ck.joint_sharded_launches - calls == 1
    assert ck.joint_sharded_kernel_launches() - clusters == 1
    assert pc.joint_wave_stats.snapshot() == {
        "launches": 0, "sharded_launches": 1, "global_rows": 0,
        "torch_waves": 0}
    assert pc.fused_wave_stats.snapshot() == {
        "launches": 0, "fallbacks": 1, "failures": 0}
    want = pc.launch_wave(kins, steps, [feats] * len(kins),
                          device=cuda_device)
    for g, w in zip(got, want):
        for name in ("chosen", "found", "scores", "topk_idx",
                     "topk_scores") + tk.FUSED_METRIC_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(w, name)),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# The single eval's candidate set (csrc/candidate_set.cu) against its plain
# version, place_taskgroup_topk, on the card: bit for bit.
# ---------------------------------------------------------------------------

def _candidate_check(kin, k, feats, dev, n_candidates=0):
    """One call of the kernel on one eval's planes against the plain
    version on the same tensors: outputs and ``valid`` equal bit for bit.
    Returns ``(out, valid)``."""
    one = kernel_in_from_numpy(kin, device=dev)
    before = ck.candidate_launches
    got, ok = ck.candidate_eval_place(one, k, feats, n_candidates)
    assert ck.candidate_launches == before + 1
    want, want_ok = tk.place_taskgroup_topk(one, k, feats, n_candidates)
    _assert_single(got, want)
    assert bool(ok) == bool(want_ok)
    return got, bool(ok)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,n_nodes", tp.CANDIDATE_VARIANTS,
                         ids=[v for v, _ in tp.CANDIDATE_VARIANTS])
def test_cuda_candidate_eval_matches_plain_version(variant, n_nodes,
                                                   cuda_device):
    for k in (1, 4, 12, 40):
        kin, feats = tp.candidate_member(50, variant, n_nodes, k, lib="port")
        got, ok = _candidate_check(kin, k, feats, cuda_device)
        assert ok and bool(got.found.any())


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes", (60, 1000, 16384, 131072))
def test_cuda_candidate_eval_at_every_width(n_nodes, cuda_device):
    """16 steps, 10 of them active (the live bucket of 10 placements)."""
    for variant in ("lean", "kitchen_sink", "no_spread"):
        kin, feats = tp.candidate_member(51, variant, n_nodes, 16,
                                         lib="port")
        kin = kin._replace(n_steps=np.asarray(10, np.int32))
        got, _ = _candidate_check(kin, 16, feats, cuda_device)
        assert not bool(got.found[10:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("k", (1, 8, 64, 256, 600))
def test_cuda_candidate_rows_past_shared_memory(k, cuda_device):
    """K to 600 at N=4096: the heads' rows of 1800 rows pass a block's
    shared memory and live in the global scratch; no K is refused."""
    kin, feats = tp.candidate_member(52, "kitchen_sink", 4000, k, lib="port")
    _, smem = ck.candidate_plan(cuda_device, 4096, k, max(2 * k, k + 8),
                                True)
    assert (smem == 0) == (k == 600)
    _candidate_check(kin, k, feats, cuda_device)


@pytest.mark.gpu
def test_cuda_candidate_tie_run_straddles_the_candidate_edge(cuda_device):
    """Eight candidates end inside a run of equal scores: the kernel keeps
    the run's lowest nodes and the run's score as rest max."""
    kin, uc, um, ac, am, _ = tp.tie_straddle_case(41, lib="port")
    kin = kin._replace(used_cpu=uc, used_mem=um, ask_cpu=ac[0],
                       ask_mem=am[0])
    feats = tk.LEAN_FEATURES._replace(with_topk=True)
    for n_candidates in (8, 0):
        _candidate_check(kin, 10, feats, cuda_device, n_candidates)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("missing", "bound"))
def test_cuda_candidate_valid_false(case, cuda_device):
    """Both of ``valid``'s conditions, reached through few candidates."""
    make = {"missing": tp.candidate_missing_case,
            "bound": tp.candidate_bound_case}[case]
    kin, feats, k, n_candidates = make(lib="port")
    _, ok = _candidate_check(kin, k, feats, cuda_device, n_candidates)
    assert not ok


@pytest.mark.gpu
def test_cuda_candidate_pins_repeat_candidates(cuda_device):
    kin, feats, k = tp.candidate_pinned_case(lib="port")
    got, ok = _candidate_check(kin, k, feats, cuda_device)
    assert ok and bool(got.found.all())


@pytest.mark.gpu
@pytest.mark.parametrize("k", (1, 16, 64, 256, 600))
def test_cuda_candidate_penalties_and_pins_change_every_step(k, cuda_device):
    """Step penalties that hit candidate rows at every step and change
    from step to step, and pins that repeat candidates and each other
    (``tp.candidate_churn_case``), to K=600 where the heads' rows live in
    the global scratch: every cached key is what a rescore gives."""
    for variant in ("kitchen_sink", "no_spread"):
        kin, feats = tp.candidate_churn_case(56, 4000, k, variant,
                                             lib="port")
        _candidate_check(kin, k, feats, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes", (16384, 131072))
def test_cuda_candidate_every_union_at_the_live_widths(n_nodes, cuda_device):
    """Every union without a spread, 16 steps of which 10 active."""
    for variant, _ in tp.CANDIDATE_VARIANTS:
        kin, feats = tp.candidate_member(57, variant, n_nodes, 16,
                                         lib="port")
        kin = kin._replace(n_steps=np.asarray(10, np.int32))
        _candidate_check(kin, 16, feats, cuda_device)


def _host_equal(got, want):
    """Two ``_read_single`` results: equal values, dtypes and shapes."""
    (g, g_ok), (w, w_ok) = got, want
    assert g_ok == w_ok
    for name in tk.KernelOut._fields:
        a, b = getattr(g, name), getattr(w, name)
        if isinstance(b, int):
            assert type(a) is int and a == b, name
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.gpu
def test_cuda_candidate_packed_readback(cuda_device):
    """The kernel's outputs are views of one buffer that
    ``ck.candidate_readback`` copies back at once; the host arrays equal
    those of the plain version's outputs read back through torch ops
    (``_read_single``), and the plain tensors are refused."""
    for variant, k in (("kitchen_sink", 16), ("no_spread", 3), ("lean", 1)):
        kin, feats = tp.candidate_member(58, variant, 383, k, lib="port")
        one = kernel_in_from_numpy(kin, device=cuda_device)
        got, ok = ck.candidate_eval_place(one, k, feats)
        want, want_ok = tk.place_taskgroup_topk(one, k, feats)
        with pytest.raises(ValueError):
            ck.candidate_readback(want, want_ok, k)
        _host_equal(ck.candidate_readback(got, ok, k),
                    tk._read_single(want, want_ok, k))


@pytest.mark.gpu
def test_cuda_candidate_readback_is_one_copy(cuda_device):
    """The ``single_topk`` route (``default_kernel_launch``) as the device
    sees it, in the profiler's trace: after the planes' upload, the
    kernel's two launches, then one device-to-host copy of all the call's
    outputs, and no torch op between the kernel and that copy."""
    from torch.autograd import DeviceType

    kin, feats = tp.candidate_member(58, "kitchen_sink", 383, 16,
                                     lib="port")
    feats = tk.canonical_features(feats)
    tk.single_eval_stats.reset()
    want = tk.default_kernel_launch(kin, 16, feats, device=cuda_device)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = tk.default_kernel_launch(kin, 16, feats, device=cuda_device)
        torch.cuda.synchronize()
    assert tk.single_eval_stats.snapshot() == {
        "topk": 2, "breaches": 0, "full": 0}
    _host_equal((got, True), (want, True))
    ops = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    first = next(i for i, name in enumerate(ops) if "cand_pass" in name)
    assert len(ops) == first + 3, ops
    assert "cand_scan" in ops[first + 1] and "DtoH" in ops[first + 2], ops


@pytest.mark.gpu
def test_cuda_candidate_concurrent_calls(cuda_device):
    """Four threads call the kernel at once on one card, each on a stream
    of its own (worker threads and the warmup thread do): each call has its
    own buffer, so each gets its own eval's answer."""
    from concurrent.futures import ThreadPoolExecutor
    import threading

    evals = []
    for j, variant in enumerate(("lean", "shuffle", "kitchen_sink",
                                 "no_spread")):
        kin, feats = tp.candidate_member(59 + j, variant, 383, 16,
                                         lib="port")
        one = kernel_in_from_numpy(kin, device=cuda_device)
        evals.append((one, feats,
                      tk._read_single(*tk.place_taskgroup_topk(one, 16,
                                                               feats), 16)))
    torch.cuda.synchronize()
    start = threading.Barrier(len(evals))

    def run(j):
        one, feats, _ = evals[j]
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            start.wait()
            return [ck.candidate_readback(
                *ck.candidate_eval_place(one, 16, feats), 16)
                for _ in range(20)]

    before = ck.candidate_launches
    with ThreadPoolExecutor(len(evals)) as pool:
        results = list(pool.map(run, range(len(evals))))
    assert ck.candidate_launches == before + 20 * len(evals)
    for (_, _, want), got in zip(evals, results):
        for host in got:
            _host_equal(host, want)


@pytest.mark.gpu
def test_cuda_default_launch_candidate_route(cuda_device, monkeypatch):
    """``default_kernel_launch`` of a lean eval on the card is one call of
    the candidate kernel and no joint launch; a breach (two candidates,
    forced) is one of each and hands back the full-width placement."""
    kin, feats = tp.candidate_member(53, "lean", 200, tp.K, lib="port")
    feats = tk.canonical_features(feats)
    tk.single_eval_stats.reset()
    before = (ck.candidate_launches, ck.joint_launches)
    got = tk.default_kernel_launch(kin, tp.K, feats, device=cuda_device)
    assert (ck.candidate_launches, ck.joint_launches) == (
        before[0] + 1, before[1])
    assert tk.single_eval_stats.snapshot() == {
        "topk": 1, "breaches": 0, "full": 0}
    want = tk.default_kernel_launch(kin, tp.K, feats, device="cpu")
    for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=ATOL)

    kin, feats, k, n_candidates = tp.candidate_missing_case(lib="port")
    feats = tk.canonical_features(feats)
    real = ck.candidate_eval_place
    monkeypatch.setattr(ck, "candidate_eval_place",
                        lambda kin, k, f: real(kin, k, f, n_candidates))
    tk.single_eval_stats.reset()
    before = (ck.candidate_launches, ck.joint_launches)
    got = tk.default_kernel_launch(kin, k, feats, device=cuda_device)
    assert (ck.candidate_launches, ck.joint_launches) == (
        before[0] + 1, before[1] + 1)
    assert tk.single_eval_stats.snapshot() == {
        "topk": 1, "breaches": 1, "full": 1}
    full = tk.place_taskgroup(kernel_in_from_numpy(kin, device=cuda_device),
                              k, feats)
    for name in ("chosen", "found", "scores", "topk_idx"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)),
            getattr(full, name).cpu().numpy(), err_msg=name)


@pytest.mark.gpu
def test_cuda_warmup_launches_the_candidate_kernel(cuda_device):
    """A ``single_topk`` warmup entry is one call of the candidate kernel."""
    from nomad_tpu_torch.ops import warmup

    feats = tk.canonical_features(tk.LEAN_FEATURES._replace(with_topk=True))
    entry = {"kernel": "single_topk", "nodes": 256, "steps": 16,
             "features": dict(feats._asdict())}
    before = (ck.candidate_launches, ck.joint_launches)
    assert warmup.warmup_entries([entry], device=cuda_device) == (1, 0)
    assert (ck.candidate_launches, ck.joint_launches) == (
        before[0] + 1, before[1])
