"""The CUDA kernels against their plain torch versions, on the card.

Imports nothing of JAX or of ``nomad_tpu`` (members come from the port's
own synthetic builders), so it runs where only the port is installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py

Every test takes the ``cuda_device`` fixture, which skips without a card.
Choices, found, ``valid``, top-k indices and metrics must match exactly;
scores, top-k scores and carries within 1e-5.
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
    """Each CTA keeps its node range's scores and ranks in shared memory:
    2**19 nodes over one cluster do not fit, and the wrapper says so
    before launching."""
    assert ck.fused_wave_cluster_size() == 16
    kins, feats = tp.wave_members(25, "shuffle", 1000, b=1, lib="port",
                                  n_pad=1 << 19)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device=cuda_device)
    before = ck.launches
    with pytest.raises(ValueError, match="limit of [0-9]+ B"):
        ck.fused_wave_place(kin, sm, sl, t_pad, feats)
    assert ck.launches == before


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

    srv = Server(ServerConfig(num_workers=1, worker_batch_size=8,
                              heartbeat_ttl=60.0, gc_tuning=False),
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
