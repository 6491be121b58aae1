"""Live waves over the device mesh, the port against the JAX package.

Counterparts of ``tests/test_sharded_waves.py``: ``launch_wave(mesh=)``
splits the wave's node axis over the mesh's devices and must place
exactly as the one-device wave does, with no fallback; shared planes
resident split over the mesh upload nothing on a repeat wave; a mesh
that does not divide the node axis runs the wave on one device,
counted; sharded waves' keys fold back into mesh-agnostic manifest
entries; and a port server over an 8-entry CPU mesh places a burst as a
JAX server over its 8 virtual devices does. The port's own rules are
held too: a fused sharded launch that raises fails its wave, counted,
and nothing runs in its place; ``use_device_mesh=None`` adopts a mesh
over the cards only; and the warmup's mesh pass warms the keys a mesh
server launches, with the reference's skip and route rules, while
adopting a mesh without warmup launches nothing.

The port's mesh is eight CPU entries (``devices=[cpu] * 8``, the
``cpu8`` fixture), the counterpart of the conftest's eight virtual JAX
devices. Every wave's node axis is at least 256 rows (32 a shard; see
``tests/test_torch_mesh.py`` on the CPU's scalar tail).
"""

import numpy as np
import pytest
import torch

import jax

from nomad_tpu import mock
from nomad_tpu.ops import warmup as ref_warmup
from nomad_tpu.ops.kernel import LEAN_FEATURES as REF_LEAN
from nomad_tpu.ops.kernel import build_kernel_in as ref_build_kernel_in
from nomad_tpu.parallel import coalesce as ref_coalesce
from nomad_tpu.parallel import sharded as ref_sharded
from nomad_tpu.parallel.synthetic import synthetic_cluster as ref_cluster
from nomad_tpu.parallel.synthetic import synthetic_eval as ref_eval
from nomad_tpu.structs import consts
from nomad_tpu.structs.constraints import Constraint
from nomad_tpu_torch import telemetry
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.ops import warmup as kernel_warmup
from nomad_tpu_torch.parallel import coalesce
from nomad_tpu_torch.parallel import sharded
from nomad_tpu_torch.parallel.synthetic import synthetic_cluster, synthetic_eval
from nomad_tpu_torch.telemetry.kernel_profile import profiler
from nomad_tpu_torch.tensors.device_state import default_device_state

from test_torch_server import Pair, allocs_by_name, eval_rows


CPU = torch.device("cpu")


@pytest.fixture()
def cpu8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return [CPU] * 8


@pytest.fixture()
def wave_mesh(cpu8):
    return sharded.wave_mesh(devices=cpu8)


@pytest.fixture()
def counts():
    """Fresh wave counters, and the process-wide state given back as it
    was."""
    prior = default_device_state.mesh
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()
    default_device_state.configure_mesh(prior)


def _assert_same_outs(a_outs, b_outs, scores_exact=True):
    for a, b in zip(a_outs, b_outs):
        for name in ("chosen", "found", "nodes_evaluated", "nodes_feasible",
                     "exhausted_cpu", "exhausted_mem"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)), name)
        np.testing.assert_array_equal(np.asarray(a.topk_idx),
                                      np.asarray(b.topk_idx))
        if scores_exact:
            np.testing.assert_array_equal(np.asarray(a.scores),
                                          np.asarray(b.scores))
        else:
            np.testing.assert_allclose(np.asarray(a.scores),
                                       np.asarray(b.scores), rtol=0,
                                       atol=1.19e-7)


def _ref_members(n_nodes=200, members=5, k=4, seed=5):
    """The reference test's wave: five members of one cluster, each its
    own ask (JAX modules; the port converts the same numpy leaves)."""
    cluster = ref_cluster(n_nodes, cpu=2000.0, mem=4096.0, disk=50000.0,
                          seed=seed)
    rng = np.random.default_rng(3)
    kins = []
    for _ in range(members):
        ev = ref_eval(cluster, desired_count=k)
        kin = ref_build_kernel_in(cluster, ev, k)
        kins.append(kin._replace(
            ask_cpu=np.asarray(float(rng.choice([100, 300, 500])),
                               np.float32)))
    return kins, [k] * members, [REF_LEAN._replace(with_topk=True)] * members


def _port(kins, feats):
    return ([kernel_in_from_numpy(k, keep_numpy=True) for k in kins],
            [tk.KernelFeatures(**f._asdict()) for f in feats])


class TestShardedWaveParity:
    def test_launch_wave_identical_to_single_device(self, wave_mesh,
                                                    counts):
        ref_kins, steps, ref_feats = _ref_members()
        kins, feats = _port(ref_kins, ref_feats)
        single = coalesce.launch_wave(kins, steps, feats, device="cpu")
        sharded_out = coalesce.launch_wave(kins, steps, feats, device="cpu",
                                           mesh=wave_mesh)
        assert coalesce.sharded_wave_stats.snapshot() == {
            "launches": 1, "fallbacks": 0, "mesh_devices": 8}
        assert coalesce.fused_wave_stats.snapshot() == {
            "launches": 2, "fallbacks": 0, "failures": 0}
        _assert_same_outs(sharded_out, single)
        assert any(np.asarray(s.found).any() for s in single)
        # and as the JAX package's wave over its 8 virtual devices
        ref_out = ref_coalesce.launch_wave(ref_kins, steps, ref_feats,
                                           mesh=ref_sharded.wave_mesh(8))
        _assert_same_outs(sharded_out, ref_out, scores_exact=False)

    def test_joint_sharded_wave_counts_a_fused_fallback(self, wave_mesh,
                                                        counts):
        """A union outside the fused envelope (network) runs the joint
        sharded wave: still sharded, one fused fallback."""
        ref_kins, steps, ref_feats = _ref_members(seed=9)
        kins, feats = _port(ref_kins, ref_feats)
        kins = [k._replace(ask_mbits=np.asarray(10, np.int32),
                           avail_mbits=np.full(k.cap_cpu.shape, 1000,
                                               np.int32)) for k in kins]
        feats = [f._replace(with_network=True) for f in feats]
        out = coalesce.launch_wave(kins, steps, feats, device="cpu",
                                   mesh=wave_mesh)
        single = coalesce.launch_wave(kins, steps, feats, device="cpu")
        _assert_same_outs(out, single)
        assert coalesce.sharded_wave_stats.snapshot()["launches"] == 1
        assert coalesce.fused_wave_stats.snapshot() == {
            "launches": 0, "fallbacks": 2, "failures": 0}

    def test_coalescer_threads_its_mesh(self, wave_mesh, counts):
        kins, feats = _port(*_ref_members()[::2])
        co = coalesce.LaunchCoalescer(1, device="cpu", mesh=wave_mesh)
        try:
            out = co.launch(kins[0], 4, feats[0])
        finally:
            co.done()
        assert co.mesh is wave_mesh and co.launches == 1
        assert coalesce.sharded_wave_stats.snapshot()["launches"] == 1
        single = coalesce.launch_wave(kins[:1], [4], feats[:1],
                                      device="cpu")
        _assert_same_outs([out], single)

    def test_mesh_with_resident_usage_raises(self, wave_mesh):
        kins, feats = _port(*_ref_members()[::2])
        resident = coalesce.ResidentUsage(
            kins[0].used_cpu, kins[0].used_mem, kins[0].used_disk,
            device="cpu")
        with pytest.raises(ValueError, match="resident"):
            coalesce.launch_wave(kins, [4] * len(kins), feats, device="cpu",
                                 resident=resident, mesh=wave_mesh)
        with pytest.raises(ValueError, match="resident"):
            coalesce.LaunchCoalescer(2, device="cpu", resident=resident,
                                     mesh=wave_mesh)


def _shared_layout_wave(n_nodes=200, members=4, k=3, seed=5):
    """B kins whose three sharing groups are all identity-shared: the
    wave-shared planes of one (cluster, usage) pair, the neutral and job
    groups frozen singletons (the live stack's steady shape)."""
    cluster = synthetic_cluster(n_nodes, seed=seed)
    cluster.avail_mbits = np.zeros(cluster.n_pad, np.int32)
    cluster.avail_mbits[:n_nodes] = 1000

    class _U:
        pass

    u = _U()
    u.uid = f"wave-test-{seed}"
    u.version = 1
    u.structure_version = 0
    u.rows = {nid: i for i, nid in enumerate(cluster.node_ids)}
    u.n = cluster.n_real
    for f, dt in (("used_cpu", np.float32), ("used_mem", np.float32),
                  ("used_disk", np.float32), ("used_cores", np.int32),
                  ("used_mbits", np.int32)):
        setattr(u, f, np.zeros(cluster.n_real, dt))
    u.row_events = ()
    u.row_events_floor = 0
    u.node_events = ()

    shared = cluster.wave_shared_planes(u)
    neutral = tk.neutral_planes(cluster.n_pad)
    base_mask = cluster.ready.copy()
    base_mask.setflags(write=False)
    ev = synthetic_eval(cluster, desired_count=k)
    kins, steps, feats = [], [], []
    for i in range(members):
        kin = tk.build_kernel_in(cluster, ev, k)
        kins.append(kin._replace(
            ask_cpu=np.asarray(100.0 + 50 * i, np.float32),
            **{f: shared[f] for f in shared},
            port_conflict=neutral.zeros_bool,
            dev_free=neutral.zeros_dev,
            dev_aff_score=neutral.zeros_f32,
            job_tg_count=neutral.zeros_i32,
            job_any_count=neutral.zeros_i32,
            penalty=neutral.zeros_bool,
            aff_score=neutral.zeros_f32,
            base_mask=base_mask,
        ))
        steps.append(k)
        feats.append(tk.LEAN_FEATURES._replace(with_topk=True))
    return cluster, u, kins, steps, feats


class TestShardedSharedLayout:
    def test_shared_layout_parity_and_resident_uploads(self, wave_mesh,
                                                       counts):
        """Shared planes resident split over the mesh: the waves equal
        the one-device wave, and the repeat wave uploads only the
        members' stacked planes (node_perm, the step maps' planes,
        scalars), nothing of a shared one."""
        cluster, u, kins, steps, feats = _shared_layout_wave()
        default_device_state.configure_mesh(wave_mesh)
        gen = default_device_state.ensure(cluster, u, "cpu")
        assert gen.mesh is wave_mesh and all(
            len(p) == 8 for p in gen.planes.values())
        shared = cluster.wave_shared_planes(u)
        for f, arr in shared.items():
            assert default_device_state.lookup(
                arr, frozen_ok=False, mesh=wave_mesh) is gen.planes[f]
            assert default_device_state.lookup(arr, "cpu",
                                               frozen_ok=False) is None
        sharded_out = coalesce.launch_wave(kins, steps, feats, device="cpu",
                                           mesh=wave_mesh)
        first = coalesce.upload_stats.bytes
        coalesce.launch_wave(kins, steps, feats, device="cpu",
                             mesh=wave_mesh)
        repeat = coalesce.upload_stats.bytes - first
        single = coalesce.launch_wave(kins, steps, feats, device="cpu",
                                      mesh=None)
        _assert_same_outs(sharded_out, single)
        assert any(np.asarray(s.found).any() for s in single)
        stats = coalesce.sharded_wave_stats.snapshot()
        assert stats == {"launches": 2, "fallbacks": 0, "mesh_devices": 8}
        # node_perm ([4, 256] i32) plus the member scalars: far under
        # one [N] f32 plane a member
        n_pad = cluster.n_pad
        assert 0 < repeat < 4 * n_pad * 4 + 4096, repeat

    def test_indivisible_mesh_falls_back_unsharded(self, cpu8, counts):
        """A 3-entry mesh over a 256-row node axis cannot split it: the
        wave runs on one device, counts a fallback, places alike."""
        mesh3 = sharded.wave_mesh(3, devices=cpu8)
        _, _, kins, steps, feats = _shared_layout_wave(seed=7)
        out_m = coalesce.launch_wave(kins, steps, feats, device="cpu",
                                     mesh=mesh3)
        out_s = coalesce.launch_wave(kins, steps, feats, device="cpu",
                                     mesh=None)
        assert coalesce.sharded_wave_stats.snapshot() == {
            "launches": 0, "fallbacks": 1, "mesh_devices": 3}
        _assert_same_outs(out_m, out_s)

    def test_one_device_mesh_falls_back(self, counts):
        """A mesh of one device (one card) runs on it, one counted
        fallback, as the reference's does."""
        mesh1 = sharded.wave_mesh(device="cpu")
        assert mesh1.size == 1
        _, _, kins, steps, feats = _shared_layout_wave(seed=8)
        coalesce.launch_wave(kins, steps, feats, device="cpu", mesh=mesh1)
        assert coalesce.sharded_wave_stats.snapshot() == {
            "launches": 0, "fallbacks": 1, "mesh_devices": 1}


class TestShardedFailure:
    def test_fused_sharded_failure_fails_the_wave(self, wave_mesh, counts,
                                                  monkeypatch):
        """A fused sharded wave that raises fails every member, counted
        under failures; the joint sharded wave never runs in its place
        (the reference falls back to it; the port does not)."""
        joint = []

        def broken(mesh, *layout):
            def fn(*a, **k):
                raise RuntimeError("injected sharded failure")
            return fn, None, None

        def counted(*a, **k):
            joint.append(1)
            raise AssertionError("the joint sharded wave ran")

        monkeypatch.setattr(sharded, "fused_sharded_entry", broken)
        monkeypatch.setattr(sharded, "joint_sharded_entry", counted)
        kins, feats = _port(*_ref_members()[::2])
        with pytest.raises(RuntimeError, match="injected sharded failure"):
            coalesce.launch_wave(kins, [4] * len(kins), feats, device="cpu",
                                 mesh=wave_mesh)
        assert coalesce.fused_wave_stats.snapshot() == {
            "launches": 0, "fallbacks": 0, "failures": 1}
        assert coalesce.sharded_wave_stats.snapshot()["launches"] == 1
        assert not joint
        # through a coalescer every member gets the error
        co = coalesce.LaunchCoalescer(1, device="cpu", mesh=wave_mesh)
        try:
            with pytest.raises(RuntimeError, match="injected"):
                co.launch(kins[0], 4, feats[0])
        finally:
            co.done()
        assert coalesce.fused_wave_stats.snapshot()["failures"] == 2


class TestShardedManifest:
    def test_sharded_launch_keys_fold_into_manifest(self, wave_mesh,
                                                    counts):
        """A mesh server's manifest does not go empty because every wave
        ran sharded: sharded keys fold into mesh-agnostic joint entries,
        as the reference's do."""
        _, _, kins, steps, feats = _shared_layout_wave(seed=13)
        telemetry.enable()
        telemetry.reset()
        coalesce.launch_wave(kins, steps, feats, device="cpu",
                             mesh=wave_mesh)
        entries = kernel_warmup.manifest_from_profiler(profiler)
        joints = [e for e in entries if e["kernel"] == "joint"]
        assert joints and joints[0]["nodes"] == 256, entries
        # the reference folds the same key to the same entry
        key = next(k for kern, k in profiler.keys()
                   if kern == "fused_wave_sharded")

        class _Keys:
            def keys(self):
                return [("fused_wave_sharded", key[:6] + (
                    REF_LEAN._replace(with_topk=True), key[7]))]

        ref = ref_warmup.manifest_from_profiler(_Keys())
        assert [(e["wave"], e["steps"], e["nodes"]) for e in ref] == [
            (e["wave"], e["steps"], e["nodes"]) for e in joints]


def _warm_entries(features=REF_LEAN._replace(with_topk=True)):
    """One entry of each case of the reference's mesh-pass rules, with
    the JAX package's feature dicts: a lean fused entry (the sharded
    kernel), a spread entry (the joint sharded wave), an entry whose
    shards would be narrower than TOPK (joint), an entry whose node axis
    an 8-device mesh does not divide (skipped) and a single-eval entry
    (skipped under ``mesh_only``)."""
    lean = dict(features._asdict())
    spread = dict(features._replace(n_spreads=1)._asdict())

    def joint(**kw):
        return {"kernel": "joint", "wave": 4, "steps": tk.pad_steps(16),
                "nodes": 256, "shared": True, "neutral_shared": True,
                "job_shared": True, "features": lean, **kw}

    return [joint(), joint(features=spread), joint(nodes=32),
            joint(nodes=100, shared=False),
            {"kernel": "single_topk", "nodes": 256, "steps": 4,
             "features": lean}]


_ROUTES = {
    "_warm_fused_sharded": "fused_wave_sharded",
    "_warm_joint_sharded": "joint_sharded",
    "_warm_fused": "fused_wave", "_warm_joint": "joint",
    "_warm_single": "single",
}


def _record_routes(monkeypatch, module, calls: list) -> None:
    """Wrap ``module``'s warm functions: each one that warms an entry
    appends ``(entry's position, route)`` to ``calls``."""
    for name, route in _ROUTES.items():
        real = getattr(module, name)

        def wrapped(e, *a, _real=real, _route=route):
            did = _real(e, *a)
            if did:
                calls.append((e["_pos"], _route))
            return did

        monkeypatch.setattr(module, name, wrapped)


class TestShardedWarmup:
    @pytest.mark.parametrize("mesh_only", [True, False])
    def test_mesh_pass_matches_the_reference(self, cpu8, counts,
                                             monkeypatch, mesh_only):
        """``warmup_entries(mesh=, mesh_only=)`` over the port's 8-entry
        CPU mesh and the JAX package's 8 virtual devices: the same
        ``(warmed, failed)`` and the same route for each entry; the port
        warms every mesh entry before any one-device entry."""
        entries = [dict(e, _pos=i) for i, e in enumerate(_warm_entries())]
        ref_calls, calls = [], []
        _record_routes(monkeypatch, ref_warmup, ref_calls)
        _record_routes(monkeypatch, kernel_warmup, calls)
        ref = ref_warmup.warmup_entries(entries, mesh=ref_sharded.wave_mesh(8),
                                        mesh_only=mesh_only)
        kernel_warmup.warmup_stats.reset()
        got = kernel_warmup.warmup_entries(
            entries, device="cpu", mesh=sharded.wave_mesh(devices=cpu8),
            mesh_only=mesh_only)
        assert got == ref == ((3, 0) if mesh_only else (5, 0))
        assert sorted(calls) == sorted(ref_calls)
        # the waves' route first: the three mesh entries, in order
        assert calls[:3] == [(0, "fused_wave_sharded"), (1, "joint_sharded"),
                             (2, "joint_sharded")]
        assert not any("sharded" in r for _, r in calls[3:])
        stats = kernel_warmup.warmup_stats.snapshot()
        assert stats["fused_wave_sharded"] == 1
        assert stats["joint_sharded"] == 2

    def test_warmed_sharded_key_counts_no_miss(self, wave_mesh, counts):
        """The counterpart of the reference's
        ``TestShardedWarmup::test_warmup_populates_sharded_jit_signatures``:
        an entry warmed over the mesh leaves its live sharded launch no
        miss."""
        _, _, kins, steps, feats = _shared_layout_wave(seed=11)
        _, union, b_pad, t_pad, layout, *_ = coalesce._wave_layout(
            kins, steps, feats)
        entry = {"kernel": "joint", "wave": b_pad, "steps": t_pad,
                 "nodes": int(kins[0].cap_cpu.shape[-1]),
                 "shared": layout[0], "neutral_shared": layout[1],
                 "job_shared": layout[2], "features": dict(union._asdict())}
        profiler.clear_seen()
        assert kernel_warmup.warmup_entries(
            [entry], device="cpu", mesh=wave_mesh, mesh_only=True) == (1, 0)
        telemetry.enable()
        telemetry.reset()
        coalesce.launch_wave(kins, steps, feats, device="cpu",
                             mesh=wave_mesh)
        assert profiler.summary()["Launches"] == 1
        assert profiler.misses_for("fused_wave_sharded") == 0, \
            profiler.summary()["PerKey"]

    def test_racing_first_calls_share_one_neutral_singleton(
            self, monkeypatch):
        """Eval threads racing to a node size's first neutral planes all
        get one object, so a process's first wave shares the neutral
        group as every later wave does and takes the key the warm pass
        warmed."""
        import threading
        import time

        real = tk._frozen

        def slow(a):
            time.sleep(0.002)
            return real(a)

        monkeypatch.setattr(tk, "_frozen", slow)
        n, k = 4096 + 8 * 37, 24
        for cache, key in ((tk._NEUTRAL_CACHE, n),
                           (tk._NEUTRAL_STEP_CACHE, k),
                           (tk._NEUTRAL_WORDS_CACHE, (n, 3))):
            cache.pop(key, None)
        start = threading.Barrier(8)
        got = []

        def first_call():
            start.wait()
            got.append((tk.neutral_planes(n), tk.neutral_step_planes(k),
                        tk.neutral_port_words(n, 3)))

        threads = [threading.Thread(target=first_call) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(3):
            assert len({id(g[i]) for g in got}) == 1

    def test_warm_pass_racing_live_waves_places_as_b1(self, wave_mesh,
                                                      counts):
        """A mesh pass on another thread, over the same mesh, while live
        waves run: every live wave places exactly as B1 on one device."""
        import threading

        _, _, kins, steps, feats = _shared_layout_wave(seed=17)
        want = coalesce.launch_wave(kins, steps, feats, device="cpu")
        stop = threading.Event()
        passes = []

        def warm():
            while not stop.is_set():
                passes.append(kernel_warmup.warmup_entries(
                    _warm_entries(tk.LEAN_FEATURES._replace(with_topk=True)),
                    device="cpu", mesh=wave_mesh, mesh_only=True))

        t = threading.Thread(target=warm)
        t.start()
        try:
            for _ in range(4):
                _assert_same_outs(coalesce.launch_wave(
                    kins, steps, feats, device="cpu", mesh=wave_mesh), want)
        finally:
            stop.set()
            t.join(timeout=60)
        assert passes and set(passes) == {(3, 0)}
        stats = coalesce.sharded_wave_stats.snapshot()
        assert stats["launches"] == 4 and stats["fallbacks"] == 0


# ---------------------------------------------------------------------------
# Servers over a mesh, the port beside the JAX package.
# ---------------------------------------------------------------------------

CLASSES = 8


def _classed_jobs():
    """One job a node class: each places only on its class's nodes, so a
    batch's waves place alike whatever order their members arrive in."""
    jobs = []
    for c in range(CLASSES):
        job = mock.simple_job()
        job.task_groups[0].count = 3
        job.constraints = [Constraint(ltarget="${node.class}",
                                      rtarget=f"class-{c}", operand="=")]
        jobs.append(job)
    return jobs


def test_server_places_a_burst_as_the_reference_over_its_mesh(
        cpu8, counts, monkeypatch, tmp_path):
    """Both servers with ``use_device_mesh=True``: the JAX one over its 8
    virtual devices; the port's finds one CPU, adopts none, and is then
    given the 8-entry CPU mesh (``_adopt_wave_mesh``). One
    deterministic burst (seeded eval ids, registered while the workers
    are stopped) places the same allocs on the same nodes;
    the port's waves all ran sharded, none fell back or failed, its
    resident state holds the server's mesh until shutdown, and its
    exporter reads the sharded series."""
    from nomad_tpu_torch.telemetry.exporter import prometheus_text

    monkeypatch.setattr(kernel_warmup, "DEFAULT_MANIFEST_PATH",
                        str(tmp_path / "absent.json"))
    monkeypatch.setattr(ref_warmup, "DEFAULT_MANIFEST_PATH",
                        str(tmp_path / "absent-ref.json"))
    pair = Pair(monkeypatch, num_workers=1, worker_batch_size=CLASSES,
                heartbeat_ttl=3600.0, use_device_mesh=True,
                coalesce_adaptive=False)
    with pair:
        assert pair.ref.wave_mesh is not None
        assert pair.port.wave_mesh is None
        pair.port._adopt_wave_mesh(sharded.wave_mesh(devices=cpu8))
        mesh = pair.port.wave_mesh
        assert mesh is not None and mesh.shape == {"nodes": 8}
        assert default_device_state.mesh is mesh
        for i in range(6 * CLASSES):
            pair.call("node_register",
                      mock.node(node_class=f"class-{i % CLASSES}"))
        pair.wait_idle("nodes registered")
        coalesce.sharded_wave_stats.reset()
        coalesce.fused_wave_stats.reset()
        for s in pair.sides:
            for w in s.workers:
                w.stop()
        for i, job in enumerate(_classed_jobs()):
            pair.call("job_register", job, seed=1000 + i)
        for s in pair.sides:
            for w in s.workers:
                w.start()
        pair.wait_idle("burst placed")
        # the same allocs on the same nodes, and the same evals (the
        # stores' indexes may differ: how a wave's plans group into
        # commits depends on timing)
        assert allocs_by_name(pair.port) == allocs_by_name(pair.ref)
        assert eval_rows(pair.port) == eval_rows(pair.ref)
        placed = allocs_by_name(pair.port)
        assert len(placed) == 3 * CLASSES
        assert all(v[1] == consts.ALLOC_DESIRED_RUN for v in placed.values())
        w = pair.port.workers[0]
        assert w.last_error is None and w.batch_launches >= 1
        stats = coalesce.sharded_wave_stats.snapshot()
        assert stats["launches"] == w.batch_launches >= 1, stats
        assert stats["fallbacks"] == 0 and stats["mesh_devices"] == 8
        fused = coalesce.fused_wave_stats.snapshot()
        assert fused["failures"] == 0 and fused["fallbacks"] == 0, fused
        text = prometheus_text().splitlines()
        assert (f"nomad_tpu_wave_sharded_launches_total "
                f"{stats['launches']}") in text
        assert "nomad_tpu_wave_sharded_mesh_devices 8" in text
        assert default_device_state.snapshot()["mesh_devices"] == 8
    assert pair.port.wave_mesh is None
    assert default_device_state.mesh is None


def test_use_device_mesh_on_one_device_adopts_none(monkeypatch, tmp_path,
                                                  caplog):
    """On one device ``use_device_mesh=True`` logs and adopts no mesh;
    ``_adopt_wave_mesh`` then takes a virtual one, and shutdown gives
    the resident state back."""
    import logging

    from nomad_tpu_torch.server.server import Server, ServerConfig

    monkeypatch.setattr(kernel_warmup, "DEFAULT_MANIFEST_PATH",
                        str(tmp_path / "absent.json"))
    prior = default_device_state.mesh
    srv = Server(ServerConfig(num_workers=0, use_device_mesh=True),
                 device="cpu")
    with caplog.at_level(logging.INFO, logger="nomad_tpu_torch"):
        srv.start()
    try:
        assert srv.wave_mesh is None
        assert "no mesh adopted" in caplog.text
        mesh = sharded.wave_mesh(devices=[torch.device("cpu")] * 4)
        srv._adopt_wave_mesh(mesh)
        assert srv.wave_mesh is mesh
        assert default_device_state.mesh is (mesh if prior is None
                                             else prior)
    finally:
        srv.shutdown()
    assert srv.wave_mesh is None and default_device_state.mesh is prior


@pytest.mark.parametrize("use,adopts", [(None, True), (False, False),
                                        (True, True)])
def test_only_use_device_mesh_true_adopts_a_mesh_over_the_cards(
        use, adopts, monkeypatch, tmp_path):
    """With four cards patched in, ``use_device_mesh=True`` adopts a mesh
    over them, and so does None, as in the JAX package (the port's
    sharded wave is the hand kernel, within 3x of B1's wave on one
    card); False adopts none. On the CPU, None adopts none."""
    from nomad_tpu_torch.server.server import Server, ServerConfig

    monkeypatch.setattr(kernel_warmup, "DEFAULT_MANIFEST_PATH",
                        str(tmp_path / "absent.json"))
    prior = default_device_state.mesh
    srv = Server(ServerConfig(num_workers=0, use_device_mesh=use),
                 device="cpu")
    srv.start()
    try:
        assert srv.wave_mesh is None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        # the probe as it runs on a host of four cards
        srv.device = torch.device("cuda", 0)
        srv._maybe_configure_wave_mesh()
        srv.device = CPU
        if adopts:
            assert list(srv.wave_mesh.devices.flat) == [
                torch.device("cuda", i) for i in range(4)]
            assert default_device_state.mesh is (
                srv.wave_mesh if prior is None else prior)
        else:
            assert srv.wave_mesh is None
            assert default_device_state.mesh is prior
    finally:
        srv.shutdown()
    assert srv.wave_mesh is None and default_device_state.mesh is prior


def test_agent_scrape_reads_the_sharded_series(cpu8, counts, monkeypatch,
                                               tmp_path):
    """An agent whose server adopted a 4-entry mesh: its waves run
    sharded and ``/v1/metrics?format=prometheus`` says so (a server
    without a mesh keeps the series at zero,
    ``test_torch_serving_plane.py``)."""
    import time
    import urllib.request

    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.api.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.client import APIClient
    from nomad_tpu_torch.api.codec import encode

    monkeypatch.setattr(kernel_warmup, "DEFAULT_MANIFEST_PATH",
                        str(tmp_path / "absent.json"))
    agent = Agent(AgentConfig(device="cpu", num_schedulers=1,
                              serf_enabled=False, worker_batch_size=4,
                              coalesce_adaptive=False))
    agent.start()
    try:
        srv = agent.server
        srv._adopt_wave_mesh(sharded.wave_mesh(4, devices=cpu8))
        for _ in range(12):
            srv.node_register(port_mock.node())
        api = APIClient(agent.http_addr)
        jobs = []
        for _ in range(4):
            job = port_mock.simple_job()
            job.task_groups[0].count = 2
            jobs.append(job)
        worker = srv.workers[0]
        worker.stop()
        for job in jobs:
            api.jobs.register(encode(job))
        worker.start()
        deadline = time.time() + 60
        while time.time() < deadline and sum(
                len(api.jobs.allocations(j.id)) for j in jobs) < 8:
            time.sleep(0.02)
        assert sum(len(api.jobs.allocations(j.id)) for j in jobs) == 8
        with urllib.request.urlopen(
                agent.http_addr + "/v1/metrics?format=prometheus") as r:
            text = r.read().decode().splitlines()
        stats = coalesce.sharded_wave_stats.snapshot()
        assert stats["launches"] >= 1 and stats["fallbacks"] == 0, stats
        assert (f"nomad_tpu_wave_sharded_launches_total "
                f"{stats['launches']}") in text
        assert "nomad_tpu_wave_sharded_fallbacks_total 0" in text
        assert "nomad_tpu_wave_sharded_mesh_devices 4" in text
    finally:
        agent.shutdown()
    assert default_device_state.mesh is None


def test_mesh_server_manifest_round_trip(cpu8, counts, tmp_path):
    """The reference's mini-mesh smoke, through the server: a mesh
    server's burst persists its sharded keys as mesh-agnostic manifest
    entries; a second server, as a fresh process would (no key seen),
    warms those entries on its one device at start and over the mesh it
    adopts after, and its bursts of the same shape run sharded with no
    fallback and no sharded miss, the resident state advancing by the
    sharded scatter."""
    import time

    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.server.server import Server, ServerConfig

    manifest = str(tmp_path / "manifest.json")

    def burst(srv, n_jobs=CLASSES):
        jobs = []
        for _ in range(n_jobs):
            job = port_mock.simple_job()
            job.task_groups[0].count = 3
            jobs.append(job)
        for w in srv.workers:
            w.stop()
        for job in jobs:
            srv.job_register(job)
        for w in srv.workers:
            w.start()
        deadline = time.time() + 60
        while time.time() < deadline and sum(
                len(srv.state.snapshot().allocs_by_job(j.namespace, j.id))
                for j in jobs) < 3 * n_jobs:
            time.sleep(0.02)
        assert sum(len(srv.state.snapshot().allocs_by_job(
            j.namespace, j.id)) for j in jobs) == 3 * n_jobs

    def server():
        srv = Server(ServerConfig(
            num_workers=1, worker_batch_size=CLASSES, heartbeat_ttl=3600.0,
            coalesce_adaptive=False, kernel_warmup=True,
            warmup_manifest_path=manifest), device="cpu")
        srv.start()
        srv._adopt_wave_mesh(sharded.wave_mesh(devices=cpu8))
        for _ in range(30):
            srv.node_register(port_mock.node())
        return srv

    telemetry.enable()
    srv = server()
    try:
        burst(srv)
    finally:
        srv.shutdown()
    assert coalesce.sharded_wave_stats.snapshot()["launches"] >= 1
    entries = kernel_warmup.load_manifest(manifest)
    assert any(e["kernel"] == "joint" for e in entries), entries

    kernel_warmup.warmup_stats.reset()
    telemetry.reset()
    profiler.clear_seen()
    srv = server()
    try:
        for t in (srv._warmup_thread, srv._mesh_warmup_thread):
            t.join(timeout=60)
        warmed = kernel_warmup.warmup_stats.snapshot()
        assert warmed.get("fused_wave_sharded", 0) >= 1, warmed
        assert warmed.get("fused_wave", 0) >= 1, warmed
        assert srv.warmup_stats["failed"] == 0, srv.warmup_stats
        assert sorted(p["pass"] for p in srv.warmup_passes) == [
            "mesh", "start"]
        telemetry.reset()
        burst(srv)
        burst(srv)
        stats = coalesce.sharded_wave_stats.snapshot()
        assert stats["launches"] >= 2 and stats["fallbacks"] == 0, stats
        # every sharded key the bursts launched was warmed
        assert profiler.misses_for("fused_wave_sharded") == 0, \
            profiler.summary()["PerKey"]
        assert profiler.misses_for("joint_sharded") == 0
        # the second burst's planes advanced from the first's by the
        # sharded scatter
        assert default_device_state.snapshot()["delta_advances"] >= 1
    finally:
        srv.shutdown()
    assert default_device_state.mesh is None


def test_adopting_a_mesh_launches_nothing(cpu8, counts, tmp_path):
    """``_adopt_wave_mesh`` sets the server's and the resident state's
    mesh and nothing else: no thread, no warm launch, no wave, even with
    a manifest of entries that would run sharded."""
    import threading

    from nomad_tpu_torch.server.server import Server, ServerConfig

    manifest = str(tmp_path / "manifest.json")
    kernel_warmup.save_manifest([{
        "kernel": "joint", "wave": 4, "steps": tk.pad_steps(16),
        "nodes": 256, "shared": True, "neutral_shared": True,
        "job_shared": True,
        "features": dict(tk.LEAN_FEATURES._replace(
            with_topk=True)._asdict())}], manifest)
    srv = Server(ServerConfig(num_workers=0, kernel_warmup=False,
                              warmup_manifest_path=manifest), device="cpu")
    srv.start()
    try:
        threads = set(threading.enumerate())
        kernel_warmup.warmup_stats.reset()
        mesh = sharded.wave_mesh(devices=cpu8)
        srv._adopt_wave_mesh(mesh)
        assert srv.wave_mesh is mesh and default_device_state.mesh is mesh
        assert set(threading.enumerate()) <= threads
        assert kernel_warmup.warmup_stats.snapshot() == {}
        assert coalesce.sharded_wave_stats.snapshot()["launches"] == 0
    finally:
        srv.shutdown()
    assert srv.wave_mesh is None and default_device_state.mesh is None


def _one_entry_manifest(path: str) -> str:
    kernel_warmup.save_manifest([{
        "kernel": "joint", "wave": 4, "steps": tk.pad_steps(16),
        "nodes": 256, "shared": True, "neutral_shared": True,
        "job_shared": True,
        "features": dict(tk.LEAN_FEATURES._replace(
            with_topk=True)._asdict())}], path)
    return path


def test_mesh_from_start_is_warmed_by_the_start_up_pass(cpu8, counts,
                                                       monkeypatch,
                                                       tmp_path):
    """A mesh adopted inside ``start()`` (eight CPU entries patched in as
    the devices): the one start-up thread warms the entry over the mesh
    and on the device, counted once, and no mesh-only pass runs."""
    from nomad_tpu_torch.parallel import mesh as mesh_mod
    from nomad_tpu_torch.server.server import Server, ServerConfig

    manifest = _one_entry_manifest(str(tmp_path / "manifest.json"))
    monkeypatch.setattr(mesh_mod, "available_devices", lambda d=None: cpu8)
    kernel_warmup.warmup_stats.reset()
    srv = Server(ServerConfig(num_workers=0, use_device_mesh=True,
                              kernel_warmup=True,
                              warmup_manifest_path=manifest), device="cpu")
    srv.start()
    try:
        assert srv.wave_mesh is not None and srv.wave_mesh.size == 8
        srv._warmup_thread.join(timeout=60)
        assert srv._mesh_warmup_thread is None
        assert kernel_warmup.warmup_stats.snapshot() == {
            "fused_wave_sharded": 1, "fused_wave": 1}
        assert srv.warmup_stats["warmed"] == 1
        assert srv.warmup_stats["failed"] == 0
        assert [p["pass"] for p in srv.warmup_passes] == ["start"]
    finally:
        srv.shutdown()
    assert default_device_state.mesh is None


def test_mesh_adopted_after_start_is_warmed_and_joined(cpu8, counts,
                                                      monkeypatch,
                                                      tmp_path):
    """``_adopt_wave_mesh`` after ``start()`` with a manifest runs a
    mesh-only pass on its own thread; ``shutdown()`` joins it before it
    gives the resident state's mesh back."""
    import threading
    import time

    from nomad_tpu_torch.server.server import Server, ServerConfig

    manifest = _one_entry_manifest(str(tmp_path / "manifest.json"))
    entered = threading.Event()
    real_warm = kernel_warmup._warm_sharded

    def slow_warm(*a, **k):
        entered.set()
        time.sleep(0.3)
        return real_warm(*a, **k)

    monkeypatch.setattr(kernel_warmup, "_warm_sharded", slow_warm)
    srv = Server(ServerConfig(num_workers=0, kernel_warmup=True,
                              warmup_manifest_path=manifest), device="cpu")
    released = []
    real_configure = default_device_state.configure_mesh

    def configure(mesh):
        if mesh is None:
            released.append(srv._mesh_warmup_thread.is_alive())
        return real_configure(mesh)

    monkeypatch.setattr(default_device_state, "configure_mesh", configure)
    kernel_warmup.warmup_stats.reset()
    srv.start()
    srv._warmup_thread.join(timeout=60)
    assert srv._mesh_warmup_thread is None
    mesh = sharded.wave_mesh(devices=cpu8)
    srv._adopt_wave_mesh(mesh)
    t = srv._mesh_warmup_thread
    assert t is not None and t.name == "mesh-kernel-warmup"
    assert entered.wait(10)
    srv.shutdown()
    assert released == [False] and not t.is_alive()
    assert srv.wave_mesh is None and default_device_state.mesh is None
    assert kernel_warmup.warmup_stats.snapshot() == {
        "fused_wave": 1, "fused_wave_sharded": 1}
    passes = {p["pass"]: p for p in srv.warmup_passes}
    assert passes["mesh"]["warmed"] == 1 and passes["mesh"]["failed"] == 0
    assert srv.warmup_stats["warmed"] == 2
