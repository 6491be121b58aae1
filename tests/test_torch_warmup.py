"""The port's start-up kernel warmup (ops/warmup.py), on the CPU.

``TestManifest`` and ``TestAOTWarmupSteadyState`` of
``tests/test_warmup.py`` on the port: the manifest round trip and merge;
``expand_lattice`` gives the JAX package's entries for the same input,
and both packages bucket waves alike; a manifest warmup leaves no
profiler miss over the keys a steady burst launches; a server persists
its manifest at shutdown and warms it at the next start. The port's
server accepts ``kernel_warmup=True`` and a manifest path (it refused
both before the warmup existed). Warm launches are counted apart from
the waves', a dummy wave takes exactly its entry's layout, a failed
entry is counted and skipped, and threads that race for one kernel
library build and load it once.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from nomad_tpu.ops import warmup as ref_warmup
from nomad_tpu.parallel import coalesce as ref_coalesce
from nomad_tpu_torch import mock, telemetry
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import warmup as kernel_warmup
from nomad_tpu_torch.ops.build import BuiltLibrary
from nomad_tpu_torch.ops.kernel import LEAN_FEATURES
from nomad_tpu_torch.parallel import coalesce as pc
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.telemetry.kernel_profile import profiler


@pytest.fixture()
def clean_telemetry():
    telemetry.enable()
    telemetry.reset()
    profiler.clear_seen()
    yield
    telemetry.disable()
    telemetry.reset()


def _register_jobs(server, n_jobs, count=3):
    jobs = []
    for _ in range(n_jobs):
        j = mock.simple_job()
        j.task_groups[0].count = count
        jobs.append(j)
        server.job_register(j)
    return jobs


def _drain_worker(server, batch_size=8):
    """Deterministic eval loop: a manual batching worker drains the
    broker (jobs registered first, so batches are full-size)."""
    from nomad_tpu_torch.server.worker import Worker

    w = Worker(server, 0, batch_size=batch_size)
    while w.run_once(timeout=0.0):
        pass
    return w


def _server(**kw):
    kw.setdefault("num_workers", 0)
    return Server(ServerConfig(heartbeat_ttl=3600.0, gc_tuning=False, **kw),
                  device="cpu")


def _placed(server, jobs):
    snap = server.state.snapshot()
    return sum(len(snap.allocs_by_job(j.namespace, j.id)) for j in jobs)


JOINT = {"kernel": "joint", "wave": 32, "steps": 512, "nodes": 64,
         "shared": True, "neutral_shared": False, "job_shared": True,
         "features": dict(LEAN_FEATURES._asdict())}


class TestManifest:
    def test_roundtrip_and_merge(self, tmp_path):
        e1 = {"kernel": "joint", "wave": 16, "steps": 64, "nodes": 64,
              "shared": True, "neutral_shared": False,
              "features": {"n_spreads": 0, "with_topk": True}}
        e2 = {"kernel": "single_topk", "nodes": 64, "steps": 16,
              "features": {"n_spreads": 0}}
        path = str(tmp_path / "warmup.json")
        assert kernel_warmup.save_manifest([e1], path) == 1
        assert kernel_warmup.save_manifest([e1, e2], path) == 2
        got = kernel_warmup.load_manifest(path)
        assert len(got) == 2
        data = json.loads(open(path).read())
        assert data["version"] == kernel_warmup.MANIFEST_VERSION

    def test_default_path_is_the_ports_own(self):
        assert (kernel_warmup.DEFAULT_MANIFEST_PATH
                != ref_warmup.DEFAULT_MANIFEST_PATH)
        assert kernel_warmup.DEFAULT_MANIFEST_PATH.endswith(
            "nomad_tpu_torch_warmup.json")

    @pytest.mark.parametrize("entry,max_wave", [
        (JOINT, None),
        (JOINT, 64),
        ({**JOINT, "wave": 4, "steps": 32, "job_shared": False}, 32),
        ({**JOINT, "wave": 16, "steps": 128,
          "features": {**JOINT["features"], "with_step_penalties": True,
                       "with_preferred": True}}, None),
        ({**JOINT, "wave": 1, "steps": 8, "nodes": 16384}, 32),
        ({"kernel": "single_topk", "nodes": 64, "steps": 16,
          "features": {"n_spreads": 0}}, None),
    ])
    def test_expand_lattice_matches_the_reference(self, entry, max_wave):
        got = kernel_warmup.expand_lattice([entry], max_wave=max_wave)
        want = ref_warmup.expand_lattice([entry], max_wave=max_wave)
        assert got == want

    def test_expand_lattice_covers_waves_layouts_and_singles(self):
        out = kernel_warmup.expand_lattice([JOINT])
        joint = [x for x in out if x["kernel"] == "joint"]
        assert sorted({x["wave"] for x in joint}) == [1, 4, 16, 32]
        assert all(x["shared"] and x["neutral_shared"]
                   for x in joint if x["wave"] == 1)
        singles = {x["kernel"] for x in out if x["kernel"] != "joint"}
        assert singles == {"single_topk", "single_full"}

    def test_both_packages_bucket_waves_alike(self):
        assert pc._WAVE_BUCKETS == ref_coalesce._WAVE_BUCKETS
        for b in range(1, 600):
            assert pc.pad_wave(b) == ref_coalesce.pad_wave(b), b

    def test_manifest_from_profiler_folds_fused_into_joint(
            self, clean_telemetry):
        key = (16, 256, 64, True, False, False, LEAN_FEATURES)
        profiler.call("fused_wave", lambda *a: 0, (), (), key, "cpu")
        profiler.call("joint", lambda *a: 0, (), (), key, "cpu")
        profiler.call("warmup_fused_wave", lambda *a: 0, (), (), key, "cpu")
        profiler.call("single_topk", lambda *a: 0, (), (),
                      (64, 16, LEAN_FEATURES), "cpu")
        entries = kernel_warmup.manifest_from_profiler(profiler)
        assert [e["kernel"] for e in entries] == ["joint", "single_topk"]
        assert entries[0]["job_shared"] is False


class TestDummyWave:
    @pytest.mark.parametrize("layout", [
        (True, True, True), (True, False, True), (False, True, False),
        (False, False, False)])
    def test_entry_wave_takes_the_entrys_layout(self, layout):
        import torch

        e = {**JOINT, "wave": 4, "steps": 64, "shared": layout[0],
             "neutral_shared": layout[1], "job_shared": layout[2]}
        wave = kernel_warmup._entry_wave(e, torch.device("cpu"))
        assert (wave.b_pad, wave.t_pad, wave.layout) == (4, 64, layout)
        assert wave.features == LEAN_FEATURES
        # a shared group ships without a member axis, a stacked one with
        assert (wave.kin.cap_cpu.dim() == 1) == layout[0]
        assert (wave.kin.base_mask.dim() == 1) == layout[2]

    def test_warm_launches_are_not_waves(self, clean_telemetry):
        kernel_warmup.warmup_stats.reset()
        pc.fused_wave_stats.reset()
        pc.wave_stats.reset()
        warmed, failed = kernel_warmup.warmup_entries(
            [{**JOINT, "wave": 4, "steps": 64},
             {"kernel": "single_full", "nodes": 64, "steps": 8,
              "features": dict(LEAN_FEATURES._asdict())}], device="cpu")
        assert (warmed, failed) == (2, 0)
        assert kernel_warmup.warmup_stats.snapshot() == {
            "fused_wave": 1, "single_full": 1}
        assert pc.fused_wave_stats.snapshot()["launches"] == 0
        assert pc.wave_stats.snapshot()["launches"] == 0
        d = profiler.summary()["Dispatches"]
        assert d == {"warmup_fused_wave": 1, "warmup_single_full": 1}

    def test_entry_past_b1s_plan_warms_the_joint_kernel(
            self, clean_telemetry, monkeypatch):
        """A lean entry whose node axis B1's cluster would not hold (B1's
        plan answering so, as the card's does past its shared memory)
        warms the joint kernel, the route ``launch_wave`` takes for it;
        with the plan as it is on CPU tensors, B1."""
        kernel_warmup.warmup_stats.reset()
        entry = {**JOINT, "wave": 4, "steps": 64}
        assert kernel_warmup.warmup_entries([entry], device="cpu") == (1, 0)
        asked = []

        def fits(dev, n, b, shuffle):
            asked.append((n, b))
            return False

        monkeypatch.setattr(ck, "fused_wave_fits", fits)
        assert kernel_warmup.warmup_entries([entry], device="cpu") == (1, 0)
        assert asked == [(entry["nodes"], 4)]
        assert kernel_warmup.warmup_stats.snapshot() == {
            "fused_wave": 1, "joint": 1}

    @pytest.mark.parametrize("variant", ["spread", "lean_narrow"])
    def test_mesh_pass_warms_through_the_joint_sharded_kernel(
            self, clean_telemetry, monkeypatch, variant):
        """The mesh pass warms a joint entry the fused sharded kernel does
        not take (a spread union; a lean one whose shards fall under
        TOPK rows) through the joint sharded kernel's wrapper, once."""
        import torch

        from nomad_tpu_torch.parallel import sharded

        calls = []
        real = sharded.joint_sharded_wave_place
        monkeypatch.setattr(sharded, "joint_sharded_wave_place",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        feats = LEAN_FEATURES._replace(with_topk=True)
        if variant == "spread":
            feats = feats._replace(n_spreads=1)
        entry = {**JOINT, "wave": 4, "steps": 64, "nodes": 256,
                 "features": dict(feats._asdict())}
        shards = 8 if variant == "spread" else 64
        mesh = sharded.wave_mesh(devices=[torch.device("cpu")] * shards)
        kernel_warmup.warmup_stats.reset()
        assert kernel_warmup.warmup_entries(
            [entry], device="cpu", mesh=mesh, mesh_only=True) == (1, 0)
        assert calls == [1]
        assert kernel_warmup.warmup_stats.snapshot() == {"joint_sharded": 1}

    def test_failed_entry_is_counted_and_skipped(self, clean_telemetry):
        warmed, failed = kernel_warmup.warmup_entries(
            [{**JOINT, "wave": 4, "steps": 64},
             {**JOINT, "wave": 3, "steps": 64}], device="cpu")
        assert (warmed, failed) == (1, 1)

    def test_unreadable_manifest_counts_one_failure(self, tmp_path):
        path = tmp_path / "warmup.json"
        path.write_text("{not json")
        assert kernel_warmup.warmup_from_manifest(
            str(path), device="cpu") == (0, 1)
        assert kernel_warmup.warmup_from_manifest(
            str(tmp_path / "absent.json"), device="cpu") == (0, 0)


class TestAOTWarmupSteadyState:
    def test_zero_misses_after_manifest_warmup(self, tmp_path,
                                               clean_telemetry):
        """Record a burst's bucket keys, forget every key (a fresh
        process), warm from the manifest: the next burst has no miss."""
        server = _server(coalesce_adaptive=False)
        server.start()
        try:
            for _ in range(40):
                server.node_register(mock.node())
            jobs = _register_jobs(server, 8)
            _drain_worker(server)
            assert _placed(server, jobs) == 24

            path = str(tmp_path / "warmup.json")
            entries = kernel_warmup.manifest_from_profiler(profiler)
            assert entries, "profiler recorded no bucket keys"
            kernel_warmup.save_manifest(entries, path)

            profiler.clear_seen()
            profiler.reset()
            warmed, failed = kernel_warmup.warmup_from_manifest(
                path, device="cpu")
            assert warmed >= len(entries)
            assert failed == 0

            profiler.reset()
            jobs2 = _register_jobs(server, 8)
            _drain_worker(server)
            assert _placed(server, jobs2) == 24
            s = profiler.summary()
            assert s["Launches"] >= 1
            assert s["Misses"] == 0, s["PerKey"]
        finally:
            server.shutdown()

    def test_server_persists_and_warms_manifest(self, tmp_path,
                                                clean_telemetry):
        path = str(tmp_path / "warmup.json")
        server = _server(warmup_manifest_path=path)
        server.start()
        try:
            for _ in range(20):
                server.node_register(mock.node())
            _register_jobs(server, 4)
            _drain_worker(server, batch_size=4)
        finally:
            server.shutdown()
        assert os.path.exists(path)
        assert kernel_warmup.load_manifest(path)

        server2 = _server(warmup_manifest_path=path)
        server2.start()
        try:
            t = server2._warmup_thread
            assert t is not None
            t.join(timeout=120)
            assert not t.is_alive()
            assert server2.warmup_stats["failed"] == 0
            assert server2.warmup_stats["warmed"] >= 1
        finally:
            server2.shutdown()

    def test_server_accepts_kernel_warmup_true(self, tmp_path, monkeypatch,
                                               clean_telemetry):
        """``kernel_warmup=True`` without a path warms from the default
        manifest (absent here: zero entries) and persists to it."""
        path = tmp_path / "default.json"
        monkeypatch.setattr(kernel_warmup, "DEFAULT_MANIFEST_PATH",
                            str(path))
        server = _server(kernel_warmup=True)
        server.start()
        try:
            server._warmup_thread.join(timeout=60)
            assert server.warmup_stats == {
                "warmed": 0, "failed": 0,
                "seconds": server.warmup_stats["seconds"]}
            for _ in range(10):
                server.node_register(mock.node())
            _register_jobs(server, 2)
            _drain_worker(server, batch_size=2)
        finally:
            server.shutdown()
        assert kernel_warmup.load_manifest(str(path))

    def test_server_accepts_a_manifest_path(self, tmp_path,
                                            clean_telemetry):
        """A manifest path with ``kernel_warmup=None`` warms when the file
        exists, and warms nothing when it does not."""
        path = tmp_path / "warmup.json"
        absent = _server(warmup_manifest_path=str(path))
        absent.start()
        absent.shutdown()
        assert absent._warmup_thread is None
        kernel_warmup.save_manifest([{**JOINT, "wave": 4, "steps": 64}],
                                    str(path))
        server = _server(warmup_manifest_path=str(path),
                         worker_batch_size=4)
        server.start()
        try:
            server._warmup_thread.join(timeout=120)
            assert server.warmup_stats["failed"] == 0
            assert server.warmup_stats["warmed"] >= 1
        finally:
            server.shutdown()

    def test_server_warms_the_observed_keys_alone(self, tmp_path,
                                                  clean_telemetry):
        """A server warms each manifest key as it was observed, one warm
        launch each, and no lattice around them (``expand=True`` is the
        caller's choice)."""
        entries = [{**JOINT, "wave": 4, "steps": 64},
                   {**JOINT, "wave": 16, "steps": 256, "job_shared": False}]
        path = str(tmp_path / "warmup.json")
        kernel_warmup.save_manifest(entries, path)
        kernel_warmup.warmup_stats.reset()
        server = _server(warmup_manifest_path=path)
        server.start()
        try:
            server._warmup_thread.join(timeout=120)
            assert server.warmup_stats["failed"] == 0
            assert server.warmup_stats["warmed"] == len(entries)
        finally:
            server.shutdown()
        assert kernel_warmup.warmup_stats.snapshot() == {
            "fused_wave": len(entries)}
        assert len(kernel_warmup.expand_lattice(entries)) > len(entries)

    def test_shutdown_stops_and_joins_the_warmup_thread(
            self, tmp_path, monkeypatch):
        path = str(tmp_path / "warmup.json")
        kernel_warmup.save_manifest([JOINT], path)
        started = threading.Event()
        real = kernel_warmup._warm_fused

        def slow(e, dev):
            started.set()
            time.sleep(0.05)
            return real(e, dev)

        monkeypatch.setattr(kernel_warmup, "_warm_fused", slow)
        server = _server(warmup_manifest_path=path)
        server.start()
        assert started.wait(60)
        server.shutdown()
        assert not server._warmup_thread.is_alive()


def test_racing_threads_build_and_load_a_library_once(monkeypatch,
                                                      tmp_path):
    """A wave and the warmup thread asking for one library at once: one
    build, one load, and every caller gets the same record."""
    builds = []

    def fake_build(name):
        builds.append(name)
        time.sleep(0.05)
        return BuiltLibrary(tmp_path / f"lib{name}.so", "", cached=False)

    class FakeCDLL:
        def __init__(self, path):
            self.fused_wave_launch = lambda *a: 0

    monkeypatch.setattr(ck, "_LIBS", {})
    monkeypatch.setattr(ck, "build_library", fake_build)
    monkeypatch.setattr(ck.ctypes, "CDLL", FakeCDLL)
    loads0 = ck.library_loads
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(ck.load_library("fused_wave")))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == ["fused_wave"]
    assert ck.library_loads == loads0 + 1
    assert len(got) == 8 and all(g is got[0] for g in got)
