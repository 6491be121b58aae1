"""The port's kernel profiler (telemetry/kernel_profile.py), on the CPU.

The cases of ``tests/test_telemetry.py::TestKernelProfiler`` on the
port: a reused bucket key counts no second miss, and a live server wave
records its stages. Then what the port adds: a miss is the first launch
of a key in the process unless warmup marked it warm, or a launch during
which a kernel library was loaded; a disabled profiler calls through;
and with the snapshot's planes resident, a steady wave uploads nothing
for the twelve wave-shared planes and counts exactly one dispatch.
"""

import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock, telemetry
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops.kernel import LEAN_FEATURES
from nomad_tpu_torch.ops.warmup import _dummy_kin
from nomad_tpu_torch.parallel import coalesce as pc
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.telemetry import profiler, tracer


@pytest.fixture()
def clean_telemetry():
    telemetry.enable()
    telemetry.reset()
    profiler.clear_seen()
    yield
    telemetry.disable()
    telemetry.reset()


def _times(x, k):
    return x * k


class TestKernelProfiler:
    def test_cache_miss_counting_under_reused_bucket_shapes(
            self, clean_telemetry):
        """Two launches with the same bucket key: one miss. A third with a
        new key: another miss."""
        key_a = ("bucket", 64)
        out1 = profiler.call("toy", _times, (np.ones(64, np.float32),),
                             (2,), key_a, "cpu")
        out2 = profiler.call("toy", _times, (np.ones(64, np.float32),),
                             (2,), key_a, "cpu")
        assert isinstance(out1, torch.Tensor)
        assert float(out1[0]) == 2.0 and float(out2[0]) == 2.0
        assert profiler.misses_for("toy") == 1

        key_b = ("bucket", 128)
        profiler.call("toy", _times, (np.ones(128, np.float32),), (2,),
                      key_b, "cpu")
        assert profiler.misses_for("toy") == 2

        s = profiler.summary()
        assert s["Launches"] == 3
        assert s["Misses"] == 2
        assert s["Dispatches"] == {"toy": 3}
        assert s["TransferBytes"]["h2d"] == (64 + 64 + 128) * 4
        assert s["StageSeconds"]["execute"] >= 0.0
        assert s["StageSeconds"]["h2d"] > 0.0
        assert s["StageSeconds"]["compile"] > 0.0
        assert profiler.keys() == [("toy", key_a), ("toy", key_b)]

    def test_live_wave_records_kernel_stages(self, clean_telemetry):
        """A real coalesced wave of the port's server populates the kernel
        spans and the per-key accounting."""
        from nomad_tpu_torch.server.server import Server, ServerConfig

        server = Server(ServerConfig(num_workers=1, worker_batch_size=4,
                                     heartbeat_ttl=3600.0, gc_tuning=False),
                        device="cpu")
        server.start()
        try:
            for _ in range(20):
                server.node_register(mock.node())
            jobs = []
            for _ in range(8):
                job = mock.simple_job()
                job.task_groups[0].count = 2
                jobs.append(job)
                server.job_register(job)
            deadline = time.time() + 60
            while time.time() < deadline:
                snap = server.state.snapshot()
                if sum(len(snap.allocs_by_job(j.namespace, j.id))
                       for j in jobs) >= 16:
                    break
                time.sleep(0.05)
            stages = tracer.stage_totals()
            for name in ("worker.snapshot", "eval.schedule",
                         "wave.assemble", "kernel.h2d", "kernel.execute",
                         "kernel.d2h", "plan.evaluate", "plan.group_commit",
                         "plan.commit", "fsm.apply"):
                assert name in stages, f"missing span {name}"
            prof = profiler.summary()
            assert prof["Launches"] >= 1
            assert prof["TransferBytes"]["d2h"] > 0
            # a repeated key is no miss
            assert prof["Misses"] <= len(prof["PerKey"])
        finally:
            server.shutdown()


class TestMisses:
    def test_warmed_key_is_no_miss(self, clean_telemetry):
        profiler.mark_warm("toy", ("warm", 8))
        profiler.call("toy", _times, (np.ones(8, np.float32),), (3,),
                      ("warm", 8), "cpu")
        assert profiler.summary()["Misses"] == 0

    def test_seen_keys_survive_reset_until_cleared(self, clean_telemetry):
        args = (np.ones(8, np.float32),)
        profiler.call("toy", _times, args, (3,), ("k",), "cpu")
        profiler.reset()
        profiler.call("toy", _times, args, (3,), ("k",), "cpu")
        assert profiler.summary()["Misses"] == 0
        profiler.clear_seen()
        profiler.call("toy", _times, args, (3,), ("k",), "cpu")
        assert profiler.summary()["Misses"] == 1

    def test_library_load_inside_a_launch_is_a_miss(self, clean_telemetry,
                                                    monkeypatch):
        args = (np.ones(8, np.float32),)
        profiler.call("toy", _times, args, (3,), ("lib",), "cpu")

        def loads_a_library(x, k):
            monkeypatch.setattr(ck, "library_loads", ck.library_loads + 1)
            return x * k

        profiler.call("toy", loads_a_library, args, (3,), ("lib",), "cpu")
        s = profiler.summary()
        assert s["Misses"] == 2 and s["PerKey"][0]["Launches"] == 2

    def test_disabled_profiler_calls_through(self):
        telemetry.disable()
        profiler.reset()
        got = []

        def fn(x, k):
            got.append(type(x))
            return k

        assert profiler.call("toy", fn, (np.ones(4),), (5,), ("d",),
                             "cpu") == 5
        # the callee gets its arguments as they were: nothing uploaded
        assert got == [np.ndarray]
        assert profiler.summary()["Launches"] == 0
        profiler.add_bytes("h2d", 100)
        profiler.count_dispatch("topk_drain")
        assert profiler.summary()["TransferBytes"]["h2d"] == 0
        assert profiler.summary()["Dispatches"] == {}

    def test_tensor_on_another_device_is_refused(self, clean_telemetry):
        with pytest.raises(ValueError, match="plane on meta"):
            profiler.call("toy", _times, (torch.ones(4, device="meta"),),
                          (2,), ("m",), "cpu")


def test_steady_resident_wave_uploads_no_shared_plane(clean_telemetry):
    """With the snapshot's planes resident on the wave's device (the
    batching worker's ``ClusterCache(device=...)``), a wave whose members
    share them uploads 0 bytes for the twelve wave-shared planes and
    counts exactly one dispatch."""
    store = StateStore()
    for _ in range(40):
        store.upsert_node(mock.node())
    snap = store.snapshot()
    cluster = pc.ClusterCache(device="cpu").get(snap)
    host = cluster.wave_shared_planes(snap.usage)
    assert set(host) == set(pc._SHAREABLE_FIELDS)
    kin = _dummy_kin(cluster.n_pad, 8)._replace(
        **host, n_steps=np.asarray(2, np.int32),
        ask_cpu=np.asarray(100.0, np.float32),
        ask_mem=np.asarray(64.0, np.float32),
        base_mask=np.ones(cluster.n_pad, bool))
    perms = [np.random.default_rng(s).permutation(cluster.n_pad).astype(
        np.int32) for s in range(4)]

    def wave(planes):
        kins = [kin._replace(**planes, node_perm=p) for p in perms]
        telemetry.reset()
        pc.launch_wave(kins, [8] * 4, [LEAN_FEATURES] * 4, device="cpu")
        return profiler.summary()

    # the first wave may also upload the frozen neutral planes of this
    # node size, once per process (the device state's first sight)
    resident = [wave(host) for _ in range(3)][1:]
    # the same wave over unregistered copies of the planes (still shared
    # by identity among the members): each goes up once
    copies = wave({f: np.array(a) for f, a in host.items()})
    shared_bytes = sum(a.nbytes for a in host.values())
    for s in resident + [copies]:
        assert s["Dispatches"] == {"fused_wave": 1}, s
        assert s["TransferBytes"]["d2h"] > 0
    assert (copies["TransferBytes"]["h2d"]
            - resident[1]["TransferBytes"]["h2d"]) == shared_bytes
    assert resident[0]["TransferBytes"] == resident[1]["TransferBytes"]
    assert resident[1]["Misses"] == 0
