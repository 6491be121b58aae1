"""The port's device-resident cluster state against the JAX package's (CPU).

The scenarios of ``tests/test_device_state.py`` run on both packages'
``DeviceClusterState`` with one store history: every node and alloc is
made with the JAX ``mock`` and carried across with
``convert.structs_from_reference``, and every write goes to both stores
in the same order. After each ensure, the port's resident planes (on
``device="cpu"``) must equal, bit for bit and dtype for dtype, both the
JAX state's resident planes and a fresh ``ClusterTensors.build`` of the
snapshot; the stats counters must match the JAX state's, except
``bytes_uploaded``: the JAX scatter pads each row batch to a bucket,
the port uploads the real rows alone, so its bytes are never more.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.state import usage as ref_usage
from nomad_tpu.state.store import StateStore as RefStore
from nomad_tpu.tensors.device_state import DeviceClusterState as RefState
from nomad_tpu.tensors.schema import IncrementalClusterCache as RefCache
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.ops.kernel import neutral_planes
from nomad_tpu_torch.state.store import StateStore as PortStore
from nomad_tpu_torch.tensors import device_state as pds
from nomad_tpu_torch.tensors.device_state import DeviceClusterState
from nomad_tpu_torch.tensors.schema import (
    ClusterTensors,
    IncrementalClusterCache,
)

CPU = torch.device("cpu")

#: stats keys both packages count alike
SAME_STATS = ("hits", "full_uploads", "delta_advances", "fork_deltas",
              "usage_full_uploads", "rows_uploaded", "bytes_full_equiv",
              "resident_generations", "mesh_devices")


class Pair:
    """One store history in both packages, each with its own cluster
    cache and device state."""

    def __init__(self, n_nodes=24, max_generations=4):
        self.ref = RefStore()
        self.port = PortStore()
        self.memo = {}
        self.ref_ds = RefState(max_generations=max_generations)
        self.ds = DeviceClusterState(max_generations=max_generations)
        self.ref_cache = RefCache()
        self.cache = IncrementalClusterCache()
        for _ in range(n_nodes):
            self.upsert_node(mock.node())

    def conv(self, obj):
        return structs_from_reference(obj, self.memo)

    def upsert_node(self, node):
        port = self.conv(node)
        self.ref.upsert_node(node)
        self.port.upsert_node(port)

    def upsert_allocs(self, allocs):
        port = [self.conv(a) for a in allocs]
        self.ref.upsert_allocs(allocs)
        self.port.upsert_allocs(port)

    def both(self, method, *args):
        getattr(self.ref, method)(*args)
        getattr(self.port, method)(*args)

    def nodes(self):
        return self.ref.snapshot().nodes()

    def ensure(self):
        """Ensure the newest snapshot on both sides; returns both
        snapshots, their clusters and both generations."""
        rs, ps = self.ref.snapshot(), self.port.snapshot()
        rc, pc = self.ref_cache.get(rs), self.cache.get(ps)
        return (rs, ps, rc, pc, self.ref_ds.ensure(rc, rs.usage),
                self.ds.ensure(pc, ps.usage, "cpu"))

    def gens(self, rs, ps):
        return (self.ref_ds._gens[(rs.usage.uid,
                                   rs.usage.structure_version)],
                self.ds._gens[(ps.usage.uid, ps.usage.structure_version,
                               CPU)])

    def assert_parity(self, rs, ps, stats=True):
        """Port planes == JAX planes == a fresh build, dtype for dtype;
        counters alike (unless the port's history differs on purpose)."""
        ref_gen, gen = self.gens(rs, ps)
        fresh = ClusterTensors.build(ps.nodes()).wave_shared_planes(
            ps.usage)
        assert set(gen.planes) == set(fresh) == set(ref_gen.planes)
        for f, host in fresh.items():
            got = gen.planes[f]
            assert got.device == CPU, f
            got = got.numpy()
            ref = np.asarray(ref_gen.planes[f])
            assert got.dtype == host.dtype == ref.dtype, f
            npt.assert_array_equal(got, host, err_msg=f)
            npt.assert_array_equal(got, ref, err_msg=f)
        if stats:
            self.assert_stats()

    def assert_stats(self):
        r, p = self.ref_ds.snapshot(), self.ds.snapshot()
        for k in SAME_STATS:
            assert p[k] == r[k], (k, p[k], r[k])
        assert p["bytes_uploaded"] <= r["bytes_uploaded"]
        assert p["errors"] == 0


@pytest.fixture()
def pair():
    return Pair()


class TestDeviceDeltaParity:
    def test_alloc_churn_advances_by_scatter(self, pair):
        pair.ensure()
        nodes = pair.nodes()
        pair.upsert_allocs(
            [mock.alloc(node_id=nodes[i % 8].id) for i in range(20)])
        rs, ps, *_ = pair.ensure()
        assert pair.ds.delta_advances == 1
        assert pair.ds.full_uploads == 1          # only the initial build
        assert pair.ds.rows_uploaded > 0
        pair.assert_parity(rs, ps)

    def test_structural_update_is_fork_delta(self, pair):
        pair.ensure()
        node = pair.nodes()[5].copy()
        node.node_resources.cpu.cpu_shares = 12345
        pair.upsert_node(node)
        rs, ps, *_ = pair.ensure()
        assert pair.ds.fork_deltas == 1
        pair.assert_parity(rs, ps)

    def test_delete_permutes_rows_and_falls_back_to_full(self, pair):
        pair.ensure()
        pair.both("delete_node", pair.nodes()[0].id)
        rs, ps, *_ = pair.ensure()
        assert pair.ds.fork_deltas == 0
        assert pair.ds.full_uploads == 2
        pair.assert_parity(rs, ps)

    def test_random_scatter_sequences(self, pair):
        rng = np.random.default_rng(23)
        pair.ensure()
        live_allocs = []
        for _round in range(8):
            for _ in range(int(rng.integers(1, 5))):
                nodes = pair.nodes()
                pick = nodes[int(rng.integers(0, len(nodes)))]
                op = rng.integers(0, 6)
                if op == 0:
                    a = mock.alloc(node_id=pick.id)
                    live_allocs.append(a)
                    pair.upsert_allocs([a])
                elif op == 1 and live_allocs:
                    a = live_allocs.pop(
                        int(rng.integers(0, len(live_allocs))))
                    pair.both("stop_alloc", a.id, [])
                elif op == 2:
                    pair.upsert_node(mock.node())
                elif op == 3:
                    n = pick.copy()
                    n.node_resources.cpu.cpu_shares = int(
                        rng.integers(1000, 9000))
                    pair.upsert_node(n)
                elif op == 4:
                    pair.both("update_node_drain", pick.id,
                              bool(rng.integers(0, 2)))
                elif len(nodes) > 4:
                    pair.both("delete_node", pick.id)
            rs, ps, *_ = pair.ensure()
            pair.assert_parity(rs, ps)
        assert pair.ds.delta_advances + pair.ds.fork_deltas >= 2

    def test_trimmed_row_log_falls_back_to_full_usage_upload(self, pair):
        pair.ensure()
        nodes = pair.nodes()
        for i in range(ref_usage.ROW_LOG_MAX + 8):
            pair.upsert_allocs([mock.alloc(node_id=nodes[i % 8].id)])
        rs, ps, *_ = pair.ensure()
        assert pair.ds.usage_full_uploads == 1
        assert pair.ds.delta_advances == 0
        pair.assert_parity(rs, ps)


class TestGenerationCache:
    def test_same_version_is_hit(self, pair):
        *_, g1 = pair.ensure()
        *_, g2 = pair.ensure()
        assert g1 is g2
        assert pair.ds.hits == 1
        pair.assert_stats()

    def test_structure_fork_keeps_both_generations(self, pair):
        """A wave still running against the OLD structure version keeps
        its resident planes while the new version's generation advances."""
        _, old_snap, _, old_cluster, _, _ = pair.ensure()
        old_host = old_cluster.wave_shared_planes(old_snap.usage)
        old_dev = {f: pair.ds.lookup(h, "cpu") for f, h in old_host.items()}
        assert all(t is not None for t in old_dev.values())
        pair.upsert_node(mock.node())
        rs, ps, *_ = pair.ensure()
        pair.assert_parity(rs, ps)
        for f, host in old_host.items():
            dev = pair.ds.lookup(host, "cpu")
            assert dev is old_dev[f], f
            npt.assert_array_equal(dev.numpy(), host, err_msg=f)

    def test_older_snapshot_does_not_demote_generation(self, pair):
        rs_old, ps_old, rc, cluster, _, _ = pair.ensure()
        pair.upsert_allocs([mock.alloc(node_id=pair.nodes()[0].id)])
        rs, ps, *_ = pair.ensure()
        ds = pair.ds
        uploads = ds.full_uploads + ds.usage_full_uploads
        key = (ps.usage.uid, ps.usage.structure_version, CPU)
        gen_new = ds._gens[key]
        assert ds.ensure(pair.cache.get(ps_old), ps_old.usage, "cpu") is None
        assert pair.ref_ds.ensure(pair.ref_cache.get(rs_old),
                                  rs_old.usage) is None
        assert ds.full_uploads + ds.usage_full_uploads == uploads
        assert ds._gens[key] is gen_new
        assert gen_new.version == ps.usage.version
        stale_used = cluster.gathered_usage(ps_old.usage)[0]
        assert ds.lookup(stale_used, "cpu", frozen_ok=False) is None
        assert len(ds._frozen) == 0
        pair.assert_parity(rs, ps)

    def test_eviction_unregisters_and_miss_rebuilds(self):
        pair = Pair(max_generations=2)
        rs_first, first, _, first_cluster, _, _ = pair.ensure()
        first_host = first_cluster.wave_shared_planes(first.usage)
        for _ in range(3):
            pair.upsert_node(mock.node())
            pair.ensure()
        assert len(pair.ds._gens) == 2
        assert pair.ds.evictions == 2
        assert pair.ds.lookup(first_host["cap_cpu"], "cpu") is None
        full_before = pair.ds.full_uploads
        pair.ds.ensure(first_cluster, first.usage, "cpu")
        pair.ref_ds.ensure(pair.ref_cache.get(rs_first), rs_first.usage)
        assert pair.ds.full_uploads == full_before + 1
        pair.assert_parity(rs_first, first)
        gen = pair.ds._gens[(first.usage.uid,
                             first.usage.structure_version, CPU)]
        for f, host in first_host.items():
            npt.assert_array_equal(gen.planes[f].numpy(), host, err_msg=f)


class TestRegistry:
    def test_frozen_singletons_become_resident(self):
        ds = DeviceClusterState()
        host = neutral_planes(64).zeros_f32
        dev1 = ds.lookup(host, "cpu")
        dev2 = ds.lookup(host, "cpu")
        assert dev1 is not None and dev1 is dev2
        assert dev1.dtype == torch.float32
        npt.assert_array_equal(dev1.numpy(), host)
        # a copy, never an alias of the read-only host array
        assert dev1.data_ptr() != host.ctypes.data

    def test_mutable_unregistered_array_is_not_resident(self):
        ds = DeviceClusterState()
        assert ds.lookup(np.zeros(8, np.float32), "cpu") is None
        assert ds.lookup(3.5, "cpu") is None


class TestPortOnly:
    def test_lookup_keyed_by_device_never_serves_another(self, pair):
        """Two registries in one state: a generation resident on a
        second device (``meta``, a stand-in for the card on a CPU-only
        machine) and one on the CPU. A lookup serves only the twin on
        the wave's own device; an entry keyed by ``cuda:0`` is never
        served to a CPU wave."""
        rs, ps, rc, cluster, _, _ = pair.ensure()
        pair.assert_parity(rs, ps)
        ds = pair.ds
        meta = torch.device("meta")
        ds.ensure(cluster, ps.usage, meta)
        host = cluster.wave_shared_planes(ps.usage)
        for f, h in host.items():
            on_cpu = ds.lookup(h, "cpu")
            on_meta = ds.lookup(h, meta)
            assert on_cpu.device == CPU and on_meta.device == meta, f
        frozen = neutral_planes(32).zeros_i32
        assert ds.lookup(frozen, meta).device == meta
        assert ds.lookup(frozen, "cpu").device == CPU
        # an entry on the card, seen from a CPU wave
        card_only = np.ones(4, np.float32)
        ds._registry[(id(card_only), torch.device("cuda", 0))] = (
            card_only, torch.ones(4))
        assert ds.lookup(card_only, "cpu") is None
        assert ds.lookup(card_only, meta) is None
        assert ds.snapshot()["full_uploads"] == 2     # one per device

    def test_padding_rows_never_reach_the_indexed_write(self, pair,
                                                        monkeypatch):
        """Every row the scatter writes is a real dirty row of the plane:
        no bucket padding, no out-of-range index (the JAX scatter drops
        its out-of-bounds padding; torch's index_copy would raise)."""
        seen = []
        real = pds._scatter_rows

        def record(plane, rows, vals):
            seen.append((int(plane.shape[0]), rows.tolist()))
            return real(plane, rows, vals)

        monkeypatch.setattr(pds, "_scatter_rows", record)
        pair.ensure()
        nodes = pair.nodes()
        pair.upsert_allocs([mock.alloc(node_id=nodes[i].id)
                            for i in (0, 3, 3, 7)])
        rs, ps, *_ = pair.ensure()
        assert seen
        cluster = pair.cache.get(ps)
        dirty = sorted(cluster.index[nodes[i].id] for i in (0, 3, 7))
        for n_pad, rows in seen:
            assert rows == dirty
            assert all(0 <= r < n_pad for r in rows)
        pair.assert_parity(rs, ps)
        # a row outside the planes is refused before any write
        gen = pair.ds._gens[(ps.usage.uid, ps.usage.structure_version, CPU)]
        host = cluster.wave_shared_planes(ps.usage)
        n_pad = cluster.n_pad
        seen.clear()
        with pytest.raises(IndexError):
            pair.ds._scatter(gen.planes, host, {n_pad}, CPU)
        assert not seen

    def test_failed_advance_is_counted(self, pair, monkeypatch):
        from nomad_tpu_torch.parallel import coalesce

        def broken(*a, **k):
            raise RuntimeError("upload failed")

        ds = DeviceClusterState()
        monkeypatch.setattr(coalesce, "default_device_state", ds)
        monkeypatch.setattr(ds, "_fork_or_build", broken)
        snap = pair.port.snapshot()
        cluster = coalesce.ClusterCache(device="cpu").get(snap)
        assert cluster.n_real == 24       # the build is served all the same
        assert ds.snapshot()["errors"] == 0   # requested, not advanced yet
        ds.advance_pending("cpu")
        assert ds.snapshot()["errors"] == 1
        assert "upload failed" in ds.snapshot()["last_error"]

    def test_request_defers_the_advance_to_the_wave(self, pair):
        """``request`` (an eval at snapshot time) makes nothing resident;
        ``advance_pending`` (the wave's assembling thread) does, newest
        usage first, and a request for a current generation is a hit."""
        ds = pair.ds
        rs, ps, *_ = pair.ensure()
        pair.upsert_allocs([mock.alloc(node_id=pair.nodes()[1].id)])
        snaps = [pair.port.snapshot()]
        pair.upsert_allocs([mock.alloc(node_id=pair.nodes()[2].id)])
        snaps.append(pair.port.snapshot())
        for snap in snaps:
            ds.request(pair.cache.get(snap), snap.usage, "cpu")
        assert ds.planes_for(snaps[1].usage, "cpu") is None
        ds.advance_pending("meta")                  # another device's
        assert ds.planes_for(snaps[1].usage, "cpu") is None
        ds.advance_pending("cpu")
        assert ds.planes_for(snaps[1].usage, "cpu") is not None
        assert ds.delta_advances == 1 and not ds._pending
        rs, ps, *_ = pair.ensure()
        pair.assert_parity(rs, ps, stats=False)
        hits = ds.hits
        ds.request(pair.cache.get(ps), ps.usage, "cpu")
        assert ds.hits == hits + 1 and not ds._pending

    def test_check_fresh_names_a_plane_that_differs(self, pair):
        """``check_fresh`` advances the resident planes to a snapshot and
        finds them equal to a fresh upload; a plane changed on the device
        is named."""
        ds = pair.ds
        pair.ensure()
        pair.upsert_allocs([mock.alloc(node_id=pair.nodes()[1].id)])
        snap = pair.port.snapshot()
        res = ds.check_fresh(snap, "cpu")
        assert res["resident"] and res["differ"] == [], res
        ds.planes_for(snap.usage, "cpu")["used_cpu"][0] += 1.0
        assert ds.check_fresh(snap, "cpu")["differ"] == ["used_cpu"]


class TestClusterCacheResidency:
    """Every ``ClusterCache`` names a device (the card unless the caller
    names the CPU) and requests its snapshots' planes resident there:
    no setting turns residency off."""

    def test_cache_requests_the_snapshot_planes(self, pair, monkeypatch):
        from nomad_tpu_torch.parallel import coalesce

        ds = DeviceClusterState()
        monkeypatch.setattr(coalesce, "default_device_state", ds)
        cache = coalesce.ClusterCache("cpu")
        assert cache.device == CPU
        snap = pair.port.snapshot()
        cluster = cache.get(snap)
        assert ds._pending and ds.planes_for(snap.usage, "cpu") is None
        ds.advance_pending("cpu")
        planes = ds.planes_for(snap.usage, "cpu")
        for f, host in cluster.wave_shared_planes(snap.usage).items():
            assert planes[f].dtype == pds._TORCH_DTYPES[host.dtype]
            npt.assert_array_equal(planes[f].numpy(), host)
        assert ds.snapshot()["errors"] == 0

    def test_default_cache_is_one_per_device(self):
        from nomad_tpu_torch.parallel import coalesce

        cpu = coalesce.default_cluster_cache("cpu")
        assert cpu is coalesce.default_cluster_cache(CPU)
        assert cpu.device == CPU
        if torch.cuda.is_available():
            assert coalesce.ClusterCache().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                coalesce.ClusterCache()
            with pytest.raises(RuntimeError, match="CUDA"):
                coalesce.default_cluster_cache()

    def test_scheduler_eval_makes_its_planes_resident(self, monkeypatch):
        """A ``GenericScheduler`` eval outside batch mode (the
        ``Harness``) builds its cluster through the default cache of its
        own device, and its placement reads the resident planes."""
        from nomad_tpu_torch import mock as port_mock
        from nomad_tpu_torch.parallel import coalesce
        from nomad_tpu_torch.scheduler.testing import Harness

        ds = DeviceClusterState()
        monkeypatch.setattr(coalesce, "default_device_state", ds)
        monkeypatch.setattr(pds, "default_device_state", ds)
        h = Harness(device="cpu")
        for _ in range(6):
            h.state.upsert_node(port_mock.node())
        job = port_mock.simple_job()
        h.state.upsert_job(job)
        h.process("service", port_mock.eval(job_id=job.id, type=job.type))
        assert len(h.placed_allocs()) == 10
        s = ds.snapshot()
        assert s["full_uploads"] == 1 and s["errors"] == 0, s
        assert s["resident_generations"] == 1
