"""The port's resident cluster state split over a mesh, against the JAX
package's (CPU).

Counterparts of each scenario of ``tests/test_sharded_state.py``: with a
mesh configured, a generation is placed split over the mesh's nodes axis
(each plane a tuple of per-shard tensors) and must stay bit-identical to
a fresh ``ClusterTensors.build`` through every advance path (the
sharded dirty-row scatter, structure forks, eviction and miss rebuilds,
trimmed-log fallbacks), to the JAX state's resident planes on its 8
virtual devices, and shard by shard to the fresh planes split by shard.
Lookups carry the caller's placement: a one-device lookup misses a split
generation and the reverse, and a foreign mesh misses both. Both states
see one store history (``test_torch_device_state.Pair``); their
counters match as there.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax

from nomad_tpu import mock
from nomad_tpu.parallel import sharded as ref_sharded
from nomad_tpu.state import usage as ref_usage
from nomad_tpu.tensors.device_state import DeviceClusterState as RefState
from nomad_tpu_torch.ops.kernel import neutral_planes
from nomad_tpu_torch.parallel import sharded
from nomad_tpu_torch.tensors import device_state as pds
from nomad_tpu_torch.tensors.device_state import DeviceClusterState
from nomad_tpu_torch.tensors.schema import ClusterTensors

from test_torch_device_state import CPU, Pair


#: eight CPU entries, as the conftest gives JAX eight virtual devices
CPU8 = [CPU] * 8


@pytest.fixture()
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return sharded.wave_mesh(devices=CPU8)


class ShardedPair(Pair):
    """``Pair`` with both states split over an 8-device mesh."""

    def __init__(self, mesh, n_nodes=24, max_generations=4):
        super().__init__(n_nodes=n_nodes, max_generations=max_generations)
        self.mesh = mesh
        self.ref_ds = RefState(max_generations=max_generations,
                               mesh=ref_sharded.wave_mesh(8))
        self.ds = DeviceClusterState(max_generations=max_generations,
                                     mesh=mesh)

    def gens(self, rs, ps):
        return (self.ref_ds._gens[(rs.usage.uid,
                                   rs.usage.structure_version)],
                self.ds._gens[(ps.usage.uid, ps.usage.structure_version,
                               self.mesh.key)])

    def assert_parity(self, rs, ps, stats=True):
        """Port shards == the fresh planes split by shard; their
        concatenation == the JAX planes == a fresh build."""
        ref_gen, gen = self.gens(rs, ps)
        assert gen.mesh is self.mesh
        fresh = ClusterTensors.build(ps.nodes()).wave_shared_planes(
            ps.usage)
        assert set(gen.planes) == set(fresh) == set(ref_gen.planes)
        for f, host in fresh.items():
            parts = gen.planes[f]
            assert isinstance(parts, tuple) and len(parts) == 8, f
            want = sharded.place(host, sharded.P("nodes"), self.mesh)
            for got, w in zip(parts, want):
                assert got.device == CPU and got.dtype == w.dtype, f
                assert torch.equal(got, w), f
            whole = torch.cat(parts).numpy()
            assert whole.dtype == host.dtype, f
            npt.assert_array_equal(whole, host, err_msg=f)
            npt.assert_array_equal(whole, np.asarray(ref_gen.planes[f]),
                                   err_msg=f)
            assert len(ref_gen.planes[f].sharding.device_set) == 8
        if stats:
            self.assert_stats()


@pytest.fixture()
def spair(mesh):
    return ShardedPair(mesh)


class TestShardedDeltaParity:
    def test_alloc_churn_advances_by_sharded_scatter(self, spair):
        spair.ensure()
        nodes = spair.nodes()
        spair.upsert_allocs(
            [mock.alloc(node_id=nodes[i % 8].id) for i in range(20)])
        rs, ps, *_ = spair.ensure()
        assert spair.ds.delta_advances == 1
        assert spair.ds.full_uploads == 1          # only the initial build
        assert spair.ds.usage_full_uploads == 0
        spair.assert_parity(rs, ps)

    def test_structure_fork_stays_sharded(self, spair):
        spair.ensure()
        node = spair.nodes()[5].copy()
        node.node_resources.cpu.cpu_shares = 12345
        spair.upsert_node(node)
        rs, ps, *_ = spair.ensure()
        assert spair.ds.fork_deltas == 1
        spair.assert_parity(rs, ps)

    @pytest.mark.parametrize("n_nodes", [9, 24, 63])
    def test_uneven_node_counts_pad_to_shard_multiples(self, mesh,
                                                       n_nodes):
        """Real node counts that do not divide the mesh: the pad bucket
        (a power of two, 64 at least) does, so real rows land unevenly
        over the shards; parity holds through churn."""
        spair = ShardedPair(mesh, n_nodes=n_nodes)
        spair.ensure()
        nodes = spair.nodes()
        spair.upsert_allocs(
            [mock.alloc(node_id=nodes[i % n_nodes].id)
             for i in range(min(n_nodes * 2, 30))])
        rs, ps, *_ = spair.ensure()
        assert spair.ds.delta_advances == 1
        spair.assert_parity(rs, ps)

    def test_random_sharded_sequences(self, spair):
        """Random interleavings of alloc transitions and node adds,
        updates, drains and deletes, with parity after every round."""
        rng = np.random.default_rng(41)
        spair.ensure()
        live = []
        for _round in range(6):
            for _ in range(int(rng.integers(1, 5))):
                nodes = spair.nodes()
                pick = nodes[int(rng.integers(0, len(nodes)))]
                op = rng.integers(0, 6)
                if op == 0:
                    a = mock.alloc(node_id=pick.id)
                    live.append(a)
                    spair.upsert_allocs([a])
                elif op == 1 and live:
                    a = live.pop(int(rng.integers(0, len(live))))
                    spair.both("stop_alloc", a.id, [])
                elif op == 2:
                    spair.upsert_node(mock.node())
                elif op == 3:
                    n = pick.copy()
                    n.node_resources.cpu.cpu_shares = int(
                        rng.integers(1000, 9000))
                    spair.upsert_node(n)
                elif op == 4:
                    spair.both("update_node_drain", pick.id,
                               bool(rng.integers(0, 2)))
                elif len(nodes) > 4:
                    spair.both("delete_node", pick.id)
            rs, ps, *_ = spair.ensure()
            spair.assert_parity(rs, ps)
        assert spair.ds.delta_advances + spair.ds.fork_deltas >= 2

    def test_trimmed_row_log_full_upload_stays_sharded(self, spair):
        """The unprovable-log fallback uploads the usage planes again,
        split as the generation is, not to one device."""
        spair.ensure()
        nodes = spair.nodes()
        for i in range(ref_usage.ROW_LOG_MAX + 8):
            spair.upsert_allocs([mock.alloc(node_id=nodes[i % 8].id)])
        rs, ps, *_ = spair.ensure()
        assert spair.ds.usage_full_uploads == 1
        assert spair.ds.delta_advances == 0
        spair.assert_parity(rs, ps)

    def test_eviction_and_miss_rebuild_sharded(self, mesh):
        spair = ShardedPair(mesh, max_generations=2)
        rs_first, first, _, first_cluster, _, _ = spair.ensure()
        first_host = first_cluster.wave_shared_planes(first.usage)
        for _ in range(3):
            spair.upsert_node(mock.node())
            spair.ensure()
        assert len(spair.ds._gens) == 2
        assert spair.ds.lookup(first_host["cap_cpu"], mesh=mesh) is None
        full_before = spair.ds.full_uploads
        spair.ds.ensure(first_cluster, first.usage, mesh)
        spair.ref_ds.ensure(spair.ref_cache.get(rs_first), rs_first.usage)
        assert spair.ds.full_uploads == full_before + 1
        spair.assert_parity(rs_first, first)

    def test_scatter_writes_each_shard_its_own_rows(self, spair,
                                                    monkeypatch):
        """Dirty rows carry global ids; each shard writes only the rows
        in its slice, as local ids, and a shard without one is not
        written (its tensor stays the same object)."""
        seen = []
        real = pds._scatter_rows

        def record(plane, rows, vals):
            seen.append((int(plane.shape[0]), rows.tolist()))
            return real(plane, rows, vals)

        _, ps0, *_ = spair.ensure()
        gen0 = dict(spair.gens(spair.ref.snapshot(), ps0)[1].planes)
        monkeypatch.setattr(pds, "_scatter_rows", record)
        nodes = spair.nodes()
        spair.upsert_allocs([mock.alloc(node_id=nodes[i].id)
                             for i in (0, 9, 9, 20)])
        rs, ps, *_ = spair.ensure()
        cluster = spair.cache.get(ps)
        dirty = sorted(cluster.index[nodes[i].id] for i in (0, 9, 20))
        n_loc = cluster.n_pad // 8
        by_shard = {}
        for r in dirty:
            by_shard.setdefault(r // n_loc, []).append(r % n_loc)
        fields = len(ClusterTensors.WAVE_USAGE_FIELDS)
        assert sorted(rows for _, rows in seen) == sorted(
            rows for rows in by_shard.values() for _ in range(fields))
        assert all(n == n_loc for n, _ in seen)
        gen = spair.gens(rs, ps)[1]
        for f in ClusterTensors.WAVE_USAGE_FIELDS:
            for s in range(8):
                same = gen.planes[f][s] is gen0[f][s]
                assert same == (s not in by_shard), (f, s)
        spair.assert_parity(rs, ps)


class TestPlacementIsolation:
    def test_single_device_lookup_misses_sharded_generation(self, spair,
                                                            mesh):
        """A one-device wave never receives a split plane, a wave over
        another mesh never receives this one's."""
        _, ps, _, cluster, _, _ = spair.ensure()
        host = cluster.wave_shared_planes(ps.usage)
        for f, arr in host.items():
            assert spair.ds.lookup(arr, frozen_ok=False,
                                   mesh=mesh) is not None, f
            assert spair.ds.lookup(arr, "cpu", frozen_ok=False) is None, f
            assert spair.ds.lookup(
                arr, frozen_ok=False,
                mesh=sharded.wave_mesh(4, devices=CPU8)) is None, f
        # a new mesh object over the same devices names the same
        # placement
        same = sharded.wave_mesh(devices=CPU8)
        assert spair.ds.lookup(host["cap_cpu"], frozen_ok=False,
                               mesh=same) is not None

    def test_frozen_singleton_resident_under_both_placements(self, mesh):
        ds = DeviceClusterState(mesh=mesh)
        host = neutral_planes(64).zeros_f32
        spec = sharded.shared_field_spec("cap_cpu")
        dev_sharded = ds.lookup(host, spec=spec, mesh=mesh)
        dev_single = ds.lookup(host, "cpu")
        assert dev_sharded is not None and dev_single is not None
        assert isinstance(dev_sharded, tuple) and len(dev_sharded) == 8
        npt.assert_array_equal(torch.cat(dev_sharded).numpy(), host)
        npt.assert_array_equal(dev_single.numpy(), host)
        # repeat lookups serve the same resident leaves (no re-upload)
        assert ds.lookup(host, spec=spec, mesh=mesh) is dev_sharded
        assert ds.lookup(host, "cpu") is dev_single

    def test_foreign_mesh_frozen_lookup_misses(self, mesh):
        ds = DeviceClusterState(mesh=mesh)
        host = neutral_planes(64).zeros_f32
        spec = sharded.shared_field_spec("cap_cpu")
        other = sharded.wave_mesh(4, devices=CPU8)
        assert ds.lookup(host, spec=spec, mesh=other) is None
        # ... also once the same spec is resident under the state's own
        # mesh
        assert ds.lookup(host, spec=spec, mesh=mesh) is not None
        assert ds.lookup(host, spec=spec, mesh=other) is None

    def test_configure_mesh_change_evicts_everything(self, mesh):
        pair = Pair(n_nodes=16)
        ds = pair.ds                                  # one device
        _, snap, _, cluster, _, _ = pair.ensure()
        host = cluster.wave_shared_planes(snap.usage)
        assert ds.lookup(host["cap_cpu"], "cpu") is not None
        ds.request(cluster, snap.usage, "cpu")
        ds.configure_mesh(mesh)
        assert ds.lookup(host["cap_cpu"], "cpu") is None
        assert ds.lookup(host["cap_cpu"], mesh=mesh) is None
        assert len(ds._gens) == 0 and len(ds._frozen) == 0
        assert not ds._pending
        assert ds.snapshot()["mesh_devices"] == 8
        # ensure again builds the split generation
        ds.ensure(cluster, snap.usage, "cpu")
        assert ds.lookup(host["cap_cpu"], mesh=mesh) is not None
        # an equal mesh (a new object over the same devices) is no change
        gens_before = dict(ds._gens)
        ds.configure_mesh(sharded.wave_mesh(devices=CPU8))
        assert dict(ds._gens) == gens_before
        ds.configure_mesh(None)
        assert len(ds._gens) == 0 and ds.snapshot()["mesh_devices"] == 0

    def test_indivisible_node_axis_places_single_device(self, mesh):
        """A mesh whose device count does not divide the pad bucket (3 x
        64 rows): generations stay on one device and serve one-device
        callers; the launcher makes the same call and falls back."""
        pair = Pair(n_nodes=16)
        pair.ds.configure_mesh(sharded.wave_mesh(3, devices=CPU8))
        _, snap, _, cluster, _, gen = pair.ensure()
        assert gen.mesh is None
        host = cluster.wave_shared_planes(snap.usage)
        assert pair.ds.lookup(host["cap_cpu"], "cpu") is not None


class TestRequests:
    def test_requests_advance_on_the_mesh(self, spair, mesh):
        """An eval's ``request`` on its device is placed by the state's
        mesh; the sharded wave's ``advance_pending(mesh)`` runs it, and
        ``check_fresh`` holds each shard against the fresh planes split
        by shard."""
        ds = spair.ds
        _, ps, _, cluster, _, _ = spair.ensure()
        spair.upsert_allocs([mock.alloc(node_id=spair.nodes()[3].id)])
        ps = spair.port.snapshot()
        cluster = spair.cache.get(ps)
        ds.request(cluster, ps.usage, "cpu")
        assert ds.planes_for(ps.usage, mesh) is None
        ds.advance_pending(mesh)
        assert not ds._pending
        planes = ds.planes_for(ps.usage, mesh)
        assert planes is not None and all(
            isinstance(p, tuple) for p in planes.values())
        assert ds.delta_advances == 1
        res = ds.check_fresh(ps, "cpu")
        assert res == {"resident": True, "planes": len(planes),
                       "differ": [], "shards": 8}, res
        # a write into one shard of the generation check_fresh compared
        ds.planes_for(ps.usage, "cpu")["used_cpu"][2][0] += 1.0
        assert ds.check_fresh(ps, "cpu")["differ"] == ["used_cpu"]

    def test_warm_scatter_covers_the_shards(self, mesh):
        ds = DeviceClusterState(mesh=mesh)
        # the whole plane on the device, then a shard on each distinct
        # mesh device (one here: the virtual mesh's CPU)
        assert ds.warm_scatter(256, "cpu") == 4
        assert DeviceClusterState().warm_scatter(256, "cpu") == 2

    def test_ensure_refuses_a_foreign_mesh(self, spair, mesh):
        _, ps, _, cluster, _, _ = spair.ensure()
        foreign = sharded.wave_mesh(4, devices=CPU8)
        with pytest.raises(ValueError, match="not this state's mesh"):
            spair.ds.ensure(cluster, ps.usage, foreign)
        assert spair.ds.planes_for(ps.usage, foreign) is None
        assert spair.ds.planes_for(ps.usage, mesh) is not None
