"""The port's raft plane against the JAX package's raft test files (CPU).

Every scenario of ``tests/test_raft.py`` (bare raft nodes over the
in-memory and TCP transports, replicated servers, failover, partitions,
log compaction), of ``tests/test_raft_pipeline.py`` (the pipelined
AppendEntries window held equivalent to the synchronous path over
seeded fault schedules, leader leases, the batched apply's one wakeup)
and of ``tests/test_wal.py`` (CRC framing, torn tails, rotation, the
stable and snapshot stores, the torn-tail fuzz) runs on the port's
modules; every ``Server`` places on ``device="cpu"``. Then what the port
adds: a linearizable read through the port's ``ReadPlane`` on the leader
(the lease's fast path, then the barrier once the lease has lapsed), its
``NoLeaderError`` on a follower, a follower's default-mode read fenced
to the leader's commit index, and the six reference defects the port
repairs, each shown on both packages.
"""

import os
import random
import shutil
import tempfile
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.raft.log import LogEntry, LogStore
from nomad_tpu_torch.raft.node import NotLeaderError, RaftConfig, RaftNode
from nomad_tpu_torch.raft.observe import raft_observer
from nomad_tpu_torch.raft.transport import InmemTransport, TransportRegistry
from nomad_tpu_torch.raft.wal import (
    DurableLogStore,
    SnapshotStore,
    StableStore,
    WalCorruptionError,
    WriteAheadLog,
    replay_records,
    wal_stats,
)
from nomad_tpu_torch.server import fsm as fsm_mod
from nomad_tpu_torch.server.fsm import NomadFSM
from nomad_tpu_torch.server.readplane import (
    MODE_DEFAULT,
    MODE_LINEARIZABLE,
    NoLeaderError,
)
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.server.testing import make_cluster, wait_for_leader, wait_until
from nomad_tpu_torch.state.store import StateStore, watch_stats
from nomad_tpu_torch.state.usage import usage_rebuild_diff
from nomad_tpu_torch.utils import faultpoints


@pytest.fixture(autouse=True)
def _clean_plane():
    faultpoints.reset()
    yield
    faultpoints.reset()


def cpu_config(**kw):
    """``make_cluster``'s default server config, placing on the CPU."""
    return ServerConfig(num_workers=1, heartbeat_ttl=60.0, device="cpu",
                        **kw)


FAST = RaftConfig(
    heartbeat_interval=0.02,
    election_timeout_min=0.06,
    election_timeout_max=0.12,
)


def make_raft_cluster(n, fsm_factory=None):
    """N bare RaftNodes over an in-memory transport; each applies into
    its own list (the FSM)."""
    registry = TransportRegistry()
    addrs = [f"n{i}" for i in range(n)]
    nodes, logs = [], []
    for addr in addrs:
        applied = []
        logs.append(applied)
        node = RaftNode(
            node_id=addr,
            peers=addrs,
            transport=InmemTransport(addr, registry),
            fsm_apply=(lambda a: lambda t, r: a.append((t, r)) or len(a))(applied),
            config=FAST,
        )
        nodes.append(node)
    for node in nodes:
        node.start()
    return nodes, logs, registry


def leader_of(nodes, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [n for n in nodes if n.is_leader()]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.01)
    raise TimeoutError("no single leader")


def shutdown_all(nodes):
    for n in nodes:
        n.shutdown()


class TestRaftCore:
    def test_single_node_elects_self(self):
        nodes, logs, _ = make_raft_cluster(1)
        try:
            leader = leader_of(nodes)
            assert leader is nodes[0]
            result = leader.apply("set", {"k": 1})
            assert result == 1
            assert logs[0] == [("set", {"k": 1})]
        finally:
            shutdown_all(nodes)

    def test_three_node_replication(self):
        nodes, logs, _ = make_raft_cluster(3)
        try:
            leader = leader_of(nodes)
            for i in range(5):
                leader.apply("op", {"i": i})
            wait_until(
                lambda: all(len(l) == 5 for l in logs),
                msg="all FSMs applied 5 entries",
            )
            assert logs[0] == logs[1] == logs[2]
        finally:
            shutdown_all(nodes)

    def test_apply_on_follower_raises(self):
        nodes, logs, _ = make_raft_cluster(3)
        try:
            leader = leader_of(nodes)
            follower = next(n for n in nodes if n is not leader)
            with pytest.raises(NotLeaderError):
                follower.apply("op", {})
        finally:
            shutdown_all(nodes)

    def test_forward_apply_from_follower(self):
        nodes, logs, _ = make_raft_cluster(3)
        try:
            leader = leader_of(nodes)
            follower = next(n for n in nodes if n is not leader)
            result = follower.forward_apply("op", {"x": 1})
            assert result == 1
        finally:
            shutdown_all(nodes)

    def test_leader_failover(self):
        nodes, logs, _ = make_raft_cluster(3)
        try:
            leader = leader_of(nodes)
            leader.apply("op", {"i": 0})
            leader.shutdown()
            rest = [n for n in nodes if n is not leader]
            new_leader = leader_of(rest)
            assert new_leader is not leader
            new_leader.apply("op", {"i": 1})
            live_logs = [logs[nodes.index(n)] for n in rest]
            wait_until(
                lambda: all(len(l) == 2 for l in live_logs),
                msg="survivors applied both entries",
            )
        finally:
            shutdown_all(n for n in nodes if n._threads)

    def test_partition_heals(self):
        nodes, logs, registry = make_raft_cluster(3)
        try:
            leader = leader_of(nodes)
            followers = [n for n in nodes if n is not leader]
            # cut the leader from both followers: majority elects anew
            for f in followers:
                registry.partition(leader.id, f.id)
            new_leader = leader_of(followers)
            new_leader.apply("op", {"after": "partition"})
            # heal: old leader steps down and catches up
            registry.heal()
            wait_until(
                lambda: not leader.is_leader(),
                msg="old leader stepped down",
            )
            wait_until(
                lambda: all(len(l) == 1 for l in logs),
                msg="all logs converged",
            )
        finally:
            shutdown_all(nodes)

    def test_log_store_compaction(self):
        log = LogStore()
        for i in range(1, 11):
            log.append(LogEntry(index=i, term=1, data=i))
        log.compact_to(5, 1)
        assert log.base_index() == 5
        assert log.get(5) is None
        assert log.get(6).data == 6
        assert log.last_index() == 10
        log.truncate_from(8)
        assert log.last_index() == 7


class TestTcpTransport:
    def test_three_node_cluster_over_tcp(self):
        # raft_rpc.go RaftLayer analog: same RPCs over real sockets
        from nomad_tpu_torch.raft.transport import TcpTransport

        transports = [TcpTransport() for _ in range(3)]
        addrs = [t.addr for t in transports]
        nodes, logs = [], []
        for t in transports:
            applied = []
            logs.append(applied)
            node = RaftNode(
                node_id=t.addr,
                peers=addrs,
                transport=t,
                fsm_apply=(lambda a: lambda ty, r: a.append((ty, r)) or len(a))(applied),
                config=FAST,
            )
            nodes.append(node)
        for n in nodes:
            n.start()
        try:
            leader = leader_of(nodes, timeout=10)
            for i in range(3):
                leader.apply("op", {"i": i})
            wait_until(
                lambda: all(len(l) == 3 for l in logs),
                msg="TCP replication to all nodes",
            )
            assert logs[0] == logs[1] == logs[2]
        finally:
            shutdown_all(nodes)


class TestReplicatedServer:
    def test_job_register_replicates(self):
        servers, _ = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers)
            for _ in range(3):
                leader.node_register(mock.node())
            job = mock.job()
            resp = leader.job_register(job)
            assert resp["eval_id"]
            # every server's state store converges on the same job+allocs
            wait_until(
                lambda: all(
                    s.state.snapshot().job_by_id(job.namespace, job.id) is not None
                    for s in servers
                ),
                msg="job replicated to all servers",
            )
            wait_until(
                lambda: all(
                    len(s.state.snapshot().allocs_by_job(job.namespace, job.id)) == 10
                    for s in servers
                ),
                timeout=30,
                msg="allocs replicated to all servers",
            )
        finally:
            for s in servers:
                s.shutdown()

    def test_follower_forwards_writes(self):
        servers, _ = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers)
            follower = next(s for s in servers if s is not leader)
            node = mock.node()
            follower.node_register(node)
            wait_until(
                lambda: all(
                    s.state.snapshot().node_by_id(node.id) is not None
                    for s in servers
                ),
                msg="node visible on all servers",
            )
        finally:
            for s in servers:
                s.shutdown()

    def test_leader_failover_keeps_scheduling(self):
        # generous timeouts: under a full-suite run, other workers'
        # processes crowd the Python control plane (scheduling +
        # elections)
        servers, _ = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers, timeout=30)
            for _ in range(3):
                leader.node_register(mock.node())
            job1 = mock.job()
            leader.job_register(job1)
            wait_until(
                lambda: len(leader.state.snapshot().allocs_by_job(
                    job1.namespace, job1.id)) == 10,
                timeout=90,
                msg="first job placed",
            )
            leader.shutdown()
            rest = [s for s in servers if s is not leader]
            new_leader = wait_for_leader(rest, timeout=30)
            job2 = mock.job()
            new_leader.job_register(job2)
            wait_until(
                lambda: len(new_leader.state.snapshot().allocs_by_job(
                    job2.namespace, job2.id)) == 10,
                timeout=90,
                msg="second job placed by new leader",
            )
        finally:
            for s in servers:
                if s.raft is not None and s.raft._threads:
                    s.shutdown()

    def test_snapshot_restore_roundtrip(self):
        from nomad_tpu_torch.state.store import StateStore

        store = StateStore()
        node = mock.node()
        store.upsert_node(node)
        job = mock.job()
        store.upsert_job(job)
        data = store.to_snapshot_bytes()

        fresh = StateStore()
        fresh.restore_from_bytes(data)
        snap = fresh.snapshot()
        assert snap.node_by_id(node.id) is not None
        assert snap.job_by_id(job.namespace, job.id) is not None
        assert snap.latest_index() == store.latest_index()


def make_pipe_cluster(n, max_in_flight=8):
    """N bare RaftNodes with the pipelined-replication window sized by
    ``max_in_flight`` (1 = the synchronous path, bit-for-bit)."""
    cfg = RaftConfig(
        heartbeat_interval=0.02,
        election_timeout_min=0.06,
        election_timeout_max=0.12,
        max_in_flight=max_in_flight,
    )
    registry = TransportRegistry()
    addrs = [f"n{i}" for i in range(n)]
    nodes, logs = [], []
    for addr in addrs:
        applied = []
        logs.append(applied)
        nodes.append(RaftNode(
            node_id=addr,
            peers=addrs,
            transport=InmemTransport(addr, registry),
            fsm_apply=(lambda a: lambda t, r: a.append((t, r)) or len(a))(applied),
            config=cfg,
        ))
    for node in nodes:
        node.start()
    return nodes, logs, registry


#: one fault family per seed residue; every family crosses the
#: pipelined window's drain/fallback seams a different way
SCENARIOS = ("drops", "latency", "conflict", "term_change", "leader_kill")


def _run_seed(seed, max_in_flight, n_ops=12):
    """One randomized run: returns the converged log's op ids (in
    order) after asserting the exactly-once / identical-replica
    property. Op ids are deterministic per (seed, op, attempt), so a
    disturbance-free run's log is a pure function of the seed — the
    cross-arm bit-identity hook."""
    rng = random.Random(seed)
    scenario = SCENARIOS[seed % len(SCENARIOS)]
    nodes, logs, registry = make_pipe_cluster(3, max_in_flight)
    acked, killed = [], []
    try:
        try:
            leader = leader_of(nodes)
            disturb_at = rng.randrange(2, n_ops - 2)
            if scenario == "drops":
                faultpoints.arm(
                    {"raft.replicate.send": {"kind": "error", "p": 0.2}},
                    seed=seed)
            elif scenario == "latency":
                faultpoints.arm(
                    {"raft.replicate.send": {
                        "kind": "latency", "p": 0.5,
                        "sleep_s": 0.001 + rng.random() * 0.004}},
                    seed=seed)
            i, attempt = 0, 0
            while i < n_ops:
                if i == disturb_at and attempt == 0:
                    if scenario == "conflict":
                        f = next(n for n in nodes
                                 if n not in killed and not n.is_leader())
                        registry.partition(leader.id, f.id)
                    elif scenario == "term_change":
                        leader.step_down()
                    elif scenario == "leader_kill":
                        # mid-window: earlier applies may still be in
                        # flight in the pipelined window when it dies
                        leader.shutdown()
                        killed.append(leader)
                op_id = f"s{seed}-op{i}-a{attempt}"
                try:
                    live = [n for n in nodes if n not in killed]
                    leader = leader_of(live, timeout=5.0)
                    leader.apply("set", {"id": op_id}, timeout=5.0)
                except Exception:
                    attempt += 1
                    assert attempt <= 8, (seed, scenario, op_id)
                    continue
                acked.append(op_id)
                attempt = 0
                i += 1
        finally:
            faultpoints.reset()
            registry.heal()
        live_idx = [k for k, nd in enumerate(nodes) if nd not in killed]

        def converged():
            ls = [logs[k] for k in live_idx]
            if not all(ls[0] == other for other in ls[1:]):
                return False
            ids = [r["id"] for _, r in ls[0]]
            return all(a in ids for a in acked)

        deadline = time.time() + 10.0
        while time.time() < deadline and not converged():
            time.sleep(0.01)
        assert converged(), (seed, scenario, acked,
                             [len(logs[k]) for k in live_idx])
        ids = [r["id"] for _, r in logs[live_idx[0]]]
        # exactly-once: acked ops appear once; an unacked attempt that
        # committed after its client timed out appears at most once
        assert len(ids) == len(set(ids)), (seed, scenario)
        for a in acked:
            assert ids.count(a) == 1, (seed, scenario, a)
        return ids, acked, scenario
    finally:
        shutdown_all(n for n in nodes if n not in killed)


class TestPipelinedLogEquivalence:
    def _sweep(self, seeds):
        for seed in seeds:
            ids, acked, scenario = _run_seed(seed, max_in_flight=8)
            if scenario == "latency":
                # disturbance-free arm: the log IS the acked sequence,
                # so the synchronous arm must produce the identical
                # bytes — pipelining changed nothing observable
                assert ids == acked, (seed, ids, acked)
                sync_ids, sync_acked, _ = _run_seed(seed, max_in_flight=1)
                assert sync_ids == ids, (seed, sync_ids, ids)

    def test_property_pipelined_log_equivalent_25_seeds(self):
        self._sweep(range(25))

    @pytest.mark.slow
    def test_property_pipelined_log_equivalent_200_seeds(self):
        self._sweep(range(25, 225))

    def test_max_in_flight_1_never_arms_pipeline(self):
        """The dispatcher must route ``max_in_flight=1`` through the
        original synchronous replicator — zero pipeline batches, zero
        armed peers — so today's path stays bit-identical."""
        nodes, logs, _ = make_pipe_cluster(3, max_in_flight=1)
        try:
            leader = leader_of(nodes)
            for i in range(8):
                leader.apply("set", {"id": i})
            wait_until(lambda: all(len(l) == 8 for l in logs),
                       msg="all replicas applied")
            assert logs[0] == logs[1] == logs[2]
            g = leader.observe_gauges()
            assert g["pipeline_batches"] == 0, g
            assert g["pipeline_armed"] == 0, g
            assert g["pipeline_drains"] == 0, g
        finally:
            shutdown_all(nodes)

    def test_pipelined_path_actually_pipelines(self):
        """Sanity for the property above: at ``max_in_flight=8`` the
        window really is taken (batches counted, no drains on a clean
        wire) — otherwise the equivalence sweep proves nothing."""
        nodes, logs, _ = make_pipe_cluster(3, max_in_flight=8)
        try:
            leader = leader_of(nodes)
            for i in range(20):
                leader.apply("set", {"id": i})
            wait_until(lambda: all(len(l) == 20 for l in logs),
                       msg="all replicas applied")
            g = leader.observe_gauges()
            assert g["pipeline_batches"] > 0, g
        finally:
            shutdown_all(nodes)


class TestServerPipelinedUsageParity:
    def test_usage_rebuild_diff_empty_under_pipelined_replication(self):
        """Server-backed variant of the equivalence property: schedule
        real allocs through a pipelined cluster and require the
        incremental usage planes on EVERY replica to match a from-
        scratch rebuild bit-for-bit."""
        servers, _ = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers)
            # clusters run the pipelined window by default now
            assert leader.raft.config.max_in_flight > 1
            for _ in range(3):
                leader.node_register(mock.node())
            job = mock.job()
            leader.job_register(job)
            wait_until(
                lambda: all(
                    len(s.state.snapshot().allocs_by_job(
                        job.namespace, job.id)) == 10
                    for s in servers),
                timeout=30,
                msg="allocs replicated to all servers",
            )
            for s in servers:
                assert usage_rebuild_diff(s.state) == [], s.config.name
        finally:
            for s in servers:
                s.shutdown()


class TestLeaderLease:
    def test_lease_held_on_steady_leader_not_on_follower(self):
        nodes, _, _ = make_pipe_cluster(3)
        try:
            leader = leader_of(nodes)
            leader.apply("set", {"id": "x"})
            wait_until(lambda: leader.lease_valid(),
                       msg="lease established from append acks")
            for f in (n for n in nodes if n is not leader):
                assert not f.lease_valid()
        finally:
            shutdown_all(nodes)

    def test_deposed_leader_lease_lapses_before_new_leader_commits(self):
        """The safety argument, executed: lease window
        (election_timeout_min * lease_fraction) < election_timeout_min,
        so when the partitioned-away majority elects a successor, the
        old leader — still believing it leads — must already be
        reporting its lease invalid. A fast read there would be stale;
        the lease forbids it."""
        nodes, _, registry = make_pipe_cluster(3)
        try:
            old = leader_of(nodes)
            old.apply("set", {"id": "pre"})
            wait_until(lambda: old.lease_valid(), msg="lease held")
            followers = [n for n in nodes if n is not old]
            for f in followers:
                registry.partition(old.id, f.id)
            new = leader_of(followers, timeout=5.0)
            # the instant a successor exists, the old lease is gone
            assert not old.lease_valid()
            assert old.is_leader()      # ...though it doesn't know yet
            new.apply("set", {"id": "post"})
            assert not old.lease_valid()
        finally:
            registry.heal()
            shutdown_all(nodes)

    def test_lease_read_counters_and_expiry_event(self):
        nodes, _, _ = make_pipe_cluster(3)
        try:
            leader = leader_of(nodes)
            leader.apply("set", {"id": "x"})
            wait_until(lambda: leader.lease_valid(), msg="lease held")
            t0 = time.monotonic()
            leader.note_lease_read(True)
            g = leader.observe_gauges()
            assert g["lease_reads_fast"] == 1, g
            # fast -> barrier edge emits ONE lease_expired event
            leader.note_lease_read(False)
            leader.note_lease_read(False)
            g = leader.observe_gauges()
            assert g["lease_reads_barrier"] == 2, g
            evs = [e for e in raft_observer.events(since_mono=t0)
                   if e["kind"] == "lease_expired"
                   and e["server"] == leader.id]
            assert len(evs) == 1, evs
        finally:
            shutdown_all(nodes)

    def test_server_linearizable_read_paths(self):
        servers, _ = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers)
            wait_until(lambda: leader.raft.lease_valid(),
                       msg="leader lease held")
            leader.linearizable_read()      # fast path, no barrier
            assert leader.raft.observe_gauges()["lease_reads_fast"] >= 1
            follower = next(s for s in servers if s is not leader)
            with pytest.raises(NotLeaderError):
                follower.linearizable_read()
        finally:
            for s in servers:
                s.shutdown()


class TestBatchedApplyWakeupAudit:
    def test_one_wakeup_one_publish_stamp_per_batch(self):
        """A committed run applied as one batch must cost ONE watcher
        wakeup (carrying the batch's newest index) and ONE event-stream
        publish stamp — the spurious-wakeup counter stays flat."""
        store = StateStore()
        pubs = []

        class _RecordingBroker:
            def publish(self, events, stamp=None):
                pubs.append((list(events), stamp))

        f = NomadFSM(store, event_broker=_RecordingBroker())
        jobs = [mock.job() for _ in range(5)]
        base = store.table_index(["jobs"])
        base_held = watch_stats.snapshot()["held_watchers"]
        got = []
        th = threading.Thread(
            target=lambda: got.append(
                store.block_until(["jobs"], base, timeout=10.0)))
        th.start()
        wait_until(
            lambda: watch_stats.snapshot()["held_watchers"] > base_held,
            msg="watcher parked")
        watch_stats.reset_stats()
        results = f.apply_batch(
            [(fsm_mod.JOB_REGISTER, {"job": j}) for j in jobs])
        th.join(5.0)
        assert not th.is_alive()
        assert all(err is None for _, err in results), results
        idxs = [i for i, _ in results]
        newest = max(idxs)
        assert got == [newest], (got, newest)
        snap = watch_stats.snapshot()
        assert snap["wakeups"] == 1, snap
        assert snap["spurious_wakeups"] == 0, snap
        # one stamp for the whole batch; per-entry commit indexes ride
        # the events so consumers still see each entry's index
        assert len(pubs) == 1, [len(p[0]) for p in pubs]
        events, stamp = pubs[0]
        assert isinstance(stamp, float)
        assert sorted({e.index for e in events}) == sorted(set(idxs))
        assert max(e.index for e in events) == newest

    def test_per_entry_apply_still_publishes_per_entry(self):
        """Containment check for the audit above: the single-entry
        path keeps its one-stamp-per-apply behavior (the batch path is
        an optimization, not a semantics change)."""
        store = StateStore()
        pubs = []

        class _RecordingBroker:
            def publish(self, events, stamp=None):
                pubs.append(stamp)

        f = NomadFSM(store, event_broker=_RecordingBroker())
        for _ in range(3):
            f.apply(fsm_mod.JOB_REGISTER, {"job": mock.job()})
        assert len(pubs) == 3


def _entries(store):
    return [(e.index, e.term, e.data)
            for e in store.entries_from(store.base_index() + 1, 10_000)]


def _fill(path, n=12, term=1):
    log = DurableLogStore(path)
    for i in range(1, n + 1):
        log.append(LogEntry(index=i, term=term, data=("op", i)))
    log.sync()
    return log


def _segments(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".seg"))


class TestWalRoundtrip:
    def test_append_truncate_compact_replay_bit_identical(self, tmp_path):
        d = str(tmp_path / "wal")
        log = _fill(d, 10)
        log.truncate_from(9)                # conflict resolution
        log.append(LogEntry(index=9, term=2, data=("op", "ninth")))
        log.compact_to(4, 1)
        log.sync()
        before = (_entries(log), log.base_index(), log.last_index(),
                  log.last_term())
        log.close()

        again = DurableLogStore(d)
        assert (_entries(again), again.base_index(), again.last_index(),
                again.last_term()) == before
        assert again.replayed_entries == len(before[0])
        again.close()

    def test_torn_tail_truncates_to_clean_prefix(self, tmp_path):
        d = str(tmp_path / "wal")
        log = _fill(d, 8)
        log.close()
        seg = os.path.join(d, _segments(d)[-1])
        size = os.path.getsize(seg)
        torn0 = wal_stats.snapshot()["torn_truncations"]
        with open(seg, "r+b") as f:
            f.truncate(size - 7)            # half a frame at the tail
        again = DurableLogStore(d)
        # a clean PREFIX: entries 1..7 intact, 8 gone, nothing mangled
        assert _entries(again) == [(i, 1, ("op", i)) for i in range(1, 8)]
        assert wal_stats.snapshot()["torn_truncations"] == torn0 + 1
        # the truncated file appends cleanly again
        again.append(LogEntry(index=8, term=1, data=("op", "redo")))
        again.sync()
        again.close()
        final = DurableLogStore(d)
        assert _entries(final)[-1] == (8, 1, ("op", "redo"))
        final.close()

    def test_midfile_corruption_is_loud_never_silent(self, tmp_path):
        d = str(tmp_path / "wal")
        log = _fill(d, 8)
        log.close()
        seg = os.path.join(d, _segments(d)[-1])
        # flip one byte in the FIRST frame: valid frames follow, so
        # this is corruption, not a torn tail — recovery must refuse
        with open(seg, "r+b") as f:
            f.seek(12)
            byte = f.read(1)
            f.seek(12)
            f.write(bytes([byte[0] ^ 0x40]))
        with pytest.raises(WalCorruptionError):
            DurableLogStore(d)

    def test_sealed_segment_damage_is_loud(self, tmp_path):
        d = str(tmp_path / "wal")
        log = DurableLogStore(d, segment_max_bytes=128)
        for i in range(1, 12):
            log.append(LogEntry(index=i, term=1, data=("op", i)))
        log.sync()
        log.close()
        segs = _segments(d)
        assert len(segs) > 2
        # cut the TAIL of a SEALED (non-newest) segment: rotation
        # fsynced it whole, so a short read there is corruption
        sealed = os.path.join(d, segs[0])
        with open(sealed, "r+b") as f:
            f.truncate(os.path.getsize(sealed) - 3)
        with pytest.raises(WalCorruptionError):
            DurableLogStore(d)

    def test_rotation_and_deletion_after_compaction(self, tmp_path):
        d = str(tmp_path / "wal")
        log = DurableLogStore(d, segment_max_bytes=128)
        for i in range(1, 30):
            log.append(LogEntry(index=i, term=1, data=("op", i)))
        log.sync()
        n_before = len(_segments(d))
        assert n_before > 3
        log.compact_to(25, 1)
        # sealed segments wholly below the snapshot are gone
        assert len(_segments(d)) < n_before
        log.close()
        again = DurableLogStore(d)
        assert again.base_index() == 25
        assert _entries(again) == [(i, 1, ("op", i)) for i in range(26, 30)]
        again.close()

    def test_replay_is_index_keyed_across_deleted_segments(self, tmp_path):
        """Regression: after compaction deletes segments, the retained
        stream starts mid-log; a truncate record recorded BEFORE the
        retained compact record must still aim at the right entries
        (positional replay through the live arithmetic mis-aimed it)."""
        records = [("entry", i, 1, "command", ("op", i))
                   for i in range(40, 50)]
        records.append(("truncate", 48))
        records.append(("entry", 48, 2, "command", ("op", "new48")))
        records.append(("compact", 45, 1))
        base, term, entries = replay_records(records)
        assert (base, term) == (45, 1)
        assert [(e.index, e.term) for e in entries] == [
            (46, 1), (47, 1), (48, 2)]

    def test_torn_write_fault_fail_stops_and_recovers(self, tmp_path):
        d = str(tmp_path / "wal")
        log = _fill(d, 3)
        faultpoints.arm({"wal.frame.torn": {"kind": "error", "nth": 1}})
        with pytest.raises(faultpoints.FaultError):
            log.append(LogEntry(index=4, term=1, data=("op", 4)))
        assert log.wal_failed
        # fail-stop: nothing may be journaled after a torn frame
        with pytest.raises(WalCorruptionError):
            log.append(LogEntry(index=5, term=1, data=("op", 5)))
        with pytest.raises(WalCorruptionError):
            log.sync()
        log.close()
        faultpoints.disarm()
        # recovery truncates the half-written frame: clean 1..3 prefix
        again = DurableLogStore(d)
        assert _entries(again) == [(i, 1, ("op", i)) for i in (1, 2, 3)]
        again.close()

    def test_concurrent_appends_sync_group_coalesced(self, tmp_path):
        d = str(tmp_path / "wal")
        log = DurableLogStore(d, fsync_policy="batch")
        idx_lock = threading.Lock()
        next_idx = [0]
        errors = []

        def writer(k):
            try:
                for _ in range(20):
                    # index assignment + append are one atomic step,
                    # like the raft caller (which does both under its
                    # lock) — the journal must stay ascending; only
                    # the SYNCS race, which is the point
                    with idx_lock:
                        next_idx[0] += 1
                        i = next_idx[0]
                        log.append(LogEntry(index=i, term=1,
                                            data=("op", i)))
                    log.sync()
            except Exception as e:              # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert not errors
        log.close()
        again = DurableLogStore(d)
        assert again.last_index() == 80
        assert again.replayed_entries == 80
        again.close()

    def test_always_policy_is_durable_per_record(self, tmp_path):
        d = str(tmp_path / "wal")
        f0 = wal_stats.snapshot()["fsyncs"]
        log = DurableLogStore(d, fsync_policy="always")
        log.append(LogEntry(index=1, term=1, data=("op", 1)))
        assert wal_stats.snapshot()["fsyncs"] > f0
        log.close()
        with pytest.raises(ValueError):
            WriteAheadLog(str(tmp_path / "bad"), fsync_policy="sometimes")


class TestStableStore:
    def test_roundtrip_and_noop_fast_path(self, tmp_path):
        d = str(tmp_path)
        ss = StableStore(d)
        assert ss.load() == (0, None)
        ss.put(3, "cand-a")
        f0 = wal_stats.snapshot()["fsyncs"]
        ss.put(3, "cand-a")                 # unchanged: free
        assert wal_stats.snapshot()["fsyncs"] == f0
        assert StableStore(d).load() == (3, "cand-a")

    def test_monotone_never_regresses(self, tmp_path):
        d = str(tmp_path)
        ss = StableStore(d)
        ss.put(5, "cand-b")
        ss.put(4, "cand-a")                 # stale racer: ignored
        ss.put(5, None)                     # a vote is never un-cast
        assert StableStore(d).load() == (5, "cand-b")
        ss.put(6, None)                     # a NEW term clears the vote
        assert StableStore(d).load() == (6, None)

    def test_corrupt_stable_is_loud(self, tmp_path):
        d = str(tmp_path)
        StableStore(d).put(7, "cand-c")
        with open(os.path.join(d, "stable"), "r+b") as f:
            f.seek(9)
            f.write(b"\xff")
        with pytest.raises(WalCorruptionError):
            StableStore(d).load()


class TestSnapshotStore:
    def test_keep_last_two_and_newest_wins(self, tmp_path):
        d = str(tmp_path)
        sn = SnapshotStore(d)
        for idx, data in ((10, b"ten"), (20, b"twenty"), (30, b"thirty")):
            sn.save(idx, 1, data)
        files = [f for f in os.listdir(d) if f.endswith(".snap")]
        assert len(files) == 2              # keep-last-2
        assert sn.load_newest() == (30, 1, b"thirty")

    def test_corrupt_newest_falls_back_to_older(self, tmp_path):
        d = str(tmp_path)
        sn = SnapshotStore(d)
        sn.save(10, 1, b"older")
        newest = sn.save(20, 2, b"newer")
        size = os.path.getsize(newest)
        with open(newest, "r+b") as f:
            f.seek(size - 1)
            last = f.read(1)
            f.seek(size - 1)
            f.write(bytes([last[0] ^ 0xFF]))
        assert sn.load_newest() == (10, 1, b"older")

    def test_kill_mid_write_leaves_only_ignored_tmp(self, tmp_path):
        d = str(tmp_path)
        sn = SnapshotStore(d)
        sn.save(10, 1, b"good")
        faultpoints.arm(
            {"wal.snapshot.write": {"kind": "error", "nth": 1}})
        with pytest.raises(faultpoints.FaultError):
            sn.save(20, 1, b"never-lands")
        faultpoints.disarm()
        # the failed write never became a .snap: recovery sees 'good'
        assert sn.load_newest() == (10, 1, b"good")


class TestTornTailFuzzMini:
    def test_forty_seeds_never_silently_diverge(self):
        """Tier-1 slice of the seeded torn-tail fuzz: every mutated
        recovery is a clean prefix or a loud WalCorruptionError — zero
        silent divergences."""
        r = run_torn_tail_fuzz(seeds=40, entries=60)
        assert r["silent_divergences"] == 0, r
        assert r["clean_prefix"] + r["loud_corruption"] == 40
        assert r["clean_prefix"] > 0 and r["loud_corruption"] > 0


def run_torn_tail_fuzz(seeds: int = 200, entries: int = 120,
                       segment_bytes: int = 2048) -> dict:
    """Seeded torn-tail fuzz over a recorded WAL, on the port's
    ``raft/wal.py`` (``bench/trace_report.run_torn_tail_fuzz`` holds the
    JAX package's): random tail truncations and byte flips, asserting
    that recovery either yields a log equal to SOME clean prefix of the
    recorded record stream, or raises WalCorruptionError. A recovery that
    succeeds with anything else is a silent divergence."""
    base = tempfile.mkdtemp(prefix="nomad-torch-tornfuzz-")
    ref_dir = os.path.join(base, "ref")
    try:
        # a reference WAL with appends, a conflict truncation and a
        # compaction, spanning several segments
        ref = DurableLogStore(ref_dir, fsync_policy="batch",
                              segment_max_bytes=segment_bytes)
        index = 0
        for i in range(entries):
            index += 1
            e = LogEntry(index=index, term=1 + i // 50, kind="command",
                         data=("op", {"i": i, "pad": "x" * (i % 17)}))
            ref.append(e)
            if i == entries // 2:
                index -= 2
                ref.truncate_from(index + 1)
            if i == (2 * entries) // 3:
                ref.compact_to(index - 20, e.term)
        ref.sync()
        ref.close()

        # every valid prefix of the record stream on disk, through the
        # index-keyed replay the recovery path uses
        replay_wal = WriteAheadLog(ref_dir)
        disk_records = replay_wal.replay()
        replay_wal.close()

        def fingerprint(base_index, base_term, entry_list):
            return (base_index, base_term,
                    tuple((e.index, e.term, e.kind, repr(e.data))
                          for e in entry_list))

        valid_prefixes = {
            fingerprint(*replay_records(disk_records[:k]))
            for k in range(len(disk_records) + 1)}
        outcomes = {"clean_prefix": 0, "loud_corruption": 0,
                    "silent_divergences": 0}
        diverged: list = []
        for seed in range(seeds):
            rng = random.Random(seed)
            case = os.path.join(base, f"case-{seed}")
            shutil.copytree(ref_dir, case)
            segs = sorted(f for f in os.listdir(case)
                          if f.endswith(".seg"))
            mode = rng.choice(("cut", "flip", "cutflip"))
            if mode in ("cut", "cutflip"):
                tail = os.path.join(case, segs[-1])
                size = os.path.getsize(tail)
                with open(tail, "r+b") as f:
                    f.truncate(max(size - rng.randrange(1, 61), 0))
            if mode in ("flip", "cutflip"):
                target = os.path.join(case, rng.choice(segs))
                size = os.path.getsize(target)
                if size:
                    with open(target, "r+b") as f:
                        for _ in range(rng.randrange(1, 5)):
                            pos = rng.randrange(size)
                            f.seek(pos)
                            byte = f.read(1)
                            f.seek(pos)
                            f.write(bytes([byte[0] ^ (1 << rng.randrange(8))]))
            try:
                recovered = DurableLogStore(case)
            except WalCorruptionError:
                outcomes["loud_corruption"] += 1
            else:
                recovered.close()
                got = fingerprint(recovered.base_index(),
                                  recovered._base_term, recovered._entries)
                if got in valid_prefixes:
                    outcomes["clean_prefix"] += 1
                else:
                    outcomes["silent_divergences"] += 1
                    diverged.append((seed, mode))
            shutil.rmtree(case, ignore_errors=True)
        return {"seeds": seeds, "diverged_cases": diverged[:5], **outcomes}
    finally:
        shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------
# What the port adds: reads through the port's ReadPlane on a cluster.
# ---------------------------------------------------------------------------

class TestReadPlaneOnCluster:
    def test_linearizable_read_on_leader_and_no_leader_on_follower(
            self, monkeypatch):
        servers, _ = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers, timeout=15.0)
            leader.node_register(mock.node())
            wait_until(lambda: leader.raft.lease_valid(), timeout=10.0,
                       msg="leader lease held")
            g0 = leader.raft.observe_gauges()
            ctx = leader.readplane.resolve(MODE_LINEARIZABLE)
            assert ctx.mode == MODE_LINEARIZABLE
            assert ctx.served_by == "leader"
            assert ctx.index == leader.state.latest_index()
            g1 = leader.raft.observe_gauges()
            assert g1["lease_reads_fast"] == g0["lease_reads_fast"] + 1
            # a lapsed lease demotes the read to the quorum barrier: a
            # no-op entry committed through the followers
            monkeypatch.setattr(leader.raft, "lease_valid", lambda: False)
            commit0 = leader.raft.commit_index
            ctx = leader.readplane.resolve(MODE_LINEARIZABLE)
            g2 = leader.raft.observe_gauges()
            assert g2["lease_reads_barrier"] \
                == g1["lease_reads_barrier"] + 1
            assert leader.raft.commit_index > commit0
            assert ctx.served_by == "leader"
            follower = next(s for s in servers if s is not leader)
            with pytest.raises(NoLeaderError) as err:
                follower.readplane.resolve(MODE_LINEARIZABLE)
            assert err.value.known_leader == leader.raft.id
        finally:
            for s in servers:
                s.shutdown()

    def test_follower_default_read_is_fenced_to_the_leader(self):
        servers, _ = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers, timeout=15.0)
            node = mock.node()
            leader.node_register(node)
            follower = next(s for s in servers if s is not leader)
            # the fence covers what the leader held when the read began;
            # the leader goes on committing entries for a moment after
            # the register, and those may land after the fence
            fence = leader.state.latest_index()
            ctx = follower.readplane.resolve(MODE_DEFAULT)
            assert ctx.served_by == "follower"
            assert ctx.index >= fence
            assert follower.state.snapshot().node_by_id(node.id) is not None
        finally:
            for s in servers:
                s.shutdown()


class TestReferenceDefects:
    """Behaviors of the reference that the port repairs (ROADMAP C), each
    on both packages: the port's code, then the reference's."""

    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_an_eval_enqueued_twice_is_handed_out_once(self, package):
        """An eval enqueued while a copy of it is ready, or pending behind
        its job's outstanding eval: the port keeps one copy (Nomad's
        broker tracks every eval it holds); the reference queues the
        second, and a batch hands the eval out twice."""
        if package == "port":
            from nomad_tpu_torch.server.eval_broker import EvalBroker
        else:
            from nomad_tpu.server.eval_broker import EvalBroker
        broker = EvalBroker(batch_fill_window_s=0.0)
        broker.set_enabled(True)
        try:
            job = mock.job()
            first, second = (mock.eval(job_id=job.id, type=job.type)
                             for _ in range(2))
            for ev in (first, first, second, second):
                broker.enqueue(ev)
            batch = broker.dequeue_batch([job.type], 8, timeout=0)
            assert [ev.id for ev, _ in batch] == (
                [first.id] if package == "port" else [first.id] * 2)
            broker.ack(first.id, batch[-1][1])
            batch = broker.dequeue_batch([job.type], 8, timeout=0)
            assert [ev.id for ev, _ in batch] == [second.id]
            broker.ack(second.id, batch[0][1])
            want = 0 if package == "port" else 1
            assert broker.stats()["total_ready"] == want
        finally:
            broker.set_enabled(False)

    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_a_registration_between_broker_enable_and_restore(
            self, package):
        """``establish_leadership`` enables the broker, then restores the
        store's pending evals. A registration the FSM applies in between
        enqueues its eval and the restore finds it again: the port's
        broker holds it once, the reference's twice."""
        if package == "port":
            srv = Server(cpu_config())
        else:
            from nomad_tpu.server.server import Server as RefServer
            from nomad_tpu.server.server import ServerConfig as RefConfig

            srv = RefServer(RefConfig(num_workers=1, heartbeat_ttl=60.0))
        try:
            srv.eval_broker.set_enabled(True)
            job = mock.job()
            srv.job_register(job)
            srv._restore_evals()
            want = 1 if package == "port" else 2
            assert srv.eval_broker.stats()["total_ready"] == want
        finally:
            srv.eval_broker.set_enabled(False)
            srv.planner.close()

    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_commit_with_a_voter_down_when_the_leaders_fsync_trails(
            self, package, tmp_path):
        """Three durable nodes, one down; the live follower acks each
        entry before the leader's own fsync ends. The port counts the
        leader's match after its sync toward the quorum and commits; the
        reference counts it only in a single-voter cluster, so its entry
        waits for an append that never comes."""
        if package == "port":
            node_cls, transport_cls, registry = (
                RaftNode, InmemTransport, TransportRegistry())
        else:
            from nomad_tpu.raft import node as ref_node
            from nomad_tpu.raft import transport as ref_transport

            node_cls, transport_cls, registry = (
                ref_node.RaftNode, ref_transport.InmemTransport,
                ref_transport.TransportRegistry())
        addrs = ["n0", "n1", "n2"]
        nodes = [node_cls(
            node_id=a, peers=addrs, transport=transport_cls(a, registry),
            fsm_apply=lambda t, r: 0, config=FAST,
            data_dir=str(tmp_path / a)) for a in addrs]
        for n in nodes:
            n.start()
        try:
            leader = leader_of(nodes)
            down = next(n for n in nodes if n is not leader)
            down.shutdown()
            sync = leader.log.sync

            def trailing_sync():
                time.sleep(0.2)
                return sync()

            leader.log.sync = trailing_sync
            if package == "port":
                for i in range(3):
                    leader.apply("op", {"i": i}, timeout=5.0)
                assert leader.commit_index == leader.log.last_index()
            else:
                with pytest.raises(TimeoutError):
                    leader.apply("op", {"i": 0}, timeout=1.0)
                assert leader.commit_index < leader.log.last_index()
        finally:
            shutdown_all(n for n in nodes if n._threads)

    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_a_followers_worker_and_its_disabled_broker(self, package):
        """A follower's broker is disabled and returns at once. The
        port's follower keeps its workers paused and never asks it; the
        reference's worker asks again without waiting, over and over."""
        if package == "port":
            servers, _ = make_cluster(3, cpu_config())
        else:
            from nomad_tpu.server import testing as ref_testing

            servers, _ = ref_testing.make_cluster(3)
        try:
            leader = wait_for_leader(servers, timeout=15.0)
            follower = next(s for s in servers if s is not leader)
            calls = []
            dequeue = follower.eval_broker.dequeue_batch

            def counted(*args, **kwargs):
                calls.append(1)
                return dequeue(*args, **kwargs)

            follower.eval_broker.dequeue_batch = counted
            time.sleep(0.3)
            if package == "port":
                assert not calls
            else:
                assert len(calls) > 50
        finally:
            for s in servers:
                s.shutdown()

    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_an_eval_blocked_by_rejected_plans_is_released(
            self, package, monkeypatch):
        """An eval blocked after its plans were rejected too often
        (triggered by max-plan-attempts). The port's leader releases it
        to the broker on its failed-eval unblock loop (Nomad's
        periodicUnblockFailedEvals; the interval patched to 50 ms); the
        reference's leader has no such loop, and the eval stays
        blocked."""
        if package == "port":
            from nomad_tpu_torch.server import server as server_mod

            monkeypatch.setattr(server_mod, "FAILED_EVAL_UNBLOCK_INTERVAL",
                                0.05)
            srv = Server(ServerConfig(num_workers=0, heartbeat_ttl=60.0,
                                      device="cpu"))
            ev = mock.eval()
        else:
            from nomad_tpu import mock as ref_mock
            from nomad_tpu.server.server import Server as RefServer
            from nomad_tpu.server.server import ServerConfig as RefConfig

            srv = RefServer(RefConfig(num_workers=0, heartbeat_ttl=60.0))
            ev = ref_mock.eval()
        srv.start()
        try:
            ev.status = "blocked"
            ev.triggered_by = "max-plan-attempts"
            # the leader's own core GC evals wait in the broker too
            ready = srv.eval_broker.stats()["total_ready"]
            srv.blocked_evals.block(ev)
            assert srv.blocked_evals.stats()["total_blocked"] == 1
            deadline = time.monotonic() + 0.5
            while time.monotonic() < deadline and \
                    srv.blocked_evals.stats()["total_blocked"]:
                time.sleep(0.01)
            if package == "port":
                assert srv.blocked_evals.stats()["total_blocked"] == 0
                assert srv.eval_broker.stats()["total_ready"] == ready + 1
                assert srv.failed_evals_unblocked == 1
            else:
                assert srv.blocked_evals.stats()["total_blocked"] == 1
                assert srv.eval_broker.stats()["total_ready"] == ready
        finally:
            srv.shutdown()

    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_a_request_vote_while_the_node_recovers(self, package):
        """A RequestVote that reaches a node whose handler is registered
        but whose state is not built yet (here: at once, from inside
        ``set_handler``). The port's node answers not granted; the
        reference's handler raises AttributeError, which in a live
        cluster ends the candidate's vote thread (``_request_vote_from``
        catches only ConnectionError)."""
        if package == "port":
            node_cls, transport_cls, registry = (
                RaftNode, InmemTransport, TransportRegistry())
        else:
            from nomad_tpu.raft import node as ref_node
            from nomad_tpu.raft import transport as ref_transport

            node_cls, transport_cls, registry = (
                ref_node.RaftNode, ref_transport.InmemTransport,
                ref_transport.TransportRegistry())
        candidate = transport_cls("n1", registry)
        vote = {"term": 1, "candidate": "n1", "last_log_index": 0,
                "last_log_term": 0}
        replies = []

        class EagerTransport(transport_cls):
            def set_handler(self, handler):
                super().set_handler(handler)
                try:
                    replies.append(candidate.send("n0", "request_vote",
                                                  dict(vote)))
                except Exception as e:          # noqa: BLE001
                    replies.append(e)

        node_cls(node_id="n0", peers=["n0", "n1"],
                 transport=EagerTransport("n0", registry),
                 fsm_apply=lambda t, r: 0, config=FAST)
        if package == "port":
            assert replies == [{"term": 0, "granted": False}]
            # once built, the node votes
            assert candidate.send("n0", "request_vote", dict(vote)) == {
                "term": 1, "granted": True}
        else:
            assert isinstance(replies[0], AttributeError)

    @pytest.mark.parametrize("package", ["port", "jax"])
    def test_node_evaluate_and_purge_with_allocations(self, package):
        """``Node.Evaluate`` and ``Node.Deregister`` (HTTP evaluate and
        purge) for a node with an allocation. The port's endpoints pass
        the node's index to ``_create_node_evals``, which applies the
        evals, and return its ids: one eval for the alloc's job each
        time, and the purge removes the node. The reference's pass a
        snapshot and apply the ids again as evals: AttributeError."""
        if package == "port":
            from nomad_tpu_torch.server import endpoints

            srv, m = Server(cpu_config()), mock
        else:
            from nomad_tpu import mock as m
            from nomad_tpu.server import endpoints
            from nomad_tpu.server.server import Server as RefServer
            from nomad_tpu.server.server import ServerConfig as RefConfig

            srv = RefServer(RefConfig(num_workers=1, heartbeat_ttl=60.0))
        try:
            node = m.node()
            srv.state.upsert_node(node)
            alloc = m.alloc(node_id=node.id)
            srv.state.upsert_job(alloc.job)
            srv.state.upsert_allocs([alloc])
            if package == "jax":
                with pytest.raises(AttributeError, match="modify_index"):
                    endpoints.node_evaluate(srv, node.id)
                with pytest.raises(AttributeError, match="'id'"):
                    endpoints.node_deregister(srv, node.id)
                return
            for call in (endpoints.node_evaluate, endpoints.node_deregister):
                res = call(srv, node.id)
                snap = srv.state.snapshot()
                evals = [snap.eval_by_id(i) for i in res["eval_ids"]]
                assert [e.job_id for e in evals] == [alloc.job_id]
                assert evals[0].node_id == node.id
                assert res["index"] >= evals[0].modify_index
            assert srv.state.snapshot().node_by_id(node.id) is None
        finally:
            srv.planner.close()
