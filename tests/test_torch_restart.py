"""The port's kill/restart recovery against ``tests/test_restart.py`` (CPU).

Every scenario of the JAX package's file runs on the port's modules with
``device="cpu"``: the pinned mini restart smoke, raft hard-state safety
across restarts, the event stream's resume across a restart and the
heartbeat-expired node re-registering into a restarted cluster. Then
what the port adds, each on three-server durable clusters:

- the twin burst: a cluster of each package, fed the same nodes and the
  same serial burst of evaluations, ends with the same placements by
  alloc name and node, and the six stores agree;
- kill and restart, on both packages: the leader is killed mid-burst,
  the burst converges on the survivors and the killed server recovers
  from its data dir. The kill's timing sets the order, so this is held
  to invariants: every job placed exactly once, the three stores equal,
  usage planes equal to a rebuild;
- InstallSnapshot and re-election: a server that led, lost leadership,
  took an InstallSnapshot and leads again places on resident planes
  equal to a fresh upload.

The JAX clusters here run with the port's two repairs of the reference
patched into the JAX classes (``jax_with_port_repairs``): a follower's
worker waits paused until its server leads, and the leader's own fsync
counts toward the commit. Unrepaired, the JAX followers' workers spin on
their disabled brokers and slow every thread of the process, and with a
voter down the JAX commit stalls until the next entry (ROADMAP C;
``tests/test_torch_raft.py::TestReferenceDefects`` shows both on the
unpatched reference). The comparison is then about placements and
recovery, not those two defects. Every wait has a deadline, and every
server is shut down in a ``finally``.
"""

import threading
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.raft import node as ref_node
from nomad_tpu.server import core_sched as ref_core_sched
from nomad_tpu.server import fsm as ref_fsm
from nomad_tpu.server import server as ref_server
from nomad_tpu.server import testing as ref_testing
from nomad_tpu.server.server import ServerConfig as RefConfig
from nomad_tpu.state.usage import usage_rebuild_diff as ref_rebuild_diff
from nomad_tpu_torch import mock
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.raft.node import RaftConfig, RaftNode
from nomad_tpu_torch.raft.transport import InmemTransport, TransportRegistry
from nomad_tpu_torch.server import testing as port_testing
from nomad_tpu_torch.server.server import ServerConfig
from nomad_tpu_torch.server.testing import (
    hard_kill,
    make_cluster,
    restart_server,
    wait_for_leader,
)
from nomad_tpu_torch.state.usage import usage_rebuild_diff
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.tensors.device_state import default_device_state
from nomad_tpu_torch.utils import faultpoints


@pytest.fixture(autouse=True)
def _clean_plane():
    faultpoints.reset()
    yield
    faultpoints.reset()


def _wait(fn, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def _live_allocs(server, jobs):
    snap = server.state.snapshot()
    return [a for j in jobs
            for a in snap.allocs_by_job(j.namespace, j.id)
            if not a.terminal_status()]


def _one_server(data_dir, **cfg_overrides):
    cfg = dict(num_workers=1, worker_batch_size=4, heartbeat_ttl=60.0,
               data_dir=data_dir, device="cpu")
    cfg.update(cfg_overrides)
    servers, registry = make_cluster(1, ServerConfig(**cfg),
                                     data_dirs=[data_dir])
    return servers[0], registry


class TestMiniRestartSmoke:
    def test_commit_kill_restart_bit_identical(self, tmp_path):
        """The tier-1 pinned restart smoke: a
        single durable server commits N evals, the node object is
        hard-dropped (in-memory state discarded wholesale), and a
        fresh server restarted from the data dir must converge to
        bit-identical usage planes with every eval terminal and every
        acked placement intact."""
        d = str(tmp_path / "srv")
        server, registry = _one_server(d)
        s2 = None
        try:
            wait_for_leader([server], timeout=15.0)
            for _ in range(6):
                server.node_register(mock.node())
            jobs = []
            for _ in range(4):
                j = mock.simple_job()
                j.task_groups[0].count = 2
                server.job_register(j)      # returning = acked
                jobs.append(j)
            _wait(lambda: len(_live_allocs(server, jobs)) == 8,
                  timeout=60.0, msg="burst placed")
            idx0 = server.state.latest_index()

            hard_kill(server)
            s2 = restart_server(server, registry)
            wait_for_leader([s2], timeout=15.0)
            _wait(lambda: s2.state.latest_index() >= idx0,
                  timeout=30.0, msg="recovery caught up")
            assert s2.raft.replayed_entries > 0
            # acked placements intact, exactly once
            live = _live_allocs(s2, jobs)
            assert len(live) == 8
            for j in jobs:
                mine = [a for a in live if a.job_id == j.id]
                assert len({a.name for a in mine}) == len(mine) == 2
            # usage planes bit-identical to a from-scratch rebuild
            assert usage_rebuild_diff(s2.state) == []

            def terminal():
                snap = s2.state.snapshot()
                if any(e.status == consts.EVAL_STATUS_PENDING
                       for e in snap.evals_iter()):
                    return False
                b = s2.eval_broker.stats()
                return b["total_ready"] == 0 and b["total_unacked"] == 0

            _wait(terminal, timeout=30.0, msg="evals terminal")
        finally:
            for s in (server, s2):
                if s is not None:
                    try:
                        s.shutdown()
                    except Exception:           # noqa: BLE001
                        pass


class TestHardStateDurability:
    FAST = RaftConfig(heartbeat_interval=0.02,
                      election_timeout_min=0.06,
                      election_timeout_max=0.12)

    def _bare_node(self, d, registry, peers=("n0", "peer-a", "peer-b")):
        node = RaftNode(
            node_id="n0", peers=list(peers),
            transport=InmemTransport("n0", registry),
            fsm_apply=lambda t, r: 0,
            config=self.FAST, data_dir=d,
        )
        return node

    def test_vote_survives_restart_no_double_vote(self, tmp_path):
        """The raft SAFETY half of the tentpole: a node that granted
        its term-5 vote to candidate A, crashed, and restarted must
        refuse candidate B in term 5 (the seed's in-memory term/vote
        allowed the double vote)."""
        d = str(tmp_path / "raft")
        registry = TransportRegistry()
        node = self._bare_node(d, registry)
        req = {"term": 5, "candidate": "peer-a",
               "last_log_index": 0, "last_log_term": 0}
        resp = node._on_request_vote(dict(req))
        assert resp["granted"]
        # crash: drop the object, no graceful anything
        node.transport.close()

        again = self._bare_node(d, registry)
        assert again.current_term == 5
        assert again.voted_for == "peer-a"
        steal = {"term": 5, "candidate": "peer-b",
                 "last_log_index": 99, "last_log_term": 5}
        assert not again._on_request_vote(steal)["granted"]
        # the same candidate may re-ask (lost response retry)
        assert again._on_request_vote(dict(req))["granted"]
        again.transport.close()

    def test_fallback_snapshot_behind_base_refuses_to_boot(self, tmp_path):
        """Keep-last-2 fallback meets a compacted log: when the newest
        snapshot fails its CRC and the older fallback sits BELOW the
        WAL's compacted base, the span in between is unreconstructable
        — recovery must refuse loudly, never boot an FSM silently
        missing committed state."""
        import os

        from nomad_tpu_torch.raft.wal import (
            DurableLogStore,
            SnapshotStore,
            WalCorruptionError,
        )
        from nomad_tpu_torch.raft.log import LogEntry

        d = str(tmp_path / "raft")
        os.makedirs(d)
        sn = SnapshotStore(d)
        sn.save(5, 1, b"older-fallback")
        newest = sn.save(20, 1, b"newest")
        log = DurableLogStore(os.path.join(d, "wal"))
        for i in range(1, 26):
            log.append(LogEntry(index=i, term=1, data=("op", i)))
        log.compact_to(20, 1)
        log.close()
        # bit-rot the newest snapshot: load falls back to index 5 < 20
        size = os.path.getsize(newest)
        with open(newest, "r+b") as f:
            f.seek(size - 1)
            last = f.read(1)
            f.seek(size - 1)
            f.write(bytes([last[0] ^ 0xFF]))
        registry = TransportRegistry()
        with pytest.raises(WalCorruptionError):
            RaftNode(
                node_id="n0", peers=["n0"],
                transport=InmemTransport("n0", registry),
                fsm_apply=lambda t, r: 0,
                restore_fn=lambda b: None,
                config=self.FAST, data_dir=d,
            )

    def test_failed_wal_demotes_leader_and_fails_over(self, tmp_path):
        """Fail-stop demotion: a leader whose WAL dies (torn write /
        IO error) must stop leading — its heartbeats would otherwise
        suppress elections forever while every write fails — and a
        healthy peer must take over (the reference's panic-and-
        failover, in-process)."""
        registry = TransportRegistry()
        addrs = ["d0", "d1", "d2"]
        nodes = []
        for addr in addrs:
            nodes.append(RaftNode(
                node_id=addr, peers=addrs,
                transport=InmemTransport(addr, registry),
                fsm_apply=lambda t, r: 0,
                config=self.FAST,
                data_dir=str(tmp_path / addr),
            ))
        for n in nodes:
            n.start()
        try:
            _wait(lambda: sum(n.is_leader() for n in nodes) == 1,
                  timeout=10.0, msg="initial leader")
            leader = next(n for n in nodes if n.is_leader())
            leader.apply("op", {"i": 0})
            # tear the LEADER's next journaled frame: WAL fail-stops
            faultpoints.arm(
                {"wal.frame.torn": {"kind": "error", "nth": 1}})
            with pytest.raises(faultpoints.FaultError):
                leader.apply("op", {"i": 1})
            faultpoints.disarm()
            assert leader.log.wal_failed
            _wait(lambda: not leader.is_leader(), timeout=10.0,
                  msg="failed-WAL leader demoted")
            _wait(lambda: any(n.is_leader() for n in nodes
                              if n is not leader),
                  timeout=10.0, msg="healthy peer took over")
            new_leader = next(n for n in nodes
                              if n is not leader and n.is_leader())
            assert new_leader.apply("op", {"i": 2}) is not None
            # the dead-disk node never reclaims leadership
            time.sleep(0.5)
            assert not leader.is_leader()
        finally:
            for n in nodes:
                n.shutdown()

    def test_term_adoption_durable_before_response(self, tmp_path):
        """AppendEntries carrying a newer term persists it before the
        ack: a restart must come back in the adopted term, not behind
        it."""
        d = str(tmp_path / "raft")
        registry = TransportRegistry()
        node = self._bare_node(d, registry)
        resp = node._on_append_entries({
            "term": 9, "leader": "peer-a", "prev_log_index": 0,
            "prev_log_term": 0, "entries": [], "leader_commit": 0,
        })
        assert resp["success"]
        node.transport.close()
        again = self._bare_node(d, registry)
        assert again.current_term == 9
        again.transport.close()


class TestStreamResumeAcrossRestart:
    def test_resume_above_boot_index_gap_free_no_duplicates(self, tmp_path):
        """A client holding ``?index=`` across a
        full server restart. With the whole history in the WAL, replay
        republishes every event with its original index — the resume
        delivers exactly the events past the client's index, no silent
        gap, no replayed duplicate."""
        d = str(tmp_path / "srv")
        server, registry = _one_server(d)
        s2 = None
        try:
            wait_for_leader([server], timeout=15.0)
            sub = server.event_broker.subscribe()
            for _ in range(3):
                server.node_register(mock.node())
            jobs = [mock.simple_job() for _ in range(2)]
            for j in jobs:
                j.task_groups[0].count = 1
                server.job_register(j)
            _wait(lambda: len(_live_allocs(server, jobs)) == 2,
                  timeout=60.0, msg="placed")
            seen = [e for e in sub.next_events(timeout=2.0,
                                               max_events=4096)]
            assert seen
            last_index = max(e.index for e in seen)
            seen_keys = {(e.index, e.topic, e.type, e.key) for e in seen}
            sub.close()

            hard_kill(server)
            s2 = restart_server(server, registry)
            wait_for_leader([s2], timeout=15.0)
            _wait(lambda: s2.state.latest_index() >= last_index,
                  timeout=30.0, msg="replay caught up")
            # register one more node so there is post-restart traffic
            post = mock.node()
            s2.node_register(post)
            resumed = s2.event_broker.subscribe(from_index=last_index)
            got = resumed.next_events(timeout=3.0, max_events=4096)
            from nomad_tpu_torch.server.stream import TOPIC_LOST

            # everything the client already saw stays unseen (no
            # replayed duplicates) ...
            dupes = [e for e in got
                     if (e.index, e.topic, e.type, e.key) in seen_keys]
            assert not dupes, dupes[:3]
            # ... and the new event arrives without a loss marker
            assert any(e.key == post.id for e in got
                       if e.topic != TOPIC_LOST)
            assert not any(e.topic == TOPIC_LOST for e in got)
            resumed.close()
        finally:
            for s in (server, s2):
                if s is not None:
                    try:
                        s.shutdown()
                    except Exception:           # noqa: BLE001
                        pass

    def test_resume_below_boot_index_gets_explicit_lost_marker(
            self, tmp_path):
        """A snapshot compacts history the fresh ring can never
        replay: a client resuming below the boot index must get the
        explicit unknown-size LostEvents marker with a resume point —
        never a silent gap (the fresh-ring trimmed-history floor)."""
        d = str(tmp_path / "srv")
        server, registry = _one_server(d)
        s2 = None
        try:
            wait_for_leader([server], timeout=15.0)
            for _ in range(3):
                server.node_register(mock.node())
            job = mock.simple_job()
            job.task_groups[0].count = 1
            server.job_register(job)
            _wait(lambda: len(_live_allocs(server, [job])) == 1,
                  timeout=60.0, msg="placed")
            early_index = 1                 # a long-gone client cursor
            server.raft.force_snapshot()    # history compacted to disk

            hard_kill(server)
            s2 = restart_server(server, registry)
            wait_for_leader([s2], timeout=15.0)
            assert s2.raft.recovered_snapshot_index > early_index
            resumed = s2.event_broker.subscribe(from_index=early_index)
            s2.node_register(mock.node())   # wake the stream
            got = resumed.next_events(timeout=3.0, max_events=4096)
            from nomad_tpu_torch.server.stream import TOPIC_LOST

            assert got and got[0].topic == TOPIC_LOST
            assert got[0].payload["LostEvents"] == -1
            assert got[0].payload["ResumeIndex"] >= 0
            resumed.close()
        finally:
            for s in (server, s2):
                if s is not None:
                    try:
                        s.shutdown()
                    except Exception:           # noqa: BLE001
                        pass


class TestExpiredNodeReregisterAcrossRestart:
    def test_expiry_reregister_reconcile_drain_preserved(self, tmp_path):
        """A node heartbeat-expires while its
        server cluster rides a leader kill→restart (step_down +
        restart interplay), then re-registers under the SAME id with a
        fresh struct. The drain-derived state (ineligibility, drain
        strategy) must survive the re-registration and the job must
        end exactly-once placed — no duplicate live allocs, nothing
        resurrected on the victim."""
        dirs = [str(tmp_path / f"srv-{i}") for i in range(3)]
        servers, registry = make_cluster(3, ServerConfig(
            num_workers=1, worker_batch_size=2, heartbeat_ttl=1.5,
            nack_timeout=1.5, data_dir="", device="cpu"), data_dirs=dirs)
        stop = threading.Event()
        try:
            wait_for_leader(servers, timeout=15.0)

            def cur_leader():
                for s in servers:
                    if s.raft.is_leader() and s.is_leader():
                        return s
                return None

            def with_leader(fn, timeout=20.0):
                deadline = time.time() + timeout
                last = None
                while time.time() < deadline:
                    s = cur_leader()
                    if s is not None:
                        try:
                            return fn(s)
                        except Exception as e:  # noqa: BLE001
                            last = e
                    time.sleep(0.05)
                raise AssertionError(f"no leader took the call: {last!r}")

            worker_node = mock.node()
            victim = mock.node()
            with_leader(lambda s: s.node_register(worker_node))
            with_leader(lambda s: s.node_register(victim))

            def keep_worker_alive():
                while not stop.is_set():
                    s = cur_leader()
                    if s is not None:
                        try:
                            s.node_heartbeat(worker_node.id, "ready")
                        except Exception:       # noqa: BLE001
                            pass
                    time.sleep(0.2)

            hb = threading.Thread(target=keep_worker_alive, daemon=True)
            hb.start()

            job = mock.simple_job()
            job.task_groups[0].count = 2
            with_leader(lambda s: s.job_register(job))
            _wait(lambda: len(_live_allocs(
                cur_leader() or servers[0], [job])) == 2,
                timeout=60.0, msg="job placed")

            # drain the victim: allocs migrate off; completion leaves
            # it ineligible (drainer semantics)
            with_leader(lambda s: s.node_update_drain(
                victim.id, True, None))
            _wait(lambda: all(
                a.node_id != victim.id for a in _live_allocs(
                    cur_leader() or servers[0], [job])),
                timeout=60.0, msg="victim drained")

            # kill the leader (deposed mid-flight) and restart it; the
            # VICTIM never heartbeats, so its TTL expires on whichever
            # leader owns the timers during the transition
            leader = cur_leader()
            idx = servers.index(leader)
            hard_kill(leader)
            fresh = restart_server(leader, registry)
            servers[idx] = fresh
            _wait(lambda: cur_leader() is not None, timeout=30.0,
                  msg="re-elected")
            _wait(lambda: (cur_leader() or servers[0]).state.snapshot()
                  .node_by_id(victim.id).status == consts.NODE_STATUS_DOWN,
                  timeout=30.0, msg="victim expired down")

            # the client restarts and re-registers: SAME id, fresh
            # struct (no drain fields — clients never set those)
            reborn = mock.node(id=victim.id)
            with_leader(lambda s, n=reborn: s.node_register(n))

            def settled():
                s = cur_leader()
                if s is None:
                    return False
                snap = s.state.snapshot()
                row = snap.node_by_id(victim.id)
                if row is None or row.status != consts.NODE_STATUS_READY:
                    return False
                live = _live_allocs(s, [job])
                names = [a.name for a in live]
                return (len(live) == 2 and len(set(names)) == 2
                        and all(a.node_id != victim.id for a in live))

            _wait(settled, timeout=60.0,
                  msg="reconciled exactly-once off the drained victim")
            row = (cur_leader() or servers[0]).state.snapshot() \
                .node_by_id(victim.id)
            # operator intent survived BOTH the server restart and the
            # client re-registration
            assert row.scheduling_eligibility == \
                consts.NODE_SCHEDULING_INELIGIBLE
        finally:
            stop.set()
            for s in servers:
                try:
                    s.shutdown()
                except Exception:               # noqa: BLE001
                    pass


# ---------------------------------------------------------------------------
# What the port adds: three-server durable clusters of both packages.
# ---------------------------------------------------------------------------

#: per package: its cluster harness, config, mock, usage rebuild check,
#: and the config's device setting
PACKAGES = {
    "jax": (ref_testing, RefConfig, ref_mock, ref_rebuild_diff, {}),
    "port": (port_testing, ServerConfig, mock, usage_rebuild_diff,
             {"device": "cpu"}),
}


@pytest.fixture
def jax_with_port_repairs(monkeypatch):
    """The JAX ``Server.start`` pausing the workers before raft starts
    (``establish_leadership`` unpauses them), and the JAX
    ``RaftNode._count_self_match`` advancing the commit with peers too:
    the port's code for both."""
    real_start = ref_server.Server.start

    def start(self):
        if self.raft is not None:
            for w in self.workers:
                w.set_pause(True)
        real_start(self)

    def count_self_match(self, entry):
        with self._lock:
            if self.state != ref_node.LEADER \
                    or self.current_term != entry.term:
                return
            if entry.index > self.match_index.get(self.id, 0):
                self.match_index[self.id] = entry.index
            self._advance_commit_locked()

    monkeypatch.setattr(ref_server.Server, "start", start)
    monkeypatch.setattr(ref_node.RaftNode, "_count_self_match",
                        count_self_match)


def idle(server) -> bool:
    bs = server.eval_broker.stats()
    return (bs["total_ready"] == 0 and bs["total_unacked"] == 0
            and bs["total_waiting"] == 0
            and not any(w._live for w in server.workers)
            and server.plan_queue.stats()["depth"] == 0)


def store_rows(server):
    """The store's index and ``alloc id -> (node, desired, client
    status)``."""
    snap = server.state.snapshot()
    return server.state.latest_index(), {
        a.id: (a.node_id, a.desired_status, a.client_status)
        for a in snap.allocs_iter()}


def wait_stores_equal(servers, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        rows = [store_rows(s) for s in servers]
        if all(r == rows[0] for r in rows[1:]):
            return rows[0]
        time.sleep(0.02)
    raise AssertionError(
        "stores differ: " + str([(r[0], len(r[1])) for r in rows]))


def current_leader(servers):
    for s in servers:
        if s.raft is not None and s.raft.is_leader() and s.is_leader():
            return s
    return None


def submit(servers, job, timeout=30.0):
    """Register ``job`` through whichever live server takes it: a
    follower forwards to the leader, and a call that finds no leader
    (mid-election) is retried."""
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        for s in servers:
            try:
                return s.job_register(job)
            except Exception as e:              # noqa: BLE001
                last = e
        time.sleep(0.05)
    raise AssertionError(f"no server took {job.id}: {last!r}")


def shutdown_all(servers):
    for s in servers:
        try:
            s.shutdown()
        except Exception:                       # noqa: BLE001
            pass


def _twin_jobs():
    jobs = []
    for count in (3, 5, 2, 6, 4, 1):
        job = ref_mock.job()
        job.task_groups[0].count = count
        jobs.append(job)
    return jobs


class TestTwinBurst:
    def test_serial_burst_places_alike_on_three_server_clusters(
            self, tmp_path, jax_with_port_repairs):
        """One worker, one eval at a time, on a durable three-server
        cluster of each package: every eval reaches both leaders with
        their stores at the same index, so both make the same
        placements; each cluster's three stores then agree."""
        memo = {}
        ref_servers, port_servers = [], []
        try:
            ref_servers, _ = ref_testing.make_cluster(3, RefConfig(
                num_workers=1, worker_batch_size=1, heartbeat_ttl=60.0),
                data_dirs=[str(tmp_path / f"jax-{i}") for i in range(3)])
            port_servers, _ = make_cluster(3, ServerConfig(
                num_workers=1, worker_batch_size=1, heartbeat_ttl=60.0,
                device="cpu"),
                data_dirs=[str(tmp_path / f"port-{i}") for i in range(3)])
            leaders = (ref_testing.wait_for_leader(ref_servers, 15.0),
                       wait_for_leader(port_servers, 15.0))
            # the leaders' first core-GC evals each commit a write: every
            # one complete on both sides before the first shared write
            n_core = len(ref_core_sched.ALL_CORE_JOBS)
            _wait(lambda: all(idle(s) and sum(
                e.type == consts.JOB_TYPE_CORE
                and e.status == consts.EVAL_STATUS_COMPLETE
                for e in s.state.snapshot().evals_iter()) == n_core
                for s in leaders), timeout=30.0,
                msg="leaders' core evals complete")
            for _ in range(6):
                node = ref_mock.node()
                leaders[0].node_register(node)
                leaders[1].node_register(
                    structs_from_reference(node, memo))
            for job in _twin_jobs():
                ev = ref_mock.eval(
                    job_id=job.id, namespace=job.namespace, type=job.type,
                    priority=job.priority,
                    triggered_by=consts.EVAL_TRIGGER_JOB_REGISTER)
                idx = [s.state.latest_index() for s in leaders]
                assert idx[0] == idx[1], f"indexes drifted: {idx}"
                req = {"job": job, "evals": [ev]}
                leaders[0].raft_apply(ref_fsm.JOB_REGISTER, req)
                leaders[1].raft_apply(ref_fsm.JOB_REGISTER,
                                      structs_from_reference(req, memo))
                _wait(lambda: all(
                    s.state.snapshot().eval_by_id(ev.id).status
                    != consts.EVAL_STATUS_PENDING and idle(s)
                    for s in leaders), timeout=60.0,
                    msg=f"eval of {job.id}")
            rows = [wait_stores_equal(ref_servers),
                    wait_stores_equal(port_servers)]
            assert rows[0][0] == rows[1][0]
            placed = []
            for leader in leaders:
                snap = leader.state.snapshot()
                placed.append({(a.job_id, a.name): a.node_id
                               for a in snap.allocs_iter()})
            assert placed[1] == placed[0]
            assert len(placed[1]) == sum(
                j.task_groups[0].count for j in _twin_jobs())
        finally:
            shutdown_all(ref_servers + port_servers)


class TestKillAndRestart:
    @pytest.mark.parametrize("package", ["jax", "port"])
    def test_leader_killed_mid_burst_then_restarted_from_disk(
            self, package, tmp_path, jax_with_port_repairs):
        testing, config, pmock, rebuild_diff, extra = PACKAGES[package]
        dirs = [str(tmp_path / f"srv-{i}") for i in range(3)]
        servers, registry = testing.make_cluster(3, config(
            num_workers=1, worker_batch_size=4, heartbeat_ttl=60.0,
            **extra), data_dirs=dirs)
        try:
            leader = testing.wait_for_leader(servers, timeout=15.0)
            for _ in range(6):
                leader.node_register(pmock.node())
            jobs = []
            for _ in range(8):
                job = pmock.simple_job()
                job.task_groups[0].count = 2
                jobs.append(job)
            for job in jobs[:4]:
                leader.job_register(job)
            _wait(lambda: len(_live_allocs(leader, jobs)) >= 4,
                  timeout=60.0, msg="the first jobs placing")
            testing.hard_kill(leader)
            live = [s for s in servers if s is not leader]
            for job in jobs[4:]:
                submit(live, job)
            testing.wait_for_leader(live, timeout=15.0)

            def converged():
                s = current_leader(live)
                if s is None or not idle(s):
                    return False
                allocs = _live_allocs(s, jobs)
                return len(allocs) == 2 * len(jobs)

            _wait(converged, timeout=60.0, msg="burst converged")
            new = current_leader(live)
            fresh = testing.restart_server(leader, registry)
            servers[servers.index(leader)] = fresh
            _wait(lambda: fresh.state.latest_index()
                  >= new.state.latest_index(), timeout=30.0,
                  msg="restarted server caught up")
            assert (fresh.raft.replayed_entries
                    or fresh.raft.recovered_snapshot_index)
            wait_stores_equal(servers)
            for s in servers:
                live_allocs = _live_allocs(s, jobs)
                for job in jobs:
                    names = [a.name for a in live_allocs
                             if a.job_id == job.id]
                    assert len(names) == len(set(names)) == 2, (
                        s.config.name, job.id, names)
                assert rebuild_diff(s.state) == [], s.config.name
        finally:
            shutdown_all(servers)


class TestInstallSnapshotReelection:
    def test_deposed_leader_installs_snapshot_then_places_on_fresh_planes(
            self, tmp_path):
        """A leads and places (its waves make the snapshot's planes
        resident on the CPU), is cut off while B leads, compacts its log
        past A and commits more; on healing, A takes B's snapshot in
        place (a rebuilt usage index: a new generation key), leads again
        and places on planes equal to a fresh upload."""
        from nomad_tpu_torch.raft.observe import raft_observer

        dirs = [str(tmp_path / f"srv-{i}") for i in range(3)]
        servers, registry = make_cluster(3, ServerConfig(
            num_workers=1, worker_batch_size=4, heartbeat_ttl=60.0,
            device="cpu"), data_dirs=dirs)
        try:
            a = wait_for_leader(servers, timeout=15.0)
            for _ in range(6):
                a.node_register(mock.node())

            def place(server, n):
                jobs = []
                for _ in range(n):
                    job = mock.simple_job()
                    job.task_groups[0].count = 2
                    server.job_register(job)
                    jobs.append(job)
                _wait(lambda: len(_live_allocs(server, jobs)) == 2 * n
                      and idle(server), timeout=60.0,
                      msg=f"{n} jobs placed on {server.config.name}")
                return jobs

            jobs = place(a, 2)
            usage = a.state.snapshot().usage
            led_key = (usage.uid, usage.structure_version)
            assert any(k[:2] == led_key for k in default_device_state._gens)
            others = [s for s in servers if s is not a]
            for o in others:
                registry.partition(a.raft.id, o.raft.id)
            b = wait_for_leader(others, timeout=15.0)
            jobs += place(b, 3)
            b.raft.force_snapshot()
            t0 = time.monotonic()
            registry.heal()
            _wait(lambda: not a.raft.is_leader()
                  and a.state.latest_index() >= b.state.latest_index(),
                  timeout=30.0, msg="A caught up from B")
            installs = [e for e in raft_observer.events(since_mono=t0)
                        if e["kind"] == "snapshot_install"
                        and e["server"] == a.raft.id]
            assert installs, "A caught up without an InstallSnapshot"
            usage = a.state.snapshot().usage
            assert (usage.uid, usage.structure_version) != led_key

            deadline = time.time() + 30.0
            while not (a.raft.is_leader() and a.is_leader()):
                assert time.time() < deadline, "A never led again"
                leader = current_leader(servers)
                if leader is not None and leader is not a:
                    leader.raft.step_down()
                    a.raft._start_election()
                time.sleep(0.3)
            jobs += place(a, 2)
            snap = a.state.snapshot()
            res = default_device_state.check_fresh(snap, "cpu")
            assert res["resident"] and res["differ"] == [], res
            assert usage_rebuild_diff(a.state) == []
            live = _live_allocs(a, jobs)
            assert len({(x.job_id, x.name) for x in live}) == len(live) \
                == 2 * len(jobs)
        finally:
            registry.heal()
            shutdown_all(servers)
