"""The port's worker processes against ``tests/test_workerproc.py``.

Every scenario of the JAX package's file runs against the port on the
CPU: the framed channel (``utils/ipc``), the generation leases, the
frame reconstruction property (a replica rebuilt from one bootstrap frame
plus ``(gen, delta)`` frames equals the owner's root at the same
generation, usage planes included; the same seeded op streams, carried
across with ``convert.structs_from_reference``), the live plane through
two worker processes, a SIGKILL mid-lease and the stale plan token.
Then what the port adds: a system job through worker processes, every
process reporting the owner's device (``device="cpu"`` reaches the
children) and its resident planes equal to a fresh upload, three
processes on a packed cluster placing under the placement turn with no
rejected node plan, a process
that cannot open its device (``start()`` raises, nothing places, no
respawn loop), and worker processes whose interpreter has ``jax`` and
``nomad_tpu`` blocked.
"""

import gc
import json
import pickle
import subprocess
import time

import pytest
import torch

from test_mvcc_store import _apply, _gen_ops

from nomad_tpu_torch import mock
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.server import workerproc
from nomad_tpu_torch.state.store import (
    StateStore,
    _TABLE_NAMES,
    apply_frame,
    bootstrap_frame,
    delta_frame,
    expire_generation_leases,
    lease_generation,
    leased_generation_count,
    release_owner_leases,
    renew_owner_leases,
    snapshot_at,
    store_stats,
)
from nomad_tpu_torch.state.usage import usage_rebuild_diff
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.utils import faultpoints
from nomad_tpu_torch.utils.ipc import (
    Channel,
    FrameError,
    channel_pair,
    socket_pair,
)


@pytest.fixture(autouse=True)
def _clean_plane():
    faultpoints.reset()
    yield
    faultpoints.reset()


def _wait(fn, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


# ---------------------------------------------------------------------------
# framed channel


class TestChannel:
    def test_roundtrip_and_order(self):
        a, b = channel_pair()
        try:
            a.send({"t": "x", "n": 1})
            a.send(["big", b"\x00" * 65_536])
            assert b.recv() == {"t": "x", "n": 1}
            assert b.recv() == ["big", b"\x00" * 65_536]
            b.send("reply")
            assert a.recv() == "reply"
        finally:
            a.close()
            b.close()

    def test_recv_timeout_returns_none(self):
        a, b = channel_pair()
        try:
            assert b.recv(timeout=0.05) is None
        finally:
            a.close()
            b.close()

    def test_closed_peer_raises_eof(self):
        a, b = channel_pair()
        a.close()
        try:
            with pytest.raises(EOFError):
                b.recv()
        finally:
            b.close()

    def test_corrupt_frame_raises_frame_error(self):
        import struct
        import zlib

        raw_a, raw_b = socket_pair()
        chan = Channel(raw_b)
        try:
            payload = pickle.dumps({"k": "v"})
            bad_crc = (zlib.crc32(payload) ^ 0xDEAD) & 0xFFFFFFFF
            raw_a.sendall(struct.pack(">II", len(payload), bad_crc)
                          + payload)
            with pytest.raises(FrameError):
                chan.recv()
        finally:
            raw_a.close()
            chan.close()


# ---------------------------------------------------------------------------
# generation leases


class TestGenerationLeases:
    def test_lease_pins_root_past_reader_release(self):
        store = StateStore()
        store.upsert_node(mock.node())
        snap = store.snapshot()
        gen = store.current_generation()
        assert lease_generation(gen, "test-owner")
        store.upsert_node(mock.node())
        del snap
        gc.collect()
        assert snapshot_at(gen) is not None
        assert leased_generation_count() >= 1
        st = store_stats.snapshot()
        assert st["live_roots_leased"] >= 1
        assert st["live_roots"] == (st["live_roots_leased"]
                                    + st["live_roots_in_process"])
        release_owner_leases("test-owner")
        gc.collect()
        assert snapshot_at(gen) is None

    def test_ttl_expiry_and_renewal(self):
        store = StateStore()
        store.upsert_node(mock.node())
        gen = store.current_generation()
        assert lease_generation(gen, "ttl-owner", ttl_s=0.08)
        store.upsert_node(mock.node())
        assert renew_owner_leases("ttl-owner", ttl_s=0.08) == 1
        time.sleep(0.12)
        assert expire_generation_leases() >= 1
        gc.collect()
        assert snapshot_at(gen) is None
        assert release_owner_leases("ttl-owner") == 0

    def test_lease_on_dead_generation_refuses(self):
        store = StateStore()
        store.upsert_node(mock.node())
        gen = store.current_generation()
        store.upsert_node(mock.node())
        gc.collect()
        assert not lease_generation(gen, "late-owner")


# ---------------------------------------------------------------------------
# snapshot transport frames: the bit-identity property


def _ship(frame):
    """Frames cross a pickle boundary in production; so do they here."""
    return pickle.loads(pickle.dumps(frame,
                                     protocol=pickle.HIGHEST_PROTOCOL))


def _assert_replica_identical(owner, replica):
    ro, rr = owner._root, replica._root
    assert rr.generation == ro.generation
    assert rr.index == ro.index
    assert rr.table_indexes == ro.table_indexes
    for name in _TABLE_NAMES:
        ot = ro.tables[name].to_dict()
        nt = rr.tables[name].to_dict()
        assert sorted(ot) == sorted(nt), f"table {name} keys diverged"
        for k, row in ot.items():
            if isinstance(row, (set, frozenset)):
                assert nt[k] == row, f"table {name} row {k!r} diverged"
            else:
                assert pickle.dumps(nt[k]) == pickle.dumps(row), \
                    f"table {name} row {k!r} diverged"
    assert usage_rebuild_diff(replica) == []


def _port_ops(seed, n_ops):
    """The reference's seeded op stream, its arguments carried across to
    the port's structs."""
    return [(method, structs_from_reference(args))
            for method, args in _gen_ops(seed, n_ops=n_ops)]


def _run_frame_reconstruction(seed, n_ops=60):
    ops = _port_ops(seed, n_ops)
    owner = StateStore()
    _apply(owner, ops[: n_ops // 2])

    replica = StateStore()
    apply_frame(replica, _ship(bootstrap_frame(
        owner, pin_owner=f"port-prop-{seed}")))
    _assert_replica_identical(owner, replica)

    synced = owner.current_generation()
    rest = ops[n_ops // 2:]
    step = 5
    for i in range(0, len(rest), step):
        _apply(owner, rest[i:i + step])
        frame = delta_frame(owner, synced, pin_owner=f"port-prop-{seed}")
        if frame is None:
            assert owner.current_generation() == synced
            continue
        apply_frame(replica, _ship(frame))
        synced = frame["generation"]
        _assert_replica_identical(owner, replica)
    release_owner_leases(f"port-prop-{seed}")


class TestFrameReconstruction:
    @pytest.mark.parametrize("seed", range(25))
    def test_delta_reconstructed_replica_bit_identical(self, seed):
        _run_frame_reconstruction(seed)

    def test_out_of_order_delta_raises(self):
        owner = StateStore()
        owner.upsert_node(mock.node())
        replica = StateStore()
        apply_frame(replica, _ship(bootstrap_frame(owner)))
        base = owner.current_generation()
        snap = owner.snapshot()
        owner.upsert_node(mock.node())
        frame = delta_frame(owner, base)
        assert frame is not None
        apply_frame(replica, _ship(frame))
        with pytest.raises(ValueError, match="out-of-order"):
            apply_frame(replica, _ship(frame))
        del snap

    def test_delta_none_when_base_root_gone(self):
        owner = StateStore()
        owner.upsert_node(mock.node())
        base = owner.current_generation()
        owner.upsert_node(mock.node())
        gc.collect()
        assert delta_frame(owner, base) is None


# ---------------------------------------------------------------------------
# the live plane: real worker processes


def _make_server(scheduler_workers=2, start=True, **kw):
    from nomad_tpu_torch.server.server import Server, ServerConfig

    kw = {"worker_batch_size": 4, **kw}
    cfg = ServerConfig(
        num_workers=1, heartbeat_ttl=60.0,
        nack_timeout=2.0, scheduler_workers=scheduler_workers,
        gc_tuning=False, **kw)
    server = Server(cfg, device="cpu")
    if start:
        server.start()
    return server


def _submit_jobs(server, n, count=2):
    jobs = []
    for _ in range(n):
        job = mock.simple_job()
        job.task_groups[0].count = count
        server.job_register(job)
        jobs.append(job)
    return jobs


def _converged(server, jobs, want_per_job=2):
    snap = server.state.snapshot()
    live = sum(1 for j in jobs
               for a in snap.allocs_by_job(j.namespace, j.id)
               if not a.terminal_status())
    if live != len(jobs) * want_per_job:
        return False
    if any(e.status in (consts.EVAL_STATUS_PENDING,
                        consts.EVAL_STATUS_BLOCKED)
           for e in snap.evals_iter()):
        return False
    b = server.eval_broker.stats()
    return (b["total_ready"] == 0 and b["total_unacked"] == 0
            and b["total_waiting"] == 0)


def _exact(server, jobs, per_job=2):
    snap = server.state.snapshot()
    for j in jobs:
        names = [a.name for a in snap.allocs_by_job(j.namespace, j.id)
                 if not a.terminal_status()]
        assert len(set(names)) == len(names) == per_job


class _Spawned:
    """Every worker process a test's supervisor starts."""

    def __init__(self, monkeypatch):
        self.procs = []
        real = subprocess.Popen

        def popen(*args, **kwargs):
            p = real(*args, **kwargs)
            self.procs.append(p)
            return p

        monkeypatch.setattr(workerproc.subprocess, "Popen", popen)

    def all_exited(self) -> bool:
        return all(p.poll() is not None for p in self.procs)


class TestWorkerProcesses:
    def test_end_to_end_scheduling_through_worker_processes(self):
        """scheduler_workers=2: jobs place through real worker processes
        (dequeue → replica snapshot → plan-build → submit over IPC) on
        the owner's device, in-process workers shrink to the core queue,
        and the usage planes stay rebuild-identical, in the owner and in
        each process's resident planes."""
        server = _make_server()
        try:
            assert server.worker_supervisor is not None
            assert all(w.schedulers == [consts.JOB_TYPE_CORE]
                       for w in server.workers)
            for _ in range(8):
                server.node_register(mock.node())
            jobs = _submit_jobs(server, 6)
            _wait(lambda: _converged(server, jobs), timeout=90.0,
                  msg="jobs placed through worker processes")
            wp = server.stats()["worker_procs"]
            assert wp["workers"] == 2 and wp["alive"] == 2
            assert wp["acked"] >= len(jobs)
            assert wp["outstanding"] == 0
            assert wp["lease_reissues"] == 0
            assert wp["device"] == "cpu"
            assert usage_rebuild_diff(server.state) == []
            _exact(server, jobs)
            sup = server.worker_supervisor
            counters = sup.child_counters()
            assert [c["device"] for c in counters] == ["cpu", "cpu"]
            assert sum(c["processed"] for c in counters) >= len(jobs)
            for c in counters:
                assert c["fused"]["fallbacks"] == 0
                assert c["fused"]["failures"] == 0
                assert c["device_state"]["errors"] == 0
                assert c["rss_bytes"] > 0 and c["last_error"] is None
            for h in sup.handles:
                h.sync_state()
            for res in sup.probe_all("resident"):
                assert res["resident"] and res["differ"] == [], res
            children = server.stats()["worker_procs"]["children"]
            assert [c["device"] for c in children] == ["cpu", "cpu"]
            assert all(c["bootstrap_bytes"] > 0 for c in children)
            # one path for a process's counters: its heartbeats
            assert [c["counters"]["device"] for c in children] == [
                "cpu", "cpu"]
            assert all(c["counters"]["turn"] is not None for c in children)
        finally:
            server.shutdown()
        assert leased_generation_count() == 0

    def test_sigkill_mid_lease_recovers_pinned_seed(self):
        """REAL process death: the pinned-seed schedule SIGKILLs one
        worker process right after it receives a lease — the
        supervisor's liveness monitor must re-enqueue the dead worker's
        lease ledger, respawn the process, and the burst must converge
        to exact placement anyway."""
        server = _make_server()
        try:
            for _ in range(8):
                server.node_register(mock.node())
            faultpoints.arm(
                {"workerproc.kill": {"kind": "error", "nth": 2}},
                seed=17017)
            jobs = _submit_jobs(server, 6)
            _wait(lambda: _converged(server, jobs), timeout=120.0,
                  msg="burst converged through worker SIGKILL")
            assert faultpoints.stats()["workerproc.kill"]["fires"] == 1
            faultpoints.disarm()
            wp = server.stats()["worker_procs"]
            assert wp["respawns"] >= 1, wp
            assert wp["lease_reissues"] >= 1, wp
            assert wp["alive"] == 2, wp
            assert wp["outstanding"] == 0, wp
            assert wp["spawn_failures"] == 0, wp
            assert usage_rebuild_diff(server.state) == []
            _exact(server, jobs)
        finally:
            server.shutdown()
        assert leased_generation_count() == 0

    def test_system_job_through_worker_processes(self):
        """A system job and a sysbatch job are leased to a worker process
        and place one alloc on every ready node."""
        server = _make_server()
        try:
            nodes = [mock.node() for _ in range(6)]
            for n in nodes:
                server.node_register(n)
            server.state.update_node_drain(nodes[0].id, True)
            jobs = []
            for job_type in (consts.JOB_TYPE_SYSTEM, consts.JOB_TYPE_SYSBATCH):
                job = mock.system_job()
                job.type = job_type
                server.job_register(job)
                jobs.append(job)
            ready = sorted(n.id for n in nodes[1:])

            def placed():
                snap = server.state.snapshot()
                return all(sorted(a.node_id for a in snap.allocs_by_job(
                    j.namespace, j.id) if not a.terminal_status()) == ready
                    for j in jobs)

            _wait(placed, timeout=90.0, msg="system jobs placed")
            _wait(lambda: _converged(server, [], 0), timeout=30.0,
                  msg="broker drained")
            snap = server.state.snapshot()
            for j in jobs:
                evs = [e for e in snap.evals_iter() if e.job_id == j.id]
                assert [e.status for e in evs] == [
                    consts.EVAL_STATUS_COMPLETE]
            counters = server.worker_supervisor.child_counters()
            assert sum(c["mask_launches"] for c in counters) >= 2
            assert server.stats()["worker_procs"]["acked"] >= 2
            assert usage_rebuild_diff(server.state) == []
        finally:
            server.shutdown()
        assert leased_generation_count() == 0

    def test_device_that_cannot_be_opened_fails_start(self, monkeypatch):
        """Worker processes told to open a device that is not there
        report it in their first message: ``start()`` raises, every
        process is gone, none is respawned, and nothing is placed (no
        process falls back to the CPU)."""
        spawned = _Spawned(monkeypatch)
        server = _make_server(start=False)
        server.worker_supervisor.device = torch.device("cuda", 99)
        try:
            with pytest.raises(RuntimeError, match="could not open device"):
                server.start()
            assert len(spawned.procs) == 2
            _wait(spawned.all_exited, timeout=10.0, msg="processes exited")
            assert all(p.returncode != 0 for p in spawned.procs)
            for _ in range(3):
                server.node_register(mock.node())
            time.sleep(0.5)
            assert len(spawned.procs) == 2
            wp = server.stats()["worker_procs"]
            assert wp["respawns"] == 0 and wp["workers"] == 0, wp
            assert not list(server.state.snapshot().allocs_iter())
        finally:
            server.shutdown()
        assert leased_generation_count() == 0

    def test_respawn_that_cannot_open_its_device_is_not_retried(
            self, monkeypatch):
        """A process that dies later is respawned once; a replacement
        that cannot open its device is not respawned again."""
        spawned = _Spawned(monkeypatch)
        server = _make_server()
        try:
            assert len(spawned.procs) == 2
            sup = server.worker_supervisor
            sup.device = torch.device("cuda", 99)
            spawned.procs[0].kill()
            _wait(lambda: sup.stats()["spawn_failures"] == 1, timeout=60.0,
                  msg="the replacement's device failure")
            time.sleep(0.5)
            wp = sup.stats()
            assert wp["respawns"] == 1 and len(spawned.procs) == 3, wp
            assert wp["alive"] == 1
            assert wp["children"][0]["device_error"]
            assert wp["children"][1]["device"] == "cpu"
        finally:
            server.shutdown()
        assert spawned.all_exited()

    def test_processes_take_turns_on_a_packed_cluster(self):
        """Three processes schedule concurrent batches of C2M jobs on a
        packed replay cluster. Their waves take the placement turn and
        place against every plan committed before them, so no node plan
        is rejected and no eval fails (without the turn, their waves
        binpack onto the same nodes from one snapshot: rejections, and
        evals out of attempts)."""
        import numpy as np

        from nomad_tpu_torch.parallel import c2m
        from nomad_tpu_torch.server.plan_apply import plan_group_stats

        store = c2m.generate(300, 3000, seed=7)
        server = _make_server(scheduler_workers=3, start=False,
                              worker_batch_size=16,
                              coalesce_adaptive=False)
        server.state.restore_from_bytes(store.to_snapshot_bytes())
        server.start()
        try:
            sup = server.worker_supervisor
            assert sup.turn is not None
            rng = np.random.default_rng(7)
            jobs = [c2m.burst_job(rng, i) for i in range(48)]
            plan_group_stats.reset()
            for job in jobs:
                server.job_register(job)
            _wait(lambda: _converged(server, jobs, c2m.BURST_COUNT),
                  timeout=120.0, msg="burst placed through three processes")
            snap = server.state.snapshot()
            assert not [e.id for e in snap.evals_iter()
                        if e.status == consts.EVAL_STATUS_FAILED]
            assert plan_group_stats.snapshot()["rejected_node_plans"] == 0
            turns = [c["turn"] for c in sup.child_counters()]
            assert sum(t["grants"] for t in turns) == sup.turn.grants >= 3
            assert sum(t["refreshed"] for t in turns) >= len(jobs)
            assert usage_rebuild_diff(server.state) == []
        finally:
            server.shutdown()
        assert leased_generation_count() == 0

    def test_worker_processes_load_neither_jax_nor_reference(
            self, monkeypatch, tmp_path):
        """The worker processes run with ``jax`` and ``nomad_tpu`` blocked
        by a ``sitecustomize`` first on their path: each writes, at exit,
        the modules of either that it loaded, and must name none."""
        hook = tmp_path / "hook"
        hook.mkdir()
        out = tmp_path / "out"
        out.mkdir()
        (hook / "sitecustomize.py").write_text(
            "import atexit, json, os, sys\n"
            "before = {m for m in sys.modules\n"
            "          if m == 'jax' or m.startswith(('jax.', 'nomad_tpu.'))}\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['nomad_tpu'] = None\n"
            "def _report():\n"
            "    new = sorted(m for m, v in sys.modules.items()\n"
            "                 if v is not None and (m == 'jax' or m.startswith(\n"
            "                     ('jax.', 'nomad_tpu.'))) and m not in before)\n"
            f"    path = os.path.join({str(out)!r}, f'{{os.getpid()}}.json')\n"
            "    with open(path, 'w') as f:\n"
            "        json.dump(new, f)\n"
            "atexit.register(_report)\n")
        monkeypatch.syspath_prepend(str(hook))
        spawned = _Spawned(monkeypatch)
        server = _make_server()
        try:
            for _ in range(4):
                server.node_register(mock.node())
            jobs = _submit_jobs(server, 4)
            _wait(lambda: _converged(server, jobs), timeout=90.0,
                  msg="jobs placed with the reference blocked")
            assert server.stats()["worker_procs"]["acked"] >= len(jobs)
        finally:
            server.shutdown()
        _wait(spawned.all_exited, timeout=10.0, msg="processes exited")
        reports = {int(p.stem): json.loads(p.read_text())
                   for p in out.glob("*.json")}
        assert sorted(reports) == sorted(p.pid for p in spawned.procs)
        assert all(v == [] for v in reports.values()), reports


class TestStalePlanToken:
    """plan_endpoint.go Submit token-check parity: a dead worker's
    in-flight plan can reach the applier AFTER the supervisor
    re-enqueued its lease — committing it would race the redelivered
    eval into duplicate live slots. A plan is valid only while its
    worker still holds the eval lease."""

    def test_stale_token_plan_rejected_live_token_accepted(self):
        from nomad_tpu_torch.structs.eval_plan import Plan

        server = _make_server(scheduler_workers=0, start=False)
        broker = server.eval_broker
        broker.set_enabled(True)
        ev = mock.eval()
        broker.enqueue(ev)
        out, token = broker.dequeue([ev.type], timeout=1)
        assert out.id == ev.id
        plan = Plan(eval_id=ev.id, eval_token=token)
        assert server._validate_plan_token(plan) is None
        broker.nack(ev.id, token)
        with pytest.raises(ValueError, match="stale eval token"):
            server.submit_plan(plan)
        assert server._validate_plan_token(Plan(eval_id=ev.id)) is None
