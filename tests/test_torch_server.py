"""The port's server against the JAX package's, on the CPU.

``nomad_tpu_torch.server.Server`` runs the main path from a registered
job to a committed plan: the eval broker, a worker (one eval at a time or
batches through the coalescer, whose waves run B1's plain version on the
CPU), the plan queue and the applier's group commit, the FSM into the
store. State is made once with the JAX package's ``mock`` and carried
across with ``convert.structs_from_reference``; allocations are matched
by name.

The six end-to-end scenarios of ``tests/test_server.py`` run on both
servers at once. Each write goes to both, with both packages' uuid
generators seeded alike just before it, so the evals it creates get the
same ids and so the same shuffle seeds (``f"{eval.id}:{latest_index}"``).
A serial burst (one worker, one eval at a time) is fed the same
evaluations and must end with the same placements. Threaded bursts, the
plan window, the wave cohort, the GC treatment (in a subprocess, since
``gc.freeze`` is process-wide) and the refused settings are checked on
the port alone. Every wait has a deadline and every server is shut down
in a ``finally``.
"""

import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.server import fsm as ref_fsm
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefConfig
from nomad_tpu.structs import consts
from nomad_tpu.structs import eval_plan as ref_eval_plan
from nomad_tpu.structs.eval_plan import Evaluation
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.parallel import c2m
from nomad_tpu_torch.parallel import coalesce as pc
from nomad_tpu_torch.server import plan_apply as port_plan_apply
from nomad_tpu_torch.server import plan_queue as port_plan_queue
from nomad_tpu_torch.server.server import Server as PortServer
from nomad_tpu_torch.server.server import ServerConfig as PortConfig
from nomad_tpu_torch.structs import eval_plan as port_eval_plan

import _torch_parity as tp

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60.0


def wait_for(fn, timeout=WAIT_S, msg="condition", servers=()):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.01)
    errors = [w.last_error for s in servers for w in s.workers
              if w.last_error]
    raise AssertionError(f"timeout waiting for {msg}; worker errors: "
                         f"{errors}")


def idle(server) -> bool:
    """Nothing in the broker, no eval held by a worker, no plan queued."""
    bs = server.eval_broker.stats()
    return (bs["total_ready"] == 0 and bs["total_unacked"] == 0
            and not any(w._live for w in server.workers)
            and server.plan_queue.stats()["depth"] == 0)


def allocs_by_name(server):
    """``(job_id, alloc name) -> (node_id, desired, client status)`` of
    every allocation in the store."""
    snap = server.state.snapshot()
    return {(a.job_id, a.name): (a.node_id, a.desired_status,
                                 a.client_status)
            for a in snap.allocs_iter()}


def eval_rows(server, by_id=True):
    """``eval id -> (status, trigger, job, previous eval)`` of the job
    evals (without ``by_id``, their sorted rows), and the sorted rows of
    the core (GC) evals, whose ids the leader's loop draws at its own
    moment."""
    evals = list(server.state.snapshot().evals_iter())
    rows = [(e.id, (e.status, e.triggered_by, e.job_id, e.previous_eval))
            for e in evals if e.type != consts.JOB_TYPE_CORE]
    jobs = dict(rows) if by_id else sorted(row for _, row in rows)
    core = sorted((e.status, e.triggered_by, e.job_id) for e in evals
                  if e.type == consts.JOB_TYPE_CORE)
    return jobs, core


class Pair:
    """Both packages' servers with one configuration, fed the same
    writes in the same order."""

    def __init__(self, monkeypatch, **cfg):
        self.memo = {}
        self.monkeypatch = monkeypatch
        self.ref = RefServer(RefConfig(**cfg))
        self.port = PortServer(PortConfig(**cfg), device="cpu")

    @property
    def sides(self):
        return (self.ref, self.port)

    def __enter__(self):
        for s in self.sides:
            s.start()
        if self.port.workers:
            # the leader's first core-GC evals are processed before any
            # write (without workers they stay queued)
            self.wait_idle("servers idle after start")
        return self

    def __exit__(self, *exc):
        for s in self.sides:
            s.shutdown()

    def conv(self, obj):
        return structs_from_reference(obj, self.memo)

    def call(self, name, *args, seed=None):
        """``server.<name>(*args)`` on both (the port gets converted
        arguments). With ``seed``, each package's uuid generator is
        seeded with it just before its call."""
        port_args = self.conv(args)
        out = []
        for server, pkg, a in ((self.ref, ref_eval_plan, args),
                               (self.port, port_eval_plan, port_args)):
            if seed is not None:
                self.monkeypatch.setattr(pkg, "_UUID_RNG",
                                         random.Random(seed))
            out.append(getattr(server, name)(*a))
        return out

    def wait_idle(self, msg="idle"):
        wait_for(lambda: all(idle(s) for s in self.sides), msg=msg,
                 servers=self.sides)

    def assert_same(self, by_id=True):
        """Same index, placements by alloc name, evals (by id when the
        writes were seeded) and blocked evals."""
        assert self.ref.state.latest_index() == self.port.state.latest_index()
        assert allocs_by_name(self.port) == allocs_by_name(self.ref)
        assert eval_rows(self.port, by_id) == eval_rows(self.ref, by_id)
        for k in ("total_blocked", "total_escaped"):
            assert (self.port.blocked_evals.stats().get(k)
                    == self.ref.blocked_evals.stats().get(k)), k


def live_count(server, job, status=consts.ALLOC_DESIRED_RUN) -> int:
    return len([a for a in server.state.snapshot().allocs_by_job(
        job.namespace, job.id) if a.desired_status == status])


# ---------------------------------------------------------------------------
# tests/test_server.py's TestServerEndToEnd, on both servers at once.
# ---------------------------------------------------------------------------

def _pair_with_nodes(monkeypatch, n_nodes=5, **cfg):
    cfg.setdefault("num_workers", 2)
    cfg.setdefault("heartbeat_ttl", 60.0)
    pair = Pair(monkeypatch, **cfg)
    return pair, [mock.node() for _ in range(n_nodes)]


def test_job_register_places_allocs(monkeypatch):
    pair, nodes = _pair_with_nodes(monkeypatch)
    with pair:
        for n in nodes:
            pair.call("node_register", n)
        job = mock.job()
        ref_out, port_out = pair.call("job_register", job, seed=11)
        assert ref_out["eval_id"] == port_out["eval_id"]
        wait_for(lambda: all(live_count(s, job) == 10 for s in pair.sides)
                 and all(s.state.snapshot().eval_by_id(
                     ref_out["eval_id"]).status
                     == consts.EVAL_STATUS_COMPLETE for s in pair.sides),
                 msg="10 allocs placed, eval complete", servers=pair.sides)
        pair.wait_idle()
        pair.assert_same()


def test_exhausted_job_blocks_then_unblocks(monkeypatch):
    pair, nodes = _pair_with_nodes(monkeypatch, n_nodes=1)
    with pair:
        pair.call("node_register", nodes[0])
        job = mock.job()
        # each mock node fits at most 7 tasks (3900 MHz usable / 500)
        job.task_groups[0].count = 20
        pair.call("job_register", job, seed=12)
        wait_for(lambda: all(s.blocked_evals.stats()["total_blocked"] == 1
                             for s in pair.sides),
                 msg="blocked eval created", servers=pair.sides)
        pair.wait_idle()
        assert live_count(pair.port, job) < 20
        pair.assert_same()
        # capacity arrives with the workers stopped, so the unblocked
        # eval runs against the state after all four registrations on
        # both (a paused worker may still be inside a dequeue)
        for s in pair.sides:
            for w in s.workers:
                w.stop()
        for _ in range(4):
            pair.call("node_register", mock.node())
        for s in pair.sides:
            for w in s.workers:
                w.start()
        wait_for(lambda: all(live_count(s, job) == 20 for s in pair.sides),
                 msg="all 20 allocs placed after unblock", servers=pair.sides)
        pair.wait_idle()
        pair.assert_same()


def test_job_deregister_stops_allocs(monkeypatch):
    pair, nodes = _pair_with_nodes(monkeypatch)
    with pair:
        for n in nodes:
            pair.call("node_register", n)
        job = mock.job()
        pair.call("job_register", job, seed=13)
        wait_for(lambda: all(live_count(s, job) == 10 for s in pair.sides),
                 msg="allocs placed", servers=pair.sides)
        pair.wait_idle()
        pair.call("job_deregister", job.namespace, job.id, seed=14)
        wait_for(lambda: all(
            live_count(s, job, consts.ALLOC_DESIRED_STOP) == 10
            for s in pair.sides), msg="allocs stopped", servers=pair.sides)
        pair.wait_idle()
        pair.assert_same()


def test_heartbeat_expiry_marks_node_down(monkeypatch):
    pair = Pair(monkeypatch, num_workers=2, heartbeat_ttl=0.2)
    with pair:
        node = mock.node()
        pair.call("node_register", node)
        wait_for(lambda: all(
            s.state.snapshot().node_by_id(node.id).status
            == consts.NODE_STATUS_DOWN for s in pair.sides),
            timeout=10, msg="node down after missed heartbeat")
        pair.wait_idle()
        assert eval_rows(pair.port) == eval_rows(pair.ref)


def test_heartbeat_keeps_node_alive(monkeypatch):
    pair = Pair(monkeypatch, num_workers=0, heartbeat_ttl=0.3)
    with pair:
        node = mock.node()
        pair.call("node_register", node)
        for _ in range(4):
            time.sleep(0.1)
            pair.call("node_heartbeat", node.id, consts.NODE_STATUS_READY)
        for s in pair.sides:
            assert (s.state.snapshot().node_by_id(node.id).status
                    == consts.NODE_STATUS_READY)


def test_failed_eval_reaped_with_follow_up(monkeypatch):
    pair = Pair(monkeypatch, num_workers=0, eval_delivery_limit=1)
    for s in pair.sides:
        s.eval_broker.initial_nack_delay = 0.0
        s.eval_broker.subsequent_nack_delay = 0.0
    with pair:
        ev = Evaluation(type=consts.JOB_TYPE_SERVICE, job_id="job-1",
                        namespace="default", priority=50,
                        status=consts.EVAL_STATUS_PENDING)
        pair.call("raft_apply", ref_fsm.EVAL_UPDATE, {"evals": [ev]})
        for s in pair.sides:
            out, token = s.eval_broker.dequeue([consts.JOB_TYPE_SERVICE],
                                               timeout=5)
            assert out is not None and out.id == ev.id
            s.eval_broker.nack(out.id, token)
        wait_for(lambda: all(
            s.state.snapshot().eval_by_id(ev.id).status
            == consts.EVAL_STATUS_FAILED for s in pair.sides),
            msg="failed eval reaped")

        def follow_ups(s):
            # the follow-up's id comes from the reaper thread's draw
            return sorted(
                (e.status, e.job_id, e.previous_eval, e.wait_until_s is not None)
                for e in s.state.snapshot().evals_iter()
                if e.triggered_by == consts.EVAL_TRIGGER_FAILED_FOLLOW_UP)

        wait_for(lambda: all(len(follow_ups(s)) == 1 for s in pair.sides),
                 msg="follow-up eval")
        assert follow_ups(pair.port) == follow_ups(pair.ref)


def test_heartbeat_timers_one_thread():
    """The port's timers keep the reference's semantics (reset postpones,
    clear cancels, disable drops every timer, ``count``) on one thread
    for any number of nodes."""
    from nomad_tpu_torch.server.heartbeat import HeartbeatTimers

    fired = []
    t = HeartbeatTimers(fired.append, ttl=1.0, ttl_jitter=0.0)
    assert t.reset("off") == 1.0 and t.count() == 0   # disabled: no timer
    threads = threading.active_count()
    t.set_enabled(True)
    names = [f"n{i}" for i in range(200)]
    for n in names:
        t.reset(n)
    assert t.count() == 200
    assert threading.active_count() <= threads + 1
    t.clear("n0")
    deadline = time.monotonic() + WAIT_S
    while len(fired) < 198 and time.monotonic() < deadline:
        t.reset("n1")                   # kept alive past its first TTL
        time.sleep(0.05)
    assert sorted(fired) == sorted(names[2:])
    assert t.count() == 1
    timer_thread = t._thread
    t.set_enabled(False)
    assert t.count() == 0
    time.sleep(1.2)
    assert "n1" not in fired
    timer_thread.join(10)
    assert not timer_thread.is_alive(), "timer thread outlived disable"


# ---------------------------------------------------------------------------
# A serial burst: the same evaluations, one at a time, on both servers.
# ---------------------------------------------------------------------------

def _burst_jobs():
    jobs = []
    for i in range(6):
        job = (mock.batch_job() if i % 3 == 2 else mock.job())
        job.task_groups[0].count = 3 + i
        jobs.append(job)
    big = mock.job()
    big.task_groups[0].count = 40      # more than the cluster holds
    jobs.append(big)
    return jobs


def test_serial_burst_places_alike(monkeypatch):
    """One worker, one eval at a time: each eval is handed to both
    servers with the store at the same index, so both make the same
    placements, blocked evals included. The writes are not seeded, so
    the ids the schedulers draw (allocs, the blocked eval) differ."""
    pair = Pair(monkeypatch, num_workers=1, worker_batch_size=1,
                heartbeat_ttl=60.0)
    with pair:
        for _ in range(8):
            pair.call("node_register", mock.node())
        for job in _burst_jobs():
            ev = mock.eval(job_id=job.id, namespace=job.namespace,
                           type=job.type, priority=job.priority,
                           triggered_by=consts.EVAL_TRIGGER_JOB_REGISTER)
            idx = [s.state.latest_index() for s in pair.sides]
            assert idx[0] == idx[1], f"indexes drifted before {job.id}: {idx}"
            pair.call("raft_apply", ref_fsm.JOB_REGISTER,
                      {"job": job, "evals": [ev]})
            wait_for(lambda: all(
                s.state.snapshot().eval_by_id(ev.id).status
                != consts.EVAL_STATUS_PENDING for s in pair.sides)
                and all(idle(s) for s in pair.sides),
                msg=f"eval of {job.id}", servers=pair.sides)
        pair.assert_same(by_id=False)
        placed = allocs_by_name(pair.port)
        assert len(placed) > 40
        assert pair.port.blocked_evals.stats()["total_blocked"] == 1


# ---------------------------------------------------------------------------
# The port alone: batched bursts through the coalescer.
# ---------------------------------------------------------------------------

def _c2m_server(n_nodes=60, n_allocs=120, **cfg):
    cfg.setdefault("heartbeat_ttl", 60.0)
    srv = PortServer(PortConfig(**cfg), device="cpu")
    srv.state.restore_from_bytes(
        c2m.generate(n_nodes, n_allocs).to_snapshot_bytes())
    return srv


def _counting(monkeypatch, name):
    """Wrap ``coalesce.<name>`` to count its calls."""
    calls = []
    orig = getattr(pc, name)

    def wrapper(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(pc, name, wrapper)
    return calls


def _register_stopped(srv, jobs):
    """Register ``jobs`` while the workers are stopped, so the broker hands
    them out in full batches."""
    for w in srv.workers:
        w.stop()
    try:
        for job in jobs:
            srv.job_register(job)
    finally:
        for w in srv.workers:
            w.start()


def test_batched_burst_runs_waves_on_b1(monkeypatch):
    """``test_burst_of_jobs_all_schedule``'s shape (one worker, batches of
    8, 12 jobs x 2) on C2M lean jobs: every job placed, no node over
    capacity, fewer waves than evals, every wave B1's plain version, no
    fallback. The coalescer's adaptive window is off, so a wave waits for
    every member of its batch: with it on, how a batch splits into waves
    depends on the machine's load."""
    b1 = _counting(monkeypatch, "fused_wave_place")
    pc.fused_wave_stats.reset()
    srv = _c2m_server(num_workers=1, worker_batch_size=8,
                      coalesce_adaptive=False)
    srv.start()
    try:
        rng = np.random.default_rng(5)
        jobs = []
        for i in range(12):
            job = c2m.burst_job(rng, i, prefix="batched")
            job.task_groups[0].count = 2
            jobs.append(job)
        _register_stopped(srv, jobs)
        wait_for(lambda: all(live_count(srv, j) == 2 for j in jobs)
                 and idle(srv), msg="burst placed", servers=(srv,))
        w = srv.workers[0]
        assert w.last_error is None
        assert tp.over_capacity_nodes(srv.state) == 0
        snap = srv.state.snapshot()
        for j in jobs:
            ev = [e for e in snap.evals_iter() if e.job_id == j.id]
            assert [e.status for e in ev] == [consts.EVAL_STATUS_COMPLETE]
    finally:
        srv.shutdown()
    # the worker's loop has ended, so its last batch is reaped and counted
    assert w._pool is None
    assert 1 <= w.batch_launches < len(jobs) <= w.batch_requests
    assert w.max_wave >= 4
    stats = pc.fused_wave_stats.snapshot()
    assert stats == {"launches": len(b1), "fallbacks": 0, "failures": 0}
    assert len(b1) == w.batch_launches


def test_b1_failure_nacks_the_wave(monkeypatch):
    """A failing B1 fails its wave's evals: each is nacked (here to the
    failed queue, delivery limit 1), the failure is counted, and the
    plain version never runs in its place."""
    def broken(*a, **k):
        raise RuntimeError("injected B1 failure")

    monkeypatch.setattr(pc, "fused_wave_place", broken)
    plain = []
    real_plain = ck.fused_wave_place_reference

    def counted_plain(*a, **k):
        plain.append(1)
        return real_plain(*a, **k)

    monkeypatch.setattr(ck, "fused_wave_place_reference", counted_plain)
    pc.fused_wave_stats.reset()
    srv = _c2m_server(num_workers=1, worker_batch_size=4,
                      eval_delivery_limit=1)
    srv.eval_broker.initial_nack_delay = 0.0
    srv.start()
    try:
        rng = np.random.default_rng(6)
        jobs = [c2m.burst_job(rng, i, prefix="broken") for i in range(4)]
        _register_stopped(srv, jobs)

        def failed():
            snap = srv.state.snapshot()
            return [e for e in snap.evals_iter()
                    if e.job_id in {j.id for j in jobs}
                    and e.status == consts.EVAL_STATUS_FAILED]

        wait_for(lambda: len(failed()) == 4, msg="evals failed")
        stats = pc.fused_wave_stats.snapshot()
        assert stats["failures"] >= 1 and stats["launches"] == 0
        assert stats["fallbacks"] == 0 and not plain
        assert "injected B1 failure" in srv.workers[0].last_error
        assert all(live_count(srv, j) == 0 for j in jobs)
    finally:
        srv.shutdown()


def test_cluster_cache_builds_each_version_once():
    """The evals of a batch that miss one store version together share
    one build: one full build, one object for every caller."""
    from nomad_tpu_torch.tensors.schema import IncrementalClusterCache

    store = c2m.generate(300, 600)
    snap = store.snapshot()
    cache = IncrementalClusterCache()
    start = threading.Barrier(16)
    got = []

    def one():
        start.wait(WAIT_S)
        got.append(cache.get(snap))

    threads = [threading.Thread(target=one, daemon=True) for _ in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(WAIT_S)
    assert len(got) == 16 and all(g is got[0] for g in got)
    assert cache.full_builds == 1 and cache.hits == 15


# ---------------------------------------------------------------------------
# Plan window and wave cohort.
# ---------------------------------------------------------------------------

def _members(n, seed=0):
    from nomad_tpu_torch.ops.kernel import LEAN_FEATURES
    from nomad_tpu_torch.parallel.synthetic import synthetic_kernel_in

    return [synthetic_kernel_in(60, 2, seed=seed + i) for i in range(n)], \
        LEAN_FEATURES


def test_plan_window_lets_the_next_wave_fire():
    """While wave 1's member A is inside its plan window (a slow plan
    submission), member B's second launch fires as wave 2 at once,
    without waiting for A (a non-adaptive coalescer has no deadline)."""
    kins, feats = _members(3)
    co = pc.LaunchCoalescer(2, device="cpu", adaptive=False)
    in_window = threading.Event()
    release = threading.Event()
    b_second = threading.Event()
    errors = []

    def member_a():
        try:
            co.launch(kins[0], 2, feats)
            with co.plan_window():
                in_window.set()
                release.wait(WAIT_S)
        except Exception as e:              # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            co.done()

    def member_b():
        try:
            co.launch(kins[1], 2, feats)
            in_window.wait(WAIT_S)
            co.launch(kins[2], 2, feats)
            b_second.set()
        except Exception as e:              # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            co.done()

    threads = [threading.Thread(target=f, daemon=True)
               for f in (member_a, member_b)]
    for th in threads:
        th.start()
    try:
        assert b_second.wait(WAIT_S), "wave 2 waited for the plan window"
        assert not release.is_set()
        assert co.launches == 2 and co.max_wave == 2
    finally:
        release.set()
        for th in threads:
            th.join(WAIT_S)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors


def test_wave_arms_cohort_and_commits_as_one(monkeypatch):
    """A wave of k members arms the plan queue's cohort with k before its
    members resume; the applier's ``dequeue_batch`` then holds out for all
    k plans, which commit as one index bump."""
    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.structs.eval_plan import Plan
    from nomad_tpu_torch.utils.wavecohort import WaveCohortTracker

    k = 4
    tracker = WaveCohortTracker()
    # wide windows: a loaded machine must not expire the cohort before
    # its members resume (a drained cohort releases at once anyway)
    tracker.WINDOW_DEFAULT_S = tracker.ARRIVAL_GAP_S = 10.0
    tracker.HARD_CAP_S = 20.0
    monkeypatch.setattr(pc, "wave_cohorts", tracker)
    monkeypatch.setattr(port_plan_queue, "wave_cohorts", tracker)
    store = StateStore()
    nodes = [port_mock.node() for _ in range(2)]
    for n in nodes:
        store.upsert_node(n)
    queue = port_plan_queue.PlanQueue()
    queue.set_enabled(True)
    planner = port_plan_apply.Planner(store, queue, pool_workers=1)
    kins, feats = _members(k, seed=10)
    co = pc.LaunchCoalescer(k, device="cpu", adaptive=False)
    armed = []

    def member(i):
        try:
            co.launch(kins[i], 2, feats)
            armed.append(tracker.pending_wait_s() > 0.0)
            a = port_mock.alloc(node_id=nodes[i % 2].id)
            queue.enqueue(Plan(priority=50,
                               node_allocation={a.node_id: [a]}))
        finally:
            co.done()

    threads = [threading.Thread(target=member, args=(i,), daemon=True)
               for i in range(k)]
    for th in threads:
        th.start()
    batch = queue.dequeue_batch(128, timeout=WAIT_S)
    for th in threads:
        th.join(WAIT_S)
    assert not any(th.is_alive() for th in threads)
    assert co.launches == 1 and tracker.waves == 1
    assert len(batch) == k, "the applier popped a partial cohort"
    assert tracker.snapshot()["drained_cohorts"] == 1
    before = store.latest_index()
    results = planner.apply_batch([p.plan for p in batch])
    assert store.latest_index() == before + 1
    assert all(r.alloc_index == before + 1 for r in results)


def test_group_commit_is_one_index_bump():
    """test_plan_group_commit.py's case on the port's Planner: four plans
    applied as a group land as one store commit."""
    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.structs.eval_plan import Plan

    store = StateStore()
    node = port_mock.node()
    store.upsert_node(node)
    planner = port_plan_apply.Planner(store, port_plan_queue.PlanQueue(),
                                      pool_workers=1)
    before = store.latest_index()
    plans = []
    for _ in range(4):
        a = port_mock.alloc(node_id=node.id)
        plans.append(Plan(priority=50, node_allocation={node.id: [a]}))
    results = planner.apply_batch(plans)
    assert store.latest_index() == before + 1
    assert all(r.alloc_index == before + 1 for r in results)


def test_cohort_drains_and_learns():
    from nomad_tpu_torch.utils.wavecohort import WaveCohortTracker

    t = WaveCohortTracker()
    assert t.pending_wait_s() == 0.0
    t.note_wave(3)
    assert t.pending_wait_s() > 0.0
    for _ in range(3):
        t.note_plan()
    assert t.pending_wait_s() == 0.0
    snap = t.snapshot()
    assert snap["drained_cohorts"] == 1
    assert snap["cohort_plans"] == 3
    assert snap["drain_ewma_ms"] >= 0.0


def test_cohort_shortfall_expires():
    from nomad_tpu_torch.utils.wavecohort import WaveCohortTracker

    t = WaveCohortTracker()
    t.WINDOW_DEFAULT_S = 0.01
    t.note_wave(2)
    t.note_plan()
    deadline = time.monotonic() + 2.0
    while t.pending_wait_s() > 0.0 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert t.pending_wait_s() == 0.0
    assert t.snapshot()["expired_cohorts"] == 1


def test_dequeue_batch_waits_for_cohort(monkeypatch):
    from nomad_tpu_torch.structs.eval_plan import Plan
    from nomad_tpu_torch.utils.wavecohort import WaveCohortTracker

    tracker = WaveCohortTracker()
    monkeypatch.setattr(port_plan_queue, "wave_cohorts", tracker)
    q = port_plan_queue.PlanQueue()
    q.set_enabled(True)
    tracker.note_wave(2)
    q.enqueue(Plan(priority=50))

    def late():
        time.sleep(0.01)
        q.enqueue(Plan(priority=50))

    th = threading.Thread(target=late, daemon=True)
    th.start()
    batch = q.dequeue_batch(128, timeout=0.2)
    th.join(WAIT_S)
    assert len(batch) == 2, "applier popped a partial cohort"


def test_dequeue_batch_unaffected_without_cohort():
    from nomad_tpu_torch.structs.eval_plan import Plan

    q = port_plan_queue.PlanQueue()
    q.set_enabled(True)
    q.enqueue(Plan(priority=50))
    t0 = time.monotonic()
    batch = q.dequeue_batch(128, timeout=0.2)
    assert len(batch) == 1
    assert time.monotonic() - t0 < 0.05


# ---------------------------------------------------------------------------
# The GC treatment, in a subprocess (gc.freeze is process-wide).
# ---------------------------------------------------------------------------

_GC_RUN = r"""
import gc, sys, threading, time
from nomad_tpu_torch.server.server import Server, ServerConfig

mode = sys.argv[1]
collects = []
real_collect = gc.collect
gc.collect = lambda *a: collects.append(1) or real_collect(*a)
before = (gc.get_threshold(), gc.get_freeze_count())


def gc_threads():
    return [t for t in threading.enumerate() if t.name == "interpreter-gc"]


cfg = dict(num_workers=0, gc_interval=0.05, gc_tuning=(mode != "off"))
srv = Server(ServerConfig(**cfg), device="cpu")
srv.start()
try:
    if mode in ("off", "env"):
        assert (gc.get_threshold(), gc.get_freeze_count()) == before
        assert not gc_threads()
    else:
        frozen = gc.get_freeze_count()
        assert frozen > before[1]
        assert gc.get_threshold() == (50000, 1000, 10000)
        assert len(gc_threads()) == 1
        deadline = time.time() + 30
        while not collects and time.time() < deadline:
            time.sleep(0.01)
        assert collects, "the maintenance thread never collected"
finally:
    srv.shutdown()
for t in gc_threads():
    t.join(30)
assert not gc_threads(), "maintenance thread outlived shutdown"
if mode == "on":
    # a second server in the process does not freeze again (frozen
    # objects that die leave the count; a freeze would add the heap)
    srv = Server(ServerConfig(**cfg), device="cpu")
    srv.start()
    try:
        assert gc.get_freeze_count() <= frozen
    finally:
        srv.shutdown()
print("ok")
"""


@pytest.mark.parametrize("mode", ["on", "off", "env"])
def test_gc_treatment(mode):
    env = dict(os.environ)
    env.pop("NOMAD_TPU_GC_TUNING", None)
    if mode == "env":
        env["NOMAD_TPU_GC_TUNING"] = "0"
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _GC_RUN, mode],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# Settings: nothing is ignored, nothing is dropped.
# ---------------------------------------------------------------------------

def test_settings_that_ask_for_nothing_unported_are_accepted(
        monkeypatch, tmp_path):
    # auto warmup reads the default manifest when one exists: point it at
    # a path that does not, so no manifest outside the test is read
    from nomad_tpu_torch.ops import warmup

    monkeypatch.setattr(warmup, "DEFAULT_MANIFEST_PATH",
                        str(tmp_path / "absent.json"))
    for cfg in ({"use_device_mesh": False}, {"use_device_mesh": None},
                {"use_device_mesh": True},
                {"kernel_warmup": False}, {"kernel_warmup": None},
                {"authoritative_region": "global"},
                {"authoritative_region": "eu"},
                {"data_dir": str(tmp_path / "data")}):
        srv = PortServer(PortConfig(num_workers=0, **cfg), device="cpu")
        srv.start()
        srv.shutdown()


def test_setup_raft_attaches_a_durable_log(tmp_path):
    """``setup_raft`` with a ``data_dir`` recovers and journals under
    ``<data_dir>/raft``: a one-server cluster elects itself, commits a
    write through its WAL, and a restart from the directory finds it."""
    from nomad_tpu_torch import mock as port_mock
    from nomad_tpu_torch.raft.transport import InmemTransport, TransportRegistry

    def boot():
        srv = PortServer(PortConfig(num_workers=0, heartbeat_ttl=60.0,
                                    data_dir=str(tmp_path)), device="cpu")
        srv.setup_raft("s1", ["s1"], InmemTransport("s1", registry))
        srv.start()
        wait_for(srv.is_leader, msg="self-election", servers=(srv,))
        return srv

    registry = TransportRegistry()
    node = port_mock.node()
    srv = boot()
    try:
        assert srv.raft._durable
        srv.node_register(node)
        index = srv.state.latest_index()
    finally:
        srv.shutdown()
    assert os.listdir(tmp_path / "raft")
    srv = boot()
    try:
        assert srv.raft.replayed_entries > 0
        assert srv.state.latest_index() >= index
        assert srv.state.snapshot().node_by_id(node.id) is not None
    finally:
        srv.shutdown()


def test_system_eval_completes_through_the_server():
    """A system job registered with the port's server places one alloc on
    every ready node, and its eval completes."""
    from nomad_tpu_torch import mock as port_mock

    srv = PortServer(PortConfig(num_workers=1, heartbeat_ttl=60.0,
                                gc_tuning=False), device="cpu")
    srv.start()
    try:
        nodes = [port_mock.node() for _ in range(5)]
        for n in nodes:
            srv.node_register(n)
        job = port_mock.system_job()
        out = srv.job_register(job)
        wait_for(lambda: srv.state.snapshot().eval_by_id(
            out["eval_id"]).status == consts.EVAL_STATUS_COMPLETE,
            msg="system eval complete", servers=(srv,))
        snap = srv.state.snapshot()
        live = [a for a in snap.allocs_by_job(job.namespace, job.id)
                if not a.terminal_status()]
        assert sorted(a.node_id for a in live) == sorted(n.id for n in nodes)
        assert srv.workers[0].last_error is None
    finally:
        srv.shutdown()


def test_config_device_and_argument():
    srv = PortServer(PortConfig(num_workers=0, device="cpu"))
    assert srv.device == torch.device("cpu")
    srv = PortServer(PortConfig(num_workers=0, device="cuda"), device="cpu")
    assert srv.device == torch.device("cpu")


def test_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        PortServer(PortConfig(num_workers=0))
