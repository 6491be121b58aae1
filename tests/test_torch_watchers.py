"""Every scenario of ``tests/test_watchers.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Watcher/lifecycle tests: GC, periodic, events, drainer, deployments.

Modeled on reference nomad/core_sched_test.go, periodic_test.go,
drainer tests, deploymentwatcher/deployments_watcher_test.go, and
stream/event_broker_test.go.
"""

import time

import pytest

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.server import stream
from nomad_tpu_torch.server.drainer import DrainStrategy
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.utils.cron import CronExpr
from nomad_tpu_torch.utils.timetable import TimeTable
from _torch_client import port_bridge  # noqa: F401


def wait_for(fn, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


class TestCron:
    def test_every(self):
        e = CronExpr("@every 5s")
        now = time.time()
        assert abs(e.next_after(now) - (now + 5)) < 0.01

    def test_every_minute(self):
        e = CronExpr("* * * * *")
        now = time.time()
        nxt = e.next_after(now)
        assert 0 < nxt - now <= 60

    def test_specific_minute(self):
        e = CronExpr("30 * * * *")
        nxt = time.localtime(e.next_after())
        assert nxt.tm_min == 30

    def test_step_and_range(self):
        e = CronExpr("*/15 9-17 * * *")
        nxt = time.localtime(e.next_after())
        assert nxt.tm_min in (0, 15, 30, 45)
        assert 9 <= nxt.tm_hour <= 17

    def test_bad_spec_raises(self):
        with pytest.raises(ValueError):
            CronExpr("not a cron")


class TestTimeTable:
    def test_nearest(self):
        tt = TimeTable()
        tt.witness(10, when=100.0)
        tt.witness(20, when=200.0)
        assert tt.nearest_index(150.0) == 10
        assert tt.nearest_index(250.0) == 20
        assert tt.nearest_index(50.0) == 0


class TestEventBroker:
    def test_publish_subscribe(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            sub = server.event_broker.subscribe({stream.TOPIC_JOB: ["*"]})
            job = mock.job()
            server.job_register(job)
            events = sub.next_events(timeout=2)
            assert any(
                e.topic == stream.TOPIC_JOB and e.key == job.id
                for e in events
            )
            sub.close()
        finally:
            server.shutdown()

    def test_topic_filter(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            sub = server.event_broker.subscribe({stream.TOPIC_NODE: ["*"]})
            server.job_register(mock.job())
            events = sub.next_events(timeout=0.3)
            assert all(e.topic == stream.TOPIC_NODE for e in events)
            node = mock.node()
            server.node_register(node)
            events = sub.next_events(timeout=2)
            assert any(e.key == node.id for e in events)
        finally:
            server.shutdown()


class TestCoreGC:
    def test_eval_and_alloc_gc(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            ev = mock.eval(status=consts.EVAL_STATUS_COMPLETE)
            server.state.upsert_evals([ev])
            alloc = mock.alloc(
                eval_id=ev.id,
                desired_status=consts.ALLOC_DESIRED_STOP,
                client_status=consts.ALLOC_CLIENT_COMPLETE,
            )
            server.state.upsert_allocs([alloc])
            server.force_gc()
            snap = server.state.snapshot()
            assert snap.eval_by_id(ev.id) is None
            assert snap.alloc_by_id(alloc.id) is None
        finally:
            server.shutdown()

    def test_live_eval_not_collected(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            ev = mock.eval(status=consts.EVAL_STATUS_COMPLETE)
            server.state.upsert_evals([ev])
            alloc = mock.alloc(eval_id=ev.id)   # still running
            server.state.upsert_allocs([alloc])
            server.force_gc()
            assert server.state.snapshot().eval_by_id(ev.id) is not None
        finally:
            server.shutdown()

    def test_job_gc(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            job = mock.job(stop=True)
            server.state.upsert_job(job)
            server.force_gc()
            assert server.state.snapshot().job_by_id(job.namespace, job.id) is None
        finally:
            server.shutdown()

    def test_node_gc(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            node = mock.node(status=consts.NODE_STATUS_DOWN)
            server.state.upsert_node(node)
            server.force_gc()
            assert server.state.snapshot().node_by_id(node.id) is None
        finally:
            server.shutdown()

    def test_threshold_respected_without_force(self):
        server = Server(ServerConfig(device="cpu",
                                     num_workers=0, eval_gc_threshold=3600))
        server.start()
        try:
            ev = mock.eval(status=consts.EVAL_STATUS_COMPLETE)
            server.state.upsert_evals([ev])
            from nomad_tpu_torch.server.core_sched import CoreScheduler
            sched = CoreScheduler(server.state.snapshot(), None, server)
            sched.eval_gc(force=False)   # too young to collect
            assert server.state.snapshot().eval_by_id(ev.id) is not None
        finally:
            server.shutdown()


class TestPeriodic:
    def test_periodic_launches_children(self):
        server = Server(ServerConfig(device="cpu",
                                     num_workers=2, heartbeat_ttl=60.0))
        server.start()
        try:
            for _ in range(2):
                server.node_register(mock.node())
            job = mock.simple_job(type=consts.JOB_TYPE_BATCH)
            job.task_groups[0].count = 1
            job.periodic = structs.PeriodicConfig(
                enabled=True, spec="@every 0.2s"
            )
            resp = server.job_register(job)
            assert resp["eval_id"] == ""    # parent gets no eval
            wait_for(
                lambda: len([
                    j for j in server.state.snapshot().jobs()
                    if j.parent_id == job.id
                ]) >= 2,
                timeout=10,
                msg="two periodic children launched",
            )
            child = next(
                j for j in server.state.snapshot().jobs()
                if j.parent_id == job.id
            )
            wait_for(
                lambda: len(server.state.snapshot().allocs_by_job(
                    child.namespace, child.id)) == 1,
                timeout=15,
                msg="child job scheduled",
            )
        finally:
            server.shutdown()

    def test_stop_parent_stops_launches(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            job = mock.simple_job(type=consts.JOB_TYPE_BATCH)
            job.periodic = structs.PeriodicConfig(enabled=True, spec="@every 0.2s")
            server.job_register(job)
            assert server.periodic_dispatcher.tracked_count() == 1
            server.job_deregister(job.namespace, job.id)
            assert server.periodic_dispatcher.tracked_count() == 0
        finally:
            server.shutdown()


class TestDrainer:
    def test_drain_migrates_allocs(self, tmp_path):
        server = Server(ServerConfig(device="cpu",
                                     num_workers=2, heartbeat_ttl=30.0))
        server.start()
        c1 = Client(InProcessRPC(server), ClientConfig(data_dir=str(tmp_path / "c1")))
        c2 = Client(InProcessRPC(server), ClientConfig(data_dir=str(tmp_path / "c2")))
        c1.start()
        c2.start()
        try:
            wait_for(
                lambda: all(
                    server.state.snapshot().node_by_id(c.node_id) is not None
                    and server.state.snapshot().node_by_id(c.node_id).ready()
                    for c in (c1, c2)
                ),
                msg="both nodes ready",
            )
            job = mock.simple_job()
            job.task_groups[0].count = 2
            job.task_groups[0].tasks[0].config = {}   # run forever
            server.job_register(job)
            wait_for(
                lambda: len([
                    a for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                    if a.client_status == consts.ALLOC_CLIENT_RUNNING
                ]) == 2,
                timeout=30,
                msg="2 allocs running",
            )
            server.node_update_drain(
                c1.node_id, True, DrainStrategy(deadline_s=60)
            )
            # all running allocs end up on c2; drain flag clears
            wait_for(
                lambda: len([
                    a for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                    if a.client_status == consts.ALLOC_CLIENT_RUNNING
                    and a.node_id == c2.node_id
                ]) == 2,
                timeout=30,
                msg="allocs migrated to c2",
            )
            wait_for(
                lambda: not server.state.snapshot().node_by_id(c1.node_id).drain,
                timeout=15,
                msg="drain completed",
            )
            node = server.state.snapshot().node_by_id(c1.node_id)
            assert node.scheduling_eligibility == consts.NODE_SCHEDULING_INELIGIBLE
        finally:
            c1.shutdown()
            c2.shutdown()
            server.shutdown()


class TestDeployments:
    def make_update_job(self):
        job = mock.simple_job()
        job.task_groups[0].count = 3
        job.task_groups[0].tasks[0].config = {}   # run forever
        job.task_groups[0].update = structs.UpdateStrategy(
            max_parallel=1,
            min_healthy_time_s=0.1,
            healthy_deadline_s=10.0,
            progress_deadline_s=30.0,
        )
        return job

    def test_deployment_succeeds_when_healthy(self, tmp_path):
        server = Server(ServerConfig(device="cpu",
                                     num_workers=2, heartbeat_ttl=30.0))
        server.start()
        client = Client(InProcessRPC(server), ClientConfig(data_dir=str(tmp_path)))
        client.start()
        try:
            wait_for(
                lambda: server.state.snapshot().node_by_id(client.node_id) is not None
                and server.state.snapshot().node_by_id(client.node_id).ready(),
                msg="node ready",
            )
            job = self.make_update_job()
            server.job_register(job)
            wait_for(
                lambda: server.state.snapshot().latest_deployment_by_job_id(
                    job.namespace, job.id) is not None,
                timeout=30,
                msg="deployment created",
            )
            wait_for(
                lambda: server.state.snapshot().latest_deployment_by_job_id(
                    job.namespace, job.id).status
                == consts.DEPLOYMENT_STATUS_SUCCESSFUL,
                timeout=30,
                msg="deployment successful",
            )
            d = server.state.snapshot().latest_deployment_by_job_id(
                job.namespace, job.id)
            state = d.task_groups[job.task_groups[0].name]
            assert state.healthy_allocs >= state.desired_total == 3
        finally:
            client.shutdown()
            server.shutdown()

    def test_failed_deployment_marked_failed(self, tmp_path):
        server = Server(ServerConfig(device="cpu",
                                     num_workers=2, heartbeat_ttl=30.0))
        server.start()
        client = Client(InProcessRPC(server), ClientConfig(data_dir=str(tmp_path)))
        client.start()
        try:
            wait_for(
                lambda: server.state.snapshot().node_by_id(client.node_id) is not None
                and server.state.snapshot().node_by_id(client.node_id).ready(),
                msg="node ready",
            )
            job = self.make_update_job()
            job.task_groups[0].count = 1
            job.task_groups[0].restart_policy = structs.RestartPolicy(
                attempts=0, interval_s=300, delay_s=0.01, mode="fail"
            )
            # tasks crash: deployment must fail
            job.task_groups[0].tasks[0].config = {"run_for": 0.05, "exit_code": 1}
            server.job_register(job)
            wait_for(
                lambda: (
                    server.state.snapshot().latest_deployment_by_job_id(
                        job.namespace, job.id) is not None
                    and server.state.snapshot().latest_deployment_by_job_id(
                        job.namespace, job.id).status
                    == consts.DEPLOYMENT_STATUS_FAILED
                ),
                timeout=30,
                msg="deployment failed",
            )
        finally:
            client.shutdown()
            server.shutdown()

    def test_idle_watcher_caches_against_deployment_table_index(self):
        """Alloc commits wake the deployments watcher on every plan; with
        nothing tracked and no active deployments, the tick must early-out
        against the deployment table index WITHOUT re-scanning the
        deployments table (the drainer's and volume watcher's discipline). A
        deployment write re-arms the scan."""
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            node = mock.node()
            server.node_register(node)
            calls = []
            orig = server.state.active_deployments
            server.state.active_deployments = \
                lambda: (calls.append(1), orig())[1]
            # let the watcher prove idleness once
            deadline = time.time() + 10
            while time.time() < deadline and not calls:
                time.sleep(0.05)
            time.sleep(0.3)
            baseline = len(calls)
            assert baseline >= 1
            # alloc-table churn: each upsert wakes the watcher loop,
            # but the deployment index is unchanged -> no re-scan
            for _ in range(15):
                a = mock.alloc(node_id=node.id)
                server.state.upsert_allocs([a])
                time.sleep(0.02)
            time.sleep(0.5)
            assert len(calls) <= baseline + 1, (baseline, len(calls))
            # a deployment write bumps the index and re-arms the scan
            from nomad_tpu_torch.structs.eval_plan import Deployment

            server.state.upsert_deployment(
                Deployment(job_id="j", namespace="default"))
            deadline = time.time() + 10
            while time.time() < deadline and len(calls) <= baseline + 1:
                time.sleep(0.05)
            assert len(calls) > baseline
        finally:
            server.shutdown()
