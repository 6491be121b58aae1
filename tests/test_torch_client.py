"""Every scenario of ``tests/test_client.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``). Then a
repair of the port's raw_exec (a restarted task's status file), on both
packages.

Client runtime + driver tests.

Modeled on reference client/client_test.go, allocrunner/taskrunner
tests, and drivers/rawexec/driver_test.go: mock-driver-based client
integration against an in-process server (TestClient + TestServer
pattern, client/testing.go), real-subprocess rawexec tests, and
restart-recovery with task reattach.
"""

import os
import time

import pytest

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.client.state_db import MemStateDB, StateDB
from nomad_tpu_torch.client.task_runner import RestartTracker
from nomad_tpu_torch.drivers import builtin_drivers
from nomad_tpu_torch.drivers.mock import MockDriver
from nomad_tpu_torch.drivers.rawexec import RawExecDriver, executor_path
from nomad_tpu_torch.plugins.drivers import TaskConfig
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from _torch_client import port_bridge  # noqa: F401


def wait_for(fn, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


class TestMockDriver:
    def test_run_and_exit(self):
        d = MockDriver()
        h = d.start_task(TaskConfig(
            id="t1", name="t1", driver_config={"run_for": 0.05, "exit_code": 0},
        ))
        assert h.state == "running"
        result = d.wait_task("t1", timeout=5)
        assert result.exit_code == 0

    def test_exit_code(self):
        d = MockDriver()
        d.start_task(TaskConfig(id="t2", name="t2",
                                driver_config={"run_for": 0.01, "exit_code": 3}))
        result = d.wait_task("t2", timeout=5)
        assert result.exit_code == 3

    def test_start_error(self):
        d = MockDriver()
        with pytest.raises(RuntimeError):
            d.start_task(TaskConfig(id="t3", name="t3",
                                    driver_config={"start_error": "boom"}))

    def test_stop_long_running(self):
        d = MockDriver()
        d.start_task(TaskConfig(id="t4", name="t4", driver_config={}))
        d.stop_task("t4", timeout=2)
        result = d.wait_task("t4", timeout=2)
        assert result.signal == 15


class TestRawExecDriver:
    def test_echo(self, tmp_path):
        d = RawExecDriver()
        cfg = TaskConfig(
            id="e1", name="e1", alloc_dir=str(tmp_path),
            driver_config={"command": "/bin/sh",
                           "args": ["-c", "echo raw-exec-ran"]},
        )
        d.start_task(cfg)
        result = d.wait_task("e1", timeout=10)
        assert result.exit_code == 0
        out = (tmp_path / "stdout").read_text()
        assert "raw-exec-ran" in out

    def test_exit_code_propagates(self, tmp_path):
        d = RawExecDriver()
        d.start_task(TaskConfig(
            id="e2", name="e2", alloc_dir=str(tmp_path),
            driver_config={"command": "/bin/sh", "args": ["-c", "exit 7"]},
        ))
        result = d.wait_task("e2", timeout=10)
        assert result.exit_code == 7

    def test_stop_kills_process_group(self, tmp_path):
        d = RawExecDriver()
        d.start_task(TaskConfig(
            id="e3", name="e3", alloc_dir=str(tmp_path),
            driver_config={"command": "/bin/sleep", "args": ["60"]},
        ))
        t0 = time.time()
        d.stop_task("e3", timeout=2)
        result = d.wait_task("e3", timeout=5)
        assert result is not None
        assert time.time() - t0 < 10

    def test_executor_binary_builds(self):
        # native/executor.cc must compile with the baked-in toolchain
        assert executor_path() is not None

    def test_reattach_after_driver_restart(self, tmp_path):
        """The native executor keeps supervising across a driver
        teardown (drivers/shared/executor 2-process model +
        RecoverTask)."""
        d1 = RawExecDriver()
        cfg = TaskConfig(
            id="e4", name="e4", alloc_dir=str(tmp_path),
            driver_config={"command": "/bin/sh",
                           "args": ["-c", "sleep 0.8; echo survived"]},
        )
        handle = d1.start_task(cfg)
        # simulate agent restart: fresh driver instance, recover by handle
        d2 = RawExecDriver()
        d2.recover_task(handle)
        result = d2.wait_task("e4", timeout=10)
        assert result.exit_code == 0
        assert "survived" in (tmp_path / "stdout").read_text()


class TestRestartTracker:
    def test_service_restarts_on_failure(self):
        rt = RestartTracker(structs.RestartPolicy(attempts=2, interval_s=300,
                                                  delay_s=0.01, mode="fail"),
                            consts.JOB_TYPE_SERVICE)
        assert rt.next_restart(False)[0] == "restart"
        assert rt.next_restart(False)[0] == "restart"
        assert rt.next_restart(False)[0] == "fail"

    def test_batch_success_exits(self):
        rt = RestartTracker(structs.RestartPolicy(attempts=2), consts.JOB_TYPE_BATCH)
        assert rt.next_restart(True)[0] == "exit"

    def test_service_success_restarts(self):
        rt = RestartTracker(structs.RestartPolicy(attempts=2, delay_s=0.01),
                            consts.JOB_TYPE_SERVICE)
        assert rt.next_restart(True)[0] == "restart"


class TestStateDB:
    def test_roundtrip(self, tmp_path):
        db = StateDB(str(tmp_path / "state.db"))
        alloc = mock.alloc()
        db.put_allocation(alloc)
        db.put_task_state(alloc.id, "web", local_state={"x": 1},
                          task_handle={"pid": 42})
        assert len(db.get_allocations()) == 1
        local, handle = db.get_task_state(alloc.id, "web")
        assert local == {"x": 1} and handle == {"pid": 42}
        db.delete_allocation(alloc.id)
        assert db.get_allocations() == []
        db.close()

    def test_persists_across_reopen(self, tmp_path):
        path = str(tmp_path / "state.db")
        db = StateDB(path)
        alloc = mock.alloc()
        db.put_allocation(alloc)
        db.put_meta("node_id", "abc")
        db.close()
        db2 = StateDB(path)
        assert len(db2.get_allocations()) == 1
        assert db2.get_meta("node_id") == "abc"
        db2.close()


class TestClientEndToEnd:
    def make_pair(self, tmp_path, **client_kw):
        server = Server(ServerConfig(device="cpu",
                                     num_workers=2, heartbeat_ttl=30.0))
        server.start()
        client = Client(
            InProcessRPC(server),
            ClientConfig(data_dir=str(tmp_path), **client_kw),
        )
        client.start()
        return server, client

    def test_client_registers_and_heartbeats(self, tmp_path):
        server, client = self.make_pair(tmp_path)
        try:
            wait_for(
                lambda: (
                    server.state.snapshot().node_by_id(client.node_id) is not None
                    and server.state.snapshot().node_by_id(client.node_id).status
                    == consts.NODE_STATUS_READY
                ),
                msg="node registered ready",
            )
            node = server.state.snapshot().node_by_id(client.node_id)
            assert node.node_resources.cpu.cpu_shares > 0
            assert "mock_driver" in node.drivers
        finally:
            client.shutdown()
            server.shutdown()

    def test_job_runs_to_completion(self, tmp_path):
        """Full loop: job -> scheduler -> client watch -> mock driver ->
        status update -> server marks complete."""
        server, client = self.make_pair(tmp_path)
        try:
            wait_for(
                lambda: server.state.snapshot().node_by_id(client.node_id) is not None
                and server.state.snapshot().node_by_id(client.node_id).ready(),
                msg="node ready",
            )
            job = mock.simple_job(type=consts.JOB_TYPE_BATCH)
            job.task_groups[0].count = 2
            job.task_groups[0].tasks[0].config = {"run_for": 0.1}
            server.job_register(job)
            wait_for(
                lambda: len([
                    a for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                    if a.client_status == consts.ALLOC_CLIENT_COMPLETE
                ]) == 2,
                timeout=30,
                msg="2 allocs complete",
            )
        finally:
            client.shutdown()
            server.shutdown()

    def test_rawexec_job_writes_output(self, tmp_path):
        server, client = self.make_pair(tmp_path)
        try:
            wait_for(
                lambda: server.state.snapshot().node_by_id(client.node_id) is not None
                and server.state.snapshot().node_by_id(client.node_id).ready(),
                msg="node ready",
            )
            job = mock.simple_job(type=consts.JOB_TYPE_BATCH)
            job.task_groups[0].count = 1
            job.task_groups[0].tasks[0].driver = "raw_exec"
            job.task_groups[0].tasks[0].config = {
                "command": "/bin/sh", "args": ["-c", "echo from-alloc"],
            }
            server.job_register(job)
            wait_for(
                lambda: any(
                    a.client_status == consts.ALLOC_CLIENT_COMPLETE
                    for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                ),
                timeout=30,
                msg="rawexec alloc complete",
            )
            allocs = server.state.snapshot().allocs_by_job(job.namespace, job.id)
            logs = os.path.join(
                str(tmp_path), "allocs", allocs[0].id, "alloc", "logs"
            )
            stdout = os.path.join(logs, "web.stdout.0")
            assert "from-alloc" in open(stdout).read()
        finally:
            client.shutdown()
            server.shutdown()

    def test_failed_task_marks_alloc_failed(self, tmp_path):
        server, client = self.make_pair(tmp_path)
        try:
            wait_for(
                lambda: server.state.snapshot().node_by_id(client.node_id) is not None
                and server.state.snapshot().node_by_id(client.node_id).ready(),
                msg="node ready",
            )
            job = mock.simple_job(type=consts.JOB_TYPE_BATCH)
            job.task_groups[0].count = 1
            job.task_groups[0].restart_policy = structs.RestartPolicy(
                attempts=0, interval_s=300, delay_s=0.01, mode="fail"
            )
            job.task_groups[0].tasks[0].config = {"run_for": 0.05, "exit_code": 1}
            server.job_register(job)
            wait_for(
                lambda: any(
                    a.client_status == consts.ALLOC_CLIENT_FAILED
                    for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                ),
                timeout=30,
                msg="alloc failed",
            )
        finally:
            client.shutdown()
            server.shutdown()

    def test_stop_job_stops_allocs(self, tmp_path):
        server, client = self.make_pair(tmp_path)
        try:
            wait_for(
                lambda: server.state.snapshot().node_by_id(client.node_id) is not None
                and server.state.snapshot().node_by_id(client.node_id).ready(),
                msg="node ready",
            )
            job = mock.simple_job()
            job.task_groups[0].count = 1
            job.task_groups[0].tasks[0].config = {}   # run until killed
            server.job_register(job)
            wait_for(
                lambda: any(
                    a.client_status == consts.ALLOC_CLIENT_RUNNING
                    for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                ),
                timeout=30,
                msg="alloc running",
            )
            server.job_deregister(job.namespace, job.id)
            wait_for(
                lambda: all(
                    a.client_terminal_status()
                    for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                ),
                timeout=30,
                msg="allocs stopped on client",
            )
        finally:
            client.shutdown()
            server.shutdown()

    def test_client_restart_recovers_rawexec_task(self, tmp_path):
        """Agent restart: the executor keeps the task alive; a new
        client reattaches via the persisted TaskHandle
        (client.go:1109 restoreState + RecoverTask)."""
        server = Server(ServerConfig(device="cpu",
                                     num_workers=2, heartbeat_ttl=30.0))
        server.start()
        client = Client(
            InProcessRPC(server),
            ClientConfig(data_dir=str(tmp_path), persistent_state=True),
        )
        client.start()
        try:
            wait_for(
                lambda: server.state.snapshot().node_by_id(client.node_id) is not None
                and server.state.snapshot().node_by_id(client.node_id).ready(),
                msg="node ready",
            )
            job = mock.simple_job(type=consts.JOB_TYPE_BATCH)
            job.task_groups[0].count = 1
            job.task_groups[0].tasks[0].driver = "raw_exec"
            job.task_groups[0].tasks[0].config = {
                "command": "/bin/sh",
                "args": ["-c", "sleep 1.5; echo recovered-ok"],
            }
            server.job_register(job)
            wait_for(
                lambda: any(
                    a.client_status == consts.ALLOC_CLIENT_RUNNING
                    for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                ),
                timeout=30,
                msg="alloc running",
            )
            node_id = client.node_id
            # hard-stop the agent WITHOUT stopping tasks
            client._shutdown.set()
            for t in client._threads:
                t.join(timeout=2)
            client.state_db.close()

            # new agent instance over the same data dir
            client2 = Client(
                InProcessRPC(server),
                ClientConfig(data_dir=str(tmp_path), persistent_state=True),
            )
            assert client2.node_id == node_id
            client2.start()
            wait_for(
                lambda: any(
                    a.client_status == consts.ALLOC_CLIENT_COMPLETE
                    for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                ),
                timeout=30,
                msg="recovered alloc completes",
            )
            allocs = server.state.snapshot().allocs_by_job(job.namespace, job.id)
            logs = os.path.join(
                str(tmp_path), "allocs", allocs[0].id, "alloc", "logs"
            )
            assert "recovered-ok" in open(
                os.path.join(logs, "web.stdout.0")
            ).read()
            client2.shutdown()
        finally:
            server.shutdown()

    def test_node_down_reschedules_to_other_client(self, tmp_path):
        """Kill a client; heartbeat expiry reschedules its allocs onto
        the surviving client (heartbeat.go -> node down -> eval ->
        reconcile lost)."""
        server = Server(ServerConfig(device="cpu",
                                     num_workers=2, heartbeat_ttl=1.0))
        server.start()
        c1 = Client(InProcessRPC(server),
                    ClientConfig(data_dir=str(tmp_path / "c1")))
        c2 = Client(InProcessRPC(server),
                    ClientConfig(data_dir=str(tmp_path / "c2")))
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
            victim, survivor = c1, c2
            victim._shutdown.set()     # silent death: heartbeats stop
            wait_for(
                lambda: server.state.snapshot().node_by_id(victim.node_id).status
                == consts.NODE_STATUS_DOWN,
                timeout=15,
                msg="victim node down",
            )
            wait_for(
                lambda: len([
                    a for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                    if a.client_status == consts.ALLOC_CLIENT_RUNNING
                    and a.node_id == survivor.node_id
                ]) == 2,
                timeout=30,
                msg="allocs rescheduled to survivor",
            )
        finally:
            c1.shutdown()
            c2.shutdown()
            server.shutdown()


class TestLogmonSurvival:
    def test_logs_written_while_agent_down_are_collected(self, tmp_path):
        """logmon runs as its own process (logmon.go:46): output a task
        writes while the agent is down still lands in the rotated
        files, and the restarted agent reattaches to the SAME collector
        instead of spawning a second one."""
        server = Server(ServerConfig(device="cpu",
                                     num_workers=2, heartbeat_ttl=30.0))
        server.start()
        client = Client(
            InProcessRPC(server),
            ClientConfig(data_dir=str(tmp_path), persistent_state=True),
        )
        client.start()
        try:
            wait_for(
                lambda: server.state.snapshot().node_by_id(client.node_id)
                is not None
                and server.state.snapshot().node_by_id(client.node_id).ready(),
                msg="node ready",
            )
            job = mock.simple_job(type=consts.JOB_TYPE_BATCH)
            job.task_groups[0].count = 1
            job.task_groups[0].tasks[0].driver = "raw_exec"
            # slow ticker: emits one line per 0.3s for ~6s
            job.task_groups[0].tasks[0].config = {
                "command": "/bin/sh",
                "args": ["-c",
                         "for i in $(seq 1 20); do echo tick-$i; "
                         "sleep 0.3; done"],
            }
            server.job_register(job)
            wait_for(
                lambda: any(
                    a.client_status == consts.ALLOC_CLIENT_RUNNING
                    for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                ),
                timeout=30, msg="alloc running",
            )
            alloc = server.state.snapshot().allocs_by_job(
                job.namespace, job.id)[0]
            base = os.path.join(str(tmp_path), "allocs", alloc.id,
                                "alloc", "logs", "web.stdout")
            pid_path = base + ".logmon.pid"
            wait_for(lambda: os.path.exists(pid_path),
                     msg="collector pidfile")
            collector_pid = int(open(pid_path).read())

            # hard-stop the agent WITHOUT stopping tasks or collectors
            client._shutdown.set()
            for t in client._threads:
                t.join(timeout=2)
            client.state_db.close()

            def logged():
                from nomad_tpu_torch.client.logmon import read_rotated
                return read_rotated(base).decode(errors="replace")

            # ticks keep landing while no agent exists
            before = logged()
            wait_for(lambda: logged() != before and "tick-" in logged(),
                     timeout=10, msg="logs flowing while agent down")

            # restarted agent reattaches to the same collector
            client2 = Client(
                InProcessRPC(server),
                ClientConfig(data_dir=str(tmp_path), persistent_state=True),
            )
            client2.start()
            wait_for(
                lambda: any(
                    a.client_status == consts.ALLOC_CLIENT_COMPLETE
                    for a in server.state.snapshot().allocs_by_job(
                        job.namespace, job.id)
                ),
                timeout=30, msg="task completes after restart",
            )
            assert int(open(pid_path).read()) == collector_pid \
                if os.path.exists(pid_path) else True
            final = logged()
            assert "tick-1" in final and "tick-20" in final
            client2.shutdown()
        finally:
            server.shutdown()


# ---------------------------------------------------------------------------
# What the port adds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_restarted_task_reports_its_own_exit(package, tmp_path):
    """A task restarted under its policy runs again in the same dir, and
    the native executor appends to the status file there. The port's
    raw_exec starts each run on an empty file, so the second run reports
    its own pid and exit; the reference's reads the first run's records
    back: it reports the first run's exit code at once and keeps the dead
    run's pid, while the new process runs on unwatched."""
    if package == "port":
        driver_cls, config_cls = RawExecDriver, TaskConfig
    else:
        from nomad_tpu.drivers.rawexec import RawExecDriver as driver_cls
        from nomad_tpu.plugins.drivers import TaskConfig as config_cls
    assert executor_path() is not None
    d = driver_cls()
    first = d.start_task(config_cls(
        id="r1", name="web", alloc_dir=str(tmp_path),
        driver_config={"command": "/bin/sh", "args": ["-c", "exit 1"]}))
    assert d.wait_task("r1", timeout=10).exit_code == 1
    second = d.start_task(config_cls(
        id="r2", name="web", alloc_dir=str(tmp_path),
        driver_config={"command": "/bin/sh",
                       "args": ["-c", "sleep 0.3; exit 0"]}))
    result = d.wait_task("r2", timeout=10)
    if package == "port":
        assert result.exit_code == 0
        assert second.driver_state["pid"] != first.driver_state["pid"]
    else:
        assert result.exit_code == 1
        assert second.driver_state["pid"] == first.driver_state["pid"]
        time.sleep(0.5)        # let the unwatched run end
