"""The JAX package's client stack and the port's, side by side.

One server of each package (the port's on the CPU), each with two
clients of fixed node ids and classes and data dirs of their own, take
the same jobs, made once with the reference ``mock`` and carried across
with ``convert.structs_from_reference``. Each job is pinned to one class
by a constraint, so the node an allocation lands on is determined. The
allocations are matched by name (their ids are random in each package)
and must agree in node, client status, the task's event types in
order, its exit codes, its restart count and the bytes its task wrote to
stdout. The JAX package's raw_exec runs with the port's repair of a
restarted task's status file patched in (ROADMAP C), since without it
the task that fails once reports its first exit code on every run.
"""

import os
import re
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.drivers import rawexec as ref_rawexec
from nomad_tpu.client.client import Client as RefClient
from nomad_tpu.client.client import ClientConfig as RefClientConfig
from nomad_tpu.client.client import InProcessRPC as RefRPC
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefServerConfig
from nomad_tpu.structs import consts
from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.server.server import Server, ServerConfig
from _torch_client import processes_with

NODES = (("00000000-0000-4000-8000-00000000000a", "twin-a"),
         ("00000000-0000-4000-8000-00000000000b", "twin-b"))
_EXIT = re.compile(r"exit code (-?\d+)")


def _wait(fn, timeout=60.0, every=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(every)
    return False


def _pin(job, node_class):
    job.constraints = [ref_structs.Constraint(
        ltarget="${node.class}", rtarget=node_class, operand="=")]
    job.datacenters = ["dc1"]
    return job


def _echo_job():
    job = ref_mock.job()
    job.id = "twin-echo"
    job.type = consts.JOB_TYPE_BATCH
    tg = job.task_groups[0]
    tg.count = 2
    task = tg.tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh",
                   "args": ["-c", "echo $NOMAD_ALLOC_NAME"]}
    return _pin(job, "twin-a")


def _mock_service():
    job = ref_mock.job()
    job.id = "twin-svc"
    tg = job.task_groups[0]
    tg.count = 1
    tg.tasks[0].driver = "mock_driver"
    tg.tasks[0].config = {"run_for": "120s"}
    return _pin(job, "twin-b")


def _fails_once():
    """Exits 1 on its first run, then 0: one restart under its policy."""
    job = ref_mock.job()
    job.id = "twin-retry"
    job.type = consts.JOB_TYPE_BATCH
    tg = job.task_groups[0]
    tg.count = 1
    tg.restart_policy = ref_structs.RestartPolicy(
        attempts=2, interval_s=300.0, delay_s=0.05, mode="fail")
    task = tg.tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", (
        'm="$NOMAD_TASK_DIR/ran-once"; '
        'if [ -e "$m" ]; then echo second; exit 0; fi; '
        'touch "$m"; echo first; exit 1')]}
    return _pin(job, "twin-b")


class Side:
    """One package's server and its two clients."""

    def __init__(self, server, client_cls, config_cls, rpc_cls, root):
        self.server = server
        self.server.start()
        self.clients = []
        for node_id, node_class in NODES:
            data = os.path.join(root, node_class)
            c = client_cls(rpc_cls(server), config_cls(
                data_dir=data, node_class=node_class,
                update_batch_interval=0.05), node_id=node_id)
            c.start()
            self.clients.append(c)
        assert _wait(lambda: all(
            (n := self.server.state.snapshot().node_by_id(i)) is not None
            and n.ready() for i, _ in NODES)), "clients never got ready"

    def allocs(self, job_id):
        return {a.name: a for a in self.server.state.snapshot().allocs_by_job(
            "default", job_id)}

    def stdout(self, alloc, task):
        client = next(c for c in self.clients if c.node_id == alloc.node_id)
        base = os.path.join(client.config.data_dir, "allocs", alloc.id,
                            "alloc", "logs", f"{task}.stdout.0")
        with open(base, "rb") as f:
            return f.read()

    def shutdown(self):
        for c in self.clients:
            c.shutdown()
        self.server.shutdown()


def _summary(side, job_id):
    out = {}
    for name, a in side.allocs(job_id).items():
        tasks = {}
        for tname, ts in sorted(a.task_states.items()):
            events = [e.type for e in ts.events]
            exits = [int(m.group(1)) for e in ts.events
                     if (m := _EXIT.search(e.message or ""))]
            tasks[tname] = (ts.state, ts.failed, ts.restarts, events, exits)
        out[name] = (a.node_id, a.client_status, tasks)
    return out


@pytest.fixture()
def sides(tmp_path, monkeypatch):
    start = ref_rawexec.RawExecDriver.start_task

    def start_on_an_empty_status_file(self, config):
        status = os.path.join(config.alloc_dir or "/tmp",
                              f".executor-{config.name}.status")
        if os.path.exists(status):
            os.unlink(status)
        return start(self, config)

    monkeypatch.setattr(ref_rawexec.RawExecDriver, "start_task",
                        start_on_an_empty_status_file)
    ref = Side(RefServer(RefServerConfig(num_workers=1, heartbeat_ttl=30.0)),
               RefClient, RefClientConfig, RefRPC, str(tmp_path / "ref"))
    try:
        port = Side(Server(ServerConfig(num_workers=1, heartbeat_ttl=30.0,
                                        device="cpu")),
                    Client, ClientConfig, InProcessRPC,
                    str(tmp_path / "port"))
    except BaseException:
        ref.shutdown()
        raise
    yield ref, port
    port.shutdown()
    ref.shutdown()


def _register(ref, port, job):
    ref.server.job_register(job)
    port.server.job_register(structs_from_reference(job))


def _all_terminal(side, job_id, n):
    allocs = side.allocs(job_id)
    return len(allocs) == n and all(
        a.client_terminal_status() for a in allocs.values())


def test_client_stacks_run_the_same_jobs_alike(sides):
    ref, port = sides
    echo, svc, retry = _echo_job(), _mock_service(), _fails_once()
    for job in (echo, svc, retry):
        _register(ref, port, job)
    for side in (ref, port):
        assert _wait(lambda: _all_terminal(side, echo.id, 2)
                     and _all_terminal(side, retry.id, 1)), \
            _summary(side, retry.id)
        assert _wait(lambda: [
            a.client_status for a in side.allocs(svc.id).values()]
            == [consts.ALLOC_CLIENT_RUNNING])
    for job in (echo, retry):
        got = _summary(port, job.id)
        assert got == _summary(ref, job.id)
        task = job.task_groups[0].tasks[0].name
        for name, a in ref.allocs(job.id).items():
            assert port.stdout(port.allocs(job.id)[name], task) == \
                ref.stdout(a, task)
    (retry_state,) = _summary(port, retry.id).values()
    node_id, status, tasks = retry_state
    assert status == consts.ALLOC_CLIENT_COMPLETE, retry_state
    assert node_id == NODES[1][0]
    (state, failed, restarts, _, exits), = tasks.values()
    assert (state, failed, restarts, exits) == ("dead", False, 1, [1, 0])
    assert {a.node_id for a in port.allocs(echo.id).values()} == {
        NODES[0][0]}
    assert sorted(port.stdout(a, echo.task_groups[0].tasks[0].name)
                  for a in port.allocs(echo.id).values()) == [
        b"twin-echo.web[0]\n", b"twin-echo.web[1]\n"]

    for side in (ref, port):
        side.server.job_deregister("default", svc.id)
    for side in (ref, port):
        assert _wait(lambda: _all_terminal(side, svc.id, 1))
    assert _summary(port, svc.id) == _summary(ref, svc.id)
    (svc_state,) = _summary(port, svc.id).values()
    assert svc_state[0] == NODES[1][0]
    assert svc_state[1] == consts.ALLOC_CLIENT_COMPLETE
    # the tasks and, once they are stopped, their log collectors end
    assert _wait(lambda: not [
        pid for job in (echo, svc, retry)
        for a in port.allocs(job.id).values()
        for pid in processes_with(a.id)], timeout=15)
