"""The port's CLI, on the CPU.

Every scenario of ``tests/test_cli.py`` (the verb tree driven against a
live in-process agent, the reference's command/*_test.go pattern) runs
on the port's ``cli.main`` against an agent built with
``AgentConfig(device="cpu", ...)``. Then the port's own: ``python -m
nomad_tpu_torch agent -server -device cpu -http-port 0`` in a child
process takes a job from ``job run`` and places it, and stops on
SIGTERM with exit 0; ``agent -dev -device cpu`` in a child process runs
a raw_exec job from ``job run`` to ``complete``, ``alloc logs`` prints
its output, and SIGTERM ends it with exit 0; ``agent -client`` exits 1
with the reference's message (a client-only agent has no server to
reach in-process)."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.api.codec import encode
from nomad_tpu_torch.cli.main import main
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.utils.snapshot import archive_snapshot
from _torch_client import processes_with

ROOT = Path(__file__).resolve().parents[1]

JOB_HCL = """
job "cli-example" {
  datacenters = ["dc1"]
  type = "service"

  group "web" {
    count = 2

    task "frontend" {
      driver = "mock_driver"
      config {
        run_for = "10s"
      }
      resources {
        cpu    = 500
        memory = 256
      }
    }
  }
}
"""


@pytest.fixture(scope="module")
def agent():
    a = Agent(AgentConfig(device="cpu", name="cli-agent", num_schedulers=1))
    a.start()
    for _ in range(4):
        a.server.node_register(mock.node())
    yield a
    a.shutdown()


@pytest.fixture(scope="module")
def addr(agent):
    return agent.http_addr


@pytest.fixture()
def jobfile(tmp_path):
    p = tmp_path / "example.hcl"
    p.write_text(JOB_HCL)
    return str(p)


def run_cli(addr, *argv):
    return main(["-address", addr, *argv])


class TestJobCommands:
    def test_run_and_status(self, addr, jobfile, capsys):
        rc = run_cli(addr, "job", "run", jobfile)
        out = capsys.readouterr().out
        assert rc == 0, out
        assert 'status "complete"' in out
        assert out.count("Allocation") == 2

        rc = run_cli(addr, "job", "status", "cli-example")
        out = capsys.readouterr().out
        assert rc == 0
        assert "cli-example" in out
        assert "Summary" in out
        assert "Allocations" in out

    def test_job_list(self, addr, capsys):
        rc = run_cli(addr, "job", "status")
        out = capsys.readouterr().out
        assert rc == 0
        assert "cli-example" in out

    def test_plan_detects_change(self, addr, jobfile, capsys):
        # same job, higher count => diff => exit code 1
        changed = JOB_HCL.replace("count = 2", "count = 4")
        p = jobfile + ".changed"
        with open(p, "w") as f:
            f.write(changed)
        rc = run_cli(addr, "job", "plan", p)
        capsys.readouterr()
        assert rc == 1  # non-empty diff

    def test_inspect(self, addr, capsys):
        rc = run_cli(addr, "job", "inspect", "cli-example")
        out = capsys.readouterr().out
        assert rc == 0
        parsed = json.loads(out)
        assert parsed["Job"]["ID"] == "cli-example"

    def test_top_level_run_alias(self, addr, jobfile, capsys):
        rc = run_cli(addr, "run", "-detach", jobfile)
        out = capsys.readouterr().out
        assert rc == 0
        assert "registration successful" in out

    def test_stop(self, addr, capsys):
        rc = run_cli(addr, "job", "stop", "-detach", "-purge", "cli-example")
        capsys.readouterr()
        assert rc == 0
        rc = run_cli(addr, "job", "status", "cli-example")
        err = capsys.readouterr().err
        assert rc == 1
        assert "no jobs match" in err


class TestNodeCommands:
    def test_node_status_list(self, addr, capsys):
        rc = run_cli(addr, "node", "status")
        out = capsys.readouterr().out
        assert rc == 0
        assert "foobar-" in out
        assert "ready" in out

    def test_node_status_one_by_prefix(self, agent, addr, capsys):
        node_id = agent.server.state.snapshot().nodes()[0].id
        rc = run_cli(addr, "node", "status", node_id[:8])
        out = capsys.readouterr().out
        assert rc == 0
        assert node_id in out

    def test_node_eligibility(self, agent, addr, capsys):
        node_id = agent.server.state.snapshot().nodes()[0].id
        rc = run_cli(addr, "node", "eligibility", "-disable", node_id)
        out = capsys.readouterr().out
        assert rc == 0
        assert "ineligible" in out
        rc = run_cli(addr, "node", "eligibility", "-enable", node_id)
        out = capsys.readouterr().out
        assert rc == 0


class TestAllocEvalCommands:
    def test_alloc_and_eval_status(self, agent, addr, jobfile, capsys):
        rc = run_cli(addr, "job", "run", jobfile)
        capsys.readouterr()
        assert rc == 0
        api = APIClient(addr)
        allocs = api.jobs.allocations("cli-example")
        assert allocs
        rc = run_cli(addr, "alloc", "status", allocs[0]["ID"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "cli-example" in out

        rc = run_cli(addr, "eval", "list")
        out = capsys.readouterr().out
        assert rc == 0
        assert "cli-example" in out

        ev_id = allocs[0]["EvalID"]
        rc = run_cli(addr, "eval", "status", ev_id)
        out = capsys.readouterr().out
        assert rc == 0
        assert "complete" in out

    def test_generic_status_resolves_alloc(self, addr, capsys):
        api = APIClient(addr)
        allocs = api.jobs.allocations("cli-example")
        rc = run_cli(addr, "status", allocs[0]["ID"][:8])
        out = capsys.readouterr().out
        assert rc == 0
        assert "Client Status" in out


class TestOperatorCommands:
    def test_scheduler_config(self, addr, capsys):
        rc = run_cli(addr, "operator", "scheduler", "get-config")
        out = capsys.readouterr().out
        assert rc == 0
        assert "binpack" in out
        rc = run_cli(addr, "operator", "scheduler", "set-config",
                     "-scheduler-algorithm", "spread")
        capsys.readouterr()
        assert rc == 0
        rc = run_cli(addr, "operator", "scheduler", "get-config")
        out = capsys.readouterr().out
        assert "spread" in out
        run_cli(addr, "operator", "scheduler", "set-config",
                "-scheduler-algorithm", "binpack")
        capsys.readouterr()

    def test_snapshot_roundtrip(self, addr, tmp_path, capsys):
        snap = str(tmp_path / "state.snap")
        rc = run_cli(addr, "operator", "snapshot", "save", snap)
        out = capsys.readouterr().out
        assert rc == 0
        assert "written" in out
        rc = run_cli(addr, "operator", "snapshot", "restore", snap)
        out = capsys.readouterr().out
        assert rc == 0

    def test_server_members(self, addr, capsys):
        rc = run_cli(addr, "server", "members")
        out = capsys.readouterr().out
        assert rc == 0
        assert "cli-agent" in out


class TestMiscCommands:
    def test_namespace_lifecycle(self, addr, capsys):
        rc = run_cli(addr, "namespace", "apply", "ns-test",
                     "-description", "x")
        capsys.readouterr()
        assert rc == 0
        rc = run_cli(addr, "namespace", "list")
        out = capsys.readouterr().out
        assert "ns-test" in out
        rc = run_cli(addr, "namespace", "delete", "ns-test")
        capsys.readouterr()
        assert rc == 0

    def test_system_gc(self, addr, capsys):
        assert run_cli(addr, "system", "gc") == 0
        capsys.readouterr()

    def test_version(self, addr, capsys):
        assert run_cli(addr, "version") == 0
        assert "nomad-tpu" in capsys.readouterr().out

    def test_dispatch(self, agent, addr, capsys):
        from nomad_tpu_torch.structs.job import ParameterizedJobConfig

        job = mock.simple_job()
        job.parameterized = ParameterizedJobConfig(meta_required=["input"])
        api = APIClient(addr)
        api.jobs.register(encode(job))
        rc = run_cli(addr, "job", "dispatch", "-detach",
                     "-meta", "input=x", job.id)
        out = capsys.readouterr().out
        assert rc == 0
        assert "Dispatched Job ID" in out


# ---------------------------------------------------------------------------
# What the port adds
# ---------------------------------------------------------------------------

def test_agent_process_on_the_cpu_places_a_cli_job(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch", "agent", "-server",
         "-device", "cpu", "-http-port", "0", "-name", "cpu-agent"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT), env=env)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        addr, deadline = "", time.time() + 120
        while not addr and time.time() < deadline:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if "HTTP at " in line:
                addr = line.split("HTTP at ", 1)[1].strip()
        assert addr, "the agent printed no address in 120 s"
        api = APIClient(addr)
        # a server-only agent learns of nodes from clients; here they
        # come as an operator snapshot of a store that holds four
        store = StateStore()
        for _ in range(4):
            store.upsert_node(mock.node())
        api.operator.snapshot_restore(
            archive_snapshot(SimpleNamespace(state=store, raft=None)))
        jobfile = tmp_path / "example.hcl"
        jobfile.write_text(JOB_HCL)
        r = subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch", "-address", addr,
             "job", "run", str(jobfile)],
            capture_output=True, text=True, cwd=str(ROOT), env=env,
            timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        allocs = api.jobs.allocations("cli-example")
        assert len(allocs) == 2
        assert {a["NodeID"] for a in allocs} <= {
            n["ID"] for n in api.nodes.list()}
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
    assert rc == 0


ECHO_HCL = """
job "cli-echo" {
  datacenters = ["dc1"]
  type = "batch"

  group "echo" {
    task "say" {
      driver = "raw_exec"
      config {
        command = "/bin/sh"
        args    = ["-c", "echo cli-echo-ran"]
      }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""


def test_dev_agent_process_runs_a_cli_job_and_serves_its_log(tmp_path):
    """``agent -dev`` is server and client in one process: a job from
    ``job run`` runs to ``complete`` on its node, in a dir under the
    agent's own temp dir, ``alloc logs`` prints the task's output, and
    SIGTERM ends the agent with exit 0."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "TMPDIR": str(tmp)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch", "agent", "-dev",
         "-device", "cpu", "-http-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT), env=env)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    alloc_ids = []
    try:
        addr, deadline = "", time.time() + 120
        while not addr and time.time() < deadline:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if "HTTP at " in line:
                addr = line.split("HTTP at ", 1)[1].strip()
        assert addr, "the agent printed no address in 120 s"
        api = APIClient(addr)
        jobfile = tmp_path / "echo.hcl"
        jobfile.write_text(ECHO_HCL)

        def cli(*argv):
            return subprocess.run(
                [sys.executable, "-m", "nomad_tpu_torch", "-address", addr,
                 *argv], capture_output=True, text=True, cwd=str(ROOT),
                env=env, timeout=120)

        r = cli("job", "run", str(jobfile))
        assert r.returncode == 0, r.stdout + r.stderr
        deadline = time.time() + 60
        while time.time() < deadline and [
                a["ClientStatus"] for a in api.jobs.allocations("cli-echo")
        ] != ["complete"]:
            time.sleep(0.1)
        (alloc,) = api.jobs.allocations("cli-echo")
        alloc_ids.append(alloc["ID"])
        assert alloc["ClientStatus"] == "complete"
        assert (tmp / "nomad-tpu-client" / "allocs" / alloc["ID"]).is_dir()
        (node,) = api.nodes.list()
        assert alloc["NodeID"] == node["ID"]
        r = cli("alloc", "logs", alloc["ID"], "say")
        assert r.returncode == 0, r.stderr
        assert r.stdout == "cli-echo-ran\n"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
    assert rc == 0
    # neither the task nor its log collectors outlive the agent
    deadline = time.time() + 15
    while [pid for alloc_id in alloc_ids
           for pid in processes_with(alloc_id)]:
        assert time.time() < deadline, "task processes left"
        time.sleep(0.1)


def test_client_only_agent_exits_1_with_the_references_message(capsys):
    assert main(["agent", "-client", "-device", "cpu", "-http-port",
                 "0"]) == 1
    assert "client-only agents need a server address" in (
        capsys.readouterr().err)
