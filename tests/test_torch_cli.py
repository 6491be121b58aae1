"""The port's CLI, on the CPU.

Every scenario of ``tests/test_cli.py`` (the verb tree driven against a
live in-process agent, the reference's command/*_test.go pattern) runs
on the port's ``cli.main`` against an agent built with
``AgentConfig(device="cpu", ...)``. Then the port's own: ``python -m
nomad_tpu_torch agent -server -device cpu -http-port 0`` in a child
process takes a job from ``job run`` and places it, and stops on
SIGTERM with exit 0; ``agent -dev`` and ``agent -client`` exit 1 naming
ROADMAP A.10."""

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


@pytest.mark.parametrize("flag", ["-dev", "-client"])
def test_client_mode_exits_1_naming_a10(flag, capsys):
    assert main(["agent", flag, "-device", "cpu", "-http-port", "0"]) == 1
    assert "ROADMAP A.10" in capsys.readouterr().err
