"""Every scenario of ``tests/test_client_endpoints.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Client HTTP endpoint tests: fs, logs, exec, restart, signal.

Modeled on reference client/fs_endpoint_test.go,
client/alloc_endpoint_test.go, and the server->node pass-through
(nomad/client_fs_endpoint.go forwarding).
"""

import time

import pytest

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient, APIError
from _torch_client import port_bridge  # noqa: F401


def wait_for(fn, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError(f"timeout waiting for {msg}")


def run_job(agent, api, run_for=30, driver="mock_driver", config=None):
    job = mock.job()
    job.task_groups[0].count = 1
    task = job.task_groups[0].tasks[0]
    task.driver = driver
    task.config = config if config is not None else {"run_for": run_for}
    agent.server.job_register(job)
    allocs = wait_for(
        lambda: [a for a in api.jobs.allocations(job.id)
                 if a["ClientStatus"] == "running"],
        msg="alloc running",
    )
    return job, allocs[0]


class TestFS:
    def setup_method(self):
        self.agent = Agent(AgentConfig.dev(device="cpu"))
        self.agent.start()
        self.api = APIClient(self.agent.http_addr)

    def teardown_method(self):
        self.agent.shutdown()

    def test_logs_ls_stat_cat(self):
        # raw_exec task that writes to stdout then sleeps
        job, alloc = run_job(
            self.agent, self.api, driver="raw_exec",
            config={"command": "/bin/sh",
                    "args": ["-c", "echo hello-from-task; sleep 30"]},
        )
        aid = alloc["ID"]
        wait_for(lambda: "hello-from-task" in
                 self.api.allocations.logs(aid, "web"), msg="stdout logged")

        entries = self.api.allocations.fs_ls(aid, "/")
        names = {e["Name"] for e in entries}
        assert "alloc" in names and "web" in names

        st = self.api.allocations.fs_stat(aid, "alloc/logs")
        assert st["IsDir"]

        data = self.api.allocations.fs_cat(aid, "alloc/logs/web.stdout.0")
        assert "hello-from-task" in data

    def test_path_escape_rejected(self):
        job, alloc = run_job(self.agent, self.api)
        with pytest.raises(APIError) as e:
            self.api.allocations.fs_cat(alloc["ID"], "../../../etc/passwd")
        assert e.value.status in (403, 404)

    def test_secrets_dir_denied(self):
        job, alloc = run_job(self.agent, self.api)
        with pytest.raises(APIError) as e:
            self.api.allocations.fs_ls(alloc["ID"], "web/secrets")
        assert e.value.status == 403

    def test_restart_unknown_task_404(self):
        job, alloc = run_job(self.agent, self.api)
        with pytest.raises(APIError) as e:
            self.api.allocations.restart(alloc["ID"], "nope")
        assert e.value.status == 404

    def test_exec(self):
        job, alloc = run_job(
            self.agent, self.api, driver="raw_exec",
            config={"command": "/bin/sleep", "args": ["30"]},
        )
        out = self.api.allocations.exec(alloc["ID"], "web",
                                        ["/bin/echo", "exec-ok"])
        assert "exec-ok" in out["stdout"]
        assert out["exit_code"] == 0

    def test_restart_bounces_task(self):
        job, alloc = run_job(
            self.agent, self.api, driver="raw_exec",
            config={"command": "/bin/sleep", "args": ["30"]},
        )
        aid = alloc["ID"]
        self.api.allocations.restart(aid)

        def restarted():
            info = self.api.allocations.info(aid)
            events = info["TaskStates"]["web"]["Events"]
            types = [e["Type"] for e in events]
            return types.count("Started") >= 2 and \
                info["ClientStatus"] == "running"
        wait_for(restarted, msg="task restarted")

    def test_signal_kills_process(self):
        job, alloc = run_job(
            self.agent, self.api, driver="raw_exec",
            config={"command": "/bin/sleep", "args": ["30"]},
        )
        self.api.allocations.signal(alloc["ID"], "SIGKILL")

        def saw_exit():
            info = self.api.allocations.info(alloc["ID"])
            events = info["TaskStates"]["web"]["Events"]
            return any(e["Type"] in ("Terminated", "Restarting")
                       for e in events)
        wait_for(saw_exit, msg="task terminated by signal")


class TestPassThrough:
    def test_server_only_agent_proxies_to_node(self):
        dev = Agent(AgentConfig.dev(device="cpu"))
        dev.start()
        srv = Agent(AgentConfig(device="cpu", name="hub", num_schedulers=0))
        srv.start()
        try:
            api = APIClient(dev.http_addr)
            job, alloc = run_job(
                dev, api, driver="raw_exec",
                config={"command": "/bin/sh",
                        "args": ["-c", "echo proxied-log; sleep 30"]},
            )
            # teach the hub about the node + alloc (in a full multi-host
            # deployment registration would do this)
            node = dev.client.node
            srv.server.state.upsert_node(node.copy())
            full = dev.server.state.snapshot().alloc_by_id(alloc["ID"])
            srv.server.state.upsert_allocs([full.copy_skip_job()])

            hub_api = APIClient(srv.http_addr)
            log = wait_for(
                lambda: hub_api.allocations.logs(alloc["ID"], "web"),
                msg="proxied logs",
            )
            assert "proxied-log" in log
            with pytest.raises(APIError):
                hub_api.allocations.logs("nonexistent-alloc", "web")
        finally:
            dev.shutdown()
            srv.shutdown()


class TestInteractiveExec:
    """Streaming exec over the websocket (api/allocations_exec.go,
    driver.proto:79 ExecTaskStreaming): stdin and stdout both ways."""

    def setup_method(self):
        self.agent = Agent(AgentConfig.dev(device="cpu"))
        self.agent.start()
        self.api = APIClient(self.agent.http_addr)

    def teardown_method(self):
        self.agent.shutdown()

    def _running_alloc(self):
        job, alloc = run_job(
            self.agent, self.api, driver="raw_exec",
            config={"command": "/bin/sh", "args": ["-c", "sleep 30"]},
        )
        return alloc["ID"]

    def test_bidirectional_stream(self):
        aid = self._running_alloc()
        session = self.api.allocations.exec_stream(aid, "web", ["cat"])
        session.send_stdin(b"ping-1\n")
        session.send_stdin(b"ping-2\n")
        session.close_stdin()
        got = b""
        for frame in session.events():
            blob = frame.get("stdout") or {}
            if blob.get("bytes"):
                got += blob["bytes"]
        assert b"ping-1" in got and b"ping-2" in got
        assert session.exit_code == 0

    def test_exit_code_propagates(self):
        aid = self._running_alloc()
        session = self.api.allocations.exec_stream(
            aid, "web", ["/bin/sh", "-c", "echo out; echo err >&2; exit 7"])
        out, err = b"", b""
        for frame in session.events():
            if (frame.get("stdout") or {}).get("bytes"):
                out += frame["stdout"]["bytes"]
            if (frame.get("stderr") or {}).get("bytes"):
                err += frame["stderr"]["bytes"]
        assert b"out" in out
        assert b"err" in err
        assert session.exit_code == 7

    def test_tty_session(self):
        aid = self._running_alloc()
        session = self.api.allocations.exec_stream(
            aid, "web", ["/bin/sh"], tty=True)
        session.resize(24, 80)
        session.send_stdin(b"echo tty-$((40+2))\n")
        session.send_stdin(b"exit\n")
        got = b""
        for frame in session.events():
            blob = frame.get("stdout") or {}
            if blob.get("bytes"):
                got += blob["bytes"]
        assert b"tty-42" in got
        assert session.exit_code == 0

    def test_server_forwards_exec_to_node(self):
        """A server-only agent tunnels the exec websocket to the node
        running the alloc (rpc.go:708 NodeStreamingRpc analog)."""
        dev = Agent(AgentConfig.dev(device="cpu"))
        dev.start()
        srv = Agent(AgentConfig(device="cpu", name="hub", num_schedulers=0))
        srv.start()
        try:
            api_dev = APIClient(dev.http_addr)
            job, alloc = run_job(
                dev, api_dev, driver="raw_exec",
                config={"command": "/bin/sh", "args": ["-c", "sleep 30"]},
            )
            # teach the hub about the node + alloc (multi-host
            # registration would do this in a real deployment)
            srv.server.state.upsert_node(dev.client.node.copy())
            full = dev.server.state.snapshot().alloc_by_id(alloc["ID"])
            srv.server.state.upsert_allocs([full.copy_skip_job()])

            hub_api = APIClient(srv.http_addr)
            session = hub_api.allocations.exec_stream(
                alloc["ID"], "web", ["cat"])
            session.send_stdin(b"through-the-tunnel\n")
            session.close_stdin()
            got = b""
            for frame in session.events():
                blob = frame.get("stdout") or {}
                if blob.get("bytes"):
                    got += blob["bytes"]
            assert b"through-the-tunnel" in got
            assert session.exit_code == 0
        finally:
            srv.shutdown()
            dev.shutdown()
