"""Every scenario of ``tests/test_client_hardening.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Client hardening tests: logmon rotation, heartbeatstop,
allocwatcher, agent config files.

Modeled on reference client/logmon tests (rotation), heartbeatstop.go
tests (self-stop on disconnect), allocwatcher/alloc_watcher_test.go
(prev-alloc wait + disk migration), and command/agent/config_parse
tests.
"""

import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api.config_file import load_config_files
from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.client.logmon import LogMon, read_rotated, rotated_files
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.job import EphemeralDisk
from _torch_client import port_bridge  # noqa: F401


def _wait(fn, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


class TestLogMon:
    def test_collects_and_rotates(self, tmp_path):
        import threading

        from nomad_tpu_torch.client.logmon import _Collector

        base = str(tmp_path / "web.stdout")
        collector = _Collector(base, max_files=3, max_file_size_mb=1)
        collector.max_bytes = 100   # tiny rotation threshold for the test
        collector.open()
        t = threading.Thread(target=collector.run, daemon=True)
        t.start()
        try:
            fd = os.open(collector.fifo_path, os.O_WRONLY)
            for i in range(20):
                os.write(fd, f"line-{i:04d} ".encode() * 4)
            os.close(fd)
            assert _wait(lambda: len(rotated_files(base)) >= 2)
        finally:
            collector.request_stop()
            t.join(timeout=3)
        files = rotated_files(base)
        assert 2 <= len(files) <= 3          # pruned to max_files
        data = read_rotated(base)
        assert b"line-0019" in data

    def test_read_rotated_offset_limit(self, tmp_path):
        base = str(tmp_path / "t.stdout")
        for i, content in enumerate([b"aaaa", b"bbbb", b"cccc"]):
            with open(f"{base}.{i}", "wb") as f:
                f.write(content)
        assert read_rotated(base) == b"aaaabbbbcccc"
        assert read_rotated(base, offset=2) == b"aabbbbcccc"
        assert read_rotated(base, offset=5, limit=4) == b"bbbc"

    def test_task_logs_end_to_end(self, tmp_path):
        """rawexec output travels fifo -> logmon -> rotated file ->
        fs logs API."""
        server = Server(ServerConfig(device="cpu", num_workers=1))
        server.start()
        client = Client(InProcessRPC(server),
                        ClientConfig(data_dir=str(tmp_path)))
        client.start()
        try:
            job = mock.job()
            job.type = consts.JOB_TYPE_BATCH
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "raw_exec"
            task.config = {"command": "/bin/sh",
                           "args": ["-c", "echo logmon-works"]}
            server.job_register(job)
            assert _wait(lambda: any(
                ar.is_done() for ar in client.allocs.values()
                if ar.alloc.job_id == job.id), timeout=30)
            ar = next(a for a in client.allocs.values()
                      if a.alloc.job_id == job.id)
            assert _wait(lambda: "logmon-works" in
                         ar.task_logs(task.name, "stdout"))
        finally:
            client.shutdown()
            server.shutdown()


class TestHeartbeatStop:
    def test_alloc_stopped_after_disconnect(self, tmp_path):
        server = Server(ServerConfig(device="cpu", num_workers=1))
        server.start()
        client = Client(InProcessRPC(server),
                        ClientConfig(data_dir=str(tmp_path)))
        client.start()
        try:
            job = mock.job()
            job.task_groups[0].count = 1
            job.task_groups[0].stop_after_client_disconnect_s = 0.2
            task = job.task_groups[0].tasks[0]
            task.driver = "mock_driver"
            task.config = {"run_for": "120s"}
            server.job_register(job)
            assert _wait(lambda: any(
                tr.task_state.state == "running"
                for ar in client.allocs.values()
                for tr in ar.task_runners.values()), timeout=30)
            # sever the transport: every heartbeat now fails
            def broken(*a, **k):
                raise ConnectionError("network partition")
            client.rpc.update_status = broken
            client.rpc.register_node = broken
            client.last_heartbeat_ok = time.time() - 1.0
            client.heartbeat_ttl = 0.2   # speed the loop up
            ar = next(iter(client.allocs.values()))
            assert _wait(ar.is_done, timeout=15), \
                "alloc not self-stopped after disconnect"
        finally:
            client.shutdown()
            server.shutdown()


class TestAllocWatcher:
    def test_waits_for_previous_and_migrates_disk(self, tmp_path):
        server = Server(ServerConfig(device="cpu", num_workers=1))
        server.start()
        client = Client(InProcessRPC(server),
                        ClientConfig(data_dir=str(tmp_path)))
        client.start()
        try:
            job = mock.job()
            job.task_groups[0].count = 1
            job.task_groups[0].ephemeral_disk = EphemeralDisk(
                sticky=True, migrate=True)
            task = job.task_groups[0].tasks[0]
            task.driver = "mock_driver"
            task.config = {"run_for": "60s"}
            server.job_register(job)
            assert _wait(lambda: any(
                tr.task_state.state == "running"
                for ar in client.allocs.values()
                for tr in ar.task_runners.values()), timeout=30)
            old = next(iter(client.allocs.values()))
            # leave a data file in the shared alloc dir
            marker = os.path.join(old.alloc_dir, "alloc", "data.txt")
            os.makedirs(os.path.dirname(marker), exist_ok=True)
            with open(marker, "w") as f:
                f.write("precious")

            # destructive update -> replacement alloc with
            # previous_allocation pointing at the old one
            job2 = job.copy()
            job2.version = 1
            job2.task_groups[0].tasks[0].env = {"NEW": "1"}
            server.job_register(job2)

            def replacement():
                return next(
                    (a for a in client.allocs.values()
                     if a.alloc.id != old.alloc.id
                     and a.alloc.job_id == job.id), None)
            assert _wait(lambda: replacement() is not None, timeout=30)
            new = replacement()
            assert new.alloc.previous_allocation == old.alloc.id
            assert _wait(lambda: any(
                tr.task_state.state == "running"
                for tr in new.task_runners.values()), timeout=30)
            migrated = os.path.join(new.alloc_dir, "alloc", "data.txt")
            assert _wait(lambda: os.path.exists(migrated)), \
                "ephemeral disk not migrated"
            with open(migrated) as f:
                assert f.read() == "precious"
        finally:
            client.shutdown()
            server.shutdown()


class TestLogMonResume:
    def test_resumes_at_highest_index(self, tmp_path):
        """Agent restart must not interleave new output into old
        rotated files (rotation logic lives in the collector)."""
        import threading

        from nomad_tpu_torch.client.logmon import _Collector

        base = str(tmp_path / "t.stdout")
        with open(f"{base}.0", "wb") as f:
            f.write(b"x" * 200)
        with open(f"{base}.1", "wb") as f:
            f.write(b"y" * 200)
        collector = _Collector(base, max_files=5, max_file_size_mb=1)
        collector.max_bytes = 100
        collector.open()
        t = threading.Thread(target=collector.run, daemon=True)
        t.start()
        try:
            # .1 is already over the threshold -> resumed at .2
            assert collector._idx == 2
            fd = os.open(collector.fifo_path, os.O_WRONLY)
            os.write(fd, b"fresh")
            os.close(fd)
            assert _wait(lambda: os.path.exists(f"{base}.2")
                         and b"fresh" in open(f"{base}.2", "rb").read())
        finally:
            collector.request_stop()
            t.join(timeout=3)
        assert open(f"{base}.0", "rb").read() == b"x" * 200
        assert open(f"{base}.1", "rb").read() == b"y" * 200


class TestAllocWatcherRaces:
    def test_stop_during_wait_prevents_task_start(self, tmp_path):
        """An alloc stopped while awaiting its predecessor must never
        start tasks."""
        from nomad_tpu_torch.client.alloc_runner import AllocRunner
        from nomad_tpu_torch.drivers import builtin_drivers
        import threading

        job = mock.job()
        job.task_groups[0].count = 1
        old_alloc = mock.alloc(job=job)
        new_alloc = mock.alloc(job=job)
        new_alloc.previous_allocation = old_alloc.id

        old_runner = AllocRunner(
            alloc=old_alloc, drivers=builtin_drivers(),
            data_dir=str(tmp_path), on_alloc_update=lambda a: None)
        # predecessor never started -> _tasks_started False -> waiter
        # blocks until the successor is stopped
        new_runner = AllocRunner(
            alloc=new_alloc, drivers=builtin_drivers(),
            data_dir=str(tmp_path), on_alloc_update=lambda a: None,
            prev_lookup={old_alloc.id: old_runner}.get)
        t = threading.Thread(target=new_runner.run, daemon=True)
        t.start()
        time.sleep(0.3)
        assert new_runner.task_runners == {}    # still waiting
        new_runner.stop("test stop")
        t.join(timeout=5)
        assert not t.is_alive()
        assert new_runner.task_runners == {}    # never started


class TestAgentConfigFile:
    def test_hcl_config_merge(self, tmp_path):
        (tmp_path / "base.hcl").write_text('''
        name       = "cfg-agent"
        region     = "eu"
        datacenter = "dc9"
        ports { http = 5757 }
        server {
          enabled        = true
          num_schedulers = 3
        }
        client {
          enabled    = true
          node_class = "compute"
          meta { rack = "r4" }
        }
        acl { enabled = true }
        ''')
        (tmp_path / "override.hcl").write_text('region = "ap"')
        cfg = load_config_files([str(tmp_path / "base.hcl"),
                                 str(tmp_path / "override.hcl")])
        assert cfg.name == "cfg-agent"
        assert cfg.region == "ap"            # later file wins
        assert cfg.datacenter == "dc9"
        assert cfg.http_port == 5757
        assert cfg.server_enabled and cfg.client_enabled
        assert cfg.num_schedulers == 3
        assert cfg.node_class == "compute"
        assert cfg.meta == {"rack": "r4"}
        assert cfg.acl_enabled

    def test_json_config_and_directory(self, tmp_path):
        d = tmp_path / "conf.d"
        d.mkdir()
        (d / "01.json").write_text(
            '{"name": "j-agent", "server": {"enabled": true}}')
        (d / "02.hcl").write_text('datacenter = "dcj"')
        cfg = load_config_files([str(d)])
        assert cfg.name == "j-agent"
        assert cfg.server_enabled
        assert cfg.datacenter == "dcj"

    def test_tls_block(self, tmp_path):
        (tmp_path / "tls.hcl").write_text('''
        tls {
          http      = true
          ca_file   = "ca.pem"
          cert_file = "cert.pem"
          key_file  = "key.pem"
          verify_https_client = true
        }
        ''')
        cfg = load_config_files([str(tmp_path / "tls.hcl")])
        assert cfg.tls is not None and cfg.tls.enabled
        assert cfg.tls.verify_https_client
        assert cfg.tls.cert_file == "cert.pem"


class TestTemplateSandbox:
    """template.go:572-601 escapingfs sandbox (CVE-2022-24683 class):
    jobspec-controlled template paths must not escape the task dir."""

    def test_dest_escape_rejected(self, tmp_path):
        from nomad_tpu_torch.client.task_runner import TaskRunner

        task_dir = tmp_path / "task"
        task_dir.mkdir()
        with pytest.raises(PermissionError):
            TaskRunner._sandboxed_path(str(task_dir), "../../etc/cron.d/x")

    def test_symlink_escape_rejected(self, tmp_path):
        from nomad_tpu_torch.client.task_runner import TaskRunner

        task_dir = tmp_path / "task"
        (task_dir / "local").mkdir(parents=True)
        (task_dir / "local" / "link").symlink_to("/etc")
        with pytest.raises(PermissionError):
            TaskRunner._sandboxed_path(str(task_dir), "local/link/passwd")

    def test_normal_paths_allowed(self, tmp_path):
        from nomad_tpu_torch.client.task_runner import TaskRunner

        task_dir = tmp_path / "task"
        task_dir.mkdir()
        got = TaskRunner._sandboxed_path(str(task_dir), "local/config.txt")
        assert got == os.path.realpath(
            os.path.join(str(task_dir), "local/config.txt"))
        # absolute jobspec paths are re-rooted, not trusted
        got = TaskRunner._sandboxed_path(str(task_dir), "/secrets/creds")
        assert got.startswith(os.path.realpath(str(task_dir)))

    def test_shared_alloc_dir_allowed(self, tmp_path):
        """The sandbox root is the alloc dir, so templates may target
        the shared ../alloc dir (reference alloc-dir escapingfs root)."""
        from nomad_tpu_torch.client.task_runner import TaskRunner

        task_dir = tmp_path / "task"
        (tmp_path / "alloc").mkdir()
        task_dir.mkdir()
        got = TaskRunner._sandboxed_path(
            str(task_dir), "../alloc/data/config.json")
        assert got == os.path.realpath(
            os.path.join(str(tmp_path), "alloc/data/config.json"))
