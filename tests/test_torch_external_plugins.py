"""Every scenario of ``tests/test_external_plugins.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Out-of-process driver plugin tests.

Modeled on reference plugins/drivers tests + go-plugin lifecycle
coverage: handshake, RPC roundtrip through a real subprocess, plugin
directory loading, crash handling, and a job running end-to-end on an
external driver.
"""

import os
import shutil
import sys
import time

import pytest

import nomad_tpu_torch.plugins.demo_sleep_driver as demo_mod
from nomad_tpu_torch import mock
from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.plugins.drivers import HEALTH_HEALTHY, HEALTH_UNHEALTHY
from nomad_tpu_torch.plugins.external import (
    ExternalDriver,
    PluginCrashed,
    load_plugin_dir,
)
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from _torch_client import port_bridge  # noqa: F401

ARGV = [sys.executable, "-m", "nomad_tpu_torch.plugins.demo_sleep_driver"]


def _wait(fn, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture()
def driver():
    drv = ExternalDriver(ARGV)
    yield drv
    drv.shutdown()


class TestProtocol:
    def test_handshake_and_info(self, driver):
        assert driver.name == "sleep"
        info = driver.plugin_info()
        assert info.name == "sleep" and info.type == "driver"
        fp = driver.fingerprint()
        assert fp.health == HEALTH_HEALTHY
        assert fp.attributes["driver.sleep"] == "1"

    def test_task_lifecycle_through_subprocess(self, driver):
        from nomad_tpu_torch.plugins.drivers import TaskConfig

        cfg = TaskConfig(id="t1", name="t",
                         driver_config={"duration": "0.2s"})
        handle = driver.start_task(cfg)
        assert handle.driver == "sleep"
        assert handle.driver_state["pid"] > 0
        status = driver.inspect_task("t1")
        assert status.state in ("running", "exited")
        res = driver.wait_task("t1", timeout=10)
        assert res is not None and res.successful()
        driver.destroy_task("t1")

    def test_exit_code_propagates(self, driver):
        from nomad_tpu_torch.plugins.drivers import TaskConfig

        driver.start_task(TaskConfig(
            id="t2", driver_config={"duration": "0.05s", "exit_code": 3}))
        res = driver.wait_task("t2", timeout=10)
        assert res.exit_code == 3 and not res.successful()

    def test_errors_cross_the_boundary(self, driver):
        # KeyError crosses typed: task_runner's force-destroyed
        # contract (task_runner.py wait loop) depends on it
        with pytest.raises(KeyError):
            driver.wait_task("no-such-task", timeout=1)

    def test_nested_dataclasses_survive_roundtrip(self, driver):
        from nomad_tpu_torch.plugins.drivers import TaskConfig

        cfg = TaskConfig(id="t9", driver_config={"duration": "0.05s"})
        handle = driver.start_task(cfg)
        assert isinstance(handle.config, TaskConfig)
        assert handle.config.id == "t9"
        driver.wait_task("t9", timeout=10)
        status = driver.inspect_task("t9")
        assert status.exit_result is not None
        assert status.exit_result.successful()

    def test_crash_detected(self, driver):
        driver._proc.kill()
        driver._proc.wait()
        fp = driver.fingerprint()
        assert fp.health == HEALTH_UNHEALTHY
        with pytest.raises(PluginCrashed):
            driver.plugin_info()


class TestPluginDir:
    def test_load_plugin_dir(self, tmp_path):
        shutil.copy(demo_mod.__file__, tmp_path / "sleep_plugin.py")
        (tmp_path / "notes.txt").write_text("not a plugin")
        drivers = load_plugin_dir(str(tmp_path))
        try:
            assert list(drivers) == ["sleep"]   # handshake name wins
            assert drivers["sleep"].fingerprint().health == HEALTH_HEALTHY
        finally:
            for d in drivers.values():
                d.shutdown()

    def test_bad_plugin_skipped(self, tmp_path):
        (tmp_path / "broken.py").write_text("print('not a handshake')\n")
        assert load_plugin_dir(str(tmp_path)) == {}


class TestEndToEnd:
    def test_job_runs_on_external_driver(self, tmp_path):
        plugin_dir = tmp_path / "plugins"
        plugin_dir.mkdir()
        shutil.copy(demo_mod.__file__, plugin_dir / "sleep_plugin.py")
        server = Server(ServerConfig(device="cpu", num_workers=1))
        server.start()
        client = Client(
            InProcessRPC(server),
            ClientConfig(data_dir=str(tmp_path / "data"),
                         plugin_dir=str(plugin_dir)),
        )
        client.start()
        try:
            # the external driver fingerprints onto the node
            assert "sleep" in client.drivers
            job = mock.job()
            job.type = consts.JOB_TYPE_BATCH
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "sleep"
            task.config = {"duration": "0.3s"}
            server.job_register(job)
            assert _wait(lambda: any(
                a.client_status == consts.ALLOC_CLIENT_COMPLETE
                for a in server.state.snapshot().allocs_by_job(
                    job.namespace, job.id))), "task never completed"
        finally:
            client.shutdown()
            server.shutdown()
