"""Device Reserve wiring: scheduler-assigned devices reach the task
as plugin-provided env (device.proto Reserve -> container env), the
path GPUs use to become visible to workloads.

The scenario of ``tests/test_device_reserve.py`` on the port's modules,
then the port's ``CudaDevicePlugin`` with ``torch.cuda`` patched where a
card is needed: no card reports no device, two cards give one
``nvidia/gpu`` group and ``CUDA_VISIBLE_DEVICES``, an error while a card
is present propagates, and a reserved card reaches the task.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DEVICE, PluginInfo
from nomad_tpu_torch.plugins.device import (
    CudaDevicePlugin,
    DevicePlugin,
    ReservationResponse,
)
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.resources import NodeDeviceResource, RequestedDevice
from _torch_client import port_bridge  # noqa: F401


class FakeGpuPlugin(DevicePlugin):
    def __init__(self):
        self.reserved = []

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name="gpu", type=PLUGIN_TYPE_DEVICE)

    def fingerprint(self):
        return [NodeDeviceResource(
            vendor="acme", type="gpu", name="a100",
            instance_ids=["gpu-0", "gpu-1"],
        )]

    def reserve(self, device_ids):
        self.reserved.append(list(device_ids))
        visible = ",".join(i.split("-")[-1] for i in device_ids)
        return ReservationResponse(
            container_res={"ACME_VISIBLE_DEVICES": visible})


def _wait(fn, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


class TestDeviceReserve:
    def test_assigned_devices_surface_as_env(self, tmp_path):
        plugin = FakeGpuPlugin()
        server = Server(ServerConfig(device="cpu", num_workers=1))
        server.start()
        client = Client(
            InProcessRPC(server),
            ClientConfig(data_dir=str(tmp_path)),
            device_plugins=[plugin],
        )
        client.start()
        try:
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "mock_driver"
            task.config = {"run_for": "30s"}
            task.resources.devices = [
                RequestedDevice(name="acme/gpu", count=1)]
            server.job_register(job)
            assert _wait(lambda: any(
                tr.task_state.state == "running"
                for ar in client.allocs.values()
                for tr in ar.task_runners.values())), "task never ran"
            assert plugin.reserved, "plugin.reserve never called"
            tr = next(tr for ar in client.allocs.values()
                      for tr in ar.task_runners.values())
            env = tr._task_config().env
            assert env.get("ACME_VISIBLE_DEVICES") in ("0", "1"), env
        finally:
            client.shutdown()
            server.shutdown()


# ---------------------------------------------------------------------------
# What the port adds: the CUDA device plugin
# ---------------------------------------------------------------------------

def _cards(monkeypatch, count, name="NVIDIA H100 80GB HBM3"):
    """``torch.cuda`` reporting ``count`` cards of ``name``."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index=0: name)


class TestCudaDevicePlugin:
    def test_no_card_no_device(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        plugin = CudaDevicePlugin()
        assert plugin.plugin_info() == PluginInfo(
            name="nvidia", type=PLUGIN_TYPE_DEVICE)
        assert plugin.fingerprint() == []

    def test_two_cards_fingerprint_and_reserve(self, monkeypatch):
        _cards(monkeypatch, 2)
        plugin = CudaDevicePlugin()
        assert plugin.fingerprint() == [NodeDeviceResource(
            vendor="nvidia", type="gpu", name="NVIDIA H100 80GB HBM3",
            instance_ids=["gpu-0", "gpu-1"],
            attributes={"platform": "cuda", "count": "2"})]
        assert plugin.reserve(["gpu-1"]).container_res == {
            "CUDA_VISIBLE_DEVICES": "1"}
        assert plugin.reserve(["gpu-0", "gpu-1"]).container_res == {
            "CUDA_VISIBLE_DEVICES": "0,1"}

    def test_an_error_while_a_card_is_present_propagates(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

        def broken():
            raise RuntimeError("CUDA driver initialization failed")

        monkeypatch.setattr(torch.cuda, "device_count", broken)
        with pytest.raises(RuntimeError, match="initialization failed"):
            CudaDevicePlugin().fingerprint()

    def test_reserved_card_reaches_the_task(self, monkeypatch, tmp_path):
        """A job asking ``nvidia/gpu`` lands on the node the plugin
        fingerprinted, and its task sees the card as
        ``CUDA_VISIBLE_DEVICES``."""
        _cards(monkeypatch, 2)
        server = Server(ServerConfig(device="cpu", num_workers=1))
        server.start()
        client = Client(InProcessRPC(server),
                        ClientConfig(data_dir=str(tmp_path)),
                        device_plugins=[CudaDevicePlugin()])
        client.start()
        try:
            (group,) = client.node.node_resources.devices
            assert (group.vendor, group.type, group.name) == (
                "nvidia", "gpu", "NVIDIA H100 80GB HBM3")
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "mock_driver"
            task.config = {"run_for": "30s"}
            task.resources.devices = [
                RequestedDevice(name="nvidia/gpu", count=1)]
            server.job_register(job)
            assert _wait(lambda: any(
                tr.task_state.state == "running"
                for ar in client.allocs.values()
                for tr in ar.task_runners.values())), "task never ran"
            tr = next(tr for ar in client.allocs.values()
                      for tr in ar.task_runners.values())
            assert tr._task_config().env.get("CUDA_VISIBLE_DEVICES") in (
                "0", "1")
            server.job_deregister(job.namespace, job.id)
        finally:
            client.shutdown()
            server.shutdown()
