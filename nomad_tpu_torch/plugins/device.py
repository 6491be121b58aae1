"""Device plugin API: where accelerators surface as schedulable resources.

Reference behavior: plugins/device/device.go:25 ``DevicePlugin`` --
Fingerprint (stream of device groups with attributes), Reserve(ids) ->
container env/mounts/devices, Stats (stream). This is the path by which
GPUs become ``NodeDeviceResource``s the scheduler's DeviceChecker and
deviceAllocator consume (scheduler/feasible.go:1193, device.go:32).

Counterpart of ``nomad_tpu/plugins/device.py``. ``DevicePlugin`` and
``ReservationResponse`` are the reference's; the built-in plugin is
``CudaDevicePlugin``, which fingerprints the local CUDA cards through
``torch.cuda`` and exposes a reservation through the CUDA runtime's own
``CUDA_VISIBLE_DEVICES``, as Nomad's nvidia device plugin does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from nomad_tpu_torch.plugins.base import (
    BasePlugin,
    PLUGIN_TYPE_DEVICE,
    PluginInfo,
)
from nomad_tpu_torch.structs.resources import NodeDeviceResource


@dataclass
class ReservationResponse:
    """device.proto Reserve: how the runtime exposes reserved devices."""

    container_res: Dict[str, str] = field(default_factory=dict)   # env vars
    mounts: List[Dict] = field(default_factory=list)
    devices: List[Dict] = field(default_factory=list)


class DevicePlugin(BasePlugin):
    def fingerprint(self) -> List[NodeDeviceResource]:
        raise NotImplementedError

    def reserve(self, device_ids: List[str]) -> ReservationResponse:
        raise NotImplementedError

    def stats(self) -> Dict[str, Dict]:
        return {}


class CudaDevicePlugin(DevicePlugin):
    """Fingerprints the local CUDA cards through ``torch.cuda``.

    A node without a card (``torch.cuda.is_available()`` false) reports
    no device, as the nvidia plugin does on a GPU-less node. While a
    card is present, an error from the query propagates: a card that
    cannot be read is a fault of the node, not an absent device.
    """

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name="nvidia", type=PLUGIN_TYPE_DEVICE)

    def fingerprint(self) -> List[NodeDeviceResource]:
        import torch

        if not torch.cuda.is_available():
            return []
        count = torch.cuda.device_count()
        return [
            NodeDeviceResource(
                vendor="nvidia",
                type="gpu",
                name=torch.cuda.get_device_name(0),
                instance_ids=[f"gpu-{i}" for i in range(count)],
                attributes={"platform": "cuda", "count": str(count)},
            )
        ]

    def reserve(self, device_ids: List[str]) -> ReservationResponse:
        visible = ",".join(i.rsplit("-", 1)[-1] for i in device_ids)
        return ReservationResponse(
            container_res={"CUDA_VISIBLE_DEVICES": visible}
        )
