"""Host fingerprinting: building the Node from the machine.

Reference behavior: client/fingerprint/ (~30 fingerprinters feeding
Node.Attributes/NodeResources via fingerprint_manager.go). Implemented
fingerprinters: arch, cpu, memory, storage, host, nomad version,
network, plus driver fingerprints (via the driver registry) and device
fingerprints (via device plugins -- the CUDA fingerprinter surfaces
chips as schedulable NodeDeviceResources).
"""

from __future__ import annotations

import os
import platform
import shutil
import socket
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch import structs
from nomad_tpu_torch.structs import consts


def fingerprint_arch(attrs: Dict, res: structs.NodeResources) -> None:
    attrs["cpu.arch"] = platform.machine()
    attrs["arch"] = platform.machine()


def fingerprint_cpu(attrs: Dict, res: structs.NodeResources) -> None:
    cores = os.cpu_count() or 1
    attrs["cpu.numcores"] = str(cores)
    # without frequency probing assume 1 GHz/core compute units
    # (fingerprint/cpu.go uses MHz x cores for cpu shares)
    mhz = 1000
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    mhz = int(float(line.split(":")[1]))
                    break
    except (FileNotFoundError, ValueError, IndexError):
        pass
    attrs["cpu.frequency"] = str(mhz)
    total = mhz * cores
    attrs["cpu.totalcompute"] = str(total)
    res.cpu = structs.NodeCpuResources(
        cpu_shares=total,
        total_core_count=cores,
        reservable_cpu_cores=list(range(cores)),
    )


def fingerprint_memory(attrs: Dict, res: structs.NodeResources) -> None:
    mem_mb = 1024
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    mem_mb = int(line.split()[1]) // 1024
                    break
    except (FileNotFoundError, ValueError, IndexError):
        pass
    attrs["memory.totalbytes"] = str(mem_mb * 1024 * 1024)
    res.memory = structs.NodeMemoryResources(memory_mb=mem_mb)


def fingerprint_storage(attrs: Dict, res: structs.NodeResources, data_dir: str = "/tmp") -> None:
    try:
        usage = shutil.disk_usage(data_dir)
        disk_mb = usage.free // (1024 * 1024)
    except OSError:
        disk_mb = 1024
    attrs["unique.storage.volume"] = data_dir
    attrs["unique.storage.bytesfree"] = str(disk_mb * 1024 * 1024)
    res.disk = structs.NodeDiskResources(disk_mb=int(disk_mb))


def fingerprint_host(attrs: Dict, res: structs.NodeResources) -> None:
    attrs["kernel.name"] = platform.system().lower()
    attrs["kernel.version"] = platform.release()
    attrs["os.name"] = platform.system().lower()
    attrs["os.version"] = platform.version()
    attrs["unique.hostname"] = socket.gethostname()


def fingerprint_nomad(attrs: Dict, res: structs.NodeResources) -> None:
    from nomad_tpu_torch import __version__
    attrs["nomad.version"] = __version__
    attrs["nomad.revision"] = "tpu"


def fingerprint_network(attrs: Dict, res: structs.NodeResources) -> None:
    hostname = socket.gethostname()
    try:
        ip = socket.gethostbyname(hostname)
    except OSError:
        ip = "127.0.0.1"
    attrs["unique.network.ip-address"] = ip
    res.networks = [
        structs.NetworkResource(
            device="eth0", cidr=f"{ip}/32", ip=ip, mbits=1000
        )
    ]


DEFAULT_FINGERPRINTERS: List[Callable] = [
    fingerprint_arch,
    fingerprint_cpu,
    fingerprint_memory,
    fingerprint_storage,
    fingerprint_host,
    fingerprint_nomad,
    fingerprint_network,
]


def fingerprint_node(
    node_id: str,
    datacenter: str = "dc1",
    node_class: str = "",
    drivers: Optional[Dict] = None,
    device_plugins: Optional[List] = None,
    meta: Optional[Dict[str, str]] = None,
) -> structs.Node:
    """Run all fingerprinters into a fresh Node
    (fingerprint_manager.go run + client.go setupNode)."""
    attrs: Dict[str, str] = {}
    res = structs.NodeResources()
    for fp in DEFAULT_FINGERPRINTERS:
        try:
            fp(attrs, res)
        except Exception:                       # noqa: BLE001
            continue
    driver_infos = {}
    for name, drv in (drivers or {}).items():
        try:
            fp = drv.fingerprint()
        except Exception:                       # noqa: BLE001
            continue
        attrs.update(fp.attributes)
        driver_infos[name] = structs.DriverInfo(
            detected=fp.health != "undetected",
            healthy=fp.health == "healthy",
            health_description=fp.health_description,
        )
    for plugin in device_plugins or []:
        try:
            res.devices.extend(plugin.fingerprint())
        except Exception:                       # noqa: BLE001
            continue
    node = structs.Node(
        id=node_id,
        name=socket.gethostname(),
        datacenter=datacenter,
        node_class=node_class,
        attributes=attrs,
        node_resources=res,
        reserved_resources=structs.NodeReservedResources(),
        drivers=driver_infos,
        meta=dict(meta or {}),
        status=consts.NODE_STATUS_INIT,
    )
    node.compute_class()
    return node
