"""Resource model and fit/score math.

Reference behavior: nomad/structs/structs.go (Resources :2500 area,
NodeResources :2894, NodeReservedResources :3453, AllocatedResources :3524,
ComparableResources :3970) and nomad/structs/funcs.go (AllocsFit :166,
computeFreePercentage :235, ScoreFitBinPack :259, ScoreFitSpread :286).

These are the *host-side* reference semantics; the TPU kernel in
``nomad_tpu_torch.ops.kernel`` reproduces exactly this math as vectorized ops over
the node tensor, and the tests assert parity between the two.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs.network import NetworkIndex, NetworkResource, Port


# ---------------------------------------------------------------------------
# Ask-side (what a task requests)
# ---------------------------------------------------------------------------


@dataclass
class RequestedDevice:
    """A device ask, e.g. "nvidia/gpu" or "google/tpu" count=4.

    Reference: nomad/structs/devices.go + structs.go RequestedDevice.
    Name is `[vendor/]type[/model]`.
    """

    name: str = ""
    count: int = 1
    constraints: List = field(default_factory=list)   # List[Constraint]
    affinities: List = field(default_factory=list)    # List[Affinity]

    def id_tuple(self) -> Tuple[str, ...]:
        return tuple(self.name.split("/"))

    def copy(self) -> "RequestedDevice":
        return dataclasses.replace(
            self,
            constraints=[c.copy() for c in self.constraints],
            affinities=[a.copy() for a in self.affinities],
        )


@dataclass
class Resources:
    """Per-task resource ask (reference structs.go Resources).

    CPU in MHz shares, memory/disk in MB. ``cores`` reserves whole cpu
    cores (reference rank.go:462-492 cpuset handling).
    """

    cpu: int = 100
    cores: int = 0
    memory_mb: int = 300
    memory_max_mb: int = 0
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[RequestedDevice] = field(default_factory=list)

    def copy(self) -> "Resources":
        return dataclasses.replace(
            self,
            networks=[n.copy() for n in self.networks],
            devices=[d.copy() for d in self.devices],
        )


# ---------------------------------------------------------------------------
# Node-side (what a node offers)
# ---------------------------------------------------------------------------


@dataclass
class NodeCpuResources:
    """Reference structs.go NodeCpuResources."""

    cpu_shares: int = 0                 # total MHz
    total_core_count: int = 0
    reservable_cpu_cores: List[int] = field(default_factory=list)

    def shares_per_core(self) -> int:
        if self.total_core_count == 0:
            return 0
        return self.cpu_shares // self.total_core_count


@dataclass
class NodeMemoryResources:
    memory_mb: int = 0


@dataclass
class NodeDiskResources:
    disk_mb: int = 0


@dataclass
class NodeDeviceResource:
    """A homogeneous group of device instances on a node.

    Reference: nomad/structs/devices.go NodeDeviceResource -- vendor/type/name
    plus instance list; attributes drive device constraints/affinities.
    """

    vendor: str = ""
    type: str = ""
    name: str = ""
    instance_ids: List[str] = field(default_factory=list)
    attributes: Dict[str, object] = field(default_factory=dict)
    healthy_ids: Optional[List[str]] = None  # defaults to all instances

    def id_string(self) -> str:
        return f"{self.vendor}/{self.type}/{self.name}"

    def available_ids(self) -> List[str]:
        return list(self.healthy_ids if self.healthy_ids is not None else self.instance_ids)

    def matches_request(self, name: str) -> bool:
        """Match a RequestedDevice.name of the form type | vendor/type |
        vendor/type/model (reference devices.go ID matching)."""
        parts = name.split("/")
        if len(parts) == 1:
            return parts[0] == self.type
        if len(parts) == 2:
            return parts[0] == self.vendor and parts[1] == self.type
        if len(parts) == 3:
            return (
                parts[0] == self.vendor
                and parts[1] == self.type
                and parts[2] == self.name
            )
        return False


@dataclass
class NodeResources:
    """Total resources a node fingerprints (reference structs.go:2894)."""

    cpu: NodeCpuResources = field(default_factory=NodeCpuResources)
    memory: NodeMemoryResources = field(default_factory=NodeMemoryResources)
    disk: NodeDiskResources = field(default_factory=NodeDiskResources)
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[NodeDeviceResource] = field(default_factory=list)
    min_dynamic_port: int = 0  # 0 -> NetworkIndex default (20000)
    max_dynamic_port: int = 0  # 0 -> NetworkIndex default (32000)

    def comparable(self) -> "ComparableResources":
        return ComparableResources(
            cpu_shares=self.cpu.cpu_shares,
            memory_mb=self.memory.memory_mb,
            disk_mb=self.disk.disk_mb,
            reserved_cores=list(self.cpu.reservable_cpu_cores),
        )


@dataclass
class NodeReservedResources:
    """Resources the agent excludes from scheduling (structs.go:3453)."""

    cpu_shares: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_cpu_cores: List[int] = field(default_factory=list)
    networks_ports: List[int] = field(default_factory=list)  # reserved host ports

    def comparable(self) -> "ComparableResources":
        return ComparableResources(
            cpu_shares=self.cpu_shares,
            memory_mb=self.memory_mb,
            disk_mb=self.disk_mb,
            reserved_cores=list(self.reserved_cpu_cores),
        )


# ---------------------------------------------------------------------------
# Allocated (what a placement consumed)
# ---------------------------------------------------------------------------


@dataclass
class AllocatedCpuResources:
    cpu_shares: int = 0
    reserved_cores: List[int] = field(default_factory=list)


@dataclass
class AllocatedMemoryResources:
    memory_mb: int = 0
    memory_max_mb: int = 0


@dataclass
class AllocatedDeviceResource:
    vendor: str = ""
    type: str = ""
    name: str = ""
    device_ids: List[str] = field(default_factory=list)

    def id_string(self) -> str:
        return f"{self.vendor}/{self.type}/{self.name}"


@dataclass
class AllocatedTaskResources:
    cpu: AllocatedCpuResources = field(default_factory=AllocatedCpuResources)
    memory: AllocatedMemoryResources = field(default_factory=AllocatedMemoryResources)
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[AllocatedDeviceResource] = field(default_factory=list)

    def copy(self) -> "AllocatedTaskResources":
        return AllocatedTaskResources(
            cpu=dataclasses.replace(self.cpu, reserved_cores=list(self.cpu.reserved_cores)),
            memory=dataclasses.replace(self.memory),
            networks=[n.copy() for n in self.networks],
            devices=[dataclasses.replace(d, device_ids=list(d.device_ids)) for d in self.devices],
        )


@dataclass
class AllocatedSharedResources:
    """Task-group-shared resources (disk, group network/ports)."""

    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    ports: List[Port] = field(default_factory=list)


@dataclass
class AllocatedResources:
    """Per-alloc resource record: per-task map + shared (structs.go:3524)."""

    tasks: Dict[str, AllocatedTaskResources] = field(default_factory=dict)
    task_lifecycles: Dict[str, Optional[object]] = field(default_factory=dict)
    shared: AllocatedSharedResources = field(default_factory=AllocatedSharedResources)

    def comparable(self) -> "ComparableResources":
        """Flatten to the comparable form used by fit/score math.

        Reference structs.go AllocatedResources.Comparable: sums
        non-sidecar task resources (lifecycle handling simplified: all
        tasks summed), unions reserved cores, merges networks/ports.
        """
        c = ComparableResources(disk_mb=self.shared.disk_mb)
        for tr in self.tasks.values():
            c.cpu_shares += tr.cpu.cpu_shares
            c.reserved_cores = sorted(set(c.reserved_cores) | set(tr.cpu.reserved_cores))
            c.memory_mb += tr.memory.memory_mb
            c.networks.extend(tr.networks)
        c.networks.extend(self.shared.networks)
        return c


@dataclass
class ComparableResources:
    """Flattened cpu/mem/disk/networks used by scoring (structs.go:3970)."""

    cpu_shares: int = 0
    reserved_cores: List[int] = field(default_factory=list)
    memory_mb: int = 0
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)

    def add(self, other: Optional["ComparableResources"]) -> None:
        if other is None:
            return
        self.cpu_shares += other.cpu_shares
        self.reserved_cores = sorted(set(self.reserved_cores) | set(other.reserved_cores))
        self.memory_mb += other.memory_mb
        self.disk_mb += other.disk_mb
        self.networks.extend(other.networks)

    def subtract(self, other: Optional["ComparableResources"]) -> None:
        if other is None:
            return
        self.cpu_shares -= other.cpu_shares
        self.reserved_cores = sorted(set(self.reserved_cores) - set(other.reserved_cores))
        self.memory_mb -= other.memory_mb
        self.disk_mb -= other.disk_mb

    def superset(self, other: "ComparableResources") -> Tuple[bool, str]:
        """Is self a superset of other? Returns (ok, exhausted-dimension).

        Reference structs.go ComparableResources.Superset -- including the
        cpuset containment check for reserved cores (structs.go:4009).
        """
        if self.cpu_shares < other.cpu_shares:
            return False, "cpu"
        if other.reserved_cores and not set(other.reserved_cores) <= set(self.reserved_cores):
            return False, "cores"
        if self.memory_mb < other.memory_mb:
            return False, "memory"
        if self.disk_mb < other.disk_mb:
            return False, "disk"
        return True, ""

    def copy(self) -> "ComparableResources":
        return ComparableResources(
            cpu_shares=self.cpu_shares,
            reserved_cores=list(self.reserved_cores),
            memory_mb=self.memory_mb,
            disk_mb=self.disk_mb,
            networks=[n.copy() for n in self.networks],
        )


# ---------------------------------------------------------------------------
# Device accounting (reference structs/devices.go DeviceAccounter)
# ---------------------------------------------------------------------------


class DeviceAccounter:
    """Tracks device instance usage on a node to detect oversubscription."""

    def __init__(self, node) -> None:
        # {device id string: {instance id: use count}}
        self.devices: Dict[str, Dict[str, int]] = {}
        for dev in node.node_resources.devices:
            self.devices[dev.id_string()] = {iid: 0 for iid in dev.available_ids()}

    def add_allocs(self, allocs) -> bool:
        """Returns True if a collision (oversubscription) was detected."""
        collision = False
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            if alloc.allocated_resources is None:
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for dev in tr.devices:
                    instances = self.devices.get(dev.id_string())
                    if instances is None:
                        continue
                    for iid in dev.device_ids:
                        if iid in instances:
                            instances[iid] += 1
                            if instances[iid] > 1:
                                collision = True
        return collision

    def add_reserved(self, dev: AllocatedDeviceResource) -> bool:
        collision = False
        instances = self.devices.setdefault(dev.id_string(), {})
        for iid in dev.device_ids:
            count = instances.get(iid, 0)
            if count >= 1:
                collision = True
            instances[iid] = count + 1
        return collision

    def free_instances(self, dev_id: str) -> List[str]:
        return [iid for iid, n in self.devices.get(dev_id, {}).items() if n == 0]


# ---------------------------------------------------------------------------
# Fit + score math (reference nomad/structs/funcs.go)
# ---------------------------------------------------------------------------


def allocs_fit(
    node,
    allocs,
    net_idx: Optional[NetworkIndex] = None,
    check_devices: bool = False,
) -> Tuple[bool, str, ComparableResources]:
    """Check whether a set of allocations fits on a node.

    Mirrors reference funcs.go:166 AllocsFit: sums non-terminal alloc
    utilization, rejects reserved-core overlap, requires node resources
    (minus node-reserved) to be a superset, then checks port collisions
    via the NetworkIndex and optionally device oversubscription.
    Returns (fit, exhausted_dimension, used).
    """
    used = ComparableResources()
    reserved_cores = set()
    core_overlap = False
    any_ports = False
    any_devices = False

    for alloc in allocs:
        if alloc.terminal_status():
            continue
        cr, uses_ports, uses_devices = alloc.fit_meta()
        used.add(cr)
        any_ports |= uses_ports
        any_devices |= uses_devices
        for core in cr.reserved_cores:
            if core in reserved_cores:
                core_overlap = True
            reserved_cores.add(core)

    if core_overlap:
        return False, "cores", used

    available = node.comparable_resources()
    available.subtract(node.comparable_reserved_resources())
    ok, dim = available.superset(used)
    if not ok:
        return False, dim, used

    if net_idx is None and any_ports:
        # only build the port/bandwidth index when some proposed alloc
        # actually declares networks or ports — for port-less sets no
        # collision or bandwidth use is possible, and building the
        # index per node per plan dominated the applier's profile
        net_idx = NetworkIndex()
        collide, reason = net_idx.set_node(node)
        if collide:
            return False, f"reserved node port collision: {reason}", used
        collide, reason = net_idx.add_allocs(allocs)
        if collide:
            return False, f"reserved alloc port collision: {reason}", used

    if net_idx is not None and net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    if check_devices and any_devices:
        accounter = DeviceAccounter(node)
        if accounter.add_allocs(allocs):
            return False, "device oversubscribed", used

    return True, "", used


def compute_free_percentage(node, util: ComparableResources) -> Tuple[float, float]:
    """Free cpu/mem fraction after `util` is placed (funcs.go:235)."""
    res = node.comparable_resources()
    reserved = node.comparable_reserved_resources()
    node_cpu = float(res.cpu_shares)
    node_mem = float(res.memory_mb)
    if reserved is not None:
        node_cpu -= float(reserved.cpu_shares)
        node_mem -= float(reserved.memory_mb)
    # Zero-capacity guard: Go's float division yields +/-Inf and the score
    # clamp absorbs it; Python raises. Treat a zero-capacity dimension as
    # fully utilized (free = 0) -- such nodes can never improve a score.
    free_pct_cpu = 1.0 - (float(util.cpu_shares) / node_cpu) if node_cpu > 0 else 0.0
    free_pct_ram = 1.0 - (float(util.memory_mb) / node_mem) if node_mem > 0 else 0.0
    return free_pct_cpu, free_pct_ram


def _clamp_score(score: float) -> float:
    if score > 18.0:
        return 18.0
    if score < 0.0:
        return 0.0
    return score


def score_fit_binpack(node, util: ComparableResources) -> float:
    """Best-fit score in [0, 18] (funcs.go:259): 20 - (10^fc + 10^fm)."""
    fc, fm = compute_free_percentage(node, util)
    total = math.pow(10, fc) + math.pow(10, fm)
    return _clamp_score(20.0 - total)


def score_fit_spread(node, util: ComparableResources) -> float:
    """Worst-fit score in [0, 18] (funcs.go:286): (10^fc + 10^fm) - 2."""
    fc, fm = compute_free_percentage(node, util)
    total = math.pow(10, fc) + math.pow(10, fm)
    return _clamp_score(total - 2.0)
