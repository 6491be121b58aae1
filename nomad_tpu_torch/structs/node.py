"""Node model: fingerprint attributes, resources, computed class.

Reference behavior: nomad/structs/structs.go Node (:1851) and
nomad/structs/node_class.go (ComputedClass -- a hash over the scheduling-
relevant subset of the node used to memoize feasibility per class).
"""

from __future__ import annotations

import copy as _copy
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nomad_tpu_torch.structs.consts import (
    NODE_SCHEDULING_ELIGIBLE,
    NODE_STATUS_DOWN,
    NODE_STATUS_INIT,
    NODE_STATUS_READY,
)
from nomad_tpu_torch.structs.resources import (
    ComparableResources,
    NodeReservedResources,
    NodeResources,
)


@dataclass
class DriverInfo:
    """Per-driver fingerprint result (structs.go DriverInfo)."""

    attributes: Dict[str, str] = field(default_factory=dict)
    detected: bool = False
    healthy: bool = False
    health_description: str = ""


@dataclass
class HostVolumeConfig:
    name: str = ""
    path: str = ""
    read_only: bool = False


@dataclass
class Node:
    """A client machine in the cluster (structs.go:1851)."""

    id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    node_pool: str = "default"
    attributes: Dict[str, object] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    node_resources: NodeResources = field(default_factory=NodeResources)
    reserved_resources: NodeReservedResources = field(default_factory=NodeReservedResources)
    drivers: Dict[str, DriverInfo] = field(default_factory=dict)
    host_volumes: Dict[str, HostVolumeConfig] = field(default_factory=dict)
    csi_node_plugins: Dict[str, Dict] = field(default_factory=dict)
    csi_controller_plugins: Dict[str, Dict] = field(default_factory=dict)
    status: str = NODE_STATUS_INIT
    scheduling_eligibility: str = NODE_SCHEDULING_ELIGIBLE
    drain: bool = False
    drain_strategy: Optional["DrainStrategy"] = None
    status_description: str = ""
    http_addr: str = ""
    secret_id: str = ""
    create_index: int = 0
    modify_index: int = 0
    last_drain: Optional[Dict] = None
    computed_class: str = ""

    # -- scheduling-facing helpers ---------------------------------------

    def ready(self) -> bool:
        """structs.go Node.Ready: status ready, not draining, eligible."""
        return (
            self.status == NODE_STATUS_READY
            and not self.drain
            and self.scheduling_eligibility == NODE_SCHEDULING_ELIGIBLE
        )

    def comparable_resources(self) -> ComparableResources:
        return self.node_resources.comparable()

    def comparable_reserved_resources(self) -> Optional[ComparableResources]:
        return self.reserved_resources.comparable()

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN

    def compute_class(self) -> str:
        """Hash the scheduling-relevant portions of the node.

        Reference node_class.go ComputeClass: nodes with equal computed
        class are interchangeable for *class-level* feasibility checks
        (constraints on attributes/class/drivers), which lets the
        eligibility cache (feasible.go:1050) skip whole classes. Unique
        attributes (``unique.``-prefixed) are excluded.
        """
        h = hashlib.sha256()
        # datacenter is class-relevant: ${node.datacenter} constraints
        # are checked per class representative (node_class.go hashes it)
        h.update(self.datacenter.encode())
        h.update(self.node_class.encode())
        h.update(self.node_pool.encode())
        for k in sorted(self.attributes):
            if k.startswith("unique."):
                continue
            h.update(k.encode())
            h.update(str(self.attributes[k]).encode())
        for k in sorted(self.meta):
            if k.startswith("unique."):
                continue
            h.update(k.encode())
            h.update(str(self.meta[k]).encode())
        for name in sorted(self.drivers):
            d = self.drivers[name]
            h.update(name.encode())
            h.update(b"1" if (d.detected and d.healthy) else b"0")
        for dev in self.node_resources.devices:
            h.update(dev.id_string().encode())
            for k in sorted(dev.attributes):
                h.update(k.encode())
                h.update(str(dev.attributes[k]).encode())
        self.computed_class = h.hexdigest()[:16]
        return self.computed_class

    def copy(self) -> "Node":
        return _copy.deepcopy(self)

    def stub(self) -> Dict:
        return {
            "ID": self.id,
            "Name": self.name,
            "Datacenter": self.datacenter,
            "NodeClass": self.node_class,
            "Status": self.status,
            "SchedulingEligibility": self.scheduling_eligibility,
            "Drain": self.drain,
        }


class DrainStrategy:
    """structs.go DrainStrategy/DrainSpec: how long a drain may take
    and whether system jobs are left alone."""

    def __init__(self, deadline_s: float = 3600.0,
                 ignore_system_jobs: bool = False) -> None:
        import time as _time
        self.deadline_s = deadline_s
        self.ignore_system_jobs = ignore_system_jobs
        self.started_at = _time.time()

    def deadline_passed(self) -> bool:
        import time as _time
        return self.deadline_s > 0 and \
            _time.time() > self.started_at + self.deadline_s
