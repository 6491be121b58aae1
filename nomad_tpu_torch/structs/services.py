"""Native service-registration model.

Reference behavior: nomad/structs/service_registration.go -- the
``ServiceRegistration`` rows written by clients when tasks with
``provider = "nomad"`` services start (Nomad 1.3's built-in service
discovery), plus the list-stub grouping the /v1/services endpoint
returns. Service *definitions* (name, port label, checks) live on
Task/TaskGroup (structs/services.go Service, see structs/job.py); this
module is the registered-instance currency.
"""

from __future__ import annotations

import copy as _copy
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class ServiceRegistration:
    """One live instance of a service (service_registration.go)."""

    id: str = ""
    service_name: str = ""
    namespace: str = "default"
    node_id: str = ""
    datacenter: str = ""
    job_id: str = ""
    alloc_id: str = ""
    tags: List[str] = field(default_factory=list)
    address: str = ""
    port: int = 0
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "ServiceRegistration":
        return _copy.deepcopy(self)

    def validate(self) -> None:
        if not self.id:
            raise ValueError("missing service registration ID")
        if not self.service_name:
            raise ValueError(f"registration {self.id}: missing service name")
        if not self.node_id:
            raise ValueError(f"registration {self.id}: missing node ID")

    def stub(self) -> Dict:
        return {
            "ID": self.id,
            "ServiceName": self.service_name,
            "Namespace": self.namespace,
            "NodeID": self.node_id,
            "Datacenter": self.datacenter,
            "JobID": self.job_id,
            "AllocID": self.alloc_id,
            "Tags": list(self.tags),
            "Address": self.address,
            "Port": self.port,
            "CreateIndex": self.create_index,
            "ModifyIndex": self.modify_index,
        }


def registration_id(service_name: str, alloc_id: str, task_name: str = "",
                    port_label: str = "") -> str:
    """Deterministic instance id (reference uses _nomad-task-<alloc>-
    <task>-<service>-<port label> as the Consul/Nomad service id; the
    port label keeps same-named services on one task distinct)."""
    parts = ["_nomad-task", alloc_id, task_name or "group", service_name,
             port_label]
    return "-".join(p for p in parts if p)
