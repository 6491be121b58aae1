"""Client-side native service registration.

Reference behavior: client/serviceregistration/ -- the client registers
running tasks' ``provider = "nomad"`` services against the server's
ServiceRegistration endpoint (nsd/nsd.go RegisterWorkload) and removes
them when the workload stops (RemoveWorkload). Address comes from the
node fingerprint; port from the allocation's assigned port labels.

The "builtin" provider (this build's default, standing in for both
nomad- and consul-provided discovery) registers here too.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from nomad_tpu_torch.structs.services import ServiceRegistration, registration_id

LOG = logging.getLogger(__name__)

PROVIDERS = ("nomad", "builtin")


class ServiceRegWrapper:
    def __init__(self, rpc, node) -> None:
        self.rpc = rpc
        self.node = node

    def _address(self) -> str:
        return str(self.node.attributes.get("unique.network.ip-address",
                                            "127.0.0.1"))

    def _port_for_label(self, alloc, label: str) -> int:
        """Resolve a service's port label against the alloc's assigned
        networks (serviceregistration GetAddress semantics)."""
        if not label:
            return 0
        nets = []
        res = alloc.allocated_resources
        if res is not None:
            if res.shared is not None:
                nets.extend(res.shared.networks)
                for p in res.shared.ports:
                    if p.label == label:
                        return p.value
            for tr in res.tasks.values():
                nets.extend(tr.networks)
        for net in nets:
            port = net.port_for_label(label)
            if port:
                return port
        return 0

    def build(self, alloc, services, task_name: str = "") -> List[ServiceRegistration]:
        regs = []
        for svc in services or []:
            if svc.provider not in PROVIDERS:
                continue
            regs.append(ServiceRegistration(
                id=registration_id(svc.name, alloc.id, task_name,
                                   svc.port_label),
                service_name=svc.name,
                namespace=alloc.namespace,
                node_id=alloc.node_id,
                datacenter=self.node.datacenter,
                job_id=alloc.job_id,
                alloc_id=alloc.id,
                tags=list(svc.tags),
                address=self._address(),
                port=self._port_for_label(alloc, svc.port_label),
            ))
        return regs

    def register(self, alloc, services, task_name: str = "") -> None:
        regs = self.build(alloc, services, task_name)
        if regs:
            try:
                self.rpc.register_services(regs)
            except Exception as e:              # noqa: BLE001
                LOG.warning("service registration for alloc %s: %s",
                            alloc.id, e)

    def deregister_alloc(self, alloc_id: str) -> None:
        try:
            self.rpc.deregister_services_by_alloc([alloc_id])
        except Exception as e:                  # noqa: BLE001
            LOG.warning("service deregistration for alloc %s: %s",
                        alloc_id, e)

    def deregister_task(self, alloc, services, task_name: str = "") -> None:
        """Pull one dead task's instances while its siblings keep
        running (RemoveWorkload at task granularity)."""
        ids = [
            registration_id(svc.name, alloc.id, task_name, svc.port_label)
            for svc in services or [] if svc.provider in PROVIDERS
        ]
        if ids:
            try:
                self.rpc.deregister_services(ids)
            except Exception as e:              # noqa: BLE001
                LOG.warning("service deregistration for task %s/%s: %s",
                            alloc.id, task_name, e)
