"""CSI plugin client interface.

Reference behavior: plugins/csi/client.go (~1.5k LoC) -- the gRPC
client Nomad uses to talk to CSI controller and node plugins
(ControllerPublishVolume / ControllerUnpublishVolume /
NodeStageVolume / NodePublishVolume / NodeUnpublishVolume /
ValidateVolumeCapabilities). The build exposes the same verb surface as
an in-process interface; real deployments would back it with a gRPC
channel to the plugin's unix socket, tests and the dev agent use
``FakeCSIClient`` (the analog of plugins/csi/fake/client.go).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class CSIClientError(Exception):
    pass


class CSIClient:
    """Verb surface of plugins/csi/client.go."""

    def plugin_probe(self) -> bool:
        raise NotImplementedError

    def plugin_get_info(self) -> Dict:
        raise NotImplementedError

    def controller_publish_volume(self, external_id: str, node_external_id: str,
                                  read_only: bool, capability: Dict) -> Dict:
        raise NotImplementedError

    def controller_unpublish_volume(self, external_id: str,
                                    node_external_id: str) -> None:
        raise NotImplementedError

    def controller_validate_capabilities(self, external_id: str,
                                         capabilities: List[Dict]) -> None:
        raise NotImplementedError

    def controller_create_volume(self, name: str, capacity_min: int,
                                 capacity_max: int,
                                 capabilities: List[Dict],
                                 parameters: Dict) -> Dict:
        raise NotImplementedError

    def controller_delete_volume(self, external_id: str) -> None:
        raise NotImplementedError

    def node_stage_volume(self, external_id: str, staging_path: str,
                          capability: Dict, context: Dict) -> None:
        raise NotImplementedError

    def node_unstage_volume(self, external_id: str, staging_path: str) -> None:
        raise NotImplementedError

    def node_publish_volume(self, external_id: str, staging_path: str,
                            target_path: str, read_only: bool,
                            capability: Dict) -> None:
        raise NotImplementedError

    def node_unpublish_volume(self, external_id: str, target_path: str) -> None:
        raise NotImplementedError


class FakeCSIClient(CSIClient):
    """In-process fake with scriptable failures
    (plugins/csi/fake/client.go)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (external_id, node) -> published
        self.controller_published: Set[Tuple[str, str]] = set()
        self.node_staged: Set[Tuple[str, str]] = set()
        self.node_published: Set[Tuple[str, str]] = set()
        self.created_volumes: Dict[str, Dict] = {}
        # scriptable failures: verb name -> error message
        self.fail: Dict[str, str] = {}
        self.calls: List[Tuple[str, tuple]] = []

    def _call(self, verb: str, *args) -> None:
        with self._lock:
            self.calls.append((verb, args))
            if verb in self.fail:
                raise CSIClientError(self.fail[verb])

    def plugin_probe(self) -> bool:
        self._call("plugin_probe")
        return True

    def plugin_get_info(self) -> Dict:
        self._call("plugin_get_info")
        return {"name": "fake-csi", "version": "1.0.0"}

    def controller_publish_volume(self, external_id, node_external_id,
                                  read_only, capability):
        self._call("controller_publish_volume", external_id, node_external_id)
        self.controller_published.add((external_id, node_external_id))
        return {"publish_context": {}}

    def controller_unpublish_volume(self, external_id, node_external_id):
        self._call("controller_unpublish_volume", external_id, node_external_id)
        self.controller_published.discard((external_id, node_external_id))

    def controller_validate_capabilities(self, external_id, capabilities):
        self._call("controller_validate_capabilities", external_id)

    def controller_create_volume(self, name, capacity_min, capacity_max,
                                 capabilities, parameters):
        self._call("controller_create_volume", name)
        ext_id = f"ext-{name}"
        self.created_volumes[ext_id] = {
            "name": name, "capacity": capacity_max or capacity_min,
        }
        return {"external_id": ext_id, "capacity": capacity_max or capacity_min}

    def controller_delete_volume(self, external_id):
        self._call("controller_delete_volume", external_id)
        self.created_volumes.pop(external_id, None)

    def node_stage_volume(self, external_id, staging_path, capability, context):
        self._call("node_stage_volume", external_id, staging_path)
        self.node_staged.add((external_id, staging_path))

    def node_unstage_volume(self, external_id, staging_path):
        self._call("node_unstage_volume", external_id, staging_path)
        self.node_staged.discard((external_id, staging_path))

    def node_publish_volume(self, external_id, staging_path, target_path,
                            read_only, capability):
        self._call("node_publish_volume", external_id, target_path)
        self.node_published.add((external_id, target_path))

    def node_unpublish_volume(self, external_id, target_path):
        self._call("node_unpublish_volume", external_id, target_path)
        self.node_published.discard((external_id, target_path))
