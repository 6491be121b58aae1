"""CSI volume and plugin models.

Reference behavior: nomad/structs/csi.go (~1.5k LoC) -- the
Container-Storage-Interface data model: ``CSIVolume`` (a registered
external volume with access/attachment capabilities and live claims),
``CSIPlugin`` (the aggregated health view of a plugin's controller and
node instances across the cluster), and the claim state machine the
volume watcher drives (claim → unpublish node → unpublish controller →
free). Claim-mode admission mirrors csi.go ``CSIVolume.WriteSchedulable``
/ ``claimWrite`` / ``claimRead``.
"""

from __future__ import annotations

import copy as _copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Access modes (csi.go CSIVolumeAccessMode)
ACCESS_MODE_UNKNOWN = ""
ACCESS_MODE_SINGLE_NODE_READER = "single-node-reader-only"
ACCESS_MODE_SINGLE_NODE_WRITER = "single-node-writer"
ACCESS_MODE_MULTI_NODE_READER = "multi-node-reader-only"
ACCESS_MODE_MULTI_NODE_SINGLE_WRITER = "multi-node-single-writer"
ACCESS_MODE_MULTI_NODE_MULTI_WRITER = "multi-node-multi-writer"

# Attachment modes (csi.go CSIVolumeAttachmentMode)
ATTACHMENT_MODE_UNKNOWN = ""
ATTACHMENT_MODE_BLOCK = "block-device"
ATTACHMENT_MODE_FS = "file-system"

# Claim modes (csi.go CSIVolumeClaimMode)
CLAIM_READ = "read"
CLAIM_WRITE = "write"
CLAIM_RELEASE = "release"

# Claim states (csi.go CSIVolumeClaimState) -- the unpublish workflow
# the volume watcher steps through, in order.
CLAIM_STATE_TAKEN = "taken"
CLAIM_STATE_NODE_DETACHED = "node-detached"
CLAIM_STATE_CONTROLLER_DETACHED = "controller-detached"
CLAIM_STATE_READY_TO_FREE = "ready-to-free"

# Plugin instance health (csi.go CSIInfo)


@dataclass
class CSIVolumeClaim:
    """One alloc's claim on a volume (csi.go CSIVolumeClaim)."""

    alloc_id: str = ""
    node_id: str = ""
    external_node_id: str = ""
    mode: str = CLAIM_READ
    access_mode: str = ACCESS_MODE_UNKNOWN
    attachment_mode: str = ATTACHMENT_MODE_UNKNOWN
    state: str = CLAIM_STATE_TAKEN
    # where the claiming node actually staged/published the volume;
    # recorded at claim time so the server-side unpublish workflow
    # releases the same paths (reference keeps these in the client's
    # csimanager usage state)
    staging_path: str = ""
    target_path: str = ""

    def copy(self) -> "CSIVolumeClaim":
        return _copy.deepcopy(self)

    def release_copy(self, state: str = CLAIM_STATE_TAKEN) -> "CSIVolumeClaim":
        """A release-mode copy at the given unpublish state (the claim
        transition currency of the volume watcher / claim GC)."""
        rel = self.copy()
        rel.mode = CLAIM_RELEASE
        rel.state = state
        return rel


@dataclass
class CSIMountOptions:
    """csi.go CSIMountOptions."""

    fs_type: str = ""
    mount_flags: List[str] = field(default_factory=list)


@dataclass
class CSIVolumeCapability:
    """One (access, attachment) capability pair (csi.go
    CSIVolumeCapability; volumes may list several since 1.1)."""

    access_mode: str = ACCESS_MODE_UNKNOWN
    attachment_mode: str = ATTACHMENT_MODE_UNKNOWN


@dataclass
class CSIVolume:
    """A registered external volume (csi.go CSIVolume)."""

    id: str = ""
    namespace: str = "default"
    name: str = ""
    external_id: str = ""
    plugin_id: str = ""
    provider: str = ""
    capacity_min: int = 0
    capacity_max: int = 0
    requested_capabilities: List[CSIVolumeCapability] = field(default_factory=list)
    mount_options: CSIMountOptions = field(default_factory=CSIMountOptions)
    secrets: Dict[str, str] = field(default_factory=dict)
    parameters: Dict[str, str] = field(default_factory=dict)
    context: Dict[str, str] = field(default_factory=dict)
    topologies: List[Dict[str, str]] = field(default_factory=list)
    # live claims keyed by alloc id (csi.go ReadClaims/WriteClaims)
    read_claims: Dict[str, CSIVolumeClaim] = field(default_factory=dict)
    write_claims: Dict[str, CSIVolumeClaim] = field(default_factory=dict)
    # claims released by the scheduler but not yet unpublished
    # (csi.go PastClaims), keyed by alloc id
    past_claims: Dict[str, CSIVolumeClaim] = field(default_factory=dict)
    schedulable: bool = True
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "CSIVolume":
        return _copy.deepcopy(self)

    def validate(self) -> None:
        if not self.id:
            raise ValueError("missing volume ID")
        if not self.plugin_id:
            raise ValueError(f"volume {self.id}: missing plugin ID")
        if not self.requested_capabilities:
            raise ValueError(
                f"volume {self.id}: must include at least one capability block"
            )

    # --- claim admission (csi.go WriteSchedulable/ReadSchedulable) ------

    def _has_capability(self, access_modes: List[str]) -> bool:
        return any(
            c.access_mode in access_modes for c in self.requested_capabilities
        )

    def read_schedulable(self) -> bool:
        if not self.schedulable:
            return False
        return self._has_capability([
            ACCESS_MODE_SINGLE_NODE_READER,
            ACCESS_MODE_SINGLE_NODE_WRITER,
            ACCESS_MODE_MULTI_NODE_READER,
            ACCESS_MODE_MULTI_NODE_SINGLE_WRITER,
            ACCESS_MODE_MULTI_NODE_MULTI_WRITER,
        ])

    def write_schedulable(self) -> bool:
        if not self.schedulable:
            return False
        return self._has_capability([
            ACCESS_MODE_SINGLE_NODE_WRITER,
            ACCESS_MODE_MULTI_NODE_SINGLE_WRITER,
            ACCESS_MODE_MULTI_NODE_MULTI_WRITER,
        ])

    def write_freely(self) -> bool:
        """Can accept an additional writer right now (csi.go WriteFreeClaims)."""
        if self._has_capability([ACCESS_MODE_MULTI_NODE_MULTI_WRITER]):
            return True
        return len(self.write_claims) == 0

    def read_freely(self) -> bool:
        """Can accept an additional reader right now."""
        if self._has_capability([
            ACCESS_MODE_MULTI_NODE_READER,
            ACCESS_MODE_MULTI_NODE_SINGLE_WRITER,
            ACCESS_MODE_MULTI_NODE_MULTI_WRITER,
        ]):
            return True
        return len(self.read_claims) + len(self.write_claims) == 0

    def claimable(self, mode: str) -> bool:
        if mode == CLAIM_WRITE:
            return self.write_schedulable() and self.write_freely()
        return self.read_schedulable() and self.read_freely()

    def claim(self, claim: CSIVolumeClaim) -> None:
        """Apply one claim transition (csi.go Claim). Raises on a write
        claim the volume cannot accept."""
        if claim.mode == CLAIM_RELEASE:
            self._release(claim)
            return
        # re-claim by the same alloc is idempotent
        if claim.alloc_id in self.read_claims:
            del self.read_claims[claim.alloc_id]
        if claim.alloc_id in self.write_claims:
            del self.write_claims[claim.alloc_id]
        if claim.mode == CLAIM_WRITE:
            if not self.write_freely() and claim.alloc_id not in self.write_claims:
                raise ValueError(
                    f"volume {self.id} max write claims reached"
                )
            self.write_claims[claim.alloc_id] = claim
        else:
            self.read_claims[claim.alloc_id] = claim
        self.past_claims.pop(claim.alloc_id, None)

    def _release(self, claim: CSIVolumeClaim) -> None:
        if claim.state == CLAIM_STATE_READY_TO_FREE:
            self.read_claims.pop(claim.alloc_id, None)
            self.write_claims.pop(claim.alloc_id, None)
            self.past_claims.pop(claim.alloc_id, None)
        else:
            self.read_claims.pop(claim.alloc_id, None)
            self.write_claims.pop(claim.alloc_id, None)
            self.past_claims[claim.alloc_id] = claim

    def in_use(self) -> bool:
        return bool(self.read_claims or self.write_claims)

    def stub(self) -> Dict:
        """List-view summary in wire casing (csi.go CSIVolListStub)."""
        return {
            "ID": self.id,
            "Namespace": self.namespace,
            "Name": self.name,
            "ExternalID": self.external_id,
            "PluginID": self.plugin_id,
            "Provider": self.provider,
            "Schedulable": self.schedulable,
            "CurrentReaders": len(self.read_claims),
            "CurrentWriters": len(self.write_claims),
            "AccessMode": (
                self.requested_capabilities[0].access_mode
                if self.requested_capabilities else ""
            ),
            "AttachmentMode": (
                self.requested_capabilities[0].attachment_mode
                if self.requested_capabilities else ""
            ),
            "CreateIndex": self.create_index,
            "ModifyIndex": self.modify_index,
        }


@dataclass
class CSIPlugin:
    """Aggregated plugin health across the cluster (csi.go CSIPlugin).

    The reference maintains this as a state table updated whenever a
    node fingerprint changes (state_store.go updateNodeCSIPlugins); the
    build derives it from the nodes table on read, which keeps it
    trivially consistent with fingerprints (same approach as the
    scaling-policies view).
    """

    id: str = ""
    provider: str = ""
    version: str = ""
    controller_required: bool = False
    # node_id -> info dict (healthy, requires_topology, ...)
    controllers: Dict[str, Dict] = field(default_factory=dict)
    nodes: Dict[str, Dict] = field(default_factory=dict)

    @property
    def controllers_healthy(self) -> int:
        return sum(1 for i in self.controllers.values() if i.get("healthy"))

    @property
    def nodes_healthy(self) -> int:
        return sum(1 for i in self.nodes.values() if i.get("healthy"))

    def stub(self) -> Dict:
        return {
            "ID": self.id,
            "Provider": self.provider,
            "ControllerRequired": self.controller_required,
            "ControllersHealthy": self.controllers_healthy,
            "ControllersExpected": len(self.controllers),
            "NodesHealthy": self.nodes_healthy,
            "NodesExpected": len(self.nodes),
        }


def plugins_from_nodes(nodes) -> Dict[str, CSIPlugin]:
    """Derive the plugin table from node fingerprints
    (state_store.go updateNodeCSIPlugins semantics)."""
    plugins: Dict[str, CSIPlugin] = {}

    def get(pid: str, info: Dict) -> CSIPlugin:
        p = plugins.get(pid)
        if p is None:
            p = CSIPlugin(id=pid)
            plugins[pid] = p
        if info.get("provider"):
            p.provider = info["provider"]
        if info.get("version"):
            p.version = info["version"]
        return p

    for node in nodes:
        for pid, info in (node.csi_controller_plugins or {}).items():
            p = get(pid, info)
            p.controller_required = True
            p.controllers[node.id] = info
        for pid, info in (node.csi_node_plugins or {}).items():
            p = get(pid, info)
            p.nodes[node.id] = info
    return plugins
