"""Client-side CSI volume mount lifecycle.

Reference behavior: client/pluginmanager/csimanager/ -- the
``volumeManager`` stages and publishes CSI volumes for claiming
allocations (volume.go MountVolume: NodeStageVolume once per volume,
NodePublishVolume per alloc into the alloc dir) and unpublishes on
release (UnmountVolume). Claims are made against the server first
(allocrunner/csi_hook.go Claim RPC), which controller-publishes when
the plugin requires it.

The usage counter mirrors csimanager's ref-counted staging: the last
alloc to unmount a volume on the node also unstages it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Tuple

from nomad_tpu_torch.structs import csi as csi_structs

LOG = logging.getLogger(__name__)


class CSIMountInfo:
    def __init__(self, source: str, target_path: str,
                 plugin_id: str = "", external_id: str = "") -> None:
        self.source = source
        self.target_path = target_path
        self.plugin_id = plugin_id
        self.external_id = external_id


class CSIManager:
    def __init__(self, rpc, csi_clients: Dict[str, object],
                 node_id: str, data_dir: str) -> None:
        self.rpc = rpc                       # ClientRPC: csi_claim verb
        self.csi_clients = csi_clients       # plugin_id -> CSIClient
        self.node_id = node_id
        self.data_dir = data_dir
        self._lock = threading.Lock()
        # volume id -> set of alloc ids using its staged mount
        self._usage: Dict[str, set] = {}

    def _staging_path(self, vol) -> str:
        return os.path.join(self.data_dir, "csi", "staging", vol.id)

    def _target_path(self, vol, alloc_id: str) -> str:
        return os.path.join(self.data_dir, "csi", "per-alloc", alloc_id, vol.id)

    def mount_volume(self, alloc, vol_req) -> CSIMountInfo:
        """csi_hook.go Prerun: claim against the server, then stage +
        publish through the node plugin."""
        mode = csi_structs.CLAIM_READ if vol_req.read_only \
            else csi_structs.CLAIM_WRITE
        # the claim records the exact paths this node will publish at,
        # so the server-side unpublish workflow can replay them
        claim = csi_structs.CSIVolumeClaim(
            alloc_id=alloc.id, node_id=self.node_id, mode=mode,
            access_mode=vol_req.access_mode,
            attachment_mode=vol_req.attachment_mode,
        )
        claim.staging_path = os.path.join(
            self.data_dir, "csi", "staging", vol_req.source
        )
        claim.target_path = os.path.join(
            self.data_dir, "csi", "per-alloc", alloc.id, vol_req.source
        )
        vol = self.rpc.csi_claim(alloc.namespace, vol_req.source, claim)
        client = self.csi_clients.get(vol.plugin_id)
        staging = claim.staging_path
        target = claim.target_path
        capability = {
            "access_mode": vol_req.access_mode or (
                vol.requested_capabilities[0].access_mode
                if vol.requested_capabilities else ""
            ),
            "attachment_mode": vol_req.attachment_mode or (
                vol.requested_capabilities[0].attachment_mode
                if vol.requested_capabilities else ""
            ),
        }
        with self._lock:
            first = not self._usage.get(vol.id)
        if client is not None:
            if first:
                client.node_stage_volume(
                    vol.external_id, staging, capability, vol.context
                )
            client.node_publish_volume(
                vol.external_id, staging, target, vol_req.read_only, capability
            )
        else:
            os.makedirs(target, exist_ok=True)
        # count the alloc as a user only once staged+published, so a
        # failed stage doesn't leave a phantom user that makes the next
        # alloc skip staging
        with self._lock:
            self._usage.setdefault(vol.id, set()).add(alloc.id)
        return CSIMountInfo(source=vol_req.source, target_path=target,
                            plugin_id=vol.plugin_id,
                            external_id=vol.external_id)

    def unmount_volume(self, alloc_id: str, mount: CSIMountInfo) -> None:
        """csi_hook.go Postrun: unpublish this alloc's mount; unstage if
        it was the last user on the node."""
        client = self.csi_clients.get(mount.plugin_id)
        with self._lock:
            users = self._usage.get(mount.source, set())
            users.discard(alloc_id)
            last = not users
        if client is not None:
            client.node_unpublish_volume(mount.external_id,
                                         mount.target_path)
            if last:
                client.node_unstage_volume(
                    mount.external_id,
                    os.path.join(self.data_dir, "csi", "staging",
                                 mount.source),
                )
