"""Volume watcher: reap CSI claims of terminal allocations.

Reference behavior: nomad/volumewatcher/ (~0.7k LoC) -- the leader runs
one logical watcher per CSI volume with claims. When a claiming alloc
becomes terminal (or is GC'd), the watcher drives the per-claim
unpublish state machine (volumewatcher/volume_watcher.go
volumeReapImpl):

  taken -> node-unpublish (client RPC)    -> node-detached
        -> controller-unpublish (if any)  -> controller-detached
        -> checkpoint via Raft            -> ready-to-free -> freed

Each step is checkpointed through a ``CSIVolumeClaim`` Raft write so a
leader failover resumes where the previous leader stopped. The build
collapses the per-volume goroutines into one scan loop (volumes with no
past claims are skipped, so the loop is proportional to in-flight
releases, like the reference's watcher set).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.structs import csi as csi_structs

LOG = logging.getLogger(__name__)


class VolumesWatcher:
    def __init__(self, server, poll_interval: float = 0.2) -> None:
        self.server = server
        self.poll_interval = poll_interval
        self._enabled = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev, self._enabled = self._enabled, enabled
        if enabled and not prev:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="volume-watcher"
            )
            self._thread.start()

    def _run(self) -> None:
        from nomad_tpu_torch.telemetry.trace import tracer

        index = 0
        while self._enabled:
            index = self.server.state.block_until(
                ["allocs", "csi_volumes"], index, timeout=self.poll_interval
            )
            try:
                with tracer.span("bg.volumes"):
                    self.reap_once()
            except Exception as e:              # noqa: BLE001
                LOG.warning("volumewatcher: %s", e)

    def reap_once(self) -> int:
        """One pass over all volumes; returns number of claim
        transitions applied (volume_watcher.go volumeReapImpl)."""
        # every alloc commit wakes this loop; with no CSI volumes
        # registered even the (now O(1)) snapshot + volume scan is
        # pure overhead — one lock-free table-length read settles it
        if self.server.state.csi_volume_count() == 0:
            return 0
        snap = self.server.state.snapshot()
        transitions = 0
        for vol in snap.csi_volumes_iter():
            # terminal-alloc live claims become releases first
            # (volume_watcher.go collects pastClaims from terminal allocs)
            for claims in (vol.read_claims, vol.write_claims):
                for alloc_id, claim in list(claims.items()):
                    alloc = snap.alloc_by_id(alloc_id)
                    if alloc is None or alloc.terminal_status() \
                            or alloc.client_terminal_status():
                        self._checkpoint(vol, claim.release_copy())
                        transitions += 1
            for claim in list(vol.past_claims.values()):
                transitions += self._step(vol, claim)
        return transitions

    def _step(self, vol, claim) -> int:
        """Advance one past-claim through the unpublish pipeline."""
        state = claim.state
        if state == csi_structs.CLAIM_STATE_TAKEN:
            try:
                self.server.csi_node_unpublish(vol, claim)
            except Exception as e:              # noqa: BLE001
                LOG.warning("volumewatcher: node unpublish %s: %s", vol.id, e)
                return 0
            next_state = csi_structs.CLAIM_STATE_NODE_DETACHED
        elif state == csi_structs.CLAIM_STATE_NODE_DETACHED:
            plugin = self.server.csi_plugin_by_id(vol.plugin_id)
            if plugin is not None and plugin.controller_required:
                try:
                    self.server.csi_controller_unpublish(vol, claim)
                except Exception as e:          # noqa: BLE001
                    LOG.warning(
                        "volumewatcher: controller unpublish %s: %s", vol.id, e
                    )
                    return 0
            next_state = csi_structs.CLAIM_STATE_READY_TO_FREE
        elif state == csi_structs.CLAIM_STATE_CONTROLLER_DETACHED:
            next_state = csi_structs.CLAIM_STATE_READY_TO_FREE
        else:
            next_state = csi_structs.CLAIM_STATE_READY_TO_FREE
        self._checkpoint(vol, claim.release_copy(next_state))
        return 1

    def _checkpoint(self, vol, claim) -> None:
        self.server.raft_apply(fsm_msgs.CSI_VOLUME_CLAIM, {
            "namespace": vol.namespace,
            "volume_id": vol.id,
            "claim": claim,
        })
