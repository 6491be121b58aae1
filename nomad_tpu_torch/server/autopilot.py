"""Autopilot: raft peer health and dead-server cleanup.

Reference behavior: nomad/autopilot.go (+ the raft-autopilot library)
-- the leader continuously evaluates each raft peer's health (last
contact, log lag) against the operator-tunable AutopilotConfig (stored
in raft, schema.go autopilot-config; /v1/operator/autopilot/
configuration) and, when ``CleanupDeadServers`` is on, removes voters
that have been unreachable beyond the threshold so a replaced server
doesn't permanently shrink the quorum margin.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

LOG = logging.getLogger(__name__)


class Autopilot:
    def __init__(self, server, interval: float = 1.0) -> None:
        self.server = server
        self.interval = interval
        self._enabled = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # bumped on every enable; a sleeping loop from a previous
        # leadership term notices and exits instead of doubling up
        self._gen = 0
        # peer -> first time it was seen unhealthy (stabilization)
        self._unhealthy_since: Dict[str, float] = {}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev, self._enabled = self._enabled, enabled
            if enabled and not prev:
                self._gen += 1
                gen = self._gen
        if enabled and not prev:
            self._thread = threading.Thread(
                target=self._run, args=(gen,), daemon=True, name="autopilot"
            )
            self._thread.start()
        if not enabled:
            self._unhealthy_since.clear()

    def _run(self, gen: int) -> None:
        from nomad_tpu_torch.telemetry.trace import tracer

        while True:
            time.sleep(self.interval)
            with self._lock:
                if not self._enabled or self._gen != gen:
                    return
            try:
                with tracer.span("bg.autopilot"):
                    self.evaluate_once()
            except Exception as e:              # noqa: BLE001
                LOG.warning("autopilot: %s", e)

    def config(self) -> Dict:
        return self.server.state.autopilot_config

    def health(self) -> Dict:
        """/v1/operator/autopilot/health payload."""
        raft = self.server.raft
        cfg = self.config()
        threshold = cfg.get("last_contact_threshold_s", 10.0)
        servers: List[Dict] = []
        if raft is None:
            # single-process authority: one healthy pseudo-leader
            servers.append({
                "ID": self.server.config.name,
                "Leader": True, "Voter": True, "Healthy": True,
                "LastContact": 0.0,
                "LastIndex": self.server.state.latest_index(),
            })
        else:
            stats = raft.stats()
            servers.append({
                "ID": raft.id,
                "Leader": raft.is_leader(),
                "Voter": True,
                "Healthy": True,
                "LastContact": 0.0,
                "LastIndex": stats["last_log_index"],
            })
            for h in raft.server_health():
                servers.append({
                    "ID": h["id"],
                    "Leader": False,
                    "Voter": True,
                    "Healthy": h["last_contact_s"] < threshold,
                    "LastContact": (
                        h["last_contact_s"]
                        if h["last_contact_s"] != float("inf") else -1.0
                    ),
                    "LastIndex": h["match_index"],
                })
        n_healthy = sum(1 for s in servers if s["Healthy"])
        return {
            "Healthy": n_healthy > len(servers) // 2,
            "FailureTolerance": max(
                0, n_healthy - (len(servers) // 2 + 1)
            ),
            "Servers": servers,
        }

    def evaluate_once(self) -> List[str]:
        """One health pass; returns peers removed (autopilot
        pruneDeadServers)."""
        raft = self.server.raft
        if raft is None or not raft.is_leader():
            self._unhealthy_since.clear()
            return []
        cfg = self.config()
        if not cfg.get("cleanup_dead_servers", True):
            return []
        threshold = cfg.get("last_contact_threshold_s", 10.0)
        stabilization = cfg.get("server_stabilization_time_s", 10.0)
        now = time.time()
        removed: List[str] = []
        healths = raft.server_health()
        for h in healths:
            peer = h["id"]
            if h["last_contact_s"] < threshold:
                self._unhealthy_since.pop(peer, None)
                continue
            since = self._unhealthy_since.setdefault(peer, now)
            if now - since < stabilization:
                continue
            # never remove below a functioning majority of the
            # remaining set (pruneDeadServers quorum guard)
            n_peers = len(healths) + 1   # + leader
            n_failed = sum(
                1 for x in healths
                if x["last_contact_s"] >= threshold
            )
            if n_peers - n_failed <= n_peers // 2:
                LOG.warning(
                    "autopilot: not removing %s: would break quorum", peer
                )
                continue
            raft.remove_peer(peer)
            self._unhealthy_since.pop(peer, None)
            removed.append(peer)
        if removed:
            LOG.info("autopilot: removed dead servers %s", removed)
        return removed
