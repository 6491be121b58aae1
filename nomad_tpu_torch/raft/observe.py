"""Consensus-plane observability: per-server raft stats + event log.

A cluster plane without this is observability-dark
— ``make_cluster`` servers blended into one process-global registry,
and a red chaos run was diagnosed by reading logs. This module is the
per-server substrate the rest of the consensus observability layer
builds on:

- :class:`RaftObserver` — a process-wide registry of per-``server_id``
  consensus stats (term/state/commit gauges read live from the node,
  election/term/step-down transition counters, per-peer replication
  lag, snapshot-transfer meters). Exported with a ``server_id`` label
  (telemetry/exporter.py), so a 3-node in-process cluster reports
  three distinguishable truths instead of one blended one.
- the **consensus event log** — a bounded, monotonic-stamped ring of
  election/term/leadership/recovery events across every server in the
  process. The failover timeline (telemetry/timeline.py) merges it
  with fault-point firings and span streams into the causally-ordered
  ``CHAOS_TIMELINE.json`` artifact the chaos/restart cells emit.

Cost discipline: recording a transition event is one bounded deque
append under a small witness lock — elections and step-downs are rare.
Per-RPC costs live in raft/node.py and are O(ns-µs) with tracing off
(a dict store for the append stamp, an always-on histogram record per
commit advance — the histogram budget).
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from nomad_tpu_torch.utils.witness import witness_lock

__all__ = ["RaftObserver", "raft_observer"]

#: consensus event kinds the timeline understands (docs/TELEMETRY.md
#: "Consensus plane"); anything else is carried verbatim
EVENT_KINDS = (
    "election_start", "leader_won", "term_adopt", "stepdown",
    "killed", "wal_failed", "recovery", "snapshot_install",
    "established", "revoked", "converged", "lease_expired",
)

#: most servers ever tracked (tests boot hundreds of short-lived
#: servers; the observer must not grow with them)
_MAX_SERVERS = 64
#: consensus events retained (a chaos cell produces tens, not
#: thousands — elections are rare by construction)
_MAX_EVENTS = 4096


class _ServerObs:
    """One server's consensus counters. The live gauges (term, state,
    commit index, per-peer lag) are read from the node itself at
    snapshot time through a weakref — counters survive the node."""

    __slots__ = ("server_id", "node_ref", "transitions",
                 "replicated_entries", "peer_lag_ms", "xfer_bytes",
                 "registered_mono")

    def __init__(self, server_id: str) -> None:
        self.server_id = server_id
        self.node_ref = None
        #: kind -> count (election/leader/term/stepdown/recovery)
        self.transitions: Dict[str, int] = {}
        #: peer -> entries acked by that peer (leader-side)
        self.replicated_entries: Dict[str, int] = {}
        #: peer -> newest observed append->ack lag in ms (leader-side)
        self.peer_lag_ms: Dict[str, float] = {}
        #: direction ("sent"/"received") -> snapshot transfer bytes
        self.xfer_bytes: Dict[str, int] = {}
        self.registered_mono = time.monotonic()


class RaftObserver:
    """Process-wide per-server consensus stats + the shared event log.

    Lock order: the observer lock is a LEAF — nothing is called while
    holding it except dict/deque operations. Live-node reads at
    snapshot time happen OUTSIDE the lock (the node's own lock guards
    them), so ``observer -> node`` never nests.
    """

    def __init__(self) -> None:
        self._lock = witness_lock("raft.observe.RaftObserver._lock")
        self._servers: Dict[str, _ServerObs] = {}
        self._events: deque = deque(maxlen=_MAX_EVENTS)

    # --- registration ----------------------------------------------------

    def register(self, server_id: str, node=None) -> None:
        """Register (or RE-register: a restarted server takes over its
        id, keeping accumulated counters for timeline continuity)."""
        with self._lock:
            obs = self._servers.get(server_id)
            if obs is None:
                if len(self._servers) >= _MAX_SERVERS:
                    oldest = min(self._servers.values(),
                                 key=lambda o: o.registered_mono)
                    del self._servers[oldest.server_id]
                obs = self._servers[server_id] = _ServerObs(server_id)
            obs.registered_mono = time.monotonic()
            obs.node_ref = weakref.ref(node) if node is not None else None

    def unregister(self, server_id: str) -> None:
        """Drop the live-node ref (shutdown); counters + events stay."""
        with self._lock:
            obs = self._servers.get(server_id)
            if obs is not None:
                obs.node_ref = None

    # --- recording -------------------------------------------------------

    def note_event(self, server_id: str, kind: str,
                   term: Optional[int] = None,
                   index: Optional[int] = None,
                   detail: Optional[Dict] = None) -> None:
        """Append one consensus event to the shared ring (the timeline
        feed). Bounded; cheap; safe from any thread."""
        ev = {
            "t": time.monotonic(),
            "wall": time.time(),
            "server": server_id,
            "kind": kind,
        }
        if term is not None:
            ev["term"] = term
        if index is not None:
            ev["index"] = index
        if detail:
            ev["detail"] = detail
        with self._lock:
            self._events.append(ev)

    def note_transition(self, server_id: str, kind: str) -> None:
        with self._lock:
            obs = self._servers.get(server_id)
            if obs is not None:
                obs.transitions[kind] = obs.transitions.get(kind, 0) + 1

    def note_replicated(self, server_id: str, peer: str, entries: int,
                        lag_ms: Optional[float] = None) -> None:
        """Leader-side: ``entries`` acked by ``peer``; ``lag_ms`` is
        the newest append->ack latency when an append stamp existed."""
        with self._lock:
            obs = self._servers.get(server_id)
            if obs is None:
                return
            obs.replicated_entries[peer] = (
                obs.replicated_entries.get(peer, 0) + entries)
            if lag_ms is not None:
                obs.peer_lag_ms[peer] = lag_ms

    def note_snapshot_xfer(self, server_id: str, direction: str,
                           nbytes: int) -> None:
        with self._lock:
            obs = self._servers.get(server_id)
            if obs is not None:
                obs.xfer_bytes[direction] = (
                    obs.xfer_bytes.get(direction, 0) + nbytes)

    # --- introspection ---------------------------------------------------

    def staleness_ms(self, server_id: str) -> Optional[float]:
        """Leader-attributed replication staleness for ``server_id``:
        the newest append->ack lag any leader recorded for it as a
        peer (read plane). Multiple observers may carry an
        entry (a deposed leader's last measurement lingers); the MAX
        wins — the meter may overstate staleness, never understate
        it. None when no leader ever measured this server."""
        with self._lock:
            worst: Optional[float] = None
            for obs in self._servers.values():
                lag = obs.peer_lag_ms.get(server_id)
                if lag is not None and (worst is None or lag > worst):
                    worst = lag
            return worst

    def events(self, since_mono: float = 0.0) -> List[Dict]:
        """The consensus event ring, oldest first (the timeline feed).
        ``since_mono`` filters to events at/after a monotonic stamp."""
        with self._lock:
            out = list(self._events)
        if since_mono:
            out = [e for e in out if e["t"] >= since_mono]
        return out

    def snapshot(self) -> Dict[str, Dict]:
        """Per-server stats for the exporter: counters from the
        observer, live gauges from the node (read outside the lock)."""
        with self._lock:
            rows = [(obs.server_id, obs.node_ref,
                     dict(obs.transitions),
                     dict(obs.replicated_entries),
                     dict(obs.peer_lag_ms), dict(obs.xfer_bytes))
                    for obs in self._servers.values()]
        out: Dict[str, Dict] = {}
        for sid, ref, transitions, replicated, lag_ms, xfer in rows:
            row = {
                "transitions": transitions,
                "replicated_entries": replicated,
                "peer_lag_ms": lag_ms,
                "snapshot_xfer_bytes": xfer,
                "live": False,
            }
            node = ref() if ref is not None else None
            if node is not None:
                try:
                    row.update(node.observe_gauges())
                    row["live"] = True
                except Exception:               # noqa: BLE001
                    pass        # node mid-shutdown: counters only
            out[sid] = row
        return out

    def reset_stats(self) -> None:
        """Clear counters + events (burst windowing, telemetry.reset).
        Registrations (live-node refs) survive."""
        with self._lock:
            self._events.clear()
            for obs in self._servers.values():
                obs.transitions.clear()
                obs.replicated_entries.clear()
                obs.peer_lag_ms.clear()
                obs.xfer_bytes.clear()


#: process-wide observer (telemetry/exporter.py + timeline feed)
raft_observer = RaftObserver()
