"""Plan rejection tracker (Nomad 1.3's marquee robustness feature).

Reference behavior: nomad/plan_apply.go ``BadNodeTracker`` (1.3's
``plan_rejection_tracker`` config): a node whose plans keep getting
REJECTED by the applier's re-validation is usually a node whose client
state diverged from the servers' (a stuck fingerprint, a half-dead
kubelet-analog, the classic "node that eats the cluster" failure
mode). Every rejection sends the scheduler back for a refresh-retry
loop against the same broken node. The tracker counts per-node
rejections inside a sliding window and, past a threshold, marks the
node INELIGIBLE through the normal raft path so the scheduler simply
stops proposing onto it — converting an infinite retry storm into one
operator-visible eligibility flip.

Counters are exported as ``nomad_tpu_plan_rejection_*`` series
(telemetry/exporter.py) and surfaced in ``Server.stats()``; the
marking itself rides ``NODE_UPDATE_ELIGIBILITY`` so followers, the
event stream, and the store index all see it like any operator action.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from nomad_tpu_torch.utils.witness import witness_lock

#: reference defaults (plan_rejection_tracker { node_threshold,
#: node_window }) scaled to this repo's bench cadence
DEFAULT_NODE_THRESHOLD = 15
DEFAULT_NODE_WINDOW_S = 300.0


class PlanRejectionTracker:
    """Per-node rejection counting with a sliding window.

    ``note_rejection`` returns True exactly once per crossing: when a
    node's in-window count reaches the threshold (the caller then
    marks it ineligible and the node's count resets, so a node that is
    later un-marked and misbehaves again re-crosses cleanly).
    """

    def __init__(self, threshold: int = DEFAULT_NODE_THRESHOLD,
                 window_s: float = DEFAULT_NODE_WINDOW_S) -> None:
        self._lock = witness_lock("PlanRejectionTracker._lock")
        self.threshold = threshold
        self.window_s = window_s
        # node id -> (in-window count, window start monotonic)
        self._counts: Dict[str, tuple] = {}
        self.rejections = 0
        self.nodes_marked = 0

    def configure(self, threshold: int, window_s: float) -> None:
        with self._lock:
            self.threshold = threshold
            self.window_s = window_s

    def note_rejection(self, node_id: str) -> bool:
        """One rejected node plan; True when the node just crossed the
        threshold (caller marks it ineligible and reports the outcome
        via ``note_marked`` — the crossing itself is consumed either
        way, so a failed marking retries only after a fresh window of
        rejections, the reference's best-effort semantics)."""
        now = time.monotonic()
        with self._lock:
            self.rejections += 1
            count, start = self._counts.get(node_id, (0, now))
            if now - start > self.window_s:
                count, start = 0, now
            count += 1
            if len(self._counts) > 512:
                # opportunistic eviction: lapsed windows would
                # otherwise accumulate one stale tuple per node id
                # forever on a long-lived leader with node churn (and
                # inflate the tracked_nodes gauge)
                self._counts = {
                    nid: cs for nid, cs in self._counts.items()
                    if now - cs[1] <= self.window_s}
            if self.threshold > 0 and count >= self.threshold:
                # reset so a re-marked-eligible node re-crosses cleanly
                self._counts.pop(node_id, None)
                return True
            self._counts[node_id] = (count, start)
            return False

    def note_marked(self) -> None:
        """The caller's eligibility flip actually COMMITTED — counted
        here (not at the crossing) so the exported
        ``marked_ineligible`` series never reports a flip that a
        failed raft apply swallowed."""
        with self._lock:
            self.nodes_marked += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "rejections": self.rejections,
                "nodes_marked": self.nodes_marked,
                "tracked_nodes": len(self._counts),
                "threshold": self.threshold,
                "window_s": self.window_s,
            }

    def reset_stats(self) -> None:
        """Counters AND window state (bench/test cells)."""
        with self._lock:
            self._counts.clear()
            self.rejections = 0
            self.nodes_marked = 0


#: process-wide (the leader's planner feeds it; the exporter reads it
#: — the client_update_stats pattern). Thresholds come from the
#: owning server's config at construction.
plan_rejections = PlanRejectionTracker()
