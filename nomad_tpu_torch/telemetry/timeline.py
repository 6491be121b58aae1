"""The failover timeline: CHAOS_TIMELINE.json.

The chaos/restart cells (bench/trace_report.py) assert that a cluster
CONVERGES through injected failures; this module makes the run
EXPLAIN itself. Every server's consensus events (raft/observe.py:
elections, term adoptions, step-downs, kills, recoveries, snapshot
installs, leadership establishment), the fault plane's firings
(utils/faultpoints.fire_log), and a bounded summary of the consensus
span stream merge into one causally-ordered timeline artifact:

- Ordering: events that pin a raft index are ordered BY INDEX (raft
  indexes are the cluster's causal spine — an apply of index i on any
  server happened-after the leader's append of i, whatever the local
  clocks say). Everything else orders by monotonic clock, per-server
  skew-corrected: a per-server offset is estimated so that no
  index-pinned event precedes the earliest same-index event of a
  lower-or-equal index (in-process cells share one clock and the
  offsets resolve to 0; the hook exists for multi-process cells).
- Failover phase attribution: each leadership loss opens a failover
  window that the named phases partition — ``detect`` (loss → first
  election round), ``elect`` (first round → leader won, failed rounds
  included), ``replay`` (leader won → server-side leadership
  established: broker flush/restore, barrier apply), and ``converge``
  (last establishment → the cell's quiesce stamp). The attribution
  share (named-phase wall over total failover wall) is the CI-gated
  quantity, the way TRACE_DECOMP's coverage is gated.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["build_timeline", "validate_timeline",
           "merge_into_artifact", "PHASES"]

#: failover phase names, lifecycle order
PHASES = ("detect", "elect", "replay", "converge")

#: events that mean "the cluster lost its leader" when the server was
#: leading (each opens a failover window)
_LOSS_KINDS = ("stepdown", "killed", "wal_failed")


#: index-pinned event kinds stamped by the index's CREATOR (the
#: leader) — every other server's same-index event is causally AFTER
#: these, which is what makes them usable as skew anchors. Observer
#: kinds (snapshot_install) may legally lag the anchor by transfer
#: time, so they can never anchor.
_CREATOR_KINDS = ("snapshot_sent",)


def _estimate_offsets(events: Sequence[Dict]) -> Dict[str, float]:
    """Per-server monotonic-clock offsets from index-pinned causality:
    a raft index's CREATOR event (the leader's stamp) anchors it; a
    DIFFERENT server whose same-index event sits EARLIER than the
    anchor after correction has a clock behind by at least the
    difference and gets shifted forward. Indexes with no creator event
    contribute no anchor (an early observer stamp proves nothing —
    observers legally lag the creation by transfer time), so
    shared-clock (in-process) cells resolve to all-zero offsets."""
    anchors: Dict[int, Tuple[float, str]] = {}
    for ev in events:
        idx = ev.get("index")
        if idx is None or ev["kind"] not in _CREATOR_KINDS:
            continue
        t = ev["t"]
        # a per-peer re-send repeats the creator stamp; the EARLIEST
        # is the true creation lower bound
        if idx not in anchors or t < anchors[idx][0]:
            anchors[idx] = (t, ev["server"])
    offsets: Dict[str, float] = {}
    for ev in events:
        idx = ev.get("index")
        if idx is None or idx not in anchors:
            continue
        anchor_t, anchor_server = anchors[idx]
        if ev["server"] == anchor_server:
            continue
        # causality: an index-pinned event cannot precede the index's
        # creation; if this server's clock says it did, its clock is
        # behind by at least the difference
        lag = anchor_t - (ev["t"] + offsets.get(ev["server"], 0.0))
        if lag > 0.0:
            offsets[ev["server"]] = offsets.get(ev["server"], 0.0) + lag
    return offsets


def _order_events(events: Sequence[Dict],
                  offsets: Optional[Dict[str, float]] = None) -> List[Dict]:
    """Causal order: skew-corrected monotonic sort, then the
    index-pinned subsequence is re-ordered by raft index in place
    (positions stay where the clocks put them; VALUES obey the index
    spine — the standard pinned-subsequence discipline)."""
    if offsets is None:
        offsets = _estimate_offsets(events)
    rows = [dict(ev) for ev in events]
    for ev in rows:
        ev["t_corrected"] = ev["t"] + offsets.get(ev["server"], 0.0)
    rows.sort(key=lambda e: e["t_corrected"])
    pinned_pos = [i for i, e in enumerate(rows) if e.get("index")]
    pinned = sorted((rows[i] for i in pinned_pos),
                    key=lambda e: (e["index"], e["t_corrected"]))
    for pos, ev in zip(pinned_pos, pinned):
        rows[pos] = ev
    return rows


def _failovers(ordered: List[Dict],
               converged_mono: Optional[float]) -> List[Dict]:
    """Scan the ordered events into failover windows with per-phase
    attribution. Phases partition loss→established by construction;
    anything un-spanned (a missing event) stays unattributed and
    lowers the share — honest, never hidden.

    A PARTITIONED leader never emits a loss event (it still thinks it
    leads until the heal), so its failover is detected from the other
    side: a server winning leadership away from a tracked leader that
    never reported loss opens a ``partition`` window, backdated to
    that server's election start. The mirror case — the stale
    leader's stepdown when the heal delivers it the higher term — is
    NOT a leadership loss (the cluster already moved on), so loss
    events from a superseded leader are dropped rather than opening a
    window that no election will ever close."""
    out: List[Dict] = []
    open_fo: Optional[Dict] = None
    cur_leader: Optional[str] = None
    last_elect: Dict[str, float] = {}
    for ev in ordered:
        kind, t = ev["kind"], ev["t_corrected"]
        was_leader = bool((ev.get("detail") or {}).get("was_leader"))
        if kind == "election_start":
            last_elect[ev["server"]] = t
        # only the LEADER's loss opens a failover — a killed or
        # fail-stopped follower is an event, not a leadership loss
        # (every loss-kind emitter stamps detail.was_leader)
        if kind in _LOSS_KINDS and was_leader:
            if cur_leader is not None and ev["server"] != cur_leader:
                # stale-leader correction after a heal: leadership
                # already moved (tracked from the winner's side)
                continue
            if open_fo is None:
                open_fo = {"loss_t": t, "loss_kind": kind,
                           "leader_from": ev["server"],
                           "term_from": ev.get("term")}
            continue
        if kind == "leader_won" and open_fo is None \
                and cur_leader is not None and ev["server"] != cur_leader:
            # leadership moved without a loss event: the old leader is
            # partitioned, not dead. Backdate to the winner's election
            # start so detect/elect stay honestly attributed.
            loss_t = last_elect.get(ev["server"], t)
            open_fo = {"loss_t": loss_t, "loss_kind": "partition",
                       "leader_from": cur_leader,
                       "term_from": None,
                       "elect_t": loss_t}
        if kind == "leader_won":
            cur_leader = ev["server"]
        if open_fo is None:
            continue
        if kind == "election_start" and "elect_t" not in open_fo:
            open_fo["elect_t"] = t
        elif kind == "leader_won" and "won_t" not in open_fo:
            open_fo["won_t"] = t
            open_fo["leader_to"] = ev["server"]
            open_fo["term_to"] = ev.get("term")
        elif kind == "established" and "won_t" in open_fo:
            open_fo["established_t"] = t
            out.append(open_fo)
            open_fo = None
    if open_fo is not None:
        if "won_t" not in open_fo:
            # leadership lost and never re-won before the cell ended:
            # the worst failover must not vanish from the timeline —
            # keep the window (closed at the cell's end stamp below)
            # with the un-elected tail left unattributed, so the
            # share drops instead of reading 1.0
            open_fo["unresolved"] = True
        # else: leadership won but establishment never observed (e.g.
        # the cell stopped first) — keep the partial window,
        # unattributed tail included
        out.append(open_fo)

    rendered = []
    for k, fo in enumerate(out):
        loss = fo["loss_t"]
        elect_t = fo.get("elect_t")
        won_t = fo.get("won_t")
        est_t = fo.get("established_t")
        end = est_t if est_t is not None else (won_t or loss)
        if fo.get("unresolved"):
            last_t = ordered[-1]["t_corrected"] if ordered else loss
            end = max(converged_mono if converged_mono is not None
                      else last_t, loss)
        phases = {
            "detect": max(elect_t - loss, 0.0)
            if elect_t is not None else 0.0,
            "elect": max(won_t - elect_t, 0.0)
            if elect_t is not None and won_t is not None else 0.0,
            "replay": max(est_t - won_t, 0.0)
            if est_t is not None and won_t is not None else 0.0,
            "converge": 0.0,
        }
        if k == len(out) - 1 and converged_mono is not None \
                and est_t is not None and converged_mono > est_t:
            phases["converge"] = converged_mono - est_t
            end = converged_mono
        total = max(end - loss, 0.0)
        attributed = sum(phases.values())
        rendered.append({
            "loss_kind": fo["loss_kind"],
            "resolved": not fo.get("unresolved", False),
            "leader_from": fo.get("leader_from"),
            "leader_to": fo.get("leader_to"),
            "term_from": fo.get("term_from"),
            "term_to": fo.get("term_to"),
            "start_t": loss,
            "total_ms": round(total * 1e3, 3),
            "phases_ms": {p: round(phases[p] * 1e3, 3) for p in PHASES},
            "attributed_ms": round(attributed * 1e3, 3),
            "attributed_share": round(attributed / total, 4)
            if total > 0 else 1.0,
        })
    return rendered


def build_timeline(events: Sequence[Dict],
                   fault_fires: Sequence[Dict] = (),
                   span_summary: Optional[Dict[str, int]] = None,
                   converged_mono: Optional[float] = None,
                   offsets: Optional[Dict[str, float]] = None,
                   cell: str = "") -> Dict:
    """Merge one cell's consensus events + fault firings (+ a span
    summary) into the CHAOS_TIMELINE shape. ``converged_mono`` is the
    cell's quiesce stamp (monotonic) closing the last failover's
    converge phase."""
    if offsets is None:
        offsets = _estimate_offsets(events)
    ordered = _order_events(events, offsets)
    failovers = _failovers(ordered, converged_mono)
    stamps = [e["t_corrected"] for e in ordered]
    stamps += [f["t"] for f in fault_fires]
    t0 = min(stamps) if stamps else 0.0

    total_ms = sum(f["total_ms"] for f in failovers)
    attributed_ms = sum(f["attributed_ms"] for f in failovers)
    per_server: Dict[str, int] = {}
    for ev in ordered:
        per_server[ev["server"]] = per_server.get(ev["server"], 0) + 1
    return {
        "cell": cell,
        "events": [
            {
                "t_ms": round((ev["t_corrected"] - t0) * 1e3, 3),
                "server": ev["server"],
                "kind": ev["kind"],
                **{k: ev[k] for k in ("term", "index", "detail")
                   if k in ev},
            }
            for ev in ordered
        ],
        "fault_fires": [
            {"t_ms": round((f["t"] - t0) * 1e3, 3),
             "point": f["point"], "kind": f["kind"]}
            for f in fault_fires
        ],
        "servers": per_server,
        "clock_offsets_ms": {s: round(o * 1e3, 3)
                             for s, o in offsets.items() if o},
        "span_summary": span_summary or {},
        "failovers": failovers,
        "attribution": {
            "failover_wall_ms": round(total_ms, 3),
            "attributed_ms": round(attributed_ms, 3),
            "share": round(attributed_ms / total_ms, 4)
            if total_ms > 0 else 1.0,
        },
    }


def validate_timeline(tl: Dict) -> List[str]:
    """Shape check for the CI gates (the TRACE_DECOMP discipline):
    returns the list of problems, empty when the artifact is valid."""
    problems: List[str] = []
    for key in ("cell", "events", "fault_fires", "servers",
                "failovers", "attribution"):
        if key not in tl:
            problems.append(f"missing key {key!r}")
    if problems:
        return problems
    last = -1.0
    for i, ev in enumerate(tl["events"]):
        for key in ("t_ms", "server", "kind"):
            if key not in ev:
                problems.append(f"event {i} missing {key!r}")
        if "index" in ev:
            # index-pinned events sit where causality puts them; their
            # clock stamps may legally back-step vs neighbors
            continue
        t = ev.get("t_ms", 0.0)
        if t < last - 1e-6:
            problems.append(
                f"event {i} out of order ({t} after {last})")
        last = t
    # index-pinned events must be monotone in index
    pinned = [ev["index"] for ev in tl["events"] if "index" in ev]
    if pinned != sorted(pinned):
        problems.append("index-pinned events violate raft-index order")
    for i, fo in enumerate(tl["failovers"]):
        phases = fo.get("phases_ms", {})
        if set(phases) != set(PHASES):
            problems.append(f"failover {i} phases {sorted(phases)}")
            continue
        if fo["attributed_ms"] > fo["total_ms"] + 1e-6:
            problems.append(f"failover {i} over-attributed")
    att = tl["attribution"]
    if not (0.0 <= att.get("share", -1) <= 1.0):
        problems.append(f"attribution share {att.get('share')}")
    return problems


def merge_into_artifact(path: str, section: str, tl: Dict,
                        summary_extra: Optional[Dict] = None) -> Dict:
    """Write ``tl`` under ``section`` of the CHAOS_TIMELINE.json
    artifact, merging with whatever other cells already wrote, and
    refresh the top-level attribution summary across sections."""
    doc: Dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
    sections = doc.get("cells", {})
    sections[section] = tl
    total = sum(c["attribution"]["failover_wall_ms"]
                for c in sections.values())
    attributed = sum(c["attribution"]["attributed_ms"]
                     for c in sections.values())
    # earlier cells' summary_extra keys survive later merges: start
    # from the existing doc and overwrite only the recomputed keys
    doc.pop("cells", None)
    doc.update({
        "cells": sections,
        "failovers": sum(len(c["failovers"]) for c in sections.values()),
        "events": sum(len(c["events"]) for c in sections.values()),
        "fault_fires": sum(len(c["fault_fires"])
                           for c in sections.values()),
        "attribution": {
            "failover_wall_ms": round(total, 3),
            "attributed_ms": round(attributed, 3),
            "share": round(attributed / total, 4) if total > 0 else 1.0,
        },
    })
    if summary_extra:
        doc.update(summary_extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    return doc
