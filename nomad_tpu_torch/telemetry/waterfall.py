"""Per-eval critical-path waterfalls and tail aggregation.

TRACE_DECOMP's stage table answers "where does the *mean* eval
millisecond go"; the tail question — why is p99 4.6x p50 (BENCH_r05:
plan p99 59ms vs p50 26ms) — needs the decomposition *per eval*, then
compared between the median cohort and the slowest cohort. This module
reduces one eval's span tree (everything sharing its ``trace_id``,
which IS the eval id on the instrumented hot path) to an ordered,
non-overlapping segment waterfall over the eval's e2e window
(broker-enqueue → commit, carried by the ``eval.e2e`` marker span the
worker records at ack time), then aggregates waterfalls into the
``tail`` table: per-segment latency share at p50 vs at p99.

Reduction rules (Dapper-style critical path, adapted to this repo's
concurrency shape):

- Per-trace spans claim their own wall intervals, most-specific first
  (``plan.queue_wait`` beats ``plan.wait`` beats ``eval.schedule``) —
  a child's time never double-counts against its envelope.
- The applier/FSM spans are *batch* envelopes on other threads and
  carry no per-eval trace id; for each eval they claim, by time
  overlap, the part of that eval's ``plan.wait`` window they cover.
  That is exactly the critical-path semantics: while the worker blocks
  in submit, whatever the applier is doing IS this eval's latency.
- ``dequeue-wait`` is the gap from broker enqueue to the eval's
  schedule span — ready-queue time plus the batch's shared
  snapshot/fan-out (those spans carry the batch leader's trace id, so
  for the other members they are honest queue-shaped waiting).
- Whatever no rule claims is reported as ``other``, never hidden —
  coverage (claimed / e2e) is a CI gate, not an assumption.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from nomad_tpu_torch.telemetry.histogram import percentile

__all__ = ["build_waterfall", "build_waterfalls", "aggregate_tail",
           "SEGMENT_ORDER"]

#: waterfall display order (≈ lifecycle order). The raft-* segments
#: live INSIDE the commit window: replicate (AppendEntries
#: on the wire), fsync (the leader's group fsync), quorum (append →
#: majority commit residue), apply (raft apply-loop dispatch around
#: the FSM).
SEGMENT_ORDER = [
    "dequeue-wait", "snapshot", "schedule", "park", "launch",
    "plan-queue", "evaluate", "commit", "raft-replicate", "raft-fsync",
    "raft-quorum", "raft-apply", "fsm", "plan-wait", "other",
]

#: per-trace span name -> (segment, claim priority). Higher priority
#: claims wall first; lower-priority intervals keep only what is left.
_PER_TRACE = {
    "plan.queue_wait": ("plan-queue", 90),
    "wave.launch": ("launch", 80),
    "wave.park": ("park", 70),
    "worker.snapshot": ("snapshot", 60),
    "plan.wait": ("plan-wait", 20),
    "eval.schedule": ("schedule", 10),
}

#: batch-envelope span names (no per-eval trace id): claimed by
#: overlap with the eval's plan.wait window. fsm nests inside commit
#: and per-plan evaluation inside the evaluate envelope, so priority
#: runs leaf-out. The raft segments follow the same
#: greedy-interval discipline inside the commit envelope: fsync and
#: replicate are disjoint leaf windows on the disk/network threads
#: (claimed first), quorum is the append→commit window residue those
#: two leave behind, raft-apply wraps the FSM dispatch so fsm (110)
#: claims first and raft-apply keeps the dispatch residue — together
#: they PARTITION the commit window exactly (property-tested in
#: tests/test_consensus_observability.py).
_GLOBAL = {
    "raft.fsync": ("raft-fsync", 130),
    "raft.replicate": ("raft-replicate", 125),
    "raft.quorum": ("raft-quorum", 112),
    "fsm.apply": ("fsm", 110),
    "raft.apply": ("raft-apply", 108),
    "plan.commit": ("commit", 105),
    "plan.evaluate": ("evaluate", 100),
}

_E2E_SPAN = "eval.e2e"

_Interval = Tuple[float, float]


def _clip(iv: _Interval, lo: float, hi: float) -> Optional[_Interval]:
    s, e = max(iv[0], lo), min(iv[1], hi)
    return (s, e) if e > s else None


def _subtract(iv: _Interval,
              claimed: Sequence[_Interval]) -> List[_Interval]:
    """``iv`` minus the (sorted, disjoint) claimed intervals."""
    out: List[_Interval] = []
    s, e = iv
    for cs, ce in claimed:
        if ce <= s:
            continue
        if cs >= e:
            break
        if cs > s:
            out.append((s, cs))
        s = max(s, ce)
        if s >= e:
            break
    if s < e:
        out.append((s, e))
    return out


def _claim(claimed: List[_Interval], iv: _Interval) -> float:
    """Claim ``iv``'s unclaimed part; returns the seconds claimed and
    keeps ``claimed`` sorted + disjoint."""
    got = _subtract(iv, claimed)
    if not got:
        return 0.0
    claimed.extend(got)
    claimed.sort()
    # merge adjacency so the list stays small
    merged: List[_Interval] = []
    for s, e in claimed:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    claimed[:] = merged
    return sum(e - s for s, e in got)


def build_waterfall(trace_spans: Sequence,
                    global_spans: Sequence = ()) -> Optional[Dict]:
    """Reduce one eval's spans to its critical-path waterfall.

    ``trace_spans``: every span with the eval's trace id (must include
    the ``eval.e2e`` marker). ``global_spans``: applier/FSM batch
    envelopes (any trace id); only their overlap with this eval's
    ``plan.wait`` windows is attributed. Returns None when no e2e
    marker exists (the eval never committed, or the ring wrapped past
    it).
    """
    e2e = None
    for s in trace_spans:
        if s.name == _E2E_SPAN:
            e2e = s
    if e2e is None:
        return None
    w0, w1 = e2e.start_s, e2e.start_s + e2e.dur_s
    if w1 <= w0:
        return None

    # candidate claims: (priority, order, segment, interval)
    cands: List[Tuple[int, int, str, _Interval]] = []
    sched_start = None
    wait_windows: List[_Interval] = []
    for s in trace_spans:
        tgt = _PER_TRACE.get(s.name)
        if tgt is None:
            continue
        iv = _clip((s.start_s, s.start_s + s.dur_s), w0, w1)
        if iv is None:
            continue
        seg, prio = tgt
        cands.append((prio, len(cands), seg, iv))
        if s.name == "eval.schedule":
            sched_start = iv[0] if sched_start is None \
                else min(sched_start, iv[0])
        elif s.name == "plan.wait":
            wait_windows.append(iv)
    for s in global_spans:
        tgt = _GLOBAL.get(s.name)
        if tgt is None:
            continue
        seg, prio = tgt
        for win in wait_windows:
            iv = _clip((s.start_s, s.start_s + s.dur_s), win[0], win[1])
            if iv is not None:
                cands.append((prio, len(cands), seg, iv))
    if sched_start is not None and sched_start > w0:
        cands.append((15, len(cands), "dequeue-wait", (w0, sched_start)))

    claimed: List[_Interval] = []
    segments: Dict[str, float] = {}
    for prio, _, seg, iv in sorted(cands, key=lambda c: -c[0]):
        got = _claim(claimed, iv)
        if got > 0.0:
            segments[seg] = segments.get(seg, 0.0) + got
    covered = sum(e - s for s, e in claimed)
    e2e_s = w1 - w0
    other = max(e2e_s - covered, 0.0)
    if other > 0.0:
        segments["other"] = other
    return {
        "trace_id": e2e.trace_id,
        "e2e_s": e2e_s,
        "segments": segments,
        "covered_s": covered,
        "coverage": covered / e2e_s,
    }


def build_waterfalls(spans: Iterable) -> List[Dict]:
    """Group a span dump by trace id and reduce every eval that has an
    ``eval.e2e`` marker."""
    by_trace: Dict[str, List] = {}
    global_spans: List = []
    for s in spans:
        if s.name in _GLOBAL:
            global_spans.append(s)
        elif s.trace_id:
            by_trace.setdefault(s.trace_id, []).append(s)
    out = []
    for trace_spans in by_trace.values():
        wf = build_waterfall(trace_spans, global_spans)
        if wf is not None:
            out.append(wf)
    return out


def aggregate_tail(waterfalls: List[Dict],
                   p50_band: Tuple[float, float] = (0.25, 0.75),
                   tail_q: float = 0.99) -> Dict:
    """Fold per-eval waterfalls into the TRACE_DECOMP ``tail`` table:
    per-segment latency share for the median cohort (evals between the
    p50 band's quantiles) vs the tail cohort (evals at/above the
    ``tail_q`` latency). Shares are cohort-sum over cohort-sum — the
    "of a p99 eval's milliseconds, how many went to segment X"
    quantity.
    """
    if not waterfalls:
        return {"e2e_count": 0, "segments": {}, "p50_coverage": 0.0,
                "p99_coverage": 0.0, "p50_cohort": 0, "p99_cohort": 0}
    lats = [w["e2e_s"] for w in waterfalls]
    lo = percentile(lats, p50_band[0])
    hi = percentile(lats, p50_band[1])
    tail_cut = percentile(lats, tail_q)
    # both cohorts are non-empty by construction: nearest-rank
    # percentile returns an actual sample, so the waterfall carrying
    # ``lo`` is in the band and the max is always >= tail_cut
    mid = [w for w in waterfalls if lo <= w["e2e_s"] <= hi]
    tail = [w for w in waterfalls if w["e2e_s"] >= tail_cut]

    def cohort(rows: List[Dict]) -> Tuple[Dict[str, float], float, float]:
        tot = sum(w["e2e_s"] for w in rows)
        segs: Dict[str, float] = {}
        for w in rows:
            for seg, secs in w["segments"].items():
                segs[seg] = segs.get(seg, 0.0) + secs
        cov = sum(w["covered_s"] for w in rows)
        return segs, tot, cov

    mid_segs, mid_tot, mid_cov = cohort(mid)
    tail_segs, tail_tot, tail_cov = cohort(tail)
    table: Dict[str, Dict] = {}
    for seg in SEGMENT_ORDER:
        m, t = mid_segs.get(seg, 0.0), tail_segs.get(seg, 0.0)
        if m == 0.0 and t == 0.0:
            continue
        table[seg] = {
            "p50_ms": round(m / len(mid) * 1e3, 4),
            "p50_share": round(m / mid_tot, 4) if mid_tot else 0.0,
            "p99_ms": round(t / len(tail) * 1e3, 4),
            "p99_share": round(t / tail_tot, 4) if tail_tot else 0.0,
        }
    slowest = sorted(waterfalls, key=lambda w: -w["e2e_s"])[:3]
    return {
        "e2e_count": len(waterfalls),
        "e2e_p50_ms": round(percentile(lats, 0.5) * 1e3, 3),
        "e2e_p90_ms": round(percentile(lats, 0.9) * 1e3, 3),
        "e2e_p99_ms": round(percentile(lats, 0.99) * 1e3, 3),
        "segments": table,
        # the coverage gates: "other" is excluded from covered_s by
        # construction, so this is the fraction of cohort latency the
        # NAMED segments explain
        "p50_coverage": round(mid_cov / mid_tot, 4) if mid_tot else 0.0,
        "p99_coverage": round(tail_cov / tail_tot, 4)
        if tail_tot else 0.0,
        "p50_cohort": len(mid),
        "p99_cohort": len(tail),
        "slowest": [
            {"trace_id": w["trace_id"],
             "e2e_ms": round(w["e2e_s"] * 1e3, 3),
             "segments_ms": {k: round(v * 1e3, 3)
                             for k, v in sorted(
                                 w["segments"].items(),
                                 key=lambda kv: -kv[1])}}
            for w in slowest
        ],
    }
