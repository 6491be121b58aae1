"""Streaming log-bucketed latency histograms.

TRACE_DECOMP attributes *mean* per-eval milliseconds; the open-item-4
contention gate ("e2e p99 plan latency holds") is a *distribution*
question the per-stage aggregates structurally cannot answer. This
module is the distribution substrate: bounded-memory streaming
histograms in the Prometheus classic-histogram shape, cheap enough to
record on the eval hot path, mergeable across workers, with quantile
estimation whose error is bounded by the bucket geometry.

Design constraints, in order:

- **Thread-cheap.** ``record`` is one ``math.log``, one short lock,
  three adds — no allocation, no sort, no deque growth. Safe to call
  per eval / per wave / per plan whether or not tracing is enabled.
- **Bounded.** Fixed bucket table (geometric, ``GROWTH`` = 2^0.25 per
  bucket, 1µs … ~54min + overflow). Memory never grows with traffic.
- **Mergeable.** All histograms share one static bound table, so merge
  is element-wise addition — associative and commutative, the property
  that lets per-worker histograms fold into one exposition.
- **Bounded-error quantiles.** ``quantile`` returns the geometric
  midpoint of the bucket holding the nearest-rank order statistic:
  relative error ≤ sqrt(GROWTH) − 1 ≈ 9.1% against the exact value
  (property-tested against ``numpy.percentile`` in
  tests/test_tail_latency.py).

``percentile()`` is the shared *exact* quantile helper for call sites
that already hold a small sample list — it replaces the two
independently-grown ``int(len*0.99)`` sorted-list hacks that used to
live in parallel/coalesce.py and bench.py (both off by one at the
tail: ``int(100*0.99) == 99`` indexes the MAX, not the 99th
percentile, of a 100-sample list).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "GROWTH", "LatencyHistogram", "HistogramRegistry", "histograms",
    "percentile",
]

#: per-bucket growth factor. 2^0.25 keeps midpoint-estimate relative
#: error under ~9.1% while 128 buckets still span 1µs → ~54 minutes —
#: wide enough for any eval latency this system can produce.
GROWTH = 2.0 ** 0.25
#: lower edge of bucket 0 (everything at or below lands there)
MIN_S = 1e-6
#: finite buckets; index N_BUCKETS is the +Inf overflow bucket
N_BUCKETS = 128

_LOG_GROWTH = math.log(GROWTH)
#: upper bounds of the finite buckets: bucket i covers
#: (BOUNDS[i-1], BOUNDS[i]], bucket 0 covers (0, MIN_S].
BOUNDS: Tuple[float, ...] = tuple(
    MIN_S * GROWTH ** i for i in range(N_BUCKETS)
)


def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile of a small sample.

    ``q`` in [0, 1]. Sorts a copy, so the input may be any sequence in
    any order (callers holding an already-sorted list pay one O(n)
    verification pass inside sort). Nearest-rank: the smallest value
    with at least ``ceil(q*n)`` samples at or below it — the standard
    definition, which for q=0.99 over 100 samples is element 98
    (0-indexed), NOT element 99 (the max) that ``int(n*0.99)``
    indexing returns.
    """
    if not values:
        return 0.0
    vs = sorted(values)
    if q <= 0.0:
        return vs[0]
    rank = min(math.ceil(q * len(vs)), len(vs))
    return vs[max(rank, 1) - 1]


def bucket_index(seconds: float) -> int:
    """Index of the bucket covering ``seconds`` (shared static table)."""
    if seconds <= MIN_S:
        return 0
    # ceil with a tiny epsilon so exact bound values stay in their
    # bucket instead of spilling up on float noise
    idx = int(math.ceil(math.log(seconds / MIN_S) / _LOG_GROWTH - 1e-9))
    return idx if idx <= N_BUCKETS else N_BUCKETS


class LatencyHistogram:
    """One named latency distribution. All instances share BOUNDS."""

    __slots__ = ("name", "_lock", "_counts", "_sum", "_count", "_max")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._counts = [0] * (N_BUCKETS + 1)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    # --- recording ------------------------------------------------------

    def record(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        idx = bucket_index(seconds)
        with self._lock:
            self._counts[idx] += 1
            self._sum += seconds
            self._count += 1
            if seconds > self._max:
                self._max = seconds

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other`` into this histogram (element-wise adds over
        the shared bound table: associative, commutative)."""
        with other._lock:
            counts = list(other._counts)
            o_sum, o_count, o_max = other._sum, other._count, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += o_sum
            self._count += o_count
            if o_max > self._max:
                self._max = o_max

    def reset(self) -> None:
        with self._lock:
            for i in range(len(self._counts)):
                self._counts[i] = 0
            self._sum = 0.0
            self._count = 0
            self._max = 0.0

    # --- introspection --------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum_s(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        return self.quantiles((q,))[0]

    def quantiles(self, qs: Iterable[float]) -> List[float]:
        """Nearest-rank quantile estimates: geometric midpoint of the
        bucket holding each target rank (one lock, one bucket walk for
        all requested quantiles)."""
        qs = list(qs)
        with self._lock:
            if self._count == 0:
                return [0.0 for _ in qs]
            counts = list(self._counts)
            total = self._count
            hist_max = self._max
        out: List[float] = []
        for q in qs:
            rank = min(max(int(math.ceil(q * total)), 1), total)
            cum = 0
            est = hist_max
            for i, c in enumerate(counts):
                cum += c
                if cum >= rank:
                    if i == 0:
                        # (0, MIN_S]: everything here is "instant"
                        est = min(MIN_S, hist_max)
                    elif i >= N_BUCKETS:
                        # overflow: the max is the only honest bound
                        est = hist_max
                    else:
                        est = min(BOUNDS[i] / math.sqrt(GROWTH), hist_max)
                    break
            out.append(est)
        return out

    def snapshot(self) -> Dict:
        """Summary dict (bench artifacts / JSON endpoints)."""
        p50, p90, p99 = self.quantiles((0.5, 0.9, 0.99))
        with self._lock:
            count, total, mx = self._count, self._sum, self._max
        return {
            "count": count,
            "sum_s": round(total, 6),
            "mean_ms": round(total / count * 1e3, 4) if count else 0.0,
            "p50_ms": round(p50 * 1e3, 4),
            "p90_ms": round(p90 * 1e3, 4),
            "p99_ms": round(p99 * 1e3, 4),
            "max_ms": round(mx * 1e3, 4),
        }

    def prometheus_lines(self, metric: str, labels: str = "") -> List[str]:
        """Classic-histogram exposition: cumulative ``_bucket`` lines
        (non-empty buckets plus the mandatory ``+Inf``), ``_sum``,
        ``_count``. ``labels`` is a pre-rendered ``k="v"`` list without
        braces; ``le`` is appended to it."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        sep = "," if labels else ""
        lines: List[str] = []
        cum = 0
        for i, c in enumerate(counts[:N_BUCKETS]):
            cum += c
            if c:
                lines.append(
                    f'{metric}_bucket{{{labels}{sep}le="{BOUNDS[i]:.9g}"}}'
                    f" {cum}")
        lines.append(
            f'{metric}_bucket{{{labels}{sep}le="+Inf"}} {total_count}')
        lines.append(f"{metric}_sum{{{labels}}} {total_sum:.6f}")
        lines.append(f"{metric}_count{{{labels}}} {total_count}")
        return lines


#: the latency series the hot path feeds (histogram `op` label values).
#: e2e = broker-enqueue → eval committed (ack after final plan commit);
#: the rest are the stage waits the tail decomposition names.
E2E = "e2e"
PLAN_QUEUE = "plan_queue"
PLAN_EVALUATE = "plan_evaluate"
PLAN_COMMIT = "plan_commit"
WAVE_PARK = "wave_park"
SNAPSHOT_WAIT = "snapshot_wait"
#: event-stream delivery lag: FSM-apply stamp -> consumer hand-off
#: (server/stream.py; the serving plane's headline distribution)
STREAM_DELIVER = "stream_deliver"
#: raft WAL group-fsync latency (raft/wal.py): the disk
#: cost every durable ack amortizes across the batched-commit windows
WAL_FSYNC = "wal_fsync"
#: consensus-plane latency ops (raft/node.py) — always-on
#: like e2e. raft_replication = leader append -> peer ack (per-peer
#: lag in ms); raft_quorum = leader append -> commit-index advance;
#: raft_append = follower AppendEntries handling incl. its group
#: fsync; raft_snapshot_xfer = one InstallSnapshot send
RAFT_REPLICATION = "raft_replication"
RAFT_QUORUM = "raft_quorum"
RAFT_APPEND = "raft_append"
RAFT_SNAPSHOT_XFER = "raft_snapshot_xfer"
#: full election duration (first round -> leadership won)
RAFT_ELECTION = "raft_election"
#: read-plane staleness (server/readplane.py): how far
#: behind the leader the data each served read was — 0 on the leader,
#: the last-contact / attributed-lag age on followers. The serving
#: plane's consistency distribution, exported per-op like the rest.
READ_STALENESS = "read_staleness"


class HistogramRegistry:
    """Process-wide named histograms (analogous to the tracer /
    metrics global_registry). ``get`` creates on first use so record
    sites need no setup ordering."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[str, LatencyHistogram] = {}

    def get(self, name: str) -> LatencyHistogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.get(name)
                if h is None:
                    h = LatencyHistogram(name)
                    self._hists[name] = h
        return h

    def peek(self, name: str) -> Optional[LatencyHistogram]:
        """Like ``get`` but never creates (exposition must not mint
        empty series)."""
        return self._hists.get(name)

    def items(self) -> List[Tuple[str, LatencyHistogram]]:
        with self._lock:
            return sorted(self._hists.items())

    def snapshot(self) -> Dict[str, Dict]:
        return {name: h.snapshot() for name, h in self.items()}

    def reset(self) -> None:
        for _, h in self.items():
            h.reset()


#: process-wide latency histograms; reset via telemetry.reset()
histograms = HistogramRegistry()
