"""Span tracing for the eval lifecycle.

The reference instruments every hot component with go-metrics timers
(eval_broker.go, plan_apply.go, worker.go all carry
``defer metrics.MeasureSince(...)``); this subsystem goes one step
further and records *spans* — named, nested, per-thread intervals on a
monotonic clock — so the live path's per-eval wall time can be
decomposed stage by stage (BENCH_r05's unexplained 25x TPU/CPU gap is
exactly a missing decomposition).

Design constraints, in order:

- **~zero cost when disabled.** ``span()`` is one attribute check and
  returns a shared no-op context manager; no allocation, no lock, no
  clock read. The live path stays within noise of the uninstrumented
  build when tracing is off.
- **Thread-safe.** Spans nest per-thread via ``threading.local`` stacks
  (no cross-thread mutation); completed spans land in a bounded ring
  buffer plus per-name aggregates under one short lock.
- **Bounded.** The ring holds the newest ``capacity`` spans; aggregates
  (count / total / exclusive seconds per name) never lose data, so a
  long burst still decomposes exactly even after the ring wraps.
- **Exclusive time is first-class.** A span's *exclusive* duration is
  its wall duration minus its same-thread children — the quantity a
  stage decomposition can sum without double counting (a scheduler span
  that parks inside a kernel wave must not claim the wave's time).

Cross-thread propagation: a thread that fans work out captures
``tracer.context()`` and workers re-parent under it with
``tracer.attach(ctx)`` — the worker's spans then carry the originating
trace id (threads do not inherit ``threading.local`` state).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["Span", "Tracer", "tracer", "FlightRecorder", "flight_recorder",
           "ConsensusRecorder", "consensus_recorder"]

_ids = itertools.count(1)


class Span:
    """One completed interval. Attributes are kept flat and small —
    spans are recorded on the hot path.

    Each span carries TWO clocks: wall (monotonic) and the owning
    thread's CPU time (``time.thread_time``). Wall answers "how long
    did this stage hold the critical path"; CPU answers "how much work
    did this stage execute". The distinction matters under the GIL: B
    concurrently-scheduled eval threads each see ~the whole phase as
    wall time, but their CPU times sum to the work actually done — the
    stage decomposition sums CPU for host stages and wall for
    device-blocking stages, so neither is double counted."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "dur_s", "child_s", "cpu_s", "child_cpu_s", "thread")

    def __init__(self, name: str, trace_id: str, span_id: int,
                 parent_id: int, start_s: float, dur_s: float,
                 child_s: float, cpu_s: float, child_cpu_s: float,
                 thread: str) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_s = start_s
        self.dur_s = dur_s
        self.child_s = child_s
        self.cpu_s = cpu_s
        self.child_cpu_s = child_cpu_s
        self.thread = thread

    @property
    def exclusive_s(self) -> float:
        return max(self.dur_s - self.child_s, 0.0)

    @property
    def exclusive_cpu_s(self) -> float:
        return max(self.cpu_s - self.child_cpu_s, 0.0)

    def to_api(self) -> Dict:
        """The wire shape /v1/operator/traces serves."""
        return {
            "Name": self.name,
            "TraceID": self.trace_id,
            "SpanID": self.span_id,
            "ParentID": self.parent_id,
            "Start": round(self.start_s, 6),
            "DurationMs": round(self.dur_s * 1e3, 4),
            "ExclusiveMs": round(self.exclusive_s * 1e3, 4),
            "CpuMs": round(self.cpu_s * 1e3, 4),
            "ExclusiveCpuMs": round(self.exclusive_cpu_s * 1e3, 4),
            "Thread": self.thread,
        }


class _NoopSpan:
    """Shared disabled-mode context manager: no state, no clock."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopSpan()


class _LiveSpan:
    """An open span on one thread's stack."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "c0", "child_s", "child_cpu_s", "sampled")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: int, sampled: bool) -> None:
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.child_s = 0.0
        self.child_cpu_s = 0.0
        self.t0 = 0.0
        self.c0 = 0.0
        self.sampled = sampled

    def __enter__(self) -> "_LiveSpan":
        self.tracer._tls_stack().append(self)
        self.t0 = time.monotonic()
        # the CPU clock is read AFTER the wall clock and only on
        # sampled trees: on kernels where CLOCK_THREAD_CPUTIME_ID is a
        # real syscall (no vDSO) each read costs tens of µs — see
        # Tracer._calibrate
        self.c0 = time.thread_time() if self.sampled else 0.0
        return self

    def __exit__(self, *exc) -> None:
        # clock geometry on a sampled span: t0 is captured BEFORE the
        # enter CPU read and dur after the exit CPU read, so both
        # expensive reads' WALL lands inside this span's own window —
        # while their CPU is excluded from this span's cpu (c0 is
        # captured at the END of the enter read, the exit value before
        # its cost) and lands in the PARENT's CPU window instead
        cpu = (time.thread_time() - self.c0) if self.sampled else 0.0
        dur = time.monotonic() - self.t0
        stack = self.tracer._tls_stack()
        # unwind to self: an exception may have skipped children's exits
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        comp = self.tracer._cpu_read_cost * 2.0 if self.sampled else 0.0
        if comp:
            # shed the two reads' wall from this span's own duration —
            # the recorded span measures the system, not the tracer
            dur = max(dur - comp, 0.0)
        if stack:
            parent = stack[-1]
            if self.sampled:
                # the parent still lost the FULL window (adjusted dur
                # + the reads' wall) and the reads' syscall CPU; credit
                # both to child time so the parent's EXCLUSIVE stage —
                # the quantity the decomposition gates on — stays
                # unbiased
                parent.child_s += dur + comp
                parent.child_cpu_s += cpu + comp
            else:
                parent.child_s += dur
        self.tracer._record(self, dur, cpu)


class _Attach:
    __slots__ = ("tracer", "ctx", "prev")

    def __init__(self, tracer: "Tracer", ctx) -> None:
        self.tracer = tracer
        self.ctx = ctx

    def __enter__(self) -> "_Attach":
        tls = self.tracer._tls
        self.prev = getattr(tls, "inherit", None)
        tls.inherit = self.ctx
        return self

    def __exit__(self, *exc) -> None:
        self.tracer._tls.inherit = self.prev


class Tracer:
    def __init__(self, capacity: int = 16384) -> None:
        self._enabled = False
        self._lock = threading.Lock()
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        # name -> [count, total_s, exclusive_s, cpu_s, exclusive_cpu_s]
        self._agg: Dict[str, List[float]] = {}
        self._tls = threading.local()
        self.enabled_at: Optional[float] = None
        #: CPU-clock sampling: 1 = read thread_time on every span
        #: (exact; the normal case). On kernels where the clock is an
        #: un-vDSO'd syscall, whole span TREES are sampled 1-in-K and
        #: their CPU contributions scaled by K — unbiased aggregates
        #: at a bounded instrumentation cost (see _calibrate).
        self.cpu_sample_every = 1
        self._cpu_read_cost = 0.0
        self._root_seq = itertools.count()

    # --- control --------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._calibrate()
        self.enabled_at = time.monotonic()
        self._enabled = True

    def _calibrate(self) -> None:
        """Measure the CPU clock's read cost and pick the tree-sampling
        rate. ``time.thread_time`` is ~0.1µs through the vDSO on
        production kernels (every span reads it: exact attribution),
        but tens of µs as a real syscall under sandboxed/older kernels
        — at 4 reads per span site an instrumented eval would owe more
        CPU to the tracer than to scheduling, and the decomposition
        would gate on the instrument instead of the system. Sampling
        1-in-K span trees (scaled by K) keeps aggregates unbiased and
        the overhead bounded; per-span compensation (_LiveSpan.__exit__)
        removes the residual bias from the sampled trees themselves."""
        reads = 64
        t0 = time.perf_counter()
        for _ in range(reads):
            time.thread_time()
        cost = (time.perf_counter() - t0) / reads
        self._cpu_read_cost = cost
        if cost < 2e-6:
            self.cpu_sample_every = 1
        else:
            # cap at 4: the variance of the scaled estimate grows with
            # K, and host stages gate CI — a 4x overhead cut already
            # brings the syscall tax under the stage costs it measures
            self.cpu_sample_every = min(4, max(2, int(cost / 5e-6)))

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._agg.clear()
        if self._enabled:
            self.enabled_at = time.monotonic()

    # --- recording ------------------------------------------------------

    def _tls_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def span(self, name: str, trace_id: str = ""):
        """Open a span. The ONLY hot-path entry point: when disabled it
        returns a shared no-op without reading the clock."""
        if not self._enabled:
            return _NOOP
        stack = self._tls_stack()
        if stack:
            # children inherit the root's CPU-sampling decision so the
            # parent/child exclusive arithmetic stays consistent
            # within one tree
            parent = stack[-1]
            return _LiveSpan(self, name, trace_id or parent.trace_id,
                             parent.span_id, parent.sampled)
        sampled = self.cpu_sample_every == 1 or (
            next(self._root_seq) % self.cpu_sample_every == 0)
        inherit = getattr(self._tls, "inherit", None)
        if inherit is not None:
            return _LiveSpan(self, name, trace_id or inherit[0],
                             inherit[1], sampled)
        return _LiveSpan(self, name, trace_id, 0, sampled)

    def record(self, name: str, dur_s: float, trace_id: str = "") -> None:
        """Record an already-measured interval as a leaf span (for
        sites that must decide retroactively, e.g. a blocking dequeue
        that only counts when it returned work)."""
        if not self._enabled:
            return
        stack = self._tls_stack()
        parent_id = stack[-1].span_id if stack else 0
        if stack:
            stack[-1].child_s += dur_s
            trace_id = trace_id or stack[-1].trace_id
        # after-the-fact records carry no CPU reading (they are mostly
        # blocking waits); cpu_s=0 keeps them out of CPU attributions
        sp = Span(name, trace_id, next(_ids), parent_id,
                  time.monotonic() - dur_s, dur_s, 0.0, 0.0, 0.0,
                  threading.current_thread().name)
        self._append(sp, 0)

    def _record(self, live: _LiveSpan, dur_s: float, cpu_s: float) -> None:
        sp = Span(live.name, live.trace_id, live.span_id, live.parent_id,
                  live.t0, dur_s, live.child_s, cpu_s, live.child_cpu_s,
                  threading.current_thread().name)
        self._append(sp, self.cpu_sample_every if live.sampled else 0)

    def _append(self, sp: Span, cpu_scale: int = 1) -> None:
        # ring entries keep the raw per-span reading (0 on unsampled
        # trees); AGGREGATES scale sampled CPU by the sampling rate so
        # stage_totals stays an unbiased estimate of work executed
        with self._lock:
            self._ring.append(sp)
            agg = self._agg.get(sp.name)
            if agg is None:
                self._agg[sp.name] = [1, sp.dur_s, sp.exclusive_s,
                                      sp.cpu_s * cpu_scale,
                                      sp.exclusive_cpu_s * cpu_scale]
            else:
                agg[0] += 1
                agg[1] += sp.dur_s
                agg[2] += sp.exclusive_s
                agg[3] += sp.cpu_s * cpu_scale
                agg[4] += sp.exclusive_cpu_s * cpu_scale

    # --- propagation ----------------------------------------------------

    def context(self) -> Optional[Tuple[str, int]]:
        """(trace_id, span_id) of the calling thread's open span, for
        hand-off to worker threads via ``attach``."""
        if not self._enabled:
            return None
        stack = getattr(self._tls, "stack", None)
        if stack:
            return (stack[-1].trace_id, stack[-1].span_id)
        return None

    def attach(self, ctx: Optional[Tuple[str, int]]):
        """Adopt ``ctx`` as the parent for this thread's root spans."""
        if ctx is None:
            return _NOOP
        return _Attach(self, ctx)

    # --- cross-process shipping ------------------------------------------

    def drain_rows(self) -> List[Tuple]:
        """Pop every ring entry as a plain tuple row — the wire shape a
        worker process ships its spans to the consensus process in
        (server/workerproc.py). Aggregates stay: they are this
        process's own stage_totals. Rows are positional Span fields, so
        ``Span(*row)`` reconstructs on the other side."""
        with self._lock:
            rows = [(s.name, s.trace_id, s.span_id, s.parent_id,
                     s.start_s, s.dur_s, s.child_s, s.cpu_s,
                     s.child_cpu_s, s.thread) for s in self._ring]
            self._ring.clear()
        return rows

    def ingest(self, rows: List[Tuple]) -> None:
        """Adopt span rows recorded in ANOTHER process into this ring +
        aggregates, so worker-process spans land in the same e2e
        waterfall as the owner's (trace ids are eval ids on both sides;
        worker span ids are offset per process, so they never collide
        with local ones). Monotonic clocks are system-wide on Linux —
        the shipped start stamps order correctly against local spans."""
        if not self._enabled:
            return
        for row in rows:
            self._append(Span(*row), 1)

    # --- introspection --------------------------------------------------

    def spans(self, name: Optional[str] = None,
              trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [s for s in out if s.name == name]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def recent_spans(self, trace_id: str, scan: int = 2048) -> List[Span]:
        """Spans of one trace among the newest ``scan`` ring entries,
        oldest first. Hot-path-safe companion to ``spans``: the copy
        under the lock is bounded by ``scan`` (reversed-deque steps are
        O(1)), so a caller on an eval thread — the flight recorder
        capturing a just-finished slow eval, whose spans are by
        definition the newest — never stalls concurrent recording
        behind a full 16k-entry ring copy."""
        with self._lock:
            newest = list(itertools.islice(reversed(self._ring), scan))
        newest.reverse()
        return [s for s in newest if s.trace_id == trace_id]

    def stage_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-name aggregates since enable/reset: full-fidelity even
        after the ring wraps."""
        with self._lock:
            return {
                name: {"count": int(c), "total_s": t, "exclusive_s": e,
                       "cpu_s": cp, "exclusive_cpu_s": ecp}
                for name, (c, t, e, cp, ecp) in sorted(self._agg.items())
            }


#: process-wide tracer, analogous to utils.metrics.global_registry
tracer = Tracer()


class _CaptureRing:
    """Shared bounded-capture machinery for the flight recorders: the
    capture ring, the double-checked rate-limited append, serve-time
    span rendering, and the adaptive-threshold constants. Subclasses
    own their threshold POLICY (:class:`FlightRecorder`: one scalar
    e2e threshold; :class:`ConsensusRecorder`: per-op rows) — the
    capture-cost discipline lives here once so a fix to it cannot
    drift between the two recorders."""

    #: records retained (newest win)
    CAPACITY = 32
    #: observations before a threshold arms
    MIN_SAMPLES = 32
    #: EWMA smoothing for the p99 estimate
    ALPHA = 0.25
    #: p99 re-estimation cadence (bucket walks are cheap but not free)
    REFRESH_EVERY = 16
    #: capture rate limit (seconds between captures)
    MIN_CAPTURE_INTERVAL_S = 0.05

    def __init__(self, capacity: int) -> None:
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._last_capture_mono = 0.0
        self.min_capture_interval_s = self.MIN_CAPTURE_INTERVAL_S
        self.captured = 0

    def _capture_due(self) -> bool:
        """Pre-scan rate-limit check (cheap bail before the span-ring
        scan)."""
        with self._lock:
            return (time.monotonic() - self._last_capture_mono
                    >= self.min_capture_interval_s)

    def _try_append(self, record: Dict) -> bool:
        """Double-checked rate-limited append: a racing capture may
        have landed while the caller scanned the span ring (both are
        valid records; the limit is a cost bound, not a semantic
        one)."""
        with self._lock:
            if time.monotonic() - self._last_capture_mono \
                    < self.min_capture_interval_s:
                return False
            self._last_capture_mono = time.monotonic()
            self._ring.append(record)
            self.captured += 1
        return True

    def trees(self) -> List[Dict]:
        """Captured records in API shape (span dicts rendered here, at
        serve time — never on the thread that captured)."""
        with self._lock:
            raw = list(self._ring)
        return [
            {**{k: v for k, v in t.items() if k != "_spans"},
             "Spans": [s.to_api() for s in t["_spans"]]}
            for t in raw
        ]

    def _reset_ring_locked(self) -> None:
        self._ring.clear()
        self._last_capture_mono = 0.0
        self.captured = 0


class FlightRecorder(_CaptureRing):
    """Slow-eval flight recorder: a bounded ring of COMPLETE span trees
    for evals whose e2e latency crossed an adaptive threshold.

    Aggregates (TRACE_DECOMP, histograms) say *how much* tail there is;
    a tail investigation needs the span tree of an actual slow eval —
    which, at p99, has usually already fallen off the span ring by the
    time anyone looks. The recorder captures trees at completion time
    (the Canopy pattern: always-on, sampled by slowness), so
    ``GET /v1/operator/slow-evals`` can serve "the last N slow evals,
    fully decomposed" from a live server.

    Threshold adaptation: an EWMA of the e2e histogram's p99. Tracking
    p99 (rather than a fixed cutoff) keeps the capture rate near the
    top ~1% whatever the workload's absolute speed — a fixed cutoff
    either floods the ring on a slow box or never fires on a fast one.
    The EWMA smooths the estimate so one captured outlier doesn't
    instantly raise the bar past its successors. Disarmed until
    ``MIN_SAMPLES`` observations exist (an empty distribution has no
    tail to speak of).

    Memory is doubly bounded: at most ``capacity`` trees, each at most
    ``MAX_SPANS_PER_TREE`` spans. Capture cost is bounded too — the
    recorder runs ON the eval threads it measures, so it must not
    become the tail it records: captures are rate-limited to one per
    ``min_capture_interval_s`` (the ring only keeps the newest trees
    anyway — capturing every tail eval of a burst would overwrite
    itself while charging the burst for the serialization), the ring
    scan is bounded (``Tracer.recent_spans``), and captured trees hold
    raw Span references — the API-dict conversion happens at serve
    time, not on the hot path.
    """

    #: per-tree span cap (a runaway instrumented loop must not make
    #: one tree unbounded)
    MAX_SPANS_PER_TREE = 256

    def __init__(self, capacity: int = _CaptureRing.CAPACITY) -> None:
        super().__init__(capacity)
        self._threshold_s: Optional[float] = None
        self._observed = 0

    def observe(self, trace_id: str, e2e_s: float) -> bool:
        """Called once per committed eval with its e2e latency; captures
        the eval's span tree when it lands beyond the adaptive
        threshold. Returns True when a tree was captured."""
        from nomad_tpu_torch.telemetry.histogram import histograms

        with self._lock:
            self._observed += 1
            refresh = (self._threshold_s is None
                       or self._observed % self.REFRESH_EVERY == 0)
            armed = self._observed >= self.MIN_SAMPLES
        if refresh:
            p99 = histograms.get("e2e").quantile(0.99)
            if p99 > 0.0:
                with self._lock:
                    if self._threshold_s is None:
                        self._threshold_s = p99
                    else:
                        self._threshold_s += self.ALPHA * (
                            p99 - self._threshold_s)
        with self._lock:
            thr = self._threshold_s
        if not armed or thr is None or e2e_s < thr:
            return False
        if not tracer.enabled or not trace_id:
            return False
        if not self._capture_due():
            return False
        # bounded scan of the NEWEST ring entries: the slow eval just
        # finished, so its tree is at the ring's tail — a full-ring
        # copy under the tracer lock would stall every concurrent
        # span-recording thread (an observer effect in the very
        # instrument that measures tail latency)
        spans = tracer.recent_spans(trace_id)
        if not spans:
            return False
        tree = {
            "TraceID": trace_id,
            "E2eMs": round(e2e_s * 1e3, 3),
            "ThresholdMs": round(thr * 1e3, 3),
            "CapturedAtS": round(time.time(), 3),
            # raw Span refs; to_api conversion deferred to trees()
            "_spans": spans[:self.MAX_SPANS_PER_TREE],
        }
        return self._try_append(tree)

    def threshold_s(self) -> Optional[float]:
        with self._lock:
            return self._threshold_s

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "observed": self._observed,
                "captured": self.captured,
                "retained": len(self._ring),
                "threshold_ms": round((self._threshold_s or 0.0) * 1e3,
                                      3),
            }

    def reset(self) -> None:
        with self._lock:
            self._reset_ring_locked()
            self._threshold_s = None
            self._observed = 0


#: process-wide slow-eval recorder; reset via telemetry.reset()
flight_recorder = FlightRecorder()


class ConsensusRecorder(_CaptureRing):
    """Consensus-plane flight recorder: the slow-eval
    discipline extended to raft — slow follower appends, slow WAL
    group-fsync batches, and slow elections past a per-op adaptive
    EWMA threshold, served at ``GET /v1/operator/slow-raft`` alongside
    the eval recorder.

    Same bounded-cost rules as :class:`FlightRecorder` (the recorder
    runs on the raft/WAL threads it measures): per-op thresholds adapt
    as an EWMA of that op's histogram p99 (log-bucketed, always-on),
    disarmed until ``MIN_SAMPLES`` observations, captures rate-limited
    to one per ``MIN_CAPTURE_INTERVAL_S``, a bounded newest-first ring
    scan when a trace id exists, and span->JSON conversion deferred to
    serve time. Each captured record keeps the op, the owning
    ``server_id``, the duration vs the threshold at capture time, and
    (when tracing was on and the op carried a trace id) the span tree.
    """

    MAX_SPANS_PER_TREE = 128

    def __init__(self, capacity: int = _CaptureRing.CAPACITY) -> None:
        super().__init__(capacity)
        #: op -> [threshold_s or None, observed]
        self._ops: Dict[str, List] = {}

    def observe(self, op: str, dur_s: float, server_id: str = "",
                trace_id: str = "") -> bool:
        """Called per consensus op with its duration (the histogram
        record has already happened at the call site); captures when
        the duration lands beyond the op's adaptive threshold."""
        from nomad_tpu_torch.telemetry.histogram import histograms

        with self._lock:
            row = self._ops.get(op)
            if row is None:
                row = self._ops[op] = [None, 0]
            row[1] += 1
            observed = row[1]
            refresh = row[0] is None or observed % self.REFRESH_EVERY == 0
            armed = observed >= self.MIN_SAMPLES
        if refresh:
            h = histograms.peek(op)
            p99 = h.quantile(0.99) if h is not None else 0.0
            if p99 > 0.0:
                with self._lock:
                    # re-fetch with a default: a concurrent reset()
                    # may have cleared _ops between the locked
                    # sections — this runs on the WAL-fsync/append
                    # path, where a KeyError would fail a raft ack,
                    # not just drop a telemetry sample
                    row = self._ops.setdefault(op, [None, 0])
                    if row[0] is None:
                        row[0] = p99
                    else:
                        row[0] += self.ALPHA * (p99 - row[0])
        with self._lock:
            row = self._ops.get(op)
            thr = row[0] if row is not None else None
        if not armed or thr is None or dur_s < thr:
            return False
        if not self._capture_due():
            return False
        spans = []
        if tracer.enabled and trace_id:
            spans = tracer.recent_spans(trace_id, scan=512)
        record = {
            "Op": op,
            "ServerId": server_id,
            "TraceID": trace_id,
            "DurMs": round(dur_s * 1e3, 3),
            "ThresholdMs": round(thr * 1e3, 3),
            "CapturedAtS": round(time.time(), 3),
            "_spans": spans[:self.MAX_SPANS_PER_TREE],
        }
        return self._try_append(record)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "captured": self.captured,
                "retained": len(self._ring),
                "thresholds_ms": {
                    op: round((row[0] or 0.0) * 1e3, 3)
                    for op, row in sorted(self._ops.items())
                },
                "observed": {op: row[1]
                             for op, row in sorted(self._ops.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._reset_ring_locked()
            self._ops.clear()


#: process-wide consensus-plane recorder; reset via telemetry.reset()
consensus_recorder = ConsensusRecorder()
