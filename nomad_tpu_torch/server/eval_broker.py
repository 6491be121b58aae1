"""EvalBroker: the leader's priority queue of evaluations.

Reference behavior: nomad/eval_broker.go (:47-927). Per-scheduler-type
ready queues ordered by priority then FIFO; only one eval per job is
ever outstanding (others wait in a per-job pending heap, promoted on
Ack); dequeued evals are tracked unacked with a nack timeout; Nack
re-enqueues with a delay until the delivery limit routes the eval to
the ``_failed`` queue; WaitUntil evals sit in a delay heap until due.

TPU-native addition: ``dequeue_batch`` returns up to B compatible evals
in one call so a worker can launch them as one batched kernel
(SURVEY.md section 7 step 5 -- the key to the throughput target).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation, generate_uuid
from nomad_tpu_torch.telemetry.trace import tracer
from nomad_tpu_torch.utils.delayheap import DelayHeap
from nomad_tpu_torch.utils.faultpoints import fault
from nomad_tpu_torch.utils.witness import witness_lock

# Queue that unackable evals land on after the delivery limit
# (eval_broker.go:21 failedQueue).
FAILED_QUEUE = "_failed"

DEFAULT_NACK_TIMEOUT = 60.0
DEFAULT_DELIVERY_LIMIT = 3
DEFAULT_INITIAL_NACK_DELAY = 1.0
DEFAULT_SUBSEQUENT_NACK_DELAY = 20.0


class _ReadyQueue:
    """Priority queue: highest priority first, FIFO within priority."""

    def __init__(self) -> None:
        self._heap: List[Tuple[int, int, Evaluation]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, ev: Evaluation) -> None:
        heapq.heappush(self._heap, (-ev.priority, next(self._seq), ev))

    def peek(self) -> Optional[Evaluation]:
        return self._heap[0][2] if self._heap else None

    def pop(self) -> Optional[Evaluation]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]


class _UnackedEval:
    def __init__(self, ev: Evaluation, token: str) -> None:
        self.eval = ev
        self.token = token
        # wall-clock deadline for the auto-nack (0 = no timeout). One
        # shared watcher thread enforces deadlines for ALL unacked
        # evals; the per-dequeue ``threading.Timer`` this replaces
        # spawned a whole OS thread per handed-out eval — at batch-32
        # dequeues that was 32 thread spawns per wave on the dequeue
        # hot path (a hot-path lever).
        self.nack_deadline: float = 0.0


class EvalBroker:
    def __init__(
        self,
        nack_timeout: float = DEFAULT_NACK_TIMEOUT,
        delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
        initial_nack_delay: float = DEFAULT_INITIAL_NACK_DELAY,
        subsequent_nack_delay: float = DEFAULT_SUBSEQUENT_NACK_DELAY,
        batch_fill_window_s: float = 0.005,
    ) -> None:
        self.nack_timeout = nack_timeout
        # wave-boundary feed: after the FIRST eval of a
        # multi-eval dequeue, hold the batch open this long for more
        # ready evals. A ragged hand-out fragments the worker's wave —
        # fewer members per kernel launch AND fewer plans per batched
        # raft entry — so a few ms of fill (bounded; idle and
        # single-eval dequeues pay nothing) buys whole-wave commits.
        self.batch_fill_window_s = batch_fill_window_s
        self.delivery_limit = delivery_limit
        self.initial_nack_delay = initial_nack_delay
        self.subsequent_nack_delay = subsequent_nack_delay

        self._lock = witness_lock("EvalBroker._lock")
        self._cond = threading.Condition(self._lock)
        self._enabled = False
        # scheduler type -> ready queue (eval_broker.go `ready`)
        self._ready: Dict[str, _ReadyQueue] = {}
        # eval id -> unacked tracking (eval_broker.go `unack`)
        self._unack: Dict[str, _UnackedEval] = {}
        # (ns, job) -> eval id outstanding in broker (`jobEvals` dedup)
        self._job_evals: Dict[Tuple[str, str], str] = {}
        # (ns, job) -> pending evals awaiting the outstanding one's Ack
        # (`pendingEvals` heap per job)
        self._pending: Dict[Tuple[str, str], List[Tuple[int, int, Evaluation]]] = {}
        self._pending_seq = itertools.count()
        # eval id -> nack delivery count (`evals` requeue tracking)
        self._delivery: Dict[str, int] = {}
        # eval id -> eval to re-enqueue once the outstanding copy is
        # acked (eval_broker.go `requeue`: an Enqueue that races with an
        # unacked delivery of the same eval must not be dropped)
        self._requeue_on_ack: Dict[str, Evaluation] = {}
        # WaitUntil evals (eval_broker.go:758 delayedEvalQueue)
        self._delayed = DelayHeap()
        self._delay_thread: Optional[threading.Thread] = None
        self._delay_wake = threading.Event()
        # broker-enqueue stamps on the MONOTONIC clock, keyed by eval
        # id: the e2e latency origin (enqueue → plan commit/ack). A
        # broker-LOCAL map, never a field on the Evaluation — the
        # enqueued object is the state store's row and must stay
        # immutable (the same discipline that makes workers copy
        # before stamping snapshot_index). Set once per broker pass
        # (nack redeliveries keep the ORIGINAL stamp so the histogram
        # tail includes retry latency); dropped at ack/flush.
        self._enqueue_stamps: Dict[str, float] = {}
        # auto-nack deadlines: (deadline, eval_id, token) entries for
        # the shared watcher; stale entries (acked, or reset to a later
        # deadline) are skipped against _unack at fire time
        self._nack_heap: List[Tuple[float, str, str]] = []
        self._nack_thread: Optional[threading.Thread] = None
        self._nack_wake = threading.Event()
        # delivery-token factory: ONE uuid per broker at construction,
        # then an atomic counter. Tokens are opaque correlation handles
        # (only ever compared for equality against what this broker
        # handed out), and generate_uuid() serializes every caller
        # through the process-wide RNG lock — calling it per eval
        # inside dequeue_batch's lock hold (graftcheck R2) put a
        # cross-module lock acquisition + uuid formatting on the hot
        # dequeue path, once per wave member.
        self._token_prefix = generate_uuid()
        self._token_seq = itertools.count(1)

    # --- lifecycle (eval_broker.go SetEnabled/Flush) --------------------

    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev, self._enabled = self._enabled, enabled
        if prev and not enabled:
            self.flush()
        if enabled and not prev:
            self._delay_wake.clear()
            self._delay_thread = threading.Thread(
                target=self._run_delayed, daemon=True, name="broker-delayed"
            )
            self._delay_thread.start()
            self._nack_wake.clear()
            self._nack_thread = threading.Thread(
                target=self._run_nack_watch, daemon=True,
                name="broker-nack",
            )
            self._nack_thread.start()

    def flush(self) -> None:
        with self._lock:
            self._ready.clear()
            self._unack.clear()
            self._job_evals.clear()
            self._pending.clear()
            self._delivery.clear()
            self._requeue_on_ack.clear()
            self._enqueue_stamps.clear()
            self._delayed = DelayHeap()
            self._nack_heap.clear()
            self._cond.notify_all()
        self._delay_wake.set()
        self._nack_wake.set()

    # --- enqueue (eval_broker.go:182 Enqueue, :214 processEnqueue) ------

    def enqueue(self, ev: Evaluation) -> None:
        with self._lock:
            self._process_enqueue(ev, "")

    def enqueue_all(self, evals: List[Tuple[Evaluation, str]]) -> None:
        """[(eval, token)] -- re-enqueue evals a worker still holds
        (eval_broker.go:190 EnqueueAll: ack-if-held then enqueue)."""
        with self._lock:
            for ev, token in evals:
                un = self._unack.get(ev.id)
                if un is not None and un.token == token:
                    self._ack_locked(ev.id)
                self._process_enqueue(ev, token)

    def _process_enqueue(self, ev: Evaluation, token: str) -> None:
        if not self._enabled:
            return
        if ev.id in self._unack:
            self._requeue_on_ack[ev.id] = ev
            return
        if ev.id in self._delayed:
            return
        if ev.wait_until_s and ev.wait_until_s > time.time():
            self._delayed.push(ev.id, ev.wait_until_s, ev)
            self._delay_wake.set()
            return
        self._enqueue_locked(ev, ev.type)

    def _enqueue_locked(self, ev: Evaluation, queue: str) -> None:
        # e2e latency origin, stamped the moment the eval becomes
        # RUNNABLE (so a WaitUntil eval's intentional delay never
        # counts). setdefault = stamp-once. One clock read; runs
        # whether or not tracing is enabled — the streaming
        # histograms are always-on.
        self._enqueue_stamps.setdefault(ev.id, time.monotonic())
        if queue == FAILED_QUEUE:
            # failed evals bypass per-job dedup entirely: the job may
            # legitimately have another live eval outstanding
            self._ready.setdefault(queue, _ReadyQueue()).push(ev)
            self._cond.notify_all()
            return
        ns_job = (ev.namespace, ev.job_id)
        outstanding = self._job_evals.get(ns_job)
        if outstanding == ev.id or any(
                p.id == ev.id for _, _, p in self._pending.get(ns_job, ())):
            # already ready or pending (eval_broker.go processEnqueue's
            # evals map): a leader's restore and its FSM can both enqueue
            # an eval, and a second copy is handed out twice
            return
        if outstanding:
            heapq.heappush(
                self._pending.setdefault(ns_job, []),
                (-ev.priority, next(self._pending_seq), ev),
            )
            return
        self._job_evals[ns_job] = ev.id
        self._ready.setdefault(queue, _ReadyQueue()).push(ev)
        self._cond.notify_all()

    # --- dequeue (eval_broker.go:335 Dequeue) ---------------------------

    def _track_unacked_locked(self, ev: Evaluation) -> str:
        """Register a handed-out eval: token + auto-nack deadline (one
        heap push; the shared watcher enforces it)."""
        # next() on itertools.count is atomic — no RNG lock, no
        # formatting beyond one f-string, under the broker lock
        token = f"{self._token_prefix}-{next(self._token_seq)}"
        un = _UnackedEval(ev, token)
        self._unack[ev.id] = un
        if self.nack_timeout > 0:
            un.nack_deadline = time.time() + self.nack_timeout
            heapq.heappush(self._nack_heap,
                           (un.nack_deadline, ev.id, token))
        return token

    def dequeue(
        self, schedulers: List[str], timeout: Optional[float] = None
    ) -> Tuple[Optional[Evaluation], str]:
        batch = self.dequeue_batch(schedulers, 1, timeout)
        if not batch:
            return None, ""
        return batch[0]

    def dequeue_batch(
        self, schedulers: List[str], batch: int, timeout: Optional[float] = None
    ) -> List[Tuple[Evaluation, str]]:
        """Dequeue up to ``batch`` evals in ONE lock acquisition: a
        blocking wait for the first, then a drain of whatever else is
        ready. Batched-kernel feed path — the per-eval re-lock /
        re-wakeup of the old loop cost a lock round-trip and a
        condition touch per member per wave."""
        deadline = None if timeout is None else time.time() + timeout
        t0 = time.monotonic() if tracer.enabled else 0.0
        t1 = 0.0
        out: List[Tuple[Evaluation, str]] = []
        fill_cap = None
        last_arrival = 0.0
        notify_nack = False
        with self._lock:
            while True:
                ev = self._dequeue_locked(schedulers)
                if ev is not None:
                    if t0 and not out:
                        t1 = time.monotonic()
                    if fill_cap is None:
                        fill_cap = time.monotonic() \
                            + 4 * self.batch_fill_window_s
                    last_arrival = time.monotonic()
                    out.append((ev, self._track_unacked_locked(ev)))
                    if len(out) >= batch:
                        break
                    continue
                if not self._enabled:
                    break
                if out:
                    # batch-fill window: the queue ran dry mid-batch —
                    # wait (bounded) for the producer burst to catch
                    # up rather than hand out a wave fragment. The
                    # window slides with each arrival (a burst keeps
                    # it open until the batch fills) under a hard cap
                    # of 4 windows from the first eval, so a slow
                    # trickle can never pin latency to batch x window.
                    if batch <= 1 or self.batch_fill_window_s <= 0:
                        break
                    fill_wait = min(
                        last_arrival + self.batch_fill_window_s,
                        fill_cap) - time.monotonic()
                    if fill_wait <= 0:
                        break
                    self._cond.wait(fill_wait)
                    continue
                wait = None if deadline is None else deadline - time.time()
                if wait is not None and wait <= 0:
                    break
                self._cond.wait(wait)
            notify_nack = bool(out) and self.nack_timeout > 0
        if notify_nack:
            # ONE watcher wakeup per handed-out batch (not per eval):
            # the watcher re-reads the heap head and re-arms
            self._nack_wake.set()
        if t0 and out:
            # two spans, recorded only when work was handed out: the
            # blocking wait for the first eval (idle/backpressure —
            # overlaps producers, so the decomposition reports it
            # without attributing it) and the drain that actually
            # hands the batch out
            tracer.record("broker.wait", t1 - t0, trace_id=out[0][0].id)
            tracer.record("broker.dequeue", time.monotonic() - t1,
                          trace_id=out[0][0].id)
        return out

    def _dequeue_locked(self, schedulers: List[str]) -> Optional[Evaluation]:
        best_q = None
        best: Optional[Evaluation] = None
        for s in schedulers:
            q = self._ready.get(s)
            if q is None:
                continue
            head = q.peek()
            if head is None:
                continue
            if best is None or head.priority > best.priority:
                best, best_q = head, q
        if best_q is not None:
            return best_q.pop()
        return None

    # --- ack / nack (eval_broker.go:537 Ack, :601 Nack) -----------------

    def outstanding(self, eval_id: str) -> Optional[str]:
        with self._lock:
            un = self._unack.get(eval_id)
            return un.token if un is not None else None

    def enqueue_stamp(self, eval_id: str) -> float:
        """Monotonic broker-enqueue time of an eval still in the
        broker's hands (0.0 = unknown). Workers read it BEFORE acking
        — the ack drops the stamp — to record the e2e latency
        histogram sample."""
        with self._lock:
            return self._enqueue_stamps.get(eval_id, 0.0)

    def outstanding_reset(self, eval_id: str, token: str) -> None:
        """Reset the nack deadline (worker heartbeat during long
        scheduling; eval_broker.go OutstandingReset). The old heap
        entry goes stale in place — the watcher re-checks the live
        deadline before firing."""
        if self.nack_timeout <= 0:
            return
        with self._lock:
            un = self._unack.get(eval_id)
            if un is None or un.token != token:
                return
            un.nack_deadline = time.time() + self.nack_timeout
            heapq.heappush(self._nack_heap,
                           (un.nack_deadline, eval_id, token))

    def ack(self, eval_id: str, token: str) -> None:
        # ack seam (chaos plane): a failed ack leaves the eval unacked
        # after its work committed — the worker nacks, the redelivered
        # eval re-schedules to a no-op plan and acks clean (the
        # convergence path the chaos cell asserts)
        fault("broker.ack")
        with self._lock:
            un = self._unack.get(eval_id)
            if un is None:
                raise ValueError(f"evaluation {eval_id} is not outstanding")
            if un.token != token:
                raise ValueError(f"token mismatch for evaluation {eval_id}")
            self._ack_locked(eval_id)

    def _ack_locked(self, eval_id: str) -> None:
        un = self._unack.pop(eval_id)
        self._delivery.pop(eval_id, None)
        self._enqueue_stamps.pop(eval_id, None)
        ns_job = (un.eval.namespace, un.eval.job_id)
        if self._job_evals.get(ns_job) == eval_id:
            del self._job_evals[ns_job]
        # promote the highest-priority pending eval for this job
        pending = self._pending.get(ns_job)
        if pending:
            _, _, nxt = heapq.heappop(pending)
            if not pending:
                del self._pending[ns_job]
            self._enqueue_locked(nxt, nxt.type)
        # an enqueue raced with this delivery: honor it now
        requeued = self._requeue_on_ack.pop(eval_id, None)
        if requeued is not None:
            self._enqueue_locked(requeued, requeued.type)

    def nack(self, eval_id: str, token: str) -> None:
        # nack seam (chaos plane): a failed nack strands the eval
        # unacked until the shared deadline watcher auto-nacks it
        fault("broker.nack")
        with self._lock:
            un = self._unack.get(eval_id)
            if un is None or un.token != token:
                return
            count = self._delivery.get(eval_id, 0) + 1
            stamp = self._enqueue_stamps.get(eval_id, 0.0)
            self._ack_locked(eval_id)   # clears delivery tracking too
            ev = un.eval
            self._delivery[eval_id] = count
            if stamp:
                # a nacked eval is NOT done: the redelivery keeps the
                # original enqueue stamp so its eventual e2e sample
                # includes the retry latency (the tail's honest shape)
                self._enqueue_stamps[eval_id] = stamp
            if count >= self.delivery_limit:
                # terminal: route to the failed queue for the leader's
                # reapFailedEvaluations loop (leader.go:759)
                self._enqueue_locked(ev, FAILED_QUEUE)
                return
            delay = (
                self.initial_nack_delay
                if count == 1
                else self.subsequent_nack_delay
            )
            if delay > 0:
                self._delayed.push(ev.id, time.time() + delay, ev)
                self._delay_wake.set()
            else:
                self._enqueue_locked(ev, ev.type)

    # --- auto-nack watcher (replaces per-dequeue threading.Timer) -------

    def _run_nack_watch(self) -> None:
        while True:
            due: List[Tuple[str, str]] = []
            with self._lock:
                if not self._enabled:
                    return
                now = time.time()
                while self._nack_heap and self._nack_heap[0][0] <= now:
                    _, eid, token = heapq.heappop(self._nack_heap)
                    un = self._unack.get(eid)
                    # stale entries: acked/re-delivered (token moved) or
                    # heartbeat-reset to a later deadline
                    if un is None or un.token != token:
                        continue
                    if un.nack_deadline > now:
                        continue
                    due.append((eid, token))
                head = self._nack_heap[0][0] if self._nack_heap else None
            for eid, token in due:
                try:
                    self.nack(eid, token)
                except Exception:               # noqa: BLE001
                    # a failed auto-nack (chaos-plane injection, or any
                    # real error) must not kill the SHARED watcher —
                    # with it dead, every future deadline would strand
                    # its eval unacked forever. Re-arm a short retry
                    # deadline instead so the eval still converges
                    #
                    with self._lock:
                        un = self._unack.get(eid)
                        if un is not None and un.token == token:
                            retry = time.time() + min(
                                max(self.nack_timeout / 4.0, 0.1), 5.0)
                            un.nack_deadline = retry
                            heapq.heappush(self._nack_heap,
                                           (retry, eid, token))
                            if head is None or retry < head:
                                head = retry
            wait = max(head - time.time(), 0.01) if head else 1.0
            self._nack_wake.wait(wait)
            self._nack_wake.clear()

    # --- delayed eval loop (eval_broker.go:758 runDelayedEvalsWatcher) --

    def _run_delayed(self) -> None:
        while True:
            with self._lock:
                if not self._enabled:
                    return
                due = self._delayed.pop_due(time.time())
                for _, ev in due:
                    self._enqueue_locked(ev, ev.type)
                head = self._delayed.peek()
            wait = max(head[1] - time.time(), 0.01) if head else 1.0
            self._delay_wake.wait(wait)
            self._delay_wake.clear()

    # --- introspection (eval_broker.go:811 Stats) -----------------------

    def stats(self) -> Dict:
        with self._lock:
            by_scheduler = {
                s: {"ready": len(q), "unacked": 0}
                for s, q in self._ready.items()
                if len(q)
            }
            for un in self._unack.values():
                t = un.eval.type
                by_scheduler.setdefault(t, {"ready": 0, "unacked": 0})
                by_scheduler[t]["unacked"] += 1
            return {
                "total_ready": sum(len(q) for q in self._ready.values()),
                "total_unacked": len(self._unack),
                "total_pending": sum(len(p) for p in self._pending.values()),
                "total_waiting": len(self._delayed),
                "delayed_evals": len(self._delayed),
                "by_scheduler": by_scheduler,
            }
