"""Scheduler workers: dequeue -> snapshot -> schedule -> submit -> ack.

Reference behavior: nomad/worker.go (:86-846). Each server runs N
workers (default = #cores). A worker dequeues an evaluation from the
broker, waits for its local state to catch up to the eval's index
(SnapshotMinIndex, worker.go:537), instantiates the scheduler for the
eval type against that immutable snapshot, and acts as the scheduler's
``Planner``: SubmitPlan routes to the leader's plan queue and returns a
refreshed snapshot on partial commit; Create/Update/ReblockEval route
through the Raft boundary (here: the server's apply path).

TPU-native addition (SURVEY.md section 7 step 5): with batch_size > 1 a
worker dequeues a *batch* of evals, runs each eval's scheduler on its
own thread against ONE shared snapshot, and coalesces their placement
launches into single vmapped device calls (parallel/coalesce.py). The
reference gets eval concurrency from N workers x M servers; the TPU
build gets it from one worker amortizing N evals per kernel launch.
Plan submission stays per-eval and serialized through the leader's
applier — optimistic concurrency semantics are identical to reference
workers scheduling concurrently against a shared state index.

Counterpart of ``nomad_tpu/server/worker.py``: every eval runs its
launches on the server's device (``server.device``). A batch's waves
each fire as one launch of the fused wave kernel through the
coalescer; a single eval takes the scheduler's default launcher.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional, Tuple

from nomad_tpu_torch.scheduler.scheduler import SetStatusError, new_scheduler
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation, Plan, PlanResult
from nomad_tpu_torch.telemetry.histogram import histograms
from nomad_tpu_torch.telemetry.trace import flight_recorder, tracer
from nomad_tpu_torch.utils.faultpoints import fault

LOG = logging.getLogger(__name__)

# Queues a worker services (worker.go:60 area -- all builtin types plus
# the core GC scheduler).
DEFAULT_SCHEDULERS = [
    consts.JOB_TYPE_SERVICE,
    consts.JOB_TYPE_BATCH,
    consts.JOB_TYPE_SYSTEM,
    consts.JOB_TYPE_SYSBATCH,
    consts.JOB_TYPE_CORE,
]


class _EvalTask:
    """One pool task: completion event + confined exceptions."""

    __slots__ = ("fn", "args", "_done")

    def __init__(self, fn, args) -> None:
        self.fn = fn
        self.args = args
        self._done = threading.Event()

    def run(self) -> None:
        try:
            self.fn(*self.args)
        except Exception:                       # noqa: BLE001
            # confined like the old per-batch daemon threads: the task
            # (an eval wrapper) already acks/nacks its own eval; an
            # escaped exception must not kill the worker loop
            LOG.warning("worker eval task failed", exc_info=True)
        finally:
            self._done.set()

    def wait(self) -> None:
        self._done.wait()


class _EvalPool:
    """Persistent DAEMON-thread pool for batch eval fan-out.

    Deliberately not ``ThreadPoolExecutor``: its threads are non-daemon
    and joined by concurrent.futures' atexit hook, so an eval blocked
    in a cold kernel build would hold interpreter exit for tens of
    seconds — and a future's re-raised exception in the reap would kill
    the worker's run loop where the old per-batch daemon threads
    confined it. This pool keeps both semantics while making the
    threads PERSISTENT (the point of the change: no spawn/reap per
    eval per batch): threads spawn lazily up to ``max_threads`` and
    are always >= outstanding tasks — a queued-but-not-running eval
    would stall its wave's rendezvous until the coalescer deadline.
    """

    def __init__(self, max_threads: int, name: str) -> None:
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._max = max_threads
        self._name = name
        self._lock = threading.Lock()
        self._spawned = 0
        self._active = 0

    def submit(self, fn, *args) -> _EvalTask:
        task = _EvalTask(fn, args)
        spawn = 0
        with self._lock:
            self._active += 1
            if self._spawned < min(self._active, self._max):
                self._spawned += 1
                spawn = self._spawned
        self._q.put(task)
        if spawn:
            threading.Thread(
                target=self._run, daemon=True,
                name=f"{self._name}-{spawn}",
            ).start()
        return task

    def _run(self) -> None:
        try:
            while True:
                task = self._q.get()
                if task is None:
                    # retire sentinel. Normally shutdown() already
                    # un-booked this thread (reset _spawned to 0) and
                    # the floor makes this a no-op — but a RESPAWNED
                    # replacement (kill racing shutdown) that eats a
                    # stale sentinel is still booked, and leaving it
                    # counted would starve the next submit's spawn
                    # check with zero live threads behind it
                    with self._lock:
                        if self._spawned > 0:
                            self._spawned -= 1
                    return
                try:
                    task.run()
                finally:
                    with self._lock:
                        self._active -= 1
        except BaseException:
            # a task KILLED its thread (task.run confines Exception;
            # only BaseException — the chaos plane's FaultThreadKill,
            # or a real crash — escapes). The pool must not keep
            # counting the corpse as a server: un-book it, and if
            # tasks are still outstanding spawn a replacement so a
            # queued eval never waits on a thread that no longer
            # exists (found by the chaos cell — a killed
            # wave member otherwise wedged the whole batch's reap).
            respawn = False
            with self._lock:
                # floor at 0: shutdown() may have already reset the
                # spawn count (this corpse is then unbooked); going
                # negative would make the respawn check below — and
                # every later submit's spawn check — silently skip a
                # needed replacement
                if self._spawned > 0:
                    self._spawned -= 1
                if self._active > 0 and \
                        self._spawned < min(self._active, self._max):
                    self._spawned += 1
                    respawn = True
                    n = self._spawned
            if respawn:
                threading.Thread(
                    target=self._run, daemon=True,
                    name=f"{self._name}-{n}r",
                ).start()
            raise

    def shutdown(self) -> None:
        """Retire the current threads; in-flight tasks finish on their
        own (daemon threads never block interpreter exit). The pool
        stays USABLE: a batch still running past its worker's stop()
        join timeout may submit more chunks — resetting the spawn
        count lets those submits spawn fresh threads instead of
        queueing tasks no thread will ever serve (which would hang the
        batch's reap forever)."""
        with self._lock:
            n, self._spawned = self._spawned, 0
        for _ in range(n):
            self._q.put(None)


class _EvalRun:
    """Planner for one evaluation (worker.go:593 SubmitPlan etc.).

    Thread-confined so a batching worker can schedule many evals
    concurrently; the single-eval path uses it too.
    """

    def __init__(self, server, ev: Evaluation, token: str, snapshot,
                 plan_window=None) -> None:
        self.server = server
        self.eval = ev
        self.token = token
        self.snapshot = snapshot
        # batching workers install the coalescer's plan window here:
        # while this eval blocks on the serialized applier it yields
        # its wave-rendezvous slot, so the NEXT wave fires without
        # waiting for plan submission (plan submit pipelines behind
        # wave N instead of serializing wave N+1)
        self.plan_window = plan_window

    # --- Planner interface ---------------------------------------------

    def submit_plan(self, plan: Plan) -> Tuple[Optional[PlanResult], Optional[object]]:
        plan.eval_id = self.eval.id
        plan.eval_token = self.token
        plan.snapshot_index = self.snapshot.latest_index()
        if self.plan_window is not None:
            with self.plan_window:
                # deferred host post-processing (AllocMetric top-k
                # materialization) runs HERE: the wave-rendezvous slot
                # is yielded, so this work overlaps the next wave's
                # execute instead of the eval's own wave window
                plan.run_deferred()
                result = self.server.submit_plan(plan)
        else:
            plan.run_deferred()
            result = self.server.submit_plan(plan)
        state = None
        if result is not None and result.refresh_index > 0:
            # partial commit: hand the scheduler a newer snapshot to
            # retry against (worker.go:631-646)
            state = self.server.snapshot_min_index(result.refresh_index)
            self.snapshot = state
        return result, state

    def update_eval(self, ev: Evaluation) -> None:
        self.server.update_eval(ev, token=self.token)

    def create_eval(self, ev: Evaluation) -> None:
        ev.previous_eval = self.eval.id
        self.server.create_eval(ev, token=self.token)

    def reblock_eval(self, ev: Evaluation) -> None:
        self.server.reblock_eval(ev, token=self.token)

    def serve_rs_meet_minimum_version(self) -> bool:
        return True


class Worker:
    def __init__(
        self,
        server,
        worker_id: int = 0,
        schedulers: Optional[List[str]] = None,
        batch_size: int = 1,
    ) -> None:
        self.server = server
        self.id = worker_id
        self.schedulers = schedulers or list(DEFAULT_SCHEDULERS)
        self.batch_size = batch_size
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pause = threading.Event()
        self.processed = 0
        self.last_error: Optional[str] = None
        # cumulative coalescing stats from batch waves
        self.batch_launches = 0
        self.batch_requests = 0
        self.max_wave = 0
        # evals currently being scheduled, kept alive against the
        # broker's nack timeout by one long-lived heartbeat thread
        self._live: dict = {}
        self._live_lock = threading.Lock()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        # persistent eval-thread pool for batch scheduling: created
        # lazily on the first batch (single-eval workers never pay for
        # it), sized to the 2-deep chunk pipeline so every submitted
        # eval runs concurrently — the coalescer's rendezvous counts
        # it as a participant and a queued (not running) eval would
        # stall the wave until its deadline
        self._pool: Optional[_EvalPool] = None
        self._pool_lock = threading.Lock()

    # --- lifecycle (worker.go run/pause) --------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._hb_stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"worker-{self.id}"
        )
        self._thread.start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_outstanding, daemon=True,
            name=f"worker-{self.id}-hb",
        )
        self._hb_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._hb_stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            # in-flight evals finish (they ack/nack on their own);
            # idle pool threads exit
            pool.shutdown()

    def _eval_pool(self) -> _EvalPool:
        with self._pool_lock:
            if self._pool is None:
                self._pool = _EvalPool(
                    2 * self.MAX_WAVE, f"worker-{self.id}-eval")
            return self._pool

    def set_pause(self, paused: bool) -> None:
        """Leadership-change pause (leader.go:496 handlePausableWorkers)."""
        if paused:
            self._pause.set()
        else:
            self._pause.clear()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._pause.is_set():
                self._stop.wait(0.05)
                continue
            try:
                self.run_once(timeout=0.2)
            except BaseException:               # noqa: BLE001
                # the DISPATCH loop is infrastructure: in single-eval
                # mode _process runs on THIS thread, so a killed eval
                # (chaos FaultThreadKill, or any real crash past the
                # Exception confinement) would otherwise take the
                # whole worker down and strand every future eval —
                # the chaos cell found exactly that. The eval itself
                # stays abandoned (unacked; the broker's deadline
                # recovers it), the loop survives.
                LOG.warning("worker %d: eval dispatch crashed; "
                            "continuing", self.id, exc_info=True)

    # --- one dequeue->process->ack cycle --------------------------------

    def run_once(self, timeout: Optional[float] = 0.0) -> bool:
        """Process up to batch_size evals; returns True if any ran."""
        batch = self.server.eval_broker.dequeue_batch(
            self.schedulers, self.batch_size, timeout
        )
        if not batch:
            return False
        if len(batch) == 1 and getattr(self.server, "placement_turn",
                                       None) is None:
            # (a worker process under a placement turn places even a
            # single eval as a wave, so that it takes the turn)
            ev, token = batch[0]
            self._process(ev, token)
        else:
            # the envelope span: its exclusive CPU is the fan-out cost
            # (pool submit/reap) the per-eval spans can't see
            with tracer.span("worker.batch", trace_id=batch[0][0].id):
                self._process_batch(batch)
        return True

    def _heartbeat_outstanding(self) -> None:
        """OutstandingReset for every in-flight eval while scheduling
        runs long (worker.go keeps dequeued evals alive past the nack
        timeout; a cold kernel build can take tens of seconds). One
        long-lived thread per worker; evals register in _live."""
        # cadence must stay below the nack timer even when the timeout
        # is configured very small, or long evals get spuriously nacked
        nack = self.server.eval_broker.nack_timeout
        interval = min(max(nack / 3.0, 1.0), max(nack / 2.0, 0.1))
        while not self._hb_stop.wait(interval):
            with self._live_lock:
                items = list(self._live.items())
            for eid, token in items:
                try:
                    self.server.eval_broker.outstanding_reset(eid, token)
                except Exception:                   # noqa: BLE001
                    pass

    def _process(self, ev: Evaluation, token: str,
                 snapshot=None, launcher=None, cluster_provider=None,
                 plan_window=None) -> None:
        eval_id = ev.id
        # read the broker's enqueue stamp BEFORE processing: the ack
        # inside the span below drops it (the stamp lives in a
        # broker-local map, never on the store's immutable eval row)
        t_enq = self.server.eval_broker.enqueue_stamp(eval_id)
        # eval-thread seam (chaos plane): kind="kill" raises a
        # BaseException the except-Exception confinement below does NOT
        # catch — the thread dies mid-cohort with neither ack nor nack
        # (only the finallys unwind), and recovery must come from the
        # broker's auto-nack deadline. Placed BEFORE the _live
        # registration: past it, the try/finally owns the cleanup — a
        # kill between registering and the try would leave a stale
        # _live entry whose heartbeat resets would keep the dead eval
        # alive against the auto-nack forever.
        fault("worker.eval")
        with self._live_lock:
            self._live[ev.id] = token
        try:
            with tracer.span("eval.schedule", trace_id=ev.id):
                if snapshot is None:
                    # SnapshotMinIndex: local raft must catch up to the
                    # eval before scheduling (worker.go:537)
                    wait_index = max(ev.modify_index, ev.snapshot_index)
                    t_snap = time.monotonic()
                    with tracer.span("worker.snapshot"):
                        snapshot = self.server.snapshot_min_index(wait_index)
                    histograms.get("snapshot_wait").record(
                        time.monotonic() - t_snap)
                # stamp the snapshot the scheduler runs against on a
                # copy -- the store's row must stay immutable (worker.go
                # updateEvalSnapshotIndex routes this through Raft);
                # blocked evals derived from this one inherit the stamp
                ev = ev.copy()
                ev.snapshot_index = snapshot.latest_index()
                run = _EvalRun(self.server, ev, token, snapshot,
                               plan_window=plan_window)
                if ev.type == consts.JOB_TYPE_CORE:
                    sched = self.server.new_core_scheduler(snapshot, run)
                else:
                    kw = {}
                    if launcher is not None:
                        kw["kernel_launch"] = launcher
                    if cluster_provider is not None:
                        kw["cluster_provider"] = cluster_provider
                    sched = new_scheduler(ev.type, snapshot, run,
                                          device=self.server.device, **kw)
                sched.process(ev)
                self.server.eval_broker.ack(ev.id, token)
            if t_enq:
                # e2e latency: broker-enqueue → committed (the ack
                # above follows the eval's final plan commit). The
                # histogram is always-on (one log + one short lock);
                # the e2e marker span and the slow-eval flight
                # recorder ride only when tracing is enabled — the
                # marker is what anchors this eval's critical-path
                # waterfall, the recorder what captures its tree if
                # it lands beyond the adaptive p99 threshold.
                # Recorded BEFORE the processed bump: monitors settle
                # on that counter, so the sample must already be in
                # the histogram when the counter moves (the tail
                # section's count-equality gate).
                e2e_s = time.monotonic() - t_enq
                histograms.get("e2e").record(e2e_s)
                if tracer.enabled:
                    tracer.record("eval.e2e", e2e_s, trace_id=eval_id)
                    flight_recorder.observe(eval_id, e2e_s)
            with self._live_lock:
                # += from up to MAX_WAVE concurrent eval threads is a
                # read-modify-write race; monitors poll this counter
                self.processed += 1
        except Exception as e:                      # noqa: BLE001
            import traceback
            self.last_error = traceback.format_exc()
            LOG.warning("worker %d: eval %s failed: %s", self.id, ev.id, e)
            try:
                self.server.eval_broker.nack(ev.id, token)
            except Exception:                       # noqa: BLE001
                pass
        finally:
            with self._live_lock:
                self._live.pop(ev.id, None)

    #: Concurrent eval threads per wave. Bounds thread count for large
    #: batches (one Python thread per eval would collapse under GIL
    #: contention at bench batch sizes) and matches the largest
    #: wave bucket below 256, so waves stay on few shapes.
    MAX_WAVE = 64

    def _process_batch(self, batch: List[Tuple[Evaluation, str]]) -> None:
        """Schedule a batch of evals concurrently with coalesced launches.

        All evals share one snapshot taken at the max of their wait
        indexes (each still stamps its own copy); their placement
        kernels fire as joint waves. Plans submit per-eval through the
        normal applier path, so conflicting placements resolve exactly
        as they do between reference workers: re-validation + partial
        commit + retry against a refreshed snapshot.

        Batches larger than MAX_WAVE split into chunks, each with its
        own rendezvous — started CONCURRENTLY, because a wave's device
        execution releases the GIL while every one of its participants
        is parked: with a second chunk in flight, its threads do their
        host-side tensor builds exactly inside that window, so device
        time and Python time overlap instead of strictly alternating.
        All chunks share the one snapshot (reference workers routinely
        schedule against state that other workers' plans are landing
        on).
        """
        from nomad_tpu_torch.parallel.coalesce import ClusterCache, LaunchCoalescer

        wait_index = max(
            max(ev.modify_index, ev.snapshot_index) for ev, _ in batch
        )
        try:
            t_snap = time.monotonic()
            with tracer.span("worker.snapshot", trace_id=batch[0][0].id):
                snapshot = self.server.snapshot_min_index(wait_index)
            histograms.get("snapshot_wait").record(
                time.monotonic() - t_snap)
        except Exception:                           # noqa: BLE001
            # snapshot catch-up failed for the whole batch: nack all
            for ev, token in batch:
                try:
                    self.server.eval_broker.nack(ev.id, token)
                except Exception:                   # noqa: BLE001
                    pass
            return
        # eval threads re-parent their spans under this batch's trace
        trace_ctx = tracer.context() or (
            (batch[0][0].id, 0) if tracer.enabled else None)

        # snapshot planes go resident on the waves' device
        clusters = ClusterCache(self.server.device)
        # the persistent pool replaces a thread spawn/reap per eval per
        # batch (TRACE_DECOMP: ~0.5-1 ms/eval of worker fanout): chunk
        # tasks are SUBMITTED to long-lived daemon threads and reaped
        # via completion events; tracer context still attaches per
        # task inside one()
        pool = self._eval_pool()
        in_flight: List[Tuple[List, "LaunchCoalescer"]] = []

        def reap(group) -> None:
            tasks, coalescer = group
            for t in tasks:
                t.wait()
            self.batch_launches += coalescer.launches
            self.batch_requests += coalescer.requests
            self.max_wave = max(self.max_wave, coalescer.max_wave)

        for start in range(0, len(batch), self.MAX_WAVE):
            # 2-deep pipeline: chunk N+1 builds while chunk N's wave
            # executes, but total live threads stay <= 2 x MAX_WAVE
            # (unbounded fan-out is the GIL collapse MAX_WAVE exists
            # to prevent)
            if len(in_flight) >= 2:
                reap(in_flight.pop(0))
            chunk = batch[start:start + self.MAX_WAVE]
            cfg = self.server.config
            coalescer = LaunchCoalescer(
                len(chunk), device=self.server.device,
                window_min_s=cfg.coalesce_window_min_ms / 1e3,
                window_max_s=cfg.coalesce_window_max_ms / 1e3,
                adaptive=cfg.coalesce_adaptive,
                # a worker process's waves take the owner's placement
                # turn (server/workerproc); in-process waves take none
                turn=getattr(self.server, "placement_turn", None),
                # the server's own device mesh (None: one device), read
                # per batch, so a mesh adopted late serves later batches
                mesh=getattr(self.server, "wave_mesh", None),
            )

            def one(ev: Evaluation, token: str,
                    coalescer=coalescer) -> None:
                try:
                    with tracer.attach(trace_ctx):
                        self._process(
                            ev, token,
                            snapshot=snapshot,
                            launcher=coalescer.launch,
                            cluster_provider=clusters.get,
                            plan_window=coalescer.plan_window(),
                        )
                finally:
                    coalescer.done()

            tasks = [
                pool.submit(one, ev, token) for ev, token in chunk
            ]
            in_flight.append((tasks, coalescer))
        for group in in_flight:
            reap(group)
