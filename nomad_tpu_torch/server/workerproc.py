"""Multi-process scheduler workers over MVCC snapshot generations.

The consensus process keeps the plan apply/group commit, the broker, the
store and the serving plane; N worker PROCESSES run the GIL-heavy host
side of scheduling — dequeue → snapshot → feasibility → reconcile →
assembly → plan-build — each against its own replica of the MVCC store,
and submit built plans back over IPC. Reference shape: Nomad's many
``worker.go`` loops against one go-memdb store, here spread over
interpreters so scheduler Python stops sharing the consensus process's
GIL.

Counterpart of ``nomad_tpu/server/workerproc.py``, with two design
changes. Every worker process opens the owner's device (``server.device``,
named in the hello) and places its waves there. Its real ``Worker``
builds its ``LaunchCoalescer``, ``ClusterCache`` and schedulers on that
device, so each process has its own CUDA context, its own resident
cluster planes (advanced by dirty rows as ``apply_frame`` replays the
owner's changes into the replica) and its own B1 launches. (The JAX
package's workers place on the CPU by design.) A process that cannot
open its device says so in its first message: ``start()`` raises, and a
respawned one is not respawned again. Heartbeats carry each process's
wave counters (device, B1 launches, fused-wave launches, fallbacks and
failures, device-state errors, waves and their members, turns, RSS),
shown per process in ``stats()["children"]``. And with two or more
processes their waves take a placement turn (``_TurnLock``): without
it, concurrent waves binpack onto the same nodes from their own
snapshots, and on a packed cluster evals run out of plan attempts.

Topology (one supervisor in the consensus process):

    consensus process                     worker process k
    -----------------                     ----------------
    EvalBroker --dequeue_batch--> WorkerProcSupervisor
         (lease: evals+tokens+stamps) --> _ProxyBroker --> Worker
         (state: bootstrap/(gen,delta)) -> apply_frame -> replica store
    Planner <------------ rpc: submit_plan/update_eval <-- _EvalRun
    EvalBroker  <------- ack/nack (+span rows) ---------- _ProxyBroker

Protocol invariants:

- The broker's ``dequeue_batch`` fill window is the shard point: the
  supervisor dequeues whole batches and LEASES each to one worker, so
  the wave-batching shape survives the process split. The broker's
  unacked tracking is the lease ledger — on worker death the supervisor
  re-enqueues everything that worker still held via ``enqueue_all``
  (ack-if-held then enqueue, the broker's own recovery primitive) and
  respawns the process.
- State ships as ONE bootstrap frame at attach, then ``(gen, delta)``
  frames (state/store.delta_frame — identity-pruned pmap diffs, the
  WAL's CRC framing underneath via utils/ipc), each pickled once by the
  owner so its bytes are metered. The owner pins each shipped generation
  with a liveness-bounded lease (state/store.lease_generation) renewed on
  worker heartbeats, so the weak registry cannot free a root a remote
  reader still addresses.
- Frames and RPC replies share one FIFO pipe and the owner sends the
  state frame BEFORE the rpc result that references it, so a worker's
  ``snapshot_min_index(refresh_index)`` finds its replica already
  caught up (same-pipe ordering, no cross-process index wait). The
  placement turn's grant is such a reply: the wave that takes it sees
  every plan committed before it.
- Worker span rows ship back with heartbeats and acks; the owner
  ingests them into its tracer (trace ids are eval ids on both sides),
  so per-worker stages still land in ONE e2e waterfall. The e2e
  histogram sample itself is recorded owner-side at ack receipt —
  broker enqueue stamp to ack, same origin as in-process workers.
"""

from __future__ import annotations

import itertools
import logging
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch.ops import cuda_kernel
from nomad_tpu_torch.parallel import coalesce
from nomad_tpu_torch.scheduler import system
from nomad_tpu_torch.state.store import (
    StateStore,
    apply_frame,
    bootstrap_frame,
    delta_frame,
    release_generation_lease,
    release_owner_leases,
    renew_owner_leases,
    expire_generation_leases,
)
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation
from nomad_tpu_torch.telemetry.histogram import histograms
from nomad_tpu_torch.telemetry.trace import flight_recorder, tracer
from nomad_tpu_torch.tensors.device_state import default_device_state
from nomad_tpu_torch.utils.faultpoints import FaultError, fault
from nomad_tpu_torch.utils.ipc import (
    Channel,
    FrameError,
    channel_from_fd,
    socket_pair,
)

LOG = logging.getLogger(__name__)

#: queues leased out to worker processes; the core (GC) scheduler runs
#: its store-mutating callbacks in the owner and stays in-process
WORKER_SCHEDULERS = [
    consts.JOB_TYPE_SERVICE,
    consts.JOB_TYPE_BATCH,
    consts.JOB_TYPE_SYSTEM,
    consts.JOB_TYPE_SYSBATCH,
]

#: per-worker span-id offset: child span ids start at (id+1) * 1e12 so
#: they never collide with the owner's counter in the merged waterfall
_SPAN_ID_STRIDE = 10 ** 12

#: worker-side heartbeat cadence (liveness + lease renewal + span flush
#: + wave counters)
_HB_INTERVAL_S = 0.2

#: owner-side ping cadence feeding the worker_ipc round-trip histogram
_PING_INTERVAL_S = 0.5

#: how long ``start()`` waits for a worker process to report its device
#: (interpreter start, torch import, device context)
_READY_TIMEOUT_S = 180.0


# ---------------------------------------------------------------------------
# worker-process side
# ---------------------------------------------------------------------------


class _ProxyBroker:
    """The worker process's stand-in for the owner's EvalBroker.

    ``dequeue_batch`` hands out leased evals; acks/nacks/heartbeat
    resets become messages. Enqueue stamps ship with the lease (Linux
    monotonic clocks are system-wide, so owner stamps compare against
    worker clocks), keeping the worker's local latency view honest.
    """

    def __init__(self, chan: Channel, nack_timeout: float) -> None:
        self.chan = chan
        self.nack_timeout = nack_timeout
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[Tuple[Evaluation, str]] = []
        self._stamps: Dict[str, float] = {}

    def feed(self, evals: List[Tuple[Evaluation, str]],
             stamps: Dict[str, float]) -> None:
        with self._lock:
            self._queue.extend(evals)
            self._stamps.update(stamps)
            self._cond.notify_all()

    def dequeue_batch(self, schedulers: List[str], batch: int,
                      timeout: Optional[float] = None,
                      ) -> List[Tuple[Evaluation, str]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self._queue:
                wait = None if deadline is None \
                    else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    return []
                self._cond.wait(wait)
            out, self._queue = self._queue[:batch], self._queue[batch:]
            return out

    def ack(self, eval_id: str, token: str) -> None:
        self.chan.send({"t": "ack", "eval_id": eval_id, "token": token,
                        "spans": tracer.drain_rows()
                        if tracer.enabled else None})
        with self._lock:
            self._stamps.pop(eval_id, None)

    def nack(self, eval_id: str, token: str) -> None:
        self.chan.send({"t": "nack", "eval_id": eval_id, "token": token})
        with self._lock:
            self._stamps.pop(eval_id, None)

    def enqueue_stamp(self, eval_id: str) -> float:
        with self._lock:
            return self._stamps.get(eval_id, 0.0)

    def outstanding_reset(self, eval_id: str, token: str) -> None:
        # the owner applies the reset against the real broker AND
        # treats it as a liveness signal (lease renewal)
        self.chan.send({"t": "hb", "resets": [(eval_id, token)]})


class _OwnerProxy:
    """The worker process's stand-in for the Server: the exact surface
    ``Worker``/``_EvalRun`` touch, backed by the replica store for
    reads and request/reply RPCs for every state mutation. ``device`` is
    the owner's device, opened in this process: the worker's waves and
    single-eval launches run there."""

    def __init__(self, chan: Channel, replica: StateStore, broker:
                 _ProxyBroker, config, device) -> None:
        self.chan = chan
        self.state = replica
        self.eval_broker = broker
        self.config = config
        self.device = device
        #: set by ``worker_main`` when the owner runs several processes
        self.placement_turn: Optional[_PlacementTurn] = None
        # device ownership stays with the consensus process: no mesh,
        # as in the reference's worker processes
        self.wave_mesh = None
        self._rpc_lock = threading.Lock()
        self._rpc_seq = itertools.count(1)
        self._rpc_pending: Dict[int, List] = {}
        self._index_cond = threading.Condition()

    # -- replica upkeep (reader loop) -----------------------------------

    def note_state_advanced(self) -> None:
        with self._index_cond:
            self._index_cond.notify_all()

    def resolve_rpc(self, msg: Dict) -> None:
        with self._rpc_lock:
            entry = self._rpc_pending.pop(msg["rid"], None)
        if entry is None:
            return
        entry[1] = msg
        entry[0].set()

    # -- Server surface --------------------------------------------------

    def _rpc(self, payload: Dict):
        rid = next(self._rpc_seq)
        done = threading.Event()
        entry = [done, None]
        with self._rpc_lock:
            self._rpc_pending[rid] = entry
        payload["t"] = "rpc"
        payload["rid"] = rid
        t0 = time.monotonic()
        self.chan.send(payload)
        if not done.wait(60.0):
            with self._rpc_lock:
                self._rpc_pending.pop(rid, None)
            raise TimeoutError(f"worker rpc {payload['m']} timed out")
        # request to reply, the state frame sent before it included
        histograms.get("worker_rpc").record(time.monotonic() - t0)
        msg = entry[1]
        if not msg["ok"]:
            raise RuntimeError(msg["error"])
        return msg.get("value")

    def submit_plan(self, plan):
        # deferred thunks already ran worker-side (_EvalRun calls
        # run_deferred before submit); what crosses the pipe is data
        return self._rpc({"m": "submit_plan", "plan": plan})

    def update_eval(self, ev: Evaluation, token: str = "") -> None:
        self._rpc({"m": "update_eval", "eval": ev, "token": token})

    def create_eval(self, ev: Evaluation, token: str = "") -> None:
        self._rpc({"m": "create_eval", "eval": ev, "token": token})

    def reblock_eval(self, ev: Evaluation, token: str = "") -> None:
        self._rpc({"m": "reblock_eval", "eval": ev, "token": token})

    def snapshot_min_index(self, index: int, timeout: float = 5.0):
        """Replica-local SnapshotMinIndex: the owner pushes a state
        frame down the same FIFO pipe before any reply that references
        its index, so this normally returns immediately; the bounded
        wait covers reordering bugs loudly rather than scheduling
        against stale state."""
        deadline = time.monotonic() + timeout
        with self._index_cond:
            while self.state.latest_index() < index:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    raise TimeoutError(
                        f"replica index {self.state.latest_index()} "
                        f"< {index}")
                self._index_cond.wait(min(wait, 0.05))
        return self.state.snapshot()

    def new_core_scheduler(self, snapshot, planner):
        raise RuntimeError("core evals are owner-only; a worker "
                           "process must never receive one")


class _PlacementTurn:
    """A worker process's side of the placement turn (see
    ``WorkerProcSupervisor``), given to its waves' ``LaunchCoalescer``.

    ``begin`` asks the owner for the turn; the owner pushes its newest
    state frame before it answers, so the replica then holds every plan
    committed so far. Each member placing from its snapshot's shared
    usage planes (the read-only ``gathered_usage`` arrays of an empty
    plan) on the same node axis gets the newest snapshot's planes in
    their place; any other member keeps its own. ``end`` gives the turn
    back."""

    def __init__(self, proxy: "_OwnerProxy") -> None:
        self.proxy = proxy
        self.clusters = coalesce.ClusterCache(proxy.device)
        self.grants = 0
        self.refreshed = 0
        self.kept = 0
        self.wait_s = 0.0

    def begin(self, kins: List) -> List:
        from nomad_tpu_torch.tensors.schema import ClusterTensors

        t0 = time.monotonic()
        self.proxy._rpc({"m": "placement_turn"})
        self.wait_s += time.monotonic() - t0
        self.grants += 1
        snap = self.proxy.state.snapshot()
        usage = getattr(snap, "usage", None)
        if usage is None:
            self.kept += len(kins)
            return kins
        try:
            cluster = self.clusters.get(snap)
            fields = ClusterTensors.WAVE_USAGE_FIELDS
            fresh = dict(zip(fields, cluster.gathered_usage(usage)))
        except BaseException:
            # the wave fails without holding the turn: give it back
            self.end()
            raise
        out = []
        for kin in kins:
            shared = kin.cap_cpu is cluster.cap_cpu and all(
                isinstance(getattr(kin, f), np.ndarray)
                and not getattr(kin, f).flags.writeable for f in fields)
            if shared:
                kin = kin._replace(**fresh)
                self.refreshed += 1
            else:
                self.kept += 1
            out.append(kin)
        return out

    def end(self) -> None:
        try:
            self.proxy.chan.send({"t": "turn_end"})
        except (OSError, EOFError):
            pass

    def snapshot(self) -> Dict:
        return {"grants": self.grants, "refreshed": self.refreshed,
                "kept": self.kept, "wait_s": self.wait_s}

    def reset(self) -> None:
        self.grants = self.refreshed = self.kept = 0
        self.wait_s = 0.0


def _open_device(name: str):
    """``(device, its name)``: the device resolved and a first tensor made
    on it, so a card that cannot be opened fails here and not in a
    wave."""
    import torch

    from nomad_tpu_torch.device import resolve_device

    dev = resolve_device(name)
    torch.zeros(1, device=dev)
    if dev.type == "cuda":
        return dev, torch.cuda.get_device_name(dev)
    return dev, "cpu"


def _rss_bytes() -> int:
    """This process's resident memory (``VmRSS``); 0 where /proc has
    none."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class _ChildCounters:
    """The wave counters a worker process reports with each heartbeat.

    Process-wide counters (B1 launches, fused-wave stats, the device
    state's, the system mask's) are read as they stand and zeroed by
    ``reset``; the worker's own cumulative counters are reported against
    the baseline ``reset`` takes. ``first_wave_ms`` is the latency of the
    process's first wave (its cold start on the device) and survives a
    reset. ``rpc_p50_ms``/``rpc_p99_ms`` are the round trips of its RPCs
    (request to reply, the state frame before the reply included), and
    ``frame_apply_s`` the seconds its reader spent applying frames.
    ``turn`` counts the placement turns its waves took (grants, members
    given the newest usage, members that kept their own, seconds waited)."""

    def __init__(self, worker, device_name: str,
                 turn: Optional[_PlacementTurn]) -> None:
        self.worker = worker
        self.device_name = device_name
        self.turn = turn
        self.first_wave_ms: Optional[float] = None
        self.frames = 0
        self.frame_apply_s = 0.0
        self.frame_apply_max_s = 0.0
        self.bootstrap_apply_s: Optional[float] = None
        self._base = (0, 0, 0)

    def note_frame(self, bootstrap: bool, seconds: float) -> None:
        if bootstrap and self.bootstrap_apply_s is None:
            self.bootstrap_apply_s = seconds
            return
        self.frames += 1
        self.frame_apply_s += seconds
        self.frame_apply_max_s = max(self.frame_apply_max_s, seconds)

    def snapshot(self) -> Dict:
        if self.first_wave_ms is None and coalesce.wave_stats._wave_s:
            self.first_wave_ms = coalesce.wave_stats._wave_s[0] * 1e3
        w = self.worker
        waves, requests, processed = self._base
        rpc = histograms.get("worker_rpc")
        rpc_p50, rpc_p99 = rpc.quantiles((0.5, 0.99))
        return {
            "pid": os.getpid(), "device": self.device_name,
            "b1_launches": cuda_kernel.launches,
            "fused": coalesce.fused_wave_stats.snapshot(),
            "device_state": default_device_state.snapshot(),
            "mask_launches": system.mask_launches,
            "waves": w.batch_launches - waves,
            "requests": w.batch_requests - requests,
            "processed": w.processed - processed,
            "first_wave_ms": self.first_wave_ms,
            "rpcs": rpc.count, "rpc_p50_ms": rpc_p50 * 1e3,
            "rpc_p99_ms": rpc_p99 * 1e3,
            "frames": self.frames, "frame_apply_s": self.frame_apply_s,
            "frame_apply_max_s": self.frame_apply_max_s,
            "bootstrap_apply_s": self.bootstrap_apply_s,
            "rss_bytes": _rss_bytes(), "last_error": w.last_error,
            "turn": self.turn.snapshot() if self.turn is not None else None,
        }

    def reset(self) -> None:
        cuda_kernel.launches = 0
        coalesce.fused_wave_stats.reset()
        default_device_state.reset_stats()
        system.mask_launches = 0
        histograms.get("worker_rpc").reset()
        self.frames, self.frame_apply_s, self.frame_apply_max_s = 0, 0.0, 0.0
        w = self.worker
        self._base = (w.batch_launches, w.batch_requests, w.processed)
        if self.turn is not None:
            self.turn.reset()


def _child_main() -> None:
    """``python -c`` entry of a worker process: reconstruct the channel
    from the inherited socketpair fd, receive the hello (config, device
    and scheduler list — config objects ride the framed channel, never
    argv), open the device and report it (or the error that kept it
    from opening, then exit), run the worker loop until stop/EOF."""
    worker_id, fd = int(sys.argv[1]), int(sys.argv[2])
    chan = channel_from_fd(fd)
    hello = chan.recv()
    try:
        device, name = _open_device(hello["device"])
    except Exception as e:                      # noqa: BLE001
        chan.send({"t": "ready", "pid": os.getpid(), "device": None,
                   "error": f"{type(e).__name__}: {e}"})
        chan.close()
        sys.exit(1)
    chan.send({"t": "ready", "pid": os.getpid(), "device": name,
               "error": None})
    worker_main(worker_id, chan, hello["config"], hello["schedulers"],
                device, name, hello["placement_turn"])


def worker_main(worker_id: int, chan: Channel, config,
                schedulers: List[str], device, device_name: str,
                placement_turn: bool = False) -> None:
    """Body of one scheduler worker process.

    Builds a replica StateStore fed by transport frames, a proxy
    broker/server pair on ``device``, and a REAL ``Worker`` on top — the
    scheduling loop, wave batching, heartbeats, and eval pool are the
    in-process code paths, unchanged. With ``placement_turn`` its waves
    take the owner's placement turn. The main thread is the channel
    reader; it also answers the owner's probes (a heartbeat now, the
    counters' reset, the resident planes against a fresh upload).
    """
    from nomad_tpu_torch.telemetry import trace as trace_mod
    from nomad_tpu_torch.server.worker import Worker

    # span ids from this process never collide with the owner's
    trace_mod._ids = itertools.count((worker_id + 1) * _SPAN_ID_STRIDE)

    replica = StateStore()
    broker = _ProxyBroker(chan, config.nack_timeout)
    proxy = _OwnerProxy(chan, replica, broker, config, device)
    if placement_turn:
        proxy.placement_turn = _PlacementTurn(proxy)
    worker = Worker(proxy, worker_id, schedulers=list(schedulers),
                    batch_size=config.worker_batch_size)
    counters = _ChildCounters(worker, device_name, proxy.placement_turn)
    worker.start()

    stop = threading.Event()

    def send_heartbeat() -> None:
        rows = tracer.drain_rows() if tracer.enabled else None
        chan.send({"t": "hb", "resets": [], "spans": rows,
                   "stats": counters.snapshot()})

    def heartbeat() -> None:
        # liveness + lease renewal + span flush + wave counters, even
        # when idle
        while not stop.wait(_HB_INTERVAL_S):
            try:
                send_heartbeat()
            except (OSError, EOFError):
                return

    threading.Thread(target=heartbeat, daemon=True,
                     name=f"workerproc-{worker_id}-hb").start()

    probes = {
        # the heartbeat rides the pipe ahead of the probe's answer, so
        # the owner holds these counters once the probe returns
        "heartbeat": send_heartbeat,
        "reset": counters.reset,
        "resident": lambda: default_device_state.check_fresh(
            replica.snapshot(), device),
    }
    try:
        while True:
            try:
                msg = chan.recv()
            except (EOFError, OSError):
                break           # owner is gone; daemon process exits
            except FrameError as e:
                LOG.warning("worker %d: dropped frame: %s", worker_id, e)
                continue
            t = msg["t"]
            if t == "state":
                t0 = time.perf_counter()
                frame = pickle.loads(msg["blob"])
                apply_frame(replica, frame)
                counters.note_frame(frame["kind"] == "bootstrap",
                                    time.perf_counter() - t0)
                proxy.note_state_advanced()
            elif t == "lease":
                if msg["trace"] and not tracer.enabled:
                    tracer.enable()
                elif not msg["trace"] and tracer.enabled:
                    tracer.disable()
                broker.feed(msg["evals"], msg["stamps"])
            elif t == "rpc_result":
                proxy.resolve_rpc(msg)
            elif t == "ping":
                chan.send({"t": "pong", "ts": msg["ts"]})
            elif t == "probe":
                value, err = None, None
                try:
                    value = probes[msg["kind"]]()
                except Exception as e:          # noqa: BLE001
                    err = f"{type(e).__name__}: {e}"
                chan.send({"t": "probe_result", "id": msg["id"],
                           "value": value, "error": err})
            elif t == "stop":
                break
    finally:
        stop.set()
        worker.stop()
        chan.close()


# ---------------------------------------------------------------------------
# consensus-process side
# ---------------------------------------------------------------------------


class _WorkerHandle:
    """Owner-side record of one worker process: its channel, lease
    ledger, the generation its replica is synced to, the device it
    reported and its last wave counters."""

    def __init__(self, supervisor: "WorkerProcSupervisor",
                 worker_id: int) -> None:
        self.sup = supervisor
        self.server = supervisor.server
        self.worker_id = worker_id
        #: generation-lease owner key (state/store lease registry)
        self.owner_key = f"workerproc-{id(supervisor):x}-{worker_id}"
        #: eval_id -> (eval, token) this worker currently holds
        self.outstanding: Dict[str, Tuple[Evaluation, str]] = {}
        self.out_lock = threading.Lock()
        #: serializes frame generation order per worker
        self.state_lock = threading.Lock()
        self.synced_gen: Optional[int] = None
        self.acked = 0
        self.last_hb = time.monotonic()
        self.last_ping = 0.0
        self.recovered = False
        self.proc = None
        self.chan: Optional[Channel] = None
        self._reader: Optional[threading.Thread] = None
        #: set when the process reported its device (or died first)
        self.ready = threading.Event()
        self.device_name: Optional[str] = None
        self.device_error: Optional[str] = None
        #: the process's wave counters from its last heartbeat
        self.child_stats: Dict = {}
        self.frames_sent = 0
        self.frame_bytes = 0
        self.bootstrap_bytes = 0
        self.bootstrap_s: Optional[float] = None
        self._probe_seq = itertools.count(1)
        self._probes: Dict[int, List] = {}
        self._probe_lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------

    def spawn(self) -> None:
        """Spawn a FRESH interpreter (subprocess, not fork: forking
        would clone the owner's device context, locks, and threads) and
        hand it one socketpair end by fd. Config and device cross as
        the hello message over the framed channel, never argv."""
        ours, theirs = socket_pair()
        self.chan = Channel(ours)
        env = dict(os.environ)
        # the child resolves nomad_tpu_torch exactly as this process
        # does (test runs are often cwd-rooted, not installed)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in sys.path if p) or env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "from nomad_tpu_torch.server.workerproc import _child_main; "
             "_child_main()",
             str(self.worker_id), str(theirs.fileno())],
            pass_fds=(theirs.fileno(),),
            env=env,
            close_fds=True,
        )
        # the child holds its end now; closing ours-side copy makes the
        # child's recv raise EOF if this process dies
        theirs.close()
        self.chan.send({"t": "hello", "config": self.server.config,
                        "device": str(self.sup.device),
                        "schedulers": WORKER_SCHEDULERS,
                        "placement_turn": self.sup.turn is not None})
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"workerproc-{self.worker_id}-reader")
        self._reader.start()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def serving(self) -> bool:
        """Alive and placing on its device: a lease may go to it."""
        return self.ready.is_set() and self.device_error is None \
            and self.alive()

    def _join(self, timeout: float) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass

    def close(self, stop_msg: bool = False) -> None:
        if self.chan is not None and stop_msg:
            try:
                self.chan.send({"t": "stop"})
            except (OSError, EOFError):
                pass
        if self.proc is not None:
            self._join(2.0 if stop_msg else 0.2)
            if self.proc.poll() is None:
                self.proc.terminate()
                self._join(1.0)
            if self.proc.poll() is None:
                self.proc.kill()
                self._join(1.0)
        if self.chan is not None:
            self.chan.close()
            self.chan = None
        release_owner_leases(self.owner_key)
        self.synced_gen = None

    # -- leasing ---------------------------------------------------------

    def lease(self, batch: List[Tuple[Evaluation, str]]) -> None:
        broker = self.server.eval_broker
        with self.out_lock:
            for ev, token in batch:
                self.outstanding[ev.id] = (ev, token)
        stamps = {ev.id: broker.enqueue_stamp(ev.id) for ev, _ in batch}
        self.sync_state()
        self.chan.send({"t": "lease", "evals": batch, "stamps": stamps,
                        "trace": tracer.enabled})
        # chaos seam: REAL process death mid-lease — the worker holds
        # the evals, its replica is synced, and SIGKILL gives it no
        # chance to ack, nack, or clean up. Recovery must come entirely
        # from the supervisor's liveness monitor re-enqueueing the
        # lease ledger.
        try:
            fault("workerproc.kill")
        except FaultError:
            LOG.warning("chaos: SIGKILL worker process %d mid-lease",
                        self.worker_id)
            os.kill(self.proc.pid, signal.SIGKILL)

    def sync_state(self) -> None:
        """Bring the worker's replica to the owner's current root:
        one (gen, delta) frame — bootstrap only at attach or if the
        base generation's root was lost (lease expiry after a long
        wedge). Holds state_lock through the send so frames always
        arrive in generation order. The frame is pickled here, once,
        so its bytes are metered."""
        with self.state_lock:
            store = self.server.state
            if store.current_generation() == self.synced_gen:
                return
            t0 = time.perf_counter()
            frame = None
            if self.synced_gen is not None:
                frame = delta_frame(store, self.synced_gen,
                                    pin_owner=self.owner_key)
            if frame is None:
                if store.current_generation() == self.synced_gen:
                    return      # writer raced us back to synced
                frame = bootstrap_frame(store, pin_owner=self.owner_key)
            blob = pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)
            self.chan.send({"t": "state", "blob": blob})
            self.frames_sent += 1
            self.frame_bytes += len(blob)
            if frame["kind"] == "bootstrap" and self.bootstrap_s is None:
                self.bootstrap_bytes = len(blob)
                self.bootstrap_s = time.perf_counter() - t0
            prev, self.synced_gen = self.synced_gen, frame["generation"]
            if prev is not None and prev != self.synced_gen:
                release_generation_lease(prev, self.owner_key)

    def probe(self, kind: str, timeout: float = 120.0):
        """Ask the process for ``kind`` and wait for its answer; raises on
        an error or a timeout. ``heartbeat``: it sends one now, so
        ``child_stats`` holds its counters when this returns; ``reset``:
        it zeroes them; ``resident``: its resident planes against a fresh
        upload of its replica's snapshot."""
        pid = next(self._probe_seq)
        entry = [threading.Event(), None]
        with self._probe_lock:
            self._probes[pid] = entry
        self.chan.send({"t": "probe", "id": pid, "kind": kind})
        if not entry[0].wait(timeout):
            with self._probe_lock:
                self._probes.pop(pid, None)
            raise TimeoutError(f"worker process {self.worker_id}: probe "
                               f"{kind} timed out")
        msg = entry[1]
        if msg["error"]:
            raise RuntimeError(f"worker process {self.worker_id}: probe "
                               f"{kind}: {msg['error']}")
        return msg["value"]

    def stats(self) -> Dict:
        with self.out_lock:
            outstanding, acked = len(self.outstanding), self.acked
        return {
            "worker_id": self.worker_id,
            "pid": self.proc.pid if self.proc is not None else None,
            "alive": self.alive(), "device": self.device_name,
            "device_error": self.device_error,
            "acked": acked, "outstanding": outstanding,
            "frames_sent": self.frames_sent, "frame_bytes": self.frame_bytes,
            "bootstrap_bytes": self.bootstrap_bytes,
            "bootstrap_s": self.bootstrap_s,
            "counters": dict(self.child_stats),
        }

    # -- message handling ------------------------------------------------

    def _read_loop(self) -> None:
        chan = self.chan
        while True:
            try:
                msg = chan.recv()
            except (EOFError, OSError):
                if not self.ready.is_set():
                    self.device_error = (
                        f"worker process {self.worker_id} exited before it "
                        "reported its device")
                    self.ready.set()
                return
            except FrameError as e:
                LOG.warning("workerproc %d: dropped frame: %s",
                            self.worker_id, e)
                continue
            try:
                t = msg["t"]
                if t == "ack":
                    self._on_ack(msg)
                elif t == "nack":
                    self._on_nack(msg)
                elif t == "hb":
                    self._on_hb(msg)
                elif t == "pong":
                    histograms.get("worker_ipc").record(
                        time.monotonic() - msg["ts"])
                elif t == "rpc":
                    # NEVER inline: submit_plan blocks on the applier
                    # (up to 30s) and the reader must keep draining
                    self.sup.rpc_pool.submit(self._on_rpc, msg)
                elif t == "turn_end":
                    self.sup.turn.release(self)
                elif t == "ready":
                    self.device_name = msg["device"]
                    self.device_error = msg["error"]
                    self.ready.set()
                elif t == "probe_result":
                    with self._probe_lock:
                        entry = self._probes.pop(msg["id"], None)
                    if entry is not None:
                        entry[1] = msg
                        entry[0].set()
            except Exception:                   # noqa: BLE001
                LOG.warning("workerproc %d: message %s failed",
                            self.worker_id, msg.get("t"), exc_info=True)

    def _on_ack(self, msg: Dict) -> None:
        eid, token = msg["eval_id"], msg["token"]
        broker = self.server.eval_broker
        # e2e origin read BEFORE the ack drops the stamp — the same
        # discipline as the in-process worker
        t_enq = broker.enqueue_stamp(eid)
        try:
            broker.ack(eid, token)
        except Exception as e:                  # noqa: BLE001
            # in-process parity: a failed ack (chaos seam, or a lease
            # already recovered after a presumed-dead worker revived)
            # converges through nack/auto-nack redelivery
            LOG.warning("workerproc %d: ack %s failed: %s",
                        self.worker_id, eid, e)
            try:
                broker.nack(eid, token)
            except Exception:                   # noqa: BLE001
                pass
            with self.out_lock:
                self.outstanding.pop(eid, None)
            return
        if msg.get("spans") and tracer.enabled:
            tracer.ingest(msg["spans"])
        if t_enq:
            e2e_s = time.monotonic() - t_enq
            histograms.get("e2e").record(e2e_s)
            if tracer.enabled:
                tracer.record("eval.e2e", e2e_s, trace_id=eid)
                flight_recorder.observe(eid, e2e_s)
        with self.out_lock:
            self.outstanding.pop(eid, None)
            self.acked += 1

    def _on_nack(self, msg: Dict) -> None:
        try:
            self.server.eval_broker.nack(msg["eval_id"], msg["token"])
        except Exception:                       # noqa: BLE001
            pass
        with self.out_lock:
            self.outstanding.pop(msg["eval_id"], None)

    def _on_hb(self, msg: Dict) -> None:
        self.last_hb = time.monotonic()
        broker = self.server.eval_broker
        for eid, token in msg["resets"]:
            try:
                broker.outstanding_reset(eid, token)
            except Exception:                   # noqa: BLE001
                pass
        renew_owner_leases(self.owner_key)
        if msg.get("stats"):
            self.child_stats = msg["stats"]
        if msg.get("spans") and tracer.enabled:
            tracer.ingest(msg["spans"])

    def _on_rpc(self, msg: Dict) -> None:
        rid, method = msg["rid"], msg["m"]
        value, ok, err = None, True, ""
        t0 = time.monotonic()
        try:
            server = self.server
            if method == "submit_plan":
                value = server.submit_plan(msg["plan"])
            elif method == "placement_turn":
                # granted here; the frame pushed below brings the
                # process's replica up to every plan committed so far
                self.sup.turn.acquire(self)
            elif method == "update_eval":
                server.update_eval(msg["eval"], token=msg["token"])
            elif method == "create_eval":
                server.create_eval(msg["eval"], token=msg["token"])
            elif method == "reblock_eval":
                server.reblock_eval(msg["eval"], token=msg["token"])
            else:
                raise ValueError(f"unknown worker rpc {method!r}")
            # push the post-commit state BEFORE the reply: the frame
            # rides the same FIFO pipe, so the worker's
            # snapshot_min_index(refresh_index) finds its replica
            # already at (or past) the index the reply references
            t1 = time.monotonic()
            self.sync_state()
            histograms.get("worker_rpc_call").record(t1 - t0)
            histograms.get("worker_rpc_sync").record(time.monotonic() - t1)
        except Exception as e:                  # noqa: BLE001
            ok, err = False, f"{type(e).__name__}: {e}"
        try:
            self.chan.send({"t": "rpc_result", "rid": rid, "ok": ok,
                            "value": value, "error": err})
        except (OSError, EOFError):
            pass


class _TurnLock:
    """The placement turn, owner side: which worker process may launch a
    wave now. Granted in request order; a holder gives it back once its
    wave's plans are in (``turn_end``), or by dying. A request that
    waits longer than ``timeout`` fails (its wave's evals fail and are
    nacked), so a grant never outlives the request's RPC."""

    def __init__(self, timeout: float = 30.0) -> None:
        self._cv = threading.Condition()
        self.holder: Optional[_WorkerHandle] = None
        self.timeout = timeout
        self.grants = 0
        self._closed = False

    def acquire(self, handle: "_WorkerHandle") -> None:
        t0 = time.monotonic()
        deadline = t0 + self.timeout
        with self._cv:
            while self.holder is not None and not self._closed:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    raise TimeoutError(
                        f"placement turn held by worker process "
                        f"{self.holder.worker_id} for {self.timeout:.0f} s")
                self._cv.wait(wait)
            if self._closed:
                raise RuntimeError("placement turn closed")
            self.holder = handle
            self.grants += 1
        histograms.get("placement_turn_wait").record(time.monotonic() - t0)

    def release(self, handle: "_WorkerHandle") -> None:
        with self._cv:
            if self.holder is handle:
                self.holder = None
                self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class WorkerProcSupervisor:
    """Leader-side service: leases eval batches to worker processes,
    tracks their liveness, recovers leases on death.

    Started on establish_leadership when ``scheduler_workers > 0``,
    stopped on revoke. The in-process Workers shrink to the core (GC)
    queue; everything else flows through here. Every process places on
    ``device`` (the server's); ``start()`` waits until each has opened
    it and raises, with every process stopped, if one could not.

    With two or more processes, their waves take turns to place
    (``turn``): a wave takes the turn before it launches, places against
    every plan committed so far, and gives it back once its plans are
    in. Without it, concurrent waves binpack onto the same nodes from
    one snapshot, and on a packed cluster an eval whose plans are all
    rejected runs out of attempts (two for a batch job) and fails. The
    processes still reconcile, check feasibility and build their
    members' inputs in parallel.
    """

    def __init__(self, server) -> None:
        self.server = server
        self.n_workers = server.config.scheduler_workers
        #: the device every worker process opens: the server's
        self.device = server.device
        self.handles: List[_WorkerHandle] = []
        self.lease_reissues = 0
        self.respawns = 0
        #: respawned processes that could not open their device (not
        #: respawned again)
        self.spawn_failures = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._rr = 0
        #: the placement turn, when several processes place
        self.turn: Optional[_TurnLock] = (
            _TurnLock() if self.n_workers > 1 else None)
        # RPC execution pool, shared across workers: submit_plan can
        # block on the serialized applier; reader threads never do.
        # Reuses the worker eval pool (daemon, kill-respawn semantics)
        from nomad_tpu_torch.server.worker import _EvalPool

        self.rpc_pool = _EvalPool(4 * max(self.n_workers, 1),
                                  "workerproc-rpc")

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._threads:
                return
            self._stop.clear()
            self.handles = [_WorkerHandle(self, i)
                            for i in range(self.n_workers)]
            for h in self.handles:
                h.spawn()
            deadline = time.monotonic() + _READY_TIMEOUT_S
            errors = []
            for h in self.handles:
                if not h.ready.wait(max(deadline - time.monotonic(), 0.0)):
                    h.device_error = (f"no device report within "
                                      f"{_READY_TIMEOUT_S:.0f} s")
                if h.device_error is not None:
                    errors.append(f"worker process {h.worker_id}: "
                                  f"{h.device_error}")
            if errors:
                handles, self.handles = self.handles, []
                for h in handles:
                    h.close(stop_msg=True)
                raise RuntimeError(
                    f"worker processes could not open device "
                    f"{self.device}: " + "; ".join(errors))
            self._threads = [
                threading.Thread(target=self._dispatch_loop, daemon=True,
                                 name="workerproc-dispatch"),
                threading.Thread(target=self._monitor_loop, daemon=True,
                                 name="workerproc-monitor"),
            ]
            for t in self._threads:
                t.start()

    def stop(self) -> None:
        with self._lock:
            if not self._threads and not self.handles:
                return
            self._stop.set()
            threads, self._threads = self._threads, []
            handles, self.handles = self.handles, []
        if self.turn is not None:
            self.turn.close()
        for t in threads:
            t.join(timeout=2.0)
        for h in handles:
            h.close(stop_msg=True)
        self.rpc_pool.shutdown()

    # -- loops -----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        cfg = self.server.config
        broker = self.server.eval_broker
        while not self._stop.is_set():
            batch = broker.dequeue_batch(
                WORKER_SCHEDULERS, cfg.worker_batch_size, timeout=0.2)
            if not batch:
                continue
            h = self._pick_worker()
            if h is None:
                # no live worker this instant (mass kill mid-respawn):
                # hand the batch straight back; the monitor respawns
                broker.enqueue_all(batch)
                self._stop.wait(0.05)
                continue
            try:
                h.lease(batch)
            except (OSError, EOFError):
                # died between liveness check and send: the lease
                # ledger already has the batch; recovery re-enqueues
                LOG.warning("workerproc %d: lease send failed",
                            h.worker_id)

    def _pick_worker(self) -> Optional[_WorkerHandle]:
        with self._lock:
            handles = list(self.handles)
        if not handles:
            return None
        for i in range(len(handles)):
            h = handles[(self._rr + i) % len(handles)]
            if h.serving():
                self._rr = (self._rr + i + 1) % len(handles)
                return h
        return None

    def _monitor_loop(self) -> None:
        while not self._stop.wait(0.05):
            now = time.monotonic()
            with self._lock:
                handles = list(self.handles)
            for h in handles:
                if not h.alive():
                    self._recover(h)
                    continue
                if now - h.last_ping >= _PING_INTERVAL_S:
                    h.last_ping = now
                    try:
                        h.chan.send({"t": "ping", "ts": now})
                    except (OSError, EOFError):
                        pass
            # TTL sweep: leases of wedged/defunct owners expire here
            expire_generation_leases()

    def _recover(self, h: _WorkerHandle) -> None:
        """A worker died: re-enqueue every eval it still held (the
        broker's ack-if-held-then-enqueue keeps tokens consistent),
        drop its generation leases, respawn — unless it died because it
        could not open its device, which a respawn would repeat."""
        if h.recovered:
            return
        h.recovered = True
        if h._reader is not None:
            # the process is gone, so its reader reaches EOF: after it,
            # a device report (or its absence) is final
            h._reader.join(timeout=2.0)
        if self.turn is not None:
            self.turn.release(h)
        with h.out_lock:
            pending = list(h.outstanding.values())
            h.outstanding.clear()
        if pending:
            try:
                self.server.eval_broker.enqueue_all(pending)
            except Exception:                   # noqa: BLE001
                LOG.warning("workerproc %d: lease re-enqueue failed",
                            h.worker_id, exc_info=True)
        with self._lock:
            self.lease_reissues += len(pending)
            if self._stop.is_set():
                h.close()
                return
            if h.device_error is not None:
                self.spawn_failures += 1
                LOG.error("worker process %d could not open device %s "
                          "(%s); not respawned", h.worker_id, self.device,
                          h.device_error)
                h.close()
                return
            self.respawns += 1
        LOG.warning("worker process %d died; re-enqueued %d leased "
                    "evals, respawning", h.worker_id, len(pending))
        h.close()
        replacement = _WorkerHandle(self, h.worker_id)
        replacement.spawn()
        with self._lock:
            try:
                self.handles[self.handles.index(h)] = replacement
            except ValueError:
                replacement.close()

    # -- introspection ---------------------------------------------------

    def probe_all(self, kind: str, timeout: float = 120.0) -> List:
        """``kind`` (see ``_WorkerHandle.probe``) from every serving
        process, in worker order."""
        with self._lock:
            handles = list(self.handles)
        return [h.probe(kind, timeout) for h in handles if h.serving()]

    def child_counters(self, timeout: float = 120.0) -> List[Dict]:
        """Every serving process's wave counters, in worker order, from a
        heartbeat each sent on request just now: the numbers
        ``stats()["children"]`` shows."""
        with self._lock:
            handles = [h for h in self.handles if h.serving()]
        for h in handles:
            h.probe("heartbeat", timeout)
        return [dict(h.child_stats) for h in handles]

    def stats(self) -> Dict:
        with self._lock:
            handles = list(self.handles)
            reissues, respawns = self.lease_reissues, self.respawns
            spawn_failures = self.spawn_failures
        children = [h.stats() for h in handles]
        return {
            "workers": len(handles),
            "alive": sum(1 for c in children if c["alive"]),
            "acked": sum(c["acked"] for c in children),
            "outstanding": sum(c["outstanding"] for c in children),
            "lease_reissues": reissues,
            "respawns": respawns,
            "spawn_failures": spawn_failures,
            "device": str(self.device),
            "turn_grants": self.turn.grants if self.turn is not None else 0,
            "children": children,
        }
