"""The Server: broker + planner + workers + heartbeats + leadership.

Reference behavior: nomad/server.go (Server struct :97-260, NewServer
:294), nomad/leader.go (establishLeadership :277-404), and the endpoint
semantics of nomad/job_endpoint.go, node_endpoint.go, eval_endpoint.go,
plan_endpoint.go. Single-process mode: ``raft_apply`` goes straight to
the FSM; the replication layer (task: control plane) swaps in a real
log without changing any caller.

Counterpart of ``nomad_tpu/server/server.py``. ``device`` (an argument
of ``Server`` or a field of ``ServerConfig``; ``None`` means the card)
is where every worker's placement waves and single-eval launches run;
with ``scheduler_workers > 0`` each worker process opens it too and
places there (server/workerproc.py). ``use_device_mesh`` splits the
placement waves' node axis over a mesh of devices (``wave_mesh``, see
``_maybe_configure_wave_mesh``). Forwarding a job to its region and
replicating ACLs from the authoritative region go through the port's
``api/client``, as in the reference.
``setup_raft`` attaches the replicated log (``raft/``) as in the
reference, with ``data_dir`` its durable WAL, stable store and
snapshots; only the leader's workers dequeue evals, so only the leader
launches placement waves on ``device``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.server.blocked_evals import BlockedEvals
from nomad_tpu_torch.server.eval_broker import FAILED_QUEUE, EvalBroker
from nomad_tpu_torch.server.fsm import NomadFSM
from nomad_tpu_torch.server.heartbeat import HeartbeatTimers
from nomad_tpu_torch.server import plan_apply as _plan_apply
from nomad_tpu_torch.server import plan_rejection as _plan_rejection
from nomad_tpu_torch.server.plan_apply import Planner
from nomad_tpu_torch.server.plan_queue import PlanQueue
from nomad_tpu_torch.server.worker import Worker
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation, Plan, PlanResult
from nomad_tpu_torch.utils.faultpoints import fault

LOG = logging.getLogger(__name__)

#: gc.freeze() must run at most once per PROCESS (see
#: Server._tune_interpreter_gc)
_GC_FROZEN = False


class ServerConfig:
    def __init__(
        self,
        num_workers: int = 2,
        worker_batch_size: int = 1,
        heartbeat_ttl: float = 10.0,
        nack_timeout: float = 60.0,
        eval_delivery_limit: int = 3,
        failed_eval_follow_up_wait: float = 60.0,
        plan_pool_workers: int = 4,
        region: str = "global",
        datacenter: str = "dc1",
        name: str = "server-1",
        authoritative_region: str = "",
        replication_token: str = "",
        replication_interval: float = 1.0,
        gc_interval: float = 60.0,
        eval_gc_threshold: float = 3600.0,
        job_gc_threshold: float = 4 * 3600.0,
        node_gc_threshold: float = 24 * 3600.0,
        deployment_gc_threshold: float = 3600.0,
        use_device_mesh: Optional[bool] = None,
        vault_addr: str = "",
        vault_token: str = "",
        vault_token_role: str = "",
        gc_tuning: bool = True,
        kernel_warmup: Optional[bool] = None,
        warmup_manifest_path: str = "",
        coalesce_window_min_ms: float = 1.0,
        coalesce_window_max_ms: float = 50.0,
        coalesce_adaptive: bool = True,
        broker_fill_window_ms: float = 5.0,
        client_update_fill_window_ms: float = 2.0,
        plan_rejection_threshold: int = 15,
        plan_rejection_window_s: float = 300.0,
        data_dir: str = "",
        raft_fsync_policy: str = "batch",
        scheduler_workers: int = 0,
        raft_max_in_flight: int = 8,
        raft_leader_lease: bool = True,
        raft_lease_fraction: float = 0.75,
        device: DeviceLike = None,
    ) -> None:
        self.num_workers = num_workers
        self.worker_batch_size = worker_batch_size
        self.heartbeat_ttl = heartbeat_ttl
        self.nack_timeout = nack_timeout
        self.eval_delivery_limit = eval_delivery_limit
        self.failed_eval_follow_up_wait = failed_eval_follow_up_wait
        self.plan_pool_workers = plan_pool_workers
        self.region = region
        self.datacenter = datacenter
        self.name = name
        self.authoritative_region = authoritative_region
        self.replication_token = replication_token
        self.replication_interval = replication_interval
        self.gc_interval = gc_interval
        self.eval_gc_threshold = eval_gc_threshold
        self.job_gc_threshold = job_gc_threshold
        self.node_gc_threshold = node_gc_threshold
        self.deployment_gc_threshold = deployment_gc_threshold
        # route placement waves over a device mesh (the node axis split
        # over several cards): True over every available device, None
        # and False never (the port's sharded wave is slower than B1)
        self.use_device_mesh = use_device_mesh
        # real Vault server (nomad/vault.go config); empty addr = the
        # in-memory dev provider
        self.vault_addr = vault_addr
        self.vault_token = vault_token
        self.vault_token_role = vault_token_role
        # interpreter-GC treatment for long-running servers (see
        # Server._tune_interpreter_gc); tests and embedders can opt out
        self.gc_tuning = gc_tuning
        # kernel warmup at start (ops/warmup.py): None warms from the
        # manifest when one exists, True always (a missing manifest is
        # zero entries), False never; the manifest defaults to the
        # port's own path
        self.kernel_warmup = kernel_warmup
        self.warmup_manifest_path = warmup_manifest_path
        # adaptive wave-coalescer window bounds (seconds derive from
        # ms knobs; parallel/coalesce.LaunchCoalescer): the rendezvous
        # fires a partial wave once a parked eval has waited
        # clamp(EWMA_wave_latency/2, min, max)
        self.coalesce_window_min_ms = coalesce_window_min_ms
        self.coalesce_window_max_ms = coalesce_window_max_ms
        self.coalesce_adaptive = coalesce_adaptive
        # broker batch-fill window: how long dequeue_batch
        # holds a partially-filled multi-eval hand-out open for the
        # producer burst; 0 disables (the unbatched behavior)
        self.broker_fill_window_ms = broker_fill_window_ms
        # heartbeat fan-in batching: how long the
        # client-update group-commit leader holds its batch open for
        # concurrent Node.UpdateAlloc arrivals before the one raft
        # apply (sliding with arrivals, hard-capped at 4 windows —
        # the broker batch-fill discipline); 0 disables the window
        # (drain-while-busy coalescing still applies)
        self.client_update_fill_window_ms = client_update_fill_window_ms
        # plan rejection tracker (server/plan_rejection.py; Nomad 1.3's
        # plan_rejection_tracker): a node whose applier rejections
        # cross the threshold inside the window is marked ineligible
        # through raft. 0 disables the marking (counting stays on).
        self.plan_rejection_threshold = plan_rejection_threshold
        self.plan_rejection_window_s = plan_rejection_window_s
        # crash-safe raft durability (raft/wal.py): a data
        # dir makes term/vote, the log, and snapshots survive a kill —
        # setup_raft recovers from it (stable store -> newest snapshot
        # -> WAL replay). Empty = in-memory raft (the seed behavior).
        # fsync policy: "always" fsyncs per journaled record;
        # "batch" (default) group-fsyncs at the ack boundaries, which
        # the batched-commit windows amortize to roughly one
        # fsync per wave.
        self.data_dir = data_dir
        self.raft_fsync_policy = raft_fsync_policy
        # multi-process scheduler workers: N worker
        # PROCESSES run the GIL-heavy scheduling host side against
        # (gen, delta)-fed MVCC replicas, leased eval batches by the
        # leader (server/workerproc.py); the consensus process keeps
        # the device mesh, plan apply, raft, and serving plane. 0 =
        # everything in-process, today's behavior, bit-identical.
        self.scheduler_workers = scheduler_workers
        # pipelined AppendEntries + leader leases (raft/node.py
        # RaftConfig): max_in_flight bounds the per-peer
        # replication window (1 = the synchronous send->ack->send
        # path, bit-identical to pre-pipeline behavior); leader_lease
        # lets leader-side linearizable reads skip the quorum barrier
        # while a quorum of AppendEntries acks landed within
        # lease_fraction of election_timeout_min. Only consulted when
        # setup_raft builds the RaftConfig itself (an explicit
        # raft_config argument wins, knobs and all).
        self.raft_max_in_flight = raft_max_in_flight
        self.raft_leader_lease = raft_leader_lease
        self.raft_lease_fraction = raft_lease_fraction
        # where placement waves and single-eval launches run: None is
        # the card (and raises without one), "cpu" the plain version
        self.device = device


class ClientUpdateStats:
    """Heartbeat fan-in accounting: how many
    Node.UpdateAlloc callers coalesced into how many raft entries, and
    the raw heartbeat rate — the serving-plane counters the fleet cell
    and ``nomad_tpu_client_update_fanin_total`` /
    ``nomad_tpu_heartbeats_total`` expose."""

    __slots__ = ("_lock", "callers", "batches", "allocs", "heartbeats")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.callers = 0
        self.batches = 0
        self.allocs = 0
        self.heartbeats = 0

    def note_caller(self, n_allocs: int) -> None:
        with self._lock:
            self.callers += 1
            self.allocs += n_allocs

    def note_batch(self) -> None:
        with self._lock:
            self.batches += 1

    def note_heartbeat(self) -> None:
        with self._lock:
            self.heartbeats += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "callers": self.callers,
                "batches": self.batches,
                "allocs": self.allocs,
                "heartbeats": self.heartbeats,
                "coalesce_ratio": round(self.callers / self.batches, 4)
                if self.batches else 0.0,
            }

    def reset_stats(self) -> None:
        with self._lock:
            self.callers = 0
            self.batches = 0
            self.allocs = 0
            self.heartbeats = 0


#: process-wide (every Server feeds it; windowed by telemetry.reset)
client_update_stats = ClientUpdateStats()


class _ClientUpdateBatch:
    """One group-committed ALLOC_CLIENT_UPDATE raft entry's future:
    concurrent client status updates (the heartbeat fan-in path) merge
    their alloc + eval lists and ride one apply."""

    def __init__(self) -> None:
        self.allocs: List = []
        self.evals: List[Evaluation] = []
        self.first_arrival = 0.0
        self._done = threading.Event()
        self._index = 0
        self._error: Optional[Exception] = None

    def resolve(self, index: int, error: Optional[Exception]) -> None:
        if self._done.is_set():
            return
        self._index, self._error = index, error
        self._done.set()

    def wait(self, timeout: float = 30.0) -> int:
        if not self._done.wait(timeout):
            raise TimeoutError("client update group commit timed out")
        if self._error is not None:
            raise self._error
        return self._index


class _EvalCommitBatch:
    """One group-committed EVAL_UPDATE raft entry's future."""

    def __init__(self) -> None:
        self.evals: List[Evaluation] = []
        self._done = threading.Event()
        self._index = 0
        self._error: Optional[Exception] = None

    def resolve(self, index: int, error: Optional[Exception]) -> None:
        # idempotent: the abnormal-unwind cleanup may re-resolve a batch
        # whose result was already delivered; first writer wins
        if self._done.is_set():
            return
        self._index, self._error = index, error
        self._done.set()

    def wait(self, timeout: float = 30.0) -> int:
        if not self._done.wait(timeout):
            raise TimeoutError("eval update group commit timed out")
        if self._error is not None:
            raise self._error
        return self._index


class Server:
    """``raft`` is optional: without it the server is a single-process
    authority (raft_apply goes straight to the FSM); with it, applies
    replicate through the log and leadership drives
    establish/revoke_leadership (leader.go:54 monitorLeadership).

    ``device`` overrides ``config.device``; the resolved device is
    ``self.device``, and every worker runs its evals' launches there."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 device: DeviceLike = None) -> None:
        self.config = config or ServerConfig()
        self.device = resolve_device(
            self.config.device if device is None else device)
        self._eval_commit_lock = threading.Lock()
        self._eval_commit_batch: Optional[_EvalCommitBatch] = None
        self._eval_commit_busy = False
        # heartbeat fan-in batcher: Node.UpdateAlloc storms
        # coalesce into one ALLOC_CLIENT_UPDATE raft entry per drain
        self._client_update_lock = threading.Lock()
        self._client_update_cond = threading.Condition(
            self._client_update_lock)
        self._client_update_batch: Optional[_ClientUpdateBatch] = None
        self._client_update_busy = False
        self.raft = None
        self.state = StateStore()
        self.eval_broker = EvalBroker(
            nack_timeout=self.config.nack_timeout,
            delivery_limit=self.config.eval_delivery_limit,
            batch_fill_window_s=self.config.broker_fill_window_ms / 1e3,
        )
        self.blocked_evals = BlockedEvals(self.eval_broker.enqueue)
        from nomad_tpu_torch.server.stream import EventBroker
        self.event_broker = EventBroker()
        self.fsm = NomadFSM(
            self.state, self.eval_broker, self.blocked_evals,
            event_broker=self.event_broker,
        )
        # consistency-mode read routing: every server —
        # leader or follower — resolves its reads through this plane
        from nomad_tpu_torch.server.readplane import ReadPlane
        self.readplane = ReadPlane(self)
        self.plan_queue = PlanQueue()
        from collections import deque

        # rolling plan-latency observations (submit -> applied result)
        self.plan_latencies = deque(maxlen=100_000)
        from nomad_tpu_torch.server.plan_rejection import plan_rejections
        plan_rejections.configure(self.config.plan_rejection_threshold,
                                  self.config.plan_rejection_window_s)
        self.planner = Planner(
            self.state, self.plan_queue, self.config.plan_pool_workers,
            raft_apply=self.raft_apply,
            on_node_rejection_threshold=self._mark_node_plan_rejected,
            validate_token=self._validate_plan_token,
        )
        self.heartbeats = HeartbeatTimers(
            self._on_heartbeat_expire, ttl=self.config.heartbeat_ttl
        )
        # with worker processes enabled, the in-process workers shrink
        # to the core (GC) queue — its schedulers mutate owner-only
        # state; every other eval type is leased out by the supervisor
        in_proc_schedulers = None
        if self.config.scheduler_workers > 0:
            in_proc_schedulers = [consts.JOB_TYPE_CORE]
        self.workers: List[Worker] = [
            Worker(self, i, schedulers=in_proc_schedulers,
                   batch_size=self.config.worker_batch_size)
            for i in range(self.config.num_workers)
        ]
        self.worker_supervisor = None
        if self.config.scheduler_workers > 0:
            from nomad_tpu_torch.server.workerproc import WorkerProcSupervisor

            self.worker_supervisor = WorkerProcSupervisor(self)
        # leader-only lifecycle subsystems (leader.go establishLeadership
        # enables: periodic dispatcher, deployment watcher, drainer)
        from nomad_tpu_torch.server.deployment_watcher import DeploymentsWatcher
        from nomad_tpu_torch.server.drainer import NodeDrainer
        from nomad_tpu_torch.server.periodic import PeriodicDispatcher
        from nomad_tpu_torch.server import core_sched
        from nomad_tpu_torch.utils.timetable import TimeTable

        from nomad_tpu_torch.server.volume_watcher import VolumesWatcher
        from nomad_tpu_torch.server.autopilot import Autopilot

        # Consul/Vault integration (nomad/vault.go, consul.go): dev
        # in-memory providers by default; real HTTP providers slot in
        # via config without touching derivation/revocation paths
        from nomad_tpu_torch.server.secrets import (
            DevConsulProvider,
            HTTPVaultProvider,
            VaultManager,
        )
        provider = None
        if self.config.vault_addr:
            provider = HTTPVaultProvider(
                self.config.vault_addr, self.config.vault_token,
                token_role=self.config.vault_token_role,
            )
        self.vault = VaultManager(provider=provider)
        self.consul = DevConsulProvider()

        self.autopilot = Autopilot(self)
        self.periodic_dispatcher = PeriodicDispatcher(self)
        self.deployments_watcher = DeploymentsWatcher(self)
        self.node_drainer = NodeDrainer(self)
        self.volumes_watcher = VolumesWatcher(self)
        # CSI plugin clients keyed by plugin id; dev/test deployments
        # register FakeCSIClient instances (plugins/csi fake)
        self.csi_clients: Dict[str, object] = {}
        self.time_table = TimeTable()
        self.fsm.periodic_dispatcher = self.periodic_dispatcher
        core_sched.install(self)

        self._leader = False
        self._ott_lock = threading.Lock()
        # secrets mid-exchange: claimed under _ott_lock so the raft
        # delete can run OUTSIDE it (graftcheck R2 — raft_apply blocks
        # on the commit barrier and may sleep-retry; holding the lock
        # through it serialized every concurrent exchange behind raft)
        self._ott_claims: set = set()
        self._shutdown = threading.Event()
        self._leader_threads: List[threading.Thread] = []
        # serializes establish/revoke (raft fires them from separate
        # threads on leadership flaps); the generation lets stale leader
        # loops from a previous term notice and exit
        self._leadership_lock = threading.Lock()
        self._leader_gen = 0
        # this server's device mesh for placement waves (None = one
        # device); per server, so co-resident servers with different
        # meshes cannot clobber each other
        self.wave_mesh = None
        # whether THIS server configured the process-wide resident
        # cluster state's mesh (released at shutdown)
        self._owns_device_state_mesh = False
        # the start-up warmup thread, and the mesh-only pass a mesh
        # adopted after it runs (both joined at shutdown)
        self._warmup_thread = None
        self._mesh_warmup_thread = None
        self._warmup_started = False
        self._warmup_lock = threading.Lock()
        self.warmup_stats = None
        self.warmup_passes: List[dict] = []

    # --- lifecycle ------------------------------------------------------

    def setup_raft(self, node_id: str, peers: List[str], transport,
                   raft_config=None) -> None:
        """Attach a replication log (server.go:1228 setupRaft). With
        ``config.data_dir`` set, the raft layer recovers its durable
        state (term/vote, snapshot, WAL) from ``<data_dir>/raft``
        before the node participates — the RaftNode constructor runs
        restore_fn into this server's state store."""
        from nomad_tpu_torch.raft.node import RaftConfig, RaftNode

        data_dir = ""
        if self.config.data_dir:
            data_dir = os.path.join(self.config.data_dir, "raft")
        if raft_config is None:
            raft_config = RaftConfig(
                max_in_flight=self.config.raft_max_in_flight,
                leader_lease=self.config.raft_leader_lease,
                lease_fraction=self.config.raft_lease_fraction,
            )
        self.raft = RaftNode(
            node_id=node_id,
            peers=peers,
            transport=transport,
            fsm_apply=self.fsm.apply,
            fsm_apply_batch=self.fsm.apply_batch,
            config=raft_config,
            snapshot_fn=self.state.to_snapshot_bytes,
            restore_fn=self.state.restore_from_bytes,
            on_leader=self.establish_leadership,
            on_follower=self.revoke_leadership,
            data_dir=data_dir or None,
            fsync_policy=self.config.raft_fsync_policy,
        )
        if data_dir:
            # the fresh event ring knows nothing before this boot:
            # everything the restored snapshot covers is trimmed
            # history, so a client resuming `?index=` below it gets an
            # explicit LostEvents marker instead of a silent gap.
            # WAL-replayed entries re-publish through the normal FSM
            # path with their original indexes (resumes above the
            # floor stay gap-free and the `index <= from_index` filter
            # keeps them duplicate-free).
            self.event_broker.note_trimmed_through(self.state.latest_index())

    def start(self) -> None:
        """Start workers; leadership comes from raft when attached,
        otherwise immediately (single-process authority)."""
        self._shutdown.clear()
        self._tune_interpreter_gc()
        self._maybe_configure_wave_mesh()
        self._maybe_start_kernel_warmup()
        self.vault.start()
        if self.raft is not None:
            # a follower's broker is disabled and returns at once, so an
            # unpaused worker spins on the interpreter lock (Nomad's
            # worker backs off, worker.go dequeueEvaluation); workers
            # wait paused until establish_leadership
            for w in self.workers:
                w.set_pause(True)
            self.raft.start()
        else:
            try:
                self.establish_leadership()
            except Exception:
                # a worker process that could not open its device: stop
                # what leadership started, then say why
                self.shutdown()
                raise
        for w in self.workers:
            w.start()

    def _tune_interpreter_gc(self) -> None:
        """Keep CPython's cyclic collector out of the scheduling hot
        path. Gen-2 passes scan every live object — O(cluster state),
        observed at 250ms+ per pause at bench alloc counts, and they
        fire at arbitrary allocation points, which made them the p99
        plan-latency tail. Standard long-running-service treatment:
        freeze boot-time objects out of the scanned set, raise the
        thresholds so young-gen passes are rare and full passes never
        fire on their own, and pay the full-collection debt explicitly
        on a dedicated maintenance thread between bursts. Refcounts
        still reclaim everything acyclic immediately; opt out with
        gc_tuning=False."""
        self._gc_tuned = False
        if not self.config.gc_tuning \
                or os.environ.get("NOMAD_TPU_GC_TUNING") == "0":
            return
        import gc

        global _GC_FROZEN
        if not _GC_FROZEN:
            # freeze only BOOT-TIME objects, once per process — calling
            # freeze() again on a restarted server would move its
            # accumulated cluster state into the permanent generation
            # and leak its cycles for the process lifetime
            gc.freeze()
            _GC_FROZEN = True
        # gen0 at 50k keeps young-object sweeps cheap and infrequent;
        # the enormous gen1/gen2 multipliers mean full passes happen in
        # the maintenance thread, not under a wave
        gc.set_threshold(50_000, 1_000, 10_000)
        self._gc_tuned = True

        # the full-collection debt is paid on EVERY server for the
        # process lifetime — leadership-gated loops would leave a
        # follower (or a deposed leader) accumulating cycles forever.
        # A generation token supersedes the previous start()'s thread
        # (checking is_alive() instead would race a stop()/start()
        # cycle into having NO maintenance thread at all).
        self._gc_gen = getattr(self, "_gc_gen", 0) + 1
        gen = self._gc_gen

        def maintain() -> None:
            while not self._shutdown.wait(self.config.gc_interval):
                if self._gc_gen != gen:
                    return               # superseded by a restart
                # prefer an idle moment (empty plan queue), but never
                # defer more than ~10s: a bounded, explicitly-placed
                # pause beats an unbounded implicit one
                for _ in range(20):
                    if self.plan_queue.stats()["depth"] == 0:
                        break
                    if self._shutdown.wait(0.5):
                        return
                gc.collect()

        threading.Thread(target=maintain, daemon=True,
                         name="interpreter-gc").start()

    #: seconds shutdown waits for the warmup thread to end its entry
    WARMUP_JOIN_S = 60.0

    def _maybe_start_kernel_warmup(self) -> None:
        """Warm the placement kernels' bucket keys recorded in the warmup
        manifest (ops/warmup.py), as observed, on a background thread,
        so the first evals find every kernel loaded: over the server's
        mesh first when it has one (the waves' route), then on its device
        (the single-eval launches). ``kernel_warmup=None`` warms whenever
        a manifest exists; True forces it (a missing manifest is then
        zero entries); False disables it. The result lands in
        ``warmup_stats`` (``warmed``, ``failed``, ``seconds``, summed
        over this pass and a later mesh pass; each pass in
        ``warmup_passes``)."""
        self._warmup_thread = None
        self._mesh_warmup_thread = None
        self.warmup_stats = None
        self.warmup_passes = []
        self._warmup_started = True
        path = self._warmup_manifest_path()
        if path is None:
            return
        from nomad_tpu_torch.ops.warmup import start_background_warmup

        self._warmup_thread = start_background_warmup(
            path, device=self.device, stop=self._shutdown,
            on_done=self._warmup_done("start"), mesh=self.wave_mesh)

    def _warmup_done(self, name: str):
        """``on_done`` of one warm pass: adds it to ``warmup_stats`` and
        lists it in ``warmup_passes``."""
        def done(warmed: int, failed: int, seconds: float) -> None:
            with self._warmup_lock:
                prior = self.warmup_stats or {
                    "warmed": 0, "failed": 0, "seconds": 0.0}
                self.warmup_stats = {
                    "warmed": prior["warmed"] + warmed,
                    "failed": prior["failed"] + failed,
                    "seconds": prior["seconds"] + seconds}
                self.warmup_passes = self.warmup_passes + [{
                    "pass": name, "warmed": warmed, "failed": failed,
                    "seconds": seconds}]
        return done

    def _maybe_start_mesh_warmup(self, mesh) -> None:
        """A mesh adopted after ``start()``: warm the manifest's entries
        over it alone (the start-up pass covered the device), on a daemon
        thread of its own, under the start-up pass's gating."""
        path = self._warmup_manifest_path()
        if path is None or self._shutdown.is_set():
            return
        from nomad_tpu_torch.ops.warmup import start_background_warmup

        prior = self._mesh_warmup_thread
        if prior is not None:
            prior.join(timeout=self.WARMUP_JOIN_S)
        self._mesh_warmup_thread = start_background_warmup(
            path, device=self.device, stop=self._shutdown,
            on_done=self._warmup_done("mesh"), mesh=mesh, mesh_only=True)

    def _warmup_manifest_path(self):
        """The manifest warmup should read, or None when warmup is
        disabled (``kernel_warmup=False``) or auto mode finds none."""
        if self.config.kernel_warmup is False:
            return None
        path = self.config.warmup_manifest_path
        if not path:
            from nomad_tpu_torch.ops import warmup

            path = warmup.DEFAULT_MANIFEST_PATH
        if self.config.kernel_warmup is None and not os.path.exists(path):
            return None
        return path

    def _maybe_persist_warmup_manifest(self) -> None:
        """Union the profiler's observed bucket keys into the warmup
        manifest, so the next start warms what this one launched. Only
        when the profiler recorded keys (it does while enabled) and a
        manifest path is configured, or warmup is forced on, which falls
        back to the default path (auto mode never writes the default
        path: test suites start many short-lived servers)."""
        if self.config.kernel_warmup is False:
            return
        path = self.config.warmup_manifest_path
        if not path:
            if self.config.kernel_warmup is not True:
                return
            from nomad_tpu_torch.ops import warmup

            path = warmup.DEFAULT_MANIFEST_PATH
        from nomad_tpu_torch.ops.warmup import (
            manifest_from_profiler,
            save_manifest,
        )

        try:
            entries = manifest_from_profiler()
            if entries:
                save_manifest(entries, path, merge=True)
        except OSError as e:
            LOG.warning("warmup manifest persist failed: %s", e)

    def _maybe_configure_wave_mesh(self) -> None:
        """Split the placement waves' node axis over a mesh of devices,
        as the JAX package does: ``use_device_mesh=True`` over
        ``parallel/mesh.available_devices`` (every card; the one CPU on
        the CPU), None over every card of a host with two or more CUDA
        cards (never on the CPU), False never. Fewer than two devices
        adopt no mesh (logged when the configuration asked for one)."""
        use = self.config.use_device_mesh
        if use is False or (use is None and self.device.type != "cuda"):
            return
        from nomad_tpu_torch.parallel.mesh import available_devices
        from nomad_tpu_torch.parallel.sharded import wave_mesh

        devs = available_devices(self.device)
        if len(devs) < 2:
            if use:
                LOG.info("use_device_mesh: %d %s device, no mesh adopted",
                         len(devs), self.device.type)
            return
        self._adopt_wave_mesh(wave_mesh(devices=devs))

    def _adopt_wave_mesh(self, mesh) -> None:
        """Make ``mesh`` this server's wave mesh: its workers' coalescers
        read ``wave_mesh`` per batch, and the process-wide resident state
        splits its generations over it unless another server's mesh is
        there first (that server keeps its residency; this one's waves
        then ship host planes). A mesh adopted after ``start()`` (a test
        or the chip smoke giving a server a virtual mesh) is warmed by a
        mesh-only pass on its own thread, as the JAX server warms the
        mesh its probe adopts: each manifest key launched once through
        the sharded kernel, so the first live wave over the mesh finds
        the library loaded, each card's plan built, peer access on and
        the allocator warm. A mesh adopted inside ``start()`` is warmed
        by the start-up pass."""
        self.wave_mesh = mesh
        LOG.info("placement waves sharded over %d devices: %s", mesh.size,
                 mesh)
        from nomad_tpu_torch.tensors.device_state import (
            default_device_state,
        )

        if (default_device_state.mesh is None
                or self._owns_device_state_mesh) \
                and not self._shutdown.is_set():
            default_device_state.configure_mesh(mesh)
            self._owns_device_state_mesh = True
        if self._warmup_started:
            self._maybe_start_mesh_warmup(mesh)

    def shutdown(self) -> None:
        self._shutdown.set()
        # the warmup threads stop between entries; joined before the
        # resident state's mesh is released, so none launches over a mesh
        # or a card the next user of the process takes over
        for t in (self._warmup_thread, self._mesh_warmup_thread):
            if t is not None:
                t.join(timeout=self.WARMUP_JOIN_S)
                if t.is_alive():
                    LOG.warning("kernel warmup still running after %.0f s",
                                self.WARMUP_JOIN_S)
        self._warmup_started = False
        if self._owns_device_state_mesh:
            # give the resident state back its one-device placement, so a
            # later server without a mesh finds its planes resident
            from nomad_tpu_torch.tensors.device_state import (
                default_device_state,
            )

            default_device_state.configure_mesh(None)
            self._owns_device_state_mesh = False
        self.wave_mesh = None
        self._maybe_persist_warmup_manifest()
        self.vault.stop()
        for w in self.workers:
            w.stop()
        if self.raft is not None:
            self.raft.shutdown()
        self.revoke_leadership()
        self.planner.close()

    def is_leader(self) -> bool:
        return self._leader

    def linearizable_read(self) -> None:
        """Gate a leader-side read so it is linearizable.

        With a valid leader lease (a quorum of AppendEntries acks
        landed within ``lease_fraction`` of the minimum election
        timeout — see raft/node.py lease clock math) the local store
        is provably current and the read proceeds immediately. When
        the lease lapsed (partition, quiet cluster with heartbeats
        failing) the read demotes to the leader barrier: a no-op entry
        committed through quorum, the pre-lease path. Deposed leaders
        fail here (NotLeaderError from the barrier) instead of serving
        stale state. No raft attached = single-process authority, the
        local store IS the state."""
        raft = self.raft
        if raft is None:
            return
        if raft.lease_valid():
            raft.note_lease_read(True)
            return
        raft.note_lease_read(False)
        raft.barrier()

    def establish_leadership(self) -> None:
        """leader.go:277 establishLeadership: enable the leader-only
        subsystems and restore broker/blocked state from the store."""
        with self._leadership_lock:
            # raft may have flapped before this callback ran
            if self.raft is not None and not self.raft.is_leader():
                return
            if self._leader:
                return
            self._leader = True
            self._leader_gen += 1
            gen = self._leader_gen
            self.plan_queue.set_enabled(True)
            self.planner.start()
            self.eval_broker.set_enabled(True)
            self.blocked_evals.set_enabled(True)
            self.heartbeats.set_enabled(True)
            self._restore_evals()
            self._init_heartbeats()
            for w in self.workers:
                w.set_pause(False)
            if self.worker_supervisor is not None:
                self.worker_supervisor.start()
            self.periodic_dispatcher.set_enabled(True)
            self.periodic_dispatcher.restore(self.state.snapshot())
            self.deployments_watcher.set_enabled(True)
            self.node_drainer.set_enabled(True)
            self.volumes_watcher.set_enabled(True)
            self.autopilot.set_enabled(True)
            loops = [
                ("reap-failed-evals", self.reap_failed_evals_once, 0.2),
                ("reap-dup-blocked", self.reap_dup_blocked_once, 0.2),
                ("timetable-witness", self._witness_time, 0.5),
                ("schedule-gc", self.schedule_core_gc, self.config.gc_interval),
            ]
            if self.config.authoritative_region and \
                    self.config.authoritative_region != self.config.region:
                loops.append(("acl-replication", self.replicate_acl_once,
                              self.config.replication_interval))
            for name, fn, interval in loops:
                t = threading.Thread(
                    target=self._leader_loop, args=(fn, interval, gen),
                    daemon=True, name=name,
                )
                self._leader_threads.append(t)
                t.start()
            if self.raft is not None:
                # consensus event: server-side leadership is live
                # (broker restored, watchers enabled) — the failover
                # timeline's `replay` phase ends here
                from nomad_tpu_torch.raft.observe import raft_observer

                raft_observer.note_event(
                    self.raft.id, "established",
                    term=self.raft.current_term,
                    detail={"state_index": self.state.latest_index()})

    def revoke_leadership(self) -> None:
        """leader.go revokeLeadership."""
        with self._leadership_lock:
            if not self._shutdown.is_set():
                if self.raft is not None and self.raft.is_leader():
                    return   # already re-elected; keep leader state
                if not self._leader and self.raft is not None:
                    return
            self._leader = False
            # stop leasing BEFORE the broker flushes: a lease issued
            # against a flushed broker would strand its tokens
            if self.worker_supervisor is not None:
                self.worker_supervisor.stop()
            self.eval_broker.set_enabled(False)
            self.blocked_evals.set_enabled(False)
            self.plan_queue.set_enabled(False)
            self.planner.stop()
            self.heartbeats.set_enabled(False)
            self.periodic_dispatcher.set_enabled(False)
            self.deployments_watcher.set_enabled(False)
            self.node_drainer.set_enabled(False)
            self.volumes_watcher.set_enabled(False)
            self.autopilot.set_enabled(False)
            for w in self.workers:
                w.set_pause(True)
            self._leader_threads.clear()
            if self.raft is not None:
                from nomad_tpu_torch.raft.observe import raft_observer

                raft_observer.note_event(
                    self.raft.id, "revoked",
                    term=self.raft.current_term)

    def _leader_loop(self, fn, interval: float, gen: int) -> None:
        from nomad_tpu_torch.telemetry.trace import tracer

        span_name = "bg." + fn.__name__
        while (
            self._leader
            and self._leader_gen == gen
            and not self._shutdown.is_set()
        ):
            try:
                with tracer.span(span_name):
                    fn()
            except Exception as e:              # noqa: BLE001
                LOG.warning("leader loop %s: %s", fn.__name__, e)
            self._shutdown.wait(interval)

    def _restore_evals(self) -> None:
        """leader.go:430 restoreEvals: re-seed broker/blocked from the
        replicated state after a leadership transition."""
        snap = self.state.snapshot()
        for ev in snap.evals_iter():
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    def _init_heartbeats(self) -> None:
        """heartbeat.go initializeHeartbeatTimers."""
        for node in self.state.snapshot().nodes():
            if node.terminal_status():
                continue
            self.heartbeats.reset(node.id)

    # --- raft boundary --------------------------------------------------

    def raft_apply(self, msg_type: str, req: Dict) -> int:
        """rpc.go:750 raftApply: replicate through the log when present
        (followers forward to the leader), else direct FSM apply."""
        if self.raft is None:
            return self.fsm.apply(msg_type, req)
        if self.raft.is_leader():
            from nomad_tpu_torch.raft.node import NotLeaderError
            try:
                return self.raft.apply(msg_type, req)
            except NotLeaderError:
                pass   # lost leadership mid-apply: route to the new one
        result = self.raft.forward_apply(msg_type, req)
        if isinstance(result, int):
            # read-your-writes: the reference forwards the WHOLE RPC so
            # follow-up reads hit leader state; here the caller reads
            # local state next, so wait for the local FSM to reach the
            # committed index before returning — and fail loudly rather
            # than hand back stale state
            deadline = time.time() + 5.0
            while self.state.latest_index() < result:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"local state lagging committed raft index "
                        f"{result} after forward")
                time.sleep(0.002)
        return result

    def snapshot_min_index(self, index: int, timeout: float = 5.0):
        """worker.go:537 SnapshotMinIndex: wait for local state to reach
        `index` then snapshot. Immediate in single-process mode."""
        deadline = time.time() + timeout
        while self.state.latest_index() < index:
            if time.time() > deadline:
                raise TimeoutError(
                    f"state index {self.state.latest_index()} < {index}"
                )
            time.sleep(0.001)
        return self.state.snapshot()

    # --- Job endpoint (nomad/job_endpoint.go) ---------------------------

    def job_register(self, job, token: str = "") -> Dict:
        """Job.Register: validate, commit, create+enqueue an eval.
        ``token`` is forwarded on multiregion fan-out registrations."""
        errs = job.validate()
        if errs:
            # job_endpoint.go Register rejects invalid jobs outright
            raise ValueError("job validation failed: " + "; ".join(errs))
        # connect admission (job_endpoint_hook_connect.go): every
        # sidecar service gets a scheduler-assigned mesh port
        _connect_admission(job)
        # multiregion fan-out (structs.go:4133; the reference's
        # multiregion register hook): a job submitted with region
        # "global" and a multiregion block becomes one per-region copy,
        # each registered in its region over the federation layer
        if job.multiregion and job.region in ("", "global"):
            return self._register_multiregion(job, token=token)
        warnings: List[str] = []
        evals = []
        if job.type != consts.JOB_TYPE_CORE and not job.is_periodic() \
                and not job.is_parameterized():
            evals.append(
                Evaluation(
                    namespace=job.namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=consts.EVAL_TRIGGER_JOB_REGISTER,
                    job_id=job.id,
                    status=consts.EVAL_STATUS_PENDING,
                )
            )
        index = self.raft_apply(
            fsm_msgs.JOB_REGISTER, {"job": job, "evals": evals}
        )
        return {
            "eval_id": evals[0].id if evals else "",
            "index": index,
            "warnings": warnings,
        }

    def _register_multiregion(self, job, token: str = "") -> Dict:
        """Fan one multiregion job out into per-region copies.

        Per-region overrides: a region stanza's ``count`` replaces the
        task groups' counts, ``datacenters`` replaces the job's. The
        local region registers directly; remote regions register over
        the federation HTTP (serf WAN analog) carrying the submitter's
        ACL token. Copies carry concrete region names so remote
        servers do not re-fan them. Region reachability is verified
        up front so a late failure can't leave a silently partial
        rollout; mid-flight HTTP failures surface the partial state in
        the error.
        """
        specs = [(str(r.get("name", "")), r)
                 for r in job.multiregion_regions() if r.get("name")]
        # pre-flight: every remote region must be reachable
        for name, _ in specs:
            if name != self.config.region and self.region_addr(name) is None:
                raise ValueError(f"multiregion: no path to region {name}")
        results: Dict = {}
        local_result: Optional[Dict] = None
        for name, region_spec in specs:
            copy = job.copy()
            copy.region = name
            count = int(region_spec.get("count", 0) or 0)
            if count > 0:
                for tg in copy.task_groups:
                    tg.count = count
            dcs = region_spec.get("datacenters") or []
            if dcs:
                copy.datacenters = list(dcs)
            try:
                if name == self.config.region:
                    local_result = self.job_register(copy, token=token)
                    results[name] = local_result
                else:
                    results[name] = self._remote_job_register(
                        self.region_addr(name), copy, name, token)
            except (ValueError, OSError) as e:
                done = sorted(results)
                raise ValueError(
                    f"multiregion register in {name} failed after "
                    f"registering in {done or 'no regions'}: {e}"
                )
        if local_result is None:
            # submitted to a server whose region isn't in the list:
            # still forward everywhere, answer with the first result
            local_result = next(iter(results.values()), {"eval_id": "",
                                                         "index": 0,
                                                         "warnings": []})
        out = dict(local_result)
        out.setdefault("eval_id", "")
        out.setdefault("index", 0)
        out.setdefault("warnings", [])
        out["regions"] = sorted(results)
        return out

    def _remote_job_register(self, addr: str, job, region: str,
                             token: str = "") -> Dict:
        """Register a per-region copy on the target region's server,
        through APIClient so the cluster's TLS config applies (same
        path ACL replication uses). Returns the server-shape result."""
        from nomad_tpu_torch.api.client import APIClient, APIError, QueryOptions
        from nomad_tpu_torch.api.codec import encode

        tls = getattr(self, "tls_api", None) or {}
        try:
            api = APIClient(addr, token=token, **tls)
            resp = api.jobs.register(encode(job),
                                     QueryOptions(region=region))
        except (APIError, OSError) as e:
            raise ValueError(f"multiregion register in {region}: {e}")
        return {
            "eval_id": resp.get("EvalID", ""),
            "index": resp.get("JobModifyIndex", 0),
            "warnings": [resp["Warnings"]] if resp.get("Warnings") else [],
        }

    def unblock_deployment(self, deployment_id: str) -> int:
        """Deployment.Unblock (the multiregion gate release): a blocked
        deployment resumes running and gets a follow-up eval."""
        snap = self.state.snapshot()
        d = snap.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment '{deployment_id}' not found")
        if d.status != consts.DEPLOYMENT_STATUS_BLOCKED:
            return self.state.latest_index()
        from nomad_tpu_torch.server.deployment_watcher import _operator_eval

        return self.raft_apply(
            fsm_msgs.DEPLOYMENT_STATUS_UPDATE,
            {
                "deployment_id": d.id,
                "status": consts.DEPLOYMENT_STATUS_RUNNING,
                "description": "Deployment unblocked",
                "evals": [_operator_eval(d)],
            },
        )

    def unblock_job_deployment(self, namespace: str, job_id: str):
        """Unblock the latest blocked deployment of a job (the target
        of a cross-region kick). Returns (index, unblocked) — callers
        retry while nothing was there to unblock (the kick can race
        the target's scheduler creating the blocked row)."""
        snap = self.state.snapshot()
        d = snap.latest_deployment_by_job_id(namespace, job_id)
        if d is None or d.status != consts.DEPLOYMENT_STATUS_BLOCKED:
            return self.state.latest_index(), False
        return self.unblock_deployment(d.id), True

    def fail_job_deployment(self, namespace: str, job_id: str,
                            description: str = "Deployment marked as failed"):
        """Fail the latest active deployment of a job: the target of a
        cross-region failure propagation (multiregion on_failure).
        Returns (index, failed)."""
        snap = self.state.snapshot()
        d = snap.latest_deployment_by_job_id(namespace, job_id)
        if d is None or not d.active():
            return self.state.latest_index(), False
        from nomad_tpu_torch.server.deployment_watcher import _operator_eval

        index = self.raft_apply(
            fsm_msgs.DEPLOYMENT_STATUS_UPDATE,
            {
                "deployment_id": d.id,
                "status": consts.DEPLOYMENT_STATUS_FAILED,
                "description": description,
                "evals": [_operator_eval(d)],
            },
        )
        return index, True

    def job_deregister(self, namespace: str, job_id: str, purge: bool = False) -> Dict:
        snap = self.state.snapshot()
        job = snap.job_by_id(namespace, job_id)
        evals = []
        if job is not None and job.type != consts.JOB_TYPE_CORE:
            evals.append(
                Evaluation(
                    namespace=namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=consts.EVAL_TRIGGER_JOB_DEREGISTER,
                    job_id=job_id,
                    status=consts.EVAL_STATUS_PENDING,
                )
            )
        index = self.raft_apply(
            fsm_msgs.JOB_DEREGISTER,
            {"namespace": namespace, "job_id": job_id, "purge": purge,
             "evals": evals},
        )
        return {"eval_id": evals[0].id if evals else "", "index": index}

    # --- Node endpoint (nomad/node_endpoint.go) -------------------------

    def node_register(self, node) -> Dict:
        snap = self.state.snapshot()
        existing = snap.node_by_id(node.id)
        index = self.raft_apply(fsm_msgs.NODE_REGISTER, {"node": node})
        ttl = self.heartbeats.reset(node.id)
        transitioned = existing is None or existing.status != node.status
        if transitioned and node.status == consts.NODE_STATUS_READY:
            self.blocked_evals.unblock(node.computed_class, index)
            self._create_node_evals(node.id, index)
        return {"heartbeat_ttl": ttl, "index": index}

    def node_update_status(self, node_id: str, status: str) -> Dict:
        """Heartbeat + status transitions (node_endpoint.go UpdateStatus).

        Lock-free single-row read off the current MVCC root: the
        steady heartbeat path (no status change) needs exactly one
        node row. (Under the seed store a full snapshot per heartbeat
        marked every table shared and forced whole-table COW copies on
        the next write — the MVCC store removed that tax, but one row
        still beats materializing a snapshot object per heartbeat at
        fleet rates, 10k+ clients.)"""
        # heartbeat delivery seam (chaos plane): an injected error is a
        # dropped heartbeat — enough of them in a row and the TTL
        # expires, driving the node-down -> allocs-lost -> reschedule
        # pipeline this endpoint normally keeps at bay
        fault("heartbeat.deliver")
        client_update_stats.note_heartbeat()
        node = self.state.node_by_id_direct(node_id)
        if node is None:
            raise KeyError(f"unknown node {node_id}")
        index = self.state.latest_index()
        if node.status != status:
            index = self.raft_apply(
                fsm_msgs.NODE_UPDATE_STATUS,
                {"node_id": node_id, "status": status},
            )
            self._create_node_evals(node_id, index)
            if status == consts.NODE_STATUS_READY:
                self.blocked_evals.unblock(node.computed_class, index)
            elif status == consts.NODE_STATUS_DOWN:
                # a down node's service instances are unreachable
                # (node_endpoint.go UpdateStatus -> service reg reaping)
                self.raft_apply(fsm_msgs.SERVICE_REG_DELETE_BY_NODE,
                                {"node_id": node_id})
        ttl = 0.0
        if status != consts.NODE_STATUS_DOWN:
            ttl = self.heartbeats.reset(node_id)
        else:
            self.heartbeats.clear(node_id)
        return {"heartbeat_ttl": ttl, "index": index}

    def node_update_drain(self, node_id: str, drain: bool, strategy=None) -> int:
        index = self.raft_apply(
            fsm_msgs.NODE_UPDATE_DRAIN,
            {"node_id": node_id, "drain": drain, "strategy": strategy},
        )
        self._create_node_evals(node_id, index, consts.EVAL_TRIGGER_NODE_DRAIN)
        return index

    def node_update_eligibility(self, node_id: str, eligibility: str) -> int:
        snap = self.state.snapshot()
        node = snap.node_by_id(node_id)
        index = self.raft_apply(
            fsm_msgs.NODE_UPDATE_ELIGIBILITY,
            {"node_id": node_id, "eligibility": eligibility},
        )
        if (
            node is not None
            and eligibility == consts.NODE_SCHEDULING_ELIGIBLE
        ):
            self.blocked_evals.unblock(node.computed_class, index)
        return index

    def node_heartbeat(self, node_id: str, status: str) -> Dict:
        return self.node_update_status(node_id, status)

    def _on_heartbeat_expire(self, node_id: str) -> None:
        """heartbeat.go invalidateHeartbeat: TTL missed => node down —
        UNLESS the node is running an alloc whose group grants a
        reconnect window (max_client_disconnect), in which case the
        node enters DISCONNECTED (node_endpoint.go disconnect
        handling): its allocs go 'unknown' and are not replaced until
        the window lapses, and a reconnecting client resumes them."""
        has_window = False
        try:
            for alloc in self.state.snapshot().allocs_by_node(node_id):
                if alloc.terminal_status() or alloc.job is None:
                    continue
                tg = alloc.job.lookup_task_group(alloc.task_group)
                if tg is not None and \
                        getattr(tg, "max_client_disconnect_s", None):
                    has_window = True
                    break
        except Exception:                       # noqa: BLE001
            pass
        status = (consts.NODE_STATUS_DISCONNECTED if has_window
                  else consts.NODE_STATUS_DOWN)
        LOG.info("heartbeat missed for node %s: marking %s",
                 node_id, status)
        try:
            index = self.raft_apply(
                fsm_msgs.NODE_UPDATE_STATUS,
                {"node_id": node_id, "status": status},
            )
            self._create_node_evals(node_id, index)
            if status == consts.NODE_STATUS_DOWN:
                self.raft_apply(fsm_msgs.SERVICE_REG_DELETE_BY_NODE,
                                {"node_id": node_id})
        except Exception as e:                  # noqa: BLE001
            LOG.warning("failed to invalidate heartbeat for %s: %s", node_id, e)

    def _create_node_evals(
        self, node_id: str, index: int, trigger: str = consts.EVAL_TRIGGER_NODE_UPDATE
    ) -> List[str]:
        """node_endpoint.go:1606 createNodeEvals: one eval per job with a
        non-terminal alloc on the node, plus every system job."""
        snap = self.state.snapshot()
        evals: List[Evaluation] = []
        seen = set()
        for alloc in snap.allocs_by_node(node_id):
            if alloc.terminal_status() or alloc.job is None:
                continue
            key = (alloc.namespace, alloc.job_id)
            if key in seen:
                continue
            seen.add(key)
            evals.append(
                Evaluation(
                    namespace=alloc.namespace,
                    priority=alloc.job.priority,
                    type=alloc.job.type,
                    triggered_by=trigger,
                    job_id=alloc.job_id,
                    node_id=node_id,
                    node_modify_index=index,
                    status=consts.EVAL_STATUS_PENDING,
                )
            )
        for job in snap.jobs():
            if job.type != consts.JOB_TYPE_SYSTEM or job.stop:
                continue
            key = (job.namespace, job.id)
            if key in seen:
                continue
            seen.add(key)
            evals.append(
                Evaluation(
                    namespace=job.namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=trigger,
                    job_id=job.id,
                    node_id=node_id,
                    node_modify_index=index,
                    status=consts.EVAL_STATUS_PENDING,
                )
            )
        if evals:
            self.raft_apply(fsm_msgs.EVAL_UPDATE, {"evals": evals})
        return [e.id for e in evals]

    def _mark_node_plan_rejected(self, node_id: str) -> None:
        """A node crossed the plan-rejection threshold (Nomad 1.3's
        BadNodeTracker): mark it ineligible through the normal raft
        path so the scheduler stops proposing onto it. Skipped when
        disabled (threshold 0) or the node is already ineligible."""
        if self.config.plan_rejection_threshold <= 0:
            return
        try:
            node = self.state.node_by_id_direct(node_id)
            if node is None or node.scheduling_eligibility == \
                    consts.NODE_SCHEDULING_INELIGIBLE:
                return
            LOG.warning(
                "node %s crossed the plan rejection threshold (%d in "
                "%.0fs): marking ineligible", node_id,
                self.config.plan_rejection_threshold,
                self.config.plan_rejection_window_s)
            self.raft_apply(
                fsm_msgs.NODE_UPDATE_ELIGIBILITY,
                {"node_id": node_id,
                 "eligibility": consts.NODE_SCHEDULING_INELIGIBLE},
            )
            _plan_rejection.plan_rejections.note_marked()
        except Exception as e:                  # noqa: BLE001
            LOG.warning("failed to mark plan-rejected node %s "
                        "ineligible: %s", node_id, e)

    def update_allocs_from_client(self, allocs: List) -> int:
        """Node.UpdateAlloc: client status batch + reschedule evals for
        failures (node_endpoint.go:1155)."""
        snap = self.state.snapshot()
        evals: List[Evaluation] = []
        seen = set()
        for a in allocs:
            existing = snap.alloc_by_id(a.id)
            if existing is None or existing.job is None:
                continue
            if a.client_status in (consts.ALLOC_CLIENT_COMPLETE,
                                   consts.ALLOC_CLIENT_FAILED,
                                   consts.ALLOC_CLIENT_LOST):
                # terminal alloc: revoke any Vault tokens derived for it
                # (vault.go RevokeTokens via the FSM alloc-update path)
                self.vault.revoke_for_alloc(a.id)
            failed = a.client_status == consts.ALLOC_CLIENT_FAILED
            # a client reporting RUNNING over a server-side UNKNOWN is a
            # reconnect: the reconciler must pick between this alloc and
            # any replacement it scheduled (node_endpoint.go UpdateAlloc
            # creates an eval for reconnected allocs)
            reconnected = (
                existing.client_status == consts.ALLOC_CLIENT_UNKNOWN
                and a.client_status == consts.ALLOC_CLIENT_RUNNING
            )
            if not failed and not reconnected:
                continue
            key = (existing.namespace, existing.job_id)
            if key in seen:
                continue
            seen.add(key)
            evals.append(
                Evaluation(
                    namespace=existing.namespace,
                    priority=existing.job.priority,
                    type=existing.job.type,
                    triggered_by=(consts.EVAL_TRIGGER_RECONNECT
                                  if reconnected else
                                  consts.EVAL_TRIGGER_RETRY_FAILED_ALLOC),
                    job_id=existing.job_id,
                    status=consts.EVAL_STATUS_PENDING,
                )
            )
        return self._client_update_group_commit(allocs, evals)

    def _client_update_group_commit(self, allocs: List,
                                    evals: List[Evaluation]) -> int:
        """Heartbeat fan-in batching: concurrent
        Node.UpdateAlloc callers merge into ONE ALLOC_CLIENT_UPDATE
        raft entry — one FSM apply, one store write txn, one event batch
        per drain instead of one per client. Same leader-drains
        discipline as ``_eval_update_group_commit``, plus a bounded
        FILL WINDOW (the broker batch-fill pattern): the
        leader holds a fresh batch open ``client_update_fill_window_ms``
        for the rest of the storm to land, sliding with arrivals under
        a hard cap of 4 windows, so a fleet's heartbeat burst commits
        as a handful of entries while a solo update pays at most one
        window."""
        client_update_stats.note_caller(len(allocs))
        window_s = self.config.client_update_fill_window_ms / 1e3
        with self._client_update_cond:
            my_batch = self._client_update_batch
            if my_batch is None:
                my_batch = self._client_update_batch = _ClientUpdateBatch()
                my_batch.first_arrival = time.monotonic()
            my_batch.allocs.extend(allocs)
            my_batch.evals.extend(evals)
            self._client_update_cond.notify_all()
            if self._client_update_busy:
                leader = False
            else:
                self._client_update_busy = True
                leader = True
        if not leader:
            return my_batch.wait()
        completed = False
        batch: Optional[_ClientUpdateBatch] = None
        try:
            while True:
                with self._client_update_cond:
                    batch = self._client_update_batch
                    if batch is None:
                        self._client_update_busy = False
                        break
                    if window_s > 0:
                        # fill window: hold the batch open for the rest
                        # of the concurrent storm; each arrival slides
                        # the window (notify above), capped at 4 windows
                        # from the first arrival so a trickle can never
                        # pin latency
                        cap = batch.first_arrival + 4 * window_s
                        last_size = -1
                        while time.monotonic() < cap:
                            if len(batch.allocs) == last_size:
                                break       # window elapsed, no arrival
                            last_size = len(batch.allocs)
                            self._client_update_cond.wait(
                                min(window_s,
                                    cap - time.monotonic()))
                    self._client_update_batch = None
                try:
                    client_update_stats.note_batch()
                    # fan-in flush seam (chaos plane): error fails the
                    # whole batch (every caller sees it); kind="kill"
                    # kills the drain leader mid-flush and exercises
                    # the abnormal-unwind discipline in the finally
                    fault("server.client_update.raft")
                    batch.resolve(self.raft_apply(
                        fsm_msgs.ALLOC_CLIENT_UPDATE,
                        {"allocs": batch.allocs, "evals": batch.evals},
                    ), None)
                except Exception as e:               # noqa: BLE001
                    batch.resolve(0, e)
            completed = True
        finally:
            if not completed:
                # abnormal unwind (BaseException inside raft_apply):
                # fail the popped batch and any batch queued behind the
                # dead leader, then reset — same discipline as the eval
                # group commit
                err = RuntimeError("client update group-commit leader "
                                   "aborted")
                if batch is not None:
                    batch.resolve(0, err)
                with self._client_update_cond:
                    self._client_update_busy = False
                    orphan = self._client_update_batch
                    self._client_update_batch = None
                if orphan is not None and orphan is not batch:
                    orphan.resolve(0, err)
        return my_batch.wait()

    def derive_vault_tokens(self, alloc_id: str,
                            task_names: List[str]) -> Dict[str, str]:
        """Node.DeriveVaultToken (node_endpoint.go DeriveVaultToken):
        validate the alloc exists and each named task has a vault
        block, then mint one token per task."""
        snap = self.state.snapshot()
        alloc = snap.alloc_by_id(alloc_id)
        if alloc is None or alloc.job is None:
            raise KeyError(f"allocation {alloc_id} not found")
        if alloc.terminal_status():
            # a lagging client asking for a dead alloc's tokens would
            # mint accessors nothing ever revokes (the terminal update
            # already ran); reject like node_endpoint.go does
            raise ValueError(
                f"allocation {alloc_id} is terminal; refusing to "
                "derive Vault tokens")
        tg = alloc.job.lookup_task_group(alloc.task_group)
        asks: Dict[str, List[str]] = {}
        for name in task_names:
            task = next((t for t in tg.tasks if t.name == name), None) \
                if tg is not None else None
            if task is None or task.vault is None:
                raise ValueError(
                    f"task {name} does not request a Vault token")
            asks[name] = task.vault.policies
        infos = self.vault.derive_tokens(alloc_id, asks)
        return {name: info.token for name, info in infos.items()}

    def get_client_allocs(self, node_id: str, min_index: int = 0,
                          timeout: float = 0.0) -> Dict:
        """Node.GetClientAllocs: the client's blocking query for its
        assigned allocations (node_endpoint.go GetClientAllocs;
        client.go:2063 watchAllocations).

        Linearizable: lease-gated (fast path) or barrier-demoted, so a
        client polling a just-deposed leader never sees a stale
        assignment set presented as current."""
        self.linearizable_read()
        index = self.state.block_until(["allocs"], min_index, timeout)
        snap = self.state.snapshot()
        allocs = snap.allocs_by_node(node_id)
        return {
            "index": index,
            "allocs": allocs,
        }

    # --- Eval endpoint (worker-facing; nomad/eval_endpoint.go) ----------

    def update_eval(self, ev: Evaluation, token: str = "") -> int:
        return self._eval_update_group_commit(ev)

    def create_eval(self, ev: Evaluation, token: str = "") -> int:
        return self._eval_update_group_commit(ev)

    def _eval_update_group_commit(self, ev: Evaluation) -> int:
        """Group-commit EVAL_UPDATE: a wave of batched workers finishes
        ~wave-size evals nearly at once; one raft entry per drain
        instead of one per eval (the deploymentwatcher-batcher idea,
        deployments_watcher.go:36, but latency-free — whatever arrives
        while the previous apply is in flight rides the next entry).

        The first arriver becomes the committer and drains successive
        batches until none are pending; everyone else waits on their
        batch's future."""
        with self._eval_commit_lock:
            my_batch = self._eval_commit_batch
            if my_batch is None:
                my_batch = self._eval_commit_batch = _EvalCommitBatch()
            my_batch.evals.append(ev)
            if self._eval_commit_busy:
                leader = False
            else:
                self._eval_commit_busy = True
                leader = True
        if not leader:
            return my_batch.wait()
        # try/finally covers BaseException too (KeyboardInterrupt /
        # SystemExit inside raft_apply): a committer dying abnormally
        # must never leave busy=True with no drainer — that would wedge
        # every later create/update_eval behind a batch nobody commits
        completed = False
        batch: Optional[_EvalCommitBatch] = None
        try:
            while True:
                with self._eval_commit_lock:
                    batch = self._eval_commit_batch
                    self._eval_commit_batch = None
                    if batch is None:
                        # normal handoff: clear busy atomically with the
                        # empty check so the next arriver becomes leader
                        self._eval_commit_busy = False
                        break
                try:
                    # group-commit raft seam (chaos plane): same
                    # semantics as the client-update seam above — the
                    # kill schedule finally exercises the abnormal
                    # unwind below for real
                    fault("server.eval_commit.raft")
                    batch.resolve(self.raft_apply(
                        fsm_msgs.EVAL_UPDATE, {"evals": batch.evals}), None)
                except Exception as e:               # noqa: BLE001
                    batch.resolve(0, e)
            completed = True
        finally:
            if not completed:
                # abnormal unwind (BaseException past the except above —
                # KeyboardInterrupt/SystemExit inside raft_apply): busy
                # is still True and no new leader can arise. Fail BOTH
                # the popped in-flight batch (its waiters would
                # otherwise hit the blind 30s TimeoutError) and any
                # batch queued behind the dead committer, then reset.
                err = RuntimeError("eval group-commit leader aborted")
                if batch is not None:
                    batch.resolve(0, err)
                with self._eval_commit_lock:
                    self._eval_commit_busy = False
                    orphan = self._eval_commit_batch
                    self._eval_commit_batch = None
                if orphan is not None and orphan is not batch:
                    orphan.resolve(0, err)
        return my_batch.wait()

    def reblock_eval(self, ev: Evaluation, token: str = "") -> int:
        """Eval.Reblock: the worker re-blocks an eval it still holds."""
        outstanding = self.eval_broker.outstanding(ev.id)
        if outstanding is None:
            raise ValueError(f"evaluation {ev.id} is not outstanding")
        if token and outstanding != token:
            raise ValueError(f"token mismatch for evaluation {ev.id}")
        return self.raft_apply(fsm_msgs.EVAL_UPDATE, {"evals": [ev]})

    # --- Plan endpoint (nomad/plan_endpoint.go) -------------------------

    def _validate_plan_token(self, plan: Plan) -> Optional[str]:
        """plan_endpoint.go Submit: a plan is valid only while its
        worker still HOLDS the eval lease. A plan landing after the
        broker re-enqueued the eval (worker-process death, auto-nack
        deadline) would commit placements a redelivered twin is about
        to make again from a pre-commit snapshot — duplicate live
        slots. Token-less plans (tests, core GC) skip the check."""
        if not plan.eval_token:
            return None
        held = self.eval_broker.outstanding(plan.eval_id)
        if held != plan.eval_token:
            return (f"plan for evaluation {plan.eval_id} rejected: "
                    f"stale eval token (lease re-enqueued)")
        return None

    def submit_plan(self, plan: Plan) -> PlanResult:
        import time as _time

        from nomad_tpu_torch.telemetry.trace import tracer

        err = self._validate_plan_token(plan)
        if err:
            raise ValueError(err)
        # safety net for planners that didn't drain the deferred
        # post-processing in their own (overlapped) window; idempotent
        plan.run_deferred()
        t0 = _time.perf_counter()
        # plan.wait overlaps the applier's own evaluate/commit spans
        # (the worker blocks while the applier thread works); the trace
        # decomposition attributes the applier side and reports this
        # wait as overlapped
        with tracer.span("plan.wait", trace_id=plan.eval_id):
            if self.planner.running():
                pending = self.plan_queue.enqueue(plan)
                result = pending.wait(timeout=30.0)
            else:
                # synchronous mode (tests without the applier thread)
                result = self.planner.apply_one(plan)
        # plan latency observability (BASELINE.md p50/p99 plan latency)
        self.plan_latencies.append(_time.perf_counter() - t0)
        return result

    # --- federation (serf WAN + rpc.go:537 region forwarding) -----------

    def join_region(self, region: str, http_addr: str) -> None:
        """Record a federated region's entry point (serf WAN join);
        replicated through raft so failover keeps forwarding working."""
        if region != self.config.region:
            self.raft_apply(fsm_msgs.REGION_UPSERT,
                            {"region": region, "http_addr": http_addr})

    def known_regions(self) -> List[str]:
        """region_endpoint.go List: own region + WAN-known regions."""
        return sorted({self.config.region, *self.state.regions()})

    def region_addr(self, region: str) -> Optional[str]:
        return self.state.regions().get(region)

    def replicate_acl_once(self) -> int:
        """leader.go:1347 replicateACLPolicies/Tokens: non-authoritative
        regions diff against the authoritative region -- upserting what
        changed and deleting what the authority no longer has (a revoked
        global token must die everywhere). Returns applied change count."""
        auth = self.config.authoritative_region
        if not auth or auth == self.config.region:
            return 0
        addr = self.region_addr(auth)
        if addr is None:
            return 0
        from nomad_tpu_torch.api.client import APIClient
        from nomad_tpu_torch.acl.policy import ACLPolicy, ACLToken

        # tls_api is set by the agent when the cluster runs TLS so
        # replication trusts the cluster CA / presents this agent's cert
        tls = getattr(self, "tls_api", None) or {}
        api = APIClient(addr, token=self.config.replication_token, **tls)
        n = 0

        # policies: upsert changed, delete stale
        remote_names = set()
        upserts = []
        for stub in api.acl.policies():
            full = api.acl.policy(stub["Name"])
            name = full.get("Name", "")
            remote_names.add(name)
            local = self.state.acl_policy_by_name(name)
            if local is not None \
                    and local.rules == full.get("Rules", "") \
                    and local.description == full.get("Description", ""):
                continue
            upserts.append(ACLPolicy(
                name=name,
                description=full.get("Description", ""),
                rules=full.get("Rules", ""),
            ))
        if upserts:
            self.raft_apply(fsm_msgs.ACL_POLICY_UPSERT,
                            {"policies": upserts})
            n += len(upserts)
        stale = [p.name for p in self.state.acl_policies()
                 if p.name not in remote_names]
        if stale:
            self.raft_apply(fsm_msgs.ACL_POLICY_DELETE, {"names": stale})
            n += len(stale)

        # global tokens follow the authoritative region; local tokens
        # never replicate (leader.go replicateACLTokens)
        remote_accessors = set()
        tok_upserts = []
        for stub in api.acl.tokens():
            # the list stub carries Global: skip local tokens without a
            # per-token fetch (they never replicate)
            if not stub.get("Global", False):
                continue
            full = api.acl.token(stub["AccessorID"])
            accessor = full.get("AccessorID", "")
            remote_accessors.add(accessor)
            local = self.state.acl_token_by_accessor(accessor)
            if local is not None \
                    and local.secret_id == full.get("SecretID", "") \
                    and local.policies == (full.get("Policies") or []) \
                    and local.type == full.get("Type", "client"):
                continue
            tok_upserts.append(ACLToken(
                accessor_id=accessor,
                secret_id=full.get("SecretID", ""),
                name=full.get("Name", ""),
                type=full.get("Type", "client"),
                policies=full.get("Policies") or [],
                global_=True,
            ))
        if tok_upserts:
            self.raft_apply(fsm_msgs.ACL_TOKEN_UPSERT,
                            {"tokens": tok_upserts})
            n += len(tok_upserts)
        stale_toks = [t.accessor_id for t in self.state.acl_tokens()
                      if t.global_ and t.accessor_id not in remote_accessors]
        if stale_toks:
            self.raft_apply(fsm_msgs.ACL_TOKEN_DELETE,
                            {"accessor_ids": stale_toks})
            n += len(stale_toks)
        return n

    # --- one-time tokens (acl_endpoint.go UpsertOneTimeToken/Exchange) --

    def create_one_time_token(self, accessor_id: str,
                              ttl_s: float = 600.0) -> Dict:
        """Mint a one-time token for an ACL token holder (used by `nomad
        ui -authenticate`; acl_endpoint.go UpsertOneTimeToken)."""
        import uuid as _uuid

        ott = {
            "one_time_secret_id": str(_uuid.uuid4()),
            "accessor_id": accessor_id,
            "expires_at": time.time() + ttl_s,
        }
        self.raft_apply(fsm_msgs.ONE_TIME_TOKEN_UPSERT, {"token": ott})
        return ott

    def exchange_one_time_token(self, secret: str):
        """Exchange a one-time secret for the underlying ACL token
        (acl_endpoint.go ExchangeOneTimeToken); single use. The lock
        makes check-then-delete atomic against concurrent exchanges on
        this server (the HTTP agent is threaded)."""
        with self._ott_lock:
            if secret in self._ott_claims:
                # a concurrent exchange already claimed it: single use
                raise ValueError("one-time token expired or not found")
            ott = self.state.one_time_token_by_secret(secret)
            if ott is None or ott["expires_at"] <= time.time():
                raise ValueError("one-time token expired or not found")
            token = self.state.acl_token_by_accessor(ott["accessor_id"])
            self._ott_claims.add(secret)
        # the raft delete runs off the lock; the claim set keeps
        # check-then-delete atomic against concurrent exchanges until
        # the commit lands (after which the store row is gone)
        try:
            self.raft_apply(fsm_msgs.ONE_TIME_TOKEN_DELETE,
                            {"secrets": [secret]})
        finally:
            with self._ott_lock:
                self._ott_claims.discard(secret)
        if token is None:
            raise ValueError("one-time token's ACL token no longer exists")
        return token

    def expire_one_time_tokens(self, force: bool = False) -> int:
        now = time.time() + (10**9 if force else 0)
        expired = self.state.expire_one_time_tokens(now)
        if expired:
            self.raft_apply(fsm_msgs.ONE_TIME_TOKEN_EXPIRE, {"now": now})
        return len(expired)

    # --- service registrations (service_registration_endpoint.go) ------

    def mesh_identity_token(self, namespace: str, service: str,
                            alloc_id: str = "") -> str:
        """Mesh identity credential for a Connect service pair
        (consul.go DeriveSITokens analog; see DevConsulProvider).

        When ``alloc_id`` is given (every client RPC passes it), the
        derivation is scoped the way the reference scopes SI tokens to
        the requesting alloc's services (consul.go DeriveSITokens):
        ``service`` must be declared by the alloc's job — as one of its
        own connect services or as a sidecar upstream destination —
        otherwise any workload could mint any destination's identity
        and the token gate would only exclude external traffic."""
        if alloc_id:
            snap = self.state.snapshot()
            alloc = snap.alloc_by_id(alloc_id)
            if alloc is None:
                raise PermissionError(
                    f"mesh identity: unknown alloc {alloc_id}")
            # check the alloc's PLACEMENT-TIME job (alloc.job): after a
            # job update removes a connect stanza, still-running
            # old-version allocs remain entitled to the services their
            # own version declared
            job = alloc.job or snap.job_by_id(alloc.namespace, alloc.job_id)
            if (job is None or alloc.namespace != namespace
                    or not self._job_declares_mesh_service(job, service)):
                raise PermissionError(
                    f"mesh identity: alloc {alloc_id[:8]}'s job does not "
                    f"declare connect service or upstream '{service}'")
        return self.consul.mesh_identity_token(namespace, service)

    @staticmethod
    def _job_declares_mesh_service(job, service: str) -> bool:
        for tg in job.task_groups:
            for svc in list(getattr(tg, "services", [])) + [
                    s for t in getattr(tg, "tasks", [])
                    for s in getattr(t, "services", [])]:
                if not svc.connect:
                    continue
                if svc.name == service:
                    return True
                for up in svc.upstreams():
                    if str(up.get("destination_name", "")) == service:
                        return True
        return False

    def services_by_name(self, namespace: str, name: str) -> List[Dict]:
        """ServiceRegistration.GetService: live instances by name (the
        connect upstream resolver's discovery query)."""
        return [r.stub() for r in
                self.state.service_registrations_by_name(namespace, name)]

    def service_register(self, regs: List) -> int:
        """ServiceRegistration.Upsert: clients report their running
        service instances."""
        for r in regs:
            r.validate()
        return self.raft_apply(fsm_msgs.SERVICE_REG_UPSERT,
                               {"services": regs})

    def service_deregister(self, reg_id: str) -> int:
        return self.raft_apply(fsm_msgs.SERVICE_REG_DELETE_BY_ID,
                               {"id": reg_id})

    def service_deregister_by_alloc(self, alloc_ids: List[str]) -> int:
        return self.raft_apply(fsm_msgs.SERVICE_REG_DELETE_BY_ALLOC,
                               {"alloc_ids": alloc_ids})

    # --- CSI (nomad/csi_endpoint.go + plugins/csi) ----------------------

    def csi_volume_register(self, volumes: List) -> int:
        """CSIVolume.Register: validate capabilities against the
        controller plugin (csi_endpoint.go Register) then commit."""
        for v in volumes:
            v.validate()
            client = self.csi_clients.get(v.plugin_id)
            if client is not None and v.external_id:
                client.controller_validate_capabilities(
                    v.external_id,
                    [c.__dict__ for c in v.requested_capabilities],
                )
        return self.raft_apply(fsm_msgs.CSI_VOLUME_REGISTER,
                               {"volumes": volumes})

    def csi_volume_deregister(self, namespace: str, volume_id: str,
                              force: bool = False) -> int:
        return self.raft_apply(fsm_msgs.CSI_VOLUME_DEREGISTER, {
            "namespace": namespace, "volume_id": volume_id, "force": force,
        })

    def csi_volume_claim(self, namespace: str, volume_id: str, claim) -> int:
        """CSIVolume.Claim: controller-publish (if required) then record
        the claim (csi_endpoint.go Claim -> controllerPublishVolume)."""
        from nomad_tpu_torch.structs import csi as csi_structs

        vol = self.state.csi_volume_by_id(namespace, volume_id)
        if vol is None:
            raise ValueError(f"volume not found: {volume_id}")
        if claim.mode != csi_structs.CLAIM_RELEASE \
                and not vol.claimable(claim.mode):
            raise ValueError(
                f"volume {volume_id} unschedulable or max claims reached"
            )
        client = self.csi_clients.get(vol.plugin_id)
        plugin = self.csi_plugin_by_id(vol.plugin_id)
        if (claim.mode != csi_structs.CLAIM_RELEASE and client is not None
                and plugin is not None and plugin.controller_required):
            client.controller_publish_volume(
                vol.external_id, claim.external_node_id or claim.node_id,
                claim.mode == csi_structs.CLAIM_READ,
                {"access_mode": claim.access_mode,
                 "attachment_mode": claim.attachment_mode},
            )
        return self.raft_apply(fsm_msgs.CSI_VOLUME_CLAIM, {
            "namespace": namespace, "volume_id": volume_id, "claim": claim,
        })

    def csi_volume_create(self, volumes: List) -> List:
        """CSIVolume.Create: ask the controller plugin to provision the
        external volume, then register (csi_endpoint.go Create)."""
        created = []
        for v in volumes:
            v.validate()
            client = self.csi_clients.get(v.plugin_id)
            if client is not None:
                resp = client.controller_create_volume(
                    v.name or v.id, v.capacity_min, v.capacity_max,
                    [c.__dict__ for c in v.requested_capabilities],
                    v.parameters,
                )
                v.external_id = resp.get("external_id", v.external_id)
            created.append(v)
        self.raft_apply(fsm_msgs.CSI_VOLUME_REGISTER, {"volumes": created})
        return created

    def csi_volume_delete(self, namespace: str, volume_id: str) -> int:
        """CSIVolume.Delete: delete the external volume then deregister."""
        vol = self.state.csi_volume_by_id(namespace, volume_id)
        if vol is None:
            raise ValueError(f"volume not found: {volume_id}")
        client = self.csi_clients.get(vol.plugin_id)
        if client is not None and vol.external_id:
            client.controller_delete_volume(vol.external_id)
        return self.csi_volume_deregister(namespace, volume_id)

    def csi_plugin_by_id(self, plugin_id: str):
        from nomad_tpu_torch.structs.csi import plugins_from_nodes

        return plugins_from_nodes(self.state.snapshot().nodes()).get(plugin_id)

    def csi_plugins(self) -> Dict:
        from nomad_tpu_torch.structs.csi import plugins_from_nodes

        return plugins_from_nodes(self.state.snapshot().nodes())

    def csi_node_unpublish(self, vol, claim) -> None:
        """volumewatcher step 1: unpublish on the claiming node (the
        reference RPCs the client, which calls the node plugin). The
        claim carries the paths the node actually published at."""
        client = self.csi_clients.get(vol.plugin_id)
        if client is not None and claim.target_path:
            client.node_unpublish_volume(vol.external_id, claim.target_path)

    def csi_controller_unpublish(self, vol, claim) -> None:
        client = self.csi_clients.get(vol.plugin_id)
        if client is not None:
            client.controller_unpublish_volume(
                vol.external_id, claim.external_node_id or claim.node_id
            )

    # --- core scheduler hook (GC; nomad/core_sched.go) ------------------

    def new_core_scheduler(self, snapshot, planner):
        if self._core_scheduler_factory is None:
            raise ValueError("core scheduler not installed")
        return self._core_scheduler_factory(snapshot, planner, self)

    # --- leader reaping loops (leader.go:759, :795) ---------------------

    def reap_failed_evals_once(self) -> int:
        """Dequeue from the _failed queue, mark failed, create a delayed
        follow-up eval (leader.go reapFailedEvaluations)."""
        n = 0
        while True:
            ev, token = self.eval_broker.dequeue([FAILED_QUEUE], timeout=0)
            if ev is None:
                return n
            updated = ev.copy()
            updated.status = consts.EVAL_STATUS_FAILED
            updated.status_description = (
                f"evaluation reached delivery limit "
                f"({self.config.eval_delivery_limit})"
            )
            follow_up = updated.create_failed_follow_up_eval(
                self.config.failed_eval_follow_up_wait
            )
            self.raft_apply(
                fsm_msgs.EVAL_UPDATE, {"evals": [updated, follow_up]}
            )
            self.eval_broker.ack(ev.id, token)
            n += 1

    def _witness_time(self) -> None:
        self.time_table.witness(self.state.latest_index())

    def schedule_core_gc(self) -> None:
        """leader.go schedulePeriodic: enqueue the _core GC evals."""
        from nomad_tpu_torch.server import core_sched
        for core_job in core_sched.ALL_CORE_JOBS:
            self.eval_broker.enqueue(core_sched.new_core_eval(core_job))

    def force_gc(self) -> None:
        """`nomad system gc` (system_endpoint.go): run every collector
        ignoring thresholds."""
        from nomad_tpu_torch.server import core_sched
        sched = core_sched.CoreScheduler(self.state.snapshot(), None, self)
        sched.eval_gc(force=True)
        sched.job_gc(force=True)
        sched.node_gc(force=True)
        sched.deployment_gc(force=True)
        sched.csi_volume_claim_gc(force=True)
        sched.one_time_token_gc(force=True)

    def reap_dup_blocked_once(self) -> int:
        """Cancel duplicate blocked evals (leader.go
        reapDupBlockedEvaluations)."""
        dups = self.blocked_evals.get_duplicates(timeout=0.0)
        if not dups:
            return 0
        updated = []
        for ev in dups:
            new = ev.copy()
            new.status = consts.EVAL_STATUS_CANCELLED
            new.status_description = "existing blocked evaluation exists for this job"
            updated.append(new)
        self.raft_apply(fsm_msgs.EVAL_UPDATE, {"evals": updated})
        return len(updated)

    # --- introspection --------------------------------------------------

    def stats(self) -> Dict:
        from nomad_tpu_torch.scheduler import stack as _stack

        return {
            "leader": self._leader,
            "broker": self.eval_broker.stats(),
            "blocked": self.blocked_evals.stats(),
            "plan_queue": self.plan_queue.stats(),
            # applier health: full vs partial commits and where plan
            # latency goes (queue wait / evaluate / raft commit)
            "plan_apply": {
                "plans_full": self.planner.plans_full,
                "plans_partial": self.planner.plans_partial,
                "stage_seconds": {
                    k: round(v, 4)
                    for k, v in self.planner.stage_s.items()
                },
            },
            # group commit: vector-proven vs exact-fallback plan
            # re-validation + batched raft entry shape
            "plan_group": _plan_apply.plan_group_stats.snapshot(),
            # plan rejection tracker (Nomad 1.3): per-node rejection
            # pressure + eligibility flips it drove
            "plan_rejection": _plan_rejection.plan_rejections.snapshot(),
            # exact host-side assignment disagreed with the kernel and
            # forced a masked re-run (should stay near zero)
            "assign_retry_launches":
                _stack.STATS["assign_retry_launches"],
            "heartbeats": self.heartbeats.count(),
            "workers": len(self.workers),
            # multi-process scheduler workers: lease ledger
            # + liveness of the worker-process fleet, when enabled
            "worker_procs": self.worker_supervisor.stats()
            if self.worker_supervisor is not None else None,
            "state_index": self.state.latest_index(),
        }


def _connect_admission(job) -> None:
    """Inject scheduler-visible mesh plumbing for Connect services
    (job_endpoint_hook_connect.go groupConnectHook):

    - every group service with a sidecar gets a dynamic port labeled
      ``connect-proxy-<service>`` on the group's bridge network, so
      the NetworkIndex assigns the sidecar's public mesh port like any
      other port;
    - a sidecar requires a bridge-mode group network (reference
      validation: Connect requires network mode "bridge").
    """
    from nomad_tpu_torch.structs.network import Port

    for tg in job.task_groups:
        sidecars = [s for s in (tg.services or []) if s.has_sidecar()]
        if not sidecars:
            continue
        bridge = None
        for net in tg.networks:
            if getattr(net, "mode", "host") == "bridge":
                bridge = net
                break
        if bridge is None:
            raise ValueError(
                f"group {tg.name}: Consul Connect sidecars require a "
                "bridge-mode group network")
        for svc in sidecars:
            label = svc.mesh_port_label()
            have = any(
                p.label == label
                for p in list(bridge.dynamic_ports)
                + list(bridge.reserved_ports))
            if not have:
                bridge.dynamic_ports.append(Port(label=label))
