"""The MVCC state store: generation-stamped immutable roots, lock-free
snapshots, single-writer transactions, watches, plan application.

Reference behavior: nomad/state/state_store.go (6,611 LoC) -- the subset
that the scheduler, brokers, and API depend on. Tables mirror
schema.go:50-72: nodes, jobs, job_version, evals, allocs, deployments,
index, scheduler_config (plus more added as subsystems land).

Concurrency model (go-memdb parity, PAPER.md layer 2): every table is a
persistent structural-sharing map (state/pmap.py); the whole store
state lives in ONE immutable :class:`StoreRoot` stamped with a
monotonically-increasing generation id. Writes run inside a
single-writer transaction (``_txn``) that accumulates per-table
overlays and commits by building a NEW root (one bulk path-copy per
touched table) and swapping the store's root pointer — atomic under
CPython's attribute-store semantics. Readers never lock anything:
``snapshot()`` is one attribute read, a snapshot is frozen forever,
and a writer never waits for (or invalidates) a reader. The seed
store's copy-on-write table marking (the old COW flag machinery), its
whole-table copies on the write after a snapshot, and the reader/writer
convoy on ``_lock`` are all gone.

Watches fire per-table on commit, giving blocking queries the same
index+watch contract as memdb WatchSets (state_store.go blocking-query
support, rpc.go:808). Because the root (with its per-table commit
indexes) is published BEFORE callbacks fire, a woken waiter always
observes the index that triggered the notify — the seed's
registration-race spurious wakeups cannot happen.

Roots are registered by generation in a process-wide weak registry:
``snapshot_at(generation)`` rehydrates any still-live generation, the
runway for handing snapshots to other worker processes by id alone
(ROADMAP open item 1). Dropping every reference to a snapshot releases
exactly its private subtrees (structural sharing; property-tested in
tests/test_mvcc_store.py).
"""

from __future__ import annotations

import itertools
import pickle
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from nomad_tpu_torch.state.pmap import EMPTY, PMap, TOMBSTONE, pmap_diff
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import Allocation
from nomad_tpu_torch.structs.eval_plan import Deployment, Evaluation, Plan, PlanResult
from nomad_tpu_torch.utils.witness import witness_lock


class SchedulerConfiguration:
    """Runtime-mutable scheduler config (reference structs.go
    SchedulerConfiguration; stored in raft, schema.go:65)."""

    def __init__(self) -> None:
        self.scheduler_algorithm = consts.SCHEDULER_ALGORITHM_BINPACK
        self.preemption_system_enabled = True
        self.preemption_batch_enabled = False
        self.preemption_service_enabled = False
        self.memory_oversubscription_enabled = False
        self.pause_eval_broker = False

    def effective_algorithm(self) -> str:
        return self.scheduler_algorithm

    def preemption_enabled(self, scheduler_type: str) -> bool:
        return {
            consts.JOB_TYPE_SERVICE: self.preemption_service_enabled,
            consts.JOB_TYPE_BATCH: self.preemption_batch_enabled,
            consts.JOB_TYPE_SYSTEM: self.preemption_system_enabled,
            consts.JOB_TYPE_SYSBATCH: self.preemption_system_enabled,
        }.get(scheduler_type, False)


class WatchStats:
    """Blocking-query wakeup accounting: how many watchers
    ``block_until`` currently holds parked, how often they wake for a
    real index advance vs spuriously (a shared Event set without the
    watched tables' index actually advancing past the waiter's floor),
    and how many waits expire. The serving plane is mostly reads and
    watches — without these counters a fleet-scale watch storm is
    invisible in every exposition surface."""

    __slots__ = ("_lock", "held", "wakeups", "spurious", "timeouts")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.held = 0
        self.wakeups = 0
        self.spurious = 0
        self.timeouts = 0

    def enter(self) -> None:
        with self._lock:
            self.held += 1

    def leave(self) -> None:
        with self._lock:
            self.held -= 1

    def note_wakeup(self, spurious: bool) -> None:
        with self._lock:
            if spurious:
                self.spurious += 1
            else:
                self.wakeups += 1

    def note_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "held_watchers": self.held,
                "wakeups": self.wakeups,
                "spurious_wakeups": self.spurious,
                "timeouts": self.timeouts,
            }

    def reset_stats(self) -> None:
        """Counters only; the held gauge tracks live waiters."""
        with self._lock:
            self.wakeups = 0
            self.spurious = 0
            self.timeouts = 0


#: process-wide (every StateStore's block_until feeds it; exported as
#: nomad_tpu_watch_* and ridden into TRACE_DECOMP's serving section)
watch_stats = WatchStats()


class StoreStats:
    """MVCC plumbing counters, exported as ``nomad_tpu_store_*``.

    Deliberately lock-free: the snapshot counter is bumped on the
    read path, which this subsystem promises never blocks — a plain
    ``+=`` under the GIL can drop the odd increment under thread races,
    which is acceptable for a monotone monitoring counter and nothing
    else reads it for correctness. Write-side counters are bumped under
    the write lock and are exact."""

    __slots__ = ("write_txns", "snapshots", "restores", "last_generation")

    def __init__(self) -> None:
        self.write_txns = 0
        self.snapshots = 0
        self.restores = 0
        self.last_generation = 0

    def note_write(self, generation: int) -> None:
        self.write_txns += 1
        self.last_generation = generation

    def note_restore(self, generation: int) -> None:
        self.restores += 1
        self.last_generation = generation

    def note_snapshot(self) -> None:
        self.snapshots += 1

    def snapshot(self) -> Dict:
        leased = leased_generation_count()
        total = len(_ROOT_REGISTRY)
        return {
            "write_txns": self.write_txns,
            "snapshots": self.snapshots,
            "restores": self.restores,
            "last_generation": self.last_generation,
            "live_roots": total,
            # split: roots alive only because a worker
            # process leased them vs roots some in-process reader
            # still holds. A root can be both; the split attributes
            # it to the lease (the lease is what would retain it if
            # every in-process reader dropped).
            "live_roots_leased": leased,
            "live_roots_in_process": max(total - leased, 0),
        }

    def reset_stats(self) -> None:
        """Rate counters only; the generation high-water mark is
        identity, not a rate, and survives the window reset."""
        self.write_txns = 0
        self.snapshots = 0
        self.restores = 0


#: process-wide (multiple stores feed it; bench cells window it like
#: the other *_stats singletons via telemetry.reset_window_stats)
store_stats = StoreStats()

#: process-wide generation ids: unique across every store in the
#: process so a generation id alone names a root in the registry
#: (the cross-process-worker runway wants ids that never collide)
_GENERATIONS = itertools.count(1)

#: generation -> StoreRoot, weak on the root: a generation stays
#: rehydratable exactly as long as SOMETHING still references its root
#: (the store's current pointer, a live StateSnapshot, a pinned
#: serialization). Dropping the last reference releases the root and
#: every subtree not shared with a newer generation.
_ROOT_REGISTRY: "weakref.WeakValueDictionary[int, StoreRoot]" = \
    weakref.WeakValueDictionary()


def snapshot_at(generation: int) -> Optional["StateSnapshot"]:
    """Rehydrate a snapshot from a still-live generation id; None if
    that generation's root has been released."""
    root = _ROOT_REGISTRY.get(generation)
    if root is None:
        return None
    return StateSnapshot(root)


# --- cross-process generation leases ------------------------------------
#
# The weak registry frees a root the moment no IN-PROCESS reader holds
# it — but a worker process reading a snapshot it reconstructed from a
# ``(gen, delta)`` frame holds nothing in the owner's process, so the
# owner could release the very root the next delta must diff against.
# A lease is an explicit STRONG pin, keyed by (owner, generation), with
# a liveness-bounded TTL: the supervisor renews its workers' leases on
# their heartbeats and releases them on advance or death; a wedged
# supervisor's pins expire rather than retaining roots forever.

#: default lease TTL — several heartbeat intervals of slack
LEASE_TTL_S = 30.0

_lease_lock = threading.Lock()
#: (owner, generation) -> [root strong ref, expires_at (monotonic)]
_GENERATION_LEASES: Dict[Tuple[str, int], List] = {}


def _expire_leases_locked(now: float) -> int:
    doomed = [k for k, (_root, exp) in _GENERATION_LEASES.items()
              if exp <= now]
    for k in doomed:
        del _GENERATION_LEASES[k]
    return len(doomed)


def lease_generation(generation: int, owner: str,
                     ttl_s: float = LEASE_TTL_S) -> bool:
    """Pin ``generation``'s root for ``owner`` (a worker-process id);
    False when the root is already gone. Renewing an existing lease
    just extends its expiry."""
    now = time.monotonic()
    root = _ROOT_REGISTRY.get(generation)
    with _lease_lock:
        _expire_leases_locked(now)
        if root is None:
            return False
        _GENERATION_LEASES[(owner, generation)] = [root, now + ttl_s]
    return True


def release_generation_lease(generation: int, owner: str) -> bool:
    with _lease_lock:
        return _GENERATION_LEASES.pop((owner, generation), None) is not None


def release_owner_leases(owner: str) -> int:
    """Drop every lease held by ``owner`` (worker death / shutdown)."""
    with _lease_lock:
        doomed = [k for k in _GENERATION_LEASES if k[0] == owner]
        for k in doomed:
            del _GENERATION_LEASES[k]
    return len(doomed)


def renew_owner_leases(owner: str, ttl_s: float = LEASE_TTL_S) -> int:
    """Heartbeat-driven renewal: extend every lease ``owner`` holds."""
    now = time.monotonic()
    with _lease_lock:
        _expire_leases_locked(now)
        n = 0
        for (o, _gen), row in _GENERATION_LEASES.items():
            if o == owner:
                row[1] = now + ttl_s
                n += 1
    return n


def expire_generation_leases() -> int:
    """Drop expired leases (the supervisor's liveness sweep calls this;
    every lease call expires lazily too). Returns the drop count."""
    with _lease_lock:
        return _expire_leases_locked(time.monotonic())


def leased_generation_count() -> int:
    """Distinct generations currently pinned by a live lease."""
    now = time.monotonic()
    with _lease_lock:
        _expire_leases_locked(now)
        return len({gen for (_o, gen) in _GENERATION_LEASES})


# --- snapshot transport frames ------------------------------------------
#
# The wire shapes for feeding worker-process replicas: one ``bootstrap``
# frame at attach (the only full-state ship), then ``(gen, delta)``
# frames — per-table overlays computed by pmap_diff's identity-pruned
# walk, O(changes) not O(store). Frames adopt the OWNER's generation
# ids, so a worker-side snapshot names the same state the owner's
# registry does, and the replica's usage planes are advanced by
# replaying the same transitions the owner's write paths took — the
# `usage_rebuild_diff` bit-identity invariant holds on both sides.


def bootstrap_frame(store: "StateStore", pin_owner: Optional[str] = None,
                    ttl_s: float = LEASE_TTL_S) -> Dict:
    """Full-state frame off ONE root, lock-free (the to_snapshot_bytes
    discipline). With ``pin_owner`` the target generation is leased
    while the root is still strongly held here — no window where a
    commit storm could release it before the pin lands."""
    root = store._root
    frame = {
        "kind": "bootstrap",
        "generation": root.generation,
        "index": root.index,
        "tables": {name: root.tables[name].to_dict()
                   for name in _TABLE_NAMES},
        "table_indexes": dict(root.table_indexes),
        "scheduler_config": root.scheduler_config,
        "autopilot_config": dict(root.autopilot_config),
        "draining_nodes": root.draining_nodes,
    }
    if pin_owner is not None:
        lease_generation(root.generation, pin_owner, ttl_s)
    return frame


def delta_frame(store: "StateStore", from_generation: int,
                pin_owner: Optional[str] = None,
                ttl_s: float = LEASE_TTL_S) -> Optional[Dict]:
    """The ``(gen, delta)`` frame turning ``from_generation``'s root
    into the store's current root; None when the base root is gone
    (caller falls back to a bootstrap frame) or nothing changed.
    Never re-pickles the whole store: per-table overlays come from
    pmap_diff, and unchanged config/draining fields ship as None."""
    new_root = store._root
    if new_root.generation == from_generation:
        return None
    old_root = _ROOT_REGISTRY.get(from_generation)
    if old_root is None:
        return None
    tables: Dict[str, Dict] = {}
    for name in _TABLE_NAMES:
        ot, nt = old_root.tables[name], new_root.tables[name]
        if ot is nt:
            continue
        changes = pmap_diff(ot, nt)
        if not changes:
            continue
        # TOMBSTONE is an unpicklable-by-identity sentinel: encode
        # deletes as a key list instead
        sets = {k: v for k, v in changes.items() if v is not TOMBSTONE}
        dels = [k for k, v in changes.items() if v is TOMBSTONE]
        tables[name] = {"set": sets, "del": dels}
    frame = {
        "kind": "delta",
        "from_generation": from_generation,
        "generation": new_root.generation,
        "index": new_root.index,
        "tables": tables,
        "table_indexes": (dict(new_root.table_indexes)
                          if new_root.table_indexes
                          is not old_root.table_indexes else None),
        "scheduler_config": (new_root.scheduler_config
                             if new_root.scheduler_config
                             is not old_root.scheduler_config else None),
        "autopilot_config": (dict(new_root.autopilot_config)
                             if new_root.autopilot_config
                             is not old_root.autopilot_config else None),
        "draining_nodes": (new_root.draining_nodes
                           if new_root.draining_nodes
                           is not old_root.draining_nodes else None),
    }
    if pin_owner is not None:
        lease_generation(new_root.generation, pin_owner, ttl_s)
    return frame


def apply_frame(store: "StateStore", frame: Dict) -> None:
    """Apply a transport frame to a REPLICA store (a worker process's
    follower copy). Adopts the owner's generation id — the replica's
    snapshot at gen G is the owner's state at gen G — and replays
    node/alloc transitions through the replica's UsageIndex exactly as
    the owner's write paths did, so ``usage_rebuild_diff`` stays empty
    on the replica. Delta frames must apply in order: a frame whose
    base is not the replica's current generation raises (the transport
    serializes frames per connection, so this only fires on a protocol
    bug). Replica roots are NOT registered in the process-wide
    generation registry: the replica is a follower view, not a root
    provider."""
    kind = frame.get("kind")
    if kind == "bootstrap":
        tables = {name: PMap.from_dict(frame["tables"][name])
                  for name in _TABLE_NAMES}
        with store._write_lock:
            store.usage.rebuild(frame["tables"]["nodes"].values(),
                                frame["tables"]["allocs"].values())
            root = StoreRoot(
                generation=frame["generation"],
                index=frame["index"],
                tables=tables,
                table_indexes=dict(frame["table_indexes"]),
                usage=store.usage.planes_copy(),
                scheduler_config=frame["scheduler_config"],
                autopilot_config=dict(frame["autopilot_config"]),
                draining_nodes=frame["draining_nodes"],
            )
            store._root = root
        return
    if kind != "delta":
        raise ValueError(f"unknown frame kind {kind!r}")
    with store._write_lock:
        base = store._root
        if frame["from_generation"] != base.generation:
            raise ValueError(
                f"out-of-order delta frame: base gen "
                f"{frame['from_generation']} != replica gen "
                f"{base.generation}")
        tables = dict(base.tables)
        allocs_before = base.tables["allocs"]
        for name in _TABLE_NAMES:
            chg = frame["tables"].get(name)
            if chg is None:
                continue
            overlay = dict(chg["set"])
            for k in chg["del"]:
                overlay[k] = TOMBSTONE
            if name == "nodes":
                # same transitions the owner's node write paths took
                # (delete before upsert: a recycled node id must land
                # in a fresh row, not inherit the old one's planes)
                for nid in chg["del"]:
                    store.usage.drop_node(nid)
                for nid in chg["set"]:
                    store.usage.node_row(nid)
                    store.usage.note_node_change(nid)
            elif name == "allocs":
                for aid in chg["del"]:
                    old_a = allocs_before.get(aid)
                    if old_a is not None:
                        store.usage.alloc_changed(old_a, None)
                for aid, new_a in chg["set"].items():
                    store.usage.alloc_changed(
                        allocs_before.get(aid), new_a)
            tables[name] = tables[name].update_with(overlay)
        root = StoreRoot(
            generation=frame["generation"],
            index=frame["index"],
            tables=tables,
            table_indexes=(dict(frame["table_indexes"])
                           if frame["table_indexes"] is not None
                           else base.table_indexes),
            usage=store.usage.planes_copy(),
            scheduler_config=(frame["scheduler_config"]
                              if frame["scheduler_config"] is not None
                              else base.scheduler_config),
            autopilot_config=(dict(frame["autopilot_config"])
                              if frame["autopilot_config"] is not None
                              else base.autopilot_config),
            draining_nodes=(frame["draining_nodes"]
                            if frame["draining_nodes"] is not None
                            else base.draining_nodes),
        )
        store._root = root


#: every table in a root, in payload order. Index tables (allocs_by_*)
#: hold immutable frozenset values; scaling_events holds tuples — row
#: values are never mutated in place anywhere, only replaced.
_TABLE_NAMES = (
    "nodes", "jobs", "job_versions", "evals", "allocs", "deployments",
    "allocs_by_job", "allocs_by_node", "allocs_by_eval", "csi_volumes",
    "namespaces", "scaling_events", "acl_policies", "acl_tokens",
    "services", "one_time_tokens", "periodic_launches", "regions",
)

#: tables whose watchers fire on restore (restored ACLs must bump
#: their table indexes, or the token resolver's index-keyed
#: compiled-ACL cache keeps serving pre-restore policies)
_RESTORE_NOTIFY = (
    "nodes", "jobs", "evals", "allocs", "deployment",
    "scheduler_config", "csi_volumes", "services",
    "acl_policy", "acl_token",
)


class StoreRoot:
    """One immutable point-in-time state of the whole store.

    Everything a reader can observe hangs off the root: the PMap
    tables, the per-watch-key commit indexes, the frozen usage planes,
    the config objects, and the derived draining-node set. A root is
    never mutated after publication; a commit builds a new one. The
    ``__weakref__`` slot is what lets the generation registry hold
    roots without pinning them."""

    __slots__ = ("generation", "index", "tables", "table_indexes",
                 "usage", "scheduler_config", "autopilot_config",
                 "draining_nodes", "__weakref__")

    def __init__(self, generation: int, index: int,
                 tables: Dict[str, PMap], table_indexes: Dict[str, int],
                 usage, scheduler_config, autopilot_config: Dict,
                 draining_nodes: frozenset) -> None:
        self.generation = generation
        self.index = index
        self.tables = tables
        self.table_indexes = table_indexes
        self.usage = usage
        self.scheduler_config = scheduler_config
        self.autopilot_config = autopilot_config
        self.draining_nodes = draining_nodes


class _WriteTxn:
    """Single-writer transaction: per-table ``{key: row-or-TOMBSTONE}``
    overlays over a base root. Reads through the txn see the overlay
    first (a txn observes its own writes, like memdb's write txn);
    commit folds each overlay into its table with one bulk path-copy
    (``PMap.update_with``) and swaps the root.

    Inside a :meth:`StateStore.batch_txn` scope the txn carries the
    enclosing ``parent`` accumulator: reads fall through its own
    overlay to the batch's (earlier entries in the same batch are
    visible, exactly as if each had committed), and a clean exit folds
    into the accumulator instead of swapping the root."""

    __slots__ = ("base", "parent", "index", "overlays", "notify",
                 "scheduler_config", "autopilot_config", "aborted")

    def __init__(self, base: StoreRoot, parent=None) -> None:
        self.base = base
        self.parent = parent
        self.index = (parent.index if parent is not None
                      else base.index) + 1
        self.overlays: Dict[str, Dict] = {}
        self.notify: List[str] = []
        self.scheduler_config = None
        self.autopilot_config: Optional[Dict] = None
        self.aborted = False

    def get(self, table: str, key, default=None):
        ov = self.overlays.get(table)
        if ov is not None and key in ov:
            val = ov[key]
            return default if val is TOMBSTONE else val
        if self.parent is not None:
            return self.parent.get(table, key, default)
        return self.base.tables[table].get(key, default)

    def set(self, table: str, key, value) -> None:
        self.overlays.setdefault(table, {})[key] = value

    def delete(self, table: str, key) -> None:
        self.overlays.setdefault(table, {})[key] = TOMBSTONE

    def items(self, table: str) -> Iterator[Tuple]:
        ov = self.overlays.get(table)
        pov = (self.parent.overlays.get(table)
               if self.parent is not None else None)
        if not ov and not pov:
            yield from self.base.tables[table].items()
            return
        merged = dict(pov) if pov else {}
        if ov:
            merged.update(ov)
        for k, v in self.base.tables[table].items():
            if k not in merged:
                yield k, v
        for k, v in merged.items():
            if v is not TOMBSTONE:
                yield k, v

    def values(self, table: str) -> Iterator:
        for _k, v in self.items(table):
            yield v

    def abort(self) -> None:
        """Commit nothing: no index bump, no generation, no notify
        (the seed's early-return-current-index write paths)."""
        self.aborted = True


class _BatchTxn:
    """Accumulator behind :meth:`StateStore.batch_txn`: N inner write
    txns fold into ONE root swap. The batched raft apply loop
    runs a whole committed range through this — one write-lock
    span, one ``update_with`` fold per touched table, one generation,
    one watcher notify at the batch's newest index.

    Per-table ``notify_indexes`` keep each table's commit index EXACT
    (the index of the last inner txn that touched it) — a blocking
    query's fast path keys on table indexes, and rounding them all up
    to the batch index would wake/pass waiters whose table never
    changed (the busy-loop hazard ``block_until`` is built to avoid).

    ``owner`` is the batching thread's ident: only that thread (the
    raft apply loop running FSM handlers) reads through the pending
    overlays via the ``*_direct`` accessors — every other reader keeps
    MVCC isolation on the last published root."""

    __slots__ = ("base", "owner", "overlays", "notify",
                 "notify_indexes", "scheduler_config",
                 "autopilot_config", "txn_count")

    def __init__(self, base: StoreRoot) -> None:
        self.base = base
        self.owner = threading.get_ident()
        self.overlays: Dict[str, Dict] = {}
        self.notify: Set[str] = set()
        self.notify_indexes: Dict[str, int] = {}
        self.scheduler_config = None
        self.autopilot_config: Optional[Dict] = None
        self.txn_count = 0

    @property
    def index(self) -> int:
        return self.base.index + self.txn_count

    def get(self, table: str, key, default=None):
        ov = self.overlays.get(table)
        if ov is not None and key in ov:
            val = ov[key]
            return default if val is TOMBSTONE else val
        return self.base.tables[table].get(key, default)

    def fold(self, txn: "_WriteTxn") -> None:
        """Absorb a clean inner txn (called under the write lock)."""
        self.txn_count += 1
        for name, overlay in txn.overlays.items():
            self.overlays.setdefault(name, {}).update(overlay)
        for t in txn.notify:
            self.notify.add(t)
            self.notify_indexes[t] = txn.index
        if txn.scheduler_config is not None:
            self.scheduler_config = txn.scheduler_config
        if txn.autopilot_config is not None:
            self.autopilot_config = txn.autopilot_config


class StateSnapshot:
    """A point-in-time read view (memdb Snapshot analog).

    Implements the scheduler's ``State`` interface
    (reference scheduler/scheduler.go:67-141).

    Construction is O(1) and LOCK-FREE: it wraps one immutable
    :class:`StoreRoot` — no table copies, no COW marking, no writer
    coordination of any kind. The snapshot is frozen at its generation
    forever; later writes build new roots and cannot reach it.
    """

    def __init__(self, root) -> None:
        if isinstance(root, StateStore):    # back-compat construction
            root = root._root
        self._root = root
        self.generation = root.generation
        self.index = root.index
        tables = root.tables
        self._nodes = tables["nodes"]
        self._jobs = tables["jobs"]
        self._job_versions = tables["job_versions"]
        self._evals = tables["evals"]
        self._allocs = tables["allocs"]
        self._deployments = tables["deployments"]
        self._allocs_by_job = tables["allocs_by_job"]
        self._allocs_by_node = tables["allocs_by_node"]
        self._allocs_by_eval = tables["allocs_by_eval"]
        self._csi_volumes = tables["csi_volumes"]
        self.scheduler_config = root.scheduler_config
        # frozen utilization planes for the scheduler fast path
        # (state/usage.py), captured at this generation's commit —
        # consistent with the tables by construction
        self.usage = root.usage

    def stamp(self) -> Dict[str, int]:
        """The read plane's provenance stamp: which frozen root this
        view serves (generation-stamped reads)."""
        return {"generation": self.generation, "index": self.index}

    # --- State interface (scheduler.go:67-141) ---

    def nodes(self) -> List:
        return list(self._nodes.values())

    def node_by_id(self, node_id: str):
        return self._nodes.get(node_id)

    def ready_nodes_in_pool(self, pool: str = "default") -> List:
        return [n for n in self._nodes.values() if n.ready()]

    def job_by_id(self, namespace: str, job_id: str):
        return self._jobs.get((namespace, job_id))

    def job_by_id_and_version(self, namespace: str, job_id: str, version: int):
        return self._job_versions.get((namespace, job_id, version))

    def jobs(self) -> List:
        return list(self._jobs.values())

    def eval_by_id(self, eval_id: str):
        return self._evals.get(eval_id)

    def evals_iter(self):
        return self._evals.values()

    def evals_by_job(self, namespace: str, job_id: str) -> List[Evaluation]:
        return [
            e for e in self._evals.values()
            if e.namespace == namespace and e.job_id == job_id
        ]

    def allocs_by_job(self, namespace: str, job_id: str, anyCreateIndex: bool = True) -> List[Allocation]:
        ids = self._allocs_by_job.get((namespace, job_id), ())
        return [self._allocs[i] for i in ids]

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        ids = self._allocs_by_node.get(node_id, ())
        return [self._allocs[i] for i in ids]

    def allocs_by_node_terminal(self, node_id: str, terminal: bool) -> List[Allocation]:
        return [a for a in self.allocs_by_node(node_id) if a.terminal_status() == terminal]

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        ids = self._allocs_by_eval.get(eval_id, ())
        return [self._allocs[i] for i in ids]

    def alloc_by_id(self, alloc_id: str):
        return self._allocs.get(alloc_id)

    def allocs_iter(self):
        return self._allocs.values()

    def latest_deployment_by_job_id(self, namespace: str, job_id: str):
        best = None
        for d in self._deployments.values():
            if d.namespace == namespace and d.job_id == job_id:
                if best is None or d.create_index > best.create_index:
                    best = d
        return best

    def deployments_by_job_id(self, namespace: str, job_id: str) -> List[Deployment]:
        return [
            d for d in self._deployments.values()
            if d.namespace == namespace and d.job_id == job_id
        ]

    def deployment_by_id(self, deployment_id: str):
        return self._deployments.get(deployment_id)

    def deployments_iter(self):
        return self._deployments.values()

    def csi_volume_by_id(self, namespace: str, volume_id: str):
        return self._csi_volumes.get((namespace, volume_id))

    def csi_volumes_iter(self):
        return self._csi_volumes.values()

    def latest_index(self) -> int:
        return self.index


class StateStore:
    """The writable store. One per server; FSM applies Raft entries here."""

    def __init__(self) -> None:
        from nomad_tpu_torch.state.usage import UsageIndex

        # the ONLY lock on the data path, held by writers for the span
        # of one transaction. Readers never touch it: every read
        # accessor below starts from one atomic `self._root` load.
        self._write_lock = witness_lock("store_write_txn", rlock=True)
        # watcher registration only (never nested with the write lock
        # held in either direction on the commit path: callbacks are
        # collected under it and fired outside both locks)
        self._watch_lock = witness_lock("store_watch")
        # incrementally-scattered per-node utilization planes; every
        # alloc/node mutation routes its transition through it UNDER
        # THE WRITE LOCK, and each commit freezes planes_copy() (cached
        # — free when the txn didn't touch usage) into the new root
        self.usage = UsageIndex()
        # table name -> [callback(index)]; fired outside all locks
        self._watchers: Dict[str, List[Callable[[int], None]]] = {}
        # active batch accumulator (batch_txn scope); guarded by the
        # write RLock — only the owning thread ever sees a non-None
        # value from inside a _txn it opened
        self._batch: Optional[_BatchTxn] = None
        root = StoreRoot(
            generation=next(_GENERATIONS),
            index=0,
            tables={name: EMPTY for name in _TABLE_NAMES},
            table_indexes={},
            usage=self.usage.planes_copy(),
            scheduler_config=SchedulerConfiguration(),
            # autopilot config (schema.go autopilot-config)
            autopilot_config={
                "cleanup_dead_servers": True,
                "last_contact_threshold_s": 10.0,
                "server_stabilization_time_s": 10.0,
            },
            draining_nodes=frozenset(),
        )
        _ROOT_REGISTRY[root.generation] = root
        self._root = root

    # --- infrastructure ---

    def snapshot(self) -> StateSnapshot:
        """O(1), lock-free: one root-pointer read."""
        store_stats.note_snapshot()
        return StateSnapshot(self._root)

    def current_generation(self) -> int:
        return self._root.generation

    def snapshot_at(self, generation: int) -> Optional[StateSnapshot]:
        """Rehydrate a still-live generation by id (module-level
        ``snapshot_at`` reaches across stores; this is the same
        registry)."""
        return snapshot_at(generation)

    def latest_index(self) -> int:
        return self._root.index

    def read_stamp(self) -> Tuple[int, int]:
        """``(generation, index)`` from ONE atomic root load — the
        generation-stamped read the read plane serves against.
        Reading ``current_generation()`` and
        ``latest_index()`` separately can straddle a root swap; this
        cannot."""
        root = self._root
        return root.generation, root.index

    @property
    def scheduler_config(self) -> SchedulerConfiguration:
        """The current root's scheduler config. The OBJECT is shared
        across generations until ``set_scheduler_config`` replaces it
        (reference semantics: operator flags take effect immediately,
        they are config, not versioned state)."""
        return self._root.scheduler_config

    @property
    def autopilot_config(self) -> Dict:
        return self._root.autopilot_config

    def watch(self, table: str, cb: Callable[[int], None]) -> Callable[[], None]:
        """Register a commit callback for a table; returns unwatch fn."""
        with self._watch_lock:
            self._watchers.setdefault(table, []).append(cb)

        def unwatch() -> None:
            with self._watch_lock:
                lst = self._watchers.get(table, [])
                if cb in lst:
                    lst.remove(cb)

        return unwatch

    def _fire(self, tables: List[str], index: int) -> None:
        """Run watch callbacks for a committed txn — OUTSIDE both
        locks, and strictly AFTER the new root (with its advanced
        table_indexes) is published, so a woken waiter's index read
        always sees the commit that woke it."""
        cbs: List[Callable[[int], None]] = []
        with self._watch_lock:
            for t in tables:
                cbs.extend(self._watchers.get(t, ()))
        for cb in cbs:
            cb(index)

    def table_index(self, tables: List[str]) -> int:
        """Highest commit index across the given tables (lock-free)."""
        ti = self._root.table_indexes
        return max((ti.get(t, 0) for t in tables), default=0)

    @contextmanager
    def _txn(self):
        """Single-writer transaction scope. The body stages writes on
        the txn; a normal exit commits (new root, generation bump,
        watcher notify); an exception or ``txn.abort()`` commits
        nothing. graftcheck R4's txn-scope rule keys on this being the
        only mutation doorway.

        Inside an enclosing :meth:`batch_txn` (same thread — the write
        RLock makes the nesting reentrant) a clean exit folds into the
        batch accumulator instead: no root swap, no notify — those
        happen once when the batch closes."""
        self._write_lock.acquire()
        batch = self._batch
        if batch is not None and batch.owner == threading.get_ident():
            try:
                txn = _WriteTxn(self._root, parent=batch)
                yield txn
                if not txn.aborted:
                    batch.fold(txn)
            finally:
                self._write_lock.release()
            return
        t0 = time.perf_counter()
        try:
            txn = _WriteTxn(self._root)
            yield txn
            if not txn.aborted:
                self._commit(txn)
        finally:
            self._write_lock.release()
        if not txn.aborted:
            _record_write_txn(time.perf_counter() - t0)
            if txn.notify:
                self._fire(txn.notify, txn.index)

    @contextmanager
    def batch_txn(self):
        """Batch N write transactions into ONE root swap + ONE watcher
        notify (the batched raft apply loop's doorway). Every ``_txn``
        opened by this thread inside the scope folds into the batch;
        the scope exit publishes one root at the batch's newest index
        and fires each touched table's watchers once, carrying that
        table's own newest index. An empty batch (every inner txn
        aborted, or none opened) publishes nothing."""
        self._write_lock.acquire()
        if self._batch is not None:
            # nested batches collapse into the outer one
            self._write_lock.release()
            yield
            return
        t0 = time.perf_counter()
        batch = _BatchTxn(self._root)
        self._batch = batch
        try:
            yield
            if batch.txn_count:
                self._commit_batch(batch)
        finally:
            self._batch = None
            self._write_lock.release()
        if batch.txn_count:
            _record_write_txn(time.perf_counter() - t0)
            if batch.notify:
                self._fire(sorted(batch.notify), batch.index)

    def _commit(self, txn: _WriteTxn) -> None:
        """Fold one txn's overlays into a new root and publish it.
        Caller holds the write lock."""
        self._publish_root(
            txn.base, txn.overlays,
            {t: txn.index for t in txn.notify}, txn.index,
            txn.scheduler_config, txn.autopilot_config)

    def _commit_batch(self, batch: _BatchTxn) -> None:
        """Fold the whole accumulator into ONE new root. Caller holds
        the write lock."""
        self._publish_root(
            batch.base, batch.overlays, batch.notify_indexes,
            batch.index, batch.scheduler_config, batch.autopilot_config)

    def _publish_root(self, base: StoreRoot, overlays: Dict[str, Dict],
                      notify_indexes: Dict[str, int], index: int,
                      scheduler_config, autopilot_config) -> None:
        """Fold overlays into new tables (one bulk path-copy each),
        build the next root, publish it. Caller holds the write lock;
        the publication itself is one attribute store. Shared by the
        single-txn and batch commit paths — per-table indexes advance
        to each table's OWN newest index (== the txn index on the
        single path), never past it."""
        tables = base.tables
        if overlays:
            tables = dict(tables)
            for name, overlay in overlays.items():
                tables[name] = tables[name].update_with(overlay)
        if notify_indexes:
            table_indexes = dict(base.table_indexes)
            for t, t_idx in notify_indexes.items():
                if table_indexes.get(t, 0) < t_idx:
                    table_indexes[t] = t_idx
        else:
            table_indexes = base.table_indexes
        nodes_overlay = overlays.get("nodes")
        if nodes_overlay:
            draining = set(base.draining_nodes)
            for nid, node in nodes_overlay.items():
                if node is TOMBSTONE or not getattr(node, "drain", False):
                    draining.discard(nid)
                else:
                    draining.add(nid)
            draining = frozenset(draining)
        else:
            draining = base.draining_nodes
        generation = next(_GENERATIONS)
        root = StoreRoot(
            generation=generation,
            index=index,
            tables=tables,
            table_indexes=table_indexes,
            usage=self.usage.planes_copy(),
            scheduler_config=(scheduler_config
                              or base.scheduler_config),
            autopilot_config=(autopilot_config
                              if autopilot_config is not None
                              else base.autopilot_config),
            draining_nodes=draining,
        )
        _ROOT_REGISTRY[generation] = root
        self._root = root
        store_stats.note_write(generation)

    def has_draining_nodes(self) -> bool:
        """O(1) lock-free pre-check for the drainer: the root carries
        the draining-node id set, maintained incrementally at commit."""
        return bool(self._root.draining_nodes)

    def csi_volume_count(self) -> int:
        """O(1) lock-free pre-check for the volume watcher."""
        return len(self._root.tables["csi_volumes"])

    def node_by_id_direct(self, node_id: str):
        """Lock-free read of one node row at the current generation.
        Kept (with its *_direct name) as the blessed single-row
        accessor graftcheck R4 points callers at; rows are replaced,
        never mutated, so handing one out is safe. The batch-owning
        thread reads through the pending batch overlay (its earlier
        entries must be visible to later handlers, exactly as if each
        had committed); everyone else sees the published root."""
        batch = self._batch
        if batch is not None and batch.owner == threading.get_ident():
            return batch.get("nodes", node_id)
        return self._root.tables["nodes"].get(node_id)

    def alloc_by_id_direct(self, alloc_id: str):
        """Lock-free read of one alloc row at the current generation
        (batch-overlay-aware for the owning thread, like
        ``node_by_id_direct``)."""
        batch = self._batch
        if batch is not None and batch.owner == threading.get_ident():
            return batch.get("allocs", alloc_id)
        return self._root.tables["allocs"].get(alloc_id)

    def job_by_id_direct(self, namespace: str, job_id: str):
        """Lock-free read of one job row at the current generation
        (batch-overlay-aware for the owning thread — the FSM's
        stop-without-purge deregister must see a register earlier in
        the same applied batch)."""
        batch = self._batch
        if batch is not None and batch.owner == threading.get_ident():
            return batch.get("jobs", (namespace, job_id))
        return self._root.tables["jobs"].get((namespace, job_id))

    def allocs_by_node_direct(self, node_id: str) -> List:
        """Lock-free read of one node's alloc rows, all from ONE root:
        the id-set and the rows it points at are the same generation,
        so the list can never contain a dangling id (the seed needed
        its lock for that guarantee)."""
        root = self._root
        ids = root.tables["allocs_by_node"].get(node_id, ())
        allocs = root.tables["allocs"]
        return [allocs[i] for i in ids]

    def allocs_by_job_direct(self, namespace: str, job_id: str) -> List:
        """Lock-free read of one job's alloc rows, all from ONE root
        (the ``allocs_by_node_direct`` shape keyed by job): the plan
        applier's duplicate-slot guard needs a job's live slots
        job-wide — a redelivered eval can re-place a slot on a
        different node than the committed original."""
        root = self._root
        ids = root.tables["allocs_by_job"].get((namespace, job_id), ())
        allocs = root.tables["allocs"]
        return [allocs[i] for i in ids]

    def with_usage_view(self, fn):
        """Run ``fn(planes, allocs)``: the frozen utilization planes
        (state/usage.py) and the alloc table of ONE root — both
        READ-ONLY to the callee and mutually consistent BY
        CONSTRUCTION (they were frozen by the same commit). The plan
        applier's group checker folds in-flight plan results against
        this pair; under the seed store the pairing needed the store
        lock held across both reads (server/plan_apply._GroupFitChecker)."""
        root = self._root
        return fn(root.usage, root.tables["allocs"])

    def with_allocs(self, fn):
        """Run ``fn(allocs)`` with one root's alloc table (READ-ONLY
        to the callee) — ``with_usage_view`` without the planes, for
        callers that only need consistent per-alloc liveness reads."""
        return fn(self._root.tables["allocs"])

    def block_until(self, tables: List[str], min_index: int, timeout: float) -> int:
        """Block until one of `tables` commits past min_index or the
        timeout passes; returns those tables' current index. This is the
        memdb WatchSet + min-index contract behind blocking queries
        (reference rpc.go:808 blockingRPC). Keyed on per-table indexes
        so unrelated commits don't wake every watcher."""
        idx = self.table_index(tables)
        if idx > min_index or timeout <= 0:
            return max(idx, min_index)
        event = threading.Event()
        # the notify carries its commit index into this cell, so a
        # wakeup re-checks against the index THAT TRIGGERED IT — and
        # because the root publishes before callbacks fire, the
        # lock-free floor read below can never lag the notify (the
        # seed's registration race, its main spurious-wakeup source)
        cell = [idx]

        def _woken(i: int, _cell=cell, _event=event) -> None:
            if i > _cell[0]:
                _cell[0] = i
            _event.set()

        unwatchers = [self.watch(t, _woken) for t in tables]
        watch_stats.enter()
        try:
            deadline = time.time() + timeout
            # re-check after registration: a commit may have landed
            # between the first check and the watch registration
            idx = max(cell[0], self.table_index(tables))
            while idx <= min_index:
                remaining = deadline - time.time()
                if remaining <= 0:
                    watch_stats.note_timeout()
                    break
                woke = event.wait(remaining)
                event.clear()
                # both reads are lock-free: the cell is the index that
                # fired the event, the table_index a monotone floor
                idx = max(cell[0], self.table_index(tables))
                if woke:
                    watch_stats.note_wakeup(spurious=idx <= min_index)
            return max(idx, min_index)
        finally:
            watch_stats.leave()
            for unwatch in unwatchers:
                unwatch()

    # --- aux tables: namespaces / scaling / ACL / stability -------------

    def upsert_namespace(self, ns) -> int:
        with self._txn() as txn:
            txn.set("namespaces", ns.name, ns)
            txn.notify = ["namespaces"]
        return txn.index

    def delete_namespace(self, name: str) -> int:
        with self._txn() as txn:
            if any(key[0] == name for key, _ in txn.items("jobs")):
                raise ValueError(f"namespace '{name}' has registered jobs")
            txn.delete("namespaces", name)
            txn.notify = ["namespaces"]
        return txn.index

    def namespaces(self) -> List:
        return list(self._root.tables["namespaces"].values())

    def namespace_by_name(self, name: str):
        return self._root.tables["namespaces"].get(name)

    def record_scaling_event(self, namespace: str, job_id: str, group: str,
                             event: Dict) -> int:
        """state_store.go UpsertScalingEvent (bounded history per group).
        History rows are immutable tuples: each event REPLACES the
        tuple (MVCC discipline — older generations keep theirs)."""
        with self._txn() as txn:
            event = dict(event)
            event.setdefault("task_group", group)
            key = (namespace, job_id)
            events = (event,) + txn.get("scaling_events", key, ())
            # structs.go JobTrackedScalingEvents
            txn.set("scaling_events", key, events[:20])
            txn.notify = ["scaling_event"]
        return txn.index

    def scaling_events(self, namespace: str, job_id: str) -> List[Dict]:
        return list(self._root.tables["scaling_events"]
                    .get((namespace, job_id), ()))

    def scaling_policies(self) -> List[Dict]:
        """Derived view: one policy per task group with a scaling stanza
        (reference stores these in a table keyed by target; deriving
        from the jobs table keeps them trivially consistent)."""
        out = []
        for (ns, jid), job in self._root.tables["jobs"].items():
            for tg in job.task_groups:
                if tg.scaling is not None:
                    out.append({
                        "id": f"{ns}/{jid}/{tg.name}",
                        "namespace": ns, "job_id": jid, "group": tg.name,
                        "policy": tg.scaling, "enabled": tg.scaling.enabled,
                    })
        return out

    def scaling_policy_by_id(self, policy_id: str):
        for p in self.scaling_policies():
            if p["id"] == policy_id:
                return p
        return None

    def set_job_stability(self, namespace: str, job_id: str, version: int,
                          stable: bool) -> int:
        with self._txn() as txn:
            idx = txn.index
            job = txn.get("job_versions", (namespace, job_id, version))
            if job is not None:
                # copy-on-write (the seed flipped the flag on the live
                # row, mutating state already visible to snapshots);
                # the jobs-table row is the same logical object when
                # the stabilized version is current, so both tables
                # take the new row
                job = job.copy()
                job.stable = stable
                job.modify_index = idx
                txn.set("job_versions", (namespace, job_id, version), job)
                current = txn.get("jobs", (namespace, job_id))
                if current is not None and current.version == version:
                    txn.set("jobs", (namespace, job_id), job)
            txn.notify = ["jobs"]
        return txn.index

    def upsert_acl_policy(self, policy) -> int:
        with self._txn() as txn:
            txn.set("acl_policies", policy.name, policy)
            txn.notify = ["acl_policy"]
        return txn.index

    def delete_acl_policy(self, name: str) -> int:
        with self._txn() as txn:
            txn.delete("acl_policies", name)
            txn.notify = ["acl_policy"]
        return txn.index

    def acl_policies(self) -> List:
        return list(self._root.tables["acl_policies"].values())

    def acl_policy_by_name(self, name: str):
        return self._root.tables["acl_policies"].get(name)

    def deployment_by_id(self, deployment_id: str):
        """Lock-free read of one deployment row at the current
        generation."""
        return self._root.tables["deployments"].get(deployment_id)

    def active_deployments(self) -> List[Deployment]:
        """Lock-free read of the active deployment rows: the
        deployments watcher polls this on every state change, and rows
        are replaced (never mutated) on update, so handing them out is
        safe."""
        return [d for d in self._root.tables["deployments"].values()
                if d.active()]

    def multiregion_terminal_deployment_ids(self) -> List[str]:
        """Ids of terminal multiregion deployments (the candidates for
        cross-region kicks) — the cheap gate that lets the watcher skip
        whole-state snapshots when there is no multiregion work."""
        return [
            d.id for d in self._root.tables["deployments"].values()
            if d.is_multiregion and d.status in (
                consts.DEPLOYMENT_STATUS_SUCCESSFUL,
                consts.DEPLOYMENT_STATUS_FAILED,
            )
        ]

    def upsert_acl_token(self, token) -> int:
        with self._txn() as txn:
            txn.set("acl_tokens", token.accessor_id, token)
            txn.notify = ["acl_token"]
        return txn.index

    def delete_acl_token(self, accessor_id: str) -> int:
        with self._txn() as txn:
            txn.delete("acl_tokens", accessor_id)
            txn.notify = ["acl_token"]
        return txn.index

    def acl_tokens(self) -> List:
        return list(self._root.tables["acl_tokens"].values())

    def acl_token_by_accessor(self, accessor_id: str):
        return self._root.tables["acl_tokens"].get(accessor_id)

    def acl_token_by_secret(self, secret_id: str):
        for t in self._root.tables["acl_tokens"].values():
            if t.secret_id == secret_id:
                return t
        return None

    # --- CSI volumes (state_store.go UpsertCSIVolume/CSIVolumeClaim) ----

    def upsert_csi_volumes(self, volumes: List) -> int:
        with self._txn() as txn:
            idx = txn.index
            for v in volumes:
                existing = txn.get("csi_volumes", (v.namespace, v.id))
                if existing is not None:
                    # re-register keeps live claims (csi_endpoint.go
                    # Register merge semantics)
                    v.read_claims = existing.read_claims
                    v.write_claims = existing.write_claims
                    v.past_claims = existing.past_claims
                    v.create_index = existing.create_index
                else:
                    v.create_index = idx
                v.modify_index = idx
                txn.set("csi_volumes", (v.namespace, v.id), v)
            txn.notify = ["csi_volumes"]
        return txn.index

    def csi_volume_deregister(self, namespace: str, volume_id: str,
                              force: bool = False) -> int:
        with self._txn() as txn:
            vol = txn.get("csi_volumes", (namespace, volume_id))
            if vol is None:
                raise ValueError(f"volume not found: {volume_id}")
            if vol.in_use() and not force:
                raise ValueError(f"volume in use: {volume_id}")
            txn.delete("csi_volumes", (namespace, volume_id))
            txn.notify = ["csi_volumes"]
        return txn.index

    def csi_volume_claim(self, namespace: str, volume_id: str, claim) -> int:
        """Apply a claim transition copy-on-write (state_store.go
        CSIVolumeClaim)."""
        with self._txn() as txn:
            vol = txn.get("csi_volumes", (namespace, volume_id))
            if vol is None:
                raise ValueError(f"volume not found: {volume_id}")
            vol = vol.copy()
            vol.claim(claim)
            vol.modify_index = txn.index
            txn.set("csi_volumes", (namespace, volume_id), vol)
            txn.notify = ["csi_volumes"]
        return txn.index

    def csi_volumes(self) -> List:
        return list(self._root.tables["csi_volumes"].values())

    def csi_volume_by_id(self, namespace: str, volume_id: str):
        return self._root.tables["csi_volumes"].get((namespace, volume_id))

    def csi_volumes_by_plugin(self, plugin_id: str) -> List:
        return [v for v in self._root.tables["csi_volumes"].values()
                if v.plugin_id == plugin_id]

    # --- service registrations (state_store_service_registration.go) ----

    def upsert_service_registrations(self, regs: List) -> int:
        with self._txn() as txn:
            idx = txn.index
            for r in regs:
                existing = txn.get("services", r.id)
                r.create_index = existing.create_index if existing else idx
                r.modify_index = idx
                txn.set("services", r.id, r)
            txn.notify = ["services"]
        return txn.index

    def delete_service_registration(self, reg_id: str) -> int:
        with self._txn() as txn:
            if txn.get("services", reg_id) is None:
                raise ValueError(f"service registration not found: {reg_id}")
            txn.delete("services", reg_id)
            txn.notify = ["services"]
        return txn.index

    def delete_service_registrations_by_alloc(self, alloc_ids: List[str]) -> int:
        """Client dereg batches + alloc GC
        (DeleteServiceRegistrationByAllocID)."""
        doomed_allocs = set(alloc_ids)
        with self._txn() as txn:
            doomed = [r.id for r in txn.values("services")
                      if r.alloc_id in doomed_allocs]
            if not doomed:
                txn.abort()
                return self._root.index
            for rid in doomed:
                txn.delete("services", rid)
            txn.notify = ["services"]
        return txn.index

    def delete_service_registrations_by_node(self, node_id: str) -> int:
        """Node down/deregister reaping (DeleteServiceRegistrationByNodeID)."""
        with self._txn() as txn:
            doomed = [r.id for r in txn.values("services")
                      if r.node_id == node_id]
            if not doomed:
                txn.abort()
                return self._root.index
            for rid in doomed:
                txn.delete("services", rid)
            txn.notify = ["services"]
        return txn.index

    def service_registrations(self, namespace: str = "*") -> List:
        return [r for r in self._root.tables["services"].values()
                if namespace in ("*", r.namespace)]

    def service_registrations_by_name(self, namespace: str, name: str) -> List:
        return [r for r in self._root.tables["services"].values()
                if r.namespace == namespace and r.service_name == name]

    def service_registration_by_id(self, reg_id: str):
        return self._root.tables["services"].get(reg_id)

    # --- one-time tokens (state_store.go UpsertOneTimeToken) -----------

    def upsert_one_time_token(self, ott: Dict) -> int:
        with self._txn() as txn:
            txn.set("one_time_tokens", ott["one_time_secret_id"], dict(ott))
            txn.notify = ["one_time_token"]
        return txn.index

    def one_time_token_by_secret(self, secret: str):
        return self._root.tables["one_time_tokens"].get(secret)

    def delete_one_time_tokens(self, secrets: List[str]) -> int:
        with self._txn() as txn:
            for s in secrets:
                txn.delete("one_time_tokens", s)
            txn.notify = ["one_time_token"]
        return txn.index

    def expire_one_time_tokens(self, now: float) -> List[str]:
        items = self._root.tables["one_time_tokens"].items()
        batch = self._batch
        if batch is not None and batch.owner == threading.get_ident():
            ov = batch.overlays.get("one_time_tokens")
            if ov:
                merged = dict(items)
                merged.update(ov)
                items = [(s, t) for s, t in merged.items()
                         if t is not TOMBSTONE]
        return [s for s, t in items
                if t.get("expires_at", 0) <= now]

    # --- periodic launch ledger (state_store.go UpsertPeriodicLaunch) ---

    def upsert_periodic_launch(self, namespace: str, job_id: str,
                               launch_time: float) -> int:
        with self._txn() as txn:
            txn.set("periodic_launches", (namespace, job_id), launch_time)
            txn.notify = ["periodic_launch"]
        return txn.index

    def delete_periodic_launch(self, namespace: str, job_id: str) -> int:
        with self._txn() as txn:
            txn.delete("periodic_launches", (namespace, job_id))
            txn.notify = ["periodic_launch"]
        return txn.index

    def periodic_launch_by_id(self, namespace: str, job_id: str) -> float:
        return self._root.tables["periodic_launches"] \
            .get((namespace, job_id), 0.0)

    # --- federation registry --------------------------------------------

    def upsert_region(self, region: str, http_addr: str) -> int:
        with self._txn() as txn:
            txn.set("regions", region, http_addr)
            txn.notify = ["regions"]
        return txn.index

    def regions(self) -> Dict[str, str]:
        return self._root.tables["regions"].to_dict()

    # --- autopilot config (state_store.go AutopilotConfig) --------------

    def set_autopilot_config(self, config: Dict) -> int:
        with self._txn() as txn:
            txn.autopilot_config = dict(config)
            txn.notify = ["autopilot-config"]
        return txn.index

    # --- snapshot persist/restore (fsm.go:1393 Snapshot, :1407 Restore) -

    def to_snapshot_bytes(self) -> bytes:
        """Serialize every table for raft snapshots / operator backup.

        Pins ONE root and serializes it with no locks at all: writers
        keep committing new generations while a multi-second C2M dump
        pickles this one (the seed held its lock to assemble the
        payload; before a later fix it held it for the whole pickle).
        The payload is plain dicts/sets — the same shape the seed
        wrote, so WAL/snapshot files stay readable both ways."""
        root = self._root
        t = root.tables
        payload = {
            "index": root.index,
            "nodes": t["nodes"].to_dict(),
            "jobs": t["jobs"].to_dict(),
            "job_versions": t["job_versions"].to_dict(),
            "evals": t["evals"].to_dict(),
            "allocs": t["allocs"].to_dict(),
            "deployments": t["deployments"].to_dict(),
            "allocs_by_job": {k: set(v)
                              for k, v in t["allocs_by_job"].items()},
            "allocs_by_node": {k: set(v)
                               for k, v in t["allocs_by_node"].items()},
            "allocs_by_eval": {k: set(v)
                               for k, v in t["allocs_by_eval"].items()},
            "scheduler_config": root.scheduler_config,
            "namespaces": t["namespaces"].to_dict(),
            "scaling_events": {k: list(v)
                               for k, v in t["scaling_events"].items()},
            "acl_policies": t["acl_policies"].to_dict(),
            "acl_tokens": t["acl_tokens"].to_dict(),
            "csi_volumes": t["csi_volumes"].to_dict(),
            "services": t["services"].to_dict(),
            "one_time_tokens": t["one_time_tokens"].to_dict(),
            "periodic_launches": t["periodic_launches"].to_dict(),
            "autopilot_config": dict(root.autopilot_config),
            "regions": t["regions"].to_dict(),
        }
        return pickle.dumps(payload)

    def restore_from_bytes(self, data: bytes) -> None:
        payload = pickle.loads(data)
        # bulk-build the PMaps before taking the write lock (restore
        # has no concurrent writers by protocol, but a reader-visible
        # half-restored root must never exist either way)
        tables = {
            "nodes": PMap.from_dict(payload["nodes"]),
            "jobs": PMap.from_dict(payload["jobs"]),
            "job_versions": PMap.from_dict(payload["job_versions"]),
            "evals": PMap.from_dict(payload["evals"]),
            "allocs": PMap.from_dict(payload["allocs"]),
            "deployments": PMap.from_dict(payload["deployments"]),
            "allocs_by_job": PMap.from_dict(
                {k: frozenset(v)
                 for k, v in payload["allocs_by_job"].items()}),
            "allocs_by_node": PMap.from_dict(
                {k: frozenset(v)
                 for k, v in payload["allocs_by_node"].items()}),
            "allocs_by_eval": PMap.from_dict(
                {k: frozenset(v)
                 for k, v in payload["allocs_by_eval"].items()}),
            "namespaces": PMap.from_dict(payload.get("namespaces", {})),
            "scaling_events": PMap.from_dict(
                {k: tuple(v)
                 for k, v in payload.get("scaling_events", {}).items()}),
            "acl_policies": PMap.from_dict(payload.get("acl_policies", {})),
            "acl_tokens": PMap.from_dict(payload.get("acl_tokens", {})),
            "csi_volumes": PMap.from_dict(payload.get("csi_volumes", {})),
            "services": PMap.from_dict(payload.get("services", {})),
            "one_time_tokens": PMap.from_dict(
                payload.get("one_time_tokens", {})),
            "periodic_launches": PMap.from_dict(
                payload.get("periodic_launches", {})),
            "regions": PMap.from_dict(payload.get("regions", {})),
        }
        draining = frozenset(
            nid for nid, n in payload["nodes"].items()
            if getattr(n, "drain", False))
        with self._write_lock:
            self.usage.rebuild(payload["nodes"].values(),
                               payload["allocs"].values())
            base = self._root
            table_indexes = dict(base.table_indexes)
            for t in _RESTORE_NOTIFY:
                if table_indexes.get(t, 0) < payload["index"]:
                    table_indexes[t] = payload["index"]
            generation = next(_GENERATIONS)
            root = StoreRoot(
                generation=generation,
                index=payload["index"],
                tables=tables,
                table_indexes=table_indexes,
                usage=self.usage.planes_copy(),
                scheduler_config=payload["scheduler_config"],
                autopilot_config=dict(payload.get(
                    "autopilot_config", base.autopilot_config)),
                draining_nodes=draining,
            )
            _ROOT_REGISTRY[generation] = root
            self._root = root
            store_stats.note_restore(generation)
        self._fire(list(_RESTORE_NOTIFY), payload["index"])

    # --- writes (FSM apply targets, fsm.go:194-280 dispatch) ---

    def upsert_node(self, node) -> int:
        with self._txn() as txn:
            idx = txn.index
            if not node.computed_class:
                node.compute_class()
            node.modify_index = idx
            if node.create_index == 0:
                node.create_index = idx
            existing = txn.get("nodes", node.id)
            if existing is not None:
                # re-registration keeps OPERATOR intent (state_store.go
                # upsertNodeTxn): a client restarting — including one
                # whose server restarted underneath it —
                # sends a fresh Node struct, but drain state and
                # scheduling eligibility were set through the drain/
                # eligibility endpoints and must survive it
                node.drain = existing.drain
                node.drain_strategy = existing.drain_strategy
                node.scheduling_eligibility = existing.scheduling_eligibility
                if node.create_index == idx:
                    node.create_index = existing.create_index
            txn.set("nodes", node.id, node)
            self.usage.node_row(node.id)
            self.usage.note_node_change(node.id)
            txn.notify = ["nodes"]
        return txn.index

    def delete_node(self, node_id: str) -> int:
        with self._txn() as txn:
            txn.delete("nodes", node_id)
            self.usage.drop_node(node_id)
            txn.notify = ["nodes"]
        return txn.index

    def update_node_status(self, node_id: str, status: str) -> int:
        with self._txn() as txn:
            node = txn.get("nodes", node_id)
            if node is not None:
                node = node.copy()
                node.status = status
                node.modify_index = txn.index
                txn.set("nodes", node_id, node)
                self.usage.note_node_change(node_id)
            txn.notify = ["nodes"]
        return txn.index

    def update_node_eligibility(self, node_id: str, eligibility: str) -> int:
        with self._txn() as txn:
            node = txn.get("nodes", node_id)
            if node is not None:
                node = node.copy()
                node.scheduling_eligibility = eligibility
                node.modify_index = txn.index
                txn.set("nodes", node_id, node)
                self.usage.note_node_change(node_id)
            txn.notify = ["nodes"]
        return txn.index

    def update_node_drain(self, node_id: str, drain: bool, strategy=None,
                          mark_eligible: bool = True) -> int:
        with self._txn() as txn:
            node = txn.get("nodes", node_id)
            if node is not None:
                node = node.copy()
                node.drain = drain
                node.drain_strategy = strategy
                if drain or not mark_eligible:
                    # drain completion keeps the node ineligible until
                    # the operator re-enables (drainer semantics)
                    node.scheduling_eligibility = consts.NODE_SCHEDULING_INELIGIBLE
                else:
                    node.scheduling_eligibility = consts.NODE_SCHEDULING_ELIGIBLE
                node.modify_index = txn.index
                txn.set("nodes", node_id, node)
                self.usage.note_node_change(node_id)
            txn.notify = ["nodes"]
        return txn.index

    def upsert_job(self, job) -> int:
        """UpsertJob: bumps version when the spec changed
        (state_store.go upsertJobImpl semantics)."""
        with self._txn() as txn:
            idx = txn.index
            key = (job.namespace, job.id)
            existing = txn.get("jobs", key)
            if existing is not None:
                if existing.spec_hash() != job.spec_hash():
                    job.version = existing.version + 1
                else:
                    job.version = existing.version
                job.create_index = existing.create_index
            else:
                job.create_index = idx
                job.version = 0
            job.modify_index = idx
            job.job_modify_index = idx
            job.status = _job_status(job)
            txn.set("jobs", key, job)
            txn.set("job_versions", (job.namespace, job.id, job.version), job)
            txn.notify = ["jobs"]
        return txn.index

    def delete_job(self, namespace: str, job_id: str) -> int:
        with self._txn() as txn:
            txn.delete("jobs", (namespace, job_id))
            # purge version history too (state_store.go DeleteJobTxn
            # deletes from the job_version table)
            for key, _ in txn.items("job_versions"):
                if key[0] == namespace and key[1] == job_id:
                    txn.delete("job_versions", key)
            txn.notify = ["jobs"]
        return txn.index

    def upsert_evals(self, evals: List[Evaluation]) -> int:
        with self._txn() as txn:
            idx = txn.index
            for e in evals:
                e.modify_index = idx
                if e.create_index == 0:
                    e.create_index = idx
                txn.set("evals", e.id, e)
            txn.notify = ["evals"]
        return txn.index

    def delete_evals(self, eval_ids: List[str]) -> int:
        with self._txn() as txn:
            for eid in eval_ids:
                txn.delete("evals", eid)
            txn.notify = ["evals"]
        return txn.index

    def upsert_allocs(self, allocs: List[Allocation]) -> int:
        with self._txn() as txn:
            dep_touched = False
            for a in allocs:
                dep_touched |= self._upsert_alloc_txn(txn, a)
            txn.notify = (["allocs", "deployment"] if dep_touched
                          else ["allocs"])
        return txn.index

    def _upsert_alloc_txn(self, txn: _WriteTxn, a: Allocation) -> bool:
        """Returns True when the upsert also wrote a deployment row."""
        idx = txn.index
        existing = txn.get("allocs", a.id)
        if existing is not None:
            # merge client-only fields if this is a server-side update
            a.create_index = existing.create_index
            if a.job is None:
                a.job = existing.job
        else:
            a.create_index = idx
        a.modify_index = idx
        txn.set("allocs", a.id, a)
        self.usage.alloc_changed(existing, a)
        dep_touched = self._update_deployment_with_alloc_txn(
            txn, existing, a)
        for table, key in (
            ("allocs_by_job", (a.namespace, a.job_id)),
            ("allocs_by_node", a.node_id),
            ("allocs_by_eval", a.eval_id),
        ):
            ids = txn.get(table, key)
            if ids is None or a.id not in ids:
                # frozenset replacement, never in-place (older
                # generations keep their id-sets)
                txn.set(table, key, (ids or frozenset()) | {a.id})
        return dep_touched

    def update_allocs_from_client(self, allocs: List[Allocation]) -> int:
        """Client status updates (state_store.go UpdateAllocsFromClient)."""
        with self._txn() as txn:
            idx = txn.index
            dep_touched = False
            for update in allocs:
                existing = txn.get("allocs", update.id)
                if existing is None:
                    continue
                new = existing.copy_skip_job()
                new.client_status = update.client_status
                new.client_description = update.client_description
                new.task_states = dict(update.task_states)
                if update.deployment_status is not None:
                    new.deployment_status = update.deployment_status
                if update.network_status is not None:
                    new.network_status = update.network_status
                new.modify_index = idx
                new.modify_time_ns = update.modify_time_ns
                txn.set("allocs", new.id, new)
                self.usage.alloc_changed(existing, new)
                # health transitions roll up into the deployment
                # (state_store.go updateDeploymentWithAlloc)
                dep_touched |= self._update_deployment_with_alloc_txn(
                    txn, existing, new)
            txn.notify = (["allocs", "deployment"] if dep_touched
                          else ["allocs"])
        return txn.index

    def _update_deployment_with_alloc_txn(
        self, txn: _WriteTxn, old: Optional[Allocation], new: Allocation
    ) -> bool:
        """Bump DeploymentState counters on placement/health changes
        (state_store.go updateDeploymentWithAlloc). Returns True when a
        deployment row was actually written — callers notify the
        "deployment" table only then, so the deployments watcher's
        index-gated early-out actually fires on deployment-less
        placement bursts (the common case)."""
        if not new.deployment_id:
            return False
        d = txn.get("deployments", new.deployment_id)
        if d is None or not d.active():
            return False
        state = d.task_groups.get(new.task_group)
        if state is None:
            return False
        placed = 1 if old is None else 0
        old_h = old.deployment_status.healthy \
            if old is not None and old.deployment_status is not None else None
        new_h = new.deployment_status.healthy \
            if new.deployment_status is not None else None
        d_healthy = (1 if new_h is True else 0) - (1 if old_h is True else 0)
        d_unhealthy = (1 if new_h is False else 0) - (1 if old_h is False else 0)
        if not (placed or d_healthy or d_unhealthy):
            return False
        d = d.copy()
        state = d.task_groups[new.task_group]
        state.placed_allocs += placed
        state.healthy_allocs += d_healthy
        state.unhealthy_allocs += d_unhealthy
        d.modify_index = txn.index
        txn.set("deployments", d.id, d)
        return True

    def update_allocs_desired_transition(self, transitions: Dict[str, object], evals: List[Evaluation]) -> int:
        """{alloc_id: DesiredTransition} -- drainer/operator migrate
        requests (state_store.go UpdateAllocsDesiredTransitions)."""
        with self._txn() as txn:
            idx = txn.index
            for alloc_id, transition in transitions.items():
                existing = txn.get("allocs", alloc_id)
                if existing is None:
                    continue
                new = existing.copy_skip_job()
                new.desired_transition = transition
                new.modify_index = idx
                txn.set("allocs", alloc_id, new)
                self.usage.alloc_changed(existing, new)
            for e in evals:
                e.modify_index = idx
                if e.create_index == 0:
                    e.create_index = idx
                txn.set("evals", e.id, e)
            txn.notify = ["allocs", "evals"]
        return txn.index

    def stop_alloc(self, alloc_id: str, evals: List[Evaluation]) -> int:
        """Mark one alloc desired=stop (`nomad alloc stop`;
        state_store.go UpdateAllocDesiredTransition + stop)."""
        with self._txn() as txn:
            idx = txn.index
            existing = txn.get("allocs", alloc_id)
            if existing is not None:
                new = existing.copy_skip_job()
                new.desired_status = consts.ALLOC_DESIRED_STOP
                new.modify_index = idx
                txn.set("allocs", alloc_id, new)
                self.usage.alloc_changed(existing, new)
            for e in evals:
                e.modify_index = idx
                if e.create_index == 0:
                    e.create_index = idx
                txn.set("evals", e.id, e)
            txn.notify = ["allocs", "evals"]
        return txn.index

    def upsert_deployment(self, d: Deployment) -> int:
        with self._txn() as txn:
            d.modify_index = txn.index
            if d.create_index == 0:
                d.create_index = txn.index
            txn.set("deployments", d.id, d)
            txn.notify = ["deployment"]
        return txn.index

    def update_deployment_status(self, deployment_id: str, status: str, description: str = "") -> int:
        with self._txn() as txn:
            d = txn.get("deployments", deployment_id)
            if d is not None:
                d = d.copy()
                d.status = status
                d.status_description = description or d.status_description
                d.modify_index = txn.index
                txn.set("deployments", deployment_id, d)
            txn.notify = ["deployment"]
        return txn.index

    def delete_allocs(self, alloc_ids: List[str]) -> int:
        """GC path (state_store.go DeleteEval also reaps allocs; service
        registrations of reaped allocs go with them)."""
        with self._txn() as txn:
            doomed = set(alloc_ids)
            for aid in alloc_ids:
                a = txn.get("allocs", aid)
                if a is None:
                    continue
                txn.delete("allocs", aid)
                self.usage.alloc_changed(a, None)
                for table, key in (
                    ("allocs_by_job", (a.namespace, a.job_id)),
                    ("allocs_by_node", a.node_id),
                    ("allocs_by_eval", a.eval_id),
                ):
                    ids = txn.get(table, key)
                    if ids and aid in ids:
                        remaining = ids - {aid}
                        if remaining:
                            txn.set(table, key, remaining)
                        else:
                            txn.delete(table, key)
            stale_regs = [r.id for r in txn.values("services")
                          if r.alloc_id in doomed]
            for rid in stale_regs:
                txn.delete("services", rid)
            txn.notify = (["allocs", "services"] if stale_regs
                          else ["allocs"])
        return txn.index

    def delete_deployments(self, deployment_ids: List[str]) -> int:
        with self._txn() as txn:
            for did in deployment_ids:
                txn.delete("deployments", did)
            txn.notify = ["deployment"]
        return txn.index

    def update_deployment_alloc_health(
        self,
        deployment_id: str,
        healthy_ids: List[str],
        unhealthy_ids: List[str],
        deployment_update: Optional[Dict] = None,
        evals: Optional[List[Evaluation]] = None,
    ) -> int:
        """state_store.go UpdateDeploymentAllocHealth: record per-alloc
        deployment health and bump the DeploymentState counters."""
        from nomad_tpu_torch.structs.alloc import AllocDeploymentStatus

        with self._txn() as txn:
            idx = txn.index
            d = txn.get("deployments", deployment_id)
            if d is not None:
                d = d.copy()
                for aid, healthy in [(i, True) for i in healthy_ids] + [
                    (i, False) for i in unhealthy_ids
                ]:
                    a = txn.get("allocs", aid)
                    if a is None:
                        continue
                    new = a.copy_skip_job()
                    new.job = a.job
                    status = new.deployment_status or AllocDeploymentStatus()
                    was = status.healthy
                    status.healthy = healthy
                    status.modify_index = idx
                    new.deployment_status = status
                    new.modify_index = idx
                    txn.set("allocs", aid, new)
                    self.usage.alloc_changed(a, new)
                    state = d.task_groups.get(new.task_group)
                    if state is not None and was != healthy:
                        if healthy:
                            state.healthy_allocs += 1
                            if was is False:
                                state.unhealthy_allocs -= 1
                        else:
                            state.unhealthy_allocs += 1
                            if was is True:
                                state.healthy_allocs -= 1
                d.modify_index = idx
                if deployment_update:
                    d.status = deployment_update.get("status", d.status)
                    d.status_description = deployment_update.get(
                        "status_description", d.status_description
                    )
                txn.set("deployments", deployment_id, d)
            for e in evals or []:
                e.modify_index = idx
                if e.create_index == 0:
                    e.create_index = idx
                txn.set("evals", e.id, e)
            txn.notify = ["allocs", "deployment", "evals"]
        return txn.index

    def update_deployment_promotion(
        self, deployment_id: str, groups: Optional[List[str]] = None,
        evals: Optional[List[Evaluation]] = None,
    ) -> int:
        """state_store.go UpdateDeploymentPromotion: mark canaries
        promoted for all (or the given) groups."""
        with self._txn() as txn:
            idx = txn.index
            d = txn.get("deployments", deployment_id)
            if d is not None:
                d = d.copy()
                for name, state in d.task_groups.items():
                    if groups is None or name in groups:
                        state.promoted = True
                d.modify_index = idx
                txn.set("deployments", deployment_id, d)
            for e in evals or []:
                e.modify_index = idx
                if e.create_index == 0:
                    e.create_index = idx
                txn.set("evals", e.id, e)
            txn.notify = ["deployment", "evals"]
        return txn.index

    def set_scheduler_config(self, config: SchedulerConfiguration) -> int:
        with self._txn() as txn:
            txn.scheduler_config = config
            txn.notify = ["scheduler_config"]
        return txn.index

    # --- plan application (FSM ApplyPlanResults, fsm.go applyPlanResults) ---

    def upsert_plan_results(
        self,
        alloc_index: int,
        plan: Plan,
        node_allocation: Dict[str, List[Allocation]],
        node_update: Dict[str, List[Allocation]],
        node_preemptions: Dict[str, List[Allocation]],
        deployment: Optional[Deployment] = None,
        deployment_updates: Optional[List[Dict]] = None,
    ) -> int:
        """Commit one (possibly partial) plan the applier validated."""
        return self.upsert_plan_results_batch(alloc_index, [{
            "plan": plan,
            "node_allocation": node_allocation,
            "node_update": node_update,
            "node_preemptions": node_preemptions,
            "deployment": deployment,
            "deployment_updates": deployment_updates,
        }])

    def upsert_plan_results_batch(self, alloc_index: int,
                                  plans: List[Dict]) -> int:
        """Commit a batch of evaluated plans as ONE transaction / index
        bump / watcher notification (the applier merges a burst of
        plans into one raft entry; fsm.go applyPlanResults semantics
        per plan, applied in batch order). A wave of hundreds of alloc
        upserts folds into the alloc table with one bulk path-copy at
        commit (PMap.update_with)."""
        with self._txn() as txn:
            idx = txn.index
            dep_touched = False
            for p in plans:
                plan = p["plan"]
                for allocs in p["node_update"].values():
                    for a in allocs:
                        dep_touched |= self._upsert_alloc_txn(txn, a)
                for allocs in p["node_preemptions"].values():
                    for a in allocs:
                        dep_touched |= self._upsert_alloc_txn(txn, a)
                for allocs in p["node_allocation"].values():
                    for a in allocs:
                        if a.job is None:
                            a.job = plan.job
                        dep_touched |= self._upsert_alloc_txn(txn, a)
                deployment = p.get("deployment")
                if deployment is not None:
                    deployment.modify_index = idx
                    if deployment.create_index == 0:
                        deployment.create_index = idx
                    txn.set("deployments", deployment.id, deployment)
                    dep_touched = True
                for du in p.get("deployment_updates") or []:
                    d = txn.get("deployments", du.get("deployment_id"))
                    if d is not None:
                        d = d.copy()
                        d.status = du.get("status", d.status)
                        d.status_description = du.get(
                            "status_description", d.status_description)
                        d.modify_index = idx
                        txn.set("deployments", d.id, d)
                        dep_touched = True
            # notify "deployment" only when a row actually changed: the
            # deployments watcher's idle gate keys on this index, and a
            # deployment-less placement burst (the common case) must not
            # defeat it by bumping the index on every plan commit
            txn.notify = (["allocs", "deployment"] if dep_touched
                          else ["allocs"])
        return txn.index


def _record_write_txn(dt: float) -> None:
    """One histogram sample per committed transaction (the bench store
    cell's store_write_txn_p99_us reads this distribution)."""
    try:
        from nomad_tpu_torch.telemetry.histogram import histograms

        histograms.get("store_write_txn").record(dt)
    except Exception:                           # noqa: BLE001 - metric only
        pass


def _job_status(job) -> str:
    if job.stop:
        return consts.JOB_STATUS_DEAD
    return consts.JOB_STATUS_PENDING
