"""Raft consensus node: election, replication, commit, FSM apply.

Reference behavior: hashicorp/raft v1.3.5 as wired by nomad
(server.go:1228 setupRaft, fsm.go): every authoritative mutation is a
log entry; the FSM applies committed entries in order; leadership
changes drive nomad's establishLeadership/revokeLeadership
(leader.go:54). This is a from-scratch implementation of the standard
algorithm (election timeout randomization, AppendEntries consistency
check, majority commit with current-term guard, InstallSnapshot for
lagging followers).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.raft.log import LOG_COMMAND, LOG_NOOP, LogEntry, LogStore
from nomad_tpu_torch.raft.observe import raft_observer
from nomad_tpu_torch.telemetry.histogram import (
    RAFT_APPEND,
    RAFT_ELECTION,
    RAFT_QUORUM,
    RAFT_REPLICATION,
    RAFT_SNAPSHOT_XFER,
    histograms,
)
from nomad_tpu_torch.telemetry.trace import consensus_recorder, tracer
from nomad_tpu_torch.utils.faultpoints import FaultError, fault
from nomad_tpu_torch.utils.witness import witness_lock

# reserved msg_types for replicated membership changes, handled by the
# raft layer itself instead of the FSM (hashicorp/raft
# RemoveServer/AddVoter)
RAFT_REMOVE_PEER = "__RaftRemovePeerConfigChange__"
RAFT_ADD_PEER = "__RaftAddPeerConfigChange__"

LOG = logging.getLogger(__name__)

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


class NotLeaderError(Exception):
    def __init__(self, leader: Optional[str]) -> None:
        super().__init__(f"not leader; leader is {leader}")
        self.leader = leader


class RaftConfig:
    def __init__(
        self,
        heartbeat_interval: float = 0.05,
        election_timeout_min: float = 0.15,
        election_timeout_max: float = 0.30,
        max_append_entries: int = 64,
        snapshot_threshold: int = 8192,
        max_in_flight: int = 8,
        leader_lease: bool = True,
        lease_fraction: float = 0.75,
    ) -> None:
        self.heartbeat_interval = heartbeat_interval
        self.election_timeout_min = election_timeout_min
        self.election_timeout_max = election_timeout_max
        self.max_append_entries = max_append_entries
        self.snapshot_threshold = snapshot_threshold
        #: AppendEntries batches a per-peer replicator may keep in
        #: flight before waiting for acks (hashicorp/raft's pipeline);
        #: 1 disables pipelining entirely — the replicator then runs
        #: the original synchronous send->ack->send path, bit for bit
        self.max_in_flight = max_in_flight
        #: clock-based leader lease: a quorum of AppendEntries acks
        #: within ``election_timeout_min * lease_fraction`` of their
        #: SEND stamps lets leader-side linearizable reads skip the
        #: barrier round-trip. Safety leans on the paired follower
        #: rule: no vote against a live leader within
        #: election_timeout_min of its last contact (raft §6), so a
        #: deposed leader's lease always expires before its successor
        #: can win — as long as clock RATES stay within the
        #: 1 - lease_fraction margin (offsets don't matter, both
        #: sides measure durations)
        self.leader_lease = leader_lease
        self.lease_fraction = lease_fraction


class _ApplyFuture:
    def __init__(self, index: int) -> None:
        self.index = index
        self._done = threading.Event()
        self.result: Any = None
        self.error: Optional[Exception] = None

    def respond(self, result: Any, error: Optional[Exception]) -> None:
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float]) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError("apply timeout")
        if self.error is not None:
            raise self.error
        return self.result


class RaftNode:
    def __init__(
        self,
        node_id: str,
        peers: List[str],
        transport,
        fsm_apply: Callable[[str, Dict], Any],
        fsm_apply_batch: Optional[
            Callable[[List[Tuple[str, Dict]]], List]] = None,
        config: Optional[RaftConfig] = None,
        snapshot_fn: Optional[Callable[[], bytes]] = None,
        restore_fn: Optional[Callable[[bytes], None]] = None,
        on_leader: Optional[Callable[[], None]] = None,
        on_follower: Optional[Callable[[], None]] = None,
        log_store: Optional[LogStore] = None,
        data_dir: Optional[str] = None,
        fsync_policy: str = "batch",
    ) -> None:
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.transport = transport
        # the handler answers from the first RPC on, while the node
        # still recovers its state: until the end of __init__ a vote is
        # not granted and any other RPC finds no node here
        self._ready = False
        transport.set_handler(self._handle_rpc)
        self.fsm_apply = fsm_apply
        # optional batched FSM doorway: the apply loop hands a whole
        # committed run of plain commands to one call (one FSM-lock +
        # store-root-swap span on the other side); absent, it falls
        # back to per-entry fsm_apply inside the same batch drain
        self.fsm_apply_batch = fsm_apply_batch
        self.config = config or RaftConfig()
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.on_leader = on_leader
        self.on_follower = on_follower

        # witness-created: the stress tier checks the pipeline
        # window bookkeeping below for lock-order inversions
        self._lock = witness_lock("raft_node", rlock=True)
        self.state = FOLLOWER
        self.current_term = 0
        self.voted_for: Optional[str] = None
        # crash-safe durability plane (raft/wal.py). With a
        # data_dir this node recovers its HARD state from disk in
        # strict order: stable store (term/vote — a node that forgets
        # its vote can vote twice in one term, a raft SAFETY
        # violation) -> newest valid snapshot -> restore_fn -> WAL
        # replay into the log. Committed replayed entries re-apply
        # into the FSM through the normal apply loop once the commit
        # index advances (leader election / AppendEntries).
        self._stable = None
        self._snapshots = None
        self._durable = bool(data_dir)
        self.recovered_snapshot_index = 0
        self.replayed_entries = 0
        if data_dir:
            from nomad_tpu_torch.raft import wal as _wal

            os.makedirs(data_dir, exist_ok=True)
            self._stable = _wal.StableStore(data_dir, owner=node_id)
            self.current_term, self.voted_for = self._stable.load()
            self._snapshots = _wal.SnapshotStore(data_dir, owner=node_id)
            snap = self._snapshots.load_newest()
            if snap is not None and self.restore_fn is not None:
                self.recovered_snapshot_index = snap[0]
                self.restore_fn(snap[2])
            store = _wal.DurableLogStore(
                os.path.join(data_dir, "wal"), fsync_policy=fsync_policy,
                owner=node_id)
            self.replayed_entries = store.replayed_entries
            if snap is not None and store.base_index() < snap[0]:
                # crash between snapshot write and the compact record:
                # the snapshot is authoritative for everything <= its
                # index, so compact the replayed log up to it
                store.compact_to(snap[0], snap[1])
            if (snap is None or snap[0] < store.base_index()) \
                    and store.base_index() > 0:
                # no snapshot at all, OR only an OLDER fallback (the
                # newest failed its CRC): either way the span up to
                # the compacted base cannot be reconstructed
                have = "no valid snapshot" if snap is None else \
                    f"newest valid snapshot is only {snap[0]}"
                raise _wal.WalCorruptionError(
                    f"{node_id}: log compacted to {store.base_index()} "
                    f"but {have} — the state below the base is "
                    "unrecoverable (refusing to boot with silent "
                    "data loss)")
            log_store = store
            _wal.wal_stats.note_recovery(node_id)
            if self.replayed_entries or snap is not None:
                LOG.info(
                    "%s: recovered from %s (term=%d vote=%s "
                    "snapshot=%d wal_entries=%d)", node_id, data_dir,
                    self.current_term, self.voted_for,
                    self.recovered_snapshot_index, self.replayed_entries)
        self.log = log_store or LogStore()
        # everything at or below the base was snapshotted from applied
        # state: committed by definition
        self.commit_index = self.log.base_index()
        self.last_applied = self.log.base_index()
        self.leader_id: Optional[str] = None
        self._last_contact = time.monotonic()
        self._votes = 0
        # set when a committed config change removed this node
        self._removed = False

        # leader volatile state
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        # last successful RPC round-trip per peer (autopilot's
        # last-contact health signal)
        self.peer_last_contact: Dict[str, float] = {}

        # --- pipelined replication -------------------------------------
        # Per-peer window state, all under self._lock. A peer's
        # pipeline arms (_pipe_ok) only after a successful synchronous
        # ack proved next_index correct; any failure, term change,
        # conflict backoff, or snapshot need DRAINS the window (epoch
        # bump discards in-flight acks) and falls back to the sync
        # path. Acks are processed strictly in send order (_pipe_seq /
        # _pipe_ack_turn) so match_index/commit advance per batch
        # exactly as the synchronous path would.
        self._pipe_ok: Dict[str, bool] = {}
        self._pipe_epoch: Dict[str, int] = {}
        self._pipe_seq: Dict[str, int] = {}
        self._pipe_ack_turn: Dict[str, int] = {}
        self._pipe_inflight: Dict[str, int] = {}
        #: speculative send frontier — entries below it are in flight
        self._pipe_next: Dict[str, int] = {}
        self._pipe_cond = threading.Condition(self._lock)
        self._pipe_batches = 0
        self._pipe_drains = 0
        # per-peer wire turnstile: concurrent sender threads overlap
        # their TRANSIT (the fault seam's injected latency sleeps
        # concurrently) but hit the transport strictly in sequence
        # order — the ordered-stream property a TCP pipeline gets for
        # free, without which scheduler jitter reorders arrivals at
        # the follower and every reorder costs a conflict + drain.
        # LEAF under raft_node: _pipe_drain_locked mirrors the epoch
        # into it while holding self._lock; senders never take
        # self._lock while holding it
        self._wire_lock = witness_lock("raft_pipe_wire")
        self._wire_cond = threading.Condition(self._wire_lock)
        self._wire_turn: Dict[str, int] = {}
        self._wire_epoch: Dict[str, int] = {}

        # --- leader lease ----------------------------------------------
        # per-peer newest SEND-start stamp among acked AppendEntries /
        # InstallSnapshot RPCs: the follower's no-vote window opens at
        # its RECEIVE time >= our send time, so a lease computed from
        # send stamps can never outlive the window that protects it
        self._lease_contact: Dict[str, float] = {}
        self._lease_reads_fast = 0
        self._lease_reads_barrier = 0
        # edge-detect lease expiry for the consensus event log: set on
        # a fast-path read, cleared (with one "lease_expired" timeline
        # event) the first time a read demotes to the barrier
        self._lease_was_valid = False

        self._futures: Dict[int, _ApplyFuture] = {}
        self._apply_cond = threading.Condition(self._lock)
        # --- consensus-plane observability ------------------------------
        # leader-side append stamps (index -> monotonic) feed the
        # always-on quorum/replication-lag histograms: O(1) dict ops
        # per apply, pruned as the commit index advances
        self._append_stamps: Dict[int, float] = {}
        #: highest index already pruned from _append_stamps — lets the
        #: per-ack prune skip its O(stamps) scan when the floor is
        #: pinned by a lagging/dead peer
        self._stamp_floor = 0
        # (histogram op, seconds) samples collected under self._lock,
        # recorded OUTSIDE it by _obs_flush (R2: no foreign locks
        # inside the raft critical sections)
        self._obs_pending: List[Tuple[str, float]] = []
        # the newest applier's trace context, shipped inside raft RPCs
        # so one eval's span tree spans leader and followers (batch
        # envelope semantics — the waterfall claims by overlap)
        self._repl_trace_ctx: Optional[Tuple[str, int]] = None
        # open-election stamp for the election-duration observation
        self._election_started_mono: Optional[float] = None
        raft_observer.register(node_id, self)
        if self._durable and (self.replayed_entries
                              or self.recovered_snapshot_index):
            # recovered indexes ride in detail, NOT as a causal pin: a
            # recovery replays OLD indexes and must order by clock,
            # not be sorted back to where those entries first landed
            raft_observer.note_event(
                node_id, "recovery", term=self.current_term,
                detail={"replayed": self.replayed_entries,
                        "snapshot_index": self.recovered_snapshot_index})
        # one persistent replicator per peer, individually woken -- a
        # slow peer must not delay heartbeats to the others
        self._peer_wakes: Dict[str, threading.Event] = {
            p: threading.Event() for p in self.peers
        }
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        # the term whose noop barrier marks leadership fully established
        self._leader_barrier_term = -1
        # serializes FSM apply against snapshot capture so a snapshot is
        # exactly the state at last_applied (no torn snapshots);
        # witness-created so the batched drain's fsm->node->store
        # ordering is checked under the stress tier
        self._fsm_lock = witness_lock("raft_fsm")
        # request-id -> result for forwarded applies (at-most-once: a
        # retry after a dropped response must not re-apply the command)
        self._forward_results: Dict[str, Any] = {}
        self._forward_order: List[str] = []
        self._ready = True

    # --- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._shutdown.clear()
        for name, target in (
            ("raft-tick", self._run_ticker),
            ("raft-apply", self._run_apply),
        ):
            t = threading.Thread(target=target, daemon=True, name=f"{name}-{self.id}")
            self._threads.append(t)
            t.start()
        for peer in self.peers:
            t = threading.Thread(
                target=self._run_peer_replicator, args=(peer,),
                daemon=True, name=f"raft-repl-{self.id}-{peer}",
            )
            self._threads.append(t)
            t.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._lock:
            self._apply_cond.notify_all()
        self._wake_replicators()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
        self.transport.close()
        close = getattr(self.log, "close", None)
        if close is not None:
            close()
        if self._durable:
            from nomad_tpu_torch.raft.wal import wal_stats

            wal_stats.note_cache(self.id, 0)
        raft_observer.unregister(self.id)

    # --- durability helpers (raft/wal.py) -------------------------------

    def _persist_hard_state_locked(self) -> None:
        """Persist (current_term, voted_for). MUST complete before any
        RPC response that grants a vote or adopts the term leaves this
        node — a crash after responding but before persisting would
        let the restarted node vote again in the same term. Called
        under self._lock; the stable store's writes are monotone so a
        racing later persist can never be regressed by this one."""
        if self._stable is not None:
            self._stable.put(self.current_term, self.voted_for)

    def _sync_log(self) -> None:
        """The ack durability boundary: group-fsync every journaled
        frame (no-op for the in-memory store). Called OUTSIDE
        self._lock — an fsync must never stretch the RPC/apply
        critical sections."""
        if self._durable:
            # raft-fsync is a waterfall segment: the span window is
            # the disk wait an eval's commit actually sat behind
            with tracer.span("raft.fsync"):
                self.log.sync()

    def _note_snapshot_cache_locked(self) -> None:
        from nomad_tpu_torch.raft.wal import wal_stats

        cache = self._snapshot_cache
        wal_stats.note_cache(self.id, len(cache[2]) if cache else 0)

    def is_leader(self) -> bool:
        with self._lock:
            return self.state == LEADER

    def leader_addr(self) -> Optional[str]:
        with self._lock:
            return self.id if self.state == LEADER else self.leader_id

    def last_contact_s(self) -> float:
        """Age of this server's last leader contact (AppendEntries /
        InstallSnapshot receipt or vote grant), in seconds — the
        follower-side staleness meter the read plane stamps into
        ``X-Nomad-Last-Contact``. 0.0 on the leader: its
        store is the state, by definition not stale."""
        with self._lock:
            if self.state == LEADER:
                return 0.0
            return max(0.0, time.monotonic() - self._last_contact)

    # --- public apply ---------------------------------------------------

    def apply(self, msg_type: str, req: Dict, timeout: float = 10.0) -> Any:
        """Append a command; block until committed + FSM-applied locally.
        On followers raises NotLeaderError (callers forward)."""
        # the leader-side entry seam: an injected error here is a raft
        # apply that failed before the append (chaos plane)
        fault("raft.apply.pre")
        if tracer.enabled:
            # cross-server propagation: the applier's trace context
            # rides the next AppendEntries so follower-side spans
            # join this eval's tree (last-writer-wins batch envelope)
            self._repl_trace_ctx = tracer.context()
        with self._lock:
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            entry = LogEntry(
                index=self.log.last_index() + 1,
                term=self.current_term,
                kind=LOG_COMMAND,
                data=(msg_type, req),
            )
            self.log.append(entry)
            self._append_stamps[entry.index] = time.monotonic()
            fut = _ApplyFuture(entry.index)
            self._futures[entry.index] = fut
        # replicators ship the in-memory entry while the leader's own
        # fsync runs (disk overlaps network — followers fsync before
        # acking anyway); the leader's own log vote counts toward
        # commit only once the entry is DURABLE, so _count_self_match
        # stays behind the sync
        self._wake_replicators()
        self._sync_log()
        self._count_self_match(entry)
        self._obs_flush()
        return fut.wait(timeout)

    def barrier(self, timeout: float = 5.0) -> None:
        """Commit a noop and wait (leadership barrier)."""
        with self._lock:
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            entry = LogEntry(
                index=self.log.last_index() + 1,
                term=self.current_term,
                kind=LOG_NOOP,
                data=None,
            )
            self.log.append(entry)
            self._append_stamps[entry.index] = time.monotonic()
            fut = _ApplyFuture(entry.index)
            self._futures[entry.index] = fut
        self._wake_replicators()
        self._sync_log()
        self._count_self_match(entry)
        self._obs_flush()
        fut.wait(timeout)

    def _count_self_match(self, entry: LogEntry) -> None:
        """Advance the leader's own match index for a just-synced
        entry. Concurrent appliers can sync out of order (the group
        fsync covers both), so the match only ever moves forward."""
        with self._lock:
            if self.state != LEADER or self.current_term != entry.term:
                return
            if entry.index > self.match_index.get(self.id, 0):
                self.match_index[self.id] = entry.index
            # a follower's ack may have landed before this sync: with
            # one voter down, no later ack would count the leader's
            # own match and the entry would never commit
            self._advance_commit_locked()

    # --- ticker: elections + heartbeats ---------------------------------

    def _election_timeout(self) -> float:
        return random.uniform(
            self.config.election_timeout_min, self.config.election_timeout_max
        )

    def _run_ticker(self) -> None:
        timeout = self._election_timeout()
        wal_halted = False
        while not self._shutdown.is_set():
            time.sleep(self.config.heartbeat_interval / 2)
            if self._durable and getattr(self.log, "wal_failed", False):
                # fail-stop demotion (the reference panics on a boltdb
                # write error and failover follows the process death;
                # in-process we demote instead): a node that cannot
                # persist must stop LEADING — its heartbeats would
                # otherwise suppress elections forever while every
                # write fails — and must never campaign. It keeps
                # answering reads/votes; an operator (or the restart
                # harness) kills + recovers it.
                if not wal_halted:
                    wal_halted = True
                    raft_observer.note_event(
                        self.id, "wal_failed", term=self.current_term,
                        detail={"was_leader": self.is_leader()})
                    LOG.error(
                        "%s: WAL failed — halting raft leadership/"
                        "campaigns (kill + restart to recover)", self.id)
                if self.is_leader():
                    self.step_down()
                continue
            with self._lock:
                state = self.state
                elapsed = time.monotonic() - self._last_contact
                if self._removed:
                    continue   # voted off the cluster: never campaign
            if state == LEADER:
                try:
                    # leader step-down seam: an armed error here (the
                    # chaos cell's leader-kill schedule) deposes this
                    # leader mid-flight — elections, broker flush +
                    # restore, and plan-future failover all follow the
                    # exact production paths
                    fault("raft.leader.stepdown")
                except FaultError:
                    LOG.info("%s: injected leader step-down", self.id)
                    self.step_down()
                    continue
                self._wake_replicators()   # heartbeat
                continue
            if elapsed >= timeout:
                timeout = self._election_timeout()
                self._start_election()

    def _start_election(self) -> None:
        with self._lock:
            self.state = CANDIDATE
            self.current_term += 1
            term = self.current_term
            self.voted_for = self.id
            self._votes = 1
            self.leader_id = None
            self._last_contact = time.monotonic()
            last_index = self.log.last_index()
            last_term = self.log.last_term()
            peers = list(self.peers)
            # the self-vote is a vote: durable before any RequestVote
            # RPC leaves (a restarted candidate must not re-vote
            # differently in this term)
            self._persist_hard_state_locked()
            if self._election_started_mono is None:
                # first round of this election sequence: the elect
                # phase of a failover runs from HERE to leader_won,
                # covering failed rounds in between
                self._election_started_mono = time.monotonic()
        raft_observer.note_transition(self.id, "election")
        raft_observer.note_event(self.id, "election_start", term=term)
        LOG.debug("%s starting election term %d", self.id, term)
        if not peers:
            self._maybe_win_locked_check(term)
            return
        for peer in peers:
            threading.Thread(
                target=self._request_vote_from,
                args=(peer, term, last_index, last_term),
                daemon=True,
            ).start()

    def _request_vote_from(self, peer: str, term: int, last_index: int, last_term: int) -> None:
        try:
            resp = self.transport.send(
                peer, "request_vote",
                {"term": term, "candidate": self.id,
                 "last_log_index": last_index, "last_log_term": last_term},
            )
        except ConnectionError:
            return
        with self._lock:
            if self.state != CANDIDATE or self.current_term != term:
                return
            if resp["term"] > self.current_term:
                self._step_down_locked(resp["term"])
                return
            if resp.get("granted"):
                self._votes += 1
        self._maybe_win_locked_check(term)

    def _maybe_win_locked_check(self, term: int) -> None:
        became_leader = False
        with self._lock:
            n_voters = len(self.peers) + 1
            if (
                self.state == CANDIDATE
                and self.current_term == term
                and self._votes > n_voters // 2
            ):
                self.state = LEADER
                self.leader_id = self.id
                last = self.log.last_index()
                self.next_index = {p: last + 1 for p in self.peers}
                self.match_index = {p: 0 for p in self.peers}
                self.match_index[self.id] = last
                # fresh leadership: every pipeline re-arms through a
                # synchronous ack, the lease starts from zero (stamps
                # from a previous term must not validate this one)
                self._pipe_drain_all_locked()
                self._lease_contact = {}
                became_leader = True
                election_dur = (
                    time.monotonic() - self._election_started_mono
                    if self._election_started_mono is not None else None)
                self._election_started_mono = None
                LOG.info("%s became leader for term %d", self.id, term)
        if became_leader:
            raft_observer.note_transition(self.id, "leader")
            raft_observer.note_event(self.id, "leader_won", term=term)
            if election_dur is not None:
                # election duration feeds the histogram + consensus
                # recorder: a slow election (repeated timeouts, vote
                # churn) is a tail event worth a captured record
                histograms.get(RAFT_ELECTION).record(election_dur)
                consensus_recorder.observe(
                    RAFT_ELECTION, election_dur, server_id=self.id)
            # commit a barrier noop from this term; on_leader fires when
            # it applies (guarantees the FSM has all prior state)
            with self._lock:
                entry = LogEntry(
                    index=self.log.last_index() + 1,
                    term=term,
                    kind=LOG_NOOP,
                    data=None,
                )
                self.log.append(entry)
                self._leader_barrier_term = term
            self._wake_replicators()
            self._sync_log()
            self._count_self_match(entry)

    def step_down(self) -> None:
        """Voluntarily abandon leadership (hashicorp/raft's leadership
        transfer, minus the hand-off): become a follower in the current
        term, fail pending futures, and let a peer's election timeout
        pick the next leader. The chaos cell's leader-kill schedule
        drives this through the ``raft.leader.stepdown`` fault point."""
        with self._lock:
            if self.state != LEADER:
                return
            self._step_down_locked(self.current_term)

    def _step_down_locked(self, term: int) -> None:
        was_leader = self.state == LEADER
        self.state = FOLLOWER
        self._election_started_mono = None
        if term > self.current_term:
            # only a NEW term clears the vote -- resetting within the
            # same term would allow double-voting
            self.current_term = term
            self.voted_for = None
            # adopted term durable before any response built on it
            # leaves this node (the stable store's no-change fast path
            # makes the equal-term calls free)
            self._persist_hard_state_locked()
            raft_observer.note_transition(self.id, "term")
            raft_observer.note_event(self.id, "term_adopt", term=term)
        self._last_contact = time.monotonic()
        if was_leader:
            # deposed: in-flight pipeline acks are void, and the lease
            # dies with the leadership (lease_valid gates on LEADER
            # anyway; clearing the stamps keeps a re-election from
            # inheriting them)
            self._pipe_drain_all_locked()
            self._lease_contact = {}
            raft_observer.note_transition(self.id, "stepdown")
            raft_observer.note_event(
                self.id, "stepdown", term=self.current_term,
                detail={"was_leader": True})
            # fail pending futures; a new leader owns them now
            for fut in self._futures.values():
                fut.respond(None, NotLeaderError(self.leader_id))
            self._futures.clear()
            if self.on_follower is not None:
                threading.Thread(target=self.on_follower, daemon=True).start()

    # --- replication (leader) -------------------------------------------

    def _wake_replicators(self) -> None:
        # snapshot under the lock: membership changes (gossip-driven
        # add/remove_peer) mutate the dict concurrently with the
        # ticker's iteration
        with self._lock:
            wakes = list(self._peer_wakes.values())
        for ev in wakes:
            ev.set()

    def _run_peer_replicator(self, peer: str) -> None:
        wake = self._peer_wakes[peer]
        while not self._shutdown.is_set():
            wake.wait(self.config.heartbeat_interval)
            wake.clear()
            if self._shutdown.is_set():
                return
            with self._lock:
                if peer not in self.peers:
                    return   # removed from the voting set (autopilot)
                if self.state != LEADER:
                    continue
            try:
                self._replicate_to(peer)
            except Exception as e:              # noqa: BLE001
                LOG.debug("%s: replicate to %s failed: %s", self.id, peer, e)

    def _replicate_to(self, peer: str) -> None:
        """Per-peer replication dispatch. The pipelined path needs an
        ARMED window (a prior synchronous ack proved next_index) and
        ``max_in_flight > 1``; everything else — first contact,
        conflict backoff, snapshot catch-up, and the
        ``max_in_flight=1`` configuration — runs the original
        synchronous send->ack->send path unchanged."""
        if self.config.max_in_flight > 1:
            with self._lock:
                pipelined = self._pipe_ok.get(peer, False)
            if pipelined:
                self._replicate_pipelined(peer)
                return
        self._replicate_sync(peer)

    def _replicate_sync(self, peer: str) -> None:
        with self._lock:
            if self.state != LEADER:
                return
            term = self.current_term
            next_idx = self.next_index.get(peer, self.log.last_index() + 1)
            base = self.log.base_index()
            need_snapshot = next_idx <= base
        if need_snapshot and self._snapshot_cache is None:
            # log is compacted past the peer but no snapshot bytes are
            # in memory (restart from a compacted log, or the cache was
            # dropped after the fleet caught up): PREFER the on-disk
            # snapshot file over re-forcing an FSM capture —
            # only capture anew when no durable file
            # covers the base
            if not self._load_disk_snapshot_cache():
                self.force_snapshot()
        with self._lock:
            if self.state != LEADER or self.current_term != term:
                return
            if need_snapshot:
                if self._snapshot_cache is None:
                    LOG.error(
                        "%s: peer %s needs snapshot but none available",
                        self.id, peer,
                    )
                    return
                snapshot_req = self._build_snapshot_req_locked()
            else:
                snapshot_req = None
                prev_index = next_idx - 1
                prev_term = self.log.term_at(prev_index)
                if prev_term is None:
                    return
                entries = self.log.entries_from(
                    next_idx, self.config.max_append_entries
                )
                commit = self.commit_index
        # lease stamp = SEND-start (before the seam: an injected delay
        # only makes the stamp conservative). The follower's no-vote
        # window opens at its receive time >= this stamp, so a lease
        # extended from here can never outlive that window.
        t_start = time.monotonic()
        # replication seam: injected errors/latency here are dropped or
        # slow AppendEntries RPCs — the replicator's retry-next-wake
        # path (ConnectionError treatment below) must absorb them
        fault("raft.replicate.send")
        try:
            if snapshot_req is not None:
                # index-pinned CREATOR event: the send precedes every
                # follower's snapshot_install for this index, so the
                # timeline's skew estimator can anchor the index at
                # this stamp (telemetry/timeline._estimate_offsets)
                raft_observer.note_event(
                    self.id, "snapshot_sent", term=term,
                    index=snapshot_req["last_index"])
                xfer_t0 = time.monotonic()
                resp = self.transport.send(peer, "install_snapshot", snapshot_req)
                histograms.get(RAFT_SNAPSHOT_XFER).record(
                    time.monotonic() - xfer_t0)
                raft_observer.note_snapshot_xfer(
                    self.id, "sent", len(snapshot_req["data"] or b""))
                with self._lock:
                    if resp["term"] > self.current_term:
                        self._step_down_locked(resp["term"])
                        return
                    self.next_index[peer] = snapshot_req["last_index"] + 1
                    self.match_index[peer] = snapshot_req["last_index"]
                    self.peer_last_contact[peer] = time.monotonic()
                    self._note_lease_contact_locked(peer, t_start)
                    self._maybe_drop_snapshot_cache_locked()
                return
            req = {"term": term, "leader": self.id,
                   "prev_log_index": prev_index,
                   "prev_log_term": prev_term,
                   "entries": entries, "leader_commit": commit}
            if entries and tracer.enabled:
                # ship the applier's trace context and span the RPC:
                # raft-replicate is the waterfall's network segment
                ctx = self._repl_trace_ctx
                if ctx is not None:
                    req["trace"] = ctx
                with tracer.attach(ctx), tracer.span("raft.replicate"):
                    resp = self.transport.send(peer, "append_entries", req)
            else:
                resp = self.transport.send(peer, "append_entries", req)
        except ConnectionError:
            return
        lag_s = None
        with self._lock:
            if self.state != LEADER or self.current_term != term:
                return
            if resp["term"] > self.current_term:
                self._step_down_locked(resp["term"])
                return
            self.peer_last_contact[peer] = time.monotonic()
            # the follower answered IN OUR TERM: its election timer
            # reset on receipt, so even a conflict reply extends the
            # lease window (the stamp is the send start, see above)
            self._note_lease_contact_locked(peer, t_start)
            if resp.get("success"):
                # next_index is now PROVEN for this peer: arm the
                # pipelined window (no-op at max_in_flight=1 — the
                # dispatch never consults _pipe_ok then)
                self._pipe_ok[peer] = True
                if entries:
                    newest = entries[-1].index
                    stamp = self._append_stamps.get(newest)
                    if stamp is not None:
                        lag_s = time.monotonic() - stamp
                        self._obs_pending.append((RAFT_REPLICATION, lag_s))
                    self.match_index[peer] = newest
                    self.next_index[peer] = newest + 1
                    self._advance_commit_locked()
                    self._maybe_drop_snapshot_cache_locked()
                    if self.next_index[peer] <= self.log.last_index():
                        self._wake_replicators()
            else:
                # follower log conflict: back off (fast with hint)
                hint = resp.get("conflict_index")
                self.next_index[peer] = max(
                    1, hint if hint else self.next_index.get(peer, 2) - 1
                )
                self._wake_replicators()
        if entries and resp.get("success"):
            raft_observer.note_replicated(
                self.id, peer, len(entries),
                lag_ms=round(lag_s * 1e3, 3) if lag_s is not None
                else None)
        self._obs_flush()

    # --- pipelined replication ------------------------------------------

    def _replicate_pipelined(self, peer: str) -> None:
        """Fill the peer's in-flight window: cut AppendEntries batches
        from the speculative frontier (``_pipe_next``) and hand each to
        a short-lived sender thread — up to ``max_in_flight`` at once.
        Acks are serialized in send order by :meth:`_pipe_ack`. The
        transport send itself always happens OUTSIDE self._lock (R2)."""
        cfg = self.config
        while not self._shutdown.is_set():
            with self._lock:
                if self.state != LEADER or not self._pipe_ok.get(peer):
                    return
                if self._pipe_inflight.get(peer, 0) >= cfg.max_in_flight:
                    return      # window full; freed slots re-wake us
                term = self.current_term
                epoch = self._pipe_epoch.get(peer, 0)
                next_idx = self._pipe_next.get(
                    peer, 0) or self.next_index.get(
                        peer, self.log.last_index() + 1)
                if next_idx <= self.log.base_index():
                    # compacted past the peer: InstallSnapshot stays
                    # serial — drain and let the sync path take over
                    self._pipe_drain_locked(peer)
                    self._wake_peer(peer)
                    return
                prev_index = next_idx - 1
                prev_term = self.log.term_at(prev_index)
                if prev_term is None:
                    self._pipe_drain_locked(peer)
                    self._wake_peer(peer)
                    return
                entries = self.log.entries_from(
                    next_idx, cfg.max_append_entries)
                if not entries:
                    if self._pipe_inflight.get(peer, 0):
                        return  # in-flight batches double as heartbeats
                    break       # idle: sync heartbeat keeps the lease
                commit = self.commit_index
                seq = self._pipe_seq.get(peer, 0)
                self._pipe_seq[peer] = seq + 1
                self._pipe_inflight[peer] = (
                    self._pipe_inflight.get(peer, 0) + 1)
                self._pipe_next[peer] = entries[-1].index + 1
                self._pipe_batches += 1
                ctx = self._repl_trace_ctx
            req = {"term": term, "leader": self.id,
                   "prev_log_index": prev_index,
                   "prev_log_term": prev_term,
                   "entries": entries, "leader_commit": commit}
            threading.Thread(
                target=self._pipe_send,
                args=(peer, epoch, seq, req, ctx),
                daemon=True,
                name=f"raft-pipe-{self.id}-{peer}-{seq}",
            ).start()
        # fell through: nothing in flight and nothing to send — run an
        # idle heartbeat on the sync path (leadership + lease refresh)
        self._replicate_sync(peer)

    def _pipe_send(self, peer: str, epoch: int, seq: int, req: Dict,
                   ctx: Optional[Tuple[str, int]]) -> None:
        """One in-flight batch: transit outside every lock, then send
        through the peer's wire turnstile (strict sequence order —
        the ordered stream a real pipeline rides), then hand the
        response (None on any failure) to the in-order ack stage."""
        t_start = time.monotonic()
        resp = None
        stale = False
        try:
            # same replication seam as the sync path: injected
            # errors/latency are dropped or slow pipelined RPCs and
            # surface as a drain + sync retry. Runs BEFORE the
            # turnstile so in-flight transits overlap.
            fault("raft.replicate.send")
            with self._wire_cond:
                while (not self._shutdown.is_set()
                       and self._wire_epoch.get(peer, 0) == epoch
                       and self._wire_turn.get(peer, 0) != seq):
                    self._wire_cond.wait(0.05)
                stale = (self._shutdown.is_set()
                         or self._wire_epoch.get(peer, 0) != epoch)
            if not stale:
                # we OWN the turn until we bump it below: no later
                # batch can reach the transport before us, and the
                # turnstile lock itself is not held across the send
                try:
                    if req["entries"] and tracer.enabled:
                        if ctx is not None:
                            req["trace"] = ctx
                        with tracer.attach(ctx), \
                                tracer.span("raft.replicate"):
                            resp = self.transport.send(
                                peer, "append_entries", req)
                    else:
                        resp = self.transport.send(
                            peer, "append_entries", req)
                finally:
                    with self._wire_cond:
                        if self._wire_epoch.get(peer, 0) == epoch:
                            self._wire_turn[peer] = seq + 1
                        self._wire_cond.notify_all()
        except (ConnectionError, FaultError):
            resp = None
        except Exception as e:                      # noqa: BLE001
            LOG.debug("%s: pipelined send to %s failed: %s",
                      self.id, peer, e)
            resp = None
        self._pipe_ack(peer, epoch, seq, req, resp, t_start)

    def _pipe_ack(self, peer: str, epoch: int, seq: int, req: Dict,
                  resp: Optional[Dict], t_start: float) -> None:
        """Process one batch's ack IN SEND ORDER: wait for our turn,
        then run the exact synchronous success/failure bookkeeping.
        A failed or out-of-term ack drains the window — every batch
        behind it is discarded (their acks become stale-epoch no-ops)
        and the peer falls back to the sync path."""
        entries = req["entries"]
        lag_s = None
        ok = False
        refill = False
        with self._lock:
            while (not self._shutdown.is_set()
                   and self._pipe_epoch.get(peer, 0) == epoch
                   and self._pipe_ack_turn.get(peer, 0) != seq):
                self._pipe_cond.wait(0.1)
            if (self._shutdown.is_set()
                    or self._pipe_epoch.get(peer, 0) != epoch):
                # drained while we waited: the window was reset; the
                # follower may have appended anyway — duplicates are
                # idempotent on the sync retry
                self._pipe_cond.notify_all()
                return
            self._pipe_ack_turn[peer] = seq + 1
            self._pipe_inflight[peer] = max(
                0, self._pipe_inflight.get(peer, 0) - 1)
            self._pipe_cond.notify_all()
            if self.state != LEADER or self.current_term != req["term"]:
                self._pipe_drain_locked(peer)
                return
            if resp is None:
                self._pipe_drain_locked(peer)
                self._wake_peer(peer)
                return
            if resp["term"] > self.current_term:
                self._pipe_drain_locked(peer)
                self._step_down_locked(resp["term"])
                return
            self.peer_last_contact[peer] = time.monotonic()
            self._note_lease_contact_locked(peer, t_start)
            if resp.get("success"):
                ok = True
                newest = entries[-1].index
                stamp = self._append_stamps.get(newest)
                if stamp is not None:
                    lag_s = time.monotonic() - stamp
                    self._obs_pending.append((RAFT_REPLICATION, lag_s))
                if newest > self.match_index.get(peer, 0):
                    self.match_index[peer] = newest
                if newest + 1 > self.next_index.get(peer, 0):
                    self.next_index[peer] = newest + 1
                self._advance_commit_locked()
                self._maybe_drop_snapshot_cache_locked()
                frontier = self._pipe_next.get(
                    peer, 0) or self.next_index.get(peer, 0)
                if frontier <= self.log.last_index():
                    refill = True
            else:
                # conflict: resolution is SERIAL by design — back off
                # next_index with the hint, drain, go sync
                hint = resp.get("conflict_index")
                self.next_index[peer] = max(
                    1, hint if hint else self.next_index.get(peer, 2) - 1)
                self._pipe_drain_locked(peer)
                self._wake_peer(peer)
                return
        if ok:
            raft_observer.note_replicated(
                self.id, peer, len(entries),
                lag_ms=round(lag_s * 1e3, 3) if lag_s is not None
                else None)
        self._obs_flush()
        if refill:
            self._wake_peer(peer)

    def _wake_peer(self, peer: str) -> None:
        with self._lock:
            wake = self._peer_wakes.get(peer)
        if wake is not None:
            wake.set()

    def _pipe_drain_locked(self, peer: str) -> None:
        """Reset the peer's window (caller holds self._lock): bump the
        epoch so in-flight acks discard themselves, zero the sequence
        counters, disarm — the next contact goes through the sync path
        and re-arms on success."""
        self._pipe_epoch[peer] = self._pipe_epoch.get(peer, 0) + 1
        self._pipe_seq[peer] = 0
        self._pipe_ack_turn[peer] = 0
        self._pipe_inflight[peer] = 0
        self._pipe_next.pop(peer, None)
        if self._pipe_ok.get(peer):
            self._pipe_drains += 1
        self._pipe_ok[peer] = False
        self._pipe_cond.notify_all()
        # release wire-turnstile waiters: they see the epoch move and
        # discard without sending (raft_node -> raft_pipe_wire is the
        # only edge between these locks; senders never take self._lock
        # while holding the turnstile)
        with self._wire_cond:
            self._wire_epoch[peer] = self._pipe_epoch[peer]
            self._wire_turn[peer] = 0
            self._wire_cond.notify_all()

    def _pipe_drain_all_locked(self) -> None:
        for p in self.peers:
            self._pipe_drain_locked(p)

    # --- leader lease ---------------------------------------------------

    def _note_lease_contact_locked(self, peer: str, t_start: float) -> None:
        """Record an acked RPC's SEND-start stamp (monotone per peer)."""
        if t_start > self._lease_contact.get(peer, 0.0):
            self._lease_contact[peer] = t_start

    def _lease_window(self) -> float:
        return (self.config.election_timeout_min
                * self.config.lease_fraction)

    def _lease_quorum_stamp_locked(self) -> Optional[float]:
        """The send stamp at which a quorum (self + enough peers) had
        acked — the lease extends ``_lease_window()`` past it. None
        when no quorum of peers has ever acked this leadership."""
        if not self.peers:
            return time.monotonic()
        need = (len(self.peers) + 1) // 2   # peers needed beyond self
        if need == 0:
            return time.monotonic()
        stamps = sorted((self._lease_contact.get(p, 0.0)
                         for p in self.peers), reverse=True)
        stamp = stamps[need - 1]
        return stamp if stamp > 0.0 else None

    def lease_valid(self) -> bool:
        """True while this leader's clock-based lease holds: a quorum
        of AppendEntries acks with send stamps within
        ``election_timeout_min * lease_fraction``. While True,
        leader-side linearizable reads may skip the barrier round-trip
        (server.py linearizable_read); on False they demote to the
        leader barrier. Never true off-leader or with leases off."""
        with self._lock:
            return self._lease_valid_locked()

    def _lease_valid_locked(self) -> bool:
        if self.state != LEADER or not self.config.leader_lease:
            return False
        stamp = self._lease_quorum_stamp_locked()
        if stamp is None:
            return False
        return time.monotonic() - stamp <= self._lease_window()

    def note_lease_read(self, fast: bool) -> None:
        """Server-side accounting: a linearizable read served off the
        lease fast path (True) or demoted to the barrier (False). A
        held->lapsed transition lands one ``lease_expired`` event in
        the consensus timeline (raft/observe.py) so chaos cells can
        line lease loss up against partitions and elections."""
        expired_term = None
        with self._lock:
            if fast:
                self._lease_reads_fast += 1
                self._lease_was_valid = True
            else:
                self._lease_reads_barrier += 1
                if self._lease_was_valid:
                    self._lease_was_valid = False
                    expired_term = self.current_term
        if expired_term is not None:
            raft_observer.note_event(
                self.id, "lease_expired", term=expired_term)

    def _build_snapshot_req_locked(self) -> Dict:
        # the request carries the CACHE's own (index, term) — never
        # pair base_index with possibly-newer cache bytes (a capture
        # racing a replicator between cache-set and compact would
        # otherwise ship state@applied labeled as state@base, and the
        # follower would re-apply the span in between twice)
        index, term, data = self._snapshot_cache
        return {
            "term": self.current_term,
            "leader": self.id,
            "last_index": index,
            "last_term": term,
            "data": data,
        }

    def _load_disk_snapshot_cache(self) -> bool:
        """Re-arm the in-memory snapshot cache from the newest on-disk
        snapshot file when it covers the compacted base. Returns True
        when the cache is usable afterward."""
        if self._snapshots is None:
            return False
        snap = self._snapshots.load_newest()
        if snap is None:
            return False
        with self._lock:
            if snap[0] < self.log.base_index():
                return False     # disk older than the base: re-force
            self._snapshot_cache = snap
            self._note_snapshot_cache_locked()
        return True

    def _maybe_drop_snapshot_cache_locked(self) -> None:
        """The cache was unbounded and unmetered.
        Once every peer's match index covers the base, no lagging
        follower can need it — drop the bytes (the on-disk file, or a
        fresh force, serves any later straggler)."""
        if self._snapshot_cache is None:
            return
        base = self.log.base_index()
        if all(self.match_index.get(p, 0) >= base for p in self.peers):
            self._snapshot_cache = None
            self._note_snapshot_cache_locked()

    def _advance_commit_locked(self) -> None:
        """Majority match with current-term guard (Raft section 5.4.2)."""
        matches = sorted(self.match_index.values(), reverse=True)
        n_voters = len(self.peers) + 1
        majority_idx = matches[n_voters // 2] if len(matches) >= n_voters else 0
        if majority_idx > self.commit_index:
            term_at = self.log.term_at(majority_idx)
            if term_at == self.current_term:
                self.commit_index = majority_idx
                # quorum latency = leader append -> majority commit;
                # sampled at the advancing index, recorded outside
                # this lock by whichever caller flushes next
                stamp = self._append_stamps.get(majority_idx)
                if stamp is not None:
                    self._obs_pending.append(
                        (RAFT_QUORUM, time.monotonic() - stamp))
                self._apply_cond.notify_all()
        # prune stamps only once EVERY peer has acked them (and commit
        # has passed): the laggard's stamp must survive to its own ack
        # so the per-peer replication-lag sample and cluster_health's
        # LagMs measure the slowest peer, not just the majority
        floor = self.commit_index
        if self.peers:
            floor = min(min(self.match_index.get(p, 0)
                            for p in self.peers), floor)
        if floor > self._stamp_floor:
            for idx in [i for i in self._append_stamps if i <= floor]:
                del self._append_stamps[idx]
            self._stamp_floor = floor

    def _obs_flush(self) -> None:
        """Record the latency samples the locked sections collected.
        Called OUTSIDE self._lock; histogram records are the always-on
        O(µs) budget, the quorum waterfall span only exists when
        tracing is on."""
        with self._lock:
            if len(self._append_stamps) > 4096:
                # a dead peer pins the min-match prune floor; shed the
                # oldest stamps but keep the live tail so quorum and
                # healthy-peer ack samples survive the guard. Runs
                # BEFORE the empty-pending bail: a leader without
                # quorum collects no samples at all, which is exactly
                # when stamps grow unboundedly
                for idx in sorted(self._append_stamps)[:-1024]:
                    del self._append_stamps[idx]
            if not self._obs_pending:
                return
            pending, self._obs_pending = self._obs_pending, []
        enabled = tracer.enabled
        for op, dur in pending:
            histograms.get(op).record(dur)
            if enabled and op == RAFT_QUORUM:
                # retroactive leaf record: the waterfall claims it by
                # overlap with the eval's commit window
                tracer.record("raft.quorum", dur)

    # --- apply loop -----------------------------------------------------

    #: committed entries drained per apply wakeup — bounds one batch's
    #: future-response burst and event list during post-restart catch-up
    _APPLY_BATCH_MAX = 1024

    def _run_apply(self) -> None:
        """Batched apply drain: each wakeup takes the FULL
        committed-but-unapplied range (capped) and applies it as ONE
        batch — one _fsm_lock span, and (through fsm_apply_batch) one
        store write-txn root swap + one event-stream publish stamp —
        instead of the seed's per-entry lock/notify churn."""
        while not self._shutdown.is_set():
            with self._lock:
                if self.last_applied >= self.commit_index:
                    self._apply_cond.wait(0.2)
                if self._shutdown.is_set():
                    return
                if self.last_applied >= self.commit_index:
                    continue
                start = self.last_applied + 1
                end = min(self.commit_index,
                          start + self._APPLY_BATCH_MAX - 1)
                batch = [(i, self.log.get(i), self._futures.pop(i, None))
                         for i in range(start, end + 1)]
                barrier_term = self._leader_barrier_term
                is_leader = self.state == LEADER
            barrier_hit = self._apply_committed_batch(
                batch, barrier_term, is_leader)
            if barrier_hit:
                with self._lock:
                    self._leader_barrier_term = -1
                if self.on_leader is not None:
                    threading.Thread(
                        target=self.on_leader, daemon=True).start()
            self._maybe_snapshot()

    def _apply_committed_batch(self, batch, barrier_term: int,
                               is_leader: bool) -> bool:
        """Apply one committed range under ONE _fsm_lock hold.

        Contiguous runs of plain commands go through ``fsm_apply_batch``
        (one store root swap on the other side) when wired, else
        per-entry ``fsm_apply`` inside the same hold. Membership
        changes and noops break runs and apply inline, preserving
        strict log order. Futures respond AFTER the lock drops.
        Returns whether the leadership barrier noop applied."""
        barrier_hit = False
        responses: List[Tuple[Optional[_ApplyFuture], Any,
                              Optional[Exception]]] = []
        with self._fsm_lock:
            with self._lock:
                frontier = self.last_applied
            run: List[Tuple[str, Dict]] = []
            run_futs: List[Optional[_ApplyFuture]] = []

            def flush_run() -> None:
                if not run:
                    return
                if self.fsm_apply_batch is not None:
                    # raft-apply is the waterfall envelope around the
                    # FSM's own fsm.apply span (leaf-out: fsm claims
                    # first, this span keeps the dispatch residue)
                    with tracer.span("raft.apply"):
                        try:
                            results = self.fsm_apply_batch(list(run))
                        except Exception as e:      # noqa: BLE001
                            # the batch doorway contains per-entry
                            # failures itself; anything escaping it
                            # must not kill the apply loop
                            results = [(None, e)] * len(run)
                else:
                    results = []
                    with tracer.span("raft.apply"):
                        for msg_type, req in run:
                            try:
                                results.append(
                                    (self.fsm_apply(msg_type, req), None))
                            except Exception as e:  # noqa: BLE001
                                results.append((None, e))
                for fut, (result, error) in zip(run_futs, results):
                    if error is not None:
                        LOG.warning("%s: FSM apply failed: %s",
                                    self.id, error)
                    responses.append((fut, result, error))
                run.clear()
                run_futs.clear()

            applied_to = frontier
            for index, entry, fut in batch:
                if index <= frontier:
                    # a snapshot install moved the applied frontier
                    # while this batch waited on _fsm_lock: the
                    # restored state already CONTAINS these entries —
                    # applying them now would double-apply
                    if fut is not None:
                        responses.append((fut, None, None))
                    continue
                applied_to = index
                if entry is None:
                    continue
                if entry.kind == LOG_COMMAND:
                    msg_type, req = entry.data
                    if msg_type in (RAFT_REMOVE_PEER, RAFT_ADD_PEER):
                        # replicated membership change: applied on
                        # every replica at the same log position —
                        # flush first so log order is preserved
                        flush_run()
                        try:
                            if msg_type == RAFT_REMOVE_PEER:
                                self._apply_remove_peer(req["peer"])
                            else:
                                self._apply_add_peer(req["peer"])
                            responses.append((fut, index, None))
                        except Exception as e:      # noqa: BLE001
                            LOG.warning(
                                "%s: FSM apply %s failed: %s",
                                self.id, msg_type, e)
                            responses.append((fut, None, e))
                        continue
                    # committed-entry apply seam, fired per entry as
                    # the run assembles. NOTE: error injection here on
                    # a REPLICATED cluster diverges replicas (the
                    # entry applies on the others) — the reference
                    # panics for the same reason; chaos schedules use
                    # latency only on clusters, errors only
                    # single-server (docs/ROBUSTNESS.md)
                    try:
                        fault("raft.fsm.apply")
                    except Exception as e:          # noqa: BLE001
                        LOG.warning("%s: FSM apply %s failed: %s",
                                    self.id, msg_type, e)
                        responses.append((fut, None, e))
                        continue
                    run.append((msg_type, req))
                    run_futs.append(fut)
                    continue
                # noop (possibly the leadership barrier)
                if (entry.kind == LOG_NOOP and is_leader
                        and entry.term == barrier_term):
                    barrier_hit = True
                if fut is not None:
                    responses.append((fut, None, None))
            flush_run()
            with self._lock:
                if applied_to > self.last_applied:
                    self.last_applied = applied_to
        for fut, result, error in responses:
            if fut is not None:
                fut.respond(result, error)
        return barrier_hit

    # --- snapshots ------------------------------------------------------

    #: (index, term, data) of the newest captured snapshot — the index
    #: pairing travels WITH the bytes (see _build_snapshot_req_locked)
    _snapshot_cache: Optional[Tuple[int, int, bytes]] = None

    def _maybe_snapshot(self) -> None:
        if self.snapshot_fn is None:
            return
        with self._lock:
            applied = self.last_applied
            base = self.log.base_index()
        if applied - base < self.config.snapshot_threshold:
            return
        self.force_snapshot()

    def force_snapshot(self) -> None:
        """Operator snapshot (nomad /v1/operator/snapshot analog).

        Holding _fsm_lock quiesces the apply loop so the captured bytes
        are exactly the state at last_applied -- compacting to any other
        index would lose or double-apply entries on restore.

        Durable order: snapshot FILE first, then the WAL
        compact record, then superseded-segment deletion — a crash at
        any seam recovers from the newer of (previous snapshot + full
        WAL) or (new snapshot + suffix)."""
        if self.snapshot_fn is None:
            return
        with self._fsm_lock:
            with self._lock:
                applied = self.last_applied
            data = self.snapshot_fn()
            with self._lock:
                term = self.log.term_at(applied) or self.current_term
                self._snapshot_cache = (applied, term, data)
                self._note_snapshot_cache_locked()
            if self._snapshots is not None:
                self._snapshots.save(applied, term, data)
            self.log.compact_to(applied, term)
        self.log.persist()

    # --- RPC handlers ---------------------------------------------------

    def _handle_rpc(self, method: str, req: Dict) -> Dict:
        if not self._ready:
            if method == "request_vote":
                return {"term": 0, "granted": False}
            raise ConnectionError(f"{self.id} is still recovering")
        if method == "request_vote":
            return self._on_request_vote(req)
        if method == "append_entries":
            return self._on_append_entries(req)
        if method == "install_snapshot":
            return self._on_install_snapshot(req)
        if method == "forward_apply":
            return self._on_forward_apply(req)
        if method == "read_index":
            return self._on_read_index(req)
        raise ValueError(f"unknown raft RPC {method}")

    def _on_request_vote(self, req: Dict) -> Dict:
        with self._lock:
            if (self.config.leader_lease
                    and self.state == FOLLOWER
                    and self.leader_id is not None
                    and req["candidate"] != self.leader_id
                    and time.monotonic() - self._last_contact
                    < self.config.election_timeout_min):
                # lease-safety half of the leader lease (raft §6 /
                # CheckQuorum): while this follower heard its leader
                # within election_timeout_min it refuses votes WITHOUT
                # adopting the candidate's term — otherwise any
                # partitioned rejoiner could depose a leader whose
                # clock lease (a strict fraction of this window) is
                # still live, and a lease-read would go stale
                return {"term": self.current_term, "granted": False}
            if req["term"] > self.current_term:
                self._step_down_locked(req["term"])
            granted = False
            # a candidate this replica knows was removed from the
            # voting set cannot get our vote (post-removal rejoin guard)
            known_voter = req["candidate"] in self.peers
            if known_voter and req["term"] == self.current_term and (
                self.voted_for is None or self.voted_for == req["candidate"]
            ):
                # candidate's log must be at least as up-to-date
                my_last_term = self.log.last_term()
                my_last_index = self.log.last_index()
                if (req["last_log_term"], req["last_log_index"]) >= (
                    my_last_term, my_last_index,
                ):
                    granted = True
                    self.voted_for = req["candidate"]
                    self._last_contact = time.monotonic()
                    # the vote is durable BEFORE the grant leaves: a
                    # crash after responding must restart remembering
                    # who this term's vote went to
                    self._persist_hard_state_locked()
            return {"term": self.current_term, "granted": granted}

    def _on_append_entries(self, req: Dict) -> Dict:
        if req.get("entries") and tracer.enabled:
            # adopt the leader-shipped trace context so this
            # follower's spans land in the originating eval's tree —
            # the cross-server propagation
            with tracer.attach(req.get("trace")), \
                    tracer.span("raft.follower.append"):
                return self._append_entries_observed(req)
        return self._append_entries_observed(req)

    def _append_entries_observed(self, req: Dict) -> Dict:
        t0 = time.monotonic() if req.get("entries") else 0.0
        with self._lock:
            resp, dirty = self._append_entries_locked(req)
        if dirty:
            # the success ack PROMISES the appended/truncated suffix
            # survives a crash: group-fsync before it leaves (outside
            # the lock — an fsync must not stall the RPC plane).
            # Heartbeats and rejections stay fsync-free.
            self._sync_log()
        if t0:
            # follower append handling incl. its group fsync: the
            # always-on distribution + the consensus flight recorder
            dur = time.monotonic() - t0
            histograms.get(RAFT_APPEND).record(dur)
            consensus_recorder.observe(
                RAFT_APPEND, dur, server_id=self.id,
                trace_id=(req.get("trace") or ("",))[0])
        return resp

    def _append_entries_locked(self, req: Dict) -> Tuple[Dict, bool]:
        if req["term"] < self.current_term:
            return {"term": self.current_term, "success": False}, False
        if req["term"] > self.current_term or self.state != FOLLOWER:
            self._step_down_locked(req["term"])
        self.current_term = req["term"]
        self.leader_id = req["leader"]
        self._last_contact = time.monotonic()

        prev_index = req["prev_log_index"]
        prev_term = req["prev_log_term"]
        if prev_index > 0:
            local_term = self.log.term_at(prev_index)
            if local_term is None:
                return {
                    "term": self.current_term, "success": False,
                    "conflict_index": self.log.last_index() + 1,
                }, False
            if local_term != prev_term:
                return {
                    "term": self.current_term, "success": False,
                    "conflict_index": max(1, prev_index - 1),
                }, False
        dirty = False
        for entry in req["entries"]:
            local = self.log.get(entry.index)
            if local is not None and local.term != entry.term:
                self.log.truncate_from(entry.index)
                local = None
                dirty = True
            if local is None:
                if self.log.last_index() + 1 == entry.index:
                    self.log.append(entry)
                    dirty = True
                # else: gap; leader will back off via conflict_index
        # commit may only advance to the last entry VERIFIED by this
        # batch -- a stale uncommitted tail beyond it must not be
        # applied (Raft figure 2: min(leaderCommit, index of last
        # new entry))
        last_verified = (
            req["entries"][-1].index if req["entries"] else prev_index
        )
        if req["leader_commit"] > self.commit_index:
            new_commit = min(req["leader_commit"], last_verified)
            if new_commit > self.commit_index:
                self.commit_index = new_commit
                self._apply_cond.notify_all()
        return {"term": self.current_term, "success": True}, dirty

    def _on_install_snapshot(self, req: Dict) -> Dict:
        with self._lock:
            if req["term"] < self.current_term:
                return {"term": self.current_term}
            self._step_down_locked(req["term"])
            self.current_term = req["term"]
            self.leader_id = req["leader"]
            self._last_contact = time.monotonic()
            if req["data"] is None:
                # never wipe local state for an empty snapshot
                return {"term": self.current_term}
        raft_observer.note_snapshot_xfer(
            self.id, "received", len(req["data"]))
        raft_observer.note_event(
            self.id, "snapshot_install", term=req["term"],
            index=req["last_index"])
        if self._snapshots is not None:
            # the multi-MB durable file write runs OUTSIDE self._lock
            # (an fsync must not stall the RPC/ticker plane) and disk
            # lands BEFORE the log compaction: a crash in between
            # recovers from this file plus the uncompacted WAL; the
            # reverse order is the seed's unrecoverable
            # compacted-log-without-snapshot state
            self._snapshots.save(
                req["last_index"], req["last_term"], req["data"])
        # _fsm_lock quiesces the apply loop for the whole swap (the
        # force_snapshot lock order); restore + compact + truncate +
        # counter updates are ONE section under self._lock — the
        # re-validate, the restore, and the log surgery must be atomic
        # against a concurrent AppendEntries from a newer leader, or
        # the truncate could delete an entry the append already
        # counted into commit_index (the apply loop would then skip it
        # silently — replica divergence). The restore/compact cost
        # under the raft lock is the pre-existing trade on this rare
        # path; the multi-MB file save above stays outside.
        with self._fsm_lock:
            with self._lock:
                # re-validate after the unlocked write: a newer term
                # may have arrived, or this snapshot may be STALE
                # (local state already at/past it — restoring would
                # rewind the FSM); the file above is kept either way
                if req["term"] < self.current_term:
                    return {"term": self.current_term}
                if req["last_index"] <= max(self.log.base_index(),
                                            self.last_applied):
                    return {"term": self.current_term}
                if self.restore_fn is not None:
                    self.restore_fn(req["data"])
                self.log.compact_to(req["last_index"], req["last_term"])
                self.log.truncate_from(req["last_index"] + 1)
                if req["last_index"] > self.commit_index:
                    self.commit_index = req["last_index"]
                self.last_applied = req["last_index"]
                resp = {"term": self.current_term}
        self._sync_log()
        return resp

    def _on_forward_apply(self, req: Dict) -> Dict:
        """Leader-side handler for follower-forwarded applies
        (rpc.go:537 forwarding). request_id gives at-most-once: a retry
        after a dropped response returns the cached result instead of
        re-applying."""
        request_id = req.get("request_id")
        if request_id is not None:
            with self._lock:
                if request_id in self._forward_results:
                    return {"ok": True, "result": self._forward_results[request_id]}
        try:
            ctx = req.get("trace")
            if ctx is not None and tracer.enabled:
                # forwarded applies keep the origin server's trace id:
                # the leader-side spans (fsync/quorum/apply) join the
                # forwarding eval's tree
                with tracer.attach(tuple(ctx)), \
                        tracer.span("raft.forward.apply"):
                    result = self.apply(req["msg_type"], req["req"],
                                        timeout=10.0)
            else:
                result = self.apply(req["msg_type"], req["req"],
                                    timeout=10.0)
        except NotLeaderError as e:
            return {"ok": False, "not_leader": True, "leader": e.leader}
        if request_id is not None:
            with self._lock:
                self._forward_results[request_id] = result
                self._forward_order.append(request_id)
                while len(self._forward_order) > 1024:
                    self._forward_results.pop(self._forward_order.pop(0), None)
        return {"ok": True, "result": result}

    def _on_read_index(self, req: Dict) -> Dict:
        """Leader-side half of the ReadIndex fence (raft §6.4,
        server/readplane.py): confirm we are STILL leader —
        via the lease when it holds, via a committed barrier when it
        lapsed — then vouch for the current commit index. The
        forwarding follower waits for its own apply loop to reach that
        index and serves locally; only the fence crosses the wire."""
        with self._lock:
            if self.state != LEADER:
                return {"ok": False, "not_leader": True,
                        "leader": self.leader_id}
            leased = self._lease_valid_locked()
            index = self.commit_index
            term = self.current_term
        if not leased:
            try:
                self.barrier()
            except NotLeaderError as e:
                return {"ok": False, "not_leader": True,
                        "leader": e.leader}
            with self._lock:
                if self.state != LEADER:
                    return {"ok": False, "not_leader": True,
                            "leader": self.leader_id}
                index = self.commit_index
                term = self.current_term
        return {"ok": True, "index": index, "term": term,
                "leader": self.id}

    def forward_apply(self, msg_type: str, req: Dict, timeout: float = 10.0) -> Any:
        """Follower-side: route an apply to the current leader."""
        import uuid
        request_id = str(uuid.uuid4())   # stable across retries
        deadline = time.time() + timeout
        while time.time() < deadline:
            leader = self.leader_addr()
            if leader is None or leader == self.id:
                if self.is_leader():
                    return self.apply(msg_type, req, timeout)
                time.sleep(0.05)
                continue
            fwd = {"msg_type": msg_type, "req": req,
                   "request_id": request_id}
            if tracer.enabled:
                ctx = tracer.context()
                if ctx is not None:
                    fwd["trace"] = ctx
            try:
                resp = self.transport.send(
                    leader, "forward_apply", fwd,
                    timeout=timeout,
                )
            except ConnectionError:
                time.sleep(0.05)
                continue
            if resp.get("ok"):
                return resp["result"]
            time.sleep(0.05)
        raise TimeoutError("could not reach a leader")

    def stats(self) -> Dict:
        with self._lock:
            return {
                "state": self.state,
                "term": self.current_term,
                "leader": self.leader_id,
                "commit_index": self.commit_index,
                "last_applied": self.last_applied,
                "last_log_index": self.log.last_index(),
            }

    # --- consensus-plane observability ----------------------------------

    def observe_gauges(self) -> Dict:
        """Live gauges for the observer's per-server snapshot (the
        exporter's ``server_id``-labeled series)."""
        now = time.monotonic()
        with self._lock:
            last_log = self.log.last_index()
            leader = self.state == LEADER
            lease_stamp = (self._lease_quorum_stamp_locked()
                           if leader else None)
            return {
                "state": self.state,
                "is_leader": 1 if leader else 0,
                "term": self.current_term,
                "commit_index": self.commit_index,
                "last_applied": self.last_applied,
                "last_log_index": last_log,
                "peer_lag_entries": {
                    p: last_log - self.match_index.get(p, 0)
                    for p in self.peers
                } if leader else {},
                "peer_last_contact_s": {
                    p: round(now - self.peer_last_contact[p], 3)
                    for p in self.peers if p in self.peer_last_contact
                },
                # pipeline window health
                "pipeline_inflight": {
                    p: self._pipe_inflight.get(p, 0)
                    for p in self.peers
                } if leader else {},
                # _pipe_ok is recorded even at max_in_flight=1 (the
                # sync path arms it; the dispatcher just never asks) —
                # the gauge reports 0 unless the window is enabled
                "pipeline_armed": sum(
                    1 for p in self.peers if self._pipe_ok.get(p))
                if leader and self.config.max_in_flight > 1 else 0,
                "pipeline_batches": self._pipe_batches,
                "pipeline_drains": self._pipe_drains,
                # leader lease
                "lease_valid": 1 if self._lease_valid_locked() else 0,
                "lease_age_s": round(now - lease_stamp, 4)
                if lease_stamp is not None else None,
                "lease_reads_fast": self._lease_reads_fast,
                "lease_reads_barrier": self._lease_reads_barrier,
            }

    def cluster_health(self) -> Dict:
        """The autopilot-style per-peer view /v1/operator/
        cluster-health renders: this server's identity + raft state,
        and (leader-side) each peer's match index, entry/ms lag, and
        last-contact age. Lag in ms is the age of the oldest entry the
        peer has NOT acked — 0 when fully caught up, null when the
        age is UNKNOWN (this leader holds no stamp for that entry:
        inherited from a previous leader after failover, or shed by
        the growth guard) so a lagging peer can never read as
        "caught up in ms"."""
        now = time.monotonic()
        with self._lock:
            last_log = self.log.last_index()
            peers = []
            for p in self.peers:
                match = self.match_index.get(p, 0)
                lag_entries = max(last_log - match, 0)
                lag_ms: Optional[float] = 0.0
                if lag_entries and self.state == LEADER:
                    stamp = self._append_stamps.get(match + 1)
                    lag_ms = round((now - stamp) * 1e3, 3) \
                        if stamp is not None else None
                contact = self.peer_last_contact.get(p)
                contact_ms = round((now - contact) * 1e3, 3) \
                    if contact is not None else None
                peers.append({
                    "Id": p,
                    "MatchIndex": match,
                    "LagEntries": lag_entries,
                    "LagMs": lag_ms,
                    "LastContactMs": contact_ms,
                    "Healthy": bool(
                        contact is not None
                        and now - contact
                        < 10 * self.config.heartbeat_interval
                        and lag_entries < 1024),
                })
            return {
                "ServerId": self.id,
                "State": self.state,
                "Term": self.current_term,
                "Leader": self.id if self.state == LEADER
                else self.leader_id,
                "CommitIndex": self.commit_index,
                "LastApplied": self.last_applied,
                "LastLogIndex": last_log,
                "Peers": peers,
            }

    # --- membership + health (autopilot's raft surface) -----------------

    def add_peer(self, peer: str) -> None:
        """Replicated membership addition (raft AddVoter; the serf
        member-join -> addRaftPeer flow, reference leader.go:1182):
        commits a config-change entry so every replica starts
        replicating to the new server at the same log position. The
        new server itself boots with the full peer set in its static
        config (agent server_join) and catches up via AppendEntries
        or InstallSnapshot. Same restart caveat as remove_peer:
        membership is re-derived from static config + gossip on
        process restart (a compaction past this entry does not replay
        it); the entry protects against failover amnesia within a
        process lifetime, and the membership layer re-adds live peers
        on its first gossip exchange after a restart."""
        self.apply(RAFT_ADD_PEER, {"peer": peer})

    def _apply_add_peer(self, peer: str) -> None:
        if peer == self.id:
            with self._lock:
                self._removed = False   # re-added after a removal
            return
        with self._lock:
            if peer in self.peers:
                return
            self.peers.append(peer)
            self.next_index[peer] = self.log.last_index() + 1
            self.match_index[peer] = 0
            self._peer_wakes[peer] = threading.Event()
            running = bool(self._threads) and not self._shutdown.is_set()
        if running:
            t = threading.Thread(
                target=self._run_peer_replicator, args=(peer,),
                daemon=True, name=f"raft-repl-{self.id}-{peer}",
            )
            self._threads.append(t)
            t.start()
        LOG.info("%s: added raft peer %s", self.id, peer)

    def remove_peer(self, peer: str) -> None:
        """Replicated membership change (raft RemoveServer; autopilot
        dead-server cleanup): commits a config-change entry through the
        log so every replica -- including a future leader -- drops the
        peer at the same position. Single-server changes only (no joint
        consensus), matching hashicorp/raft's RemoveServer. Note:
        membership is re-derived from static config on process restart;
        the entry protects against failover amnesia, not restarts."""
        self.apply(RAFT_REMOVE_PEER, {"peer": peer})

    def _apply_remove_peer(self, peer: str) -> None:
        if peer == self.id:
            # we were voted off the island: stop participating
            with self._lock:
                self._removed = True
                self.state = FOLLOWER
                self.peers = []
            LOG.info("%s: removed from the cluster by config change", self.id)
            return
        with self._lock:
            if peer not in self.peers:
                return
            self.peers.remove(peer)
            self.next_index.pop(peer, None)
            self.match_index.pop(peer, None)
            self.peer_last_contact.pop(peer, None)
            # stranded in-flight acks see the epoch bump and discard
            # (the bumped epoch entry itself stays so they CAN see it)
            self._pipe_drain_locked(peer)
            self._pipe_ok.pop(peer, None)
            self._lease_contact.pop(peer, None)
            wake = self._peer_wakes.pop(peer, None)
        if wake is not None:
            wake.set()
        LOG.info("%s: removed raft peer %s", self.id, peer)

    def server_health(self) -> List[Dict]:
        """Per-peer health view (autopilot ServerHealth): last contact
        age and log lag, leader's perspective."""
        now = time.monotonic()
        with self._lock:
            last_log = self.log.last_index()
            return [
                {
                    "id": p,
                    "last_contact_s": (
                        now - self.peer_last_contact[p]
                        if p in self.peer_last_contact else float("inf")
                    ),
                    "match_index": self.match_index.get(p, 0),
                    "log_lag": last_log - self.match_index.get(p, 0),
                }
                for p in self.peers
            ]
