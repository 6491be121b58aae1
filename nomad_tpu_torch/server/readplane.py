"""The follower read plane: consistency-mode routing.

PAPER.md layer 4's blocking-query machinery lets ANY Nomad server
answer reads with explicit staleness attribution, but until this PR
every read landed on the leader — the last single-node ceiling named
in ROADMAP open item 3. This module is the routing subsystem that
makes every server a read server. Three per-request modes, resolved
at the HTTP/RPC boundary (api/http.py ``_read``):

- **linearizable** — leader-only. Serve off a valid leader lease
  (a quorum of AppendEntries acks within
  ``lease_fraction * election_timeout_min``); on lapse, demote to the
  quorum barrier (a committed noop). A follower answers 503 with a
  leader hint — the mode's whole point is that no other server may
  answer.
- **default** — leader-preferred. The leader serves locally; a
  follower transparently *fences* the read against its known leader
  with the ReadIndex protocol (raft §6.4: the leader confirms it is
  still leader via lease-or-barrier and returns its commit index; the
  follower waits for its OWN apply loop to reach that index, then
  serves from its local MVCC root). One retry-on-election; a loud 503
  + leader hint when no leader is established. This ships the read
  *fence* across the wire, never the data — the response bytes come
  off the follower's lock-free root.
- **stale** — ``?stale=true`` / ``max_stale=<dur>``. ANY server
  answers from its own O(1) MVCC root, stamping
  ``X-Nomad-Last-Contact`` from the real replication-lag meter
  (follower-side leader-contact age cross-checked against the
  leader-attributed per-peer lag, raft/observe.py) and
  ``X-Nomad-Known-Leader``; when the measured staleness exceeds the
  caller's ``max_stale`` bound the read is rejected loudly (503)
  instead of silently serving old data.

Cost discipline: the leader fast path is one ``lease_valid()`` check
(one lock, one clock read) + one counter bump; the stale path adds
one monotonic subtraction. Only the follower default path pays a
network round-trip — and it is one tiny RPC per read, not the
response body.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from nomad_tpu_torch.telemetry.histogram import READ_STALENESS, histograms
from nomad_tpu_torch.utils.witness import witness_lock

__all__ = [
    "ReadPlane", "ReadContext", "ReadPlaneError", "NoLeaderError",
    "StaleReadError", "ReadStats", "read_stats",
    "MODE_LINEARIZABLE", "MODE_DEFAULT", "MODE_STALE",
]

MODE_LINEARIZABLE = "linearizable"
MODE_DEFAULT = "default"
MODE_STALE = "stale"

#: all modes the HTTP boundary may hand to ``ReadPlane.resolve``
MODES = (MODE_LINEARIZABLE, MODE_DEFAULT, MODE_STALE)


class ReadPlaneError(Exception):
    """A read the plane refuses to serve. Maps to HTTP 503 with the
    ``X-Nomad-Known-Leader`` hint (api/http.py) — loud by design: the
    caller must retry against the hinted leader or relax its
    consistency bound, never silently receive the wrong data."""

    def __init__(self, message: str, known_leader: str = "") -> None:
        super().__init__(message)
        self.known_leader = known_leader


class NoLeaderError(ReadPlaneError):
    """No leader is established (mid-election, partitioned) — the
    default/linearizable modes cannot be satisfied here and now."""


class StaleReadError(ReadPlaneError):
    """This server's replication lag exceeds the caller's
    ``max_stale`` bound: serving would violate the contract."""


class ReadStats:
    """Read-plane accounting: who served (role), which mode, how many
    follower reads forwarded their fence to the leader (and how many
    retried across an election or failed out), how many linearizable
    reads demoted from the lease fast path to the barrier, and how
    many stale reads were rejected over their bound. The fleet cell's
    ``fleet_read_*`` trend lines and the ``nomad_tpu_read_*`` series
    both read this one object."""

    __slots__ = ("_lock", "served", "modes", "forwards",
                 "forward_retries", "forward_failures", "demotions",
                 "lease_fast", "stale_rejects")

    def __init__(self) -> None:
        self._lock = witness_lock("readplane.ReadStats._lock")
        #: role -> reads served ("leader" / "follower")
        self.served: Dict[str, int] = {"leader": 0, "follower": 0}
        #: mode -> reads resolved (incl. rejected ones)
        self.modes: Dict[str, int] = {m: 0 for m in MODES}
        self.forwards = 0
        self.forward_retries = 0
        self.forward_failures = 0
        #: linearizable reads demoted lease -> barrier
        self.demotions = 0
        #: linearizable reads served off the lease fast path
        self.lease_fast = 0
        #: stale reads rejected over their max_stale bound
        self.stale_rejects = 0

    def note_request(self, mode: str) -> None:
        with self._lock:
            self.modes[mode] = self.modes.get(mode, 0) + 1

    def note_served(self, role: str, staleness_s: float = 0.0) -> None:
        with self._lock:
            self.served[role] = self.served.get(role, 0) + 1
        # staleness distribution: how far behind the leader the data
        # each read actually served was (0 on the leader). Lives in
        # the shared registry so telemetry.reset windows it and the
        # exporter ships it without bespoke plumbing.
        histograms.get(READ_STALENESS).record(staleness_s)

    def note_forward(self, retries: int = 0) -> None:
        with self._lock:
            self.forwards += 1
            self.forward_retries += retries

    def note_forward_failure(self) -> None:
        with self._lock:
            self.forward_failures += 1

    def note_demotion(self) -> None:
        with self._lock:
            self.demotions += 1

    def note_lease_fast(self) -> None:
        with self._lock:
            self.lease_fast += 1

    def note_stale_reject(self) -> None:
        with self._lock:
            self.stale_rejects += 1

    def snapshot(self) -> Dict:
        with self._lock:
            total = sum(self.served.values())
            follower = self.served.get("follower", 0)
            return {
                "served": dict(self.served),
                "modes": dict(self.modes),
                "forwards": self.forwards,
                "forward_retries": self.forward_retries,
                "forward_failures": self.forward_failures,
                "demotions": self.demotions,
                "lease_fast": self.lease_fast,
                "stale_rejects": self.stale_rejects,
                "follower_share": round(follower / total, 4)
                if total else 0.0,
            }

    def reset_stats(self) -> None:
        with self._lock:
            self.served = {"leader": 0, "follower": 0}
            self.modes = {m: 0 for m in MODES}
            self.forwards = 0
            self.forward_retries = 0
            self.forward_failures = 0
            self.demotions = 0
            self.lease_fast = 0
            self.stale_rejects = 0


#: process-wide (every Server's plane feeds it; windowed by
#: telemetry.reset like client_update_stats)
read_stats = ReadStats()


class ReadContext:
    """One resolved read: which role served it, against which store
    stamp, how stale, and where the leader is — everything the HTTP
    layer needs to stamp ``X-Nomad-Last-Contact`` /
    ``X-Nomad-Known-Leader`` and everything the cells assert on."""

    __slots__ = ("mode", "served_by", "known_leader", "last_contact_ms",
                 "generation", "index")

    def __init__(self, mode: str, served_by: str, known_leader: str,
                 last_contact_ms: float, generation: int,
                 index: int) -> None:
        self.mode = mode
        self.served_by = served_by
        self.known_leader = known_leader
        self.last_contact_ms = last_contact_ms
        self.generation = generation
        self.index = index


class ReadPlane:
    """One server's consistency-mode router. Holds no state of its
    own beyond the server ref — every decision reads the raft node's
    live lease/leader/contact state so a resolution is always against
    the current term, never a cached one."""

    #: read-fence RPC budget: one leader round-trip is sub-ms on the
    #: in-memory transport; 2s absorbs a full election in between
    FORWARD_TIMEOUT_S = 2.0
    #: how long a fenced follower read waits for its own apply loop to
    #: reach the leader's commit index before failing loudly
    APPLY_WAIT_S = 5.0

    def __init__(self, server) -> None:
        self.server = server

    # --- staleness attribution ------------------------------------------

    def role(self) -> str:
        raft = self.server.raft
        if raft is None or raft.is_leader():
            return "leader"
        return "follower"

    def known_leader(self) -> str:
        raft = self.server.raft
        if raft is None:
            return self.server.config.name
        return raft.leader_addr() or ""

    def last_contact_s(self) -> float:
        """How stale this server's state may be, in seconds: the age
        of the last leader contact this follower observed (raft
        AppendEntries receipt), cross-checked against the newest
        leader-attributed replication lag for this server
        (raft/observe.py ``staleness_ms``) — whichever meter reads
        WORSE wins, so the stamp can overstate staleness but never
        understate it. 0.0 on the leader (its store IS the state)."""
        raft = self.server.raft
        if raft is None:
            return 0.0
        own = raft.last_contact_s()
        if own == 0.0:
            return 0.0          # leader
        from nomad_tpu_torch.raft.observe import raft_observer

        attributed_ms = raft_observer.staleness_ms(raft.id)
        if attributed_ms is not None:
            own = max(own, attributed_ms / 1e3)
        return own

    # --- mode resolution ------------------------------------------------

    def resolve(self, mode: str,
                max_stale: Optional[float] = None) -> ReadContext:
        """Route one read through its consistency mode. Returns the
        stamped :class:`ReadContext` once this server's LOCAL store is
        cleared to answer; raises :class:`ReadPlaneError` when it is
        not. The caller takes its serving snapshot AFTER this returns
        (the fence orders the store, the snapshot is then O(1))."""
        if mode not in MODES:
            raise ValueError(f"unknown consistency mode {mode!r}")
        read_stats.note_request(mode)
        if mode == MODE_STALE:
            return self._resolve_stale(max_stale)
        if mode == MODE_LINEARIZABLE:
            return self._resolve_linearizable()
        return self._resolve_default()

    def _ctx(self, mode: str, staleness_s: float) -> ReadContext:
        role = self.role()
        generation, index = self.server.state.read_stamp()
        read_stats.note_served(role, staleness_s)
        return ReadContext(
            mode=mode,
            served_by=role,
            known_leader=self.known_leader(),
            last_contact_ms=round(staleness_s * 1e3, 3),
            generation=generation,
            index=index,
        )

    def _resolve_stale(self, max_stale: Optional[float]) -> ReadContext:
        staleness = self.last_contact_s()
        if max_stale is not None and staleness > max_stale:
            read_stats.note_stale_reject()
            raise StaleReadError(
                f"state is {staleness * 1e3:.0f}ms stale, over the "
                f"max_stale bound of {max_stale * 1e3:.0f}ms",
                known_leader=self.known_leader())
        return self._ctx(MODE_STALE, staleness)

    def _resolve_linearizable(self) -> ReadContext:
        from nomad_tpu_torch.raft.node import NotLeaderError

        raft = self.server.raft
        if raft is None:
            # single-process authority: the local store IS the state
            return self._ctx(MODE_LINEARIZABLE, 0.0)
        if not raft.is_leader():
            raise NoLeaderError(
                "linearizable reads are leader-only",
                known_leader=self.known_leader())
        if raft.lease_valid():
            raft.note_lease_read(True)
            read_stats.note_lease_fast()
            return self._ctx(MODE_LINEARIZABLE, 0.0)
        # lease lapsed: demote to the quorum barrier — the pre-lease
        # linearizable path. A deposed leader fails HERE instead of
        # serving off a dead lease.
        raft.note_lease_read(False)
        read_stats.note_demotion()
        try:
            raft.barrier()
        except NotLeaderError as e:
            raise NoLeaderError(
                "deposed during linearizable barrier",
                known_leader=e.leader or "")
        return self._ctx(MODE_LINEARIZABLE, 0.0)

    def _resolve_default(self) -> ReadContext:
        raft = self.server.raft
        if raft is None or raft.is_leader():
            return self._ctx(MODE_DEFAULT, 0.0)
        index = self._forward_read_index()
        self._wait_applied(index)
        # fenced: local state now covers everything committed at the
        # moment the leader confirmed leadership — staleness stamp is
        # whatever contact age remains (informational; the fence
        # already ordered this read after the commit frontier)
        return self._ctx(MODE_DEFAULT, self.last_contact_s())

    # --- the ReadIndex fence (server RPC forwarding) --------------------

    def _forward_read_index(self) -> int:
        """Ask the known leader for its commit index (the read fence).
        One retry-on-election: the first ``not_leader`` /
        ``ConnectionError`` answer re-resolves the leader and tries
        once more; anything past that is a loud failure — an unstable
        cluster must surface as 503s, not as reads quietly queueing
        behind elections forever."""
        raft = self.server.raft
        retries = 0
        last_leader = ""
        deadline = time.monotonic() + self.FORWARD_TIMEOUT_S
        while True:
            leader = raft.leader_addr()
            if leader == raft.id and raft.is_leader():
                # elected mid-resolution: serve as the leader would
                read_stats.note_forward(retries)
                return raft.commit_index
            if leader is None or leader == raft.id:
                if retries >= 1 or time.monotonic() >= deadline:
                    read_stats.note_forward_failure()
                    raise NoLeaderError("no leader established")
                retries += 1
                self._await_leader(deadline)
                continue
            last_leader = leader
            try:
                resp = raft.transport.send(
                    leader, "read_index", {},
                    timeout=self.FORWARD_TIMEOUT_S)
            except ConnectionError:
                resp = {"ok": False}
            if resp.get("ok"):
                read_stats.note_forward(retries)
                return resp["index"]
            if retries >= 1:
                read_stats.note_forward_failure()
                raise NoLeaderError(
                    "leader unreachable for read fence",
                    known_leader=resp.get("leader") or last_leader)
            retries += 1
            self._await_leader(deadline)

    def _await_leader(self, deadline: float) -> None:
        """Between the two fence attempts: give one election window
        for a leader to surface (poll, bounded by the deadline)."""
        raft = self.server.raft
        while time.monotonic() < deadline:
            leader = raft.leader_addr()
            if leader is not None and (leader != raft.id
                                       or raft.is_leader()):
                return
            time.sleep(0.01)

    def _wait_applied(self, index: int) -> None:
        """Block until the LOCAL apply loop reaches the fence index —
        the second half of ReadIndex. Fails loudly rather than serving
        state behind the index the leader vouched for."""
        state = self.server.state
        if state.latest_index() >= index:
            return
        deadline = time.monotonic() + self.APPLY_WAIT_S
        while state.latest_index() < index:
            if time.monotonic() >= deadline:
                read_stats.note_forward_failure()
                raise ReadPlaneError(
                    f"local state lagging read fence index {index}",
                    known_leader=self.known_leader())
            time.sleep(0.001)
