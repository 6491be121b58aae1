"""Incrementally-maintained cluster utilization planes.

The scheduler's eval tensors need per-node proposed utilization
(context.go:173 ProposedAllocs). Recomputing that by scanning every
live allocation per evaluation is O(allocs) Python work — at C2M scale
(100K allocs) that alone caps the whole system at a few evals/sec.

This module keeps the planes *live* instead: the state store scatters
±delta into fixed node rows on every allocation transition (the same
scatter the fused device step applies on commit —
parallel/batching.commit_placements), so a scheduling snapshot gets its
utilization planes as one small memcpy. This is the host half of the
"device-resident cluster state" design (SURVEY.md section 7 step 4-5);
the reference's equivalent cost is hidden inside go-memdb's indexed
reads, which Python dicts cannot match per-eval.

Row discipline: rows are stable for a node's lifetime and recycled
after removal; every plane (and ClusterTensors built against the same
index) shares the axis. ``structure_version`` changes when the node
set/rows change (add/remove/update), ``version`` on every mutation.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch.tensors.schema import pad_bucket

#: node-change log length. Long enough to span the structural churn
#: between two scheduling batches (heartbeat status flaps, a rolling
#: node update); a consumer that finds its last-seen version older
#: than the log's tail falls back to a full rebuild.
NODE_LOG_MAX = 1024

#: usage-row change log length. Every alloc transition logs the node
#: whose utilization row it moved, so the device-resident cluster
#: state (tensors/device_state.py) can advance its resident planes by
#: scattering ONLY those rows instead of re-uploading full planes per
#: wave. One scheduling batch commits at most batch x placements rows;
#: 4096 spans many batches of slack before the floor forces a full
#: re-upload.
ROW_LOG_MAX = 4096


@dataclass
class UsagePlanes:
    """An immutable point-in-time copy of the utilization planes."""

    n: int                                   # row axis length (padded)
    rows: Dict[str, int]                     # node id -> row (shared ref)
    ids: Tuple                               # row -> node id (None = free)
    used_cpu: np.ndarray                     # f32[n]
    used_mem: np.ndarray
    used_disk: np.ndarray
    used_cores: np.ndarray                   # i32[n]
    used_mbits: np.ndarray                   # i32[n]
    #: count of live allocs on the node that use ports/networks or
    #: devices. Zero (together with used_cores == 0) proves the node's
    #: fit re-check is pure cpu/mem/disk arithmetic — the plan
    #: applier's vectorized group-commit check is only sound on such
    #: nodes and falls back to the exact walk otherwise
    #: (server/plan_apply.py).
    used_special: np.ndarray                 # i32[n]
    #: count of live allocs on the node that use DEVICES — the only
    #: part of used_special the ports-aware group check cannot prove
    #: from planes (DeviceAccounter needs the exact walk)
    used_devices: np.ndarray                 # i32[n]
    #: row -> int bitmap of every concrete port held by the node's
    #: live allocs (task networks reserved+dynamic, group shared
    #: ports — exactly the set NetworkIndex.add_allocs indexes). Rows
    #: with no ports carry no entry. The plan applier's ports-aware
    #: vector check validates port-bearing plans against this plane
    #: with one AND per placement.
    port_masks: Dict[int, int] = field(default_factory=dict)
    #: rows whose bitmap is NOT provable (out-of-range ports, an
    #: add-overlap — the legal multi-address same-port state a flat
    #: bitmap cannot represent — or a remove of unseen bits): the
    #: checker must take the exact walk for these nodes
    port_dirty: frozenset = frozenset()
    version: int = 0
    structure_version: int = 0
    uid: str = ""                            # owning store's identity
    #: (structure_version, node_id) per structural change, oldest
    #: first; node_id None poisons the log (full rebuild required —
    #: restore/rebuild paths). Consumed by the incremental
    #: ClusterTensors cache (tensors/schema.py) to re-flatten only
    #: dirty node rows on snapshot refresh.
    node_events: Tuple = field(default=())
    #: (version, node_id) per utilization-row mutation (alloc
    #: transitions, node drops), oldest first. Complete for every
    #: version > row_events_floor; a consumer whose last-seen version
    #: is at or below the floor must fall back to a full plane upload.
    #: Consumed by tensors/device_state.DeviceClusterState to advance
    #: device-resident utilization planes by dirty-row scatter.
    row_events: Tuple = field(default=())
    row_events_floor: int = 0


def usage_rebuild_diff(store) -> List[str]:
    """Verify the store's incrementally-maintained usage planes against
    a FROM-SCRATCH rebuild over the same nodes + allocs (the chaos
    cell's bit-identity invariant; also an operator
    debugging aid). Returns human-readable mismatch strings — empty
    means every per-node value and port bitmap is exactly equal.

    The MVCC store makes the read trivially consistent: one snapshot
    carries the tables AND the planes frozen by the same commit, so
    the torn-pair retry loop the lock-based store needed is gone —
    this can run against a store under full write load and never
    report phantom drift."""
    snap = store.snapshot()
    planes = snap.usage
    fresh = UsageIndex()
    fresh.rebuild(snap.nodes(), list(snap.allocs_iter()))
    fp = fresh.planes_copy()
    diffs: List[str] = []

    def row_vals(pl: UsagePlanes, row):
        if row is None:
            return (0.0, 0.0, 0.0, 0, 0, 0, 0, 0)
        return (
            float(pl.used_cpu[row]), float(pl.used_mem[row]),
            float(pl.used_disk[row]), int(pl.used_cores[row]),
            int(pl.used_mbits[row]), int(pl.used_special[row]),
            int(pl.used_devices[row]), int(pl.port_masks.get(row, 0)),
        )

    names = ("cpu", "mem", "disk", "cores", "mbits", "special",
             "devices", "port_mask")
    for nid in sorted(set(planes.rows) | set(fp.rows)):
        live_row = planes.rows.get(nid)
        fresh_row = fp.rows.get(nid)
        lv = row_vals(planes, live_row)
        fv = row_vals(fp, fresh_row)
        # a poisoned live bitmap is unprovable by design — the group
        # checker already exact-walks those rows, so only the provable
        # plane values participate in bit-identity
        live_dirty = live_row is not None and live_row in planes.port_dirty
        fresh_dirty = fresh_row is not None and fresh_row in fp.port_dirty
        for name, a, b in zip(names, lv, fv):
            if name == "port_mask" and (live_dirty or fresh_dirty):
                continue
            if a != b:
                diffs.append(
                    f"node {nid}: {name} live={a!r} rebuild={b!r}")
        if live_dirty != fresh_dirty:
            diffs.append(
                f"node {nid}: port_dirty live={live_dirty} "
                f"rebuild={fresh_dirty}")
    return diffs


class UsageIndex:
    """Live planes owned by the state store; mutated only inside the
    store's single-writer transaction scope (the write lock). Readers
    never touch this object — they read the frozen ``UsagePlanes`` the
    commit stamped into its :class:`~nomad_tpu_torch.state.store.StoreRoot`."""

    def __init__(self) -> None:
        import uuid

        self.uid = uuid.uuid4().hex
        self.rows: Dict[str, int] = {}
        self.ids: List[Optional[str]] = []
        self._free: List[int] = []
        self.cap = 0
        self.used_cpu = np.zeros(0, np.float32)
        self.used_mem = np.zeros(0, np.float32)
        self.used_disk = np.zeros(0, np.float32)
        self.used_cores = np.zeros(0, np.int32)
        self.used_mbits = np.zeros(0, np.int32)
        self.used_special = np.zeros(0, np.int32)
        self.used_devices = np.zeros(0, np.int32)
        # live reserved-port bitmaps: row -> int mask; rows whose mask
        # stopped being provable are poisoned until drop/rebuild
        self.port_masks = {}
        self.port_dirty = set()
        self.version = 0
        self.structure_version = 0
        # structural change log: (structure_version, node_id or None)
        self.node_log: deque = deque(maxlen=NODE_LOG_MAX)
        # usage-row change log: (version, node_id); complete for every
        # version > row_log_floor (the floor advances when entries are
        # trimmed, and jumps to the current version on rebuild)
        self.row_log: deque = deque()
        self.row_log_floor = 0
        # planes_copy cache: reused until the next mutation; guarded by
        # the owning store's write lock (all callers hold it)
        self._copy: Optional[UsagePlanes] = None
        # copy-on-write discipline for the row map: planes_copy hands
        # out self.rows BY REFERENCE (copying a 100k-entry dict per
        # usage-touching commit would dominate MVCC commit cost); the
        # flag makes the next STRUCTURAL mutator replace the dict
        # first. ids is likewise cached as a tuple until structure
        # changes — alloc transitions touch neither.
        self._rows_shared = False
        self._ids_tuple: Optional[Tuple] = None

    def _own_rows(self) -> None:
        """Detach self.rows from any frozen planes sharing it; call
        before any structural rows/ids mutation."""
        if self._rows_shared:
            self.rows = dict(self.rows)
            self._rows_shared = False
        self._ids_tuple = None

    # -- structure -------------------------------------------------------

    def _grow(self, need: int) -> None:
        new_cap = pad_bucket(max(need, 1))
        if new_cap <= self.cap:
            return
        for name in ("used_cpu", "used_mem", "used_disk", "used_cores",
                     "used_mbits", "used_special", "used_devices"):
            old = getattr(self, name)
            grown = np.zeros(new_cap, old.dtype)
            grown[: old.shape[0]] = old
            setattr(self, name, grown)
        self.cap = new_cap

    def node_row(self, node_id: str) -> int:
        row = self.rows.get(node_id)
        if row is not None:
            return row
        self._own_rows()
        if self._free:
            row = self._free.pop()
        else:
            row = len(self.ids)
            self.ids.append(None)
            self._grow(len(self.ids))
        self.ids[row] = node_id
        self.rows[node_id] = row
        self._touch(structural=True, node_id=node_id)
        return row

    def note_node_change(self, node_id: Optional[str] = None) -> None:
        """A node row was replaced in the store (status/resources may
        differ): invalidate structure-keyed caches (ClusterTensors).
        ``node_id`` feeds the change log so those caches can re-flatten
        just the dirty row; None (unknown provenance) poisons the log
        and forces the next consumer to rebuild fully."""
        self._touch(structural=True, node_id=node_id)

    def drop_node(self, node_id: str) -> None:
        if node_id not in self.rows:
            return
        self._own_rows()
        row = self.rows.pop(node_id)
        self.ids[row] = None
        self._free.append(row)
        self.port_masks.pop(row, None)
        self.port_dirty.discard(row)
        for name in ("used_cpu", "used_mem", "used_disk", "used_cores",
                     "used_mbits", "used_special", "used_devices"):
            getattr(self, name)[row] = 0
        self._touch(structural=True, node_id=node_id)
        self._log_row(node_id)

    # -- alloc transitions ----------------------------------------------

    def _alloc_delta(self, a, sign: int) -> None:
        row = self.rows.get(a.node_id)
        if row is None:
            if sign < 0:
                # the node's row was dropped (node deleted while its
                # allocs lived); creating a row just to go negative
                # would poison a future node with the same id
                return
            # allocs can land before their node registers in restore
            # order; give the node a row so the usage is not lost
            row = self.node_row(a.node_id)
        cr, uses_ports, uses_devices = a.fit_meta()
        self.used_cpu[row] += sign * cr.cpu_shares
        self.used_mem[row] += sign * cr.memory_mb
        self.used_disk[row] += sign * cr.disk_mb
        self.used_cores[row] += sign * len(cr.reserved_cores)
        mbits = sum(net.mbits for net in cr.networks)
        self.used_mbits[row] += sign * mbits
        if uses_ports or uses_devices:
            self.used_special[row] += sign
        if uses_devices:
            self.used_devices[row] += sign
        if uses_ports:
            self._port_delta(row, a, sign)

    def _port_delta(self, row: int, a, sign: int) -> None:
        """Fold one port-bearing alloc into the row's bitmap.

        Sound states stay provable: live allocs on a node are mutually
        collision-free (the plan applier re-validates every commit), so
        each used port belongs to exactly ONE live alloc and a removal
        may clear its bits. Anything else — out-of-range ports, an
        add that overlaps (the legal multi-address same-port state a
        flat bitmap cannot represent), a remove of bits never added —
        poisons the row: the group checker then takes the exact walk
        for that node, which is always bit-identical.
        """
        if row in self.port_dirty:
            return
        mask, ok = a.port_meta()
        if not ok:
            self.port_dirty.add(row)
            return
        if not mask:
            return
        cur = self.port_masks.get(row, 0)
        if sign > 0:
            if cur & mask:
                self.port_dirty.add(row)
                return
            self.port_masks[row] = cur | mask
        else:
            if mask & ~cur:
                self.port_dirty.add(row)
                return
            cur &= ~mask
            if cur:
                self.port_masks[row] = cur
            else:
                self.port_masks.pop(row, None)

    def alloc_changed(self, old, new) -> None:
        """Apply one allocation transition (upsert/update/delete)."""
        old_live = old is not None and not old.terminal_status()
        new_live = new is not None and not new.terminal_status()
        if old_live:
            self._alloc_delta(old, -1)
        if new_live:
            self._alloc_delta(new, +1)
        if old_live or new_live:
            self._touch()
            # log AFTER the version bump so the entries carry the
            # version at which the rows became dirty
            if old_live:
                self._log_row(old.node_id)
            if new_live and (not old_live or new.node_id != old.node_id):
                self._log_row(new.node_id)

    def rebuild(self, nodes, allocs) -> None:
        """Full rebuild (snapshot restore / FSM restore)."""
        # REPLACE rows (never clear in place): frozen planes may share
        # the old dict by reference
        self.rows = {}
        self._rows_shared = False
        self._ids_tuple = None
        self.ids.clear()
        self._free.clear()
        self.port_masks.clear()
        self.port_dirty.clear()
        self.cap = 0
        for name in ("used_cpu", "used_mem", "used_disk", "used_cores",
                     "used_mbits", "used_special", "used_devices"):
            setattr(self, name, np.zeros(0, getattr(self, name).dtype))
        for node in nodes:
            self.node_row(node.id)
        for a in allocs:
            if not a.terminal_status():
                self._alloc_delta(a, +1)
        self._touch(structural=True)
        # a rebuild rewrites rows wholesale: nothing before it is
        # provable from the log
        self.row_log.clear()
        self.row_log_floor = self.version

    # -- reads -----------------------------------------------------------

    def _touch(self, structural: bool = False,
               node_id: Optional[str] = None) -> None:
        self.version += 1
        if structural:
            self.structure_version += 1
            self.node_log.append((self.structure_version, node_id))
        self._copy = None

    def _log_row(self, node_id: str) -> None:
        """Record that ``node_id``'s utilization row changed at the
        CURRENT version (call after ``_touch``). Trimming advances the
        floor so completeness stays provable."""
        self.row_log.append((self.version, node_id))
        while len(self.row_log) > ROW_LOG_MAX:
            v, _ = self.row_log.popleft()
            if v > self.row_log_floor:
                self.row_log_floor = v

    def planes_copy(self) -> UsagePlanes:
        """Point-in-time copy; cached until the next mutation (commits
        that did not touch usage stamp the SAME frozen planes into the
        next root for free). Call under the store's write lock."""
        if self._copy is not None:
            return self._copy
        n = pad_bucket(max(len(self.ids), 1))
        self._grow(n)
        if self._ids_tuple is None:
            self._ids_tuple = tuple(self.ids)
        # rows is handed out BY REFERENCE under the COW flag: the next
        # structural mutator replaces the dict, so the frozen planes'
        # view never moves (alloc transitions — the per-commit common
        # case — touch only the arrays, copied below)
        self._rows_shared = True
        self._copy = UsagePlanes(
            n=n,
            rows=self.rows,
            ids=self._ids_tuple,
            used_cpu=self.used_cpu[:n].copy(),
            used_mem=self.used_mem[:n].copy(),
            used_disk=self.used_disk[:n].copy(),
            used_cores=self.used_cores[:n].copy(),
            used_mbits=self.used_mbits[:n].copy(),
            used_special=self.used_special[:n].copy(),
            used_devices=self.used_devices[:n].copy(),
            port_masks=dict(self.port_masks),
            port_dirty=frozenset(self.port_dirty),
            version=self.version,
            structure_version=self.structure_version,
            uid=self.uid,
            node_events=tuple(self.node_log),
            row_events=tuple(self.row_log),
            row_events_floor=self.row_log_floor,
        )
        return self._copy
