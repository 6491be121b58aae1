"""Plan applier: serialized per-node re-validation + commit.

Reference behavior: nomad/plan_apply.go. The leader pops plans from the
PlanQueue one at a time, re-checks every placement node against the
*latest* state (the scheduler ran against an older optimistic snapshot),
commits the surviving subset through the Raft boundary, and responds to
the worker's future. A partial commit sets ``refresh_index`` so the
scheduler refreshes its snapshot and retries the rejected placements
(generic_sched.go:343-350).

The per-node fit re-check (evaluateNodePlan, plan_apply.go:644) is the
cluster-wide serialization point; ``EvaluatePool`` parallelizes it
across nodes (plan_apply_pool.go:18). Here the pool is a thread pool
for host-path checks; for large plans the same check runs as a batched
tensor op (all nodes' proposed utilization vs capacity in one
vectorized comparison) which is the TPU-native equivalent.

Group commit (the plan-on-device wave window): a burst of
optimistically-scheduled evals lands a burst of plans. Instead of
re-walking every touched node's alloc list per plan, the applier takes
ONE snapshot of the store's live utilization planes (state/usage.py)
plus the in-flight overlay, re-validates the whole wave with per-node
float arithmetic (``_GroupFitChecker``), and commits every surviving
plan as ONE raft entry and one FSM apply (``_commit_batch``).

Ports-aware plane: port-bearing plans no longer always fall
back — the usage planes carry a per-node reserved-port bitmap
(``UsagePlanes.port_masks``), so a placement's port claim re-validates
as one AND against (live | static | overlay) bits next to the three
float compares. Any node the planes cannot prove (devices, reserved
cores, bandwidth accounting, multi-address port layouts, poisoned
bitmap rows, stale rows) falls back to the exact ``evaluateNodePlan``
walk — counted in ``plan_group_stats.fallback_plans``, which the
steady-state CI gate requires to be zero. Bit-identity of the group
pass against serialized ``apply_one`` is property-tested
(tests/test_plan_group_commit.py, including randomized port-conflict
mixes).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import Allocation
from nomad_tpu_torch.structs.eval_plan import Plan, PlanResult
from nomad_tpu_torch.structs.resources import allocs_fit
from nomad_tpu_torch.server.plan_queue import PendingPlan, PlanQueue
from nomad_tpu_torch.telemetry.histogram import histograms
from nomad_tpu_torch.telemetry.trace import tracer
from nomad_tpu_torch.utils.faultpoints import fault
from nomad_tpu_torch.utils.witness import witness_lock


class PlanGroupStats:
    """Process-wide group-commit observability.

    Exported as ``nomad_tpu_plan_group_*`` Prometheus series
    (telemetry/exporter.py) and folded into TRACE_DECOMP's steady-state
    table (bench/trace_report.py). ``fallback_plans`` is the load-bearing
    number: the steady-state CI gate requires it to be ZERO — every plan
    of a lean steady burst must be provable by the vectorized check, so
    any regression that silently de-leans the hot path (a new field the
    checker can't see, a usage-plane drift) turns the gate red instead
    of quietly serializing the applier again.
    """

    def __init__(self) -> None:
        self._lock = witness_lock("PlanGroupStats._lock")
        self.reset()

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self.plans = 0              # plans through the group pass
            self.vector_plans = 0       # fully proven by the vector check
            self.fallback_plans = 0     # >=1 node took the exact walk
            self.vector_nodes = 0
            self.fallback_nodes = 0
            self.rejected_node_plans = 0
            self.commit_batches = 0
            self.committed_plans = 0
            self.batch_bytes = 0
            # port-coverage: plans carrying >= 1 port-bearing
            # placement, split by whether the ports plane proved them
            # (this extends group-commit coverage beyond lean-only;
            # these counters are how the extension's health is gated)
            self.port_plans = 0
            self.port_vector_plans = 0
            self.port_fallback_plans = 0

    def note_plan(self, vector_nodes: int, fallback_nodes: int,
                  rejected: int, has_ports: bool = False) -> None:
        with self._lock:
            self.plans += 1
            self.vector_nodes += vector_nodes
            self.fallback_nodes += fallback_nodes
            self.rejected_node_plans += rejected
            if fallback_nodes:
                self.fallback_plans += 1
            else:
                self.vector_plans += 1
            if has_ports:
                self.port_plans += 1
                if fallback_nodes:
                    self.port_fallback_plans += 1
                else:
                    self.port_vector_plans += 1

    def note_commit(self, n_plans: int, n_bytes: int = 0) -> None:
        with self._lock:
            self.commit_batches += 1
            self.committed_plans += n_plans
            self.batch_bytes += n_bytes

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "plans": self.plans,
                "vector_plans": self.vector_plans,
                "fallback_plans": self.fallback_plans,
                "vector_nodes": self.vector_nodes,
                "fallback_nodes": self.fallback_nodes,
                "rejected_node_plans": self.rejected_node_plans,
                "commit_batches": self.commit_batches,
                "committed_plans": self.committed_plans,
                "batch_bytes": self.batch_bytes,
                "port_plans": self.port_plans,
                "port_vector_plans": self.port_vector_plans,
                "port_fallback_plans": self.port_fallback_plans,
                "group_size_avg": (
                    self.committed_plans / self.commit_batches
                    if self.commit_batches else 0.0),
            }


#: process-wide (all Planners feed it; reset with telemetry.reset())
plan_group_stats = PlanGroupStats()

#: usage planes are float32: integer sums stay exact only below 2**24.
#: A node dimension beyond that cannot be re-validated bit-identically
#: from the planes, so the checker falls back to the exact walk.
_F32_EXACT_MAX = float(1 << 24)


class _PlanOverlay:
    """Results of plans whose raft apply is still in flight.

    The reference pipelines: while plan N's raft apply runs, plan N+1
    is evaluated against an *optimistic* snapshot that already contains
    N's results (plan_apply.go:159-184). This overlay is that optimism:
    entries are added when an apply launches and removed once the store
    commit is visible, and the evaluation view merges them by alloc id
    (so the commit-then-remove window cannot double count).
    """

    def __init__(self) -> None:
        self._lock = witness_lock("PlanOverlay._lock")
        self._seq = 0
        self._entries: Dict[int, "PlanResult"] = {}

    def add(self, result: "PlanResult") -> int:
        with self._lock:
            self._seq += 1
            self._entries[self._seq] = result
            return self._seq

    def remove(self, token: int) -> None:
        with self._lock:
            self._entries.pop(token, None)

    def entries(self) -> List["PlanResult"]:
        """All in-flight results, oldest first (the group checker folds
        them into its per-node deltas at batch start)."""
        with self._lock:
            return [self._entries[k] for k in sorted(self._entries)]

    def node_adjustment(self, node_id: str):
        """(placements_by_id, removed_ids) for one node across entries.

        Entries replay in commit order with serialized-apply semantics:
        a removal drops an earlier entry's in-flight placement of the
        same id (exactly what the store would show had the earlier
        entry already committed), and a later placement re-adds the id.
        Within one entry removals apply before placements, matching
        ``upsert_plan_results_batch``'s upsert order."""
        with self._lock:
            entries = list(self._entries.values())
        placed: Dict[str, Allocation] = {}
        removed = set()
        for r in entries:
            for a in r.node_update.get(node_id, ()):
                removed.add(a.id)
                placed.pop(a.id, None)
            for a in r.node_preemptions.get(node_id, ()):
                removed.add(a.id)
                placed.pop(a.id, None)
            for a in r.node_allocation.get(node_id, ()):
                placed[a.id] = a
        return placed, removed

    def job_adjustment(self, namespace: str, job_id: str):
        """(placements_by_id, removed_ids) for one JOB across entries —
        ``node_adjustment``'s replay semantics keyed by job instead of
        node. The duplicate-slot guard needs job-wide visibility: a
        redelivered eval's twin plan can re-place a committed slot on a
        DIFFERENT node, so a per-node merge would never see the
        collision. ``removed`` may carry other jobs' ids; callers only
        use it to filter rows of this job."""
        with self._lock:
            entries = list(self._entries.values())
        placed: Dict[str, Allocation] = {}
        removed = set()
        for r in entries:
            for src in (r.node_update, r.node_preemptions):
                for allocs in src.values():
                    for a in allocs:
                        removed.add(a.id)
                        placed.pop(a.id, None)
            for allocs in r.node_allocation.values():
                for a in allocs:
                    if a.namespace == namespace and a.job_id == job_id:
                        placed[a.id] = a
        return placed, removed


class _LiveView:
    """Freshest-generation read proxy for plan evaluation.

    The MVCC store's ``snapshot()`` is free (one root-pointer read,
    go-memdb parity), so this view is no longer dodging snapshot cost —
    it exists to read each node at the FRESHEST generation at lookup
    time, shrinking the optimistic window between read and raft commit
    to the same one the reference has (plan_apply.go:209): client-side
    alloc updates landing inside it never add resource usage, so a fit
    that passed cannot become an over-commit.

    ``overlay`` adds the in-flight plans' results on top (the
    pipelining optimism, plan_apply.go:159).
    """

    def __init__(self, store, overlay: Optional[_PlanOverlay] = None) -> None:
        self._store = store
        self._overlay = overlay

    def latest_index(self) -> int:
        return self._store.latest_index()

    def node_by_id(self, node_id: str):
        # the *_direct readers (lock-free MVCC root reads) replace the
        # raw _nodes/_lock reach-through this view used to do
        # (graftcheck R4): the store's internals stay the store's
        return self._store.node_by_id_direct(node_id)

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        # overlay BEFORE store: an in-flight plan is either still in
        # the overlay (merged in) or already committed (in the later
        # store read); reading the store first would open a window
        # where a commit-then-overlay-remove hides the plan entirely
        if self._overlay is not None:
            placed, removed = self._overlay.node_adjustment(node_id)
        else:
            placed, removed = {}, set()
        rows = self._store.allocs_by_node_direct(node_id)
        by_id = {a.id: a for a in rows if a.id not in removed}
        by_id.update(placed)
        return list(by_id.values())

    def allocs_by_job(self, namespace: str, job_id: str) -> List[Allocation]:
        # same overlay-before-store merge as allocs_by_node, keyed by
        # job: the duplicate-slot guard's job-wide read
        if self._overlay is not None:
            placed, removed = self._overlay.job_adjustment(namespace, job_id)
        else:
            placed, removed = {}, set()
        rows = self._store.allocs_by_job_direct(namespace, job_id)
        by_id = {a.id: a for a in rows if a.id not in removed}
        by_id.update(placed)
        return list(by_id.values())


def _result_alloc_ids(result: "PlanResult") -> set:
    """Every alloc id a result's fold will look up in the store: the
    prefetch set that lets ``_GroupFitChecker`` read O(result) rows
    from the same MVCC root the planes came from."""
    ids = set()
    for src in (result.node_update, result.node_preemptions,
                result.node_allocation):
        for allocs in src.values():
            for a in allocs:
                ids.add(a.id)
    return ids


def _vector_usage(alloc: Allocation):
    """(cpu, mem, disk, port_mask, has_net) when the alloc is provable
    by the vectorized group check, else None.

    Lean allocs (no ports/networks/devices/cores) prove as pure float
    arithmetic. Port-bearing allocs prove too — the ports
    plane — as long as their ports are a valid flat bitmap
    (``port_meta``) and they carry no bandwidth (the NetworkIndex
    accounts mbits per device; planes cannot). Devices and reserved
    cores always need the exact per-node walk (DeviceAccounter /
    core-overlap sets). ``has_net`` marks allocs the exact walk would
    build a NetworkIndex for (``uses_ports`` — networks with or
    without concrete ports): it decides whether a node's port proof
    obligations apply at all."""
    cr, uses_ports, uses_devices = alloc.fit_meta()
    if uses_devices or cr.reserved_cores:
        return None
    if not uses_ports:
        return cr.cpu_shares, cr.memory_mb, cr.disk_mb, 0, False
    if any(net.mbits for net in cr.networks):
        return None
    mask, ok = alloc.port_meta()
    if not ok:
        return None
    return cr.cpu_shares, cr.memory_mb, cr.disk_mb, mask, True


class _GroupFitChecker:
    """Vectorized wave re-validation state for one applier pass.

    One snapshot of the store's live utilization planes (state/usage.py
    — the SAME aggregates the scheduler's eval tensors gather from)
    plus per-node float deltas folded from the in-flight overlay and
    from each plan of this batch as it is accepted. A node plan whose
    placements are provable (lean, or port-bearing with a valid flat
    bitmap), whose node carries no device or reserved-core usage, and
    whose dimensions stay inside float32's exact-integer range is then
    re-validated with three comparisons plus (for port-bearing plans)
    one bitmap AND per placement — no per-alloc walk, no NetworkIndex,
    no ComparableResources sums.

    Exactness: the merge rules mirror ``_LiveView.allocs_by_node`` +
    ``evaluate_plan`` bit for bit (entries replay in commit order —
    a removal drops an earlier in-flight placement of the same id,
    a later placement re-adds it; placements with an id live on the
    same node double-count, exactly as the serial proposed-list append
    does). Anything the planes cannot prove returns None and the
    caller runs the exact per-node walk — semantics never depend on
    the fast path.
    """

    def __init__(self, store, overlay: Optional[_PlanOverlay]) -> None:
        self._store = store
        self.ok = (getattr(store, "usage", None) is not None
                   and hasattr(store, "with_usage_view"))
        if not self.ok:
            return
        self._delta: Dict[str, List[float]] = {}
        self._removed: Dict[str, set] = {}
        self._placed: Dict[str, Dict[str, Tuple]] = {}
        self._tainted: set = set()
        self._caps: Dict[str, Tuple] = {}
        # port overlay deltas (the ports-aware plane):
        # bits ADDED by in-flight/batch placements, bits FREED by
        # their removals, and the nodes where overlay allocs would
        # make the exact walk build a NetworkIndex at all
        self._padd: Dict[str, int] = {}
        self._psub: Dict[str, int] = {}
        self._pflags: set = set()
        # entries read BEFORE the planes snapshot: an entry that
        # commits in between is deduped by the fold's committed-row
        # check (`prev is a` for placements; terminal rows for
        # removals), so it can never double-count against planes that
        # already include it
        entries = overlay.entries() if overlay is not None else []
        ids = set()
        for r in entries:
            ids |= _result_alloc_ids(r)

        def _init(planes, allocs):
            self._rows = planes.rows
            self._cpu = planes.used_cpu
            self._mem = planes.used_mem
            self._disk = planes.used_disk
            self._cores = planes.used_cores
            self._special = planes.used_special
            self._devices = planes.used_devices
            self._mbits = planes.used_mbits
            self._pmasks = planes.port_masks
            self._pdirty = planes.port_dirty
            # prefetch ONLY the rows the fold will read — rows are
            # replaced, never mutated, so handing them out is safe
            return {i: allocs.get(i) for i in ids}

        # planes + row prefetch from ONE MVCC root
        # (StateStore.with_usage_view): the fold checks store-row
        # liveness, which must be consistent with the planes — both
        # were frozen by the same commit, so the pairing is consistent
        # BY CONSTRUCTION, with no lock held by anyone (the seed
        # needed a store-lock hold across both reads; graftcheck R2 /
        # witness hold-time finding). An init failure degrades to the
        # exact walk for the batch — it must never take the applier
        # thread down.
        try:
            rows = store.with_usage_view(_init)
            for r in entries:
                self._fold_result(r, rows)
        except Exception:                       # noqa: BLE001
            import logging

            logging.getLogger(__name__).warning(
                "group-commit checker init failed; exact walk for "
                "this batch", exc_info=True)
            self.ok = False

    # -- delta accounting -------------------------------------------------

    def note_result(self, result: "PlanResult") -> None:
        """Fold an accepted plan's result so later plans of the batch
        see it (the overlay semantics, in delta form). Only the alloc
        table is needed here — the planes snapshot stays the batch's.

        A fold failure must not escape: the result itself is already
        valid, and this runs on the applier thread whose death would
        hang every worker's plan future. Instead the checker DISABLES
        itself — a half-applied delta is unsound, so the rest of the
        batch takes the exact walk (which reads the overlay, not these
        deltas)."""
        if not self.ok:
            return
        try:
            ids = _result_alloc_ids(result)
            # O(result) row prefetch under the lock, O(fold) Python
            # outside it — same reads at the same locked instant as
            # the old full fold-under-lock, minus the reader stall
            rows = self._store.with_allocs(
                lambda allocs: {i: allocs.get(i) for i in ids})
            self._fold_result(result, rows)
        except Exception:                       # noqa: BLE001
            import logging

            logging.getLogger(__name__).warning(
                "group-commit fold failed; exact walk for the rest "
                "of the batch", exc_info=True)
            self.ok = False

    def _bump(self, node_id: str, sign: float, usage: Tuple) -> None:
        d = self._delta.get(node_id)
        if d is None:
            d = self._delta[node_id] = [0.0, 0.0, 0.0]
        d[0] += sign * usage[0]
        d[1] += sign * usage[1]
        d[2] += sign * usage[2]

    def _port_add(self, nid: str, mask: int) -> None:
        if mask:
            self._padd[nid] = self._padd.get(nid, 0) | mask

    def _port_drop_placed(self, nid: str, mask: int) -> None:
        """Clear an in-flight placement's bits from the add-overlay.
        Sound because accepted placements on a provable node are
        mutually conflict-free — each overlay bit belongs to exactly
        one placed alloc (the same invariant the live plane relies
        on)."""
        if mask:
            self._padd[nid] = self._padd.get(nid, 0) & ~mask

    def _port_free(self, nid: str, mask: int) -> None:
        if mask:
            self._psub[nid] = self._psub.get(nid, 0) | mask

    def _fold_result(self, r: "PlanResult", store_allocs) -> None:
        """Fold one result's deltas. ``store_allocs`` is the
        prefetched ``{id: row}`` dict read from the same MVCC root
        as the planes, so liveness checks and plane baselines agree
        by construction (``_result_alloc_ids(r)`` is the complete set
        of ids this fold looks up — extend it if a new ``.get`` is
        added here)."""
        for src in (r.node_update, r.node_preemptions):
            for nid, allocs in src.items():
                rm = self._removed.setdefault(nid, set())
                pl = self._placed.get(nid)
                for a in allocs:
                    old = pl.pop(a.id, None) if pl else None
                    if old is not None:
                        # removes an earlier in-flight placement of the
                        # same id (serialized-commit semantics); the
                        # store row — if one exists — was already
                        # subtracted by the placed handler
                        self._bump(nid, -1.0, old)
                        self._port_drop_placed(nid, old[3])
                        rm.add(a.id)
                        continue
                    if a.id in rm:
                        continue
                    rm.add(a.id)
                    prev = store_allocs.get(a.id)
                    if (prev is None or prev.terminal_status()
                            or prev.node_id != nid):
                        continue
                    vu = _vector_usage(prev)
                    if vu is None:
                        self._tainted.add(nid)
                        continue
                    self._bump(nid, -1.0, vu)
                    self._port_free(nid, vu[3])
                    if vu[4]:
                        self._pflags.add(nid)
        for nid, allocs in r.node_allocation.items():
            pl = self._placed.setdefault(nid, {})
            for a in allocs:
                prev = store_allocs.get(a.id)
                if prev is a:
                    # already committed: the planes copy includes it
                    continue
                if a.terminal_status():
                    # terminal placements (lost/unknown transitions)
                    # contribute NOTHING to the exact walk — allocs_fit
                    # skips terminal allocs, and the merged by_id view
                    # filters them — but the merge still replaces a
                    # live store row of the same id, so the fold
                    # records a ZERO-usage entry after backing that
                    # row out
                    vu = (0, 0, 0, 0, False)
                else:
                    vu = _vector_usage(a)
                    if vu is None:
                        self._tainted.add(nid)
                        continue
                old = pl.get(a.id)
                if old is not None:
                    # last placement wins the by_id merge
                    self._bump(nid, -1.0, old)
                    self._port_drop_placed(nid, old[3])
                elif (prev is not None and not prev.terminal_status()
                        and prev.node_id == nid
                        and a.id not in self._removed.get(nid, set())):
                    # in-place update: the merged view replaces the
                    # store row with the placed version
                    pvu = _vector_usage(prev)
                    if pvu is None:
                        self._tainted.add(nid)
                        continue
                    self._bump(nid, -1.0, pvu)
                    self._port_free(nid, pvu[3])
                pl[a.id] = vu
                self._bump(nid, 1.0, vu)
                if vu[3]:
                    # an accepted placement's ports overlapping the
                    # node's effective mask means the node was proven
                    # by the exact walk under semantics the flat
                    # bitmap cannot express (multi-address) — or the
                    # planes drifted; either way, stop proving it
                    row = self._rows.get(nid)
                    live = self._pmasks.get(row, 0) if row is not None else 0
                    eff = (live & ~self._psub.get(nid, 0)) \
                        | self._padd.get(nid, 0)
                    if vu[3] & eff:
                        self._tainted.add(nid)
                    self._port_add(nid, vu[3])
                if vu[4]:
                    self._pflags.add(nid)

    # -- the vector check -------------------------------------------------

    def _node_cap(self, node) -> Tuple:
        """(cpu, mem, disk, static_port_mask, ports_ok) per node.

        ``ports_ok`` is the node-level port-proof gate: False when the
        node has more than one address (the NetworkIndex keys its
        bitmaps per ip — a flat mask over-rejects the legal
        same-port-two-addresses state), a duplicated or out-of-range
        agent-reserved port (set_node itself collides), so any
        port-involved plan on such a node must take the exact walk.
        """
        cap = self._caps.get(node.id)
        if cap is None:
            avail = node.comparable_resources()
            avail.subtract(node.comparable_reserved_resources())
            smask = 0
            sok = True
            ips = {n.ip or "0.0.0.0"
                   for n in node.node_resources.networks if n.device}
            if len(ips) > 1:
                sok = False
            for port in getattr(node.reserved_resources,
                                "networks_ports", []):
                if port < 0 or port >= 65536 or (smask >> port) & 1:
                    sok = False
                    break
                smask |= 1 << port
            cap = (float(avail.cpu_shares), float(avail.memory_mb),
                   float(avail.disk_mb), smask, sok)
            self._caps[node.id] = cap
        return cap

    def node_fit(self, plan: Plan, node_id: str, node) -> Optional[bool]:
        """True/False when provable from the planes, None to fall back
        to the exact per-node walk. Caller has already run the node
        status gates (shared with the exact path)."""
        if not self.ok or node_id in self._tainted:
            return None
        row = self._rows.get(node_id)
        if row is None:
            return None
        if self._devices[row] or self._cores[row]:
            return None
        placements = plan.node_allocation.get(node_id) or ()
        # pass 1 over placements: usage tuples + port involvement (the
        # exact walk builds its NetworkIndex iff ANY proposed alloc
        # carries networks/ports — live, overlaid, or placed here)
        place_vu = []
        place_ports = False
        for p in placements:
            if p.terminal_status():
                # allocs_fit skips terminal allocs entirely (neither
                # usage nor ports/devices), so a lost/unknown
                # transition costs nothing and needs no proof
                continue
            vu = _vector_usage(p)
            if vu is None:
                return None
            place_vu.append(vu)
            place_ports = place_ports or vu[4]
        cap = self._node_cap(node)
        # devices are gated to zero above, so used_special counts
        # exactly the node's live network/port-bearing allocs
        ports_involved = bool(self._special[row]) or place_ports \
            or node_id in self._pflags
        eff_mask = 0
        if ports_involved:
            if row in self._pdirty or self._mbits[row] or not cap[4]:
                # unprovable live bitmap, live bandwidth accounting,
                # or a node whose address/static-port layout the flat
                # mask cannot express: exact walk
                return None
            eff_mask = (self._pmasks.get(row, 0)
                        & ~self._psub.get(node_id, 0)) \
                | self._padd.get(node_id, 0)
        cpu = float(self._cpu[row])
        mem = float(self._mem[row])
        disk = float(self._disk[row])
        d = self._delta.get(node_id)
        if d is not None:
            cpu += d[0]
            mem += d[1]
            disk += d[2]
        # this plan's own staged stops/preemptions on the node: their
        # store rows leave the proposed set (dedup against ids already
        # removed or overlaid by earlier plans), freeing their ports
        removals = ((plan.node_update.get(node_id) or [])
                    + (plan.node_preemptions.get(node_id) or []))
        if removals:
            rm_seen = self._removed.get(node_id, ())
            placed = self._placed.get(node_id, {})
            seen_here: set = set()
            for a in removals:
                if a.id in seen_here:
                    continue
                seen_here.add(a.id)
                pl_usage = placed.get(a.id)
                if pl_usage is not None:
                    # this plan stops an in-flight placement: the
                    # merged view drops the placed version
                    cpu -= pl_usage[0]
                    mem -= pl_usage[1]
                    disk -= pl_usage[2]
                    eff_mask &= ~pl_usage[3]
                    continue
                if a.id in rm_seen:
                    continue
                prev = self._store.alloc_by_id_direct(a.id)
                if (prev is None or prev.terminal_status()
                        or prev.node_id != node_id):
                    continue
                vu = _vector_usage(prev)
                if vu is None:
                    # a live device/core/bandwidth alloc would have
                    # shown in the planes — unreachable unless the
                    # planes drifted: fall back
                    return None
                cpu -= vu[0]
                mem -= vu[1]
                disk -= vu[2]
                eff_mask &= ~vu[3]
        if eff_mask & cap[3]:
            # a PROPOSED live/overlay alloc holds an agent-reserved
            # port: any port bit surviving into the proposed set
            # implies the exact walk builds its NetworkIndex, whose
            # set_node pass already marked the static port used — the
            # whole node plan rejects regardless of what it places
            return False
        for vu in place_vu:
            # NOTE: no id-dedup against a live same-id store row — the
            # exact walk appends placements to the proposed list
            # without one (usage AND ports), and bit-identity tracks
            # the exact walk
            cpu += vu[0]
            mem += vu[1]
            disk += vu[2]
            if vu[3]:
                if vu[3] & (eff_mask | cap[3]):
                    # port collision against live/static/earlier
                    # placements: the exact walk rejects, so this IS
                    # the verdict, not a fallback
                    return False
                eff_mask |= vu[3]
        if max(cap[0], cap[1], cap[2], cpu, mem, disk) >= _F32_EXACT_MAX:
            return None
        return cpu <= cap[0] and mem <= cap[1] and disk <= cap[2]


class Planner:
    """The plan-apply loop (plan_apply.go:71 planApply)."""

    def __init__(
        self,
        state_store,
        plan_queue: PlanQueue,
        pool_workers: int = 4,
        raft_apply=None,
        on_node_rejection_threshold=None,
        validate_token=None,
    ) -> None:
        self.state = state_store
        self.queue = plan_queue
        self.pool_workers = pool_workers
        # plan_endpoint.go token check, re-run at DEQUEUE time: a plan
        # can sit in the queue across a lease re-enqueue (dead worker
        # recovery, auto-nack deadline) — committing it then would
        # race the redelivered eval into duplicate placements. The
        # callable returns an error string for a stale plan, else None.
        self._validate_token = validate_token
        # plan rejection tracker (server/plan_rejection.py): fired with
        # a node id when its in-window rejection count crosses the
        # threshold; the server marks it ineligible through raft
        self._on_node_rejection_threshold = on_node_rejection_threshold
        # commits go through the Raft boundary so FSM side effects
        # (blocked-eval unblock on freed capacity) fire; standalone use
        # falls back to direct store writes
        self._raft_apply = raft_apply
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # observability: full vs partial commits (a partial sends the
        # scheduler back for a refreshed-snapshot retry) and cumulative
        # seconds per applier stage (where plan latency actually goes)
        self.plans_full = 0
        self.plans_partial = 0
        # duplicate-slot rejections (see _duplicate_slot_nodes): a
        # correctness backstop firing only on redelivered-eval races,
        # so any nonzero count is worth a look
        self.plans_duplicate_slot = 0
        self.stage_s = {"queue_wait": 0.0, "evaluate": 0.0, "commit": 0.0,
                        "commit_wait": 0.0}
        # persistent re-check pool (plan_apply_pool.go:18 EvaluatePool)
        self._pool = (
            ThreadPoolExecutor(
                max_workers=pool_workers, thread_name_prefix="plan-eval"
            )
            if pool_workers > 1
            else None
        )

    # --- lifecycle ------------------------------------------------------

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="plan-applier"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def close(self) -> None:
        self.stop()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    #: Plans merged into one raft entry per applier pass. A burst of
    #: batched evals lands ~wave-size plans at once; committing them
    #: one raft entry at a time made per-plan commit overhead the p99
    #: cause at bench batch sizes.
    MAX_COMMIT_BATCH = 128

    def _run(self) -> None:
        """The pipelined applier loop (plan_apply.go:71,159-184).

        Batch N+1's per-node re-validation runs while batch N's raft
        apply is still in flight; N+1 evaluates against the live state
        PLUS the overlay of N's yet-uncommitted results, and its own
        apply starts only after N's completes (commit order is
        preserved). Within a batch, plan k's evaluation sees plans
        1..k-1 through the same overlay — the exact serial-applier
        semantics, with ONE raft entry and one store commit per batch.
        Responses go to workers only after the apply (asyncPlanWait,
        plan_apply.go:370).
        """
        overlay = _PlanOverlay()
        in_flight: Optional[threading.Thread] = None
        while not self._stop.is_set():
            batch = self.queue.dequeue_batch(self.MAX_COMMIT_BATCH,
                                             timeout=0.2)
            if not batch:
                continue
            now = time.monotonic()
            plan_queue_hist = histograms.get("plan_queue")
            for pending in batch:
                wait = now - pending.enqueued_at
                self.stage_s["queue_wait"] += wait
                plan_queue_hist.record(wait)
                tracer.record("plan.queue_wait", wait,
                              trace_id=pending.plan.eval_id)
            t_eval = time.perf_counter()
            evaluated: List[Tuple[PendingPlan, PlanResult, int]] = []
            snapshot = _LiveView(self.state, overlay)
            with tracer.span("plan.evaluate"), \
                    tracer.span("plan.group_commit"):
                # ONE planes snapshot + overlay fold re-validates the
                # whole wave; per-node exact walks survive only as the
                # unprovable-case fallback (counted, CI-gated to 0 on
                # the lean steady burst)
                checker = _GroupFitChecker(self.state, overlay)
                for pending in batch:
                    if self._validate_token is not None:
                        stale = self._validate_token(pending.plan)
                        if stale:
                            pending.respond(None, ValueError(stale))
                            continue
                    try:
                        result = self.evaluate_plan_group(
                            checker, snapshot, pending.plan)
                    except Exception as e:    # noqa: BLE001 - worker nacks
                        pending.respond(None, e)
                        continue
                    # later plans in this batch (and the next batch's
                    # evaluation) see this plan through the overlay;
                    # the checker folds it into its deltas
                    token = overlay.add(result)
                    checker.note_result(result)
                    evaluated.append((pending, result, token))
            eval_dur = time.perf_counter() - t_eval
            self.stage_s["evaluate"] += eval_dur
            # one sample per applier pass: the group evaluation latency
            # every plan in the batch waited through
            histograms.get("plan_evaluate").record(eval_dur)
            if not evaluated:
                continue
            # serialize commits: wait for the previous apply before
            # launching this one (evaluation above already overlapped).
            # commit_wait is the head-of-line block the raft
            # replication pipeline is meant to shrink —
            # while batch N's quorum is in flight, N+1 can only sit
            # here, so this stage counter is the applier-side view of
            # the commit window.
            if in_flight is not None:
                t_wait = time.perf_counter()
                in_flight.join()
                self.stage_s["commit_wait"] += time.perf_counter() - t_wait
            in_flight = threading.Thread(
                target=self._apply_batch_async,
                args=(evaluated, overlay),
                daemon=True, name="plan-commit",
            )
            in_flight.start()
        if in_flight is not None:
            in_flight.join()

    def _apply_batch_async(
        self,
        evaluated: List[Tuple[PendingPlan, PlanResult, int]],
        overlay: _PlanOverlay,
    ) -> None:
        try:
            t0 = time.perf_counter()
            with tracer.span("plan.commit"):
                index = self._commit_batch(
                    [(p.plan, r) for p, r, _ in evaluated])
            commit_dur = time.perf_counter() - t0
            self.stage_s["commit"] += commit_dur
            histograms.get("plan_commit").record(commit_dur)
            for pending, result, token in evaluated:
                result.alloc_index = index
                if result.refresh_index > 0:
                    # the conflict the scheduler must refresh past may
                    # have been an overlaid (just-committed) plan; point
                    # the retry at the post-commit state
                    result.refresh_index = max(result.refresh_index, index)
                overlay.remove(token)
                pending.respond(result, None)
        except Exception as e:                # noqa: BLE001
            for pending, _result, token in evaluated:
                overlay.remove(token)
                pending.respond(None, e)

    # --- single plan (dequeue -> evaluate -> commit) --------------------

    def apply_one(self, plan: Plan) -> PlanResult:
        snapshot = _LiveView(self.state)
        result = self.evaluate_plan(snapshot, plan)
        result.alloc_index = self._commit(plan, result)
        return result

    def apply_batch(self, plans: List[Plan]) -> List[PlanResult]:
        """Synchronous group apply: evaluate ``plans`` as ONE group
        pass (vector checks + exact fallback) and commit them as one
        raft entry / store index bump. The applier thread's batch loop
        with the pipelining removed — used by tests and synchronous
        callers; bit-identical to ``apply_one`` over the same plans in
        order (property-tested)."""
        overlay = _PlanOverlay()
        snapshot = _LiveView(self.state, overlay)
        checker = _GroupFitChecker(self.state, overlay)
        results: List[PlanResult] = []
        with tracer.span("plan.group_commit"):
            for plan in plans:
                result = self.evaluate_plan_group(checker, snapshot, plan)
                overlay.add(result)
                checker.note_result(result)
                results.append(result)
        index = self._commit_batch(list(zip(plans, results)))
        for result in results:
            result.alloc_index = index
            if result.refresh_index > 0:
                result.refresh_index = max(result.refresh_index, index)
        return results

    def _commit(self, plan: Plan, result: PlanResult) -> int:
        return self._commit_batch([(plan, result)])

    def _commit_batch(self, items: List[Tuple[Plan, PlanResult]]) -> int:
        """One raft entry / one store commit for a batch of evaluated
        plans (fsm.go applyPlanResults, batched)."""
        reqs = [
            {
                "plan": plan,
                "node_allocation": result.node_allocation,
                "node_update": result.node_update,
                "node_preemptions": result.node_preemptions,
                "deployment": result.deployment,
                "deployment_updates": result.deployment_updates,
            }
            for plan, result in items
        ]
        req = {"alloc_index": self.state.latest_index(), "plans": reqs}
        n_bytes = 0
        if tracer.enabled:
            # the wire weight of the batched raft entry (its alloc
            # payload — what a real log would ship); measured only with
            # telemetry on, off the wave-critical path (commit thread)
            try:
                import pickle

                n_bytes = len(pickle.dumps(
                    [(r["node_allocation"], r["node_update"],
                      r["node_preemptions"]) for r in reqs],
                    protocol=4))
            except Exception:               # noqa: BLE001 - metric only
                n_bytes = 0
        plan_group_stats.note_commit(len(items), n_bytes)
        # the commit seam (chaos plane): an injected error is a raft
        # apply that failed under a half-committed cohort — every plan
        # future in the batch gets the error, every worker nacks, the
        # broker redelivers against refreshed state
        fault("plan.commit.raft")
        if self._raft_apply is not None:
            # fsm.go applyPlanResults: Raft commit + blocked-eval unblock
            from nomad_tpu_torch.server.fsm import APPLY_PLAN_RESULTS
            return self._raft_apply(APPLY_PLAN_RESULTS, req)
        return self.state.upsert_plan_results_batch(
            req["alloc_index"], reqs)

    # --- group evaluation (the wave-window fast path) -------------------

    def evaluate_plan_group(self, checker: _GroupFitChecker, snapshot,
                            plan: Plan) -> PlanResult:
        """One plan's re-validation inside a group pass: vector check
        per node where provable, the exact walk otherwise. Identical
        results to ``evaluate_plan`` by construction (property-tested
        in tests/test_plan_group_commit.py)."""
        vector_nodes = 0
        fits: Dict[str, bool] = {}
        pending_exact: List[str] = []
        has_ports = any(
            not a.terminal_status() and a.fit_meta()[1]
            for allocs in plan.node_allocation.values() for a in allocs)
        for node_id in plan.node_allocation:
            placements = plan.node_allocation[node_id]
            if not placements:
                fits[node_id] = True
                continue
            node = snapshot.node_by_id(node_id)
            verdict = self._node_status_gates(node, placements)
            if verdict is not None:
                fits[node_id] = verdict[0]
                vector_nodes += 1
                continue
            fit = checker.node_fit(plan, node_id, node)
            if fit is None:
                pending_exact.append(node_id)
            else:
                fits[node_id] = fit
                vector_nodes += 1
        fallback_nodes = len(pending_exact)
        if pending_exact:
            # exact-walk fallback keeps evaluate_plan's fan-out: a
            # system-job / mass-drain plan touching many non-lean
            # nodes re-checks them on the pool, not serially
            for node_id, fit in self._exact_node_fits(
                    snapshot, plan, pending_exact).items():
                fits[node_id] = fit
        rejected = sum(1 for f in fits.values() if not f)
        plan_group_stats.note_plan(vector_nodes, fallback_nodes, rejected,
                                   has_ports=has_ports)
        return self._assemble_result(snapshot, plan, fits)

    # --- evaluation (plan_apply.go:403 evaluatePlan) --------------------

    def evaluate_plan(self, snapshot, plan: Plan) -> PlanResult:
        fits = self._exact_node_fits(
            snapshot, plan, list(plan.node_allocation.keys()))
        return self._assemble_result(snapshot, plan, fits)

    def _exact_node_fits(self, snapshot, plan: Plan,
                         node_ids: List[str]) -> Dict[str, bool]:
        """The exact per-node walk for a set of nodes. The pool pays
        off only when a plan touches MANY nodes (system jobs, mass
        drains): executor dispatch costs more than the whole fit
        re-check for the common 10-node service plan."""
        if len(node_ids) > 16 and self._pool is not None:
            verdicts = list(
                self._pool.map(
                    lambda nid: self._evaluate_node_plan(snapshot, plan, nid),
                    node_ids,
                )
            )
        else:
            verdicts = [self._evaluate_node_plan(snapshot, plan, n)
                        for n in node_ids]
        return {nid: fit for nid, (fit, _reason) in zip(node_ids, verdicts)}

    def _assemble_result(self, snapshot, plan: Plan,
                         fits: Dict[str, bool]) -> PlanResult:
        """Shared accept/reject tail of ``evaluate_plan`` and
        ``evaluate_plan_group`` (one implementation so the two paths
        cannot drift): fold per-node verdicts into the PlanResult plus
        the partial/refresh bookkeeping."""
        result = PlanResult(
            node_update=dict(plan.node_update),
            node_allocation={},
            node_preemptions={},
            deployment=plan.deployment,
            deployment_updates=list(plan.deployment_updates),
        )
        partial = False
        dup_nodes = self._duplicate_slot_nodes(snapshot, plan, fits)
        for node_id in plan.node_allocation:
            if fits[node_id] and node_id not in dup_nodes:
                result.node_allocation[node_id] = plan.node_allocation[node_id]
                if node_id in plan.node_preemptions:
                    result.node_preemptions[node_id] = plan.node_preemptions[node_id]
            elif node_id in dup_nodes:
                # NOT the node's fault — keep it out of the
                # plan-rejection / mark-ineligible tracker
                partial = True
                self.plans_duplicate_slot += 1
            else:
                partial = True
                self._note_node_rejection(node_id)
        if partial:
            # scheduler must refresh past this state and retry
            result.refresh_index = snapshot.latest_index()
            if plan.deployment is not None and not result.node_allocation:
                # nothing placed: drop the new deployment (the retry will
                # recreate it against fresh state)
                result.deployment = None
            self.plans_partial += 1
        else:
            self.plans_full += 1
        return result

    def _duplicate_slot_nodes(self, snapshot, plan: Plan,
                              fits: Dict[str, bool]) -> set:
        """Nodes whose placements would duplicate a live slot name.

        The token check at dequeue (``_validate_token``) catches plans
        whose broker lease was re-enqueued under THEM — but not the
        mirror race: after a leader failover the broker restore
        redelivers a still-pending eval whose previous plan ALREADY
        committed (the commit replicated; the worker's EVAL_UPDATE to
        complete did not). The twin holds a legitimately current token
        and a snapshot that can predate the first commit, so it
        re-places the same slots — on any node — and nothing downstream
        would object. This guard is the objection: a placement whose
        (namespace, job, slot name) already has a live alloc that this
        plan neither supersedes (same id re-placed: in-place update)
        nor removes (node_update / preemption) is rejected, and the
        partial-commit ``refresh_index`` sends the scheduler back for a
        fresh-snapshot retry, where reconcile sees the committed slots
        and places nothing. Canary placements are exempt both ways —
        a canary legitimately shares its slot name with the alloc it
        shadows, and rejecting it forever would wedge the deployment.
        System/sysbatch jobs place ``group[0]`` on EVERY node, so for
        them the collision scope narrows to the placement's own node —
        which still catches the twin (it re-places the same nodes).
        """
        job = plan.job
        same_node_only = job is not None and getattr(job, "type", "") in (
            consts.JOB_TYPE_SYSTEM, consts.JOB_TYPE_SYSBATCH)
        dup: set = set()
        remove_ids: set = set()
        for src in (plan.node_update, plan.node_preemptions):
            for allocs in src.values():
                remove_ids.update(a.id for a in allocs)
        plan_ids = {a.id for allocs in plan.node_allocation.values()
                    for a in allocs}
        live_cache: Dict[Tuple[str, str], List[Allocation]] = {}
        for node_id, placements in plan.node_allocation.items():
            if not fits.get(node_id):
                continue                    # already rejected
            for p in placements:
                if p.deployment_status is not None \
                        and p.deployment_status.canary:
                    continue
                key = (p.namespace, p.job_id)
                rows = live_cache.get(key)
                if rows is None:
                    rows = live_cache[key] = snapshot.allocs_by_job(*key)
                if any(a.name == p.name and a.id != p.id
                       and (not same_node_only or a.node_id == p.node_id)
                       and a.id not in remove_ids
                       and a.id not in plan_ids
                       and not a.terminal_status()
                       and not (a.deployment_status is not None
                                and a.deployment_status.canary)
                       for a in rows):
                    dup.add(node_id)
                    break
        return dup

    def _note_node_rejection(self, node_id: str) -> None:
        """One rejected node plan into the process-wide tracker
        (server/plan_rejection.py). Crossing the threshold fires the
        server's mark-ineligible callback SYNCHRONOUSLY on the applier
        thread — a raft apply, but a rare one (once per node per
        window at most), and serializing it here keeps the eligibility
        flip ordered before the batch's own commit responses. Failures
        never reach the applier loop."""
        try:
            from nomad_tpu_torch.server.plan_rejection import plan_rejections

            if plan_rejections.note_rejection(node_id) \
                    and self._on_node_rejection_threshold is not None:
                self._on_node_rejection_threshold(node_id)
        except Exception:                       # noqa: BLE001
            import logging

            logging.getLogger(__name__).warning(
                "plan-rejection tracking failed for node %s",
                node_id, exc_info=True)

    @staticmethod
    def _node_status_gates(node, placements) -> Optional[Tuple[bool, str]]:
        """The node-level gates of evaluateNodePlan, shared VERBATIM by
        the exact walk and the vectorized group check (so the two paths
        cannot drift). Returns a (fit, reason) verdict, or None when
        the gates pass and the resource fit check decides."""
        if node is None:
            return False, "node does not exist"
        if node.status == consts.NODE_STATUS_DISCONNECTED:
            # disconnect handling (plan_apply.go): a plan may touch a
            # disconnected node ONLY to mark its allocs unknown
            if all(a.client_status == consts.ALLOC_CLIENT_UNKNOWN
                   for a in placements):
                return True, ""
            return False, "node is disconnected and contains invalid updates"
        if node.status == consts.NODE_STATUS_DOWN:
            # a down node accepts only lost/unknown transitions
            if all(a.client_status in (consts.ALLOC_CLIENT_LOST,
                                       consts.ALLOC_CLIENT_UNKNOWN)
                   for a in placements):
                return True, ""
            return False, "node is down"
        if node.status != consts.NODE_STATUS_READY:
            return False, f"node is {node.status}"
        if node.drain:
            return False, "node is draining"
        if node.scheduling_eligibility == consts.NODE_SCHEDULING_INELIGIBLE:
            return False, "node is not eligible"
        return None

    def _evaluate_node_plan(
        self, snapshot, plan: Plan, node_id: str
    ) -> Tuple[bool, str]:
        """plan_apply.go:644 evaluateNodePlan."""
        placements = plan.node_allocation.get(node_id, [])
        if not placements:
            return True, ""
        node = snapshot.node_by_id(node_id)
        verdict = self._node_status_gates(node, placements)
        if verdict is not None:
            return verdict

        # proposed = existing (non-terminal) - updated - preempted + planned
        existing = [
            a for a in snapshot.allocs_by_node(node_id) if not a.terminal_status()
        ]
        remove_ids = {a.id for a in plan.node_update.get(node_id, [])}
        remove_ids |= {a.id for a in plan.node_preemptions.get(node_id, [])}
        proposed = [a for a in existing if a.id not in remove_ids]
        proposed.extend(placements)
        fit, reason, _util = allocs_fit(node, proposed, check_devices=True)
        return fit, reason
