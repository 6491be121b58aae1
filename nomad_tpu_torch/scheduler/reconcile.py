"""The allocation reconciler: desired state vs existing allocations.

Reference behavior: scheduler/reconcile.go (allocReconciler.Compute :204,
computeGroup :387) and reconcile_util.go (allocSet algebra,
filterByTainted :219, filterByRescheduleable :356, allocNameIndex :591).
Pure host-side set algebra -- not a hot path; placements it emits are
batched into the TPU kernel by the caller.

Round-1 scope notes (each tracked for later rounds):
- disconnect/reconnect: disconnecting allocs become 'unknown' updates
  with timeout follow-up evals and lost handling; the score-based
  keep-reconnecting-vs-replacement tiebreak (computeStopByReconnecting)
  prefers the replacement unless the reconnecting alloc is same-version.
- multiregion: regions beyond the strategy's first max_parallel wave
  create their deployment in the 'blocked' state and make no rollout
  progress until an earlier region's success unblocks them
  (structs.go:4133; the deployment watcher performs the cross-region
  kick over the federation layer).
"""

from __future__ import annotations

import threading as _threading
import time as _time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import Allocation
from nomad_tpu_torch.structs.eval_plan import Deployment, DeploymentState, Evaluation, new_deployment

# Status descriptions (reference reconcile.go:16-60 alloc* constants)
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_RECONNECTED = "alloc not needed due to reconnect"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_UPDATING = "alloc is being updated due to job update"
ALLOC_LOST = "alloc lost since its node is down"
ALLOC_UNKNOWN = "alloc is unknown since its node is disconnected"
ALLOC_IN_PLACE = "alloc updating in-place"
ALLOC_NODE_TAINTED = "alloc not needed as node is tainted"
ALLOC_RESCHEDULED = "alloc was rescheduled because it failed"

# batched reschedule window (reconcile.go:46 rescheduleWindowSize)
RESCHEDULE_WINDOW_S = 1.0

AllocSet = Dict[str, Allocation]


# ---------------------------------------------------------------------------
# allocSet algebra (reconcile_util.go)
# ---------------------------------------------------------------------------


def alloc_set(allocs) -> AllocSet:
    return {a.id: a for a in allocs}


def union(*sets: AllocSet) -> AllocSet:
    out: AllocSet = {}
    for s in sets:
        out.update(s)
    return out


def difference(a: AllocSet, *others: AllocSet) -> AllocSet:
    drop = set()
    for o in others:
        drop |= o.keys()
    return {k: v for k, v in a.items() if k not in drop}


def from_keys(a: AllocSet, keys) -> AllocSet:
    return {k: a[k] for k in keys if k in a}


def filter_by_terminal(a: AllocSet) -> AllocSet:
    return {k: v for k, v in a.items() if not v.terminal_status()}


def name_order(a: AllocSet) -> List[Allocation]:
    return sorted(a.values(), key=lambda x: (x.index(), x.id))


def new_alloc_matrix(job, allocs: List[Allocation]) -> Dict[str, AllocSet]:
    """allocMatrix: group name -> allocSet (reconcile_util.go:106)."""
    m: Dict[str, AllocSet] = {}
    for a in allocs:
        m.setdefault(a.task_group, {})[a.id] = a
    if job is not None and not job.stopped():
        for tg in job.task_groups:
            m.setdefault(tg.name, {})
    return m


def filter_by_tainted(
    a: AllocSet, tainted_nodes: Dict[str, object], supports_disconnected: bool,
    now: float,
) -> Tuple[AllocSet, AllocSet, AllocSet, AllocSet, AllocSet, AllocSet]:
    """(untainted, migrate, lost, disconnecting, reconnecting, ignore)
    -- reconcile_util.go:219."""
    untainted: AllocSet = {}
    migrate: AllocSet = {}
    lost: AllocSet = {}
    disconnecting: AllocSet = {}
    reconnecting: AllocSet = {}
    ignore: AllocSet = {}

    for aid, alloc in a.items():
        supports = supports_disconnected and _alloc_supports_disconnect(alloc)
        reconnected = False
        expired = False
        if supports and alloc.client_status in (
            consts.ALLOC_CLIENT_UNKNOWN,
            consts.ALLOC_CLIENT_RUNNING,
            consts.ALLOC_CLIENT_FAILED,
        ):
            reconnected, expired = _alloc_reconnected(alloc, now)

        if supports and reconnected and alloc.desired_status == consts.ALLOC_DESIRED_RUN \
                and alloc.client_status == consts.ALLOC_CLIENT_FAILED:
            reconnecting[aid] = alloc
            continue

        node = tainted_nodes.get(alloc.node_id)
        node_is_tainted = alloc.node_id in tainted_nodes
        if node is not None:
            if node.status == consts.NODE_STATUS_DISCONNECTED:
                if supports:
                    if alloc.client_status == consts.ALLOC_CLIENT_RUNNING:
                        disconnecting[aid] = alloc
                        continue
                    if alloc.client_status == consts.ALLOC_CLIENT_PENDING:
                        lost[aid] = alloc
                        continue
                else:
                    lost[aid] = alloc
                    continue
            elif node.status == consts.NODE_STATUS_READY and reconnected:
                if expired:
                    lost[aid] = alloc
                else:
                    reconnecting[aid] = alloc
                continue

        if alloc.terminal_status() and not reconnected:
            untainted[aid] = alloc
            continue
        if alloc.desired_transition.should_migrate():
            migrate[aid] = alloc
            continue
        if supports and _alloc_expired(alloc, now):
            lost[aid] = alloc
            continue
        if supports and alloc.client_status == consts.ALLOC_CLIENT_UNKNOWN \
                and alloc.desired_status == consts.ALLOC_DESIRED_RUN:
            ignore[aid] = alloc
            continue
        if supports and reconnected and alloc.client_status == consts.ALLOC_CLIENT_FAILED \
                and alloc.desired_status == consts.ALLOC_DESIRED_STOP:
            ignore[aid] = alloc
            continue
        if not node_is_tainted:
            if reconnected:
                if expired:
                    lost[aid] = alloc
                else:
                    reconnecting[aid] = alloc
                continue
            untainted[aid] = alloc
            continue
        if node is None or node.terminal_status():
            lost[aid] = alloc
        else:
            untainted[aid] = alloc

    return untainted, migrate, lost, disconnecting, reconnecting, ignore


def _alloc_supports_disconnect(alloc) -> bool:
    job = alloc.job
    if job is None:
        return False
    tg = job.lookup_task_group(alloc.task_group)
    return tg is not None and tg.max_client_disconnect_s is not None


def _alloc_reconnected(alloc, now: float) -> Tuple[bool, bool]:
    """structs.go Allocation.Reconnected: has a reconnect event and
    whether the disconnect window expired."""
    last_disconnect = None
    last_reconnect = None
    for ts in alloc.task_states.values():
        for e in ts.events:
            if e.type == "Disconnected":
                last_disconnect = max(last_disconnect or 0, e.time_ns)
            if e.type == "Reconnected":
                last_reconnect = max(last_reconnect or 0, e.time_ns)
    if last_reconnect is None:
        return False, False
    reconnected = last_disconnect is None or last_reconnect >= last_disconnect
    return reconnected, _alloc_expired(alloc, now)


def _alloc_expired(alloc, now: float) -> bool:
    if alloc.client_status != consts.ALLOC_CLIENT_UNKNOWN:
        return False
    job = alloc.job
    if job is None:
        return False
    tg = job.lookup_task_group(alloc.task_group)
    if tg is None or tg.max_client_disconnect_s is None:
        return False
    last_unknown = None
    for ts in alloc.task_states.values():
        for e in ts.events:
            if e.type == "Disconnected":
                last_unknown = max(last_unknown or 0, e.time_ns)
    if last_unknown is None:
        return False
    return (last_unknown / 1e9) + tg.max_client_disconnect_s < now


# ---------------------------------------------------------------------------
# per-(job, tg) reconcile invariants (the scaffold-cache idea applied
# to the reconciler): everything below depends only on the job SPEC, so
# re-deriving it per alloc per eval (task-group scans, reschedule-policy
# copies) is pure reconcile-slice overhead. Identity-keyed like
# scheduler/scaffold.py — store job rows are immutable and shared.
# ---------------------------------------------------------------------------


class _TGReconcileInfo:
    __slots__ = ("supports_disconnect", "max_client_disconnect_s",
                 "stop_after_client_disconnect_s", "policy",
                 "policy_enabled")

    def __init__(self, job, tg_name: str) -> None:
        tg = job.lookup_task_group(tg_name)
        self.supports_disconnect = (
            tg is not None and tg.max_client_disconnect_s is not None)
        self.max_client_disconnect_s = (
            tg.max_client_disconnect_s if tg is not None else None)
        self.stop_after_client_disconnect_s = (
            tg.stop_after_client_disconnect_s if tg is not None else None)
        # reschedule_policy_for returns a fresh DEFAULT copy per call;
        # the reconciler only READS the policy, so one shared instance
        # per (job, tg) is sound
        policy = job.reschedule_policy_for(tg_name)
        self.policy = policy
        self.policy_enabled = policy is not None and policy.enabled()


_RECON_INFO_MAX = 2048
_RECON_INFO: "OrderedDict[Tuple[int, str], Tuple[object, _TGReconcileInfo]]" \
    = OrderedDict()
_RECON_INFO_LOCK = _threading.Lock()


def reconcile_info_for(job, tg_name: str) -> _TGReconcileInfo:
    """The (job, tg) reconcile invariants, memoized per job OBJECT
    (entries pin the job and re-check identity, so a recycled ``id()``
    can never alias a dead job version)."""
    key = (id(job), tg_name)
    ent = _RECON_INFO.get(key)
    if ent is not None and ent[0] is job:
        return ent[1]
    built = _TGReconcileInfo(job, tg_name)
    with _RECON_INFO_LOCK:
        ent = _RECON_INFO.get(key)
        if ent is not None and ent[0] is job:
            return ent[1]
        _RECON_INFO[key] = (job, built)
        _RECON_INFO.move_to_end(key)
        while len(_RECON_INFO) > _RECON_INFO_MAX:
            _RECON_INFO.popitem(last=False)
    return built


def should_filter(alloc, is_batch: bool) -> Tuple[bool, bool]:
    """(untainted, ignore) -- reconcile_util.go:415 shouldFilter."""
    if is_batch:
        if alloc.desired_status == consts.ALLOC_DESIRED_STOP:
            if alloc.ran_successfully():
                return True, False
            return False, True
        if alloc.desired_status == consts.ALLOC_DESIRED_EVICT:
            return False, True
        if alloc.client_status != consts.ALLOC_CLIENT_FAILED:
            return True, False
        return False, False

    if alloc.desired_status in (consts.ALLOC_DESIRED_STOP, consts.ALLOC_DESIRED_EVICT):
        return False, True
    if alloc.client_status in (consts.ALLOC_CLIENT_COMPLETE, consts.ALLOC_CLIENT_LOST):
        return False, True
    return False, False


@dataclass
class DelayedRescheduleInfo:
    alloc_id: str
    alloc: Allocation
    reschedule_time_s: float


def filter_by_rescheduleable(
    a: AllocSet, is_batch: bool, is_disconnecting: bool, now: float,
    eval_id: str, deployment: Optional[Deployment],
) -> Tuple[AllocSet, AllocSet, List[DelayedRescheduleInfo]]:
    """reconcile_util.go:356."""
    untainted: AllocSet = {}
    reschedule_now: AllocSet = {}
    reschedule_later: List[DelayedRescheduleInfo] = []

    for aid, alloc in a.items():
        if is_disconnecting and alloc.client_status == consts.ALLOC_CLIENT_UNKNOWN:
            continue
        if alloc.next_allocation and alloc.terminal_status():
            continue
        is_untainted, ignore = should_filter(alloc, is_batch)
        if is_untainted and not is_disconnecting:
            untainted[aid] = alloc
        if is_untainted or ignore:
            continue

        eligible_now, eligible_later, resched_time = _update_by_reschedulable(
            alloc, now, eval_id, deployment, is_disconnecting
        )
        if not is_disconnecting and not eligible_now:
            untainted[aid] = alloc
            if eligible_later:
                reschedule_later.append(DelayedRescheduleInfo(aid, alloc, resched_time))
        else:
            reschedule_now[aid] = alloc
    return untainted, reschedule_now, reschedule_later


def _update_by_reschedulable(
    alloc, now: float, eval_id: str, d: Optional[Deployment], is_disconnecting: bool
) -> Tuple[bool, bool, float]:
    """reconcile_util.go:457 updateByReschedulable."""
    if d is not None and alloc.deployment_id == d.id and d.active() \
            and not alloc.desired_transition.reschedule:
        return False, False, 0.0
    if alloc.desired_transition.should_force_reschedule():
        return True, False, 0.0

    job = alloc.job
    policy = job.reschedule_policy_for(alloc.task_group) if job else None
    if policy is None or not policy.enabled():
        return False, False, 0.0
    fail_time = now if is_disconnecting else (alloc.modify_time_ns / 1e9)
    if not alloc.reschedule_eligible(policy, fail_time):
        return False, False, 0.0
    num_prior = len(alloc.reschedule_tracker.events) if alloc.reschedule_tracker else 0
    resched_time = fail_time + alloc._next_delay(policy, num_prior)
    eligible = alloc.client_status == consts.ALLOC_CLIENT_FAILED or is_disconnecting
    if not eligible:
        return False, False, 0.0
    if alloc.follow_up_eval_id == eval_id or (resched_time - now) <= RESCHEDULE_WINDOW_S:
        return True, False, resched_time
    if not alloc.follow_up_eval_id:
        return False, True, resched_time
    return False, False, 0.0


# ---------------------------------------------------------------------------
# fused group classification (the reconcile fast path)
#
# The legacy pipeline walks every alloc of a group FOUR times
# (filter_by_tainted -> should_filter -> filter_by_rescheduleable ->
# _update_by_reschedulable) and rebuilds an AllocSet dict per stage.
# ``classify_group`` computes each alloc's full disposition in ONE pass
# over one stable table, using the memoized per-(job, tg) invariants —
# bit-identical to the legacy composition (property-tested in
# tests/test_reconcile_fast.py, including result-list ORDER, which the
# dict insertion orders here reproduce exactly).
# ---------------------------------------------------------------------------


@dataclass
class GroupClassification:
    """One group's alloc dispositions, computed in a single pass."""

    untainted: AllocSet
    migrate: AllocSet
    lost: AllocSet
    disconnecting: AllocSet
    reconnecting: AllocSet
    ignore: int
    reschedule_now: AllocSet
    reschedule_later: List[DelayedRescheduleInfo]


def _alloc_expired_info(alloc, now: float, info) -> bool:
    """``_alloc_expired`` with the (job, tg) lookup memoized away."""
    if alloc.client_status != consts.ALLOC_CLIENT_UNKNOWN:
        return False
    if info is None or info.max_client_disconnect_s is None:
        return False
    last_unknown = None
    for ts in alloc.task_states.values():
        for e in ts.events:
            if e.type == "Disconnected":
                last_unknown = max(last_unknown or 0, e.time_ns)
    if last_unknown is None:
        return False
    return (last_unknown / 1e9) + info.max_client_disconnect_s < now


def _alloc_reconnected_info(alloc, now: float, info) -> Tuple[bool, bool]:
    """``_alloc_reconnected`` with the memoized invariants."""
    last_disconnect = None
    last_reconnect = None
    for ts in alloc.task_states.values():
        for e in ts.events:
            if e.type == "Disconnected":
                last_disconnect = max(last_disconnect or 0, e.time_ns)
            if e.type == "Reconnected":
                last_reconnect = max(last_reconnect or 0, e.time_ns)
    if last_reconnect is None:
        return False, False
    reconnected = last_disconnect is None or last_reconnect >= last_disconnect
    return reconnected, _alloc_expired_info(alloc, now, info)


def _update_by_reschedulable_info(
    alloc, now: float, eval_id: str, d: Optional[Deployment],
    d_active: bool, is_disconnecting: bool, info,
) -> Tuple[bool, bool, float]:
    """``_update_by_reschedulable`` riding the memoized policy."""
    if d is not None and alloc.deployment_id == d.id and d_active \
            and not alloc.desired_transition.reschedule:
        return False, False, 0.0
    if alloc.desired_transition.force_reschedule:
        return True, False, 0.0
    if not is_disconnecting \
            and alloc.client_status != consts.ALLOC_CLIENT_FAILED:
        # every remaining branch of the reference ends at the
        # ``eligible`` check, which needs FAILED-or-disconnecting —
        # the policy/eligibility/delay walk below cannot change this
        # alloc's (False, False, 0.0) outcome, and it is the entire
        # per-alloc cost of the steady RUNNING population
        return False, False, 0.0
    if info is None or not info.policy_enabled:
        return False, False, 0.0
    policy = info.policy
    fail_time = now if is_disconnecting else (alloc.modify_time_ns / 1e9)
    if not alloc.reschedule_eligible(policy, fail_time):
        return False, False, 0.0
    num_prior = len(alloc.reschedule_tracker.events) if alloc.reschedule_tracker else 0
    resched_time = fail_time + alloc._next_delay(policy, num_prior)
    eligible = alloc.client_status == consts.ALLOC_CLIENT_FAILED or is_disconnecting
    if not eligible:
        return False, False, 0.0
    if alloc.follow_up_eval_id == eval_id or (resched_time - now) <= RESCHEDULE_WINDOW_S:
        return True, False, resched_time
    if not alloc.follow_up_eval_id:
        return False, True, resched_time
    return False, False, 0.0


def classify_group(
    a: AllocSet, tainted_nodes: Dict[str, object], supports_disconnected: bool,
    now: float, is_batch: bool, eval_id: str, deployment: Optional[Deployment],
) -> GroupClassification:
    """The fused single pass: filter_by_tainted + both
    filter_by_rescheduleable calls + their union, with one disposition
    computation per alloc."""
    untainted: AllocSet = {}
    migrate: AllocSet = {}
    lost: AllocSet = {}
    disconnecting: AllocSet = {}
    reconnecting: AllocSet = {}
    n_ignore = 0
    # reschedule_now's legacy order: the untainted-pass entries first
    # (in untainted order), then the disconnecting-pass entries (the
    # union(reschedule_now, resched_disc) semantics)
    resched_unt: AllocSet = {}
    resched_disc: AllocSet = {}
    later: List[DelayedRescheduleInfo] = []

    d_active = deployment is not None and deployment.active()
    any_tainted = bool(tainted_nodes)
    # per-call memo over the module cache: within one group the allocs
    # share a handful of job objects (task_group is constant — the
    # matrix groups by it), so the common lookup is one dict hit
    info_cache: Dict[int, object] = {}

    for aid, alloc in a.items():
        job = alloc.job
        if job is None:
            info = None
        else:
            jkey = id(job)
            info = info_cache.get(jkey)
            if info is None:
                info = info_cache[jkey] = reconcile_info_for(
                    job, alloc.task_group)
        supports = supports_disconnected and info is not None \
            and info.supports_disconnect

        # ---- the filter_by_tainted disposition, verbatim ----
        reconnected = False
        expired = False
        if supports and alloc.client_status in (
            consts.ALLOC_CLIENT_UNKNOWN,
            consts.ALLOC_CLIENT_RUNNING,
            consts.ALLOC_CLIENT_FAILED,
        ):
            reconnected, expired = _alloc_reconnected_info(alloc, now, info)

        if supports and reconnected \
                and alloc.desired_status == consts.ALLOC_DESIRED_RUN \
                and alloc.client_status == consts.ALLOC_CLIENT_FAILED:
            reconnecting[aid] = alloc
            continue

        if any_tainted:
            node = tainted_nodes.get(alloc.node_id)
            node_is_tainted = alloc.node_id in tainted_nodes
        else:
            node = None
            node_is_tainted = False
        if node is not None:
            if node.status == consts.NODE_STATUS_DISCONNECTED:
                if supports:
                    if alloc.client_status == consts.ALLOC_CLIENT_RUNNING:
                        # -> disconnecting (kept in the set AND run
                        # through the disc-side reschedule filter below)
                        disconnecting[aid] = alloc
                        # disc-side reschedule filter: client status is
                        # RUNNING here, so the is_disconnecting UNKNOWN
                        # skip can never hit; every survivor of the
                        # shared early filters joins reschedule_now
                        # regardless of policy eligibility (legacy
                        # filter_by_rescheduleable(is_disconnecting=True))
                        if alloc.next_allocation and alloc.terminal_status():
                            continue
                        is_unt, ign = should_filter(alloc, is_batch)
                        if is_unt or ign:
                            continue
                        resched_disc[aid] = alloc
                        continue
                    if alloc.client_status == consts.ALLOC_CLIENT_PENDING:
                        lost[aid] = alloc
                        continue
                else:
                    lost[aid] = alloc
                    continue
            elif node.status == consts.NODE_STATUS_READY and reconnected:
                if expired:
                    lost[aid] = alloc
                else:
                    reconnecting[aid] = alloc
                continue

        if alloc.terminal_status() and not reconnected:
            pass        # -> untainted (reschedule filter below)
        elif alloc.desired_transition.migrate:
            migrate[aid] = alloc
            continue
        elif supports and _alloc_expired_info(alloc, now, info):
            lost[aid] = alloc
            continue
        elif supports and alloc.client_status == consts.ALLOC_CLIENT_UNKNOWN \
                and alloc.desired_status == consts.ALLOC_DESIRED_RUN:
            n_ignore += 1
            continue
        elif supports and reconnected \
                and alloc.client_status == consts.ALLOC_CLIENT_FAILED \
                and alloc.desired_status == consts.ALLOC_DESIRED_STOP:
            n_ignore += 1
            continue
        elif not node_is_tainted:
            if reconnected:
                if expired:
                    lost[aid] = alloc
                else:
                    reconnecting[aid] = alloc
                continue
            # -> untainted
        elif node is None or node.terminal_status():
            lost[aid] = alloc
            continue
        # else -> untainted

        # ---- the untainted-side reschedule filter, verbatim ----
        if alloc.next_allocation and alloc.terminal_status():
            continue
        is_unt, ign = should_filter(alloc, is_batch)
        if is_unt:
            untainted[aid] = alloc
            continue
        if ign:
            continue
        eligible_now, eligible_later, resched_time = \
            _update_by_reschedulable_info(
                alloc, now, eval_id, deployment, d_active, False, info)
        if not eligible_now:
            untainted[aid] = alloc
            if eligible_later:
                later.append(DelayedRescheduleInfo(aid, alloc, resched_time))
        else:
            resched_unt[aid] = alloc

    if resched_disc:
        resched_unt.update(resched_disc)
    return GroupClassification(
        untainted=untainted, migrate=migrate, lost=lost,
        disconnecting=disconnecting, reconnecting=reconnecting,
        ignore=n_ignore, reschedule_now=resched_unt,
        reschedule_later=later,
    )


# ---------------------------------------------------------------------------
# allocNameIndex (reconcile_util.go:591)
# ---------------------------------------------------------------------------


class AllocNameIndex:
    """Tracks which "<job>.<group>[i]" indexes are in use.

    ``in_use`` accepts an AllocSet dict or any iterable of allocs —
    callers with several sets chain them instead of building a union
    dict just to read the indexes out of it.
    """

    def __init__(self, job_id: str, group: str, count: int, in_use) -> None:
        self.job_id = job_id
        self.group = group
        self.count = count
        self.taken: set = set()
        values = in_use.values() if hasattr(in_use, "values") else in_use
        for a in values:
            idx = a.index()
            if idx >= 0:
                self.taken.add(idx)

    def _name(self, idx: int) -> str:
        return f"{self.job_id}.{self.group}[{idx}]"

    def next(self, n: int) -> List[str]:
        """Claim the n lowest unused indexes (reconcile_util.go:737)."""
        out = []
        idx = 0
        while len(out) < n:
            if idx not in self.taken:
                out.append(self._name(idx))
                self.taken.add(idx)
            idx += 1
        return out

    def highest(self, n: int) -> set:
        """Names of the n highest used indexes (reconcile_util.go:647)."""
        out = set()
        for idx in sorted(self.taken, reverse=True):
            if len(out) >= n:
                break
            out.add(self._name(idx))
        return out

    def unset_index(self, idx: int) -> None:
        self.taken.discard(idx)

    def next_canaries(self, n: int, existing: AllocSet, destructive: AllocSet) -> List[str]:
        """reconcile_util.go:682: prefer replacing destructive names."""
        existing_names = {a.name for a in existing.values()}
        out = []
        for a in name_order(destructive):
            if len(out) >= n:
                break
            if a.name not in existing_names:
                out.append(a.name)
                existing_names.add(a.name)
        idx = 0
        while len(out) < n:
            name = self._name(idx)
            if name not in existing_names:
                out.append(name)
                existing_names.add(name)
            idx += 1
        return out


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclass
class AllocPlaceResult:
    """reconcile_util.go allocPlaceResult."""

    name: str = ""
    canary: bool = False
    task_group: Optional[object] = None
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    lost: bool = False
    downgrade_non_canary: bool = False
    min_job_version: int = 0

    def stop_previous_alloc(self) -> Tuple[bool, str]:
        return False, ""


@dataclass
class AllocDestructiveResult:
    place_name: str = ""
    place_task_group: Optional[object] = None
    stop_alloc: Optional[Allocation] = None
    stop_status_description: str = ""

    @property
    def name(self) -> str:
        return self.place_name

    @property
    def task_group(self):
        return self.place_task_group

    @property
    def previous_alloc(self):
        return self.stop_alloc

    def stop_previous_alloc(self) -> Tuple[bool, str]:
        return True, self.stop_status_description


@dataclass
class AllocStopResult:
    alloc: Allocation
    client_status: str = ""
    status_description: str = ""
    followup_eval_id: str = ""


@dataclass
class DesiredUpdates:
    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
    canary: int = 0
    preemptions: int = 0


@dataclass
class ReconcileResults:
    """reconcile.go reconcileResults."""

    deployment: Optional[Deployment] = None
    deployment_updates: List[Dict] = field(default_factory=list)
    place: List[AllocPlaceResult] = field(default_factory=list)
    destructive_update: List[AllocDestructiveResult] = field(default_factory=list)
    inplace_update: List[Allocation] = field(default_factory=list)
    stop: List[AllocStopResult] = field(default_factory=list)
    attribute_updates: Dict[str, Allocation] = field(default_factory=dict)
    disconnect_updates: Dict[str, Allocation] = field(default_factory=dict)
    reconnect_updates: Dict[str, Allocation] = field(default_factory=dict)
    desired_tg_updates: Dict[str, DesiredUpdates] = field(default_factory=dict)
    desired_followup_evals: Dict[str, List[Evaluation]] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# The reconciler
# ---------------------------------------------------------------------------


class AllocReconciler:
    """reconcile.go allocReconciler."""

    def __init__(
        self,
        alloc_update_fn: Callable,
        batch: bool,
        job_id: str,
        job,
        deployment: Optional[Deployment],
        existing_allocs: List[Allocation],
        tainted_nodes: Dict[str, object],
        eval_id: str,
        eval_priority: int,
        supports_disconnected_clients: bool = True,
        now: Optional[float] = None,
        use_legacy_filters: bool = False,
    ) -> None:
        self.alloc_update_fn = alloc_update_fn
        self.batch = batch
        self.job_id = job_id
        self.job = job
        self.deployment = deployment.copy() if deployment else None
        self.old_deployment: Optional[Deployment] = None
        self.existing_allocs = existing_allocs
        self.tainted_nodes = tainted_nodes
        self.eval_id = eval_id
        self.eval_priority = eval_priority
        self.supports_disconnected = supports_disconnected_clients
        self.now = now if now is not None else _time.time()
        # False = the fused single-pass classifier (classify_group);
        # True = the reference multi-pass composition it is
        # property-tested bit-identical against
        self.use_legacy_filters = use_legacy_filters
        self.deployment_paused = False
        self.deployment_failed = False
        self.result = ReconcileResults()

    # -- top level (reconcile.go:204) ------------------------------------

    def compute(self) -> ReconcileResults:
        m = new_alloc_matrix(self.job, self.existing_allocs)
        self._cancel_unneeded_deployments()

        if self.job.stopped():
            self._handle_stop(m)
            return self.result

        self._compute_deployment_paused()
        complete = True
        for group, allocs in m.items():
            complete = self._compute_group(group, allocs) and complete
        self._compute_deployment_updates(complete)
        return self.result

    def _compute_deployment_updates(self, deployment_complete: bool) -> None:
        if self.deployment is not None and deployment_complete:
            self.result.deployment_updates.append(
                {
                    "deployment_id": self.deployment.id,
                    "status": consts.DEPLOYMENT_STATUS_SUCCESSFUL,
                    "status_description": "Deployment completed successfully",
                }
            )
        d = self.result.deployment
        if d is not None and d.requires_promotion():
            if d.has_auto_promote():
                d.status_description = "Deployment is running pending automatic promotion"
            else:
                d.status_description = "Deployment is running but requires manual promotion"

    def _compute_deployment_paused(self) -> None:
        if self.deployment is None \
                and not getattr(self, "_version_deployed", False) \
                and self.job.multiregion \
                and self.job.multiregion_starts_blocked():
            # a gated region's FIRST eval for this job version: there
            # is no deployment row yet, but initial placements must
            # wait for the earlier region — treat as paused from the
            # start (the blocked deployment row is created below so
            # the unblock kick has something to release). Once this
            # version has a successful deployment here, replacement
            # evals must NOT re-engage the gate.
            self.deployment_paused = True
            return
        if self.deployment is not None:
            # blocked multiregion deployments behave like paused ones:
            # no rollout progress until an earlier region unblocks them
            self.deployment_paused = self.deployment.status in (
                consts.DEPLOYMENT_STATUS_PAUSED,
                consts.DEPLOYMENT_STATUS_PENDING,
                consts.DEPLOYMENT_STATUS_BLOCKED,
            )
            self.deployment_failed = (
                self.deployment.status == consts.DEPLOYMENT_STATUS_FAILED
            )

    def _cancel_unneeded_deployments(self) -> None:
        if self.job.stopped():
            if self.deployment is not None and self.deployment.active():
                self.result.deployment_updates.append(
                    {
                        "deployment_id": self.deployment.id,
                        "status": consts.DEPLOYMENT_STATUS_CANCELLED,
                        "status_description": "Cancelled because job is stopped",
                    }
                )
            self.old_deployment = self.deployment
            self.deployment = None
            return
        d = self.deployment
        if d is None:
            return
        if d.job_create_index != self.job.create_index or d.job_version != self.job.version:
            if d.active():
                self.result.deployment_updates.append(
                    {
                        "deployment_id": d.id,
                        "status": consts.DEPLOYMENT_STATUS_CANCELLED,
                        "status_description": "Cancelled due to newer version of job",
                    }
                )
            self.old_deployment = d
            self.deployment = None
        elif d.status == consts.DEPLOYMENT_STATUS_SUCCESSFUL:
            self.old_deployment = d
            self.deployment = None
            # this job version already rolled out here: the multiregion
            # gate must not re-engage for replacement evals
            self._version_deployed = True

    def _handle_stop(self, m: Dict[str, AllocSet]) -> None:
        for group, allocs in m.items():
            allocs = filter_by_terminal(allocs)
            du = DesiredUpdates()
            du.stop = self._filter_and_stop_all(allocs)
            self.result.desired_tg_updates[group] = du

    def _filter_and_stop_all(self, s: AllocSet) -> int:
        untainted, migrate, lost, disconnecting, reconnecting, ignore = filter_by_tainted(
            s, self.tainted_nodes, self.supports_disconnected, self.now
        )
        self._mark_stop(untainted, "", ALLOC_NOT_NEEDED)
        self._mark_stop(migrate, "", ALLOC_NOT_NEEDED)
        self._mark_stop(lost, consts.ALLOC_CLIENT_LOST, ALLOC_LOST)
        self._mark_stop(disconnecting, "", ALLOC_NOT_NEEDED)
        self._mark_stop(reconnecting, "", ALLOC_NOT_NEEDED)
        self._mark_stop(
            {k: v for k, v in ignore.items()
             if v.client_status == consts.ALLOC_CLIENT_UNKNOWN},
            "", ALLOC_NOT_NEEDED,
        )
        return len(s)

    def _mark_stop(self, allocs: AllocSet, client_status: str, desc: str) -> None:
        for a in allocs.values():
            self.result.stop.append(
                AllocStopResult(alloc=a, client_status=client_status,
                                status_description=desc)
            )

    def _mark_delayed(self, allocs: AllocSet, client_status: str, desc: str,
                      followup: Dict[str, str]) -> None:
        for a in allocs.values():
            self.result.stop.append(
                AllocStopResult(
                    alloc=a, client_status=client_status, status_description=desc,
                    followup_eval_id=followup.get(a.id, ""),
                )
            )

    # -- per group (reconcile.go:387 computeGroup) -----------------------

    def _compute_group(self, group_name: str, all_allocs: AllocSet) -> bool:
        du = DesiredUpdates()
        self.result.desired_tg_updates[group_name] = du

        tg = self.job.lookup_task_group(group_name)
        if tg is None:
            du.stop = self._filter_and_stop_all(all_allocs)
            return True

        dstate, existing_deployment = self._init_deployment_state(group_name, tg)

        all_allocs, ignore = self._filter_old_terminal_allocs(all_allocs)
        du.ignore += len(ignore)

        canaries, all_allocs = self._cancel_unneeded_canaries(all_allocs, du)

        if self.use_legacy_filters:
            # the reference multi-pass composition: kept as the
            # semantics definition the fused pass is property-tested
            # against (tests/test_reconcile_fast.py)
            untainted, migrate, lost, disconnecting, reconnecting, ignore = \
                filter_by_tainted(
                    all_allocs, self.tainted_nodes,
                    self.supports_disconnected, self.now)
            du.ignore += len(ignore)
            untainted, reschedule_now, reschedule_later = \
                filter_by_rescheduleable(
                    untainted, self.batch, False, self.now, self.eval_id,
                    self.deployment)
            _, resched_disc, _ = filter_by_rescheduleable(
                disconnecting, self.batch, True, self.now, self.eval_id,
                self.deployment)
            reschedule_now = union(reschedule_now, resched_disc)
        else:
            cls = classify_group(
                all_allocs, self.tainted_nodes, self.supports_disconnected,
                self.now, self.batch, self.eval_id, self.deployment)
            untainted = cls.untainted
            migrate = cls.migrate
            lost = cls.lost
            disconnecting = cls.disconnecting
            reconnecting = cls.reconnecting
            du.ignore += cls.ignore
            reschedule_now = cls.reschedule_now
            reschedule_later = cls.reschedule_later

        # lost allocs with stop_after_client_disconnect delay
        lost_later = self._delay_by_stop_after_disconnect(lost)
        lost_later_evals = self._create_lost_later_evals(lost_later, tg.name)

        # disconnecting -> unknown + timeout follow-ups
        timeout_later_evals = self._create_timeout_later_evals(disconnecting, tg.name)
        lost_later_evals.update(timeout_later_evals)

        self._create_reschedule_later_evals(reschedule_later, all_allocs, tg.name)

        name_index = AllocNameIndex(
            self.job_id, group_name, tg.count,
            (a for s in (untainted, migrate, reschedule_now, lost)
             for a in s.values()),
        )

        is_canarying = (
            dstate is not None and dstate.desired_canaries != 0 and not dstate.promoted
        )
        stop, reconnecting = self._compute_stop(
            tg, name_index, untainted, migrate, lost, canaries, reconnecting,
            is_canarying, lost_later_evals,
        )
        du.stop += len(stop)
        # in-place removal (both classification paths hand this method
        # a fresh dict it owns): same content and order as
        # ``difference(untainted, stop)`` without building another dict
        for aid in stop:
            untainted.pop(aid, None)

        self._compute_reconnecting(reconnecting)
        du.ignore += len(self.result.reconnect_updates)

        ignore2, inplace, destructive = self._compute_updates(tg, untainted)
        du.ignore += len(ignore2)
        du.in_place_update += len(inplace)
        if not existing_deployment:
            dstate.desired_total += len(destructive) + len(inplace)

        if is_canarying:
            untainted = difference(untainted, canaries)

        requires_canaries = (
            tg.update is not None
            and len(destructive) != 0
            and len(canaries) < tg.update.canary
            and not (dstate is not None and dstate.promoted)
        )
        if requires_canaries:
            self._compute_canaries(tg, dstate, destructive, canaries, du, name_index)

        is_canarying = (
            dstate is not None and dstate.desired_canaries != 0 and not dstate.promoted
        )
        under_provisioned_by = self._compute_under_provisioned_by(
            tg, untainted, destructive, migrate, is_canarying
        )

        place: List[AllocPlaceResult] = []
        if not lost_later:
            place = self._compute_placements(
                tg, name_index, untainted, migrate, reschedule_now, lost,
                reconnecting, is_canarying,
            )
            if not existing_deployment:
                dstate.desired_total += len(place)

        deployment_place_ready = (
            not self.deployment_paused and not self.deployment_failed and not is_canarying
        )
        under_provisioned_by = self._compute_replacements(
            deployment_place_ready, du, place, reschedule_now, lost,
            under_provisioned_by,
        )

        if deployment_place_ready:
            self._compute_destructive_updates(destructive, under_provisioned_by, du, tg)
        else:
            du.ignore += len(destructive)

        self._compute_migrations(du, migrate, tg, is_canarying)
        self._create_deployment(
            tg.name, tg.update, existing_deployment, dstate, all_allocs, destructive
        )

        return self._is_deployment_complete(
            group_name, destructive, inplace, migrate, reschedule_now, place,
            reschedule_later, requires_canaries,
        )

    # -- helpers ---------------------------------------------------------

    def _init_deployment_state(self, group: str, tg) -> Tuple[DeploymentState, bool]:
        dstate = None
        existing = False
        if self.deployment is not None:
            dstate = self.deployment.task_groups.get(group)
            existing = dstate is not None
        if not existing:
            dstate = DeploymentState()
            if tg.update is not None and not tg.update.is_empty():
                dstate.auto_revert = tg.update.auto_revert
                dstate.auto_promote = tg.update.auto_promote
                dstate.progress_deadline_s = tg.update.progress_deadline_s
        return dstate, existing

    def _filter_old_terminal_allocs(self, all_allocs: AllocSet) -> Tuple[AllocSet, AllocSet]:
        if not self.batch:
            return all_allocs, {}
        filtered = dict(all_allocs)
        ignored = {}
        for aid, a in list(filtered.items()):
            job = a.job
            older = job is not None and (
                job.version < self.job.version or job.create_index < self.job.create_index
            )
            if older and a.terminal_status():
                del filtered[aid]
                ignored[aid] = a
        return filtered, ignored

    def _cancel_unneeded_canaries(self, all_allocs: AllocSet, du: DesiredUpdates):
        if self.old_deployment is None and self.deployment is None:
            # no deployment anywhere: no canaries can exist, and the
            # legacy fall-through would only rebuild all_allocs as an
            # identical dict (difference against nothing)
            return {}, all_allocs
        stop_ids: List[str] = []
        if self.old_deployment is not None:
            for ds in self.old_deployment.task_groups.values():
                if not ds.promoted:
                    stop_ids.extend(ds.placed_canaries)
        if self.deployment is not None and self.deployment.status == consts.DEPLOYMENT_STATUS_FAILED:
            for ds in self.deployment.task_groups.values():
                if not ds.promoted:
                    stop_ids.extend(ds.placed_canaries)
        stop_set = from_keys(all_allocs, stop_ids)
        self._mark_stop(stop_set, "", ALLOC_NOT_NEEDED)
        du.stop += len(stop_set)
        all_allocs = difference(all_allocs, stop_set)

        canaries: AllocSet = {}
        if self.deployment is not None:
            ids = []
            for ds in self.deployment.task_groups.values():
                ids.extend(ds.placed_canaries)
            canaries = from_keys(all_allocs, ids)
            untainted, migrate, lost, _, _, _ = filter_by_tainted(
                canaries, self.tainted_nodes, self.supports_disconnected, self.now
            )
            self._mark_stop(migrate, "", ALLOC_MIGRATING)
            self._mark_stop(lost, consts.ALLOC_CLIENT_LOST, ALLOC_LOST)
            canaries = untainted
            all_allocs = difference(all_allocs, migrate, lost)
        return canaries, all_allocs

    def _compute_under_provisioned_by(self, tg, untainted, destructive, migrate,
                                      is_canarying: bool) -> int:
        if tg.update is None or tg.update.is_empty() or \
                len(destructive) + len(migrate) == 0:
            return tg.count
        if self.deployment is None:
            return tg.update.max_parallel
        if self.deployment_paused or self.deployment_failed or is_canarying:
            return 0
        limit = tg.update.max_parallel
        for a in untainted.values():
            if a.deployment_id != self.deployment.id:
                continue
            if a.deployment_status is not None and a.deployment_status.is_unhealthy():
                return 0
            if a.deployment_status is None or not a.deployment_status.is_healthy():
                limit -= 1
        return max(limit, 0)

    def _compute_placements(self, tg, name_index, untainted, migrate,
                            reschedule, lost, reconnecting,
                            is_canarying: bool) -> List[AllocPlaceResult]:
        place: List[AllocPlaceResult] = []
        for a in name_order(reschedule):
            place.append(
                AllocPlaceResult(
                    name=a.name, task_group=tg, previous_alloc=a, reschedule=True,
                    canary=a.deployment_status.canary if a.deployment_status else False,
                    downgrade_non_canary=is_canarying
                    and not (a.deployment_status and a.deployment_status.canary),
                    min_job_version=a.job_version,
                )
            )
        failed_reconnects = {
            k: v for k, v in reconnecting.items()
            if v.client_status == consts.ALLOC_CLIENT_FAILED
        }
        existing = (
            len(untainted) + len(migrate) + len(reschedule) + len(reconnecting)
            - len(failed_reconnects)
        )
        for a in name_order(lost):
            if existing >= tg.count:
                break
            existing += 1
            place.append(
                AllocPlaceResult(
                    name=a.name, task_group=tg, previous_alloc=a, reschedule=False,
                    lost=True,
                    canary=a.deployment_status.canary if a.deployment_status else False,
                    downgrade_non_canary=is_canarying
                    and not (a.deployment_status and a.deployment_status.canary),
                    min_job_version=a.job_version,
                )
            )
        if existing < tg.count:
            for name in name_index.next(tg.count - existing):
                place.append(
                    AllocPlaceResult(
                        name=name, task_group=tg,
                        downgrade_non_canary=is_canarying,
                    )
                )
        return place

    def _compute_replacements(self, deployment_place_ready: bool, du, place,
                              reschedule_now, lost, under_provisioned_by: int) -> int:
        failed = {
            k: v for k, v in reschedule_now.items()
            if k not in self.result.disconnect_updates
        }
        if deployment_place_ready:
            du.place += len(place)
            self.result.place.extend(place)
            self._mark_stop(failed, "", ALLOC_RESCHEDULED)
            du.stop += len(failed)
            return max(under_provisioned_by - min(len(place), under_provisioned_by), 0)

        if lost:
            allowed = min(len(lost), len(place))
            du.place += allowed
            self.result.place.extend(place[:allowed])

        if not reschedule_now or not place:
            return under_provisioned_by

        for p in place:
            prev = p.previous_alloc
            part_of_failed = (
                self.deployment_failed and prev is not None
                and self.deployment is not None
                and self.deployment.id == prev.deployment_id
            )
            if not part_of_failed and p.reschedule:
                self.result.place.append(p)
                du.place += 1
                if prev is not None and prev.id not in self.result.disconnect_updates:
                    self.result.stop.append(
                        AllocStopResult(alloc=prev, status_description=ALLOC_RESCHEDULED)
                    )
                    du.stop += 1
        return under_provisioned_by

    def _compute_destructive_updates(self, destructive: AllocSet,
                                     under_provisioned_by: int, du, tg) -> None:
        limit = min(len(destructive), under_provisioned_by)
        du.destructive_update += limit
        du.ignore += len(destructive) - limit
        for a in name_order(destructive)[:limit]:
            self.result.destructive_update.append(
                AllocDestructiveResult(
                    place_name=a.name, place_task_group=tg, stop_alloc=a,
                    stop_status_description=ALLOC_UPDATING,
                )
            )

    def _compute_migrations(self, du, migrate: AllocSet, tg, is_canarying: bool) -> None:
        du.migrate += len(migrate)
        for a in name_order(migrate):
            self.result.stop.append(
                AllocStopResult(alloc=a, status_description=ALLOC_MIGRATING)
            )
            self.result.place.append(
                AllocPlaceResult(
                    name=a.name, task_group=tg, previous_alloc=a,
                    canary=a.deployment_status.canary if a.deployment_status else False,
                    downgrade_non_canary=is_canarying
                    and not (a.deployment_status and a.deployment_status.canary),
                    min_job_version=a.job_version,
                )
            )

    def _compute_canaries(self, tg, dstate, destructive, canaries, du, name_index) -> None:
        dstate.desired_canaries = tg.update.canary
        if not self.deployment_paused and not self.deployment_failed:
            want = tg.update.canary - len(canaries)
            du.canary += want
            for name in name_index.next_canaries(want, canaries, destructive):
                self.result.place.append(
                    AllocPlaceResult(name=name, canary=True, task_group=tg)
                )

    def _compute_stop(self, tg, name_index, untainted, migrate, lost, canaries,
                      reconnecting, is_canarying, followup_evals) -> Tuple[AllocSet, AllocSet]:
        stop: AllocSet = {}
        stop.update(lost)
        self._mark_delayed(lost, consts.ALLOC_CLIENT_LOST, ALLOC_LOST, followup_evals)

        failed_reconnects = {
            k: v for k, v in reconnecting.items()
            if v.client_status == consts.ALLOC_CLIENT_FAILED
        }
        stop.update(failed_reconnects)
        self._mark_stop(failed_reconnects, consts.ALLOC_CLIENT_FAILED, ALLOC_RESCHEDULED)
        reconnecting = difference(reconnecting, failed_reconnects)

        if is_canarying:
            untainted = difference(untainted, canaries)
        remove = len(untainted) + len(migrate) + len(reconnecting) - tg.count
        if remove <= 0:
            return stop, reconnecting

        untainted = filter_by_terminal(untainted)

        if not is_canarying and canaries:
            canary_names = {a.name for a in canaries.values()}
            for aid, a in list(difference(untainted, canaries).items()):
                if a.name in canary_names:
                    stop[aid] = a
                    self.result.stop.append(
                        AllocStopResult(alloc=a, status_description=ALLOC_NOT_NEEDED)
                    )
                    del untainted[aid]
                    remove -= 1
                    if remove == 0:
                        return stop, reconnecting

        if migrate:
            migrating_names = AllocNameIndex(self.job_id, tg.name, tg.count, migrate)
            remove_names = migrating_names.highest(remove)
            for aid, a in list(migrate.items()):
                if a.name not in remove_names:
                    continue
                self.result.stop.append(
                    AllocStopResult(alloc=a, status_description=ALLOC_NOT_NEEDED)
                )
                del migrate[aid]
                stop[aid] = a
                name_index.unset_index(a.index())
                remove -= 1
                if remove == 0:
                    return stop, reconnecting

        if reconnecting:
            remove = self._compute_stop_by_reconnecting(
                untainted, reconnecting, stop, remove
            )
            if remove == 0:
                return stop, reconnecting

        remove_names = name_index.highest(remove)
        for aid, a in list(untainted.items()):
            if a.name in remove_names:
                stop[aid] = a
                self.result.stop.append(
                    AllocStopResult(alloc=a, status_description=ALLOC_NOT_NEEDED)
                )
                del untainted[aid]
                remove -= 1
                if remove == 0:
                    return stop, reconnecting

        for aid, a in list(untainted.items()):
            stop[aid] = a
            self.result.stop.append(
                AllocStopResult(alloc=a, status_description=ALLOC_NOT_NEEDED)
            )
            del untainted[aid]
            remove -= 1
            if remove == 0:
                return stop, reconnecting
        return stop, reconnecting

    def _compute_stop_by_reconnecting(self, untainted, reconnecting, stop, remove):
        for aid, rec in list(reconnecting.items()):
            if remove == 0:
                break
            if (
                rec.desired_status != consts.ALLOC_DESIRED_RUN
                or rec.desired_transition.should_migrate()
                or rec.desired_transition.reschedule
                or rec.desired_transition.should_force_reschedule()
                or (rec.job is not None and rec.job.version < self.job.version)
                or (rec.job is not None and rec.job.create_index < self.job.create_index)
            ):
                stop[aid] = rec
                self.result.stop.append(
                    AllocStopResult(alloc=rec, status_description=ALLOC_NOT_NEEDED)
                )
                del reconnecting[aid]
                remove -= 1
                continue
            for uid, unt in list(untainted.items()):
                if unt.name != rec.name:
                    continue
                # prefer stopping the replacement unless it's newer/better
                stop_alloc, del_set, del_id = unt, untainted, uid
                desc = ALLOC_NOT_NEEDED
                if unt.job is not None and rec.job is not None and (
                    unt.job.version > rec.job.version
                    or unt.job.create_index > rec.job.create_index
                ):
                    stop_alloc, del_set, del_id = rec, reconnecting, aid
                else:
                    desc = ALLOC_RECONNECTED
                stop[stop_alloc.id] = stop_alloc
                self.result.stop.append(
                    AllocStopResult(alloc=stop_alloc, status_description=desc)
                )
                del del_set[del_id]
                remove -= 1
                if remove == 0:
                    return remove
        return remove

    def _compute_updates(self, tg, untainted: AllocSet):
        ignore: AllocSet = {}
        inplace: AllocSet = {}
        destructive: AllocSet = {}
        for aid, a in untainted.items():
            ignore_change, destructive_change, updated = self.alloc_update_fn(
                a, self.job, tg
            )
            if ignore_change:
                ignore[aid] = a
            elif destructive_change:
                destructive[aid] = a
            else:
                inplace[aid] = a
                self.result.inplace_update.append(updated)
        return ignore, inplace, destructive

    def _compute_reconnecting(self, reconnecting: AllocSet) -> None:
        """reconcile.go computeReconnecting: updates that resume allocs."""
        for aid, a in reconnecting.items():
            if a.desired_status != consts.ALLOC_DESIRED_RUN:
                continue
            if a.client_status not in (consts.ALLOC_CLIENT_RUNNING,):
                continue
            update = a.copy_skip_job()
            update.client_status = consts.ALLOC_CLIENT_RUNNING
            self.result.reconnect_updates[aid] = update

    def _delay_by_stop_after_disconnect(self, lost: AllocSet) -> List[DelayedRescheduleInfo]:
        later = []
        for a in lost.values():
            job = a.job
            tg = job.lookup_task_group(a.task_group) if job else None
            if tg is None or tg.stop_after_client_disconnect_s is None:
                continue
            if a.client_status == consts.ALLOC_CLIENT_RUNNING:
                later.append(
                    DelayedRescheduleInfo(
                        a.id, a,
                        self.now + tg.stop_after_client_disconnect_s,
                    )
                )
        return later

    def _create_lost_later_evals(self, later: List[DelayedRescheduleInfo],
                                 tg_name: str) -> Dict[str, str]:
        """Batched WaitUntil follow-up evals (reconcile.go
        createLostLaterEvals): one eval per distinct time bucket."""
        if not later:
            return {}
        out: Dict[str, str] = {}
        by_time: Dict[float, List[DelayedRescheduleInfo]] = {}
        for info in later:
            by_time.setdefault(round(info.reschedule_time_s, 0), []).append(info)
        evals = []
        for t, infos in sorted(by_time.items()):
            ev = Evaluation(
                namespace=self.job.namespace,
                priority=self.eval_priority,
                type=self.job.type,
                triggered_by=consts.EVAL_TRIGGER_RETRY_FAILED_ALLOC,
                job_id=self.job_id,
                status=consts.EVAL_STATUS_PENDING,
                wait_until_s=t,
            )
            evals.append(ev)
            for info in infos:
                out[info.alloc_id] = ev.id
        self.result.desired_followup_evals.setdefault(tg_name, []).extend(evals)
        return out

    def _create_timeout_later_evals(self, disconnecting: AllocSet, tg_name: str) -> Dict[str, str]:
        """max_client_disconnect timeout evals + unknown updates
        (reconcile.go createTimeoutLaterEvals)."""
        if not disconnecting:
            return {}
        out: Dict[str, str] = {}
        for aid, a in disconnecting.items():
            job = a.job
            tg = job.lookup_task_group(a.task_group) if job else None
            if tg is None or tg.max_client_disconnect_s is None:
                continue
            ev = Evaluation(
                namespace=self.job.namespace,
                priority=self.eval_priority,
                type=self.job.type,
                triggered_by=consts.EVAL_TRIGGER_MAX_DISCONNECT_TIMEOUT,
                job_id=self.job_id,
                status=consts.EVAL_STATUS_PENDING,
                wait_until_s=self.now + tg.max_client_disconnect_s,
            )
            self.result.desired_followup_evals.setdefault(tg_name, []).append(ev)
            out[aid] = ev.id
            update = a.copy_skip_job()
            update.client_status = consts.ALLOC_CLIENT_UNKNOWN
            update.client_description = "alloc is lost since its node is disconnected"
            update.follow_up_eval_id = ev.id
            # stamp the disconnect on every task state (structs.go
            # appends the unknown AllocState; Reconnected() compares it
            # against the client's later 'Reconnected' event)
            from nomad_tpu_torch.structs.alloc import TaskEvent
            now_ns = int(self.now * 1e9)
            for ts in update.task_states.values():
                ts.events.append(TaskEvent(
                    type="Disconnected", time_ns=now_ns,
                    message="client missed heartbeats"))
            self.result.disconnect_updates[aid] = update
        return out

    def _create_reschedule_later_evals(self, later: List[DelayedRescheduleInfo],
                                       all_allocs: AllocSet, tg_name: str) -> None:
        mapping = self._create_lost_later_evals(later, tg_name)
        for alloc_id, eval_id in mapping.items():
            existing = all_allocs.get(alloc_id)
            if existing is None:
                continue
            updated = existing.copy_skip_job()
            updated.follow_up_eval_id = eval_id
            self.result.attribute_updates[alloc_id] = updated

    def _create_deployment(self, group_name: str, strategy, existing_deployment: bool,
                           dstate: DeploymentState, all_allocs: AllocSet,
                           destructive: AllocSet) -> None:
        if existing_deployment or strategy is None or strategy.is_empty() \
                or dstate.desired_total == 0:
            return
        updating_spec = len(destructive) != 0 or len(self.result.inplace_update) != 0
        had_running = any(
            a.job is not None
            and a.job.version == self.job.version
            and a.job.create_index == self.job.create_index
            for a in all_allocs.values()
        )
        if had_running and not updating_spec:
            return
        if self.deployment is None:
            self.deployment = new_deployment(self.job)
            # multiregion gating (structs.go:4133): regions beyond the
            # first max_parallel wave deploy blocked until an earlier
            # region's success unblocks them
            if self.job.multiregion:
                self.deployment.is_multiregion = True
                if self.job.multiregion_starts_blocked():
                    self.deployment.status = consts.DEPLOYMENT_STATUS_BLOCKED
                    self.deployment.status_description = (
                        "Deployment is blocked on an earlier region"
                    )
            self.result.deployment = self.deployment
        self.deployment.task_groups[group_name] = dstate

    def _is_deployment_complete(self, group_name, destructive, inplace, migrate,
                                reschedule_now, place, reschedule_later,
                                requires_canaries: bool) -> bool:
        complete = (
            len(destructive) + len(inplace) + len(place) + len(migrate)
            + len(reschedule_now) + len(reschedule_later) == 0
            and not requires_canaries
        )
        if not complete or self.deployment is None:
            return False
        dstate = self.deployment.task_groups.get(group_name)
        if dstate is not None:
            if dstate.healthy_allocs < max(dstate.desired_total, dstate.desired_canaries) or (
                dstate.desired_canaries > 0 and not dstate.promoted
            ):
                complete = False
        return complete
