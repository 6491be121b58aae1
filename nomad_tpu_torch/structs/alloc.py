"""Allocation: the scheduling currency binding a job's task group to a node.

Reference behavior: nomad/structs/structs.go Allocation (:9468),
AllocMetric, TaskState, DesiredTransition, RescheduleTracker.
"""

from __future__ import annotations

import copy as _copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nomad_tpu_torch.structs.consts import (
    ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED,
    ALLOC_CLIENT_LOST,
    ALLOC_CLIENT_PENDING,
    ALLOC_CLIENT_RUNNING,
    ALLOC_CLIENT_UNKNOWN,
    ALLOC_DESIRED_EVICT,
    ALLOC_DESIRED_RUN,
    ALLOC_DESIRED_STOP,
)
from nomad_tpu_torch.structs.resources import AllocatedResources, ComparableResources


@dataclass
class TaskEvent:
    type: str = ""
    time_ns: int = 0
    message: str = ""
    details: Dict[str, str] = field(default_factory=dict)


@dataclass
class TaskState:
    """Client-reported per-task state (structs.go TaskState)."""

    state: str = "pending"  # pending | running | dead
    failed: bool = False
    restarts: int = 0
    last_restart_ns: int = 0
    started_at_ns: int = 0
    finished_at_ns: int = 0
    events: List[TaskEvent] = field(default_factory=list)

    def successful(self) -> bool:
        return self.state == "dead" and not self.failed


@dataclass
class AllocMetric:
    """Why/how a placement decision happened (structs.go AllocMetric).

    Stored on the Allocation; surfaced in `alloc status`. The TPU kernel
    fills nodes_evaluated/filtered/exhausted from mask population counts
    and scores from the top-k output -- the batched formulation gives these
    for free (a mask reduction) where Go tallies per-iterator.
    """

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_in_pool: int = 0
    nodes_available: Dict[str, int] = field(default_factory=dict)  # per-DC
    class_filtered: Dict[str, int] = field(default_factory=dict)
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: Dict[str, int] = field(default_factory=dict)
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    quota_exhausted: List[str] = field(default_factory=list)
    # top-K node scores: [(node_id, {scorer: score}, final)]
    score_meta: List = field(default_factory=list)
    allocation_time_ns: int = 0
    coalesced_failures: int = 0

    def exhausted_node(self, node, dimension: str) -> None:
        self.nodes_exhausted += 1
        if node is not None and node.node_class:
            self.class_exhausted[node.node_class] = (
                self.class_exhausted.get(node.node_class, 0) + 1
            )
        if dimension:
            self.dimension_exhausted[dimension] = (
                self.dimension_exhausted.get(dimension, 0) + 1
            )

    def filter_node(self, node, constraint: str) -> None:
        self.nodes_filtered += 1
        if node is not None and node.node_class:
            self.class_filtered[node.node_class] = (
                self.class_filtered.get(node.node_class, 0) + 1
            )
        if constraint:
            self.constraint_filtered[constraint] = (
                self.constraint_filtered.get(constraint, 0) + 1
            )

    def copy(self) -> "AllocMetric":
        return _copy.deepcopy(self)


@dataclass
class DesiredTransition:
    """Server-desired transitions, e.g. drain migrations (structs.go)."""

    migrate: Optional[bool] = None
    reschedule: Optional[bool] = None
    force_reschedule: Optional[bool] = None

    def should_migrate(self) -> bool:
        return bool(self.migrate)

    def should_force_reschedule(self) -> bool:
        return bool(self.force_reschedule)


@dataclass
class RescheduleEvent:
    reschedule_time_ns: int = 0
    prev_alloc_id: str = ""
    prev_node_id: str = ""
    delay_s: float = 0.0


@dataclass
class RescheduleTracker:
    events: List[RescheduleEvent] = field(default_factory=list)

    def copy(self) -> "RescheduleTracker":
        return RescheduleTracker(events=[dataclasses.replace(e) for e in self.events])


@dataclass
class NetworkStatus:
    interface_name: str = ""
    address: str = ""
    dns: Optional[Dict] = None


@dataclass
class AllocDeploymentStatus:
    healthy: Optional[bool] = None
    timestamp_ns: int = 0
    canary: bool = False
    modify_index: int = 0

    def is_healthy(self) -> bool:
        return self.healthy is True

    def is_unhealthy(self) -> bool:
        return self.healthy is False


@dataclass
class Allocation:
    """One placement of a task group on a node (structs.go:9468)."""

    id: str = ""
    namespace: str = "default"
    eval_id: str = ""
    name: str = ""               # "<job>.<group>[<index>]"
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: Optional[object] = None  # snapshot of the Job at placement time
    task_group: str = ""
    allocated_resources: Optional[AllocatedResources] = None
    metrics: Optional[AllocMetric] = None
    desired_status: str = ALLOC_DESIRED_RUN
    desired_description: str = ""
    desired_transition: DesiredTransition = field(default_factory=DesiredTransition)
    client_status: str = ALLOC_CLIENT_PENDING
    client_description: str = ""
    task_states: Dict[str, TaskState] = field(default_factory=dict)
    deployment_id: str = ""
    deployment_status: Optional[AllocDeploymentStatus] = None
    reschedule_tracker: Optional[RescheduleTracker] = None
    network_status: Optional[NetworkStatus] = None
    follow_up_eval_id: str = ""
    previous_allocation: str = ""
    next_allocation: str = ""
    preempted_allocations: List[str] = field(default_factory=list)
    preempted_by_allocation: str = ""
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0
    create_time_ns: int = 0
    modify_time_ns: int = 0
    job_version: int = 0

    # -- status algebra (structs.go Allocation.TerminalStatus etc.) ------

    def terminal_status(self) -> bool:
        """Desired stop/evict, or client terminal, is terminal."""
        if self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            return True
        return self.client_terminal_status()

    def client_terminal_status(self) -> bool:
        return self.client_status in (
            ALLOC_CLIENT_COMPLETE,
            ALLOC_CLIENT_FAILED,
            ALLOC_CLIENT_LOST,
        )

    def server_terminal_status(self) -> bool:
        return self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT)

    def running_on_client(self) -> bool:
        return self.client_status in (ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING)

    def is_unknown(self) -> bool:
        return self.client_status == ALLOC_CLIENT_UNKNOWN

    def comparable_resources(self) -> ComparableResources:
        return self.fit_meta()[0]

    def fit_meta(self):
        """(comparable, uses_ports, uses_devices), memoized against the
        ``allocated_resources`` object.

        The applier's per-node re-check (plan_apply.go:644) re-flattens
        every alloc on every touched node on every plan; the flattening
        dominated that path's profile. Resources are replaced (never
        mutated in place) when an alloc changes — the same convention
        the state store's usage planes rely on — so identity of the
        AllocatedResources object is a sound cache key. Callers must
        treat the returned ComparableResources as read-only (all
        in-tree callers do: they ``add`` it into an accumulator).
        """
        ar = self.allocated_resources
        cached = getattr(self, "_fit_meta_cache", None)
        if cached is not None and cached[0] is ar:
            return cached[1]
        if ar is None:
            meta = (ComparableResources(), False, False)
        else:
            cr = ar.comparable()
            meta = (
                cr,
                bool(cr.networks) or bool(ar.shared.ports),
                any(tr.devices for tr in ar.tasks.values()),
            )
        self._fit_meta_cache = (ar, meta)
        return meta

    def port_meta(self):
        """(port_mask, ok), memoized against ``allocated_resources``.

        ``port_mask`` is an int bitmap of every concrete port this
        alloc holds (task networks' reserved + dynamic ports, group
        shared ports — exactly the set NetworkIndex.add_allocs
        indexes) — the per-node reserved-port usage plane
        (state/usage.py) and the plan applier's vectorized port check
        (server/plan_apply.py) are built from it. ``ok`` is False when
        any port is out of range: the exact walk REJECTS such an alloc
        as a collision, which a bitmap cannot express, so consumers
        must fall back. Multi-address soundness (the same port on two
        node IPs) is a NODE property — the checker gates on the node's
        address count, not here.
        """
        ar = self.allocated_resources
        cached = getattr(self, "_port_meta_cache", None)
        if cached is not None and cached[0] is ar:
            return cached[1]
        mask = 0
        ok = True
        if ar is not None:
            # 0 <= port < network.MAX_VALID_PORT; a port listed twice
            # WITHIN the alloc collides with itself in the exact walk
            # (NetworkIndex sets bits one port at a time), which a
            # bitmap cannot express — not ok
            for tr in ar.tasks.values():
                for net in tr.networks:
                    for p in list(net.reserved_ports) + list(net.dynamic_ports):
                        if p.value < 0 or p.value >= 65536 \
                                or (mask >> p.value) & 1:
                            ok = False
                            continue
                        mask |= 1 << p.value
            for p in ar.shared.ports:
                if p.value < 0 or p.value >= 65536 or (mask >> p.value) & 1:
                    ok = False
                    continue
                mask |= 1 << p.value
        meta = (mask, ok)
        self._port_meta_cache = (ar, meta)
        return meta

    def __getstate__(self):
        """Allocs ride raft entries, snapshots, and the client state DB
        (pickle); derived scratch (the fit_meta memo) must not bloat
        those wire/disk payloads."""
        state = dict(self.__dict__)
        state.pop("_fit_meta_cache", None)
        state.pop("_port_meta_cache", None)
        state.pop("_index_cache", None)
        return state

    def index(self) -> int:
        """Alloc index parsed from Name "job.group[idx]" (structs.go).

        Memoized: the reconciler's name-index bitmaps and name-ordered
        walks re-parse the same immutable name several times per eval.
        """
        cached = getattr(self, "_index_cache", None)
        if cached is not None:
            return cached
        l = self.name.rfind("[")
        r = self.name.rfind("]")
        if l == -1 or r == -1 or r < l:
            idx = -1
        else:
            try:
                idx = int(self.name[l + 1 : r])
            except ValueError:
                idx = -1
        self._index_cache = idx
        return idx

    def job_namespaced_id(self) -> str:
        return f"{self.namespace}@{self.job_id}"

    def ran_successfully(self) -> bool:
        if not self.task_states:
            return False
        return all(ts.successful() for ts in self.task_states.values())

    def should_migrate(self) -> bool:
        return self.desired_transition.should_migrate()

    def next_reschedule_time(self, policy) -> Optional[float]:
        """Compute the delay-based next reschedule time in seconds-epoch.

        Reference structs.go Allocation.NextRescheduleTime + NextDelay:
        constant/exponential/fibonacci growth capped at max_delay.
        """
        if policy is None or not policy.enabled():
            return None
        num_prior = len(self.reschedule_tracker.events) if self.reschedule_tracker else 0
        delay = self._next_delay(policy, num_prior)
        base = self.modify_time_ns / 1e9
        return base + delay

    def _next_delay(self, policy, attempts: int) -> float:
        if policy.delay_function == "constant":
            return policy.delay_s
        if policy.delay_function == "exponential":
            delay = policy.delay_s * (2 ** attempts)
            return min(delay, policy.max_delay_s)
        if policy.delay_function == "fibonacci":
            a, b = policy.delay_s, policy.delay_s
            for _ in range(attempts):
                a, b = b, a + b
            return min(a, policy.max_delay_s)
        return policy.delay_s

    def reschedule_eligible(self, policy, fail_time_s: float) -> bool:
        """Whether this failed alloc may be rescheduled (structs.go
        Allocation.RescheduleEligible / ShouldReschedule)."""
        if policy is None or not policy.enabled():
            return False
        if policy.unlimited:
            return True
        if not self.reschedule_tracker or policy.attempts == 0:
            return policy.attempts > 0
        window_start = fail_time_s - policy.interval_s
        in_window = [
            e
            for e in self.reschedule_tracker.events
            if e.reschedule_time_ns / 1e9 >= window_start
        ]
        return len(in_window) < policy.attempts

    def copy(self) -> "Allocation":
        return _copy.deepcopy(self)

    def copy_skip_job(self) -> "Allocation":
        job = self.job
        self.job = None
        try:
            c = _copy.deepcopy(self)
        finally:
            self.job = job
        c.job = job
        return c

    def stub(self) -> Dict:
        return {
            "ID": self.id,
            "Name": self.name,
            "JobID": self.job_id,
            "NodeID": self.node_id,
            "TaskGroup": self.task_group,
            "DesiredStatus": self.desired_status,
            "ClientStatus": self.client_status,
            "DeploymentID": self.deployment_id,
        }


def remove_allocs(allocs: List[Allocation], remove: List[Allocation]) -> List[Allocation]:
    """structs.RemoveAllocs: filter out `remove` by ID."""
    rm = {a.id for a in remove}
    return [a for a in allocs if a.id not in rm]


def allocs_by_node(allocs: List[Allocation]) -> Dict[str, List[Allocation]]:
    out: Dict[str, List[Allocation]] = {}
    for a in allocs:
        out.setdefault(a.node_id, []).append(a)
    return out
