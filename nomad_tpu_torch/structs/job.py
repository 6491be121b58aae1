"""Job -> TaskGroup -> Task tree and lifecycle policies.

Reference behavior: nomad/structs/structs.go Job (:4071), TaskGroup (:6122),
Task (:6904), UpdateStrategy, ReschedulePolicy, RestartPolicy,
MigrateStrategy, PeriodicConfig, EphemeralDisk, ScalingPolicy.
"""

from __future__ import annotations

import copy as _copy
import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nomad_tpu_torch.structs.consts import (
    JOB_DEFAULT_PRIORITY,
    JOB_STATUS_PENDING,
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSBATCH,
    JOB_TYPE_SYSTEM,
)
from nomad_tpu_torch.structs.constraints import Affinity, Constraint, Spread
from nomad_tpu_torch.structs.network import NetworkResource
from nomad_tpu_torch.structs.resources import Resources


@dataclass
class UpdateStrategy:
    """Rolling-update policy (structs.go UpdateStrategy)."""

    stagger_s: float = 30.0
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0
    progress_deadline_s: float = 600.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0

    def is_empty(self) -> bool:
        return self.max_parallel == 0

    def copy(self) -> "UpdateStrategy":
        return dataclasses.replace(self)


@dataclass
class ReschedulePolicy:
    """Reschedule failed allocs onto other nodes (structs.go ReschedulePolicy)."""

    attempts: int = 0
    interval_s: float = 0.0
    delay_s: float = 30.0
    delay_function: str = "exponential"  # constant | exponential | fibonacci
    max_delay_s: float = 3600.0
    unlimited: bool = False

    def enabled(self) -> bool:
        return self.unlimited or (self.attempts > 0 and self.interval_s > 0)

    def copy(self) -> "ReschedulePolicy":
        return dataclasses.replace(self)


DEFAULT_SERVICE_RESCHEDULE = ReschedulePolicy(
    delay_s=30.0, delay_function="exponential", max_delay_s=3600.0, unlimited=True
)
DEFAULT_BATCH_RESCHEDULE = ReschedulePolicy(
    attempts=1, interval_s=24 * 3600.0, delay_s=5.0, delay_function="constant"
)


@dataclass
class RestartPolicy:
    """In-place restart policy executed by the client (structs.go RestartPolicy)."""

    attempts: int = 2
    interval_s: float = 1800.0
    delay_s: float = 15.0
    mode: str = "fail"  # fail | delay

    def copy(self) -> "RestartPolicy":
        return dataclasses.replace(self)


@dataclass
class MigrateStrategy:
    """Drain-driven migration pacing (structs.go MigrateStrategy)."""

    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0

    def copy(self) -> "MigrateStrategy":
        return dataclasses.replace(self)


@dataclass
class PeriodicConfig:
    """Cron-style launches (structs.go PeriodicConfig)."""

    enabled: bool = False
    spec: str = ""
    spec_type: str = "cron"
    prohibit_overlap: bool = False
    timezone: str = "UTC"

    def copy(self) -> "PeriodicConfig":
        return dataclasses.replace(self)


@dataclass
class ParameterizedJobConfig:
    """Dispatchable job template (structs.go ParameterizedJobConfig)."""

    payload: str = "optional"  # optional | required | forbidden
    meta_required: List[str] = field(default_factory=list)
    meta_optional: List[str] = field(default_factory=list)

    def copy(self) -> "ParameterizedJobConfig":
        return dataclasses.replace(
            self,
            meta_required=list(self.meta_required),
            meta_optional=list(self.meta_optional),
        )


@dataclass
class EphemeralDisk:
    size_mb: int = 300
    sticky: bool = False
    migrate: bool = False

    def copy(self) -> "EphemeralDisk":
        return dataclasses.replace(self)


@dataclass
class ScalingPolicy:
    """Autoscaler-facing policy (structs.go ScalingPolicy)."""

    id: str = ""
    type: str = "horizontal"
    target: Dict[str, str] = field(default_factory=dict)
    min: int = 0
    max: int = 0
    policy: Dict[str, object] = field(default_factory=dict)
    enabled: bool = True


@dataclass
class TaskLifecycleConfig:
    """init/prestart/poststart/poststop hooks (structs.go TaskLifecycleConfig)."""

    hook: str = ""  # prestart | poststart | poststop
    sidecar: bool = False


@dataclass
class LogConfig:
    max_files: int = 10
    max_file_size_mb: int = 10


@dataclass
class Template:
    source_path: str = ""
    dest_path: str = ""
    embedded_tmpl: str = ""
    change_mode: str = "restart"
    change_signal: str = ""


@dataclass
class Vault:
    """Task Vault block (structs.go Vault): which policies the task's
    derived token carries and how a new token is delivered."""

    policies: List[str] = field(default_factory=list)
    env: bool = True               # expose VAULT_TOKEN to the task
    change_mode: str = "restart"   # restart | signal | noop
    change_signal: str = ""


@dataclass
class Service:
    """Service registration + health checks (structs/services.go).

    ``connect`` is the service-mesh stanza (structs/services.go
    ConsulConnect): ``{"sidecar_service": {"proxy": {"upstreams":
    [{"destination_name": ..., "local_bind_port": ...}],
    "local_service_port": N}}}`` for sidecar-proxied services, or
    ``{"native": true}`` for connect-native workloads.
    """

    name: str = ""
    port_label: str = ""
    provider: str = "builtin"
    tags: List[str] = field(default_factory=list)
    checks: List[Dict] = field(default_factory=list)
    connect: Dict = field(default_factory=dict)

    # -- connect helpers (services.go ConsulConnect methods) -------------

    def has_sidecar(self) -> bool:
        return bool(self.connect.get("sidecar_service") is not None)

    def is_connect_native(self) -> bool:
        return bool(self.connect.get("native"))

    def sidecar_proxy(self) -> Dict:
        sc = self.connect.get("sidecar_service") or {}
        return sc.get("proxy") or {}

    def upstreams(self) -> List[Dict]:
        return list(self.sidecar_proxy().get("upstreams") or [])

    def mesh_port_label(self) -> str:
        """The dynamic port the scheduler assigns for the sidecar's
        public (mesh) listener (jobConnectHook's injected port)."""
        return f"connect-proxy-{self.name}"


@dataclass
class VolumeRequest:
    """Group-level host/CSI volume ask (structs.go VolumeRequest)."""

    name: str = ""
    type: str = "host"  # host | csi
    source: str = ""
    read_only: bool = False
    access_mode: str = ""
    attachment_mode: str = ""
    per_alloc: bool = False


@dataclass
class Task:
    """A single task run by a driver (structs.go:6904)."""

    name: str = ""
    driver: str = "mock"
    config: Dict[str, object] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    services: List[Service] = field(default_factory=list)
    meta: Dict[str, str] = field(default_factory=dict)
    kill_timeout_s: float = 5.0
    lifecycle: Optional[TaskLifecycleConfig] = None
    log_config: LogConfig = field(default_factory=LogConfig)
    templates: List[Template] = field(default_factory=list)
    artifacts: List[Dict] = field(default_factory=list)
    vault: Optional[Vault] = None
    leader: bool = False
    kill_signal: str = ""
    user: str = ""

    def copy(self) -> "Task":
        return _copy.deepcopy(self)


@dataclass
class TaskGroup:
    """A co-scheduled set of tasks (structs.go:6122)."""

    name: str = ""
    count: int = 1
    tasks: List[Task] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    # typed so the API codec decodes group networks into real
    # NetworkResource rows (an untyped List left them as wire dicts,
    # and connect admission then saw no bridge-mode network)
    networks: List[NetworkResource] = field(default_factory=list)
    volumes: Dict[str, VolumeRequest] = field(default_factory=dict)
    services: List[Service] = field(default_factory=list)
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
    reschedule_policy: Optional[ReschedulePolicy] = None
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    update: Optional[UpdateStrategy] = None
    migrate: Optional[MigrateStrategy] = None
    meta: Dict[str, str] = field(default_factory=dict)
    stop_after_client_disconnect_s: Optional[float] = None
    max_client_disconnect_s: Optional[float] = None
    scaling: Optional[ScalingPolicy] = None

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None

    def copy(self) -> "TaskGroup":
        return _copy.deepcopy(self)


@dataclass
class Job:
    """The unit of submission (structs.go:4071)."""

    id: str = ""
    name: str = ""
    namespace: str = "default"
    region: str = "global"
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    datacenters: List[str] = field(default_factory=lambda: ["dc1"])
    node_pool: str = "default"
    all_at_once: bool = False
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    update: Optional[UpdateStrategy] = None
    periodic: Optional[PeriodicConfig] = None
    parameterized: Optional[ParameterizedJobConfig] = None
    payload: bytes = b""
    meta: Dict[str, str] = field(default_factory=dict)
    version: int = 0
    status: str = JOB_STATUS_PENDING
    stop: bool = False
    stable: bool = False
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0
    parent_id: str = ""
    dispatched: bool = False
    # {"strategy": {"max_parallel": N, "on_failure": "..."},
    #  "regions": [{"name", "count", "datacenters", "meta"}, ...]}
    # (structs.go:4133 Multiregion)
    multiregion: Optional[Dict] = None
    consul_token: str = ""
    vault_token: str = ""

    # -- multiregion helpers (structs.go Multiregion) --------------------

    def multiregion_regions(self) -> List[Dict]:
        if not self.multiregion:
            return []
        return list(self.multiregion.get("regions") or [])

    def multiregion_max_parallel(self) -> int:
        """0 means every region deploys at once (reference default)."""
        if not self.multiregion:
            return 0
        strategy = self.multiregion.get("strategy") or {}
        return int(strategy.get("max_parallel", 0) or 0)

    def multiregion_on_failure(self) -> str:
        """'' (downstream regions fail), 'fail_all', or 'fail_local'."""
        if not self.multiregion:
            return ""
        strategy = self.multiregion.get("strategy") or {}
        return str(strategy.get("on_failure", "") or "")

    def multiregion_region_index(self) -> int:
        """This job copy's position in the region rollout order."""
        for i, r in enumerate(self.multiregion_regions()):
            if str(r.get("name", "")) == self.region:
                return i
        return -1

    def multiregion_starts_blocked(self) -> bool:
        """Regions past the first max_parallel wave deploy blocked and
        wait for an earlier region's success to unblock them."""
        mp = self.multiregion_max_parallel()
        if mp <= 0:
            return False
        idx = self.multiregion_region_index()
        return idx >= mp

    def validate(self) -> List[str]:
        """structs.go Job.Validate: returns a list of validation error
        strings (empty = valid). Mirrors the reference's checks: ids,
        type, priority bounds, task-group/task structure and name
        uniqueness, periodic/parameterized exclusivity."""
        errs: List[str] = []
        if not self.id:
            errs.append("missing job ID")
        elif " " in self.id:
            errs.append("job ID contains a space")
        if not self.name:
            errs.append("missing job name")
        if self.type not in (JOB_TYPE_SERVICE, JOB_TYPE_BATCH,
                             JOB_TYPE_SYSTEM, JOB_TYPE_SYSBATCH):
            errs.append(f"invalid job type: {self.type!r}")
        if not 1 <= self.priority <= 100:
            errs.append(f"job priority must be between 1 and 100, "
                        f"got {self.priority}")
        if not self.datacenters:
            errs.append("job must specify at least one datacenter")
        if not self.task_groups:
            errs.append("missing job task groups")
            return errs   # nested checks need groups (null-safe)
        if self.periodic is not None and self.parameterized is not None:
            errs.append("job can't be both periodic and parameterized")
        seen = set()
        for i, tg in enumerate(self.task_groups):
            if tg is None:
                errs.append(f"task group {i + 1} is null")
                continue
            label = tg.name or f"task group {i + 1}"
            if not tg.name:
                errs.append(f"task group {i + 1} missing name")
            elif tg.name in seen:
                errs.append(f"duplicate task group name {tg.name!r}")
            seen.add(tg.name)
            if tg.count < 0:
                errs.append(f"group {label}: count must be >= 0")
            if self.type == JOB_TYPE_SYSTEM and tg.count > 1:
                errs.append(
                    f"group {label}: system jobs can't have a count > 1")
            if not tg.tasks:
                errs.append(f"group {label}: missing tasks")
            task_names = set()
            for j, task in enumerate(tg.tasks or []):
                if task is None:
                    errs.append(f"group {label}: task {j + 1} is null")
                    continue
                tlabel = task.name or f"task {j + 1}"
                if not task.name:
                    errs.append(f"group {label}: task {j + 1} missing name")
                elif task.name in task_names:
                    errs.append(
                        f"group {label}: duplicate task name {task.name!r}")
                task_names.add(task.name)
                if not task.driver:
                    errs.append(f"group {label}, task {tlabel}: "
                                "missing driver")
                res = task.resources
                if res is not None and (res.cpu < 0 or res.memory_mb < 0):
                    errs.append(f"group {label}, task {tlabel}: "
                                "resources must be non-negative")
        for c in self.constraints or []:
            if c is not None and not c.operand:
                errs.append("constraint missing operand")
        return errs

    def namespaced_id(self) -> str:
        return f"{self.namespace}@{self.id}"

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def is_periodic(self) -> bool:
        return self.periodic is not None and self.periodic.enabled

    def is_parameterized(self) -> bool:
        return self.parameterized is not None and not self.dispatched

    def is_system(self) -> bool:
        return self.type == JOB_TYPE_SYSTEM

    def stopped(self) -> bool:
        return self.stop

    def reschedule_policy_for(self, tg_name: str) -> ReschedulePolicy:
        tg = self.lookup_task_group(tg_name)
        if tg is not None and tg.reschedule_policy is not None:
            return tg.reschedule_policy
        if self.type == JOB_TYPE_BATCH:
            return DEFAULT_BATCH_RESCHEDULE.copy()
        return DEFAULT_SERVICE_RESCHEDULE.copy()

    def required_signals(self) -> Dict[str, Dict[str, List[str]]]:
        return {}

    def spec_hash(self) -> str:
        """Content hash used for change detection (no msgpack: repr-based)."""
        material = repr(
            (
                self.id,
                self.namespace,
                self.type,
                self.priority,
                tuple(self.datacenters),
                tuple(repr(tg) for tg in self.task_groups),
                tuple(repr(c) for c in self.constraints),
                tuple(repr(a) for a in self.affinities),
                tuple(repr(s) for s in self.spreads),
            )
        )
        return hashlib.sha256(material.encode()).hexdigest()

    def copy(self) -> "Job":
        return _copy.deepcopy(self)
