"""Task driver plugin API.

Reference behavior: plugins/drivers/driver.go:47 ``DriverPlugin`` and
the wire contract plugins/drivers/proto/driver.proto:13-87:
TaskConfigSchema, Capabilities, Fingerprint (stream), RecoverTask,
StartTask, WaitTask, StopTask, DestroyTask, InspectTask, TaskStats,
TaskEvents, SignalTask, ExecTask. ``TaskHandle`` (task_handle.go)
carries enough opaque driver state to reattach to a live task after an
agent restart.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from nomad_tpu_torch.plugins.base import BasePlugin, PluginInfo

# Fingerprint health states (drivers/driver.go HealthState*)
HEALTH_UNDETECTED = "undetected"
HEALTH_UNHEALTHY = "unhealthy"
HEALTH_HEALTHY = "healthy"

# Task states (drivers/driver.go TaskState*)
TASK_STATE_UNKNOWN = "unknown"
TASK_STATE_RUNNING = "running"
TASK_STATE_EXITED = "exited"


@dataclass
class Fingerprint:
    attributes: Dict[str, str] = field(default_factory=dict)
    health: str = HEALTH_UNDETECTED
    health_description: str = ""


@dataclass
class DriverCapabilities:
    """drivers/driver.go Capabilities."""

    send_signals: bool = True
    exec_: bool = False
    fs_isolation: str = "none"       # none | chroot | image
    remote_tasks: bool = False
    # the driver owns group-network creation (drivers/driver.go:92
    # DriverNetworkManager + MustInitiateNetwork): docker containers
    # cannot join a client-made namespace, so the driver builds the
    # shared sandbox (pause container) and tasks attach to IT
    must_create_network: bool = False


@dataclass
class NetworkIsolationSpec:
    """drivers/driver.go NetworkIsolationSpec: how a task joins its
    group's shared network namespace — a named netns for exec-family
    drivers, or driver-private labels (the docker sandbox/pause
    container) for drivers that own the namespace."""

    mode: str = "group"
    netns: str = ""
    ip: str = ""                     # sandbox address (NOMAD_ALLOC_IP)
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class TaskConfig:
    """drivers/driver.go TaskConfig -- what StartTask receives."""

    id: str = ""                      # alloc_id + task name
    name: str = ""
    alloc_id: str = ""
    job_name: str = ""
    task_group_name: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    # driver-specific config block (the jobspec task "config" stanza)
    driver_config: Dict[str, Any] = field(default_factory=dict)
    resources: Optional[object] = None
    std_out_path: str = ""
    std_err_path: str = ""
    alloc_dir: str = ""
    # bridge-mode network namespace to join (networking_bridge_linux)
    netns: str = ""
    # driver-created group network to attach to (DriverNetworkManager)
    network_isolation: Optional[NetworkIsolationSpec] = None


@dataclass
class TaskHandle:
    """Opaque reattach state (plugins/drivers/task_handle.go)."""

    driver: str = ""
    config: Optional[TaskConfig] = None
    state: str = TASK_STATE_UNKNOWN
    # driver-private (e.g. pid, container id); must survive serialization
    driver_state: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ExitResult:
    exit_code: int = 0
    signal: int = 0
    oom_killed: bool = False
    err: str = ""

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and not self.err


@dataclass
class TaskStatus:
    id: str = ""
    name: str = ""
    state: str = TASK_STATE_UNKNOWN
    started_at: float = 0.0
    completed_at: float = 0.0
    exit_result: Optional[ExitResult] = None


class DriverPlugin(BasePlugin):
    """drivers/driver.go:47."""

    def task_config_schema(self) -> Dict:
        return {}

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities()

    def fingerprint(self) -> Fingerprint:
        """One fingerprint sample; the driver manager polls this into a
        stream (driver.proto Fingerprint is server-streaming)."""
        raise NotImplementedError

    def start_task(self, config: TaskConfig) -> TaskHandle:
        raise NotImplementedError

    def recover_task(self, handle: TaskHandle) -> None:
        """Reattach to a live task after agent restart (driver.proto:35)."""
        raise NotImplementedError

    def wait_task(self, task_id: str, timeout: Optional[float] = None) -> Optional[ExitResult]:
        """Block until the task exits; None on timeout."""
        raise NotImplementedError

    def stop_task(self, task_id: str, timeout: float = 5.0, signal: str = "SIGTERM") -> None:
        raise NotImplementedError

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        raise NotImplementedError

    def inspect_task(self, task_id: str) -> TaskStatus:
        raise NotImplementedError

    def task_stats(self, task_id: str) -> Dict:
        return {"cpu": {}, "memory": {}}

    def signal_task(self, task_id: str, signal: str) -> None:
        raise NotImplementedError

    def exec_task(self, task_id: str, cmd: List[str], timeout: float = 30.0) -> Dict:
        raise NotImplementedError("driver does not support exec")

    def task_events(self) -> List[Dict]:
        """Drain buffered task events (driver.proto TaskEvents stream)."""
        return []

    # -- DriverNetworkManager (drivers/driver.go:92) ---------------------

    def create_network(self, alloc_id: str,
                       port_mappings: Optional[List] = None
                       ) -> Optional["NetworkIsolationSpec"]:
        """Create the allocation's shared network sandbox. Only drivers
        with ``capabilities().must_create_network`` implement this
        (docker's pause container); None means the CLIENT owns bridge
        networking for this driver."""
        return None

    def destroy_network(self, alloc_id: str,
                        spec: "NetworkIsolationSpec") -> None:
        """Tear down a sandbox created by ``create_network``."""

    def recover_network(self, alloc_id: str,
                        port_mappings: Optional[List] = None
                        ) -> Optional["NetworkIsolationSpec"]:
        """Re-adopt a sandbox that outlived an agent restart; None when
        no live sandbox exists for the alloc. ``port_mappings`` lets an
        unhealthy sandbox be recreated with its original ports."""
        return None
