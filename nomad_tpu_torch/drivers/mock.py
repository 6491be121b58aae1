"""Mock driver: fully scriptable fake workloads for tests.

Reference behavior: drivers/mock/driver.go -- tasks controlled by their
config stanza: ``run_for`` (seconds before clean exit), ``exit_code``,
``start_error`` / ``start_error_recoverable``, ``kill_after``; plus
recoverability toggles. The client/e2e test suites are built on it
(SURVEY.md section 4 "key fakes").
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DRIVER, PluginInfo
from nomad_tpu_torch.plugins.drivers import (
    TASK_STATE_EXITED,
    TASK_STATE_RUNNING,
    DriverCapabilities,
    DriverPlugin,
    ExitResult,
    Fingerprint,
    HEALTH_HEALTHY,
    TaskConfig,
    TaskHandle,
    TaskStatus,
)


class _MockTask:
    def __init__(self, config: TaskConfig) -> None:
        self.config = config
        self.state = TASK_STATE_RUNNING
        self.started_at = time.time()
        self.completed_at = 0.0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        self.kill = threading.Event()
        # run_for accepts Go-style durations ("10s", "1m") like the
        # reference mock driver's time.ParseDuration config fields
        from nomad_tpu_torch.jobspec.hcl import duration_s

        run_for = duration_s(config.driver_config.get("run_for", 0))
        exit_code = int(config.driver_config.get("exit_code", 0))
        self.thread = threading.Thread(
            target=self._run, args=(run_for, exit_code), daemon=True
        )
        self.thread.start()

    def _run(self, run_for: float, exit_code: int) -> None:
        if run_for <= 0:
            # run until killed
            self.kill.wait()
            result = ExitResult(exit_code=0, signal=15)
        elif self.kill.wait(run_for):
            result = ExitResult(exit_code=0, signal=15)
        else:
            result = ExitResult(exit_code=exit_code)
        self.state = TASK_STATE_EXITED
        self.completed_at = time.time()
        self.exit_result = result
        self.done.set()


class MockDriver(DriverPlugin):
    def __init__(self) -> None:
        self._tasks: Dict[str, _MockTask] = {}
        self._lock = threading.Lock()

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name="mock_driver", type=PLUGIN_TYPE_DRIVER)

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities(send_signals=True, exec_=True)

    def fingerprint(self) -> Fingerprint:
        return Fingerprint(
            attributes={"driver.mock_driver": "1"},
            health=HEALTH_HEALTHY,
            health_description="Healthy",
        )

    def start_task(self, config: TaskConfig) -> TaskHandle:
        err = config.driver_config.get("start_error")
        if err:
            raise RuntimeError(str(err))
        with self._lock:
            if config.id in self._tasks:
                raise ValueError(f"task {config.id} already started")
            task = _MockTask(config)
            self._tasks[config.id] = task
        return TaskHandle(
            driver="mock_driver",
            config=config,
            state=TASK_STATE_RUNNING,
            driver_state={"started_at": task.started_at},
        )

    def recover_task(self, handle: TaskHandle) -> None:
        with self._lock:
            if handle.config.id in self._tasks:
                return
            if not bool(handle.config.driver_config.get("recoverable", True)):
                raise RuntimeError("mock task is not recoverable")
            # fresh in-memory task standing in for the "live" one
            self._tasks[handle.config.id] = _MockTask(handle.config)

    def wait_task(self, task_id: str, timeout: Optional[float] = None) -> Optional[ExitResult]:
        with self._lock:
            task = self._tasks.get(task_id)
        if task is None:
            raise KeyError(f"unknown task {task_id}")
        if not task.done.wait(timeout):
            return None
        return task.exit_result

    def stop_task(self, task_id: str, timeout: float = 5.0, signal: str = "SIGTERM") -> None:
        with self._lock:
            task = self._tasks.get(task_id)
        if task is not None:
            task.kill.set()
            task.done.wait(timeout)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        with self._lock:
            task = self._tasks.pop(task_id, None)
        if task is not None and not task.done.is_set():
            if not force:
                raise RuntimeError("task still running; use force")
            task.kill.set()

    def inspect_task(self, task_id: str) -> TaskStatus:
        with self._lock:
            task = self._tasks.get(task_id)
        if task is None:
            raise KeyError(f"unknown task {task_id}")
        return TaskStatus(
            id=task_id,
            name=task.config.name,
            state=task.state,
            started_at=task.started_at,
            completed_at=task.completed_at,
            exit_result=task.exit_result,
        )

    def signal_task(self, task_id: str, signal: str) -> None:
        if signal in ("SIGKILL", "SIGTERM", "SIGINT"):
            self.stop_task(task_id)

    def exec_task(self, task_id: str, cmd: List[str], timeout: float = 30.0) -> Dict:
        return {"stdout": b"mock exec: " + " ".join(cmd).encode(), "exit_code": 0}
