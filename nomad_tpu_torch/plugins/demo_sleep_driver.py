"""Demo external driver plugin: runs "sleep" tasks out of process.

The external-plugin analog of the reference's skeleton driver
(nomad-driver-skeleton): implements DriverPlugin against real child
processes and serves it over the stdio JSON protocol. Launch
standalone (``python -m nomad_tpu_torch.plugins.demo_sleep_driver``) or
drop into a client's plugin_dir.

Task config: {"duration": "10s", "exit_code": 0}
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Dict, Optional

from nomad_tpu_torch.jobspec.hcl import duration_s
from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DRIVER, PluginInfo
from nomad_tpu_torch.plugins.drivers import (
    HEALTH_HEALTHY,
    TASK_STATE_EXITED,
    TASK_STATE_RUNNING,
    DriverCapabilities,
    DriverPlugin,
    ExitResult,
    Fingerprint,
    TaskConfig,
    TaskHandle,
    TaskStatus,
)


class _SleepTask:
    def __init__(self, duration: float, exit_code: int) -> None:
        self.proc = subprocess.Popen(["sleep", str(max(duration, 0.01))])
        self.exit_code = exit_code
        self.started_at = time.time()
        self.completed_at = 0.0

    def poll(self) -> Optional[ExitResult]:
        rc = self.proc.poll()
        if rc is None:
            return None
        if not self.completed_at:
            self.completed_at = time.time()
        if rc == 0:
            return ExitResult(exit_code=self.exit_code)
        return ExitResult(exit_code=rc if rc > 0 else 0,
                          signal=-rc if rc < 0 else 0)


class SleepDriver(DriverPlugin):
    NAME = "sleep"

    def __init__(self) -> None:
        self._tasks: Dict[str, _SleepTask] = {}
        self._lock = threading.Lock()

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name=self.NAME, type=PLUGIN_TYPE_DRIVER,
                          plugin_version="0.1.0")

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities(send_signals=True, exec_=False)

    def fingerprint(self) -> Fingerprint:
        return Fingerprint(attributes={"driver.sleep": "1"},
                           health=HEALTH_HEALTHY)

    def start_task(self, config: TaskConfig) -> TaskHandle:
        duration = duration_s(config.driver_config.get("duration", "1s"))
        exit_code = int(config.driver_config.get("exit_code", 0))
        task = _SleepTask(duration, exit_code)
        with self._lock:
            self._tasks[config.id] = task
        return TaskHandle(
            driver=self.NAME, config=config, state=TASK_STATE_RUNNING,
            driver_state={"pid": task.proc.pid, "exit_code": exit_code},
        )

    def recover_task(self, handle: TaskHandle) -> None:
        raise RuntimeError("sleep tasks don't survive plugin restarts")

    def wait_task(self, task_id: str,
                  timeout: Optional[float] = None) -> Optional[ExitResult]:
        with self._lock:
            task = self._tasks[task_id]
        deadline = None if timeout is None else time.time() + timeout
        while True:
            res = task.poll()
            if res is not None:
                return res
            if deadline is not None and time.time() >= deadline:
                return None
            time.sleep(0.05)

    def stop_task(self, task_id: str, timeout: float = 5.0,
                  signal: str = "SIGTERM") -> None:
        with self._lock:
            task = self._tasks.get(task_id)
        if task is not None and task.proc.poll() is None:
            task.proc.terminate()

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        with self._lock:
            task = self._tasks.pop(task_id, None)
        if task is not None and task.proc.poll() is None:
            task.proc.kill()

    def inspect_task(self, task_id: str) -> TaskStatus:
        with self._lock:
            task = self._tasks[task_id]
        res = task.poll()
        return TaskStatus(
            id=task_id,
            state=TASK_STATE_EXITED if res else TASK_STATE_RUNNING,
            started_at=task.started_at,
            completed_at=task.completed_at,
            exit_result=res,
        )

    def signal_task(self, task_id: str, signal: str) -> None:
        import signal as _sig
        with self._lock:
            task = self._tasks[task_id]
        if task.proc.poll() is None:
            task.proc.send_signal(getattr(_sig, signal, _sig.SIGTERM))


if __name__ == "__main__":
    from nomad_tpu_torch.plugins.external import serve_driver

    serve_driver(SleepDriver(), SleepDriver.NAME)
