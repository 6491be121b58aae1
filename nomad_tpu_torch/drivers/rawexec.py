"""raw_exec driver: host subprocesses with no isolation.

Reference behavior: drivers/rawexec/driver.go -- launches the command
directly on the host via the shared out-of-process executor
(drivers/shared/executor/executor.go:54), so tasks keep running across
agent restarts and the driver reattaches through RecoverTask using the
persisted TaskHandle. Config stanza: {"command": ..., "args": [...]}.

Two launch paths: the native C++ executor (native/executor.cc, built on
demand) for restart-survivable supervision, or a direct subprocess
fallback when the binary is unavailable.
"""

from __future__ import annotations

import os
import signal as _signal
import subprocess
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

_EXECUTOR_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def executor_path(build: bool = True) -> Optional[str]:
    """Locate (and lazily build) the native executor binary."""
    path = os.path.abspath(os.path.join(_EXECUTOR_SRC, "executor"))
    if os.path.exists(path):
        return path
    if not build:
        return None
    try:
        subprocess.run(
            ["make", "-C", os.path.abspath(_EXECUTOR_SRC)],
            capture_output=True, timeout=60, check=True,
        )
    except Exception:                           # noqa: BLE001
        return None
    return path if os.path.exists(path) else None


class _RawTask:
    """Supervision state for one task (in-memory side)."""

    def __init__(self, config: TaskConfig) -> None:
        self.config = config
        self.pid: Optional[int] = None
        self.pgid: Optional[int] = None
        self.status_path = ""
        self.started_at = time.time()
        self.completed_at = 0.0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()

    @property
    def state(self) -> str:
        return TASK_STATE_EXITED if self.done.is_set() else TASK_STATE_RUNNING


class RawExecDriver(DriverPlugin):
    name = "raw_exec"
    use_executor = True

    def __init__(self) -> None:
        self._tasks: Dict[str, _RawTask] = {}
        self._lock = threading.Lock()

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name=self.name, type=PLUGIN_TYPE_DRIVER)

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities(send_signals=True, exec_=True, fs_isolation="none")

    def fingerprint(self) -> Fingerprint:
        return Fingerprint(
            attributes={f"driver.{self.name}": "1"},
            health=HEALTH_HEALTHY,
            health_description="Healthy",
        )

    def task_config_schema(self) -> Dict:
        return {"command": {"type": "string", "required": True},
                "args": {"type": "list"}}

    # --- launch ---------------------------------------------------------

    def _command(self, config: TaskConfig) -> List[str]:
        cmd = config.driver_config.get("command")
        if not cmd:
            raise ValueError("raw_exec requires config.command")
        return [cmd] + list(config.driver_config.get("args", []))

    def _build_env(self, config: TaskConfig) -> Dict[str, str]:
        """raw_exec inherits the agent environment (no isolation)."""
        env = dict(os.environ)
        env.update(config.env)
        return env

    def start_task(self, config: TaskConfig) -> TaskHandle:
        with self._lock:
            if config.id in self._tasks:
                raise ValueError(f"task {config.id} already started")
        task = _RawTask(config)
        workdir = config.alloc_dir or "/tmp"
        os.makedirs(workdir, exist_ok=True)
        stdout = config.std_out_path or os.path.join(workdir, "stdout")
        stderr = config.std_err_path or os.path.join(workdir, "stderr")
        argv = self._command(config)
        if config.netns:
            # join the alloc's network namespace (network_hook.go);
            # applies to executor and direct paths alike
            argv = ["ip", "netns", "exec", config.netns] + argv
        env = self._build_env(config)

        exe = executor_path() if self.use_executor else None
        if exe is not None:
            task.status_path = os.path.join(
                workdir, f".executor-{config.name}.status"
            )
            # a restart runs in the same dir and the executor appends to
            # its status file: the last run's pid and exit records go
            # first, or they would stand for this run's
            try:
                os.unlink(task.status_path)
            except FileNotFoundError:
                pass
            # the executor detaches (setsid) and supervises; we only
            # keep its status file
            subprocess.Popen(
                [exe, task.status_path, stdout, stderr, workdir]
                + self._executor_opts(config) + ["--"] + argv,
                env=env,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                start_new_session=True,
            )
            pid, pgid = self._wait_for_pid(task.status_path)
            task.pid, task.pgid = pid, pgid
            threading.Thread(
                target=self._poll_status, args=(task,), daemon=True
            ).start()
        else:
            with open(stdout, "ab") as out, open(stderr, "ab") as err:
                proc = subprocess.Popen(
                    argv, cwd=workdir, env=env,
                    stdout=out, stderr=err, start_new_session=True,
                )
            task.pid = proc.pid
            task.pgid = proc.pid
            threading.Thread(
                target=self._wait_popen, args=(task, proc), daemon=True
            ).start()

        with self._lock:
            self._tasks[config.id] = task
        return TaskHandle(
            driver=self.name,
            config=config,
            state=TASK_STATE_RUNNING,
            driver_state={
                "pid": task.pid,
                "pgid": task.pgid,
                "status_path": task.status_path,
                "started_at": task.started_at,
            },
        )

    def _executor_opts(self, config: TaskConfig) -> List[str]:
        """Extra executor flags (raw_exec runs without isolation; the
        exec driver overrides with namespaces + cgroup limits)."""
        return []

    @staticmethod
    def _wait_for_pid(status_path: str, timeout: float = 10.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            errors = []
            try:
                with open(status_path) as f:
                    for line in f:
                        if line.startswith("pid "):
                            _, pid, pgid = line.split()
                            return int(pid), int(pgid)
                        if line.startswith("error "):
                            errors.append(line[6:].strip())
                        elif line.startswith("exit "):
                            # executor failed before launching the task
                            detail = "; ".join(errors) or line.strip()
                            raise RuntimeError(
                                f"executor failed to launch task: {detail}"
                            )
            except FileNotFoundError:
                pass
            time.sleep(0.01)
        raise TimeoutError("executor did not report a pid")

    def _poll_status(self, task: _RawTask, interval: float = 0.05) -> None:
        """Watch the executor's status file for the exit record."""
        while not task.done.is_set():
            try:
                with open(task.status_path) as f:
                    for line in f:
                        if line.startswith("exit "):
                            _, code, sig = line.split()
                            task.exit_result = ExitResult(
                                exit_code=int(code), signal=int(sig)
                            )
                            task.completed_at = time.time()
                            task.done.set()
                            return
            except FileNotFoundError:
                pass
            time.sleep(interval)

    @staticmethod
    def _wait_popen(task: _RawTask, proc: subprocess.Popen) -> None:
        code = proc.wait()
        task.exit_result = ExitResult(
            exit_code=max(code, 0), signal=-code if code < 0 else 0
        )
        task.completed_at = time.time()
        task.done.set()

    # --- lifecycle ------------------------------------------------------

    def recover_task(self, handle: TaskHandle) -> None:
        """Reattach using the persisted pid/status file
        (driver.proto:35 RecoverTask + TaskHandle)."""
        with self._lock:
            if handle.config.id in self._tasks:
                return
        task = _RawTask(handle.config)
        task.pid = handle.driver_state.get("pid")
        task.pgid = handle.driver_state.get("pgid")
        task.status_path = handle.driver_state.get("status_path", "")
        task.started_at = handle.driver_state.get("started_at", time.time())
        if task.status_path:
            threading.Thread(
                target=self._poll_status, args=(task,), daemon=True
            ).start()
        elif task.pid is None or not _pid_alive(task.pid):
            task.exit_result = ExitResult(err="task no longer running")
            task.done.set()
        else:
            threading.Thread(
                target=self._poll_pid, args=(task,), daemon=True
            ).start()
        with self._lock:
            self._tasks[handle.config.id] = task

    def _poll_pid(self, task: _RawTask, interval: float = 0.1) -> None:
        while _pid_alive(task.pid):
            time.sleep(interval)
        # exit status unknowable without the executor's status file
        task.exit_result = ExitResult(err="exited while driver was detached")
        task.completed_at = time.time()
        task.done.set()

    def wait_task(self, task_id: str, timeout: Optional[float] = None) -> Optional[ExitResult]:
        task = self._get(task_id)
        if not task.done.wait(timeout):
            return None
        return task.exit_result

    def stop_task(self, task_id: str, timeout: float = 5.0, signal: str = "SIGTERM") -> None:
        task = self._get(task_id)
        if task.done.is_set() or task.pgid is None:
            return
        sig = getattr(_signal, signal, _signal.SIGTERM)
        _kill_group(task.pgid, sig)
        if not task.done.wait(timeout):
            _kill_group(task.pgid, _signal.SIGKILL)
            task.done.wait(2.0)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        task = self._get(task_id)
        if not task.done.is_set():
            if not force:
                raise RuntimeError("task still running; use force")
            if task.pgid is not None:
                _kill_group(task.pgid, _signal.SIGKILL)
        with self._lock:
            self._tasks.pop(task_id, None)

    def inspect_task(self, task_id: str) -> TaskStatus:
        task = self._get(task_id)
        return TaskStatus(
            id=task_id,
            name=task.config.name,
            state=task.state,
            started_at=task.started_at,
            completed_at=task.completed_at,
            exit_result=task.exit_result,
        )

    def signal_task(self, task_id: str, signal: str) -> None:
        task = self._get(task_id)
        if task.pgid is not None and not task.done.is_set():
            _kill_group(task.pgid, getattr(_signal, signal, _signal.SIGTERM))

    def _exec_context(self, task: _RawTask) -> tuple:
        """(argv_prefix, env) an exec session must run under so it
        shares the task's isolation context. raw_exec has none; the
        exec driver enters the task's namespaces (the reference execs
        inside the container, executor_linux.go Exec)."""
        return [], self._build_env(task.config)

    def exec_task(self, task_id: str, cmd: List[str], timeout: float = 30.0) -> Dict:
        task = self._get(task_id)
        prefix, env = self._exec_context(task)
        proc = subprocess.run(
            prefix + cmd, cwd=task.config.alloc_dir or "/tmp",
            env=env, capture_output=True, timeout=timeout,
        )
        return {
            "stdout": proc.stdout, "stderr": proc.stderr,
            "exit_code": proc.returncode,
        }

    def exec_task_streaming(self, task_id: str, cmd: List[str],
                            tty: bool = False) -> "ExecStream":
        """Interactive exec in the task's context (driver.proto:79
        ExecTaskStreaming): a live process with bidirectional stdio,
        optionally under a pty."""
        task = self._get(task_id)
        prefix, env = self._exec_context(task)
        return ExecStream(prefix + cmd, cwd=task.config.alloc_dir or "/tmp",
                          tty=tty, env=env)

    def task_stats(self, task_id: str) -> Dict:
        task = self._get(task_id)
        stats = {"cpu": {}, "memory": {}}
        if task.pid is not None:
            try:
                with open(f"/proc/{task.pid}/statm") as f:
                    pages = int(f.read().split()[1])
                stats["memory"]["rss"] = pages * os.sysconf("SC_PAGE_SIZE")
            except (FileNotFoundError, ValueError, IndexError):
                pass
        return stats

    def _get(self, task_id: str) -> _RawTask:
        with self._lock:
            task = self._tasks.get(task_id)
        if task is None:
            raise KeyError(f"unknown task {task_id}")
        return task


class ExecStream:
    """One interactive exec session (the driver half of
    ExecTaskStreaming, driver.proto:79).

    Output is pumped by a reader thread into a queue the transport
    drains with ``read_output``; stdin writes go straight to the
    process (pty master when ``tty``)."""

    def __init__(self, cmd: List[str], cwd: str, tty: bool = False,
                 env: Optional[Dict[str, str]] = None) -> None:
        import queue as _queue

        self.tty = tty
        self._q: "_queue.Queue" = _queue.Queue()
        self._master: Optional[int] = None
        if tty:
            import pty

            master, slave = pty.openpty()
            self.proc = subprocess.Popen(
                cmd, cwd=cwd, env=env,
                stdin=slave, stdout=slave, stderr=slave,
                start_new_session=True, close_fds=True,
            )
            os.close(slave)
            self._master = master
            threading.Thread(
                target=self._pump_fd, args=(master, "stdout"),
                daemon=True, name="exec-pty-pump",
            ).start()
        else:
            self.proc = subprocess.Popen(
                cmd, cwd=cwd, env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, start_new_session=True,
            )
            threading.Thread(
                target=self._pump, args=(self.proc.stdout, "stdout"),
                daemon=True, name="exec-stdout-pump",
            ).start()
            threading.Thread(
                target=self._pump, args=(self.proc.stderr, "stderr"),
                daemon=True, name="exec-stderr-pump",
            ).start()
        threading.Thread(
            target=self._wait, daemon=True, name="exec-wait",
        ).start()

    def _pump(self, f, name: str) -> None:
        try:
            while True:
                data = f.read1(65536) if hasattr(f, "read1") else f.read(65536)
                if not data:
                    break
                self._q.put((name, data))
        except (OSError, ValueError):
            pass
        finally:
            self._q.put((name, b""))            # stream EOF marker

    def _pump_fd(self, fd: int, name: str) -> None:
        try:
            while True:
                data = os.read(fd, 65536)
                if not data:
                    break
                self._q.put((name, data))
        except OSError:
            pass
        finally:
            self._q.put((name, b""))

    def _wait(self) -> None:
        code = self.proc.wait()
        self._q.put(("exited", code))

    # -- transport-facing API -------------------------------------------

    def write_stdin(self, data: bytes) -> None:
        try:
            if self._master is not None:
                os.write(self._master, data)
            elif self.proc.stdin is not None:
                self.proc.stdin.write(data)
                self.proc.stdin.flush()
        except (OSError, ValueError, BrokenPipeError):
            pass

    def close_stdin(self) -> None:
        try:
            if self._master is not None:
                # pty has no half-close; EOT tells line-disciplined
                # programs to stop reading
                os.write(self._master, b"\x04")
            elif self.proc.stdin is not None:
                self.proc.stdin.close()
        except (OSError, ValueError):
            pass

    def resize(self, height: int, width: int) -> None:
        if self._master is None:
            return
        try:
            import fcntl
            import struct as _struct
            import termios

            fcntl.ioctl(
                self._master, termios.TIOCSWINSZ,
                _struct.pack("HHHH", height, width, 0, 0),
            )
        except OSError:
            pass

    def read_output(self, timeout: float = 0.5):
        """Next ('stdout'|'stderr', bytes) chunk, ('exited', code), or
        None on timeout. A b'' chunk marks that stream's EOF."""
        import queue as _queue

        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def terminate(self) -> None:
        try:
            if self.proc.poll() is None:
                self.proc.kill()
        except OSError:
            pass
        if self._master is not None:
            try:
                os.close(self._master)
            except OSError:
                pass
            self._master = None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _kill_group(pgid: int, sig) -> None:
    try:
        os.killpg(pgid, sig)
    except ProcessLookupError:
        pass
