"""TaskRunner: the per-task state machine.

Reference behavior: client/allocrunner/taskrunner/task_runner.go:498
Run loop -- restore -> prestart hooks -> driver start -> wait -> restart
policy -> exit; hooks (task_runner_hooks.go:61-130) here are the
built-in subset: validate, task dir, logs, dispatch env. Restart policy
semantics follow taskrunner/restarts/restarts.go: up to ``attempts``
restarts inside ``interval``; beyond that ``mode=fail`` kills the task,
``mode=delay`` waits out the interval and continues.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch.plugins.drivers import DriverPlugin, TaskConfig, TaskHandle
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import TaskEvent, TaskState
from nomad_tpu_torch.structs.job import RestartPolicy, Task

LOG = logging.getLogger(__name__)

# task_runner event types (structs.go TaskEvent consts)
EVENT_RECEIVED = "Received"
EVENT_TASK_SETUP = "Task Setup"
EVENT_STARTED = "Started"
EVENT_TERMINATED = "Terminated"
EVENT_RESTARTING = "Restarting"
EVENT_NOT_RESTARTING = "Not Restarting"
EVENT_KILLING = "Killing"
EVENT_KILLED = "Killed"
EVENT_DRIVER_FAILURE = "Driver Failure"

STATE_PENDING = "pending"
STATE_RUNNING = "running"
STATE_DEAD = "dead"


class RestartTracker:
    """taskrunner/restarts/restarts.go."""

    def __init__(self, policy: RestartPolicy, job_type: str) -> None:
        self.policy = policy
        self.job_type = job_type
        self.count = 0
        self.interval_start = time.time()

    def next_restart(self, exit_success: bool) -> (str, float):
        """Returns (decision, delay): decision in {restart, fail, exit}."""
        if exit_success and self.job_type in (
            consts.JOB_TYPE_BATCH, consts.JOB_TYPE_SYSBATCH,
        ):
            # batch-family tasks that succeed are done; service/system
            # tasks restart on any exit (restarts.go GetState)
            return "exit", 0.0
        now = time.time()
        if now - self.interval_start > self.policy.interval_s:
            self.interval_start = now
            self.count = 0
        self.count += 1
        if self.count <= self.policy.attempts:
            return "restart", self.policy.delay_s
        if self.policy.mode == "delay":
            remaining = self.policy.interval_s - (now - self.interval_start)
            return "restart", max(remaining, self.policy.delay_s)
        return "fail", 0.0


class TaskRunner:
    def __init__(
        self,
        alloc,
        task: Task,
        driver: DriverPlugin,
        alloc_dir: str,
        on_state_change: Callable[[str, TaskState], None],
        state_db=None,
        restart_policy: Optional[RestartPolicy] = None,
        extra_env: Optional[Dict[str, str]] = None,
        secrets=None,
        netns: str = "",
        network_isolation=None,
    ) -> None:
        self.alloc = alloc
        self.task = task
        self.driver = driver
        self.alloc_dir = alloc_dir
        self.on_state_change = on_state_change
        self.state_db = state_db
        # alloc-level env contributions (e.g. CSI volume mount paths)
        self.extra_env = extra_env or {}
        # bridge-mode network namespace the task must join (network_hook)
        self.netns = netns
        # driver-created group network (DriverNetworkManager spec)
        self.network_isolation = network_isolation
        # Vault/Consul data plane (vault_hook + template_hook sources)
        self.secrets = secrets
        self._vault_token = ""
        self._template_watcher = None
        self._changed_templates: List = []
        self._vault_watch_stop = threading.Event()
        #: token-validity poll cadence (tests shrink this)
        self.vault_poll_interval_s = 5.0
        # logmon collectors keyed by stream — started in prestart; a
        # stream whose collector failed falls back to a plain file
        self._logmons: Dict[str, object] = {}
        self.task_state = TaskState()
        self.handle: Optional[TaskHandle] = None
        policy = restart_policy or RestartPolicy()
        job_type = alloc.job.type if alloc.job is not None else consts.JOB_TYPE_SERVICE
        self.restart_tracker = RestartTracker(policy, job_type)
        self._kill = threading.Event()
        # user-requested restart (alloc_endpoint.go Restart): bounces
        # the task without counting against the restart policy
        self._restart = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._kill_reason = ""

    @property
    def task_id(self) -> str:
        return f"{self.alloc.id[:8]}-{self.task.name}"

    # --- events/state ---------------------------------------------------

    def _emit(self, event_type: str, message: str = "") -> None:
        self.task_state.events.append(
            TaskEvent(type=event_type, time_ns=time.time_ns(), message=message)
        )
        self._notify()

    def _set_state(self, state: str, failed: Optional[bool] = None) -> None:
        self.task_state.state = state
        if failed is not None:
            self.task_state.failed = failed
        if state == STATE_RUNNING and not self.task_state.started_at_ns:
            self.task_state.started_at_ns = time.time_ns()
        if state == STATE_DEAD:
            self.task_state.finished_at_ns = time.time_ns()
        self._notify()

    def _notify(self) -> None:
        self.on_state_change(self.task.name, self.task_state)
        if self.state_db is not None:
            try:
                self.state_db.put_task_state(
                    self.alloc.id, self.task.name,
                    local_state=self.task_state, task_handle=self.handle,
                )
            except Exception as e:              # noqa: BLE001
                LOG.warning("task %s: state persist failed: %s", self.task_id, e)

    # --- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, daemon=True, name=f"task-{self.task_id}"
        )
        self._thread.start()

    def run(self) -> None:
        """task_runner.go:498 Run: the main loop."""
        try:
            self._run_inner()
        except Exception as e:                  # noqa: BLE001
            LOG.warning("task %s: runner crashed: %s", self.task_id, e)
            self._set_state(STATE_DEAD, failed=True)
        finally:
            if self._template_watcher is not None:
                self._template_watcher.stop()
            self._vault_watch_stop.set()
            self._stop_logmons()
            self._done.set()

    def _run_inner(self) -> None:
        self._emit(EVENT_RECEIVED)
        # transient setup failures (artifact downloads) are recoverable
        # and retry under the restart policy (artifact_hook.go wraps as
        # recoverable); config errors (bad template, missing vault
        # block) kill the task immediately, as in the reference
        while True:
            try:
                self._prestart()
                break
            except Exception as e:              # noqa: BLE001
                self._emit(EVENT_TASK_SETUP, f"prestart failed: {e}")
                if not getattr(e, "recoverable", False):
                    self._set_state(STATE_DEAD, failed=True)
                    return
                decision, delay = self.restart_tracker.next_restart(False)
                if decision != "restart" or self._kill.wait(delay):
                    self._set_state(STATE_DEAD, failed=True)
                    return
        while not self._kill.is_set():
            try:
                self.handle = self.driver.start_task(self._task_config())
            except Exception as e:              # noqa: BLE001
                LOG.warning("task %s: driver start failed: %s",
                            self.task.name, e)
                self._emit(EVENT_DRIVER_FAILURE, str(e))
                decision, delay = self.restart_tracker.next_restart(False)
                if decision != "restart" or self._kill.wait(delay):
                    self._set_state(STATE_DEAD, failed=True)
                    break
                continue
            self._set_state(STATE_RUNNING)
            self._emit(EVENT_STARTED)

            result = None
            while result is None and not self._kill.is_set() \
                    and not self._restart.is_set():
                try:
                    result = self.driver.wait_task(self.task_id, timeout=0.25)
                except KeyError:
                    # task force-destroyed underneath us
                    self._set_state(STATE_DEAD, failed=False)
                    return
            if self._kill.is_set():
                self._handle_kill()
                break
            if self._restart.is_set():
                # user restart wins even if the task happened to exit in
                # the same poll window -- the caller was promised a
                # bounce, not policy-driven exit handling
                self._restart.clear()
                self._emit(EVENT_RESTARTING, "user requested restart")
                try:
                    self.driver.stop_task(
                        self.task_id, timeout=self.task.kill_timeout_s,
                        signal=self.task.kill_signal or "SIGTERM",
                    )
                    self.driver.destroy_task(self.task_id, force=True)
                except Exception:               # noqa: BLE001
                    pass
                continue
            success = result.successful()
            self._emit(
                EVENT_TERMINATED,
                f"exit code {result.exit_code}, signal {result.signal}"
                + (f", err {result.err}" if result.err else ""),
            )
            self.task_state.restarts = self.restart_tracker.count
            decision, delay = self.restart_tracker.next_restart(success)
            if decision == "exit":
                self._set_state(STATE_DEAD, failed=False)
                break
            if decision == "fail":
                self._emit(EVENT_NOT_RESTARTING, "exceeded restart policy")
                self._set_state(STATE_DEAD, failed=not success)
                break
            self._emit(EVENT_RESTARTING, f"restart in {delay:.1f}s")
            self.task_state.restarts = self.restart_tracker.count
            try:
                self.driver.destroy_task(self.task_id, force=True)
            except Exception:                   # noqa: BLE001
                pass
            if self._kill.wait(delay):
                self._handle_kill()
                break

    def _handle_kill(self) -> None:
        self._emit(EVENT_KILLING, self._kill_reason)
        try:
            self.driver.stop_task(
                self.task_id, timeout=self.task.kill_timeout_s,
                signal=self.task.kill_signal or "SIGTERM",
            )
        except Exception:                       # noqa: BLE001
            pass
        self._emit(EVENT_KILLED)
        self._set_state(STATE_DEAD, failed=False)

    def _prestart(self) -> None:
        """Built-in prestart hooks: validate + task dir + logs + vault
        + templates (task_runner_hooks.go validate/taskDir/logmon/
        vault/template subset)."""
        if not self.task.name:
            raise ValueError("task has no name")
        task_dir = os.path.join(self.alloc_dir, self.task.name)
        os.makedirs(os.path.join(task_dir, "local"), exist_ok=True)
        os.makedirs(os.path.join(task_dir, "secrets"), exist_ok=True)
        os.makedirs(os.path.join(self.alloc_dir, "alloc", "logs"), exist_ok=True)
        self._emit(EVENT_TASK_SETUP, "Building Task Directory")
        self._logmon_hook()
        self._artifact_hook(task_dir)
        self._vault_hook(task_dir)
        self._template_hook(task_dir)

    def _artifact_hook(self, task_dir: str) -> None:
        """artifact_hook.go: download each artifact stanza into the
        task dir before the driver starts; failure is a task setup
        failure (Failed Artifact Download event), retried under the
        restart policy like the reference's recoverable wrap."""
        if not self.task.artifacts:
            return
        from nomad_tpu_torch.client.getter import ArtifactError, fetch_artifact

        self._emit(EVENT_TASK_SETUP, "Downloading Artifacts")
        for artifact in self.task.artifacts:
            try:
                fetch_artifact(artifact, task_dir)
            except ArtifactError as e:
                self._emit(EVENT_TASK_SETUP,
                           f"Failed Artifact Download: {e}")
                raise

    def _logmon_hook(self) -> None:
        """logmon_hook.go: one rotating collector per stream; the
        driver writes into the collector's FIFO."""
        from nomad_tpu_torch.client.logmon import LogMon

        if self._logmons:
            return
        logs = os.path.join(self.alloc_dir, "alloc", "logs")
        for stream in ("stdout", "stderr"):
            lm = LogMon(
                os.path.join(logs, f"{self.task.name}.{stream}"),
                max_files=self.task.log_config.max_files,
                max_file_size_mb=self.task.log_config.max_file_size_mb,
            )
            try:
                lm.start()
            except OSError as e:
                LOG.warning("task %s: logmon %s failed (%s); driver "
                            "writes a plain file", self.task_id, stream, e)
                continue
            self._logmons[stream] = lm

    def _stop_logmons(self) -> None:
        for lm in self._logmons.values():
            lm.stop()
        self._logmons = {}

    def _vault_hook(self, task_dir: str) -> None:
        """vault_hook.go: derive the task's token via the server
        (Node.DeriveVaultToken), write it to secrets/vault_token,
        (with vault.env) expose VAULT_TOKEN, and watch the token —
        if it is revoked/expires out from under the task, re-derive
        and fire vault.change_mode (vault_hook.go renewal-failure →
        updatedVaultToken path)."""
        if self.task.vault is None:
            return
        if self.secrets is None:
            raise RuntimeError(
                f"task {self.task.name} has a vault block but the "
                "client has no Vault integration configured")
        self._derive_and_write_token(task_dir)
        self._emit(EVENT_TASK_SETUP, "Vault token derived")
        threading.Thread(
            target=self._vault_token_watch, args=(task_dir,),
            daemon=True, name=f"vault-watch-{self.task_id}",
        ).start()

    def _derive_and_write_token(self, task_dir: str) -> None:
        tokens = self.secrets.derive_vault_tokens(
            self.alloc.id, [self.task.name])
        self._vault_token = tokens.get(self.task.name, "")
        with open(os.path.join(task_dir, "secrets", "vault_token"), "w") as f:
            f.write(self._vault_token)

    def _vault_token_watch(self, task_dir: str) -> None:
        while not self._vault_watch_stop.wait(self.vault_poll_interval_s):
            if self._done.is_set():
                return
            try:
                if self.secrets.vault_token_valid(self._vault_token):
                    continue
                self._derive_and_write_token(task_dir)
            except Exception as e:              # noqa: BLE001
                # transient (Vault unreachable, server blip): keep the
                # watch alive and retry next poll — exiting here would
                # silently end rotation for the task's lifetime
                LOG.warning("task %s: vault token check/re-derive "
                            "failed (retrying): %s", self.task_id, e)
                continue
            mode = self.task.vault.change_mode
            if mode == "restart":
                self._emit(EVENT_RESTARTING, "Vault token rotated")
                self._restart.set()
            elif mode == "signal":
                sig = self.task.vault.change_signal or "SIGHUP"
                try:
                    self.driver.signal_task(self.task_id, sig)
                    self._emit(EVENT_TASK_SETUP,
                               f"Vault token rotated; sent {sig}")
                except Exception as e:          # noqa: BLE001
                    LOG.warning("task %s: vault signal failed: %s",
                                self.task_id, e)

    def _template_hook(self, task_dir: str) -> None:
        """template_hook.go / template.go: render each template into
        the task dir; watch live sources (Consul KV / Vault) and fire
        change_mode on re-render."""
        if not self.task.templates:
            return
        from nomad_tpu_torch.client.template import (
            TemplateWatcher, uses_live_data, uses_vault,
        )

        sources = self._template_sources(task_dir)
        if self.task.vault is None and \
                any(uses_vault(src) for _, src in sources):
            raise RuntimeError(
                f"task {self.task.name}: template reads Vault secrets "
                "but the task has no vault block")
        self._render_templates(task_dir)
        live = any(uses_live_data(src) for _, src in sources)
        if live and self.secrets is not None:
            def rerender() -> bool:
                self._changed_templates = self._render_templates(task_dir)
                return bool(self._changed_templates)

            self._template_watcher = TemplateWatcher(
                poll_index=self.secrets.live_data_index,
                rerender=rerender,
                on_change=lambda: self._on_template_change(
                    self._changed_templates),
            )
            self._template_watcher.start()

    @staticmethod
    def _sandboxed_path(task_dir: str, rel: str) -> str:
        """Confine a jobspec-controlled template path to the allocation
        dir (template.go:572-601 escapingfs sandbox; CVE-2022-24683
        class: without this a submitted job reads/writes arbitrary host
        paths as the agent user). Paths resolve relative to the task
        dir but may reach the sibling shared ``alloc/`` dir, matching
        the reference's alloc-dir sandbox root."""
        full = os.path.realpath(os.path.join(task_dir, rel.lstrip("/")))
        root = os.path.realpath(os.path.dirname(task_dir.rstrip(os.sep)))
        if not (full == root or full.startswith(root + os.sep)):
            raise PermissionError(
                f"template path escapes task directory: {rel}")
        return full

    def _template_sources(self, task_dir: str):
        """Resolve each template to its source text; file-backed
        sources (source_path) read from the task's local dir."""
        out = []
        for tmpl in self.task.templates:
            src = tmpl.embedded_tmpl
            if not src and tmpl.source_path:
                path = self._sandboxed_path(
                    task_dir, os.path.join("local", tmpl.source_path))
                with open(path) as f:
                    src = f.read()
            out.append((tmpl, src))
        return out

    def _render_templates(self, task_dir: str):
        """Render every template; returns the templates whose output
        changed on disk."""
        from nomad_tpu_torch.client.template import TemplateContext, render

        ctx = TemplateContext(
            env=self._base_env(),
            meta=dict(self.task.meta),
            node_attrs=self.secrets.node_attrs() if self.secrets else {},
            kv_get=self.secrets.kv_get if self.secrets else None,
            # secret reads carry the task's derived token so the
            # provider can enforce the task's policies; reading
            # self._vault_token at call time picks up re-derivations
            secret_get=(lambda p: self.secrets.read_secret(
                p, self._vault_token)) if self.secrets else None,
            kv_ls=self.secrets.kv_ls if self.secrets else None,
            services_get=(lambda n: self.secrets.services(
                self.alloc.namespace, n)) if self.secrets else None,
        )
        changed = []
        for tmpl, src in self._template_sources(task_dir):
            out = render(src, ctx)
            dest = self._sandboxed_path(
                task_dir, tmpl.dest_path or "local/rendered")
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            old = None
            try:
                with open(dest) as f:
                    old = f.read()
            except OSError:
                pass
            if out != old:
                with open(dest, "w") as f:
                    f.write(out)
                changed.append(tmpl)
        return changed

    def _on_template_change(self, changed) -> None:
        """Fire the strongest change_mode among the templates that
        actually re-rendered (template.go change-mode dispatch)."""
        modes = {t.change_mode for t in changed}
        if "restart" in modes:
            self._emit(EVENT_RESTARTING, "template re-rendered")
            self._restart.set()
        elif "signal" in modes:
            sig = next((t.change_signal for t in changed
                        if t.change_mode == "signal" and t.change_signal),
                       "SIGHUP")
            try:
                self.driver.signal_task(self.task_id, sig)
                self._emit(EVENT_TASK_SETUP,
                           f"template re-rendered; sent {sig}")
            except Exception as e:              # noqa: BLE001
                LOG.warning("task %s: template signal failed: %s",
                            self.task_id, e)

    def _base_env(self) -> Dict[str, str]:
        env = {
            "NOMAD_ALLOC_ID": self.alloc.id,
            "NOMAD_ALLOC_NAME": self.alloc.name,
            "NOMAD_TASK_NAME": self.task.name,
            "NOMAD_JOB_ID": self.alloc.job_id,
            "NOMAD_JOB_NAME": self.alloc.job.name if self.alloc.job else "",
            "NOMAD_TASK_DIR": os.path.join(self.alloc_dir, self.task.name, "local"),
            "NOMAD_SECRETS_DIR": os.path.join(self.alloc_dir, self.task.name, "secrets"),
        }
        env.update(self.extra_env)
        env.update(self.task.env)
        return env

    def _task_config(self) -> TaskConfig:
        logs = os.path.join(self.alloc_dir, "alloc", "logs")
        env = self._base_env()
        if self._vault_token and self.task.vault is not None \
                and self.task.vault.env:
            env["VAULT_TOKEN"] = self._vault_token
        def stream_path(stream: str) -> str:
            lm = self._logmons.get(stream)
            # collector's FIFO when running, plain file otherwise
            return lm.fifo_path if lm is not None else \
                os.path.join(logs, f"{self.task.name}.{stream}.0")

        out_path = stream_path("stdout")
        err_path = stream_path("stderr")
        return TaskConfig(
            id=self.task_id,
            name=self.task.name,
            alloc_id=self.alloc.id,
            job_name=self.alloc.job.name if self.alloc.job else "",
            task_group_name=self.alloc.task_group,
            env=env,
            driver_config=dict(self.task.config),
            resources=self.task.resources,
            std_out_path=out_path,
            std_err_path=err_path,
            alloc_dir=self.alloc_dir,
            netns=self.netns,
            network_isolation=self.network_isolation,
        )

    def restore(self, task_state: TaskState, handle: Optional[TaskHandle]) -> bool:
        """Reattach to a live task (task_runner.go:1154 restore ->
        driver RecoverTask). Returns True when the task is live again."""
        self.task_state = task_state or TaskState()
        if self.task_state.state == STATE_DEAD:
            # already finished in a previous agent life: nothing to run,
            # but the runner must read as done for GC/is_done
            self._done.set()
            return False
        if handle is None:
            return False
        try:
            self.driver.recover_task(handle)
            self.handle = handle
        except Exception as e:                  # noqa: BLE001
            LOG.info("task %s: recover failed, restarting: %s", self.task_id, e)
            return False
        # re-attach the log collectors: the surviving task process
        # still holds the FIFO open; mkfifo is a no-op and the new
        # reader resumes draining it
        try:
            self._logmon_hook()
        except Exception:                       # noqa: BLE001
            pass
        # resume waiting on the recovered task
        self._thread = threading.Thread(
            target=self._run_recovered, daemon=True, name=f"task-{self.task_id}"
        )
        self._thread.start()
        return True

    def _run_recovered(self) -> None:
        result = None
        while result is None and not self._kill.is_set():
            try:
                result = self.driver.wait_task(self.task_id, timeout=0.25)
            except KeyError:
                break
        if self._kill.is_set():
            self._handle_kill()
        elif result is not None:
            self._emit(EVENT_TERMINATED, f"exit code {result.exit_code}")
            self._set_state(STATE_DEAD, failed=not result.successful())
        self._stop_logmons()
        self._done.set()

    def restart(self, reason: str = "") -> None:
        """Bounce the running task (alloc_endpoint.go Restart)."""
        self._restart.set()

    def kill(self, reason: str = "") -> None:
        self._kill_reason = reason
        self._kill.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def is_done(self) -> bool:
        return self._done.is_set()
