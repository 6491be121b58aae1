"""Out-of-process driver plugins.

Reference behavior: plugins/base + hashicorp/go-plugin — every
external plugin is a SUBPROCESS the agent launches, speaking an RPC
protocol over a private channel after a handshake
(plugins/drivers/proto/driver.proto is the wire contract). Here the
channel is newline-delimited JSON frames over the child's
stdin/stdout — same process-isolation boundary, same reattach-by-
handle semantics, debuggable with a text editor:

    handshake (child -> agent, first line):
        {"protocol": 1, "type": "driver", "name": "<driver>"}
    request  (agent -> child):  {"id": N, "method": M, "params": {...}}
    response (child -> agent):  {"id": N, "result": ...} |
                                {"id": N, "error": "..."}

The channel is one serial request/response stream per plugin: a
long-running call (exec_task) delays other calls to the same plugin.
Agent-side pollers keep their per-call timeouts short (task runners
wait in 0.25s slices), which bounds the head-of-line delay; a
multiplexed channel is the upgrade path if a driver needs
long-blocking calls.

Plugin authors implement :class:`~nomad_tpu_torch.plugins.drivers.
DriverPlugin` and call :func:`serve_driver` under ``__main__``; the
agent side wraps the subprocess in :class:`ExternalDriver`, which is a
drop-in DriverPlugin. ``load_plugin_dir`` scans a directory the way
the reference's plugin loader does (helper/pluginutils/loader).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from nomad_tpu_torch.plugins.base import PluginInfo
from nomad_tpu_torch.plugins.drivers import (
    HEALTH_UNHEALTHY,
    DriverCapabilities,
    DriverPlugin,
    ExitResult,
    Fingerprint,
    NetworkIsolationSpec,
    TaskConfig,
    TaskHandle,
    TaskStatus,
)

LOG = logging.getLogger(__name__)
PROTOCOL_VERSION = 1


def _to_wire(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # field-by-field (asdict would flatten NESTED dataclasses to
        # dicts before this recursion could tag them)
        return {"__dc__": type(obj).__name__,
                **{f.name: _to_wire(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {k: _to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_wire(v) for v in obj]
    return obj


_DC_TYPES = {
    c.__name__: c for c in (
        Fingerprint, DriverCapabilities, TaskConfig, TaskHandle,
        ExitResult, TaskStatus, PluginInfo, NetworkIsolationSpec,
    )
}


def _from_wire(obj: Any) -> Any:
    if isinstance(obj, dict):
        name = obj.pop("__dc__", None)
        decoded = {k: _from_wire(v) for k, v in obj.items()}
        if name and name in _DC_TYPES:
            cls = _DC_TYPES[name]
            fields = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in decoded.items() if k in fields})
        return decoded
    if isinstance(obj, list):
        return [_from_wire(v) for v in obj]
    return obj


class PluginCrashed(RuntimeError):
    pass


class ExternalDriver(DriverPlugin):
    """Agent-side proxy: a DriverPlugin whose methods run in the
    plugin subprocess."""

    def __init__(self, argv: List[str], name_hint: str = "",
                 call_timeout: float = 60.0) -> None:
        self.argv = list(argv)
        self._lock = threading.Lock()
        self._next_id = 0
        # chatty plugins may print arbitrarily many stray lines between
        # responses; bound the wait by time, not line count
        self._call_timeout = call_timeout
        self._proc: Optional[subprocess.Popen] = None
        self.name = name_hint
        self._start_process()

    # -- process lifecycle ----------------------------------------------

    def _start_process(self) -> None:
        # python plugins dropped into a plugin_dir import the agent's
        # SDK (nomad_tpu_torch.plugins.*); make the package root importable
        # from wherever the plugin file lives
        import nomad_tpu_torch
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(nomad_tpu_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            self.argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1, env=env,
        )
        try:
            import select
            # generous: a python plugin's interpreter+SDK import can
            # take seconds on a loaded machine; a crashed plugin still
            # fails fast via the EOF/readline path below
            r, _, _ = select.select([self._proc.stdout], [], [], 30.0)
            if not r:
                raise PluginCrashed(
                    f"plugin {self.argv}: handshake timeout")
            line = self._proc.stdout.readline()
            try:
                hs = json.loads(line)
            except (json.JSONDecodeError, TypeError):
                raise PluginCrashed(
                    f"plugin {self.argv}: bad handshake {line!r}")
            if hs.get("protocol") != PROTOCOL_VERSION or \
                    hs.get("type") != "driver":
                raise PluginCrashed(f"plugin {self.argv}: handshake {hs}")
        except PluginCrashed:
            # never leave a non-plugin executable running
            self.shutdown()
            raise
        self.name = hs.get("name", self.name)
        # pump stdout on a thread so _call can wait with a timeout;
        # readline() on the pipe directly cannot be time-bounded and
        # select() misses lines already sitting in the text buffer
        self._lines: "queue.Queue[Optional[str]]" = queue.Queue()
        reader = threading.Thread(
            target=self._pump_stdout, name=f"plugin-{self.name}-stdout",
            daemon=True)
        reader.start()

    def _pump_stdout(self) -> None:
        try:
            for line in self._proc.stdout:
                self._lines.put(line)
        except (ValueError, OSError):
            pass                                # stream closed
        self._lines.put(None)                   # EOF sentinel

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def shutdown(self) -> None:
        if self._proc is not None:
            try:
                self._proc.terminate()
                self._proc.wait(timeout=3)
            except Exception:                   # noqa: BLE001
                self._proc.kill()

    # -- rpc -------------------------------------------------------------

    def _call(self, method: str, **params: Any) -> Any:
        with self._lock:
            if not self.alive():
                raise PluginCrashed(f"plugin {self.name} is not running")
            self._next_id += 1
            frame = {"id": self._next_id, "method": method,
                     "params": _to_wire(params)}
            try:
                # graft: ok R2 - the lock IS the RPC framing: it pairs this request with its response on one pipe; frames are tiny and plugin calls are cold-path
                self._proc.stdin.write(json.dumps(frame) + "\n")
                self._proc.stdin.flush()

                resp = None
                deadline = time.monotonic() + self._call_timeout
                while True:
                    # the reader thread pumps stdout into _lines; a
                    # plugin that goes silent mid-call must not wedge
                    # the caller (and every later call, via
                    # self._lock) forever, so bound the wait by time
                    # rather than line count
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        line = self._lines.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if line is None:            # reader hit EOF
                        raise PluginCrashed(
                            f"plugin {self.name} exited mid-call")
                    try:
                        # graft: ok R2 - response parse belongs to the same framed exchange the lock serializes
                        candidate = json.loads(line)
                    except json.JSONDecodeError:
                        # stray print() from the plugin: skip, stay
                        # in sync via the response id
                        LOG.warning("plugin %s: stray stdout %r",
                                    self.name, line[:120])
                        continue
                    if candidate.get("id") == self._next_id:
                        resp = candidate
                        break
                if resp is None:
                    raise PluginCrashed(
                        f"plugin {self.name}: no response within "
                        f"{self._call_timeout}s")
            except (BrokenPipeError, OSError) as e:
                raise PluginCrashed(f"plugin {self.name}: {e}")
        if resp.get("error"):
            if resp.get("error_type") == "KeyError":
                # the force-destroyed-task contract task_runner keys on
                raise KeyError(f"plugin {self.name}: {resp['error']}")
            raise RuntimeError(f"plugin {self.name}: {resp['error']}")
        return _from_wire(resp.get("result"))

    # -- DriverPlugin surface -------------------------------------------

    def plugin_info(self) -> PluginInfo:
        return self._call("plugin_info")

    def task_config_schema(self) -> Dict:
        return self._call("task_config_schema")

    def capabilities(self) -> DriverCapabilities:
        return self._call("capabilities")

    def fingerprint(self) -> Fingerprint:
        if not self.alive():
            return Fingerprint(health=HEALTH_UNHEALTHY,
                               health_description="plugin process exited")
        try:
            return self._call("fingerprint")
        except PluginCrashed as e:
            return Fingerprint(health=HEALTH_UNHEALTHY,
                               health_description=str(e))

    def start_task(self, config: TaskConfig) -> TaskHandle:
        return self._call("start_task", config=config)

    def recover_task(self, handle: TaskHandle) -> None:
        self._call("recover_task", handle=handle)

    def wait_task(self, task_id: str,
                  timeout: Optional[float] = None) -> Optional[ExitResult]:
        return self._call("wait_task", task_id=task_id, timeout=timeout)

    def stop_task(self, task_id: str, timeout: float = 5.0,
                  signal: str = "SIGTERM") -> None:
        self._call("stop_task", task_id=task_id, timeout=timeout,
                   signal=signal)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        self._call("destroy_task", task_id=task_id, force=force)

    def inspect_task(self, task_id: str) -> TaskStatus:
        return self._call("inspect_task", task_id=task_id)

    def task_stats(self, task_id: str) -> Dict:
        return self._call("task_stats", task_id=task_id)

    def signal_task(self, task_id: str, signal: str) -> None:
        self._call("signal_task", task_id=task_id, signal=signal)

    def exec_task(self, task_id: str, cmd: List[str],
                  timeout: float = 30.0) -> Dict:
        return self._call("exec_task", task_id=task_id, cmd=cmd,
                          timeout=timeout)

    # DriverNetworkManager proxying: an external driver advertising
    # must_create_network must actually be ASKED (the base-class stub
    # would silently decline on the proxy's behalf)
    def create_network(self, alloc_id: str, port_mappings=None):
        return self._call("create_network", alloc_id=alloc_id,
                          port_mappings=list(port_mappings or []))

    def destroy_network(self, alloc_id: str, spec) -> None:
        self._call("destroy_network", alloc_id=alloc_id, spec=spec)

    def recover_network(self, alloc_id: str, port_mappings=None):
        return self._call("recover_network", alloc_id=alloc_id,
                          port_mappings=list(port_mappings or []))


def serve_driver(driver: DriverPlugin, name: str) -> None:
    """Plugin-side main loop: handshake then serve frames until EOF.

    KeyError from an unknown task id maps to the error field the
    proxy re-raises; everything else is caught so one bad request
    can't kill the plugin.
    """
    out = sys.stdout
    out.write(json.dumps({
        "protocol": PROTOCOL_VERSION, "type": "driver", "name": name,
    }) + "\n")
    out.flush()
    for line in sys.stdin:
        try:
            frame = json.loads(line)
        except json.JSONDecodeError:
            continue
        fid = frame.get("id")
        method = frame.get("method", "")
        params = _from_wire(frame.get("params") or {})
        try:
            fn = getattr(driver, method)
            if method.startswith("_") or not callable(fn):
                raise AttributeError(method)
            result = fn(**params)
            resp = {"id": fid, "result": _to_wire(result)}
        except Exception as e:                  # noqa: BLE001
            resp = {"id": fid, "error": f"{type(e).__name__}: {e}",
                    "error_type": type(e).__name__}
        out.write(json.dumps(resp) + "\n")
        out.flush()


def load_plugin_dir(plugin_dir: str) -> Dict[str, ExternalDriver]:
    """Scan a plugin directory (helper/pluginutils/loader analog):
    every executable file or ``*.py`` is launched and handshaken;
    failures are logged and skipped."""
    out: Dict[str, ExternalDriver] = {}
    if not plugin_dir or not os.path.isdir(plugin_dir):
        return out
    for entry in sorted(os.listdir(plugin_dir)):
        path = os.path.join(plugin_dir, entry)
        if not os.path.isfile(path):
            continue
        if entry.endswith(".py"):
            argv = [sys.executable, path]
        elif os.access(path, os.X_OK):
            argv = [path]
        else:
            continue
        try:
            drv = ExternalDriver(argv, name_hint=entry)
            if drv.name in out:
                LOG.warning("plugin %s: duplicate driver name %r; "
                            "keeping the first", path, drv.name)
                drv.shutdown()
                continue
            out[drv.name] = drv
        except (PluginCrashed, OSError) as e:
            LOG.warning("plugin %s failed to load: %s", path, e)
    return out
