"""exec driver: subprocesses under namespaces + cgroup limits.

Reference behavior: drivers/exec/driver.go -- like raw_exec but runs
the workload isolated via the shared executor
(drivers/shared/executor/executor_linux.go, libcontainer). The native
executor (native/executor.cc) provides the same primitives directly:
PID+mount+IPC namespaces (the task is pid 1 and its /proc shows only
its own tree), cgroup cpu/memory limits enforced from the task's
``resources`` stanza, and an optional chroot. Capabilities are probed
once per process; environments without namespace privileges degrade
to raw_exec-style supervision (and the fingerprint reflects it), the
same way the reference refuses non-root/cgroup-less clients.
"""

from __future__ import annotations

import functools
import os
import subprocess
from typing import Dict, List

from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DRIVER, PluginInfo
from nomad_tpu_torch.plugins.drivers import DriverCapabilities, TaskConfig
from nomad_tpu_torch.drivers.rawexec import RawExecDriver


def resource_executor_opts(config, cgroup_prefix: str) -> List[str]:
    """Namespace + cgroup flags for the native executor from a task's
    resources (executor_linux.go resource/namespace wiring) — shared
    by every isolating driver (exec, java)."""
    support = isolation_support()
    opts: List[str] = []
    if support["namespaces"]:
        opts.append("-isolate")
    if support["cgroups"]:
        res = config.resources
        mem = int(getattr(res, "memory_mb", 0) or 0) if res else 0
        cpu = int(getattr(res, "cpu", 0) or 0) if res else 0
        if mem > 0:
            opts += ["-mem_mb", str(mem)]
        if cpu > 0:
            opts += ["-cpu_shares", str(cpu)]
        if mem > 0 or cpu > 0:
            opts += ["-cgroup", f"{cgroup_prefix}-{config.id[:16]}"]
    return opts


@functools.lru_cache(maxsize=1)
def isolation_support() -> Dict[str, bool]:
    """Probe once: can this host unshare namespaces / write cgroups?"""
    ns = False
    try:
        probe = subprocess.run(
            ["unshare", "--pid", "--mount", "--ipc", "--fork",
             "/bin/true"],
            capture_output=True, timeout=10,
        )
        ns = probe.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        ns = False
    cg = False
    for path in ("/sys/fs/cgroup/cgroup.controllers",
                 "/sys/fs/cgroup/memory"):
        if os.path.exists(path):
            cg = os.access(os.path.dirname(path) if path.endswith(
                "cgroup.controllers") else path, os.W_OK)
            if cg:
                break
    return {"namespaces": ns, "cgroups": cg}


class ExecDriver(RawExecDriver):
    name = "exec"

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name=self.name, type=PLUGIN_TYPE_DRIVER)

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities(
            send_signals=True, exec_=True, fs_isolation="chroot"
        )

    def _executor_opts(self, config: TaskConfig) -> List[str]:
        """Namespace + cgroup flags for the native executor
        (executor_linux.go resource/namespace wiring)."""
        opts = resource_executor_opts(config, cgroup_prefix="nomad")
        chroot = (config.driver_config or {}).get("chroot")
        if chroot:
            opts += ["-chroot", str(chroot)]
        return opts

    def _exec_context(self, task):
        """Exec sessions join the task's namespaces via nsenter (the
        reference execs inside the container, executor_linux.go Exec)
        and get the task's scrubbed env — never the agent's."""
        env = self._build_env(task.config)
        if isolation_support()["namespaces"] and task.pid:
            prefix = ["nsenter", "-t", str(task.pid),
                      "-p", "-m", "-i", "--"]
            return prefix, env
        return [], env

    def _build_env(self, config: TaskConfig) -> Dict[str, str]:
        env = {
            "PATH": "/usr/local/bin:/usr/bin:/bin",
            "HOME": config.alloc_dir or "/tmp",
            "NOMAD_ALLOC_ID": config.alloc_id,
            "NOMAD_TASK_NAME": config.name,
        }
        env.update(config.env)
        return env
