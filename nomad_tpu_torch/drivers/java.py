"""java driver: run JVM workloads.

Reference behavior: drivers/java/driver.go -- fingerprints the host JVM
(`java -version` parsed into driver.java.version/runtime/vm attributes,
driver.go javaVersionInfo), launches `java [jvm_options] -jar
<jar_path> [args]` (or `-cp <class_path> <class>`) under the shared
executor WITH resource isolation (the reference java driver uses the
libcontainer executor: PID namespaces + cgroup cpu/memory limits, no
chroot — executor_linux.go via driver.go StartTask), and inherits
raw_exec's supervision/reattach machinery.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.drivers.execdriver import resource_executor_opts
from nomad_tpu_torch.drivers.rawexec import RawExecDriver
from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DRIVER, PluginInfo
from nomad_tpu_torch.plugins.drivers import (
    HEALTH_HEALTHY,
    HEALTH_UNDETECTED,
    Fingerprint,
    TaskConfig,
)


def parse_java_version(output: str) -> Tuple[str, str, str]:
    """(version, runtime, vm) from `java -version` stderr
    (drivers/java/utils.go parseJavaVersionOutput)."""
    version = runtime = vm = ""
    lines = [ln.strip() for ln in output.splitlines() if ln.strip()]
    if lines:
        m = re.search(r'version "([^"]+)"', lines[0])
        if m:
            version = m.group(1)
    for ln in lines[1:]:
        if "Runtime Environment" in ln or "Server" in ln and not vm:
            if not runtime and "Runtime" in ln:
                runtime = ln
            elif not vm:
                vm = ln
        elif not vm and ("VM" in ln):
            vm = ln
    return version, runtime, vm


class JavaDriver(RawExecDriver):
    name = "java"

    #: overridable for tests (a fake `java` script)
    java_bin: Optional[str] = None

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name=self.name, type=PLUGIN_TYPE_DRIVER)

    def fingerprint(self) -> Fingerprint:
        java = self.java_bin or shutil.which("java")
        if java is None:
            return Fingerprint(health=HEALTH_UNDETECTED,
                               health_description="java not found")
        attrs = {f"driver.{self.name}": "1"}
        try:
            proc = subprocess.run(
                [java, "-version"], capture_output=True, text=True,
                timeout=10,
            )
            version, runtime, vm = parse_java_version(
                proc.stderr or proc.stdout)
            if version:
                attrs["driver.java.version"] = version
            if runtime:
                attrs["driver.java.runtime"] = runtime
            if vm:
                attrs["driver.java.vm"] = vm
        except Exception:                       # noqa: BLE001
            pass
        return Fingerprint(attributes=attrs, health=HEALTH_HEALTHY,
                           health_description="Healthy")

    def task_config_schema(self) -> Dict:
        return {
            "jar_path": {"type": "string"},
            "class": {"type": "string"},
            "class_path": {"type": "string"},
            "jvm_options": {"type": "list"},
            "args": {"type": "list"},
        }

    def _executor_opts(self, config: TaskConfig) -> List[str]:
        """The reference java driver runs the JVM inside the isolating
        executor: PID/mount/IPC namespaces + cgroup cpu/memory limits
        from the task's resources (driver.go StartTask ->
        executor_linux.go). No chroot — the JVM needs the host's
        classpath world."""
        return resource_executor_opts(config, cgroup_prefix="nomad-java")

    def _command(self, config: TaskConfig) -> List[str]:
        cfg = config.driver_config
        argv: List[str] = [self.java_bin or "java"]
        argv.extend(cfg.get("jvm_options") or [])
        if cfg.get("jar_path"):
            argv += ["-jar", cfg["jar_path"]]
        elif cfg.get("class"):
            if cfg.get("class_path"):
                argv += ["-cp", cfg["class_path"]]
            argv.append(cfg["class"])
        else:
            raise ValueError("java driver requires jar_path or class")
        argv.extend(cfg.get("args") or [])
        return argv
