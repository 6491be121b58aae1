"""qemu driver: virtual machine workloads.

Reference behavior: drivers/qemu/driver.go -- fingerprints the
`qemu-system-x86_64` binary (driver.qemu.version), launches the VM
with `-m <memory>`, the image as the boot drive, `-nographic`, optional
KVM acceleration, user-net port forwards from ``port_map``, and a
MONITOR SOCKET (driver.go:52 qemuGracefulShutdownMsg area): when
``graceful_shutdown`` is set, the driver sends ``system_powerdown``
over the QMP socket so the guest OS shuts down cleanly before the
process is signalled. The VM process rides the shared executor for
supervision/reattach.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import socket
import subprocess
from typing import Dict, List, Optional

from nomad_tpu_torch.drivers.rawexec import RawExecDriver
from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DRIVER, PluginInfo
from nomad_tpu_torch.plugins.drivers import (
    HEALTH_HEALTHY,
    HEALTH_UNDETECTED,
    Fingerprint,
    TaskConfig,
)

QEMU_BIN = "qemu-system-x86_64"

#: longest unix socket path (driver.go qemuLegacyMaxMonitorPathLen
#: concern); sockets land in the task dir which can be deep
_SUN_PATH_MAX = 100


class QemuDriver(RawExecDriver):
    name = "qemu"

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name=self.name, type=PLUGIN_TYPE_DRIVER)

    def fingerprint(self) -> Fingerprint:
        qemu = shutil.which(QEMU_BIN)
        if qemu is None:
            return Fingerprint(health=HEALTH_UNDETECTED,
                               health_description=f"{QEMU_BIN} not found")
        attrs = {f"driver.{self.name}": "1"}
        try:
            out = subprocess.run(
                [qemu, "--version"], capture_output=True, text=True,
                timeout=10,
            ).stdout
            m = re.search(r"version ([\d.]+)", out)
            if m:
                attrs["driver.qemu.version"] = m.group(1)
        except Exception:                       # noqa: BLE001
            pass
        return Fingerprint(attributes=attrs, health=HEALTH_HEALTHY,
                           health_description="Healthy")

    def task_config_schema(self) -> Dict:
        return {
            "image_path": {"type": "string", "required": True},
            "accelerator": {"type": "string"},
            "memory": {"type": "string"},     # e.g. "512M"
            "port_map": {"type": "map"},      # {label: guest_port}
            "graceful_shutdown": {"type": "bool"},
            "args": {"type": "list"},
        }

    # -- monitor socket (driver.go getMonitorPath) -----------------------

    def monitor_path(self, config: TaskConfig) -> str:
        base = config.alloc_dir or "/tmp"
        path = os.path.join(base, f".qmp-{config.name}.sock")
        if len(path) > _SUN_PATH_MAX:
            # fall back to a short path (the reference errors on
            # over-long monitor paths for legacy qemu; modern qemu
            # still caps sun_path)
            path = f"/tmp/nomad-qmp-{config.id[:24]}.sock"
        return path

    def _command(self, config: TaskConfig) -> List[str]:
        cfg = config.driver_config
        image = cfg.get("image_path")
        if not image:
            raise ValueError("qemu driver requires image_path")
        argv: List[str] = [
            QEMU_BIN,
            "-machine", f"type=pc,accel={cfg.get('accelerator', 'tcg')}",
            "-m", str(cfg.get("memory")
                       or f"{config.resources.memory_mb or 512}M"),
            "-drive", f"file={image}",
            "-nographic",
        ]
        if cfg.get("graceful_shutdown", True):
            argv += ["-qmp",
                     f"unix:{self.monitor_path(config)},server,nowait"]
        # user-net port forwards: hostfwd per mapped label
        port_map = cfg.get("port_map") or {}
        if port_map:
            fwds = []
            for label, guest_port in port_map.items():
                host_port = 0
                for net in config.resources.networks:
                    assigned = net.port_for_label(label)
                    if assigned:
                        host_port = assigned
                        break
                if host_port:
                    fwds.append(
                        f"hostfwd=tcp::{host_port}-:{guest_port}"
                    )
            argv += ["-netdev", "user,id=user.0" +
                     "".join("," + f for f in fwds),
                     "-device", "virtio-net,netdev=user.0"]
        argv.extend(cfg.get("args") or [])
        return argv

    # -- graceful shutdown (driver.go StopTask monitor path) -------------

    @staticmethod
    def qmp_system_powerdown(path: str, timeout: float = 5.0) -> bool:
        """Ask the guest to power down over the QMP socket. Returns
        True when the command was accepted (the guest will ACPI-off;
        the VM process then exits on its own)."""
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(timeout)
            s.connect(path)
            f = s.makefile("rwb")
            json.loads(f.readline())            # greeting
            for cmd in ({"execute": "qmp_capabilities"},
                        {"execute": "system_powerdown"}):
                f.write(json.dumps(cmd).encode() + b"\n")
                f.flush()
                resp = json.loads(f.readline())
                while "return" not in resp and "error" not in resp:
                    resp = json.loads(f.readline())   # skip async events
                if "error" in resp:
                    return False
            s.close()
            return True
        except (OSError, ValueError):
            return False

    def stop_task(self, task_id: str, timeout: float = 5.0,
                  signal: str = "SIGTERM") -> None:
        task = self._get(task_id)
        cfg = task.config.driver_config or {}
        if not task.done.is_set() and cfg.get("graceful_shutdown", True):
            path = self.monitor_path(task.config)
            if os.path.exists(path) and self.qmp_system_powerdown(path):
                # clean guest shutdown: give the VM the full timeout
                # before falling back to signals
                if task.done.wait(max(timeout, 1.0)):
                    return
        super().stop_task(task_id, timeout=timeout, signal=signal)
