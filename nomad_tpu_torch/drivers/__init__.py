"""Built-in task drivers.

Reference behavior: drivers/ (SURVEY.md section 2.8) -- docker, exec,
rawexec, java, qemu, mock, registered in-process via the plugin catalog
(helper/pluginutils/catalog/register.go). All six are registered here;
fingerprinting gates placement (the scheduler's DriverChecker skips
nodes where a driver is undetected, e.g. no JVM / no qemu binary / no
docker daemon). The shared native executor (drivers/shared/executor)
supervises children from a separate process so tasks survive agent
restarts.
"""

from typing import Dict, Optional

from nomad_tpu_torch.plugins.drivers import DriverPlugin


def builtin_drivers(
    options: Optional[Dict[str, str]] = None,
) -> Dict[str, DriverPlugin]:
    """catalog/register.go: the in-process driver registry.

    ``options`` is the agent's client-options map (config.go Options);
    drivers read their knobs from it, e.g. ``docker.volumes.enabled``.
    """
    from nomad_tpu_torch.drivers.mock import MockDriver
    from nomad_tpu_torch.drivers.rawexec import RawExecDriver
    from nomad_tpu_torch.drivers.execdriver import ExecDriver
    from nomad_tpu_torch.drivers.java import JavaDriver
    from nomad_tpu_torch.drivers.qemu import QemuDriver
    from nomad_tpu_torch.drivers.docker import DockerDriver

    options = options or {}
    return {
        "mock_driver": MockDriver(),
        "raw_exec": RawExecDriver(),
        "exec": ExecDriver(),
        "java": JavaDriver(),
        "qemu": QemuDriver(),
        "docker": DockerDriver(options=options),
    }
