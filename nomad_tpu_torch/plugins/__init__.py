"""Plugin boundary: drivers and devices.

Reference behavior: plugins/ (SURVEY.md section 2.5) -- every external
plugin is a subprocess speaking gRPC (go-plugin); built-in drivers are
registered in-process through the same interfaces
(helper/pluginutils/catalog/register.go). Here the interface layer is
the same shape (fingerprint streams, task lifecycle, device reserve);
built-ins run in-process, and the ``external`` transport runs a plugin
as a subprocess over a length-prefixed pipe protocol.
"""

from nomad_tpu_torch.plugins.base import PluginInfo
from nomad_tpu_torch.plugins.drivers import (
    DriverCapabilities,
    DriverPlugin,
    ExitResult,
    Fingerprint,
    TaskConfig,
    TaskHandle,
    TaskStatus,
)

__all__ = [
    "DriverCapabilities",
    "DriverPlugin",
    "ExitResult",
    "Fingerprint",
    "PluginInfo",
    "TaskConfig",
    "TaskHandle",
    "TaskStatus",
]
