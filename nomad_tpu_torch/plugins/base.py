"""Base plugin contract.

Reference behavior: plugins/base/base.go:9 ``BasePlugin`` -- PluginInfo,
ConfigSchema, SetConfig. Config schemas here are plain dicts validated
by the plugin (the hclspec-proto analog, plugins/shared/hclspec).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


PLUGIN_TYPE_DRIVER = "driver"
PLUGIN_TYPE_DEVICE = "device"


@dataclass
class PluginInfo:
    name: str
    type: str
    plugin_api_version: str = "v0.1.0"
    plugin_version: str = "0.1.0"


class BasePlugin:
    def plugin_info(self) -> PluginInfo:
        raise NotImplementedError

    def config_schema(self) -> Dict:
        """Declared config keys -> {type, default} (hclspec analog)."""
        return {}

    def set_config(self, config: Dict) -> None:
        self.config = dict(config or {})
