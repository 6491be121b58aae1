"""Namespace model (reference nomad/structs/structs.go Namespace;
state table schema.go namespaces)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class Namespace:
    name: str = ""
    description: str = ""
    quota: str = ""
    meta: dict = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def validate(self) -> None:
        if not re.fullmatch(r"[a-zA-Z0-9-]{1,128}", self.name):
            raise ValueError(
                f"invalid namespace name '{self.name}': must be 1-128 "
                "alphanumeric or '-' characters"
            )


DEFAULT_NAMESPACE = Namespace(
    name="default", description="Default shared namespace"
)
