"""The compiled ACL object.

Reference behavior: acl/acl.go:43 — an ACL is compiled from one or more
parsed policies into per-namespace capability sets (deny wins), plus
coarse node/agent/operator dispositions (max of read<write, deny wins).
Wildcard namespace rules apply by glob match with longest-prefix
priority (simplified here to fnmatch + most-specific-pattern-wins).
"""

from __future__ import annotations

import fnmatch
from typing import Dict, Iterable, List, Optional

from nomad_tpu_torch.acl.policy import NS_DENY, ParsedPolicy


def _merge_disposition(cur: str, new: str) -> str:
    order = {"": 0, "read": 1, "write": 2, "deny": 3}
    return new if order.get(new, 0) > order.get(cur, 0) else cur


class ACL:
    def __init__(self, management: bool = False) -> None:
        self.management = management
        # exact-or-glob namespace pattern -> capability set
        self._ns_caps: Dict[str, set] = {}
        self._node = ""
        self._agent = ""
        self._operator = ""
        self._quota = ""
        self._plugin = ""

    @classmethod
    def compile(cls, policies: Iterable[ParsedPolicy]) -> "ACL":
        acl = cls()
        for p in policies:
            for rule in p.namespaces:
                caps = acl._ns_caps.setdefault(rule.name, set())
                caps.update(rule.capabilities)
            acl._node = _merge_disposition(acl._node, p.node)
            acl._agent = _merge_disposition(acl._agent, p.agent)
            acl._operator = _merge_disposition(acl._operator, p.operator)
            acl._quota = _merge_disposition(acl._quota, p.quota)
            acl._plugin = _merge_disposition(acl._plugin, p.plugin)
        return acl

    # -- namespace capabilities (acl.go AllowNamespaceOperation) ---------

    def _caps_for(self, namespace: str) -> Optional[set]:
        if namespace in self._ns_caps:
            return self._ns_caps[namespace]
        # glob rules: most-specific (longest pattern) match wins
        best: Optional[str] = None
        for pattern in self._ns_caps:
            if ("*" in pattern or "?" in pattern) and fnmatch.fnmatch(
                namespace, pattern
            ):
                if best is None or len(pattern) > len(best):
                    best = pattern
        return self._ns_caps.get(best) if best is not None else None

    def allow_ns_op(self, namespace: str, capability: str) -> bool:
        if self.management:
            return True
        caps = self._caps_for(namespace)
        if caps is None:
            return False
        if NS_DENY in caps:
            return False
        return capability in caps

    def allow_namespace(self, namespace: str) -> bool:
        if self.management:
            return True
        caps = self._caps_for(namespace)
        return bool(caps) and NS_DENY not in caps

    def allow_any_ns_op(self, capability: str) -> bool:
        """Does ANY namespace rule grant this capability? (the
        subscribe-time gate for cross-namespace streams: a token with
        no read grant anywhere has no business holding one open)"""
        if self.management:
            return True
        return any(capability in caps and NS_DENY not in caps
                   for caps in self._ns_caps.values())

    # -- coarse scopes ---------------------------------------------------

    def _allow(self, disposition: str, write: bool) -> bool:
        if self.management:
            return True
        if disposition == "deny":
            return False
        if write:
            return disposition == "write"
        return disposition in ("read", "write")

    def allow_node_read(self) -> bool:
        return self._allow(self._node, write=False)

    def allow_node_write(self) -> bool:
        return self._allow(self._node, write=True)

    def allow_agent_read(self) -> bool:
        return self._allow(self._agent, write=False)

    def allow_agent_write(self) -> bool:
        return self._allow(self._agent, write=True)

    def allow_operator_read(self) -> bool:
        return self._allow(self._operator, write=False)

    def allow_operator_write(self) -> bool:
        return self._allow(self._operator, write=True)

    def allow_quota_read(self) -> bool:
        return self._allow(self._quota, write=False)

    def allow_plugin_read(self) -> bool:
        return self._allow(self._plugin, write=False)

    def is_management(self) -> bool:
        return self.management


MANAGEMENT_ACL = ACL(management=True)
ANONYMOUS_ACL = ACL()
