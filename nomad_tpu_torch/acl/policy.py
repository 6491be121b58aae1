"""ACL policy + token models and policy-text parsing.

Reference behavior: acl/policy.go — policies are HCL documents with
`namespace "name" { policy = "read" capabilities = [...] }`, plus
node/agent/operator/quota/plugin/host_volume blocks; dispositions
expand to capability sets (expandNamespacePolicy). Tokens
(structs.go ACLToken) are client (policy-bound) or management.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Dict, List

# namespace capabilities (acl/policy.go:26-48)
NS_DENY = "deny"
NS_LIST_JOBS = "list-jobs"
NS_READ_JOB = "read-job"
NS_SUBMIT_JOB = "submit-job"
NS_DISPATCH_JOB = "dispatch-job"
NS_READ_LOGS = "read-logs"
NS_READ_FS = "read-fs"
NS_ALLOC_EXEC = "alloc-exec"
NS_ALLOC_LIFECYCLE = "alloc-lifecycle"
NS_SCALE_JOB = "scale-job"
NS_SENTINEL_OVERRIDE = "sentinel-override"
NS_CSI_REGISTER_PLUGIN = "csi-register-plugin"
NS_CSI_WRITE_VOLUME = "csi-write-volume"
NS_CSI_READ_VOLUME = "csi-read-volume"
NS_CSI_LIST_VOLUME = "csi-list-volume"
NS_CSI_MOUNT_VOLUME = "csi-mount-volume"

# disposition -> capability expansion (acl/policy.go expandNamespacePolicy)
_READ_CAPS = [
    NS_LIST_JOBS, NS_READ_JOB, NS_CSI_LIST_VOLUME, NS_CSI_READ_VOLUME,
    NS_READ_LOGS, NS_READ_FS,
]
_WRITE_CAPS = _READ_CAPS + [
    NS_SUBMIT_JOB, NS_DISPATCH_JOB, NS_ALLOC_EXEC, NS_ALLOC_LIFECYCLE,
    NS_CSI_WRITE_VOLUME, NS_CSI_MOUNT_VOLUME, NS_SCALE_JOB,
]


def expand_namespace_policy(disposition: str) -> List[str]:
    if disposition == "deny":
        return [NS_DENY]
    if disposition == "read":
        return list(_READ_CAPS)
    if disposition == "write":
        return list(_WRITE_CAPS)
    if disposition == "scale":
        return [NS_LIST_JOBS, NS_READ_JOB, NS_SCALE_JOB]
    raise ValueError(f"invalid namespace policy '{disposition}'")


@dataclass
class NamespaceRule:
    name: str = ""
    policy: str = ""
    capabilities: List[str] = field(default_factory=list)


@dataclass
class ParsedPolicy:
    namespaces: List[NamespaceRule] = field(default_factory=list)
    node: str = ""        # read | write | deny
    agent: str = ""
    operator: str = ""
    quota: str = ""
    plugin: str = ""
    host_volumes: List[NamespaceRule] = field(default_factory=list)


def parse_policy(rules: str) -> ParsedPolicy:
    """Parse HCL policy text (acl/policy.go Parse)."""
    from nomad_tpu_torch.jobspec.hcl import parse

    body = parse(rules)
    p = ParsedPolicy()
    for labels, nb in body.get_blocks("namespace"):
        rule = NamespaceRule(
            name=labels[0] if labels else "default",
            policy=str(nb.attrs.get("policy", "")),
            capabilities=[str(c) for c in nb.attrs.get("capabilities", [])],
        )
        if rule.policy:
            rule.capabilities = sorted(
                set(rule.capabilities) | set(expand_namespace_policy(rule.policy))
            )
        p.namespaces.append(rule)
    for labels, hb in body.get_blocks("host_volume"):
        p.host_volumes.append(NamespaceRule(
            name=labels[0] if labels else "*",
            policy=str(hb.attrs.get("policy", "")),
            capabilities=[str(c) for c in hb.attrs.get("capabilities", [])],
        ))
    for scope in ("node", "agent", "operator", "quota", "plugin"):
        blk = body.first_block(scope)
        if blk is not None:
            setattr(p, scope if scope != "host_volumes" else scope,
                    str(blk[1].attrs.get("policy", "")))
    return p


@dataclass
class ACLPolicy:
    """Stored policy (structs.go ACLPolicy)."""

    name: str = ""
    description: str = ""
    rules: str = ""
    create_index: int = 0
    modify_index: int = 0

    def validate(self) -> None:
        import re

        if not re.fullmatch(r"[a-zA-Z0-9-]{1,128}", self.name):
            raise ValueError(f"invalid policy name '{self.name}'")
        parse_policy(self.rules)  # raises on bad rules

    def parsed(self) -> ParsedPolicy:
        return parse_policy(self.rules)


@dataclass
class ACLToken:
    """Stored token (structs.go ACLToken)."""

    accessor_id: str = ""
    secret_id: str = ""
    name: str = ""
    type: str = "client"      # client | management
    policies: List[str] = field(default_factory=list)
    global_: bool = False
    create_time_ns: int = 0
    create_index: int = 0
    modify_index: int = 0

    @classmethod
    def create(cls, name: str = "", type: str = "client",
               policies: List[str] = (), global_: bool = False) -> "ACLToken":
        import time

        if type not in ("client", "management"):
            raise ValueError(f"invalid token type '{type}'")
        if type == "client" and not policies:
            raise ValueError("client tokens must have at least one policy")
        if type == "management" and policies:
            raise ValueError("management tokens cannot carry policies")
        return cls(
            accessor_id=str(uuid.uuid4()),
            secret_id=str(uuid.uuid4()),
            name=name,
            type=type,
            policies=list(policies),
            global_=global_,
            create_time_ns=int(time.time() * 1e9),
        )

    def is_management(self) -> bool:
        return self.type == "management"
