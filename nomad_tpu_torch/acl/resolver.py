"""Token -> compiled ACL resolution.

Reference behavior: nomad/acl.go ResolveToken — look up the secret in
the acl_token table, compile the token's policies (cached by policy
set), management tokens short-circuit, blank tokens resolve to the
anonymous policy. Bootstrap (acl_endpoint.go Bootstrap) mints the
initial management token exactly once.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from nomad_tpu_torch.acl.acl import ACL, ANONYMOUS_ACL, MANAGEMENT_ACL
from nomad_tpu_torch.acl.policy import ACLToken


class ACLDeniedError(Exception):
    pass


class TokenResolver:
    def __init__(self, server) -> None:
        self.server = server
        # policy-name tuple -> (acl_policy table index at compile, ACL);
        # an entry is valid only while the table index matches, so a
        # compile racing a policy edit can never poison the cache
        self._cache: Dict[Tuple[str, ...], Tuple[int, ACL]] = {}
        self._lock = threading.Lock()
        self._bootstrapped = False

    def bootstrap(self) -> dict:
        """Mint the initial management token (acl_endpoint.go Bootstrap)."""
        from nomad_tpu_torch.server import fsm as fsm_msgs

        with self._lock:
            if self._bootstrapped or self.server.state.acl_tokens():
                raise ValueError("ACL bootstrap already done")
            self._bootstrapped = True
        token = ACLToken.create(name="Bootstrap Token", type="management",
                                global_=True)
        index = self.server.raft_apply(
            fsm_msgs.ACL_TOKEN_UPSERT, {"tokens": [token]}
        )
        return {
            "AccessorID": token.accessor_id,
            "SecretID": token.secret_id,
            "Name": token.name,
            "Type": token.type,
            "Global": token.global_,
            "CreateIndex": index,
        }

    def resolve(self, secret: str) -> ACL:
        if not secret:
            return self._anonymous()
        token = self.server.state.acl_token_by_secret(secret)
        if token is None:
            raise PermissionError("ACL token not found")
        return self.resolve_token(token)

    def resolve_token(self, token: ACLToken) -> ACL:
        if token.is_management():
            return MANAGEMENT_ACL
        key = tuple(sorted(token.policies))
        # a policy edit must invalidate compiled ACLs (the reference
        # recompiles on ACL-table changes); the acl_policy table index
        # read BEFORE compiling tags the entry, so a policy edited
        # mid-compile yields an entry that is already stale on arrival
        policy_index = self.server.state.table_index(["acl_policy"])
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None and entry[0] == policy_index:
                return entry[1]
        parsed = []
        for name in token.policies:
            p = self.server.state.acl_policy_by_name(name)
            if p is not None:
                parsed.append(p.parsed())
        acl = ACL.compile(parsed)
        with self._lock:
            cur = self._cache.get(key)
            if cur is None or cur[0] <= policy_index:
                self._cache[key] = (policy_index, acl)
        return acl

    def invalidate(self) -> None:
        with self._lock:
            self._cache.clear()

    def _anonymous(self) -> ACL:
        anon = self.server.state.acl_policy_by_name("anonymous")
        if anon is None:
            return ANONYMOUS_ACL
        return ACL.compile([anon.parsed()])
