"""Consul/Vault integration: token derivation and secret/KV providers.

Reference behavior: nomad/vault.go (server-side Vault client —
derives per-task tokens against the Vault token-role API, tracks
accessors, renews its own + derived tokens, revokes accessors when
allocs stop) and nomad/consul.go (Service Identity token derivation
for Consul Connect). The external daemons are pluggable here: the
``VaultProvider``/``ConsulProvider`` interfaces carry the wire
contract, and the built-in ``Dev*`` providers implement it in-memory
(the analog of ``vault server -dev`` / ``consul agent -dev`` in the
reference's test rigs). A real HTTP-backed provider can be slotted in
without touching the manager or the client hooks.
"""

from __future__ import annotations

import logging
import secrets as _secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

LOG = logging.getLogger(__name__)


@dataclass
class VaultTokenInfo:
    """A derived task token (vault.go tokenData subset)."""

    token: str = ""
    accessor: str = ""
    ttl_s: float = 3600.0
    policies: List[str] = field(default_factory=list)
    renewable: bool = True
    created_at: float = 0.0
    expires_at: float = 0.0


class VaultProvider:
    """Wire contract to a Vault server (nomad/vault.go vaultClient)."""

    def create_token(self, policies: List[str], ttl_s: float,
                     meta: Optional[Dict[str, str]] = None) -> VaultTokenInfo:
        raise NotImplementedError

    def renew(self, accessor: str) -> float:
        """Extend the token's lease; returns the new expiry."""
        raise NotImplementedError

    def revoke(self, accessor: str) -> None:
        raise NotImplementedError

    def read_secret(self, path: str,
                    token: str = "") -> Optional[Dict[str, str]]:
        """KV read for template rendering ({{ secret "path" ... }}).
        ``token`` is the reading task's derived token; reads are
        policy-checked against it."""
        raise NotImplementedError

    def secrets_index(self) -> int:
        """Monotonic modify index over the secret store (template
        watchers poll this alongside the Consul KV index)."""
        raise NotImplementedError


class DevVaultProvider(VaultProvider):
    """In-memory Vault (the `vault server -dev` analog).

    Tokens are random urlsafe strings; secrets live in a dict keyed by
    mount path. Lease math is real so renewal/expiry paths exercise
    the same way they would against an external server.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tokens: Dict[str, VaultTokenInfo] = {}   # accessor -> info
        self._secrets: Dict[str, Dict[str, str]] = {}
        self._index = 0
        # policy name -> allowed path prefixes (acl/policy analog).
        # Empty registry = dev mode: any valid token reads anything
        # (`vault server -dev` root-token behavior); once any policy
        # document exists, reads are enforced against the token's
        # policy set.
        self._policies: Dict[str, List[str]] = {}

    def create_token(self, policies, ttl_s, meta=None) -> VaultTokenInfo:
        now = time.time()
        info = VaultTokenInfo(
            token=f"s.{_secrets.token_urlsafe(24)}",
            accessor=_secrets.token_urlsafe(16),
            ttl_s=ttl_s, policies=list(policies),
            created_at=now, expires_at=now + ttl_s,
        )
        with self._lock:
            self._tokens[info.accessor] = info
        return info

    def renew(self, accessor: str) -> float:
        with self._lock:
            info = self._tokens.get(accessor)
            if info is None:
                raise KeyError(f"unknown accessor {accessor}")
            info.expires_at = time.time() + info.ttl_s
            return info.expires_at

    def revoke(self, accessor: str) -> None:
        with self._lock:
            self._tokens.pop(accessor, None)

    def lookup(self, accessor: str) -> Optional[VaultTokenInfo]:
        with self._lock:
            return self._tokens.get(accessor)

    def token_valid(self, token: str) -> bool:
        now = time.time()
        with self._lock:
            return any(i.token == token and i.expires_at > now
                       for i in self._tokens.values())

    # -- KV (for templates) ---------------------------------------------

    def write_secret(self, path: str, data: Dict[str, str]) -> None:
        with self._lock:
            self._secrets[path] = dict(data)
            self._index += 1

    def set_policy(self, name: str, path_prefixes: List[str]) -> None:
        """Define a policy document: the path prefixes tokens carrying
        ``name`` may read (vault policy write analog)."""
        with self._lock:
            self._policies[name] = list(path_prefixes)

    def read_secret(self, path: str,
                    token: str = "") -> Optional[Dict[str, str]]:
        now = time.time()
        with self._lock:
            if self._policies:
                info = next((i for i in self._tokens.values()
                             if i.token == token and i.expires_at > now),
                            None)
                if info is None:
                    raise PermissionError("vault: invalid or expired token")
                allowed = any(
                    path.startswith(prefix)
                    for pol in info.policies
                    for prefix in self._policies.get(pol, [])
                )
                if not allowed:
                    raise PermissionError(
                        f"vault: token policies {info.policies} do not "
                        f"grant read on {path!r}")
            data = self._secrets.get(path)
            return dict(data) if data is not None else None

    def secrets_index(self) -> int:
        with self._lock:
            return self._index


class VaultHTTPError(RuntimeError):
    """Non-auth HTTP failure from Vault, carrying the status code."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


class HTTPVaultProvider(VaultProvider):
    """Vault over its real HTTP API (nomad/vault.go vaultClient).

    Speaks the live wire shapes:
    - token derivation: ``POST /v1/auth/token/create[/<role>]``
      (vault.go derives against a token role when configured)
    - renewal: ``POST /v1/auth/token/renew-accessor``
    - revocation: ``POST /v1/auth/token/revoke-accessor``
    - KV reads: ``GET /v1/<path>`` with the task's ``X-Vault-Token``,
      handling both KV v2 (``data.data``) and v1 (``data``) response
      shapes; 403 maps to PermissionError (policy enforcement is
      Vault's), 404 to None

    Deviation: Vault exposes no global modify index, so
    ``secrets_index`` ticks once per ``index_interval_s`` — template
    watchers re-check their secrets at that cadence instead of on an
    exact-change signal (consul-template's lease watching analog).
    """

    def __init__(self, addr: str, token: str, token_role: str = "",
                 namespace: str = "", timeout_s: float = 10.0,
                 index_interval_s: float = 15.0) -> None:
        self.addr = addr.rstrip("/")
        self.token = token
        self.token_role = token_role
        self.namespace = namespace
        self.timeout_s = timeout_s
        self.index_interval_s = index_interval_s

    # -- wire ------------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[Dict] = None,
                 token: Optional[str] = None):
        import json as _json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"{self.addr}/v1/{path.lstrip('/')}",
            data=_json.dumps(body).encode() if body is not None else None,
            method=method,
        )
        req.add_header("X-Vault-Token",
                       token if token is not None else self.token)
        if self.namespace:
            req.add_header("X-Vault-Namespace", self.namespace)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                raw = r.read()
                return _json.loads(raw) if raw.strip() else {}
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            if e.code in (401, 403):
                raise PermissionError(
                    f"vault: {method} {path}: HTTP {e.code}") from e
            detail = e.read().decode(errors="replace")[:200]
            raise VaultHTTPError(e.code,
                                 f"vault: {method} {path}: HTTP {e.code} "
                                 f"{detail}") from e

    # -- VaultProvider ---------------------------------------------------

    def create_token(self, policies, ttl_s, meta=None) -> VaultTokenInfo:
        path = "auth/token/create"
        if self.token_role:
            path += f"/{self.token_role}"
        resp = self._request("POST", path, {
            "policies": list(policies),
            "ttl": f"{int(ttl_s)}s",
            "renewable": True,
            "meta": dict(meta or {}),
        })
        if resp is None:
            raise RuntimeError(
                f"vault: token create endpoint /v1/{path} not found — "
                "check the vault address"
                + (f" and token role {self.token_role!r}"
                   if self.token_role else ""))
        if "auth" not in resp:
            raise RuntimeError("vault: token create returned no auth block")
        auth = resp["auth"]
        now = time.time()
        lease = float(auth.get("lease_duration") or ttl_s)
        return VaultTokenInfo(
            token=auth["client_token"],
            accessor=auth["accessor"],
            ttl_s=lease,
            policies=list(auth.get("token_policies")
                          or auth.get("policies") or policies),
            renewable=bool(auth.get("renewable", True)),
            created_at=now,
            expires_at=now + lease,
        )

    def renew(self, accessor: str) -> float:
        try:
            resp = self._request("POST", "auth/token/renew-accessor",
                                 {"accessor": accessor})
        except VaultHTTPError as e:
            # real Vault answers 400 "invalid accessor" for a revoked/
            # unknown accessor; the manager's renew loop treats
            # KeyError as "revoked out from under us"
            if e.code == 400:
                raise KeyError(f"unknown accessor {accessor}") from e
            raise
        if resp is None:
            raise KeyError(f"unknown accessor {accessor}")
        lease = float((resp.get("auth") or {}).get("lease_duration") or 0)
        return time.time() + lease

    def revoke(self, accessor: str) -> None:
        self._request("POST", "auth/token/revoke-accessor",
                      {"accessor": accessor})

    def token_valid(self, token: str) -> bool:
        """False ONLY when Vault says the token is invalid; transport
        and server errors propagate — reporting an unreachable Vault as
        'token revoked' would rotate live tokens (and restart tasks)
        on every network blip."""
        try:
            resp = self._request("GET", "auth/token/lookup-self",
                                 token=token)
        except PermissionError:
            return False
        return resp is not None

    def read_secret(self, path: str,
                    token: str = "") -> Optional[Dict[str, str]]:
        if not token:
            # never fall back to the manager's own privileged token:
            # reads are policy-checked against the TASK's credential
            # (the Dev provider raises the same way)
            raise PermissionError("vault: read requires the task token")
        resp = self._request("GET", path, token=token)
        if resp is None:
            return None
        data = resp.get("data") or {}
        inner = data.get("data")
        meta = data.get("metadata")
        # KV v2 envelope: metadata is a dict carrying version/created
        # fields (a v1 secret that merely HAS 'data'/'metadata' string
        # fields must not match); a soft-deleted/destroyed version has
        # data: null and must read as absent, not as the wrapper
        if "data" in data and isinstance(meta, dict) \
                and ("version" in meta or "created_time" in meta):
            return dict(inner) if isinstance(inner, dict) else None
        return dict(data)                       # KV v1 shape

    def secrets_index(self) -> int:
        return int(time.time() // self.index_interval_s)


class ConsulProvider:
    """Wire contract to a Consul agent (nomad/consul.go + template KV)."""

    def kv_put(self, key: str, value: str) -> int:
        raise NotImplementedError

    def kv_get(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def kv_list(self, prefix: str) -> List[Tuple[str, str]]:
        """Sorted (key, value) pairs under a prefix on a path boundary
        (the ``ls``/``tree`` template data source)."""
        raise NotImplementedError

    def kv_index(self) -> int:
        """Monotonic modify index over the KV store (blocking-query
        analog; template watchers poll this)."""
        raise NotImplementedError

    def derive_si_token(self, alloc_id: str, task: str,
                        service: str) -> str:
        """Service Identity token for Connect workloads
        (consul.go DeriveSITokens)."""
        raise NotImplementedError

    def mesh_identity_token(self, namespace: str, service: str) -> str:
        """The per-service mesh credential both sides of a Connect
        pair present/verify — the SI-token-backed stand-in for Envoy
        mTLS certificates + intentions (allow-by-shared-identity)."""
        raise NotImplementedError


class DevConsulProvider(ConsulProvider):
    """In-memory Consul KV + SI tokens (`consul agent -dev` analog)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._kv: Dict[str, str] = {}
        self._index = 0
        self._si_tokens: Dict[Tuple[str, str], str] = {}

    def kv_put(self, key: str, value: str) -> int:
        with self._lock:
            self._kv[key] = value
            self._index += 1
            return self._index

    def kv_delete(self, key: str) -> int:
        with self._lock:
            self._kv.pop(key, None)
            self._index += 1
            return self._index

    def kv_get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._kv.get(key)

    def kv_list(self, prefix: str) -> List[Tuple[str, str]]:
        """Sorted (key, value) pairs UNDER a prefix on a path boundary
        (consul-template's ls/tree data source: 'app' must not match
        'apple')."""
        prefix = prefix.rstrip("/")
        with self._lock:
            if not prefix:
                return sorted(self._kv.items())
            return sorted(
                (k, v) for k, v in self._kv.items()
                if k == prefix or k.startswith(prefix + "/"))

    def kv_index(self) -> int:
        with self._lock:
            return self._index

    def derive_si_token(self, alloc_id, task, service) -> str:
        with self._lock:
            key = (alloc_id, task)
            if key not in self._si_tokens:
                self._si_tokens[key] = _secrets.token_urlsafe(16)
            return self._si_tokens[key]

    def mesh_identity_token(self, namespace: str, service: str) -> str:
        with self._lock:
            key = ("mesh", namespace, service)
            if key not in self._si_tokens:
                self._si_tokens[key] = _secrets.token_urlsafe(16)
            return self._si_tokens[key]


class VaultManager:
    """Server-side token lifecycle (nomad/vault.go vaultClient).

    Tracks every accessor it hands out keyed by alloc, renews
    renewable tokens at half-TTL from a background loop, and revokes
    an alloc's accessors when it goes terminal (vault.go
    RevokeTokens; wired from the client-status update path the way
    the reference wires it from the FSM alloc-update path).
    """

    #: derived tokens default TTL (vault.go DefaultVaultTokenTTL-ish)
    DEFAULT_TTL_S = 3600.0

    def __init__(self, provider: Optional[VaultProvider] = None,
                 renew_interval_s: float = 30.0) -> None:
        self.provider = provider or DevVaultProvider()
        self.renew_interval_s = renew_interval_s
        self._lock = threading.Lock()
        # alloc_id -> {task: accessor}
        self._accessors: Dict[str, Dict[str, str]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._renew_loop, daemon=True, name="vault-renewal"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- derivation ------------------------------------------------------

    def derive_tokens(self, alloc_id: str, task_policies: Dict[str, List[str]],
                      ttl_s: Optional[float] = None) -> Dict[str, VaultTokenInfo]:
        """Node.DeriveVaultToken: one token per requesting task."""
        out: Dict[str, VaultTokenInfo] = {}
        ttl = ttl_s or self.DEFAULT_TTL_S
        for task, policies in task_policies.items():
            info = self.provider.create_token(
                policies, ttl,
                meta={"AllocationID": alloc_id, "Task": task},
            )
            out[task] = info
            with self._lock:
                self._accessors.setdefault(alloc_id, {})[task] = info.accessor
        return out

    def accessors_for_alloc(self, alloc_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._accessors.get(alloc_id, {}))

    # -- revocation ------------------------------------------------------

    def revoke_for_alloc(self, alloc_id: str) -> int:
        """Revoke every accessor derived for the alloc; returns count."""
        with self._lock:
            tasks = self._accessors.pop(alloc_id, {})
        n = 0
        for accessor in tasks.values():
            try:
                self.provider.revoke(accessor)
                n += 1
            except Exception as e:              # noqa: BLE001
                LOG.warning("vault: revoke %s failed: %s", accessor[:8], e)
        return n

    def revoke_all(self) -> int:
        """Leader-restore purge (leader.go:582 revokeVaultAccessorsOnRestore)."""
        with self._lock:
            alloc_ids = list(self._accessors)
        return sum(self.revoke_for_alloc(a) for a in alloc_ids)

    # -- renewal ---------------------------------------------------------

    def _renew_loop(self) -> None:
        while not self._stop.wait(self.renew_interval_s):
            with self._lock:
                accessors = [
                    acc for tasks in self._accessors.values()
                    for acc in tasks.values()
                ]
            for acc in accessors:
                try:
                    self.provider.renew(acc)
                except KeyError:
                    pass   # revoked out from under us; reaped on stop
                except Exception as e:          # noqa: BLE001
                    LOG.warning("vault: renew failed: %s", e)
