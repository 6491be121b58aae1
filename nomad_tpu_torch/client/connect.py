"""Connect hook: sidecar + upstream proxies for service-mesh groups.

Reference behavior: client/allocrunner/taskrunner/envoy_bootstrap_hook.go
+ connect_native_hook.go + the group-service hook's sidecar
registration. For every group service with a ``connect.sidecar_service``
stanza this hook:

1. derives the service's mesh identity token from the server
   (consul.go DeriveSITokens analog — the SecretsClient RPC);
2. launches the INBOUND sidecar proxy (client/connect_proxy.py, the
   envoy stand-in) inside the allocation's network namespace: mesh
   port (the scheduler-assigned ``connect-proxy-<svc>`` dynamic port)
   -> 127.0.0.1:<local service port>, token-gated;
3. launches one UPSTREAM proxy per declared upstream: a loopback
   listener on ``local_bind_port`` inside the namespace that relays to
   the destination's sidecar (resolved from the native service
   registry, re-resolved until it appears) with the token preamble;
4. synthesizes the ``<name>-sidecar-proxy`` service registration so
   other allocations discover the mesh entry point (the Consul sidecar
   service Nomad registers for Connect).

Connect-native services skip the proxies: the hook only derives the
token and exposes it as ``NOMAD_SI_TOKEN_<SVC>`` task env
(connect_native_hook.go workload-identity delivery).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs.job import Service

LOG = logging.getLogger(__name__)

PROXY_PROGRAM = os.path.join(os.path.dirname(__file__), "connect_proxy.py")


class _Proxy:
    __slots__ = ("proc", "desc")

    def __init__(self, proc: subprocess.Popen, desc: str) -> None:
        self.proc = proc
        self.desc = desc


class AllocConnect:
    """Per-allocation mesh state (the hook's runtime handle)."""

    def __init__(self, alloc_id: str) -> None:
        self.alloc_id = alloc_id
        self.proxies: List[_Proxy] = []
        self.sidecar_services: List[Service] = []
        self.env: Dict[str, str] = {}
        self._stop = threading.Event()
        # serializes proxy-list mutation vs destroy so a late resolver
        # thread can never spawn into an already-reaped state
        self._lock = threading.Lock()

    def add_proxy(self, proc: subprocess.Popen,
                  desc: str) -> Optional[_Proxy]:
        """Track a spawned proxy; None (caller must kill it) when
        the alloc was already destroyed."""
        with self._lock:
            if self._stop.is_set():
                return None
            p = _Proxy(proc, desc)
            self.proxies.append(p)
            return p

    def destroy(self) -> None:
        with self._lock:
            self._stop.set()
            proxies = list(self.proxies)
        for p in proxies:
            try:
                p.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        for p in proxies:
            try:
                p.proc.wait(timeout=2)
            except (OSError, subprocess.TimeoutExpired):
                try:
                    p.proc.kill()
                except OSError:
                    pass


class ConnectManager:
    """Launches and tracks sidecar/upstream proxies per allocation."""

    def __init__(self, rpc) -> None:
        self.rpc = rpc

    # -- hook entry ------------------------------------------------------

    def setup(self, alloc, tg, alloc_network) -> Optional[AllocConnect]:
        """Start mesh plumbing for the group's connect services.
        Returns None when the group has none."""
        connect_services = [
            s for s in (tg.services or [])
            if s.has_sidecar() or s.is_connect_native()
        ]
        if not connect_services:
            return None
        state = AllocConnect(alloc.id)
        try:
            self._setup_services(state, alloc, tg, alloc_network,
                                 connect_services)
        except Exception:
            # a partial setup must not leak already-spawned proxies
            state.destroy()
            raise
        return state

    def _setup_services(self, state, alloc, tg, alloc_network,
                        connect_services) -> None:
        for svc in connect_services:
            token = self._mesh_token(alloc, svc)
            env_key = ("NOMAD_SI_TOKEN_"
                       + svc.name.upper().replace("-", "_"))
            state.env[env_key] = token
            if not svc.has_sidecar():
                continue                      # connect-native: token only
            if alloc_network is None:
                raise RuntimeError(
                    f"connect sidecar for {svc.name} requires bridge "
                    "networking on this client")
            self._start_sidecar(state, alloc, svc, alloc_network, token)
            for up in svc.upstreams():
                self._start_upstream(state, alloc, svc, up, alloc_network)
            sidecar = Service(
                name=f"{svc.name}-sidecar-proxy",
                port_label=svc.mesh_port_label(),
                tags=["connect-proxy"] + list(svc.tags),
            )
            state.sidecar_services.append(sidecar)

    # -- internals -------------------------------------------------------

    def _mesh_token(self, alloc, svc: Service) -> str:
        try:
            return self.rpc.mesh_identity_token(alloc.namespace, svc.name,
                                                alloc_id=alloc.id)
        except Exception as e:                  # noqa: BLE001
            raise RuntimeError(
                f"mesh identity token for {svc.name}: {e}") from e

    def _mesh_ports(self, alloc, svc: Service) -> Tuple[int, int]:
        """(host mesh port, in-namespace mesh port) from the alloc's
        scheduler-assigned ports."""
        res = alloc.allocated_resources
        label = svc.mesh_port_label()
        ports = []
        if res is not None and res.shared is not None:
            ports.extend(res.shared.ports)
            for net in res.shared.networks:
                ports.extend(list(net.dynamic_ports)
                             + list(net.reserved_ports))
        for p in ports:
            if p.label == label:
                return p.value, (p.to or p.value)
        raise RuntimeError(
            f"no scheduler-assigned mesh port '{label}' on alloc "
            f"{alloc.id} (connect admission should have injected it)")

    def _local_service_port(self, alloc, svc: Service) -> int:
        proxy = svc.sidecar_proxy()
        port = int(proxy.get("local_service_port") or 0)
        if port:
            return port
        # fall back to the service's own port label's container port
        res = alloc.allocated_resources
        if res is not None and res.shared is not None and svc.port_label:
            for net in res.shared.networks:
                for p in list(net.dynamic_ports) + list(net.reserved_ports):
                    if p.label == svc.port_label:
                        return p.to or p.value
            for p in res.shared.ports:
                if p.label == svc.port_label:
                    return p.to or p.value
        raise RuntimeError(
            f"connect service {svc.name}: no local_service_port and no "
            f"resolvable port label '{svc.port_label}'")

    def _spawn(self, state: AllocConnect, netns: str, cfg: Dict,
               desc: str) -> Optional[_Proxy]:
        argv = ["ip", "netns", "exec", netns, sys.executable, "-S",
                PROXY_PROGRAM, json.dumps(cfg)]
        proc = subprocess.Popen(
            argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        tracked = state.add_proxy(proc, desc)
        if tracked is None:
            # destroy() won between spawn decision and tracking: the
            # alloc is gone, reap the orphan immediately
            try:
                proc.kill()
            except OSError:
                pass
            return None
        LOG.info("connect %s: %s (pid %d)", state.alloc_id[:8], desc,
                 proc.pid)
        return tracked

    def _start_sidecar(self, state, alloc, svc, net, token: str) -> None:
        _host_port, ns_port = self._mesh_ports(alloc, svc)
        local = self._local_service_port(alloc, svc)
        cfg = {
            "mode": "inbound",
            "listen": ["0.0.0.0", ns_port],
            "target": ["127.0.0.1", local],
            "token": token,
        }
        self._spawn(state, net.ns_name, cfg,
                    f"sidecar {svc.name} :{ns_port} -> 127.0.0.1:{local}")

    def _start_upstream(self, state, alloc, svc, upstream: Dict,
                        net) -> None:
        dest = str(upstream.get("destination_name", ""))
        bind = int(upstream.get("local_bind_port") or 0)
        if not dest or not bind:
            raise RuntimeError(
                f"connect upstream on {svc.name}: destination_name and "
                "local_bind_port are required")
        # the preamble presents the DESTINATION service's identity —
        # its inbound gate verifies against the same derived credential
        # (the intentions-allow analog)
        token = self.rpc.mesh_identity_token(alloc.namespace, dest,
                                             alloc_id=alloc.id)

        def resolve(delay: float):
            try:
                regs = self.rpc.services_by_name(
                    alloc.namespace, f"{dest}-sidecar-proxy")
            except Exception as e:              # noqa: BLE001
                LOG.warning("connect upstream %s: resolve: %s", dest, e)
                return None
            if not regs:
                return None
            addr = str(regs[0]["Address"])
            # host-local destinations: inside the namespace, 127.0.0.1
            # is the netns loopback — the node's listeners (port
            # relays) live at the bridge gateway address
            if addr in ("127.0.0.1", "localhost", "0.0.0.0") \
                    and net.gateway:
                addr = net.gateway
            return (addr, int(regs[0]["Port"]))

        def watch() -> None:
            import time as _time

            current = None      # (addr, port) the live proxy targets
            proxy = None
            delay = 0.2
            while not state._stop.is_set():
                target = resolve(delay)
                if target is not None and target != current:
                    # destination appeared or MOVED (rescheduled alloc
                    # gets a new node/mesh port): point the upstream at
                    # the new sidecar — envoy's cluster discovery keeps
                    # endpoints current the same way
                    if proxy is not None:
                        try:
                            proxy.proc.terminate()
                        except OSError:
                            pass
                    cfg = {
                        "mode": "upstream",
                        "listen": ["127.0.0.1", bind],
                        "target": list(target),
                        "token": token,
                    }
                    proxy = self._spawn(
                        state, net.ns_name, cfg,
                        f"upstream {dest} 127.0.0.1:{bind} -> "
                        f"{target[0]}:{target[1]}")
                    if proxy is None:
                        return          # alloc destroyed mid-spawn
                    current = target
                    delay = 5.0         # steady-state watch cadence
                elif current is None:
                    _time.sleep(delay)
                    delay = min(delay * 1.5, 3.0)
                    continue
                state._stop.wait(delay)

        # the destination may not be registered yet (its alloc is still
        # starting) and may move later; watch in the background
        threading.Thread(target=watch, daemon=True,
                         name=f"connect-resolve-{dest}").start()
