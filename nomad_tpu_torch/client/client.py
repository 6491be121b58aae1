"""The Client: node agent main loop.

Reference behavior: client/client.go (3,174 LoC) -- fingerprint the
host into a Node, register with servers and heartbeat
(registerAndHeartbeat :1609), watch assigned allocations with a
blocking query (watchAllocations :2063), diff into add/update/remove
(runAllocs :2293), run allocRunners, batch alloc status updates back to
the server, persist state for restart recovery (restoreState
:1109-1180), and GC terminal allocs.

The RPC boundary is the ``ClientRPC`` protocol: ``InProcessRPC`` talks
to a Server object directly (the test topology); the HTTP transport
plugs in at the same seam.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional, Protocol

from nomad_tpu_torch.client.alloc_runner import AllocRunner
from nomad_tpu_torch.client.fingerprint import fingerprint_node
from nomad_tpu_torch.client.state_db import MemStateDB, StateDB
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.telemetry.trace import tracer
from nomad_tpu_torch.utils.metrics import global_registry
from nomad_tpu_torch.structs.alloc import Allocation

LOG = logging.getLogger(__name__)


class ClientRPC(Protocol):
    def register_node(self, node) -> Dict: ...
    def update_status(self, node_id: str, status: str) -> Dict: ...
    def get_client_allocs(self, node_id: str, min_index: int, timeout: float) -> Dict: ...
    def update_allocs(self, allocs: List[Allocation]) -> int: ...
    def csi_claim(self, namespace: str, volume_id: str, claim): ...


class InProcessRPC:
    """Direct-call transport to a Server (test topology; the reference
    equivalent is the client and server sharing an agent process)."""

    def __init__(self, server) -> None:
        self.server = server

    def register_node(self, node) -> Dict:
        return self.server.node_register(node)

    def update_status(self, node_id: str, status: str) -> Dict:
        return self.server.node_update_status(node_id, status)

    def get_client_allocs(self, node_id: str, min_index: int, timeout: float) -> Dict:
        return self.server.get_client_allocs(node_id, min_index, timeout)

    def update_allocs(self, allocs: List[Allocation]) -> int:
        return self.server.update_allocs_from_client(allocs)

    def csi_claim(self, namespace: str, volume_id: str, claim):
        """CSIVolume.Claim RPC (allocrunner/csi_hook.go)."""
        self.server.csi_volume_claim(namespace, volume_id, claim)
        return self.server.state.csi_volume_by_id(namespace, volume_id)

    def derive_vault_tokens(self, alloc_id: str,
                            task_names: List[str]) -> Dict[str, str]:
        """Node.DeriveVaultToken RPC (taskrunner vault_hook)."""
        return self.server.derive_vault_tokens(alloc_id, task_names)

    def consul_kv_get(self, key: str):
        """Consul KV read for template rendering."""
        return self.server.consul.kv_get(key)

    def consul_kv_index(self) -> int:
        return self.server.consul.kv_index()

    def consul_kv_list(self, prefix: str):
        return self.server.consul.kv_list(prefix)

    def services_index(self) -> int:
        """Service-registration table index (templates ranging over
        ``service`` re-render when instances come and go)."""
        return self.server.state.table_index(["services"])

    def vault_read_secret(self, path: str, token: str = ""):
        """Policy-checked against the task's derived token."""
        return self.server.vault.provider.read_secret(path, token=token)

    def vault_secrets_index(self) -> int:
        return self.server.vault.provider.secrets_index()

    def vault_token_valid(self, token: str) -> bool:
        return self.server.vault.provider.token_valid(token)

    def register_services(self, regs) -> int:
        """ServiceRegistration.Upsert RPC (client serviceregistration
        wrapper -> NomadServiceProvider)."""
        return self.server.service_register(regs)

    def mesh_identity_token(self, namespace: str, service: str,
                            alloc_id: str = "") -> str:
        """Connect mesh credential (consul.go DeriveSITokens analog).
        ``alloc_id`` scopes derivation to the alloc's declared
        services/upstreams server-side."""
        return self.server.mesh_identity_token(namespace, service,
                                               alloc_id=alloc_id)

    def services_by_name(self, namespace: str, name: str):
        """ServiceRegistration.GetService (connect upstream discovery)."""
        return self.server.services_by_name(namespace, name)

    def deregister_services_by_alloc(self, alloc_ids) -> int:
        return self.server.service_deregister_by_alloc(alloc_ids)

    def deregister_services(self, reg_ids) -> int:
        index = 0
        for rid in reg_ids:
            try:
                index = self.server.service_deregister(rid)
            except ValueError:
                pass   # already gone (idempotent dereg)
        return index


class SecretsClient:
    """Client-side facade over the server's Vault/Consul surface: the
    data sources taskrunner vault/template hooks pull from
    (vault_hook.go tokens; template.go Consul KV + Vault KV reads)."""

    def __init__(self, rpc, node=None) -> None:
        self.rpc = rpc
        self.node = node

    def derive_vault_tokens(self, alloc_id: str,
                            task_names: List[str]) -> Dict[str, str]:
        return self.rpc.derive_vault_tokens(alloc_id, task_names)

    def kv_get(self, key: str):
        return self.rpc.consul_kv_get(key)

    def kv_ls(self, prefix: str):
        return self.rpc.consul_kv_list(prefix)

    def services(self, namespace: str, name: str):
        """Live service instances for template ``service`` blocks."""
        return self.rpc.services_by_name(namespace, name)

    def read_secret(self, path: str, token: str = ""):
        return self.rpc.vault_read_secret(path, token)

    def live_data_index(self) -> int:
        """Combined monotonic index over every live template source
        (Consul KV + Vault secrets + service registrations); watchers
        poll this."""
        return (self.rpc.consul_kv_index()
                + self.rpc.vault_secrets_index()
                + self.rpc.services_index())

    def vault_token_valid(self, token: str) -> bool:
        return self.rpc.vault_token_valid(token)

    def node_attrs(self) -> Dict[str, str]:
        return dict(self.node.attributes) if self.node is not None else {}


class ClientConfig:
    def __init__(
        self,
        data_dir: str = os.path.join(tempfile.gettempdir(),
                                     "nomad-tpu-client"),
        datacenter: str = "dc1",
        node_class: str = "",
        meta: Optional[Dict[str, str]] = None,
        persistent_state: bool = False,
        update_batch_interval: float = 0.2,
        max_terminal_allocs: int = 50,
        plugin_dir: str = "",
        options: Optional[Dict[str, str]] = None,
    ) -> None:
        self.data_dir = data_dir
        self.datacenter = datacenter
        self.node_class = node_class
        self.meta = meta or {}
        self.persistent_state = persistent_state
        self.update_batch_interval = update_batch_interval
        self.max_terminal_allocs = max_terminal_allocs
        self.plugin_dir = plugin_dir
        # client { options { "docker.volumes.enabled" = "true" } }
        # (agent config.go client options map, consumed by drivers)
        self.options = options or {}


class Client:
    def __init__(
        self,
        rpc: ClientRPC,
        config: Optional[ClientConfig] = None,
        drivers: Optional[Dict] = None,
        device_plugins: Optional[List] = None,
        node_id: Optional[str] = None,
        csi_clients: Optional[Dict] = None,
    ) -> None:
        self.rpc = rpc
        self.config = config or ClientConfig()
        if drivers is None:
            from nomad_tpu_torch.drivers import builtin_drivers
            drivers = builtin_drivers(self.config.options)
        # external plugin subprocesses from plugin_dir merge over the
        # built-ins (helper/pluginutils/catalog + loader semantics)
        self.external_drivers: Dict[str, object] = {}
        if self.config.plugin_dir:
            from nomad_tpu_torch.plugins.external import load_plugin_dir
            self.external_drivers = load_plugin_dir(self.config.plugin_dir)
            drivers = dict(drivers, **self.external_drivers)
        self.drivers = drivers
        self.device_plugins = device_plugins or []
        self.csi_clients = csi_clients or {}

        os.makedirs(self.config.data_dir, exist_ok=True)
        if self.config.persistent_state:
            self.state_db: StateDB = StateDB(
                os.path.join(self.config.data_dir, "client_state.db")
            )
        else:
            self.state_db = MemStateDB()

        # stable node ID across restarts (client.go nodeID persistence)
        self.node_id = node_id or self.state_db.get_meta("node_id") or str(uuid.uuid4())
        self.state_db.put_meta("node_id", self.node_id)

        self.node = fingerprint_node(
            self.node_id,
            datacenter=self.config.datacenter,
            node_class=self.config.node_class,
            drivers=self.drivers,
            device_plugins=self.device_plugins,
            meta=self.config.meta,
        )
        # advertise CSI node plugins this agent runs (the reference
        # fingerprints these from plugin allocs via dynamicplugins; the
        # build registers them at agent config time)
        for pid, client in self.csi_clients.items():
            info = {"healthy": True}
            try:
                detail = client.plugin_get_info()
                info["provider"] = detail.get("name", "")
                info["version"] = detail.get("version", "")
            except Exception:                   # noqa: BLE001
                info["healthy"] = False
            self.node.csi_node_plugins[pid] = info
        from nomad_tpu_torch.client.csimanager import CSIManager

        self.csi_manager = CSIManager(
            rpc, self.csi_clients, self.node_id, self.config.data_dir
        ) if hasattr(rpc, "csi_claim") else None
        # bridge-mode alloc networking (networking_bridge_linux.go);
        # probed once, None on hosts without netns/veth privileges
        from nomad_tpu_torch.client.network_manager import (
            BridgeNetworkManager, bridge_supported,
        )

        self.network_manager = BridgeNetworkManager() \
            if bridge_supported() else None
        from nomad_tpu_torch.client.servicereg import ServiceRegWrapper

        self.service_reg = ServiceRegWrapper(rpc, self.node) \
            if hasattr(rpc, "register_services") else None
        # Connect hook manager (envoy_bootstrap_hook analog); needs the
        # mesh-token + discovery RPC verbs
        from nomad_tpu_torch.client.connect import ConnectManager

        self.connect_mgr = ConnectManager(rpc) \
            if hasattr(rpc, "mesh_identity_token") else None
        self.secrets = SecretsClient(rpc, self.node) \
            if hasattr(rpc, "derive_vault_tokens") else None
        self.allocs: Dict[str, AllocRunner] = {}
        self._alloc_lock = threading.Lock()
        self._alloc_indexes: Dict[str, int] = {}    # alloc_id -> modify_index
        self._pending_updates: Dict[str, Allocation] = {}
        self._update_lock = threading.Lock()
        self.heartbeat_ttl = 10.0
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []

    # --- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._restore_state()
        self._register()
        for name, target in (
            ("heartbeat", self._run_heartbeat),
            ("watch-allocs", self._run_watch_allocations),
            ("update-allocs", self._run_update_batcher),
        ):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"client-{name}-{self.node_id[:8]}")
            self._threads.append(t)
            t.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
        self._flush_updates()
        for drv in self.external_drivers.values():
            drv.shutdown()
        self.state_db.close()

    def stop_allocs(self) -> None:
        """Stop all running allocs (used by tests/drain shutdown)."""
        with self._alloc_lock:
            runners = list(self.allocs.values())
        for ar in runners:
            ar.stop("client shutting down")

    def _prev_runner(self, alloc_id: str):
        """allocwatcher lookup: the previous alloc's local runner."""
        with self._alloc_lock:
            return self.allocs.get(alloc_id)

    # --- registration + heartbeat (client.go:1609) ----------------------

    def _register(self) -> None:
        self.node.status = consts.NODE_STATUS_INIT
        resp = self.rpc.register_node(self.node)
        self.heartbeat_ttl = resp.get("heartbeat_ttl", 10.0) or 10.0
        # first heartbeat flips the node ready (client.go watchNodeUpdates)
        self.rpc.update_status(self.node_id, consts.NODE_STATUS_READY)

    def _run_heartbeat(self) -> None:
        self.last_heartbeat_ok = time.time()
        while not self._shutdown.is_set():
            # heartbeat at a fraction of the TTL (client.go heartbeats
            # at intervals inside the server-granted TTL)
            wait = max(self.heartbeat_ttl * 0.4, 0.05)
            if self._shutdown.wait(wait):
                return
            if getattr(self, "partition_heartbeats", False):
                # test hook: a network partition — tasks keep running,
                # heartbeats stop reaching the servers (the
                # disconnected-clients e2e scenarios flip this)
                self._heartbeat_stop_check()
                continue
            try:
                away = time.time() - self.last_heartbeat_ok
                # heartbeat round-trip telemetry (client.go emits
                # client.heartbeat latency the same way): a server whose
                # applier or GIL is saturated shows up HERE first, as
                # heartbeat latency creeping toward the TTL
                t_hb = time.perf_counter()
                with tracer.span("client.heartbeat", trace_id=self.node_id):
                    resp = self.rpc.update_status(
                        self.node_id, consts.NODE_STATUS_READY
                    )
                global_registry.add_sample(
                    "nomad.client.heartbeat",
                    (time.perf_counter() - t_hb) * 1000.0,
                )
                self.heartbeat_ttl = resp.get("heartbeat_ttl", self.heartbeat_ttl) or self.heartbeat_ttl
                self.last_heartbeat_ok = time.time()
                if away > max(self.heartbeat_ttl, 1.0):
                    # reconnect after a real gap: the servers may have
                    # marked our allocs 'unknown' — re-push every live
                    # runner's actual status (client.go marks allocs
                    # dirty on reconnect so the server's view heals)
                    self._resync_alloc_states()
            except Exception as e:              # noqa: BLE001
                LOG.warning("client %s: heartbeat failed: %s", self.node_id[:8], e)
                self._heartbeat_stop_check()
                # the server may have lost our node (restart, GC):
                # re-register instead of retrying forever
                # (client.go retryRegisterNode on "node not found")
                try:
                    self._register()
                    self.last_heartbeat_ok = time.time()
                except Exception as re_err:     # noqa: BLE001
                    LOG.warning(
                        "client %s: re-register failed: %s",
                        self.node_id[:8], re_err,
                    )

    def _heartbeat_stop_check(self) -> None:
        """heartbeatstop.go: while disconnected from servers, stop any
        alloc whose group sets stop_after_client_disconnect once the
        disconnect outlives that duration (the client self-stops so
        the replacement the server schedules can't double-run)."""
        away = time.time() - self.last_heartbeat_ok
        with self._alloc_lock:
            runners = list(self.allocs.values())
        for runner in runners:
            tg = runner.alloc.job.lookup_task_group(runner.alloc.task_group) \
                if runner.alloc.job is not None else None
            stop_after = getattr(tg, "stop_after_client_disconnect_s", None) \
                if tg is not None else None
            if stop_after is None or away < stop_after:
                continue
            if runner.is_done():
                continue
            LOG.warning(
                "client %s: heartbeat lost %.0fs > stop_after_client_"
                "disconnect; stopping alloc %s",
                self.node_id[:8], away, runner.alloc.id[:8])
            runner.stop("heartbeat with servers lost")

    # --- allocation watching (client.go:2063, :2293) --------------------

    def _run_watch_allocations(self) -> None:
        index = 0
        while not self._shutdown.is_set():
            try:
                resp = self.rpc.get_client_allocs(
                    self.node_id, min_index=index, timeout=1.0
                )
            except Exception as e:              # noqa: BLE001
                LOG.warning("client %s: alloc watch failed: %s", self.node_id[:8], e)
                if self._shutdown.wait(1.0):
                    return
                continue
            index = max(index, resp.get("index", index))
            self._run_allocs(resp.get("allocs", []))

    def _run_allocs(self, server_allocs: List[Allocation]) -> None:
        """runAllocs: diff server view against local runners."""
        with self._alloc_lock:
            existing = dict(self.allocs)
        server_by_id = {a.id: a for a in server_allocs}

        for alloc in server_allocs:
            runner = existing.get(alloc.id)
            if runner is None:
                if alloc.server_terminal_status() or alloc.client_terminal_status():
                    continue
                self._add_alloc(alloc)
            elif alloc.modify_index > self._alloc_indexes.get(alloc.id, 0):
                self._alloc_indexes[alloc.id] = alloc.modify_index
                if alloc.job is None:
                    alloc.job = runner.alloc.job
                runner.update(alloc)

        # GC runners the server no longer knows (garbage collected)
        for alloc_id, runner in existing.items():
            if alloc_id not in server_by_id:
                runner.destroy()
                with self._alloc_lock:
                    self.allocs.pop(alloc_id, None)

        self._gc_terminal()

    def _add_alloc(self, alloc: Allocation) -> None:
        runner = AllocRunner(
            alloc=alloc,
            drivers=self.drivers,
            data_dir=self.config.data_dir,
            on_alloc_update=self._queue_update,
            state_db=self.state_db,
            csi_manager=self.csi_manager,
            service_reg=self.service_reg,
            secrets=self.secrets,
            prev_lookup=self._prev_runner,
            device_plugins=self.device_plugins,
            connect_mgr=self.connect_mgr,
            network_manager=self.network_manager,
        )
        with self._alloc_lock:
            self.allocs[alloc.id] = runner
            self._alloc_indexes[alloc.id] = alloc.modify_index
        self.state_db.put_allocation(alloc)
        threading.Thread(
            target=runner.run, daemon=True, name=f"allocrun-{alloc.id[:8]}"
        ).start()

    def _gc_terminal(self) -> None:
        """client/gc.go: bound the number of terminal alloc runners."""
        with self._alloc_lock:
            terminal = [
                (aid, ar) for aid, ar in self.allocs.items()
                if ar.is_done() and ar.alloc.terminal_status()
            ]
            excess = len(terminal) - self.config.max_terminal_allocs
            victims = terminal[:max(excess, 0)]
            for aid, _ar in victims:
                self.allocs.pop(aid, None)
        # destroy outside the lock: it blocks on task teardown
        for _aid, ar in victims:
            ar.destroy()

    # --- status updates (client.go allocSync batching) ------------------

    def _resync_alloc_states(self) -> None:
        """Queue a status update for every live runner — used after a
        reconnect, when the servers' view (possibly 'unknown'/'lost')
        must converge back to the client's ground truth."""
        import copy as _copy

        from nomad_tpu_torch.structs.alloc import TaskEvent

        now_ns = time.time_ns()
        with self._alloc_lock:
            runners = list(self.allocs.values())
        for runner in runners:
            try:
                updated = runner.alloc.copy_skip_job()
                with runner._lock:
                    updated.task_states = _copy.deepcopy(
                        dict(runner.task_states))
                # the reconnect stamp the reconciler compares against
                # the server's 'Disconnected' mark (structs.go
                # Allocation.Reconnected)
                for ts in updated.task_states.values():
                    ts.events.append(TaskEvent(
                        type="Reconnected", time_ns=now_ns,
                        message="client reconnected"))
                updated.client_status = runner.client_status()
                self._queue_update(updated)
            except Exception:                   # noqa: BLE001
                pass

    def _queue_update(self, alloc: Allocation) -> None:
        with self._update_lock:
            prior = self._pending_updates.get(alloc.id)
            if (prior is not None and alloc.deployment_status is None
                    and prior.deployment_status is not None):
                # don't let a task-state update clobber an unflushed
                # deployment-health report
                alloc.deployment_status = prior.deployment_status
            self._pending_updates[alloc.id] = alloc

    def _run_update_batcher(self) -> None:
        while not self._shutdown.is_set():
            if self._shutdown.wait(self.config.update_batch_interval):
                break
            self._flush_updates()

    def _flush_updates(self) -> None:
        with self._update_lock:
            updates, self._pending_updates = self._pending_updates, {}
        if not updates:
            return
        try:
            self.rpc.update_allocs(list(updates.values()))
        except Exception as e:                  # noqa: BLE001
            LOG.warning("client %s: alloc update failed: %s", self.node_id[:8], e)
            with self._update_lock:
                for a in updates.values():
                    self._pending_updates.setdefault(a.id, a)

    # --- restore (client.go:1109 restoreState) --------------------------

    def _restore_state(self) -> None:
        for alloc in self.state_db.get_allocations():
            if alloc.server_terminal_status():
                continue
            runner = AllocRunner(
                alloc=alloc,
                drivers=self.drivers,
                data_dir=self.config.data_dir,
                on_alloc_update=self._queue_update,
                state_db=self.state_db,
                csi_manager=self.csi_manager,
                service_reg=self.service_reg,
                secrets=self.secrets,
                prev_lookup=self._prev_runner,
                device_plugins=self.device_plugins,
                network_manager=self.network_manager,
            )
            with self._alloc_lock:
                self.allocs[alloc.id] = runner
                self._alloc_indexes[alloc.id] = alloc.modify_index
            runner.restore()

    # --- introspection --------------------------------------------------

    def num_allocs(self) -> int:
        with self._alloc_lock:
            return len(self.allocs)

    def alloc_runner(self, alloc_id: str) -> Optional[AllocRunner]:
        with self._alloc_lock:
            return self.allocs.get(alloc_id)

    def stats(self) -> Dict:
        with self._alloc_lock:
            return {
                "node_id": self.node_id,
                "allocs": len(self.allocs),
                "running": sum(
                    1 for ar in self.allocs.values() if not ar.is_done()
                ),
            }
