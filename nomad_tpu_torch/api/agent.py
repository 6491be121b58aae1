"""The merged agent process: server and/or client plus the HTTP API.

Reference behavior: command/agent/agent.go — NewAgent (:122) builds
server (setupServer :731) and/or client (setupClient :906) from one
merged config, then NewHTTPServers (http.go:86) exposes /v1.

The server places on ``AgentConfig.device``: the card unless the
config names another device. The client runs the allocations placed on
its node, in the agent's process, as the reference's does.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

LOG = logging.getLogger(__name__)


class SerialEventWorker:
    """One ordered worker for gossip-event side effects.

    Membership events MUST apply in arrival order: a thread-per-event
    dispatch let a MEMBER_FAILED land after the MEMBER_ALIVE that
    refuted it (the OS scheduler decided raft membership during
    failure flaps). Events enqueue without blocking the gossip rx /
    prober threads — which is the property the thread-per-event design
    existed for (raft applies can stall up to 10s on an impaired
    quorum) — and one daemon thread drains them in FIFO order.
    """

    def __init__(self, handler: Callable[[str, Dict], None],
                 name: str = "membership-reconcile") -> None:
        self._handler = handler
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=name)
        self._thread.start()

    def submit(self, kind: str, member: Dict) -> None:
        self._q.put((kind, member))

    def shutdown(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._q.put(None)            # wake the drain loop
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None or self._stop.is_set():
                return
            kind, member = item
            try:
                self._handler(kind, member)
            except Exception:                    # noqa: BLE001
                LOG.exception("membership event handler failed (%s %s)",
                              kind, member.get("Name"))


@dataclass
class AgentConfig:
    """Merged agent configuration (command/agent/config.go:39)."""

    name: str = "agent-1"
    region: str = "global"
    datacenter: str = "dc1"
    bind_addr: str = "127.0.0.1"
    http_port: int = 0            # 0 = ephemeral (reference default 4646)
    server_enabled: bool = True
    client_enabled: bool = False
    dev_mode: bool = False
    acl_enabled: bool = False
    num_schedulers: int = 2
    node_class: str = ""
    plugin_dir: str = ""           # external driver plugins (loader)
    meta: Dict[str, str] = field(default_factory=dict)
    # client { options { "docker.volumes.enabled" = "true" } }
    client_options: Dict[str, str] = field(default_factory=dict)
    tls: Optional[object] = None   # utils.tlsutil.TLSConfig
    # HA server mode (server.go setupRaft + serf-discovered peers; here
    # a static peer set, the reference's server_join/retry_join shape):
    # raft_peers lists every server's raft address host:port, this
    # agent's included
    raft_port: int = 0             # 0 = ephemeral
    raft_peers: List[str] = field(default_factory=list)
    #: address peers dial (host:port); required when binding 0.0.0.0
    raft_advertise: str = ""
    # WAN federation auto-join (serf retry_join analog, agent.go
    # retryJoin/command server_join stanza): entries "region@http_url";
    # retried with backoff until every entry has joined. 0 attempts =
    # retry forever.
    retry_join: List[str] = field(default_factory=list)
    retry_join_interval: float = 5.0
    retry_join_max_attempts: int = 0
    # Server gossip membership (nomad/serf.go over hashicorp/serf;
    # here server/membership.py): liveness-probed `server members`,
    # member events feeding raft peer add/remove on the leader, and
    # join-by-DNS. server_join entries are "host:port" membership
    # addresses (a DNS name expands to every A record).
    serf_enabled: bool = True
    serf_port: int = 0             # 0 = ephemeral
    server_join: List[str] = field(default_factory=list)
    #: probe cadence; tests shrink these for fast convergence
    serf_probe_interval: float = 1.0
    serf_suspect_timeout: float = 3.0
    # shared gossip key (agent `encrypt` config, serf keyring analog):
    # when set, membership datagrams are HMAC-authenticated and
    # unsigned/mismatched packets are rejected
    encrypt: str = ""
    # real Vault server (agent config vault stanza; empty = dev
    # in-memory provider)
    vault_addr: str = ""
    vault_token: str = ""
    vault_token_role: str = ""
    # AOT placement-kernel warmup (ops/warmup.py): None = auto (warm
    # when a manifest exists), plus the manifest path ("" = default
    # ~/.cache location)
    kernel_warmup: Optional[bool] = None
    warmup_manifest: str = ""
    # adaptive wave-coalescer knobs (server block: coalesce_adaptive
    # + coalesce_window_min_ms / coalesce_window_max_ms)
    coalesce_adaptive: bool = True
    coalesce_window_min_ms: float = 1.0
    coalesce_window_max_ms: float = 50.0
    # crash-safe raft durability (raft/wal.py): the agent's
    # state dir (reference top-level `data_dir`); empty = in-memory
    # raft. raft_fsync_policy: "always" (per-record) or "batch"
    # (group-fsync at ack boundaries; the default)
    data_dir: str = ""
    raft_fsync_policy: str = "batch"
    # multi-process scheduler workers (server/workerproc.py):
    # N worker processes running feasibility/reconcile/plan-build over
    # MVCC snapshot frames; 0 = in-process threads (the default, and
    # bit-identical to pre-17 behavior)
    scheduler_workers: int = 0
    # pipelined AppendEntries + leader leases (raft/node.py):
    # raft_max_in_flight bounds the per-peer replication window (1 =
    # the synchronous path); raft_leader_lease gates the quorum-free
    # linearizable-read fast path; raft_lease_fraction is the lease
    # window as a fraction of election_timeout_min
    raft_max_in_flight: int = 8
    raft_leader_lease: bool = True
    raft_lease_fraction: float = 0.75
    # where the server places: None is the card ("cuda"), and raises on
    # a machine without one; "cpu" runs the kernels' plain versions
    device: Optional[str] = None
    # evals a scheduler worker dequeues at once; above 1 they are placed
    # together, as coalesced waves (1 places each eval on its own)
    worker_batch_size: int = 1

    @classmethod
    def dev(cls, **overrides) -> "AgentConfig":
        """-dev preset: server + client in one process."""
        return cls(server_enabled=True, client_enabled=True, dev_mode=True,
                   **overrides)


class Agent:
    def __init__(self, config: Optional[AgentConfig] = None) -> None:
        self.config = config or AgentConfig()
        self.server = None
        self.client = None
        self.http = None
        self.acl_resolver = None

        if self.config.server_enabled:
            self._setup_server()
        if self.config.client_enabled:
            self._setup_client()

        from nomad_tpu_torch.api.http import HTTPAgent

        self.http = HTTPAgent(
            self, bind=self.config.bind_addr, port=self.config.http_port,
            tls_config=self.config.tls,
        )
        tls = self.config.tls
        if self.server is not None and tls is not None and tls.enabled:
            # server-originated HTTP (ACL replication) must speak the
            # cluster's TLS
            self.server.tls_api = {
                "ca_cert": tls.ca_file,
                "client_cert": tls.cert_file,
                "client_key": tls.key_file,
            }

    def _setup_server(self) -> None:
        from nomad_tpu_torch.server.server import Server, ServerConfig

        cfg = ServerConfig(
            num_workers=self.config.num_schedulers,
            region=self.config.region,
            datacenter=self.config.datacenter,
            name=self.config.name,
            vault_addr=self.config.vault_addr,
            vault_token=self.config.vault_token,
            vault_token_role=self.config.vault_token_role,
            kernel_warmup=self.config.kernel_warmup,
            warmup_manifest_path=self.config.warmup_manifest,
            coalesce_adaptive=self.config.coalesce_adaptive,
            coalesce_window_min_ms=self.config.coalesce_window_min_ms,
            coalesce_window_max_ms=self.config.coalesce_window_max_ms,
            data_dir=self.config.data_dir,
            raft_fsync_policy=self.config.raft_fsync_policy,
            scheduler_workers=self.config.scheduler_workers,
            raft_max_in_flight=self.config.raft_max_in_flight,
            raft_leader_lease=self.config.raft_leader_lease,
            raft_lease_fraction=self.config.raft_lease_fraction,
            device=self.config.device,
            worker_batch_size=self.config.worker_batch_size,
        )
        self.server = Server(cfg)
        self.raft_transport = None
        if self.config.raft_peers:
            # HA: raft over TCP between server agents (server.go:1228
            # setupRaft over the RaftLayer; peers here are static the
            # way retry_join server addresses are)
            from nomad_tpu_torch.raft.node import RaftConfig
            from nomad_tpu_torch.raft.transport import TcpTransport

            self.raft_transport = TcpTransport(
                self.config.bind_addr, self.config.raft_port)
            # the raft identity must be the address PEERS can dial;
            # a wildcard bind needs an explicit advertise address or
            # it would join as an undialable phantom member
            self_addr = self.config.raft_advertise or self.raft_transport.addr
            if self_addr.split(":")[0] in ("0.0.0.0", "::"):
                raise ValueError(
                    "raft over a wildcard bind needs raft_advertise "
                    "set to the address peers dial")
            peers = list(self.config.raft_peers)
            if self_addr not in peers:
                peers.append(self_addr)
            self.server.setup_raft(
                node_id=self_addr,
                peers=peers,
                transport=self.raft_transport,
                # python control plane: generous timeouts so GIL-holding
                # compiles don't churn elections (server/testing.py)
                raft_config=RaftConfig(
                    heartbeat_interval=0.05,
                    election_timeout_min=0.30,
                    election_timeout_max=0.60,
                ),
            )
        if self.config.acl_enabled:
            from nomad_tpu_torch.acl.resolver import TokenResolver

            self.acl_resolver = TokenResolver(self.server)
        # default namespace always exists (reference creates it on boot)
        from nomad_tpu_torch.structs.namespace import Namespace

        self.server.state.upsert_namespace(
            Namespace(name="default", description="Default shared namespace")
        )

    def _setup_client(self) -> None:
        from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC

        if self.server is None:
            raise ValueError(
                "client-only agents need a server address (in-process "
                "agent requires server_enabled)"
            )
        cfg = ClientConfig(
            node_class=self.config.node_class,
            plugin_dir=self.config.plugin_dir,
            options=self.config.client_options,
        )
        self.client = Client(InProcessRPC(self.server), cfg)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self.server is not None:
            self.server.start()
            if self.server.raft is None:
                # standalone server is immediately the authority
                self.server.establish_leadership()
            if self.config.retry_join:
                self._start_retry_join()
            if self.config.serf_enabled:
                self._start_membership()
        if self.client is not None:
            # advertise this agent's HTTP address on the node so
            # servers can pass /v1/client/* requests through
            # (client.go HTTPAddr -> Node.HTTPAddr)
            self.client.node.http_addr = self.http.addr
            self.client.start()
        self.http.start()

    def _start_retry_join(self) -> None:
        """Background WAN auto-join (serf retry_join / agent.go
        retryJoin): keep attempting each configured region join with
        backoff until it lands; an unreachable peer at boot must not
        fail the agent, and a later-started peer is joined as soon as
        it answers. The join is recorded through raft (join_region),
        so a success survives failover."""
        import threading

        def run() -> None:
            import time as _time

            pending = {}
            for entry in self.config.retry_join:
                region, _, addr = str(entry).partition("@")
                if not region or not addr:
                    LOG.warning("retry_join: malformed entry %r "
                                "(want region@http_url)", entry)
                    continue
                if region == self.config.region:
                    continue
                pending[region] = addr
            attempt = 0
            delay = self.config.retry_join_interval
            while pending and not self.server._shutdown.is_set():
                attempt += 1
                for region, addr in list(pending.items()):
                    try:
                        # verify the peer answers before recording it
                        from nomad_tpu_torch.api.client import APIClient

                        tls = getattr(self.server, "tls_api", None) or {}
                        APIClient(addr, **tls).get("/v1/agent/self")
                        self.server.join_region(region, addr)
                        del pending[region]
                        LOG.info("retry_join: joined region %s at %s",
                                 region, addr)
                    except Exception as e:      # noqa: BLE001
                        LOG.debug("retry_join %s (%s): %s",
                                  region, addr, e)
                maxa = self.config.retry_join_max_attempts
                if pending and maxa and attempt >= maxa:
                    LOG.warning("retry_join: giving up on %s after %d "
                                "attempts", sorted(pending), attempt)
                    return
                if pending:
                    self.server._shutdown.wait(delay)
                    delay = min(delay * 1.5, 60.0)

        threading.Thread(target=run, daemon=True,
                         name="retry-join").start()

    def _start_membership(self) -> None:
        """Server gossip membership (serf.go:1). Events drive the raft
        voter set on the leader — the reference's nomadJoin adds the
        peer, nomadFailed/reap removes it (leader.go:1182-1345) — so a
        dead server leaves the peer set without operator action and a
        booted one joins without a config edit."""
        from nomad_tpu_torch.server.membership import (
            MEMBER_ALIVE, MEMBER_FAILED, MEMBER_JOIN, MEMBER_LEAVE,
            Membership, expand_join_addrs,
        )

        tags = {
            "region": self.config.region,
            "dc": self.config.datacenter,
            "http_addr": self.http.addr if self.http else "",
        }
        raft = self.server.raft
        if raft is not None:
            tags["raft_addr"] = raft.id
        self._serf = Membership(
            name=self.config.name,
            bind=self.config.bind_addr,
            port=self.config.serf_port,
            tags=tags,
            region=self.config.region,
            probe_interval=self.config.serf_probe_interval,
            suspect_timeout=self.config.serf_suspect_timeout,
            encrypt=self.config.encrypt,
        )

        def reconcile(kind: str, member: dict) -> None:
            raft = self.server.raft if self.server is not None else None
            if raft is None or not raft.is_leader():
                return
            peer = (member.get("Tags") or {}).get("raft_addr", "")
            if not peer or peer == raft.id:
                return
            try:
                if kind in (MEMBER_JOIN, MEMBER_ALIVE):
                    if peer not in raft.peers:
                        raft.add_peer(peer)
                        LOG.info("membership: added raft peer %s (%s)",
                                 peer, member.get("Name"))
                elif kind in (MEMBER_FAILED, MEMBER_LEAVE):
                    if peer not in raft.peers:
                        return
                    # quorum guard (autopilot pruneDeadServers): never
                    # remove below a functioning majority. Judged from
                    # the MEMBERSHIP view — the failure detector that
                    # just fired — not raft last-contact, whose 10s
                    # horizon lags the 3-4s gossip verdict and would
                    # wave through a quorum-breaking removal.
                    dead_addrs = {
                        (m.get("Tags") or {}).get("raft_addr", "")
                        for m in self._serf.members()
                        if m["Status"] in ("failed", "left")
                    }
                    n_total = len(raft.peers) + 1
                    n_dead = sum(1 for p in raft.peers
                                 if p in dead_addrs)
                    if kind == MEMBER_FAILED \
                            and n_total - n_dead <= n_total // 2:
                        LOG.warning("membership: not removing %s: would "
                                    "break quorum", peer)
                        return
                    raft.remove_peer(peer)
                    LOG.info("membership: removed raft peer %s (%s, %s)",
                             peer, member.get("Name"), kind)
            except Exception as e:               # noqa: BLE001
                LOG.warning("membership raft reconcile (%s %s): %s",
                            kind, member.get("Name"), e)

        # ONE ordered worker: raft applies may block up to 10s on an
        # impaired quorum — exactly when failure events fire — so the
        # gossip rx/prober threads never run reconciles inline; but a
        # thread PER event let MEMBER_FAILED/MEMBER_ALIVE flap pairs
        # race each other, and the loser decided the raft voter set
        self._reconcile_worker = SerialEventWorker(reconcile)
        self._serf.on_event(self._reconcile_worker.submit)
        self._serf.start()
        if self.config.server_join:
            targets = expand_join_addrs(self.config.server_join)
            joined = self._serf.join(targets)
            if not joined and targets:
                # seeds not up yet: keep trying in the background the
                # way serf's retry_join does
                def retry() -> None:
                    while not self.server._shutdown.is_set():
                        if self._serf.join(expand_join_addrs(
                                self.config.server_join)):
                            return
                        self.server._shutdown.wait(2.0)

                threading.Thread(target=retry, daemon=True,
                                 name="membership-join").start()

    def shutdown(self) -> None:
        serf = getattr(self, "_serf", None)
        if serf is not None:
            serf.shutdown(leave=True)
        worker = getattr(self, "_reconcile_worker", None)
        if worker is not None:
            worker.shutdown()
        if self.client is not None:
            self.client.shutdown()
        if self.server is not None:
            self.server.shutdown()
        # raft transport is closed by RaftNode.shutdown (one owner)
        if self.http is not None:
            self.http.shutdown()

    @property
    def http_addr(self) -> str:
        return self.http.addr

    def members(self) -> List[Dict]:
        """serf.go Members: this server plus (in HA mode) its raft
        peers — the static-peer analog of gossip membership. The Addr
        column is the raft (server-to-server) address throughout; the
        HTTP address rides in Tags like the reference's rpc_addr."""
        import time as _time

        serf = getattr(self, "_serf", None)
        if serf is not None:
            rows = serf.members()
            raft = self.server.raft if self.server is not None else None
            leader = raft.leader_addr() if raft is not None else None
            for r in rows:
                tags = r.get("Tags") or {}
                if raft is not None:
                    r["Leader"] = bool(leader) and \
                        tags.get("raft_addr", "") == leader
                else:
                    r["Leader"] = (r["Name"] == self.config.name
                                   and self.server is not None
                                   and self.server.is_leader())
            return rows
        tags = {"region": self.config.region,
                "dc": self.config.datacenter,
                "http_addr": self.http.addr if self.http else ""}
        raft = self.server.raft if self.server is not None else None
        if raft is None:
            return [{
                "Name": self.config.name, "Status": "alive",
                "Addr": self.http.addr if self.http else "",
                "Leader": bool(self.server is not None
                               and self.server.is_leader()),
                "Tags": tags,
            }]
        leader = raft.leader_addr()
        out = [{
            "Name": self.config.name, "Status": "alive",
            "Addr": raft.id,
            "Leader": raft.id == leader,
            "Tags": tags,
        }]
        now = _time.monotonic()
        for peer in raft.peers:
            # a peer is failed when it hasn't answered in several
            # election timeouts (only the leader appends entries, so a
            # follower's view of its peers may simply be unobserved)
            seen = raft.peer_last_contact.get(peer)
            if raft.is_leader():
                status = "alive" if seen is not None \
                    and now - seen < 3.0 else "failed"
            else:
                status = "alive" if peer == leader or (
                    seen is not None and now - seen < 3.0) else "unknown"
            out.append({
                "Name": peer, "Status": status,
                "Addr": peer,
                "Leader": peer == leader,
                "Tags": dict(tags, http_addr=""),
            })
        return out
