"""In-process multi-server cluster harness.

Reference behavior: nomad/testing.go:41 TestServer -- multi-server Go
tests form real raft clusters in one process over an in-memory
transport (raft.InmemTransport; server.go raftInmem). Same here:
``make_cluster(3)`` returns three Servers replicating through
``InmemTransport`` with fast election timers.
"""

from __future__ import annotations

import copy
import time
from typing import List, Optional, Tuple

from nomad_tpu_torch.raft.node import RaftConfig
from nomad_tpu_torch.raft.transport import InmemTransport, TransportRegistry
from nomad_tpu_torch.server.server import Server, ServerConfig


#: the make_cluster raft timers, shared with restart_server so a
#: restarted node rejoins with the cadence its peers elect at.
#: Sized for a Python control plane: first-time XLA tracing in a
#: worker thread can hold the GIL for hundreds of ms; sub-100ms
#: election timeouts would churn leadership during every cold compile
CLUSTER_RAFT_CONFIG = RaftConfig(
    heartbeat_interval=0.05,
    election_timeout_min=0.30,
    election_timeout_max=0.60,
)


def make_cluster(
    n: int,
    server_config: Optional[ServerConfig] = None,
    registry: Optional[TransportRegistry] = None,
    data_dirs: Optional[List[str]] = None,
) -> Tuple[List[Server], TransportRegistry]:
    """``data_dirs`` (one per server) turns on the crash-safe raft
    durability plane: each server persists term/vote, WAL,
    and snapshots under its dir and can be ``hard_kill``-ed +
    ``restart_server``-ed from it."""
    registry = registry or TransportRegistry()
    addrs = [f"server-{i}" for i in range(n)]
    servers: List[Server] = []
    for i, addr in enumerate(addrs):
        cfg = (
            copy.deepcopy(server_config)
            if server_config is not None
            else ServerConfig(num_workers=1, heartbeat_ttl=60.0)
        )
        cfg.name = addr
        if data_dirs is not None:
            cfg.data_dir = data_dirs[i]
        s = Server(cfg)
        transport = InmemTransport(addr, registry)
        s.setup_raft(
            node_id=addr,
            peers=addrs,
            transport=transport,
            raft_config=CLUSTER_RAFT_CONFIG,
        )
        servers.append(s)
    for s in servers:
        s.start()
    return servers, registry


def hard_kill(server: Server) -> None:
    """Kill a server (the restart cell's crash stand-in): the
    in-memory transport goes dark (late RPCs to/from it fail like a
    dead process's would) and in-memory raft/store/broker state is
    discarded wholesale — only a configured ``data_dir`` survives.
    Honest limits: this is shutdown(), not SIGKILL — threads join, so
    in-flight applies may complete before death and the WAL closes at
    a record boundary. The durability plane itself flushes nothing
    here (fsync happens at ack time or never), and genuinely torn
    mid-write crash states are produced by the ``wal.frame.torn`` /
    ``wal.sync`` / ``wal.snapshot.write`` fault points instead
    (docs/ROBUSTNESS.md), which the restart cell's torn leg drives."""
    from nomad_tpu_torch.raft.observe import raft_observer

    if server.raft is not None:
        # the timeline's loss marker: a killed LEADER opens a failover
        # window (telemetry/timeline.py); a killed follower is an
        # event but not a loss
        raft_observer.note_event(
            server.raft.id, "killed", term=server.raft.current_term,
            detail={"was_leader": server.raft.is_leader()})
    server.shutdown()


def restart_server(dead: Server, registry: TransportRegistry,
                   raft_config: Optional[RaftConfig] = None) -> Server:
    """Boot a FRESH Server from a killed one's config + data_dir into
    the live cluster: new transport at the same address (the registry
    routes peers to it), recovery from disk in the RaftNode
    constructor (stable store -> snapshot -> WAL replay), then the
    normal start() path. The dead object is not reused."""
    cfg = copy.deepcopy(dead.config)
    addr = dead.raft.id
    peers = [addr, *dead.raft.peers]
    s = Server(cfg)
    transport = InmemTransport(addr, registry)
    s.setup_raft(
        node_id=addr,
        peers=peers,
        transport=transport,
        raft_config=raft_config or CLUSTER_RAFT_CONFIG,
    )
    s.start()
    return s


def wait_for_leader(servers: List[Server], timeout: float = 5.0) -> Server:
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [s for s in servers if s.raft is not None and s.raft.is_leader()]
        if len(leaders) == 1 and leaders[0].is_leader():
            return leaders[0]
        time.sleep(0.01)
    raise TimeoutError("no leader elected")


def wait_until(fn, timeout: float = 5.0, msg: str = "condition") -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.01)
    raise AssertionError(f"timeout waiting for {msg}")
