"""Consensus + replication (reference: hashicorp/raft via nomad/fsm.go,
nomad/raft_rpc.go, server.go:1228 setupRaft).

The reference replicates every authoritative state mutation through a
Raft log applied to the FSM on each server. This package provides the
same contract: ``RaftNode.apply(msg_type, req)`` returns once the entry
is committed and applied locally; leadership changes drive the server's
establish/revoke hooks (leader.go:54 monitorLeadership analog).

Transports are pluggable: ``InmemTransport`` wires nodes in one process
(the reference's raft.InmemTransport used by every multi-server Go
test); ``TcpTransport`` carries the same RPCs between processes.
"""

from nomad_tpu_torch.raft.log import LogEntry, LogStore
from nomad_tpu_torch.raft.node import RaftNode, RaftConfig, NotLeaderError
from nomad_tpu_torch.raft.transport import InmemTransport, TransportRegistry

__all__ = [
    "InmemTransport",
    "LogEntry",
    "LogStore",
    "NotLeaderError",
    "RaftConfig",
    "RaftNode",
    "TransportRegistry",
]
