"""Every scenario of ``tests/test_ha_agents.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

HA server agents: raft over TCP between full agents.

Modeled on reference nomad/server_test.go multi-server tests
(TestJoin-style real 3-node raft clusters) — but through the agent +
HTTP layer: three agents with static raft peers elect a leader,
replicate writes submitted to any agent, and survive leader loss.
"""

import socket
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.api.codec import encode
from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC
from _torch_client import port_bridge  # noqa: F401


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _wait(fn, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if fn():
                return True
        except Exception:                       # noqa: BLE001
            pass
        time.sleep(0.1)
    return False


@pytest.fixture()
def ha_cluster(tmp_path):
    ports = _free_ports(3)
    peers = [f"127.0.0.1:{p}" for p in ports]
    agents = [
        Agent(AgentConfig(device="cpu", name=f"srv-{i}", num_schedulers=1,
                          raft_port=ports[i], raft_peers=peers))
        for i in range(3)
    ]
    client = None
    try:
        for a in agents:
            a.start()
        assert _wait(lambda: any(a.server.is_leader() for a in agents)), \
            "no leader elected"
        # a real heartbeating client node (a bare mock node would be
        # marked down by the TTL timers), attached to a FOLLOWER so it
        # survives leader loss — its writes forward to the leader
        follower = next(a for a in agents if not a.server.is_leader())
        client = Client(InProcessRPC(follower.server),
                        ClientConfig(data_dir=str(tmp_path / "client")))
        client.start()
        assert _wait(lambda: all(
            a.server.state.snapshot().node_by_id(client.node_id)
            is not None for a in agents))
        yield agents, client
    finally:
        if client is not None:
            client.shutdown()
        for a in agents:
            try:
                a.shutdown()
            except Exception:                   # noqa: BLE001
                pass


def _leader(agents):
    return next((a for a in agents if a.server.is_leader()), None)


class TestHAAgents:
    def test_write_to_follower_replicates_everywhere(self, ha_cluster):
        agents, _client = ha_cluster
        follower = next(a for a in agents if not a.server.is_leader())
        api = APIClient(follower.http_addr)
        job = mock.job()
        job.task_groups[0].count = 4   # fits the single client node
        api.jobs.register(encode(job))         # HTTP to a follower
        assert _wait(lambda: all(
            a.server.state.snapshot().job_by_id(job.namespace, job.id)
            is not None for a in agents
        )), "job not replicated to every server"
        # scheduling happens on the leader; allocs replicate back
        assert _wait(lambda: all(
            len(a.server.state.snapshot().allocs_by_job(
                job.namespace, job.id)) == 4 for a in agents
        ), timeout=60), "allocs not replicated"

    def test_leader_loss_failover_keeps_scheduling(self, ha_cluster):
        agents, client = ha_cluster
        old_leader = _leader(agents)
        old_leader.shutdown()
        survivors = [a for a in agents if a is not old_leader]
        assert _wait(lambda: _leader(survivors) is not None, timeout=30), \
            "no new leader after failover"
        new_leader = _leader(survivors)
        api = APIClient(new_leader.http_addr)
        job = mock.job()
        job.task_groups[0].count = 4
        api.jobs.register(encode(job))
        assert _wait(lambda: len(
            new_leader.server.state.snapshot().allocs_by_job(
                job.namespace, job.id)) == 4, timeout=60), \
            "new leader stopped scheduling"
