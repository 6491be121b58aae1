"""The port's agent and HTTP API, on the CPU.

Every scenario of ``tests/test_api.py`` (the SDK against a live agent:
jobs, nodes, operator, search, namespaces, the event stream, allocs),
``tests/test_operator.py`` (one-time tokens, the periodic launch ledger,
autopilot), ``tests/test_tls.py`` (HTTPS, mTLS, region forwarding over
TLS, the ``tls`` CLI), ``tests/test_monitor.py`` (log streaming, pprof)
and ``tests/test_federation.py`` (regions, forwarding, ACL replication,
retry join; every agent a server) and ``tests/test_event_stream_acl.py``
(ACL-scoped event streams, on a ``-dev`` agent) runs on the port's
modules, each agent built with ``AgentConfig(device="cpu", ...)`` and each server with
``ServerConfig(device="cpu", ...)``. Then what the port adds: an
operator snapshot restored over HTTP under a running server replaces
the planes its waves place on (the placements equal those of an agent
that restored the same archive before it placed anything, and the
resident planes equal a fresh upload); an agent with no device needs a
card; an agent with a client (``-dev``, or server and client) runs a
raw_exec job to ``complete`` and serves its log, while a client-only
agent raises the reference's ``ValueError``; a client's default data
dir, its relays' state and its bridge probe's names are the process's
own; and with its workers' batch size above 1 the agent places through
coalesced waves.
"""

import json
import logging
import os
import random
import socket
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.acl.policy import ACLPolicy, ACLToken
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient, APIError, QueryOptions
from nomad_tpu_torch.api.codec import decode, encode, wire_name
from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.server.testing import make_cluster, wait_for_leader
from nomad_tpu_torch.server.testing import wait_until as cluster_wait
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.job import Job
from nomad_tpu_torch.structs.namespace import Namespace
from nomad_tpu_torch.utils.monitor import (
    LogMonitor,
    heap_summary,
    sample_profile,
    thread_dump,
)
from nomad_tpu_torch.utils.tlsutil import (
    TLSConfig,
    generate_ca,
    generate_cert,
)
from _torch_client import port_bridge  # noqa: F401
from _torch_client import processes_with

ROOT = Path(__file__).resolve().parents[1]


def cpu_config():
    """``make_cluster``'s default server config, placing on the CPU."""
    return ServerConfig(num_workers=1, heartbeat_ttl=60.0, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_api.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def agent():
    a = Agent(AgentConfig(device="cpu", name="test-agent", num_schedulers=1))
    a.start()
    # register some nodes straight into state (no client data plane here)
    for _ in range(4):
        a.server.node_register(mock.node())
    yield a
    a.shutdown()


@pytest.fixture(scope="module")
def api(agent):
    return APIClient(agent.http_addr)


def wait_until(fn, timeout=10.0, every=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(every)
    return False


class TestCodec:
    def test_wire_name(self):
        assert wire_name("job_id") == "JobID"
        assert wire_name("cpu_shares") == "CPUShares"
        assert wire_name("memory_mb") == "MemoryMB"
        assert wire_name("task_groups") == "TaskGroups"

    def test_roundtrip_job(self):
        job = mock.simple_job()
        wire = encode(job)
        assert wire["ID"] == job.id
        assert wire["TaskGroups"][0]["Tasks"][0]["Resources"]["CPU"] == 500
        back = decode(wire, Job)
        assert back.id == job.id
        assert back.task_groups[0].tasks[0].resources.cpu == 500
        assert back.task_groups[0].count == job.task_groups[0].count

    def test_decode_ignores_unknown_keys(self):
        job = decode({"ID": "x", "Bogus": 1}, Job)
        assert job.id == "x"


class TestJobsAPI:
    def test_register_and_run(self, agent, api):
        job = encode(mock.simple_job())
        res = api.jobs.register(job)
        assert res["EvalID"]
        # scheduler places all 10 allocs
        assert wait_until(
            lambda: len(api.jobs.allocations(job["ID"])) == 10
        ), "allocations never appeared"
        info = api.jobs.info(job["ID"])
        assert info["ID"] == job["ID"]
        listed = api.jobs.list()
        assert any(j["ID"] == job["ID"] for j in listed)
        summ = api.jobs.summary(job["ID"])
        assert sum(v for v in summ["Summary"]["web"].values()) == 10
        evals = api.jobs.evaluations(job["ID"])
        assert evals and evals[0]["JobID"] == job["ID"]

    def test_job_plan_dry_run(self, agent, api):
        job = encode(mock.simple_job())
        res = api.jobs.plan(job, diff=True)
        assert res["Diff"]["Type"] == "Added"
        # dry run must not register the job
        with pytest.raises(APIError) as e:
            api.jobs.info(job["ID"])
        assert e.value.status == 404

    def test_deregister(self, agent, api):
        job = encode(mock.simple_job())
        api.jobs.register(job)
        api.jobs.deregister(job["ID"], purge=True)
        with pytest.raises(APIError):
            api.jobs.info(job["ID"])

    def test_blocking_query_unblocks_on_register(self, agent, api):
        start_jobs = api.jobs.list()
        index = agent.server.state.latest_index()
        got = {}

        def blocked():
            got["jobs"] = api.jobs.list(QueryOptions(wait_index=index,
                                                     wait_time_s=5.0))

        t = threading.Thread(target=blocked)
        t.start()
        time.sleep(0.1)
        job = encode(mock.simple_job())
        api.jobs.register(job)
        t.join(timeout=10)
        assert not t.is_alive()
        assert len(got["jobs"]) >= len(start_jobs)

    def test_versions_and_revert(self, agent, api):
        job = mock.simple_job()
        wire = encode(job)
        api.jobs.register(wire)
        wire2 = encode(job)
        wire2["TaskGroups"][0]["Count"] = 3
        api.jobs.register(wire2)
        versions = api.jobs.versions(job.id)["Versions"]
        assert len(versions) >= 2
        api.jobs.revert(job.id, 0)
        info = api.jobs.info(job.id)
        assert info["Version"] >= 2  # revert re-registers as a new version

    def test_scale(self, agent, api):
        job = mock.simple_job()
        api.jobs.register(encode(job))
        api.jobs.scale(job.id, "web", 5, message="scale test")
        status = api.jobs.scale_status(job.id)
        assert status["TaskGroups"]["web"]["Desired"] == 5
        assert status["TaskGroups"]["web"]["Events"]

    def test_dispatch_parameterized(self, agent, api):
        from nomad_tpu_torch.structs.job import ParameterizedJobConfig

        job = mock.simple_job()
        job.parameterized = ParameterizedJobConfig(meta_required=["input"])
        api.jobs.register(encode(job))
        res = api.jobs.dispatch(job.id, meta={"input": "x"})
        assert res["DispatchedJobID"].startswith(f"{job.id}/dispatch-")
        # dispatched IDs contain '/': the SDK must escape them in paths
        child = res["DispatchedJobID"]
        assert api.jobs.info(child)["ID"] == child
        api.jobs.deregister(child, purge=True)
        with pytest.raises(APIError):
            api.jobs.info(child)
        with pytest.raises(APIError):
            api.jobs.dispatch(job.id, meta={})  # missing required meta


class TestNodesAPI:
    def test_list_and_info(self, agent, api):
        nodes = api.nodes.list()
        assert len(nodes) >= 4
        info = api.nodes.info(nodes[0]["ID"])
        assert info["ID"] == nodes[0]["ID"]

    def test_drain_and_eligibility(self, agent, api):
        node = api.nodes.list()[0]
        api.nodes.drain(node["ID"], enable=True, deadline_s=1.0)
        info = api.nodes.info(node["ID"])
        assert info["DrainStrategy"] or info["SchedulingEligibility"] == "ineligible"
        api.nodes.drain(node["ID"], enable=False)
        api.nodes.eligibility(node["ID"], eligible=True)
        info = api.nodes.info(node["ID"])
        assert info["SchedulingEligibility"] == "eligible"


class TestOperatorAPI:
    def test_scheduler_config_roundtrip(self, agent, api):
        cfg = api.operator.scheduler_config()["SchedulerConfig"]
        assert cfg["SchedulerAlgorithm"] == "binpack"
        cfg["SchedulerAlgorithm"] = "spread"
        api.operator.set_scheduler_config(cfg)
        cfg2 = api.operator.scheduler_config()["SchedulerConfig"]
        assert cfg2["SchedulerAlgorithm"] == "spread"
        cfg2["SchedulerAlgorithm"] = "binpack"
        api.operator.set_scheduler_config(cfg2)

    def test_snapshot_save_restore(self, agent, api):
        job = mock.simple_job()
        api.jobs.register(encode(job))
        snap = api.operator.snapshot_save()
        assert len(snap) > 100
        api.jobs.deregister(job.id, purge=True)
        with pytest.raises(APIError):
            api.jobs.info(job.id)
        api.operator.snapshot_restore(snap)
        assert api.jobs.info(job.id)["ID"] == job.id


class TestSearchAPI:
    def test_prefix_search(self, agent, api):
        job = mock.simple_job()
        api.jobs.register(encode(job))
        res = api.search.prefix(job.id[:5], "jobs")
        assert job.id in res["Matches"]["jobs"]

    def test_fuzzy_search(self, agent, api):
        nodes = api.nodes.list()
        name = nodes[0]["Name"]
        res = api.search.fuzzy(name[:4], "nodes")
        assert any(name in m["ID"] for m in res["Matches"]["nodes"])


class TestNamespacesAPI:
    def test_crud(self, agent, api):
        api.namespaces.register("apps", "application namespace")
        names = {n["Name"] for n in api.namespaces.list()}
        assert {"default", "apps"} <= names
        info = api.namespaces.info("apps")
        assert info["Description"] == "application namespace"
        api.namespaces.delete("apps")
        names = {n["Name"] for n in api.namespaces.list()}
        assert "apps" not in names


class TestAgentAPI:
    def test_self_and_health(self, agent, api):
        self_info = api.agent.self()
        assert self_info["Config"]["Name"] == "test-agent"
        assert self_info["Config"]["Server"] is True
        health = api.agent.health()
        assert health["server"]["ok"]

    def test_members(self, agent, api):
        members = api.agent.members()
        assert members["Members"][0]["Name"] == "test-agent"

    def test_metrics(self, agent, api):
        from nomad_tpu_torch.utils.metrics import global_registry

        global_registry.incr_counter("nomad.test.counter", 2)
        res = api.agent.metrics()
        assert any(c["Name"] == "nomad.test.counter" for c in res["Counters"])


class TestEventStream:
    def test_stream_delivers_job_events(self, agent, api):
        got = []

        def consume():
            try:
                for batch in api.events.stream(topics={"Job": ["*"]},
                                               timeout=10.0):
                    got.extend(batch.get("Events", []))
                    if got:
                        return
            except Exception:
                pass

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.2)
        api.jobs.register(encode(mock.simple_job()))
        t.join(timeout=10)
        assert got, "no events received"
        assert got[0]["Topic"] == "Job"


class TestAllocAPI:
    def test_alloc_lifecycle(self, agent, api):
        # earlier module-scoped tests leave jobs (some blocked on capacity)
        # behind; purge them and add fresh nodes so this job always places
        for j in api.jobs.list():
            api.jobs.deregister(j["ID"], purge=True)
        for _ in range(2):
            agent.server.node_register(mock.node())
        job = encode(mock.simple_job())
        api.jobs.register(job)
        assert wait_until(lambda: api.jobs.allocations(job["ID"]))
        allocs = api.jobs.allocations(job["ID"])
        info = api.allocations.info(allocs[0]["ID"])
        assert info["JobID"] == job["ID"]
        res = api.allocations.stop(allocs[0]["ID"])
        assert res["EvalID"]
        listed = api.allocations.list()
        assert any(a["ID"] == allocs[0]["ID"] for a in listed)


# ---------------------------------------------------------------------------
# tests/test_operator.py
# ---------------------------------------------------------------------------

class TestOneTimeTokens:
    def _server_with_token(self):
        from nomad_tpu_torch.acl.policy import ACLToken

        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        token = ACLToken.create(name="ops", type="management")
        server.raft_apply("ACLTokenUpsertRequestType", {"tokens": [token]})
        return server, token

    def test_create_and_exchange(self):
        server, token = self._server_with_token()
        try:
            ott = server.create_one_time_token(token.accessor_id)
            assert ott["expires_at"] > time.time()
            got = server.exchange_one_time_token(ott["one_time_secret_id"])
            assert got.accessor_id == token.accessor_id
            # single use
            with pytest.raises(ValueError):
                server.exchange_one_time_token(ott["one_time_secret_id"])
        finally:
            server.shutdown()

    def test_expired_rejected_and_gcd(self):
        server, token = self._server_with_token()
        try:
            ott = server.create_one_time_token(token.accessor_id, ttl_s=-1)
            with pytest.raises(ValueError):
                server.exchange_one_time_token(ott["one_time_secret_id"])
            assert server.expire_one_time_tokens() == 1
            assert server.state.one_time_token_by_secret(
                ott["one_time_secret_id"]) is None
        finally:
            server.shutdown()

    def test_over_http(self):
        from nomad_tpu_torch.api.agent import Agent, AgentConfig
        from nomad_tpu_torch.api.client import APIClient, APIError
        from nomad_tpu_torch.acl.policy import ACLToken

        agent = Agent(AgentConfig(device="cpu", num_schedulers=0))
        agent.start()
        try:
            token = ACLToken.create(name="ops", type="management")
            agent.server.raft_apply("ACLTokenUpsertRequestType",
                                    {"tokens": [token]})
            api = APIClient(agent.http.addr, token=token.secret_id)
            resp = api.acl.create_one_time_token()
            secret = resp["OneTimeToken"]["OneTimeSecretID"]
            anon = APIClient(agent.http.addr)
            got = anon.acl.exchange_one_time_token(secret)
            assert got["Token"]["AccessorID"] == token.accessor_id
            with pytest.raises(APIError):
                anon.acl.exchange_one_time_token(secret)
        finally:
            agent.shutdown()


class TestPeriodicLedger:
    def test_dispatch_records_launch(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            job = mock.job()
            job.periodic = structs.PeriodicConfig(enabled=True,
                                                  spec="@every 3600s")
            server.job_register(job)
            child = server.periodic_dispatcher.force_run(job)
            assert child
            assert server.state.periodic_launch_by_id(
                "default", job.id) > 0
        finally:
            server.shutdown()

    def test_restore_catches_up_missed_launch(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            job = mock.job()
            job.periodic = structs.PeriodicConfig(enabled=True,
                                                  spec="@every 0.5s")
            server.job_register(job)
            # ledger says the last launch was long ago -> the next
            # scheduled launch has been missed
            server.state.upsert_periodic_launch(
                "default", job.id, time.time() - 3600
            )
            before = len([
                j for j in server.state.snapshot().jobs()
                if getattr(j, "parent_id", "") == job.id
            ])
            server.periodic_dispatcher.restore(server.state.snapshot())
            after = len([
                j for j in server.state.snapshot().jobs()
                if getattr(j, "parent_id", "") == job.id
            ])
            assert after == before + 1
        finally:
            server.shutdown()


class TestAutopilot:
    def test_health_view(self):
        servers, registry = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers)
            cluster_wait(
                lambda: all(
                    h["last_contact_s"] < 5.0
                    for h in leader.raft.server_health()
                ),
                msg="peers contacted",
            )
            h = leader.autopilot.health()
            assert h["Healthy"] is True
            assert len(h["Servers"]) == 3
            assert sum(1 for s in h["Servers"] if s["Leader"]) == 1
        finally:
            for s in servers:
                s.shutdown()

    def test_dead_server_cleanup(self):
        servers, registry = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers)
            # tighten thresholds so the test is fast
            leader.state.set_autopilot_config({
                "cleanup_dead_servers": True,
                "last_contact_threshold_s": 0.5,
                "server_stabilization_time_s": 0.2,
            })
            dead = next(s for s in servers if s is not leader)
            dead_id = dead.raft.id
            dead.shutdown()
            registry.partition(leader.raft.id, dead_id)
            cluster_wait(
                lambda: leader.autopilot.evaluate_once() or
                dead_id not in leader.raft.peers,
                timeout=10.0, msg="dead server removed",
            )
            assert dead_id not in leader.raft.peers
            # the removal is a replicated config change: the surviving
            # follower drops the peer too, so a failover cannot
            # resurrect it
            follower = next(s for s in servers
                            if s is not leader and s.raft.id != dead_id)
            cluster_wait(lambda: dead_id not in follower.raft.peers,
                       msg="follower applied removal")
            # cluster still works with the remaining pair
            job = mock.job()
            leader.job_register(job)
            assert leader.state.snapshot().job_by_id(
                "default", job.id) is not None
        finally:
            for s in servers:
                try:
                    s.shutdown()
                except Exception:
                    pass

    def test_quorum_guard(self):
        servers, registry = make_cluster(3, cpu_config())
        try:
            leader = wait_for_leader(servers)
            leader.state.set_autopilot_config({
                "cleanup_dead_servers": True,
                "last_contact_threshold_s": 0.3,
                "server_stabilization_time_s": 0.1,
            })
            others = [s for s in servers if s is not leader]
            for s in others:
                registry.partition(leader.raft.id, s.raft.id)
            time.sleep(0.6)
            # both peers dead: removing either would leave the leader
            # alone -> quorum guard refuses
            removed = leader.autopilot.evaluate_once()
            assert removed == []
            assert len(leader.raft.peers) == 2
        finally:
            registry.heal()
            for s in servers:
                s.shutdown()


# ---------------------------------------------------------------------------
# tests/test_tls.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def material(tmp_path_factory):
    # the TLS material helpers are a thin wrapper over `cryptography`,
    # an optional dependency: without it these tests read as skips
    pytest.importorskip("cryptography")
    d = tmp_path_factory.mktemp("tls")
    ca = generate_ca()
    server_cert = generate_cert(ca[0], ca[1], "server.global.nomad",
                                san_dns=["server.global.nomad"])
    client_cert = generate_cert(ca[0], ca[1], "cli.global.nomad",
                                server=False)
    paths = {}
    for name, data in (("ca.pem", ca[0]), ("ca-key.pem", ca[1]),
                       ("server.pem", server_cert[0]),
                       ("server-key.pem", server_cert[1]),
                       ("client.pem", client_cert[0]),
                       ("client-key.pem", client_cert[1])):
        p = d / name
        p.write_bytes(data)
        paths[name] = str(p)
    return paths


def _agent(material, verify_client=False):
    tls = TLSConfig(
        enabled=True,
        ca_file=material["ca.pem"],
        cert_file=material["server.pem"],
        key_file=material["server-key.pem"],
        verify_https_client=verify_client,
    )
    a = Agent(AgentConfig(device="cpu", name="tls-agent", num_schedulers=0, tls=tls))
    a.start()
    return a


class TestHTTPS:
    def test_https_with_ca_verification(self, material):
        a = _agent(material)
        try:
            assert a.http_addr.startswith("https://")
            api = APIClient(a.http_addr, ca_cert=material["ca.pem"])
            assert api.agent.self()["Config"]["Name"] == "tls-agent"
        finally:
            a.shutdown()

    def test_unverified_client_rejected(self, material):
        a = _agent(material)
        try:
            # no CA configured -> default trust store -> handshake fails
            api = APIClient(a.http_addr, ca_cert=material["server.pem"])
            with pytest.raises((urllib.error.URLError, ssl.SSLError)):
                api.agent.self()
        finally:
            a.shutdown()

    def test_plain_http_refused(self, material):
        a = _agent(material)
        try:
            url = a.http_addr.replace("https://", "http://")
            with pytest.raises(Exception):
                urllib.request.urlopen(url + "/v1/agent/self", timeout=5)
        finally:
            a.shutdown()


class TestMTLS:
    def test_client_cert_required(self, material):
        a = _agent(material, verify_client=True)
        try:
            # with cert: accepted
            api = APIClient(
                a.http_addr, ca_cert=material["ca.pem"],
                client_cert=material["client.pem"],
                client_key=material["client-key.pem"],
            )
            assert api.agent.self()["Config"]["Name"] == "tls-agent"
            # without cert: handshake rejected
            bare = APIClient(a.http_addr, ca_cert=material["ca.pem"])
            with pytest.raises((urllib.error.URLError, ssl.SSLError,
                                ConnectionResetError)):
                bare.agent.self()
        finally:
            a.shutdown()


class TestFederatedTLS:
    def test_region_forwarding_over_tls(self, material):
        """Cross-region proxying must trust the cluster CA (the
        forwarder dials the remote region over HTTPS)."""
        east = _agent(material)
        west = _agent(material)
        try:
            east.server.join_region("west", west.http.addr)
            west.server.join_region("east", east.http.addr)
            api = APIClient(east.http_addr, ca_cert=material["ca.pem"])
            # ?region=west forwards east->west over HTTPS
            jobs = api.get("/v1/jobs?region=west")
            assert jobs == []
        finally:
            east.shutdown()
            west.shutdown()


class TestTLSCLI:
    def test_ca_and_cert_create(self, tmp_path):
        pytest.importorskip("cryptography")
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        r = subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch", "tls", "ca", "create"],
            cwd=tmp_path, capture_output=True, text=True, timeout=120,
            env=env)
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "nomad-agent-ca.pem").exists()
        r = subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch", "tls", "cert", "create",
             "-server"],
            cwd=tmp_path, capture_output=True, text=True, timeout=120,
            env=env)
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "global-server-nomad.pem").exists()
        # issued cert chains to the CA
        from cryptography import x509
        ca = x509.load_pem_x509_certificate(
            (tmp_path / "nomad-agent-ca.pem").read_bytes())
        leaf = x509.load_pem_x509_certificate(
            (tmp_path / "global-server-nomad.pem").read_bytes())
        assert leaf.issuer == ca.subject
        leaf.verify_directly_issued_by(ca)


# ---------------------------------------------------------------------------
# tests/test_monitor.py
# ---------------------------------------------------------------------------

class TestLogMonitor:
    def test_subscribe_receives_lines(self):
        mon = LogMonitor.install()
        q = mon.subscribe("info")
        try:
            logging.getLogger("nomad_tpu_torch.test").warning("hello-monitor")
            level, line = q.get(timeout=2)
            assert "hello-monitor" in line
        finally:
            mon.unsubscribe(q)

    def test_level_filter_in_stream(self):
        mon = LogMonitor.install()
        stop = threading.Event()
        got = []

        def consume():
            for line in mon.stream("error", stop):
                if line:
                    got.append(line)
                    stop.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.1)
        logging.getLogger("nomad_tpu_torch.test").info("below-threshold")
        logging.getLogger("nomad_tpu_torch.test").error("boom-error")
        t.join(timeout=5)
        assert got and "boom-error" in got[0]
        assert all("below-threshold" not in l for l in got)

    def test_info_records_pass_root_level_gate(self):
        """Regression: the unconfigured root logger gates at WARNING;
        subscribing at info must lower it so LOG.info lines stream,
        and restore it once the last subscriber leaves."""
        mon = LogMonitor.install()
        root = logging.getLogger()
        before = root.level
        q = mon.subscribe("info")
        try:
            logging.getLogger("nomad_tpu_torch.core_sched").info("info-visible")
            level, line = q.get(timeout=2)
            assert "info-visible" in line
        finally:
            mon.unsubscribe(q)
        assert root.level == before


class TestProfiles:
    def test_thread_dump_contains_main(self):
        dump = thread_dump()
        assert "MainThread" in dump
        assert "test_thread_dump_contains_main" in dump

    def test_sample_profile(self):
        done = threading.Event()

        def spin():
            while not done.is_set():
                sum(range(1000))

        t = threading.Thread(target=spin, name="spinner", daemon=True)
        t.start()
        try:
            out = sample_profile(seconds=0.3, hz=50)
        finally:
            done.set()
        assert "samples:" in out
        assert "spin" in out

    def test_heap_summary(self):
        out = heap_summary()
        assert "live objects" in out
        assert "dict" in out


class TestHTTP:
    def test_pprof_endpoints(self):
        agent = Agent(AgentConfig(device="cpu", num_schedulers=0))
        agent.start()
        try:
            api = APIClient(agent.http_addr)
            assert "MainThread" in api.agent.pprof("goroutine")
            assert "live objects" in api.agent.pprof("heap")
            assert "samples:" in api.agent.pprof("profile", seconds=1)
        finally:
            agent.shutdown()

    def test_monitor_streams_logs(self):
        agent = Agent(AgentConfig(device="cpu", num_schedulers=0))
        agent.start()
        try:
            api = APIClient(agent.http_addr)
            lines = []

            def consume():
                # keep draining until OUR marker arrives: under a full
                # suite run, stray daemon threads from earlier tests
                # can log a warning first, and stopping at the first
                # line then misses the marker (observed flake)
                for line in api.agent.monitor(log_level="warning",
                                              timeout=10):
                    lines.append(line)
                    if "stream-me-now" in line:
                        return

            t = threading.Thread(target=consume, daemon=True)
            t.start()
            time.sleep(0.3)
            logging.getLogger("nomad_tpu_torch.server").warning("stream-me-now")
            t.join(timeout=10)
            assert any("stream-me-now" in line for line in lines), lines
        finally:
            agent.shutdown()


# ---------------------------------------------------------------------------
# tests/test_federation.py (every agent a server)
# ---------------------------------------------------------------------------

def two_regions():
    east = Agent(AgentConfig(device="cpu", name="east-1", region="east", num_schedulers=0))
    west = Agent(AgentConfig(device="cpu", name="west-1", region="west", num_schedulers=0))
    east.start()
    west.start()
    # WAN join both ways
    east.server.join_region("west", west.http.addr)
    west.server.join_region("east", east.http.addr)
    return east, west


class TestFederation:
    def test_regions_list(self):
        east, west = two_regions()
        try:
            api = APIClient(east.http.addr)
            assert api.get("/v1/regions") == ["east", "west"]
        finally:
            east.shutdown()
            west.shutdown()

    def test_forwarding_reads_other_region(self):
        east, west = two_regions()
        try:
            job = mock.job()
            west.server.job_register(job)
            api = APIClient(east.http.addr)
            # local region: job not found
            local = api.jobs.list()
            assert all(j["ID"] != job.id for j in local)
            # ?region=west forwards to the west server
            remote = api.jobs.list(q=QueryOptions(region="west"))
            assert any(j["ID"] == job.id for j in remote)
        finally:
            east.shutdown()
            west.shutdown()

    def test_forwarding_writes_other_region(self):
        east, west = two_regions()
        try:
            api = APIClient(east.http.addr, region="west")
            api.namespaces.register("team-a", "cross-region write")
            assert west.server.state.namespace_by_name("team-a") is not None
            assert east.server.state.namespace_by_name("team-a") is None
        finally:
            east.shutdown()
            west.shutdown()

    def test_unknown_region_rejected(self):
        east, west = two_regions()
        try:
            api = APIClient(east.http.addr, region="mars")
            with pytest.raises(APIError) as e:
                api.jobs.list()
            assert "No path to region" in str(e.value)
        finally:
            east.shutdown()
            west.shutdown()

    def test_join_over_http(self):
        east = Agent(AgentConfig(device="cpu", name="e", region="east", num_schedulers=0))
        west = Agent(AgentConfig(device="cpu", name="w", region="west", num_schedulers=0))
        east.start()
        west.start()
        try:
            api = APIClient(east.http.addr)
            api.put("/v1/agent/join", q=QueryOptions(params={
                "address": west.http.addr, "join_region": "west",
            }))
            assert api.get("/v1/regions") == ["east", "west"]
        finally:
            east.shutdown()
            west.shutdown()


class TestACLReplication:
    def test_policies_and_global_tokens_replicate(self):
        from nomad_tpu_torch.acl.policy import ACLPolicy, ACLToken
        from nomad_tpu_torch.server import fsm as fsm_msgs

        auth = Agent(AgentConfig(device="cpu", name="auth-1", region="authority",
                                 num_schedulers=0))
        auth.start()
        replica = Agent(AgentConfig(device="cpu", name="rep-1", region="replica",
                                    num_schedulers=0))
        replica.start()
        try:
            replica.server.config.authoritative_region = "authority"
            replica.server.join_region("authority", auth.http.addr)

            policy = ACLPolicy(name="readers", rules='namespace "*" '
                               '{ policy = "read" }')
            auth.server.raft_apply(fsm_msgs.ACL_POLICY_UPSERT,
                                   {"policies": [policy]})
            gtok = ACLToken.create(name="g", type="management", global_=True)
            ltok = ACLToken.create(name="l", type="management", global_=False)
            auth.server.raft_apply(fsm_msgs.ACL_TOKEN_UPSERT,
                                   {"tokens": [gtok, ltok]})

            n = replica.server.replicate_acl_once()
            assert n >= 2
            got = replica.server.state.acl_policy_by_name("readers")
            assert got is not None and "read" in got.rules
            assert replica.server.state.acl_token_by_accessor(
                gtok.accessor_id) is not None
            # local tokens never replicate
            assert replica.server.state.acl_token_by_accessor(
                ltok.accessor_id) is None

            # steady state: a second pass applies nothing
            assert replica.server.replicate_acl_once() == 0

            # revocation in the authority propagates (diff-and-delete)
            auth.server.raft_apply(
                fsm_msgs.ACL_TOKEN_DELETE,
                {"accessor_ids": [gtok.accessor_id]},
            )
            auth.server.raft_apply(
                fsm_msgs.ACL_POLICY_DELETE, {"names": ["readers"]}
            )
            assert replica.server.replicate_acl_once() == 2
            assert replica.server.state.acl_token_by_accessor(
                gtok.accessor_id) is None
            assert replica.server.state.acl_policy_by_name("readers") is None
        finally:
            auth.shutdown()
            replica.shutdown()

    def test_regions_survive_snapshot_restore(self):
        from nomad_tpu_torch.server.server import Server, ServerConfig

        server = Server(ServerConfig(device="cpu", num_workers=0, region="east"))
        server.start()
        try:
            server.join_region("west", "http://west:4646")
            data = server.state.to_snapshot_bytes()
            fresh = Server(ServerConfig(device="cpu", num_workers=0, region="east"))
            fresh.state.restore_from_bytes(data)
            assert fresh.region_addr("west") == "http://west:4646"
        finally:
            server.shutdown()


class TestRetryJoin:
    """WAN auto-join (serf retry_join analog, agent.go retryJoin): an
    agent configured with region@url entries keeps retrying until the
    peer answers — including peers that start AFTER it."""

    def test_joins_peer_that_starts_later(self):
        import socket
        import time

        from nomad_tpu_torch.api.agent import Agent, AgentConfig

        # reserve the west agent's port before it exists
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        west_port = probe.getsockname()[1]
        probe.close()

        east = Agent(AgentConfig(
            device="cpu", name="rj-east", region="east",
            retry_join=[f"west@http://127.0.0.1:{west_port}"],
            retry_join_interval=0.2,
        ))
        east.start()
        west = None
        try:
            # east is up; west does not exist yet -> no join recorded
            time.sleep(0.6)
            assert east.server.region_addr("west") is None

            west = Agent(AgentConfig(
                device="cpu", name="rj-west", region="west", http_port=west_port))
            west.start()
            deadline = time.time() + 15
            while time.time() < deadline:
                if east.server.region_addr("west"):
                    break
                time.sleep(0.1)
            assert east.server.region_addr("west") == \
                f"http://127.0.0.1:{west_port}"
        finally:
            east.shutdown()
            if west is not None:
                west.shutdown()

    def test_config_file_server_join_stanza(self, tmp_path):
        from nomad_tpu_torch.api.config_file import load_config_files

        p = tmp_path / "agent.hcl"
        p.write_text("""
server {
  enabled = true
  server_join {
    retry_join     = ["west@http://h2:4646", "eu@https://h3:4646"]
    retry_max      = 12
    retry_interval = "30s"
  }
}
""")
        cfg = load_config_files([str(p)])
        assert cfg.retry_join == ["west@http://h2:4646",
                                  "eu@https://h3:4646"]
        assert cfg.retry_join_max_attempts == 12
        assert cfg.retry_join_interval == 30.0


# ---------------------------------------------------------------------------
# tests/test_event_stream_acl.py (on a server agent)
# ---------------------------------------------------------------------------

def _open_stream(addr: str, token: str, query: str = ""):
    """Raw chunked NDJSON reader over the event stream endpoint;
    returns (socket, line-iterator). ``query`` narrows topics
    (e.g. "topic=Allocation&topic=Deployment")."""
    host, port = addr.rsplit(":", 1)
    host = host.replace("http://", "")
    path = "/v1/event/stream" + (f"?{query}" if query else "")
    s = socket.create_connection((host, int(port)), timeout=30)
    s.sendall((
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}\r\nX-Nomad-Token: {token}\r\n\r\n"
    ).encode())
    f = s.makefile("rb")
    status = f.readline().decode()
    while f.readline().strip():      # drain headers
        pass

    def lines():
        while True:
            size = f.readline().strip()          # chunk size
            if not size:
                return
            try:
                n = int(size, 16)
            except ValueError:
                return
            if n == 0:
                return
            data = f.read(n)
            f.read(2)                            # trailing CRLF
            for ln in data.splitlines():
                if ln.strip():
                    yield ln

    return s, status, lines()


@pytest.fixture()
def acl_agent():
    cfg = AgentConfig.dev(device="cpu")
    cfg.acl_enabled = True
    agent = Agent(cfg)
    agent.start()
    try:
        yield agent
    finally:
        agent.shutdown()


class TestEventStreamACL:
    def test_namespace_scoped_token_sees_only_its_namespace(self, acl_agent):
        server = acl_agent.server
        server.raft_apply(fsm_msgs.NAMESPACE_UPSERT, {
            "namespaces": [Namespace(name="secret")]})
        policy = ACLPolicy(name="default-read",
                          rules='namespace "default" { policy = "read" }')
        server.raft_apply(fsm_msgs.ACL_POLICY_UPSERT,
                          {"policies": [policy]})
        tok = ACLToken.create(name="scoped", type="client",
                              policies=["default-read"])
        server.raft_apply(fsm_msgs.ACL_TOKEN_UPSERT, {"tokens": [tok]})

        s, status, lines = _open_stream(acl_agent.http.addr, tok.secret_id)
        assert " 200 " in status
        got = []
        stop = threading.Event()

        def reader():
            for ln in lines:
                batch = json.loads(ln)
                got.extend(batch.get("Events") or [])
                if stop.is_set():
                    return

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        try:
            visible = mock.job()
            visible.id = "visible-job"
            server.job_register(visible)
            hidden = mock.job()
            hidden.id = "hidden-job"
            hidden.namespace = "secret"
            server.job_register(hidden)

            deadline = time.time() + 15
            while time.time() < deadline:
                if any(e.get("Key") == "visible-job" for e in got):
                    break
                time.sleep(0.2)
            keys = {e.get("Key") for e in got}
            assert "visible-job" in keys, f"saw only {keys}"
            # the secret-namespace job never crosses this stream
            time.sleep(1.0)
            namespaces = {e.get("Namespace", "") for e in got}
            assert "secret" not in namespaces
            assert not any(e.get("Key") == "hidden-job" for e in got)
        finally:
            stop.set()
            s.close()

    def test_namespaced_token_topic_filter_scopes_alloc_events(
            self, acl_agent):
        """ISSUE 11 satellite: topic/key/namespace filtering under
        ACLs — a namespaced token subscribed to Allocation/Deployment
        topics sees only its own namespace's events; synthetic events
        published straight into the ring keep the test about the
        filter, not the scheduler."""
        from nomad_tpu_torch.server import stream

        server = acl_agent.server
        server.raft_apply(fsm_msgs.NAMESPACE_UPSERT, {
            "namespaces": [Namespace(name="secret")]})
        policy = ACLPolicy(name="default-read",
                          rules='namespace "default" { policy = "read" }')
        server.raft_apply(fsm_msgs.ACL_POLICY_UPSERT,
                          {"policies": [policy]})
        tok = ACLToken.create(name="scoped", type="client",
                              policies=["default-read"])
        server.raft_apply(fsm_msgs.ACL_TOKEN_UPSERT, {"tokens": [tok]})

        s, status, lines = _open_stream(
            acl_agent.http.addr, tok.secret_id,
            query="topic=Allocation&topic=Deployment")
        assert " 200 " in status
        got = []
        threading.Thread(
            target=lambda: [got.append(json.loads(ln))
                            for ln in lines],
            daemon=True).start()
        idx = server.state.latest_index() + 1
        server.event_broker.publish([
            stream.Event("Allocation", "AllocationUpdated", "a-vis",
                         idx, namespace="default"),
            stream.Event("Allocation", "AllocationUpdated", "a-hid",
                         idx, namespace="secret"),
            stream.Event("Deployment", "DeploymentUpdate", "d-hid",
                         idx, namespace="secret"),
            stream.Event("Job", "JobRegistered", "j-wrong-topic",
                         idx, namespace="default"),
            stream.Event("Deployment", "DeploymentUpdate", "d-vis",
                         idx, namespace="default"),
        ])
        deadline = time.time() + 15
        while time.time() < deadline:
            keys = {e.get("Key") for b in got
                    for e in (b.get("Events") or [])}
            if {"a-vis", "d-vis"} <= keys:
                break
            time.sleep(0.2)
        try:
            keys = {e.get("Key") for b in got
                    for e in (b.get("Events") or [])}
            assert {"a-vis", "d-vis"} <= keys, keys
            # namespace scope: the secret namespace's events never cross
            assert "a-hid" not in keys and "d-hid" not in keys
            # topic scope: unsubscribed topics never cross either
            assert "j-wrong-topic" not in keys
        finally:
            s.close()

    def test_management_token_sees_all_namespaces(self, acl_agent):
        from nomad_tpu_torch.server import stream

        server = acl_agent.server
        server.raft_apply(fsm_msgs.NAMESPACE_UPSERT, {
            "namespaces": [Namespace(name="secret")]})
        mgmt = ACLToken.create(name="root", type="management")
        server.raft_apply(fsm_msgs.ACL_TOKEN_UPSERT, {"tokens": [mgmt]})

        s, status, lines = _open_stream(acl_agent.http.addr,
                                        mgmt.secret_id)
        assert " 200 " in status
        got = []
        threading.Thread(
            target=lambda: [got.append(json.loads(ln))
                            for ln in lines],
            daemon=True).start()
        idx = server.state.latest_index() + 1
        server.event_broker.publish([
            stream.Event("Job", "JobRegistered", "j-default", idx,
                         namespace="default"),
            stream.Event("Job", "JobRegistered", "j-secret", idx,
                         namespace="secret"),
        ])
        deadline = time.time() + 15
        while time.time() < deadline:
            keys = {e.get("Key") for b in got
                    for e in (b.get("Events") or [])}
            if {"j-default", "j-secret"} <= keys:
                break
            time.sleep(0.2)
        try:
            keys = {e.get("Key") for b in got
                    for e in (b.get("Events") or [])}
            # the operator's stream spans every namespace
            assert {"j-default", "j-secret"} <= keys, keys
        finally:
            s.close()

    def test_revoked_token_loses_stream(self, acl_agent):
        server = acl_agent.server
        policy = ACLPolicy(name="default-read",
                          rules='namespace "default" { policy = "read" }')
        server.raft_apply(fsm_msgs.ACL_POLICY_UPSERT,
                          {"policies": [policy]})
        tok = ACLToken.create(name="doomed", type="client",
                              policies=["default-read"])
        server.raft_apply(fsm_msgs.ACL_TOKEN_UPSERT, {"tokens": [tok]})

        s, status, lines = _open_stream(acl_agent.http.addr, tok.secret_id)
        assert " 200 " in status
        ended = threading.Event()

        def reader():
            for _ in lines:
                pass
            ended.set()

        threading.Thread(target=reader, daemon=True).start()
        try:
            server.raft_apply(fsm_msgs.ACL_TOKEN_DELETE,
                              {"accessor_ids": [tok.accessor_id]})
            # next poll re-resolves the token and drops the stream
            assert ended.wait(timeout=12), \
                "stream survived token revocation"
        finally:
            s.close()

    def test_bad_token_rejected_at_subscribe(self, acl_agent):
        s, status, _ = _open_stream(acl_agent.http.addr, "no-such-token")
        s.close()
        assert " 403 " in status

    def test_anonymous_rejected_at_subscribe(self, acl_agent):
        # anonymous resolves but holds no read capability anywhere:
        # no 600s heartbeat-only stream for unauthenticated clients
        s, status, _ = _open_stream(acl_agent.http.addr, "")
        s.close()
        assert " 403 " in status

    def test_policy_narrowed_to_deny_drops_stream(self, acl_agent):
        server = acl_agent.server
        policy = ACLPolicy(name="flip",
                          rules='namespace "default" { policy = "read" }')
        server.raft_apply(fsm_msgs.ACL_POLICY_UPSERT,
                          {"policies": [policy]})
        tok = ACLToken.create(name="flipped", type="client",
                              policies=["flip"])
        server.raft_apply(fsm_msgs.ACL_TOKEN_UPSERT, {"tokens": [tok]})

        s, status, lines = _open_stream(acl_agent.http.addr, tok.secret_id)
        assert " 200 " in status
        ended = threading.Event()

        def reader():
            for _ in lines:
                pass
            ended.set()

        threading.Thread(target=reader, daemon=True).start()
        try:
            # the EDIT (not deletion) of the policy must reach the
            # stream: compiled-ACL caches are invalidated by the
            # acl_policy table index
            server.raft_apply(fsm_msgs.ACL_POLICY_UPSERT, {"policies": [
                ACLPolicy(name="flip",
                          rules='namespace "default" { policy = "deny" }')]})
            assert ended.wait(timeout=12), \
                "stream survived policy narrowing to deny"
        finally:
            s.close()


# ---------------------------------------------------------------------------
# What the port adds
# ---------------------------------------------------------------------------

def _wait_placed(api, job_id, count, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        allocs = api.jobs.allocations(job_id)
        if len(allocs) >= count:
            return allocs
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} not placed: "
                         f"{len(api.jobs.allocations(job_id))} allocs")


def _archive(store) -> bytes:
    """An operator snapshot archive of ``store``, as
    ``GET /v1/operator/snapshot`` gives it."""
    from types import SimpleNamespace

    from nomad_tpu_torch.utils.snapshot import archive_snapshot

    return archive_snapshot(SimpleNamespace(state=store, raft=None))


def _batched_agent(**kw):
    return Agent(AgentConfig(device="cpu", num_schedulers=1,
                             worker_batch_size=8, serf_enabled=False,
                             coalesce_adaptive=False, **kw))


def test_snapshot_restored_over_http_replaces_the_planes(monkeypatch):
    """An agent that placed on one cluster restores another over HTTP
    (``PUT /v1/operator/snapshot``) under its running server: its next
    job places as on an agent that restored the same archive before it
    placed anything, and the resident planes equal a fresh upload."""
    from nomad_tpu_torch.parallel import c2m
    from nomad_tpu_torch.structs import eval_plan as port_eval_plan
    from nomad_tpu_torch.tensors.device_state import default_device_state

    archive = _archive(c2m.generate(300, 2000, seed=7))
    rng = __import__("numpy").random.default_rng(11)
    job = c2m.burst_job(rng, 0, prefix="restored")
    placements = []
    for warm_first in (True, False):
        agent = _batched_agent()
        agent.start()
        try:
            api = APIClient(agent.http_addr)
            if warm_first:
                # the planes of a small cluster go resident first
                for _ in range(4):
                    agent.server.node_register(mock.node())
                first = mock.simple_job()
                api.jobs.register(encode(first))
                _wait_placed(api, first.id, 10)
            api.operator.snapshot_restore(archive)
            assert len(api.nodes.list()) == 300
            monkeypatch.setattr(port_eval_plan, "_UUID_RNG",
                                random.Random(99))
            api.jobs.register(encode(job))
            allocs = _wait_placed(api, job.id, c2m.BURST_COUNT)
            placements.append(sorted((a["Name"], a["NodeID"])
                                     for a in allocs))
            snap = agent.server.state.snapshot()
            nodes = {n.id for n in snap.nodes()}
            assert {node for _, node in placements[-1]} <= nodes
            res = default_device_state.check_fresh(snap, "cpu")
            assert res["resident"] and res["differ"] == [], res
        finally:
            agent.shutdown()
    assert placements[0] == placements[1]


def test_batched_agent_places_through_waves():
    """With ``worker_batch_size`` above 1 the agent's worker places the
    jobs it is sent over HTTP as coalesced waves (B1's plain version on
    the CPU); at the reference's batch size of 1 it forms no wave."""
    from nomad_tpu_torch.parallel import c2m
    from nomad_tpu_torch.parallel.coalesce import fused_wave_stats

    rng = __import__("numpy").random.default_rng(5)
    for batch in (8, 1):
        agent = Agent(AgentConfig(device="cpu", num_schedulers=1,
                                  worker_batch_size=batch,
                                  serf_enabled=False,
                                  coalesce_adaptive=False))
        agent.start()
        try:
            agent.server.state.restore_from_bytes(
                c2m.generate(200, 1000, seed=3).to_snapshot_bytes())
            api = APIClient(agent.http_addr)
            fused = fused_wave_stats.snapshot()["launches"]
            jobs = [c2m.burst_job(rng, i, prefix=f"b{batch}")
                    for i in range(12)]
            # the worker waits while the burst arrives, so that it finds
            # the whole burst ready: a batch of 8, then one of 4 (a
            # dequeue already waiting ends within its 0.2 s timeout)
            worker = agent.server.workers[0]
            worker.set_pause(True)
            time.sleep(0.5)
            for job in jobs:
                api.jobs.register(encode(job))
            worker.set_pause(False)
            for job in jobs:
                _wait_placed(api, job.id, c2m.BURST_COUNT)
            launched = fused_wave_stats.snapshot()["launches"] - fused
            assert worker.batch_launches == launched
            assert launched == (0 if batch == 1 else 2)
        finally:
            agent.shutdown()


def test_agent_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Agent(AgentConfig(serf_enabled=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        Agent(AgentConfig(device="cuda", serf_enabled=False))


def test_client_host_paths_and_names_are_the_processes_own(tmp_path,
                                                         monkeypatch):
    """A client's default data dir and its relays' state dir lie under
    the process's temp dir (the reference's are fixed paths under
    ``/tmp``), and its bridge probe names its netns and veth pair by the
    process's pid, so that clients of both packages, or two of the
    port's, probing at once never take each other's."""
    out = subprocess.run(
        [sys.executable, "-c",
         "from nomad_tpu_torch.client.client import ClientConfig\n"
         "from nomad_tpu_torch.client.network_manager import "
         "RELAY_STATE_DIR\n"
         "print(ClientConfig().data_dir)\nprint(RELAY_STATE_DIR)\n"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path / "nomad-tpu-client"),
                                  str(tmp_path / "nomad-tpu-relays")]

    from nomad_tpu_torch.client import network_manager

    calls = []

    def run(argv, timeout=15.0):
        calls.append(argv)
        return subprocess.CompletedProcess(argv, 0)

    monkeypatch.setattr(network_manager, "_run", run)
    assert network_manager.bridge_supported.__wrapped__() is True
    pid = os.getpid()
    assert calls == [
        ["ip", "netns", "add", f"nomadtpt-probe-{pid}"],
        ["ip", "link", "add", f"ntp{pid}a", "type", "veth", "peer", "name",
         f"ntp{pid}b"],
        ["ip", "link", "del", f"ntp{pid}a"],
        ["ip", "netns", "del", f"nomadtpt-probe-{pid}"]]
    assert all(len(name) <= 15 for name in (f"ntp{pid}a", f"ntp{pid}b"))


@pytest.mark.parametrize("config", [
    AgentConfig(device="cpu", client_enabled=True, serf_enabled=False),
    AgentConfig(device="cpu", server_enabled=False, client_enabled=True),
    AgentConfig.dev(device="cpu"),
], ids=["server+client", "client", "dev"])
def test_client_mode_runs_a_raw_exec_job_to_complete(config):
    """An agent with a server runs what it places on its own client; a
    client-only agent has no server to reach in-process."""
    if not config.server_enabled:
        with pytest.raises(ValueError, match="client-only agents need a "
                           "server address"):
            Agent(config)
        return
    agent = Agent(config)
    agent.start()
    try:
        api = APIClient(agent.http_addr)
        job = mock.job()
        job.type = consts.JOB_TYPE_BATCH
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "raw_exec"
        task.config = {"command": "/bin/sh",
                       "args": ["-c", 'echo "ran $NOMAD_ALLOC_ID"']}
        api.jobs.register(encode(job))
        assert wait_until(lambda: [
            a["ClientStatus"] for a in api.jobs.allocations(job.id)]
            == ["complete"], timeout=60)
        (alloc,) = api.jobs.allocations(job.id)
        assert alloc["NodeID"] == agent.client.node_id
        assert api.allocations.logs(alloc["ID"], task.name, "stdout") == (
            f"ran {alloc['ID']}\n")
    finally:
        agent.shutdown()
    # neither the task nor its log collectors outlive it
    assert wait_until(lambda: not processes_with(alloc["ID"]), timeout=15)
