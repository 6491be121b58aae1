"""Every scenario of ``tests/test_connect.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Consul Connect analog: sidecar proxies, mesh identity, upstreams.

Reference behavior: client/allocrunner/taskrunner/envoy_bootstrap_hook.go
(sidecar proxy per connect service), connect_native_hook.go (workload
identity for native services), nomad/job_endpoint_hook_connect.go
(sidecar mesh-port injection at admission), and the sidecar service
registration other allocations discover upstream endpoints from.

The headline property: two services
in ONE job reach each other ONLY through the mesh path — the app binds
loopback inside its namespace, the sidecar's mesh port is token-gated,
and the client's upstream listener is the sole working route.
"""

import json
import socket
import subprocess
import sys
import time

import pytest

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.client.network_manager import bridge_supported
from nomad_tpu_torch.structs.job import Service
from _torch_client import port_bridge  # noqa: F401

pytestmark = pytest.mark.skipif(
    not bridge_supported(), reason="host cannot create netns/veth")


def wait_for(fn, timeout=40.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.1)
    raise AssertionError(f"timeout waiting for {msg}")


def make_mesh_job():
    """One job, two groups: "api" serves on loopback inside its netns
    behind a connect sidecar; "web" declares an upstream to it."""
    job = mock.job()
    job.id = f"mesh-{job.id[-12:]}"
    job.constraints = []
    api = job.task_groups[0]
    api.name = "api"
    api.count = 1
    api.networks = [structs.NetworkResource(mode="bridge")]
    api.services = [Service(
        name="count-api",
        connect={"sidecar_service": {
            "proxy": {"local_service_port": 9001}}},
    )]
    task = api.tasks[0]
    task.name = "api"
    task.driver = "raw_exec"
    # the app binds LOOPBACK inside the namespace: nothing but the
    # sidecar (same namespace) can reach it
    task.config = {
        "command": sys.executable,
        "args": ["-S", "-c", (
            "import socket\n"
            "s = socket.socket()\n"
            "s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)\n"
            "s.bind((\"127.0.0.1\", 9001))\n"
            "s.listen(4)\n"
            "while True:\n"
            "    c, _ = s.accept()\n"
            "    c.sendall(b\"count-api-response\")\n"
            "    c.close()\n"
        )],
    }

    web = api.copy()
    web.name = "web"
    web.networks = [structs.NetworkResource(mode="bridge")]
    web.services = [Service(
        name="count-dashboard",
        connect={"sidecar_service": {"proxy": {
            "local_service_port": 9002,
            "upstreams": [{"destination_name": "count-api",
                           "local_bind_port": 8081}],
        }}},
    )]
    wt = web.tasks[0]
    wt.name = "web"
    wt.config = {
        "command": sys.executable,
        "args": ["-S", "-c", "import time\ntime.sleep(300)\n"],
    }
    job.task_groups = [api, web]
    return job


def _netns_fetch(ns: str, port: int, payload: bytes = b"") -> bytes:
    """Connect to 127.0.0.1:<port> INSIDE the namespace, return reply."""
    prog = (
        "import socket, sys\n"
        "c = socket.create_connection((\"127.0.0.1\", %d), timeout=5)\n"
        "c.sendall(%r)\n" % (port, payload)
        + "sys.stdout.buffer.write(c.recv(200))\n"
    )
    out = subprocess.run(
        ["ip", "netns", "exec", ns, sys.executable, "-S", "-c", prog],
        capture_output=True, timeout=15)
    return out.stdout


class TestServiceMesh:
    def test_two_services_reach_each_other_only_through_mesh(self):
        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            job = make_mesh_job()
            agent.server.job_register(job)

            # both allocs run; the api sidecar service is registered
            def regs():
                return agent.server.services_by_name(
                    "default", "count-api-sidecar-proxy")
            sidecars = wait_for(lambda: regs() or None,
                                msg="sidecar registration")
            assert sidecars[0]["Port"] > 0
            mesh_addr = (sidecars[0]["Address"], sidecars[0]["Port"])

            # find web's netns
            snap = agent.server.state.snapshot()
            web_alloc = wait_for(
                lambda: next(
                    (a for a in agent.server.state.snapshot()
                     .allocs_by_job(job.namespace, job.id)
                     if a.task_group == "web"
                     and a.client_status == "running"), None),
                msg="web alloc running")
            web_net = wait_for(
                lambda: agent.client.network_manager.network_of(
                    web_alloc.id), msg="web netns")

            # 1) THE MESH PATH WORKS: web's upstream listener inside its
            # namespace reaches the api app through both sidecars
            data = wait_for(
                lambda: _netns_fetch(web_net.ns_name, 8081) or None,
                msg="mesh response")
            assert data == b"count-api-response"

            # 2) the api app itself is NOT reachable from the host:
            # it binds loopback inside its own namespace
            api_alloc = next(
                a for a in agent.server.state.snapshot()
                .allocs_by_job(job.namespace, job.id)
                if a.task_group == "api")
            api_net = agent.client.network_manager.network_of(api_alloc.id)
            with pytest.raises(OSError):
                socket.create_connection((api_net.ip, 9001), timeout=2)

            # 3) the sidecar's mesh port refuses unauthenticated
            # connections (the intentions-deny analog): without the
            # mesh identity token, no bytes come back
            c = socket.create_connection(mesh_addr, timeout=5)
            c.sendall(b"SI wrong-token\n")
            c.settimeout(3)
            got = b""
            try:
                got = c.recv(100)
            except socket.timeout:
                pass
            finally:
                c.close()
            assert got == b"", "mesh port answered an unauthenticated peer"

            # ... and WITH the token, the same port serves (the
            # upstream proxy's handshake)
            token = agent.server.mesh_identity_token(
                "default", "count-api")
            c = socket.create_connection(mesh_addr, timeout=5)
            c.sendall(b"SI " + token.encode() + b"\n")
            got = c.recv(100)
            c.close()
            assert got == b"count-api-response"

            # 4) derivation is SCOPED to the alloc's declared
            # services/upstreams (consul.go DeriveSITokens): web's
            # alloc may derive its own service and its declared
            # upstream, but not an arbitrary destination
            assert agent.server.mesh_identity_token(
                "default", "count-api", alloc_id=web_alloc.id)
            assert agent.server.mesh_identity_token(
                "default", "count-dashboard", alloc_id=web_alloc.id)
            with pytest.raises(PermissionError):
                agent.server.mesh_identity_token(
                    "default", "some-other-service",
                    alloc_id=web_alloc.id)
            with pytest.raises(PermissionError):
                agent.server.mesh_identity_token(
                    "default", "count-api", alloc_id="no-such-alloc")
        finally:
            agent.shutdown()

    def test_connect_native_gets_identity_env(self):
        """connect-native services skip the sidecar; the task gets the
        mesh identity token as env (connect_native_hook.go)."""
        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            job = mock.job()
            job.id = f"native-{job.id[-12:]}"
            job.constraints = []
            tg = job.task_groups[0]
            tg.count = 1
            tg.services = [Service(name="nativesvc",
                                   connect={"native": True})]
            task = tg.tasks[0]
            task.driver = "raw_exec"
            task.config = {
                "command": "/bin/sh",
                "args": ["-c", "echo -n \"$NOMAD_SI_TOKEN_NATIVESVC\" "
                         "> \"$NOMAD_ALLOC_DIR_HOST\"/token.out 2>/dev/null"
                         " || echo -n \"$NOMAD_SI_TOKEN_NATIVESVC\""],
            }
            agent.server.job_register(job)
            alloc = wait_for(
                lambda: next(
                    (a for a in agent.server.state.snapshot()
                     .allocs_by_job(job.namespace, job.id)), None),
                msg="alloc placed")
            runner = wait_for(
                lambda: agent.client.allocs.get(alloc.id),
                msg="alloc runner")
            conn = wait_for(lambda: runner.alloc_connect,
                            msg="connect state")
            token = agent.server.mesh_identity_token("default", "nativesvc")
            assert conn.env["NOMAD_SI_TOKEN_NATIVESVC"] == token
            assert not conn.proxies      # native: no sidecar processes
        finally:
            agent.shutdown()
