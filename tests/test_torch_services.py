"""Every scenario of ``tests/test_services.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Native service-discovery tests.

Modeled on reference nomad/service_registration_endpoint_test.go,
state_store_service_registration_test.go, and the client
serviceregistration wrapper tests (client/serviceregistration/nsd).
"""

import time

import pytest

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.job import Service
from nomad_tpu_torch.structs.services import ServiceRegistration, registration_id
from _torch_client import port_bridge  # noqa: F401


def wait_for(fn, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def make_reg(reg_id="r1", name="web", alloc_id="a1", node_id="n1", **kw):
    return ServiceRegistration(
        id=reg_id, service_name=name, alloc_id=alloc_id, node_id=node_id,
        job_id=kw.pop("job_id", "j1"), address=kw.pop("address", "10.0.0.1"),
        port=kw.pop("port", 8080), **kw,
    )


class TestStateStore:
    def test_upsert_list_delete(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            server.service_register([make_reg(), make_reg("r2", "db")])
            assert len(server.state.service_registrations()) == 2
            assert [r.id for r in
                    server.state.service_registrations_by_name(
                        "default", "web")] == ["r1"]
            server.service_deregister("r1")
            assert len(server.state.service_registrations()) == 1
            with pytest.raises(ValueError):
                server.service_deregister("r1")
        finally:
            server.shutdown()

    def test_delete_by_alloc_and_node(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            server.service_register([
                make_reg("r1", alloc_id="a1", node_id="n1"),
                make_reg("r2", alloc_id="a2", node_id="n1"),
                make_reg("r3", alloc_id="a3", node_id="n2"),
            ])
            server.service_deregister_by_alloc(["a1"])
            assert {r.id for r in server.state.service_registrations()} == \
                {"r2", "r3"}
            server.state.delete_service_registrations_by_node("n1")
            assert {r.id for r in server.state.service_registrations()} == \
                {"r3"}
        finally:
            server.shutdown()

    def test_alloc_gc_reaps_registrations(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            server.service_register([make_reg("r1", alloc_id="a1")])
            server.state.delete_allocs(["a1"])
            assert server.state.service_registrations() == []
        finally:
            server.shutdown()

    def test_validation(self):
        with pytest.raises(ValueError):
            ServiceRegistration(id="x", service_name="web").validate()

    def test_registration_id_stable(self):
        assert registration_id("web", "a1", "t1") == \
            registration_id("web", "a1", "t1")
        assert registration_id("web", "a1", "t1") != \
            registration_id("web", "a2", "t1")
        # same service name on one task, two port labels -> distinct ids
        assert registration_id("web", "a1", "t1", "http") != \
            registration_id("web", "a1", "t1", "metrics")


class TestNodeDownReaping:
    def test_node_down_removes_its_services(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            node = mock.node()
            server.node_register(node)
            server.service_register([
                make_reg("r1", node_id=node.id),
                make_reg("r2", node_id="other-node"),
            ])
            server.node_update_status(node.id, consts.NODE_STATUS_DOWN)
            assert {r.id for r in server.state.service_registrations()} == \
                {"r2"}
        finally:
            server.shutdown()


class TestEndToEnd:
    def test_service_registered_while_task_runs(self, tmp_path):
        server = Server(ServerConfig(device="cpu", heartbeat_ttl=60.0))
        server.start()
        client = None
        try:
            client = Client(
                InProcessRPC(server),
                ClientConfig(data_dir=str(tmp_path)),
            )
            client.start()
            wait_for(
                lambda: any(n.ready() for n in server.state.snapshot().nodes()),
                msg="node ready",
            )

            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "mock_driver"
            task.config = {"run_for": 30}
            task.services = [Service(name="web-svc", provider="builtin",
                                     tags=["prod", "http"])]
            server.job_register(job)

            wait_for(
                lambda: server.state.service_registrations_by_name(
                    "default", "web-svc"),
                msg="service registered",
            )
            regs = server.state.service_registrations_by_name(
                "default", "web-svc"
            )
            assert regs[0].job_id == job.id
            assert regs[0].address
            assert regs[0].tags == ["prod", "http"]

            # stop -> task dead -> client deregisters
            server.job_deregister("default", job.id)
            wait_for(
                lambda: not server.state.service_registrations_by_name(
                    "default", "web-svc"),
                msg="service deregistered",
            )
        finally:
            if client is not None:
                client.shutdown()
            server.shutdown()


class TestHTTP:
    def test_services_over_http(self):
        from nomad_tpu_torch.api.agent import Agent, AgentConfig
        from nomad_tpu_torch.api.client import APIClient

        agent = Agent(AgentConfig(device="cpu", num_schedulers=0))
        agent.start()
        try:
            agent.server.service_register([
                make_reg("r1", "web", tags=["a"]),
                make_reg("r2", "web", alloc_id="a2", tags=["b"]),
                make_reg("r3", "db"),
            ])
            api = APIClient(agent.http.addr)
            listing = api.services.list()
            assert listing[0]["Namespace"] == "default"
            names = {s["ServiceName"] for s in listing[0]["Services"]}
            assert names == {"web", "db"}
            web = next(s for s in listing[0]["Services"]
                       if s["ServiceName"] == "web")
            assert web["Tags"] == ["a", "b"]

            regs = api.services.get("web")
            assert [r["ID"] for r in regs] == ["r1", "r2"]
            assert regs[0]["Port"] == 8080

            # delete is scoped by service name + namespace
            from nomad_tpu_torch.api.client import APIError
            with pytest.raises(APIError):
                api.services.delete("db", "r1")     # wrong name
            api.services.delete("web", "r1")
            assert [r["ID"] for r in api.services.get("web")] == ["r2"]
        finally:
            agent.shutdown()
