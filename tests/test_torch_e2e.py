"""Every scenario of ``tests/test_e2e.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

End-to-end scenario suite, driven through the public HTTP API.

Reference behavior: e2e/ runs per-component scenario suites against a
real cluster (affinities, spread, drain, rescheduling, deployments;
e2e/framework). Here the cluster is one in-process agent
(server+client) plus a second client node, and every action goes
through the HTTP API the way an operator's CLI would.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.api.codec import encode
from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.job import UpdateStrategy
from _torch_client import port_bridge  # noqa: F401


def _wait(fn, timeout=30.0, every=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if fn():
                return True
        except Exception:                       # noqa: BLE001
            pass
        time.sleep(every)
    return False


@pytest.fixture()
def cluster(tmp_path):
    """server+client agent plus a second client node, HTTP in front."""
    agent = Agent(AgentConfig(device="cpu", name="e2e", num_schedulers=1,
                              client_enabled=True))
    agent.client.config.data_dir = str(tmp_path / "c1")
    agent.start()
    c2 = Client(InProcessRPC(agent.server),
                ClientConfig(data_dir=str(tmp_path / "c2"),
                             datacenter="dc2"))
    c2.start()
    api = APIClient(agent.http_addr)
    assert _wait(lambda: len(api.get("/v1/nodes")) == 2)
    yield agent, c2, api
    c2.shutdown()
    agent.shutdown()


def _service_job(count=2, run_for="120s"):
    job = mock.job()
    job.task_groups[0].count = count
    task = job.task_groups[0].tasks[0]
    task.driver = "mock_driver"
    task.config = {"run_for": run_for}
    return job


def _running(api, job_id):
    return [a for a in api.get(f"/v1/job/{job_id}/allocations")
            if a["ClientStatus"] == "running"]


class TestE2ELifecycle:
    def test_submit_scale_stop_via_http(self, cluster):
        agent, c2, api = cluster
        hcl = '''
        job "http-e2e" {
          datacenters = ["dc1", "dc2"]
          group "app" {
            count = 2
            task "t" {
              driver = "mock_driver"
              config { run_for = "120s" }
            }
          }
        }
        '''
        parsed = api.post("/v1/jobs/parse", {"JobHCL": hcl})
        api.jobs.register(parsed)
        assert _wait(lambda: len(_running(api, "http-e2e")) == 2)

        # scale up through the API
        api.post("/v1/job/http-e2e/scale",
                 {"Target": {"Group": "app"}, "Count": 4})
        assert _wait(lambda: len(_running(api, "http-e2e")) == 4)

        # stop; allocs drain to complete
        api.delete("/v1/job/http-e2e")
        assert _wait(lambda: not _running(api, "http-e2e"))

    def test_failed_task_rescheduled(self, cluster):
        agent, c2, api = cluster
        job = mock.job()
        job.task_groups[0].count = 1
        from nomad_tpu_torch.structs.job import ReschedulePolicy, RestartPolicy
        job.task_groups[0].reschedule_policy = ReschedulePolicy(
            attempts=3, interval_s=300.0, delay_s=0.1,
            delay_function="constant")
        job.task_groups[0].restart_policy = RestartPolicy(
            attempts=0, mode="fail")
        task = job.task_groups[0].tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "0.1s", "exit_code": 1}
        api.jobs.register(encode(job))
        # a replacement allocation appears after the failure
        assert _wait(lambda: len(
            api.get(f"/v1/job/{job.id}/allocations")) >= 2, timeout=40)


class TestE2EDrain:
    def test_drain_migrates_allocs(self, cluster):
        agent, c2, api = cluster
        job = _service_job(count=4)
        job.datacenters = ["dc1", "dc2"]
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 4)

        # drain the agent's own node via the API
        node_id = agent.client.node_id
        before = {a["NodeID"] for a in _running(api, job.id)}
        assert node_id in before, "expected allocs on the drained node"
        api.post(f"/v1/node/{node_id}/drain",
                 {"DrainSpec": {"Deadline": 60_000_000_000}})
        # all four end up running on the other node
        assert _wait(lambda: (
            len(_running(api, job.id)) == 4
            and {a["NodeID"] for a in _running(api, job.id)}
            == {c2.node_id}
        ), timeout=60), "drain did not migrate all allocs"


class TestE2EDeployment:
    def test_rolling_update_deployment_succeeds(self, cluster):
        agent, c2, api = cluster
        job = _service_job(count=2)
        job.datacenters = ["dc1", "dc2"]
        job.task_groups[0].update = UpdateStrategy(
            max_parallel=1, min_healthy_time_s=0.1,
            healthy_deadline_s=30.0, canary=0)
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 2)

        job2 = job.copy()
        job2.task_groups[0].tasks[0].env = {"V": "2"}
        api.jobs.register(encode(job2))
        # the v1 deployment rolls to successful and both running
        # allocs are on the new version (v0's deployment also reads
        # "successful"; key on JobVersion)
        def rollout_done():
            deps = api.get(f"/v1/job/{job.id}/deployments")
            ok = any(d.get("Status") == "successful"
                     and d.get("JobVersion") == 1 for d in deps)
            allocs = _running(api, job.id)
            return ok and len(allocs) == 2 and \
                all(a["JobVersion"] == 1 for a in allocs)
        assert _wait(rollout_done, timeout=60), (
            api.get(f"/v1/job/{job.id}/deployments"),
            _running(api, job.id))


class TestE2EPlacement:
    def test_datacenter_spread(self, cluster):
        agent, c2, api = cluster
        from nomad_tpu_torch.structs.constraints import Spread, SpreadTarget
        job = _service_job(count=4)
        job.datacenters = ["dc1", "dc2"]
        job.spreads = [Spread(
            attribute="${node.datacenter}", weight=100,
            spread_target=[SpreadTarget(value="dc1", percent=50),
                           SpreadTarget(value="dc2", percent=50)])]
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 4)
        by_node = {}
        for a in _running(api, job.id):
            by_node[a["NodeID"]] = by_node.get(a["NodeID"], 0) + 1
        assert sorted(by_node.values()) == [2, 2], by_node

    def test_constraint_pins_datacenter(self, cluster):
        agent, c2, api = cluster
        from nomad_tpu_torch.structs.constraints import Constraint
        job = _service_job(count=2)
        job.datacenters = ["dc1", "dc2"]
        job.constraints = [Constraint(
            ltarget="${node.datacenter}", operand="=", rtarget="dc2")]
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 2)
        assert all(a["NodeID"] == c2.node_id
                   for a in _running(api, job.id))


class TestE2EDisconnectedClients:
    """e2e/disconnectedclients: a partitioned client's allocs go
    'unknown' under max_client_disconnect (no premature replacement),
    reconcile back on reconnect, and are LOST + replaced without it."""

    def test_max_client_disconnect_rides_out_partition(self, cluster):
        agent, c2, api = cluster
        job = _service_job(count=1)
        job.datacenters = ["dc2"]           # pin to the partition victim
        from nomad_tpu_torch.structs.constraints import Constraint
        job.constraints = [Constraint(
            ltarget="${node.datacenter}", operand="=", rtarget="dc2")]
        job.task_groups[0].max_client_disconnect_s = 60.0
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 1)
        alloc_id = _running(api, job.id)[0]["ID"]

        # partition: heartbeats stop, tasks keep running
        c2.partition_heartbeats = True
        assert _wait(lambda: api.get(f"/v1/node/{c2.node_id}")["Status"]
                     == consts.NODE_STATUS_DISCONNECTED, timeout=40), \
            api.get(f"/v1/node/{c2.node_id}")["Status"]
        assert _wait(lambda: api.get(f"/v1/allocation/{alloc_id}")
                     ["ClientStatus"] == consts.ALLOC_CLIENT_UNKNOWN,
                     timeout=30)
        # crucially: no replacement was scheduled inside the window
        allocs = api.get(f"/v1/job/{job.id}/allocations")
        assert len(allocs) == 1, allocs

        # heal the partition: the SAME alloc reconnects
        c2.partition_heartbeats = False
        assert _wait(lambda: api.get(f"/v1/allocation/{alloc_id}")
                     ["ClientStatus"] == "running", timeout=40)
        assert _wait(lambda: api.get(f"/v1/node/{c2.node_id}")["Status"]
                     == consts.NODE_STATUS_READY, timeout=30)

        # the reconciler keeps exactly the reconnecting alloc running;
        # any replacement it scheduled during the window is stopped
        # (its row remains in state as history — reference semantics)
        def reconciled():
            allocs = api.get(f"/v1/job/{job.id}/allocations")
            running = [a for a in allocs
                       if a["ClientStatus"] == "running"
                       and a["DesiredStatus"] == "run"]
            others_stopped = all(
                a["DesiredStatus"] in ("stop", "evict")
                for a in allocs if a["ID"] != alloc_id)
            return (len(running) == 1 and running[0]["ID"] == alloc_id
                    and others_stopped)
        assert _wait(reconciled, timeout=40), \
            api.get(f"/v1/job/{job.id}/allocations")

    def test_lost_client_without_window_is_replaced(self, cluster):
        agent, c2, api = cluster
        job = _service_job(count=1)
        job.datacenters = ["dc1", "dc2"]
        from nomad_tpu_torch.structs.constraints import Constraint
        job.constraints = [Constraint(
            ltarget="${node.datacenter}", operand="=", rtarget="dc2")]
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 1)
        old = _running(api, job.id)[0]["ID"]

        # retarget so the replacement has somewhere to go, then drop c2
        job2 = job.copy()
        job2.constraints = []
        api.jobs.register(encode(job2))
        assert _wait(lambda: len(_running(api, job2.id)) == 1, timeout=30)
        c2.partition_heartbeats = True
        # node goes down; the alloc is lost and replaced on the agent node
        assert _wait(lambda: any(
            a["ID"] != old and a["ClientStatus"] == "running"
            and a["NodeID"] == agent.client.node_id
            for a in api.get(f"/v1/job/{job.id}/allocations")), timeout=60), \
            api.get(f"/v1/job/{job.id}/allocations")
        c2.partition_heartbeats = False


class TestE2EPreemption:
    def test_high_priority_service_preempts_under_pressure(self, cluster):
        agent, c2, api = cluster
        # enable service preemption through the operator API
        cfg = api.get("/v1/operator/scheduler/configuration")
        cfg["SchedulerConfig"]["PreemptionConfig"]["ServiceSchedulerEnabled"] = True
        api.put("/v1/operator/scheduler/configuration",
                cfg["SchedulerConfig"])

        # size the ballast from the FINGERPRINTED capacity (the e2e
        # clients report the real host, not mock numbers)
        node = api.get(f"/v1/node/{agent.client.node_id}")
        cap_cpu = node["NodeResources"]["CPU"]["CPUShares"]
        cap_mem = node["NodeResources"]["Memory"]["MemoryMB"]

        # fill BOTH nodes with low-priority ballast
        filler = _service_job(count=2)
        filler.priority = 10
        filler.datacenters = ["dc1", "dc2"]
        t = filler.task_groups[0].tasks[0]
        t.resources.cpu = int(cap_cpu * 0.8)
        t.resources.memory_mb = int(cap_mem * 0.8)
        api.jobs.register(encode(filler))
        assert _wait(lambda: len(_running(api, filler.id)) == 2, timeout=40)

        # the high-priority job must evict ballast to place
        vip = _service_job(count=1)
        vip.priority = 90
        vip.datacenters = ["dc1", "dc2"]
        vt = vip.task_groups[0].tasks[0]
        vt.resources.cpu = int(cap_cpu * 0.5)
        vt.resources.memory_mb = int(cap_mem * 0.5)
        api.jobs.register(encode(vip))
        assert _wait(lambda: len(_running(api, vip.id)) == 1, timeout=60), \
            api.get(f"/v1/job/{vip.id}/allocations")
        # at least one ballast alloc was evicted (desired status evict)
        evicted = [a for a in api.get(f"/v1/job/{filler.id}/allocations")
                   if a["DesiredStatus"] == consts.ALLOC_DESIRED_EVICT]
        assert evicted, "no ballast alloc was preempted"


class TestE2ECSI:
    def test_csi_volume_gates_placement_and_releases_claims(self, cluster):
        agent, c2, api = cluster
        from nomad_tpu_torch.structs import csi as csi_structs

        # only c2 fingerprints the plugin: placement must follow it
        c2.node.csi_node_plugins = {
            "plug-e2e": {"provider": "e2e.csi", "version": "1",
                         "healthy": True}}
        c2.rpc.register_node(c2.node)
        api.put("/v1/volumes", {"Volumes": [{
            "ID": "vol-e2e", "Namespace": "default", "Name": "vol-e2e",
            "ExternalID": "ext-1", "PluginID": "plug-e2e",
            "RequestedCapabilities": [{
                "AccessMode": csi_structs.ACCESS_MODE_SINGLE_NODE_WRITER,
                "AttachmentMode": csi_structs.ATTACHMENT_MODE_FS}],
        }]})
        vols = api.get("/v1/volumes")
        assert any(v["ID"] == "vol-e2e" for v in vols)

        from nomad_tpu_torch.structs.job import VolumeRequest
        job = _service_job(count=1)
        job.datacenters = ["dc1", "dc2"]
        job.task_groups[0].volumes = {
            "data": VolumeRequest(name="data", type="csi",
                                  source="vol-e2e")}
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 1, timeout=40)
        assert _running(api, job.id)[0]["NodeID"] == c2.node_id, \
            "placement ignored the CSI plugin constraint"

        # lifecycle: stop the job; claims drain and the volume can be
        # deregistered through the public API
        api.delete(f"/v1/job/{job.id}")
        assert _wait(lambda: not _running(api, job.id))

        def dereg_ok():
            api.delete("/v1/volume/csi/vol-e2e")
            return all(v["ID"] != "vol-e2e"
                       for v in api.get("/v1/volumes"))
        assert _wait(dereg_ok, timeout=40)


class TestE2EOversubscription:
    def test_memory_max_rides_allocs_only_when_enabled(self, cluster):
        agent, c2, api = cluster
        job = _service_job(count=1)
        t = job.task_groups[0].tasks[0]
        t.resources.memory_mb = 64
        t.resources.memory_max_mb = 512
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 1)
        a = api.get(f"/v1/allocation/{_running(api, job.id)[0]['ID']}")
        got = a["AllocatedResources"]["Tasks"]["web"]["Memory"]
        assert got["MemoryMaxMB"] == 0, got     # disabled by default

        cfg = api.get("/v1/operator/scheduler/configuration")
        cfg["SchedulerConfig"]["MemoryOversubscriptionEnabled"] = True
        api.put("/v1/operator/scheduler/configuration",
                cfg["SchedulerConfig"])
        job2 = _service_job(count=1)
        t2 = job2.task_groups[0].tasks[0]
        t2.resources.memory_mb = 64
        t2.resources.memory_max_mb = 512
        api.jobs.register(encode(job2))
        assert _wait(lambda: len(_running(api, job2.id)) == 1)
        a2 = api.get(f"/v1/allocation/{_running(api, job2.id)[0]['ID']}")
        got2 = a2["AllocatedResources"]["Tasks"]["web"]["Memory"]
        assert got2["MemoryMaxMB"] == 512, got2


class TestE2EBlockedEvals:
    def test_blocked_job_unblocks_when_capacity_frees(self, cluster):
        agent, c2, api = cluster
        # ballast consumes nearly everything on both nodes
        node = api.get(f"/v1/node/{agent.client.node_id}")
        cap_cpu = node["NodeResources"]["CPU"]["CPUShares"]
        cap_mem = node["NodeResources"]["Memory"]["MemoryMB"]
        filler = _service_job(count=2)
        filler.datacenters = ["dc1", "dc2"]
        ft = filler.task_groups[0].tasks[0]
        ft.resources.cpu = int(cap_cpu * 0.8)
        ft.resources.memory_mb = int(cap_mem * 0.8)
        api.jobs.register(encode(filler))
        assert _wait(lambda: len(_running(api, filler.id)) == 2, timeout=40)

        big = _service_job(count=1)
        big.datacenters = ["dc1", "dc2"]
        bt = big.task_groups[0].tasks[0]
        bt.resources.cpu = int(cap_cpu * 0.5)
        bt.resources.memory_mb = int(cap_mem * 0.5)
        api.jobs.register(encode(big))
        # blocked, not placed
        assert _wait(lambda: any(
            e["Status"] == consts.EVAL_STATUS_BLOCKED
            for e in api.get(f"/v1/job/{big.id}/evaluations")), timeout=30)
        assert not _running(api, big.id)

        # free capacity: the blocked eval unblocks and places
        api.delete(f"/v1/job/{filler.id}")
        assert _wait(lambda: len(_running(api, big.id)) == 1, timeout=60), \
            api.get(f"/v1/job/{big.id}/evaluations")


class TestE2EPeriodicAndDispatch:
    def test_periodic_job_forced_launch(self, cluster):
        agent, c2, api = cluster
        from nomad_tpu_torch.structs.job import PeriodicConfig
        job = _service_job(count=1, run_for="0.2s")
        job.type = consts.JOB_TYPE_BATCH
        job.periodic = PeriodicConfig(enabled=True, spec="0 3 * * *",
                                      spec_type="cron")
        api.jobs.register(encode(job))
        # the parent never runs; a forced launch creates a child
        from urllib.parse import quote
        api.post(f"/v1/job/{job.id}/periodic/force", {})
        def child_done():
            kids = [j for j in api.get("/v1/jobs")
                    if j["ID"].startswith(job.id + "/periodic-")]
            return kids and any(
                a["ClientStatus"] == "complete"
                for k in kids
                for a in api.get(
                    f"/v1/job/{quote(k['ID'], safe='')}/allocations"))
        assert _wait(child_done, timeout=40)

    def test_parameterized_dispatch(self, cluster):
        agent, c2, api = cluster
        from nomad_tpu_torch.structs.job import ParameterizedJobConfig
        job = _service_job(count=1, run_for="0.2s")
        job.type = consts.JOB_TYPE_BATCH
        job.parameterized = ParameterizedJobConfig(
            payload="optional", meta_optional=["color"])
        api.jobs.register(encode(job))
        resp = api.post(f"/v1/job/{job.id}/dispatch",
                        {"Meta": {"color": "green"}})
        from urllib.parse import quote
        child = quote(resp["DispatchedJobID"], safe="")
        assert _wait(lambda: any(
            a["ClientStatus"] == "complete"
            for a in api.get(f"/v1/job/{child}/allocations")), timeout=40)


class TestE2ESystem:
    def test_system_job_covers_every_eligible_node(self, cluster):
        agent, c2, api = cluster
        job = mock.system_job()
        job.datacenters = ["dc1", "dc2"]
        job.constraints = []
        t = job.task_groups[0].tasks[0]
        t.driver = "mock_driver"
        t.config = {"run_for": "120s"}
        api.jobs.register(encode(job))
        assert _wait(lambda: {a["NodeID"] for a in _running(api, job.id)}
                     == {agent.client.node_id, c2.node_id}, timeout=40), \
            _running(api, job.id)


class TestE2EConnect:
    def test_sidecar_service_gets_mesh_port(self, cluster):
        agent, c2, api = cluster
        import sys as _sys
        from nomad_tpu_torch.structs import NetworkResource, Service
        job = mock.job()
        job.constraints = []
        tg = job.task_groups[0]
        tg.count = 1
        tg.networks = [NetworkResource(mode="bridge")]
        tg.services = [Service(
            name="mesh-api",
            connect={"sidecar_service": {
                "proxy": {"local_service_port": 9901}}})]
        task = tg.tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "120s"}
        api.jobs.register(encode(job))
        assert _wait(lambda: len(_running(api, job.id)) == 1, timeout=40)
        a = api.get(f"/v1/allocation/{_running(api, job.id)[0]['ID']}")
        ports = (a["AllocatedResources"]["Shared"] or {}).get("Ports") or []
        mesh = [p for p in ports
                if p.get("Label") == "connect-proxy-mesh-api"]
        assert mesh and mesh[0]["Value"] > 0, ports
