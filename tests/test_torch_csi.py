"""Every scenario of ``tests/test_csi.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

CSI subsystem tests.

Modeled on reference nomad/structs/csi_test.go (claim admission),
nomad/csi_endpoint_test.go (register/claim/deregister),
nomad/volumewatcher/volumes_watcher_test.go (claim reaping), and
scheduler/feasible_test.go TestCSIVolumeChecker.
"""

import time

import pytest

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.plugins.csi import CSIClientError, FakeCSIClient
from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs import csi as csi
from _torch_client import port_bridge  # noqa: F401


def wait_for(fn, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def make_volume(vol_id="vol-1", access=csi.ACCESS_MODE_SINGLE_NODE_WRITER,
                **kw):
    return csi.CSIVolume(
        id=vol_id,
        namespace=kw.pop("namespace", "default"),
        name=vol_id,
        external_id=f"ext-{vol_id}",
        plugin_id=kw.pop("plugin_id", "plug-1"),
        requested_capabilities=[
            csi.CSIVolumeCapability(
                access_mode=access,
                attachment_mode=csi.ATTACHMENT_MODE_FS,
            )
        ],
        **kw,
    )


def claim_for(alloc_id, node_id="node-1", mode=csi.CLAIM_WRITE):
    return csi.CSIVolumeClaim(alloc_id=alloc_id, node_id=node_id, mode=mode)


class TestClaimAdmission:
    # csi_test.go TestCSIVolumeClaim

    def test_single_writer_blocks_second_writer(self):
        v = make_volume()
        v.claim(claim_for("a1"))
        assert not v.claimable(csi.CLAIM_WRITE)
        with pytest.raises(ValueError):
            v.claim(claim_for("a2"))

    def test_single_writer_reclaim_idempotent(self):
        v = make_volume()
        v.claim(claim_for("a1"))
        v.claim(claim_for("a1"))
        assert len(v.write_claims) == 1

    def test_multi_writer_allows_many(self):
        v = make_volume(access=csi.ACCESS_MODE_MULTI_NODE_MULTI_WRITER)
        v.claim(claim_for("a1"))
        v.claim(claim_for("a2"))
        assert len(v.write_claims) == 2

    def test_reader_only_volume_rejects_writer(self):
        v = make_volume(access=csi.ACCESS_MODE_MULTI_NODE_READER)
        assert not v.write_schedulable()
        assert v.read_schedulable()

    def test_release_moves_to_past_claims(self):
        v = make_volume()
        v.claim(claim_for("a1"))
        rel = claim_for("a1", mode=csi.CLAIM_RELEASE)
        v.claim(rel)
        assert not v.write_claims
        assert "a1" in v.past_claims
        done = claim_for("a1", mode=csi.CLAIM_RELEASE)
        done.state = csi.CLAIM_STATE_READY_TO_FREE
        v.claim(done)
        assert not v.past_claims

    def test_unschedulable_volume(self):
        v = make_volume(schedulable=False)
        assert not v.claimable(csi.CLAIM_WRITE)
        assert not v.claimable(csi.CLAIM_READ)

    def test_validate(self):
        with pytest.raises(ValueError):
            csi.CSIVolume(id="v", plugin_id="p").validate()


class TestStateStore:
    # state_store CSIVolume table semantics

    def test_register_claim_deregister(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            server.csi_volume_register([make_volume()])
            vol = server.state.csi_volume_by_id("default", "vol-1")
            assert vol is not None and vol.create_index > 0

            server.csi_volume_claim("default", "vol-1", claim_for("a1"))
            vol = server.state.csi_volume_by_id("default", "vol-1")
            assert "a1" in vol.write_claims

            # in-use deregister rejected without force
            with pytest.raises(ValueError):
                server.csi_volume_deregister("default", "vol-1")
            server.csi_volume_deregister("default", "vol-1", force=True)
            assert server.state.csi_volume_by_id("default", "vol-1") is None
        finally:
            server.shutdown()

    def test_reregister_keeps_claims(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            server.csi_volume_register([make_volume()])
            server.csi_volume_claim("default", "vol-1", claim_for("a1"))
            server.csi_volume_register([make_volume()])
            vol = server.state.csi_volume_by_id("default", "vol-1")
            assert "a1" in vol.write_claims
        finally:
            server.shutdown()

    def test_snapshot_restore_roundtrip(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            server.csi_volume_register([make_volume()])
            data = server.state.to_snapshot_bytes()
            server2 = Server(ServerConfig(device="cpu", num_workers=0))
            server2.state.restore_from_bytes(data)
            assert server2.state.csi_volume_by_id("default", "vol-1") is not None
        finally:
            server.shutdown()


class TestPluginsView:
    def test_plugins_from_nodes(self):
        n1 = mock.node()
        n1.csi_node_plugins = {"plug-1": {"healthy": True}}
        n2 = mock.node()
        n2.csi_node_plugins = {"plug-1": {"healthy": False}}
        n2.csi_controller_plugins = {"plug-1": {"healthy": True}}
        plugins = csi.plugins_from_nodes([n1, n2])
        p = plugins["plug-1"]
        assert p.nodes_healthy == 1
        assert len(p.nodes) == 2
        assert p.controller_required
        assert p.controllers_healthy == 1


class TestVolumeWatcher:
    # volumes_watcher_test.go: terminal alloc -> claims reaped

    def test_reaps_terminal_alloc_claims(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            fake = FakeCSIClient()
            server.csi_clients["plug-1"] = fake
            node = mock.node()
            node.csi_node_plugins = {"plug-1": {"healthy": True}}
            node.csi_controller_plugins = {"plug-1": {"healthy": True}}
            server.node_register(node)

            server.csi_volume_register([make_volume()])
            job = mock.job()
            alloc = mock.alloc(job=job, node_id=node.id)
            server.state.upsert_allocs([alloc])
            server.csi_volume_claim(
                "default", "vol-1", claim_for(alloc.id, node_id=node.id)
            )
            # controller-publish happened on claim
            assert ("ext-vol-1", node.id) in fake.controller_published

            # alloc goes terminal -> watcher releases and unpublishes
            term = alloc.copy()
            term.client_status = consts.ALLOC_CLIENT_COMPLETE
            term.desired_status = consts.ALLOC_DESIRED_STOP
            server.state.upsert_allocs([term])

            def freed():
                vol = server.state.csi_volume_by_id("default", "vol-1")
                return not vol.in_use() and not vol.past_claims
            wait_for(freed, msg="claims freed")
            assert not fake.controller_published
        finally:
            server.shutdown()

    def test_node_unpublish_error_retries(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            fake = FakeCSIClient()
            fake.fail["node_unpublish_volume"] = "socket gone"
            server.csi_clients["plug-1"] = fake
            server.csi_volume_register([make_volume()])
            c = claim_for("a1")
            c.target_path = "/data/csi/per-alloc/a1/vol-1"
            server.csi_volume_claim("default", "vol-1", c)
            # alloc a1 does not exist -> treated terminal -> release
            wait_for(
                lambda: server.state.csi_volume_by_id(
                    "default", "vol-1").past_claims,
                msg="claim released",
            )
            # stuck in taken because node unpublish keeps failing
            time.sleep(0.3)
            vol = server.state.csi_volume_by_id("default", "vol-1")
            assert vol.past_claims["a1"].state == csi.CLAIM_STATE_TAKEN
            # plugin recovers -> watcher finishes the pipeline
            del fake.fail["node_unpublish_volume"]
            wait_for(
                lambda: not server.state.csi_volume_by_id(
                    "default", "vol-1").past_claims,
                msg="claim freed after recovery",
            )
        finally:
            server.shutdown()


class TestFeasibility:
    # feasible_test.go TestCSIVolumeChecker

    def _snap_with_volume(self, server, access):
        server.csi_volume_register([make_volume(access=access)])
        return server.state.snapshot()

    def test_node_without_plugin_infeasible(self):
        from nomad_tpu_torch.scheduler.feasible import csi_ok

        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            snap = self._snap_with_volume(
                server, csi.ACCESS_MODE_SINGLE_NODE_WRITER
            )
            tg = structs.TaskGroup(name="web", volumes={
                "v": structs.VolumeRequest(name="v", type="csi",
                                           source="vol-1"),
            })
            n_plug = mock.node()
            n_plug.csi_node_plugins = {"plug-1": {"healthy": True}}
            n_unhealthy = mock.node()
            n_unhealthy.csi_node_plugins = {"plug-1": {"healthy": False}}
            n_none = mock.node()
            assert csi_ok(n_plug, tg, snap, "default")
            assert not csi_ok(n_unhealthy, tg, snap, "default")
            assert not csi_ok(n_none, tg, snap, "default")
        finally:
            server.shutdown()

    def test_claimed_single_writer_infeasible(self):
        from nomad_tpu_torch.scheduler.feasible import csi_ok

        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            snap = self._snap_with_volume(
                server, csi.ACCESS_MODE_SINGLE_NODE_WRITER
            )
            server.csi_volume_claim("default", "vol-1", claim_for("other"))
            snap = server.state.snapshot()
            tg = structs.TaskGroup(name="web", volumes={
                "v": structs.VolumeRequest(name="v", type="csi",
                                           source="vol-1"),
            })
            node = mock.node()
            node.csi_node_plugins = {"plug-1": {"healthy": True}}
            assert not csi_ok(node, tg, snap, "default")
            # read-only ask on the same volume also fails (single-node
            # writer volume with an active writer has no free reads)
            tg.volumes["v"].read_only = True
            assert not csi_ok(node, tg, snap, "default")
        finally:
            server.shutdown()


class TestHTTP:
    def _agent(self):
        from nomad_tpu_torch.api.agent import Agent, AgentConfig

        agent = Agent(AgentConfig(device="cpu", num_schedulers=0))
        agent.start()
        return agent

    def test_volume_lifecycle_over_http(self):
        from nomad_tpu_torch.api.client import APIClient, APIError

        agent = self._agent()
        try:
            api = APIClient(agent.http.addr)
            api.csi_volumes.register({
                "ID": "vol-http", "Name": "vol-http", "PluginID": "plug-1",
                "ExternalID": "ext-1",
                "RequestedCapabilities": [{
                    "AccessMode": csi.ACCESS_MODE_MULTI_NODE_READER,
                    "AttachmentMode": csi.ATTACHMENT_MODE_FS,
                }],
            })
            vols = api.csi_volumes.list()
            assert [v["ID"] for v in vols] == ["vol-http"]
            info = api.csi_volumes.info("vol-http")
            assert info["PluginID"] == "plug-1"
            assert api.csi_volumes.list(plugin_id="nope") == []
            assert len(api.csi_volumes.list(plugin_id="plug-1")) == 1
            api.csi_volumes.deregister("vol-http")
            with pytest.raises(APIError):
                api.csi_volumes.info("vol-http")
        finally:
            agent.shutdown()

    def test_volume_get_redacts_secrets(self):
        from nomad_tpu_torch.api.client import APIClient

        agent = self._agent()
        try:
            vol = make_volume("vol-sec")
            vol.secrets = {"password": "hunter2"}
            agent.server.csi_volume_register([vol])
            api = APIClient(agent.http.addr)
            info = api.csi_volumes.info("vol-sec")
            assert info["Secrets"] == {"password": "[REDACTED]"}
            # the stored volume keeps the real secret
            assert agent.server.state.csi_volume_by_id(
                "default", "vol-sec").secrets["password"] == "hunter2"
        finally:
            agent.shutdown()

    def test_volume_register_requires_capability(self):
        from nomad_tpu_torch.api.client import APIClient, APIError

        agent = self._agent()
        try:
            api = APIClient(agent.http.addr)
            with pytest.raises(APIError):
                api.csi_volumes.register({"ID": "bad", "PluginID": "p"})
        finally:
            agent.shutdown()

    def test_plugins_view_over_http(self):
        from nomad_tpu_torch.api.client import APIClient

        agent = self._agent()
        try:
            node = mock.node()
            node.csi_node_plugins = {"plug-9": {"healthy": True}}
            agent.server.node_register(node)
            api = APIClient(agent.http.addr)
            plugins = api.csi_plugins.list()
            assert [p["ID"] for p in plugins] == ["plug-9"]
            assert api.csi_plugins.info("plug-9")["NodesHealthy"] == 1
        finally:
            agent.shutdown()

    def test_detach_releases_claims(self):
        from nomad_tpu_torch.api.client import APIClient

        agent = self._agent()
        try:
            server = agent.server
            server.csi_volume_register([make_volume()])
            server.csi_volume_claim(
                "default", "vol-1", claim_for("a1", node_id="n-9")
            )
            api = APIClient(agent.http.addr)
            api.csi_volumes.detach("vol-1", node_id="n-9")
            wait_for(
                lambda: not server.state.csi_volume_by_id(
                    "default", "vol-1").in_use(),
                msg="detached",
            )
        finally:
            agent.shutdown()


class TestEndToEnd:
    def test_job_with_csi_volume_mounts_and_releases(self, tmp_path):
        """Full slice: volume registered, job placed only on the node
        with the plugin, client stages+publishes, stop releases."""
        server = Server(ServerConfig(device="cpu", heartbeat_ttl=60.0))
        server.start()
        fake = FakeCSIClient()
        server.csi_clients["plug-1"] = fake
        client = None
        try:
            server.csi_volume_register([make_volume()])
            client = Client(
                InProcessRPC(server),
                ClientConfig(data_dir=str(tmp_path)),
                csi_clients={"plug-1": fake},
            )
            client.start()
            wait_for(
                lambda: any(n.ready() for n in server.state.snapshot().nodes()),
                msg="node ready",
            )

            job = mock.job()
            job.task_groups[0].count = 1
            job.task_groups[0].volumes = {
                "data": structs.VolumeRequest(
                    name="data", type="csi", source="vol-1",
                    access_mode=csi.ACCESS_MODE_SINGLE_NODE_WRITER,
                    attachment_mode=csi.ATTACHMENT_MODE_FS,
                ),
            }
            job.task_groups[0].tasks[0].driver = "mock_driver"
            job.task_groups[0].tasks[0].config = {"run_for": 30}
            server.job_register(job)

            def claimed():
                vol = server.state.csi_volume_by_id("default", "vol-1")
                return vol.in_use()
            wait_for(claimed, msg="volume claimed")
            assert fake.node_staged and fake.node_published
            # the claim carries the node's real publish paths so the
            # server-side unpublish can replay them
            vol = server.state.csi_volume_by_id("default", "vol-1")
            claim = next(iter(vol.write_claims.values()))
            assert claim.target_path.endswith("/vol-1")
            # tasks see the mount path via env
            ar = next(iter(client.allocs.values()))
            tr = next(iter(ar.task_runners.values()))
            assert tr.extra_env.get("NOMAD_ALLOC_VOLUME_DATA") == \
                claim.target_path

            # stop the job: alloc terminal -> watcher frees the claim
            server.job_deregister("default", job.id)

            def freed():
                vol = server.state.csi_volume_by_id("default", "vol-1")
                return not vol.in_use() and not vol.past_claims
            wait_for(freed, msg="volume freed")
            # the watcher unpublished the node's actual target path
            wait_for(lambda: not fake.node_published,
                     msg="node target unpublished")
        finally:
            if client is not None:
                client.shutdown()
            server.shutdown()
