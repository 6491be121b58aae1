"""Every scenario of ``tests/test_ui.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Web UI serving tests.

The reference serves its Ember app at /ui (command/agent/http.go:318
UIEnabled handler); ours serves a single-file SPA. These tests cover
the HTTP wiring — redirect, catch-all document serving, and the
?resources=true stub extension the topology view uses.
"""

import time
import urllib.request

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.api.codec import encode
from _torch_client import port_bridge  # noqa: F401


@pytest.fixture(scope="module")
def agent():
    a = Agent(AgentConfig(device="cpu",
                          name="ui-test-agent", num_schedulers=1))
    a.start()
    for _ in range(3):
        a.server.node_register(mock.node())
    yield a
    a.shutdown()


@pytest.fixture(scope="module")
def api(agent):
    return APIClient(agent.http_addr)


def _get(agent, path):
    req = urllib.request.Request(agent.http_addr + path)
    return urllib.request.urlopen(req, timeout=10)


class TestUIServing:
    def test_root_redirects_to_ui(self, agent):
        # urllib follows the 307; the final body is the app document
        resp = _get(agent, "/")
        assert resp.status == 200
        assert resp.url.endswith("/ui/")

    def test_ui_serves_app(self, agent):
        body = _get(agent, "/ui/").read().decode()
        assert "nomad-tpu" in body
        # the app module is extracted but served with the document
        assert '<script src="/ui/app.js">' in body
        js = _get(agent, "/ui/app.js").read().decode()
        # every app section is routable
        for view in ("#/jobs", "#/clients", "#/allocations",
                     "#/evaluations", "#/deployments", "#/topology",
                     "#/servers", "#/settings"):
            assert view in body or view in js

    def test_ui_catchall_paths_serve_same_doc(self, agent):
        a = _get(agent, "/ui/").read()
        b = _get(agent, "/ui/jobs/some-job").read()
        assert a == b
        assert _get(agent, "/ui").read() == a

    def test_content_type_is_html(self, agent):
        resp = _get(agent, "/ui/")
        assert resp.headers["Content-Type"].startswith("text/html")


class TestAllocStubResources:
    def test_resources_param_adds_allocated(self, agent, api):
        job = mock.job()
        api.jobs.register(encode(job))
        deadline = time.time() + 30
        while time.time() < deadline:
            allocs = api.get("/v1/allocations?resources=true")
            if allocs:
                break
            time.sleep(0.2)
        assert allocs, "no allocations placed"
        res = allocs[0]["AllocatedResources"]
        assert res["CPU"] > 0 and res["MemoryMB"] > 0
        # default stub stays lean
        lean = api.get("/v1/allocations")
        assert "AllocatedResources" not in lean[0]

    def test_node_stub_resources(self, api):
        nodes = api.get("/v1/nodes?resources=true")
        assert nodes and nodes[0]["NodeResources"]["CPU"] > 0
        assert nodes[0]["NodeResources"]["MemoryMB"] > 0
        assert "NodeResources" not in api.get("/v1/nodes")[0]


class TestUIExecTerminal:
    """The exec terminal's code path: the UI builds
    /v1/client/allocation/<id>/exec?task&tty&command&x_nomad_token and
    speaks the JSON-frame protocol over a websocket. This drives the
    EXACT request shape the SPA constructs (viewExec)."""

    def test_ui_document_has_exec_view_and_event_stream(self, agent):
        body = _get(agent, "/ui/app.js").read().decode()
        assert "viewExec" in body
        assert "/exec/" in body
        assert "startEventStream" in body
        assert "/v1/event/stream" in body
        assert "x_nomad_token" in body

    def test_exec_websocket_via_ui_url_shape(self):
        import base64
        import json as _json
        import urllib.parse

        from nomad_tpu_torch.utils import ws as wslib

        # a dev agent: the exec session needs a real client + driver
        agent = Agent(AgentConfig.dev(device="cpu", name="ui-exec-agent"))
        agent.start()
        try:
            self._drive_exec(agent, base64, _json, urllib.parse, wslib)
        finally:
            agent.shutdown()

    def _drive_exec(self, agent, base64, _json, urlparse, wslib):
        job = mock.job()
        job.constraints = []
        tg = job.task_groups[0]
        tg.count = 1
        task = tg.tasks[0]
        task.driver = "raw_exec"
        task.config = {"command": "/bin/sh",
                       "args": ["-c", "sleep 120"]}
        agent.server.job_register(job)
        deadline = time.time() + 30
        alloc = None
        while time.time() < deadline:
            allocs = agent.server.state.snapshot().allocs_by_job(
                job.namespace, job.id)
            alloc = next((a for a in allocs
                          if a.client_status == "running"), None)
            if alloc:
                break
            time.sleep(0.2)
        assert alloc is not None, "task never ran"

        # the SPA's URL shape: query-string token + JSON command
        qs = urlparse.urlencode({
            "task": task.name, "tty": "false",
            "command": _json.dumps(["/bin/sh"]),
            "x_nomad_token": "",
        })
        url = (f"{agent.http_addr}/v1/client/allocation/"
               f"{alloc.id}/exec?{qs}")
        conn = wslib.connect(url)
        try:
            line = b"echo ui-exec-$((40+2))\n"
            conn.send(_json.dumps(
                {"stdin": {"data":
                           base64.b64encode(line).decode()}}).encode())
            got = b""
            deadline = time.time() + 20
            while b"ui-exec-42" not in got and time.time() < deadline:
                op, data = conn.recv()
                if op == wslib.OP_TEXT:
                    frame = _json.loads(data)
                    for k in ("stdout", "stderr"):
                        d = (frame.get(k) or {}).get("data")
                        if d:
                            got += base64.b64decode(d)
            assert b"ui-exec-42" in got
        finally:
            conn.close()


class TestUIHarness:
    """Mirage-analog harness: a seeded dev cluster behind the real /v1
    surface, driven through the SPA's exact request contract (no JS
    runtime ships in this environment; the click path exercises every
    call each view makes and the fields it consumes)."""

    def test_clicks_job_to_alloc_to_logs_and_files(self):
        from nomad_tpu_torch.api.agent import Agent, AgentConfig
        from nomad_tpu_torch.ui.harness import UIClient, seed_cluster

        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            seeded = seed_cluster(agent, n_service_jobs=1)
            ui = UIClient(agent.http.addr)

            # jobs list -> the seeded job row with the fields the
            # table renders
            jobs = ui.click_jobs()
            row = next(j for j in jobs if j["ID"] == "ui-seed-0")
            assert row["Status"] and row["Type"]

            # job detail fan-out -> an allocation id
            detail = ui.click_job("ui-seed-0")
            assert detail["job"]["ID"] == "ui-seed-0"
            assert detail["allocs"], "job detail shows no allocations"
            alloc_id = detail["allocs"][0]["ID"]

            # alloc detail -> task states the view renders
            a = ui.click_alloc(alloc_id)
            assert a["ClientStatus"] == "running"
            task = next(iter(a["TaskStates"]))

            # logs view -> the task's real output
            deadline = time.time() + 20
            logs = ""
            while time.time() < deadline and "ui-harness-line" not in logs:
                logs = ui.click_logs(alloc_id, task)
                time.sleep(0.2)
            assert "ui-harness-line" in logs

            # fs browser -> walk to the log file (alloc/logs, the
            # reference layout) and read it back
            entries = ui.click_fs(alloc_id, "/")
            shared = next(e for e in entries if e["Name"] == "alloc")
            assert shared["IsDir"]
            files = ui.click_fs(alloc_id, "/alloc/logs")
            logfile = next(e for e in files
                           if e["Name"].endswith(".stdout.0"))
            got = ui.click_file(alloc_id,
                                f"/alloc/logs/{logfile['Name']}")
            assert "ui-harness-line" in got["Data"]
        finally:
            agent.shutdown()

    def test_every_spa_api_reference_has_a_route(self, agent):
        """A renamed endpoint must fail THIS test, not silently 404 in
        the browser (the contract half of the Mirage analog)."""
        import os

        from nomad_tpu_torch.ui.harness import unrouted_paths

        app_js = open(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "nomad_tpu_torch", "ui", "app.js")).read()
        missing = unrouted_paths(app_js, agent.http)
        assert missing == [], f"SPA references unrouted paths: {missing}"

    def test_app_js_served_and_referenced(self, agent):
        import urllib.request

        doc = urllib.request.urlopen(
            agent.http.addr + "/ui/").read().decode()
        assert '<script src="/ui/app.js">' in doc
        js = urllib.request.urlopen(
            agent.http.addr + "/ui/app.js").read().decode()
        assert "viewAllocFs" in js and "viewAllocLogs" in js
        assert "/v1/client/fs/ls" in js

    def test_app_js_is_structurally_valid(self):
        """One syntax error aborts the whole SPA module; with no JS
        runtime in this environment, the structural lint is the
        backstop for the bricking error class (unbalanced brackets,
        unterminated strings/templates)."""
        import os

        from nomad_tpu_torch.ui.harness import lint_js

        src = open(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "nomad_tpu_torch", "ui", "app.js")).read()
        assert lint_js(src) == []
        # the linter itself catches what it claims to catch
        assert lint_js("function f() { return `${x`; }")
        assert lint_js("const a = (1, [2, 3);")
        assert lint_js("const s = 'oops\nmore';")
        assert lint_js("/* never closed")


class TestViewContract:
    """The machine-checked view contract: app.js embeds
    a route -> endpoint -> field manifest; the harness (a) cross-checks
    every PascalCase field read in each view against the manifest and
    (b) walks every declared field path against the REAL seeded API.
    Together: a view cannot read a field the API does not return
    without one of these tests failing — the executable equivalent of
    running the SPA against reference Mirage (ui/mirage/config.js)."""

    @staticmethod
    def _app_js():
        import os

        return open(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "nomad_tpu_torch", "ui", "app.js")).read()

    def test_contract_parses_and_covers_every_routed_view(self):
        import re

        from nomad_tpu_torch.ui.harness import extract_view_contract

        src = self._app_js()
        contract = extract_view_contract(src)
        assert "helpers" in contract
        # every view the router dispatches to has a contract entry
        # (viewExec drives a websocket, exempt by design)
        routed = set(re.findall(r"\bview\w+", src.split("const routes")[1]))
        missing = sorted(routed - set(contract) - {"viewExec"})
        assert missing == [], f"routed views missing a contract: {missing}"

    def test_every_field_read_is_declared(self):
        from nomad_tpu_torch.ui.harness import undeclared_field_reads

        extra = undeclared_field_reads(self._app_js())
        assert extra == {}, (
            f"views read API fields the contract never walks: {extra}")

    def test_contract_walks_clean_against_a_seeded_cluster(self):
        import time

        from nomad_tpu_torch import mock
        from nomad_tpu_torch.api.agent import Agent, AgentConfig
        from nomad_tpu_torch.structs import csi
        from nomad_tpu_torch.ui.harness import (
            UIClient, extract_view_contract, seed_cluster,
            walk_view_contract,
        )

        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            seeded = seed_cluster(agent, n_service_jobs=1)
            server = agent.server
            # CSI seeds: a fingerprinting node + a registered volume
            n = mock.node()
            n.csi_node_plugins = {"plug-ui": {"provider": "ui.csi",
                                              "version": "1.0",
                                              "healthy": True}}
            n.csi_controller_plugins = {"plug-ui": {"provider": "ui.csi",
                                                    "version": "1.0",
                                                    "healthy": True}}
            server.node_register(n)
            vol = csi.CSIVolume(
                id="ui-vol", namespace="default", name="ui-vol",
                external_id="ext-ui-vol", plugin_id="plug-ui",
                requested_capabilities=[csi.CSIVolumeCapability(
                    access_mode=csi.ACCESS_MODE_SINGLE_NODE_WRITER,
                    attachment_mode=csi.ATTACHMENT_MODE_FS)],
            )
            server.csi_volume_register([vol])
            # ACL seed: a policy + token the ACL views render
            from nomad_tpu_torch.acl.policy import ACLPolicy, ACLToken
            server.state.upsert_acl_policy(ACLPolicy(
                name="ui-policy", description="ui harness seed",
                rules='namespace "default" { policy = "read" }'))
            server.state.upsert_acl_token(ACLToken.create(
                name="ui-token", type="client",
                policies=["ui-policy"]))

            alloc0 = seeded["allocs"][0]
            # a native service registration (services views)
            from nomad_tpu_torch.structs.services import ServiceRegistration
            server.service_register([ServiceRegistration(
                id="ui-svc-1", service_name="web", namespace="default",
                node_id=alloc0.node_id, job_id=seeded["jobs"][0].id,
                alloc_id=alloc0.id, address="127.0.0.1", port=8080,
                tags=["ui"])])
            # a deployment row (deployments views): service job with an
            # update strategy
            dj = mock.job(id="ui-deploy-job")
            dj.type = "service"
            dj.task_groups[0].count = 1
            dj.task_groups[0].tasks[0].driver = "mock_driver"
            from nomad_tpu_torch.structs.job import UpdateStrategy
            dj.task_groups[0].update = UpdateStrategy(
                max_parallel=1, min_healthy_time_s=0.1,
                healthy_deadline_s=30, progress_deadline_s=600)
            server.job_register(dj)
            deadline = time.time() + 30
            while time.time() < deadline:
                if server.state.snapshot().latest_deployment_by_job_id(
                        "default", "ui-deploy-job") is not None:
                    break
                time.sleep(0.2)

            alloc = seeded["allocs"][0]
            job = seeded["jobs"][0]
            # a log file the fs/stat walk can stat
            deadline = time.time() + 20
            ui = UIClient(agent.http.addr)
            logfile = None
            while time.time() < deadline and logfile is None:
                try:
                    files = ui.click_fs(alloc.id, "/alloc/logs")
                    logfile = next(
                        (e["Name"] for e in files
                         if e["Name"].endswith(".stdout.0")), None)
                except Exception:                # noqa: BLE001
                    pass
                if logfile is None:
                    time.sleep(0.3)
            assert logfile, "no rotated log file appeared"

            params = {
                # the deployment-bearing job exercises the full job
                # detail fan-out (deployments included)
                "job": "ui-deploy-job",
                "node": alloc.node_id,
                "alloc": alloc.id,
                "volume": "ui-vol",
                "plugin": "plug-ui",
                "policy": "ui-policy",
                "service": "web",
                "task": next(iter(alloc.task_states or {"web": 1})),
                "file": f"/alloc/logs/{logfile}",
            }
            contract = extract_view_contract(self._app_js())
            failures = walk_view_contract(ui, contract, params)
            assert failures == [], "\n".join(failures)
        finally:
            agent.shutdown()
