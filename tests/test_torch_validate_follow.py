"""Every scenario of ``tests/test_validate_follow.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Job validation + follow-mode log streaming tests.

Modeled on reference nomad/job_endpoint_test.go Validate coverage and
client fs_endpoint follow-logs tests.
"""

import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.api.codec import encode
from nomad_tpu_torch.structs import consts
from _torch_client import port_bridge  # noqa: F401


@pytest.fixture(scope="module")
def agent(tmp_path_factory):
    a = Agent(AgentConfig(device="cpu", name="vf-agent", num_schedulers=1,
                          client_enabled=True))
    a.client.config.data_dir = str(tmp_path_factory.mktemp("client"))
    a.start()
    yield a
    a.shutdown()


@pytest.fixture(scope="module")
def api(agent):
    return APIClient(agent.http_addr)


class TestJobValidate:
    def test_struct_validate(self):
        job = mock.job()
        assert job.validate() == []
        job.priority = 0
        job.task_groups[0].name = ""
        errs = job.validate()
        assert any("priority" in e for e in errs)
        assert any("missing name" in e for e in errs)

    def test_duplicate_groups_and_tasks(self):
        job = mock.job()
        job.task_groups.append(job.task_groups[0].copy())
        errs = job.validate()
        assert any("duplicate task group" in e for e in errs)

    def test_validate_null_fields_report_not_crash(self, api):
        """Arbitrary payloads must produce validation results, not
        500s (null Resources / TaskGroups)."""
        res = api.put("/v1/validate/job", {"Job": {
            "ID": "x", "Name": "x", "Datacenters": ["dc1"],
            "TaskGroups": [{"Name": "g", "Tasks": [
                {"Name": "t", "Driver": "exec", "Resources": None}]}],
        }})
        assert res["ValidationErrors"] == []
        res2 = api.put("/v1/validate/job", {"Job": {
            "ID": "x", "Name": "x", "TaskGroups": None}})
        assert any("task groups" in e for e in res2["ValidationErrors"])

    def test_validate_endpoint(self, api):
        res = api.put("/v1/validate/job", {"Job": encode(mock.job())})
        assert res["ValidationErrors"] == []
        bad = mock.job()
        bad.type = "cron"
        res = api.put("/v1/validate/job", {"Job": encode(bad)})
        assert any("invalid job type" in e
                   for e in res["ValidationErrors"])
        assert res["Error"]

    def test_register_rejects_invalid(self, api):
        bad = mock.job()
        bad.datacenters = []
        from nomad_tpu_torch.api.client import APIError
        with pytest.raises(APIError):
            api.jobs.register(encode(bad))


class TestFollowLogs:
    def test_follow_streams_live_output(self, agent, api):
        job = mock.job()
        job.type = consts.JOB_TYPE_BATCH
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "raw_exec"
        task.config = {
            "command": "/bin/sh",
            "args": ["-c",
                     "echo first; sleep 1.2; echo second; sleep 0.3"],
        }
        api.jobs.register(encode(job))
        deadline = time.time() + 60
        alloc_id = ""
        while time.time() < deadline and not alloc_id:
            allocs = api.get(f"/v1/job/{job.id}/allocations")
            running = [a for a in allocs
                       if a["ClientStatus"] in ("running", "complete")]
            if running:
                alloc_id = running[0]["ID"]
            time.sleep(0.2)
        assert alloc_id, "alloc never started"

        chunks = []
        got_first = threading.Event()

        def consume():
            for chunk in api.allocations.logs_follow(
                    alloc_id, task.name, "stdout", timeout=60):
                chunks.append((time.time(), chunk.decode()))
                if b"first" in chunk:
                    got_first.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        assert got_first.wait(timeout=30), "first line never streamed"
        t.join(timeout=30)
        assert not t.is_alive(), "follow stream didn't end with the task"
        text = "".join(c for _, c in chunks)
        assert "first" in text and "second" in text
        # 'second' must have arrived in a later chunk than 'first'
        # (live tail, not one buffered read)
        first_t = next(ts for ts, c in chunks if "first" in c)
        second_t = next(ts for ts, c in chunks if "second" in c)
        assert second_t > first_t
