"""Every scenario of ``tests/test_artifacts.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Artifact fetching (getter.py + the task-runner prestart hook).

Reference: client/allocrunner/taskrunner/artifact_hook.go,
getter/getter.go. HTTP sources are served by a local stdlib server
(the environment has no egress); git sources clone a local repo.
"""

import hashlib
import http.server
import os
import subprocess
import tarfile
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.client.getter import ArtifactError, fetch_artifact
from _torch_client import port_bridge  # noqa: F401


@pytest.fixture()
def http_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifacts")
    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(root), **kw)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield root, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


class TestFetchArtifact:
    def test_http_download_with_checksum(self, http_root, tmp_path):
        root, base = http_root
        (root / "tool.txt").write_bytes(b"#!/bin/sh\necho tool\n")
        digest = hashlib.sha256(b"#!/bin/sh\necho tool\n").hexdigest()
        dest = fetch_artifact(
            {"source": f"{base}/tool.txt",
             "options": {"checksum": f"sha256:{digest}"}},
            str(tmp_path),
        )
        assert open(os.path.join(dest, "tool.txt")).read().startswith("#!")

    def test_checksum_mismatch_removes_file(self, http_root, tmp_path):
        root, base = http_root
        (root / "bad.bin").write_bytes(b"payload")
        with pytest.raises(ArtifactError, match="checksum mismatch"):
            fetch_artifact(
                {"source": f"{base}/bad.bin",
                 "options": {"checksum": "sha256:" + "0" * 64}},
                str(tmp_path),
            )
        assert not os.path.exists(tmp_path / "local" / "bad.bin")

    def test_archive_auto_unpacks(self, http_root, tmp_path):
        root, base = http_root
        pkg = root / "pkg"
        pkg.mkdir()
        (pkg / "bin.sh").write_text("echo packaged\n")
        with tarfile.open(root / "pkg.tar.gz", "w:gz") as t:
            t.add(str(pkg / "bin.sh"), arcname="bin.sh")
        dest = fetch_artifact(
            {"source": f"{base}/pkg.tar.gz", "destination": "local/pkg"},
            str(tmp_path),
        )
        assert open(os.path.join(dest, "bin.sh")).read() == "echo packaged\n"
        assert not os.path.exists(os.path.join(dest, "pkg.tar.gz"))

    def test_git_clone(self, tmp_path):
        repo = tmp_path / "srcrepo"
        repo.mkdir()
        subprocess.run(["git", "init", "-q"], cwd=repo, check=True)
        (repo / "hello.txt").write_text("from-git\n")
        subprocess.run(["git", "add", "."], cwd=repo, check=True)
        subprocess.run(
            ["git", "-c", "user.email=t@t", "-c", "user.name=t",
             "commit", "-qm", "init"], cwd=repo, check=True)
        task_dir = tmp_path / "task"
        task_dir.mkdir()
        dest = fetch_artifact(
            {"source": f"git::file://{repo}", "destination": "local/repo"},
            str(task_dir),
        )
        assert open(os.path.join(dest, "hello.txt")).read() == "from-git\n"

    def test_destination_escape_rejected(self, tmp_path):
        with pytest.raises(ArtifactError, match="escapes"):
            fetch_artifact(
                {"source": "/etc/hostname", "destination": "../../escape"},
                str(tmp_path),
            )


class TestArtifactHookEndToEnd:
    def test_job_binary_arrives_via_artifact(self, http_root):
        """A job whose executable arrives via an artifact block runs it
        (artifact_hook.go end-to-end)."""
        root, base = http_root
        (root / "runme.sh").write_text("#!/bin/sh\necho artifact-ran\n")
        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            api = APIClient(agent.http_addr)
            job = mock.job()
            job.task_groups[0].count = 1
            task = job.task_groups[0].tasks[0]
            task.driver = "raw_exec"
            task.artifacts = [{"source": f"{base}/runme.sh"}]
            task.config = {"command": "/bin/sh",
                           "args": ["-c",
                                    "sh $NOMAD_TASK_DIR/runme.sh; sleep 30"]}
            agent.server.job_register(job)
            deadline = time.time() + 20
            logged = ""
            while time.time() < deadline:
                allocs = api.jobs.allocations(job.id)
                running = [a for a in allocs
                           if a["ClientStatus"] == "running"]
                if running:
                    logged = api.allocations.logs(running[0]["ID"], "web")
                    if "artifact-ran" in logged:
                        break
                time.sleep(0.2)
            assert "artifact-ran" in logged
        finally:
            agent.shutdown()

    def test_failed_download_fails_task_setup(self):
        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            api = APIClient(agent.http_addr)
            job = mock.job()
            job.task_groups[0].count = 1
            job.task_groups[0].restart_policy.attempts = 0
            task = job.task_groups[0].tasks[0]
            task.driver = "raw_exec"
            task.artifacts = [
                {"source": "http://127.0.0.1:1/never-there.bin"}]
            task.config = {"command": "/bin/true"}
            agent.server.job_register(job)
            deadline = time.time() + 25
            saw_event = False
            while time.time() < deadline and not saw_event:
                for a in api.jobs.allocations(job.id):
                    info = api.allocations.info(a["ID"])
                    events = (info.get("TaskStates", {})
                              .get("web", {}).get("Events", []))
                    if any("Failed Artifact Download" in
                           str(e.get("DisplayMessage", "")) +
                           str(e.get("Message", "")) for e in events):
                        saw_event = True
                time.sleep(0.3)
            assert saw_event, "no Failed Artifact Download event"
        finally:
            agent.shutdown()
