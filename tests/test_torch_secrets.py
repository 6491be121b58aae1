"""Every scenario of ``tests/test_secrets.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Consul/Vault integration tests.

Modeled on reference nomad/vault_test.go (derivation, renewal,
revocation) and client/allocrunner/taskrunner/template/template_test.go
(render functions, change modes).
"""

import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC
from nomad_tpu_torch.client.template import (
    TemplateContext,
    TemplateWatcher,
    render,
    uses_live_data,
)
from nomad_tpu_torch.server.secrets import (
    DevConsulProvider,
    DevVaultProvider,
    VaultManager,
)
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.job import Template, Vault
from _torch_client import port_bridge  # noqa: F401


class TestDevVaultProvider:
    def test_token_lifecycle(self):
        v = DevVaultProvider()
        info = v.create_token(["web-policy"], ttl_s=60)
        assert info.token.startswith("s.")
        assert v.token_valid(info.token)
        assert v.lookup(info.accessor).policies == ["web-policy"]
        old_expiry = info.expires_at
        time.sleep(0.01)
        assert v.renew(info.accessor) >= old_expiry
        v.revoke(info.accessor)
        assert not v.token_valid(info.token)
        with pytest.raises(KeyError):
            v.renew(info.accessor)

    def test_secret_kv(self):
        v = DevVaultProvider()
        v.write_secret("secret/db", {"password": "hunter2"})
        assert v.read_secret("secret/db")["password"] == "hunter2"
        assert v.read_secret("secret/missing") is None

    def test_secrets_index_bumps_on_write(self):
        v = DevVaultProvider()
        i0 = v.secrets_index()
        v.write_secret("a", {"x": "1"})
        assert v.secrets_index() > i0

    def test_policy_enforcement(self):
        v = DevVaultProvider()
        v.write_secret("secret/db", {"password": "pw"})
        v.write_secret("secret/admin", {"root": "rw"})
        v.set_policy("db-read", ["secret/db"])
        tok = v.create_token(["db-read"], ttl_s=60).token
        assert v.read_secret("secret/db", token=tok)["password"] == "pw"
        with pytest.raises(PermissionError):
            v.read_secret("secret/admin", token=tok)
        with pytest.raises(PermissionError):
            v.read_secret("secret/db", token="bogus")

    def test_dev_mode_no_policies_allows_all(self):
        v = DevVaultProvider()
        v.write_secret("secret/x", {"k": "v"})
        # no policy docs configured -> dev root behavior
        assert v.read_secret("secret/x", token="")["k"] == "v"


class TestVaultManager:
    def test_derive_and_revoke_per_alloc(self):
        m = VaultManager()
        tokens = m.derive_tokens("alloc-1", {"web": ["p1"], "db": ["p2"]})
        assert set(tokens) == {"web", "db"}
        assert len(m.accessors_for_alloc("alloc-1")) == 2
        assert m.revoke_for_alloc("alloc-1") == 2
        assert m.accessors_for_alloc("alloc-1") == {}
        for info in tokens.values():
            assert not m.provider.token_valid(info.token)

    def test_renew_loop_extends_leases(self):
        m = VaultManager(renew_interval_s=0.05)
        info = m.derive_tokens("a", {"t": []})["t"]
        first_expiry = m.provider.lookup(info.accessor).expires_at
        m.start()
        try:
            time.sleep(0.2)
            assert m.provider.lookup(info.accessor).expires_at > first_expiry
        finally:
            m.stop()

    def test_revoke_all_on_restore(self):
        m = VaultManager()
        m.derive_tokens("a1", {"t": []})
        m.derive_tokens("a2", {"t": []})
        assert m.revoke_all() == 2


class TestConsulKV:
    def test_kv_index_monotonic(self):
        c = DevConsulProvider()
        i1 = c.kv_put("app/config", "v1")
        i2 = c.kv_put("app/config", "v2")
        assert i2 > i1
        assert c.kv_get("app/config") == "v2"
        assert c.kv_index() == i2

    def test_si_token_stable_per_task(self):
        c = DevConsulProvider()
        t1 = c.derive_si_token("a", "web", "svc")
        assert c.derive_si_token("a", "web", "svc") == t1
        assert c.derive_si_token("a", "db", "svc") != t1


class TestTemplateRender:
    def test_all_functions(self):
        ctx = TemplateContext(
            env={"PORT": "8080"},
            meta={"team": "infra"},
            node_attrs={"arch": "x86"},
            kv_get={"app/name": "web"}.get,
            secret_get={"secret/db": {"password": "pw"}}.get,
        )
        out = render(
            'name={{ key "app/name" }} port={{ env "PORT" }} '
            'team={{ meta "team" }} arch={{ node_attr "arch" }} '
            'pw={{ secret "secret/db" "password" }} '
            'miss={{ keyOrDefault "nope" "fallback" }}',
            ctx,
        )
        assert out == ("name=web port=8080 team=infra arch=x86 "
                       "pw=pw miss=fallback")

    def test_missing_renders_empty(self):
        assert render('x={{ key "none" }}', TemplateContext()) == "x="

    def test_uses_live_data(self):
        assert uses_live_data('{{ key "a" }}')
        assert uses_live_data('{{ secret "a" "b" }}')
        assert not uses_live_data('{{ env "A" }}')

    def test_watcher_fires_on_index_change(self):
        c = DevConsulProvider()
        c.kv_put("k", "v1")
        fired = []
        w = TemplateWatcher(
            poll_index=c.kv_index,
            rerender=lambda: True,
            on_change=lambda: fired.append(1),
            interval_s=0.05,
        )
        w.start()
        try:
            time.sleep(0.1)
            assert not fired
            c.kv_put("k", "v2")
            deadline = time.time() + 2
            while not fired and time.time() < deadline:
                time.sleep(0.02)
            assert fired
        finally:
            w.stop()


@pytest.fixture()
def cluster(tmp_path):
    server = Server(ServerConfig(device="cpu", num_workers=1))
    server.start()
    client = Client(
        InProcessRPC(server),
        ClientConfig(data_dir=str(tmp_path), update_batch_interval=0.05),
    )
    client.start()
    yield server, client
    client.shutdown()
    server.shutdown()


def _wait(fn, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


class TestEndToEnd:
    def test_vault_token_delivered_to_task(self, cluster, tmp_path):
        server, client = cluster
        job = mock.job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "2s"}
        task.vault = Vault(policies=["web-read"])
        server.job_register(job)

        assert _wait(lambda: any(
            tr.task_state.state == "running"
            for ar in client.allocs.values()
            for tr in ar.task_runners.values()
        )), "task never started"
        ar = next(iter(client.allocs.values()))
        token_file = os.path.join(
            ar.alloc_dir, task.name, "secrets", "vault_token")
        with open(token_file) as f:
            token = f.read()
        assert token.startswith("s.")
        assert server.vault.provider.token_valid(token)
        assert len(server.vault.accessors_for_alloc(ar.alloc.id)) == 1

    def test_tokens_revoked_when_alloc_completes(self, cluster):
        server, client = cluster
        job = mock.job()
        job.type = consts.JOB_TYPE_BATCH
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "0.1s"}
        task.vault = Vault(policies=[])
        server.job_register(job)

        # batch task finishes -> client reports terminal -> server revokes
        assert _wait(lambda: all(
            a.client_status == consts.ALLOC_CLIENT_COMPLETE
            for a in server.state.snapshot().allocs_iter()
            if a.job_id == job.id
        ) and any(server.state.snapshot().allocs_iter()))
        alloc = next(a for a in server.state.snapshot().allocs_iter()
                     if a.job_id == job.id)
        assert _wait(
            lambda: server.vault.accessors_for_alloc(alloc.id) == {})

    def test_template_rendered_and_change_mode_restart(self, cluster):
        server, client = cluster
        server.consul.kv_put("app/greeting", "hello")
        job = mock.job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "60s"}
        task.templates = [Template(
            embedded_tmpl='greeting={{ key "app/greeting" }}',
            dest_path="local/config.txt",
            change_mode="restart",
        )]
        server.job_register(job)

        assert _wait(lambda: any(
            tr.task_state.state == "running"
            for ar in client.allocs.values()
            for tr in ar.task_runners.values()
        ))
        ar = next(iter(client.allocs.values()))
        dest = os.path.join(ar.alloc_dir, task.name, "local", "config.txt")
        with open(dest) as f:
            assert f.read() == "greeting=hello"

        tr = next(iter(ar.task_runners.values()))
        restarts_before = len([
            e for e in tr.task_state.events if e.type == "Restarting"])
        server.consul.kv_put("app/greeting", "bonjour")
        assert _wait(lambda: open(dest).read() == "greeting=bonjour")
        assert _wait(lambda: len([
            e for e in tr.task_state.events if e.type == "Restarting"
        ]) > restarts_before), "change_mode=restart never fired"

    def test_change_mode_of_changed_template_only(self, cluster):
        """A noop template re-rendering must not fire an unrelated
        template's restart mode."""
        server, client = cluster
        server.consul.kv_put("noop/key", "v1")
        job = mock.job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "60s"}
        task.templates = [
            Template(embedded_tmpl='k={{ key "noop/key" }}',
                     dest_path="local/live.txt", change_mode="noop"),
            Template(embedded_tmpl="static content",
                     dest_path="local/static.txt", change_mode="restart"),
        ]
        server.job_register(job)
        assert _wait(lambda: any(
            tr.task_state.state == "running"
            for ar in client.allocs.values()
            for tr in ar.task_runners.values()
        ))
        ar = next(iter(client.allocs.values()))
        tr = next(iter(ar.task_runners.values()))
        dest = os.path.join(ar.alloc_dir, task.name, "local", "live.txt")
        server.consul.kv_put("noop/key", "v2")
        assert _wait(lambda: open(dest).read() == "k=v2")
        time.sleep(0.3)   # give a wrong restart a chance to fire
        assert not any(e.type == "Restarting" for e in tr.task_state.events)

    def test_secret_rotation_triggers_rerender(self, cluster):
        """Vault secret writes bump the live-data index too."""
        server, client = cluster
        server.vault.provider.write_secret("db/creds", {"pass": "one"})
        job = mock.job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "60s"}
        task.vault = Vault(policies=[])
        task.templates = [Template(
            embedded_tmpl='pass={{ secret "db/creds" "pass" }}',
            dest_path="local/creds.txt", change_mode="noop",
        )]
        server.job_register(job)
        assert _wait(lambda: any(
            tr.task_state.state == "running"
            for ar in client.allocs.values()
            for tr in ar.task_runners.values()
        ))
        ar = next(iter(client.allocs.values()))
        dest = os.path.join(ar.alloc_dir, task.name, "local", "creds.txt")
        assert open(dest).read() == "pass=one"
        server.vault.provider.write_secret("db/creds", {"pass": "two"})
        assert _wait(lambda: open(dest).read() == "pass=two"), \
            "secret rotation never re-rendered"

    def test_template_with_secret_requires_vault_block(self, cluster):
        server, client = cluster
        job = mock.job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "60s"}
        task.templates = [Template(
            embedded_tmpl='{{ secret "a" "b" }}', dest_path="local/x")]
        server.job_register(job)
        assert _wait(lambda: any(
            tr.task_state.state == "dead" and tr.task_state.failed
            for ar in client.allocs.values()
            for tr in ar.task_runners.values()
        )), "prestart should fail without a vault block"

    def test_vault_token_rotation_redelivers(self, cluster):
        server, client = cluster
        job = mock.job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": "60s"}
        task.vault = Vault(policies=[], change_mode="noop")
        server.job_register(job)
        assert _wait(lambda: any(
            tr.task_state.state == "running"
            for ar in client.allocs.values()
            for tr in ar.task_runners.values()
        ))
        ar = next(iter(client.allocs.values()))
        tr = next(iter(ar.task_runners.values()))
        tr.vault_poll_interval_s = 0.05
        old = tr._vault_token
        # revoke out from under the task (external operator action)
        server.vault.revoke_for_alloc(ar.alloc.id)
        assert _wait(lambda: tr._vault_token != old
                     and server.vault.provider.token_valid(tr._vault_token)), \
            "token never re-derived"
        token_file = os.path.join(
            ar.alloc_dir, task.name, "secrets", "vault_token")
        assert open(token_file).read() == tr._vault_token


class TestDeriveValidation:
    def test_terminal_alloc_rejected(self):
        server = Server(ServerConfig(device="cpu", num_workers=0))
        server.start()
        try:
            job = mock.job()
            server.job_register(job)
            from nomad_tpu_torch.structs.alloc import Allocation
            alloc = Allocation(
                job_id=job.id, namespace=job.namespace,
                task_group=job.task_groups[0].name,
                client_status=consts.ALLOC_CLIENT_COMPLETE,
                desired_status=consts.ALLOC_DESIRED_STOP,
            )
            alloc.job = job
            server.state.upsert_allocs([alloc])
            with pytest.raises(ValueError):
                server.derive_vault_tokens(alloc.id, [
                    job.task_groups[0].tasks[0].name])
        finally:
            server.shutdown()


class TestJobspecVault:
    def test_vault_block_parses(self):
        from nomad_tpu_torch.jobspec.parse import parse_hcl as parse_job
        hcl = '''
        job "web" {
          group "app" {
            task "server" {
              driver = "mock_driver"
              vault {
                policies      = ["db-read", "kv-read"]
                change_mode   = "signal"
                change_signal = "SIGUSR1"
              }
            }
          }
        }
        '''
        job = parse_job(hcl)
        v = job.task_groups[0].tasks[0].vault
        assert v is not None
        assert v.policies == ["db-read", "kv-read"]
        assert v.change_mode == "signal"
        assert v.change_signal == "SIGUSR1"
