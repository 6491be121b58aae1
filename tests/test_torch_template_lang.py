"""Every scenario of ``tests/test_template_lang.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Template language: the Go text/template subset consul-template
embeds (client/allocrunner/taskrunner/template/template.go).

Conditionals, ranges over lists and maps, with-blocks, variables,
pipelines, and the ls/service data sources — the features beyond bare
interpolation that the reference's jobs routinely use for config
files (e.g. ranging over service instances into an upstream list).
"""

import pytest

from nomad_tpu_torch.client.template import (
    MissingKeyError,
    TemplateContext,
    TemplateSyntaxError,
    render,
    uses_live_data,
    uses_vault,
)
from _torch_client import port_bridge  # noqa: F401


def ctx(**kw):
    kv = kw.pop("kv", {})
    services = kw.pop("services", {})
    return TemplateContext(
        kv_get=kv.get,
        kv_ls=lambda p: sorted((k, v) for k, v in kv.items()
                               if k.startswith(p)),
        services_get=lambda n: services.get(n, []),
        **kw,
    )


class TestConditionals:
    def test_if_else(self):
        c = ctx(env={"MODE": "prod"})
        t = '{{ if env "MODE" }}mode={{ env "MODE" }}{{ else }}dev{{ end }}'
        assert render(t, c) == "mode=prod"
        assert render(t, ctx(env={})) == "dev"

    def test_else_if_chain(self):
        t = ('{{ if env "A" }}a{{ else if env "B" }}b'
             '{{ else }}neither{{ end }}')
        assert render(t, ctx(env={"A": "1"})) == "a"
        assert render(t, ctx(env={"B": "1"})) == "b"
        assert render(t, ctx(env={})) == "neither"

    def test_keyordefault_truthiness(self):
        t = ('{{ if keyOrDefault "feature" "" }}on{{ else }}off{{ end }}')
        assert render(t, ctx(kv={"feature": "yes"})) == "on"
        assert render(t, ctx(kv={})) == "off"


class TestRange:
    def test_range_services_into_upstreams(self):
        """The canonical consul-template use: render a backend list."""
        c = ctx(services={"api": [
            {"Name": "api", "Address": "10.0.0.1", "Port": 8080},
            {"Name": "api", "Address": "10.0.0.2", "Port": 8081},
        ]})
        t = ('{{ range service "api" }}'
             'server {{ .Address }}:{{ .Port }};\n'
             '{{ end }}')
        assert render(t, c) == \
            "server 10.0.0.1:8080;\nserver 10.0.0.2:8081;\n"

    def test_range_ls_pairs(self):
        c = ctx(kv={"app/config/db": "pg", "app/config/cache": "redis",
                    "app/other": "x"})
        t = '{{ range ls "app/config" }}{{ .Key }}={{ .Value }} {{ end }}'
        assert render(t, c) == "cache=redis db=pg "

    def test_range_with_vars_and_else(self):
        c = ctx(services={"api": [{"Port": 1}, {"Port": 2}]})
        t = ('{{ range $i, $s := service "api" }}'
             '[{{ $i }}]={{ $s.Port }} {{ end }}')
        assert render(t, c) == "[0]=1 [1]=2 "
        t2 = '{{ range service "gone" }}x{{ else }}no instances{{ end }}'
        assert render(t2, c) == "no instances"

    def test_range_over_secret_map(self):
        c = TemplateContext(
            secret_get=lambda p: {"user": "u1", "pass": "p1"}
            if p == "db/creds" else None)
        t = ('{{ range $k, $v := secret "db/creds" }}'
             '{{ $k }}={{ $v }};{{ end }}')
        assert render(t, c) == "pass=p1;user=u1;"


class TestWithAndVars:
    def test_with_rebinds_dot(self):
        c = TemplateContext(secret_get=lambda p: {"addr": "db:5432"})
        t = ('{{ with secret "db" }}addr={{ .addr }}{{ else }}none'
             '{{ end }}')
        assert render(t, c) == "addr=db:5432"
        assert render(t, TemplateContext()) == "none"

    def test_variable_assignment(self):
        c = ctx(kv={"a": "hello"})
        t = '{{ $x := key "a" }}{{ $x }}-{{ $x | toUpper }}'
        assert render(t, c) == "hello-HELLO"

    def test_pipeline_functions(self):
        c = ctx(kv={"a": "  Mixed Case  "})
        assert render('{{ key "a" | trimSpace | toLower }}', c) == \
            "mixed case"


class TestErrorsAndStrict:
    def test_strict_missing_key_raises(self):
        with pytest.raises(MissingKeyError):
            render('{{ key "nope" }}', ctx(kv={}), strict=True)
        assert render('{{ key "nope" }}', ctx(kv={})) == ""

    def test_unterminated_block_is_syntax_error(self):
        with pytest.raises(TemplateSyntaxError):
            render('{{ if env "A" }}never closed', ctx(env={}))

    def test_unknown_function_is_syntax_error(self):
        with pytest.raises(TemplateSyntaxError):
            render("{{ frobnicate }}", ctx())


class TestDetection:
    def test_uses_live_data_sees_control_flow_sources(self):
        assert uses_live_data('{{ range service "api" }}{{ end }}')
        assert uses_live_data('{{ range ls "p" }}{{ end }}')
        assert uses_live_data('{{ if key "a" }}x{{ end }}')
        assert not uses_live_data('{{ env "HOME" }}')

    def test_uses_vault(self):
        assert uses_vault('{{ with secret "a" }}{{ end }}')
        assert not uses_vault('{{ key "a" }}')


class TestEndToEnd:
    def test_rendered_config_through_live_task(self):
        """A template with range/if over live KV renders into the task
        dir and re-renders when KV changes (change_mode analog covered
        by test_secrets)."""
        import os
        import sys
        import time

        from nomad_tpu_torch import mock
        from nomad_tpu_torch.api.agent import Agent, AgentConfig
        from nomad_tpu_torch.structs.job import Template

        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            agent.server.consul.kv_put("backends/one", "10.1.1.1:80")
            agent.server.consul.kv_put("backends/two", "10.2.2.2:80")
            job = mock.simple_job(id="tmpl-lang-job")
            tg = job.task_groups[0]
            tg.count = 1
            task = tg.tasks[0]
            task.driver = "raw_exec"
            task.config = {"command": sys.executable,
                           "args": ["-S", "-c",
                                    "import time; time.sleep(300)"]}
            task.templates = [Template(
                embedded_tmpl=(
                    '{{ range ls "backends" }}'
                    "server {{ .Key }} {{ .Value }}\n"
                    "{{ end }}"
                    '{{ if keyOrDefault "tls" "" }}tls on{{ else }}'
                    "tls off{{ end }}\n"),
                dest_path="local/backends.conf",
            )]
            agent.server.job_register(job)
            deadline = time.time() + 60
            rendered = None
            while time.time() < deadline:
                snap = agent.server.state.snapshot()
                allocs = snap.allocs_by_job(job.namespace, job.id)
                if allocs:
                    ar = agent.client.allocs.get(allocs[0].id)
                    if ar:
                        p = os.path.join(ar.alloc_dir, task.name,
                                         "local", "backends.conf")
                        if os.path.exists(p):
                            rendered = open(p).read()
                            break
                time.sleep(0.2)
            assert rendered == ("server one 10.1.1.1:80\n"
                                "server two 10.2.2.2:80\n"
                                "tls off\n")
        finally:
            agent.shutdown()


class TestReviewEdges:
    def test_trim_markers(self):
        c = ctx(services={"api": [{"Address": "a", "Port": 1},
                                  {"Address": "b", "Port": 2}]})
        t = ('{{- range service "api" }}\n'
             '{{ .Address }}:{{ .Port }}\n'
             '{{- end }}\n')
        assert render(t, c) == "\na:1\nb:2\n"

    def test_ls_prefix_path_boundary(self):
        c = ctx(kv={"app/x": "1", "apple": "2"})
        t = '{{ range ls "app" }}{{ .Key }}={{ .Value }} {{ end }}'
        assert render(t, c) == "x=1 "

    def test_literals_do_not_classify_as_vault_or_live(self):
        # a Consul key literally named secret/... is not a Vault read
        assert not uses_vault('{{ key "secret/db" }}')
        assert uses_vault('{{ with secret "db" }}{{ end }}')
        # env/meta with suspicious literal names are not live
        assert not uses_live_data('{{ env "key" }}')
        assert not uses_live_data('{{ meta "service" }}')
        assert uses_live_data('{{ key "a" }}')

    def test_wrong_arity_is_syntax_error(self):
        with pytest.raises(TemplateSyntaxError):
            render("{{ key }}", ctx())
        with pytest.raises(TemplateSyntaxError):
            render('{{ env "A" "B" }}', ctx())

    def test_service_change_bumps_live_index(self):
        """Templates ranging over service() must re-render when
        instances register: the watcher's poll index moves on service
        registration changes."""
        from nomad_tpu_torch.api.agent import Agent, AgentConfig
        from nomad_tpu_torch.structs.services import ServiceRegistration

        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            secrets = agent.client.secrets
            before = secrets.live_data_index()
            agent.server.service_register([ServiceRegistration(
                id="tmpl-svc-1", service_name="api", namespace="default",
                node_id="n1", alloc_id="a1", address="10.0.0.9",
                port=8080)])
            assert secrets.live_data_index() > before
            assert any(s["Port"] == 8080
                       for s in secrets.services("default", "api"))
        finally:
            agent.shutdown()

    def test_service_template_rerenders_on_registration(self):
        """End to end: a template ranging over service() re-renders
        (through the live watcher) when a new instance registers."""
        import os
        import sys
        import time

        from nomad_tpu_torch import mock
        from nomad_tpu_torch.api.agent import Agent, AgentConfig
        from nomad_tpu_torch.structs.job import Template
        from nomad_tpu_torch.structs.services import ServiceRegistration

        agent = Agent(AgentConfig.dev(device="cpu"))
        agent.start()
        try:
            agent.server.service_register([ServiceRegistration(
                id="svc-tmpl-0", service_name="backend",
                namespace="default", node_id="n1", alloc_id="a0",
                address="10.0.0.1", port=8080)])
            job = mock.simple_job(id="svc-tmpl-job")
            tg = job.task_groups[0]
            tg.count = 1
            task = tg.tasks[0]
            task.driver = "raw_exec"
            task.config = {"command": sys.executable,
                           "args": ["-S", "-c",
                                    "import time; time.sleep(300)"]}
            task.templates = [Template(
                embedded_tmpl=('{{ range service "backend" }}'
                               "up {{ .Address }}:{{ .Port }}\n"
                               "{{ end }}"),
                dest_path="local/upstreams.conf", change_mode="noop")]
            agent.server.job_register(job)

            def rendered():
                snap = agent.server.state.snapshot()
                allocs = snap.allocs_by_job(job.namespace, job.id)
                if not allocs:
                    return None
                ar = agent.client.allocs.get(allocs[0].id)
                if not ar:
                    return None
                p = os.path.join(ar.alloc_dir, task.name, "local",
                                 "upstreams.conf")
                return open(p).read() if os.path.exists(p) else None

            deadline = time.time() + 60
            while time.time() < deadline and rendered() is None:
                time.sleep(0.2)
            assert rendered() == "up 10.0.0.1:8080\n"

            # a NEW instance registers: the watcher re-renders
            agent.server.service_register([ServiceRegistration(
                id="svc-tmpl-1", service_name="backend",
                namespace="default", node_id="n2", alloc_id="a1",
                address="10.0.0.2", port=8081)])
            deadline = time.time() + 30
            while time.time() < deadline and \
                    (rendered() or "").count("up ") < 2:
                time.sleep(0.2)
            assert rendered() == ("up 10.0.0.1:8080\n"
                                  "up 10.0.0.2:8081\n")
        finally:
            agent.shutdown()
