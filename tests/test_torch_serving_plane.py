"""The port's serving plane against the JAX package's, on the CPU.

- Every scenario of ``tests/test_jobspec2.py`` (HCL2 variables, locals,
  functions, interpolation, dynamic blocks, multiregion) runs on the
  port's ``jobspec``; the same HCL sources parsed by both packages give
  equal jobs once the reference's is carried across with
  ``convert.structs_from_reference``.
- ``api/codec`` encodes the same job, node, allocation and evaluation to
  equal bytes in both packages.
- ``server/endpoints``: ``job_plan`` (a job that fits, and one that does
  not, whose metrics hold the scores), ``job_scale`` and ``job_revert``
  return equal results on twin servers fed alike (both packages' uuid
  generators seeded alike before each call, so ids agree too), times
  aside, scores within ``SCORE_ATOL``; ``node_evaluate`` fails alike in
  both, a reference defect the port keeps (ROADMAP C).
- The same request sequence to a JAX agent and a port agent gives equal
  response bodies, times and the ids drawn at random aside.
- ``prometheus_text`` of both packages, fed alike in a fresh process,
  has the same series and labels, but for the two series the port adds
  (``nomad_tpu_wave_fused_failures_total`` and
  ``nomad_tpu_device_state_errors_total``) and the buckets a histogram's
  data decides.
- The waterfall cases of ``tests/test_tail_latency.py`` run on the
  port's ``telemetry/waterfall``.
"""

import json
import os
import random
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.api.agent import Agent as RefAgent
from nomad_tpu.api.agent import AgentConfig as RefAgentConfig
from nomad_tpu.api.codec import encode as ref_encode
from nomad_tpu.jobspec.parse import parse_hcl as ref_parse_hcl
from nomad_tpu.server import endpoints as ref_endpoints
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefConfig
from nomad_tpu.structs import eval_plan as ref_eval_plan
from nomad_tpu_torch.api.agent import Agent as PortAgent
from nomad_tpu_torch.api.agent import AgentConfig as PortAgentConfig
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.api.codec import encode as port_encode
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.jobspec.eval import EvalError, FUNCS, Scope, eval_expr, evaluate
from nomad_tpu_torch.jobspec.hcl import parse
from nomad_tpu_torch.jobspec.parse import parse_hcl
from nomad_tpu_torch.server import endpoints as port_endpoints
from nomad_tpu_torch.server.server import Server as PortServer
from nomad_tpu_torch.server.server import ServerConfig as PortConfig
from nomad_tpu_torch.structs import eval_plan as port_eval_plan
from nomad_tpu_torch.telemetry.trace import Span
from nomad_tpu_torch.telemetry.waterfall import (
    aggregate_tail,
    build_waterfall,
    build_waterfalls,
)

ROOT = Path(__file__).resolve().parents[1]
SCORE_ATOL = 1e-5
WAIT_S = 120.0


# ---------------------------------------------------------------------------
# tests/test_jobspec2.py on the port's jobspec
# ---------------------------------------------------------------------------

class TestVariables:
    def test_default_and_override(self):
        src = '''
        variable "region" { default = "us-west" }
        variable "count" { default = 3 }
        job "j" {
          region = var.region
          group "g" { count = var.count }
        }
        '''
        job = parse_hcl(src)
        assert job.region == "us-west"
        assert job.task_groups[0].count == 3
        job2 = parse_hcl(src, {"region": "eu-east", "count": 5})
        assert job2.region == "eu-east"
        assert job2.task_groups[0].count == 5

    def test_missing_value_errors(self):
        src = 'variable "x" {}\njob "j" { region = var.x }'
        with pytest.raises(EvalError):
            parse_hcl(src)

    def test_undeclared_override_errors(self):
        src = 'job "j" {}'
        with pytest.raises(EvalError):
            parse_hcl(src, {"nope": 1})


class TestLocals:
    def test_locals_reference_vars_and_each_other(self):
        src = '''
        variable "env" { default = "prod" }
        locals {
          full    = "${var.env}-cluster"
          shouted = upper(local.full)
        }
        job "j" { region = local.shouted }
        '''
        assert parse_hcl(src).region == "PROD-CLUSTER"

    def test_local_cycle_errors(self):
        src = '''
        locals { a = local.b
                 b = local.a }
        job "j" {}
        '''
        with pytest.raises(EvalError):
            parse_hcl(src)


class TestInterpolation:
    def test_expressions_inside_interpolation(self):
        scope = Scope({"var": {"n": 4, "name": "web"}, "local": {}})
        assert eval_expr("var.n + 2", scope) == 6
        assert eval_expr("var.n * 2 - 1", scope) == 7
        assert eval_expr("var.n > 3 && var.n < 10", scope) is True
        assert eval_expr('var.n == 4 ? "big" : "small"', scope) == "big"
        assert eval_expr('upper(var.name)', scope) == "WEB"
        assert eval_expr('format("%s-%d", var.name, var.n)', scope) == "web-4"

    def test_native_type_for_sole_interpolation(self):
        src = '''
        variable "count" { default = 7 }
        job "j" { group "g" { count = "${var.count}" } }
        '''
        assert parse_hcl(src).task_groups[0].count == 7

    def test_runtime_namespaces_pass_through(self):
        """${attr...} / ${node...} / ${env...} resolve at schedule/run
        time; the parser must keep them literal."""
        src = '''
        job "j" {
          constraint {
            attribute = "${attr.kernel.name}"
            value     = "linux"
          }
          group "g" {
            task "t" {
              driver = "mock"
              env { HOST = "${node.unique.name}" }
            }
          }
        }
        '''
        job = parse_hcl(src)
        assert job.constraints[0].ltarget == "${attr.kernel.name}"
        assert job.task_groups[0].tasks[0].env["HOST"] == \
            "${node.unique.name}"

    def test_indexing(self):
        scope = Scope({"var": {"dcs": ["dc1", "dc2"],
                               "m": {"k": "v"}}, "local": {}})
        assert eval_expr("var.dcs[1]", scope) == "dc2"
        assert eval_expr('var.m["k"]', scope) == "v"


class TestFunctions:
    def test_stdlib_subset(self):
        f = FUNCS
        assert f["join"](",", ["a", "b"]) == "a,b"
        assert f["split"](",", "a,b") == ["a", "b"]
        assert f["replace"]("a-b", "-", "_") == "a_b"
        assert f["length"]([1, 2, 3]) == 3
        assert f["concat"]([1], [2, 3]) == [1, 2, 3]
        assert f["contains"](["x"], "x") is True
        assert f["coalesce"](None, "", "v") == "v"
        assert f["ceil"](1.2) == 2 and f["floor"](1.8) == 1
        assert f["range"](3) == [0, 1, 2]
        assert f["element"](["a", "b"], 3) == "b"
        assert f["merge"]({"a": 1}, {"b": 2}) == {"a": 1, "b": 2}
        assert f["flatten"]([[1], [2, 3]]) == [1, 2, 3]
        assert f["distinct"]([1, 1, 2]) == [1, 2]
        assert f["jsondecode"](f["jsonencode"]({"x": 1})) == {"x": 1}
        assert f["base64decode"](f["base64encode"]("hi")) == "hi"
        assert f["lookup"]({"a": 1}, "b", 9) == 9
        assert f["trimprefix"]("abc", "ab") == "c"
        assert f["tonumber"]("4") == 4

    def test_function_call_in_jobspec(self):
        src = '''
        variable "dcs" { default = ["dc1", "dc2"] }
        job "j" {
          datacenters = var.dcs
          region      = join("-", var.dcs)
        }
        '''
        job = parse_hcl(src)
        assert job.datacenters == ["dc1", "dc2"]
        assert job.region == "dc1-dc2"

    def test_unknown_function_errors(self):
        with pytest.raises(EvalError):
            parse_hcl('job "j" { region = frobnicate("x") }')


class TestDynamicBlocks:
    def test_dynamic_expands_services(self):
        src = '''
        variable "ports" { default = ["http", "admin"] }
        job "j" {
          group "g" {
            task "t" {
              driver = "mock"
              dynamic "service" {
                for_each = var.ports
                content {
                  name = "svc-${service.value}"
                  port = service.value
                }
              }
            }
          }
        }
        '''
        task = parse_hcl(src).task_groups[0].tasks[0]
        assert [s.name for s in task.services] == ["svc-http", "svc-admin"]
        assert [s.port_label for s in task.services] == ["http", "admin"]

    def test_dynamic_with_labels_and_iterator(self):
        src = '''
        locals { groups = { web = 2, db = 1 } }
        job "j" {
          dynamic "group" {
            for_each = local.groups
            iterator = it
            labels   = ["${it.key}"]
            content {
              count = it.value
              task "t" { driver = "mock" }
            }
          }
        }
        '''
        job = parse_hcl(src)
        names = {tg.name: tg.count for tg in job.task_groups}
        assert names == {"web": 2, "db": 1}


class TestBodyEvaluate:
    def test_variable_blocks_dropped(self):
        body = evaluate(parse('variable "x" { default = 1 }\na = var.x'))
        assert body.attrs == {"a": 1}
        assert body.get_blocks("variable") == []


class TestReviewRegressions:
    def test_nomad_env_interpolations_stay_literal(self):
        """${NOMAD_TASK_DIR} and friends resolve at the client, never
        at parse time."""
        src = '''
        job "j" { group "g" { task "t" {
          driver = "mock"
          config { command = "${NOMAD_TASK_DIR}/run.sh" }
          env { D = "${NOMAD_ALLOC_DIR}/x" }
        } } }
        '''
        task = parse_hcl(src).task_groups[0].tasks[0]
        assert task.config["command"] == "${NOMAD_TASK_DIR}/run.sh"
        assert task.env["D"] == "${NOMAD_ALLOC_DIR}/x"

    def test_override_converted_to_declared_type(self):
        src = '''
        variable "n" { default = 3 }
        job "j" { group "g" { count = "${var.n * 2}" } }
        '''
        job = parse_hcl(src, {"n": "5"})    # CLI strings coerce to int
        assert job.task_groups[0].count == 10
        src2 = '''
        variable "dcs" { default = ["dc1"] }
        job "j" { datacenters = var.dcs }
        '''
        job2 = parse_hcl(src2, {"dcs": '["a", "b"]'})
        assert job2.datacenters == ["a", "b"]
        with pytest.raises(EvalError):
            parse_hcl(src, {"n": "not-a-number"})

    def test_undeclared_env_variable_ignored(self):
        src = 'variable "x" { default = 1 }\njob "j" {}'
        # env-sourced unknown: fine; explicit flag unknown: error
        parse_hcl(src, env_variables={"stray": "v"})
        with pytest.raises(EvalError):
            parse_hcl(src, variables={"stray": "v"})
        # env value for a DECLARED variable applies (flag wins over env)
        src2 = 'variable "r" { default = "a" }\njob "j" { region = var.r }'
        assert parse_hcl(src2, env_variables={"r": "b"}).region == "b"
        assert parse_hcl(src2, {"r": "c"}, {"r": "b"}).region == "c"

    def test_sole_interpolation_keeps_native_list(self):
        src = '''
        variable "dcs" { default = ["dc1", "dc2"] }
        job "j" { datacenters = "${var.dcs}" }
        '''
        assert parse_hcl(src).datacenters == ["dc1", "dc2"]

    def test_ternary_guard_protects_dead_branch(self):
        scope = Scope({"var": {"l": [], "f": ["x"]}, "local": {}})
        assert eval_expr('length(var.l) > 0 ? var.l[0] : "none"',
                         scope) == "none"
        assert eval_expr('length(var.f) > 0 ? var.f[0] : "none"',
                         scope) == "x"

    def test_runtime_errors_become_eval_errors(self):
        scope = Scope({"var": {"l": []}, "local": {}})
        with pytest.raises(EvalError):
            eval_expr("var.l[5]", scope)
        with pytest.raises(EvalError):
            eval_expr('"a" + 1', scope)


def test_multiregion_block_parses():
    hcl = '''
    job "mr" {
      datacenters = ["dc1"]
      multiregion {
        strategy {
          max_parallel = 1
          on_failure   = "fail_all"
        }
        region "east" {
          count       = 3
          datacenters = ["east-1"]
        }
        region "west" {
          count = 2
        }
      }
      group "web" {
        task "t" {
          driver = "raw_exec"
          config { command = "/bin/true" }
        }
      }
    }
    '''
    job = parse_hcl(hcl)
    assert job.multiregion["strategy"]["max_parallel"] == 1
    assert job.multiregion["strategy"]["on_failure"] == "fail_all"
    regions = job.multiregion["regions"]
    assert [r["name"] for r in regions] == ["east", "west"]
    assert regions[0]["count"] == 3
    assert regions[0]["datacenters"] == ["east-1"]
    # helper semantics used by the scheduler gate
    job.region = "west"
    assert job.multiregion_region_index() == 1
    assert job.multiregion_starts_blocked()
    job.region = "east"
    assert not job.multiregion_starts_blocked()


# ---------------------------------------------------------------------------
# The waterfall cases of tests/test_tail_latency.py
# ---------------------------------------------------------------------------

def _span(name, trace_id, start, dur, span_id=0, parent=0):
    return Span(name, trace_id, span_id, parent, start, dur,
                0.0, 0.0, 0.0, "t")


class TestWaterfall:
    def _spans(self, tid="ev1", base=0.0):
        return [
            _span("eval.e2e", tid, base + 0.000, 0.100),
            _span("eval.schedule", tid, base + 0.010, 0.080),
            _span("wave.park", tid, base + 0.020, 0.030),
            _span("wave.launch", tid, base + 0.050, 0.020),
            _span("plan.wait", tid, base + 0.070, 0.020),
            _span("plan.queue_wait", tid, base + 0.070, 0.004),
        ]

    def _globals(self, base=0.0):
        return [
            _span("plan.evaluate", "", base + 0.074, 0.006),
            _span("plan.commit", "", base + 0.080, 0.008),
            _span("fsm.apply", "", base + 0.082, 0.004),
        ]

    def test_segment_claims(self):
        wf = build_waterfall(self._spans(), self._globals())
        assert wf is not None
        segs = wf["segments"]
        approx = lambda a, b: abs(a - b) < 1e-9     # noqa: E731
        assert approx(wf["e2e_s"], 0.100)
        assert approx(segs["dequeue-wait"], 0.010)
        # schedule = envelope minus park/launch/plan-wait-window claims
        assert approx(segs["schedule"], 0.010)
        assert approx(segs["park"], 0.030)
        assert approx(segs["launch"], 0.020)
        assert approx(segs["plan-queue"], 0.004)
        assert approx(segs["evaluate"], 0.006)
        # fsm claims inside the commit envelope first
        assert approx(segs["fsm"], 0.004)
        assert approx(segs["commit"], 0.004)
        # plan.wait residue after queue/evaluate/commit/fsm claims
        assert approx(segs["plan-wait"], 0.002)
        # 0.090..0.100 (after schedule, before commit stamp) unclaimed
        assert approx(segs["other"], 0.010)
        assert approx(wf["covered_s"], 0.090)
        assert approx(wf["coverage"], 0.90)
        # claims partition the window: segments sum to e2e exactly
        assert approx(sum(segs.values()), wf["e2e_s"])

    def test_applier_envelopes_only_claim_inside_plan_wait(self):
        # a commit from ANOTHER batch, outside this eval's plan.wait
        # window, must not be attributed to this eval
        glob = self._globals() + [_span("plan.commit", "", 0.010, 0.030)]
        wf = build_waterfall(self._spans(), glob)
        assert abs(wf["segments"]["commit"] - 0.004) < 1e-9

    def test_missing_e2e_marker_returns_none(self):
        spans = [s for s in self._spans() if s.name != "eval.e2e"]
        assert build_waterfall(spans, self._globals()) is None

    def test_build_waterfalls_groups_by_trace(self):
        spans = (self._spans("a", 0.0) + self._spans("b", 1.0)
                 + self._globals(0.0) + self._globals(1.0))
        wfs = build_waterfalls(spans)
        assert {w["trace_id"] for w in wfs} == {"a", "b"}

    def test_aggregate_tail_p50_vs_p99(self):
        rng = random.Random(2)
        wfs = []
        # 99 fast evals dominated by schedule, 1 slow eval dominated
        # by dequeue-wait: the tail table must show dequeue-wait's
        # share GROWING at p99 — the "what makes the tail slow" signal
        for i in range(99):
            e2e = 0.010 + rng.uniform(0, 0.002)
            wfs.append({
                "trace_id": f"f{i}", "e2e_s": e2e,
                "segments": {"schedule": e2e * 0.7, "park": e2e * 0.3},
                "covered_s": e2e, "coverage": 1.0,
            })
        wfs.append({
            "trace_id": "slow", "e2e_s": 0.5,
            "segments": {"dequeue-wait": 0.45, "schedule": 0.05},
            "covered_s": 0.5, "coverage": 1.0,
        })
        tail = aggregate_tail(wfs)
        assert tail["e2e_count"] == 100
        assert tail["p50_coverage"] >= 0.99
        segs = tail["segments"]
        assert segs["schedule"]["p50_share"] > 0.6
        assert segs["dequeue-wait"]["p99_share"] > 0.8
        assert segs["dequeue-wait"].get("p50_share", 0.0) < 0.05
        # nearest-rank p99 of 100 samples is the 99th value (a fast
        # eval) — NOT the max, which is exactly the off-by-one the
        # shared helper exists to fix
        assert 10.0 <= tail["e2e_p99_ms"] <= 13.0
        assert tail["slowest"][0]["trace_id"] == "slow"
        assert tail["slowest"][0]["e2e_ms"] == 500.0

    def test_aggregate_tail_empty(self):
        tail = aggregate_tail([])
        assert tail["e2e_count"] == 0
        assert tail["segments"] == {}


# ---------------------------------------------------------------------------
# Both packages fed alike
# ---------------------------------------------------------------------------

#: HCL sources parsed by both packages (the jobspec scenarios' features
#: and a job with every stanza the scheduler reads)
HCL_SOURCES = {
    "variables": ("""
        variable "region" { default = "us-west" }
        variable "count" { default = 3 }
        locals { name = upper("${var.region}-web") }
        job "j" {
          region = var.region
          meta { label = local.name }
          group "g" { count = var.count }
        }
        """, {"count": 5}),
    "dynamic": ("""
        variable "ports" { default = ["http", "admin"] }
        job "d" {
          group "g" {
            network {
              dynamic "port" {
                for_each = var.ports
                labels   = [port.value]
                content {}
              }
            }
            dynamic "service" {
              for_each = var.ports
              content {
                name = "svc-${service.value}"
                port = service.value
              }
            }
            task "t" { driver = "mock_driver" }
          }
        }
        """, None),
    "full": ("""
        job "web" {
          datacenters = ["dc1", "dc2"]
          type        = "service"
          priority    = 70
          constraint {
            attribute = "${attr.kernel.name}"
            value     = "linux"
          }
          update {
            max_parallel = 2
            stagger      = "30s"
          }
          group "frontend" {
            count = 4
            spread {
              attribute = "${node.datacenter}"
              weight    = 60
            }
            affinity {
              attribute = "${node.class}"
              value     = "large"
              weight    = 40
            }
            restart {
              attempts = 3
              interval = "5m"
              delay    = "15s"
              mode     = "delay"
            }
            network {
              port "http" { to = 8080 }
            }
            task "app" {
              driver = "docker"
              config {
                image = "nginx:1.25"
                ports = ["http"]
              }
              env { MODE = "prod" }
              resources {
                cpu    = 500
                memory = 256
              }
            }
          }
        }
        """, None),
    "batch": ("""
        job "nightly" {
          type = "batch"
          periodic {
            cron             = "0 3 * * *"
            prohibit_overlap = true
          }
          parameterized {
            payload       = "optional"
            meta_required = ["input"]
          }
          group "g" {
            task "t" {
              driver = "raw_exec"
              config { command = "/bin/true" }
            }
          }
        }
        """, None),
}


@pytest.mark.parametrize("name", sorted(HCL_SOURCES))
def test_hcl_parses_alike_in_both_packages(name):
    src, variables = HCL_SOURCES[name]
    ref = ref_parse_hcl(src, variables) if variables else ref_parse_hcl(src)
    port = parse_hcl(src, variables) if variables else parse_hcl(src)
    assert structs_from_reference(ref, {}) == port
    assert json.dumps(ref_encode(ref), sort_keys=True) == json.dumps(
        port_encode(port), sort_keys=True)


@pytest.mark.parametrize("make", [
    ref_mock.job, ref_mock.simple_job, ref_mock.batch_job, ref_mock.node,
    ref_mock.alloc, ref_mock.eval,
], ids=["job", "simple_job", "batch_job", "node", "alloc", "eval"])
def test_codec_encodes_alike(make):
    obj = make()
    port = structs_from_reference(obj, {})
    assert json.dumps(ref_encode(obj), sort_keys=True) == json.dumps(
        port_encode(port), sort_keys=True)


#: keys whose values are drawn at random: an allocation's, an eval's and
#: a deployment's own ids and the ids that point at them (node, job and
#: namespace ids stay compared)
RANDOM_IDS = ("ID", "EvalID", "AllocID", "DeploymentID", "FollowupEvalID",
              "PreviousAllocation", "NextAllocation", "PreviousEval",
              "NextEval", "BlockedEval")


def assert_alike(ref, port, path="$", ids=True):
    """Equal once times (and, without ``ids``, random ids) are set
    aside; floats within ``SCORE_ATOL``."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), (path, port)
        assert set(ref) == set(port), (path, set(ref) ^ set(port))
        for k in ref:
            if k.endswith(("Time", "Timestamp", "time_ns")) or (
                    not ids and k in RANDOM_IDS):
                continue
            assert_alike(ref[k], port[k], f"{path}.{k}", ids)
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(ref) == len(port), (
            path, ref, port)
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_alike(a, b, f"{path}[{i}]", ids)
    elif isinstance(ref, float) or isinstance(port, float):
        assert abs(ref - port) <= SCORE_ATOL, (path, ref, port)
    else:
        assert ref == port, (path, ref, port)


def _wait(fn, msg):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.01)
    raise AssertionError(f"timeout waiting for {msg}")


def _idle(server) -> bool:
    bs = server.eval_broker.stats()
    return (bs["total_ready"] == 0 and bs["total_unacked"] == 0
            and not any(w._live for w in server.workers)
            and server.plan_queue.stats()["depth"] == 0)


class Twins:
    """A JAX and a port server, or agent, fed the same writes; each write
    is made with both packages' uuid generators seeded alike, and waits
    until both servers are idle."""

    def __init__(self, monkeypatch, ref, port):
        self.monkeypatch = monkeypatch
        self.ref, self.port = ref, port
        self.memo = {}

    def servers(self):
        return [getattr(s, "server", None) or s for s in (self.ref, self.port)]

    def seed(self, seed):
        for pkg in (ref_eval_plan, port_eval_plan):
            self.monkeypatch.setattr(pkg, "_UUID_RNG", random.Random(seed))

    def write(self, fn_ref, fn_port, *args, seed, convert=True):
        """``fn_ref(*args)``, then ``fn_port`` on the arguments carried
        across; returns both results."""
        out = []
        for fn, a in ((fn_ref, args), (fn_port, structs_from_reference(
                args, self.memo) if convert else args)):
            self.seed(seed)
            out.append(fn(*a))
        _wait(lambda: all(_idle(s) for s in self.servers()),
              "both servers idle")
        return out

    def allocs(self):
        """Per package, ``alloc name -> (node, desired status)``."""
        return [{(a.job_id, a.name): (a.node_id, a.desired_status)
                 for a in s.state.snapshot().allocs_iter()}
                for s in self.servers()]


@pytest.fixture()
def twin_servers(monkeypatch):
    ref = RefServer(RefConfig(num_workers=1, heartbeat_ttl=60.0))
    port = PortServer(PortConfig(num_workers=1, heartbeat_ttl=60.0),
                      device="cpu")
    for s in (ref, port):
        s.start()
    try:
        yield Twins(monkeypatch, ref, port)
    finally:
        for s in (ref, port):
            s.shutdown()


def test_endpoints_return_alike_on_twin_servers(twin_servers):
    from functools import partial

    tw = twin_servers
    for i in range(4):
        tw.write(tw.ref.node_register, tw.port.node_register,
                 ref_mock.node(), seed=100 + i)
    job = ref_mock.simple_job()
    tw.write(tw.ref.job_register, tw.port.job_register, job, seed=1)
    ref_allocs, port_allocs = tw.allocs()
    assert len(ref_allocs) == 10 and ref_allocs == port_allocs

    def both(name, *args, seed):
        r, p = tw.write(partial(getattr(ref_endpoints, name), tw.ref),
                        partial(getattr(port_endpoints, name), tw.port),
                        *args, seed=seed)
        assert_alike(ref_encode(r), port_encode(p))
        return r, p

    # a plan that fits, with its diff, and one that does not: its failed
    # groups' metrics carry the scores of the nodes it ranked
    grown = ref_mock.simple_job(id=job.id)
    grown.task_groups[0].count = 12
    r, _ = both("job_plan", grown, True, seed=2)
    assert r["annotations"].desired_tg_updates["web"].place == 2
    assert r["diff"] is not None
    huge = ref_mock.simple_job()
    huge.task_groups[0].count = 60
    r, _ = both("job_plan", huge, False, seed=3)
    assert r["failed_tg_allocs"]
    both("job_scale", job.namespace, job.id, "web", 5, "down to five",
         seed=4)
    both("job_revert", job.namespace, job.id, 0, seed=5)
    ref_allocs, port_allocs = tw.allocs()
    assert ref_allocs == port_allocs
    # a reference defect the port repairs (ROADMAP C): the reference's
    # node_evaluate hands ``_create_node_evals`` a snapshot for its
    # index, and that method applies the evals itself and returns their
    # ids, which node_evaluate then applies again as evals; the port's
    # passes the node's index and returns the ids
    node = next(iter(ref_allocs.values()))[0]
    with pytest.raises(AttributeError) as e:
        ref_endpoints.node_evaluate(tw.ref, node)
    assert "'str' object has no attribute 'modify_index'" in str(e.value)
    res = port_endpoints.node_evaluate(tw.port, node)
    snap = tw.port.state.snapshot()
    evals = [snap.eval_by_id(i) for i in res["eval_ids"]]
    assert [ev.job_id for ev in evals] == [job.id]
    assert evals[0].triggered_by == "node-update"
    assert evals[0].node_modify_index == snap.node_by_id(node).modify_index


@pytest.fixture()
def twin_agents(monkeypatch):
    ref = RefAgent(RefAgentConfig(name="twin", num_schedulers=1,
                                  serf_enabled=False))
    port = PortAgent(PortAgentConfig(name="twin", num_schedulers=1,
                                     serf_enabled=False, device="cpu"))
    for a in (ref, port):
        a.start()
    try:
        yield Twins(monkeypatch, ref, port)
    finally:
        for a in (ref, port):
            a.shutdown()


def test_agents_answer_a_request_sequence_alike(twin_agents):
    tw = twin_agents
    apis = (APIClient(tw.ref.http_addr), APIClient(tw.port.http_addr))
    for i in range(4):
        tw.write(tw.ref.server.node_register, tw.port.server.node_register,
                 ref_mock.node(), seed=200 + i)
    job = ref_mock.simple_job()
    wire = ref_encode(job)
    grown = dict(wire, TaskGroups=[dict(wire["TaskGroups"][0], Count=12)])

    def both(method, path, body=None, seed=0):
        """One request to each agent, seeded alike; equal bodies (lists
        of allocations in name order)."""
        r, p = tw.write(
            lambda: apis[0].request(method, path, body, None),
            lambda: apis[1].request(method, path, body, None),
            seed=seed, convert=False)
        if path.endswith("/allocations"):
            r, p = (sorted(x, key=lambda a: a["Name"]) for x in (r, p))
        assert_alike(r, p, f"{method} {path}", ids=False)
        return r

    both("PUT", "/v1/jobs", {"Job": wire}, seed=1)
    _wait(lambda: all(len(api.jobs.allocations(job.id)) == 10
                      for api in apis), "both jobs placed")
    for path in ("/v1/jobs", f"/v1/job/{job.id}",
                 f"/v1/job/{job.id}/allocations",
                 f"/v1/job/{job.id}/evaluations",
                 f"/v1/job/{job.id}/summary", f"/v1/job/{job.id}/versions",
                 "/v1/nodes", "/v1/allocations", "/v1/evaluations",
                 "/v1/namespaces", "/v1/operator/scheduler/configuration",
                 "/v1/regions"):
        both("GET", path)
    plan = both("PUT", f"/v1/job/{job.id}/plan",
                {"Job": grown, "Diff": True}, seed=2)
    assert plan["Annotations"]["DesiredTGUpdates"]["web"]["Place"] == 2
    both("POST", f"/v1/job/{job.id}/scale",
         {"Target": {"Group": "web"}, "Count": 4, "Message": "m"}, seed=3)
    both("GET", f"/v1/job/{job.id}/scale")
    both("GET", f"/v1/job/{job.id}/allocations")
    both("PUT", "/v1/namespace/apps", {"Name": "apps",
                                        "Description": "d"}, seed=4)
    both("POST", "/v1/search", {"Prefix": job.id[:6], "Context": "jobs"})
    both("DELETE", f"/v1/job/{job.id}?purge=true", seed=5)
    both("GET", "/v1/jobs")


_SCRAPE_RUN = r"""
import json, os, random, sys, time, urllib.request
import jax
jax.config.update("jax_platforms", "cpu")
from nomad_tpu import mock
from nomad_tpu.api.agent import Agent as RefAgent, AgentConfig as RefCfg
from nomad_tpu.api.codec import encode
from nomad_tpu.structs import eval_plan as ref_eval_plan
from nomad_tpu_torch.api.agent import Agent as PortAgent
from nomad_tpu_torch.api.agent import AgentConfig as PortCfg
from nomad_tpu_torch.api.client import APIClient
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.structs import eval_plan as port_eval_plan
agents = [RefAgent(RefCfg(name="twin", num_schedulers=1, serf_enabled=False)),
          PortAgent(PortCfg(name="twin", num_schedulers=1, serf_enabled=False,
                            device="cpu"))]
for a in agents:
    a.start()
try:
    memo = {}
    for _ in range(8):
        node = mock.node()
        agents[0].server.node_register(node)
        agents[1].server.node_register(structs_from_reference(node, memo))
    apis = [APIClient(a.http_addr) for a in agents]
    for api in apis:
        api.put("/v1/operator/traces", {"Enable": True, "Reset": True})
    for k in range(3):
        job = mock.simple_job()
        for pkg, api in zip((ref_eval_plan, port_eval_plan), apis):
            pkg._UUID_RNG = random.Random(k)
            api.jobs.register(encode(job))
        for api in apis:
            deadline = time.time() + 120
            while time.time() < deadline and len(
                    api.jobs.allocations(job.id)) < 10:
                time.sleep(0.02)
            assert len(api.jobs.allocations(job.id)) == 10
    texts = []
    for a in agents:
        with urllib.request.urlopen(
                a.http_addr + "/v1/metrics?format=prometheus") as r:
            texts.append(r.read().decode())
finally:
    for a in agents:
        a.shutdown()
print(json.dumps(texts))
"""

#: series only the port exposes (ROADMAP C): a B1 launch that raises
#: fails its wave, and a failed device-state advance is counted
PORT_ONLY_SERIES = {"nomad_tpu_wave_fused_failures_total",
                    "nomad_tpu_device_state_errors_total"}


def _series(text):
    """Every sample's name and labels; a histogram bucket without its
    ``le``, which the data decides."""
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key = line.rpartition(" ")[0]
        if "_bucket{" in key:
            key = re.sub(r',?le="[^"]*"', "", key)
        out.add(key)
    return out


def test_prometheus_series_alike():
    """Both packages' exporters, fed alike in a fresh process (the
    registries are process-wide), expose the same series and labels."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", NOMAD_TPU_GC_TUNING="0")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SCRAPE_RUN],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref_text, port_text = json.loads(proc.stdout.strip().splitlines()[-1])
    ref, port = _series(ref_text), _series(port_text)
    assert ref - port == set()
    assert port - ref == PORT_ONLY_SERIES
    for name in ("nomad_tpu_wave_sharded_launches_total",
                 "nomad_tpu_wave_sharded_fallbacks_total",
                 "nomad_tpu_wave_sharded_mesh_devices"):
        assert f"{name} 0" in port_text.splitlines()
