"""The port's own copies of pure-Python reference modules have not drifted.

Each module below is kept in ``nomad_tpu_torch`` as a copy of the JAX
package's file of the same path, so the port imports nothing of
``nomad_tpu``. A case asserts that the copy's code equals the reference
file's once every ``nomad_tpu`` package name in it (``nomad_tpu.x``
imports, ``from nomad_tpu import``) is read as ``nomad_tpu_torch``: the
two syntax trees must be equal, every statement, name and literal
included. Comments and docstrings are not part of the comparison; the
copies drop the reference's notes on its own change history from a few
of them. Files the port changed where the device starts
(``tensors/schema``, ``ops/kernel``, ``parallel/coalesce``, the
scheduler's context, stack, generic, testing and package init, the
server's worker, server and heartbeat timers) are held by the parity
tests instead.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

COPIES = (
    "structs/consts", "structs/network", "structs/resources",
    "structs/constraints", "structs/job", "structs/csi", "structs/node",
    "structs/alloc", "structs/eval_plan", "structs/__init__",
    "structs/services",
    "utils/witness", "telemetry/histogram", "telemetry/trace",
    "state/pmap", "state/usage", "state/store", "state/__init__", "mock",
    "feasibility/attr_planes", "feasibility/cache", "feasibility/compiler",
    "feasibility/runtime", "feasibility/__init__",
    "scheduler/scheduler", "scheduler/util", "scheduler/device",
    "scheduler/feasible", "scheduler/preemption", "scheduler/reconcile",
    "scheduler/scaffold",
    "utils/delayheap", "utils/kheap", "utils/metrics", "utils/faultpoints",
    "utils/wavecohort", "utils/timetable", "utils/cron", "utils/ipc",
    "server/plan_rejection", "server/blocked_evals",
    "server/eval_broker", "server/plan_queue", "server/fsm",
    "server/plan_apply", "server/stream", "server/readplane",
    "server/core_sched", "server/periodic", "server/deployment_watcher",
    "server/drainer", "server/volume_watcher", "server/autopilot",
    "server/secrets", "server/__init__",
)

_PACKAGE = re.compile(r"\bnomad_tpu\b")


def _code(text: str) -> str:
    """The module's syntax tree without docstrings, as text."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIES)
def test_copy_matches_reference(name):
    ref = (ROOT / "nomad_tpu" / f"{name}.py").read_text()
    port = (ROOT / "nomad_tpu_torch" / f"{name}.py").read_text()
    assert _code(port) == _code(_PACKAGE.sub("nomad_tpu_torch", ref)), (
        f"nomad_tpu_torch/{name}.py drifted from nomad_tpu/{name}.py")
