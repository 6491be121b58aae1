"""The port's own copies of pure-Python reference modules have not drifted.

Each module below is kept in ``nomad_tpu_torch`` as a copy of the JAX
package's file of the same path, so the port imports nothing of
``nomad_tpu``. A case asserts that the copy's code equals the reference
file's once every ``nomad_tpu`` package name in it (``nomad_tpu.x``
imports, ``from nomad_tpu import``) is read as ``nomad_tpu_torch``: the
two syntax trees must be equal, every statement, name and literal
included. Comments and docstrings are not part of the comparison; the
copies drop the reference's notes on its own change history from a few
of them. A deliberate difference is listed in ``PATCHES`` and applied
to the reference before the comparison. Files the port changed where the device starts
(``tensors/schema``, ``ops/kernel``, ``parallel/coalesce``, the
scheduler's context, stack, generic, testing and package init, the
server's worker, server and heartbeat timers) are held by the parity
tests instead. Of ``server/server.py``, the methods that wire the raft
log into the server (``RAFT_WIRING``) must equal the reference's the
same way, method by method (deliberate differences in
``WIRING_PATCHES``); of ``telemetry/exporter.py``, every function
but ``prometheus_text`` (``EXPORTER_FUNCTIONS``). The web UI's static
assets, which ``api/http`` serves, are the reference's bytes.
``plugins/device`` is not a copy: its ``CudaDevicePlugin`` is held by
``test_torch_device_reserve.py``.
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
    "raft/__init__", "raft/log", "raft/observe", "raft/wal",
    "raft/transport", "raft/node", "server/testing", "telemetry/timeline",
    "api/codec", "structs/namespace", "structs/diff", "server/endpoints",
    "server/search", "utils/snapshot", "utils/monitor",
    "telemetry/waterfall", "server/membership",
    "jobspec/hcl", "jobspec/eval", "jobspec/parse", "jobspec/__init__",
    "acl/policy", "acl/acl", "acl/resolver", "acl/__init__",
    "utils/tlsutil", "utils/ws", "api/http", "api/client",
    "api/config_file", "api/__init__", "api/agent",
    "cli/fmt", "cli/main", "cli/__init__", "__main__",
    "plugins/base", "plugins/drivers", "plugins/__init__",
    "drivers/mock", "drivers/rawexec", "drivers/execdriver", "drivers/java",
    "drivers/qemu", "drivers/docker_api", "drivers/docklog",
    "drivers/docker", "drivers/__init__",
    "client/state_db", "client/fingerprint", "client/logmon",
    "client/getter", "client/template", "client/task_runner",
    "client/alloc_runner", "client/csimanager", "client/network_manager",
    "client/servicereg", "client/connect", "client/connect_proxy",
    "client/client", "client/__init__",
    "plugins/external", "plugins/demo_sleep_driver", "plugins/csi",
    "ui/harness",
)

#: deliberate differences of a copy from its reference: each (reference
#: code, port code) pair is applied to the reference text before the
#: comparison, so the rest of the file stays held. ROADMAP C names each.
PATCHES = {
    # the leader's own fsync counts toward the commit when it ends after
    # the followers' acks, not only in a single-voter cluster
    # a RequestVote that reaches a node still recovering its state is
    # not granted (the reference's handler raises AttributeError there,
    # which ends the candidate's vote thread); any other RPC finds no
    # node until the state exists
    "raft/node": ((
        "            if not self.peers:\n"
        "                self._advance_commit_locked()\n",
        "            self._advance_commit_locked()\n"), (
        "        self.transport = transport\n"
        "        transport.set_handler(self._handle_rpc)\n",
        "        self.transport = transport\n"
        "        self._ready = False\n"
        "        transport.set_handler(self._handle_rpc)\n"), (
        "        self._forward_order: List[str] = []\n",
        "        self._forward_order: List[str] = []\n"
        "        self._ready = True\n"), (
        "    def _handle_rpc(self, method: str, req: Dict) -> Dict:\n",
        "    def _handle_rpc(self, method: str, req: Dict) -> Dict:\n"
        "        if not self._ready:\n"
        "            if method == \"request_vote\":\n"
        "                return {\"term\": 0, \"granted\": False}\n"
        "            raise ConnectionError(f\"{self.id} is still recovering\")\n"
        )),
    # an eval already ready or pending is not enqueued a second time
    "server/eval_broker": ((
        "        if outstanding and outstanding != ev.id:\n",
        "        if outstanding == ev.id or any(\n"
        "                p.id == ev.id for _, _, p in "
        "self._pending.get(ns_job, ())):\n"
        "            return\n"
        "        if outstanding:\n"),),
    # ``job plan`` dry-runs its scheduler on the server's device; node
    # evaluate and purge pass the node's index to ``_create_node_evals``,
    # which applies the evals itself, and return the ids it gives (the
    # reference passes a snapshot and applies the ids again as evals)
    "server/endpoints": ((
        "    h = Harness(state=shadow)\n",
        "    h = Harness(state=shadow, device=server.device)\n"), (
        "    evals = server._create_node_evals(node_id, snap)\n"
        "    index = server.raft_apply(\n"
        "        fsm_msgs.NODE_DEREGISTER, {\"node_id\": node_id, "
        "\"evals\": evals}\n"
        "    )\n"
        "    return {\"eval_ids\": [e.id for e in evals], \"index\": index}\n",
        "    eval_ids = server._create_node_evals(node_id, node.modify_index)\n"
        "    index = server.raft_apply(\n"
        "        fsm_msgs.NODE_DEREGISTER, {\"node_id\": node_id, "
        "\"evals\": eval_ids}\n"
        "    )\n"
        "    return {\"eval_ids\": eval_ids, \"index\": index}\n"), (
        "    evals = server._create_node_evals(node_id, snap)\n"
        "    index = server.raft_apply(fsm_msgs.EVAL_UPDATE, "
        "{\"evals\": evals})\n"
        "    return {\"eval_ids\": [e.id for e in evals], \"index\": index}\n",
        "    eval_ids = server._create_node_evals(node_id, node.modify_index)\n"
        "    return {\"eval_ids\": eval_ids, "
        "\"index\": server.state.latest_index()}\n")),
    # the agent names its server's device (None is the card) and its
    # workers' batch size (1, the reference's, places each eval alone:
    # no wave reaches B1)
    "api/agent": ((
        "    raft_lease_fraction: float = 0.75\n",
        "    raft_lease_fraction: float = 0.75\n"
        "    device: Optional[str] = None\n"
        "    worker_batch_size: int = 1\n"), (
        "            raft_lease_fraction=self.config.raft_lease_fraction,\n",
        "            raft_lease_fraction=self.config.raft_lease_fraction,\n"
        "            device=self.config.device,\n"
        "            worker_batch_size=self.config.worker_batch_size,\n")),
    # a client's default data dir and its bridge probe's and relays'
    # host-wide names are the process's own (under its temp dir, named
    # by its pid), never the reference's fixed ones under /tmp: both
    # packages' clients run on one host
    "client/client": ((
        "import os\nimport threading\n",
        "import os\nimport tempfile\nimport threading\n"), (
        "        data_dir: str = \"/tmp/nomad-tpu-client\",\n",
        "        data_dir: str = os.path.join(tempfile.gettempdir(),\n"
        "                                     \"nomad-tpu-client\"),\n")),
    "client/network_manager": ((
        "import logging\nimport socket\nimport subprocess\n"
        "import threading\n",
        "import logging\nimport os\nimport socket\nimport subprocess\n"
        "import tempfile\nimport threading\n"), (
        "    ns = \"nomadtpu-probe\"\n",
        "    ns = f\"nomadtpt-probe-{os.getpid()}\"\n"
        "    veth = f\"ntp{os.getpid()}\"\n"), (
        "        ok = _run([\"ip\", \"link\", \"add\", \"nomadtpu-pr0\", "
        "\"type\", \"veth\",\n"
        "                   \"peer\", \"name\", \"nomadtpu-pr1\"])"
        ".returncode == 0\n"
        "        _run([\"ip\", \"link\", \"del\", \"nomadtpu-pr0\"])\n",
        "        ok = _run([\"ip\", \"link\", \"add\", f\"{veth}a\", "
        "\"type\", \"veth\",\n"
        "                   \"peer\", \"name\", f\"{veth}b\"])"
        ".returncode == 0\n"
        "        _run([\"ip\", \"link\", \"del\", f\"{veth}a\"])\n"), (
        "RELAY_STATE_DIR = \"/tmp/nomad-tpu-relays\"\n",
        "RELAY_STATE_DIR = os.path.join(tempfile.gettempdir(), "
        "\"nomad-tpu-relays\")\n")),
    # a restarted task's executor starts on an empty status file, not
    # on the last run's pid and exit records
    "drivers/rawexec": ((
        "            task.status_path = os.path.join(\n"
        "                workdir, f\".executor-{config.name}.status\"\n"
        "            )\n",
        "            task.status_path = os.path.join(\n"
        "                workdir, f\".executor-{config.name}.status\"\n"
        "            )\n"
        "            try:\n"
        "                os.unlink(task.status_path)\n"
        "            except FileNotFoundError:\n"
        "                pass\n"),),
    # the server block's ``worker_batch_size`` sets the agent's
    "api/config_file": ((
        "        if \"scheduler_workers\" in sa:\n"
        "            cfg.scheduler_workers = int(sa[\"scheduler_workers\"])\n",
        "        if \"scheduler_workers\" in sa:\n"
        "            cfg.scheduler_workers = int(sa[\"scheduler_workers\"])\n"
        "        if \"worker_batch_size\" in sa:\n"
        "            cfg.worker_batch_size = int(sa[\"worker_batch_size\"])\n"),),
    # ``agent -device`` picks the server's device, and a refused setting
    # exits 1 with its message
    "cli/main": ((
        "    if args.plugin_dir:\n"
        "        cfg.plugin_dir = args.plugin_dir\n",
        "    if args.plugin_dir:\n"
        "        cfg.plugin_dir = args.plugin_dir\n"
        "    if args.device:\n"
        "        cfg.device = args.device\n"), (
        "    except ValueError as e:\n"
        "        return _fail(str(e))\n"
        "    agent.start()\n",
        "    except (ValueError, NotImplementedError) as e:\n"
        "        return _fail(str(e))\n"
        "    agent.start()\n"), (
        "                    help=\"directory of external driver plugins\")\n",
        "                    help=\"directory of external driver plugins\")\n"
        "    ag.add_argument(\"-device\", default=None,\n"
        "                    help=\"device the server places on (default: "
        "the \"\n"
        "                    \"CUDA card; 'cpu' runs the plain versions)\")\n")),
}

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
    for was, now in PATCHES.get(name, ()):
        assert ref.count(was) == 1, f"{name}: patched code not found once"
        ref = ref.replace(was, now)
    assert _code(port) == _code(_PACKAGE.sub("nomad_tpu_torch", ref)), (
        f"nomad_tpu_torch/{name}.py drifted from nomad_tpu/{name}.py")


#: ``Server`` methods of ``server/server.py`` that attach the raft log,
#: route writes through it and follow its leadership, copied whole
RAFT_WIRING = (
    "setup_raft", "is_leader", "linearizable_read", "establish_leadership",
    "revoke_leadership", "_leader_loop", "_restore_evals", "raft_apply",
    "snapshot_min_index",
)

#: deliberate differences of a ``RAFT_WIRING`` method, as ``PATCHES``:
#: the leader also runs Nomad's periodicUnblockFailedEvals, which the
#: reference's leader lacks (an eval blocked after its plans were
#: rejected too often then stays blocked)
WIRING_PATCHES = {
    "establish_leadership": ((
        "                (\"reap-dup-blocked\", self.reap_dup_blocked_once, "
        "0.2),\n",
        "                (\"reap-dup-blocked\", self.reap_dup_blocked_once, "
        "0.2),\n"
        "                (\"unblock-failed-evals\", "
        "self.unblock_failed_evals_once,\n"
        "                 FAILED_EVAL_UNBLOCK_INTERVAL),\n"),),
}


def _method(text: str, cls: str, name: str) -> str:
    tree = ast.parse(text)
    klass = next(n for n in tree.body
                 if isinstance(n, ast.ClassDef) and n.name == cls)
    fn = next(n for n in klass.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return _code(ast.unparse(fn))


@pytest.mark.parametrize("name", RAFT_WIRING)
def test_server_raft_wiring_matches_reference(name):
    ref = (ROOT / "nomad_tpu" / "server" / "server.py").read_text()
    port = (ROOT / "nomad_tpu_torch" / "server" / "server.py").read_text()
    for was, now in WIRING_PATCHES.get(name, ()):
        assert ref.count(was) == 1, f"{name}: patched code not found once"
        ref = ref.replace(was, now)
    assert _method(port, "Server", name) == _method(
        _PACKAGE.sub("nomad_tpu_torch", ref), "Server", name), (
        f"Server.{name} drifted from the reference")


#: functions of ``telemetry/exporter.py`` copied whole; its
#: ``prometheus_text`` differs (the fused failures series, no source
#: dropped in silence) and is held by its series against the
#: reference's in ``test_torch_serving_plane.py``
EXPORTER_FUNCTIONS = (
    "_esc", "_lbl", "traces_json", "stream_health_json",
    "cluster_health_json", "slow_raft_json", "slow_evals_json",
)


def _function(text: str, name: str) -> str:
    tree = ast.parse(text)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return _code(ast.unparse(fn))


def test_exporter_holds_every_function_it_copies():
    port = (ROOT / "nomad_tpu_torch" / "telemetry" / "exporter.py").read_text()
    tree = ast.parse(port)
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert names == set(EXPORTER_FUNCTIONS) | {"prometheus_text"}


@pytest.mark.parametrize("name", EXPORTER_FUNCTIONS)
def test_exporter_function_matches_reference(name):
    ref = (ROOT / "nomad_tpu" / "telemetry" / "exporter.py").read_text()
    port = (ROOT / "nomad_tpu_torch" / "telemetry" / "exporter.py").read_text()
    assert _function(port, name) == _function(
        _PACKAGE.sub("nomad_tpu_torch", ref), name), (
        f"exporter.{name} drifted from the reference")


@pytest.mark.parametrize("name", ("index.html", "app.js"))
def test_ui_asset_is_the_reference_bytes(name):
    """``api/http`` serves the web UI from ``../ui`` beside itself."""
    assert (ROOT / "nomad_tpu_torch" / "ui" / name).read_bytes() == (
        ROOT / "nomad_tpu" / "ui" / name).read_bytes()
