"""CLI entry point — the `command/` layer of the reference.

Reference behavior: main.go:63-73 registers the top-level verbs
(agent, job, node, alloc, eval, deployment, namespace, acl, operator,
server, status, system, ui, version) with mitchellh/cli; each verb
talks to the cluster through the api/ SDK. This module provides the
same verb tree over argparse on top of nomad_tpu_torch.api.client.

Usage::

    python -m nomad_tpu_torch agent -server             # on the card
    python -m nomad_tpu_torch agent -server -device cpu
    python -m nomad_tpu_torch job run example.hcl
    python -m nomad_tpu_torch node status
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Any, Dict, List, Optional

from nomad_tpu_torch.api.client import APIClient, APIError, QueryOptions
from nomad_tpu_torch.cli.fmt import dict_rows, format_kv, format_list, short_id

VERSION = "0.1.0"


def make_client(args) -> APIClient:
    return APIClient(
        address=args.address,
        token=args.token,
        namespace=args.namespace,
        region=getattr(args, "region", "") or "",
        ca_cert=getattr(args, "ca_cert", "") or "",
        client_cert=getattr(args, "client_cert", "") or "",
        client_key=getattr(args, "client_key", "") or "",
    )


def _fail(msg: str) -> int:
    print(f"Error: {msg}", file=sys.stderr)
    return 1


# --- job ----------------------------------------------------------------


def _job_variables(args) -> tuple:
    """(-var flags, NOMAD_VAR_* env) — jobspec2 variable sources.
    Flags naming undeclared variables error; env values for
    undeclared variables are ignored."""
    flags: Dict = {}
    for item in getattr(args, "var", None) or []:
        if "=" not in item:
            raise ValueError(f"-var needs key=value, got {item!r}")
        k, v = item.split("=", 1)
        flags[k] = v
    env = {k[len("NOMAD_VAR_"):]: v for k, v in os.environ.items()
           if k.startswith("NOMAD_VAR_")}
    return flags, env


def _load_jobfile(path: str, variables: Optional[tuple] = None) -> Dict:
    """Parse an HCL or JSON jobspec file to a wire-format job dict
    (jobspec2.Parse → api.Job in the reference)."""
    from nomad_tpu_torch.api.codec import encode
    from nomad_tpu_torch.jobspec.parse import parse_hcl, parse_json

    if path == "-":
        src = sys.stdin.read()
    else:
        with open(path) as f:
            src = f.read()
    if path.endswith(".json"):
        data = json.loads(src)
        job = parse_json(data.get("Job", data))
    else:
        flags, env = variables or ({}, {})
        job = parse_hcl(src, flags, env)
    return encode(job)


def _monitor_eval(api: APIClient, eval_id: str, timeout: float = 30.0) -> int:
    """Poll an eval to completion, printing placement results — the
    `monitor` in command/monitor.go."""
    deadline = time.time() + timeout
    last_status = ""
    while time.time() < deadline:
        try:
            ev = api.evaluations.info(eval_id)
        except APIError as e:
            return _fail(f"eval lookup failed: {e}")
        status = ev.get("Status", "")
        if status != last_status:
            print(f"==> Evaluation \"{short_id(eval_id)}\" status \"{status}\"")
            last_status = status
        if status in ("complete", "failed", "canceled"):
            allocs = api.evaluations.allocations(eval_id)
            for a in allocs:
                print(
                    f"    Allocation \"{short_id(a['ID'])}\" created on node "
                    f"\"{short_id(a.get('NodeID', ''))}\""
                )
            blocked = ev.get("BlockedEval")
            if blocked:
                print(
                    f"==> Evaluation \"{short_id(eval_id)}\" waiting for "
                    f"additional capacity to place remainder (blocked eval "
                    f"\"{short_id(blocked)}\")"
                )
            if ev.get("FailedTGAllocs"):
                for tg, metric in ev["FailedTGAllocs"].items():
                    print(f"    Task Group \"{tg}\" (failed to place)")
                    for cls, n in (metric.get("ClassFiltered") or {}).items():
                        print(f"      * Class {cls}: {n} nodes filtered")
                    for dim, n in (metric.get("ConstraintFiltered") or {}).items():
                        print(f"      * Constraint {dim}: {n} nodes filtered")
            return 0 if status == "complete" else 2
        time.sleep(0.2)
    return _fail("eval monitoring timed out")


def cmd_job_run(args) -> int:
    api = make_client(args)
    try:
        job = _load_jobfile(args.jobfile, _job_variables(args))
    except Exception as e:
        return _fail(f"parsing jobspec: {e}")
    res = api.jobs.register(job)
    eval_id = res.get("EvalID", "")
    if args.detach or not eval_id:
        print(f"Job registration successful")
        if eval_id:
            print(f"Evaluation ID: {eval_id}")
        return 0
    return _monitor_eval(api, eval_id)


def cmd_job_plan(args) -> int:
    api = make_client(args)
    try:
        job = _load_jobfile(args.jobfile, _job_variables(args))
    except Exception as e:
        return _fail(f"parsing jobspec: {e}")
    res = api.jobs.plan(job, diff=True)
    diff = res.get("Diff") or {}
    print(f"+/- Job: \"{job.get('ID', '')}\"")
    if diff:
        print(f"Diff type: {diff.get('Type', 'None')}")
        for tg in diff.get("TaskGroups") or []:
            print(f"  Task Group: \"{tg.get('Name')}\" ({tg.get('Type')})")
    anno = res.get("Annotations") or {}
    for tg, changes in (anno.get("DesiredTGUpdates") or {}).items():
        parts = ", ".join(f"{k}: {v}" for k, v in changes.items() if v)
        print(f"  Group \"{tg}\": {parts or 'no changes'}")
    # reference exits 1 when the diff is non-empty so scripts can gate
    return 1 if diff.get("Type") not in (None, "", "None") else 0


def cmd_job_validate(args) -> int:
    """job_validate.go: parse + server-side structural validation."""
    api = make_client(args)
    try:
        job = _load_jobfile(args.jobfile, _job_variables(args))
    except Exception as e:
        return _fail(f"parsing jobspec: {e}")
    res = api.put("/v1/validate/job", {"Job": job})
    errs = res.get("ValidationErrors") or []
    if errs:
        print("Job validation errors:")
        for e in errs:
            print(f"  * {e}")
        return 1
    print("Job validation successful")
    return 0


def cmd_job_status(args) -> int:
    api = make_client(args)
    if not args.job_id:
        jobs = api.jobs.list()
        if not jobs:
            print("No running jobs")
            return 0
        print(dict_rows(jobs, ["ID", "Type", "Priority", "Status"]))
        return 0
    job = _resolve_one(api, args.job_id, "jobs", api.jobs.info)
    if job is None:
        return 1
    rows = [
        f"ID|{job['ID']}",
        f"Name|{job.get('Name', '')}",
        f"Type|{job.get('Type', '')}",
        f"Priority|{job.get('Priority', '')}",
        f"Datacenters|{','.join(job.get('Datacenters') or [])}",
        f"Status|{job.get('Status', '')}",
        f"Version|{job.get('Version', 0)}",
    ]
    print(format_kv(rows))
    try:
        summ = api.jobs.summary(job["ID"])
        print("\nSummary")
        srows = ["Task Group|Queued|Starting|Running|Failed|Complete|Lost"]
        for tg, s in sorted((summ.get("Summary") or {}).items()):
            srows.append(
                f"{tg}|{s.get('Queued', 0)}|{s.get('Starting', 0)}|"
                f"{s.get('Running', 0)}|{s.get('Failed', 0)}|"
                f"{s.get('Complete', 0)}|{s.get('Lost', 0)}"
            )
        print(format_list(srows))
    except APIError:
        pass
    allocs = api.jobs.allocations(job["ID"])
    if allocs:
        print("\nAllocations")
        arows = ["ID|Node ID|Task Group|Desired|Status"]
        for a in allocs:
            arows.append(
                f"{short_id(a['ID'])}|{short_id(a.get('NodeID', ''))}|"
                f"{a.get('TaskGroup', '')}|{a.get('DesiredStatus', '')}|"
                f"{a.get('ClientStatus', '')}"
            )
        print(format_list(arows))
    return 0


def cmd_job_stop(args) -> int:
    api = make_client(args)
    job = _resolve_one(api, args.job_id, "jobs", api.jobs.info)
    if job is None:
        return 1
    res = api.jobs.deregister(job["ID"], purge=args.purge)
    eval_id = res.get("EvalID", "")
    if args.detach or not eval_id:
        if eval_id:
            print(f"Evaluation ID: {eval_id}")
        return 0
    return _monitor_eval(api, eval_id)


def cmd_job_inspect(args) -> int:
    api = make_client(args)
    job = _resolve_one(api, args.job_id, "jobs", api.jobs.info)
    if job is None:
        return 1
    print(json.dumps({"Job": job}, indent=4, sort_keys=True))
    return 0


def cmd_job_history(args) -> int:
    api = make_client(args)
    res = api.jobs.versions(args.job_id)
    for v in res.get("Versions") or []:
        print(format_kv([
            f"Version|{v.get('Version')}",
            f"Stable|{v.get('Stable', False)}",
            f"Status|{v.get('Status', '')}",
        ]))
        print()
    return 0


def cmd_job_revert(args) -> int:
    api = make_client(args)
    res = api.jobs.revert(args.job_id, args.version)
    eval_id = res.get("EvalID", "")
    if eval_id and not args.detach:
        return _monitor_eval(api, eval_id)
    print(f"Evaluation ID: {eval_id}")
    return 0


def cmd_job_dispatch(args) -> int:
    api = make_client(args)
    meta = {}
    for kv in args.meta or []:
        if "=" not in kv:
            return _fail(f"-meta must be key=value, got \"{kv}\"")
        k, v = kv.split("=", 1)
        meta[k] = v
    payload = b""
    if args.input_file:
        with open(args.input_file, "rb") as f:
            payload = f.read()
    res = api.jobs.dispatch(args.job_id, meta=meta, payload=payload)
    print(f"Dispatched Job ID = {res['DispatchedJobID']}")
    if res.get("EvalID") and not args.detach:
        return _monitor_eval(api, res["EvalID"])
    return 0


def cmd_job_scale(args) -> int:
    api = make_client(args)
    res = api.jobs.scale(args.job_id, args.group, args.count,
                         message="scaled via CLI")
    if res.get("EvalID") and not args.detach:
        return _monitor_eval(api, res["EvalID"])
    print(f"Evaluation ID: {res.get('EvalID', '')}")
    return 0


def cmd_job_periodic_force(args) -> int:
    api = make_client(args)
    res = api.jobs.periodic_force(args.job_id)
    print(f"Evaluation ID: {res.get('EvalID', '')}")
    return 0


def cmd_job_deployments(args) -> int:
    api = make_client(args)
    deps = api.jobs.deployments(args.job_id)
    if not deps:
        print("No deployments found")
        return 0
    print(dict_rows(deps, ["ID", "JobID", "Status", "StatusDescription"]))
    return 0


# --- node ---------------------------------------------------------------


def cmd_node_status(args) -> int:
    api = make_client(args)
    if not args.node_id:
        nodes = api.nodes.list()
        rows = ["ID|DC|Name|Class|Drain|Eligibility|Status"]
        for n in nodes:
            rows.append(
                f"{short_id(n['ID'])}|{n.get('Datacenter', '')}|"
                f"{n.get('Name', '')}|{n.get('NodeClass', '')}|"
                f"{n.get('Drain', False)}|"
                f"{n.get('SchedulingEligibility', '')}|{n.get('Status', '')}"
            )
        print(format_list(rows))
        return 0
    node = _resolve_one(api, args.node_id, "nodes", api.nodes.info)
    if node is None:
        return 1
    print(format_kv([
        f"ID|{node['ID']}",
        f"Name|{node.get('Name', '')}",
        f"Class|{node.get('NodeClass', '')}",
        f"DC|{node.get('Datacenter', '')}",
        f"Drain|{node.get('Drain', False)}",
        f"Eligibility|{node.get('SchedulingEligibility', '')}",
        f"Status|{node.get('Status', '')}",
    ]))
    allocs = api.nodes.allocations(node["ID"])
    if allocs:
        print("\nAllocations")
        rows = ["ID|Job ID|Task Group|Desired|Status"]
        for a in allocs:
            rows.append(
                f"{short_id(a['ID'])}|{a.get('JobID', '')}|"
                f"{a.get('TaskGroup', '')}|{a.get('DesiredStatus', '')}|"
                f"{a.get('ClientStatus', '')}"
            )
        print(format_list(rows))
    return 0


def cmd_node_drain(args) -> int:
    api = make_client(args)
    if args.enable == args.disable:
        return _fail("exactly one of -enable or -disable is required")
    node = _resolve_one(api, args.node_id, "nodes", api.nodes.info)
    if node is None:
        return 1
    enable = args.enable
    api.nodes.drain(node["ID"], enable=enable, deadline_s=args.deadline)
    print(f"Node \"{short_id(node['ID'])}\" drain strategy "
          f"{'set' if enable else 'unset'}")
    return 0


def cmd_node_eligibility(args) -> int:
    api = make_client(args)
    if args.enable == args.disable:
        return _fail("exactly one of -enable or -disable is required")
    node = _resolve_one(api, args.node_id, "nodes", api.nodes.info)
    if node is None:
        return 1
    eligible = args.enable
    api.nodes.eligibility(node["ID"], eligible)
    print(f"Node \"{short_id(node['ID'])}\" scheduling eligibility set: "
          f"{'eligible' if eligible else 'ineligible'}")
    return 0


# --- alloc / eval / deployment -----------------------------------------


def cmd_alloc_status(args) -> int:
    api = make_client(args)
    alloc = _resolve_one(api, args.alloc_id, "allocs", api.allocations.info)
    if alloc is None:
        return 1
    print(format_kv([
        f"ID|{alloc['ID']}",
        f"Eval ID|{short_id(alloc.get('EvalID', ''))}",
        f"Name|{alloc.get('Name', '')}",
        f"Node ID|{short_id(alloc.get('NodeID', ''))}",
        f"Job ID|{alloc.get('JobID', '')}",
        f"Client Status|{alloc.get('ClientStatus', '')}",
        f"Desired Status|{alloc.get('DesiredStatus', '')}",
    ]))
    metrics = alloc.get("Metrics") or {}
    if metrics.get("ScoreMetaData"):
        print("\nPlacement Metrics")
        rows = ["Node|Score"]
        for sm in metrics["ScoreMetaData"][:5]:
            rows.append(f"{short_id(sm.get('NodeID', ''))}|"
                        f"{sm.get('NormScore', 0):.3f}")
        print(format_list(rows))
    return 0


def cmd_alloc_stop(args) -> int:
    api = make_client(args)
    alloc = _resolve_one(api, args.alloc_id, "allocs", api.allocations.info)
    if alloc is None:
        return 1
    res = api.allocations.stop(alloc["ID"])
    if res.get("EvalID") and not args.detach:
        return _monitor_eval(api, res["EvalID"])
    print(f"Evaluation ID: {res.get('EvalID', '')}")
    return 0


def cmd_alloc_logs(args) -> int:
    api = make_client(args)
    logtype = "stderr" if args.stderr else "stdout"
    if args.follow:
        # reconnect with offset when the server's stream deadline
        # expires mid-task (command/alloc_logs.go follows until the
        # task stops)
        pos = 0
        try:
            while True:
                for chunk in api.allocations.logs_follow(
                        args.alloc_id, args.task, logtype, offset=pos):
                    pos += len(chunk)
                    print(chunk.decode(errors="replace"), end="",
                          flush=True)
                alloc = api.allocations.info(args.alloc_id)
                if alloc.get("ClientStatus") not in ("pending", "running"):
                    break
        except (KeyboardInterrupt, APIError):
            pass
        return 0
    print(api.allocations.logs(args.alloc_id, args.task, logtype), end="")
    return 0


def cmd_alloc_restart(args) -> int:
    api = make_client(args)
    api.allocations.restart(args.alloc_id, args.task or "")
    print(f"Restarted allocation \"{args.alloc_id}\"")
    return 0


def cmd_alloc_signal(args) -> int:
    api = make_client(args)
    api.allocations.signal(args.alloc_id, args.signal, args.task or "")
    print(f"Signalled allocation \"{args.alloc_id}\"")
    return 0


def cmd_alloc_exec(args) -> int:
    api = make_client(args)
    if not (args.interactive or args.tty):
        out = api.allocations.exec(args.alloc_id, args.task, args.cmd)
        if out.get("stdout"):
            print(out["stdout"], end="")
        if out.get("stderr"):
            import sys as _sys
            print(out["stderr"], end="", file=_sys.stderr)
        return int(out.get("exit_code", 0) or 0)
    return _alloc_exec_interactive(api, args)


def _alloc_exec_interactive(api, args) -> int:
    """Streaming exec (`alloc exec -i [-t]`): websocket pty session
    (reference api/allocations_exec.go + command/alloc_exec.go)."""
    import sys as _sys
    import threading as _threading

    session = api.allocations.exec_stream(
        args.alloc_id, args.task, args.cmd, tty=args.tty)

    stdin_fd = _sys.stdin.fileno() if _sys.stdin.isatty() else None
    restore = None
    if args.tty and stdin_fd is not None:
        import termios
        import tty as _ttymod

        restore = termios.tcgetattr(stdin_fd)
        _ttymod.setraw(stdin_fd)
        try:
            import fcntl
            import struct as _struct

            import termios as _t

            packed = fcntl.ioctl(1, _t.TIOCGWINSZ,
                                 _struct.pack("HHHH", 0, 0, 0, 0))
            rows, cols, _, _ = _struct.unpack("HHHH", packed)
            session.resize(rows, cols)
        except OSError:
            pass

    stop = _threading.Event()

    def pump_stdin() -> None:
        try:
            while not stop.is_set():
                data = _sys.stdin.buffer.read1(4096) \
                    if hasattr(_sys.stdin.buffer, "read1") \
                    else _sys.stdin.buffer.read(4096)
                if not data:
                    session.close_stdin()
                    break
                session.send_stdin(data)
        except (OSError, ValueError, ConnectionError):
            pass

    t = _threading.Thread(target=pump_stdin, daemon=True)
    t.start()
    code = 1
    try:
        for frame in session.events():
            for name, out in (("stdout", _sys.stdout), ("stderr", _sys.stderr)):
                blob = frame.get(name) or {}
                if blob.get("bytes"):
                    out.buffer.write(blob["bytes"])
                    out.flush()
        code = session.exit_code if session.exit_code is not None else 1
    finally:
        stop.set()
        session.close()
        if restore is not None:
            import termios

            termios.tcsetattr(stdin_fd, termios.TCSADRAIN, restore)
    return int(code)


def cmd_alloc_fs(args) -> int:
    api = make_client(args)
    path = args.path or "/"
    stat = api.allocations.fs_stat(args.alloc_id, path)
    if stat.get("IsDir"):
        entries = api.allocations.fs_ls(args.alloc_id, path)
        print(dict_rows(entries, ["Name", "Size", "IsDir"]))
    else:
        print(api.allocations.fs_cat(args.alloc_id, path), end="")
    return 0


def cmd_eval_list(args) -> int:
    api = make_client(args)
    evals = api.evaluations.list()
    rows = ["ID|Priority|Triggered By|Job ID|Status"]
    for e in evals[: args.limit]:
        rows.append(
            f"{short_id(e['ID'])}|{e.get('Priority', '')}|"
            f"{e.get('TriggeredBy', '')}|{e.get('JobID', '')}|"
            f"{e.get('Status', '')}"
        )
    print(format_list(rows))
    return 0


def cmd_eval_status(args) -> int:
    api = make_client(args)
    ev = _resolve_one(api, args.eval_id, "evals", api.evaluations.info)
    if ev is None:
        return 1
    print(format_kv([
        f"ID|{ev['ID']}",
        f"Status|{ev.get('Status', '')}",
        f"Type|{ev.get('Type', '')}",
        f"Triggered By|{ev.get('TriggeredBy', '')}",
        f"Job ID|{ev.get('JobID', '')}",
        f"Priority|{ev.get('Priority', '')}",
        f"Placement Failures|{bool(ev.get('FailedTGAllocs'))}",
    ]))
    return 0


def cmd_deployment_list(args) -> int:
    api = make_client(args)
    deps = api.deployments.list()
    if not deps:
        print("No deployments found")
        return 0
    print(dict_rows(deps, ["ID", "JobID", "Status", "StatusDescription"]))
    return 0


def cmd_deployment_status(args) -> int:
    api = make_client(args)
    dep = _resolve_one(api, args.deployment_id, "deployment",
                       api.deployments.info)
    if dep is None:
        return 1
    print(format_kv([
        f"ID|{dep['ID']}",
        f"Job ID|{dep.get('JobID', '')}",
        f"Status|{dep.get('Status', '')}",
        f"Description|{dep.get('StatusDescription', '')}",
    ]))
    for tg, st in (dep.get("TaskGroups") or {}).items():
        print(f"\nTask Group \"{tg}\"")
        print(format_kv([
            f"Desired|{st.get('DesiredTotal', 0)}",
            f"Placed|{st.get('PlacedAllocs', 0)}",
            f"Healthy|{st.get('HealthyAllocs', 0)}",
            f"Unhealthy|{st.get('UnhealthyAllocs', 0)}",
        ]))
    return 0


def cmd_deployment_promote(args) -> int:
    api = make_client(args)
    api.deployments.promote(args.deployment_id)
    print(f"Deployment \"{short_id(args.deployment_id)}\" promoted")
    return 0


def cmd_deployment_fail(args) -> int:
    api = make_client(args)
    api.deployments.fail(args.deployment_id)
    print(f"Deployment \"{short_id(args.deployment_id)}\" marked failed")
    return 0


def cmd_deployment_pause(args) -> int:
    api = make_client(args)
    api.deployments.pause(args.deployment_id, pause=not args.resume)
    print(f"Deployment \"{short_id(args.deployment_id)}\" "
          f"{'resumed' if args.resume else 'paused'}")
    return 0


# --- status (generic prefix resolver) ----------------------------------


def _resolve_one(api: APIClient, prefix: str, context: str, info_fn):
    """Exact lookup, falling back to prefix search — the reference's
    short-ID UX (command/helpers.go getByPrefix pattern)."""
    try:
        return info_fn(prefix)
    except APIError:
        pass
    try:
        res = api.search.prefix(prefix, context)
        matches = (res.get("Matches") or {}).get(context) or []
    except APIError:
        matches = []
    if not matches:
        print(f"Error: no {context} match prefix \"{prefix}\"",
              file=sys.stderr)
        return None
    if len(matches) > 1:
        print(f"Error: prefix \"{prefix}\" matched multiple {context}:\n  "
              + "\n  ".join(matches), file=sys.stderr)
        return None
    return info_fn(matches[0])


def cmd_status(args) -> int:
    api = make_client(args)
    if not args.identifier:
        return cmd_job_status(argparse.Namespace(**{**vars(args), "job_id": ""}))
    res = api.search.prefix(args.identifier, "all")
    matches = {k: v for k, v in (res.get("Matches") or {}).items() if v}
    if not matches:
        return _fail(f"no matches for \"{args.identifier}\"")
    context, ids = next(iter(matches.items()))
    sub = {
        "jobs": (cmd_job_status, "job_id"),
        "nodes": (cmd_node_status, "node_id"),
        "allocs": (cmd_alloc_status, "alloc_id"),
        "evals": (cmd_eval_status, "eval_id"),
        "deployment": (cmd_deployment_status, "deployment_id"),
    }.get(context)
    if sub is None:
        print("\n".join(f"{context}: {i}" for i in ids))
        return 0
    fn, attr = sub
    return fn(argparse.Namespace(**{**vars(args), attr: ids[0]}))


# --- namespace / acl / operator / server / system ----------------------


def cmd_namespace_list(args) -> int:
    api = make_client(args)
    nss = api.namespaces.list()
    print(dict_rows(nss, ["Name", "Description"]))
    return 0


def cmd_namespace_apply(args) -> int:
    api = make_client(args)
    api.namespaces.register(args.name, args.description or "")
    print(f"Successfully applied namespace \"{args.name}\"")
    return 0


def cmd_namespace_delete(args) -> int:
    api = make_client(args)
    api.namespaces.delete(args.name)
    print(f"Successfully deleted namespace \"{args.name}\"")
    return 0


def cmd_service_list(args) -> int:
    api = make_client(args)
    rows = []
    for ns_block in api.services.list():
        for svc in ns_block.get("Services", []):
            rows.append({
                "ServiceName": svc.get("ServiceName", ""),
                "Namespace": ns_block.get("Namespace", ""),
                "Tags": ",".join(svc.get("Tags", [])),
            })
    print(dict_rows(rows, ["ServiceName", "Namespace", "Tags"]))
    return 0


def cmd_service_info(args) -> int:
    api = make_client(args)
    regs = api.services.get(args.service_name)
    print(dict_rows(regs, ["ID", "Address", "Port", "NodeID", "AllocID"]))
    return 0


def cmd_service_delete(args) -> int:
    api = make_client(args)
    api.services.delete(args.service_name, args.service_id)
    print(f"Successfully deleted service registration \"{args.service_id}\"")
    return 0


def cmd_volume_register(args) -> int:
    import json as _json

    api = make_client(args)
    with open(args.file) as f:
        spec = f.read()
    try:
        vol = _json.loads(spec)
    except _json.JSONDecodeError:
        from nomad_tpu_torch.jobspec.hcl import parse_hcl
        vol = parse_hcl(spec).get("volume", {})
    api.csi_volumes.register(vol)
    print(f"Successfully registered volume \"{vol.get('ID', vol.get('id', ''))}\"")
    return 0


def cmd_volume_status(args) -> int:
    api = make_client(args)
    if args.volume_id:
        v = api.csi_volumes.info(args.volume_id)
        print(format_kv([
            f"ID|{v.get('ID', '')}",
            f"Name|{v.get('Name', '')}",
            f"External ID|{v.get('ExternalID', '')}",
            f"Plugin ID|{v.get('PluginID', '')}",
            f"Schedulable|{v.get('Schedulable', '')}",
            f"Readers|{len(v.get('ReadClaims') or {})}",
            f"Writers|{len(v.get('WriteClaims') or {})}",
        ]))
    else:
        vols = api.csi_volumes.list()
        print(dict_rows(vols, ["ID", "Name", "PluginID", "Schedulable"]))
    return 0


def cmd_volume_deregister(args) -> int:
    api = make_client(args)
    api.csi_volumes.deregister(args.volume_id, force=args.force)
    print(f"Successfully deregistered volume \"{args.volume_id}\"")
    return 0


def cmd_volume_detach(args) -> int:
    api = make_client(args)
    api.csi_volumes.detach(args.volume_id, node_id=args.node or "")
    print(f"Successfully detached volume \"{args.volume_id}\"")
    return 0


def cmd_plugin_status(args) -> int:
    api = make_client(args)
    if args.plugin_id:
        p = api.csi_plugins.info(args.plugin_id)
        print(format_kv([
            f"ID|{p.get('ID', '')}",
            f"Provider|{p.get('Provider', '')}",
            f"Controllers Healthy|{p.get('ControllersHealthy', 0)}",
            f"Nodes Healthy|{p.get('NodesHealthy', 0)}",
        ]))
    else:
        plugins = api.csi_plugins.list()
        print(dict_rows(
            plugins,
            ["ID", "Provider", "ControllersHealthy", "NodesHealthy"],
        ))
    return 0


def cmd_acl_bootstrap(args) -> int:
    api = make_client(args)
    tok = api.acl.bootstrap()
    print(format_kv([
        f"Accessor ID|{tok.get('AccessorID', '')}",
        f"Secret ID|{tok.get('SecretID', '')}",
        f"Type|{tok.get('Type', '')}",
    ]))
    return 0


def cmd_acl_policy_apply(args) -> int:
    api = make_client(args)
    with open(args.rules_file) as f:
        rules = f.read()
    api.acl.put_policy(args.name, rules, args.description or "")
    print(f"Successfully wrote \"{args.name}\" ACL policy")
    return 0


def cmd_acl_policy_list(args) -> int:
    api = make_client(args)
    print(dict_rows(api.acl.policies(), ["Name", "Description"]))
    return 0


def cmd_acl_policy_delete(args) -> int:
    api = make_client(args)
    api.acl.delete_policy(args.name)
    print(f"Successfully deleted \"{args.name}\" ACL policy")
    return 0


def cmd_acl_token_create(args) -> int:
    api = make_client(args)
    tok = api.acl.create_token(
        name=args.name or "", type=args.type,
        policies=args.policy or [], global_=args.global_token,
    )
    print(format_kv([
        f"Accessor ID|{tok.get('AccessorID', '')}",
        f"Secret ID|{tok.get('SecretID', '')}",
        f"Name|{tok.get('Name', '')}",
        f"Type|{tok.get('Type', '')}",
        f"Policies|{','.join(tok.get('Policies') or [])}",
    ]))
    return 0


def cmd_acl_token_list(args) -> int:
    api = make_client(args)
    print(dict_rows(api.acl.tokens(), ["AccessorID", "Name", "Type"]))
    return 0


def cmd_acl_token_delete(args) -> int:
    api = make_client(args)
    api.acl.delete_token(args.accessor_id)
    print("Token deleted")
    return 0


def cmd_operator_scheduler_get(args) -> int:
    api = make_client(args)
    cfg = api.operator.scheduler_config()["SchedulerConfig"]
    print(format_kv([
        f"Scheduler Algorithm|{cfg.get('SchedulerAlgorithm', '')}",
        f"Preemption System|{(cfg.get('PreemptionConfig') or {}).get('SystemSchedulerEnabled', False)}",
        f"Preemption Service|{(cfg.get('PreemptionConfig') or {}).get('ServiceSchedulerEnabled', False)}",
        f"Preemption Batch|{(cfg.get('PreemptionConfig') or {}).get('BatchSchedulerEnabled', False)}",
    ]))
    return 0


def cmd_operator_scheduler_set(args) -> int:
    api = make_client(args)
    cfg = api.operator.scheduler_config()["SchedulerConfig"]
    if args.scheduler_algorithm:
        cfg["SchedulerAlgorithm"] = args.scheduler_algorithm
    api.operator.set_scheduler_config(cfg)
    print("Scheduler configuration updated!")
    return 0


def cmd_operator_snapshot_save(args) -> int:
    api = make_client(args)
    data = api.operator.snapshot_save()
    with open(args.file, "wb") as f:
        f.write(data)
    print(f"State file written to {args.file} ({len(data)} bytes)")
    return 0


def cmd_operator_snapshot_restore(args) -> int:
    api = make_client(args)
    with open(args.file, "rb") as f:
        data = f.read()
    api.operator.snapshot_restore(data)
    print("Snapshot restored")
    return 0


def cmd_operator_autopilot_get(args) -> int:
    api = make_client(args)
    cfg = api.operator.autopilot_configuration()
    print(format_kv([
        f"CleanupDeadServers|{cfg.get('CleanupDeadServers', '')}",
        f"LastContactThreshold|{cfg.get('LastContactThreshold', '')}",
        f"ServerStabilizationTime|{cfg.get('ServerStabilizationTime', '')}",
    ]))
    return 0


def cmd_operator_autopilot_set(args) -> int:
    api = make_client(args)
    cfg = api.operator.autopilot_configuration()
    if args.cleanup_dead_servers is not None:
        cfg["CleanupDeadServers"] = args.cleanup_dead_servers == "true"
    if args.last_contact_threshold:
        cfg["LastContactThreshold"] = args.last_contact_threshold
    api.operator.set_autopilot_configuration(cfg)
    print("Configuration updated!")
    return 0


def cmd_operator_autopilot_health(args) -> int:
    api = make_client(args)
    h = api.operator.autopilot_health()
    print(f"Healthy: {h.get('Healthy')}")
    print(f"FailureTolerance: {h.get('FailureTolerance')}")
    print(dict_rows(h.get("Servers", []),
                    ["ID", "Leader", "Healthy", "LastContact"]))
    return 0


def cmd_tls_ca_create(args) -> int:
    """tls_ca_create.go: write nomad-agent-ca{,-key}.pem."""
    from nomad_tpu_torch.utils.tlsutil import generate_ca

    cert, key = generate_ca(common_name=args.common_name)
    for path, data, mode in (("nomad-agent-ca.pem", cert, 0o644),
                             ("nomad-agent-ca-key.pem", key, 0o600)):
        with open(path, "wb") as f:
            f.write(data)
        os.chmod(path, mode)
        print(f"==> CA {'certificate' if mode == 0o644 else 'key'} "
              f"saved to: {path}")
    return 0


def cmd_tls_cert_create(args) -> int:
    """tls_cert_create.go: issue a server/client/cli cert off the CA."""
    from nomad_tpu_torch.utils.tlsutil import generate_cert

    try:
        with open(args.ca, "rb") as f:
            ca_cert = f.read()
        with open(args.key, "rb") as f:
            ca_key = f.read()
    except OSError as e:
        return _fail(f"cannot read CA material (run 'tls ca create' "
                     f"first?): {e}")
    role = "server" if args.server else ("client" if args.client else "cli")
    name = f"{role}.{args.cert_region}.nomad"
    cert, key = generate_cert(
        ca_cert, ca_key, common_name=name,
        san_dns=[name] + (args.additional_dnsname or []),
        # client *agents* also serve the HTTPS API (fs/exec proxying),
        # so their certs carry serverAuth too; only cli certs are
        # client-only (reference tls_cert_create.go)
        server=args.server or args.client,
        client=True,
    )
    base = f"{args.cert_region}-{role}-nomad"
    for suffix, data, mode in ((".pem", cert, 0o644),
                               ("-key.pem", key, 0o600)):
        path = base + suffix
        with open(path, "wb") as f:
            f.write(data)
        os.chmod(path, mode)
        print(f"==> Cert saved to: {path}")
    return 0


def cmd_monitor(args) -> int:
    api = make_client(args)
    try:
        for line in api.agent.monitor(log_level=args.log_level):
            print(line)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_operator_debug(args) -> int:
    """operator_debug.go: capture a support bundle."""
    import json as _json
    import tarfile
    import io
    import time as _time

    api = make_client(args)
    captures = {
        "agent-self.json": lambda: api.agent.self(),
        "agent-health.json": lambda: api.agent.health(),
        "agent-members.json": lambda: api.agent.members(),
        "metrics.json": lambda: api.agent.metrics(),
        "nodes.json": lambda: api.nodes.list(),
        "regions.json": lambda: api.get("/v1/regions"),
        "operator-raft.json": lambda: api.operator.raft_configuration(),
        "operator-autopilot-health.json":
            lambda: api.operator.autopilot_health(),
        "operator-scheduler-config.json":
            lambda: api.operator.scheduler_config(),
        "pprof-goroutine.txt": lambda: api.agent.pprof("goroutine"),
        "pprof-heap.txt": lambda: api.agent.pprof("heap"),
        "pprof-profile.txt":
            lambda: api.agent.pprof("profile", seconds=args.seconds),
    }
    out = args.output or f"nomad-debug-{int(_time.time())}.tar.gz"
    with tarfile.open(out, "w:gz") as tar:
        for name, fn in captures.items():
            try:
                payload = fn()
            except Exception as e:              # noqa: BLE001
                payload = {"error": str(e)}
            data = (payload if isinstance(payload, str)
                    else _json.dumps(payload, indent=2, default=str)).encode()
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            info.mtime = int(_time.time())
            tar.addfile(info, io.BytesIO(data))
            print(f"  captured {name}")
    print(f"Created debug archive: {out}")
    return 0


def cmd_operator_raft_list(args) -> int:
    api = make_client(args)
    cfg = api.operator.raft_configuration()
    servers = cfg.get("Servers") or []
    print(dict_rows(servers, ["ID", "Node", "Address", "Leader", "Voter"]))
    return 0


def cmd_server_members(args) -> int:
    api = make_client(args)
    res = api.agent.members()
    members = res.get("Members") or []
    rows = ["Name|Address|Status|Leader|Region|DC"]
    for m in members:
        rows.append(
            f"{m.get('Name', '')}|{m.get('Addr', '')}|{m.get('Status', '')}|"
            f"{m.get('Leader', False)}|"
            f"{(m.get('Tags') or {}).get('region', '')}|"
            f"{(m.get('Tags') or {}).get('dc', '')}"
        )
    print(format_list(rows))
    return 0


def cmd_system_gc(args) -> int:
    api = make_client(args)
    api.system.gc()
    return 0


def cmd_system_reconcile(args) -> int:
    api = make_client(args)
    api.system.reconcile_summaries()
    return 0


def cmd_ui(args) -> int:
    print(f"Opening URL \"{args.address}/ui\"")
    return 0


def cmd_version(args) -> int:
    print(f"nomad-tpu v{VERSION}")
    return 0


# --- agent --------------------------------------------------------------


def cmd_agent(args) -> int:
    """Run an agent process (command/agent/command.go Run)."""
    from nomad_tpu_torch.api.agent import Agent, AgentConfig

    if args.config:
        from nomad_tpu_torch.api.config_file import load_config_files
        try:
            cfg = load_config_files(args.config)
        except (OSError, ValueError) as e:
            return _fail(f"loading config: {e}")
        if args.dev:
            cfg.server_enabled = cfg.client_enabled = True
        cfg.server_enabled = cfg.server_enabled or args.server
        cfg.client_enabled = cfg.client_enabled or args.client
        if not (cfg.server_enabled or cfg.client_enabled):
            return _fail("config enables neither server nor client")
    elif args.dev:
        cfg = AgentConfig.dev()
    elif not args.server and not args.client:
        return _fail("must specify either -server, -client or -dev")
    else:
        cfg = AgentConfig(
            server_enabled=args.server, client_enabled=args.client
        )
    # explicit flags override config files (config.go merge order);
    # -bind/-http-port default to None so "flag given" is unambiguous
    if args.name:
        cfg.name = args.name
    cfg.region = args.region or cfg.region
    cfg.datacenter = args.dc or cfg.datacenter
    if args.bind is not None:
        cfg.bind_addr = args.bind
    if args.http_port is not None:
        cfg.http_port = args.http_port
    elif cfg.http_port == 0:
        cfg.http_port = 4646   # reference default port
    if args.raft_peers:
        cfg.raft_peers = list(args.raft_peers)
    if args.raft_port is not None:
        cfg.raft_port = args.raft_port
    if args.raft_advertise:
        cfg.raft_advertise = args.raft_advertise
    if args.plugin_dir:
        cfg.plugin_dir = args.plugin_dir
    if args.device:
        cfg.device = args.device
    if args.tls_cert or args.tls_key:
        if not (args.tls_cert and args.tls_key and args.tls_ca):
            return _fail("TLS needs -tls-ca, -tls-cert and -tls-key")
        from nomad_tpu_torch.utils.tlsutil import TLSConfig
        cfg.tls = TLSConfig(
            enabled=True, ca_file=args.tls_ca, cert_file=args.tls_cert,
            key_file=args.tls_key,
            verify_https_client=args.tls_verify_https_client,
        )
    try:
        agent = Agent(cfg)
    except (ValueError, NotImplementedError) as e:
        return _fail(str(e))
    agent.start()
    print(f"==> Nomad-TPU agent started! HTTP at {agent.http_addr}")
    mode = ("server+client" if cfg.server_enabled and cfg.client_enabled
            else "server" if cfg.server_enabled else "client")
    print(f"    Mode: {mode}  Region: {cfg.region}  DC: {cfg.datacenter}")

    stop = {"flag": False}

    def _sig(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        while not stop["flag"]:
            time.sleep(0.2)
    finally:
        print("==> Caught signal, gracefully shutting down")
        agent.shutdown()
    return 0


# --- parser -------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad-tpu")
    p.add_argument("-address", default=os.environ.get(
        "NOMAD_ADDR", "http://127.0.0.1:4646"))
    p.add_argument("-token", default=os.environ.get("NOMAD_TOKEN", ""))
    p.add_argument("-namespace", default=os.environ.get(
        "NOMAD_NAMESPACE", "default"))
    p.add_argument("-region", default=os.environ.get("NOMAD_REGION", ""))
    p.add_argument("-ca-cert", dest="ca_cert",
                   default=os.environ.get("NOMAD_CACERT", ""))
    p.add_argument("-client-cert", dest="client_cert",
                   default=os.environ.get("NOMAD_CLIENT_CERT", ""))
    p.add_argument("-client-key", dest="client_key",
                   default=os.environ.get("NOMAD_CLIENT_KEY", ""))
    sub = p.add_subparsers(dest="command")

    # agent
    ag = sub.add_parser("agent", help="run an agent")
    ag.add_argument("-dev", action="store_true")
    ag.add_argument("-server", action="store_true")
    ag.add_argument("-client", action="store_true")
    ag.add_argument("-name", default="")
    ag.add_argument("-dc", default="")
    ag.add_argument("-bind", default=None)
    ag.add_argument("-http-port", dest="http_port", type=int, default=None)
    ag.add_argument("-config", action="append", default=[],
                    help="config file or directory (repeatable)")
    ag.add_argument("-raft-port", dest="raft_port", type=int, default=None)
    ag.add_argument("-raft-peer", dest="raft_peers", action="append",
                    default=[], help="raft address of a server peer "
                    "(repeatable; enables HA mode)")
    ag.add_argument("-raft-advertise", dest="raft_advertise", default="",
                    help="address peers dial this server's raft on "
                    "(required with a wildcard -bind)")
    ag.add_argument("-plugin-dir", dest="plugin_dir", default="",
                    help="directory of external driver plugins")
    ag.add_argument("-device", default=None,
                    help="device the server places on (default: the "
                    "CUDA card; 'cpu' runs the plain versions)")
    ag.add_argument("-tls-ca", dest="tls_ca", default="")
    ag.add_argument("-tls-cert", dest="tls_cert", default="")
    ag.add_argument("-tls-key", dest="tls_key", default="")
    ag.add_argument("-tls-verify-https-client", action="store_true",
                    dest="tls_verify_https_client")
    ag.set_defaults(fn=cmd_agent)

    # job
    job = sub.add_parser("job", help="job commands").add_subparsers(
        dest="subcommand", required=True)
    jr = job.add_parser("run")
    jr.add_argument("jobfile")
    jr.add_argument("-detach", action="store_true")
    jr.add_argument("-var", action="append", dest="var")
    jr.set_defaults(fn=cmd_job_run)
    jp = job.add_parser("plan")
    jp.add_argument("jobfile")
    jp.add_argument("-var", action="append", dest="var")
    jp.set_defaults(fn=cmd_job_plan)
    jv = job.add_parser("validate")
    jv.add_argument("jobfile")
    jv.add_argument("-var", action="append", dest="var")
    jv.set_defaults(fn=cmd_job_validate)
    js = job.add_parser("status")
    js.add_argument("job_id", nargs="?", default="")
    js.set_defaults(fn=cmd_job_status)
    jst = job.add_parser("stop")
    jst.add_argument("job_id")
    jst.add_argument("-purge", action="store_true")
    jst.add_argument("-detach", action="store_true")
    jst.set_defaults(fn=cmd_job_stop)
    ji = job.add_parser("inspect")
    ji.add_argument("job_id")
    ji.set_defaults(fn=cmd_job_inspect)
    jh = job.add_parser("history")
    jh.add_argument("job_id")
    jh.set_defaults(fn=cmd_job_history)
    jrev = job.add_parser("revert")
    jrev.add_argument("job_id")
    jrev.add_argument("version", type=int)
    jrev.add_argument("-detach", action="store_true")
    jrev.set_defaults(fn=cmd_job_revert)
    jd = job.add_parser("dispatch")
    jd.add_argument("job_id")
    jd.add_argument("input_file", nargs="?", default="")
    jd.add_argument("-meta", action="append")
    jd.add_argument("-detach", action="store_true")
    jd.set_defaults(fn=cmd_job_dispatch)
    jsc = job.add_parser("scale")
    jsc.add_argument("job_id")
    jsc.add_argument("group")
    jsc.add_argument("count", type=int)
    jsc.add_argument("-detach", action="store_true")
    jsc.set_defaults(fn=cmd_job_scale)
    jpf = job.add_parser("periodic-force")
    jpf.add_argument("job_id")
    jpf.set_defaults(fn=cmd_job_periodic_force)
    jdp = job.add_parser("deployments")
    jdp.add_argument("job_id")
    jdp.set_defaults(fn=cmd_job_deployments)

    # run/stop/plan top-level aliases (reference keeps both)
    run = sub.add_parser("run")
    run.add_argument("jobfile")
    run.add_argument("-detach", action="store_true")
    run.add_argument("-var", action="append", dest="var")
    run.set_defaults(fn=cmd_job_run)
    stop = sub.add_parser("stop")
    stop.add_argument("job_id")
    stop.add_argument("-purge", action="store_true")
    stop.add_argument("-detach", action="store_true")
    stop.set_defaults(fn=cmd_job_stop)
    plan = sub.add_parser("plan")
    plan.add_argument("jobfile")
    plan.add_argument("-var", action="append", dest="var")
    plan.set_defaults(fn=cmd_job_plan)

    # node
    node = sub.add_parser("node", help="node commands").add_subparsers(
        dest="subcommand", required=True)
    ns = node.add_parser("status")
    ns.add_argument("node_id", nargs="?", default="")
    ns.set_defaults(fn=cmd_node_status)
    nd = node.add_parser("drain")
    nd.add_argument("node_id")
    nd.add_argument("-enable", action="store_true")
    nd.add_argument("-disable", action="store_true")
    nd.add_argument("-deadline", type=float, default=0.0)
    nd.set_defaults(fn=cmd_node_drain)
    ne = node.add_parser("eligibility")
    ne.add_argument("node_id")
    ne.add_argument("-enable", action="store_true")
    ne.add_argument("-disable", action="store_true")
    ne.set_defaults(fn=cmd_node_eligibility)

    # alloc
    alloc = sub.add_parser("alloc", help="alloc commands").add_subparsers(
        dest="subcommand", required=True)
    als = alloc.add_parser("status")
    als.add_argument("alloc_id")
    als.set_defaults(fn=cmd_alloc_status)
    alst = alloc.add_parser("stop")
    alst.add_argument("alloc_id")
    alst.add_argument("-detach", action="store_true")
    alst.set_defaults(fn=cmd_alloc_stop)
    alog = alloc.add_parser("logs")
    alog.add_argument("alloc_id")
    alog.add_argument("task")
    alog.add_argument("-stderr", action="store_true")
    alog.add_argument("-f", dest="follow", action="store_true")
    alog.set_defaults(fn=cmd_alloc_logs)
    ares = alloc.add_parser("restart")
    ares.add_argument("alloc_id")
    ares.add_argument("task", nargs="?", default="")
    ares.set_defaults(fn=cmd_alloc_restart)
    asig = alloc.add_parser("signal")
    asig.add_argument("-s", dest="signal", default="SIGTERM")
    asig.add_argument("alloc_id")
    asig.add_argument("task", nargs="?", default="")
    asig.set_defaults(fn=cmd_alloc_signal)
    aex = alloc.add_parser("exec")
    aex.add_argument("-task", required=True)
    aex.add_argument("-i", dest="interactive", action="store_true",
                     help="stream stdin (websocket exec)")
    aex.add_argument("-t", dest="tty", action="store_true",
                     help="allocate a pty")
    aex.add_argument("alloc_id")
    aex.add_argument("cmd", nargs="+")
    aex.set_defaults(fn=cmd_alloc_exec)
    afs = alloc.add_parser("fs")
    afs.add_argument("alloc_id")
    afs.add_argument("path", nargs="?", default="/")
    afs.set_defaults(fn=cmd_alloc_fs)

    # eval
    ev = sub.add_parser("eval", help="eval commands").add_subparsers(
        dest="subcommand", required=True)
    evl = ev.add_parser("list")
    evl.add_argument("-limit", type=int, default=50)
    evl.set_defaults(fn=cmd_eval_list)
    evs = ev.add_parser("status")
    evs.add_argument("eval_id")
    evs.set_defaults(fn=cmd_eval_status)

    # deployment
    dep = sub.add_parser("deployment").add_subparsers(
        dest="subcommand", required=True)
    dl = dep.add_parser("list")
    dl.set_defaults(fn=cmd_deployment_list)
    ds = dep.add_parser("status")
    ds.add_argument("deployment_id")
    ds.set_defaults(fn=cmd_deployment_status)
    dpm = dep.add_parser("promote")
    dpm.add_argument("deployment_id")
    dpm.set_defaults(fn=cmd_deployment_promote)
    df = dep.add_parser("fail")
    df.add_argument("deployment_id")
    df.set_defaults(fn=cmd_deployment_fail)
    dpa = dep.add_parser("pause")
    dpa.add_argument("deployment_id")
    dpa.add_argument("-resume", action="store_true")
    dpa.set_defaults(fn=cmd_deployment_pause)

    # status
    st = sub.add_parser("status", help="generic identifier lookup")
    st.add_argument("identifier", nargs="?", default="")
    st.set_defaults(fn=cmd_status)

    # namespace
    nsp = sub.add_parser("namespace").add_subparsers(
        dest="subcommand", required=True)
    nl = nsp.add_parser("list")
    nl.set_defaults(fn=cmd_namespace_list)
    na = nsp.add_parser("apply")
    na.add_argument("name")
    na.add_argument("-description", default="")
    na.set_defaults(fn=cmd_namespace_apply)
    ndel = nsp.add_parser("delete")
    ndel.add_argument("name")
    ndel.set_defaults(fn=cmd_namespace_delete)

    # service (native discovery)
    svc = sub.add_parser("service").add_subparsers(dest="subcommand",
                                                   required=True)
    svl = svc.add_parser("list")
    svl.set_defaults(fn=cmd_service_list)
    svi = svc.add_parser("info")
    svi.add_argument("service_name")
    svi.set_defaults(fn=cmd_service_info)
    svd = svc.add_parser("delete")
    svd.add_argument("service_name")
    svd.add_argument("service_id")
    svd.set_defaults(fn=cmd_service_delete)

    # volume + plugin (CSI)
    vol = sub.add_parser("volume").add_subparsers(dest="subcommand",
                                                  required=True)
    vreg = vol.add_parser("register")
    vreg.add_argument("file")
    vreg.set_defaults(fn=cmd_volume_register)
    vst = vol.add_parser("status")
    vst.add_argument("volume_id", nargs="?", default="")
    vst.set_defaults(fn=cmd_volume_status)
    vdereg = vol.add_parser("deregister")
    vdereg.add_argument("volume_id")
    vdereg.add_argument("-force", action="store_true")
    vdereg.set_defaults(fn=cmd_volume_deregister)
    vdet = vol.add_parser("detach")
    vdet.add_argument("volume_id")
    vdet.add_argument("-node", default="")
    vdet.set_defaults(fn=cmd_volume_detach)

    plug = sub.add_parser("plugin").add_subparsers(dest="subcommand",
                                                   required=True)
    pst = plug.add_parser("status")
    pst.add_argument("plugin_id", nargs="?", default="")
    pst.set_defaults(fn=cmd_plugin_status)

    # acl
    acl = sub.add_parser("acl").add_subparsers(dest="subcommand",
                                               required=True)
    ab = acl.add_parser("bootstrap")
    ab.set_defaults(fn=cmd_acl_bootstrap)
    apol = acl.add_parser("policy").add_subparsers(dest="subsub",
                                                   required=True)
    apa = apol.add_parser("apply")
    apa.add_argument("name")
    apa.add_argument("rules_file")
    apa.add_argument("-description", default="")
    apa.set_defaults(fn=cmd_acl_policy_apply)
    apl = apol.add_parser("list")
    apl.set_defaults(fn=cmd_acl_policy_list)
    apd = apol.add_parser("delete")
    apd.add_argument("name")
    apd.set_defaults(fn=cmd_acl_policy_delete)
    atok = acl.add_parser("token").add_subparsers(dest="subsub",
                                                  required=True)
    atc = atok.add_parser("create")
    atc.add_argument("-name", default="")
    atc.add_argument("-type", default="client")
    atc.add_argument("-policy", action="append")
    atc.add_argument("-global", dest="global_token", action="store_true")
    atc.set_defaults(fn=cmd_acl_token_create)
    atl = atok.add_parser("list")
    atl.set_defaults(fn=cmd_acl_token_list)
    atd = atok.add_parser("delete")
    atd.add_argument("accessor_id")
    atd.set_defaults(fn=cmd_acl_token_delete)

    # operator
    op = sub.add_parser("operator").add_subparsers(dest="subcommand",
                                                   required=True)
    osch = op.add_parser("scheduler").add_subparsers(dest="subsub",
                                                     required=True)
    og = osch.add_parser("get-config")
    og.set_defaults(fn=cmd_operator_scheduler_get)
    ose = osch.add_parser("set-config")
    ose.add_argument("-scheduler-algorithm", dest="scheduler_algorithm",
                     choices=["binpack", "spread"], default="")
    ose.set_defaults(fn=cmd_operator_scheduler_set)
    osnap = op.add_parser("snapshot").add_subparsers(dest="subsub",
                                                     required=True)
    oss = osnap.add_parser("save")
    oss.add_argument("file")
    oss.set_defaults(fn=cmd_operator_snapshot_save)
    osr = osnap.add_parser("restore")
    osr.add_argument("file")
    osr.set_defaults(fn=cmd_operator_snapshot_restore)
    oauto = op.add_parser("autopilot").add_subparsers(dest="subsub",
                                                      required=True)
    oag = oauto.add_parser("get-config")
    oag.set_defaults(fn=cmd_operator_autopilot_get)
    oas = oauto.add_parser("set-config")
    oas.add_argument("-cleanup-dead-servers", dest="cleanup_dead_servers",
                     choices=["true", "false"], default=None)
    oas.add_argument("-last-contact-threshold",
                     dest="last_contact_threshold", default="")
    oas.set_defaults(fn=cmd_operator_autopilot_set)
    oah = oauto.add_parser("health")
    oah.set_defaults(fn=cmd_operator_autopilot_health)
    oraft = op.add_parser("raft").add_subparsers(dest="subsub",
                                                 required=True)
    orl = oraft.add_parser("list-peers")
    orl.set_defaults(fn=cmd_operator_raft_list)
    odbg = op.add_parser("debug")
    odbg.add_argument("-output", default="")
    odbg.add_argument("-seconds", type=int, default=2)
    odbg.set_defaults(fn=cmd_operator_debug)

    # monitor
    mon = sub.add_parser("monitor", help="stream agent logs")
    mon.add_argument("-log-level", dest="log_level", default="info")
    mon.set_defaults(fn=cmd_monitor)

    # tls
    tls = sub.add_parser("tls", help="TLS certificate helpers") \
        .add_subparsers(dest="subcommand", required=True)
    tca = tls.add_parser("ca").add_subparsers(dest="verb", required=True)
    tcac = tca.add_parser("create")
    tcac.add_argument("-common-name", dest="common_name",
                      default="nomad-tpu CA")
    tcac.set_defaults(fn=cmd_tls_ca_create)
    tcert = tls.add_parser("cert").add_subparsers(dest="verb", required=True)
    tcc = tcert.add_parser("create")
    tcc.add_argument("-ca", default="nomad-agent-ca.pem")
    tcc.add_argument("-key", default="nomad-agent-ca-key.pem")
    tcc.add_argument("-server", action="store_true")
    tcc.add_argument("-client", action="store_true")
    tcc.add_argument("-region", dest="cert_region", default="global")
    tcc.add_argument("-additional-dnsname", action="append",
                     dest="additional_dnsname")
    tcc.set_defaults(fn=cmd_tls_cert_create)

    # server
    srv = sub.add_parser("server").add_subparsers(dest="subcommand",
                                                  required=True)
    sm = srv.add_parser("members")
    sm.set_defaults(fn=cmd_server_members)

    # system
    system = sub.add_parser("system").add_subparsers(dest="subcommand",
                                                     required=True)
    sg = system.add_parser("gc")
    sg.set_defaults(fn=cmd_system_gc)
    sr = system.add_parser("reconcile").add_subparsers(dest="subsub",
                                                       required=True)
    srs = sr.add_parser("summaries")
    srs.set_defaults(fn=cmd_system_reconcile)

    # ui / version
    ui = sub.add_parser("ui")
    ui.set_defaults(fn=cmd_ui)
    ver = sub.add_parser("version")
    ver.set_defaults(fn=cmd_version)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 1
    try:
        return args.fn(args)
    except APIError as e:
        return _fail(str(e))
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
