"""Map parsed HCL / JSON jobspecs onto Job structs.

Reference behavior: jobspec/parse.go (block -> struct mapping, duration
parsing, singleton block enforcement) and jobspec2's HCL2 grammar. One
`job "id" { ... }` block with nested group/task/resources/network/
constraint/affinity/spread/update/migrate/restart/reschedule/periodic/
parameterized/scaling/volume/service/template/artifact/logs/lifecycle
blocks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from nomad_tpu_torch.jobspec.hcl import Body, duration_s, parse
from nomad_tpu_torch.structs.constraints import Affinity, Constraint, Spread, SpreadTarget
from nomad_tpu_torch.structs.job import (
    EphemeralDisk,
    Job,
    LogConfig,
    MigrateStrategy,
    ParameterizedJobConfig,
    PeriodicConfig,
    ReschedulePolicy,
    RestartPolicy,
    ScalingPolicy,
    Service,
    Task,
    TaskGroup,
    TaskLifecycleConfig,
    Template,
    UpdateStrategy,
    VolumeRequest,
)
from nomad_tpu_torch.structs.network import NetworkResource, Port
from nomad_tpu_torch.structs.resources import RequestedDevice, Resources


def parse_hcl(src: str, variables: Optional[Dict] = None,
              env_variables: Optional[Dict] = None) -> Job:
    """HCL jobspec text -> Job (jobspec2/parse.go Parse).

    ``variables`` overrides `variable` block defaults (the -var CLI
    flag — undeclared names error); ``env_variables`` are NOMAD_VAR_*
    values (undeclared names ignored)."""
    from nomad_tpu_torch.jobspec.eval import evaluate

    body = evaluate(parse(src), variables, env_variables)
    found = body.first_block("job")
    if found is None:
        raise ValueError("jobspec must contain a 'job' block")
    labels, jb = found
    if not labels:
        raise ValueError("job block requires a label: job \"name\" { ... }")
    return _map_job(labels[0], jb)


def parse_json(data: Dict) -> Job:
    """JSON jobspec (the API wire shape) -> Job."""
    from nomad_tpu_torch.api.codec import decode

    payload = data.get("Job", data)
    job = decode(payload, Job)
    if job is None or not job.id:
        raise ValueError("Job.ID is required")
    return job


# -- block mappers -------------------------------------------------------


def _constraints(body: Body) -> List[Constraint]:
    out = []
    for _labels, cb in body.get_blocks("constraint"):
        a = cb.attrs
        operand = a.get("operator", a.get("op", "="))
        # sugar forms (jobspec/parse.go parseConstraints)
        if "distinct_hosts" in a:
            out.append(Constraint(operand="distinct_hosts"))
            continue
        if "distinct_property" in a:
            out.append(Constraint(
                operand="distinct_property",
                ltarget=str(a["distinct_property"]),
                rtarget=str(a.get("value", "")),
            ))
            continue
        for sugar in ("regexp", "version", "semver", "set_contains"):
            if sugar in a:
                operand = sugar
                a = {**a, "value": a[sugar]}
                break
        out.append(Constraint(
            ltarget=str(a.get("attribute", "")),
            rtarget=str(a.get("value", "")),
            operand=str(operand),
        ))
    return out


def _affinities(body: Body) -> List[Affinity]:
    out = []
    for _labels, ab in body.get_blocks("affinity"):
        a = ab.attrs
        operand = a.get("operator", "=")
        for sugar in ("regexp", "version", "semver", "set_contains",
                      "set_contains_any", "set_contains_all"):
            if sugar in a:
                operand = sugar
                a = {**a, "value": a[sugar]}
                break
        out.append(Affinity(
            ltarget=str(a.get("attribute", "")),
            rtarget=str(a.get("value", "")),
            operand=str(operand),
            weight=int(a.get("weight", 50)),
        ))
    return out


def _spreads(body: Body) -> List[Spread]:
    out = []
    for _labels, sb in body.get_blocks("spread"):
        targets = [
            SpreadTarget(value=labels[0] if labels else "",
                         percent=int(tb.attrs.get("percent", 0)))
            for labels, tb in sb.get_blocks("target")
        ]
        out.append(Spread(
            attribute=str(sb.attrs.get("attribute", "")),
            weight=int(sb.attrs.get("weight", 50)),
            spread_target=targets,
        ))
    return out


def _network(nb: Body) -> NetworkResource:
    net = NetworkResource(
        mode=str(nb.attrs.get("mode", "host")),
        mbits=int(nb.attrs.get("mbits", 0)),
    )
    for labels, pb in nb.get_blocks("port"):
        label = labels[0] if labels else ""
        port = Port(
            label=label,
            value=int(pb.attrs.get("static", 0)),
            to=int(pb.attrs.get("to", 0)),
            host_network=str(pb.attrs.get("host_network", "default")),
        )
        if port.value:
            net.reserved_ports.append(port)
        else:
            net.dynamic_ports.append(port)
    return net


def _resources(rb: Body) -> Resources:
    r = Resources(
        cpu=int(rb.attrs.get("cpu", 100)),
        cores=int(rb.attrs.get("cores", 0)),
        memory_mb=int(rb.attrs.get("memory", 300)),
        memory_max_mb=int(rb.attrs.get("memory_max", 0)),
        disk_mb=int(rb.attrs.get("disk", 0)),
    )
    for labels, db in rb.get_blocks("device"):
        r.devices.append(RequestedDevice(
            name=labels[0] if labels else "",
            count=int(db.attrs.get("count", 1)),
            constraints=_constraints(db),
            affinities=_affinities(db),
        ))
    for _labels, nb in rb.get_blocks("network"):
        r.networks.append(_network(nb))
    return r


def _update(ub: Body) -> UpdateStrategy:
    a = ub.attrs
    return UpdateStrategy(
        stagger_s=duration_s(a.get("stagger"), 30.0),
        max_parallel=int(a.get("max_parallel", 1)),
        health_check=str(a.get("health_check", "checks")),
        min_healthy_time_s=duration_s(a.get("min_healthy_time"), 10.0),
        healthy_deadline_s=duration_s(a.get("healthy_deadline"), 300.0),
        progress_deadline_s=duration_s(a.get("progress_deadline"), 600.0),
        auto_revert=bool(a.get("auto_revert", False)),
        auto_promote=bool(a.get("auto_promote", False)),
        canary=int(a.get("canary", 0)),
    )


def _task(name: str, tb: Body) -> Task:
    a = tb.attrs
    task = Task(
        name=name,
        driver=str(a.get("driver", "mock")),
        env={k: str(v) for k, v in (a.get("env") or {}).items()}
        if isinstance(a.get("env"), dict) else {},
        meta={k: str(v) for k, v in (a.get("meta") or {}).items()}
        if isinstance(a.get("meta"), dict) else {},
        kill_timeout_s=duration_s(a.get("kill_timeout"), 5.0),
        kill_signal=str(a.get("kill_signal", "")),
        leader=bool(a.get("leader", False)),
        user=str(a.get("user", "")),
        constraints=_constraints(tb),
        affinities=_affinities(tb),
    )
    for _l, eb in tb.get_blocks("env"):
        task.env.update({k: str(v) for k, v in eb.attrs.items()})
    for _l, mb in tb.get_blocks("meta"):
        task.meta.update({k: str(v) for k, v in mb.attrs.items()})
    cfg = tb.first_block("config")
    if cfg is not None:
        task.config = _body_to_dict(cfg[1])
    res = tb.first_block("resources")
    if res is not None:
        task.resources = _resources(res[1])
    lc = tb.first_block("lifecycle")
    if lc is not None:
        task.lifecycle = TaskLifecycleConfig(
            hook=str(lc[1].attrs.get("hook", "")),
            sidecar=bool(lc[1].attrs.get("sidecar", False)),
        )
    logs = tb.first_block("logs")
    if logs is not None:
        task.log_config = LogConfig(
            max_files=int(logs[1].attrs.get("max_files", 10)),
            max_file_size_mb=int(logs[1].attrs.get("max_file_size", 10)),
        )
    for _l, t in tb.get_blocks("template"):
        task.templates.append(Template(
            source_path=str(t.attrs.get("source", "")),
            dest_path=str(t.attrs.get("destination", "")),
            embedded_tmpl=str(t.attrs.get("data", "")),
            change_mode=str(t.attrs.get("change_mode", "restart")),
            change_signal=str(t.attrs.get("change_signal", "")),
        ))
    vb = tb.first_block("vault")
    if vb is not None:
        from nomad_tpu_torch.structs.job import Vault
        task.vault = Vault(
            policies=[str(p) for p in vb[1].attrs.get("policies", [])],
            env=bool(vb[1].attrs.get("env", True)),
            change_mode=str(vb[1].attrs.get("change_mode", "restart")),
            change_signal=str(vb[1].attrs.get("change_signal", "")),
        )
    for _l, art in tb.get_blocks("artifact"):
        task.artifacts.append(_body_to_dict(art))
    for labels, sb in tb.get_blocks("service"):
        task.services.append(_service(labels, sb))
    return task


def _service(labels: List[str], sb: Body) -> Service:
    svc = Service(
        name=str(sb.attrs.get("name", labels[0] if labels else "")),
        port_label=str(sb.attrs.get("port", "")),
        provider=str(sb.attrs.get("provider", "builtin")),
        tags=[str(t) for t in sb.attrs.get("tags", [])],
    )
    for _l, cb in sb.get_blocks("check"):
        check = _body_to_dict(cb)
        for dur in ("interval", "timeout"):
            if dur in check:
                check[dur] = duration_s(check[dur])
        svc.checks.append(check)
    # connect stanza (services.go ConsulConnect): sidecar_service with
    # optional proxy { upstreams { ... } local_service_port }, or
    # native = true
    for _l, conb in sb.get_blocks("connect"):
        if conb.attrs.get("native"):
            svc.connect["native"] = True
        for _sl, scb in conb.get_blocks("sidecar_service"):
            sidecar: dict = {}
            for _pl, pb in scb.get_blocks("proxy"):
                proxy = {"upstreams": []}
                if "local_service_port" in pb.attrs:
                    proxy["local_service_port"] = int(
                        pb.attrs["local_service_port"])
                for _ul, ub in pb.get_blocks("upstreams"):
                    proxy["upstreams"].append({
                        "destination_name": str(
                            ub.attrs.get("destination_name", "")),
                        "local_bind_port": int(
                            ub.attrs.get("local_bind_port", 0)),
                    })
                sidecar["proxy"] = proxy
            svc.connect["sidecar_service"] = sidecar
    return svc


def _group(name: str, gb: Body) -> TaskGroup:
    a = gb.attrs
    tg = TaskGroup(
        name=name,
        count=int(a.get("count", 1)),
        constraints=_constraints(gb),
        affinities=_affinities(gb),
        spreads=_spreads(gb),
        meta={k: str(v) for k, v in (a.get("meta") or {}).items()}
        if isinstance(a.get("meta"), dict) else {},
    )
    if "stop_after_client_disconnect" in a:
        tg.stop_after_client_disconnect_s = duration_s(
            a["stop_after_client_disconnect"]
        )
    if "max_client_disconnect" in a:
        tg.max_client_disconnect_s = duration_s(a["max_client_disconnect"])
    for _l, mb in gb.get_blocks("meta"):
        tg.meta.update({k: str(v) for k, v in mb.attrs.items()})
    for _l, nb in gb.get_blocks("network"):
        tg.networks.append(_network(nb))
    for labels, tb in gb.get_blocks("task"):
        tg.tasks.append(_task(labels[0] if labels else "", tb))
    for labels, vb in gb.get_blocks("volume"):
        va = vb.attrs
        tg.volumes[labels[0] if labels else ""] = VolumeRequest(
            name=labels[0] if labels else "",
            type=str(va.get("type", "host")),
            source=str(va.get("source", "")),
            read_only=bool(va.get("read_only", False)),
            access_mode=str(va.get("access_mode", "")),
            attachment_mode=str(va.get("attachment_mode", "")),
            per_alloc=bool(va.get("per_alloc", False)),
        )
    for labels, sb in gb.get_blocks("service"):
        tg.services.append(_service(labels, sb))
    rp = gb.first_block("restart")
    if rp is not None:
        ra = rp[1].attrs
        tg.restart_policy = RestartPolicy(
            attempts=int(ra.get("attempts", 2)),
            interval_s=duration_s(ra.get("interval"), 1800.0),
            delay_s=duration_s(ra.get("delay"), 15.0),
            mode=str(ra.get("mode", "fail")),
        )
    rs = gb.first_block("reschedule")
    if rs is not None:
        ra = rs[1].attrs
        tg.reschedule_policy = ReschedulePolicy(
            attempts=int(ra.get("attempts", 0)),
            interval_s=duration_s(ra.get("interval"), 0.0),
            delay_s=duration_s(ra.get("delay"), 30.0),
            delay_function=str(ra.get("delay_function", "exponential")),
            max_delay_s=duration_s(ra.get("max_delay"), 3600.0),
            unlimited=bool(ra.get("unlimited", False)),
        )
    ed = gb.first_block("ephemeral_disk")
    if ed is not None:
        ea = ed[1].attrs
        tg.ephemeral_disk = EphemeralDisk(
            size_mb=int(ea.get("size", 300)),
            sticky=bool(ea.get("sticky", False)),
            migrate=bool(ea.get("migrate", False)),
        )
    up = gb.first_block("update")
    if up is not None:
        tg.update = _update(up[1])
    mg = gb.first_block("migrate")
    if mg is not None:
        ma = mg[1].attrs
        tg.migrate = MigrateStrategy(
            max_parallel=int(ma.get("max_parallel", 1)),
            health_check=str(ma.get("health_check", "checks")),
            min_healthy_time_s=duration_s(ma.get("min_healthy_time"), 10.0),
            healthy_deadline_s=duration_s(ma.get("healthy_deadline"), 300.0),
        )
    sc = gb.first_block("scaling")
    if sc is not None:
        sa = sc[1].attrs
        policy = sc[1].first_block("policy")
        tg.scaling = ScalingPolicy(
            min=int(sa.get("min", 0)),
            max=int(sa.get("max", 0)),
            enabled=bool(sa.get("enabled", True)),
            policy=_body_to_dict(policy[1]) if policy else {},
        )
    return tg


def _map_job(job_id: str, jb: Body) -> Job:
    a = jb.attrs
    job = Job(
        id=job_id,
        name=str(a.get("name", job_id)),
        namespace=str(a.get("namespace", "default")),
        region=str(a.get("region", "global")),
        type=str(a.get("type", "service")),
        priority=int(a.get("priority", 50)),
        datacenters=[str(d) for d in a.get("datacenters", ["dc1"])],
        node_pool=str(a.get("node_pool", "default")),
        all_at_once=bool(a.get("all_at_once", False)),
        constraints=_constraints(jb),
        affinities=_affinities(jb),
        spreads=_spreads(jb),
        meta={k: str(v) for k, v in (a.get("meta") or {}).items()}
        if isinstance(a.get("meta"), dict) else {},
    )
    for _l, mb in jb.get_blocks("meta"):
        job.meta.update({k: str(v) for k, v in mb.attrs.items()})
    up = jb.first_block("update")
    if up is not None:
        job.update = _update(up[1])
    per = jb.first_block("periodic")
    if per is not None:
        pa = per[1].attrs
        job.periodic = PeriodicConfig(
            enabled=bool(pa.get("enabled", True)),
            spec=str(pa.get("cron", pa.get("spec", ""))),
            prohibit_overlap=bool(pa.get("prohibit_overlap", False)),
            timezone=str(pa.get("time_zone", "UTC")),
        )
    mr = jb.first_block("multiregion")
    if mr is not None:
        mrb = mr[1]
        multiregion: Dict = {"strategy": {}, "regions": []}
        strat = mrb.first_block("strategy")
        if strat is not None:
            sa = strat[1].attrs
            multiregion["strategy"] = {
                "max_parallel": int(sa.get("max_parallel", 0) or 0),
                "on_failure": str(sa.get("on_failure", "")),
            }
        for labels, rb in mrb.get_blocks("region"):
            ra = rb.attrs
            multiregion["regions"].append({
                "name": labels[0] if labels else "",
                "count": int(ra.get("count", 0) or 0),
                "datacenters": [str(d) for d in ra.get("datacenters", [])],
                "meta": {k: str(v) for k, v in (ra.get("meta") or {}).items()}
                if isinstance(ra.get("meta"), dict) else {},
            })
        job.multiregion = multiregion
    par = jb.first_block("parameterized")
    if par is not None:
        pa = par[1].attrs
        job.parameterized = ParameterizedJobConfig(
            payload=str(pa.get("payload", "optional")),
            meta_required=[str(m) for m in pa.get("meta_required", [])],
            meta_optional=[str(m) for m in pa.get("meta_optional", [])],
        )
    for labels, gb in jb.get_blocks("group"):
        job.task_groups.append(_group(labels[0] if labels else "", gb))
    # bare task at job level gets an implicit group (jobspec/parse.go)
    for labels, tb in jb.get_blocks("task"):
        name = labels[0] if labels else ""
        job.task_groups.append(TaskGroup(name=name, tasks=[_task(name, tb)]))
    return job


def _body_to_dict(body: Body) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(body.attrs)
    for btype, labels, sub in body.blocks:
        entry = _body_to_dict(sub)
        if labels:
            out.setdefault(btype, {})[labels[0]] = entry
        else:
            out.setdefault(btype, []) if isinstance(out.get(btype), list) else None
            if isinstance(out.get(btype), list):
                out[btype].append(entry)
            elif btype in out:
                out[btype] = [out[btype], entry]
            else:
                out[btype] = entry
    return out
