"""Agent configuration files.

Reference behavior: command/agent/config.go:39 + config_parse.go —
the agent loads one or more HCL/JSON config files (or directories),
merges them in order (later wins), then applies CLI flags on top.
This module parses the same shape of file into AgentConfig:

    name       = "node-1"
    region     = "global"
    datacenter = "dc1"
    bind_addr  = "0.0.0.0"
    ports { http = 4646 }
    server {
      enabled           = true
      num_schedulers    = 2
      scheduler_workers = 0   # N>0: multi-process scheduler workers
    }
    client {
      enabled    = true
      node_class = "compute"
      meta { rack = "r1" }
    }
    acl { enabled = true }
    tls {
      http      = true
      ca_file   = "ca.pem"
      cert_file = "cert.pem"
      key_file  = "key.pem"
      verify_https_client = false
    }
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from nomad_tpu_torch.jobspec.hcl import Body, parse


def load_config_files(paths: List[str], base=None):
    """Merge config files/directories into an AgentConfig
    (config.go LoadConfig/Merge semantics: later files win)."""
    from nomad_tpu_torch.api.agent import AgentConfig

    cfg = base or AgentConfig()
    for path in paths:
        if os.path.isdir(path):
            entries = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith((".hcl", ".json"))
            )
            for entry in entries:
                cfg = _apply_file(cfg, entry)
        else:
            cfg = _apply_file(cfg, path)
    return cfg


def _apply_file(cfg, path: str):
    with open(path) as f:
        src = f.read()
    if path.endswith(".json"):
        data = json.loads(src)
        body = _json_to_body(data)
    else:
        body = parse(src)
    return _apply_body(cfg, body)


def _json_to_body(data: dict) -> Body:
    body = Body()
    for k, v in data.items():
        if isinstance(v, dict):
            body.blocks.append((k, [], _json_to_body(v)))
        else:
            body.attrs[k] = v
    return body


def _apply_body(cfg, body: Body):
    a = body.attrs
    if "name" in a:
        cfg.name = str(a["name"])
    if "region" in a:
        cfg.region = str(a["region"])
    if "datacenter" in a:
        cfg.datacenter = str(a["datacenter"])
    if "bind_addr" in a:
        cfg.bind_addr = str(a["bind_addr"])
    # gossip authentication key (reference agent config `encrypt`,
    # a top-level attribute)
    if "encrypt" in a:
        cfg.encrypt = str(a["encrypt"])
    # agent state dir (reference top-level `data_dir`): turns on the
    # crash-safe raft durability plane — term/vote, WAL, snapshots
    # persist under <data_dir>/raft (docs/ROBUSTNESS.md "Durability")
    if "data_dir" in a:
        cfg.data_dir = str(a["data_dir"])

    ports = body.first_block("ports")
    if ports is not None and "http" in ports[1].attrs:
        cfg.http_port = int(ports[1].attrs["http"])
    if ports is not None and "serf" in ports[1].attrs:
        cfg.serf_port = int(ports[1].attrs["serf"])

    srv = body.first_block("server")
    if srv is not None:
        sa = srv[1].attrs
        if "enabled" in sa:
            cfg.server_enabled = bool(sa["enabled"])
        if "num_schedulers" in sa:
            cfg.num_schedulers = int(sa["num_schedulers"])
        # multi-process scheduler workers (server/workerproc.py):
        # 0 = in-process threads, the bit-identical default
        if "scheduler_workers" in sa:
            cfg.scheduler_workers = int(sa["scheduler_workers"])
        # evals a worker places together as one coalesced wave
        if "worker_batch_size" in sa:
            cfg.worker_batch_size = int(sa["worker_batch_size"])
        if "raft_port" in sa:
            cfg.raft_port = int(sa["raft_port"])
        if "raft_peers" in sa:
            cfg.raft_peers = [str(p) for p in sa["raft_peers"]]
        if "raft_advertise" in sa:
            cfg.raft_advertise = str(sa["raft_advertise"])
        if "serf_enabled" in sa:
            cfg.serf_enabled = bool(sa["serf_enabled"])
        if "serf_port" in sa:
            cfg.serf_port = int(sa["serf_port"])
        # AOT placement-kernel warmup + adaptive wave-coalescer window
        # (ops/warmup.py, parallel/coalesce.py; see docs/PERF.md)
        if "kernel_warmup" in sa:
            cfg.kernel_warmup = bool(sa["kernel_warmup"])
        if "warmup_manifest" in sa:
            cfg.warmup_manifest = str(sa["warmup_manifest"])
        if "coalesce_adaptive" in sa:
            cfg.coalesce_adaptive = bool(sa["coalesce_adaptive"])
        if "coalesce_window_min_ms" in sa:
            cfg.coalesce_window_min_ms = float(sa["coalesce_window_min_ms"])
        if "coalesce_window_max_ms" in sa:
            cfg.coalesce_window_max_ms = float(sa["coalesce_window_max_ms"])
        # WAL fsync policy ("always" per record / "batch" group-fsync
        # at ack boundaries; raft/wal.py)
        if "raft_fsync_policy" in sa:
            cfg.raft_fsync_policy = str(sa["raft_fsync_policy"])
        # replication pipeline + leader leases (raft/node.py)
        if "raft_max_in_flight" in sa:
            cfg.raft_max_in_flight = int(sa["raft_max_in_flight"])
        if "raft_leader_lease" in sa:
            cfg.raft_leader_lease = bool(sa["raft_leader_lease"])
        if "raft_lease_fraction" in sa:
            cfg.raft_lease_fraction = float(sa["raft_lease_fraction"])
        # gossip membership seeds ("host:port"; DNS names expand to
        # every A record — join-by-DNS)
        if "server_join" in sa and isinstance(sa["server_join"], list):
            cfg.server_join = [str(x) for x in sa["server_join"]]
        # server_join stanza (agent config server_join/retry_join):
        # retry_join entries are "region@http_url" for WAN federation
        sj = srv[1].first_block("server_join")
        if sj is not None:
            ja = sj[1].attrs
            if "retry_join" in ja:
                cfg.retry_join = [str(x) for x in ja["retry_join"]]
            if "retry_max" in ja:
                cfg.retry_join_max_attempts = int(ja["retry_max"])
            if "retry_interval" in ja:
                from nomad_tpu_torch.jobspec.hcl import duration_s

                cfg.retry_join_interval = duration_s(ja["retry_interval"])

    cli = body.first_block("client")
    if cli is not None:
        ca = cli[1].attrs
        if "enabled" in ca:
            cfg.client_enabled = bool(ca["enabled"])
        if "node_class" in ca:
            cfg.node_class = str(ca["node_class"])
        if "plugin_dir" in ca:
            cfg.plugin_dir = str(ca["plugin_dir"])
        meta = cli[1].first_block("meta")
        if meta is not None:
            cfg.meta = {str(k): str(v) for k, v in meta[1].attrs.items()}
        elif isinstance(ca.get("meta"), dict):
            cfg.meta = {str(k): str(v) for k, v in ca["meta"].items()}
        opts = cli[1].first_block("options")
        if opts is not None:
            cfg.client_options = {
                str(k): str(v) for k, v in opts[1].attrs.items()}
        elif isinstance(ca.get("options"), dict):
            cfg.client_options = {
                str(k): str(v) for k, v in ca["options"].items()}

    acl = body.first_block("acl")
    if acl is not None and "enabled" in acl[1].attrs:
        cfg.acl_enabled = bool(acl[1].attrs["enabled"])

    # vault { address = "http://..." token = "..." create_from_role = "" }
    # (command/agent/config.go Vault stanza)
    vault = body.first_block("vault")
    if vault is not None:
        va = vault[1].attrs
        cfg.vault_addr = str(va.get("address", ""))
        cfg.vault_token = str(va.get("token", ""))
        cfg.vault_token_role = str(va.get("create_from_role", ""))

    tls = body.first_block("tls")
    if tls is not None:
        ta = tls[1].attrs
        if ta.get("http") or ta.get("cert_file"):
            from nomad_tpu_torch.utils.tlsutil import TLSConfig
            cfg.tls = TLSConfig(
                enabled=True,
                ca_file=str(ta.get("ca_file", "")),
                cert_file=str(ta.get("cert_file", "")),
                key_file=str(ta.get("key_file", "")),
                verify_https_client=bool(
                    ta.get("verify_https_client", False)),
            )
    return cfg
