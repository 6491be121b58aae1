"""Python SDK for the /v1 API (the api/ Go module analog).

Reference behavior: api/api.go:448 Client — per-endpoint typed
helpers, QueryOptions with blocking-query support (WaitIndex/WaitTime),
WriteOptions with namespace/token, event-stream decoding.

Usage::

    c = APIClient("http://127.0.0.1:4646")
    c.jobs.register(job_dict)
    for ev in c.events.stream(topics={"Job": ["*"]}):
        ...
"""

from __future__ import annotations

import copy
import json
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


def _esc(segment: Any) -> str:
    """URL-escape a path segment. Dispatched job IDs contain '/'
    (``parent/dispatch-...``, structs.go DispatchedID), so any ID embedded
    in a route path must be quoted."""
    return urllib.parse.quote(str(segment), safe="")


class APIError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


@dataclass
class QueryOptions:
    """api.QueryOptions: blocking + filtering knobs."""

    namespace: str = ""
    region: str = ""
    wait_index: int = 0
    wait_time_s: float = 0.0
    prefix: str = ""
    auth_token: str = ""
    params: Dict[str, str] = field(default_factory=dict)


class APIClient:
    def __init__(self, address: str = "http://127.0.0.1:4646",
                 token: str = "", namespace: str = "default",
                 timeout: float = 305.0, region: str = "",
                 ca_cert: str = "", client_cert: str = "",
                 client_key: str = "") -> None:
        self.address = address.rstrip("/")
        self.token = token
        self.namespace = namespace
        self.region = region
        self.timeout = timeout
        # TLS (api.Client TLSConfig; env NOMAD_CACERT/NOMAD_CLIENT_CERT/
        # NOMAD_CLIENT_KEY in the CLI): a CA pins server verification,
        # a client cert/key pair enables mTLS
        self._ssl_context = None
        if bool(client_cert) != bool(client_key):
            raise ValueError(
                "client_cert and client_key must be provided together")
        if ca_cert or client_cert:
            from nomad_tpu_torch.utils.tlsutil import client_context
            self._ssl_context = client_context(
                ca_cert, client_cert, client_key)
        self.jobs = Jobs(self)
        self.nodes = Nodes(self)
        self.allocations = Allocations(self)
        self.evaluations = Evaluations(self)
        self.deployments = Deployments(self)
        self.system = System(self)
        self.operator = Operator(self)
        self.agent = AgentAPI(self)
        self.search = Search(self)
        self.namespaces = Namespaces(self)
        self.acl = ACLAPI(self)
        self.events = Events(self)
        self.scaling = Scaling(self)
        self.csi_volumes = CSIVolumes(self)
        self.csi_plugins = CSIPlugins(self)
        self.services = Services(self)

    # -- transport -------------------------------------------------------

    def _url(self, path: str, q: Optional[QueryOptions] = None) -> str:
        params: Dict[str, str] = {}
        ns = (q.namespace if q and q.namespace else self.namespace)
        if ns:
            params["namespace"] = ns
        region = (q.region if q and q.region else self.region)
        if region:
            params["region"] = region
        if q is not None:
            if q.wait_index:
                params["index"] = str(q.wait_index)
            if q.wait_time_s:
                params["wait"] = f"{q.wait_time_s}s"
            if q.prefix:
                params["prefix"] = q.prefix
            params.update(q.params)
        qs = urllib.parse.urlencode(params)
        sep = "&" if "?" in path else "?"
        return f"{self.address}{path}" + (f"{sep}{qs}" if qs else "")

    def request(self, method: str, path: str, body: Any = None,
                q: Optional[QueryOptions] = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._url(path, q), data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        token = (q.auth_token if q and q.auth_token else self.token)
        if token:
            req.add_header("X-Nomad-Token", token)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout,
                                        context=self._ssl_context) as resp:
                raw = resp.read()
                return json.loads(raw) if raw else None
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
                msg = payload.get("error", str(payload))
            except Exception:
                msg = str(e)
            raise APIError(e.code, msg) from None

    def stream(self, path: str, params: Optional[List[tuple]] = None,
               timeout: float = 60.0) -> Iterator[Any]:
        """Yield parsed NDJSON frames from a chunked streaming endpoint
        (/v1/event/stream, /v1/agent/monitor), skipping empty
        keepalive frames."""
        url = f"{self.address}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(
            url,
            headers={"X-Nomad-Token": self.token} if self.token else {},
        )
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=self._ssl_context) as resp:
            for line in resp:
                line = line.strip()
                if not line or line == b"{}":
                    continue
                yield json.loads(line)

    def get(self, path: str, q: Optional[QueryOptions] = None) -> Any:
        return self.request("GET", path, None, q)

    def put(self, path: str, body: Any = None, q: Optional[QueryOptions] = None) -> Any:
        return self.request("PUT", path, body, q)

    def post(self, path: str, body: Any = None, q: Optional[QueryOptions] = None) -> Any:
        return self.request("POST", path, body, q)

    def delete(self, path: str, q: Optional[QueryOptions] = None) -> Any:
        return self.request("DELETE", path, None, q)


class _Endpoint:
    def __init__(self, client: APIClient) -> None:
        self.c = client


class Jobs(_Endpoint):
    def list(self, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get("/v1/jobs", q)

    def register(self, job: Dict, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.put("/v1/jobs", {"Job": job}, q)

    def info(self, job_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/job/{_esc(job_id)}", q)

    def deregister(self, job_id: str, purge: bool = False,
                   q: Optional[QueryOptions] = None) -> Dict:
        q = copy.deepcopy(q) if q is not None else QueryOptions()
        if purge:
            q.params["purge"] = "true"
        return self.c.delete(f"/v1/job/{_esc(job_id)}", q)

    def plan(self, job: Dict, diff: bool = False,
             q: Optional[QueryOptions] = None) -> Dict:
        return self.c.put(f"/v1/job/{_esc(job['ID'])}/plan",
                          {"Job": job, "Diff": diff}, q)

    def allocations(self, job_id: str, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get(f"/v1/job/{_esc(job_id)}/allocations", q)

    def evaluations(self, job_id: str, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get(f"/v1/job/{_esc(job_id)}/evaluations", q)

    def deployments(self, job_id: str, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get(f"/v1/job/{_esc(job_id)}/deployments", q)

    def summary(self, job_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/job/{_esc(job_id)}/summary", q)

    def versions(self, job_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/job/{_esc(job_id)}/versions", q)

    def revert(self, job_id: str, version: int,
               q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/job/{_esc(job_id)}/revert",
                           {"JobID": job_id, "JobVersion": version}, q)

    def stable(self, job_id: str, version: int, stable: bool,
               q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/job/{_esc(job_id)}/stable",
                           {"JobVersion": version, "Stable": stable}, q)

    def dispatch(self, job_id: str, meta: Optional[Dict] = None,
                 payload: bytes = b"", q: Optional[QueryOptions] = None) -> Dict:
        import base64

        return self.c.post(
            f"/v1/job/{_esc(job_id)}/dispatch",
            {"Meta": meta or {},
             "Payload": base64.b64encode(payload).decode()}, q,
        )

    def scale(self, job_id: str, group: str, count: int, message: str = "",
              q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(
            f"/v1/job/{_esc(job_id)}/scale",
            {"Target": {"Group": group}, "Count": count, "Message": message}, q,
        )

    def scale_status(self, job_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/job/{_esc(job_id)}/scale", q)

    def periodic_force(self, job_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/job/{_esc(job_id)}/periodic/force", {}, q)

    def parse(self, hcl: str) -> Dict:
        return self.c.post("/v1/jobs/parse", {"JobHCL": hcl})


class Nodes(_Endpoint):
    def list(self, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get("/v1/nodes", q)

    def info(self, node_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/node/{_esc(node_id)}", q)

    def allocations(self, node_id: str, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get(f"/v1/node/{_esc(node_id)}/allocations", q)

    def drain(self, node_id: str, enable: bool = True,
              deadline_s: float = 0.0, ignore_system: bool = False,
              q: Optional[QueryOptions] = None) -> Dict:
        spec = None
        if enable:
            spec = {"Deadline": int(deadline_s * 1e9),
                    "IgnoreSystemJobs": ignore_system}
        return self.c.post(f"/v1/node/{_esc(node_id)}/drain", {"DrainSpec": spec}, q)

    def eligibility(self, node_id: str, eligible: bool,
                    q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(
            f"/v1/node/{_esc(node_id)}/eligibility",
            {"Eligibility": "eligible" if eligible else "ineligible"}, q,
        )

    def evaluate(self, node_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/node/{_esc(node_id)}/evaluate", {}, q)

    def purge(self, node_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/node/{_esc(node_id)}/purge", {}, q)


class ExecSession:
    """One interactive exec stream (the SDK half of alloc exec).

    JSON-over-websocket frames mirror the reference's
    drivers.ExecTaskStreaming messages: {"stdin": {"data": b64}},
    {"stdin": {"close": true}}, {"tty_size": {...}} out;
    {"stdout"/"stderr": {"data": b64}}, {"exited", "result"} in.
    """

    def __init__(self, conn) -> None:
        self.conn = conn
        self.exit_code: Optional[int] = None

    def send_stdin(self, data: bytes) -> None:
        import base64
        import json as _json

        self.conn.send(_json.dumps(
            {"stdin": {"data": base64.b64encode(data).decode()}}).encode())

    def close_stdin(self) -> None:
        import json as _json

        self.conn.send(_json.dumps({"stdin": {"close": True}}).encode())

    def resize(self, height: int, width: int) -> None:
        import json as _json

        self.conn.send(_json.dumps(
            {"tty_size": {"height": height, "width": width}}).encode())

    def events(self) -> Iterator[Dict]:
        """Yield decoded frames until the process exits or the peer
        closes; sets ``exit_code`` when the exited frame arrives."""
        import base64
        import json as _json

        from nomad_tpu_torch.utils import ws as wslib

        while True:
            try:
                op, payload = self.conn.recv()
            except (ConnectionError, OSError):
                return
            if op == wslib.OP_CLOSE:
                return
            if op not in (wslib.OP_TEXT, wslib.OP_BINARY):
                continue
            try:
                frame = _json.loads(payload)
            except _json.JSONDecodeError:
                continue
            for name in ("stdout", "stderr"):
                blob = frame.get(name) or {}
                if blob.get("data"):
                    frame[name]["bytes"] = base64.b64decode(blob["data"])
            yield frame
            if frame.get("exited"):
                self.exit_code = (frame.get("result") or {}).get("exit_code")
                return

    def close(self) -> None:
        self.conn.close()


class Allocations(_Endpoint):
    def list(self, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get("/v1/allocations", q)

    def info(self, alloc_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/allocation/{_esc(alloc_id)}", q)

    def stats(self, alloc_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/client/allocation/{_esc(alloc_id)}/stats", q)

    def restart(self, alloc_id: str, task: str = "",
                q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/client/allocation/{_esc(alloc_id)}/restart",
                           {"TaskName": task}, q)

    def signal(self, alloc_id: str, signal: str, task: str = "",
               q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/client/allocation/{_esc(alloc_id)}/signal",
                           {"Signal": signal, "TaskName": task}, q)

    def exec(self, alloc_id: str, task: str, cmd: List[str],
             q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/client/allocation/{_esc(alloc_id)}/exec",
                           {"Task": task, "Cmd": cmd}, q)

    def exec_stream(self, alloc_id: str, task: str, cmd: List[str],
                    tty: bool = False,
                    q: Optional[QueryOptions] = None) -> "ExecSession":
        """Interactive exec over a websocket (api/allocations_exec.go).

        Returns an ExecSession: write stdin bytes, iterate output
        chunks, read the exit code."""
        import json as _json

        q = q or QueryOptions()
        q.params.update({
            "task": task,
            "command": _json.dumps(cmd),
            "tty": "true" if tty else "false",
        })
        url = self.c._url(f"/v1/client/allocation/{_esc(alloc_id)}/exec", q)
        from nomad_tpu_torch.utils import ws as wslib

        conn = wslib.connect(url, token=self.c.token,
                             tls_context=self.c._ssl_context)
        return ExecSession(conn)

    def logs(self, alloc_id: str, task: str, logtype: str = "stdout",
             offset: int = 0, limit: int = 0,
             q: Optional[QueryOptions] = None) -> str:
        q = q or QueryOptions()
        q.params.update({"task": task, "type": logtype})
        if offset:
            q.params["offset"] = str(offset)
        if limit:
            q.params["limit"] = str(limit)
        resp = self.c.get(f"/v1/client/fs/logs/{_esc(alloc_id)}", q)
        return resp.get("Data", "")

    def logs_follow(self, alloc_id: str, task: str,
                    logtype: str = "stdout", offset: int = 0,
                    timeout: float = 630.0) -> Iterator[bytes]:
        """?follow=true tail: yields raw byte chunks as they arrive.
        Byte chunks let callers resume with offset=bytes-seen."""
        q = QueryOptions()
        q.params.update({"task": task, "type": logtype, "follow": "true"})
        if offset:
            q.params["offset"] = str(offset)
        # _url stamps region/namespace like every other request
        url = self.c._url(f"/v1/client/fs/logs/{_esc(alloc_id)}", q)
        req = urllib.request.Request(
            url,
            headers={"X-Nomad-Token": self.c.token} if self.c.token else {},
        )
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout,
                    context=self.c._ssl_context) as resp:
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        return
                    yield chunk
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:                   # noqa: BLE001
                msg = str(e)
            raise APIError(e.code, msg) from None

    def fs_ls(self, alloc_id: str, path: str = "/",
              q: Optional[QueryOptions] = None) -> List[Dict]:
        q = q or QueryOptions()
        q.params["path"] = path
        return self.c.get(f"/v1/client/fs/ls/{_esc(alloc_id)}", q)

    def fs_stat(self, alloc_id: str, path: str,
                q: Optional[QueryOptions] = None) -> Dict:
        q = q or QueryOptions()
        q.params["path"] = path
        return self.c.get(f"/v1/client/fs/stat/{_esc(alloc_id)}", q)

    def fs_cat(self, alloc_id: str, path: str,
               q: Optional[QueryOptions] = None) -> str:
        q = q or QueryOptions()
        q.params["path"] = path
        resp = self.c.get(f"/v1/client/fs/cat/{_esc(alloc_id)}", q)
        return resp.get("Data", "")

    def stop(self, alloc_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/allocation/{_esc(alloc_id)}/stop", {}, q)


class Evaluations(_Endpoint):
    def list(self, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get("/v1/evaluations", q)

    def info(self, eval_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/evaluation/{_esc(eval_id)}", q)

    def allocations(self, eval_id: str, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get(f"/v1/evaluation/{_esc(eval_id)}/allocations", q)


class Deployments(_Endpoint):
    def list(self, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get("/v1/deployments", q)

    def info(self, deployment_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/deployment/{_esc(deployment_id)}", q)

    def fail(self, deployment_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/deployment/fail/{_esc(deployment_id)}", {}, q)

    def pause(self, deployment_id: str, pause: bool = True,
              q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(f"/v1/deployment/pause/{_esc(deployment_id)}",
                           {"Pause": pause}, q)

    def promote(self, deployment_id: str, groups: Optional[List[str]] = None,
                q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post(
            f"/v1/deployment/promote/{_esc(deployment_id)}",
            {"All": groups is None, "Groups": groups}, q,
        )


class System(_Endpoint):
    def gc(self) -> None:
        self.c.put("/v1/system/gc")

    def reconcile_summaries(self) -> None:
        self.c.put("/v1/system/reconcile/summaries")


class Operator(_Endpoint):
    def scheduler_config(self) -> Dict:
        return self.c.get("/v1/operator/scheduler/configuration")

    def set_scheduler_config(self, config: Dict) -> Dict:
        return self.c.put("/v1/operator/scheduler/configuration", config)

    def autopilot_configuration(self) -> Dict:
        return self.c.get("/v1/operator/autopilot/configuration")

    def set_autopilot_configuration(self, config: Dict) -> Dict:
        return self.c.put("/v1/operator/autopilot/configuration", config)

    def autopilot_health(self) -> Dict:
        return self.c.get("/v1/operator/autopilot/health")

    def raft_configuration(self) -> Dict:
        return self.c.get("/v1/operator/raft/configuration")

    def snapshot_save(self) -> bytes:
        import base64

        res = self.c.get("/v1/operator/snapshot")
        return base64.b64decode(res["Snapshot"])

    def snapshot_restore(self, data: bytes) -> Dict:
        import base64

        return self.c.put("/v1/operator/snapshot",
                          {"Snapshot": base64.b64encode(data).decode()})


class AgentAPI(_Endpoint):
    def self(self) -> Dict:
        return self.c.get("/v1/agent/self")

    def health(self) -> Dict:
        return self.c.get("/v1/agent/health")

    def members(self) -> Dict:
        return self.c.get("/v1/agent/members")

    def metrics(self) -> Dict:
        return self.c.get("/v1/metrics")

    _PPROF_PROFILES = ("goroutine", "profile", "heap")

    def pprof(self, profile: str = "goroutine", seconds: int = 1) -> str:
        if profile not in self._PPROF_PROFILES:
            raise ValueError(
                f"unsupported profile {profile!r}; "
                f"one of {', '.join(self._PPROF_PROFILES)}"
            )
        q = QueryOptions()
        if profile == "profile":
            q.params["seconds"] = str(seconds)
        return self.c.get(f"/v1/agent/pprof/{_esc(profile)}",
                          q).get("Profile", "")

    def monitor(self, log_level: str = "info",
                timeout: float = 60.0) -> Iterator[str]:
        """Yield live log lines from /v1/agent/monitor."""
        for payload in self.c.stream("/v1/agent/monitor",
                                     [("log_level", log_level)], timeout):
            if payload.get("Data"):
                yield payload["Data"]


class Search(_Endpoint):
    def prefix(self, prefix: str, context: str = "all",
               q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post("/v1/search",
                           {"Prefix": prefix, "Context": context}, q)

    def fuzzy(self, text: str, context: str = "all",
              q: Optional[QueryOptions] = None) -> Dict:
        return self.c.post("/v1/search/fuzzy",
                           {"Text": text, "Context": context}, q)


class Namespaces(_Endpoint):
    def list(self) -> List[Dict]:
        return self.c.get("/v1/namespaces")

    def info(self, name: str) -> Dict:
        return self.c.get(f"/v1/namespace/{_esc(name)}")

    def register(self, name: str, description: str = "") -> Dict:
        return self.c.put(f"/v1/namespace/{_esc(name)}",
                          {"Name": name, "Description": description})

    def delete(self, name: str) -> Dict:
        return self.c.delete(f"/v1/namespace/{_esc(name)}")


class Scaling(_Endpoint):
    def policies(self) -> List[Dict]:
        return self.c.get("/v1/scaling/policies")

    def policy(self, policy_id: str) -> Dict:
        return self.c.get(f"/v1/scaling/policy/{_esc(policy_id)}")


class CSIVolumes(_Endpoint):
    """api/csi.go CSIVolumes."""

    def list(self, plugin_id: str = "",
             q: Optional[QueryOptions] = None) -> List[Dict]:
        q = q or QueryOptions()
        if plugin_id:
            q.params["plugin_id"] = plugin_id
        return self.c.get("/v1/volumes", q)

    def info(self, volume_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/volume/csi/{_esc(volume_id)}", q)

    def register(self, volume: Dict, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.put("/v1/volumes", {"Volumes": [volume]}, q)

    def deregister(self, volume_id: str, force: bool = False,
                   q: Optional[QueryOptions] = None) -> Dict:
        q = q or QueryOptions()
        if force:
            q.params["force"] = "true"
        return self.c.delete(f"/v1/volume/csi/{_esc(volume_id)}", q)

    def create(self, volume: Dict, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.put(
            f"/v1/volume/csi/{_esc(volume.get('ID', volume.get('id', '')))}/create",
            {"Volumes": [volume]}, q,
        )

    def delete(self, volume_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.delete(f"/v1/volume/csi/{_esc(volume_id)}/delete", q)

    def detach(self, volume_id: str, node_id: str = "", alloc_id: str = "",
               q: Optional[QueryOptions] = None) -> Dict:
        q = q or QueryOptions()
        if node_id:
            q.params["node"] = node_id
        if alloc_id:
            q.params["alloc"] = alloc_id
        return self.c.put(f"/v1/volume/csi/{_esc(volume_id)}/detach", q=q)


class CSIPlugins(_Endpoint):
    def list(self, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get("/v1/plugins", q)

    def info(self, plugin_id: str, q: Optional[QueryOptions] = None) -> Dict:
        return self.c.get(f"/v1/plugin/csi/{_esc(plugin_id)}", q)


class Services(_Endpoint):
    """api/services.go: native service discovery."""

    def list(self, q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get("/v1/services", q)

    def get(self, service_name: str,
            q: Optional[QueryOptions] = None) -> List[Dict]:
        return self.c.get(f"/v1/service/{_esc(service_name)}", q)

    def delete(self, service_name: str, service_id: str,
               q: Optional[QueryOptions] = None) -> Dict:
        return self.c.delete(
            f"/v1/service/{_esc(service_name)}/{_esc(service_id)}", q
        )


class ACLAPI(_Endpoint):
    def bootstrap(self) -> Dict:
        return self.c.post("/v1/acl/bootstrap")

    def policies(self) -> List[Dict]:
        return self.c.get("/v1/acl/policies")

    def policy(self, name: str) -> Dict:
        return self.c.get(f"/v1/acl/policy/{_esc(name)}")

    def put_policy(self, name: str, rules: str, description: str = "") -> Dict:
        return self.c.put(f"/v1/acl/policy/{_esc(name)}",
                          {"Rules": rules, "Description": description})

    def delete_policy(self, name: str) -> Dict:
        return self.c.delete(f"/v1/acl/policy/{_esc(name)}")

    def tokens(self) -> List[Dict]:
        return self.c.get("/v1/acl/tokens")

    def create_token(self, name: str = "", type: str = "client",
                     policies: Optional[List[str]] = None,
                     global_: bool = False) -> Dict:
        return self.c.put("/v1/acl/token", {
            "Name": name, "Type": type, "Policies": policies or [],
            "Global": global_,
        })

    def self_token(self) -> Dict:
        return self.c.get("/v1/acl/token/self")

    def token(self, accessor_id: str) -> Dict:
        return self.c.get(f"/v1/acl/token/{_esc(accessor_id)}")

    def create_one_time_token(self) -> Dict:
        return self.c.post("/v1/acl/token/onetime")

    def exchange_one_time_token(self, secret: str) -> Dict:
        return self.c.post("/v1/acl/token/onetime/exchange",
                           {"OneTimeSecretID": secret})

    def delete_token(self, accessor_id: str) -> Dict:
        return self.c.delete(f"/v1/acl/token/{_esc(accessor_id)}")


class Events(_Endpoint):
    def stream(self, topics: Optional[Dict[str, List[str]]] = None,
               index: int = 0, timeout: float = 60.0) -> Iterator[Dict]:
        """Yield event batches from /v1/event/stream (NDJSON frames)."""
        params = []
        for topic, keys in (topics or {"*": ["*"]}).items():
            for key in keys:
                params.append(("topic", f"{topic}:{key}"))
        if index:
            params.append(("index", str(index)))
        yield from self.c.stream("/v1/event/stream", params, timeout)
