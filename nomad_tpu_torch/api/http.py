"""The /v1 HTTP API agent.

Reference: command/agent/http.go — registerHandlers (:321-411) route
table, wrap() error handling, blocking-query parameters
(parseWait/parseConsistency), NDJSON event streaming, and the merged
server+client agent process.

Implementation: stdlib ThreadingHTTPServer + a regex route table. Each
handler receives a Request carrying path params, query, decoded JSON
body, and the resolved ACL token; blocking queries ride
StateStore.block_until (the memdb WatchSet analog).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.api.codec import decode, encode
from nomad_tpu_torch.server import endpoints
from nomad_tpu_torch.server.readplane import ReadPlaneError
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.job import Job


class HTTPError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status
        self.message = message


class Request:
    """One parsed HTTP request handed to route handlers."""

    def __init__(self, method: str, path: str, params: Dict[str, str],
                 query: Dict[str, List[str]], body: Optional[Any],
                 token: str, handler: BaseHTTPRequestHandler) -> None:
        self.method = method
        self.path = path
        self.params = params
        self.query = query
        self.body = body
        self.token = token
        self.handler = handler

    def q(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def flag(self, name: str) -> bool:
        return self.q(name) not in ("", "false", "0")

    @property
    def namespace(self) -> str:
        return self.q("namespace", "default")

    def wait_params(self) -> Tuple[int, float]:
        """parseWait: ?index=N&wait=Dur -> (min_index, timeout_s)."""
        index = int(self.q("index", "0") or 0)
        wait = self.q("wait", "")
        timeout = 300.0
        if wait:
            parsed = parse_duration(wait)
            if parsed is not None:
                timeout = parsed
        return index, min(timeout, 600.0)

    def consistency_params(self) -> Tuple[str, Optional[float]]:
        """parseConsistency: ``?stale`` / ``max_stale=<dur>``
        / ``consistency=<mode>`` -> (mode, max_stale_s). An explicit
        ``consistency=`` wins; ``max_stale`` alone implies stale."""
        max_stale = None
        raw = self.q("max_stale", "")
        if raw:
            max_stale = parse_duration(raw)
            if max_stale is None:
                raise HTTPError(400, f"invalid max_stale duration {raw!r}")
        mode = self.q("consistency", "")
        if not mode:
            mode = ("stale" if (self.flag("stale") or max_stale is not None)
                    else "default")
        elif mode not in ("default", "stale", "linearizable"):
            raise HTTPError(400, f"unknown consistency mode {mode!r}")
        return mode, max_stale


def parse_duration(v) -> Optional[float]:
    """Go-style duration -> seconds ('500ms', '10s', '1m', '2h', bare
    numbers are seconds); None if unparseable."""
    if isinstance(v, (int, float)):
        return float(v)
    if not isinstance(v, str):
        return None
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h)?", v)
    if m is None:
        return None
    mult = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}[m.group(2) or "s"]
    return float(m.group(1)) * mult


class HTTPAgent:
    """Routes + lifecycle for one agent's HTTP server."""

    def __init__(self, agent, bind: str = "127.0.0.1", port: int = 0,
                 tls_config=None) -> None:
        self.agent = agent
        self.tls_config = tls_config
        self._routes: List[Tuple[str, re.Pattern, Callable]] = []
        self._register_routes()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _dispatch(self, method: str) -> None:
                outer._handle(self, method)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        class _QuietServer(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # socketserver's default prints a raw traceback to
                # stderr; route it through logging instead so stderr
                # stays clean for the process's own consumers. A
                # client dropping mid-response is routine (debug);
                # anything else is a real handler failure and must
                # stay visible at default log levels
                import logging
                import sys

                exc = sys.exc_info()[1]
                log = logging.getLogger(__name__)
                if isinstance(exc, (ConnectionError, TimeoutError)):
                    log.debug("http: client %s dropped: %s",
                              client_address, exc)
                else:
                    log.warning("http: error serving %s",
                                client_address, exc_info=True)

        self.httpd = _QuietServer((bind, port), _Handler)
        self.httpd.daemon_threads = True
        scheme = "http"
        # outbound SSL context for intra-cluster forwarding (region +
        # node proxying must trust the cluster CA and present this
        # agent's cert when peers enforce mTLS)
        self._fwd_context = None
        if tls_config is not None and tls_config.enabled:
            # TLS listener (tlsutil/config.go IncomingTLSConfig); with
            # verify_https_client the handshake requires a CA-signed
            # client cert (mTLS). do_handshake_on_connect=False defers
            # the handshake to the per-connection handler thread so a
            # stalled peer can't block the accept loop.
            from nomad_tpu_torch.utils.tlsutil import client_context, server_context
            self.httpd.socket = server_context(tls_config).wrap_socket(
                self.httpd.socket, server_side=True,
                do_handshake_on_connect=False)
            self._fwd_context = client_context(
                tls_config.ca_file, tls_config.cert_file,
                tls_config.key_file)
            scheme = "https"
        self.addr = (f"{scheme}://{self.httpd.server_address[0]}:"
                     f"{self.httpd.server_address[1]}")
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="http-agent", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- request plumbing (http.go wrap()) -------------------------------

    def _handle(self, handler: BaseHTTPRequestHandler, method: str) -> None:
        parsed = urllib.parse.urlparse(handler.path)
        path = parsed.path
        query = urllib.parse.parse_qs(parsed.query)
        body = None
        raw_body = b""
        length = int(handler.headers.get("Content-Length") or 0)
        if length:
            raw_body = handler.rfile.read(length)
            if raw_body:
                try:
                    body = json.loads(raw_body)
                except json.JSONDecodeError:
                    body = raw_body
        token = handler.headers.get("X-Nomad-Token", "")
        if not token:
            auth = handler.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                token = auth[7:]
        if not token:
            # browsers cannot set headers on WebSocket upgrades; the
            # UI's exec terminal passes the token as a query param
            # (the reference UI does the same, ui/app/services/token.js).
            # Accepted ONLY for upgrade/stream requests — on plain
            # requests a query token would leak into access logs,
            # proxies, and browser history.
            is_upgrade = "upgrade" in (
                handler.headers.get("Connection", "").lower())
            if is_upgrade or path == "/v1/event/stream":
                token = (query.get("x_nomad_token") or [""])[0]

        # cross-region forwarding (rpc.go:537 forward/forwardRegion):
        # a request naming another region proxies to a server there
        region = (query.get("region") or [""])[0]
        agent_region = self.agent.config.region
        if region and region != agent_region:
            if self.agent.server is None:
                # a client-only agent has no WAN registry; answering
                # locally would masquerade as the remote region
                self._send(handler, 400, {
                    "error": f"No path to region {region}: "
                             "agent has no server",
                })
            else:
                self._forward_region(handler, method, region, parsed,
                                     token, raw_body)
            return

        # server->node pass-through (rpc.go:708 NodeStreamingRpc /
        # nodeConns): proxy /v1/client/* to the HTTP agent on the
        # allocation's node when the alloc doesn't run locally (covers
        # server-only agents AND combined agents asked about another
        # node's alloc)
        if path.startswith("/v1/client/") and self.agent.server is not None \
                and not self._alloc_is_local(parsed):
            self._forward_client(handler, method, parsed, token, raw_body)
            return

        for route_method, pattern, fn in self._routes:
            if route_method != method:
                continue
            m = pattern.fullmatch(path)
            if m is None:
                continue
            # path params arrive percent-encoded (dispatched job IDs
            # contain '/'); decode before handing to endpoint handlers
            params = {
                k: urllib.parse.unquote(v)
                for k, v in m.groupdict().items()
                if v is not None
            }
            req = Request(method, path, params, query, body, token, handler)
            try:
                result = fn(req)
            except HTTPError as e:
                self._send(handler, e.status, {"error": e.message})
            except ReadPlaneError as e:
                # the read plane refused (no leader / over max_stale):
                # loud 503 + the leader hint so callers can re-aim
                if e.known_leader:
                    handler._read_leader_hint = e.known_leader
                self._send(handler, 503, {"error": str(e)})
            except PermissionError as e:
                self._send(handler, 403, {"error": str(e)})
            except KeyError as e:
                self._send(handler, 404, {"error": str(e)})
            except (ValueError, TypeError) as e:
                self._send(handler, 400, {"error": str(e)})
            except Exception as e:  # wrap(): 500 + message
                self._send(handler, 500, {"error": f"{type(e).__name__}: {e}"})
            else:
                if result is not StreamedResponse:
                    status, payload = result if isinstance(result, tuple) else (200, result)
                    self._send(handler, status, payload)
            return
        self._send(handler, 404, {"error": f"no handler for {method} {path}"})

    # endpoints whose responses never end; forwarding must relay
    # them incrementally rather than buffer the body
    _STREAMING_PATHS = frozenset({"/v1/event/stream", "/v1/agent/monitor"})

    def _forward_region(self, handler, method: str, region: str,
                        parsed, token: str, raw_body: bytes) -> None:
        """Proxy the request to the named region's server verbatim
        (minus the region param, so it doesn't loop)."""
        addr = self.agent.server.region_addr(region)
        if addr is None:
            self._send(handler, 400, {"error": f"No path to region {region}"})
            return
        pairs = [(k, v) for k, v in urllib.parse.parse_qsl(parsed.query)
                 if k != "region"]
        url = addr + parsed.path
        if pairs:
            url += "?" + urllib.parse.urlencode(pairs)
        if handler.headers.get("Upgrade", "").lower() == "websocket":
            self._tunnel_websocket(handler, url, token)
            return
        # outlive the remote's blocking-query hold (default 300s,
        # capped at 600s server-side) plus slack
        wait = dict(pairs).get("wait", "")
        hold = parse_duration(wait) if wait else 300.0
        fwd_timeout = min(hold if hold is not None else 300.0, 600.0) + 10.0
        raw_stream = self._wants_stream(parsed)
        if parsed.path in self._STREAMING_PATHS or raw_stream:
            # infinite stream: relay incrementally instead of buffering
            # an unbounded body (NDJSON line-wise, follow-logs raw);
            # outlive the remote's 600s stream deadline
            req = urllib.request.Request(url, method=method)
            if token:
                req.add_header("X-Nomad-Token", token)
            try:
                with urllib.request.urlopen(
                        req, timeout=660.0,
                        context=self._fwd_context) as resp:
                    self._relay_body(handler, resp, raw=raw_stream)
            except (OSError, ValueError, urllib.error.HTTPError) as e:
                self._send(handler, 502,
                           {"error": f"region {region} unreachable: {e}"})
            return
        self._proxy(handler, method, url, token, raw_body,
                    timeout=fwd_timeout, unreachable=f"region {region}")

    _CLIENT_PATH_RE = re.compile(
        r"/v1/client/(?:allocation|fs/[a-z]+)/(?P<id>[^/?]+)"
    )

    def _client_path_alloc_id(self, parsed) -> str:
        m = self._CLIENT_PATH_RE.match(parsed.path)
        return urllib.parse.unquote(m.group("id")) if m else ""

    def _alloc_is_local(self, parsed) -> bool:
        """Does this agent's client run the alloc the path names?"""
        if self.agent.client is None:
            return False
        alloc_id = self._client_path_alloc_id(parsed)
        if not alloc_id:
            return True   # non-alloc client routes (e.g. /v1/client/stats)
        return self.agent.client.alloc_runner(alloc_id) is not None

    def _proxy(self, handler, method: str, url: str, token: str,
               raw_body: bytes, timeout: float = 60.0,
               unreachable: str = "upstream") -> None:
        """Shared HTTP proxy plumbing (region + node forwarding)."""
        req = urllib.request.Request(url, data=raw_body or None,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        if token:
            req.add_header("X-Nomad-Token", token)
        remote_index = None
        try:
            with urllib.request.urlopen(req, timeout=timeout,
                                        context=self._fwd_context) as resp:
                raw, status = resp.read(), resp.status
                remote_index = resp.headers.get("X-Nomad-Index")
        except urllib.error.HTTPError as e:
            raw, status = e.read(), e.code
            remote_index = e.headers.get("X-Nomad-Index")
        except (OSError, ValueError) as e:
            self._send(handler, 502,
                       {"error": f"{unreachable} unreachable: {e}"})
            return
        try:
            payload = json.loads(raw) if raw else None
        except json.JSONDecodeError:
            # non-JSON upstream body (e.g. /v1/metrics?format=prometheus
            # raw text exposition): relay it verbatim with the remote's
            # content type instead of mangling it into a 502
            if 200 <= status < 300:
                self._send_text(
                    handler, raw.decode("utf-8", "replace"), status=status)
                return
            status, payload = 502, {"error": "bad upstream response"}
        self._send(handler, status, payload, index=remote_index)

    def _forward_client(self, handler, method, parsed, token,
                        raw_body) -> None:
        """Resolve the alloc's node and proxy the request there."""
        snap = self.agent.server.state.snapshot()
        node = None
        alloc_id = self._client_path_alloc_id(parsed)
        if alloc_id:
            alloc = snap.alloc_by_id(alloc_id)
            if alloc is None:
                self._send(handler, 404, {"error": "unknown allocation"})
                return
            node = snap.node_by_id(alloc.node_id)
        else:
            node_id = (urllib.parse.parse_qs(parsed.query)
                       .get("node_id") or [""])[0]
            if node_id:
                node = snap.node_by_id(node_id)
        if node is None or not getattr(node, "http_addr", ""):
            self._send(handler, 404,
                       {"error": "no client agent reachable for request"})
            return
        if node.http_addr == self.addr:
            # the alloc is assigned here but its runner hasn't started
            # yet; proxying to ourselves would loop
            self._send(handler, 404,
                       {"error": "allocation not yet running on node"})
            return
        url = node.http_addr + parsed.path
        if parsed.query:
            url += "?" + parsed.query
        if handler.headers.get("Upgrade", "").lower() == "websocket":
            # interactive exec: opaque byte tunnel to the node's agent
            # (rpc.go:708 NodeStreamingRpc analog)
            self._tunnel_websocket(handler, url, token)
            return
        if self._wants_stream(parsed):
            req = urllib.request.Request(url, method=method)
            if token:
                req.add_header("X-Nomad-Token", token)
            try:
                with urllib.request.urlopen(
                        req, timeout=660.0,
                        context=self._fwd_context) as resp:
                    self._relay_raw(handler, resp)
            except (OSError, ValueError, urllib.error.HTTPError) as e:
                self._send(handler, 502, {"error": f"node unreachable: {e}"})
            return
        self._proxy(handler, method, url, token, raw_body,
                    unreachable="node")

    def _tunnel_websocket(self, handler, url: str, token: str) -> None:
        """Relay a websocket upgrade + both byte directions verbatim.

        The tunnel re-issues the upgrade toward the node with the
        caller's Sec-WebSocket-Key, writes the node's 101 response back,
        then pumps raw bytes both ways — no frame parsing needed."""
        import socket
        import ssl as _ssl

        parsed = urllib.parse.urlparse(url)
        host = parsed.hostname
        port = parsed.port or (443 if parsed.scheme == "https" else 80)
        try:
            upstream = socket.create_connection((host, port), timeout=30)
            if parsed.scheme == "https":
                ctx = self._fwd_context or _ssl.create_default_context()
                upstream = ctx.wrap_socket(upstream, server_hostname=host)
            # connect timeout only; a quiet session must stay open
            upstream.settimeout(None)
        except OSError as e:
            self._send(handler, 502, {"error": f"node unreachable: {e}"})
            return
        path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
        lines = [f"GET {path} HTTP/1.1", f"Host: {host}:{port}"]
        for h in ("Upgrade", "Connection", "Sec-WebSocket-Key",
                  "Sec-WebSocket-Version"):
            v = handler.headers.get(h)
            if v:
                lines.append(f"{h}: {v}")
        if token:
            lines.append(f"X-Nomad-Token: {token}")
        try:
            upstream.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        except OSError as e:
            self._send(handler, 502, {"error": f"node unreachable: {e}"})
            upstream.close()
            return

        handler.close_connection = True
        down = handler.connection

        def shut(*socks) -> None:
            for s in socks:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

        def pump_up() -> None:
            # downstream reads go through rfile: it may hold frames the
            # header parser read ahead of
            try:
                while True:
                    data = handler.rfile.read1(65536)
                    if not data:
                        break
                    upstream.sendall(data)
            except (OSError, ValueError):
                pass
            finally:
                shut(down, upstream)

        t = threading.Thread(target=pump_up, daemon=True,
                             name="ws-tunnel-up")
        t.start()
        try:
            while True:
                data = upstream.recv(65536)
                if not data:
                    break
                down.sendall(data)
        except OSError:
            pass
        finally:
            shut(down, upstream)
        t.join(timeout=5)
        try:
            upstream.close()
        except OSError:
            pass

    @staticmethod
    def _wants_stream(parsed) -> bool:
        """Endpoints whose responses never end mid-request: follow-mode
        log tails (the exact-path streaming set is separate)."""
        q = urllib.parse.parse_qs(parsed.query)
        return parsed.path.startswith("/v1/client/fs/logs/") and \
            (q.get("follow") or [""])[0] not in ("", "false", "0")

    def _relay_raw(self, handler, resp) -> None:
        self._relay_body(handler, resp, raw=True)

    def _relay_body(self, handler, resp, raw: bool) -> None:
        """Pipe a remote endless stream through as it arrives — raw
        byte chunks (follow logs) or NDJSON line-wise (event stream,
        monitor). Always terminates the chunked framing."""
        try:
            handler.send_response(resp.status)
            handler.send_header(
                "Content-Type",
                resp.headers.get("Content-Type", "application/json"))
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()
            if raw:
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    self._write_chunk(handler, chunk)
            else:
                for line in resp:
                    self._write_chunk(handler, line)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self._end_chunks(handler)

    def _relay_stream(self, handler, resp) -> None:
        self._relay_body(handler, resp, raw=False)

    def _send(self, handler, status: int, payload, index=None) -> None:
        """``index`` overrides the stamped X-Nomad-Index (forwarded
        responses must carry the REMOTE region's index or cross-region
        blocking queries spin)."""
        try:
            data = json.dumps(encode(payload)).encode()
            handler.send_response(status)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(data)))
            if index is None:
                index = self.agent.server.state.latest_index() \
                    if self.agent.server else 0
            handler.send_header("X-Nomad-Index", str(index))
            # read-plane attribution: every routed read
            # carries how stale its data may be and where the leader
            # is; a refused read still carries the leader hint
            ctx = getattr(handler, "_read_ctx", None)
            if ctx is not None:
                handler.send_header("X-Nomad-Last-Contact",
                                    str(ctx.last_contact_ms))
                if ctx.known_leader:
                    handler.send_header("X-Nomad-Known-Leader",
                                        ctx.known_leader)
            else:
                hint = getattr(handler, "_read_leader_hint", "")
                if hint:
                    handler.send_header("X-Nomad-Known-Leader", hint)
            handler.end_headers()
            handler.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _send_text(self, handler, body: str, status: int = 200,
                   content_type: str = "text/plain; version=0.0.4") -> None:
        """Raw text response (Prometheus exposition is not JSON)."""
        try:
            data = body.encode()
            handler.send_response(status)
            handler.send_header("Content-Type", content_type)
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _block(self, req: Request, tables: List[str]) -> None:
        """Blocking query: wait until any listed table passes ?index."""
        min_index, timeout = req.wait_params()
        if min_index > 0 and self.agent.server is not None:
            self.agent.server.state.block_until(tables, min_index + 1, timeout)

    def _read(self, req: Request, tables: Optional[List[str]] = None):
        """Consistency-routed read: resolve the mode fence
        through the server's read plane, run the blocking-query wait
        against the LOCAL store (followers wake on their own FSM
        applies), then take the serving snapshot. Order matters: the
        fence first (a default-mode follower read is ordered after the
        leader's commit frontier before it blocks or serves), the
        snapshot last (it sees everything the fence + wait admitted).
        Raises ReadPlaneError -> 503 when the plane refuses."""
        server = self._server
        mode, max_stale = req.consistency_params()
        ctx = server.readplane.resolve(mode, max_stale)
        req.handler._read_ctx = ctx
        if tables:
            self._block(req, tables)
        return server.state.snapshot()

    # -- ACL gate --------------------------------------------------------

    def _acl(self, req: Request, check: str, *args) -> None:
        """Resolve + enforce (nomad/acl.go ResolveToken). No-op until
        ACLs are enabled on the agent."""
        resolver = getattr(self.agent, "acl_resolver", None)
        if resolver is None:
            return
        acl = resolver.resolve(req.token)
        if not getattr(acl, check)(*args):
            raise HTTPError(403, "Permission denied")

    @property
    def _server(self):
        s = self.agent.server
        if s is None:
            raise HTTPError(400, "server is not enabled on this agent")
        return s

    # -- route table (http.go:321-411) -----------------------------------

    def _register_routes(self) -> None:
        def add(method: str, pattern: str, fn) -> None:
            self._routes.append((method, re.compile(pattern), fn))

        # web UI (reference serves the Ember app at /ui; http.go:318)
        add("GET", r"/", self.ui_redirect)
        add("GET", r"/ui/app\.js", self.ui_app_js)
        add("GET", r"/ui(?:/.*)?", self.ui_index)

        # jobs
        add("GET", r"/v1/jobs", self.jobs_list)
        add("PUT", r"/v1/jobs", self.job_register)
        add("POST", r"/v1/jobs", self.job_register)
        add("POST", r"/v1/jobs/parse", self.jobs_parse)
        add("PUT", r"/v1/validate/job", self.job_validate)
        add("POST", r"/v1/validate/job", self.job_validate)
        add("GET", r"/v1/job/(?P<id>[^/]+)", self.job_get)
        add("POST", r"/v1/job/(?P<id>[^/]+)", self.job_update)
        add("PUT", r"/v1/job/(?P<id>[^/]+)", self.job_update)
        add("DELETE", r"/v1/job/(?P<id>[^/]+)", self.job_delete)
        add("PUT", r"/v1/job/(?P<id>[^/]+)/plan", self.job_plan)
        add("POST", r"/v1/job/(?P<id>[^/]+)/plan", self.job_plan)
        add("GET", r"/v1/job/(?P<id>[^/]+)/allocations", self.job_allocs)
        add("GET", r"/v1/job/(?P<id>[^/]+)/evaluations", self.job_evals)
        add("GET", r"/v1/job/(?P<id>[^/]+)/deployments", self.job_deployments)
        add("GET", r"/v1/job/(?P<id>[^/]+)/deployment", self.job_latest_deployment)
        # multiregion gate release + failure propagation
        # (Deployment.Unblock / Deployment.Fail analogs, by job)
        add("POST", r"/v1/job/(?P<id>[^/]+)/deployment/unblock",
            self.job_deployment_unblock)
        add("POST", r"/v1/job/(?P<id>[^/]+)/deployment/fail",
            self.job_deployment_fail)
        add("GET", r"/v1/job/(?P<id>[^/]+)/summary", self.job_summary)
        add("GET", r"/v1/job/(?P<id>[^/]+)/versions", self.job_versions)
        add("POST", r"/v1/job/(?P<id>[^/]+)/revert", self.job_revert)
        add("PUT", r"/v1/job/(?P<id>[^/]+)/revert", self.job_revert)
        add("POST", r"/v1/job/(?P<id>[^/]+)/stable", self.job_stable)
        add("PUT", r"/v1/job/(?P<id>[^/]+)/stable", self.job_stable)
        add("POST", r"/v1/job/(?P<id>[^/]+)/dispatch", self.job_dispatch)
        add("PUT", r"/v1/job/(?P<id>[^/]+)/dispatch", self.job_dispatch)
        add("POST", r"/v1/job/(?P<id>[^/]+)/scale", self.job_scale)
        add("PUT", r"/v1/job/(?P<id>[^/]+)/scale", self.job_scale)
        add("GET", r"/v1/job/(?P<id>[^/]+)/scale", self.job_scale_status)
        add("POST", r"/v1/job/(?P<id>[^/]+)/periodic/force", self.job_periodic_force)
        add("PUT", r"/v1/job/(?P<id>[^/]+)/periodic/force", self.job_periodic_force)

        # nodes
        add("GET", r"/v1/nodes", self.nodes_list)
        add("GET", r"/v1/node/(?P<id>[^/]+)", self.node_get)
        add("GET", r"/v1/node/(?P<id>[^/]+)/allocations", self.node_allocs)
        add("POST", r"/v1/node/(?P<id>[^/]+)/drain", self.node_drain)
        add("PUT", r"/v1/node/(?P<id>[^/]+)/drain", self.node_drain)
        add("POST", r"/v1/node/(?P<id>[^/]+)/eligibility", self.node_eligibility)
        add("PUT", r"/v1/node/(?P<id>[^/]+)/eligibility", self.node_eligibility)
        add("POST", r"/v1/node/(?P<id>[^/]+)/evaluate", self.node_evaluate)
        add("PUT", r"/v1/node/(?P<id>[^/]+)/evaluate", self.node_evaluate)
        add("POST", r"/v1/node/(?P<id>[^/]+)/purge", self.node_purge)
        add("PUT", r"/v1/node/(?P<id>[^/]+)/purge", self.node_purge)

        # allocations
        add("GET", r"/v1/allocations", self.allocs_list)
        add("GET", r"/v1/allocation/(?P<id>[^/]+)", self.alloc_get)
        add("POST", r"/v1/allocation/(?P<id>[^/]+)/stop", self.alloc_stop)
        add("PUT", r"/v1/allocation/(?P<id>[^/]+)/stop", self.alloc_stop)

        # evaluations
        add("GET", r"/v1/evaluations", self.evals_list)
        add("GET", r"/v1/evaluation/(?P<id>[^/]+)", self.eval_get)
        add("GET", r"/v1/evaluation/(?P<id>[^/]+)/allocations", self.eval_allocs)

        # deployments
        add("GET", r"/v1/deployments", self.deployments_list)
        add("GET", r"/v1/deployment/(?P<id>[^/]+)", self.deployment_get)
        add("GET", r"/v1/deployment/allocations/(?P<id>[^/]+)", self.deployment_allocs)
        add("POST", r"/v1/deployment/fail/(?P<id>[^/]+)", self.deployment_fail)
        add("PUT", r"/v1/deployment/fail/(?P<id>[^/]+)", self.deployment_fail)
        add("POST", r"/v1/deployment/pause/(?P<id>[^/]+)", self.deployment_pause)
        add("PUT", r"/v1/deployment/pause/(?P<id>[^/]+)", self.deployment_pause)
        add("POST", r"/v1/deployment/promote/(?P<id>[^/]+)", self.deployment_promote)
        add("PUT", r"/v1/deployment/promote/(?P<id>[^/]+)", self.deployment_promote)

        # status / agent / operator
        add("GET", r"/v1/regions", self.regions_list)
        add("GET", r"/v1/status/leader", self.status_leader)
        add("GET", r"/v1/status/peers", self.status_peers)
        add("GET", r"/v1/agent/self", self.agent_self)
        add("GET", r"/v1/agent/health", self.agent_health)
        add("GET", r"/v1/agent/members", self.agent_members)
        add("PUT", r"/v1/agent/join", self.agent_join)
        add("POST", r"/v1/agent/join", self.agent_join)
        add("GET", r"/v1/agent/monitor", self.agent_monitor)
        add("GET", r"/v1/agent/pprof/goroutine", self.pprof_goroutine)
        add("GET", r"/v1/agent/pprof/profile", self.pprof_profile)
        add("GET", r"/v1/agent/pprof/heap", self.pprof_heap)
        add("GET", r"/v1/agent/servers", self.agent_servers)
        add("GET", r"/v1/metrics", self.metrics)
        add("GET", r"/v1/operator/traces", self.operator_traces)
        add("PUT", r"/v1/operator/traces", self.operator_traces_put)
        add("POST", r"/v1/operator/traces", self.operator_traces_put)
        add("GET", r"/v1/operator/slow-evals", self.operator_slow_evals)
        add("GET", r"/v1/operator/slow-raft", self.operator_slow_raft)
        add("GET", r"/v1/operator/stream-health", self.operator_stream_health)
        add("GET", r"/v1/operator/cluster-health",
            self.operator_cluster_health)
        add("GET", r"/v1/operator/scheduler/configuration", self.sched_config_get)
        add("PUT", r"/v1/operator/scheduler/configuration", self.sched_config_put)
        add("POST", r"/v1/operator/scheduler/configuration", self.sched_config_put)
        add("GET", r"/v1/operator/raft/configuration", self.raft_config)
        add("GET", r"/v1/operator/autopilot/configuration",
            self.autopilot_config_get)
        add("PUT", r"/v1/operator/autopilot/configuration",
            self.autopilot_config_put)
        add("POST", r"/v1/operator/autopilot/configuration",
            self.autopilot_config_put)
        add("GET", r"/v1/operator/autopilot/health", self.autopilot_health)
        add("GET", r"/v1/operator/snapshot", self.snapshot_save)
        add("PUT", r"/v1/operator/snapshot", self.snapshot_restore)
        add("POST", r"/v1/operator/snapshot", self.snapshot_restore)

        # system
        add("PUT", r"/v1/system/gc", self.system_gc)
        add("POST", r"/v1/system/gc", self.system_gc)
        add("PUT", r"/v1/system/reconcile/summaries", self.system_reconcile)
        add("POST", r"/v1/system/reconcile/summaries", self.system_reconcile)

        # search
        add("POST", r"/v1/search", self.search)
        add("PUT", r"/v1/search", self.search)
        add("POST", r"/v1/search/fuzzy", self.search_fuzzy)
        add("PUT", r"/v1/search/fuzzy", self.search_fuzzy)

        # namespaces
        add("GET", r"/v1/namespaces", self.namespaces_list)
        add("GET", r"/v1/namespace/(?P<name>[^/]+)", self.namespace_get)
        add("PUT", r"/v1/namespace/(?P<name>[^/]+)", self.namespace_upsert)
        add("POST", r"/v1/namespace/(?P<name>[^/]+)", self.namespace_upsert)
        add("PUT", r"/v1/namespace", self.namespace_upsert)
        add("POST", r"/v1/namespace", self.namespace_upsert)
        add("DELETE", r"/v1/namespace/(?P<name>[^/]+)", self.namespace_delete)

        # scaling
        add("GET", r"/v1/scaling/policies", self.scaling_policies)
        add("GET", r"/v1/scaling/policy/(?P<id>.+)", self.scaling_policy)

        # CSI volumes + plugins (http.go CSIVolumesRequest)
        add("GET", r"/v1/volumes", self.volumes_list)
        add("PUT", r"/v1/volumes", self.volume_register)
        add("POST", r"/v1/volumes", self.volume_register)
        add("GET", r"/v1/volume/csi/(?P<id>[^/]+)", self.volume_get)
        add("PUT", r"/v1/volume/csi/(?P<id>[^/]+)", self.volume_register)
        add("POST", r"/v1/volume/csi/(?P<id>[^/]+)", self.volume_register)
        add("DELETE", r"/v1/volume/csi/(?P<id>[^/]+)", self.volume_deregister)
        add("PUT", r"/v1/volume/csi/(?P<id>[^/]+)/create", self.volume_create)
        add("POST", r"/v1/volume/csi/(?P<id>[^/]+)/create", self.volume_create)
        add("DELETE", r"/v1/volume/csi/(?P<id>[^/]+)/delete", self.volume_delete)
        add("PUT", r"/v1/volume/csi/(?P<id>[^/]+)/detach", self.volume_detach)
        add("POST", r"/v1/volume/csi/(?P<id>[^/]+)/detach", self.volume_detach)
        add("GET", r"/v1/plugins", self.plugins_list)
        add("GET", r"/v1/plugin/csi/(?P<id>[^/]+)", self.plugin_get)

        # native service discovery (http.go ServiceRegistrations)
        add("GET", r"/v1/services", self.services_list)
        add("GET", r"/v1/service/(?P<name>[^/]+)", self.service_get)
        add("DELETE", r"/v1/service/(?P<name>[^/]+)/(?P<id>[^/]+)",
            self.service_delete)

        # event stream
        add("GET", r"/v1/event/stream", self.event_stream)

        # ACL
        add("POST", r"/v1/acl/bootstrap", self.acl_bootstrap)
        add("PUT", r"/v1/acl/bootstrap", self.acl_bootstrap)
        add("GET", r"/v1/acl/policies", self.acl_policies_list)
        add("GET", r"/v1/acl/policy/(?P<name>[^/]+)", self.acl_policy_get)
        add("PUT", r"/v1/acl/policy/(?P<name>[^/]+)", self.acl_policy_put)
        add("POST", r"/v1/acl/policy/(?P<name>[^/]+)", self.acl_policy_put)
        add("DELETE", r"/v1/acl/policy/(?P<name>[^/]+)", self.acl_policy_delete)
        add("GET", r"/v1/acl/tokens", self.acl_tokens_list)
        add("POST", r"/v1/acl/token/onetime", self.acl_ott_create)
        add("PUT", r"/v1/acl/token/onetime", self.acl_ott_create)
        add("POST", r"/v1/acl/token/onetime/exchange", self.acl_ott_exchange)
        add("PUT", r"/v1/acl/token/onetime/exchange", self.acl_ott_exchange)
        add("PUT", r"/v1/acl/token", self.acl_token_put)
        add("POST", r"/v1/acl/token", self.acl_token_put)
        add("GET", r"/v1/acl/token/self", self.acl_token_self)
        add("GET", r"/v1/acl/token/(?P<id>[^/]+)", self.acl_token_get)
        add("PUT", r"/v1/acl/token/(?P<id>[^/]+)", self.acl_token_put)
        add("POST", r"/v1/acl/token/(?P<id>[^/]+)", self.acl_token_put)
        add("DELETE", r"/v1/acl/token/(?P<id>[^/]+)", self.acl_token_delete)

        # client (stats/fs) routes
        add("GET", r"/v1/client/allocation/(?P<id>[^/]+)/stats", self.client_alloc_stats)
        add("POST", r"/v1/client/allocation/(?P<id>[^/]+)/restart", self.client_alloc_restart)
        add("PUT", r"/v1/client/allocation/(?P<id>[^/]+)/restart", self.client_alloc_restart)
        add("POST", r"/v1/client/allocation/(?P<id>[^/]+)/signal", self.client_alloc_signal)
        add("PUT", r"/v1/client/allocation/(?P<id>[^/]+)/signal", self.client_alloc_signal)
        add("POST", r"/v1/client/allocation/(?P<id>[^/]+)/exec", self.client_alloc_exec)
        add("PUT", r"/v1/client/allocation/(?P<id>[^/]+)/exec", self.client_alloc_exec)
        # websocket upgrade (interactive exec, api/allocations_exec.go)
        add("GET", r"/v1/client/allocation/(?P<id>[^/]+)/exec", self.client_alloc_exec)
        add("GET", r"/v1/client/fs/logs/(?P<id>[^/]+)", self.client_fs_logs)
        add("GET", r"/v1/client/fs/ls/(?P<id>[^/]+)", self.client_fs_ls)
        add("GET", r"/v1/client/fs/stat/(?P<id>[^/]+)", self.client_fs_stat)
        add("GET", r"/v1/client/fs/cat/(?P<id>[^/]+)", self.client_fs_cat)
        add("GET", r"/v1/client/fs/readat/(?P<id>[^/]+)", self.client_fs_readat)
        add("GET", r"/v1/client/stats", self.client_stats)

    # -- job handlers ----------------------------------------------------

    def _decode_job(self, data: Dict) -> Job:
        payload = data.get("Job", data) if isinstance(data, dict) else data
        job = decode(payload, Job)
        if job is None or not job.id:
            raise HTTPError(400, "Job must be specified")
        if not job.namespace:
            job.namespace = "default"
        return job

    def jobs_list(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "read-job")
        snap = self._read(req, ["jobs"])
        prefix = req.q("prefix")
        jobs = [
            _job_stub(j) for j in snap.jobs()
            if j.namespace == req.namespace and j.id.startswith(prefix)
        ]
        return sorted(jobs, key=lambda j: j["ID"])

    def job_register(self, req: Request):
        job = self._decode_job(req.body)
        self._acl(req, "allow_ns_op", job.namespace, "submit-job")
        res = self._server.job_register(job, token=req.token)
        return {"EvalID": res["eval_id"], "EvalCreateIndex": res["index"],
                "JobModifyIndex": res["index"], "Warnings": "; ".join(res["warnings"])}

    def job_update(self, req: Request):
        return self.job_register(req)

    def job_validate(self, req: Request):
        """Job.Validate (job_endpoint.go Validate): structural check
        without committing anything."""
        from nomad_tpu_torch.structs.job import Job

        body = req.body or {}
        if not isinstance(body, dict) or "Job" not in body:
            raise HTTPError(400, "Job is required")
        job = decode(body["Job"], Job)
        errs = job.validate()
        return {
            "DriverConfigValidated": True,
            "ValidationErrors": errs,
            "Error": "; ".join(errs) if errs else "",
            "Warnings": "",
        }

    def jobs_parse(self, req: Request):
        from nomad_tpu_torch.jobspec.parse import parse_hcl

        if not isinstance(req.body, dict) or "JobHCL" not in req.body:
            raise HTTPError(400, "JobHCL is required")
        job = parse_hcl(req.body["JobHCL"],
                        req.body.get("Variables") or None)
        return encode(job)

    def job_get(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "read-job")
        snap = self._read(req, ["jobs"])
        job = snap.job_by_id(req.namespace, req.params["id"])
        if job is None:
            raise HTTPError(404, "job not found")
        return job

    def job_delete(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "submit-job")
        res = self._server.job_deregister(
            req.namespace, req.params["id"], purge=req.flag("purge")
        )
        return {"EvalID": res["eval_id"], "EvalCreateIndex": res["index"],
                "JobModifyIndex": res["index"]}

    def job_plan(self, req: Request):
        job = self._decode_job(req.body)
        self._acl(req, "allow_ns_op", job.namespace, "submit-job")
        diff = bool(req.body.get("Diff")) if isinstance(req.body, dict) else False
        res = endpoints.job_plan(self._server, job, diff=diff)
        return {
            "Annotations": res["annotations"],
            "FailedTGAllocs": res["failed_tg_allocs"],
            "Diff": res["diff"],
            "JobModifyIndex": res["job_modify_index"],
            "CreatedEvals": res["created_evals"],
        }

    def job_allocs(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "read-job")
        snap = self._read(req, ["allocs"])
        allocs = snap.allocs_by_job(req.namespace, req.params["id"])
        return [_alloc_stub(a) for a in allocs]

    def job_evals(self, req: Request):
        snap = self._read(req, ["evals"])
        return snap.evals_by_job(req.namespace, req.params["id"])

    def job_deployments(self, req: Request):
        snap = self._read(req, ["deployment"])
        return snap.deployments_by_job_id(req.namespace, req.params["id"])

    def job_latest_deployment(self, req: Request):
        snap = self._read(req, ["deployment"])
        return snap.latest_deployment_by_job_id(req.namespace, req.params["id"])

    def job_deployment_unblock(self, req: Request):
        """Multiregion gate release: an earlier region succeeded
        (Deployment.Unblock; deployment watcher cross-region kick)."""
        self._acl(req, "allow_ns_op", req.namespace, "submit-job")
        index, unblocked = self._server.unblock_job_deployment(
            req.namespace, req.params["id"])
        return {"Index": index, "Unblocked": unblocked}

    def job_deployment_fail(self, req: Request):
        """Multiregion failure propagation: an earlier/peer region
        failed and the job's on_failure strategy fails this one too."""
        self._acl(req, "allow_ns_op", req.namespace, "submit-job")
        index, failed = self._server.fail_job_deployment(
            req.namespace, req.params["id"],
            "Failed because of an unsuccessful deployment in a "
            "federated region")
        return {"Index": index, "Failed": failed}

    def job_summary(self, req: Request):
        snap = self._read(req, ["allocs"])
        job = snap.job_by_id(req.namespace, req.params["id"])
        if job is None:
            raise HTTPError(404, "job not found")
        summary: Dict[str, Dict[str, int]] = {}
        for tg in job.task_groups:
            summary[tg.name] = {
                "Queued": 0, "Complete": 0, "Failed": 0, "Running": 0,
                "Starting": 0, "Lost": 0, "Unknown": 0,
            }
        for a in snap.allocs_by_job(req.namespace, job.id):
            tg = summary.setdefault(a.task_group, {
                "Queued": 0, "Complete": 0, "Failed": 0, "Running": 0,
                "Starting": 0, "Lost": 0, "Unknown": 0,
            })
            status = {
                consts.ALLOC_CLIENT_PENDING: "Starting",
                consts.ALLOC_CLIENT_RUNNING: "Running",
                consts.ALLOC_CLIENT_COMPLETE: "Complete",
                consts.ALLOC_CLIENT_FAILED: "Failed",
                consts.ALLOC_CLIENT_LOST: "Lost",
                consts.ALLOC_CLIENT_UNKNOWN: "Unknown",
            }.get(a.client_status, "Starting")
            tg[status] += 1
        return {"JobID": job.id, "Namespace": job.namespace, "Summary": summary}

    def job_versions(self, req: Request):
        snap = self._read(req, ["jobs"])
        versions = []
        v = 0
        job = snap.job_by_id(req.namespace, req.params["id"])
        if job is None:
            raise HTTPError(404, "job not found")
        for v in range(job.version, -1, -1):
            jv = snap.job_by_id_and_version(req.namespace, req.params["id"], v)
            if jv is not None:
                versions.append(jv)
        return {"Versions": versions}

    def job_revert(self, req: Request):
        body = req.body or {}
        res = endpoints.job_revert(
            self._server, req.namespace, req.params["id"],
            int(body.get("JobVersion", 0)),
            body.get("EnforcePriorVersion"),
        )
        return {"EvalID": res["eval_id"], "Index": res["index"]}

    def job_stable(self, req: Request):
        body = req.body or {}
        res = endpoints.job_stable(
            self._server, req.namespace, req.params["id"],
            int(body.get("JobVersion", 0)), bool(body.get("Stable", False)),
        )
        return {"Index": res["index"]}

    def job_dispatch(self, req: Request):
        body = req.body or {}
        import base64

        payload = base64.b64decode(body.get("Payload", "") or "")
        res = endpoints.job_dispatch(
            self._server, req.namespace, req.params["id"],
            payload=payload, meta=body.get("Meta") or {},
        )
        return {"DispatchedJobID": res["dispatched_job_id"],
                "EvalID": res["eval_id"], "Index": res["index"]}

    def job_scale(self, req: Request):
        body = req.body or {}
        target = body.get("Target") or {}
        res = endpoints.job_scale(
            self._server, req.namespace, req.params["id"],
            target.get("Group", ""),
            body.get("Count"),
            message=body.get("Message", ""),
            error=bool(body.get("Error", False)),
            meta=body.get("Meta"),
        )
        return {"EvalID": res["eval_id"], "EvalCreateIndex": res["index"]}

    def job_scale_status(self, req: Request):
        snap = self._read(req)
        job = snap.job_by_id(req.namespace, req.params["id"])
        if job is None:
            raise HTTPError(404, "job not found")
        groups = {}
        allocs = snap.allocs_by_job(req.namespace, job.id)
        for tg in job.task_groups:
            running = sum(
                1 for a in allocs
                if a.task_group == tg.name
                and a.client_status == consts.ALLOC_CLIENT_RUNNING
            )
            groups[tg.name] = {
                "Desired": tg.count,
                "Running": running,
                "Events": self._server.state.scaling_events(req.namespace, job.id),
            }
        return {"JobID": job.id, "JobStopped": job.stopped(),
                "TaskGroups": groups}

    def job_periodic_force(self, req: Request):
        snap = self._server.state.snapshot()
        job = snap.job_by_id(req.namespace, req.params["id"])
        if job is None:
            raise HTTPError(404, "job not found")
        if not job.is_periodic():
            raise HTTPError(400, "job is not periodic")
        child = self._server.periodic_dispatcher.force_run(job)
        return {"EvalCreateIndex": self._server.state.latest_index(),
                "EvalID": child}

    # -- node handlers ---------------------------------------------------

    def nodes_list(self, req: Request):
        self._acl(req, "allow_node_read")
        snap = self._read(req, ["nodes"])
        prefix = req.q("prefix")
        with_res = req.flag("resources")
        return sorted(
            (_node_stub(n, resources=with_res)
             for n in snap.nodes() if n.id.startswith(prefix)),
            key=lambda n: n["ID"],
        )

    def node_get(self, req: Request):
        self._acl(req, "allow_node_read")
        snap = self._read(req, ["nodes"])
        node = snap.node_by_id(req.params["id"])
        if node is None:
            raise HTTPError(404, "node not found")
        return node

    def node_allocs(self, req: Request):
        snap = self._read(req, ["allocs"])
        return snap.allocs_by_node(req.params["id"])

    def node_drain(self, req: Request):
        self._acl(req, "allow_node_write")
        body = req.body or {}
        spec = body.get("DrainSpec")
        enable = spec is not None
        strategy = None
        if enable:
            from nomad_tpu_torch.server.drainer import DrainStrategy
            strategy = DrainStrategy(
                deadline_s=float(spec.get("Deadline", 0)) / 1e9
                if spec.get("Deadline") else 3600.0,
                ignore_system_jobs=bool(spec.get("IgnoreSystemJobs",
                                                 False)),
            )
        index = self._server.node_update_drain(req.params["id"], enable, strategy)
        return {"EvalIDs": [], "EvalCreateIndex": index, "NodeModifyIndex": index}

    def node_eligibility(self, req: Request):
        self._acl(req, "allow_node_write")
        body = req.body or {}
        elig = body.get("Eligibility", "")
        if elig not in (consts.NODE_SCHEDULING_ELIGIBLE,
                        consts.NODE_SCHEDULING_INELIGIBLE):
            raise HTTPError(400, f"invalid eligibility '{elig}'")
        index = self._server.node_update_eligibility(req.params["id"], elig)
        return {"NodeModifyIndex": index}

    def node_evaluate(self, req: Request):
        res = endpoints.node_evaluate(self._server, req.params["id"])
        return {"EvalIDs": res["eval_ids"], "EvalCreateIndex": res["index"]}

    def node_purge(self, req: Request):
        self._acl(req, "allow_node_write")
        res = endpoints.node_deregister(self._server, req.params["id"])
        return {"EvalIDs": res["eval_ids"], "NodeModifyIndex": res["index"]}

    # -- alloc / eval handlers -------------------------------------------

    def allocs_list(self, req: Request):
        snap = self._read(req, ["allocs"])
        prefix = req.q("prefix")
        with_res = req.flag("resources")
        out = [
            _alloc_stub(a, resources=with_res) for a in snap.allocs_iter()
            if a.namespace == req.namespace and a.id.startswith(prefix)
        ]
        return sorted(out, key=lambda a: a["ID"])

    def alloc_get(self, req: Request):
        snap = self._read(req, ["allocs"])
        alloc = snap.alloc_by_id(req.params["id"])
        if alloc is None:
            raise HTTPError(404, "alloc not found")
        return alloc

    def alloc_stop(self, req: Request):
        res = endpoints.alloc_stop(self._server, req.params["id"])
        return {"EvalID": res["eval_id"], "Index": res["index"]}

    def evals_list(self, req: Request):
        snap = self._read(req, ["evals"])
        prefix = req.q("prefix")
        return sorted(
            (e for e in snap.evals_iter()
             if e.namespace == req.namespace and e.id.startswith(prefix)),
            key=lambda e: e.id,
        )

    def eval_get(self, req: Request):
        snap = self._read(req, ["evals"])
        ev = snap.eval_by_id(req.params["id"])
        if ev is None:
            raise HTTPError(404, "eval not found")
        return ev

    def eval_allocs(self, req: Request):
        snap = self._read(req, ["allocs"])
        return [_alloc_stub(a) for a in snap.allocs_by_eval(req.params["id"])]

    # -- deployment handlers ---------------------------------------------

    def deployments_list(self, req: Request):
        snap = self._read(req, ["deployment"])
        return sorted(
            (d for d in snap.deployments_iter() if d.namespace == req.namespace),
            key=lambda d: d.id,
        )

    def deployment_get(self, req: Request):
        snap = self._read(req, ["deployment"])
        d = snap.deployment_by_id(req.params["id"])
        if d is None:
            raise HTTPError(404, "deployment not found")
        return d

    def deployment_allocs(self, req: Request):
        snap = self._read(req)
        return [
            _alloc_stub(a) for a in snap.allocs_iter()
            if a.deployment_id == req.params["id"]
        ]

    def deployment_fail(self, req: Request):
        index = self._server.deployments_watcher.fail_deployment(req.params["id"])
        return {"DeploymentModifyIndex": index}

    def deployment_pause(self, req: Request):
        body = req.body or {}
        index = self._server.deployments_watcher.pause_deployment(
            req.params["id"], bool(body.get("Pause", False))
        )
        return {"DeploymentModifyIndex": index}

    def deployment_promote(self, req: Request):
        body = req.body or {}
        index = self._server.deployments_watcher.promote_deployment(
            req.params["id"], body.get("Groups"), bool(body.get("All", True)),
        )
        return {"DeploymentModifyIndex": index}

    # -- status / agent / operator ---------------------------------------

    def status_leader(self, req: Request):
        s = self._server
        if s.raft is not None:
            return s.raft.leader_id or ""
        return s.config.name

    def status_peers(self, req: Request):
        s = self._server
        if s.raft is not None:
            return list(s.raft.peers)
        return [s.config.name]

    def agent_self(self, req: Request):
        a = self.agent
        stats = {}
        if a.server is not None:
            stats["nomad"] = a.server.stats()
        if a.client is not None:
            stats["client"] = a.client.stats()
        return {
            "Config": {
                "Region": a.config.region,
                "Datacenter": a.config.datacenter,
                "Name": a.config.name,
                "Server": a.server is not None,
                "Client": a.client is not None,
                "Version": {"Version": "0.1.0"},
            },
            "Stats": stats,
            "Member": {"Name": a.config.name, "Addr": self.addr},
        }

    def agent_health(self, req: Request):
        ok = {"ok": True, "message": "ok"}
        return {
            "server": ok if self.agent.server is not None else None,
            "client": ok if self.agent.client is not None else None,
        }

    def agent_join(self, req: Request):
        """PUT /v1/agent/join?address=<http addr>&join_region=<name>:
        federate with another region (serf WAN join analog). agent:write
        gated -- an open join would let anyone redirect token-bearing
        forwarded requests to their own endpoint."""
        self._acl(req, "allow_agent_write")
        addr = req.q("address")
        region = req.q("join_region")
        if not addr or not region:
            raise HTTPError(400, "address and join_region are required")
        if not addr.startswith(("http://", "https://")):
            raise HTTPError(400, f"address must be an http(s) URL: {addr!r}")
        if region == self.agent.config.region:
            raise HTTPError(400, f"cannot join own region {region!r}")
        self._server.join_region(region, addr)
        return {"num_joined": 1}

    # -- web UI ----------------------------------------------------------

    _UI_HTML: Optional[bytes] = None

    def ui_redirect(self, req: Request):
        h = req.handler
        h.send_response(307)
        h.send_header("Location", "/ui/")
        h.send_header("Content-Length", "0")
        h.end_headers()
        return StreamedResponse

    def _serve_static(self, req: Request, cache_attr: str, relpath: str,
                      content_type: str):
        """Lazily-cached static asset from the ui/ directory."""
        cls = type(self)
        body = getattr(cls, cache_attr, None)
        if body is None:
            path = os.path.join(os.path.dirname(__file__), "..", "ui",
                                relpath)
            with open(path, "rb") as f:
                body = f.read()
            setattr(cls, cache_attr, body)
        h = req.handler
        h.send_response(200)
        h.send_header("Content-Type", content_type)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)
        return StreamedResponse

    def ui_index(self, req: Request):
        """Serve the SPA shell; every /ui/* path gets the same document
        (hash routing client-side)."""
        return self._serve_static(req, "_UI_HTML", "index.html",
                                  "text/html; charset=utf-8")

    _UI_JS = None

    def ui_app_js(self, req: Request):
        """The SPA's application module (extracted from the document so
        tests and tooling can read it standalone)."""
        return self._serve_static(
            req, "_UI_JS", "app.js",
            "application/javascript; charset=utf-8")

    @staticmethod
    def _write_chunk(h, payload: bytes) -> None:
        h.wfile.write(f"{len(payload):x}\r\n".encode())
        h.wfile.write(payload + b"\r\n")
        h.wfile.flush()

    @staticmethod
    def _end_chunks(h) -> None:
        """Best-effort terminal chunk so clients see a clean EOF even
        after a mid-stream error."""
        try:
            h.wfile.write(b"0\r\n\r\n")
            h.wfile.flush()
        except OSError:
            pass

    @classmethod
    def _begin_chunked(cls, h, content_type: str = "application/json"):
        """Start a chunked response; returns the frame writer."""
        h.send_response(200)
        h.send_header("Content-Type", content_type)
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()
        return lambda payload: cls._write_chunk(h, payload)

    def agent_monitor(self, req: Request):
        """GET /v1/agent/monitor?log_level=X: stream agent logs as
        NDJSON frames (monitor.go / ndjson streaming)."""
        from nomad_tpu_torch.utils.monitor import LogMonitor

        self._acl(req, "allow_agent_read")
        level = req.q("log_level", "info")
        mon = LogMonitor.install()
        h = req.handler
        deadline = time.time() + 600.0
        stop = threading.Event()
        try:
            write_chunk = self._begin_chunked(h)
            for line in mon.stream(level, stop):
                if time.time() > deadline:
                    stop.set()
                    break
                obj = {"Data": line} if line else {}
                write_chunk(json.dumps(obj).encode() + b"\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            stop.set()
            self._end_chunks(h)
        return StreamedResponse

    def pprof_goroutine(self, req: Request):
        from nomad_tpu_torch.utils.monitor import thread_dump

        self._acl(req, "allow_agent_read")
        return {"Profile": thread_dump()}

    def pprof_profile(self, req: Request):
        from nomad_tpu_torch.utils.monitor import sample_profile

        self._acl(req, "allow_agent_read")
        seconds = min(float(req.q("seconds", "1") or 1), 30.0)
        return {"Profile": sample_profile(seconds)}

    def pprof_heap(self, req: Request):
        from nomad_tpu_torch.utils.monitor import heap_summary

        self._acl(req, "allow_agent_read")
        return {"Profile": heap_summary()}

    def agent_members(self, req: Request):
        members = getattr(self.agent, "members", None)
        if members is not None:
            return {"ServerRegion": self.agent.config.region,
                    "Members": members()}
        return {"ServerRegion": self.agent.config.region,
                "Members": [{"Name": self.agent.config.name,
                             "Status": "alive", "Addr": self.addr}]}

    def agent_servers(self, req: Request):
        return [self.addr]

    def metrics(self, req: Request):
        from nomad_tpu_torch.telemetry import exporter
        from nomad_tpu_torch.utils import metrics as m

        if req.q("format") == "prometheus":
            # real text exposition (text/plain), not a JSON-quoted
            # string: Prometheus scrapers parse the raw body. The
            # event broker is per-server state — pass it so the
            # nomad_tpu_stream_* serving-plane gauges ride the scrape
            broker = self.agent.server.event_broker \
                if self.agent.server is not None else None
            self._send_text(req.handler,
                            exporter.prometheus_text(
                                m.global_registry, event_broker=broker))
            return StreamedResponse
        return m.global_registry.summary()

    def operator_traces(self, req: Request):
        """Operator trace dump (gated like the event stream: the token
        must hold a real capability — operator:read — or the request
        is rejected outright)."""
        from nomad_tpu_torch.telemetry import exporter

        self._acl(req, "allow_operator_read")
        try:
            limit = int(req.q("limit", "2000") or 2000)
        except ValueError:
            limit = 2000
        # ?trace_id= narrows the dump to one eval's span tree
        # (Tracer.spans already filters; this is the HTTP plumbing)
        return exporter.traces_json(limit=limit,
                                    trace_id=req.q("trace_id", ""))

    def operator_slow_evals(self, req: Request):
        """Slow-eval flight recorder dump: complete span trees of the
        evals that crossed the adaptive e2e-p99 threshold, plus the
        streaming latency histogram summaries. Same ACL as the trace
        dump (operator:read)."""
        from nomad_tpu_torch.telemetry import exporter

        self._acl(req, "allow_operator_read")
        try:
            limit = int(req.q("limit", "0") or 0)
        except ValueError:
            limit = 0
        return exporter.slow_evals_json(limit=limit)

    def operator_slow_raft(self, req: Request):
        """Consensus flight recorder dump: slow raft
        appends / WAL fsync batches / elections past their adaptive
        thresholds — the slow-evals recorder's sibling. Same ACL
        (operator:read)."""
        from nomad_tpu_torch.telemetry import exporter

        self._acl(req, "allow_operator_read")
        try:
            limit = int(req.q("limit", "0") or 0)
        except ValueError:
            limit = 0
        return exporter.slow_raft_json(limit=limit)

    def operator_cluster_health(self, req: Request):
        """Autopilot-style consensus health: this server's
        raft identity/term/state, per-peer match/lag/last-contact
        (leader-side), WAL occupancy + durability counters, consensus
        latency distributions, transition counters, and the fault
        plane's arm state. ACL: operator:read."""
        from nomad_tpu_torch.telemetry import exporter

        self._acl(req, "allow_operator_read")
        return exporter.cluster_health_json(self._server)

    def operator_stream_health(self, req: Request):
        """Serving-plane health in one pull: event-ring
        publish/deliver/lost counters + subscriber lag, blocking-query
        wakeup accounting, heartbeat fan-in coalescing, and the
        delivery-lag histogram summary. Same ACL as the trace dump
        (operator:read)."""
        from nomad_tpu_torch.telemetry import exporter

        self._acl(req, "allow_operator_read")
        return exporter.stream_health_json(self._server.event_broker)

    def operator_traces_put(self, req: Request):
        """Toggle tracing at runtime: {"Enable": true|false}, optional
        {"Reset": true} to clear collected spans first."""
        from nomad_tpu_torch import telemetry

        self._acl(req, "allow_operator_write")
        body = req.body if isinstance(req.body, dict) else {}
        if body.get("Reset"):
            telemetry.reset()
        if "Enable" in body:
            if body["Enable"]:
                telemetry.enable()
            else:
                telemetry.disable()
        return {"Enabled": telemetry.enabled()}

    def sched_config_get(self, req: Request):
        cfg = self._server.state.scheduler_config
        return {
            "SchedulerConfig": {
                "SchedulerAlgorithm": cfg.scheduler_algorithm,
                "MemoryOversubscriptionEnabled": cfg.memory_oversubscription_enabled,
                "PauseEvalBroker": cfg.pause_eval_broker,
                "PreemptionConfig": {
                    "SystemSchedulerEnabled": cfg.preemption_system_enabled,
                    "SysBatchSchedulerEnabled": cfg.preemption_system_enabled,
                    "BatchSchedulerEnabled": cfg.preemption_batch_enabled,
                    "ServiceSchedulerEnabled": cfg.preemption_service_enabled,
                },
            }
        }

    def sched_config_put(self, req: Request):
        from nomad_tpu_torch.server import fsm as fsm_msgs
        from nomad_tpu_torch.state.store import SchedulerConfiguration

        body = req.body or {}
        cfg = SchedulerConfiguration()
        cfg.scheduler_algorithm = body.get(
            "SchedulerAlgorithm", consts.SCHEDULER_ALGORITHM_BINPACK
        )
        cfg.memory_oversubscription_enabled = bool(
            body.get("MemoryOversubscriptionEnabled", False)
        )
        cfg.pause_eval_broker = bool(body.get("PauseEvalBroker", False))
        pre = body.get("PreemptionConfig") or {}
        cfg.preemption_system_enabled = bool(pre.get("SystemSchedulerEnabled", True))
        cfg.preemption_batch_enabled = bool(pre.get("BatchSchedulerEnabled", False))
        cfg.preemption_service_enabled = bool(pre.get("ServiceSchedulerEnabled", False))
        index = self._server.raft_apply(fsm_msgs.SCHEDULER_CONFIG, {"config": cfg})
        return {"Updated": True, "Index": index}

    def regions_list(self, req: Request):
        """region_endpoint.go List."""
        return self._server.known_regions()

    def raft_config(self, req: Request):
        """operator_endpoint.go RaftGetConfiguration: ID/Node/Address/
        Leader/Voter per server — THIS server included (raft.peers
        excludes self). The UI and `operator raft list-peers` both
        render Address; the contract walk caught it missing."""
        self._acl(req, "allow_operator_read")
        s = self._server
        if s.raft is None:
            return {"Servers": [{"ID": s.config.name, "Node": s.config.name,
                                 "Address": s.config.name,
                                 "Leader": True, "Voter": True}], "Index": 0}
        leader = s.raft.leader_addr()
        rows = [{"ID": rid, "Node": rid, "Address": rid,
                 "Leader": rid == leader, "Voter": True}
                for rid in [s.raft.id, *s.raft.peers]]
        return {"Servers": rows, "Index": s.raft.commit_index}

    def autopilot_config_get(self, req: Request):
        self._acl(req, "allow_operator_read")
        cfg = self._server.state.autopilot_config
        return {
            "CleanupDeadServers": cfg.get("cleanup_dead_servers", True),
            "LastContactThreshold":
                f"{cfg.get('last_contact_threshold_s', 10.0)}s",
            "ServerStabilizationTime":
                f"{cfg.get('server_stabilization_time_s', 10.0)}s",
        }

    def autopilot_config_put(self, req: Request):
        from nomad_tpu_torch.server import fsm as fsm_msgs

        self._acl(req, "allow_operator_write")
        body = req.body or {}

        def dur(key, default):
            raw = body.get(key)
            if raw is None:
                return default
            parsed = parse_duration(raw)
            if parsed is None:
                raise HTTPError(400, f"invalid duration for {key}: {raw!r}")
            return parsed

        cfg = {
            "cleanup_dead_servers": bool(body.get("CleanupDeadServers", True)),
            "last_contact_threshold_s": dur("LastContactThreshold", 10.0),
            "server_stabilization_time_s": dur("ServerStabilizationTime", 10.0),
        }
        index = self._server.raft_apply(
            fsm_msgs.AUTOPILOT_CONFIG, {"config": cfg}
        )
        return {"Updated": True, "Index": index}

    def autopilot_health(self, req: Request):
        self._acl(req, "allow_operator_read")
        return self._server.autopilot.health()

    def snapshot_save(self, req: Request):
        import base64

        from nomad_tpu_torch.utils.snapshot import archive_snapshot

        data = archive_snapshot(self._server)
        return {"Snapshot": base64.b64encode(data).decode()}

    def snapshot_restore(self, req: Request):
        import base64

        from nomad_tpu_torch.utils.snapshot import restore_snapshot

        body = req.body or {}
        if "Snapshot" not in body:
            raise HTTPError(400, "Snapshot is required")
        restore_snapshot(self._server, base64.b64decode(body["Snapshot"]))
        return {"Restored": True}

    def system_gc(self, req: Request):
        self._server.force_gc()
        return {}

    def system_reconcile(self, req: Request):
        return {}

    # -- search ----------------------------------------------------------

    def search(self, req: Request):
        from nomad_tpu_torch.server.search import prefix_search

        body = req.body or {}
        return prefix_search(
            self._server.state.snapshot(),
            body.get("Prefix", ""), body.get("Context", "all"),
            namespace=req.namespace,
        )

    def search_fuzzy(self, req: Request):
        from nomad_tpu_torch.server.search import fuzzy_search

        body = req.body or {}
        return fuzzy_search(
            self._server.state.snapshot(),
            body.get("Text", ""), body.get("Context", "all"),
            namespace=req.namespace,
        )

    # -- namespaces / scaling --------------------------------------------

    def namespaces_list(self, req: Request):
        return sorted(self._server.state.namespaces(), key=lambda n: n.name)

    def namespace_get(self, req: Request):
        ns = self._server.state.namespace_by_name(req.params["name"])
        if ns is None:
            raise HTTPError(404, "namespace not found")
        return ns

    def namespace_upsert(self, req: Request):
        from nomad_tpu_torch.server import fsm as fsm_msgs
        from nomad_tpu_torch.structs.namespace import Namespace

        body = req.body or {}
        name = req.params.get("name") or body.get("Name", "")
        if not name:
            raise HTTPError(400, "namespace name required")
        ns = Namespace(name=name, description=body.get("Description", ""),
                       quota=body.get("Quota", ""))
        index = self._server.raft_apply(
            fsm_msgs.NAMESPACE_UPSERT, {"namespaces": [ns]}
        )
        return {"Index": index}

    def namespace_delete(self, req: Request):
        from nomad_tpu_torch.server import fsm as fsm_msgs

        index = self._server.raft_apply(
            fsm_msgs.NAMESPACE_DELETE, {"names": [req.params["name"]]}
        )
        return {"Index": index}

    def scaling_policies(self, req: Request):
        return self._server.state.scaling_policies()

    def scaling_policy(self, req: Request):
        p = self._server.state.scaling_policy_by_id(req.params["id"])
        if p is None:
            raise HTTPError(404, "scaling policy not found")
        return p

    # -- CSI volumes + plugins (csi_endpoint.go) -------------------------

    def volumes_list(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "csi-list-volume")
        self._read(req, ["csi_volumes"])
        ns = req.namespace
        plugin_id = req.q("plugin_id")
        vols = [
            v for v in self._server.state.csi_volumes()
            if (ns in ("*", v.namespace))
            and (not plugin_id or v.plugin_id == plugin_id)
        ]
        return [v.stub() for v in sorted(vols, key=lambda v: v.id)]

    def volume_get(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "csi-read-volume")
        self._read(req, ["csi_volumes"])
        vol = self._server.state.csi_volume_by_id(
            req.namespace, req.params["id"]
        )
        if vol is None:
            raise HTTPError(404, "volume not found")
        # secrets never leave the server (csi_endpoint.go Get strips
        # Secrets before responding)
        redacted = vol.copy()
        redacted.secrets = {k: "[REDACTED]" for k in vol.secrets}
        return redacted

    def volume_register(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "csi-write-volume")
        vols = self._decode_volumes(req)
        try:
            index = self._server.csi_volume_register(vols)
        except ValueError as e:
            raise HTTPError(400, str(e))
        return {"Index": index}

    def volume_create(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "csi-write-volume")
        vols = self._decode_volumes(req)
        try:
            created = self._server.csi_volume_create(vols)
        except ValueError as e:
            raise HTTPError(400, str(e))
        return {"Volumes": created}

    def _decode_volumes(self, req: Request):
        from nomad_tpu_torch.api.codec import decode
        from nomad_tpu_torch.structs.csi import CSIVolume

        body = req.body or {}
        raw = body.get("Volumes") or ([body.get("Volume")]
                                      if body.get("Volume") else [])
        if not raw:
            raise HTTPError(400, "no volumes provided")
        vols = []
        for r in raw:
            v = decode(r, CSIVolume)
            if not v.namespace or v.namespace == "default":
                v.namespace = req.namespace if req.namespace != "*" \
                    else "default"
            vols.append(v)
        return vols

    def volume_deregister(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "csi-write-volume")
        try:
            index = self._server.csi_volume_deregister(
                req.namespace, req.params["id"], force=req.flag("force")
            )
        except ValueError as e:
            raise HTTPError(400 if "in use" in str(e) else 404, str(e))
        return {"Index": index}

    def volume_delete(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "csi-write-volume")
        try:
            index = self._server.csi_volume_delete(
                req.namespace, req.params["id"]
            )
        except ValueError as e:
            raise HTTPError(400 if "in use" in str(e) else 404, str(e))
        return {"Index": index}

    def volume_detach(self, req: Request):
        """Force-release one alloc's (or node's) claims
        (csi_endpoint.go Unpublish)."""
        self._acl(req, "allow_ns_op", req.namespace, "csi-write-volume")
        vol = self._server.state.csi_volume_by_id(
            req.namespace, req.params["id"]
        )
        if vol is None:
            raise HTTPError(404, "volume not found")
        node_id = req.q("node")
        alloc_id = req.q("alloc")
        index = self._server.state.latest_index()
        for claims in (vol.read_claims, vol.write_claims):
            for aid, claim in list(claims.items()):
                if alloc_id and aid != alloc_id:
                    continue
                if node_id and claim.node_id != node_id:
                    continue
                index = self._server.csi_volume_claim(
                    vol.namespace, vol.id, claim.release_copy()
                )
        return {"Index": index}

    def plugins_list(self, req: Request):
        self._acl(req, "allow_plugin_read")
        self._read(req, ["nodes"])
        plugins = self._server.csi_plugins()
        return [p.stub() for p in sorted(plugins.values(), key=lambda p: p.id)]

    def plugin_get(self, req: Request):
        self._acl(req, "allow_plugin_read")
        self._read(req, ["nodes"])
        p = self._server.csi_plugins().get(req.params["id"])
        if p is None:
            raise HTTPError(404, "plugin not found")
        out = p.stub()
        out["Controllers"] = p.controllers
        out["Nodes"] = p.nodes
        return out

    # -- native service discovery (service_registration_endpoint.go) -----

    def services_list(self, req: Request):
        """Grouped stubs: [{Namespace, Services: [{ServiceName, Tags}]}]
        (service_registration_endpoint.go List)."""
        self._acl(req, "allow_ns_op", req.namespace, "read-job")
        self._read(req, ["services"])
        regs = self._server.state.service_registrations(req.namespace)
        by_ns: Dict[str, Dict[str, set]] = {}
        for r in regs:
            tags = by_ns.setdefault(r.namespace, {}).setdefault(
                r.service_name, set()
            )
            tags.update(r.tags)
        return [
            {
                "Namespace": ns,
                "Services": [
                    {"ServiceName": name, "Tags": sorted(tags)}
                    for name, tags in sorted(services.items())
                ],
            }
            for ns, services in sorted(by_ns.items())
        ]

    def service_get(self, req: Request):
        self._acl(req, "allow_ns_op", req.namespace, "read-job")
        self._read(req, ["services"])
        regs = self._server.state.service_registrations_by_name(
            req.namespace, req.params["name"]
        )
        return [r.stub() for r in sorted(regs, key=lambda r: r.id)]

    def service_delete(self, req: Request):
        reg = self._server.state.service_registration_by_id(req.params["id"])
        if reg is None or reg.service_name != req.params["name"] \
                or reg.namespace != req.namespace:
            raise HTTPError(404, "service registration not found")
        self._acl(req, "allow_ns_op", reg.namespace, "submit-job")
        try:
            index = self._server.service_deregister(reg.id)
        except ValueError as e:
            raise HTTPError(404, str(e))
        return {"Index": index}

    # -- event stream (stream/ndjson.go) ---------------------------------

    def event_stream(self, req: Request):
        broker = self._server.event_broker
        # subscriptions are inherently local reads: each server's FSM
        # feeds its own ring, so a follower serves its own events and
        # resumes by raft index across failovers. Route
        # through the read plane in stale mode so the subscriber gets
        # the same staleness attribution + max_stale rejection as any
        # other query — a follower over the caller's bound refuses the
        # stream loudly instead of silently lagging it.
        _, max_stale = req.consistency_params()
        self._server.readplane.resolve("stale", max_stale)
        resolver = getattr(self.agent, "acl_resolver", None)

        # subscribe-time ACL (event_broker.go:55 SubscribeWithACLCheck):
        # the token must resolve NOW, and is re-resolved every poll so a
        # revocation drops the stream (handleACLUpdates analog) instead
        # of a dead token riding a live subscription forever
        def _resolve():
            if resolver is None:
                return None
            try:
                acl = resolver.resolve(req.token)
            except PermissionError:
                raise HTTPError(403, "Permission denied")
            # SubscribeWithACLCheck rejects tokens with no relevant
            # read capability at all (incl. anonymous) outright rather
            # than letting them hold a 600s heartbeat-only stream
            if not (acl.is_management() or acl.allow_node_read()
                    or acl.allow_any_ns_op("read-job")):
                raise HTTPError(403, "Permission denied")
            return acl

        acl = _resolve()

        def _visible(ev) -> bool:
            """Namespace/topic capability filter (aclAllowsSubscription):
            Node/ACL topics need node:read / management; namespaced
            topics need read-job capability on the event's namespace.
            LostEvents markers always pass — a slow consumer must learn
            it lost events (the marker carries a count and a resume
            index, never another namespace's payload)."""
            if ev.topic == "LostEvents":
                return True
            if acl is None or acl.is_management():
                return True
            if ev.topic in ("ACLToken", "ACLPolicy"):
                return False
            if ev.topic == "Node":
                return acl.allow_node_read()
            return acl.allow_ns_op(ev.namespace or "default", "read-job")

        topics: Dict[str, List[str]] = {}
        for t in req.query.get("topic", []):
            if ":" in t:
                topic, key = t.split(":", 1)
            else:
                topic, key = t, "*"
            topics.setdefault(topic, []).append(key)
        index, _ = req.wait_params()
        sub = broker.subscribe(topics or {"*": ["*"]}, from_index=index)
        h = req.handler
        try:
            write_chunk = self._begin_chunked(h)
            deadline = time.time() + 600
            last_write = time.time()
            while time.time() < deadline:
                events = sub.next_events(timeout=5.0)
                try:
                    acl = _resolve()
                except HTTPError:
                    break               # token revoked: drop the stream
                events = [e for e in events if _visible(e)]
                if events:
                    batch = {
                        "Index": events[-1].index,
                        "Events": [encode(e) for e in events],
                    }
                    payload = (json.dumps(batch) + "\n").encode()
                    write_chunk(payload)
                    broker.note_delivered_bytes(len(payload))
                    last_write = time.time()
                elif time.time() - last_write >= 5.0:
                    # keepalive on ELAPSED TIME, not on queue state:
                    # an instant {} per filtered batch would leak
                    # hidden-namespace activity timing, and pure
                    # silence would trip client/proxy idle timeouts.
                    # A reconnecting client resumes with ?index=<last
                    # Index it saw>: the ring replays from there, or
                    # delivers a LostEvents marker if that span was
                    # trimmed (stream/ndjson.go keepalive + resume)
                    write_chunk(b"{}\n")
                    last_write = time.time()
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            sub.close()
            self._end_chunks(req.handler)
        return StreamedResponse

    # -- ACL handlers ----------------------------------------------------

    @property
    def _acl_store(self):
        resolver = getattr(self.agent, "acl_resolver", None)
        if resolver is None:
            raise HTTPError(400, "ACL support disabled")
        return resolver

    def acl_bootstrap(self, req: Request):
        return self._acl_store.bootstrap()

    def acl_policies_list(self, req: Request):
        self._acl(req, "is_management")
        return [
            {"Name": p.name, "Description": p.description}
            for p in self._server.state.acl_policies()
        ]

    def acl_policy_get(self, req: Request):
        self._acl(req, "is_management")
        p = self._server.state.acl_policy_by_name(req.params["name"])
        if p is None:
            raise HTTPError(404, "policy not found")
        return p

    def acl_policy_put(self, req: Request):
        from nomad_tpu_torch.acl.policy import ACLPolicy
        from nomad_tpu_torch.server import fsm as fsm_msgs

        self._acl(req, "is_management")
        body = req.body or {}
        p = ACLPolicy(
            name=req.params["name"],
            description=body.get("Description", ""),
            rules=body.get("Rules", ""),
        )
        p.validate()
        index = self._server.raft_apply(
            fsm_msgs.ACL_POLICY_UPSERT, {"policies": [p]}
        )
        return {"Index": index}

    def acl_policy_delete(self, req: Request):
        from nomad_tpu_torch.server import fsm as fsm_msgs

        self._acl(req, "is_management")
        index = self._server.raft_apply(
            fsm_msgs.ACL_POLICY_DELETE, {"names": [req.params["name"]]}
        )
        return {"Index": index}

    def acl_tokens_list(self, req: Request):
        self._acl(req, "is_management")
        return [
            {"AccessorID": t.accessor_id, "Name": t.name, "Type": t.type,
             "Policies": t.policies, "Global": t.global_}
            for t in self._server.state.acl_tokens()
        ]

    def acl_token_self(self, req: Request):
        t = self._server.state.acl_token_by_secret(req.token)
        if t is None:
            raise HTTPError(403, "token not found")
        return t

    def acl_token_get(self, req: Request):
        self._acl(req, "is_management")
        t = self._server.state.acl_token_by_accessor(req.params["id"])
        if t is None:
            raise HTTPError(404, "token not found")
        return t

    def acl_token_put(self, req: Request):
        from nomad_tpu_torch.acl.policy import ACLToken
        from nomad_tpu_torch.server import fsm as fsm_msgs

        self._acl(req, "is_management")
        body = req.body or {}
        t = ACLToken.create(
            name=body.get("Name", ""),
            type=body.get("Type", "client"),
            policies=body.get("Policies") or [],
            global_=bool(body.get("Global", False)),
        )
        if req.params.get("id"):
            existing = self._server.state.acl_token_by_accessor(req.params["id"])
            if existing is None:
                raise HTTPError(404, "token not found")
            t.accessor_id = existing.accessor_id
            t.secret_id = existing.secret_id
        index = self._server.raft_apply(
            fsm_msgs.ACL_TOKEN_UPSERT, {"tokens": [t]}
        )
        out = encode(t)
        out["Index"] = index
        return out

    def acl_ott_create(self, req: Request):
        """POST /v1/acl/token/onetime: mint a one-time token for the
        caller's ACL token (acl_endpoint.go UpsertOneTimeToken)."""
        t = self._server.state.acl_token_by_secret(req.token)
        if t is None:
            raise HTTPError(403, "token not found")
        ott = self._server.create_one_time_token(t.accessor_id)
        return {"OneTimeToken": {
            "OneTimeSecretID": ott["one_time_secret_id"],
            "AccessorID": ott["accessor_id"],
            "ExpiresAt": ott["expires_at"],
        }}

    def acl_ott_exchange(self, req: Request):
        body = req.body or {}
        secret = body.get("OneTimeSecretID", "")
        try:
            token = self._server.exchange_one_time_token(secret)
        except ValueError as e:
            raise HTTPError(403, str(e))
        return {"Token": token}

    def acl_token_delete(self, req: Request):
        from nomad_tpu_torch.server import fsm as fsm_msgs

        self._acl(req, "is_management")
        index = self._server.raft_apply(
            fsm_msgs.ACL_TOKEN_DELETE, {"accessor_ids": [req.params["id"]]}
        )
        return {"Index": index}

    # -- client handlers -------------------------------------------------

    @property
    def _client(self):
        c = self.agent.client
        if c is None:
            raise HTTPError(400, "client is not enabled on this agent")
        return c

    def client_alloc_stats(self, req: Request):
        return self._runner(req, "read-job").stats()

    def client_fs_logs(self, req: Request):
        runner = self._runner(req, "read-logs")
        task = req.q("task")
        logtype = req.q("type", "stdout")
        offset = int(req.q("offset", "0") or 0)
        if req.flag("follow"):
            return self._stream_fs_logs(req, runner, task, logtype, offset)
        try:
            logs = runner.task_logs(
                task, logtype,
                offset=offset,
                limit=int(req.q("limit", "0") or 0),
            )
        except PermissionError as e:
            raise HTTPError(403, str(e))
        return {"Data": logs}

    def _stream_fs_logs(self, req: Request, runner, task: str,
                        logtype: str, offset: int):
        """?follow=true: raw chunked text that tails the rotation
        chain until the task is done (fs_endpoint.go Logs follow)."""
        # probe before committing the 200: bad task names / escaping
        # paths must 403 like the non-follow read does
        try:
            first = runner.task_logs_bytes(task, logtype, offset=offset)
        except PermissionError as e:
            raise HTTPError(403, str(e))
        h = req.handler
        deadline = time.time() + 600.0
        try:
            write_chunk = self._begin_chunked(
                h, content_type="text/plain; charset=utf-8")
            pos = offset
            data = first
            idle_after_done = 0
            while time.time() < deadline:
                if data:
                    pos += len(data)
                    write_chunk(data)
                    idle_after_done = 0
                else:
                    if runner.is_done():
                        # grace passes catch the logmon drain on stop
                        idle_after_done += 1
                        if idle_after_done > 2:
                            break
                    time.sleep(0.25)
                data = runner.task_logs_bytes(task, logtype, offset=pos)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self._end_chunks(h)
        return StreamedResponse

    def client_fs_ls(self, req: Request):
        try:
            return self._runner(req, "read-fs").list_dir(req.q("path", "/"))
        except FileNotFoundError:
            raise HTTPError(404, "path not found")
        except PermissionError as e:
            raise HTTPError(403, str(e))

    def client_stats(self, req: Request):
        return self._client.stats()

    def _runner(self, req: Request, capability: str = ""):
        """Resolve the local runner; ACL-check against the alloc's REAL
        namespace (the query param is caller-controlled)."""
        runner = self._client.alloc_runner(req.params["id"])
        if runner is None:
            raise HTTPError(404, "unknown allocation")
        if capability:
            self._acl(req, "allow_ns_op", runner.alloc.namespace, capability)
        return runner

    def client_alloc_restart(self, req: Request):
        body = req.body or {}
        try:
            self._runner(req, "alloc-lifecycle").restart_tasks(
                body.get("TaskName", "")
            )
        except KeyError as e:
            raise HTTPError(404, str(e))
        return {}

    def client_alloc_signal(self, req: Request):
        body = req.body or {}
        try:
            self._runner(req, "alloc-lifecycle").signal_tasks(
                body.get("Signal", "SIGTERM"), body.get("TaskName", "")
            )
        except KeyError as e:
            raise HTTPError(404, str(e))
        return {}

    def client_alloc_exec(self, req: Request):
        """Exec in a task. Two modes (reference api/allocations_exec.go):

        - websocket upgrade: interactive bidirectional stream; JSON
          frames {"stdin": {"data": b64}} / {"stdin": {"close": true}}
          / {"tty_size": {"height", "width"}} inbound, {"stdout"/
          "stderr": {"data": b64}} / {"exited", "result"} outbound.
        - plain POST: one-shot captured output (kept for simple
          clients; the reference CLI always streams).
        """
        handler = req.handler
        if handler is not None and \
                handler.headers.get("Upgrade", "").lower() == "websocket":
            return self._exec_websocket(req)
        if req.method == "GET":
            raise HTTPError(400, "interactive exec requires a websocket "
                                 "upgrade; use POST for one-shot exec")
        body = req.body or {}
        task = body.get("Task", "")
        cmd = body.get("Cmd") or []
        if not task or not cmd:
            raise HTTPError(400, "Task and Cmd are required")
        try:
            out = self._runner(req, "alloc-exec").exec_in_task(task, cmd)
        except KeyError as e:
            raise HTTPError(404, str(e))
        except NotImplementedError as e:
            raise HTTPError(400, str(e))
        for k in ("stdout", "stderr"):
            if isinstance(out.get(k), bytes):
                out[k] = out[k].decode(errors="replace")
        return out

    def _exec_websocket(self, req: Request):
        """The interactive leg: ws frames <-> driver ExecStream."""
        import base64

        from nomad_tpu_torch.utils import ws as wslib

        handler = req.handler
        task = req.q("task", "")
        tty = req.q("tty", "") in ("true", "1")
        try:
            cmd = json.loads(req.q("command", "[]"))
        except json.JSONDecodeError:
            cmd = []
        if not task or not cmd:
            raise HTTPError(400, "task and command are required")
        runner = self._runner(req, "alloc-exec")
        try:
            stream = runner.exec_stream_in_task(task, cmd, tty=tty)
        except KeyError as e:
            raise HTTPError(404, str(e))
        except NotImplementedError as e:
            raise HTTPError(400, str(e))

        if not wslib.server_handshake(handler):
            stream.terminate()
            return StreamedResponse
        handler.close_connection = True

        stop = threading.Event()
        # both threads write frames on the same buffered wfile; a lock
        # keeps a PONG from landing inside a half-flushed TEXT frame
        wlock = threading.Lock()

        def send_frame(op, payload: bytes) -> None:
            with wlock:
                wslib.write_frame(handler.wfile, op, payload)

        def pump_in() -> None:
            """ws -> process stdin / resize."""
            try:
                while not stop.is_set():
                    op, payload = wslib.read_frame(handler.rfile)
                    if op == wslib.OP_CLOSE:
                        break
                    if op == wslib.OP_PING:
                        send_frame(wslib.OP_PONG, payload)
                        continue
                    if op not in (wslib.OP_TEXT, wslib.OP_BINARY):
                        continue
                    try:
                        frame = json.loads(payload)
                    except json.JSONDecodeError:
                        continue
                    stdin = frame.get("stdin") or {}
                    if stdin.get("data"):
                        stream.write_stdin(base64.b64decode(stdin["data"]))
                    if stdin.get("close"):
                        stream.close_stdin()
                    size = frame.get("tty_size") or {}
                    if size:
                        stream.resize(int(size.get("height", 24)),
                                      int(size.get("width", 80)))
            except (ConnectionError, OSError, ValueError):
                pass
            finally:
                stream.terminate()

        t = threading.Thread(target=pump_in, daemon=True, name="exec-ws-in")
        t.start()
        try:
            exit_code = None
            while True:
                # after the process exits, keep draining briefly: the
                # output pumps race the waiter, and trailing pty bytes
                # must not be lost behind the exited frame
                item = stream.read_output(
                    timeout=0.5 if exit_code is None else 0.2)
                if item is None:
                    if exit_code is not None:
                        break
                    continue
                name, data = item
                if name == "exited":
                    exit_code = data
                    continue
                if data:
                    send_frame(wslib.OP_TEXT, json.dumps({
                        name: {"data": base64.b64encode(data).decode()},
                    }).encode())
            send_frame(wslib.OP_TEXT, json.dumps({
                "exited": True,
                "result": {"exit_code": exit_code},
            }).encode())
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            stop.set()
            stream.terminate()
            try:
                send_frame(wslib.OP_CLOSE, b"")
            except OSError:
                pass
        return StreamedResponse

    def client_fs_stat(self, req: Request):
        try:
            return self._runner(req, "read-fs").stat_file(req.q("path", "/"))
        except FileNotFoundError:
            raise HTTPError(404, "file not found")
        except PermissionError as e:
            raise HTTPError(403, str(e))

    def client_fs_cat(self, req: Request):
        try:
            data = self._runner(req, "read-fs").cat_file(req.q("path", "/"))
        except FileNotFoundError:
            raise HTTPError(404, "file not found")
        except IsADirectoryError:
            raise HTTPError(400, "path is a directory")
        except PermissionError as e:
            raise HTTPError(403, str(e))
        return {"Data": data.decode(errors="replace")}

    def client_fs_readat(self, req: Request):
        try:
            offset = int(req.q("offset", "0") or 0)
            limit = int(req.q("limit", "0") or 0)
        except ValueError:
            raise HTTPError(400, "offset and limit must be integers")
        if offset < 0 or limit < 0:
            raise HTTPError(400, "offset and limit must be >= 0")
        try:
            data = self._runner(req, "read-fs").cat_file(
                req.q("path", "/"), offset=offset, limit=limit,
            )
        except FileNotFoundError:
            raise HTTPError(404, "file not found")
        except IsADirectoryError:
            raise HTTPError(400, "path is a directory")
        except PermissionError as e:
            raise HTTPError(403, str(e))
        return {"Data": data.decode(errors="replace"),
                "Offset": offset}


class StreamedResponse:
    """Sentinel: handler already wrote the response body."""


def _job_stub(j) -> Dict:
    return {
        "ID": j.id, "ParentID": j.parent_id, "Name": j.name or j.id,
        "Namespace": j.namespace, "Type": j.type, "Priority": j.priority,
        "Status": j.status,
        "Stop": j.stop, "Version": j.version,
        "CreateIndex": j.create_index, "ModifyIndex": j.modify_index,
        "JobModifyIndex": j.job_modify_index,
    }


def _node_stub(n, resources: bool = False) -> Dict:
    out = {
        "ID": n.id, "Name": n.name, "Datacenter": n.datacenter,
        "NodeClass": n.node_class, "Status": n.status,
        "SchedulingEligibility": n.scheduling_eligibility,
        "Drain": n.drain_strategy is not None,
        "Address": getattr(n, "http_addr", ""),
        "NodePool": getattr(n, "node_pool", "default"),
    }
    if resources:
        # ?resources=true includes flattened capacity on the stub
        # (reference NodeListStub.NodeResources; the UI topology view
        # reads capacity from one list call instead of N detail calls)
        cr = n.node_resources.comparable()
        out["NodeResources"] = {
            "CPU": cr.cpu_shares, "MemoryMB": cr.memory_mb,
            "DiskMB": cr.disk_mb,
        }
    return out


def _alloc_stub(a, resources: bool = False) -> Dict:
    out = {
        "ID": a.id, "EvalID": a.eval_id, "Name": a.name,
        "Namespace": a.namespace, "NodeID": a.node_id, "NodeName": a.node_name,
        "JobID": a.job_id, "JobVersion": a.job_version,
        "TaskGroup": a.task_group,
        "DesiredStatus": a.desired_status, "ClientStatus": a.client_status,
        "DeploymentID": a.deployment_id,
        "CreateIndex": a.create_index, "ModifyIndex": a.modify_index,
        "CreateTime": a.create_time_ns, "ModifyTime": a.modify_time_ns,
        "FollowupEvalID": a.follow_up_eval_id,
    }
    if resources:
        # ?resources=true includes flattened allocated resources on the
        # stub (reference AllocationListStub.AllocatedResources; used by
        # the UI topology view)
        cr = a.comparable_resources()
        out["AllocatedResources"] = {
            "CPU": cr.cpu_shares, "MemoryMB": cr.memory_mb,
            "DiskMB": cr.disk_mb,
        }
    return out
