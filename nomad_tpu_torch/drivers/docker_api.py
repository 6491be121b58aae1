"""Minimal Docker Engine API client over the unix socket.

Reference behavior: drivers/docker uses the daemon API for everything
(go-dockerclient); this build's driver shells out to the CLI for
run/stop (documented deviation) but reads OPERATIONAL data — stats,
logs — straight from the engine like the reference does
(drivers/docker/stats.go collects from the stats endpoint;
docklog/docklog.go follows the logs endpoint), because polling
`docker stats` subprocesses is slow and lossy at real collection
intervals.

Stdlib-only: http.client over an AF_UNIX socket.
"""

from __future__ import annotations

import http.client
import json
import socket
import struct
from typing import Dict, Iterator, Optional, Tuple

#: everything a flaky daemon/socket can throw at a caller that wants
#: to fall back rather than fail (half-up proxies raise HTTPException
#: subclasses; truncated bodies raise ValueError via json)
TRANSPORT_ERRORS: Tuple = (OSError, http.client.HTTPException, ValueError)

DEFAULT_SOCKET = "/var/run/docker.sock"
API_VERSION = "v1.40"


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 30.0) -> None:
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


class EngineError(RuntimeError):
    pass


class DockerEngine:
    """One-call-per-connection client (the engine closes idle conns)."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET,
                 timeout: float = 30.0) -> None:
        self.socket_path = socket_path
        self.timeout = timeout

    def _request(self, method: str, path: str,
                 timeout: Optional[float] = None) -> http.client.HTTPResponse:
        conn = _UnixHTTPConnection(self.socket_path,
                                   timeout or self.timeout)
        conn.request(method, f"/{API_VERSION}{path}")
        resp = conn.getresponse()
        if resp.status >= 400:
            body = resp.read(500).decode(errors="replace")
            conn.close()
            raise EngineError(f"{method} {path}: {resp.status} {body}")
        return resp

    def _json(self, method: str, path: str) -> Dict:
        resp = self._request(method, path)
        try:
            return json.loads(resp.read())
        finally:
            resp.close()

    # -- surface ---------------------------------------------------------

    def ping(self) -> bool:
        try:
            resp = self._request("GET", "/_ping", timeout=5.0)
            ok = resp.read() == b"OK"
            resp.close()
            return ok
        except TRANSPORT_ERRORS + (EngineError,):
            return False

    def version(self) -> Dict:
        return self._json("GET", "/version")

    def stats(self, container: str) -> Dict:
        """One-shot raw stats (the stream=false form the reference's
        collector reads per interval)."""
        return self._json(
            "GET", f"/containers/{container}/stats?stream=false")

    def logs(self, container: str, follow: bool = True,
             stdout: bool = True, stderr: bool = True,
             since: int = 0) -> Iterator:
        """Yield (stream, bytes) frames from the engine's multiplexed
        log stream (docklog.go's source). stream 1=stdout, 2=stderr."""
        q = (f"/containers/{container}/logs?follow={'1' if follow else '0'}"
             f"&stdout={'1' if stdout else '0'}"
             f"&stderr={'1' if stderr else '0'}&since={since}")
        resp = self._request("GET", q, timeout=None if follow else 30.0)

        def read_exact(n: int) -> bytes:
            # resp.read(n) may return short on connection hiccups; a
            # short frame must end the stream, never misalign the next
            # header
            buf = b""
            while len(buf) < n:
                chunk = resp.read(n - len(buf))
                if not chunk:
                    break
                buf += chunk
            return buf

        try:
            while True:
                head = read_exact(8)
                if len(head) < 8:
                    return
                stream, _, _, _, size = struct.unpack(">BBBBI", head)
                if size == 0:
                    continue        # empty frame is not end-of-stream
                data = read_exact(size)
                if len(data) < size:
                    if data:
                        yield stream, data
                    return
                yield stream, data
        finally:
            resp.close()


def compute_cpu_percent(stats: Dict) -> float:
    """CPU percentage from a raw stats sample (drivers/docker/stats.go
    calculateCPUPercent: delta vs precpu over the system delta,
    scaled by online cpus)."""
    try:
        cpu = stats["cpu_stats"]
        pre = stats["precpu_stats"]
        cpu_delta = (cpu["cpu_usage"]["total_usage"]
                     - pre["cpu_usage"]["total_usage"])
        sys_delta = (cpu.get("system_cpu_usage", 0)
                     - pre.get("system_cpu_usage", 0))
        ncpu = cpu.get("online_cpus") or len(
            cpu["cpu_usage"].get("percpu_usage") or [1])
        if cpu_delta > 0 and sys_delta > 0:
            return cpu_delta / sys_delta * ncpu * 100.0
    except (KeyError, TypeError, ZeroDivisionError):
        pass
    return 0.0


def memory_rss(stats: Dict) -> int:
    """Resident memory from a raw sample (stats.go memory usage:
    usage minus the reclaimable page cache when reported)."""
    try:
        mem = stats["memory_stats"]
        usage = int(mem.get("usage", 0))
        detail = mem.get("stats") or {}
        cache = int(detail.get("total_inactive_file")
                    or detail.get("inactive_file") or 0)
        return max(usage - cache, 0)
    except (KeyError, TypeError, ValueError):
        return 0
