"""Raft transports: in-memory (tests) and TCP (real clusters).

Reference behavior: nomad/raft_rpc.go ``RaftLayer`` carries raft RPCs
over the server's multiplexed TCP listener; Go tests use
raft.InmemTransport. RPCs here: request_vote, append_entries,
install_snapshot -- plus ``forward`` so followers can route
``apply`` calls to the leader (the analog of rpc.go:537 leader
forwarding).
"""

from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
from typing import Any, Callable, Dict, Optional

Handler = Callable[[str, Dict], Dict]


class TransportRegistry:
    """Shared address space for in-memory transports (one per test)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: Dict[str, "InmemTransport"] = {}
        # partition simulation: set of (src, dst) pairs that drop
        self._cut: set = set()

    def register(self, addr: str, transport: "InmemTransport") -> None:
        """Register (or RE-register: a restarted server takes over its
        address — the old, closed transport stops resolving)."""
        with self._lock:
            self._nodes[addr] = transport

    def unregister(self, addr: str, transport: "InmemTransport") -> None:
        """Identity-guarded removal: only the transport that owns the
        address slot may vacate it (a restarted server's replacement
        must not be torn down by the dead one's late close)."""
        with self._lock:
            if self._nodes.get(addr) is transport:
                del self._nodes[addr]

    def lookup(self, addr: str) -> Optional["InmemTransport"]:
        with self._lock:
            return self._nodes.get(addr)

    def partition(self, a: str, b: str) -> None:
        """Cut connectivity both ways (fault injection)."""
        with self._lock:
            self._cut.add((a, b))
            self._cut.add((b, a))

    def heal(self) -> None:
        with self._lock:
            self._cut.clear()

    def is_cut(self, src: str, dst: str) -> bool:
        with self._lock:
            return (src, dst) in self._cut


class InmemTransport:
    """Direct-call transport (raft.InmemTransport analog)."""

    def __init__(self, addr: str, registry: TransportRegistry) -> None:
        self.addr = addr
        self.registry = registry
        self._handler: Optional[Handler] = None
        self._closed = False
        registry.register(addr, self)

    def set_handler(self, handler: Handler) -> None:
        self._handler = handler

    def send(self, target: str, method: str, req: Dict, timeout: float = 1.0) -> Dict:
        if self._closed:
            raise ConnectionError(f"transport at {self.addr} is closed")
        if self.registry.is_cut(self.addr, target):
            raise ConnectionError(f"partitioned: {self.addr} -> {target}")
        peer = self.registry.lookup(target)
        if peer is None or peer._handler is None or peer._closed:
            raise ConnectionError(f"no transport at {target}")
        return peer._handler(method, req)

    def close(self) -> None:
        """Go dark: a killed/shut-down node must stop answering AND
        stop originating (the restart harness re-registers a fresh
        transport at the same address)."""
        self._closed = True
        self.registry.unregister(self.addr, self)


class _TcpHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        try:
            while True:
                header = self.rfile.read(4)
                if len(header) < 4:
                    return
                (length,) = struct.unpack(">I", header)
                payload = self.rfile.read(length)
                method, req = pickle.loads(payload)
                resp = self.server.rpc_handler(method, req)  # type: ignore[attr-defined]
                out = pickle.dumps(resp)
                self.wfile.write(struct.pack(">I", len(out)) + out)
        except (ConnectionError, EOFError, OSError):
            return


class TcpTransport:
    """Length-prefixed pickle frames over TCP.

    The codec is trusted-cluster-internal, exactly like the reference's
    msgpack RPC (rpc.go:363): peers are authenticated by network
    position (and mTLS when enabled at the listener); payloads are
    never accepted from untrusted sources.
    """

    def __init__(self, bind_addr: str = "127.0.0.1", port: int = 0) -> None:
        self._server = socketserver.ThreadingTCPServer(
            (bind_addr, port), _TcpHandler, bind_and_activate=True
        )
        self._server.daemon_threads = True
        self._server.rpc_handler = self._dispatch  # type: ignore[attr-defined]
        self.addr = "%s:%d" % self._server.server_address
        self._handler: Optional[Handler] = None
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"raft-tcp-{self.addr}",
        )
        self._thread.start()
        self._conn_lock = threading.Lock()
        self._conns: Dict[str, socket.socket] = {}
        self._closed = False
        # one in-flight request per target connection: concurrent sends
        # on a shared socket would interleave frames / cross responses
        self._target_locks: Dict[str, threading.Lock] = {}

    def set_handler(self, handler: Handler) -> None:
        self._handler = handler

    def _dispatch(self, method: str, req: Dict) -> Dict:
        if self._closed:
            # server.shutdown() only stops NEW connections; handler
            # threads for established peer connections would keep
            # answering and make a stopped node look alive
            raise ConnectionError("transport closed")
        if self._handler is None:
            raise ConnectionError("handler not installed")
        return self._handler(method, req)

    def send(self, target: str, method: str, req: Dict, timeout: float = 2.0) -> Dict:
        payload = pickle.dumps((method, req))
        with self._conn_lock:
            tlock = self._target_locks.setdefault(target, threading.Lock())
        with tlock:
            return self._send_locked(target, payload, timeout)

    def _send_locked(self, target: str, payload: bytes, timeout: float) -> Dict:
        with self._conn_lock:
            conn = self._conns.get(target)
        try:
            if conn is None:
                host, port = target.rsplit(":", 1)
                conn = socket.create_connection((host, int(port)), timeout=timeout)
                with self._conn_lock:
                    self._conns[target] = conn
            conn.settimeout(timeout)
            conn.sendall(struct.pack(">I", len(payload)) + payload)
            header = self._recv_exact(conn, 4)
            (length,) = struct.unpack(">I", header)
            return pickle.loads(self._recv_exact(conn, length))
        except (OSError, EOFError) as e:
            with self._conn_lock:
                self._conns.pop(target, None)
            try:
                if conn is not None:
                    conn.close()
            except OSError:
                pass
            raise ConnectionError(f"rpc to {target} failed: {e}") from e

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise EOFError("connection closed")
            buf += chunk
        return buf

    def close(self) -> None:
        self._closed = True
        self._server.shutdown()
        self._server.server_close()
        with self._conn_lock:
            for c in self._conns.values():
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()
