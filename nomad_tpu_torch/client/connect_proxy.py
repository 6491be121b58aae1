"""Sidecar proxy: the envoy stand-in for the Connect service mesh.

Reference behavior: client/allocrunner/taskrunner/envoy_bootstrap_hook.go
generates an Envoy bootstrap and runs Envoy as the sidecar; this build
runs this program instead (one process per sidecar role, launched by
the connect hook inside the allocation's network namespace):

- ``inbound``: the sidecar's public (mesh) listener. Accepts mesh
  connections, REQUIRES the service's mesh identity token as a
  preamble line (the SI-token analog of Envoy's mTLS + intentions;
  consul.go DeriveSITokens), then relays to the local service bound on
  loopback inside the namespace. A connection without the token is
  dropped before a single upstream byte flows.
- ``upstream``: a local listener on 127.0.0.1:<local_bind_port> inside
  the namespace (services.go ConsulUpstream). Relays to the
  destination sidecar's mesh address, sending the token preamble.

Run with ``python -S`` (no site imports) and a single JSON argv:
  {"mode": "inbound"|"upstream", "listen": ["ip", port],
   "target": ["ip", port], "token": "..."}
"""

import json
import socket
import sys
import threading

PREAMBLE_MAX = 128


def _pump(src: socket.socket, dst: socket.socket) -> None:
    try:
        while True:
            data = src.recv(65536)
            if not data:
                break
            dst.sendall(data)
    except OSError:
        pass
    finally:
        for s in (src, dst):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def _relay(conn: socket.socket, target, preamble: bytes = b"") -> None:
    try:
        upstream = socket.create_connection(tuple(target), timeout=10)
    except OSError:
        conn.close()
        return
    try:
        if preamble:
            upstream.sendall(preamble)
        t = threading.Thread(target=_pump, args=(conn, upstream), daemon=True)
        t.start()
        _pump(upstream, conn)
        t.join(timeout=2)
    finally:
        for s in (conn, upstream):
            try:
                s.close()
            except OSError:
                pass


def _read_line(conn: socket.socket, limit: int = PREAMBLE_MAX) -> bytes:
    buf = b""
    while b"\n" not in buf and len(buf) < limit:
        try:
            chunk = conn.recv(1)
        except OSError:
            return b""
        if not chunk:
            break
        buf += chunk
    return buf.split(b"\n", 1)[0]


def _serve_inbound(cfg) -> None:
    token = cfg["token"].encode()
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(tuple(cfg["listen"]))
    srv.listen(32)
    while True:
        conn, _ = srv.accept()

        def handle(conn=conn):
            conn.settimeout(10)
            line = _read_line(conn)
            if line != b"SI " + token:
                # unauthenticated mesh connection: refuse before any
                # bytes reach the service (the intentions-deny analog)
                conn.close()
                return
            conn.settimeout(None)
            _relay(conn, cfg["target"])

        threading.Thread(target=handle, daemon=True).start()


def _serve_upstream(cfg) -> None:
    preamble = ("SI " + cfg["token"] + "\n").encode()
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(tuple(cfg["listen"]))
    srv.listen(32)
    while True:
        conn, _ = srv.accept()
        threading.Thread(
            target=_relay, args=(conn, cfg["target"], preamble),
            daemon=True).start()


def main() -> None:
    cfg = json.loads(sys.argv[1])
    if cfg["mode"] == "inbound":
        _serve_inbound(cfg)
    else:
        _serve_upstream(cfg)


if __name__ == "__main__":
    main()
