"""Minimal RFC 6455 WebSocket: handshake + framing, both roles.

Reference behavior: `nomad alloc exec` runs over a websocket from the
CLI/SDK to the agent HTTP API (api/allocations_exec.go:13), which the
server forwards to the allocation's node. The environment has no
websocket library, so this implements the subset the exec path needs:
HTTP/1.1 upgrade, client-masked frames, text/binary/ping/pong/close,
no extensions, no fragmentation of outgoing messages (incoming
fragmented messages are reassembled).
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import ssl
import struct
import urllib.parse
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# Largest message a peer may send; frames above this are rejected
# before allocation (exec stdio and API payloads sit far below this).
MAX_FRAME_BYTES = 16 * 1024 * 1024

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _xor_mask(payload: bytes, key: bytes) -> bytes:
    """Mask/unmask via one big-int XOR (a per-byte Python loop on the
    stdio hot path caps exec throughput at a few MB/s)."""
    n = len(payload)
    if n == 0:
        return payload
    full = key * (n // 4) + key[: n % 4]
    return (int.from_bytes(payload, "big")
            ^ int.from_bytes(full, "big")).to_bytes(n, "big")


def write_frame(wfile, opcode: int, payload: bytes, mask: bool = False) -> None:
    """One unfragmented frame. Clients MUST mask (RFC 6455 5.3)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mask_bit | n])
    elif n < 65536:
        head += bytes([mask_bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        wfile.write(head + key + _xor_mask(payload, key))
    else:
        wfile.write(head + payload)
    wfile.flush()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed")
        buf += chunk
    return buf


def read_frame(rfile) -> Tuple[int, bytes]:
    """Read one complete message (reassembles continuation frames)."""
    opcode = None
    payload = b""
    while True:
        b1, b2 = _read_exact(rfile, 2)
        fin = b1 & 0x80
        op = b1 & 0x0F
        masked = b2 & 0x80
        n = b2 & 0x7F
        if n == 126:
            n = struct.unpack(">H", _read_exact(rfile, 2))[0]
        elif n == 127:
            n = struct.unpack(">Q", _read_exact(rfile, 8))[0]
        if n > MAX_FRAME_BYTES or len(payload) + n > MAX_FRAME_BYTES:
            # peer-supplied 64-bit length: cap before allocating so a
            # hostile client can't drive unbounded memory growth (1009)
            raise ConnectionError(f"websocket frame too large: {n}")
        key = _read_exact(rfile, 4) if masked else b""
        data = _read_exact(rfile, n) if n else b""
        if masked:
            data = _xor_mask(data, key)
        if op in (OP_CLOSE, OP_PING, OP_PONG):
            return op, data            # control frames are never fragmented
        if opcode is None:
            opcode = op
        payload += data
        if fin:
            return opcode, payload


def server_handshake(handler) -> bool:
    """Upgrade an in-flight http.server request. Returns False (with a
    400 written) when the request is not a valid websocket upgrade."""
    key = handler.headers.get("Sec-WebSocket-Key", "")
    if not key:
        handler.send_response(400)
        handler.end_headers()
        return False
    handler.send_response(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.wfile.flush()
    return True


class WSConn:
    """Client-side connection (used by the SDK/CLI and by node
    forwarding when tunneling is not possible)."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.rfile = sock.makefile("rb")
        self.wfile = sock.makefile("wb")

    def send(self, payload: bytes, opcode: int = OP_TEXT) -> None:
        write_frame(self.wfile, opcode, payload, mask=True)

    def recv(self) -> Tuple[int, bytes]:
        return read_frame(self.rfile)

    def close(self) -> None:
        try:
            write_frame(self.wfile, OP_CLOSE, b"", mask=True)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def connect(url: str, token: str = "",
            tls_context: Optional[ssl.SSLContext] = None,
            timeout: float = 30.0) -> WSConn:
    """Dial ws over the agent's http(s) URL (http://host:port/path?q)."""
    parsed = urllib.parse.urlparse(url)
    host = parsed.hostname
    port = parsed.port or (443 if parsed.scheme == "https" else 80)
    sock = socket.create_connection((host, port), timeout=timeout)
    if parsed.scheme == "https":
        ctx = tls_context or ssl.create_default_context()
        sock = ctx.wrap_socket(sock, server_hostname=host)
    # the connect timeout must not apply to session reads: an exec
    # session idling past it would be torn down mid-stream
    sock.settimeout(None)
    key = base64.b64encode(os.urandom(16)).decode()
    path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
    lines = [
        f"GET {path} HTTP/1.1",
        f"Host: {host}:{port}",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Key: {key}",
        "Sec-WebSocket-Version: 13",
    ]
    if token:
        lines.append(f"X-Nomad-Token: {token}")
    try:
        sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        conn = WSConn(sock)
        status_line = conn.rfile.readline().decode(errors="replace")
        if " 101 " not in status_line and \
                not status_line.rstrip().endswith("101"):
            parts = status_line.split(None, 2)
            code = parts[1] if len(parts) > 1 else "?"
            # drain headers + any body snippet for the error message
            while True:
                line = conn.rfile.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
            raise ConnectionError(f"websocket upgrade refused: HTTP {code}")
        while True:
            line = conn.rfile.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
        return conn
    except BaseException:
        # a refused/failed upgrade must not leak the socket (retrying
        # SDKs would accumulate fds to EMFILE)
        try:
            sock.close()
        except OSError:
            pass
        raise
