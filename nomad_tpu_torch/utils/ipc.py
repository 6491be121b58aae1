"""CRC-framed IPC channel between the consensus process and scheduler
worker processes.

The wire shape is the raft WAL's: every message is one framed
record — a fixed ``(length, crc32)`` header followed by a pickled
payload — so a torn or corrupted read surfaces as :class:`FrameError`
at the boundary instead of a partially-applied message deeper in. The
transport underneath is a plain ``socketpair`` stream: worker processes
are spawned as fresh interpreters (``subprocess``, not fork — forking
would clone the device runtime's state, thread locks, and device handles
into the child) and inherit one end by file descriptor.

Discipline for what crosses a :class:`Channel`:
plain data only — evals, plans, snapshot frames, span rows, dicts of
scalars. Never device-resident arrays, locks/witness locks, tracer or
mesh handles, sockets, or thread/process objects.
"""

from __future__ import annotations

import pickle
import select
import socket
import struct
import threading
import zlib
from typing import Any, Optional, Tuple

#: frame header: payload length, crc32 of the payload (WAL framing)
_FRAME = struct.Struct(">II")

#: refuse absurd frames (a corrupt length header would otherwise make
#: the reader try to allocate/await gigabytes)
MAX_FRAME_BYTES = 1 << 31


class FrameError(RuntimeError):
    """A frame failed its length or CRC check (torn/corrupt message)."""


class Channel:
    """One endpoint of a framed duplex stream.

    ``send`` is thread-safe (the worker's scheduler threads, heartbeat
    ticker, and RPC replies all write the same stream); ``recv`` is
    single-reader by design — each endpoint owns one reader loop.
    """

    __slots__ = ("_sock", "_send_lock")

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._send_lock = threading.Lock()

    def send(self, obj: Any) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        header = _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        with self._send_lock:
            try:
                self._sock.sendall(header + payload)
            except BrokenPipeError:
                raise EOFError("channel peer is gone")

    def _read_exact(self, n: int) -> bytes:
        bufs = []
        while n:
            chunk = self._sock.recv(min(n, 1 << 20))
            if not chunk:
                raise EOFError("channel closed")
            bufs.append(chunk)
            n -= len(chunk)
        return b"".join(bufs)

    def recv(self, timeout: Optional[float] = None) -> Any:
        """Next message; None on timeout when ``timeout`` is given.
        Raises EOFError when the peer is gone, FrameError on a frame
        that fails its length/CRC check."""
        if timeout is not None and not self.poll(timeout):
            return None
        header = self._read_exact(_FRAME.size)
        length, crc = _FRAME.unpack(header)
        if length > MAX_FRAME_BYTES:
            raise FrameError(f"frame length {length} exceeds cap")
        payload = self._read_exact(length)
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise FrameError("frame CRC mismatch")
        return pickle.loads(payload)

    def poll(self, timeout: float = 0.0) -> bool:
        try:
            r, _w, _x = select.select([self._sock], [], [], timeout)
        except (OSError, ValueError):
            # closed under us: report readable so recv raises EOFError
            return True
        return bool(r)

    def fileno(self) -> int:
        return self._sock.fileno()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def channel_pair() -> Tuple[Channel, Channel]:
    """A connected (owner, peer) Channel pair over a socketpair. For
    cross-process use, hand the peer end's inheritable fd to the child
    (``channel_from_fd`` reconstructs there) and close it locally."""
    a, b = socket.socketpair()
    return Channel(a), Channel(b)


def socket_pair() -> Tuple[socket.socket, socket.socket]:
    """The raw sockets, for callers that ship one end to a subprocess
    by fd (``pass_fds``) before wrapping their own end in a Channel."""
    return socket.socketpair()


def channel_from_fd(fd: int) -> Channel:
    """Reconstruct a Channel in a child process from an inherited
    socketpair fd (the subprocess spawn path)."""
    return Channel(socket.socket(socket.AF_UNIX, socket.SOCK_STREAM,
                                 fileno=fd))
