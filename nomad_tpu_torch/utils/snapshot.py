"""Operator snapshot archive save/restore.

Reference behavior: helper/snapshot — a tar.gz archive carrying raft
metadata + the FSM state, written by /v1/operator/snapshot and restored
via the same endpoint. Here: gzip'd tar with `meta.json` (index, term,
timestamp, sha256) and `state.bin` (StateStore.to_snapshot_bytes).
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import tarfile
import time


def archive_snapshot(server) -> bytes:
    """Build the archive from the server's current state."""
    state_bytes = server.state.to_snapshot_bytes()
    meta = {
        "Index": server.state.latest_index(),
        "Term": getattr(server.raft, "current_term", 0) if server.raft else 0,
        "Timestamp": time.time(),
        "SHA256": hashlib.sha256(state_bytes).hexdigest(),
        "Version": 1,
    }
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb") as gz:
        with tarfile.open(fileobj=gz, mode="w") as tar:
            meta_bytes = json.dumps(meta).encode()
            mi = tarfile.TarInfo("meta.json")
            mi.size = len(meta_bytes)
            tar.addfile(mi, io.BytesIO(meta_bytes))
            si = tarfile.TarInfo("state.bin")
            si.size = len(state_bytes)
            tar.addfile(si, io.BytesIO(state_bytes))
    return buf.getvalue()


def read_snapshot(data: bytes) -> tuple:
    """-> (meta dict, state bytes); verifies the digest."""
    buf = io.BytesIO(data)
    with gzip.GzipFile(fileobj=buf, mode="rb") as gz:
        with tarfile.open(fileobj=gz, mode="r") as tar:
            meta = json.loads(tar.extractfile("meta.json").read())
            state_bytes = tar.extractfile("state.bin").read()
    digest = hashlib.sha256(state_bytes).hexdigest()
    if digest != meta.get("SHA256"):
        raise ValueError("snapshot digest mismatch (corrupt archive)")
    return meta, state_bytes


def restore_snapshot(server, data: bytes) -> None:
    """Replace server state from an archive (operator restore)."""
    _meta, state_bytes = read_snapshot(data)
    server.state.restore_from_bytes(state_bytes)
