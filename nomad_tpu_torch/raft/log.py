"""Raft log entries and the log store.

Reference behavior: hashicorp/raft's LogStore backed by raft-boltdb
(go.mod:80); here an in-memory list with optional file persistence
(the boltdb analog) and snapshot-driven truncation.
"""

from __future__ import annotations

import os
import pickle
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional

# Entry kinds
LOG_COMMAND = "command"
LOG_NOOP = "noop"            # barrier entry a new leader commits
LOG_CONFIG = "configuration"  # membership change


@dataclass
class LogEntry:
    index: int
    term: int
    kind: str = LOG_COMMAND
    # command payload: (msg_type, req) for the FSM
    data: Any = None


class LogStore:
    """Append-only log with prefix truncation after snapshots.

    Indexes are 1-based (raft convention); ``base`` is the index of the
    last entry compacted into a snapshot.
    """

    def __init__(self, path: Optional[str] = None) -> None:
        self._lock = threading.RLock()
        self._entries: List[LogEntry] = []
        self._base_index = 0     # last snapshotted index
        self._base_term = 0
        self._path = path
        if path and os.path.exists(path):
            self._load()

    # --- persistence (raft-boltdb analog) -------------------------------

    def _load(self) -> None:
        with open(self._path, "rb") as f:
            payload = pickle.load(f)
        self._entries = payload["entries"]
        self._base_index = payload["base_index"]
        self._base_term = payload["base_term"]

    def sync(self) -> None:
        """Durability boundary: a no-op for the in-memory store.
        DurableLogStore (raft/wal.py) overrides it with the WAL's
        group fsync; raft/node.py calls it before any ack that
        promises the entries survive a crash."""

    def persist(self) -> None:
        if not self._path:
            return
        tmp = self._path + ".tmp"
        with self._lock:
            payload = {
                "entries": list(self._entries),
                "base_index": self._base_index,
                "base_term": self._base_term,
            }
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, self._path)

    # --- accessors ------------------------------------------------------

    def last_index(self) -> int:
        with self._lock:
            if self._entries:
                return self._entries[-1].index
            return self._base_index

    def last_term(self) -> int:
        with self._lock:
            if self._entries:
                return self._entries[-1].term
            return self._base_term

    def base_index(self) -> int:
        with self._lock:
            return self._base_index

    def term_at(self, index: int) -> Optional[int]:
        with self._lock:
            if index == 0:
                return 0
            if index == self._base_index:
                return self._base_term
            entry = self._get_locked(index)
            return entry.term if entry is not None else None

    def get(self, index: int) -> Optional[LogEntry]:
        with self._lock:
            return self._get_locked(index)

    def _get_locked(self, index: int) -> Optional[LogEntry]:
        pos = index - self._base_index - 1
        if pos < 0 or pos >= len(self._entries):
            return None
        return self._entries[pos]

    def entries_from(self, index: int, max_entries: int = 64) -> List[LogEntry]:
        with self._lock:
            pos = index - self._base_index - 1
            if pos < 0:
                pos = 0
            return list(self._entries[pos:pos + max_entries])

    # --- mutation -------------------------------------------------------

    def append(self, entry: LogEntry) -> None:
        with self._lock:
            self._entries.append(entry)

    def truncate_from(self, index: int) -> None:
        """Drop entries >= index (conflict resolution on followers)."""
        with self._lock:
            pos = index - self._base_index - 1
            if pos < 0:
                pos = 0
            del self._entries[pos:]

    def compact_to(self, index: int, term: int) -> None:
        """Drop entries <= index after they are in a snapshot."""
        with self._lock:
            pos = index - self._base_index
            if pos > 0:
                del self._entries[:pos]
            self._base_index = index
            self._base_term = term
