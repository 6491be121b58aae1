"""Client-local persistent state for restart recovery.

Reference behavior: client/state/state_database.go:105 -- boltdb
(helper/boltdd) persistence of allocation and task-runner state so a
restarted agent can restore its allocRunners and reattach to live
tasks (client.go:1109 restoreState). Backend here is sqlite3 (stdlib),
with pickled rows; an in-memory variant and an error-injecting variant
mirror client/state/memdb.go and errdb.go for tests.
"""

from __future__ import annotations

import os
import pickle
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple


class StateDB:
    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.executescript(
                """
                CREATE TABLE IF NOT EXISTS allocations (
                    alloc_id TEXT PRIMARY KEY,
                    data BLOB NOT NULL
                );
                CREATE TABLE IF NOT EXISTS task_state (
                    alloc_id TEXT NOT NULL,
                    task_name TEXT NOT NULL,
                    local_state BLOB,
                    task_handle BLOB,
                    PRIMARY KEY (alloc_id, task_name)
                );
                CREATE TABLE IF NOT EXISTS node_meta (
                    key TEXT PRIMARY KEY,
                    value BLOB NOT NULL
                );
                """
            )
            self._conn.commit()

    # --- allocations ----------------------------------------------------

    def put_allocation(self, alloc) -> None:
        # serialize before taking the connection lock (graftcheck R2):
        # the lock only needs to cover the sqlite write
        data = pickle.dumps(alloc)
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO allocations (alloc_id, data) VALUES (?, ?)",
                (alloc.id, data),
            )
            self._conn.commit()

    def get_allocations(self) -> List:
        with self._lock:
            rows = self._conn.execute(
                "SELECT data FROM allocations"
            ).fetchall()
        return [pickle.loads(r[0]) for r in rows]

    def delete_allocation(self, alloc_id: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM allocations WHERE alloc_id = ?", (alloc_id,)
            )
            self._conn.execute(
                "DELETE FROM task_state WHERE alloc_id = ?", (alloc_id,)
            )
            self._conn.commit()

    # --- task runner state ----------------------------------------------

    def put_task_state(self, alloc_id: str, task_name: str,
                       local_state=None, task_handle=None) -> None:
        local = pickle.dumps(local_state) if local_state is not None else None
        handle = pickle.dumps(task_handle) if task_handle is not None else None
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO task_state "
                "(alloc_id, task_name, local_state, task_handle) "
                "VALUES (?, ?, ?, ?)",
                (alloc_id, task_name, local, handle),
            )
            self._conn.commit()

    def get_task_state(self, alloc_id: str, task_name: str) -> Tuple[Optional[object], Optional[object]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT local_state, task_handle FROM task_state "
                "WHERE alloc_id = ? AND task_name = ?",
                (alloc_id, task_name),
            ).fetchone()
        if row is None:
            return None, None
        local = pickle.loads(row[0]) if row[0] is not None else None
        handle = pickle.loads(row[1]) if row[1] is not None else None
        return local, handle

    # --- node meta (client ID persistence etc.) -------------------------

    def put_meta(self, key: str, value) -> None:
        data = pickle.dumps(value)
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO node_meta (key, value) VALUES (?, ?)",
                (key, data),
            )
            self._conn.commit()

    def get_meta(self, key: str):
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM node_meta WHERE key = ?", (key,)
            ).fetchone()
        return pickle.loads(row[0]) if row else None

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class MemStateDB(StateDB):
    """client/state/memdb.go analog."""

    def __init__(self) -> None:
        super().__init__(":memory:")


class ErrStateDB(MemStateDB):
    """client/state/errdb.go analog: fault injection for tests."""

    def __init__(self) -> None:
        super().__init__()
        self.fail = False

    def put_allocation(self, alloc) -> None:
        if self.fail:
            raise IOError("state db write failure (injected)")
        super().put_allocation(alloc)

    def put_task_state(self, *a, **kw) -> None:
        if self.fail:
            raise IOError("state db write failure (injected)")
        super().put_task_state(*a, **kw)
