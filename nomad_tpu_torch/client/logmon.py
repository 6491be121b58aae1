"""Per-task log collection with rotation (the logmon analog).

Reference behavior: client/logmon/logmon.go runs a SEPARATE PROCESS
per task stream that reads the task's stdout/stderr through a FIFO and
writes size-rotated files ``<task>.<stream>.N`` (client/lib/fifo +
logmon/logging/rotator.go), honoring the task's LogConfig (max_files /
max_file_size_mb). The process boundary is the point: task logs keep
flowing across agent restarts, and a restarted agent REATTACHES to the
live collector instead of starting a second one (go-plugin reattach).

Here ``LogMon`` is the supervisor handle: ``start()`` spawns
``python -m nomad_tpu_torch.client.logmon <base> <max_files> <max_mb>`` as a
detached session, or adopts an already-running collector via its
pidfile. The collector child owns the FIFO and the rotation chain; on
SIGTERM it drains the FIFO tail and exits. If spawning fails the
collector runs as an in-agent thread (degraded: logs die with the
agent, logged as a warning).

fs 'logs' reads concatenate the rotated chain in index order.
"""

from __future__ import annotations

import errno
import glob
import logging
import os
import re
import select
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

LOG = logging.getLogger(__name__)


class _Collector:
    """The FIFO -> rotated-files loop (runs in the collector process,
    or in-agent as the degraded fallback)."""

    def __init__(self, base_path: str, max_files: int,
                 max_file_size_mb: int) -> None:
        self.base_path = base_path
        self.fifo_path = base_path + ".fifo"
        self.max_files = max(1, max_files)
        self.max_bytes = max(1, max_file_size_mb) * 1024 * 1024
        self._stop = threading.Event()
        self._fd: Optional[int] = None
        self._idx = 0
        self._out = None
        self._written = 0

    def open(self) -> None:
        os.makedirs(os.path.dirname(self.base_path), exist_ok=True)
        try:
            os.mkfifo(self.fifo_path)
        except FileExistsError:
            pass
        # O_RDWR keeps the read end open across writer restarts (task
        # restarts reopen the FIFO) and makes this open non-blocking
        self._fd = os.open(self.fifo_path, os.O_RDWR | os.O_NONBLOCK)
        # resume at the highest existing index (restart must not
        # interleave new output into already-rotated files)
        existing = rotated_files(self.base_path)
        if existing:
            self._idx = int(existing[-1].rsplit(".", 1)[1])
        self._open_current()
        if self._written >= self.max_bytes:
            self._rotate()

    def _open_current(self) -> None:
        path = f"{self.base_path}.{self._idx}"
        self._out = open(path, "ab")
        self._written = self._out.tell()

    def _rotate(self) -> None:
        self._out.close()
        self._idx += 1
        self._open_current()
        # prune beyond max_files (rotator.go purgeOldFiles)
        doomed = self._idx - self.max_files
        if doomed >= 0:
            try:
                os.unlink(f"{self.base_path}.{doomed}")
            except OSError:
                pass

    #: run-loop iterations between liveness checks (~10s at the 0.2s
    #: select timeout)
    _CHECK_EVERY = 50

    def run(self, should_exit=None) -> None:
        ticks = 0
        while not self._stop.is_set():
            ticks += 1
            if ticks % self._CHECK_EVERY == 0:
                # the alloc's log dir being deleted means the alloc was
                # garbage-collected (or a test's tmp tree was removed):
                # nothing will ever reattach — exit instead of leaking
                # a poller forever)
                if not os.path.isdir(os.path.dirname(self.base_path)):
                    break
                if should_exit is not None and should_exit():
                    break
            r, _, _ = select.select([self._fd], [], [], 0.2)
            if not r:
                continue
            try:
                chunk = os.read(self._fd, 65536)
            except OSError as e:
                if e.errno == errno.EAGAIN:
                    continue
                break
            if not chunk:
                continue
            self._out.write(chunk)
            self._out.flush()
            self._written += len(chunk)
            if self._written >= self.max_bytes:
                self._rotate()
        self.drain_and_close()

    def request_stop(self) -> None:
        self._stop.set()

    def drain_and_close(self) -> None:
        if self._fd is not None:
            # drain what the writer flushed before it exited — a
            # fast-exiting task's tail output is still in the FIFO
            # buffer when the collector stops
            while True:
                try:
                    chunk = os.read(self._fd, 65536)
                except OSError:
                    break
                if not chunk:
                    break
                self._out.write(chunk)
            os.close(self._fd)
            self._fd = None
        if self._out is not None:
            self._out.close()
            self._out = None
        try:
            os.unlink(self.fifo_path)
        except OSError:
            pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _is_collector(pid: int) -> bool:
    """A pidfile pid is only trustworthy if the process actually IS a
    logmon collector — crashes leave stale files, and pids recycle."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return b"logmon" in f.read()
    except OSError:
        return False


class LogMon:
    """Supervisor handle for one task stream's collector process.

    ``base_path`` is the unsuffixed target (".../web.stdout"); output
    files are ``base_path.N``. The write side is ``fifo_path`` — hand
    it to the driver as the task's stdout/stderr path.
    """

    def __init__(self, base_path: str, max_files: int = 10,
                 max_file_size_mb: int = 10) -> None:
        self.base_path = base_path
        self.fifo_path = base_path + ".fifo"
        self.pid_path = base_path + ".logmon.pid"
        self.max_files = max_files
        self.max_file_size_mb = max_file_size_mb
        self._pid: Optional[int] = None
        self._proc: Optional[subprocess.Popen] = None
        self._inproc: Optional[_Collector] = None
        self._inproc_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        os.makedirs(os.path.dirname(self.base_path), exist_ok=True)
        # reattach: a collector from a previous agent life is still
        # running (the whole point of the process boundary)
        existing = self._read_pidfile()
        if existing is not None and _pid_alive(existing) \
                and _is_collector(existing):
            self._pid = existing
            return
        # stale leftovers from an uncleanly-died collector would make
        # the spawn-wait loop adopt the wrong pid
        for leftover in (self.pid_path,):
            try:
                os.unlink(leftover)
            except OSError:
                pass
        try:
            # run THIS FILE as a script with -S: the collector is
            # stdlib-only, and skipping site/package init avoids the
            # environment's heavyweight interpreter startup per stream
            proc = subprocess.Popen(
                [sys.executable, "-S", os.path.abspath(__file__),
                 self.base_path, str(self.max_files),
                 str(self.max_file_size_mb)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True,
                cwd="/",
            )
        except OSError as e:
            LOG.warning("logmon %s: spawn failed (%s); collecting "
                        "in-process (logs will not survive agent "
                        "restart)", self.base_path, e)
            self._start_inproc()
            return
        # wait for the collector to own the FIFO + pidfile
        deadline = time.time() + 10
        while time.time() < deadline:
            pid = self._read_pidfile()
            if pid is not None and os.path.exists(self.fifo_path):
                self._pid = pid
                self._proc = proc      # our child: reap it on stop
                return
            if proc.poll() is not None:
                break
            time.sleep(0.01)
        LOG.warning("logmon %s: collector did not come up; collecting "
                    "in-process", self.base_path)
        self._start_inproc()

    def _start_inproc(self) -> None:
        self._inproc = _Collector(self.base_path, self.max_files,
                                  self.max_file_size_mb)
        self._inproc.open()
        self._inproc_thread = threading.Thread(
            target=self._inproc.run, daemon=True,
            name=f"logmon-{os.path.basename(self.base_path)}",
        )
        self._inproc_thread.start()

    def _read_pidfile(self) -> Optional[int]:
        try:
            with open(self.pid_path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def stop(self) -> None:
        """Terminate the collector (task is done). NOT called on agent
        shutdown with a live task — the collector must outlive us."""
        if self._inproc is not None:
            self._inproc.request_stop()
            if self._inproc_thread is not None:
                self._inproc_thread.join(timeout=2)
            self._inproc = None
            self._inproc_thread = None
            return
        if self._pid is not None:
            try:
                os.kill(self._pid, signal.SIGTERM)
            except OSError:
                pass
            if self._proc is not None:
                # our own child: reap it, or it lingers as a zombie
                try:
                    self._proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    try:
                        self._proc.wait(timeout=2)
                    except subprocess.TimeoutExpired:
                        pass
                self._proc = None
            else:
                # adopted collector (previous agent life): init reaps it
                deadline = time.time() + 3
                while time.time() < deadline and _pid_alive(self._pid):
                    time.sleep(0.02)
                if _pid_alive(self._pid):
                    try:
                        os.kill(self._pid, signal.SIGKILL)
                    except OSError:
                        pass
            self._pid = None
        try:
            os.unlink(self.pid_path)
        except OSError:
            pass


def read_rotated(base_path: str, offset: int = 0, limit: int = 0) -> bytes:
    """Concatenated read across the rotation chain ``base.N`` in index
    order (fs_endpoint.go Logs stitches frames the same way)."""
    out = []
    remaining = limit if limit > 0 else None
    skip = offset
    for path in rotated_files(base_path):
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        if skip >= size:
            skip -= size
            continue
        with open(path, "rb") as f:
            if skip:
                f.seek(skip)
                skip = 0
            data = f.read(remaining if remaining is not None else -1)
        out.append(data)
        if remaining is not None:
            remaining -= len(data)
            if remaining <= 0:
                break
    return b"".join(out)


def rotated_files(base_path: str) -> List[str]:
    found: List[Tuple[int, str]] = []
    for path in glob.glob(base_path + ".*"):
        m = re.fullmatch(re.escape(base_path) + r"\.(\d+)", path)
        if m:
            found.append((int(m.group(1)), path))
    return [p for _i, p in sorted(found)]


def _collector_main(argv: List[str]) -> int:
    """``python -m nomad_tpu_torch.client.logmon <base> <max_files> <max_mb>``
    — the collector process entry (logmon.go main loop)."""
    if len(argv) != 3:
        print("usage: logmon <base_path> <max_files> <max_file_size_mb>",
              file=sys.stderr)
        return 2
    base, max_files, max_mb = argv[0], int(argv[1]), int(argv[2])
    collector = _Collector(base, max_files, max_mb)
    collector.open()
    pid_path = base + ".logmon.pid"
    with open(pid_path, "w") as f:
        f.write(str(os.getpid()))
    signal.signal(signal.SIGTERM, lambda *_: collector.request_stop())
    signal.signal(signal.SIGHUP, signal.SIG_IGN)   # agent exit is not ours
    # Reattach semantics want the collector to OUTLIVE the agent; test
    # harnesses want the opposite (a suite spawning hundreds of agents
    # must not leak hundreds of pollers). With the env toggle set, the
    # collector also exits once its spawning agent is gone.
    should_exit = None
    if os.environ.get("NOMAD_TPU_LOGMON_ORPHAN_EXIT") == "1":
        # orphaning is detected as REPARENTING (ppid changed away from
        # the spawning agent), not as "parent is pid 1" — the agent
        # itself may legitimately BE pid 1 (container entrypoint), in
        # which case this signal never fires and the alloc-dir check
        # remains the only exit path
        parent = os.getppid()
        should_exit = (lambda: os.getppid() != parent
                       or not _pid_alive(parent))
    collector.run(should_exit)
    try:
        os.unlink(pid_path)
    except OSError:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(_collector_main(sys.argv[1:]))
