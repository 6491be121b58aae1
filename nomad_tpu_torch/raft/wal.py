"""Crash-safe raft durability: segmented WAL, stable store, snapshots.

Reference behavior: nomad wires hashicorp/raft to raft-boltdb (the log
+ stable store; server.go:1228 setupRaft) and a FileSnapshotStore — a
server that is killed recovers its term, vote, log, and FSM from its
data dir. This module is that plane for our raft:

- :class:`WriteAheadLog` — an append-only SEGMENTED journal of
  CRC32-framed records. Frame = ``>II`` header (payload length,
  crc32(payload)) + payload. Torn-tail recovery: a bad frame at the
  tail of the NEWEST segment is a torn write — the file is truncated
  at the frame boundary and replay stops (a clean prefix). A bad frame
  anywhere else (a sealed segment, or followed by parseable frames) is
  CORRUPTION and raises :class:`WalCorruptionError` — loud, never a
  silent divergence.
- :class:`DurableLogStore` — the raft LogStore journaled through the
  WAL: every append/truncate/compact is a framed record; replay
  rebuilds the in-memory log bit-identically.
- :class:`StableStore` — the tiny atomic-rename+fsync store for
  ``(current_term, voted_for)``, the raft HARD state: a restarted node
  that forgets its vote can vote twice in one term — a safety
  violation, not a liveness gap. Writes are monotone (a racing stale
  writer can never regress a newer persisted term/vote).
- :class:`SnapshotStore` — CRC-framed ``snapshot-<index>-<term>``
  files, written tmp + fsync + atomic rename, keep-last-2 with
  fallback to the older file when the newest fails its CRC.

Fsync policy (the ``fsync_policy`` knob, ServerConfig/HCL):

- ``"always"`` — every journaled record fsyncs on the writer thread
  before it returns. Maximum paranoia, one fsync per record.
- ``"batch"`` (default) — records are written+flushed immediately but
  fsync happens at the ACK boundaries (:meth:`WriteAheadLog.sync`),
  GROUP-COALESCED: concurrent syncers ride one fsync (the first
  through the gate fsyncs everything written so far; waiters whose
  frames that fsync covered return without their own). The
  batched-commit windows (wave group commit, eval group commit,
  client-update fan-in) already collapse a wave's writes into one
  raft apply, so the steady path pays roughly one fsync per wave, not
  per eval (docs/PERF.md "Group-fsync amortization").

Correctness ordering lives in raft/node.py: term/vote persist BEFORE
any RPC response that grants a vote or adopts a term; follower append
and leader replicate sync BEFORE ack.

Fail-stop: any write/fsync failure (real IO error or the injected
``wal.frame.torn`` / ``wal.sync`` fault points) marks the WAL failed
and every later write raises — a node that cannot persist must stop
acking, exactly like the reference panicking on a boltdb write error.
The raft ticker then DEMOTES the node (step down, never campaign)
so a healthy peer takes over; the restart harness kills + recovers
it — replay truncates the torn tail and the cluster re-replicates.

Recovery order (the restart constructor path, raft/node.py):
stable store → newest valid snapshot → ``restore_fn`` → WAL replay
into the log → committed entries re-apply into the FSM through the
normal apply loop as the commit index advances.

Counters land in :data:`wal_stats` and are exported as the
``nomad_tpu_raft_durability_*`` / ``nomad_tpu_raft_snapshot_*``
Prometheus series (telemetry/exporter.py); fsync latency records into
the ``wal_fsync`` op of ``nomad_tpu_latency_seconds``.
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from nomad_tpu_torch.raft.log import LogEntry, LogStore
from nomad_tpu_torch.telemetry.histogram import WAL_FSYNC, histograms
from nomad_tpu_torch.telemetry.trace import consensus_recorder
from nomad_tpu_torch.utils.faultpoints import FaultError, fault
from nomad_tpu_torch.utils.witness import witness_lock

LOG = logging.getLogger(__name__)

#: frame header: payload length + crc32(payload)
_FRAME = struct.Struct(">II")
#: sanity bound on a single frame's payload (a flipped length byte
#: must not read as a plausible frame)
MAX_FRAME_BYTES = 64 * 1024 * 1024
#: rotate the live segment past this size
DEFAULT_SEGMENT_BYTES = 4 * 1024 * 1024


class WalCorruptionError(RuntimeError):
    """Unrecoverable on-disk state: mid-file corruption, a torn tail
    in a SEALED segment, or a compacted log with no valid snapshot.
    Deliberately loud — recovery never silently diverges."""


class DurabilityStats:
    """Process-wide durability accounting (every WAL/StableStore/
    SnapshotStore feeds it; multi-server tests share one). Gauge-like
    values (cache/disk snapshot bytes) are kept per owner and summed
    at snapshot time so co-resident servers never clobber each other.

    every note site also carries an ``owner`` (the server
    id), accumulated per owner so co-resident ``make_cluster`` servers
    stop blending into one truth — the exporter renders
    :meth:`per_server` with a ``server_id`` label next to the
    process-wide aggregates."""

    _PER_KEYS = ("frames", "fsyncs", "wal_fsyncs",
                 "fsync_batch_frames", "bytes_written",
                 "replayed_entries", "torn_truncations", "recoveries")

    def __init__(self) -> None:
        self._lock = witness_lock("wal.DurabilityStats._lock")
        self.fsyncs = 0
        self.frames = 0
        self.bytes_written = 0
        self.replayed_entries = 0
        self.torn_truncations = 0
        self.recoveries = 0
        self.snapshots_written = 0
        self.snapshots_pruned = 0
        self.snapshots_invalid = 0
        self._cache_bytes: Dict[str, int] = {}
        self._disk_bytes: Dict[str, int] = {}
        #: owner -> per-server counters (_PER_KEYS)
        self._per: Dict[str, Dict[str, int]] = {}
        #: owner -> live WAL occupancy (segments, pending frames, ...)
        self._occupancy: Dict[str, Dict[str, int]] = {}

    def _bump_locked(self, owner: str, key: str, n: int) -> None:
        if not owner:
            return
        row = self._per.get(owner)
        if row is None:
            row = self._per[owner] = {k: 0 for k in self._PER_KEYS}
        row[key] += n

    def note_frame(self, nbytes: int, owner: str = "") -> None:
        with self._lock:
            self.frames += 1
            self.bytes_written += nbytes
            self._bump_locked(owner, "frames", 1)
            self._bump_locked(owner, "bytes_written", nbytes)

    def note_fsync(self, owner: str = "", covered_frames: int = 0,
                   wal: bool = False) -> None:
        """One fsync; ``covered_frames`` is the group-fsync batch
        occupancy (how many journaled frames this sync made durable —
        the amortization the batched-commit windows buy). ``wal``
        marks WAL record fsyncs (group syncs + rotation seals): only
        those enter ``fsync_batch_avg``'s denominator, so stable-store
        term persists and snapshot-file fsyncs — which cover no frames
        by construction — cannot dilute the amortization gauge."""
        with self._lock:
            self.fsyncs += 1
            self._bump_locked(owner, "fsyncs", 1)
            if wal:
                self._bump_locked(owner, "wal_fsyncs", 1)
            if covered_frames:
                self._bump_locked(owner, "fsync_batch_frames",
                                  covered_frames)

    def note_replay(self, entries: int, owner: str = "") -> None:
        with self._lock:
            self.replayed_entries += entries
            self._bump_locked(owner, "replayed_entries", entries)

    def note_torn(self, owner: str = "") -> None:
        with self._lock:
            self.torn_truncations += 1
            self._bump_locked(owner, "torn_truncations", 1)

    def note_recovery(self, owner: str = "") -> None:
        with self._lock:
            self.recoveries += 1
            self._bump_locked(owner, "recoveries", 1)

    def note_wal_state(self, owner: str, segments: int,
                       pending_frames: int, live_segment_bytes: int,
                       failed: bool) -> None:
        """WAL occupancy gauge feed (segment count, frames written but
        not yet covered by an fsync, live-segment fill, fail-stop
        flag). Updated at sync/rotate/close — gauge cadence, not
        per-frame."""
        if not owner:
            return
        with self._lock:
            self._occupancy[owner] = {
                "segments": segments,
                "pending_frames": pending_frames,
                "live_segment_bytes": live_segment_bytes,
                "wal_failed": 1 if failed else 0,
            }

    def note_snapshot(self, written: int = 0, pruned: int = 0,
                      invalid: int = 0) -> None:
        with self._lock:
            self.snapshots_written += written
            self.snapshots_pruned += pruned
            self.snapshots_invalid += invalid

    def note_cache(self, owner: str, nbytes: int) -> None:
        """Meter one raft node's in-memory snapshot cache
        (the cache was unbounded AND unmetered)."""
        with self._lock:
            if nbytes:
                self._cache_bytes[owner] = nbytes
            else:
                self._cache_bytes.pop(owner, None)

    def note_disk(self, owner: str, nbytes: int) -> None:
        with self._lock:
            if nbytes:
                self._disk_bytes[owner] = nbytes
            else:
                self._disk_bytes.pop(owner, None)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "fsyncs": self.fsyncs,
                "frames": self.frames,
                "bytes_written": self.bytes_written,
                "replayed_entries": self.replayed_entries,
                "torn_truncations": self.torn_truncations,
                "recoveries": self.recoveries,
                "snapshots_written": self.snapshots_written,
                "snapshots_pruned": self.snapshots_pruned,
                "snapshots_invalid": self.snapshots_invalid,
                "snapshot_cache_bytes": sum(self._cache_bytes.values()),
                "snapshot_disk_bytes": sum(self._disk_bytes.values()),
            }

    def per_server(self) -> Dict[str, Dict]:
        """Per-owner durability counters + WAL occupancy (the
        per-replica view the exporter labels with ``server_id``)."""
        with self._lock:
            out: Dict[str, Dict] = {}
            for owner in set(self._per) | set(self._occupancy):
                row = dict(self._per.get(
                    owner, {k: 0 for k in self._PER_KEYS}))
                row.update(self._occupancy.get(owner, {}))
                wal_fsyncs = row.get("wal_fsyncs", 0)
                row["fsync_batch_avg"] = round(
                    row.get("fsync_batch_frames", 0) / wal_fsyncs, 4) \
                    if wal_fsyncs else 0.0
                out[owner] = row
            return out

    def reset_stats(self) -> None:
        with self._lock:
            self.fsyncs = 0
            self.frames = 0
            self.bytes_written = 0
            self.replayed_entries = 0
            self.torn_truncations = 0
            self.recoveries = 0
            self.snapshots_written = 0
            self.snapshots_pruned = 0
            self.snapshots_invalid = 0
            self._cache_bytes.clear()
            self._disk_bytes.clear()
            self._per.clear()
            self._occupancy.clear()


#: process-wide durability counters (telemetry/exporter.py source)
wal_stats = DurabilityStats()


def frame(payload: bytes) -> bytes:
    """One CRC32-framed record: length + crc + payload."""
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _parse_frame(data: bytes, offset: int) -> Optional[Tuple[int, bytes]]:
    """Parse one frame at ``offset``. Returns (next_offset, payload),
    or None when no valid frame starts there (short header, insane
    length, short payload, or CRC mismatch)."""
    end = len(data)
    if offset + _FRAME.size > end:
        return None
    length, crc = _FRAME.unpack_from(data, offset)
    if length > MAX_FRAME_BYTES or offset + _FRAME.size + length > end:
        return None
    payload = data[offset + _FRAME.size: offset + _FRAME.size + length]
    if zlib.crc32(payload) != crc:
        return None
    return offset + _FRAME.size + length, payload


def _valid_frame_follows(data: bytes, offset: int) -> bool:
    """Does any parseable frame start past a bad frame? If yes, the
    bad frame is mid-file CORRUPTION (a torn write can only ever be
    the last thing that hit the file). The scan runs to end-of-file —
    a bounded window would let a corrupted frame LARGER than the
    window hide the acked frames beyond it behind a "torn tail"
    truncation, the silent divergence this module forbids. Recovery
    is rare and segments are bounded; candidate offsets with
    implausible lengths fail before any CRC work."""
    for pos in range(offset + 1, len(data)):
        if _parse_frame(data, pos) is not None:
            return True
    return False


def _fsync_dir(path: str) -> None:
    """Directory fsync so a rename/creat survives the crash too. Best
    effort: not every filesystem supports fsync on a directory fd."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


# --- stable store --------------------------------------------------------

#: stable payload: term (u64) + voted-for length (u16) + utf-8 bytes
_STABLE = struct.Struct(">QH")


class StableStore:
    """Durable ``(current_term, voted_for)`` — the raft HARD state.

    One tiny file, written tmp + fsync + atomic rename (+ dir fsync).
    Writes are MONOTONE: term never regresses and a vote within a term
    is never un-cast, so racing writers (a vote grant racing a term
    adoption) can persist in any order without the durable state ever
    being older than any response already sent. Unchanged writes are
    free (the heartbeat path calls through here every term touch).
    """

    def __init__(self, data_dir: str, owner: str = "") -> None:
        self._dir = data_dir
        self._path = os.path.join(data_dir, "stable")
        self._owner = owner
        self._lock = witness_lock("wal.StableStore._lock")
        self._term = 0
        self._vote: Optional[str] = None
        self._loaded = False

    def load(self) -> Tuple[int, Optional[str]]:
        """Read the persisted hard state; (0, None) when none exists.
        A CRC mismatch is loud: the write path's atomic rename means a
        torn stable file cannot happen — a bad one is real corruption."""
        with self._lock:
            if self._loaded:
                return self._term, self._vote
            self._loaded = True
            if not os.path.exists(self._path):
                return 0, None
            with open(self._path, "rb") as f:
                data = f.read()
            parsed = _parse_frame(data, 0)
            if parsed is None:
                raise WalCorruptionError(
                    f"stable store {self._path} failed its CRC check")
            _, payload = parsed
            term, vlen = _STABLE.unpack_from(payload, 0)
            vote = payload[_STABLE.size:_STABLE.size + vlen].decode(
                "utf-8") if vlen else None
            self._term, self._vote = term, vote
            return term, vote

    def put(self, term: int, voted_for: Optional[str]) -> None:
        """Persist, monotone. Must complete BEFORE any RPC response
        that grants a vote or adopts the term (raft/node.py)."""
        vote_bytes = voted_for.encode("utf-8") if voted_for else b""
        payload = _STABLE.pack(term, len(vote_bytes)) + vote_bytes
        blob = frame(payload)
        with self._lock:
            if term < self._term:
                return              # stale racer: durable state is newer
            if term == self._term and (voted_for == self._vote
                                       or voted_for is None):
                return              # no change / never un-cast a vote
            tmp = self._path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path)
            _fsync_dir(self._dir)
            self._term, self._vote = term, voted_for
            wal_stats.note_fsync(self._owner)


# --- snapshot store ------------------------------------------------------

#: snapshot payload prefix: index (u64) + term (u64); data follows
_SNAP = struct.Struct(">QQ")
_SNAP_KEEP = 2


class SnapshotStore:
    """CRC-framed ``snapshot-<index>-<term>.snap`` files; atomic
    rename, keep-last-:data:`_SNAP_KEEP` with CRC-validated fallback to
    the older file. The on-disk file is PREFERRED over re-forcing an
    FSM capture when a lagging peer needs a snapshot (raft/node.py)."""

    def __init__(self, data_dir: str, owner: str = "") -> None:
        self._dir = data_dir
        self._owner = owner or data_dir
        self._lock = witness_lock("wal.SnapshotStore._lock")

    def _paths(self) -> List[Tuple[int, int, str]]:
        """(index, term, path) for every snapshot file, newest first."""
        out = []
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        for name in names:
            if not (name.startswith("snapshot-") and name.endswith(".snap")):
                continue
            parts = name[len("snapshot-"):-len(".snap")].split("-")
            if len(parts) != 2:
                continue
            try:
                out.append((int(parts[0]), int(parts[1]),
                            os.path.join(self._dir, name)))
            except ValueError:
                continue
        out.sort(reverse=True)
        return out

    def save(self, index: int, term: int, data: bytes) -> str:
        """Write ``snapshot-<index>-<term>`` durably; prune to the
        newest :data:`_SNAP_KEEP`. Called BEFORE WAL compaction so a
        crash between the two recovers from this file + the full WAL."""
        payload = _SNAP.pack(index, term) + data
        blob = frame(payload)
        path = os.path.join(self._dir, f"snapshot-{index:020d}-{term}.snap")
        with self._lock:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                # mid-snapshot-write seam (chaos plane): a kill here
                # leaves only the tmp file — recovery ignores it and
                # falls back to the previous snapshot + the uncompacted
                # WAL; an error propagates (the capture fails whole)
                fault("wal.snapshot.write")
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(self._dir)
            wal_stats.note_fsync(self._owner)
            wal_stats.note_snapshot(written=1)
            pruned = 0
            for _, _, old in self._paths()[_SNAP_KEEP:]:
                try:
                    os.unlink(old)
                    pruned += 1
                except OSError:
                    pass
            if pruned:
                wal_stats.note_snapshot(pruned=pruned)
            wal_stats.note_disk(self._owner, sum(
                os.path.getsize(p) for _, _, p in self._paths()))
        return path

    def load_newest(self) -> Optional[Tuple[int, int, bytes]]:
        """Newest snapshot that passes its CRC, or None. An invalid
        newest file falls back to the older one (keep-last-2 is FOR
        this: a crash mid-rename or bit rot must not strand the node)."""
        with self._lock:
            for index, term, path in self._paths():
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    continue
                parsed = _parse_frame(data, 0)
                if parsed is None:
                    LOG.warning("snapshot %s failed CRC; trying older",
                                path)
                    wal_stats.note_snapshot(invalid=1)
                    continue
                _, payload = parsed
                pidx, pterm = _SNAP.unpack_from(payload, 0)
                if pidx != index or pterm != term:
                    wal_stats.note_snapshot(invalid=1)
                    continue
                return index, term, payload[_SNAP.size:]
            return None


# --- the segmented WAL ---------------------------------------------------

class WriteAheadLog:
    """Append-only segmented journal of CRC-framed records.

    Segments are ``wal-<seq>.seg``; the newest is live, the rest are
    sealed (fsynced at rotation). Per-segment max-touched-index makes
    post-compaction deletion safe: a sealed segment whose every record
    touches indexes <= the snapshot index is wholly superseded by it.
    """

    def __init__(self, wal_dir: str, fsync_policy: str = "batch",
                 segment_max_bytes: int = DEFAULT_SEGMENT_BYTES,
                 owner: str = "") -> None:
        if fsync_policy not in ("always", "batch"):
            raise ValueError(
                f"fsync_policy must be 'always' or 'batch', "
                f"got {fsync_policy!r}")
        os.makedirs(wal_dir, exist_ok=True)
        self.dir = wal_dir
        self.fsync_policy = fsync_policy
        self.segment_max_bytes = segment_max_bytes
        self.owner = owner
        self._lock = witness_lock("wal.WriteAheadLog._lock")
        self._sync_lock = witness_lock("wal.WriteAheadLog._sync_lock")
        self._file = None
        self._seq = 0
        self._size = 0
        self._written = 0            # frames written (monotonic)
        self._synced = 0             # frames covered by an fsync
        self._max_touched = 0        # current segment
        self._sealed: List[Tuple[int, int, str]] = []  # (seq, max_idx, path)
        self._failed = False

    # -- recovery ---------------------------------------------------------

    def _segment_paths(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("wal-") and name.endswith(".seg"):
                try:
                    out.append((int(name[4:-4]), os.path.join(self.dir, name)))
                except ValueError:
                    continue
        out.sort()
        return out

    def replay(self) -> List[Any]:
        """Read every segment in order; return the decoded records.
        Torn-tail semantics: a bad frame in the NEWEST segment with no
        parseable frame after it truncates the file there (a clean
        prefix — counted in ``torn_truncations``); anything else
        raises :class:`WalCorruptionError`. Leaves the WAL positioned
        to append to the newest segment (or a fresh one)."""
        records: List[Any] = []
        segments = self._segment_paths()
        self._sealed = []
        for pos, (seq, path) in enumerate(segments):
            last_segment = pos == len(segments) - 1
            with open(path, "rb") as f:
                data = f.read()
            offset = 0
            seg_max = 0
            while offset < len(data):
                parsed = _parse_frame(data, offset)
                if parsed is None:
                    if not last_segment:
                        raise WalCorruptionError(
                            f"bad frame at {path}:{offset} in a SEALED "
                            "segment (rotation fsynced it whole): "
                            "mid-log corruption, refusing to guess")
                    if _valid_frame_follows(data, offset):
                        raise WalCorruptionError(
                            f"bad frame at {path}:{offset} followed by "
                            "parseable frames: mid-log corruption, not "
                            "a torn tail; refusing to silently drop "
                            "acknowledged records")
                    # a genuine torn tail: truncate at the frame
                    # boundary and recover the clean prefix
                    LOG.warning("wal: truncating torn tail at %s:%d "
                                "(%d bytes dropped)", path, offset,
                                len(data) - offset)
                    with open(path, "r+b") as f:
                        f.truncate(offset)
                        f.flush()
                        os.fsync(f.fileno())
                    wal_stats.note_torn(self.owner)
                    break
                offset, payload = parsed
                record = pickle.loads(payload)
                records.append(record)
                seg_max = max(seg_max, _record_touched(record))
            if last_segment:
                self._seq = seq
                self._size = offset
                self._max_touched = seg_max
            else:
                self._sealed.append((seq, seg_max, path))
        if segments:
            self._file = open(segments[-1][1], "ab")
        else:
            self._open_segment(0)
        self._note_occupancy_locked()
        return records

    def _open_segment(self, seq: int) -> None:
        self._seq = seq
        self._size = 0
        self._max_touched = 0
        path = os.path.join(self.dir, f"wal-{seq:08d}.seg")
        self._file = open(path, "ab")
        _fsync_dir(self.dir)

    # -- writes -----------------------------------------------------------

    def encode(self, record: Any) -> bytes:
        """Pickle a record OUTSIDE any lock (graftcheck R2: callers
        hold the log store lock around write(), never around this)."""
        return pickle.dumps(record)

    def write(self, payload: bytes, touched: int = 0) -> None:
        """Append one framed record to the live segment (flush, no
        fsync under the batch policy — sync() is the durability
        boundary). Failure is fail-stop."""
        blob = frame(payload)
        with self._lock:
            if self._failed:
                raise WalCorruptionError(
                    "wal is failed (a previous write/fsync error); "
                    "the node must restart and recover")
            try:
                try:
                    # torn-write seam (chaos plane): a fire writes only
                    # a PREFIX of the frame — exactly what a crash
                    # mid-write leaves — then fails the WAL (fail-stop:
                    # nothing may be journaled after a torn frame, or
                    # recovery would read mid-file garbage)
                    fault("wal.frame.torn")
                except FaultError:
                    self._file.write(blob[: max(len(blob) // 2, 1)])
                    self._file.flush()
                    raise
                self._file.write(blob)
                self._file.flush()
            except BaseException:
                self._failed = True
                raise
            self._written += 1
            self._size += len(blob)
            self._max_touched = max(self._max_touched, touched)
            wal_stats.note_frame(len(blob), self.owner)
            if self._size >= self.segment_max_bytes:
                self._rotate_locked()
        if self.fsync_policy == "always":
            self.sync()

    @property
    def failed(self) -> bool:
        return self._failed

    def _rotate_locked(self) -> None:
        """Seal the live segment (fsync whole) and open the next.
        Everything written so far is in the sealed file, so the synced
        watermark jumps to the written watermark."""
        f = self._file
        f.flush()
        os.fsync(f.fileno())
        f.close()
        wal_stats.note_fsync(self.owner,
                             covered_frames=self._written - self._synced,
                             wal=True)
        path = os.path.join(self.dir, f"wal-{self._seq:08d}.seg")
        self._sealed.append((self._seq, self._max_touched, path))
        self._synced = self._written
        self._open_segment(self._seq + 1)
        self._note_occupancy_locked()

    def _note_occupancy_locked(self) -> None:
        wal_stats.note_wal_state(
            self.owner, segments=len(self._sealed) + 1,
            pending_frames=self._written - self._synced,
            live_segment_bytes=self._size, failed=self._failed)

    def sync(self) -> None:
        """Make every written frame durable. Group-coalesced: the
        first syncer through the gate fsyncs everything written so
        far; concurrent syncers whose frames that fsync covered return
        without touching the disk (the group-commit discipline the
        batched raft applies upstream already shape the traffic for)."""
        with self._lock:
            if self._failed:
                raise WalCorruptionError("wal is failed; restart to recover")
            if self._synced >= self._written:
                return
        # kill-between-frame-write-and-fsync seam (chaos plane): the
        # frames are in the page cache but NOT durable — a kill here is
        # the canonical torn-tail crash recovery must absorb
        fault("wal.sync")
        t0 = time.perf_counter()
        with self._sync_lock:
            with self._lock:
                target = self._written
                if self._synced >= target:
                    return
                f = self._file
            try:
                os.fsync(f.fileno())
            except BaseException:
                with self._lock:
                    # a racing rotation seals (fsyncs) the captured
                    # file and swaps in a fresh one — its ValueError/
                    # EBADF here is NOT a disk failure: the rotation
                    # already made everything we cover durable
                    if self._synced >= target:
                        return
                    self._failed = True
                raise
            with self._lock:
                # batch occupancy is claimed AT the watermark move: a
                # rotation racing this sync already counted (and
                # advanced past) these frames — claiming them again
                # would double-count fsync_batch_frames
                covered = max(target - self._synced, 0)
                if target > self._synced:
                    self._synced = target
                self._note_occupancy_locked()
        dur = time.perf_counter() - t0
        wal_stats.note_fsync(self.owner, covered_frames=covered,
                             wal=True)
        histograms.get(WAL_FSYNC).record(dur)
        # consensus flight recorder: a group fsync past the adaptive
        # p99 bar gets captured for /v1/operator/slow-raft
        consensus_recorder.observe(WAL_FSYNC, dur, server_id=self.owner)

    def compact_through(self, index: int) -> None:
        """Delete sealed segments wholly superseded by a snapshot at
        ``index``. Caller must have journaled + synced the compact
        record first (a crash after deletion must still replay it).
        STRICTLY below: a sealed segment whose max touched index
        EQUALS the compaction index may hold the compact record
        itself (the journaling write can trigger the rotation that
        seals it) — deleting it would erase the only record that
        re-bases the log, leaving replay mid-stream at base 0."""
        with self._lock:
            keep = []
            for seq, max_idx, path in self._sealed:
                if max_idx < index:
                    try:
                        os.unlink(path)
                    except OSError:
                        keep.append((seq, max_idx, path))
                else:
                    keep.append((seq, max_idx, path))
            self._sealed = keep

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# --- WAL record codec ----------------------------------------------------

def _record_touched(record: Tuple) -> int:
    """The highest log index a record's information touches (segment
    deletion safety: a sealed segment is deletable only when every
    record in it touches indexes at or below the snapshot)."""
    kind = record[0]
    if kind == "entry":
        return record[1]
    # ("truncate", index) / ("compact", index, term)
    return record[1]


def replay_records(records: List[Tuple]):
    """Reconstruct (base_index, base_term, entries) from a record
    stream, INDEX-keyed — never positional. After a compaction deletes
    superseded segments the retained stream can start mid-log (its
    first appends sit above a base whose compact record was itself in
    a deleted segment), so positional replay through the live
    LogStore arithmetic would mis-aim truncates until the first
    retained compact record lands. Index-keyed replay is exact for
    every stream the write path can produce AND for every prefix of
    one (the torn-tail fuzz's divergence oracle reuses it)."""
    entries: List[LogEntry] = []
    base_index = 0
    base_term = 0
    for record in records:
        kind = record[0]
        if kind == "entry":
            _, index, term, ekind, data = record
            # a re-append at an existing index is the journaled form
            # of conflict resolution: it supersedes the old suffix
            while entries and entries[-1].index >= index:
                entries.pop()
            entries.append(
                LogEntry(index=index, term=term, kind=ekind, data=data))
        elif kind == "truncate":
            while entries and entries[-1].index >= record[1]:
                entries.pop()
        elif kind == "compact":
            index, term = record[1], record[2]
            if index >= base_index:
                base_index, base_term = index, term
                while entries and entries[0].index <= index:
                    entries.pop(0)
        else:
            raise WalCorruptionError(
                f"unknown wal record kind {kind!r}")
    return base_index, base_term, entries


class DurableLogStore(LogStore):
    """The raft LogStore journaled through a :class:`WriteAheadLog`.

    Every mutation appends a framed record inside the same lock scope
    as the in-memory change (journal order == memory order); recovery
    replays the records into a bit-identical log. ``sync()`` is the
    ack boundary the raft node calls before responding durably.
    """

    def __init__(self, wal_dir: str, fsync_policy: str = "batch",
                 segment_max_bytes: int = DEFAULT_SEGMENT_BYTES,
                 owner: str = "") -> None:
        super().__init__()
        self._wal = WriteAheadLog(wal_dir, fsync_policy=fsync_policy,
                                  segment_max_bytes=segment_max_bytes,
                                  owner=owner)
        records = self._wal.replay()
        base_index, base_term, entries = replay_records(records)
        # the recovered log must be contiguous from its base — a hole
        # means the record stream lost something it should not have
        # (e.g. a deleted segment that was still load-bearing): refuse
        # loudly, never serve positional reads over a gapped list
        expect = base_index + 1
        for e in entries:
            if e.index != expect:
                raise WalCorruptionError(
                    f"recovered log is not contiguous: expected index "
                    f"{expect}, found {e.index} (base {base_index}) — "
                    "refusing to boot over a gapped log")
            expect += 1
        self._base_index = base_index
        self._base_term = base_term
        self._entries = entries
        self.replayed_entries = len(entries)
        wal_stats.note_replay(self.replayed_entries, owner)

    @property
    def wal(self) -> WriteAheadLog:
        return self._wal

    @property
    def wal_failed(self) -> bool:
        return self._wal.failed

    # -- journaled mutators ----------------------------------------------

    def append(self, entry: LogEntry) -> None:
        payload = self._wal.encode(
            ("entry", entry.index, entry.term, entry.kind, entry.data))
        with self._lock:
            super().append(entry)
            self._wal.write(payload, touched=entry.index)

    def truncate_from(self, index: int) -> None:
        payload = self._wal.encode(("truncate", index))
        with self._lock:
            super().truncate_from(index)
            self._wal.write(payload, touched=index)

    def compact_to(self, index: int, term: int) -> None:
        payload = self._wal.encode(("compact", index, term))
        with self._lock:
            super().compact_to(index, term)
            self._wal.write(payload, touched=index)
        # the compact record must be durable BEFORE superseded
        # segments disappear (crash in between must still replay it)
        self._wal.sync()
        self._wal.compact_through(index)

    # -- durability boundary ---------------------------------------------

    def sync(self) -> None:
        self._wal.sync()

    def persist(self) -> None:
        """No-op: the WAL is the persistence; the base class's
        whole-log pickle rewrite (the behavior this replaces)
        would double-write everything per snapshot."""

    def close(self) -> None:
        self._wal.close()
