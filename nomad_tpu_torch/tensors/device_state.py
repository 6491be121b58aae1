"""Device-resident cluster state: the wave-shared planes stay on the card.

Counterpart of ``nomad_tpu/tensors/device_state.py``. The wave-shared
planes (the cluster-static capacity planes and the snapshot's gathered
utilization, ``ClusterTensors.wave_shared_planes``) live on a device as
tensors, keyed by ``(uid, structure_version, device)`` generations, and
advance between snapshots by uploading only the dirty rows and writing
them with ``_scatter_rows``, an out-of-place ``index_copy``. An eval asks
for its snapshot's planes with ``request`` (no torch call, no wait); the
thread that assembles the next wave runs the advance
(``advance_pending``) before it looks its shared leaves up.

Advancement is functional: an advance makes new tensors and leaves the
previous generation's untouched, so a wave still running against
version N never sees version N+1's rows. The uploads and the scatter
run on the caller's current stream, the stream the wave kernel launches
on, so the caching allocator keeps an evicted generation's memory for
the waves queued before its release. Generations are LRU-bounded; every
miss (an unprovable row log, permuted rows, a pad-bucket change, an
evicted base) falls back to a full upload, bit-identical by construction
and tested against a fresh ``ClusterTensors.build`` uploaded whole
(tests/test_torch_device_state.py).

Row batches are exact: torch has no compile cache to bucket for, so
only the real dirty rows are uploaded and written; every index is
checked in range before the write.

The registry maps ``(host array identity, device)`` to a tensor, the
identity contract the wave launcher's sharing layout is built on:
``launch_wave`` and ``default_kernel_launch`` swap a shared host leaf for
its resident twin on the wave's own device, so a twin on ``cuda`` never
reaches a CPU wave, or the reverse. Frozen neutral singletons ride the
same registry through a bounded LRU: they upload once per process and
device. Lookups and ensures that fail serve host planes, as the JAX
package's do, but each failure is counted under ``errors``.

Where the JAX state carries a mesh, the port has one device per
generation; ``configure_mesh`` with a mesh raises until the node-axis
mesh exists (ROADMAP A.11).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch.tensors.schema import (
    ClusterTensors,
    IncrementalClusterCache,
)
from nomad_tpu_torch.telemetry.kernel_profile import profiler
from nomad_tpu_torch.telemetry.trace import tracer

__all__ = ["DeviceClusterState", "default_device_state", "device_key"]

#: seconds a lookup waits for another thread's upload of the same frozen
#: singleton before it serves the host array instead (counted as an error)
FROZEN_WAIT_S = 30.0


def device_key(device) -> torch.device:
    """The device a registry entry is keyed by: ``cuda`` without an index
    names the current card, as a tensor placed there reports it. A key
    comes back as it is, so a caller keys once per wave."""
    if isinstance(device, torch.device) and (
            device.type != "cuda" or device.index is not None):
        return device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of ``arr`` on ``dev``, dtype kept. To the card it goes
    through pinned memory and a non-blocking copy on the current stream:
    the caller does not wait for the waves already queued there (a
    pageable copy would), and the copy still runs after them and before
    any later launch. The caching host allocator keeps the pinned block
    until the copy is done."""
    dtype = _TORCH_DTYPES.get(arr.dtype)
    if dev.type != "cuda" or dtype is None:
        return torch.tensor(arr, device=dev)
    pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = arr
    return pinned.to(dev, non_blocking=True)


#: numpy dtype -> torch dtype of the planes the state uploads
_TORCH_DTYPES = {np.dtype(d): torch.from_numpy(np.zeros(1, d)).dtype
                 for d in (np.float32, np.int32, np.bool_, np.uint8,
                           np.int64, np.float64, np.uint32)}


def _scatter_rows(plane: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``plane`` with ``plane[rows] = vals``, as a new tensor (the JAX
    package's ``plane.at[rows].set(vals)``). Every row is in range."""
    return plane.index_copy(0, rows, vals)


class _Generation:
    """One resident (uid, structure_version, device) generation."""

    __slots__ = ("key", "cluster", "version", "planes", "host_keys")

    def __init__(self, key, cluster, version, planes) -> None:
        self.key = key
        self.cluster = cluster          # host build (identity anchor)
        self.version = version          # usage version of the planes
        self.planes: Dict[str, torch.Tensor] = planes
        self.host_keys: Tuple[tuple, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.key[2]


class DeviceClusterState:
    """LRU of device-resident wave-shared plane generations."""

    def __init__(self, max_generations: int = 4,
                 max_frozen: int = 256) -> None:
        self._lock = threading.Lock()
        self._gens: "OrderedDict[tuple, _Generation]" = OrderedDict()
        #: (uid, device) -> newest resident structure_version (fork base)
        self._latest: Dict[tuple, int] = {}
        #: (id(host array), device) -> (host array, tensor). The strong
        #: host reference pins the id against reuse; entries leave with
        #: their generation. Frozen singletons live in the LRU below.
        self._registry: Dict[tuple, tuple] = {}
        #: (id(host array), device) -> (host array, tensor)
        self._frozen: "OrderedDict[tuple, tuple]" = OrderedDict()
        #: frozen key -> Event of an upload in flight; the upload runs
        #: outside ``_lock`` so it never stalls a snapshot-time advance
        self._frozen_inflight: Dict[tuple, threading.Event] = {}
        #: (uid, structure_version, device) -> (cluster, usage) asked for
        #: by ``request`` and not yet advanced to (the newest usage wins)
        self._pending: Dict[tuple, tuple] = {}
        self._pending_lock = threading.Lock()
        self.max_generations = max_generations
        self.max_frozen = max_frozen
        self.reset_stats()

    # --- mesh -----------------------------------------------------------

    def configure_mesh(self, mesh) -> None:
        """``None`` keeps single-device placement; a mesh raises until the
        port has the node-axis mesh."""
        if mesh is not None:
            raise NotImplementedError(
                "a sharded device state needs the node-axis mesh, which the "
                "PyTorch port does not have yet (ROADMAP A.11)")

    # --- stats ----------------------------------------------------------

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = 0
            self.full_uploads = 0        # generations built by full upload
            self.delta_advances = 0      # usage advances by row scatter
            self.fork_deltas = 0         # structure forks by row scatter
            self.usage_full_uploads = 0  # unprovable row log fallbacks
            self.rows_uploaded = 0
            self.bytes_uploaded = 0      # actual h2d bytes (delta + full)
            self.bytes_full_equiv = 0    # what full re-uploads would cost
            self.evictions = 0           # generations dropped by the LRU
            self.errors = 0              # failed ensures, uploads, waits
            self.last_error = ""

    def note_error(self, err: Optional[BaseException] = None) -> None:
        """Count a failure that made a caller serve host planes."""
        with self._lock:
            self.errors += 1
            if err is not None:
                self.last_error = repr(err)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "hits": self.hits,
                "full_uploads": self.full_uploads,
                "delta_advances": self.delta_advances,
                "fork_deltas": self.fork_deltas,
                "usage_full_uploads": self.usage_full_uploads,
                "rows_uploaded": self.rows_uploaded,
                "bytes_uploaded": self.bytes_uploaded,
                "bytes_full_equiv": self.bytes_full_equiv,
                "dirty_row_upload_ratio": (
                    round(self.bytes_uploaded / self.bytes_full_equiv, 4)
                    if self.bytes_full_equiv else 0.0),
                "resident_generations": len(self._gens),
                "mesh_devices": 0,
                "evictions": self.evictions,
                "errors": self.errors,
                "last_error": self.last_error,
            }

    def planes_for(self, usage, device) -> Optional[Dict[str, torch.Tensor]]:
        """The resident planes of ``usage``'s generation on ``device`` when
        they are at its version, else None."""
        gen = self._gens.get((usage.uid, usage.structure_version,
                              device_key(device)))
        if gen is None or gen.version != usage.version:
            return None
        return dict(gen.planes)

    # --- registry -------------------------------------------------------

    def lookup(self, arr, device, frozen_ok: bool = True
               ) -> Optional[torch.Tensor]:
        """The tensor twin of ``arr`` on ``device``, or None. With
        ``frozen_ok``, frozen host arrays (read-only singletons) are made
        resident on first sight; mutable arrays are served only when a
        generation registered them.

        Callers pass ``frozen_ok=False`` for the snapshot-plane group:
        gathered utilization planes are also read-only, and a stale
        snapshot's planes (deregistered by a newer advance) must miss,
        not be pinned into the frozen LRU as process-lifetime singletons."""
        if not isinstance(arr, np.ndarray):
            return None
        key = (id(arr), device_key(device))
        ent = self._registry.get(key)
        if ent is not None and ent[0] is arr:
            return ent[1]
        if frozen_ok and not arr.flags.writeable:
            ent = self._frozen.get(key)
            if ent is not None and ent[0] is arr:
                return ent[1]
            return self._frozen_resident(arr, key)
        return None

    def _frozen_resident(self, arr: np.ndarray, key: tuple):
        # claim under the lock, upload outside it; concurrent callers for
        # the same array wait on the claim's event
        while True:
            with self._lock:
                ent = self._frozen.get(key)
                if ent is not None and ent[0] is arr:
                    self._frozen.move_to_end(key)
                    return ent[1]
                ev = self._frozen_inflight.get(key)
                if ev is None:
                    ev = self._frozen_inflight[key] = threading.Event()
                    break       # this thread owns the upload
            if not ev.wait(timeout=FROZEN_WAIT_S):
                self.note_error()
                return None     # uploader wedged: serve the host array
        dev = None
        try:
            dev = self._upload({"_frozen": arr}, key[1])["_frozen"]
            with self._lock:
                self._frozen[key] = (arr, dev)
                while len(self._frozen) > self.max_frozen:
                    self._frozen.popitem(last=False)
        except Exception as err:        # noqa: BLE001 - counted; host array serves
            self.note_error(err)
            dev = None
        finally:
            with self._lock:
                self._frozen_inflight.pop(key, None)
            ev.set()
        return dev

    def _register(self, gen: _Generation,
                  host_planes: Dict[str, np.ndarray]) -> None:
        for hk in gen.host_keys:
            self._registry.pop(hk, None)
        keys = []
        for f, host in host_planes.items():
            hk = (id(host), gen.device)
            self._registry[hk] = (host, gen.planes[f])
            keys.append(hk)
        gen.host_keys = tuple(keys)

    def _evict(self, gen: _Generation) -> None:
        for hk in gen.host_keys:
            self._registry.pop(hk, None)
        uid, sv, dev = gen.key
        if self._latest.get((uid, dev)) == sv:
            self._latest.pop((uid, dev), None)

    # --- uploads --------------------------------------------------------

    def _upload(self, host_planes: Dict[str, np.ndarray],
                dev: torch.device) -> Dict[str, torch.Tensor]:
        """Full upload of ``host_planes`` to ``dev`` (dtypes kept exactly),
        byte-counted here and in the kernel profiler."""
        n_bytes = sum(a.nbytes for a in host_planes.values())
        # its own span name: the state's uploads are not the wave's
        with tracer.span("state.h2d"):
            out = {f: _to_device(a, dev) for f, a in host_planes.items()}
            if tracer.enabled and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        profiler.add_bytes("h2d", n_bytes)
        self.bytes_uploaded += n_bytes
        return out

    def _scatter(self, planes: Dict[str, torch.Tensor],
                 host_planes: Dict[str, np.ndarray], rows,
                 dev: torch.device) -> Dict[str, torch.Tensor]:
        """Advance ``planes`` to ``host_planes`` given that only ``rows``
        differ: the row indices and every plane's values go up in ONE
        packed int32 buffer ``[1 + planes, rows]`` (each plane is 4-byte
        and one-dimensional, and its values travel as bits), then each
        plane is written by ``_scatter_rows``."""
        idx = np.fromiter(sorted(rows), np.int64, len(rows))
        n_pad = next(iter(host_planes.values())).shape[0]
        if idx.size and (idx[0] < 0 or idx[-1] >= n_pad):
            raise IndexError(f"dirty rows {idx[0]}..{idx[-1]} outside the "
                             f"{n_pad}-row planes")
        fields = list(host_planes)
        buf = np.empty((1 + len(fields), idx.size), np.int32)
        buf[0] = idx
        for i, f in enumerate(fields):
            host = host_planes[f]
            if host.ndim != 1 or host.dtype.itemsize != 4:
                raise TypeError(f"{f}: {host.dtype}{host.shape} is not a "
                                "4-byte node plane")
            buf[1 + i] = host[idx].view(np.int32)
        with tracer.span("state.h2d"):
            buf_d = _to_device(buf, dev)
            rows_d = buf_d[0].long()
            out = dict(planes)
            for i, f in enumerate(fields):
                vals = buf_d[1 + i].view(planes[f].dtype)
                out[f] = _scatter_rows(planes[f], rows_d, vals)
            if tracer.enabled and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        profiler.add_bytes("h2d", buf.nbytes)
        self.bytes_uploaded += buf.nbytes
        self.rows_uploaded += int(idx.size) * len(fields)
        return out

    def warm_scatter(self, n_pad: int, device) -> int:
        """Run the dirty-row scatter once per plane dtype at a node size
        (ops/warmup.py calls this with the manifest's node shapes), so the
        first advance of a burst loads no kernel. Returns the number of
        (dtype) scatters run."""
        dev = device_key(device)
        done = 0
        rows = torch.zeros(1, dtype=torch.long, device=dev)
        for dtype in (torch.float32, torch.int32):
            plane = torch.zeros(n_pad, dtype=dtype, device=dev)
            _scatter_rows(plane, rows, torch.zeros(1, dtype=dtype,
                                                   device=dev))
            done += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return done

    # --- the entry points -----------------------------------------------

    def request(self, cluster: ClusterTensors, usage, device) -> None:
        """Ask for the wave-shared planes of (cluster, usage) resident on
        ``device``: called once per eval at snapshot time, it makes no
        torch call and never waits. The advance itself runs at the next
        ``advance_pending(device)``, which the wave launcher calls on the
        thread that assembles a wave. (The JAX package advances right
        here; in this process each torch call of an eval thread waits to
        get the interpreter lock back from ~32 scheduling threads, and
        eval threads queued behind one such advance fragmented the
        coalescer's waves.)"""
        if usage is None or not getattr(usage, "uid", ""):
            return
        dev = device_key(device)
        key = (usage.uid, usage.structure_version, dev)
        gen = self._gens.get(key)
        if gen is not None and gen.cluster is cluster \
                and gen.version >= usage.version:
            if gen.version == usage.version:
                self.hits += 1          # a tolerated stats race
            return
        with self._pending_lock:
            cur = self._pending.get(key)
            if cur is None or (cur[0] is not cluster
                               or cur[1].version < usage.version):
                self._pending[key] = (cluster, usage)

    def advance_pending(self, device) -> None:
        """Run the advances ``request`` asked for on ``device``, oldest
        structure first (a fork starts from the newest base). A failed
        advance is counted in ``errors``; its waves ship host planes."""
        if not self._pending:
            return
        dev = device_key(device)
        with self._pending_lock:
            todo = [(k, v) for k, v in self._pending.items() if k[2] == dev]
            for k, _ in todo:
                del self._pending[k]
        for _, (cluster, usage) in sorted(
                todo, key=lambda kv: (kv[0][1], kv[1][1].version)):
            try:
                self.ensure(cluster, usage, dev)
            except Exception as err:    # noqa: BLE001 - counted; host planes serve
                self.note_error(err)

    def ensure(self, cluster: ClusterTensors, usage,
               device) -> Optional[_Generation]:
        """Make the wave-shared planes of (cluster, usage) resident on
        ``device`` and registered, now (``advance_pending`` runs it for
        the requests of the evals; a cheap version compare when the
        generation is current). Returns the generation, or None for a
        usage older than the resident one."""
        if usage is None or not getattr(usage, "uid", ""):
            return None
        dev = device_key(device)
        key = (usage.uid, usage.structure_version, dev)
        # lock-free fast path: a generation's (cluster, version) pair only
        # moves forward, so a racing advance at worst sends us to the
        # locked path (hits += 1 is a tolerated stats race)
        gen = self._gens.get(key)
        if gen is not None and gen.version == usage.version \
                and gen.cluster is cluster:
            self.hits += 1
            return gen
        if gen is not None and gen.cluster is cluster \
                and gen.version > usage.version:
            # an eval still on an OLDER usage snapshot: its wave ships
            # host planes; demoting would ping-pong the registry
            return None
        # blocking on purpose: a batch's eval threads reach here with the
        # same snapshot; the first advances, the rest then hit
        with self._lock:
            gen = self._gens.get(key)
            if gen is not None and gen.version == usage.version \
                    and gen.cluster is cluster:
                self._gens.move_to_end(key)
                self.hits += 1
                return gen
            if gen is not None and gen.cluster is cluster \
                    and gen.version > usage.version:
                return None
            host = cluster.wave_shared_planes(usage)
            self.bytes_full_equiv += sum(a.nbytes for a in host.values())
            if gen is not None and gen.cluster is cluster \
                    and gen.version < usage.version:
                self._advance_usage(gen, host, usage)
            else:
                if gen is not None:
                    # the key is re-built from another host cluster object
                    self._evict(gen)
                gen = self._fork_or_build(key, cluster, host, usage)
            self._register(gen, host)
            gen.version = usage.version
            self._gens[key] = gen
            self._gens.move_to_end(key)
            latest = (usage.uid, dev)
            if usage.structure_version >= self._latest.get(latest, -1):
                self._latest[latest] = usage.structure_version
            while len(self._gens) > self.max_generations:
                _, old = self._gens.popitem(last=False)
                self._evict(old)
                self.evictions += 1
            return gen

    # --- advance paths --------------------------------------------------

    @staticmethod
    def _usage_rows_changed(usage, since_version: int):
        """Node ids whose utilization rows changed after
        ``since_version``, or None when the row log cannot prove it."""
        if since_version < getattr(usage, "row_events_floor", 0):
            return None
        return {nid for v, nid in getattr(usage, "row_events", ())
                if v > since_version}

    def _advance_usage(self, gen: _Generation,
                       host: Dict[str, np.ndarray], usage) -> None:
        """Same (uid, structure_version), newer usage version: only
        utilization rows can have moved."""
        changed = self._usage_rows_changed(usage, gen.version)
        usage_host = {f: host[f] for f in ClusterTensors.WAVE_USAGE_FIELDS}
        if changed is None:
            self.usage_full_uploads += 1
            gen.planes.update(self._upload(usage_host, gen.device))
            return
        rows = {gen.cluster.index[nid] for nid in changed
                if nid in gen.cluster.index}
        if rows:
            gen.planes = self._scatter(gen.planes, usage_host, rows,
                                       gen.device)
        self.delta_advances += 1

    def _fork_or_build(self, key, cluster: ClusterTensors,
                       host: Dict[str, np.ndarray], usage) -> _Generation:
        """A structure_version without a generation on this device: fork
        from the newest resident generation of the same store by dirty-row
        scatter when the node-change log proves the dirty set and the
        surviving rows kept their positions; otherwise a full upload."""
        uid, sv, dev = key
        base_sv = self._latest.get((uid, dev))
        base = (self._gens.get((uid, base_sv, dev))
                if base_sv is not None else None)
        if base is not None and base_sv < sv \
                and base.cluster.n_pad == cluster.n_pad:
            forked = self._try_fork(base, cluster, host, usage)
            if forked is not None:
                self.fork_deltas += 1
                return _Generation(key, cluster, usage.version, forked)
        self.full_uploads += 1
        return _Generation(key, cluster, usage.version,
                           self._upload(host, dev))

    def _try_fork(self, base: _Generation, cluster: ClusterTensors,
                  host: Dict[str, np.ndarray], usage) -> Optional[Dict]:
        changed = IncrementalClusterCache._changed_since(
            getattr(usage, "node_events", ()), base.key[1])
        if changed is None:
            return None
        n = cluster.n_real
        ids, base_ids = list(cluster.node_ids), list(base.cluster.node_ids)
        m = min(len(ids), len(base_ids))
        if ids[:m] == base_ids[:m]:
            # the common case (updates, additions at the end) without a
            # Python loop over every node: rows kept their positions, the
            # changed ones and the added ones are stale
            stale = {cluster.index[nid] for nid in changed
                     if cluster.index.get(nid, m) < m} | set(range(m, n))
        else:
            stale = []
            for j, nid in enumerate(ids):
                if nid in changed or nid not in base.cluster.index:
                    stale.append(j)
                elif base.cluster.index[nid] != j:
                    # compaction permuted surviving rows: a scatter
                    # cannot express a gather; full upload
                    return None
        if len(stale) > max(n // 2, 8):
            return None
        # rows the new build leaves as padding but the base had real
        # nodes in: their new host values are zeros by construction
        rows = set(stale) | set(range(n, base.cluster.n_real))
        static_host = {f: host[f] for f in ClusterTensors.WAVE_STATIC_FIELDS}
        usage_host = {f: host[f] for f in ClusterTensors.WAVE_USAGE_FIELDS}
        dev = base.device
        planes = dict(base.planes)
        if rows:
            planes = self._scatter(planes, static_host, rows, dev)
        dirty_usage = self._usage_rows_changed(usage, base.version)
        if dirty_usage is None:
            self.usage_full_uploads += 1
            planes.update(self._upload(usage_host, dev))
            return planes
        rows_usage = rows | {cluster.index[nid] for nid in dirty_usage
                             if nid in cluster.index}
        if rows_usage:
            planes = self._scatter(planes, usage_host, rows_usage, dev)
        return planes


#: process-wide resident state (the batching worker's snapshot path and
#: the wave launcher both consult it)
default_device_state = DeviceClusterState()
