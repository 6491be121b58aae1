"""ClusterTensors / AskTensor / SpreadTensor / EvalTensors: the plane contract.

Counterpart of ``nomad_tpu/tensors/schema.py``, builders included: node
and ask state (``structs.Node``, a task group's resources) flattened to
fixed-width f32/i32/bool numpy planes over a power-of-two padded node
axis, so that feasibility and scoring are elementwise work on the
device. Ragged data (regex/version constraints, attribute strings,
device attributes) is evaluated on the host per computed node class and
enters the kernels only as mask planes or bucket ids.

``ClusterTensors.build`` flattens a node table; ``rebuild_delta`` and
``IncrementalClusterCache`` re-flatten only the rows the store's node
change log names, bit-identical to a fresh build. ``gathered_usage``
gives the snapshot's utilization in cluster row order, shared by
identity across the evals of one snapshot so that a wave ships it once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Static widths (kernel recompiles if these change; they are framework
# constants, not per-cluster values). Asks exceeding a width raise
# AskLimitError -- the scheduler surfaces it as an eval failure rather
# than silently mis-scheduling.
MAX_RESERVED_PORT_ASKS = 16   # reserved-port asks per task group
MAX_DEV_REQS = 4              # device requests per task group
MAX_SPREADS = 4               # spread stanzas per task group (job+tg merged)
SPREAD_BUCKETS = 128          # distinct attribute values per spread stanza
PORT_WORDS = 65536 // 32      # u32 words covering the port space


class AskLimitError(ValueError):
    """A task group exceeds a static kernel width (device requests,
    spread stanzas). The reference has no such limits (iterators are
    unbounded); the tensor formulation trades that for static shapes."""


import threading as _threading  # noqa: E402

#: guards ClusterTensors' identity-shared lazy caches (gathered usage
#: planes): identity sharing is load-bearing for wave upload layout
_GATHER_LOCK = _threading.Lock()

_MIN_BUCKET = 64


def pad_bucket(n: int) -> int:
    """Round up to the next power of two (min 64) for static shapes."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


@dataclass
class ClusterTensors:
    """Per-snapshot node planes, node axis padded to ``n_pad``.

    Built once per scheduling snapshot (and incrementally updatable);
    shared by every evaluation scheduled against that snapshot.
    Capacities are net of node-reserved resources (the subtraction in
    reference funcs.go:199-204 is pre-applied).
    """

    n_real: int
    n_pad: int
    node_ids: List[str]                      # host-side, len n_real
    index: Dict[str, int]                    # node id -> row
    cap_cpu: np.ndarray                      # f32[n_pad]
    cap_mem: np.ndarray                      # f32[n_pad]
    cap_disk: np.ndarray                     # f32[n_pad]
    ready: np.ndarray                        # bool[n_pad]
    port_words: np.ndarray                   # u32[n_pad, PORT_WORDS]
    free_dyn: np.ndarray                     # i32[n_pad] free dynamic ports
    free_cores: np.ndarray                   # i32[n_pad] unreserved core count
    shares_per_core: np.ndarray              # f32[n_pad]
    # host-side ragged companions (never shipped to device)
    datacenters: List[str] = field(default_factory=list)
    node_classes: List[str] = field(default_factory=list)
    computed_classes: List[str] = field(default_factory=list)
    node_pools: List[str] = field(default_factory=list)
    # node-static planes + caches added for the per-eval fast path
    avail_mbits: Optional[np.ndarray] = None      # i32[n_pad] total net mbits
    nodes_by_id: Dict[str, object] = field(default_factory=dict)
    _dc_arr: Optional[np.ndarray] = None          # U-dtype datacenter per row
    _pool_arr: Optional[np.ndarray] = None
    _usage_perm: Optional[Tuple[int, np.ndarray, np.ndarray]] = None
    _class_rows: Optional[Dict[str, List[int]]] = None

    _gathered_usage: Optional[Tuple[int, tuple]] = None
    #: guards _gathered_usage recomputes (see gathered_usage); set by
    #: the builders, None falls back to the module-wide _GATHER_LOCK
    _gather_lock: Optional[object] = None

    # graft: frozen
    def gathered_usage(self, usage) -> tuple:
        """(used_cpu, used_mem, used_disk, used_cores, used_mbits)
        gathered to cluster rows — READ-ONLY arrays cached per usage
        ``version`` and shared by identity across every eval scheduled
        against that snapshot. The wave launcher ships identity-shared
        planes to the device ONCE per wave instead of once per member;
        mutators (retry bookkeeping) must copy-on-write.

        The recompute is double-checked under a lock: identity IS the
        contract here — two eval threads racing a version bump used to
        each build their own (equal) tuples, the wave launcher saw
        distinct objects, fell back to the stacked layout, and
        compiled a whole extra XLA variant for one batch. The lock is
        per-instance where the builders install one (the race is
        per-instance); the module lock is only the fallback for
        directly-constructed instances (bench synthetics)."""
        cached = self._gathered_usage
        if cached is not None and cached[0] == usage.version:
            return cached[1]
        with (self._gather_lock or _GATHER_LOCK):
            cached = self._gathered_usage
            if cached is not None and cached[0] == usage.version:
                return cached[1]
            version = usage.version
            perm, valid = self.usage_perm(usage)
            planes = (
                np.where(valid, usage.used_cpu[perm], 0.0).astype(np.float32),
                np.where(valid, usage.used_mem[perm], 0.0).astype(np.float32),
                np.where(valid, usage.used_disk[perm], 0.0).astype(np.float32),
                np.where(valid, usage.used_cores[perm], 0).astype(np.int32),
                np.where(valid, usage.used_mbits[perm], 0).astype(np.int32),
            )
            for p in planes:
                p.setflags(write=False)
            object.__setattr__(self, "_gathered_usage", (version, planes))
            return planes

    #: KernelIn field -> ClusterTensors plane for the cluster-static
    #: half of the wave-shared group (parallel/coalesce._SHAREABLE_
    #: FIELDS). Single source of truth for the device-resident state
    #: (tensors/device_state.py) and its property tests: these arrays
    #: reach build_kernel_in identity-preserved (np.asarray with a
    #: matching dtype is a no-op), so a device-resident copy keyed by
    #: host identity serves every wave of the snapshot.
    WAVE_STATIC_FIELDS = {
        "cap_cpu": "cap_cpu", "cap_mem": "cap_mem",
        "cap_disk": "cap_disk", "free_cores": "free_cores",
        "shares_per_core": "shares_per_core",
        "avail_mbits": "avail_mbits", "free_dyn": "free_dyn",
    }
    #: KernelIn field order of the gathered_usage tuple (the dynamic
    #: half of the wave-shared group)
    WAVE_USAGE_FIELDS = ("used_cpu", "used_mem", "used_disk",
                         "used_cores", "used_mbits")

    def wave_shared_planes(self, usage) -> Dict[str, np.ndarray]:
        """KernelIn field -> host plane for every wave-shared leaf of
        this (cluster build, usage snapshot) pair — exactly the arrays
        an eval's ``build_kernel_in`` ships by identity when its plan
        is empty (stack.py wave-shared build)."""
        planes = {f: getattr(self, c)
                  for f, c in self.WAVE_STATIC_FIELDS.items()}
        for f, arr in zip(self.WAVE_USAGE_FIELDS,
                          self.gathered_usage(usage)):
            planes[f] = arr
        return planes

    def class_rows(self) -> Dict[str, List[int]]:
        """computed class -> real-node rows, cached on the cluster build
        (the class-eligibility walk needs it once per EVAL; rebuilding
        the O(N) grouping per eval showed in the wave profile)."""
        if self._class_rows is None:
            rows: Dict[str, List[int]] = {}
            for i, cc in enumerate(self.computed_classes):
                rows.setdefault(cc, []).append(i)
            object.__setattr__(self, "_class_rows", rows)
        return self._class_rows

    def usage_perm(self, usage) -> Tuple[np.ndarray, np.ndarray]:
        """Map cluster rows -> usage-plane rows (gather index + validity).

        Cached per usage ``structure_version``; the node set cannot
        change within one version, so the mapping is stable.
        """
        cached = self._usage_perm
        if cached is not None and cached[0] == usage.structure_version:
            return cached[1], cached[2]
        perm = np.zeros(self.n_pad, np.int32)
        valid = np.zeros(self.n_pad, bool)
        for i in range(self.n_real):
            row = usage.rows.get(self.node_ids[i], -1)
            if 0 <= row < usage.n:
                perm[i] = row
                valid[i] = True
        object.__setattr__(
            self, "_usage_perm", (usage.structure_version, perm, valid)
        )
        return perm, valid

    def dc_pool_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized datacenter/pool companions (readyNodesInDCs mask)."""
        if self._dc_arr is None:
            dc = np.array(
                self.datacenters + [""] * (self.n_pad - self.n_real))
            pool = np.array(
                list(self.node_pools) + [""] * (self.n_pad - self.n_real))
            object.__setattr__(self, "_dc_arr", dc)
            object.__setattr__(self, "_pool_arr", pool)
        return self._dc_arr, self._pool_arr

    def _flatten_row(self, i: int, node) -> None:
        """Flatten one structs.Node into row ``i`` of the plane arrays
        (shared by the full build and the dirty-row delta path). The
        NetworkIndex port scan here is the dominant per-node cost of a
        cluster build — exactly what the delta path avoids paying for
        unchanged nodes."""
        from nomad_tpu_torch.structs.network import NetworkIndex

        res = node.node_resources
        rsv = node.reserved_resources
        self.cap_cpu[i] = max(res.cpu.cpu_shares - rsv.cpu_shares, 0)
        self.cap_mem[i] = max(res.memory.memory_mb - rsv.memory_mb, 0)
        self.cap_disk[i] = max(res.disk.disk_mb - rsv.disk_mb, 0)
        self.ready[i] = node.ready()
        idx = NetworkIndex()
        idx.set_node(node)
        w64 = idx.port_words()            # u64[1024]
        self.port_words[i] = w64.view(np.uint32)
        self.free_dyn[i] = idx.free_dynamic_count()
        self.free_cores[i] = len(
            set(res.cpu.reservable_cpu_cores) - set(rsv.reserved_cpu_cores)
        )
        self.shares_per_core[i] = res.cpu.shares_per_core()
        self.avail_mbits[i] = sum(net.mbits for net in res.networks)
        self.node_ids[i] = node.id
        self.datacenters[i] = node.datacenter
        self.node_classes[i] = node.node_class
        self.computed_classes[i] = node.computed_class or node.compute_class()
        self.node_pools[i] = node.node_pool

    @classmethod
    def _empty(cls, n: int, npad: int) -> "ClusterTensors":
        return cls(
            n_real=n, n_pad=npad,
            node_ids=[""] * n, index={},
            cap_cpu=np.zeros(npad, np.float32),
            cap_mem=np.zeros(npad, np.float32),
            cap_disk=np.zeros(npad, np.float32),
            ready=np.zeros(npad, bool),
            port_words=np.zeros((npad, PORT_WORDS), np.uint32),
            free_dyn=np.zeros(npad, np.int32),
            free_cores=np.zeros(npad, np.int32),
            shares_per_core=np.zeros(npad, np.float32),
            datacenters=[""] * n, node_classes=[""] * n,
            computed_classes=[""] * n, node_pools=[""] * n,
            avail_mbits=np.zeros(npad, np.int32),
            _gather_lock=_threading.Lock(),
        )

    @classmethod
    def build(cls, nodes: Sequence) -> "ClusterTensors":
        """Flatten structs.Node rows. Nodes keep their given order; the
        caller owns any shuffling (reference util.go:464 shuffleNodes is
        unnecessary under global argmax selection)."""
        n = len(nodes)
        out = cls._empty(n, pad_bucket(n))
        for i, node in enumerate(nodes):
            out._flatten_row(i, node)
        out.index = {nid: i for i, nid in enumerate(out.node_ids)}
        out.nodes_by_id = {nd.id: nd for nd in nodes}
        return out

    _PLANE_FIELDS = ("cap_cpu", "cap_mem", "cap_disk", "ready",
                     "port_words", "free_dyn", "free_cores",
                     "shares_per_core", "avail_mbits")
    _RAGGED_FIELDS = ("node_ids", "datacenters", "node_classes",
                      "computed_classes", "node_pools")

    def rebuild_delta(self, nodes: Sequence,
                      changed_ids) -> Optional["ClusterTensors"]:
        """A fresh ClusterTensors for the new node table, re-flattening
        ONLY the rows in ``changed_ids`` (plus additions); every other
        row is gathered from this build by numpy memcpy. Returns None
        when a delta is not worth it or not possible (pad-bucket
        change, or more than half the rows dirty) — the caller falls
        back to ``build``.

        The result is bit-identical to ``ClusterTensors.build(nodes)``:
        unchanged rows were computed from the same node objects (the
        store's change log guarantees untouched ids kept their rows'
        inputs), additions/removals reproduce the store's dict-order
        compaction, and dirty rows run the same flatten."""
        n = len(nodes)
        npad = pad_bucket(n)
        if npad != self.n_pad:
            return None
        if self.n_real == 0:
            # nothing to gather from (the ragged lists are empty, so
            # even placeholder row indices for stale rows would be out
            # of range); a fresh build of a tiny cluster is cheap
            return None
        stale: List[int] = []
        perm = np.zeros(n, np.int64)
        for j, node in enumerate(nodes):
            i = self.index.get(node.id, -1)
            if i < 0 or node.id in changed_ids:
                stale.append(j)
            else:
                perm[j] = i
        if len(stale) > max(n // 2, 8):
            return None
        out = ClusterTensors._empty(n, npad)
        for f in self._PLANE_FIELDS:
            old = getattr(self, f)
            new = getattr(out, f)
            new[:n] = old[perm]
        for f in self._RAGGED_FIELDS:
            old = getattr(self, f)
            setattr(out, f, [old[i] for i in perm])
        for j in stale:
            out._flatten_row(j, nodes[j])
        out.index = {nid: i for i, nid in enumerate(out.node_ids)}
        out.nodes_by_id = {nd.id: nd for nd in nodes}
        return out


@dataclass
class AskTensor:
    """Node-independent flattening of one task group's resource ask.

    The per-task loop in reference rank.go:349-500 collapses: tasks of a
    group are summed host-side (cpu/mem; group disk; group+task ports;
    device request counts) because the kernel places whole groups.
    """

    cpu: float = 0.0                 # summed task cpu shares (MHz)
    mem: float = 0.0                 # summed task memory MB
    disk: float = 0.0                # group ephemeral disk MB
    cores: int = 0                   # summed reserved-core asks
    n_dyn_ports: int = 0
    reserved_ports: List[int] = None     # host-side full list of asks
    port_mask: np.ndarray = None         # u32[PORT_WORDS] bits of ALL asks
    n_dev_reqs: int = 0
    dev_counts: np.ndarray = None        # i32[MAX_DEV_REQS], 0 pad
    total_mbits: int = 0

    @classmethod
    def build(cls, tg) -> "AskTensor":
        a = cls()
        a.reserved_ports = []
        a.port_mask = np.zeros(PORT_WORDS, np.uint32)
        a.dev_counts = np.zeros(MAX_DEV_REQS, np.int32)
        a.disk = float(tg.ephemeral_disk.size_mb)

        ndev = 0
        for net in tg.networks:
            a.n_dyn_ports += len(net.dynamic_ports)
            a.total_mbits += net.mbits
            a.reserved_ports += [p.value for p in net.reserved_ports]
        for task in tg.tasks:
            r = task.resources
            if r.cores > 0:
                a.cores += r.cores
            else:
                a.cpu += float(r.cpu)
            a.mem += float(r.memory_mb)
            for net in r.networks:
                a.n_dyn_ports += len(net.dynamic_ports)
                a.total_mbits += net.mbits
                a.reserved_ports += [p.value for p in net.reserved_ports]
            for dev in r.devices:
                if ndev >= MAX_DEV_REQS:
                    raise AskLimitError(
                        f"task group {tg.name!r} has more than "
                        f"{MAX_DEV_REQS} device requests"
                    )
                a.dev_counts[ndev] = dev.count
                ndev += 1
        a.n_dev_reqs = ndev
        for port in a.reserved_ports:
            a.port_mask[port >> 5] |= np.uint32(1 << (port & 31))
        return a


@dataclass
class SpreadTensor:
    """One spread stanza flattened to bucket arrays.

    ``bucket_id[n]`` maps each node's attribute value into the stanza's
    value table (-1 when the node lacks the attribute); ``counts[b]``
    is existing+proposed allocs per value (reference propertyset.go);
    ``desired[b]`` is the target count per value, or -1 everywhere for
    even-spread mode (no targets specified, reference spread.go:193).
    """

    bucket_id: np.ndarray        # i32[n_pad]
    counts: np.ndarray           # f32[SPREAD_BUCKETS]
    desired: np.ndarray          # f32[SPREAD_BUCKETS]; -1 = even-spread mode
    weight_frac: float = 1.0     # weight / sumSpreadWeights
    even: bool = False


@dataclass
class EvalTensors:
    """Everything one (evaluation, task group) pair ships to the kernel.

    The boolean/score planes are the tensorized residue of the
    feasibility+rank iterator chain (reference stack.go:344-439):
    ``base_mask`` folds RandomIterator eligibility, class-level constraint
    checks, driver checks, distinct_hosts/property and volume checks;
    ``aff_score``/``penalty``/``job_tg_count`` feed the soft-score planes.
    """

    base_mask: np.ndarray            # bool[n_pad]
    used_cpu: np.ndarray             # f32[n_pad] proposed utilization
    used_mem: np.ndarray             # f32[n_pad]
    used_disk: np.ndarray            # f32[n_pad]
    used_mbits: np.ndarray           # i32[n_pad]
    avail_mbits: np.ndarray          # i32[n_pad]
    used_cores: np.ndarray           # i32[n_pad] count of reserved cores used
    port_conflict_words: np.ndarray  # u32[n_pad, PORT_WORDS] in-plan port bits
    free_dyn_delta: np.ndarray       # i32[n_pad] dyn ports consumed in-plan
    dev_free: np.ndarray             # f32[n_pad, MAX_DEV_REQS] per-request
    dev_aff_score: np.ndarray        # f32[n_pad]
    has_dev_affinity: bool
    job_tg_count: np.ndarray         # i32[n_pad] same job+tg proposed allocs
    job_any_count: np.ndarray        # i32[n_pad] job allocs on node (any tg)
    distinct_hosts_job: bool         # job-level distinct_hosts constraint
    distinct_hosts_tg: bool          # tg-level distinct_hosts constraint
    penalty: np.ndarray              # bool[n_pad] rescheduling penalty nodes
    aff_score: np.ndarray            # f32[n_pad] normalized affinity score
    has_affinities: bool
    spreads: List[SpreadTensor]
    ask: AskTensor
    desired_count: int               # tg.count (anti-affinity denominator)
    algorithm: str = "binpack"       # binpack | spread (cluster config)
    #: bool[n_pad] overlay for reserved-port asks: nodes whose LIVE
    #: allocs already hold an asked port (from the usage index's port
    #: bitmaps — state/usage.py). The static node plane only covers
    #: agent-reserved ports; without this the kernel picks occupied
    #: nodes and placement burns an assigner-fail + masked relaunch.
    port_live_conflict: Optional[np.ndarray] = None


class IncrementalClusterCache:
    """ClusterTensors cache keyed on the state store's identity, with
    dirty-node delta refresh.

    The batching worker used to pay a full O(nodes) Python rebuild
    (NetworkIndex port scan per node) every batch whose snapshot's
    ``structure_version`` moved — and on a live cluster it moves every
    heartbeat-driven status write. This cache replays the usage
    index's node-change log (state/usage.py ``node_events``) between
    the cached build's version and the snapshot's, re-flattening only
    the logged rows (``ClusterTensors.rebuild_delta``). A poisoned or
    trimmed log, a pad-bucket change, or majority churn falls back to
    the full build. Delta results are bit-identical to a fresh build
    and keyed per (uid, structure_version), so wave members keep
    sharing one object by identity.

    Unlike the JAX package's cache, a key is built once: the evals of a
    batch that miss one version together wait for the first one's build
    instead of each running it (up to 32 full builds of the cluster under
    the GIL for a server's first batch after a restore)."""

    def __init__(self, max_entries: int = 8) -> None:
        self._lock = _threading.Lock()
        #: (uid, structure_version) -> ClusterTensors. Versioned keys
        #: matter: a batch still scheduling against an OLDER snapshot
        #: than the newest cached one must keep getting one identical
        #: object per call (identity sharing is the wave launcher's
        #: upload layout), not a fresh rebuild per eval.
        self._entries: Dict[Tuple[str, int], ClusterTensors] = {}
        #: uid -> newest cached structure_version (the delta base)
        self._latest: Dict[str, int] = {}
        #: key -> set once the build of that key in flight has ended
        self._building: Dict[Tuple[str, int], _threading.Event] = {}
        self.max_entries = max_entries
        # observability (asserted by tests, handy under a profiler)
        self.hits = 0
        self.delta_builds = 0
        self.full_builds = 0

    def get(self, state) -> ClusterTensors:
        u = getattr(state, "usage", None)
        if u is None or not u.uid:
            self.full_builds += 1
            return ClusterTensors.build(state.nodes())
        key = (u.uid, u.structure_version)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.hits += 1
                return hit
            pending = self._building.get(key)
            if pending is None:
                self._building[key] = _threading.Event()
            base_sv = self._latest.get(u.uid)
            base = (self._entries.get((u.uid, base_sv))
                    if base_sv is not None else None)
        if pending is not None:
            # another thread is building this version: take its result
            # (or, if its build failed or was evicted, try again)
            pending.wait()
            return self.get(state)
        try:
            return self._build(state, u, key, base, base_sv)
        finally:
            with self._lock:
                self._building.pop(key).set()

    def _build(self, state, u, key, base, base_sv) -> ClusterTensors:
        nodes = state.nodes()
        built: Optional[ClusterTensors] = None
        if base is not None and base_sv < u.structure_version:
            changed = self._changed_since(
                getattr(u, "node_events", ()), base_sv)
            if changed is not None:
                built = base.rebuild_delta(nodes, changed)
        if built is not None:
            self.delta_builds += 1
        else:
            built = ClusterTensors.build(nodes)
            self.full_builds += 1
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                # a racing thread cached this exact version first: keep
                # ITS object so every caller of the version shares one
                return hit
            self._entries[key] = built
            if u.structure_version >= self._latest.get(u.uid, -1):
                self._latest[u.uid] = u.structure_version
            while len(self._entries) > self.max_entries:
                old_key = next(iter(self._entries))
                self._entries.pop(old_key)
                if self._latest.get(old_key[0]) == old_key[1]:
                    self._latest.pop(old_key[0], None)
        return built

    @staticmethod
    def _changed_since(events, since_sv: int):
        """Node ids changed after ``since_sv`` per the log, or None
        when the log cannot prove completeness (poison entry, trimmed
        tail, or no events despite a version bump)."""
        if not events:
            return None
        changed = set()
        seen_floor = None
        for sv, nid in events:
            if seen_floor is None:
                seen_floor = sv
            if sv <= since_sv:
                continue
            if nid is None:
                return None
            changed.add(nid)
        # the log's oldest entry must not postdate the gap start, or
        # trimmed entries may hide changes
        if seen_floor is None or seen_floor > since_sv + 1:
            return None
        return changed


#: process-wide incremental cache (the batching worker's
#: cluster_provider and the direct scheduler path both consult it)
default_incremental_cluster_cache = IncrementalClusterCache()
