"""Interned node-attribute planes: the compiler's vectorized columns.

Constraint targets (``${attr.kernel.name}``, ``${meta.rack}``,
``${node.datacenter}``, ...) resolve to one string per node. Evaluating
a predicate per node re-resolves and re-parses that string every time —
regex/semver predicates in particular pay their full cost per node per
eval in the Python builder. This module flattens each target ONCE per
node structure into an interned column:

- ``codes[i]``: i32 index of node i's value in the column's value
  table, -1 when the target does not resolve on the node;
- ``values``: the (small) table of distinct strings.

A predicate then runs once per DISTINCT value (a lookup table over the
vocabulary) and broadcasts to nodes with one numpy gather — the regex
compiles once and matches |vocabulary| times instead of |nodes| times.

Column sets are keyed by the usage index's ``(uid, structure_version)``
— the same generation key the incremental ClusterTensors cache and the
device-resident cluster state use — and advance across structure forks
by re-interning ONLY the rows the ``UsagePlanes.node_events`` change
log proves dirty, exactly like ``ClusterTensors.rebuild_delta``. An
unprovable log (poisoned, trimmed) or majority churn falls back to a
fresh build, which is always correct.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch.structs.constraints import resolve_target

__all__ = ["AttrPlane", "AttrPlaneSet", "AttrPlaneCache",
           "default_attr_plane_cache"]


class AttrPlane:
    """One interned target column over the cluster's node rows."""

    __slots__ = ("target", "codes", "values", "index")

    def __init__(self, target: str, codes: np.ndarray,
                 values: List[str], index: Dict[str, int]) -> None:
        self.target = target
        self.codes = codes          # i32[n_real], -1 = unresolved
        self.values = values        # code -> string
        self.index = index          # string -> code

    def lut_mask(self, predicate) -> np.ndarray:
        """bool[n_real] of ``predicate(value, found)`` per node, with
        the predicate invoked once per distinct value (and once for
        the unresolved case)."""
        lut = np.empty(len(self.values) + 1, bool)
        lut[0] = bool(predicate(None, False))           # code -1
        for code, val in enumerate(self.values):
            lut[code + 1] = bool(predicate(val, True))
        return lut[self.codes + 1]


class AttrPlaneSet:
    """Lazily-built columns for one cluster build (one node structure)."""

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self._lock = threading.Lock()
        self._planes: Dict[str, AttrPlane] = {}

    def column(self, target: str) -> AttrPlane:
        got = self._planes.get(target)
        if got is not None:
            return got
        with self._lock:
            got = self._planes.get(target)
            if got is not None:
                return got
            got = self._build(target)
            self._planes[target] = got
            return got

    def _node(self, i: int):
        c = self.cluster
        return c.nodes_by_id.get(c.node_ids[i])

    def _build(self, target: str) -> AttrPlane:
        c = self.cluster
        codes = np.full(c.n_real, -1, np.int32)
        values: List[str] = []
        index: Dict[str, int] = {}
        for i in range(c.n_real):
            node = self._node(i)
            if node is None:
                continue
            val, ok = resolve_target(target, node)
            if not ok or val is None:
                continue
            code = index.get(val)
            if code is None:
                code = len(values)
                index[val] = code
                values.append(val)
            codes[i] = code
        codes.setflags(write=False)
        return AttrPlane(target, codes, values, index)

    def fork(self, cluster, changed_ids) -> "AttrPlaneSet":
        """A new set for ``cluster`` (a later structure_version),
        re-interning only rows whose node ids are in ``changed_ids``
        (plus rows whose position moved); every other code is gathered
        from this set."""
        out = AttrPlaneSet(cluster)
        base_index = self.cluster.index
        n = cluster.n_real
        stale: List[int] = []
        perm = np.zeros(n, np.int64)
        for j, nid in enumerate(cluster.node_ids):
            i = base_index.get(nid, -1)
            if i < 0 or nid in changed_ids:
                stale.append(j)
            else:
                perm[j] = i
        with self._lock:
            planes = dict(self._planes)
        for target, base in planes.items():
            codes = base.codes[perm].copy() if n else np.zeros(0, np.int32)
            values = list(base.values)
            index = dict(base.index)
            for j in stale:
                codes[j] = -1
                node = out._node(j)
                if node is None:
                    continue
                val, ok = resolve_target(target, node)
                if not ok or val is None:
                    continue
                code = index.get(val)
                if code is None:
                    code = len(values)
                    index[val] = code
                    values.append(val)
                codes[j] = code
            codes.setflags(write=False)
            out._planes[target] = AttrPlane(target, codes, values, index)
        return out


class AttrPlaneCache:
    """(uid, structure_version) -> AttrPlaneSet, LRU-bounded, advanced
    across structure forks by the node-events dirty set."""

    def __init__(self, max_entries: int = 8) -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, AttrPlaneSet]" = OrderedDict()
        #: uid -> newest cached structure_version (the fork base)
        self._latest: Dict[str, Optional[int]] = {}
        self.max_entries = max_entries
        self.forks = 0
        self.builds = 0

    def get(self, cluster, usage=None) -> AttrPlaneSet:
        key = self._key(cluster, usage)
        with self._lock:
            got = self._entries.get(key)
            if got is not None and got.cluster is cluster:
                self._entries.move_to_end(key)
                return got
            base = None
            if usage is not None and getattr(usage, "uid", ""):
                base_sv = self._latest.get(usage.uid)
                if base_sv is not None and base_sv < usage.structure_version:
                    base = self._entries.get((usage.uid, base_sv))
        built = None
        if base is not None:
            from nomad_tpu_torch.tensors.schema import IncrementalClusterCache

            changed = IncrementalClusterCache._changed_since(
                getattr(usage, "node_events", ()), base_sv)
            if changed is not None and len(changed) <= max(
                    cluster.n_real // 2, 8):
                built = base.fork(cluster, changed)
                self.forks += 1
        if built is None:
            built = AttrPlaneSet(cluster)
            self.builds += 1
        with self._lock:
            got = self._entries.get(key)
            if got is not None and got.cluster is cluster:
                return got
            self._entries[key] = built
            if usage is not None and getattr(usage, "uid", ""):
                if usage.structure_version >= (
                        self._latest.get(usage.uid) or -1):
                    self._latest[usage.uid] = usage.structure_version
            while len(self._entries) > self.max_entries:
                old_key, _ = self._entries.popitem(last=False)
                if self._latest.get(old_key[0]) == old_key[1]:
                    self._latest.pop(old_key[0], None)
        return built

    @staticmethod
    def _key(cluster, usage) -> Tuple:
        if usage is not None and getattr(usage, "uid", ""):
            return (usage.uid, usage.structure_version)
        # usage-less states (bare test harnesses): cluster identity
        return ("cluster-id", id(cluster))


#: process-wide column cache (the mask-program runtime's vocabulary)
default_attr_plane_cache = AttrPlaneCache()
