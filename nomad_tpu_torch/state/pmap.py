"""Persistent structural-sharing hash map — the MVCC store's substrate.

The reference StateStore is built on go-memdb's immutable radix tree:
every write path-copies the O(log n) spine from the touched leaf to a
NEW root and shares every untouched subtree, so a transaction commit
is one root-pointer swap and a snapshot is one root-pointer read
(state_store.go Snapshot — "free" point-in-time reads, PAPER.md
layer 2). Python dicts cannot do that: copying a 100k-entry table per
snapshot was the seed store's scaling wall (the heartbeat tax).

``PMap`` is that structure for this codebase: a path-copying radix
tree over the key hash (fixed fanout ``2**BITS`` per level, leaves =
small plain dicts). Operations:

- ``get``/``in``/``len``/iteration — read-only, safe from any thread
  with no lock (nodes are never mutated after publication; a reader
  holding a root sees that root forever).
- ``assoc(k, v)`` / ``dissoc(k)`` — O(log n): build a new leaf dict
  plus one spine of branch tuples, return a NEW PMap sharing all
  untouched subtrees.
- ``update_with(changes)`` — bulk transaction commit: applies a
  ``{key: value-or-TOMBSTONE}`` overlay in ONE tree walk, grouping
  changes by radix digit so each affected subtree is path-copied once
  (a wave commit's hundreds of alloc upserts cost one spine, not
  hundreds).

Leaves are plain dicts (C-speed lookup/copy) capped at ``LEAF_MAX``
entries; an over-full leaf splits into a branch on the next hash
byte. Keys whose hashes collide beyond ``MAX_DEPTH`` levels simply
share an uncapped leaf — the dict disambiguates by key equality, so
collisions cost lookup time, never correctness.

Invariants (the graftcheck R4 taint rule leans on these):
- leaf dicts and branch tuples are IMMUTABLE after publication;
- every mutator returns a new ``PMap`` — there is no in-place write;
- two PMaps from the same lineage share all subtrees their change
  sets did not touch (the retention property test pins this: dropping
  a snapshot releases exactly its private subtrees).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

#: radix bits per level: fanout 64 keeps the tree 3-4 deep at the
#: 100k-1M-row table sizes the mesh cell runs, so an assoc copies one
#: small leaf dict + a few 64-slot branch tuples (measured faster than
#: fanout 256, whose per-level tuple copies dominate the spine cost)
BITS = 6
FANOUT = 1 << BITS
MASK = FANOUT - 1

#: leaf split threshold. Leaves are plain dicts; past this size a
#: lookup is still O(1) but the per-assoc leaf copy stops being cheap
LEAF_MAX = 16

#: Python hashes are 64-bit; past this depth the radix digits are
#: exhausted and a leaf grows unbounded (equal-hash collision bucket)
MAX_DEPTH = 64 // BITS

#: delete marker for ``update_with`` overlays
TOMBSTONE = object()

_EMPTY_LEAF: Dict = {}


def _assoc(node, depth: int, h: int, key, value) -> Tuple[Any, int]:
    """Return (new_node, len_delta) with ``key=value`` folded in."""
    if isinstance(node, dict):
        added = 0 if key in node else 1
        leaf = dict(node)
        leaf[key] = value
        if len(leaf) > LEAF_MAX and depth < MAX_DEPTH:
            return _split(leaf, depth), added
        return leaf, added
    digit = (h >> (depth * BITS)) & MASK
    child = node[digit]
    if child is None:
        new_child, added = {key: value}, 1
    else:
        new_child, added = _assoc(child, depth + 1, h, key, value)
    return node[:digit] + (new_child,) + node[digit + 1:], added


def _split(leaf: Dict, depth: int):
    """An over-full leaf becomes a branch on the next radix digit."""
    buckets: Dict[int, Dict] = {}
    shift = depth * BITS
    for k, v in leaf.items():
        buckets.setdefault((hash(k) >> shift) & MASK, {})[k] = v
    if len(buckets) == 1:
        # every key shares this digit; the branch would chain — keep
        # the leaf and let the next level (or MAX_DEPTH) resolve it
        return leaf
    slots = [None] * FANOUT
    for digit, bucket in buckets.items():
        slots[digit] = bucket
    return tuple(slots)


def _dissoc(node, depth: int, h: int, key) -> Tuple[Any, int]:
    """Return (new_node_or_None, len_delta) with ``key`` removed."""
    if isinstance(node, dict):
        if key not in node:
            return node, 0
        leaf = dict(node)
        del leaf[key]
        return (leaf if leaf else None), -1
    digit = (h >> (depth * BITS)) & MASK
    child = node[digit]
    if child is None:
        return node, 0
    new_child, removed = _dissoc(child, depth + 1, h, key)
    if removed == 0:
        return node, 0
    return node[:digit] + (new_child,) + node[digit + 1:], removed


def _bulk(node, depth: int, items) -> Tuple[Any, int]:
    """Apply ``items`` = [(hash, key, value-or-TOMBSTONE)] under
    ``node`` in one walk; returns (new_node_or_None, len_delta)."""
    if node is None or isinstance(node, dict):
        leaf = dict(node) if node else {}
        delta = 0
        for _h, k, v in items:
            if v is TOMBSTONE:
                if k in leaf:
                    del leaf[k]
                    delta -= 1
            else:
                if k not in leaf:
                    delta += 1
                leaf[k] = v
        if not leaf:
            return None, delta
        if len(leaf) > LEAF_MAX and depth < MAX_DEPTH:
            return _split_bulk(leaf, depth), delta
        return leaf, delta
    shift = depth * BITS
    by_digit: Dict[int, list] = {}
    for item in items:
        by_digit.setdefault((item[0] >> shift) & MASK, []).append(item)
    slots = list(node)
    delta = 0
    for digit, group in by_digit.items():
        new_child, d = _bulk(slots[digit], depth + 1, group)
        slots[digit] = new_child
        delta += d
    return tuple(slots), delta


def _split_bulk(leaf: Dict, depth: int):
    """Split possibly far-over-full leaves recursively (bulk loads
    can overshoot LEAF_MAX by more than one entry)."""
    node = _split(leaf, depth)
    if isinstance(node, dict):
        return node
    slots = list(node)
    for digit, child in enumerate(slots):
        if isinstance(child, dict) and len(child) > LEAF_MAX \
                and depth + 1 < MAX_DEPTH:
            slots[digit] = _split_bulk(child, depth + 1)
    return tuple(slots)


def _iter_node(node) -> Iterator[Tuple[Any, Any]]:
    if node is None:
        return
    if isinstance(node, dict):
        yield from node.items()
        return
    for child in node:
        if child is not None:
            yield from _iter_node(child)


def _diff_node(old, new, out: Dict) -> None:
    """Fold the changes turning ``old`` into ``new`` into ``out`` as a
    ``{key: new_value-or-TOMBSTONE}`` overlay, pruning ``is``-identical
    subtrees without descending into them."""
    if old is new:
        return
    if isinstance(old, tuple) and isinstance(new, tuple):
        # both branches: recurse only into slots whose child changed
        for a, b in zip(old, new):
            if a is not b:
                _diff_node(a, b, out)
        return
    # shape change (leaf grew into a branch, subtree emptied, ...):
    # materialize both sides. Shape changes happen at leaf granularity,
    # so the materialized set is small.
    old_items = dict(_iter_node(old))
    for k, v in _iter_node(new):
        if old_items.pop(k, TOMBSTONE) is not v:
            out[k] = v
    for k in old_items:
        out[k] = TOMBSTONE


def pmap_diff(old: "PMap", new: "PMap") -> Dict:
    """The ``{key: new_value-or-TOMBSTONE}`` overlay turning ``old``
    into ``new`` — the wire shape of a cross-process snapshot delta
    frame (state/store.delta_frame).

    Structural sharing makes this O(changes): two maps of the same
    lineage share every untouched subtree BY IDENTITY, so the walk
    prunes on ``is`` and only descends path-copied spines. Values are
    compared by identity too (the store replaces rows, never mutates
    them); a re-set of an equal-but-distinct row therefore appears in
    the diff — a harmless superset, still exact under ``update_with``.
    """
    out: Dict = {}
    _diff_node(old._root, new._root, out)
    return out


class PMap:
    """Immutable hash map with O(log n) persistent updates.

    The dict-shaped read surface (``get``/``in``/``len``/``items``/
    ``values``/``keys``) means store tables built on it drop into the
    code paths that used plain dicts; the write surface (``assoc``/
    ``dissoc``/``update_with``) always returns a new map.
    """

    __slots__ = ("_root", "_len")

    def __init__(self, _root=_EMPTY_LEAF, _len: int = 0) -> None:
        self._root = _root
        self._len = _len

    # -- reads (lock-free on any published map) -------------------------

    def get(self, key, default=None):
        node = self._root
        h: Optional[int] = None
        depth = 0
        while isinstance(node, tuple):
            if h is None:
                h = hash(key)
            node = node[(h >> (depth * BITS)) & MASK]
            depth += 1
        if node is None:
            return default
        return node.get(key, default)

    def __contains__(self, key) -> bool:
        sentinel = TOMBSTONE
        return self.get(key, sentinel) is not sentinel

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self) -> Iterator:
        for k, _v in _iter_node(self._root):
            yield k

    def keys(self) -> Iterator:
        return iter(self)

    def values(self) -> Iterator:
        for _k, v in _iter_node(self._root):
            yield v

    def items(self) -> Iterator[Tuple[Any, Any]]:
        return _iter_node(self._root)

    def to_dict(self) -> Dict:
        """Materialize (for pickling / raft snapshot payloads)."""
        return dict(_iter_node(self._root))

    def __getitem__(self, key):
        sentinel = TOMBSTONE
        val = self.get(key, sentinel)
        if val is sentinel:
            raise KeyError(key)
        return val

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PMap(len={self._len})"

    # -- persistent writes ----------------------------------------------

    def assoc(self, key, value) -> "PMap":
        new_root, added = _assoc(self._root, 0, hash(key), key, value)
        return PMap(new_root, self._len + added)

    def dissoc(self, key) -> "PMap":
        new_root, removed = _dissoc(self._root, 0, hash(key), key)
        if removed == 0:
            return self
        return PMap(new_root if new_root is not None else _EMPTY_LEAF,
                    self._len + removed)

    def update_with(self, changes: Dict) -> "PMap":
        """Apply a ``{key: value-or-TOMBSTONE}`` overlay in one walk."""
        if not changes:
            return self
        items = [(hash(k), k, v) for k, v in changes.items()]
        new_root, delta = _bulk(self._root, 0, items)
        return PMap(new_root if new_root is not None else _EMPTY_LEAF,
                    self._len + delta)

    # -- construction / pickling ----------------------------------------

    @staticmethod
    def from_dict(d: Dict) -> "PMap":
        """Bulk-build (restore path: C2M scale in one pass)."""
        if not d:
            return PMap()
        if len(d) <= LEAF_MAX:
            return PMap(dict(d), len(d))
        items = [(hash(k), k, v) for k, v in d.items()]
        root, delta = _bulk(None, 0, items)
        return PMap(root, delta)

    def __reduce__(self):
        # pickles as its dict payload: snapshot files stay readable by
        # anything that understands dicts, and unpickling rebuilds the
        # tree bulk-wise
        return (PMap.from_dict, (self.to_dict(),))

    def __eq__(self, other) -> bool:
        if isinstance(other, PMap):
            if other is self:
                return True
            if other._len != self._len:
                return False
            other = other.to_dict()
        if isinstance(other, dict):
            if len(other) != self._len:
                return False
            sentinel = TOMBSTONE
            for k, v in other.items():
                if self.get(k, sentinel) != v:
                    return False
            return True
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None  # mutable-by-lineage identity; not hashable


EMPTY = PMap()
