"""Versioned in-memory state store (reference: nomad/state/state_store.go).

The reference uses go-memdb (immutable radix trees with MVCC snapshots).
The TPU-native build now matches that design, not just its contract:
persistent structural-sharing tables (``pmap.PMap``), generation-stamped
immutable roots swapped atomically by a single-writer transaction, and
lock-free O(1) point-in-time snapshots -- plus *incremental tensor
maintenance*: the store keeps the cluster's scheduling planes (used
cpu/mem/disk per node) up to date on every alloc write so evaluations
never rebuild them.
"""

from nomad_tpu_torch.state.store import StateStore, StateSnapshot  # noqa: F401
