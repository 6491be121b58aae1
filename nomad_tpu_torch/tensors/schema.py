"""ClusterTensors / AskTensor / SpreadTensor / EvalTensors: the plane contract.

A copy of the plane fields of ``nomad_tpu/tensors/schema.py``: node and
ask state flattened to fixed-width f32/i32/bool numpy planes over a
power-of-two padded node axis, so feasibility and scoring are elementwise
work on the device. The struct -> tensor builders (``build``,
``rebuild_delta``, ``gathered_usage``) and the incremental cluster cache
come with the structs slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# Static widths (framework constants, not per-cluster values). Asks
# exceeding a width raise AskLimitError.
MAX_RESERVED_PORT_ASKS = 16   # reserved-port asks per task group
MAX_DEV_REQS = 4              # device requests per task group
MAX_SPREADS = 4               # spread stanzas per task group (job+tg merged)
SPREAD_BUCKETS = 128          # distinct attribute values per spread stanza
PORT_WORDS = 65536 // 32      # u32 words covering the port space


class AskLimitError(ValueError):
    """A task group exceeds a static kernel width (device requests,
    spread stanzas)."""


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
    Capacities are net of node-reserved resources."""

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
    avail_mbits: Optional[np.ndarray] = None      # i32[n_pad] total net mbits


@dataclass
class AskTensor:
    """Node-independent flattening of one task group's resource ask
    (tasks of a group summed host-side)."""

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


@dataclass
class SpreadTensor:
    """One spread stanza flattened to bucket arrays: ``bucket_id[n]`` is
    the node's attribute-value bucket (-1 when absent), ``counts[b]``
    existing+proposed allocs per value, ``desired[b]`` the target count
    (-1 everywhere for even-spread mode)."""

    bucket_id: np.ndarray        # i32[n_pad]
    counts: np.ndarray           # f32[SPREAD_BUCKETS]
    desired: np.ndarray          # f32[SPREAD_BUCKETS]; -1 = even-spread mode
    weight_frac: float = 1.0     # weight / sumSpreadWeights
    even: bool = False


@dataclass
class EvalTensors:
    """Everything one (evaluation, task group) pair ships to the kernel."""

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
    #: bool[n_pad] nodes whose live allocs already hold an asked port
    port_live_conflict: Optional[np.ndarray] = None
