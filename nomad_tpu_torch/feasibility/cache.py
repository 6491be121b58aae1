"""Mask-program + evaluated-mask caches.

Two LRU layers, both process-wide and thread-safe:

- **programs**: constraint-tree signature -> compiled ``MaskProgram``.
  Compilation is cheap but the signature is the sharing key: two jobs
  with equal trees land on ONE program (and so one evaluated mask).
- **masks**: (uid, structure_version, signature) -> ``MaskEntry`` —
  the fully-evaluated static feasibility plane plus the memoized side
  channel the Python builder produced per eval (per-reason filter
  counts for AllocMetric, per-class eligibility for blocked evals).
  Keyed by the usage index's generation key so node-structure forks
  invalidate cleanly; an entry evaluated against a different
  ClusterTensors object for the same key is re-checked against row
  count before reuse (rebuilds of one structure_version are
  bit-identical by the incremental-cache contract).

Evaluated masks are FROZEN and content-deduped: two signatures whose
masks come out equal share one canonical array, so wave members of
*different* jobs still ship one identity-shared base-mask plane per
wave (parallel/coalesce job-sharing group) and one device-resident
copy ever (tensors/device_state frozen registry).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch.feasibility.compiler import MaskProgram, compile_program

__all__ = ["MaskEntry", "MaskProgramCache", "default_mask_cache"]


class MaskEntry:
    """One evaluated (program, node structure) result."""

    __slots__ = ("mask", "filter_counts", "class_job_elig",
                 "class_tg_elig", "cluster_n", "cluster_ref")

    def __init__(self, mask: np.ndarray,
                 filter_counts: List[Tuple[str, str, int]],
                 class_job_elig: Dict[str, bool],
                 class_tg_elig: Dict[str, bool],
                 cluster) -> None:
        self.mask = mask                        # frozen bool[n_pad]
        #: [(reason, node_class, count)] exactly as the Python
        #: builder's metrics.filter_node calls would have tallied
        self.filter_counts = filter_counts
        #: computed class -> eligible, in the same conditions the
        #: Python builder populated EvalEligibility (empty when the
        #: program escaped — escaped evals never memoize)
        self.class_job_elig = class_job_elig
        self.class_tg_elig = class_tg_elig
        self.cluster_n = cluster.n_real
        #: set (pinning the build) only for usage-less identity keys,
        #: where a recycled id() must not alias a dead cluster; for
        #: (uid, structure_version) keys the key itself defines the
        #: node structure and pinning would hold whole builds hostage
        self.cluster_ref = None


class MaskProgramCache:
    def __init__(self, max_programs: int = 256,
                 max_masks: int = 512) -> None:
        self._lock = threading.Lock()
        self._programs: "OrderedDict[tuple, Optional[MaskProgram]]" = \
            OrderedDict()
        self._masks: "OrderedDict[tuple, MaskEntry]" = OrderedDict()
        #: (uid, sv, digest) -> canonical frozen mask (content dedup)
        self._canonical: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self.max_programs = max_programs
        self.max_masks = max_masks
        self.reset_stats()

    # --- stats ----------------------------------------------------------

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = 0            # evaluated-mask cache hits
            self.misses = 0          # evaluations performed
            self.program_compiles = 0
            self.fallbacks = 0       # per-eval Python-builder fallbacks
            self.dynamic_applies = 0  # epilogue copies (distinct/csi/..)

    def note_fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def note_dynamic(self) -> None:
        with self._lock:
            self.dynamic_applies += 1

    def hit_ratio(self) -> float:
        with self._lock:
            total = self.hits + self.misses + self.fallbacks
            return self.hits / total if total else 0.0

    def snapshot(self) -> Dict:
        with self._lock:
            total = self.hits + self.misses + self.fallbacks
            return {
                "hits": self.hits,
                "misses": self.misses,
                "fallbacks": self.fallbacks,
                "program_compiles": self.program_compiles,
                "dynamic_applies": self.dynamic_applies,
                "hit_ratio": round(self.hits / total, 4) if total else 0.0,
                "cached_programs": len(self._programs),
                "cached_masks": len(self._masks),
            }

    # --- programs -------------------------------------------------------

    def program_for(self, job, tg) -> Optional[MaskProgram]:
        """Compiled program for the (job, tg) tree, or None when the
        tree is uncompilable (the caller falls back to the Python
        builder per eval). The signature is computed first so equal
        trees share one compile — and one None, so fallback trees
        don't recompile either."""
        from nomad_tpu_torch.feasibility.compiler import program_signature

        sig = program_signature(job, tg)
        with self._lock:
            if sig in self._programs:
                self._programs.move_to_end(sig)
                return self._programs[sig]
        program = compile_program(job, tg)
        with self._lock:
            if sig not in self._programs:
                self._programs[sig] = program
                self.program_compiles += 1
                while len(self._programs) > self.max_programs:
                    self._programs.popitem(last=False)
            return self._programs[sig]

    # --- evaluated masks ------------------------------------------------

    def _mask_key(self, program: MaskProgram, cluster, usage) -> Tuple:
        if usage is not None and getattr(usage, "uid", ""):
            return (usage.uid, usage.structure_version, program.signature)
        return ("cluster-id", id(cluster), program.signature)

    def entry_for(self, program: MaskProgram, cluster, snapshot,
                  usage=None) -> MaskEntry:
        """Evaluated static mask for (program, node structure); cached.
        Misses evaluate OUTSIDE the lock (the regex/semver work), with
        a double-check so racing evals share the winner's entry."""
        key = self._mask_key(program, cluster, usage)
        identity_key = key[0] == "cluster-id"

        def valid(ent: Optional[MaskEntry]) -> bool:
            if ent is None:
                return False
            if identity_key and ent.cluster_ref is not cluster:
                return False
            return (ent.cluster_n == cluster.n_real
                    and len(ent.mask) == cluster.n_pad)

        with self._lock:
            got = self._masks.get(key)
            if valid(got):
                self._masks.move_to_end(key)
                self.hits += 1
                return got
        from nomad_tpu_torch.feasibility.runtime import evaluate_program

        entry = evaluate_program(program, cluster, snapshot, usage)
        if identity_key:
            entry.cluster_ref = cluster
        with self._lock:
            got = self._masks.get(key)
            if valid(got):
                self.hits += 1
                return got
            entry.mask = self._dedupe_locked(key, entry.mask)
            self._masks[key] = entry
            self.misses += 1
            while len(self._masks) > self.max_masks:
                self._masks.popitem(last=False)
            return entry

    # graft: frozen
    def _dedupe_locked(self, key: Tuple,
                       mask: np.ndarray) -> np.ndarray:
        """Canonicalize equal masks of one node structure onto one
        frozen array: identity is the wave launcher's sharing contract,
        so equal-but-distinct masks would stack the whole job-sharing
        group for nothing."""
        digest = (key[0], key[1], hash(mask.tobytes()))
        canon = self._canonical.get(digest)
        if canon is not None and np.array_equal(canon, mask):
            self._canonical.move_to_end(digest)
            return canon
        mask.setflags(write=False)
        self._canonical[digest] = mask
        while len(self._canonical) > self.max_masks:
            self._canonical.popitem(last=False)
        return mask


#: process-wide cache (the stack's compiled-mask path; exported via
#: telemetry/exporter.py and reset with telemetry.reset())
default_mask_cache = MaskProgramCache()
