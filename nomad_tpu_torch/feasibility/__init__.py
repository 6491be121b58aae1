"""The feasibility compiler: constraint trees -> cached mask programs.

The one scheduling stage that never left Python — the per-eval
``FeasibilityBuilder.base_mask`` walk over constraints, drivers,
volumes and distinct rules — compiled once per distinct constraint
tree and evaluated once per node structure:

- ``attr_planes``: interned node-attribute vocabulary (per-node code
  planes), advanced incrementally from the state store's node-change
  logs;
- ``compiler``: (job, tg) constraint trees -> ``MaskProgram`` IR,
  keyed by a structural signature so equal specs share one program;
- ``cache``: program + evaluated-mask LRUs keyed by the usage index's
  (uid, structure_version) generations, with content dedup so equal
  masks share one frozen array (the wave-sharing identity contract);
- ``runtime``: the evaluation engine (bit-identical to the Python
  builder by reusing its helpers) and the per-eval epilogue that
  replays metrics/eligibility and applies dynamic rules.

See docs/PERF.md (feasibility compiler) and docs/PARITY.md.
"""

from nomad_tpu_torch.feasibility.attr_planes import (  # noqa: F401
    AttrPlaneCache,
    AttrPlaneSet,
    default_attr_plane_cache,
)
from nomad_tpu_torch.feasibility.cache import (  # noqa: F401
    MaskEntry,
    MaskProgramCache,
    default_mask_cache,
)
from nomad_tpu_torch.feasibility.compiler import (  # noqa: F401
    MaskProgram,
    compile_program,
    program_signature,
)
from nomad_tpu_torch.feasibility.runtime import (  # noqa: F401
    apply_program,
    evaluate_program,
)

__all__ = [
    "AttrPlaneCache", "AttrPlaneSet", "default_attr_plane_cache",
    "MaskEntry", "MaskProgramCache", "default_mask_cache",
    "MaskProgram", "compile_program", "program_signature",
    "apply_program", "evaluate_program",
]
