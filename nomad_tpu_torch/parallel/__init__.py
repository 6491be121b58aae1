"""Multi-device execution: device meshes and sharded placement.

Counterpart of ``nomad_tpu/parallel/__init__.py``. The reference scales
horizontally (SURVEY.md section 2.11): N servers x M workers process
evaluations concurrently (the data-parallel axis) and node-set scaling
is handled by class caching + candidate limiting (the "long context"
axis). The port maps both onto a 2D device mesh driven from one process:

- ``evals`` axis: independent evaluations batch together and split
  across devices (the worker-parallelism analog, dp).
- ``nodes`` axis: the cluster's node planes split across devices (the
  sequence-parallel analog, sp); global node selection merges each
  shard's winner and top-k (``parallel/mesh``'s collectives).
"""

from nomad_tpu_torch.parallel.mesh import AXIS_EVALS, AXIS_NODES, make_mesh
from nomad_tpu_torch.parallel.sharded import (
    batched_in_shardings,
    batched_out_shardings,
    make_place_batch,
    stack_kernel_ins,
)

__all__ = [
    "AXIS_EVALS",
    "AXIS_NODES",
    "make_mesh",
    "make_place_batch",
    "stack_kernel_ins",
    "batched_in_shardings",
    "batched_out_shardings",
]
