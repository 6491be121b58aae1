"""Device meshes for the placement waves, and their collectives.

Counterpart of ``nomad_tpu/parallel/mesh.py``. Axis semantics:

- ``evals``: data parallelism over independent evaluations (the analog
  of Nomad's N-servers x M-workers horizontal scheduler parallelism,
  reference nomad/worker.go:386).
- ``nodes``: the cluster node axis split over the devices (the analog of
  the node table that reference scheduler/feasible.go iterates; here a
  tensor axis split across the cards).

One process drives the whole mesh, as the JAX package's does: a mesh is
a grid of ``torch.device`` entries, and a sharded leaf is a tuple of
per-position tensors (``parallel/sharded.place``). The same device may
stand at several positions: a *virtual* mesh, the counterpart of the
eight virtual CPU devices the JAX tests run on (the tests pass
``devices=[cpu] * 8``). ``available_devices`` gives every card on the
card, and the one CPU on the CPU.

The reference's collectives over the ``nodes`` axis are the few
functions at the end of this module, over a list of per-shard tensors:
``all_gather`` stacks the partials on the first shard's device (the
reference's ``pmax``/``pmin`` cascade then reduces that one gather,
``parallel/sharded._merge_best``), ``psum`` sums them there, and
``broadcast`` sends a result back to each shard with ``.to()``. Nothing
is read to the host. A multi-process backend would replace these
functions and nothing else.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nomad_tpu_torch.device import DeviceLike, resolve_device

AXIS_EVALS = "evals"   # dp axis
AXIS_NODES = "nodes"   # sp/long-context axis


def _normalize(device) -> torch.device:
    """``cuda`` without an index names the current card, as a tensor
    placed there reports it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes (``evals``, ``nodes``, or
    ``nodes`` alone). ``devices`` is the numpy grid of ``torch.device``
    entries, ``shape`` maps each axis name to its size. A mesh hashes
    and compares by identity, so caches keyed by it (weakly) never hand
    one mesh's entries to another; ``key`` is its value, for callers
    that ask whether two meshes name the same placement."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            grid[idx] = _normalize(src[idx])
        names = tuple(axis_names)
        if grid.ndim != len(names):
            raise ValueError(f"a {grid.ndim}-d device grid needs "
                             f"{grid.ndim} axis names, got {names}")
        if any(a not in (AXIS_EVALS, AXIS_NODES) for a in names) or len(
                set(names)) != len(names):
            raise ValueError(f"axis names {names} are not ({AXIS_EVALS!r}, "
                             f"{AXIS_NODES!r}) or a subset")
        self.devices = grid
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, grid.shape))
        self.size = int(grid.size)

    @property
    def key(self) -> tuple:
        return (self.axis_names, tuple(self.devices.flat))

    def axis_size(self, axis: str) -> int:
        """Size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def node_rows(self) -> List[List[int]]:
        """Flat positions (row-major over ``devices``) of each evals row,
        in nodes-axis order: the shards of one node-axis split."""
        pos = np.arange(self.size).reshape(self.devices.shape)
        if self.axis_names[0] == AXIS_NODES:
            pos = pos.T if pos.ndim == 2 else pos[None]
        elif pos.ndim == 1:
            pos = pos[:, None]       # evals only: one shard per row
        return [list(map(int, row)) for row in pos]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def mesh_match(a: Optional[Mesh], b: Optional[Mesh]) -> bool:
    """Whether two mesh handles name the same placement (None = one
    device): the same object, or the same axes over the same devices."""
    if a is None or b is None:
        return a is None and b is None
    return a is b or a.key == b.key


def available_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices a mesh may span: every card on the card (the card
    unless the caller asks for the CPU), the one CPU on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    n_devices: Optional[int] = None,
    evals_parallel: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device: DeviceLike = None,
) -> Mesh:
    """Build a 2D (evals, nodes) mesh over the available devices
    (``devices``, else ``available_devices(device)``).

    ``evals_parallel`` fixes the dp-axis size; by default it is 2 when
    the device count is even and >=4 (so both axes are exercised) and
    1 otherwise.
    """
    devs = list(devices if devices is not None
                else available_devices(device))
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    devs = devs[:n]
    if evals_parallel is None:
        evals_parallel = 2 if (n % 2 == 0 and n >= 4) else 1
    if n % evals_parallel != 0:
        raise ValueError(f"{n} devices not divisible by evals axis {evals_parallel}")
    nodes_parallel = n // evals_parallel
    grid = np.empty((evals_parallel, nodes_parallel), dtype=object)
    for i, d in enumerate(devs):
        grid[i // nodes_parallel, i % nodes_parallel] = d
    return Mesh(grid, (AXIS_EVALS, AXIS_NODES))


# ---------------------------------------------------------------------------
# Collectives over the shards of one node-axis split. Each takes the
# shards' partials in shard order; the result lies on the first shard's
# device (``broadcast`` hands it to every shard).
# ---------------------------------------------------------------------------

def all_gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The partials stacked in shard order, [D, ...], on the first
    shard's device."""
    root = parts[0].device
    return torch.stack([p if p.device == root else p.to(root)
                        for p in parts])


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Exact for integer partials: the sum keeps their dtype."""
    stacked = all_gather(parts)
    return stacked.sum(dim=0, dtype=stacked.dtype)


def broadcast(x: torch.Tensor,
              devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on each shard's device, one copy per distinct device (shards
    that share a device share the copy; callers only read it)."""
    copies = {x.device: x}
    out = []
    for d in devices:
        got = copies.get(d)
        if got is None:
            got = copies[d] = x.to(d)
        out.append(got)
    return out
