"""Carrying state across from the reference package.

For a scheduler the cluster and eval planes take the place of weights.
These helpers read a reference object's fields BY NAME (duck typing: no
import of the reference package) from numpy arrays and build the port's
own objects, so the same planes can go through both implementations.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.ops.kernel import KernelIn
from nomad_tpu_torch.tensors.schema import (
    AskTensor,
    ClusterTensors,
    EvalTensors,
    SpreadTensor,
)


def _copy_dataclass(cls, src, **override):
    kwargs = {}
    for f in fields(cls):
        if f.name in override:
            kwargs[f.name] = override[f.name]
        elif hasattr(src, f.name):
            kwargs[f.name] = getattr(src, f.name)
    return cls(**kwargs)


def kernel_in_from_numpy(src, device: DeviceLike = None,
                         keep_numpy: bool = False) -> KernelIn:
    """A port ``KernelIn`` from any object with KernelIn's field names.

    ``keep_numpy=True`` keeps the leaves numpy (identity preserved where
    the dtype already matches), the form the wave launcher takes.
    Otherwise every leaf becomes a torch tensor on ``device`` (the card
    unless ``device="cpu"``)."""
    leaves = [np.asarray(getattr(src, name)) for name in KernelIn._fields]
    if keep_numpy:
        return KernelIn(*leaves)
    dev = resolve_device(device)
    return KernelIn(*[torch.from_numpy(np.array(x)).to(dev) for x in leaves])


def cluster_from_numpy(src) -> ClusterTensors:
    """A port ``ClusterTensors`` from a reference one's plane fields."""
    return _copy_dataclass(ClusterTensors, src)


def eval_from_numpy(src) -> EvalTensors:
    """A port ``EvalTensors`` (with its ask and spread stanzas) from a
    reference one's fields."""
    return _copy_dataclass(
        EvalTensors, src,
        ask=_copy_dataclass(AskTensor, src.ask),
        spreads=[_copy_dataclass(SpreadTensor, sp) for sp in src.spreads],
    )
