"""Carrying state across from the reference package.

For a scheduler the cluster state (nodes, jobs, allocations, evals) and
the eval planes take the place of weights. These helpers read a
reference object's fields BY NAME (duck typing: no import of the
reference package) and build the port's own objects, so the same state
and planes can go through both implementations.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import fields
from typing import Optional

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


_REFERENCE_PACKAGE = "nomad_tpu"
_PORT_PACKAGE = "nomad_tpu_torch"


def _port_class(cls):
    """The port's class of the same module path and name as ``cls``, a
    class of the reference package."""
    mod = cls.__module__
    port_mod = importlib.import_module(
        _PORT_PACKAGE + mod[len(_REFERENCE_PACKAGE):])
    got = getattr(port_mod, cls.__qualname__, None)
    if got is None:
        raise TypeError(f"{mod}.{cls.__qualname__} has no counterpart in "
                        f"{port_mod.__name__}")
    return got


def _is_reference(cls) -> bool:
    mod = getattr(cls, "__module__", "") or ""
    return mod == _REFERENCE_PACKAGE or mod.startswith(
        _REFERENCE_PACKAGE + ".")


def structs_from_reference(obj, memo: Optional[dict] = None):
    """The port's copy of a reference object graph (nodes, jobs, allocs,
    evals, plans and whatever they hold).

    A dataclass instance of the reference package becomes an instance of
    the port's class of the same module and name, its attributes
    converted in turn; lists, tuples, dicts and sets are converted
    element by element; everything else (numbers, strings, numpy arrays)
    is kept. ``memo`` maps ``id()`` of a converted object to its copy, so
    an object reached twice (an alloc's ``job`` and the job itself) is
    one object in the copy too; pass the same dict across calls to keep
    that sharing between them."""
    if memo is None:
        memo = {}
    return _convert(obj, memo)


def _convert(obj, memo: dict):
    if obj is None or isinstance(obj, (bool, int, float, str, bytes,
                                       np.ndarray, np.generic)):
        return obj
    hit = memo.get(id(obj))
    if hit is not None:
        return hit[1]
    cls = type(obj)
    if isinstance(obj, list):
        out = []
        memo[id(obj)] = (obj, out)
        out.extend(_convert(x, memo) for x in obj)
        return out
    if isinstance(obj, dict):
        out = {}
        memo[id(obj)] = (obj, out)
        for k, v in obj.items():
            out[_convert(k, memo)] = _convert(v, memo)
        return out
    if isinstance(obj, (set, frozenset)):
        out = cls(_convert(x, memo) for x in obj)
        memo[id(obj)] = (obj, out)
        return out
    if isinstance(obj, tuple):
        items = [_convert(x, memo) for x in obj]
        out = cls(*items) if hasattr(obj, "_fields") else cls(items)
        memo[id(obj)] = (obj, out)
        return out
    if not _is_reference(cls):
        return obj
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot carry {cls.__module__}.{cls.__qualname__} "
                        "across: not a dataclass")
    port_cls = _port_class(cls)
    out = port_cls.__new__(port_cls)
    memo[id(obj)] = (obj, out)
    if hasattr(obj, "__dict__"):
        for name, value in vars(obj).items():
            object.__setattr__(out, name, _convert(value, memo))
    else:
        for f in fields(obj):
            object.__setattr__(out, f.name,
                               _convert(getattr(obj, f.name), memo))
    return out

