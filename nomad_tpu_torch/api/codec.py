"""JSON wire codec for the /v1 API.

Reference: the Go structs marshal directly to JSON with their exported
field names (api/ package mirrors nomad/structs). Here a generic
dataclass walker produces the same shape: snake_case fields become
PascalCase with Nomad's acronym conventions (id -> ID, cpu -> CPU,
mb -> MB, ...), `_s`/`_ns` duration suffixes map to the reference's
nanosecond fields, and numpy scalars degrade to Python numbers.

Decoding is tolerant: unknown keys are ignored (the reference's
jsonpb/mapstructure behavior), missing keys keep dataclass defaults.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, Type, get_args, get_origin

# snake token -> wire token (reference exported-name conventions)
_ACRONYMS = {
    "id": "ID",
    "cpu": "CPU",
    "mb": "MB",
    "mhz": "MHz",
    "ip": "IP",
    "cidr": "CIDR",
    "ttl": "TTL",
    "acl": "ACL",
    "csi": "CSI",
    "dns": "DNS",
    "tg": "TG",
    "gc": "GC",
    "url": "URL",
    "hcl": "HCL",
}


def wire_name(snake: str) -> str:
    """cpu_shares -> CPUShares, job_id -> JobID, memory_mb -> MemoryMB."""
    parts = snake.split("_")
    # duration fields: foo_s / foo_ns keep the suffix as-is capitalized
    out = []
    for p in parts:
        if not p:
            continue
        out.append(_ACRONYMS.get(p, p.capitalize()))
    return "".join(out)


def _is_dataclass_type(t) -> bool:
    return dataclasses.is_dataclass(t) and isinstance(t, type)


def encode(obj: Any) -> Any:
    """Struct tree -> plain JSON-able value."""
    import numpy as np

    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            # never serialize back-references / cached companions
            if f.name.startswith("_"):
                continue
            v = getattr(obj, f.name)
            out[wire_name(f.name)] = encode(v)
        return out
    if isinstance(obj, dict):
        return {str(k): encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [encode(v) for v in obj]
    # plain objects (e.g. __init__-style configs): walk __dict__
    if hasattr(obj, "__dict__"):
        return {
            wire_name(k): encode(v)
            for k, v in vars(obj).items()
            if not k.startswith("_")
        }
    return str(obj)


def _decode_value(value: Any, ftype) -> Any:
    if value is None:
        return None
    origin = get_origin(ftype)
    if origin is typing.Union:
        args = [a for a in get_args(ftype) if a is not type(None)]
        if len(args) == 1:
            return _decode_value(value, args[0])
        return value
    if _is_dataclass_type(ftype):
        return decode(value, ftype)
    if origin in (list, typing.List):
        (item_t,) = get_args(ftype) or (Any,)
        return [_decode_value(v, item_t) for v in value]
    if origin in (dict, typing.Dict):
        args = get_args(ftype)
        item_t = args[1] if len(args) == 2 else Any
        return {k: _decode_value(v, item_t) for k, v in value.items()}
    if ftype is float and isinstance(value, (int, float)):
        return float(value)
    if ftype is int and isinstance(value, (int, float)):
        return int(value)
    return value


def decode(data: Optional[Dict], cls: Type) -> Any:
    """Plain JSON dict -> dataclass instance (unknown keys ignored)."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {}
    by_wire = {wire_name(f.name): f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        f = by_wire.get(key)
        if f is None:
            continue
        kwargs[f.name] = _decode_value(value, hints.get(f.name, Any))
    return cls(**kwargs)
