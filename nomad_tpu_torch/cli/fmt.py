"""Output formatting helpers for the CLI.

Reference behavior: the Go CLI renders aligned key=value rows and
column tables via helper/flatmap + mitchellh/columnize (used across
command/*.go, e.g. formatKV/formatList in command/helpers.go).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence


def format_kv(rows: Sequence[str]) -> str:
    """Align 'Key|Value' rows on the pipe, like formatKV."""
    pairs = [r.split("|", 1) for r in rows]
    width = max((len(p[0]) for p in pairs), default=0)
    out = []
    for p in pairs:
        if len(p) == 1:
            out.append(p[0])
        else:
            out.append(f"{p[0]:<{width}}  = {p[1]}")
    return "\n".join(out)


def format_list(rows: Sequence[str]) -> str:
    """Align pipe-separated columns, like formatList (columnize)."""
    if not rows:
        return ""
    table = [r.split("|") for r in rows]
    ncols = max(len(r) for r in table)
    widths = [0] * ncols
    for r in table:
        for i, cell in enumerate(r):
            widths[i] = max(widths[i], len(cell))
    lines = []
    for r in table:
        line = "  ".join(f"{cell:<{widths[i]}}" for i, cell in enumerate(r))
        lines.append(line.rstrip())
    return "\n".join(lines)


def short_id(full: Optional[str], length: int = 8) -> str:
    """First 8 chars of a UUID, like limit(id, shortId)."""
    return (full or "")[:length]


def format_time(unix_ns_or_s: Optional[float]) -> str:
    if not unix_ns_or_s:
        return "N/A"
    v = float(unix_ns_or_s)
    if v > 1e15:  # nanoseconds
        v /= 1e9
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(v))


def format_ago(unix_s: Optional[float]) -> str:
    if not unix_s:
        return "N/A"
    d = max(0.0, time.time() - float(unix_s))
    if d < 60:
        return f"{int(d)}s ago"
    if d < 3600:
        return f"{int(d // 60)}m{int(d % 60)}s ago"
    return f"{int(d // 3600)}h{int((d % 3600) // 60)}m ago"


def dict_rows(items: Iterable[Dict[str, Any]], cols: Sequence[str],
              header: Optional[Sequence[str]] = None) -> str:
    rows = ["|".join(header or cols)]
    for it in items:
        rows.append("|".join(str(it.get(c, "")) for c in cols))
    return format_list(rows)
