"""Minimal 5-field cron parser for periodic jobs.

Reference behavior: nomad/periodic.go uses gorhill/cronexpr; periodic
jobs declare ``cron`` specs (structs.go PeriodicConfig). Supported
syntax: ``* a,b a-b */n a-b/n`` per field (minute, hour, day-of-month,
month, day-of-week), plus the shorthands ``@hourly``/``@daily`` and the
non-standard ``@every <seconds>s`` used widely in tests.
"""

from __future__ import annotations

import calendar
import time
from typing import List, Optional, Set

_FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


def _parse_field(spec: str, lo: int, hi: int) -> Set[int]:
    values: Set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        for v in range(start, end + 1, step):
            if lo <= v <= hi:
                values.add(v)
    return values


class CronExpr:
    def __init__(self, spec: str) -> None:
        self.spec = spec.strip()
        self.every_s: Optional[float] = None
        if self.spec.startswith("@every"):
            # "@every 5s" / "@every 2m"
            arg = self.spec.split(None, 1)[1].strip()
            mult = 1.0
            if arg.endswith("ms"):
                mult, arg = 0.001, arg[:-2]
            elif arg.endswith("s"):
                arg = arg[:-1]
            elif arg.endswith("m"):
                mult, arg = 60.0, arg[:-1]
            elif arg.endswith("h"):
                mult, arg = 3600.0, arg[:-1]
            self.every_s = float(arg) * mult
            return
        aliases = {
            "@hourly": "0 * * * *",
            "@daily": "0 0 * * *",
            "@weekly": "0 0 * * 0",
            "@monthly": "0 0 1 * *",
        }
        spec = aliases.get(self.spec, self.spec)
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"cron spec must have 5 fields: {spec!r}")
        self.minutes, self.hours, self.doms, self.months, self.dows = (
            _parse_field(f, lo, hi)
            for f, (lo, hi) in zip(fields, _FIELD_RANGES)
        )

    def next_after(self, now: Optional[float] = None) -> float:
        """Epoch seconds of the next firing strictly after `now`."""
        now = time.time() if now is None else now
        if self.every_s is not None:
            return now + self.every_s
        t = time.localtime(now + 60 - (now % 60))   # next whole minute
        # bounded scan: four years of minutes is plenty
        for _ in range(366 * 4 * 24 * 60):
            if (
                t.tm_min in self.minutes
                and t.tm_hour in self.hours
                and t.tm_mday in self.doms
                and t.tm_mon in self.months
                and (t.tm_wday + 1) % 7 in self.dows
            ):
                return time.mktime(t)
            t = time.localtime(time.mktime(t) + 60)
        raise ValueError(f"cron spec {self.spec!r} never fires")
