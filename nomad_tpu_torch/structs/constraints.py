"""Constraints, affinities, spreads and their host-side evaluation.

Reference behavior: nomad/structs/structs.go Constraint (:8581),
Affinity (:8701), Spread/SpreadTarget (:8787); operand evaluation in
scheduler/feasible.go resolveTarget (:770 area) and checkConstraint (:806).

These evaluations are inherently ragged (regex, version parses, string
compares), so they run host-side and are memoized per computed node class
(the eligibility-cache idea, feasible.go:1050); the results feed the device
kernel as boolean mask planes.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Tuple

from nomad_tpu_torch.structs.consts import (
    CONSTRAINT_ATTRIBUTE_IS_NOT_SET,
    CONSTRAINT_ATTRIBUTE_IS_SET,
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
    CONSTRAINT_REGEX,
    CONSTRAINT_SEMVER,
    CONSTRAINT_SET_CONTAINS,
    CONSTRAINT_SET_CONTAINS_ALL,
    CONSTRAINT_SET_CONTAINS_ANY,
    CONSTRAINT_VERSION,
)


@dataclass
class Constraint:
    """A hard placement constraint (structs.go:8581)."""

    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="

    def copy(self) -> "Constraint":
        return dataclasses.replace(self)

    def __str__(self) -> str:
        return f"{self.ltarget} {self.operand} {self.rtarget}"


@dataclass
class Affinity:
    """A soft placement preference with weight in [-100, 100] (structs.go:8701)."""

    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="
    weight: int = 50

    def copy(self) -> "Affinity":
        return dataclasses.replace(self)


@dataclass
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass
class Spread:
    """Spread allocations over an attribute's values (structs.go:8787)."""

    attribute: str = ""
    weight: int = 50
    spread_target: List[SpreadTarget] = field(default_factory=list)

    def copy(self) -> "Spread":
        return dataclasses.replace(
            self, spread_target=[dataclasses.replace(t) for t in self.spread_target]
        )


# ---------------------------------------------------------------------------
# Target resolution (feasible.go resolveTarget)
# ---------------------------------------------------------------------------


def resolve_target(target: str, node) -> Tuple[Optional[str], bool]:
    """Resolve an interpolated target like ``${attr.kernel.name}`` on a node."""
    if target == "${node.unique.id}":
        return node.id, True
    if target == "${node.datacenter}":
        return node.datacenter, True
    if target == "${node.unique.name}":
        return node.name, True
    if target == "${node.class}":
        return node.node_class, True
    if target.startswith("${attr."):
        attr = target[len("${attr."):].rstrip("}")
        val = node.attributes.get(attr)
        return (str(val), True) if val is not None else (None, False)
    if target.startswith("${meta."):
        meta = target[len("${meta."):].rstrip("}")
        val = node.meta.get(meta)
        return (str(val), True) if val is not None else (None, False)
    # Literal (RTarget values are usually literals)
    return target, True


# ---------------------------------------------------------------------------
# Version parsing (hashicorp/go-version behavior subset)
# ---------------------------------------------------------------------------


_VERSION_RE = re.compile(
    r"^v?(\d+(?:\.\d+)*)(?:-([0-9A-Za-z.-]+))?(?:\+[0-9A-Za-z.-]+)?$"
)


@lru_cache(maxsize=4096)
def parse_version(s: str) -> Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """Parse into (numeric segments padded to 3, prerelease ids) or None."""
    m = _VERSION_RE.match(s.strip())
    if not m:
        return None
    nums = tuple(int(x) for x in m.group(1).split("."))
    nums = (nums + (0, 0, 0))[:max(3, len(nums))]
    pre = tuple(m.group(2).split(".")) if m.group(2) else ()
    return nums, pre


def _cmp_version(a, b) -> int:
    an, ap = a
    bn, bp = b
    # Pad numeric segments to equal length
    ln = max(len(an), len(bn))
    an = an + (0,) * (ln - len(an))
    bn = bn + (0,) * (ln - len(bn))
    if an != bn:
        return -1 if an < bn else 1
    # A version without prerelease sorts AFTER one with (1.0.0 > 1.0.0-beta)
    if ap == bp:
        return 0
    if not ap:
        return 1
    if not bp:
        return -1
    for x, y in zip(ap, bp):
        xn, yn = x.isdigit(), y.isdigit()
        if xn and yn:
            xi, yi = int(x), int(y)
            if xi != yi:
                return -1 if xi < yi else 1
        elif xn != yn:
            return -1 if xn else 1  # numeric ids sort before alpha
        elif x != y:
            return -1 if x < y else 1
    return -1 if len(ap) < len(bp) else (1 if len(ap) > len(bp) else 0)


@lru_cache(maxsize=4096)
def _parse_version_constraints(spec: str) -> Optional[Tuple[Tuple[str, str], ...]]:
    """Parse a constraint set like ``>= 1.2, < 2.0`` or ``~> 1.2.3``."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^(>=|<=|!=|~>|=|>|<)?\s*(.+)$", part)
        if not m:
            return None
        op = m.group(1) or "="
        out.append((op, m.group(2).strip()))
    return tuple(out)


def check_version_constraint(version_str: str, spec: str, semver: bool = False) -> bool:
    """Does ``version_str`` satisfy constraint set ``spec``?

    Mirrors feasible.go checkVersionMatch. ``semver=True`` treats
    prereleases per semver (a prerelease only satisfies explicit-equal).
    """
    v = parse_version(str(version_str))
    if v is None:
        return False
    constraints = _parse_version_constraints(spec)
    if not constraints:
        return False
    for op, rhs in constraints:
        rv = parse_version(rhs)
        if rv is None:
            return False
        if semver and v[1] and not rv[1]:
            # semver: prerelease versions don't satisfy non-prerelease ranges
            return False
        c = _cmp_version(v, rv)
        if op == "=" and c != 0:
            return False
        if op == "!=" and c == 0:
            return False
        if op == ">" and c <= 0:
            return False
        if op == ">=" and c < 0:
            return False
        if op == "<" and c >= 0:
            return False
        if op == "<=" and c > 0:
            return False
        if op == "~>":
            # pessimistic: >= rhs AND < next significant segment bump.
            # Significance = number of numeric segments actually written in
            # the rhs (from the parsed numeric group, not string sniffing,
            # so "v1.2.3" / "1.2.3+build" parse correctly).
            if c < 0:
                return False
            m = _VERSION_RE.match(rhs.strip())
            written = len(m.group(1).split(".")) if m else 2
            rhs_nums = rv[0]
            sig = max(2, min(written, len(rhs_nums)))
            upper = list(rhs_nums[: sig - 1])
            upper[-1] += 1
            uv = (tuple(upper), ())
            if _cmp_version(v, uv) >= 0:
                return False
    return True


@lru_cache(maxsize=1024)
def _compiled_regex(pattern: str):
    try:
        return re.compile(pattern)
    except re.error:
        return None


# ---------------------------------------------------------------------------
# Operand evaluation (feasible.go:806 checkConstraint)
# ---------------------------------------------------------------------------


def check_lexical_order(op: str, lval: str, rval: str) -> bool:
    if op == "<":
        return lval < rval
    if op == "<=":
        return lval <= rval
    if op == ">":
        return lval > rval
    if op == ">=":
        return lval >= rval
    return False


def check_set_contains_all(lval: str, rval: str) -> bool:
    have = {x.strip() for x in str(lval).split(",")}
    return all(x.strip() in have for x in str(rval).split(","))


def check_set_contains_any(lval: str, rval: str) -> bool:
    have = {x.strip() for x in str(lval).split(",")}
    return any(x.strip() in have for x in str(rval).split(","))


def check_constraint(operand: str, lval, rval, lfound: bool, rfound: bool) -> bool:
    """Evaluate one constraint operand (feasible.go:806).

    distinct_hosts / distinct_property pass here -- they are enforced by
    dedicated iterators (feasible.go:526,625 -> our scheduler.feasible).
    """
    if operand in (CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY):
        return True
    if operand in ("=", "==", "is"):
        return lfound and rfound and str(lval) == str(rval)
    if operand in ("!=", "not"):
        # Go: !reflect.DeepEqual(lVal, rVal) -- nil vs nil is equal,
        # nil vs value is not equal (feasible.go:823).
        if not lfound and not rfound:
            return False
        if lfound != rfound:
            return True
        return str(lval) != str(rval)
    if operand in ("<", "<=", ">", ">="):
        return lfound and rfound and check_lexical_order(operand, str(lval), str(rval))
    if operand == CONSTRAINT_ATTRIBUTE_IS_SET:
        return lfound
    if operand == CONSTRAINT_ATTRIBUTE_IS_NOT_SET:
        return not lfound
    if operand == CONSTRAINT_VERSION:
        return lfound and rfound and check_version_constraint(str(lval), str(rval), semver=False)
    if operand == CONSTRAINT_SEMVER:
        return lfound and rfound and check_version_constraint(str(lval), str(rval), semver=True)
    if operand == CONSTRAINT_REGEX:
        if not (lfound and rfound):
            return False
        pat = _compiled_regex(str(rval))
        return pat is not None and pat.search(str(lval)) is not None
    if operand in (CONSTRAINT_SET_CONTAINS, CONSTRAINT_SET_CONTAINS_ALL):
        return lfound and rfound and check_set_contains_all(lval, rval)
    if operand == CONSTRAINT_SET_CONTAINS_ANY:
        return lfound and rfound and check_set_contains_any(lval, rval)
    return False


def check_affinity(operand: str, lval, rval, lfound: bool, rfound: bool) -> bool:
    """Affinity matching delegates to constraint matching (feasible.go:846)."""
    return check_constraint(operand, lval, rval, lfound, rfound)


def matches_affinity(affinity: Affinity, node) -> bool:
    lval, lok = resolve_target(affinity.ltarget, node)
    rval, rok = resolve_target(affinity.rtarget, node)
    return check_affinity(affinity.operand, lval, rval, lok, rok)


def node_meets_constraints(node, constraints: List[Constraint]) -> bool:
    """All-of check used by the host-side ConstraintChecker (feasible.go:730)."""
    for c in constraints:
        lval, lok = resolve_target(c.ltarget, node)
        rval, rok = resolve_target(c.rtarget, node)
        if not check_constraint(c.operand, lval, rval, lok, rok):
            return False
    return True
