"""HCL2 evaluation: variables, locals, functions, interpolation,
dynamic blocks.

Reference behavior: jobspec2/parse.go:19-40 decodes jobspecs with full
HCL2 — `variable` blocks overridable from the CLI, `locals`, a cty
stdlib function table (functions.go:26), `${...}` interpolation with
expressions, and `dynamic` block expansion. This module evaluates the
Body tree hcl.py produces into plain values before struct mapping:

- ``variable "name" { default = ... }`` + caller overrides
- ``locals { k = expr }`` (may reference vars and other locals)
- dotted references ``var.x`` / ``local.y`` / ``<iterator>.value``
- function calls ``upper(var.x)`` (subset of the cty stdlib)
- string interpolation ``"${expr}"`` including arithmetic/comparison/
  ternary operators inside the interpolation
- ``dynamic "svc" { for_each = ...; labels = [...]; content {...} }``

Out of scope (documented divergence): for-expressions, splat
operators, and operators outside ``${...}`` interpolations.
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import re
from typing import Any, Dict, List, Optional

from nomad_tpu_torch.jobspec.hcl import Body, Call, HCLParseError, _Lexer, _parse_value


class EvalError(ValueError):
    pass


# -- function table (jobspec2/functions.go:26 cty stdlib subset) --------

def _format(fmt: str, *args: Any) -> str:
    # go-style verbs %s %d %v %f map onto %-formatting closely enough
    return re.sub(r"%v", "%s", fmt) % args


FUNCS: Dict[str, Any] = {
    "upper": lambda s: str(s).upper(),
    "lower": lambda s: str(s).lower(),
    "title": lambda s: str(s).title(),
    "trimspace": lambda s: str(s).strip(),
    "trimprefix": lambda s, p: str(s)[len(p):] if str(s).startswith(p) else str(s),
    "trimsuffix": lambda s, p: str(s)[:-len(p)] if p and str(s).endswith(p) else str(s),
    "replace": lambda s, old, new: str(s).replace(old, new),
    "split": lambda sep, s: str(s).split(sep),
    "join": lambda sep, xs: str(sep).join(str(x) for x in xs),
    "format": _format,
    "length": lambda x: len(x),
    "concat": lambda *xs: [v for x in xs for v in x],
    "contains": lambda xs, v: v in xs,
    "coalesce": lambda *xs: next((x for x in xs if x not in (None, "")), None),
    "min": min,
    "max": max,
    "abs": abs,
    "ceil": lambda x: int(math.ceil(x)),
    "floor": lambda x: int(math.floor(x)),
    "pow": lambda a, b: a ** b,
    "range": lambda *a: list(range(*(int(x) for x in a))),
    "element": lambda xs, i: xs[int(i) % len(xs)],
    "keys": lambda m: sorted(m.keys()),
    "values": lambda m: [m[k] for k in sorted(m.keys())],
    "lookup": lambda m, k, *d: m.get(k, d[0] if d else None),
    "merge": lambda *ms: {k: v for m in ms for k, v in m.items()},
    "flatten": lambda xs: [v for x in xs
                           for v in (x if isinstance(x, list) else [x])],
    "distinct": lambda xs: list(dict.fromkeys(xs)),
    "reverse": lambda xs: list(reversed(xs)),
    "sort": lambda xs: sorted(xs),
    "jsonencode": lambda x: json.dumps(x),
    "jsondecode": lambda s: json.loads(s),
    "base64encode": lambda s: base64.b64encode(str(s).encode()).decode(),
    "base64decode": lambda s: base64.b64decode(str(s)).decode(),
    "md5": lambda s: hashlib.md5(str(s).encode()).hexdigest(),
    "sha256": lambda s: hashlib.sha256(str(s).encode()).hexdigest(),
    "tostring": lambda x: str(x),
    "tonumber": lambda x: float(x) if "." in str(x) else int(x),
}

_INTERP_RE = re.compile(r"\$\{")

_REF_RE = re.compile(r"[A-Za-z_][\w-]*(\.[\w.-]+)*")


class Scope:
    def __init__(self, roots: Dict[str, Any]) -> None:
        self.roots = roots

    def child(self, extra: Dict[str, Any]) -> "Scope":
        merged = dict(self.roots)
        merged.update(extra)
        return Scope(merged)

    def resolve(self, path: str) -> Any:
        parts = path.split(".")
        if parts[0] not in self.roots:
            raise KeyError(path)
        cur: Any = self.roots[parts[0]]
        for p in parts[1:]:
            if isinstance(cur, dict):
                if p not in cur:
                    raise EvalError(f"unknown reference {path!r}")
                cur = cur[p]
            else:
                raise EvalError(f"cannot index {path!r}")
        return cur


def eval_value(v: Any, scope: Scope) -> Any:
    if isinstance(v, str):
        return _eval_string(v, scope)
    if isinstance(v, Call):
        fn = FUNCS.get(v.name)
        if fn is None:
            raise EvalError(f"unknown function {v.name!r}")
        return fn(*[eval_value(a, scope) for a in v.args])
    if isinstance(v, list):
        return [eval_value(x, scope) for x in v]
    if isinstance(v, dict):
        return {k: eval_value(x, scope) for k, x in v.items()}
    return v


def _eval_string(s: str, scope: Scope) -> Any:
    """Bare dotted reference or ${...} interpolation; plain strings
    pass through."""
    # bare reference: whole string is a resolvable dotted path
    if re.fullmatch(r"[A-Za-z_][\w-]*(\.[\w-]+)+", s):
        try:
            return scope.resolve(s)
        except KeyError:
            return s    # enum-ish bare ident ("system", "host", ...)
    if "${" not in s:
        return s
    # parts: (is_expr, value); a string that is exactly one ${expr}
    # keeps the expression's native type (HCL2 semantics)
    parts: List[tuple] = []
    i = 0
    while i < len(s):
        m = _INTERP_RE.search(s, i)
        if m is None:
            if s[i:]:
                parts.append((False, s[i:]))
            break
        if s[i:m.start()]:
            parts.append((False, s[i:m.start()]))
        # brace-match the expression
        depth = 1
        j = m.end()
        while j < len(s) and depth:
            if s[j] == "{":
                depth += 1
            elif s[j] == "}":
                depth -= 1
            j += 1
        if depth:
            raise EvalError(f"unterminated interpolation in {s!r}")
        expr = s[m.end():j - 1]
        root = expr.strip().split(".")[0].split("[")[0]
        if _REF_RE.fullmatch(expr.strip()) and root not in scope.roots:
            # a bare reference whose root is not a parse-time scope
            # (attr.*, node.*, env.*, meta.*, NOMAD_* and other
            # runtime env) stays literal for the scheduler/client to
            # resolve; only var./local./iterator roots evaluate here
            parts.append((False, "${" + expr + "}"))
        else:
            parts.append((True, eval_expr(expr, scope)))
        i = j
    if len(parts) == 1 and parts[0][0]:
        return parts[0][1]
    return "".join(v if not is_expr else _to_str(v)
                   for is_expr, v in parts)


def _to_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


# -- expression mini-parser for interpolations -------------------------
# precedence-climbing over: literals, refs, calls, unary !/-, binary
# arithmetic/comparison/logical, ternary ?:

_BINOPS = [
    ("||",), ("&&",), ("==", "!="), ("<=", ">=", "<", ">"),
    ("+", "-"), ("*", "/", "%"),
]


def eval_expr(text: str, scope: Scope) -> Any:
    p = _ExprParser(text, scope)
    try:
        v = p.parse_ternary()
    except EvalError:
        raise
    except Exception as e:   # noqa: BLE001 — IndexError/TypeError/...
        raise EvalError(f"error evaluating {text!r}: {e}")
    p.skip()
    if not p.at_end():
        raise EvalError(f"trailing input in expression {text!r}")
    return v


class _ExprParser:
    def __init__(self, text: str, scope: Scope) -> None:
        self.text = text
        self.pos = 0
        self.scope = scope
        # >0 while parsing a ternary branch the condition excluded:
        # the branch must still be consumed syntactically, but its
        # evaluation is suppressed (errors in dead branches are fine
        # — the HCL guard-then-index idiom depends on it)
        self.dead = 0

    def at_end(self) -> bool:
        return self.pos >= len(self.text)

    def skip(self) -> None:
        while not self.at_end() and self.text[self.pos] in " \t\r\n":
            self.pos += 1

    def _match(self, tok: str) -> bool:
        self.skip()
        if self.text.startswith(tok, self.pos):
            nxt = (self.text[self.pos + len(tok)]
                   if self.pos + len(tok) < len(self.text) else "")
            # don't split "<=" into "<" etc.
            if tok in ("<", ">", "=", "!") and nxt == "=":
                return False
            self.pos += len(tok)
            return True
        return False

    def _parse_dead(self, fn) -> Any:
        self.dead += 1
        try:
            return fn()
        finally:
            self.dead -= 1

    def parse_ternary(self) -> Any:
        cond = self.parse_binary(0)
        if self._match("?"):
            take_a = bool(cond) and not self.dead
            a = self.parse_ternary() if take_a \
                else self._parse_dead(self.parse_ternary)
            self.skip()
            if not self._match(":"):
                raise EvalError("expected ':' in ternary")
            b = self._parse_dead(self.parse_ternary) if take_a or self.dead \
                else self.parse_ternary()
            return a if take_a else b
        return cond

    def parse_binary(self, level: int) -> Any:
        if level >= len(_BINOPS):
            return self.parse_unary()
        left = self.parse_binary(level + 1)
        while True:
            matched = None
            for op in _BINOPS[level]:
                if self._match(op):
                    matched = op
                    break
            if matched is None:
                return left
            right = self.parse_binary(level + 1)
            left = None if self.dead else _apply(matched, left, right)

    def parse_unary(self) -> Any:
        self.skip()
        if self._match("!"):
            v = self.parse_unary()
            return None if self.dead else not v
        if not self.at_end() and self.text[self.pos] == "-" and not (
            self.pos + 1 < len(self.text) and self.text[self.pos + 1].isdigit()
        ):
            self.pos += 1
            v = self.parse_unary()
            return None if self.dead else -v
        return self.parse_primary()

    def parse_primary(self) -> Any:
        self.skip()
        if self._match("("):
            v = self.parse_ternary()
            self.skip()
            if not self._match(")"):
                raise EvalError("expected ')'")
            return v
        # reuse the HCL value lexer for literals/refs/calls
        was_quoted = not self.at_end() and self.text[self.pos] == '"'
        lx = _Lexer(self.text[self.pos:])
        try:
            raw = _parse_value(lx)
        except HCLParseError as e:
            raise EvalError(f"bad expression at {self.text[self.pos:]!r}: {e}")
        self.pos += lx.pos
        if self.dead:
            val = None
        else:
            val = eval_value(raw, self.scope)
            if not was_quoted and isinstance(val, str) \
                    and re.fullmatch(r"[A-Za-z_][\w-]*", val) and raw == val:
                # bare single ident inside an expression must resolve
                try:
                    return self.scope.resolve(val)
                except (KeyError, EvalError):
                    raise EvalError(f"unknown reference {val!r}")
        # indexing: a[0] / m["k"]
        while True:
            self.skip()
            if not self.at_end() and self.text[self.pos] == "[":
                self.pos += 1
                idx = self.parse_ternary()
                self.skip()
                if not self._match("]"):
                    raise EvalError("expected ']'")
                if not self.dead:
                    val = val[idx if isinstance(idx, str) else int(idx)]
            else:
                return val


def _apply(op: str, a: Any, b: Any) -> Any:
    if op == "||":
        return bool(a) or bool(b)
    if op == "&&":
        return bool(a) and bool(b)
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "%":
        return a % b
    if op == "/":
        return a / b
    raise EvalError(f"unknown operator {op}")


# -- body evaluation ----------------------------------------------------

def _convert_override(raw: Any, default: Any) -> Any:
    """-var/NOMAD_VAR_* values arrive as strings; coerce to the
    declared variable's type (jobspec2 converts via the cty type)."""
    if not isinstance(raw, str) or isinstance(default, str) \
            or default is None:
        return raw
    try:
        if isinstance(default, bool):
            return raw.lower() in ("1", "true", "yes")
        if isinstance(default, int):
            return int(raw)
        if isinstance(default, float):
            return float(raw)
        if isinstance(default, (list, dict)):
            return json.loads(raw)
    except (ValueError, json.JSONDecodeError) as e:
        raise EvalError(
            f"cannot convert override {raw!r} to the variable's "
            f"{type(default).__name__} type: {e}")
    return raw


def evaluate(body: Body, variables: Optional[Dict[str, Any]] = None,
             env_variables: Optional[Dict[str, Any]] = None) -> Body:
    """Collect variable/locals blocks, then return a new Body with all
    expressions evaluated and dynamic blocks expanded.

    ``variables`` are explicit overrides (-var): naming an undeclared
    variable errors. ``env_variables`` come from the environment
    (NOMAD_VAR_*): undeclared ones are silently ignored, matching the
    reference's env handling."""
    overrides = variables or {}
    env_over = env_variables or {}
    var_values: Dict[str, Any] = {}
    for labels, vb in body.get_blocks("variable"):
        name = labels[0] if labels else ""
        default = None
        if "default" in vb.attrs:
            default = eval_value(vb.attrs["default"], Scope({"var": {}}))
        if name in overrides:
            var_values[name] = _convert_override(overrides[name], default)
        elif name in env_over:
            var_values[name] = _convert_override(env_over[name], default)
        elif "default" in vb.attrs:
            var_values[name] = default
        else:
            raise EvalError(f"variable {name!r} has no value "
                            "(no default, no override)")
    unknown = set(overrides) - set(var_values)
    if unknown:
        raise EvalError(f"undeclared variables passed: {sorted(unknown)}")

    scope = Scope({"var": var_values, "local": {}})
    # locals may reference vars and earlier locals; fixpoint over a few
    # passes handles forward references, cycles error out
    pending = {}
    for _labels, lb in body.get_blocks("locals"):
        pending.update(lb.attrs)
    for _ in range(len(pending) + 1):
        progressed = False
        for k, v in list(pending.items()):
            try:
                scope.roots["local"][k] = eval_value(v, scope)
            except (EvalError, KeyError):
                continue
            del pending[k]
            progressed = True
        if not pending:
            break
        if not progressed:
            raise EvalError(
                f"unresolvable locals (cycle or unknown ref): "
                f"{sorted(pending)}")

    return _eval_body(body, scope, drop={"variable", "locals"})


def _eval_body(body: Body, scope: Scope, drop=frozenset()) -> Body:
    out = Body()
    for k, v in body.attrs.items():
        out.attrs[k] = eval_value(v, scope)
    for btype, labels, child in body.blocks:
        if btype in drop:
            continue
        if btype == "dynamic":
            out.blocks.extend(_expand_dynamic(labels, child, scope))
            continue
        out.blocks.append((
            btype,
            [str(eval_value(l, scope)) for l in labels],
            _eval_body(child, scope),
        ))
    return out


def _expand_dynamic(labels: List[str], spec: Body, scope: Scope):
    """dynamic "svc" { for_each = <coll>; iterator = it;
    labels = [...]; content { ... } } -> N concrete svc blocks."""
    btype = labels[0] if labels else ""
    coll = eval_value(spec.attrs.get("for_each", []), scope)
    iterator = spec.attrs.get("iterator", btype)
    content = spec.first_block("content")
    if content is None:
        raise EvalError(f"dynamic {btype!r} has no content block")
    label_exprs = spec.attrs.get("labels", [])
    items = (list(coll.items()) if isinstance(coll, dict)
             else list(enumerate(coll)))
    blocks = []
    for key, value in items:
        sub = scope.child({iterator: {"key": key, "value": value}})
        blabels = [str(eval_value(l, sub)) for l in label_exprs]
        blocks.append((btype, blabels, _eval_body(content[1], sub)))
    return blocks
