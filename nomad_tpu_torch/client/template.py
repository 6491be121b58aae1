"""Task template rendering (the consul-template analog).

Reference behavior: client/allocrunner/taskrunner/template/template.go
runs embedded consul-template: templates interpolate Consul KV, Vault
secrets, env vars, and node metadata into files under the task dir,
re-render when upstream data changes, and fire the template's
``change_mode`` (restart/signal/noop) on re-render.

This engine implements a real subset of the Go text/template language
consul-template embeds — not just interpolation:

    {{ key "path" }}                    Consul KV lookup
    {{ keyOrDefault "path" "d" }}       Consul KV with fallback
    {{ secret "path" "field" }}         Vault KV field lookup
    {{ env "NAME" }} {{ meta "k" }} {{ node_attr "k" }}
    {{ ls "prefix" }}                   KV pairs under a prefix
    {{ service "name" }}                live service instances
    {{ if <pipe> }} … {{ else if }} … {{ else }} … {{ end }}
    {{ range <pipe> }} … {{ else }} … {{ end }}     (lists and maps)
    {{ range $i, $v := <pipe> }} … {{ end }}
    {{ with <pipe> }} … {{ end }}
    {{ $x := <pipe> }} and {{ $x }} / {{ $x.Field }}
    {{ .Field.Sub }} over the bound dot
    pipelines: {{ key "a" | toUpper }} (toUpper/toLower/trimSpace)

Missing-value semantics follow the engine's strict flag: in strict
mode a valueless key/secret/env/meta/node_attr raises MissingKeyError
(the reference blocks the task until the key appears); otherwise it
renders empty. Out of scope (documented): scratch, sprig's long
function tail, template-calling-template.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Tuple

_ACTION_RE = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.S)
_WORD_RE = re.compile(
    r"\"(?:[^\"\\]|\\.)*\"" r"|:=|\||,"
    r"|\$[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*"
    r"|\.(?:[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*)?"
    r"|-?\d+(?:\.\d+)?"
    r"|[A-Za-z_][A-Za-z0-9_]*"
)

#: functions reading sources that change under a running task
_LIVE_FUNCS = ("key", "keyOrDefault", "secret", "ls", "service")


class MissingKeyError(KeyError):
    """A template referenced a key that has no value and no default.
    The reference blocks the task until the key appears; callers map
    this to 'template not yet renderable'."""


class TemplateSyntaxError(ValueError):
    pass


class TemplateContext:
    """Data sources a render pulls from; any may be None (renders as
    empty, the consul-template missing-key default)."""

    def __init__(self, env: Optional[Dict[str, str]] = None,
                 meta: Optional[Dict[str, str]] = None,
                 node_attrs: Optional[Dict[str, str]] = None,
                 kv_get: Optional[Callable[[str], Optional[str]]] = None,
                 secret_get: Optional[Callable[[str], Optional[Dict]]] = None,
                 kv_ls: Optional[Callable[[str], List[Tuple[str, str]]]] = None,
                 services_get: Optional[Callable[[str], List[Dict]]] = None):
        self.env = env or {}
        self.meta = meta or {}
        self.node_attrs = node_attrs or {}
        self.kv_get = kv_get or (lambda k: None)
        self.secret_get = secret_get or (lambda p: None)
        self.kv_ls = kv_ls or (lambda p: [])
        self.services_get = services_get or (lambda n: [])


# ---------------------------------------------------------------------------
# parse: template text -> node tree
# ---------------------------------------------------------------------------
# nodes: ("text", s) | ("out", pipe) | ("assign", var, pipe)
#        ("if", [(pipe, body), ...], else_body)
#        ("range", ivar, vvar, pipe, body, else_body)
#        ("with", pipe, body, else_body)
# pipe:  [command, ...] — each command is a term list; the previous
#        command's value is appended as the final argument (Go rules)
# term:  ("str", s) | ("num", x) | ("var", name) | ("dot", [fields])
#        | ("fn", name)


def _lex_action(text: str) -> List[str]:
    words = _WORD_RE.findall(text)
    if "".join(words).replace(" ", "") != text.replace(" ", ""):
        # something in the action didn't lex (unbalanced quote, stray
        # operator): surface it rather than render garbage
        leftover = text
        for w in words:
            leftover = leftover.replace(w, "", 1)
        if leftover.strip():
            raise TemplateSyntaxError(
                f"cannot parse action {text!r} (near {leftover.strip()!r})")
    return words


def _parse_term(word: str):
    if word.startswith('"'):
        return ("str", word[1:-1].replace('\\"', '"').replace("\\\\", "\\"))
    if word.startswith("$"):
        name, _, fields = word[1:].partition(".")
        return ("var", name, fields.split(".") if fields else [])
    if word == ".":
        return ("dot", [])
    if word.startswith("."):
        return ("dot", word[1:].split("."))
    if re.fullmatch(r"-?\d+(?:\.\d+)?", word):
        return ("num", float(word) if "." in word else int(word))
    return ("fn", word)


def _parse_pipe(words: List[str]):
    if not words:
        raise TemplateSyntaxError("empty pipeline")
    commands, current = [], []
    for w in words:
        if w == "|":
            if not current:
                raise TemplateSyntaxError("empty pipeline stage")
            commands.append(current)
            current = []
        else:
            current.append(_parse_term(w))
    if not current:
        raise TemplateSyntaxError("pipeline ends with |")
    commands.append(current)
    return commands


def _parse(tmpl: str):
    """Parse into a body; raises TemplateSyntaxError on unbalanced
    blocks."""
    tokens: List[Tuple[str, str]] = []
    pos = 0
    trim_next = False
    for m in _ACTION_RE.finditer(tmpl):
        if m.start() > pos:
            text = tmpl[pos:m.start()]
            if trim_next:              # previous action ended with -}}
                text = text.lstrip()
            tokens.append(("text", text))
        trim_next = False
        if m.group(1) and tokens and tokens[-1][0] == "text":
            # {{- : Go trims the whitespace before the action
            tokens[-1] = ("text", tokens[-1][1].rstrip())
        tokens.append(("action", m.group(2)))
        pos = m.end()
        if m.group(3):
            trim_next = True
    if pos < len(tmpl):
        text = tmpl[pos:]
        if trim_next:
            text = text.lstrip()
        tokens.append(("text", text))

    def parse_body(i: int, terminators: Tuple[str, ...]):
        body = []
        while i < len(tokens):
            kind, val = tokens[i]
            if kind == "text":
                body.append(("text", val))
                i += 1
                continue
            words = _lex_action(val)
            head = words[0] if words else ""
            if head in terminators or (
                    head == "else" and "else" in terminators):
                return body, i
            if head == "if":
                branches, else_body = [], []
                cond = _parse_pipe(words[1:])
                inner, i = parse_body(i + 1, ("end", "else"))
                branches.append((cond, inner))
                while True:
                    w2 = _lex_action(tokens[i][1])
                    if w2[0] == "end":
                        break
                    if w2[:2] and w2[0] == "else" and len(w2) > 1 \
                            and w2[1] == "if":
                        cond = _parse_pipe(w2[2:])
                        inner, i = parse_body(i + 1, ("end", "else"))
                        branches.append((cond, inner))
                        continue
                    # plain else
                    else_body, i = parse_body(i + 1, ("end",))
                    break
                body.append(("if", branches, else_body))
                i += 1
                continue
            if head == "range":
                rest = words[1:]
                ivar = vvar = None
                # a leading $var is a loop-variable declaration ONLY
                # when followed by "," or ":=" — `{{ range $x }}` after
                # `{{ $x := service "a" }}` (valid Go text/template)
                # iterates the variable itself
                if rest and rest[0].startswith("$"):
                    if len(rest) > 2 and rest[1] == "," \
                            and rest[2].startswith("$"):
                        ivar, vvar = rest[0][1:], rest[2][1:]
                        rest = rest[3:]
                        if rest[:1] == [":="]:
                            rest = rest[1:]
                    elif rest[1:2] == [":="]:
                        vvar = rest[0][1:]
                        rest = rest[2:]
                pipe = _parse_pipe(rest)
                inner, i = parse_body(i + 1, ("end", "else"))
                else_body = []
                if _lex_action(tokens[i][1])[0] == "else":
                    else_body, i = parse_body(i + 1, ("end",))
                body.append(("range", ivar, vvar, pipe, inner, else_body))
                i += 1
                continue
            if head == "with":
                pipe = _parse_pipe(words[1:])
                inner, i = parse_body(i + 1, ("end", "else"))
                else_body = []
                if _lex_action(tokens[i][1])[0] == "else":
                    else_body, i = parse_body(i + 1, ("end",))
                body.append(("with", pipe, inner, else_body))
                i += 1
                continue
            if head.startswith("$") and words[1:2] == [":="]:
                body.append(("assign", head[1:], _parse_pipe(words[2:])))
                i += 1
                continue
            body.append(("out", _parse_pipe(words)))
            i += 1
        if terminators:
            raise TemplateSyntaxError(
                f"unterminated block (missing {'/'.join(terminators)})")
        return body, i

    body, _ = parse_body(0, ())
    return body


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------


class _Scope:
    def __init__(self, ctx: TemplateContext, strict: bool) -> None:
        self.ctx = ctx
        self.strict = strict
        self.vars: Dict[str, object] = {}
        self.dot: object = None


def _field(value, parts: List[str]):
    for p in parts:
        if value is None:
            return None
        if isinstance(value, dict):
            value = value.get(p)
        else:
            value = getattr(value, p, None)
    return value


def _truthy(v) -> bool:
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (str, list, tuple, dict)) and len(v) == 0:
        return False
    return True


#: function -> (min_args, max_args)
_ARITY = {
    "key": (1, 1), "keyOrDefault": (1, 2), "secret": (1, 2),
    "env": (1, 1), "meta": (1, 1), "node_attr": (1, 1),
    "ls": (1, 1), "service": (1, 1),
    "toUpper": (1, 1), "toLower": (1, 1), "trimSpace": (1, 1),
}


def _call(name: str, args: List, scope: _Scope):
    ctx = scope.ctx
    arity = _ARITY.get(name)
    if arity is None:
        raise TemplateSyntaxError(f"unknown function {name!r}")
    if not (arity[0] <= len(args) <= arity[1]):
        raise TemplateSyntaxError(
            f"{name} takes {arity[0]}"
            + (f"-{arity[1]}" if arity[1] != arity[0] else "")
            + f" argument(s), got {len(args)}")

    def need(val, what):
        if val is None:
            if scope.strict:
                raise MissingKeyError(f"{what} has no value")
            return ""
        return val

    if name == "key":
        return need(ctx.kv_get(str(args[0])), f'key "{args[0]}"')
    if name == "keyOrDefault":
        val = ctx.kv_get(str(args[0]))
        return val if val is not None else (args[1] if len(args) > 1 else "")
    if name == "secret":
        data = ctx.secret_get(str(args[0]))
        if len(args) > 1:
            val = None if data is None else data.get(str(args[1]))
            return need(val, f'secret "{args[0]}" field "{args[1]}"')
        if data is None and scope.strict:
            raise MissingKeyError(f'secret "{args[0]}" has no value')
        return data or {}
    if name == "env":
        return need(ctx.env.get(str(args[0])), f'env "{args[0]}"')
    if name == "meta":
        return need(ctx.meta.get(str(args[0])), f'meta "{args[0]}"')
    if name == "node_attr":
        return need(ctx.node_attrs.get(str(args[0])),
                    f'node_attr "{args[0]}"')
    if name == "ls":
        # consul-template ls: KeyPairs directly under the prefix
        # (path-boundary: "app" never matches "apple"), .Key relative
        out = []
        prefix = str(args[0]).rstrip("/")
        for k, v in ctx.kv_ls(prefix):
            if prefix:
                if not k.startswith(prefix + "/"):
                    continue
                rel = k[len(prefix) + 1:]
            else:
                rel = k
            if rel and "/" not in rel:
                out.append({"Key": rel, "Value": v})
        return out
    if name == "service":
        return ctx.services_get(str(args[0]))
    if name == "toUpper":
        return str(args[0]).upper()
    if name == "toLower":
        return str(args[0]).lower()
    if name == "trimSpace":
        return str(args[0]).strip()
    raise TemplateSyntaxError(f"unknown function {name!r}")


def _functions_used(tmpl: str) -> set:
    """Function names actually CALLED by the template (from the parsed
    tree, so names inside string literals never count). Unparsable
    templates fall back to a conservative raw-text scan."""
    used: set = set()

    def walk_pipe(pipe):
        for command in pipe:
            for term in command:
                if term[0] == "fn":
                    used.add(term[1])

    def walk(body):
        for node in body:
            kind = node[0]
            if kind == "out":
                walk_pipe(node[1])
            elif kind == "assign":
                walk_pipe(node[2])
            elif kind == "if":
                for cond, inner in node[1]:
                    walk_pipe(cond)
                    walk(inner)
                walk(node[2])
            elif kind == "with":
                walk_pipe(node[1])
                walk(node[2])
                walk(node[3])
            elif kind == "range":
                walk_pipe(node[3])
                walk(node[4])
                walk(node[5])

    try:
        walk(_parse(tmpl))
    except TemplateSyntaxError:
        for m in _ACTION_RE.finditer(tmpl):
            for fn in _ARITY:
                if re.search(rf"\b{fn}\b", m.group(2)):
                    used.add(fn)
    return used


def _eval_term(term, scope: _Scope):
    kind = term[0]
    if kind == "str" or kind == "num":
        return term[1]
    if kind == "var":
        if term[1] not in scope.vars:
            raise TemplateSyntaxError(f"undefined variable ${term[1]}")
        return _field(scope.vars[term[1]], term[2])
    if kind == "dot":
        return _field(scope.dot, term[1])
    raise TemplateSyntaxError(f"function {term[1]!r} used as argument")


def _eval_pipe(pipe, scope: _Scope):
    value = None
    for n, command in enumerate(pipe):
        head = command[0]
        rest = command[1:]
        args = [_eval_term(t, scope) for t in rest]
        if n > 0:
            args.append(value)
        if head[0] == "fn":
            value = _call(head[1], args, scope)
        else:
            if rest:
                raise TemplateSyntaxError("term does not take arguments")
            value = _eval_term(head, scope) if n == 0 else args[-1]
    return value


def _to_text(v) -> str:
    if v is None:
        return ""
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _exec(body, scope: _Scope, out: List[str]) -> None:
    for node in body:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "out":
            out.append(_to_text(_eval_pipe(node[1], scope)))
        elif kind == "assign":
            scope.vars[node[1]] = _eval_pipe(node[2], scope)
        elif kind == "if":
            _, branches, else_body = node
            for cond, inner in branches:
                if _truthy(_eval_pipe(cond, scope)):
                    _exec(inner, scope, out)
                    break
            else:
                _exec(else_body, scope, out)
        elif kind == "with":
            _, pipe, inner, else_body = node
            val = _eval_pipe(pipe, scope)
            if _truthy(val):
                saved = scope.dot
                scope.dot = val
                _exec(inner, scope, out)
                scope.dot = saved
            else:
                _exec(else_body, scope, out)
        elif kind == "range":
            _, ivar, vvar, pipe, inner, else_body = node
            val = _eval_pipe(pipe, scope)
            items: List[Tuple[object, object]]
            if isinstance(val, dict):
                items = sorted(val.items())
            elif isinstance(val, (list, tuple)):
                items = list(enumerate(val))
            elif val is None:
                items = []
            else:
                raise TemplateSyntaxError(
                    f"range over non-iterable {type(val).__name__}")
            if not items:
                _exec(else_body, scope, out)
                continue
            saved = scope.dot
            for k, v in items:
                if ivar is not None:
                    scope.vars[ivar] = k
                if vvar is not None:
                    scope.vars[vvar] = v
                scope.dot = v
                _exec(inner, scope, out)
            scope.dot = saved


def render(tmpl: str, ctx: TemplateContext, strict: bool = False) -> str:
    scope = _Scope(ctx, strict)
    out: List[str] = []
    _exec(_parse(tmpl), scope, out)
    return "".join(out)


def uses_live_data(tmpl: str) -> bool:
    """Does this template read sources that can change under a running
    task (KV/secrets/services)? Drives whether a change-watcher is
    needed. Classified on the parsed tree, so a KV key literally named
    "service" never counts."""
    return bool(_functions_used(tmpl) & set(_LIVE_FUNCS))


def uses_vault(tmpl: str) -> bool:
    """Does this template CALL the secret function? Requires the task
    to carry a vault block (its derived token authorizes the reads);
    a Consul key named "secret/db" does not count."""
    return "secret" in _functions_used(tmpl)


class TemplateWatcher:
    """Re-render on upstream change and fire change_mode.

    The reference's template manager subscribes to consul-template's
    watcher; here the Dev providers expose a monotonic KV index that a
    small poll loop checks (the blocking-query analog at poll
    granularity).
    """

    def __init__(self, poll_index: Callable[[], int],
                 rerender: Callable[[], bool],
                 on_change: Callable[[], None],
                 interval_s: float = 1.0) -> None:
        self.poll_index = poll_index
        self.rerender = rerender
        self.on_change = on_change
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._last = self.poll_index()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="template-watcher"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                idx = self.poll_index()
                if idx == self._last:
                    continue
                self._last = idx
                if self.rerender():
                    self.on_change()
            except Exception:                   # noqa: BLE001
                continue
