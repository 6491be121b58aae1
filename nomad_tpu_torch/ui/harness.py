"""UI test harness: a deterministic fake cluster behind the REAL /v1.

Reference behavior: ui/mirage/config.js + factories — the Ember app's
dev/test backend fakes the API so UI flows are exercisable without a
cluster. This build can do one better: the dev agent IS an in-process
cluster, so the harness seeds it with deterministic jobs/nodes/allocs
and real running tasks, and UI tests drive the REAL HTTP surface the
SPA talks to. (The environment ships no JavaScript runtime, so tests
exercise the exact request/response contract each view consumes —
routes, shapes, field names — rather than evaluating the JS; the
SPA itself is a static module, ``ui/app.js``, servable standalone for
browser-based verification.)
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple


def seed_cluster(agent, n_service_jobs: int = 2,
                 task_output: str = "ui-harness-line",
                 timeout: float = 60.0) -> Dict:
    """Populate a dev agent with deterministic workloads and wait for
    them to run (the mirage/factories analog: known ids, known output).

    Returns {"jobs": [...], "allocs": [...]} of the seeded state.
    """
    import sys

    from nomad_tpu_torch import mock

    jobs = []
    for i in range(n_service_jobs):
        job = mock.simple_job(id=f"ui-seed-{i}")
        tg = job.task_groups[0]
        tg.count = 1
        task = tg.tasks[0]
        task.driver = "raw_exec"
        task.config = {
            "command": sys.executable,
            "args": ["-S", "-c",
                     f"import time\nprint({task_output!r}, flush=True)\n"
                     "time.sleep(600)\n"],
        }
        agent.server.job_register(job)
        jobs.append(job)

    deadline = time.time() + timeout
    allocs: List = []
    while time.time() < deadline:
        snap = agent.server.state.snapshot()
        allocs = [a for j in jobs
                  for a in snap.allocs_by_job(j.namespace, j.id)
                  if a.client_status == "running"]
        if len(allocs) >= n_service_jobs:
            break
        time.sleep(0.2)
    if len(allocs) < n_service_jobs:
        raise AssertionError("harness cluster never became ready")
    return {"jobs": jobs, "allocs": allocs}


class UIClient:
    """Drives the SPA's API contract over real HTTP — the same calls,
    in the same order, consuming the same fields the views do."""

    def __init__(self, base_url: str, token: str = "") -> None:
        self.base = base_url.rstrip("/")
        self.token = token

    def get(self, path: str):
        import json
        import urllib.request

        req = urllib.request.Request(self.base + path)
        if self.token:
            req.add_header("X-Nomad-Token", self.token)
        with urllib.request.urlopen(req, timeout=30) as r:
            body = r.read()
            ctype = r.headers.get("Content-Type", "")
            if "json" in ctype:
                return json.loads(body)
            return body

    # -- the click path a user takes (jobs -> job -> alloc -> logs) ----

    def click_jobs(self) -> List[Dict]:
        return self.get("/v1/jobs")

    def click_job(self, job_id: str) -> Dict:
        """viewJobDetail's fetch fan-out."""
        return {
            "job": self.get(f"/v1/job/{job_id}"),
            "summary": self.get(f"/v1/job/{job_id}/summary"),
            "allocs": self.get(f"/v1/job/{job_id}/allocations"),
            "evals": self.get(f"/v1/job/{job_id}/evaluations"),
        }

    def click_alloc(self, alloc_id: str) -> Dict:
        return self.get(f"/v1/allocation/{alloc_id}")

    def click_fs(self, alloc_id: str, path: str = "/") -> List[Dict]:
        from urllib.parse import quote

        return self.get(
            f"/v1/client/fs/ls/{alloc_id}?path={quote(path)}")

    def click_file(self, alloc_id: str, path: str) -> Dict:
        from urllib.parse import quote

        q = quote(path)
        st = self.get(f"/v1/client/fs/stat/{alloc_id}?path={q}")
        return self.get(
            f"/v1/client/fs/readat/{alloc_id}?path={q}"
            f"&offset=0&limit={st['Size']}")

    def click_logs(self, alloc_id: str, task: str,
                   logtype: str = "stdout") -> str:
        from urllib.parse import quote

        out = self.get(
            f"/v1/client/fs/logs/{alloc_id}"
            f"?task={quote(task)}&type={logtype}")
        return out.get("Data", "")


_REGEX_KEYWORDS = ("return", "typeof", "case", "in", "of", "new",
                   "delete", "void", "instanceof")


def _ends_with_keyword(src: str, pos: int) -> bool:
    """Does the code before ``pos`` end with a keyword after which a
    regex literal may start?"""
    head = src[:pos].rstrip()
    return any(
        head.endswith(k)
        and (len(head) == len(k) or not head[-len(k) - 1].isalnum())
        for k in _REGEX_KEYWORDS)


def lint_js(src: str) -> List[str]:
    """Structural JS lint: balanced (){}[] and properly terminated
    strings/template literals/comments (with ``${}`` nesting).

    Not a parser — but an unbalanced bracket or unterminated template
    literal is exactly the error class that bricks the WHOLE SPA (one
    syntax error aborts the module), and no JavaScript runtime ships
    in this environment to catch it. Returns a list of problems.
    """
    problems: List[str] = []
    stack: List[tuple] = []          # (char, line)
    # modes: code | squote | dquote | template | linecomment | comment
    # | regex | regexclass
    mode = "code"
    template_depth: List[int] = []   # brace depth at each ${ entry
    line = 1
    last_sig = ""                    # last significant code char
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        nxt = src[i + 1] if i + 1 < n else ""
        if c == "\n":
            line += 1
            if mode == "linecomment":
                mode = "code"
            elif mode in ("squote", "dquote"):
                problems.append(f"line {line - 1}: unterminated string")
                mode = "code"
            i += 1
            continue
        if mode == "linecomment":
            i += 1
            continue
        if mode == "comment":
            if c == "*" and nxt == "/":
                mode = "code"
                i += 2
                continue
            i += 1
            continue
        if mode in ("regex", "regexclass"):
            if c == "\\":
                i += 2
                continue
            if mode == "regex" and c == "[":
                mode = "regexclass"
            elif mode == "regexclass" and c == "]":
                mode = "regex"
            elif mode == "regex" and c == "/":
                mode = "code"
                last_sig = "/"
            i += 1
            continue
        if mode in ("squote", "dquote", "template"):
            if c == "\\":
                i += 2
                continue
            if mode == "squote" and c == "'":
                mode = "code"
            elif mode == "dquote" and c == '"':
                mode = "code"
            elif mode == "template":
                if c == "`":
                    mode = "code"
                elif c == "$" and nxt == "{":
                    template_depth.append(len(stack))
                    stack.append(("{", line))
                    mode = "code"
                    i += 2
                    continue
            i += 1
            continue
        # code mode
        if c == "/" and nxt == "/":
            mode = "linecomment"
            i += 2
            continue
        if c == "/" and nxt == "*":
            mode = "comment"
            i += 2
            continue
        if c == "/":
            # regex vs division: a regex can only FOLLOW an operator,
            # opener, separator, or keyword boundary (the standard
            # restricted-production heuristic)
            if last_sig == "" or last_sig in "(,=:[!&|?{};~^%*+-<>" \
                    or _ends_with_keyword(src, i):
                mode = "regex"
                i += 1
                continue
            last_sig = c
            i += 1
            continue
        if c == "'":
            mode = "squote"
        elif c == '"':
            mode = "dquote"
        elif c == "`":
            mode = "template"
        elif c in "({[":
            stack.append((c, line))
        elif c in ")}]":
            want = {")": "(", "}": "{", "]": "["}[c]
            if not stack or stack[-1][0] != want:
                problems.append(f"line {line}: unmatched '{c}'")
            else:
                stack.pop()
                if c == "}" and template_depth and \
                        len(stack) == template_depth[-1]:
                    template_depth.pop()
                    mode = "template"
        if not c.isspace():
            last_sig = c
        i += 1
    if mode == "template":
        problems.append("unterminated template literal at EOF")
    if mode == "comment":
        problems.append("unterminated block comment at EOF")
    for ch, ln in stack:
        problems.append(f"line {ln}: unclosed '{ch}'")
    return problems


#: SPA-referenced paths the static check cannot resolve: websocket
#: upgrades with dynamic construction, and templates whose FIRST
#: dynamic segment expands to literal route words (deployment
#: promote/pause/fail verbs)
_NON_GET = {"/v1/client/allocation/_/exec", "/v1/deployment/_"}


def referenced_api_paths(app_js: str) -> List[str]:
    """Every /v1 path literal the SPA references (the contract the
    route table must serve). Template expressions normalize to a
    placeholder segment."""
    paths = set()
    for m in re.finditer(r"/v1/[A-Za-z0-9_${}()./-]*", app_js):
        p = m.group(0)
        p = re.sub(r"\$\{[^}]*\}", "_", p)
        p = p.split("?")[0].rstrip("/.")
        if p and p != "/v1":
            paths.add(p)
    return sorted(paths)


def route_table_patterns(http_agent) -> List:
    return [(method, pattern) for method, pattern, _fn
            in http_agent._routes]


def extract_view_contract(app_js: str) -> Dict:
    """The machine-checked route -> endpoint -> field manifest embedded
    in app.js (between __VIEW_CONTRACT_START__/__VIEW_CONTRACT_END__).
    Raises if missing or not strict JSON — the contract IS the test
    surface, so a parse failure must fail loudly."""
    import json

    m = re.search(r"__VIEW_CONTRACT_START__\n(.*?)\n__VIEW_CONTRACT_END__",
                  app_js, re.S)
    if m is None:
        raise AssertionError("app.js has no __VIEW_CONTRACT__ block")
    return json.loads(m.group(1))


def function_field_accesses(app_js: str) -> Dict[str, List[str]]:
    """PascalCase member accesses per top-level function.

    API response fields are PascalCase while JS locals/methods are
    camelCase, so `.Foo` inside a view function is, by construction,
    a read of an API field — the set the view CONSUMES. The harness
    requires every one of them to be declared in the view contract,
    which in turn is walked against the live API: a view can therefore
    not read a field the API does not return without a test failing."""
    out: Dict[str, List[str]] = {}
    parts = re.split(r"(?=^(?:async )?function \w+)", app_js, flags=re.M)
    for p in parts:
        m = re.match(r"(?:async )?function (\w+)", p)
        if m is None:
            continue
        fields = sorted(set(re.findall(r"\.([A-Z][A-Za-z0-9]*)\b", p)))
        if fields:
            out[m.group(1)] = fields
    return out


def _path_field_names(paths, helpers=None) -> set:
    """Field NAMES a set of walk paths mention (expanding @helper
    refs) — the one segment parser both declaration checks share."""
    helpers = helpers or {}
    names: set = set()
    for path in paths:
        if path.startswith("@"):
            names |= _path_field_names(helpers.get(path[1:], ()), helpers)
            continue
        for seg in path.lstrip("?").split("."):
            seg = seg.replace("[]", "")
            if seg and seg != "*":
                names.add(seg)
    return names


def _contract_fields(contract: Dict, view: str) -> set:
    """Flat set of field NAMES a view's walk paths (plus its helpers')
    mention — the declared consumption set."""
    helpers = contract.get("helpers", {})
    spec = contract.get(view, {})
    names: set = set()
    for paths in spec.get("walk", {}).values():
        names |= _path_field_names(paths, helpers)
    return names


def resolve_path(data, path: str):
    """Walk one contract path; returns (ok, reason).

    DSL: "." descends dicts; a leading "[]" means the response is a
    list (first element is checked); "KEY[]" means KEY holds a list;
    "*" fans out over every dict value; a "?" prefix marks the field
    as omittable (absence passes, a non-dict parent still fails)."""
    optional = path.startswith("?")
    segs = path.lstrip("?").split(".")

    def walk(cur, i) -> Tuple[bool, str]:
        if i == len(segs):
            return True, ""
        seg = segs[i]
        if seg == "[]" or seg == "":
            if not isinstance(cur, list):
                return False, f"expected list at {'.'.join(segs[:i])!r}"
            if not cur:
                return optional, "empty list"
            return walk(cur[0], i + 1)
        if seg == "*":
            if not isinstance(cur, dict):
                return False, f"expected dict at {'.'.join(segs[:i])!r}"
            if not cur:
                return optional, "empty dict"
            for v in cur.values():
                ok, why = walk(v, i + 1)
                if not ok:
                    return ok, why
            return True, ""
        is_list = seg.endswith("[]")
        key = seg[:-2] if is_list else seg
        if not isinstance(cur, dict):
            return False, f"expected object before {key!r}"
        if key not in cur:
            return optional, f"missing field {key!r}"
        nxt = cur[key]
        if is_list:
            if nxt is None or not isinstance(nxt, list):
                return optional, f"{key!r} is not a list"
            if not nxt:
                return optional, f"{key!r} empty"
            nxt = nxt[0]
        elif nxt is None and i + 1 < len(segs):
            return optional, f"{key!r} is null"
        return walk(nxt, i + 1)

    return walk(data, 0)


def walk_view_contract(ui: "UIClient", contract: Dict,
                       params: Dict[str, str]) -> List[str]:
    """Fetch every view's endpoints against the REAL API and resolve
    every declared field path. Returns failures (empty = pass).

    ``params`` substitutes the {job}/{node}/{alloc}/... placeholders
    with ids from the seeded cluster; a view whose placeholder has no
    param is reported as unexercised (a missing seed is a harness bug,
    not a pass)."""
    from urllib.parse import quote

    helpers = contract.get("helpers", {})
    failures: List[str] = []
    for view, spec in contract.items():
        if view == "helpers":
            continue
        for key, path in spec.get("endpoints", {}).items():
            tmpl = path
            missing_param = None
            for ph in re.findall(r"\{(\w+)\}", path):
                if ph not in params:
                    missing_param = ph
                    break
                tmpl = tmpl.replace("{" + ph + "}",
                                    quote(str(params[ph]), safe=""))
            if missing_param is not None:
                failures.append(
                    f"{view}.{key}: no seed param {missing_param!r}")
                continue
            try:
                resp = ui.get(tmpl)
            except Exception as e:               # noqa: BLE001
                failures.append(f"{view}.{key}: GET {tmpl} -> {e}")
                continue
            paths = list(spec.get("walk", {}).get(key, ()))
            expanded: List[str] = []
            for p in paths:
                if p.startswith("@"):
                    expanded.extend(helpers.get(p[1:], ()))
                else:
                    expanded.append(p)
            for p in expanded:
                ok, why = resolve_path(resp, p)
                if not ok:
                    failures.append(f"{view}.{key}: {p} ({why})")
    return failures


def undeclared_field_reads(app_js: str) -> Dict[str, List[str]]:
    """view/helper function -> PascalCase reads NOT declared in its
    contract entry (merged with its "uses" helpers'). Non-empty means
    a renderer consumes an API field the walk never checks — the gap
    this harness exists to close."""
    contract = extract_view_contract(app_js)
    accesses = function_field_accesses(app_js)
    helpers = contract.get("helpers", {})

    out: Dict[str, List[str]] = {}
    for fn, fields in accesses.items():
        if fn in contract:
            allowed = _contract_fields(contract, fn)
            for h in contract[fn].get("uses", ()):
                allowed |= _path_field_names(helpers.get(h, ()), helpers)
        elif fn in helpers:
            allowed = _path_field_names(helpers.get(fn, ()), helpers)
        else:
            continue   # non-view plumbing (actions, router, streams)
        extra = [f for f in fields if f not in allowed]
        if extra:
            out[fn] = extra
    return out


def unrouted_paths(app_js: str, http_agent,
                   extra_ignored: Optional[set] = None) -> List[str]:
    """SPA-referenced paths with no registered route under ANY method —
    the breakage class this harness exists to catch (a renamed
    endpoint silently 404s in the UI)."""
    ignored = set(_NON_GET) | (extra_ignored or set())
    patterns = [p for _m, p in route_table_patterns(http_agent)]
    missing = []
    for path in referenced_api_paths(app_js):
        if any(path.startswith(ig) for ig in ignored):
            continue
        probe = path.replace("/_", "/xxxx")
        if not any(p.fullmatch(probe) or p.fullmatch(path)
                   for p in patterns):
            missing.append(path)
    return missing
