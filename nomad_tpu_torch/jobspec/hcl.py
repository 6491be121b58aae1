"""A from-scratch HCL2-subset reader.

Covers what jobspecs and ACL policies use (reference jobspec2/parse.go
feeds hashicorp/hcl2; this is an independent implementation of the
subset): nested blocks with string labels, `key = value` attributes,
strings (escapes), numbers, bools, null, lists, objects, heredocs
(<<EOF / <<-EOF), and #, //, /* */ comments. Interpolations (`${...}`)
are preserved as literal text; duration strings ("10s", "5m") are the
caller's concern.

The parse result is a Body: ``attrs`` dict + ``blocks`` list of
(type, labels, Body).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class HCLParseError(ValueError):
    def __init__(self, msg: str, line: int) -> None:
        super().__init__(f"line {line}: {msg}")
        self.line = line


@dataclass
class Call:
    """A function call expression, evaluated by jobspec/eval.py
    (reference jobspec2/functions.go stdlib)."""

    name: str
    args: List[Any]


@dataclass
class Body:
    attrs: Dict[str, Any] = field(default_factory=dict)
    blocks: List[Tuple[str, List[str], "Body"]] = field(default_factory=list)

    def get_blocks(self, btype: str) -> List[Tuple[List[str], "Body"]]:
        return [(labels, b) for t, labels, b in self.blocks if t == btype]

    def first_block(self, btype: str) -> Optional[Tuple[List[str], "Body"]]:
        found = self.get_blocks(btype)
        return found[0] if found else None


class _Lexer:
    def __init__(self, src: str) -> None:
        self.src = src
        self.pos = 0
        self.line = 1

    def error(self, msg: str) -> HCLParseError:
        return HCLParseError(msg, self.line)

    def _peek(self, ahead: int = 0) -> str:
        i = self.pos + ahead
        return self.src[i] if i < len(self.src) else ""

    def _advance(self) -> str:
        c = self.src[self.pos]
        self.pos += 1
        if c == "\n":
            self.line += 1
        return c

    def skip_space(self, newlines: bool = True) -> None:
        while self.pos < len(self.src):
            c = self._peek()
            if c in " \t\r" or (newlines and c == "\n"):
                self._advance()
            elif c == "#" or (c == "/" and self._peek(1) == "/"):
                while self.pos < len(self.src) and self._peek() != "\n":
                    self._advance()
            elif c == "/" and self._peek(1) == "*":
                self._advance(); self._advance()
                while self.pos < len(self.src) and not (
                    self._peek() == "*" and self._peek(1) == "/"
                ):
                    self._advance()
                if self.pos < len(self.src):
                    self._advance(); self._advance()
            else:
                return

    def at_end(self) -> bool:
        return self.pos >= len(self.src)

    def read_ident(self) -> str:
        start = self.pos
        while self.pos < len(self.src) and (
            self._peek().isalnum() or self._peek() in "_-."
        ):
            self._advance()
        if start == self.pos:
            raise self.error(f"expected identifier, got {self._peek()!r}")
        return self.src[start:self.pos]

    def read_string(self) -> str:
        quote = self._advance()  # "
        out = []
        while True:
            if self.at_end():
                raise self.error("unterminated string")
            c = self._advance()
            if c == quote:
                break
            if c == "\\":
                esc = self._advance()
                out.append({
                    "n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\",
                }.get(esc, "\\" + esc))
            else:
                out.append(c)
        return "".join(out)

    def read_heredoc(self) -> str:
        # at '<<'; optional '-'
        self._advance(); self._advance()
        indent = False
        if self._peek() == "-":
            indent = True
            self._advance()
        tag = self.read_ident()
        # consume to end of line
        while not self.at_end() and self._peek() != "\n":
            self._advance()
        if not self.at_end():
            self._advance()
        lines = []
        while True:
            if self.at_end():
                raise self.error(f"unterminated heredoc <<{tag}")
            start = self.pos
            while not self.at_end() and self._peek() != "\n":
                self._advance()
            line = self.src[start:self.pos]
            if not self.at_end():
                self._advance()
            if line.strip() == tag:
                break
            lines.append(line)
        if indent:
            strip = min(
                (len(l) - len(l.lstrip()) for l in lines if l.strip()),
                default=0,
            )
            lines = [l[strip:] for l in lines]
        return "\n".join(lines) + ("\n" if lines else "")

    def read_number(self):
        start = self.pos
        if self._peek() == "-":
            self._advance()
        while not self.at_end() and (self._peek().isdigit() or self._peek() == "."):
            self._advance()
        text = self.src[start:self.pos]
        # duration-ish suffix (5s, 10m): keep as string for the mapper
        if not self.at_end() and self._peek().isalpha():
            while not self.at_end() and self._peek().isalnum():
                self._advance()
            return self.src[start:self.pos]
        try:
            return float(text) if "." in text else int(text)
        except ValueError:
            raise self.error(f"bad number {text!r}")


def _parse_value(lx: _Lexer) -> Any:
    lx.skip_space()
    c = lx._peek()
    if c == '"':
        return lx.read_string()
    if c == "<" and lx._peek(1) == "<":
        return lx.read_heredoc()
    if c == "[":
        lx._advance()
        items = []
        while True:
            lx.skip_space()
            if lx._peek() == "]":
                lx._advance()
                return items
            items.append(_parse_value(lx))
            lx.skip_space()
            if lx._peek() == ",":
                lx._advance()
    if c == "{":
        lx._advance()
        obj: Dict[str, Any] = {}
        while True:
            lx.skip_space()
            if lx._peek() == "}":
                lx._advance()
                return obj
            if lx._peek() == '"':
                key = lx.read_string()
            else:
                key = lx.read_ident()
            lx.skip_space()
            if lx._peek() in "=:":
                lx._advance()
            obj[key] = _parse_value(lx)
            lx.skip_space()
            if lx._peek() == ",":
                lx._advance()
    if c.isdigit() or c == "-":
        return lx.read_number()
    ident = lx.read_ident()
    if ident == "true":
        return True
    if ident == "false":
        return False
    if ident == "null":
        return None
    lx.skip_space(newlines=False)
    if lx._peek() == "(":
        # function call: name(arg, ...) — evaluated by jobspec/eval.py
        lx._advance()
        args: List[Any] = []
        while True:
            lx.skip_space()
            if lx._peek() == ")":
                lx._advance()
                return Call(ident, args)
            args.append(_parse_value(lx))
            lx.skip_space()
            if lx._peek() == ",":
                lx._advance()
    # bare identifier: enum-ish value, or a var./local./iterator
    # reference the evaluator resolves against its scope
    return ident


def _parse_body(lx: _Lexer, terminator: str = "") -> Body:
    body = Body()
    while True:
        lx.skip_space()
        if lx.at_end():
            if terminator:
                raise lx.error(f"expected '{terminator}' before EOF")
            return body
        if terminator and lx._peek() == terminator:
            lx._advance()
            return body
        name = lx.read_ident() if lx._peek() != '"' else lx.read_string()
        lx.skip_space(newlines=False)
        c = lx._peek()
        if c == "=":
            lx._advance()
            body.attrs[name] = _parse_value(lx)
            continue
        # block: zero or more string labels, then {
        labels: List[str] = []
        while c == '"':
            labels.append(lx.read_string())
            lx.skip_space(newlines=False)
            c = lx._peek()
        if c != "{":
            raise lx.error(
                f"expected '=' or '{{' after {name!r}, got {c!r}"
            )
        lx._advance()
        body.blocks.append((name, labels, _parse_body(lx, "}")))


def parse(src: str) -> Body:
    lx = _Lexer(src)
    return _parse_body(lx)


def duration_s(v: Any, default: float = 0.0) -> float:
    """'30s' / '5m' / '1h30m' / 10 (seconds) -> seconds."""
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return float(v)
    import re

    total = 0.0
    matched = False
    for m in re.finditer(r"(\d+(?:\.\d+)?)(ms|s|m|h|d)", str(v)):
        matched = True
        total += float(m.group(1)) * {
            "ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
        }[m.group(2)]
    if not matched:
        try:
            return float(v)
        except (TypeError, ValueError):
            return default
    return total
