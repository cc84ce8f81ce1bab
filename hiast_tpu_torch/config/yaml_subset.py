"""A reader of the YAML subset that the configs use, with no YAML package.

The card's machine has no ``yaml``, and the round driver reads ``sl_k.yaml``
and ``hiast_setting.yaml`` there, so the port reads its configs itself, on
every machine.  The subset:

- block mappings nested by indentation (spaces only);
- comments, whole-line and trailing (``#`` after a space);
- plain, single-quoted and double-quoted scalars;
- flow lists on one line, nested included (``[[768, 1536], [960, 1920]]``,
  ``[ 'MS', 'CCA' ]``);
- one optional ``---`` before the document.

Plain scalars resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1):
``true/True/yes/on`` and their negatives are bools, ``null``, ``~`` and an
empty value are None, ints may be octal, hex, binary or base 60, and a float
needs a dot, so ``3e-6`` stays the string ``'3e-6'`` (``ConfigNode`` casts it
against its float default, as it does for PyYAML's result).  Quoted scalars
are strings.  Anything else (anchors and aliases, tags, block scalars ``|``
and ``>``, block sequences, flow mappings, flow lists across lines, more
than one document, tabs, timestamps) raises ``ValueError`` naming the file
and line.
"""
from __future__ import annotations

import math
import re
from typing import Any

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_TIMESTAMP = re.compile(
    r"^(?:[0-9]{4}-[0-9]{2}-[0-9]{2}|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}"
    r"(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)$"
)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _to_int(text: str) -> int:
    """PyYAML's ``construct_yaml_int``."""
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * int(_sexagesimal(value))
    return sign * int(value)


def _to_float(text: str) -> float:
    """PyYAML's ``construct_yaml_float``."""
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value)
    return sign * float(value)


class _Line:
    """A cursor over one line of the file; ``fail`` raises with its place."""

    def __init__(self, path: str, number: int, text: str):
        self.path, self.number, self.text, self.pos = path, number, text, 0

    def fail(self, message: str):
        raise ValueError(f"{self.path}:{self.number}: {message} (outside the YAML subset the port reads)")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """True at the end of the line or at a trailing comment."""
        self.skip_spaces()
        return self.pos == len(self.text) or (self.peek() == "#" and self.text[self.pos - 1] == " ")

    def quoted(self) -> str:
        quote = self.text[self.pos]
        self.pos += 1
        out = []
        while True:
            ch = self.peek()
            if not ch:
                self.fail("a quoted scalar must end on its line")
            self.pos += 1
            if ch == quote:
                if quote == "'" and self.peek() == "'":  # '' is one quote
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if ch == "\\" and quote == '"':
                out.append(self._escape())
            else:
                out.append(ch)

    def _escape(self) -> str:
        code = self.peek()
        self.pos += 1
        if code in _ESCAPES:
            return _ESCAPES[code]
        if code in _HEX_ESCAPES:
            digits = self.text[self.pos:self.pos + _HEX_ESCAPES[code]]
            if not re.fullmatch(r"[0-9a-fA-F]+", digits) or len(digits) != _HEX_ESCAPES[code]:
                self.fail(f"bad escape \\{code}{digits}")
            self.pos += len(digits)
            return chr(int(digits, 16))
        self.fail(f"unknown escape \\{code}")

    def plain(self, flow: bool) -> str:
        """A plain scalar: up to a trailing comment or the line's end, and in a
        flow list also up to ``,`` or ``]``."""
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "#" and self.text[self.pos - 1] == " ":
                break
            after = self.text[self.pos + 1:self.pos + 2]
            if ch == ":" and (after in ("", " ") or (flow and after in ",[]{}")):
                self.fail("a mapping value where a scalar was expected")
            if flow and ch in ",[]{}":
                break
            self.pos += 1
        text = self.text[start:self.pos].rstrip(" ")
        if flow and not text:
            self.fail("an empty entry in a flow list")
        return text

    def scalar(self, flow: bool) -> Any:
        ch = self.peek()
        if ch in ("'", '"'):
            return self.quoted()
        if ch == "[":
            return self.flow_list()
        if ch in "{&*!|>%@`?#" or (ch == "-" and self.text[self.pos + 1:self.pos + 2] in ("", " ")):
            self.fail(f"{ch!r} starts a construct")
        return resolve(self.plain(flow), self)

    def flow_list(self) -> list:
        self.pos += 1  # '['
        items: list = []
        while True:
            self.skip_spaces()
            ch = self.peek()
            if not ch or ch == "#":
                self.fail("a flow list must close on its line")
            if ch == "]":
                self.pos += 1
                return items
            items.append(self.scalar(flow=True))
            self.skip_spaces()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != "]":
                self.fail("expected ',' or ']' in a flow list")


def resolve(text: str, line: _Line) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 resolver."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        line.fail(f"{text!r} resolves to a timestamp, merge or value key")
    return text


def parse(text: str, path: str = "<string>") -> Any:
    """The document in ``text``: a dict, or None when it holds nothing."""
    root: dict | None = None
    stack: list[tuple[int, dict]] = []  # (indent, mapping) of the open mappings
    pending: tuple[int, dict, Any] | None = None  # a key with no value yet
    seen_content = False
    for number, raw in enumerate(text.splitlines(), 1):
        line = _Line(path, number, raw)
        if "\t" in raw:
            line.fail("a tab")
        body = raw.lstrip(" ")
        if not body or body.startswith("#"):
            continue
        if body.rstrip(" ") == "---" or body.startswith("--- "):
            if seen_content or body.rstrip(" ") != "---":
                line.fail("more than one document, or content after '---'")
            seen_content = True
            continue
        if body.startswith("..."):
            line.fail("a document end marker")
        seen_content = True
        indent = len(raw) - len(body)
        line.pos = indent
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                p_map[p_key] = {}
                stack.append((indent, p_map[p_key]))
        if root is None:
            root = {}
            stack.append((indent, root))
        while stack and stack[-1][0] > indent:
            stack.pop()
        if not stack or stack[-1][0] != indent:
            line.fail("indentation that matches no open mapping")
        mapping = stack[-1][1]

        if line.peek() in ("'", '"'):
            key = line.quoted()
        else:
            key = _plain_key(line)
        line.skip_spaces()
        if line.peek() != ":":
            line.fail("expected 'key: value'")
        line.pos += 1
        if line.peek() not in ("", " "):
            line.fail("expected a space after ':'")
        if line.at_end():
            mapping[key] = None
            pending = (indent, mapping, key)
            continue
        mapping[key] = line.scalar(flow=False)
        if not line.at_end():
            line.fail("text after a value")
    return root


def _plain_key(line: _Line) -> Any:
    start = line.pos
    ch = line.peek()
    if ch in "[{&*!|>%@`?#" or (ch == "-" and line.text[line.pos + 1:line.pos + 2] in ("", " ")):
        line.fail(f"{ch!r} starts a construct")
    while line.pos < len(line.text):
        if line.text[line.pos] == ":" and line.text[line.pos + 1:line.pos + 2] in ("", " "):
            break
        if line.text[line.pos] == "#" and line.text[line.pos - 1] == " ":
            line.fail("a comment inside a key")
        line.pos += 1
    return resolve(line.text[start:line.pos].rstrip(" "), line)


def load(path: str) -> Any:
    """The document of the file at ``path`` (see ``parse``)."""
    with open(path, encoding="utf-8") as f:
        return parse(f.read(), path)
