"""A small YAML reader for the dataset files, so the dataset path needs no
PyYAML.

It reads what EuRoC's ``sensor.yaml`` and the flat ``dataset_params.yaml``
hold: directive lines (``%YAML:1.0``, which PyYAML refuses, or ``%YAML
1.1``) and ``---``, ``key: value`` block mappings nested by indentation,
flow lists and mappings (``[a, b]``, ``{k: v}``) that may wrap across
lines, ``#`` comments, plain and quoted scalars. Plain scalars resolve as
PyYAML's ``safe_load`` resolves them (YAML 1.1: a float needs a dot, so
``1e-05`` stays a string; ``yes``/``on`` are booleans; ``~`` and an
empty value are None). Block sequences (``- item``), tags, anchors and
multi-line plain scalars raise.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)"
                  r"|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")


def _resolve(s: str) -> Any:
    """A plain scalar -> its YAML 1.1 value, as PyYAML's safe_load."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        return float("nan") if t.endswith("nan") else float(t)
    if _SEXAGESIMAL.match(s):
        raise NotImplementedError(f"yaml_lite: sexagesimal number {s!r}")
    return s


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """A quoted scalar starting at text[i] -> (value, index after it)."""
    q = text[i]
    out = []
    i += 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            nxt = text[i + 1]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "/": "/", "0": "\0"}.get(nxt, "\\" + nxt))
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError("yaml_lite: unterminated quoted scalar")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at the start or after a blank, not quoted)."""
    q, esc = None, False
    for i, c in enumerate(line):
        if esc:
            esc = False
        elif q == '"' and c == "\\":
            esc = True
        elif q:
            if c == q:
                q = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """A flow node starting at text[i] -> (value, index after it)."""
    while text[i] == " ":
        i += 1
    c = text[i]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items: List[Any] = []
        mapping = {}
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == close:
                return (items if c == "[" else mapping), i + 1
            if c == "[":
                v, i = _flow(text, i)
                items.append(v)
            else:
                k, i = _flow(text, i)
                while text[i] == " ":
                    i += 1
                if text[i] != ":":
                    raise ValueError(f"yaml_lite: expected ':' in {text!r}")
                v, i = _flow(text, i + 1)
                mapping[k] = v
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
            elif text[i] != close:
                raise ValueError(f"yaml_lite: bad flow collection {text!r}")
    if c in "'\"":
        return _quoted(text, i)
    if c in "!&*|>":
        raise NotImplementedError(f"yaml_lite: {c!r} nodes are not read")
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
            text[j] == ":" and text[j + 1:j + 2] in (" ", "")):
        j += 1
    return _resolve(text[i:j].strip()), j


def _scalar_or_flow(text: str) -> Any:
    v, i = _flow(text + " ", 0)
    if text[i:].strip():
        raise ValueError(f"yaml_lite: trailing text in {text!r}")
    return v


def _split_key(content: str) -> Tuple[Any, str]:
    if content[0] in "'\"":
        key, i = _quoted(content, 0)
    else:
        m = re.search(r":(?= |$)", content)
        if m is None:
            raise ValueError(f"yaml_lite: expected 'key: value', got "
                             f"{content!r}")
        key, i = _resolve(content[:m.start()].strip()), m.start()
    rest = content[i:].lstrip()
    if not rest.startswith(":"):
        raise ValueError(f"yaml_lite: expected ':' after the key in "
                         f"{content!r}")
    return key, rest[1:].strip()


def loads(text: str) -> Any:
    """Parse a document of the subset above."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        s = _strip_comment(raw.expandtabs()).rstrip()
        if not s.strip() or s.startswith("%") or s.strip() in ("---", "..."):
            continue
        if s.lstrip().startswith("- ") or s.strip() == "-":
            raise NotImplementedError("yaml_lite: block sequences are not "
                                      "read")
        lines.append((len(s) - len(s.lstrip()), s.strip()))

    def block(i: int, indent: int):
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            key, rest = _split_key(lines[i][1])
            i += 1
            if rest == "":
                if i < len(lines) and lines[i][0] > indent:
                    out[key], i = block(i, lines[i][0])
                else:
                    out[key] = None
                continue
            if rest[0] in "[{":
                # a flow collection may wrap: join lines until it closes
                while _depth(rest) > 0:
                    if i >= len(lines):
                        raise ValueError("yaml_lite: unclosed flow "
                                         "collection")
                    rest += " " + lines[i][1]
                    i += 1
            out[key] = _scalar_or_flow(rest)
        if i < len(lines) and lines[i][0] > indent:
            raise ValueError(f"yaml_lite: unexpected indentation at "
                             f"{lines[i][1]!r}")
        return out, i

    if not lines:
        return None
    value, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"yaml_lite: unexpected indentation at "
                         f"{lines[i][1]!r}")
    return value


def _depth(text: str) -> int:
    """Open brackets minus closed ones, outside quoted scalars."""
    d, q, esc = 0, None, False
    for c in text:
        if esc:
            esc = False
        elif q == '"' and c == "\\":
            esc = True
        elif q:
            q = None if c == q else q
        elif c in "'\"":
            q = c
        elif c in "[{":
            d += 1
        elif c in "]}":
            d -= 1
    return d


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
