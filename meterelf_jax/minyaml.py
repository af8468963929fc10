"""A small YAML reader for camera parameter files, with no dependency.

It reads the subset of YAML that params files use and resolves scalars
the way PyYAML's ``safe_load`` does (YAML 1.1 rules):

- block mappings and block sequences (a sequence may sit at its parent
  key's indentation, and ``- key: value`` opens a mapping item);
- flow sequences ``[a, b]`` and flow mappings ``{a: 1}``, one level deep;
- decimal ints (``37``, ``-4``), floats (``-4.5``, ``1.0e+6``, ``.inf``),
  booleans (``true``, ``no``, ``On`` ...), nulls (``~``, ``null``),
  single- and double-quoted and plain strings;
- ``#`` comments and blank lines.

Anything else (anchors, aliases, tags, block scalars, several documents,
nested flow collections, tabs in indentation, octal/hex/sexagesimal
numbers) raises ``YamlError``.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple


class YamlError(ValueError):
    pass


_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
# YAML 1.1 ints and floats outside the subset (octal, hex, binary,
# sexagesimal): PyYAML would read them as numbers, so refuse them
_OTHER_NUMBER = re.compile(
    r"[-+]?(0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+"
    r"|[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
_INF = (".inf", ".Inf", ".INF")
_NAN = (".nan", ".NaN", ".NAN")


def _unquote(tok: str) -> str:
    if tok[0] == "'":
        if len(tok) < 2 or tok[-1] != "'":
            raise YamlError(f"unterminated string: {tok}")
        return tok[1:-1].replace("''", "'")
    if len(tok) < 2 or tok[-1] != '"':
        raise YamlError(f"unterminated string: {tok}")
    out, i, body = [], 0, tok[1:-1]
    esc = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0"}
    while i < len(body):
        c = body[i]
        if c == "\\":
            if i + 1 >= len(body) or body[i + 1] not in esc:
                raise YamlError(f"unsupported escape in {tok}")
            out.append(esc[body[i + 1]])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok[:1] in ("'", '"'):
        return _unquote(tok)
    if tok[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YamlError(f"unsupported YAML construct: {tok}")
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _OTHER_NUMBER.match(tok):
        raise YamlError(f"unsupported number form: {tok}")
    sign = -1.0 if tok[:1] == "-" else 1.0
    if tok.lstrip("+-") in _INF:
        return sign * float("inf")
    if tok in _NAN:
        return float("nan")
    if _FLOAT.match(tok) and any(ch.isdigit() for ch in tok):
        return float(tok.replace("_", ""))
    return tok


def _split_flow(body: str) -> List[str]:
    """Split the inside of a one-level flow collection at commas that
    are outside quotes."""
    parts, cur, quote = [], [], ""
    for c in body:
        if quote:
            cur.append(c)
            if c == quote:
                quote = ""
        elif c in ("'", '"'):
            quote = c
            cur.append(c)
        elif c in "[]{}":
            raise YamlError("nested flow collections are not supported")
        elif c == ",":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if quote:
        raise YamlError(f"unterminated string in [{body}]")
    parts.append("".join(cur))
    if parts and not parts[-1].strip():
        parts.pop()                     # trailing comma
    return parts


def _key_value(text: str) -> Tuple[Any, str] | None:
    """``key: rest`` -> (key, rest); None when text is not a mapping
    entry. The key may be quoted."""
    if text[:1] in ("'", '"'):
        end = text.find(text[0], 1)
        while text[0] == "'" and end != -1 and text[end + 1:end + 2] == "'":
            end = text.find("'", end + 2)
        if end == -1 or not re.match(r"\s*:(\s|$)", text[end + 1:]):
            return None
        rest = text[end + 1:].lstrip()[1:]
        return _unquote(text[:end + 1]), rest.strip()
    m = re.match(r"([^\s#'\"\[\]{},][^#]*?)\s*:(\s+|$)(.*)$", text)
    if not m:
        return None
    return _scalar(m.group(1)), m.group(3).strip()


def _value(text: str) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlError(f"unterminated flow sequence: {text}")
        return [_scalar(p) for p in _split_flow(text[1:-1])]
    if text.startswith("{"):
        if not text.endswith("}"):
            raise YamlError(f"unterminated flow mapping: {text}")
        out = {}
        for part in _split_flow(text[1:-1]):
            kv = _key_value(part.strip())
            if kv is None:
                raise YamlError(f"bad flow mapping entry: {part}")
            out[kv[0]] = _scalar(kv[1])
        return out
    return _scalar(text)


def _strip_comment(line: str) -> str:
    quote, i = "", 0
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1                        # skip the escaped char
            elif c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1                    # '' inside '...'
                else:
                    quote = ""
        elif c in ("'", '"') and (i == 0 or line[i - 1] in " \t:-[{,"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


class _Parser:
    def __init__(self, text: str) -> None:
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                raise YamlError("tabs are not allowed in indentation")
            if stripped in ("---", "...") or stripped.startswith("%"):
                raise YamlError(f"unsupported document marker: {stripped}")
            self.lines.append((len(body) - len(stripped), stripped))
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        indent, text = self.lines[0]
        if len(self.lines) == 1 and _key_value(text) is None \
                and not text.startswith("- ") and text != "-":
            self.i = 1
            return _value(text)
        out = self._block(indent)
        if self.i != len(self.lines):
            raise YamlError(f"unexpected indentation at: "
                            f"{self.lines[self.i][1]}")
        return out

    def _block(self, indent: int) -> Any:
        text = self.lines[self.i][1]
        if text == "-" or text.startswith("- "):
            return self._sequence(indent)
        return self._mapping(indent)

    def _nested(self, parent: int, allow_same_seq: bool) -> Any:
        """The value on the lines after a ``key:`` or ``-`` with nothing
        after it."""
        if self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind > parent:
                return self._block(ind)
            if allow_same_seq and ind == parent and (
                    text == "-" or text.startswith("- ")):
                return self._sequence(ind)
        return None

    def _mapping(self, indent: int, first: str | None = None) -> dict:
        out: dict = {}
        while self.i < len(self.lines) or first is not None:
            if first is not None:
                text, first = first, None
            else:
                ind, text = self.lines[self.i]
                if ind < indent:
                    break
                if ind > indent:
                    raise YamlError(f"unexpected indentation at: {text}")
                self.i += 1
            kv = _key_value(text)
            if kv is None:
                raise YamlError(f"expected 'key: value', got: {text}")
            key, rest = kv
            if key in out:
                raise YamlError(f"duplicate key: {key}")
            out[key] = (_value(rest) if rest
                        else self._nested(indent, allow_same_seq=True))
        return out

    def _sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YamlError(f"unexpected indentation at: {text}")
                break
            self.i += 1
            rest = text[1:].lstrip(" ")
            if not rest:
                out.append(self._nested(indent, allow_same_seq=False))
            elif rest.startswith("- "):
                raise YamlError("compact nested sequences are not supported")
            elif _key_value(rest) is not None and rest[:1] not in "[{":
                item_indent = indent + (len(text) - len(rest))
                out.append(self._mapping(item_indent, first=rest))
            else:
                out.append(_value(rest))
        return out


def safe_load(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    return _Parser(text).parse()
