"""A reader of the YAML subset the configs under ``configs/`` are written in,
in place of ``yaml.safe_load`` (the card's machine has no PyYAML).

Read: block mappings and block sequences by indentation (sequences of
mappings, and sequences at their key's indent, included); flow sequences on
one line (``[1, 2]``, ``[none, none, dots_names]``); ``#`` comments outside
quotes; single- and double-quoted scalars; PyYAML's YAML 1.1 resolution of
plain scalars (ints with ``_``, ``0x``, ``0b``, octal and base-60 forms;
floats only with a dot, so ``4.5e-6`` is a float and ``1e-4`` a string;
``yes/no/on/off/true/false`` in their three spellings; ``null``, ``~`` and
the empty value). A repeated key keeps its last value, as PyYAML does.

Everything else raises ``ValueError`` with the file and line, rather than
reading a config some other way than PyYAML would: anchors, aliases, tags,
block scalars (``|``, ``>``), flow mappings, merge keys, complex keys,
timestamps, multi-line scalars, document markers and tabs in indentation.
"""

from __future__ import annotations

import re
from typing import Any

_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULL = {"", "~", "null", "Null", "NULL"}
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_BAD_START = "&*!|>%@`{"


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    total, base = 0, 1
    for part in reversed(text.split(":")):
        total += cast(part) * base
        base *= 60
    return sign * total


def _int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: list[tuple[int, int, str]] = []  # (line number, indent, content)
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                self.fail(no, "a tab in the indentation")
            content = self._strip_comment(body, no).rstrip()
            if not content:
                continue
            if no == 1 and content.startswith("%"):
                self.fail(no, "a directive")
            if content in ("---", "...") or content.startswith(("--- ", "... ")):
                self.fail(no, "a document marker")
            self.lines.append((no, len(raw) - len(body), content))
        self.pos = 0

    def fail(self, no: int, what: str):
        raise ValueError(f"{self.source}:{no}: {what} is not read by this YAML reader")

    def _strip_comment(self, body: str, no: int) -> str:
        """``body`` up to a ``#`` that starts a comment (at the line's start or
        after a space, outside quotes)."""
        quote = None
        i = 0
        while i < len(body):
            c = body[i]
            if quote == "'":
                if c == "'":
                    if body[i + 1:i + 2] == "'":
                        i += 1
                    else:
                        quote = None
            elif quote == '"':
                if c == "\\":
                    i += 1
                elif c == '"':
                    quote = None
            elif c in "'\"":
                before = body[:i].rstrip()
                if not before or before[-1] in "[,{" or (before[-1] in ":-" and i > len(before)):
                    quote = c
            elif c == "#" and (i == 0 or body[i - 1] in " \t"):
                return body[:i]
            i += 1
        if quote is not None:
            self.fail(no, "a quoted scalar over more than one line")
        return body

    # -- structure ---------------------------------------------------------

    def read(self) -> Any:
        if not self.lines:
            return None
        node = self.block(self.lines[0][1])
        if self.pos < len(self.lines):
            no = self.lines[self.pos][0]
            self.fail(no, "a line at this indentation")
        return node

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def block(self, indent: int) -> Any:
        return self.sequence(indent) if self._is_item(self.lines[self.pos][2]) else self.mapping(indent)

    def _nested(self, indent: int, seq_at_same_indent: bool) -> Any:
        """The block under an empty ``key:`` or ``-`` at ``indent``, or None."""
        if self.pos < len(self.lines):
            _, ind, text = self.lines[self.pos]
            if ind > indent:
                return self.block(ind)
            if seq_at_same_indent and ind == indent and self._is_item(text):
                return self.sequence(indent)
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            no, ind, text = self.lines[self.pos]
            if ind < indent or not self._is_item(text):
                break
            if ind > indent:
                self.fail(no, "a line at this indentation")
            rest = text[1:].lstrip(" ")
            self.pos += 1
            if not rest:
                out.append(self._nested(ind, False))
            elif self._is_item(rest):
                self.fail(no, "a sequence nested on the same line")
            elif self._split_key(rest, no, probe=True) is not None:
                col = ind + len(text) - len(rest)
                self.lines.insert(self.pos, (no, col, rest))
                out.append(self.mapping(col))
            else:
                out.append(self.value(rest, no))
        return out

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.pos < len(self.lines):
            no, ind, text = self.lines[self.pos]
            if ind < indent or (ind == indent and self._is_item(text)):
                break
            if ind > indent:
                self.fail(no, "a line at this indentation (a multi-line scalar?)")
            key, rest = self._split_key(text, no)
            self.pos += 1
            out[key] = self._nested(indent, True) if not rest else self.value(rest, no)
        return out

    def _split_key(self, text: str, no: int, probe: bool = False):
        """(key, rest) of ``key: rest``; None when ``probe`` and the text is no
        mapping entry."""
        if text.startswith(("? ", "?")) and (len(text) == 1 or text[1] == " "):
            self.fail(no, "a complex key")
        if text[0] in "'\"":
            key, end = self._quoted(text, 0, no)
            after = text[end:].lstrip(" ")
            if not after.startswith(":"):
                if probe:
                    return None
                self.fail(no, "a quoted scalar where a 'key: value' entry is expected")
            rest = after[1:]
            if rest and rest[0] != " ":
                self.fail(no, "text right after a quoted key's colon")
            return key, rest.strip()
        if text[0] in "[{":
            if probe:
                return None
            self.fail(no, "a flow collection as a key")
        m = re.search(r":(?: |$)", text)
        if m is None:
            if probe:
                return None
            self.fail(no, f"{text!r} (expected 'key: value')")
        raw_key = text[:m.start()].rstrip()
        if raw_key == "<<":
            self.fail(no, "a merge key")
        return self.scalar(raw_key, no), text[m.end():].strip()

    # -- values --------------------------------------------------------------

    def value(self, text: str, no: int) -> Any:
        c = text[0]
        if c in "'\"":
            val, end = self._quoted(text, 0, no)
            if text[end:].strip():
                self.fail(no, "text after a quoted scalar")
            return val
        if c == "{":
            self.fail(no, "a flow mapping")
        if c == "[":
            val, end = self._flow_seq(text, 0, no)
            if text[end:].strip():
                self.fail(no, "text after a flow sequence")
            return val
        if self._is_item(text):
            self.fail(no, "a sequence entry where a value is expected")
        if re.search(r":(?: |$)", text):
            self.fail(no, "a mapping inside a plain scalar")
        return self.scalar(text, no)

    def scalar(self, text: str, no: int) -> Any:
        """A plain scalar resolved as PyYAML's SafeLoader resolves it."""
        if text and text[0] in _BAD_START:
            self.fail(no, f"{text[0]!r} at the start of a plain scalar (anchor, alias, tag, block scalar, "
                          "directive or flow mapping)")
        if text in _NULL:
            return None
        if text in _BOOL:
            return _BOOL[text]
        if _INT.match(text):
            return _int(text)
        if _FLOAT.match(text):
            return _float(text)
        if _TIMESTAMP.match(text):
            self.fail(no, "a timestamp")
        if text == "=":
            self.fail(no, "the value key '='")
        return text

    def _quoted(self, text: str, start: int, no: int) -> tuple[str, int]:
        q = text[start]
        out = []
        i = start + 1
        while i < len(text):
            c = text[i]
            if q == "'":
                if c == "'":
                    if text[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), i + 1
                out.append(c)
            else:
                if c == '"':
                    return "".join(out), i + 1
                if c == "\\":
                    e = text[i + 1:i + 2]
                    if e in _ESCAPES:
                        out.append(_ESCAPES[e])
                        i += 2
                        continue
                    if e in _HEX_ESCAPES:
                        n = _HEX_ESCAPES[e]
                        digits = text[i + 2:i + 2 + n]
                        if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                            self.fail(no, "a malformed escape")
                        out.append(chr(int(digits, 16)))
                        i += 2 + n
                        continue
                    self.fail(no, f"the escape \\{e}")
                out.append(c)
            i += 1
        self.fail(no, "a quoted scalar over more than one line")

    def _flow_seq(self, text: str, start: int, no: int) -> tuple[list, int]:
        out: list = []
        i = start + 1
        expect_item = True
        while i < len(text):
            c = text[i]
            if c == " ":
                i += 1
            elif c == "]":
                return out, i + 1
            elif c == ",":
                if expect_item:
                    self.fail(no, "an empty entry in a flow sequence")
                expect_item = True
                i += 1
            elif not expect_item:
                self.fail(no, "a missing ',' in a flow sequence")
            elif c == "[":
                val, i = self._flow_seq(text, i, no)
                out.append(val)
                expect_item = False
            elif c in "'\"":
                val, i = self._quoted(text, i, no)
                out.append(val)
                expect_item = False
            elif c == "{":
                self.fail(no, "a flow mapping")
            else:
                m = re.compile(r"[^,\[\]{}]*").match(text, i)
                item = m.group(0).rstrip(" ")
                if re.search(r":(?: |$)", item):
                    self.fail(no, "a mapping inside a flow sequence")
                out.append(self.scalar(item, no))
                i = m.end()
                expect_item = False
        self.fail(no, "a flow sequence over more than one line")


def safe_load(text: str, source: str = "<string>") -> Any:
    """The data of one YAML document, as ``yaml.safe_load`` gives it for
    the subset this module reads; ``ValueError`` naming ``source`` and the
    line for anything else."""
    return _Reader(text, source).read()
