"""A writer of block YAML, in place of ``yaml.safe_dump(data, sort_keys=False)``
(the card's machine has no PyYAML), for the config's copy that
``SaveConfigCallback`` keeps.

Mappings keep their order; a sequence under a key sits at the key's indent,
as PyYAML writes it; a sequence inside a sequence goes on the lines under
its ``-``; empty collections are ``{}`` and ``[]``. A string is written
plain only where the port's ``yaml_reader`` and PyYAML both read it back as
that same string, else single-quoted, or double-quoted with escapes when
it holds a character a single-quoted scalar cannot. Floats are written as
PyYAML writes them (``1.0e-06``, ``.inf``, ``.nan``). Both readers read the
output back to the data written (tuples come back as lists).
"""

from __future__ import annotations

import math
import re
from typing import Any

from .yaml_reader import _Reader

_PLAIN = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./ =+()$-]*")
_PRINTABLE = re.compile("[\x20-\x7e\xa0-\u2027\u202a-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]*")  # no line breaks
_ESCAPE = {"\0": "0", "\a": "a", "\b": "b", "\t": "t", "\n": "n", "\v": "v", "\f": "f", "\r": "r",
           "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N", "\xa0": "_"}


def _reads_back(text: str) -> bool:
    """Whether ``text``, written plain, reads back as itself."""
    if not _PLAIN.fullmatch(text) or text != text.strip() or " #" in text:
        return False
    try:
        return _Reader("", "<str>").scalar(text, 0) == text
    except ValueError:
        return False


def _string(text: str) -> str:
    if _reads_back(text):
        return text
    if _PRINTABLE.fullmatch(text):
        return "'" + text.replace("'", "''") + "'"
    out = []
    for c in text:
        if c in _ESCAPE:
            out.append("\\" + _ESCAPE[c])
        elif _PRINTABLE.fullmatch(c):
            out.append(c)
        elif ord(c) <= 0xFF:
            out.append(f"\\x{ord(c):02x}")
        elif ord(c) <= 0xFFFF:
            out.append(f"\\u{ord(c):04x}")
        else:
            out.append(f"\\U{ord(c):08x}")
    return '"' + "".join(out) + '"'


def _float(x: float) -> str:
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x).lower()
    if "." not in text and "e" in text:  # PyYAML's represent_float: 1e-06 -> 1.0e-06
        text = text.replace("e", ".0e", 1)
    return text


def scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _float(value)
    if isinstance(value, str):
        return _string(value)
    raise TypeError(f"cannot write a {type(value).__name__} as YAML")


def _lines(value: Any, indent: int) -> list:
    """The block lines of a non-empty mapping or sequence at ``indent``."""
    pad = " " * indent
    out = []
    if isinstance(value, dict):
        for k, v in value.items():
            if _is_block(v):
                out.append(f"{pad}{scalar(k)}:")
                out += _lines(v, indent if isinstance(v, (list, tuple)) else indent + 2)
            else:
                out.append(f"{pad}{scalar(k)}: {_inline(v)}")
        return out
    for v in value:
        if isinstance(v, dict) and v:
            nested = _lines(v, indent + 2)
            out.append(f"{pad}- {nested[0][indent + 2:]}")
            out += nested[1:]
        elif _is_block(v):
            out.append(f"{pad}-")
            out += _lines(v, indent + 2)
        else:
            out.append(f"{pad}- {_inline(v)}")
    return out


def _is_block(value: Any) -> bool:
    return isinstance(value, (dict, list, tuple)) and len(value) > 0


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return scalar(value)


def safe_dump(data: Any) -> str:
    """``data`` (dicts, lists, tuples, strings, numbers, booleans, None) as
    one block YAML document."""
    if _is_block(data):
        return "\n".join(_lines(data, 0)) + "\n"
    return _inline(data) + "\n"
