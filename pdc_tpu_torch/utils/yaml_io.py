"""YAML IO for configs and model folders.

The port writes every YAML file with its own emitter, :func:`dump_yaml`, so
a model folder written on a host without PyYAML holds the same bytes as one
written with it. The emitter covers what the training driver writes
(``training.yaml``, ``dataset.yaml``, ``identifier.yaml``, ``loss.yaml``,
``%06d_log_history.yaml``): nested dicts with sorted keys, lists of
scalars, str, int, float, bool and None, in PyYAML's block style. Floats
are written so that PyYAML's YAML 1.1 resolver reads them back as floats
(``1.0e-05``, never ``1e-05``, which it reads as a string).

Reading uses PyYAML where it is importable (the C loader when available),
and otherwise :func:`parse_yaml`, a reader of what the emitter writes, the
repo's configs and what PyYAML writes in either style: nested block
mappings and sequences (sequences of mappings, ``- - b``, PyYAML's
indentless sequences), flow collections nested to any depth and spanning
lines (``quaternion: {w: 1.0, x: 0.0, ...}``), comments, and plain and
quoted scalars resolved as YAML 1.1 does. It raises, instead of reading
another type, on what it does not construct: timestamps, base-60 numbers,
tags, anchors and aliases, block scalars and complex keys.
"""

from __future__ import annotations

import json
import math
import os
import re

import numpy as np

# YAML 1.1 implicit types, as PyYAML's resolver reads them
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_BIN = re.compile(r"[-+]?0b[0-1_]+$")
# implicit types this reader does not construct: it raises on them rather
# than read them as another type (PyYAML gives a date or datetime, and
# base-60 numbers: 12:30 is 750)
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{2}-[0-9]{2}$|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}"
                        r"(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?$")
_SEXAGESIMAL = re.compile(r"[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+$"
                          r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# strings the emitter writes without quotes, unless they would read back
# as another type; dates are quoted because PyYAML reads them as dates
_PLAIN = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_./-]*$")
_DATE = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}$")


def _resolve(text: str):
    """A plain (unquoted) scalar's value under the YAML 1.1 rules."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _HEX.match(text):
        return int(text.replace("_", ""), 16)
    if _BIN.match(text):
        return int(text.replace("_", ""), 2)
    if _OCT.match(text):
        return int(text.replace("_", ""), 8)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    if _TIMESTAMP.match(text) or _SEXAGESIMAL.match(text):
        raise ValueError(f"YAML 1.1 reads {text!r} as a timestamp or a base-60 number, "
                         "which this reader does not construct; quote it to read a string")
    return text


# -- emitter ------------------------------------------------------------------


def _float_text(v: float) -> str:
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:  # 1e-05 -> 1.0e-05, as PyYAML writes it
        text = text.replace("e", ".0e", 1)
    return text


def _scalar_text(v) -> str:
    if isinstance(v, np.generic):
        v = v.item()
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        if _PLAIN.match(v) and not _DATE.match(v) and _resolve(v) == v:
            return v
        return json.dumps(v)  # a YAML double-quoted scalar
    raise TypeError(f"cannot write {type(v).__name__} as a YAML scalar")


def _emit(data, indent: int, out: list, nested: bool = False):
    pad = " " * indent
    for key in sorted(data):
        value = data[key]
        head = f"{pad}{_scalar_text(key)}:"
        if isinstance(value, dict):
            if value:
                out.append(head)
                _emit(value, indent + 2, out, nested)
            else:
                out.append(head + " {}")
        elif isinstance(value, (list, tuple)):
            if value:
                out.append(head)
                _emit_sequence(value, indent, out, nested, key)
            else:
                out.append(head + " []")
        else:
            out.append(f"{head} {_scalar_text(value)}")


def _emit_sequence(items, indent: int, out: list, nested: bool, key=None):
    """PyYAML's block sequence: ``- `` at ``indent``, a nested collection
    starting on the dash's line."""
    pad = " " * indent
    for item in items:
        if isinstance(item, (dict, list, tuple)):
            if not nested:
                raise TypeError(f"{key}: only lists of scalars are written")
            if not item:
                out.append(f"{pad}- {'{}' if isinstance(item, dict) else '[]'}")
                continue
            sub: list = []
            if isinstance(item, dict):
                _emit(item, indent + 2, sub, nested)
            else:
                _emit_sequence(item, indent + 2, sub, nested, key)
            sub[0] = f"{pad}- {sub[0][indent + 2:]}"
            out.extend(sub)
        else:
            out.append(f"{pad}- {_scalar_text(item)}")


def dump_yaml(data, nested: bool = False) -> str:
    """``data`` (a dict) as block-style YAML text with sorted keys. With
    ``nested``, also lists of dicts and of lists, and a list at the top
    level (an annotation file), in PyYAML's block layout."""
    if isinstance(data, (list, tuple)) and nested:
        if not data:
            return "[]\n"
        out: list = []
        _emit_sequence(data, 0, out, nested)
        return "\n".join(out) + "\n"
    if not isinstance(data, dict):
        raise TypeError("the top level of a YAML file is a dict")
    if not data:
        return "{}\n"
    out = []
    _emit(data, 0, out, nested)
    return "\n".join(out) + "\n"


# -- reader -------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# comment``. A quote opens a quoted
    scalar only where a token starts (after a space or ``[{,:``), as in
    YAML; an apostrophe inside a word (``it's``) is plain text."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote and not (quote == '"' and _odd_backslashes(line, i)):
                quote = None
            continue
        if c in "\"'" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """Recursive-descent reader of one flow node: ``[...]``, ``{...}``, a
    quoted or a plain scalar, nested to any depth."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def _ws(self):
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def _peek(self):
        self._ws()
        return self.text[self.i] if self.i < len(self.text) else ""

    def _expect(self, c):
        if self._peek() != c:
            raise ValueError(f"expected {c!r} at {self.i} of flow text {self.text!r}")
        self.i += 1

    def _is_indicator_colon(self):
        """A ``:`` that separates a key from its value in flow context."""
        nxt = self.text[self.i + 1:self.i + 2]
        return self._peek() == ":" and (nxt == "" or nxt in " \t,[]{}")

    def node(self):
        c = self._peek()
        if c == "[":
            self.i += 1
            out = []
            while self._peek() != "]":
                item = self.node()
                if self._is_indicator_colon():  # [a: 1] is [{a: 1}]
                    self.i += 1
                    item = {item: self._value_or_none()}
                out.append(item)
                if self._peek() != "]":
                    self._expect(",")
            self.i += 1
            return out
        if c == "{":
            self.i += 1
            out = {}
            while self._peek() != "}":
                key = self.node()
                if isinstance(key, (dict, list)):
                    raise ValueError(f"collection as a mapping key in {self.text!r}")
                if self._is_indicator_colon():
                    self.i += 1
                    out[key] = self._value_or_none()
                else:
                    out[key] = None
                if self._peek() != "}":
                    self._expect(",")
            self.i += 1
            return out
        if c in "\"'":
            return self._quoted(c)
        if c == "" or c in ",]}":
            raise ValueError(f"missing value at {self.i} of flow text {self.text!r}")
        if c in "&*!|>%@`":
            raise ValueError(f"YAML construct not read by this reader: {self.text!r}")
        start = self.i
        while self.i < len(self.text):
            ch = self.text[self.i]
            if ch in ",[]{}" or (ch == ":" and self._is_indicator_colon()):
                break
            if ch == "#" and self.text[self.i - 1] in " \t":
                break
            self.i += 1
        return _resolve(self.text[start:self.i].strip())

    def _value_or_none(self):
        return None if self._peek() in ("", ",", "]", "}") else self.node()

    def _quoted(self, q):
        j = self.i + 1
        while True:
            k = self.text.find(q, j)
            if k < 0:
                raise ValueError(f"unterminated quoted scalar in {self.text!r}")
            if q == "'" and self.text[k + 1:k + 2] == "'":
                j = k + 2
            elif q == '"' and _odd_backslashes(self.text, k):
                j = k + 1
            else:
                break
        raw = self.text[self.i:k + 1]
        self.i = k + 1
        return json.loads(raw) if q == '"' else raw[1:-1].replace("''", "'")


def _odd_backslashes(text: str, k: int) -> bool:
    n = 0
    while k - n - 1 >= 0 and text[k - n - 1] == "\\":
        n += 1
    return n % 2 == 1


def _value(text: str):
    """A block-context value written on one line (the whole of ``text``): a
    flow collection, a quoted scalar, or a plain scalar, which in block
    context may hold ``,[]{}``."""
    if text[:1] not in "[{\"'":
        if text[:1] in "&*!|>%@`":
            raise ValueError(f"YAML construct not read by this reader: {text!r}")
        return _resolve(text)
    parser = _Flow(text)
    out = parser.node()
    if parser._peek() != "":
        raise ValueError(f"unexpected text after a value: {text!r}")
    return out


def _split_key(text: str):
    """``key: value`` -> (key, value text), or None for text that is not a
    mapping entry."""
    if text.startswith(("? ", "[", "{")) or text == "?":
        return None
    if text[:1] in "\"'":
        parser = _Flow(text)
        key = parser._quoted(text[0])
        rest = text[parser.i:]
        if not (rest == ":" or rest.startswith((": ", ":\t"))):
            return None
        return key, rest[1:].strip()
    m = re.match(r"([^#]*?):(?:[ \t]+|$)(.*)$", text)
    if not m or m.group(1).startswith(("- ", "-\t")) or m.group(1) == "-":
        return None
    return _resolve(m.group(1).strip()), m.group(2).strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


def _opens_flow(text: str) -> int:
    """Unclosed ``[``/``{`` at the end of ``text`` (outside quotes)."""
    while _is_item(text):
        text = text[1:].lstrip(" \t")
    kv = _split_key(text)
    if kv is not None:
        text = kv[1]
    if not text.startswith(("[", "{")):
        return 0  # a plain scalar, which may hold brackets
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote and not (quote == '"' and _odd_backslashes(text, i)):
                quote = None
        elif c in "\"'" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


class _Lines:
    """(indent, text) of each content line; a flow collection that spans
    lines is joined into its first line, its line breaks read as spaces."""

    def __init__(self, text: str):
        self.items = []
        pending = None
        for raw in text.splitlines():
            if raw.strip() in ("---", "...") or raw.startswith("%"):
                continue
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if pending is not None:
                pending[1] += " " + line.strip()
                if _opens_flow(pending[1]) <= 0:
                    self.items.append(tuple(pending))
                    pending = None
                continue
            item = [len(line) - len(line.lstrip(" ")), line.strip()]
            if _opens_flow(item[1]) > 0:
                pending = item
            else:
                self.items.append(tuple(item))
        if pending is not None:
            raise ValueError(f"unclosed flow collection: {pending[1]!r}")
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else (None, None)


def _block(lines: _Lines, indent: int):
    _, text = lines.peek()
    return _sequence(lines, indent) if _is_item(text) else _mapping(lines, indent)


def _nested(lines: _Lines, indent: int):
    """The value of an entry whose own line ends at its key or dash: the
    block indented deeper on the next lines, or None."""
    nxt, _ = lines.peek()
    if nxt is not None and nxt > indent:
        return _block(lines, nxt)
    return None


def _sequence(lines: _Lines, indent: int):
    out = []
    while True:
        ind, text = lines.peek()
        if ind != indent or not _is_item(text):
            return out
        rest = text[1:].lstrip(" \t")
        if not rest:
            lines.pos += 1
            out.append(_nested(lines, indent))
            continue
        # the item's content starts at its own column: rewrite the line as
        # that content and read a block there (`- a: 1` is a mapping, `- - b`
        # a sequence, continued by the lines indented to that column)
        column = indent + len(text) - len(rest)
        if _is_item(rest) or _split_key(rest) is not None:
            lines.items[lines.pos] = (column, rest)
            out.append(_block(lines, column))
        else:
            lines.pos += 1
            out.append(_value(rest))


def _mapping(lines: _Lines, indent: int):
    out = {}
    while True:
        ind, text = lines.peek()
        if ind is None or ind < indent:
            return out
        if ind > indent:
            raise ValueError(f"unexpected indentation at {text!r}")
        kv = _split_key(text)
        if kv is None:
            if _is_item(text):  # a sequence at a mapping's indent ends it
                return out
            raise ValueError(f"expected 'key: value', got {text!r}")
        key, rest = kv
        lines.pos += 1
        if rest:
            if rest.startswith(("|", ">")):
                raise ValueError(f"YAML block scalars are not read by this reader: {text!r}")
            out[key] = _value(rest)
            continue
        nxt, ntext = lines.peek()
        if nxt is not None and nxt == indent and _is_item(ntext):
            out[key] = _sequence(lines, indent)  # PyYAML's indentless sequence
        else:
            out[key] = _nested(lines, indent)


def parse_yaml(text: str):
    """Parse the subset of YAML described in the module docstring."""
    lines = _Lines(text)
    ind, first = lines.peek()
    if first is None:
        return None
    if not _is_item(first) and _split_key(first) is None:
        lines.pos += 1
        out = _value(first)
    else:
        out = _block(lines, ind)
    if lines.pos != len(lines.items):
        raise ValueError(f"unexpected indentation at {lines.items[lines.pos][1]!r}")
    return out


def _pyyaml_loader():
    try:
        import yaml
    except ImportError:
        return None
    return getattr(yaml, "CSafeLoader", yaml.SafeLoader)


def load_yaml_string(s: str):
    loader = _pyyaml_loader()
    if loader is None:
        return parse_yaml(s)
    import yaml

    return yaml.load(s, Loader=loader)


def load_yaml(filename):
    """Load a YAML file (PyYAML where importable, else :func:`parse_yaml`)."""
    with open(filename, "r") as f:
        return load_yaml_string(f.read())


def save_yaml(data, filename, nested: bool = False):
    """Write a dict (with ``nested``, any nesting, see :func:`dump_yaml`) as
    YAML, creating parent directories as needed."""
    parent = os.path.dirname(os.path.abspath(filename))
    os.makedirs(parent, exist_ok=True)
    with open(filename, "w") as f:
        f.write(dump_yaml(data, nested))
