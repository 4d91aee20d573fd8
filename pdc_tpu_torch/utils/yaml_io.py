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
and otherwise :func:`parse_yaml`, a reader of the block-style subset that
the emitter writes and that the repo's configs use: nested mappings,
block and flow sequences of scalars, comments, plain and quoted scalars
resolved as YAML 1.1 does.
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
    if _OCT.match(text):
        return int(text.replace("_", ""), 8)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
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


def _emit(data, indent: int, out: list):
    pad = " " * indent
    for key in sorted(data):
        value = data[key]
        head = f"{pad}{_scalar_text(key)}:"
        if isinstance(value, dict):
            if value:
                out.append(head)
                _emit(value, indent + 2, out)
            else:
                out.append(head + " {}")
        elif isinstance(value, (list, tuple)):
            if value:
                out.append(head)
                for item in value:
                    if isinstance(item, (dict, list, tuple)):
                        raise TypeError(f"{key}: only lists of scalars are written")
                    out.append(f"{pad}- {_scalar_text(item)}")
            else:
                out.append(head + " []")
        else:
            out.append(f"{head} {_scalar_text(value)}")


def dump_yaml(data: dict) -> str:
    """``data`` (a dict) as block-style YAML text with sorted keys."""
    if not isinstance(data, dict):
        raise TypeError("the top level of a YAML file is a dict")
    if not data:
        return "{}\n"
    out: list = []
    _emit(data, 0, out)
    return "\n".join(out) + "\n"


# -- reader -------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# comment`` (outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str):
    """``key: value`` -> (key, value text), or None for a line with no
    mapping key."""
    if text[:1] in "\"'":
        end = text.index(text[0], 1)
        if text[end + 1:end + 2] != ":":
            return None
        return _value(text[:end + 1]), text[end + 2:].strip()
    m = re.match(r"([^:]*?):(?:\s+|$)(.*)$", text)
    if not m:
        return None
    return _resolve(m.group(1).strip()), m.group(2).strip()


def _value(text: str):
    """A scalar or flow collection written on one line."""
    if text.startswith('"'):
        return json.loads(text)
    if text.startswith("'"):
        return text[1:-1].replace("''", "'")
    if text == "{}":
        return {}
    if text.startswith("["):
        inner = text[1:-1].strip()
        return [_value(x.strip()) for x in inner.split(",")] if inner else []
    if text.startswith(("{", "&", "*", "!", "|", ">")):
        raise ValueError(f"YAML construct not read by this reader: {text!r}")
    return _resolve(text)


class _Lines:
    def __init__(self, text: str):
        self.items = []
        for raw in text.splitlines():
            if raw.strip() in ("---", "..."):
                continue
            line = _strip_comment(raw)
            if line.strip():
                self.items.append((len(line) - len(line.lstrip(" ")), line.strip()))
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else (None, None)


def _block(lines: _Lines, indent: int):
    _, text = lines.peek()
    if text == "-" or text.startswith("- "):
        return _sequence(lines, indent)
    return _mapping(lines, indent)


def _sequence(lines: _Lines, indent: int):
    out = []
    while True:
        ind, text = lines.peek()
        if ind != indent or not (text == "-" or text.startswith("- ")):
            return out
        lines.pos += 1
        item = text[1:].strip()
        if not item or _split_key(item) is not None and not item.startswith(("'", '"', "[")):
            raise ValueError(f"only sequences of scalars are read: {text!r}")
        out.append(_value(item))


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
            raise ValueError(f"expected 'key: value', got {text!r}")
        key, rest = kv
        lines.pos += 1
        if rest:
            out[key] = _value(rest)
            continue
        nxt, ntext = lines.peek()
        if nxt is not None and (nxt > indent or (nxt == indent and (
                ntext == "-" or ntext.startswith("- ")))):
            out[key] = _block(lines, nxt)
        else:
            out[key] = None


def parse_yaml(text: str):
    """Parse the block-style subset described in the module docstring."""
    lines = _Lines(text)
    ind, first = lines.peek()
    if first is None:
        return None
    if ind == 0 and first in ("{}", "[]") or first.startswith(("[", '"', "'")):
        lines.pos += 1
        return _value(first)
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


def save_yaml(data, filename):
    """Write a dict as YAML with :func:`dump_yaml`, creating parent
    directories as needed."""
    parent = os.path.dirname(os.path.abspath(filename))
    os.makedirs(parent, exist_ok=True)
    with open(filename, "w") as f:
        f.write(dump_yaml(data))
