"""Reader and writer of the JAX package's ``%06d.ckpt`` files, in plain Python.

``pdc_tpu`` writes a checkpoint with ``flax.serialization.to_bytes``
(``pdc_tpu/models/dcn.py:458-466``): a msgpack map of maps whose leaves are
ndarrays, each packed as msgpack ext type 1 holding the msgpack-packed tuple
``(shape, dtype name, C-order bytes)``. This module handles exactly the
msgpack subset flax writes — maps, str, arrays, bin, ext, ints, floats, nil
and bool — with ``struct``, so the port needs neither ``msgpack`` nor flax.
Anything else (reserved byte ``0xc1``, ext codes other than the ndarray one,
truncated input, trailing bytes) raises ``ValueError``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

EXT_NDARRAY = 1  # flax.serialization._MsgpackExtType.ndarray

# first byte -> (struct format of the length/value that follows)
_UINT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
_INT = {0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}


class _Reader:
    def __init__(self, data):
        self._buf = memoryview(data)
        self._pos = 0

    def take(self, n: int) -> memoryview:
        end = self._pos + n
        if end > len(self._buf):
            raise ValueError("truncated msgpack data")
        out = self._buf[self._pos:end]
        self._pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def at_end(self) -> bool:
        return self._pos == len(self._buf)

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b == 0xca:
            return self.unpack(">f")
        if b == 0xcb:
            return self.unpack(">d")
        if b in _UINT:
            return self.unpack(_UINT[b])
        if b in _INT:
            return self.unpack(_INT[b])
        if b in _STR:
            return str(self.take(self.unpack(_STR[b])), "utf-8")
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _ARRAY:
            return [self.value() for _ in range(self.unpack(_ARRAY[b]))]
        if b in _MAP:
            return self._map(self.unpack(_MAP[b]))
        if b in _FIXEXT:
            n = _FIXEXT[b]
        elif b in _EXT:
            n = self.unpack(_EXT[b])
        else:
            raise ValueError(f"unsupported msgpack byte 0x{b:02x}")
        code = self.unpack(">b")
        return _ext_unpack(code, self.take(n))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ext_unpack(code: int, data) -> np.ndarray:
    if code != EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext code {code}")
    inner = _Reader(data)
    shape, dtype_name, buffer = inner.value()
    if not inner.at_end():
        raise ValueError("trailing bytes in ndarray ext payload")
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise ValueError(f"unsupported ndarray dtype {dtype_name!r}") from e
    # np.array copies: the result is writable and owns its memory
    return np.array(np.frombuffer(buffer, dtype=dtype).reshape(shape))


def unpackb(data: bytes):
    """Decode one msgpack object that spans all of ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if not reader.at_end():
        raise ValueError("trailing bytes after msgpack object")
    return out


def _head(out: list, small_base: int, small_max: int, formats, n: int):
    """Append a type byte + length, choosing the smallest encoding as
    msgpack-python does (so files match flax's byte for byte)."""
    if small_base is not None and n <= small_max:
        out.append(bytes([small_base | n]))
        return
    for byte, fmt in formats:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(bytes([byte]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7f or -32 <= obj < 0:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        elif obj >= 0:
            for byte, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out.append(bytes([byte]) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"integer {obj} too large for msgpack")
        else:
            for byte, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q")):
                if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out.append(bytes([byte]) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"integer {obj} too small for msgpack")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, 0xa0, 31, ((0xd9, ">B"), (0xda, ">H"), (0xdb, ">I")), len(raw))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, None, None, ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")), len(obj))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _head(out, 0x90, 15, ((0xdc, ">H"), (0xdd, ">I")), len(obj))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _head(out, 0x80, 15, ((0xde, ">H"), (0xdf, ">I")), len(obj))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.fields is not None:
            raise ValueError("object and structured dtypes are not serializable")
        payload = packb((list(obj.shape), obj.dtype.name, obj.tobytes("C")))
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}[n]
            out.append(bytes([fixext]))
        else:
            _head(out, None, None, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")), n)
        out.append(struct.pack(">b", EXT_NDARRAY))
        out.append(payload)
    else:
        raise TypeError(f"cannot msgpack-serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` (nested dict/list/tuple of str, bytes, int, float,
    bool, None and ndarray leaves) the way flax's ``msgpack_serialize`` does."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def read_checkpoint(path: str) -> dict:
    """``%06d.ckpt`` -> nested dict of numpy arrays (``{'params': ...,
    'batch_stats': ...}`` for a DCN)."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def write_checkpoint(tree: dict, path: str):
    """Write a nested dict of numpy arrays as a flax-readable checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = packb(tree)
    with open(path, "wb") as f:
        f.write(data)
