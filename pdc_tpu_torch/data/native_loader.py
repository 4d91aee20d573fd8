"""PNG decode and encode of the pdc scene layout, and the background batch
producer.

Port of :mod:`pdc_tpu.data.native_loader`: ``decode_batch`` (:82),
``encode_batch`` (:126), ``load_scene_frames`` (:168) and ``PrefetchLoader``
(:191-262). The three image kinds of a scene are RGB8 frames
(``uint8 [H, W, 3]``), 16-bit gray depth (``uint16 [H, W]``, millimetres) and
8-bit masks (``uint8 [H, W]``, nonzero -> 1). Two decoders give the same
arrays:

  * ``"libpng"``: the port's copy of the JAX package's libpng pool
    (``csrc/png_loader.cpp``), built with the host's C++ compiler at first use
    (:mod:`pdc_tpu_torch.ops._build`) and run on a pthread pool;
  * ``"zlib"``: the port's own codec on Python's ``zlib`` and numpy, run on a
    thread pool (``zlib`` and numpy release the interpreter lock). It reads
    non-interlaced PNGs of gray, RGB, palette, gray+alpha and RGBA at 8 bits
    (gray and palette also at 1, 2 and 4 bits) and 16-bit gray, and undoes
    filters 0-4: an image of Up rows in one cumulative sum, any other mix
    one anti-diagonal of pixels at a time.

The zlib codec follows libpng's simplified API, which the JAX package uses
whenever its library is built: RGB is ``PNG_FORMAT_RGB`` (gray replicated,
palette looked up); a mask is ``PNG_FORMAT_GRAY`` then nonzero -> 1, where a
colour pixel's gray is its luminance in linear light, so that a dark colour
can read as 0; 16-bit depth passes through unchanged. A pixel of alpha 255
(or off the ``tRNS`` key) is written, one of alpha 0 leaves the output
buffer as it was, as libpng composites onto the buffer it is given. A partly
transparent pixel in a kind without alpha raises ``ValueError`` under zlib:
libpng composites it in linear light through its own sRGB tables, which this
codec does not reproduce. So do interlaced files, depth that is not 16-bit
gray, and RGB or masks from 16-bit files. The encoder writes RGB8, 16-bit
gray and 8-bit gray, every row with the Up filter, which the decoder undoes
in one cumulative sum.

``decoder="auto"`` picks once per process, before its first decode, and
records the pick in :data:`decoder_chosen`: libpng where a C++ compiler,
``png.h`` and ``libpng`` are found, else zlib. A failure of the chosen
decoder (its build, a file) raises; it is never retried with the other one.
"""

from __future__ import annotations

import ctypes
import os
import queue
import struct
import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

KIND_RGB8 = 0
KIND_GRAY16 = 1
KIND_MASK8 = 2
# encoder counterparts (write instead of read)
KIND_ENC_RGB8 = 3
KIND_ENC_GRAY16 = 4
KIND_ENC_GRAY8 = 5

DECODERS = ("libpng", "zlib")
# what decoder="auto" chose in this process (None until its first use), and why
decoder_chosen: Optional[str] = None
decoder_reason: str = ""
ZLIB_LEVEL = 6  # zlib's default, as libpng's writer uses

_lock = threading.Lock()
_lib = None


# -- choosing the decoder -----------------------------------------------------------


def probe_libpng() -> Tuple[bool, str]:
    """Whether the libpng pool can be built here: a C++ compiler, ``png.h``
    on its include path and ``libpng`` for its linker. Builds nothing."""
    from pdc_tpu_torch.ops import _build

    try:
        cxx = _build.find_cxx()
    except RuntimeError as e:
        return False, str(e)
    try:
        hdr = subprocess.run([cxx, "-E", "-x", "c++", "-"], input="#include <png.h>\n",
                             capture_output=True, text=True, timeout=60)
        lib = subprocess.run([cxx, "-print-file-name=libpng.so"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return False, f"{cxx} did not run: {e}"
    if hdr.returncode != 0:
        return False, f"png.h not found by {cxx}"
    if not os.path.isabs(lib.stdout.strip()):
        return False, f"libpng.so not found by {cxx}"
    return True, f"{cxx}, png.h and {lib.stdout.strip()} found"


def resolve_decoder(decoder: str = "auto") -> str:
    """``"libpng"`` or ``"zlib"``; ``"auto"`` probes once per process."""
    global decoder_chosen, decoder_reason
    if decoder in DECODERS:
        return decoder
    if decoder != "auto":
        raise ValueError(f"decoder {decoder!r}: use 'auto', 'libpng' or 'zlib'")
    with _lock:
        if decoder_chosen is None:
            ok, decoder_reason = probe_libpng()
            decoder_chosen = "libpng" if ok else "zlib"
        return decoder_chosen


# -- the libpng pool ----------------------------------------------------------------


def _library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from pdc_tpu_torch.ops import _build

        lib = _build.load("png_loader")
        lib.loader_init.argtypes = [ctypes.c_int]
        lib.loader_init.restype = None
        for fn in (lib.decode_batch, lib.encode_batch):
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.loader_init(max(os.cpu_count() or 4, 4))
        _lib = lib
        return _lib


_LIBPNG_ERRORS = {-1: "a file could not be opened", -2: "a file is not a PNG libpng reads",
                  -3: "an image's size does not match", -4: "libpng failed to read or write"}


def _run_libpng(fn_name, items, arrays, height, width):
    lib = _library()
    n = len(items)
    paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p, _, _ in items])
    kinds = (ctypes.c_int * n)(*[k for _, k, _ in items])
    bufs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    rc = getattr(lib, fn_name)(paths, kinds, bufs, n, height, width)
    if rc == -3:
        raise ValueError(f"libpng {fn_name}: {_LIBPNG_ERRORS[rc]} ({height}x{width} expected)")
    if rc != 0:
        raise RuntimeError(f"libpng {fn_name} failed with code {rc}: "
                           f"{_LIBPNG_ERRORS.get(rc, 'unknown error')}")


# -- the plain codec: PNG chunks, filters, pixels ---------------------------------------

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_READ_CHUNKS = (b"IHDR", b"PLTE", b"tRNS", b"IDAT")
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # by colour type
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# libpng's RGB -> gray in linear light: its 8-bit gamma table of the sRGB
# default (gamma 1/0.45455) and its default luminance coefficients (sum 32768)
_TO_LINEAR = np.floor(255.0 * np.power(np.arange(256) / 255.0, 1 / 0.45455) + 0.5).astype(np.int64)
_GRAY_COEFFS = (6968, 23434, 2366)


def _chunks(path: str):
    """(IHDR fields, PLTE, tRNS, zlib stream) of a PNG file. The CRC of each
    of these chunks is checked; other chunks are skipped unread."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, plte, trns, idat = 8, None, None, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated {ctype!r} chunk")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if ctype in _READ_CHUNKS and zlib.crc32(body, zlib.crc32(ctype)) != crc:
            raise ValueError(f"{path}: CRC error in the {ctype!r} chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    return ihdr, plte, trns, b"".join(idat)


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG file, from its header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _unfilter(path, raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: ``[height, stride]`` uint8 scanlines."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    ftype, data = rows[:, 0], rows[:, 1:]
    if int(ftype.max()) > 4:
        raise ValueError(f"{path}: unknown filter type {int(ftype.max())}")
    if not ftype.any():
        return data.copy()
    if not ftype[1:].any() or (ftype[0] in (0, 2) and (ftype[1:] == 2).all()):
        # every row Up (the first row's prior is zeros): one sum down the columns
        return np.cumsum(data, axis=0, dtype=np.uint8)
    # Any other mix. Each byte depends on the reconstructed bytes of the
    # pixels to its left, above and above-left, whatever the filter, so the
    # pixels of one anti-diagonal (y + x = k) are independent: H + P - 1
    # vector steps. The pixels are kept by diagonal, out[k + 2, y + 1] =
    # pixel (y, k - y), so that a step reads and writes contiguous runs; the
    # cells around the image stay zero, the bytes left of and above it.
    P = stride // bpp
    yy, xx = np.meshgrid(np.arange(height), np.arange(P), indexing="ij")
    filt = np.zeros((height + P - 1, height, bpp), np.int16)
    filt[yy + xx, yy] = data.reshape(height, P, bpp)
    sub, up, avg, pae = ((ftype == f).astype(np.int16)[:, None] for f in (1, 2, 3, 4))
    out = np.zeros((height + P + 1, height + 1, bpp), np.int16)
    for k in range(height + P - 1):
        lo, hi = max(0, k - P + 1), min(height - 1, k) + 1
        a, b, c = out[k + 1, lo + 1:hi + 1], out[k + 1, lo:hi], out[k, lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (sub[lo:hi] * a + up[lo:hi] * b + avg[lo:hi] * ((a + b) >> 1)
                + pae[lo:hi] * paeth)
        out[k + 2, lo + 1:hi + 1] = (filt[k, lo:hi] + pred) & 0xFF
    return out[yy + xx + 2, yy + 1].reshape(height, stride).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Scanlines -> ``[H, W, channels]`` samples (uint8, or uint16 at 16 bits)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, channels)
    if depth == 8:
        return rows.reshape(h, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def _decode_png(path: str, kind: int, out: np.ndarray) -> None:
    """Decode one file into ``out`` as libpng's simplified API would."""
    (w, h, depth, color, comp, filt, interlace), plte, trns, stream = _chunks(path)
    if color not in _CHANNELS or depth not in _DEPTHS[color] or comp != 0 or filt != 0:
        raise ValueError(f"{path}: not a valid PNG header (colour type {color}, depth {depth})")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG, which the zlib decoder does not read "
                         "(decoder='libpng' does)")
    if (h, w) != tuple(out.shape[:2]):
        raise ValueError(f"{path}: image is {h}x{w}, expected {out.shape[0]}x{out.shape[1]}")
    channels = _CHANNELS[color]
    bits = channels * depth
    try:
        raw = zlib.decompress(stream)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    rows = _unfilter(path, raw, h, (w * bits + 7) // 8, max(1, bits // 8))
    px = _samples(rows, w, depth, channels)
    name = f"{depth}-bit {_COLOR_NAMES[color]}"

    if kind == KIND_GRAY16:
        if color != 0 or depth != 16 or trns is not None:
            raise ValueError(f"{path}: depth is read from 16-bit gray PNGs, this one is {name}"
                             f"{' with tRNS' if trns is not None else ''} (libpng would "
                             "convert it to linear light)")
        out[...] = px[..., 0]
        return
    if depth == 16:
        raise ValueError(f"{path}: {name} read as 8 bits: libpng converts 16-bit samples "
                         "from linear light, which the zlib decoder does not reproduce")

    alpha = None
    if color == 3:
        idx = px[..., 0]
        pal = np.zeros((256, 3), np.uint8)  # libpng pads the palette with black
        if plte is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        pal[:len(plte)] = plte
        rgb = pal[idx]
        if trns is not None:
            table = np.full(256, 255, np.uint8)
            table[:len(trns)] = np.frombuffer(trns, np.uint8)
            alpha = table[idx]
    elif color in (0, 4):
        gray = px[..., 0]
        if color == 4:
            alpha = px[..., 1]
        elif trns is not None:  # the key is in the file's bit depth
            alpha = np.where(gray == struct.unpack(">H", trns[:2])[0], 0, 255)
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        rgb = gray[..., None]
    else:  # 2, 6
        rgb = px[..., :3]
        if color == 6:
            alpha = px[..., 3]
        elif trns is not None:
            key = np.asarray(struct.unpack(">HHH", trns[:6]))
            alpha = np.where((rgb == key).all(-1), 0, 255)

    if alpha is not None and ((alpha > 0) & (alpha < 255)).any():
        raise ValueError(f"{path}: partly transparent pixels in a {name} image read without "
                         "alpha: libpng composites them in linear light, which the zlib "
                         "decoder does not reproduce (decoder='libpng' does)")
    opaque = None if alpha is None else alpha == 255

    if kind == KIND_RGB8:
        value = np.broadcast_to(rgb, out.shape)
        if opaque is None:
            out[...] = value
        else:
            out[opaque] = value[opaque]
        return
    if kind != KIND_MASK8:
        raise ValueError(f"unknown decode kind {kind}")
    if rgb.shape[-1] == 1:
        value = rgb[..., 0]
    else:
        r, g, b = (rgb[..., i] for i in range(3))
        lin = (_GRAY_COEFFS[0] * _TO_LINEAR[r] + _GRAY_COEFFS[1] * _TO_LINEAR[g]
               + _GRAY_COEFFS[2] * _TO_LINEAR[b] + 16384) >> 15
        value = np.where((r == g) & (g == b), r, lin)
    if opaque is None:
        out[...] = value != 0
    else:
        out[opaque] = value[opaque] != 0
        out[...] = out != 0


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def encode_png(arr: np.ndarray, kind: int) -> bytes:
    """A PNG file of ``arr``: ``KIND_ENC_RGB8`` (uint8 ``[H, W, 3]``),
    ``KIND_ENC_GRAY16`` (uint16 ``[H, W]``) or ``KIND_ENC_GRAY8`` (uint8
    ``[H, W]``); every row Up-filtered."""
    h, w = arr.shape[:2]
    if kind == KIND_ENC_RGB8:
        color, depth, rows = 2, 8, arr.reshape(h, w * 3)
    elif kind == KIND_ENC_GRAY16:
        color, depth, rows = 0, 16, arr.astype(">u2").view(np.uint8).reshape(h, w * 2)
    elif kind == KIND_ENC_GRAY8:
        color, depth, rows = 0, 8, arr.reshape(h, w)
    else:
        raise ValueError(f"unknown encode kind {kind}")
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 2
    filtered[:, 1:] = rows
    filtered[1:, 1:] -= rows[:-1]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, arr_u8) -> None:
    """Write uint8 ``[H, W, 3]`` (RGB) or ``[H, W]``/``[H, W, 1]`` (gray) to
    ``path`` with :func:`encode_png`, whatever decoder is installed."""
    arr = np.ascontiguousarray(arr_u8, np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    data = encode_png(arr, KIND_ENC_RGB8 if arr.ndim == 3 else KIND_ENC_GRAY8)
    with open(path, "wb") as f:
        f.write(data)


# -- the batch entry points -----------------------------------------------------------

_DECODE_SPEC = {KIND_RGB8: (np.uint8, 3), KIND_GRAY16: (np.uint16, None), KIND_MASK8: (np.uint8, None)}
_ENCODE_SPEC = {KIND_ENC_RGB8: (np.uint8, 3), KIND_ENC_GRAY16: (np.uint16, None),
                KIND_ENC_GRAY8: (np.uint8, None)}


def _check(arr: np.ndarray, spec, kind: int, height: int, width: int, what: str):
    if kind not in spec:
        raise ValueError(f"{what}: unknown kind {kind}")
    dtype, ch = spec[kind]
    shape = (height, width) if ch is None else (height, width, ch)
    if not isinstance(arr, np.ndarray) or arr.dtype != dtype or arr.shape != shape:
        raise ValueError(f"{what}: kind {kind} takes a {np.dtype(dtype).name} array of shape "
                         f"{shape}, got {getattr(arr, 'dtype', type(arr))} "
                         f"{getattr(arr, 'shape', '')}")
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what}: arrays must be C-contiguous")


def _threads(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 1))


def decode_batch(items: Sequence[Tuple[str, int, np.ndarray]], height: int, width: int,
                 decoder: str = "auto") -> None:
    """Decode ``(path, kind, out_array)`` triples in parallel, in place.

    Out arrays are C-contiguous: ``KIND_RGB8`` uint8 ``[H, W, 3]``,
    ``KIND_GRAY16`` uint16 ``[H, W]``, ``KIND_MASK8`` uint8 ``[H, W]``.

    :raises FileNotFoundError: a file is missing (either decoder)
    :raises ValueError: an image of another size or one the decoder does not read
    """
    decoder = resolve_decoder(decoder)
    for path, kind, arr in items:
        _check(arr, _DECODE_SPEC, kind, height, width, "decode_batch")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
    if not items:
        return
    if decoder == "libpng":
        _run_libpng("decode_batch", items, [a for _, _, a in items], height, width)
        return
    with ThreadPoolExecutor(_threads(len(items))) as ex:
        list(ex.map(lambda it: _decode_png(*it), items))


def encode_batch(items: Sequence[Tuple[str, int, np.ndarray]], height: int, width: int,
                 decoder: str = "auto") -> None:
    """Write ``(path, kind, array)`` triples in parallel: ``KIND_ENC_RGB8``
    (uint8 ``[H, W, 3]``), ``KIND_ENC_GRAY16`` (uint16 ``[H, W]``),
    ``KIND_ENC_GRAY8`` (uint8 ``[H, W]``), with the codec that ``decoder``
    names."""
    decoder = resolve_decoder(decoder)
    arrays = [np.ascontiguousarray(a) for _, _, a in items]
    for (_, kind, _), arr in zip(items, arrays):
        _check(arr, _ENCODE_SPEC, kind, height, width, "encode_batch")
    if not items:
        return
    if decoder == "libpng":
        _run_libpng("encode_batch", items, arrays, height, width)
        return

    def write(job):
        (path, kind, _), arr = job
        data = encode_png(arr, kind)
        with open(path, "wb") as f:
            f.write(data)

    with ThreadPoolExecutor(_threads(len(items))) as ex:
        list(ex.map(write, zip(items, arrays)))


def load_scene_frames(structure, indices: List[int], height: int, width: int,
                      decoder: str = "auto"):
    """Decode the frames ``indices`` of a scene; a frame without a mask file
    gets a mask of ones.

    :param structure: :class:`pdc_tpu_torch.data.scene.SceneStructure`
    :return: (rgb [N,H,W,3] u8, depth [N,H,W] u16, mask [N,H,W] u8)
    """
    n = len(indices)
    rgb = np.empty((n, height, width, 3), np.uint8)
    depth = np.empty((n, height, width), np.uint16)
    mask = np.empty((n, height, width), np.uint8)
    items = []
    for j, i in enumerate(indices):
        items.append((structure.rgb_image_filename(i), KIND_RGB8, rgb[j]))
        items.append((structure.depth_image_filename(i), KIND_GRAY16, depth[j]))
        mf = structure.mask_image_filename(i)
        if os.path.exists(mf):
            items.append((mf, KIND_MASK8, mask[j]))
        else:
            mask[j] = 1
    decode_batch(items, height, width, decoder=decoder)
    return rgb, depth, mask


# -- the background batch producer ------------------------------------------------------


class _ProducerError:
    """Sentinel carrying a producer-thread exception through the queue."""

    def __init__(self, exc):
        self.exc = exc


class PrefetchLoader:
    """Double-buffered background batch producer.

    Wraps a zero-argument ``make_batch`` (for example
    ``lambda: dataset.make_host_batch(B)``) with a worker thread that keeps
    up to ``depth`` batches ready. A failure in ``make_batch`` is raised by
    :meth:`next` as a ``RuntimeError`` chained to it, never a hang.
    """

    def __init__(self, make_batch, depth: int = 2, device=None):
        """:param device: when given, the worker thread also copies each
        numpy array of the batch to this device, so the copy overlaps the
        device's current step; None keeps the batch on the host."""
        self._make_batch = make_batch
        self._device = None if device is None else torch.device(device)
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
                if self._device is not None:
                    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
                             if isinstance(v, np.ndarray) else v for k, v in batch.items()}
            except BaseException as exc:  # handed to the consumer, which re-raises
                self._put(_ProducerError(exc))
                return
            self._put(batch)

    def next(self):
        item = self._q.get()
        if isinstance(item, _ProducerError):
            self.stop()
            raise RuntimeError("PrefetchLoader producer thread failed") from item.exc
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
