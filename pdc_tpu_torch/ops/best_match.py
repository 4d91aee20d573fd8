"""Streaming best-match argmin: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of :mod:`pdc_tpu.ops.pallas_kernels` (``pallas_best_match``);
the kernel is ``pdc_tpu_torch/csrc/best_match.cu``, whose header note gives
its bound on the card and its design.

``best_match(res, queries)`` takes channel-planar descriptor images
``res [B, D, HW]`` (the backbone's NCHW output, flat pixel index
``n = v*W + u``) and queries ``[B, Q, D]``, both float32 and contiguous, and
returns ``idx [B, Q]`` int32 and ``dist [B, Q]`` float32: for each query the
pixel of least ``||r_p - q||^2``, ties to the lowest index, and its
distance. On a CPU tensor it runs :func:`best_match_reference`; on a CUDA
tensor it launches the kernel (one launch per call) or raises — there is no
fallback.

The kernel's last block of each (image, query group) reduces the others'
partials, elected by a ticket counter. The counters are one zeroed int32
buffer per (device, stream), kept here and grown when a call needs more;
every launch leaves its counters at zero, and no two streams share a
buffer, so launches on different streams cannot draw each other's tickets.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from pdc_tpu_torch.ops import _build

MAX_D = 16
_MAX_GRID_YZ = 65535
_QUERIES_PER_BLOCK = 16  # the smallest query group of best_match.cu

# kernel launches made by best_match() on CUDA tensors (read by chip_smoke.py)
launches = 0


def squared_distances(res: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """``[B, Q, HW]`` squared distances ``sum_d (r_d - q_d)^2``, summed over
    channels in order as the kernel does."""
    d2 = None
    for d in range(res.shape[1]):
        t = res[:, d, None, :] - queries[:, :, d, None]
        d2 = t * t if d2 is None else d2 + t * t
    return d2


def best_match_reference(res: torch.Tensor, queries: torch.Tensor):
    """Plain PyTorch version of the kernel (same arguments and results):
    the full ``[B, Q, HW]`` distance table, then ``argmin`` (first index on
    ties) and ``sqrt``."""
    d2 = squared_distances(res, queries)
    idx = torch.argmin(d2, dim=-1)
    dist = torch.sqrt(torch.clamp(torch.gather(d2, -1, idx[..., None])[..., 0], min=0.0))
    return idx.to(torch.int32), dist


def _check(res: torch.Tensor, queries: torch.Tensor):
    if not isinstance(res, torch.Tensor) or not isinstance(queries, torch.Tensor):
        raise TypeError("res and queries must be torch tensors")
    if res.dim() != 3 or queries.dim() != 3:
        raise ValueError(f"need res [B, D, HW] and queries [B, Q, D], got "
                         f"{tuple(res.shape)} and {tuple(queries.shape)}")
    B, D, HW = res.shape
    if queries.shape[0] != B or queries.shape[2] != D:
        raise ValueError(f"queries {tuple(queries.shape)} do not fit res {tuple(res.shape)}")
    if res.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError(f"need float32, got {res.dtype} and {queries.dtype}")
    if res.device != queries.device:
        raise ValueError(f"res on {res.device} but queries on {queries.device}")
    if not (res.is_contiguous() and queries.is_contiguous()):
        raise ValueError("res and queries must be contiguous")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"descriptor dimension {D} outside 1..{MAX_D}")
    if not 1 <= HW < 2 ** 31 - 4096:
        raise ValueError(f"pixel count {HW} outside 1..2^31-4097")
    if B > _MAX_GRID_YZ or -(-queries.shape[1] // _QUERIES_PER_BLOCK) > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or query count {queries.shape[1]} too large")


@functools.cache
def _library():
    """The kernel's library, built on first use, with its C signatures."""
    lib = _build.load("best_match")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pdc_best_match.argtypes = [vp] * 7 + [i, i, i, i, i, vp]
    lib.pdc_best_match.restype = i
    lib.pdc_best_match_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.pdc_best_match_plan.restype = i
    lib.pdc_error_string.argtypes = [i]
    lib.pdc_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err):
    if err != 0:
        raise RuntimeError(f"best_match kernel launch failed: "
                           f"{lib.pdc_error_string(err).decode()} (cudaError {err})")


def plan(B: int, D: int, HW: int, Q: int, device: torch.device):
    """The kernel's launch shape on ``device``: ``(slices, query groups,
    queries per group, steps of 1024 pixels per slice)``."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    _raise_on(lib, lib.pdc_best_match_plan(B, D, HW, Q, device.index, out))
    return tuple(out)


_counters = {}  # (device index, stream handle) -> zeroed int32 tensor
_counters_lock = threading.Lock()


def _counter_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero ticket counters for launches on ``stream`` (see
    the module docstring)."""
    with _counters_lock:
        buf = _counters.get((device.index, stream))
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
            _counters[(device.index, stream)] = buf
        return buf


def best_match(res: torch.Tensor, queries: torch.Tensor):
    """Best match of every query in its image; see the module docstring."""
    global launches
    _check(res, queries)
    if res.device.type == "cpu":
        return best_match_reference(res, queries)
    if res.device.type != "cuda":
        raise ValueError(f"best_match runs on cpu or cuda tensors, not {res.device}")
    B, D, HW = res.shape
    Q = queries.shape[1]
    idx = torch.empty((B, Q), dtype=torch.int32, device=res.device)
    dist = torch.empty((B, Q), dtype=torch.float32, device=res.device)
    if Q == 0:
        return idx, dist
    lib = _library()
    slices, groups, per_group, _ = plan(B, D, HW, Q, res.device)
    n_part = B * groups * per_group * slices
    part_val = torch.empty((n_part,), dtype=torch.float32, device=res.device)
    part_idx = torch.empty((n_part,), dtype=torch.int32, device=res.device)
    stream = torch.cuda.current_stream(res.device).cuda_stream
    counters = _counter_buffer(res.device, stream, B * groups)
    _raise_on(lib, lib.pdc_best_match(
        res.data_ptr(), queries.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
        counters.data_ptr(), idx.data_ptr(), dist.data_ptr(), B, D, HW, Q, res.device.index,
        stream))
    launches += 1
    return idx, dist
