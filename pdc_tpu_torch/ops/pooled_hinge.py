"""Pooled non-match hinge (K1 forward, K2 backward): the CUDA kernels'
autograd wrapper and their plain PyTorch version.

Counterpart of :mod:`pdc_tpu.ops.pallas_loss` (``pooled_hinge``); the
kernels are ``pdc_tpu_torch/csrc/pooled_hinge.cu``, whose header note gives
their bound on the card and their design.

``pooled_hinge(da, db, mu, mv, mvalid, pu, pv, pvalid, M, use_pix, M_pixel)``
takes a batch of B pairs: match rows ``da [B, Nm, D]``, pool rows
``db [B, P, D]``, the pixel of each row's true match in image b
``mu, mv [B, Nm]``, row validity ``mvalid [B, Nm]``, pool pixels
``pu, pv [B, P]`` and pool validity ``pvalid [B, P]``, all float32 and
contiguous. It returns ``loss [B]`` float32 (differentiable in ``da`` and
``db``) and ``hard [B]`` int64 (the count of hard negatives, no gradient):

    loss_b = sum_ij w_ij * max(M - ||da_i - db_j||, 0)^2 [* pixw_ij]
    hard_b = #{ij : w_ij != 0 and M - ||da_i - db_j|| > 0}

with the collision rule in ``w`` (a pool pixel within 1 px of the row's
true match in u or v is excluded) and, with ``use_pix``,
``pixw = min(pixel distance, M_pixel) / M_pixel``. Distances are summed as
``sum_d (a_d - b_d)^2``, not expanded (see the kernel's header).

A NaN or infinite descriptor gives what the plain version gives: a NaN
loss where a NaN, or the same infinity in one channel of a row and a pool
entry, meets the sum, no hard count for such a pair, and NaN gradients
where ``0 * NaN`` or ``0 * inf`` reaches them (the kernels' header).

On CPU tensors both passes run the plain version; on CUDA tensors they
launch the kernels or raise. There is no fallback.

The kernels may be captured into a CUDA graph, but only inside
:func:`pdc_tpu_torch.ops.launches.recording`, whose replays add the
recorded passes to the launch counts below.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pdc_tpu_torch.ops import _build, launches

MAX_D = 16
_MAX_BATCH = 65535

# kernel launches on CUDA tensors, replays of captured launches included
# (read by chip_smoke.py; counted through ops/launches.py)
forward_launches = 0
backward_launches = 0
# devices on which pdc_pooled_hinge_prepare has run
_prepared = set()


def _tables(da, db, mu, mv, mvalid, pu, pv, pvalid, M, use_pix, M_pixel):
    """The ``[B, Nm, P]`` tables of the plain version, one elementwise op at
    a time in the kernels' order: differences per channel ``t``, ``d2``,
    ``dist``, ``hinge``, weight ``w`` (validity and collision), pixel
    weight ``pixw`` (None without ``use_pix``) and the counted mask."""
    t = [da[:, :, None, d] - db[:, None, :, d] for d in range(da.shape[-1])]
    d2 = None
    for td in t:
        d2 = td * td if d2 is None else d2 + td * td
    dist = torch.sqrt(torch.clamp(d2, min=1e-24))
    hinge = torch.clamp(M - dist, min=0.0)
    du = (mu[:, :, None] - pu[:, None, :]).abs()
    dv = (mv[:, :, None] - pv[:, None, :]).abs()
    w = (mvalid[:, :, None] * pvalid[:, None, :]) * ((du >= 1.0) & (dv >= 1.0)).to(da.dtype)
    pixw = torch.clamp(torch.sqrt(du * du + dv * dv), max=M_pixel) / M_pixel if use_pix else None
    counted = (w != 0) & (hinge > 0)
    return t, d2, dist, hinge, w, pixw, counted


def pooled_hinge_reference(da, db, mu, mv, mvalid, pu, pv, pvalid,
                           M: float, use_pix: bool, M_pixel: float):
    """Plain PyTorch version of K1 (same arguments and results): the full
    ``[B, Nm, P]`` table. Differentiable by autograd in ``da`` and ``db``."""
    _, _, _, hinge, w, pixw, counted = _tables(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                               M, use_pix, M_pixel)
    term = w * hinge * hinge
    if use_pix:
        term = term * pixw
    return term.sum(dim=(1, 2)), counted.sum(dim=(1, 2))


def pooled_hinge_backward_reference(g_loss, da, db, mu, mv, mvalid, pu, pv, pvalid,
                                    M: float, use_pix: bool, M_pixel: float):
    """Plain PyTorch version of K2: ``(gda [B, Nm, D], gdb [B, P, D])`` for
    the loss cotangent ``g_loss [B]``, with
    ``c_ij = -2 w_ij pixw_ij hinge_ij / dist_ij`` where the pair counts and
    ``d2 > 1e-24`` (coincident rows get no gradient), else 0."""
    t, d2, dist, hinge, w, pixw, counted = _tables(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                   M, use_pix, M_pixel)
    wp = w * pixw if use_pix else w
    c = torch.where(counted & (d2 > 1e-24), (-2.0 * wp * hinge) / dist, torch.zeros_like(d2))
    gda = torch.stack([(c * td).sum(dim=2) for td in t], dim=-1)
    gdb = torch.stack([-(c * td).sum(dim=1) for td in t], dim=-1)
    g = g_loss.to(da.dtype)
    return g[:, None, None] * gda, g[:, None, None] * gdb


def _check(da, db, mu, mv, mvalid, pu, pv, pvalid):
    tensors = (da, db, mu, mv, mvalid, pu, pv, pvalid)
    if not all(isinstance(x, torch.Tensor) for x in tensors):
        raise TypeError("pooled_hinge takes torch tensors")
    if da.dim() != 3 or db.dim() != 3:
        raise ValueError(f"need da [B, Nm, D] and db [B, P, D], got {tuple(da.shape)} "
                         f"and {tuple(db.shape)}")
    B, Nm, D = da.shape
    P = db.shape[1]
    if db.shape[0] != B or db.shape[2] != D:
        raise ValueError(f"db {tuple(db.shape)} does not fit da {tuple(da.shape)}")
    for name, x, n in (("mu", mu, Nm), ("mv", mv, Nm), ("mvalid", mvalid, Nm),
                       ("pu", pu, P), ("pv", pv, P), ("pvalid", pvalid, P)):
        if tuple(x.shape) != (B, n):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, need {(B, n)}")
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("pooled_hinge needs float32 tensors")
    if any(x.device != da.device for x in tensors):
        raise ValueError("pooled_hinge's tensors lie on different devices")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("pooled_hinge's tensors must be contiguous")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"descriptor dimension {D} outside 1..{MAX_D}")
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} above {_MAX_BATCH}")
    if da.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pooled_hinge runs on cpu or cuda tensors, not {da.device}")


def _prepared_for(lib, device: torch.device):
    """``lib``, with ``hinge_bwd``'s shared memory allowed on ``device``:
    once a device, at its first launch, which is never a capture (a graph
    is captured after eager warm-up steps)."""
    if device.index not in _prepared:
        _raise_on(lib, lib.pdc_pooled_hinge_prepare(device.index), "prepare")
        _prepared.add(device.index)
    return lib


@functools.cache
def _library():
    """The kernels' library, built on first use, with its C signatures."""
    lib = _build.load("pooled_hinge")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pdc_pooled_hinge_prepare.argtypes = [i]
    lib.pdc_pooled_hinge_prepare.restype = i
    lib.pdc_pooled_hinge_fwd.argtypes = [vp] * 12 + [i, i, i, i, f, i, f, i, vp]
    lib.pdc_pooled_hinge_fwd.restype = i
    lib.pdc_pooled_hinge_bwd.argtypes = [vp] * 12 + [i, i, i, i, f, i, f, i, vp]
    lib.pdc_pooled_hinge_bwd.restype = i
    lib.pdc_pooled_hinge_fwd_partials.argtypes = [i, i, i]
    lib.pdc_pooled_hinge_fwd_partials.restype = ctypes.c_longlong
    lib.pdc_pooled_hinge_bwd_partials.argtypes = [i, i, i, i]
    lib.pdc_pooled_hinge_bwd_partials.restype = ctypes.c_longlong
    lib.pdc_pooled_hinge_threshold.argtypes = [f]
    lib.pdc_pooled_hinge_threshold.restype = f
    lib.pdc_error_string.argtypes = [i]
    lib.pdc_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, which):
    if err != 0:
        raise RuntimeError(f"pooled_hinge {which} failed: "
                           f"{lib.pdc_error_string(err).decode()} (cudaError {err})")


def _forward_kernel(da, db, mu, mv, mvalid, pu, pv, pvalid, M, use_pix, M_pixel):
    B, Nm, D = da.shape
    P = db.shape[1]
    dev = da.device
    lib = _prepared_for(_library(), dev)
    n_part = lib.pdc_pooled_hinge_fwd_partials(B, Nm, D)
    part_loss = torch.empty((n_part,), dtype=torch.float32, device=dev)
    part_hard = torch.empty((n_part,), dtype=torch.int32, device=dev)
    loss = torch.empty((B,), dtype=torch.float32, device=dev)
    hard = torch.empty((B,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pdc_pooled_hinge_fwd(
        da.data_ptr(), db.data_ptr(), mu.data_ptr(), mv.data_ptr(), mvalid.data_ptr(),
        pu.data_ptr(), pv.data_ptr(), pvalid.data_ptr(), part_loss.data_ptr(),
        part_hard.data_ptr(), loss.data_ptr(), hard.data_ptr(),
        B, Nm, P, D, M, int(use_pix), M_pixel, dev.index, stream)
    _raise_on(lib, err, "forward kernel launch")
    launches.count(__name__, "forward")
    return loss, hard


def _backward_kernel(g_loss, da, db, mu, mv, mvalid, pu, pv, pvalid, M, use_pix, M_pixel):
    B, Nm, D = da.shape
    P = db.shape[1]
    dev = da.device
    lib = _prepared_for(_library(), dev)
    part_gdb = torch.empty((lib.pdc_pooled_hinge_bwd_partials(B, Nm, P, D),),
                           dtype=torch.float32, device=dev)
    gda = torch.empty_like(da)
    gdb = torch.empty_like(db)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pdc_pooled_hinge_bwd(
        da.data_ptr(), db.data_ptr(), mu.data_ptr(), mv.data_ptr(), mvalid.data_ptr(),
        pu.data_ptr(), pv.data_ptr(), pvalid.data_ptr(), g_loss.data_ptr(),
        part_gdb.data_ptr(), gda.data_ptr(), gdb.data_ptr(),
        B, Nm, P, D, M, int(use_pix), M_pixel, dev.index, stream)
    _raise_on(lib, err, "backward kernel launch")
    launches.count(__name__, "backward")
    return gda, gdb


class _PooledHinge(torch.autograd.Function):
    """K1 forward, K2 backward. The forward saves only its inputs; the
    backward recomputes the table tile by tile, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, da, db, mu, mv, mvalid, pu, pv, pvalid, M, use_pix, M_pixel):
        ctx.hinge = (M, use_pix, M_pixel)
        ctx.save_for_backward(da, db, mu, mv, mvalid, pu, pv, pvalid)
        if da.shape[1] == 0 or db.shape[1] == 0:
            loss = da.new_zeros(da.shape[0])
            hard = torch.zeros(da.shape[0], dtype=torch.int64, device=da.device)
        elif da.device.type == "cpu":
            launches.record(__name__, "forward")
            loss, hard = pooled_hinge_reference(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                M, use_pix, M_pixel)
        else:
            loss, hard = _forward_kernel(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                         M, use_pix, M_pixel)
        ctx.mark_non_differentiable(hard)
        return loss, hard

    @staticmethod
    def backward(ctx, g_loss, _g_hard):
        da, db, mu, mv, mvalid, pu, pv, pvalid = ctx.saved_tensors
        M, use_pix, M_pixel = ctx.hinge
        g_loss = g_loss.to(torch.float32).contiguous()
        if da.shape[1] == 0 or db.shape[1] == 0:
            gda, gdb = torch.zeros_like(da), torch.zeros_like(db)
        elif da.device.type == "cpu":
            launches.record(__name__, "backward")
            gda, gdb = pooled_hinge_backward_reference(g_loss, da, db, mu, mv, mvalid,
                                                       pu, pv, pvalid, M, use_pix, M_pixel)
        else:
            gda, gdb = _backward_kernel(g_loss, da, db, mu, mv, mvalid, pu, pv, pvalid,
                                        M, use_pix, M_pixel)
        return (gda, gdb) + (None,) * 9


def pooled_hinge(da, db, mu, mv, mvalid, pu, pv, pvalid,
                 M: float, use_pix: bool, M_pixel: float):
    """Pooled hinge of a batch of pairs; see the module docstring."""
    _check(da, db, mu, mv, mvalid, pu, pv, pvalid)
    return _PooledHinge.apply(da, db, mu, mv, mvalid, pu, pv, pvalid,
                              float(M), bool(use_pix), float(M_pixel))
