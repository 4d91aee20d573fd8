"""Multi-head attention of the ViT backbone (``models/dinov2.py``), K4: the
CUDA flash-attention kernels' wrapper and their plain PyTorch version.

``flash_attention(qkv, num_heads, scale)`` takes the qkv projection's
output ``[B, N, 3*C]`` as it lies (``[B, N, 3, heads, d]``: q, k, v, then
the heads, ``d = C / heads``) and returns ``[B, N, C]`` (``[B, N, heads,
d]``, ready for the output projection):

    o[b, n, h] = softmax_m(scale * q[b, n, h] . k[b, m, h]) v[b, m, h]

On CPU tensors it runs the plain version (:func:`attention_reference`),
which autograd differentiates; on CUDA tensors it launches the kernels of
``pdc_tpu_torch/csrc/flash_attention.cu`` or raises (a dtype other than
float32 or bfloat16, ``d`` not a multiple of 16 up to 128, a last dimension
that is not contiguous, a pointer or row stride off 16 bytes). There is no
fallback. The kernels' header gives what they replace (no TPU kernel: the
JAX package has no ViT), their bound on the card and their design: one
forward launch a call (o and the rows' log-sum-exp) and a backward of two
(dq with the rows' ``rowsum(do * o)``, then dk and dv), no ``N x N`` tensor
kept, q, k and v read where the projection put them and the gradient
written as one ``[B, N, 3*C]`` tensor.

Arithmetic: float32 products run at split-fp32 (three TF32 products,
:data:`FLOAT32_PRECISION`), never plain TF32; bfloat16 inputs take one
product each with fp32 accumulation; the softmax and the accumulators are
fp32. The path follows the input's dtype; there is no knob.

The kernels are registered as the operators ``pdc_tpu::flash_attention``
and ``pdc_tpu::flash_attention_backward`` (``torch.library``), with shape
functions, so ``torch.export`` traces a ViT through them; a program so
exported runs where this module has been imported. Their launches are
counted in :data:`forward_launches` and :data:`backward_launches` (a
backward pass counts once), CUDA graphs included (``ops/launches.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from pdc_tpu_torch.ops import _build, launches

# kernel launches on CUDA tensors, replays of captured launches included:
# forward launches and backward passes (two launches each)
forward_launches = 0
backward_launches = 0

# the products of float32 inputs: "tf32x3" (split-fp32); "tf32" (one TF32
# product) only for the test that shows split-fp32 is needed
FLOAT32_PRECISION = "tf32x3"
MAX_HEAD_DIM = 128
_MAX_HEADS_TIMES_BATCH = 65535
# (mode, tile, device) on which pdc_flash_prepare has run
_prepared = set()


def attention_reference(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version (same arguments and result): the ``N x N``
    scores written out, ``softmax(q k^T * scale) v``, the softmax in float32
    and its probabilities rounded to the input's dtype before ``p v``.
    Differentiable by autograd."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)
    p = torch.softmax((q @ k.transpose(-2, -1)).float() * scale, dim=-1).to(qkv.dtype)
    return (p @ v).transpose(1, 2).reshape(B, N, C)


@functools.cache
def _library(mode: int, tile: int):
    """The kernels' library for one kind of products (``csrc/flash_attention.cu``'s
    FLASH_MODE: 2 float32 at split-fp32, 1 float32 in plain TF32, 0 bfloat16)
    and head-dim tile (16, 32, 64 or 128), built on first use (seconds: each
    build holds only its own three kernels), with its C signatures. The
    source's own defaults, split-fp32 and 64 (the ViT-L's head dim), are the
    build that ``_build.build_all`` makes."""
    defines = () if (mode, tile) == (2, 64) else (f"FLASH_MODE={mode}", f"FLASH_DIM={tile}")
    lib = _build.load("flash_attention", defines)
    vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.pdc_flash_prepare.argtypes = [i]
    lib.pdc_flash_prepare.restype = i
    lib.pdc_flash_fwd.argtypes = [i, i, vp, vp, vp, i, i, i, i, ll, ll, ll, ll, f, i, vp]
    lib.pdc_flash_fwd.restype = i
    lib.pdc_flash_bwd.argtypes = ([i, i] + [vp] * 6 + [i] * 4 + [ll] * 6 + [f, f, i, vp])
    lib.pdc_flash_bwd.restype = i
    lib.pdc_flash_error_string.argtypes = [i]
    lib.pdc_flash_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, which):
    if err != 0:
        raise RuntimeError(f"flash attention {which} failed: "
                           f"{lib.pdc_flash_error_string(err).decode()} (cudaError {err})")


def _prepared_for(qkv: torch.Tensor, d: int):
    """The library of ``qkv``'s dtype and head dim ``d``, with its kernels'
    shared memory allowed on ``qkv``'s device: once a library and device, at
    its first launch, which is never a capture (a graph is captured after
    eager warm-up steps)."""
    dtype, split = _kind(qkv)
    key = (0 if dtype else 2 if split else 1, 1 << (d - 1).bit_length(), qkv.device.index)
    lib = _library(*key[:2])
    if key not in _prepared:
        _raise_on(lib, lib.pdc_flash_prepare(qkv.device.index), "prepare")
        _prepared.add(key)
    return lib


def _kind(qkv: torch.Tensor):
    """``(dtype code, split)`` of the C interface: float32 0, bfloat16 1;
    split-fp32 products unless :data:`FLOAT32_PRECISION` says otherwise."""
    return int(qkv.dtype == torch.bfloat16), int(FLOAT32_PRECISION == "tf32x3")


def _aligned(*tensors):
    """The kernels copy 16 bytes at a time: every base pointer and row
    stride a multiple of 16 bytes."""
    for x in tensors:
        size = x.element_size()
        if x.data_ptr() % 16 or any((s * size) % 16 for s in x.stride()[:-1]):
            raise ValueError("the attention kernel needs 16-byte aligned rows "
                             f"(pointer {x.data_ptr()}, strides {x.stride()})")


def _sizes(qkv: torch.Tensor, num_heads: int):
    B, N, C3 = qkv.shape
    return B, N, C3 // 3, C3 // (3 * num_heads)


@torch.library.custom_op("pdc_tpu::flash_attention", mutates_args=(), device_types="cuda")
def _attention_op(qkv: torch.Tensor, num_heads: int, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``o [B, N, C]`` and the rows' log-sum-exp (base
    2) ``[B*heads, N]`` float32."""
    B, N, C, d = _sizes(qkv, num_heads)
    dev = qkv.device
    lib = _prepared_for(qkv, d)
    o = torch.empty((B, N, C), dtype=qkv.dtype, device=dev)
    lse = torch.empty((B * num_heads, N), dtype=torch.float32, device=dev)
    _aligned(qkv, o)
    err = lib.pdc_flash_fwd(*_kind(qkv), qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), B, N,
                            num_heads, d, qkv.stride(0), qkv.stride(1), o.stride(0),
                            o.stride(1), scale * math.log2(math.e), dev.index,
                            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "forward kernel launch")
    launches.count(__name__, "forward")
    return o, lse


@_attention_op.register_fake
def _(qkv, num_heads, scale):
    B, N, C, _ = _sizes(qkv, num_heads)
    return (qkv.new_empty((B, N, C)),
            qkv.new_empty((B * num_heads, N), dtype=torch.float32))


@torch.library.custom_op("pdc_tpu::flash_attention_backward", mutates_args=(),
                         device_types="cuda")
def _attention_backward_op(do: torch.Tensor, qkv: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """The two backward kernels: the gradient of ``qkv``, ``[B, N, 3*C]``."""
    B, N, C, d = _sizes(qkv, num_heads)
    dev = qkv.device
    lib = _prepared_for(qkv, d)
    do = do.to(qkv.dtype).contiguous()
    dqkv = torch.empty((B, N, 3 * C), dtype=qkv.dtype, device=dev)
    delta = torch.empty_like(lse)
    _aligned(qkv, o, do, dqkv)
    err = lib.pdc_flash_bwd(*_kind(qkv), qkv.data_ptr(), o.data_ptr(), do.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), B, N, num_heads,
                            d, qkv.stride(0), qkv.stride(1), o.stride(0), o.stride(1),
                            dqkv.stride(0), dqkv.stride(1), scale, scale * math.log2(math.e),
                            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "backward kernel launch")
    launches.count(__name__, "backward")
    return dqkv


@_attention_backward_op.register_fake
def _(do, qkv, o, lse, num_heads, scale):
    return qkv.new_empty(qkv.shape)


def _setup_context(ctx, inputs, output):
    qkv, num_heads, scale = inputs
    o, lse = output
    ctx.save_for_backward(qkv, o, lse)
    ctx.mark_non_differentiable(lse)
    ctx.attention = (num_heads, scale)


def _backward(ctx, do, _dlse):
    qkv, o, lse = ctx.saved_tensors
    return _attention_backward_op(do, qkv, o, lse, *ctx.attention), None, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)


def _check(qkv: torch.Tensor, num_heads: int):
    if not isinstance(qkv, torch.Tensor) or qkv.dim() != 3:
        raise ValueError("flash_attention takes qkv [B, N, 3*C]")
    B, N, C3 = qkv.shape
    if C3 % (3 * num_heads):
        raise ValueError(f"qkv's last dimension {C3} does not split into 3 x {num_heads} heads")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {qkv.device}")
    if qkv.device.type == "cpu":
        return
    d = C3 // (3 * num_heads)
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the attention kernel takes float32 or bfloat16, not {qkv.dtype}")
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head dims that are multiples of 16 up "
                         f"to {MAX_HEAD_DIM}, not {d}")
    if qkv.stride(2) != 1:
        raise ValueError("the attention kernel needs qkv's last dimension contiguous")
    if B * num_heads > _MAX_HEADS_TIMES_BATCH:
        raise ValueError(f"{B} frames of {num_heads} heads: above {_MAX_HEADS_TIMES_BATCH} "
                         "blocks a column of the grid")


def flash_attention(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Attention of the heads in ``qkv [B, N, 3*C]``; see the module
    docstring."""
    _check(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_reference(qkv, num_heads, scale)
    o, _ = _attention_op(qkv, int(num_heads), float(scale))
    return o
