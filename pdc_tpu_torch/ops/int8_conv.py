"""The integer product of the int8 serving convolution: s8 x s8 -> s32.

Counterpart of the ``lax.conv_general_dilated(..., preferred_element_type=
jnp.int32)`` call of ``pdc_tpu/models/resnet.py:89-97`` (``Int8Conv``). That
call is XLA in the JAX package, not a Pallas kernel, so this op has no row in
the table of TPU kernels.

``int8_conv2d(xq, wq, stride, padding, dilation)`` takes int8 activations
``[B, C, H, W]`` and int8 weights ``[O, C, KH, KW]`` and returns the exact
int32 sums ``[B, O, Ho, Wo]`` of the convolution (zero padding). On a CPU
tensor it runs :func:`int8_conv2d_reference`; on a CUDA tensor it runs
:func:`int8_conv2d_int_mm`, an implicit GEMM whose product is
``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32 on the int8 tensor cores), or
raises: there is no fallback.

Both are exact. Every sum is at most ``127^2 * K`` in magnitude, with
``K = C*KH*KW`` at most 9216 (the UNet's ``up3`` convolution), far inside
int32 and inside float64's 2^53, so the float64 version's sums are integers
whatever the order of summation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm calls made by int8_conv2d() on CUDA tensors (read by chip_smoke.py)
launches = 0


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv2d_reference(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0,
                          dilation=1) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in float64 on the integer values, cast to
    int32 (exact, see the module's note)."""
    y = F.conv2d(xq.to(torch.float64), wq.to(torch.float64), None, _pair(stride),
                 _pair(padding), _pair(dilation))
    return y.to(torch.int32)


def _patches(xq, kernel, stride, padding, dilation):
    """im2col of ``xq [B, C, H, W]``: ``([B*Ho*Wo, KH*KW*C], Ho, Wo)``, each row
    the zero-padded input under one output pixel, in (kh, kw, c) order."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    x = xq.permute(0, 2, 3, 1)  # [B, H, W, C]
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    p = x.unfold(1, dh * (kh - 1) + 1, sh).unfold(2, dw * (kw - 1) + 1, sw)
    if dh > 1 or dw > 1:
        p = p[..., ::dh, ::dw]  # [B, Ho, Wo, C, KH, KW]
    b, ho, wo = p.shape[:3]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, -1), ho, wo


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv2d_int_mm(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0,
                       dilation=1) -> torch.Tensor:
    """Implicit GEMM: the patches ``[M, K]`` of ``xq`` times the weights
    ``[K, N]`` through ``torch._int_mm``. ``_int_mm`` asks for ``M > 16``
    and ``K``, ``N`` multiples of 8; the operands are padded with zeros to
    that, which leaves every sum as it is, and the padding is cut off the
    result. The patches go in row-major and the weights column-major (the
    ``[N, K]`` rows, transposed): cuBLASLt's int8 tensor-core kernels take
    only that "TN" layout, and with both row-major it finds no kernel for
    some shapes."""
    O, C, kh, kw = wq.shape
    a, ho, wo = _patches(xq, (kh, kw), _pair(stride), _pair(padding), _pair(dilation))
    M, K = a.shape
    Mp = M if M > 16 and M % 8 == 0 else max(24, _round_up(M, 8))
    Kp, Np = _round_up(K, 8), _round_up(O, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    b = wq.permute(0, 2, 3, 1).reshape(O, K)  # (kh, kw, c) order, as the patches
    if (Np, Kp) != (O, K):
        b = F.pad(b, (0, Kp - K, 0, Np - O))
    y = torch._int_mm(a.contiguous(), b.contiguous().t())  # [Mp, Np] int32
    return y[:M, :O].reshape(xq.shape[0], ho, wo, O).permute(0, 3, 1, 2)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0,
                dilation=1) -> torch.Tensor:
    """Exact int32 convolution of int8 ``xq [B, C, H, W]`` by int8
    ``wq [O, C, KH, KW]``: the plain version on a CPU tensor, the
    ``torch._int_mm`` route on a CUDA tensor."""
    global launches
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"need int8 operands, got {xq.dtype} and {wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"need xq [B, C, H, W] and wq [O, C, KH, KW], got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if xq.device != wq.device:
        raise ValueError(f"xq on {xq.device} but wq on {wq.device}")
    if xq.device.type == "cpu":
        return int8_conv2d_reference(xq, wq, stride, padding, dilation)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv2d runs on CPU or CUDA tensors, not {xq.device}")
    y = int8_conv2d_int_mm(xq, wq, stride, padding, dilation)
    launches += 1
    return y
