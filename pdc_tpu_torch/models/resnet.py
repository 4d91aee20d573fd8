"""Dilated ResNet FCNs (ResNet-18/34/50/101-8s) and the int8 serving
convolution, in PyTorch.

Port of :mod:`pdc_tpu.models.resnet` (``Int8Conv`` :64-107, ``BasicBlock``
:110-155, ``BottleneckBlock`` :157-204, ``space_to_batch`` /
``batch_to_space`` :207-223, ``ResNetFCN`` :226-328, the factories
:336-364): a ResNet whose last stages trade stride for dilation, a 1x1
descriptor head with bias, and a bilinear upsample back to the input size.

NCHW inside, as PyTorch convolutions expect; the flax module names are kept
as attribute names so :mod:`pdc_tpu_torch.models.convert` maps weights per
leaf. What must equal flax:

  * padding: 3x3 convs pad by their dilation, the 7x7/2 stem by 3, 1x1
    convs by 0 (flax ``SAME`` on a 1x1 kernel pads nothing);
  * BatchNorm eps 1e-5; in eval mode the running statistics, in train
    mode flax's rule (:class:`FlaxBatchNorm2d`);
  * max-pool 3x3/2 with padding 1 (padded with -inf in both);
  * upsample ``F.interpolate(mode="bilinear", align_corners=False)``, which
    matches ``jax.image.resize(..., "linear")`` to ~2e-5
    (``tests/test_torch_import_numerics.py:95-134``); in bfloat16,
    :func:`resize_bilinear` computes it as XLA does.

The mode is torch's: ``module.train()`` normalises with the statistics of
the batch in hand and updates the running ones, ``module.eval()`` (the
default after construction) uses the running ones. Every convolution is an
:class:`Int8Conv`; its int8 path runs only in eval mode, as the JAX package
applies it only with ``train=False``.

``dtype=torch.bfloat16`` is flax's mixed precision (``dtype=jnp.bfloat16``):
the parameters and BatchNorm's running statistics stay float32, the input
is cast to bfloat16 at entry, every convolution casts its kernel to
bfloat16 and returns bfloat16 (a bias is added after the rounding, in
bfloat16, as flax adds it), BatchNorm computes its statistics and the
normalisation in float32 and rounds its output once (flax's
``force_float32_reductions``), and the bilinear upsample returns bfloat16
(:func:`resize_bilinear`), so the descriptor image is bfloat16 as in JAX.

``remat=True`` recomputes each residual block in the backward
(``torch.utils.checkpoint``, flax's ``nn.remat``), in train mode with
gradients only; the recomputation leaves BatchNorm's running statistics
alone, so they move once per forward (:func:`remat_block`).
"""

from __future__ import annotations

import contextlib
import copy
import math
import threading
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from pdc_tpu_torch.ops.int8_conv import int8_conv2d


# set while torch.utils.checkpoint recomputes a block (remat_block); per
# thread, since the backward may run on an autograd worker thread
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    before = getattr(_recompute, "active", False)
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = before


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)``, its activations recomputed in the backward instead of
    kept (flax's ``nn.remat``). The recomputation runs under a marker that
    :class:`FlaxBatchNorm2d` reads, so the running statistics are updated by
    the forward alone, as flax discards the recomputed update."""
    return torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False,
                                             context_fn=_remat_contexts)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's train-mode rule (``nn.BatchNorm(momentum=0.9)``,
    ``pdc_tpu/models/resnet.py:132,142,151,268``): normalise with the
    biased variance of the batch, and update the running statistics as
    ``ra = 0.9 * ra + 0.1 * batch_stat`` with that same biased variance.
    Torch's own update uses the unbiased variance, so ``F.batch_norm`` is
    only used in eval mode on float32 input.

    A bfloat16 input is normalised in float32, statistics included, and the
    output rounded to bfloat16 once (flax's ``force_float32_reductions``),
    in both modes. Inside a remat recomputation (:func:`remat_block`) the
    running statistics are not updated again."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def _normalize(self, x, mean, var):
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]

    def forward(self, x):
        dtype = x.dtype
        if not self.training:
            if dtype == torch.float32:
                return super().forward(x)
            return self._normalize(x.to(torch.float32), self.running_mean,
                                   self.running_var).to(dtype)
        xf = x.to(torch.float32)
        # flax's fast variance: E[x^2] - E[x]^2, clipped at 0
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        if not getattr(_recompute, "active", False):
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        return self._normalize(xf, mean, var).to(dtype)


# "/ 127" as the JAX package computes it: XLA compiles a division by a
# constant into a multiplication by its float32 reciprocal, so every "x / 127"
# of pdc_tpu/models/resnet.py:64-107 is "x * fl(1/127)" in its jitted forward
INV_127 = 1.0 / 127.0  # rounds to fl(1/127) where it meets a float32 tensor


class Int8Conv(nn.Conv2d):
    """``nn.Conv2d`` with the int8 post-training-quantized serving path.

    Built on the float path; :func:`set_quantization` switches it. On the
    float path (``quant_int8`` False), and always in train mode, it IS
    ``nn.Conv2d``: the same parameters, and gradients of the float path.
    Otherwise, as ``pdc_tpu/models/resnet.py:64-107`` computes it:

      * activation scale: dynamic ``s_x = max(max|x|, 1e-8) / 127`` over the
        whole tensor, batch included (so a frame's descriptors depend on the
        rest of its batch); ``/ 127`` here and below is the multiplication
        by ``fl(1/127)`` that XLA makes of it (:data:`INV_127`); static
        (``quant_static``) ``s_x = max(act_scale, 1e-8)`` from the
        calibrated ``act_scale`` buffer (flax's ``quant_scales``
        collection, initial value 0);
      * weights: per output channel ``s_w = max(max|w| over (in, kh, kw),
        1e-8) / 127``;
      * ``q = clamp(round(v / s), -127, 127)`` as int8 (a division, and
        round half to even, as ``jnp.round``);
      * the s8 x s8 -> s32 product (:func:`~pdc_tpu_torch.ops.int8_conv.int8_conv2d`),
        then ``y * (s_x * s_w) + bias`` in float32, returned in the input's
        dtype (bfloat16 in a bfloat16 network).

    While ``calibrating`` (a static clone during
    ``DCN.calibrate_quantization``) the layer first raises ``act_scale`` to
    ``max|x| / 127`` of the input in hand, then quantizes with the updated
    scale, so later layers observe activations that already went through
    int8. ``act_scale`` is part of the ``state_dict`` only in a static layer.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calibrating = False
        self.register_buffer("act_scale", torch.zeros((), dtype=torch.float32))
        self.set_quantization(False, False)

    def set_quantization(self, quant_int8: bool, quant_static: bool):
        self.quant_int8, self.quant_static = bool(quant_int8), bool(quant_static)
        # re-registering keeps the value and sets whether the state_dict holds it
        self.register_buffer("act_scale", self.act_scale,
                             persistent=self.quant_int8 and self.quant_static)

    def forward(self, x):
        if not self.quant_int8 or self.training:
            if x.dtype == self.weight.dtype:
                return super().forward(x)
            # flax's mixed precision: the kernel cast to the input's compute
            # dtype, the product rounded to it, then the bias added in it
            y = self._conv_forward(x, self.weight.to(x.dtype), None)
            return y if self.bias is None else y + self.bias.to(x.dtype)[None, :, None, None]
        if self.groups != 1:
            raise ValueError("the int8 path has no grouped convolutions")
        xf = x.to(torch.float32)
        if self.quant_static:
            if self.calibrating:
                with torch.no_grad():
                    self.act_scale.copy_(torch.maximum(self.act_scale, xf.abs().amax() * INV_127))
            s_x = torch.clamp(self.act_scale, min=1e-8)
        else:
            s_x = torch.clamp(xf.abs().amax(), min=1e-8) * INV_127
        xq = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
        w = self.weight.to(torch.float32)
        s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-8) * INV_127
        wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127).to(torch.int8)
        y = int8_conv2d(xq, wq, self.stride, self.padding, self.dilation)
        # contiguous NCHW, as F.conv2d's output (the _int_mm route's is a
        # channels-last view, which consumers of the module's output do not take)
        out = y.to(torch.float32, memory_format=torch.contiguous_format) \
            * (s_x * s_w)[None, :, None, None]
        if self.bias is not None:
            out = out + self.bias.to(torch.float32)[None, :, None, None]
        return out.to(x.dtype)  # flax: out.astype(self.dtype or x.dtype)


def int8_convs(module: nn.Module):
    """``[(name, Int8Conv)]`` of ``module``, in registration order."""
    return [(n, m) for n, m in module.named_modules() if isinstance(m, Int8Conv)]


def set_quantization(module: nn.Module, quant_int8: bool, quant_static: bool = False):
    """Switch every :class:`Int8Conv` of ``module`` (and the module's own
    ``quant_int8``/``quant_static`` fields) to the given path."""
    for _, conv in int8_convs(module):
        conv.set_quantization(quant_int8, quant_static)
    module.quant_int8, module.quant_static = bool(quant_int8), bool(quant_static)
    return module


def quantized_copy(module: nn.Module, static: bool = False) -> nn.Module:
    """A copy of ``module`` that SHARES its parameters and BatchNorm
    statistics (the same tensors) and runs the int8 path, with its own
    ``act_scale`` buffers at 0. ``module`` itself is left as it was."""
    memo = {id(t): t for t in module.parameters()}
    memo.update({id(b): b for n, b in module.named_buffers() if not n.endswith("act_scale")})
    clone = copy.deepcopy(module, memo)
    for _, conv in int8_convs(clone):
        conv.act_scale = torch.zeros_like(conv.act_scale)
        conv.calibrating = False
    return set_quantization(clone, True, static)


def _conv(in_f, out_f, k, stride=1, padding=0, dilation=1, bias=False):
    return Int8Conv(in_f, out_f, k, stride=stride, padding=padding, dilation=dilation,
                    bias=bias)


class BasicBlock(nn.Module):
    """ResNet v1 basic block with optional dilation (stages 3/4 of -8s).
    The input is taken in ``dtype``, the compute dtype (a no-op inside
    :class:`ResNetFCN`, whose input is cast at entry)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(in_features, features, 3, stride, dilation, dilation)
        self.bn1 = FlaxBatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1, dilation, dilation)
        self.bn2 = FlaxBatchNorm2d(features)
        self.proj_conv: Optional[nn.Conv2d] = None
        self.proj_bn: Optional[FlaxBatchNorm2d] = None
        if in_features != features or stride != 1:
            self.proj_conv = _conv(in_features, features, 1, stride)
            self.proj_bn = FlaxBatchNorm2d(features)

    def forward(self, x):
        x = x.to(self.dtype)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.proj_conv is None else self.proj_bn(self.proj_conv(x))
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 reduce, then the 3x3 carries the stride
    and the dilation, then 1x1 expand x4 (torchvision's ``Bottleneck``)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        out_features = 4 * features
        self.conv1 = _conv(in_features, features, 1)
        self.bn1 = FlaxBatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride, dilation, dilation)
        self.bn2 = FlaxBatchNorm2d(features)
        self.conv3 = _conv(features, out_features, 1)
        self.bn3 = FlaxBatchNorm2d(out_features)
        self.proj_conv: Optional[nn.Conv2d] = None
        self.proj_bn: Optional[FlaxBatchNorm2d] = None
        if in_features != out_features or stride != 1:
            self.proj_conv = _conv(in_features, out_features, 1, stride)
            self.proj_bn = FlaxBatchNorm2d(out_features)

    def forward(self, x):
        x = x.to(self.dtype)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj_conv is None else self.proj_bn(self.proj_conv(x))
        return F.relu(y + residual)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_in, n_out]`` float32 weights of ``jax.image.resize``'s linear
    kernel along one axis (``compute_weight_mat``, upsampling, no
    translation): each output sample ``(j + 0.5) * n_in/n_out - 0.5`` takes
    the tent ``max(0, 1 - |s - i|)`` of the inputs, normalised per output."""
    scale = torch.tensor(n_out / n_in, dtype=torch.float32)
    s = (torch.arange(n_out, dtype=torch.float32) + 0.5) * (1.0 / scale) - 0.5
    w = torch.clamp(1.0 - (s[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs(),
                    min=0.0)
    return (w / w.sum(dim=0, keepdim=True)).to(device)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of ``[B, C, h0, w0]`` to ``[B, C, h, w]``
    (``align_corners=False``), in ``x``'s dtype.

    float32: ``F.interpolate``, within ~2e-5 of ``jax.image.resize``.
    bfloat16: ``jax.image.resize``'s own computation, which is separable:
    the weights rounded to bfloat16, the width contracted first and the
    result rounded to bfloat16, then the height (two bfloat16 matmuls, each
    output the sum of two exact products). This gives XLA's bits;
    ``F.interpolate`` on bfloat16 rounds once and differs from it in a
    bfloat16 ulp on about a quarter of the outputs."""
    if x.dtype == torch.float32:
        return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    ww = _resize_weights(x.shape[-1], w, x.device).to(x.dtype)
    wh = _resize_weights(x.shape[-2], h, x.device).to(x.dtype)
    return torch.matmul(wh.t(), torch.matmul(x, ww))


def space_to_batch(x: torch.Tensor, d: int) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[d*d*B, C, H/d, W/d]``: pixels split by their
    residue mod ``d``, residues outermost. A 3x3 conv with dilation ``d``
    and padding ``d`` equals a dense 3x3 conv with padding 1 on every
    subgrid, zero padding included."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // d, d, w // d, d).permute(3, 5, 0, 1, 2, 4)
    return x.reshape(d * d * b, c, h // d, w // d)


def batch_to_space(x: torch.Tensor, d: int, b: int) -> torch.Tensor:
    """Inverse of :func:`space_to_batch` for a batch of ``b``."""
    _, c, h, w = x.shape
    x = x.reshape(d, d, b, c, h, w).permute(2, 3, 4, 0, 5, 1)
    return x.reshape(b, c, h * d, w * d)


class ResNetFCN(nn.Module):
    """Dilated ResNet FCN; ``output_stride`` 8 dilates stages 3 and 4.

    ``stage_sizes=(3, 4, 6, 3)`` is ResNet-34 (or ResNet-50 with
    ``bottleneck=True``), ``(2, 2, 2, 2)`` ResNet-18, ``(3, 4, 23, 3)`` with
    ``bottleneck=True`` ResNet-101. Input ``[B, 3, H, W]`` float32, output
    ``[B, num_classes, H, W]``.

    ``dilated_s2b`` (output stride 8 only) runs stages 3 and 4 as dense 3x3
    convs in space-to-batch layout: one 2x split on entering each, both
    undone (inner split first) before the head's upsample. The same
    parameters give the dilated model's output; BatchNorm's statistics are
    taken over the same pixels. ``H/8`` and ``W/8`` must be divisible by 4.
    Every convolution is an :class:`Int8Conv` on the float path;
    :func:`set_quantization` switches them all.

    ``dtype`` is the compute dtype (float32 or bfloat16, flax's ``dtype``;
    the parameters stay float32) and the output's. ``remat`` recomputes each
    residual block in the backward (:func:`remat_block`) when the module is
    in train mode and gradients are on.
    """

    quant_int8 = quant_static = False  # set by set_quantization

    _LAYOUTS = {8: ((1, 2, 1, 1), (1, 1, 2, 4)),
                16: ((1, 2, 2, 1), (1, 1, 1, 2)),
                32: ((1, 2, 2, 2), (1, 1, 1, 1))}

    def __init__(self, num_classes: int, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 8, bottleneck: bool = False, dilated_s2b: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, bool(remat)
        if output_stride not in self._LAYOUTS:
            raise ValueError(f"output_stride must be 8, 16 or 32, got {output_stride}")
        strides, dilations = self._LAYOUTS[output_stride]
        self.use_s2b = bool(dilated_s2b) and output_stride == 8
        if self.use_s2b:
            dilations = (1, 1, 1, 1)  # dense convs in space-to-batch layout
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        self.stem_conv = _conv(3, 64, 7, 2, 3)
        self.stem_bn = FlaxBatchNorm2d(64)
        self.stage_blocks = []
        in_features = 64
        for stage, (blocks, feats) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            names = []
            for block in range(blocks):
                name = f"stage{stage + 1}_block{block}"
                self.add_module(name, block_cls(
                    in_features, feats,
                    stride=strides[stage] if block == 0 else 1,
                    dilation=dilations[stage], dtype=dtype))
                names.append(name)
                in_features = feats * block_cls.expansion
            self.stage_blocks.append(names)
        self.head = _conv(in_features, num_classes, 1, bias=True)
        self.eval()

    def forward(self, x):
        batch, in_h, in_w = x.shape[0], x.shape[-2], x.shape[-1]
        if self.use_s2b and ((in_h // 8) % 4 or (in_w // 8) % 4):
            raise ValueError(f"dilated_s2b needs H/8 and W/8 divisible by 4, got "
                             f"input {in_h}x{in_w}")
        x = x.to(self.dtype)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage, names in enumerate(self.stage_blocks):
            if self.use_s2b and stage >= 2:
                x = space_to_batch(x, 2)
            for name in names:
                block = getattr(self, name)
                x = remat_block(block, x) if remat else block(x)
        x = self.head(x)
        if self.use_s2b:
            x = batch_to_space(batch_to_space(x, 2, 4 * batch), 2, batch)
        # in the compute dtype, as the JAX package returns it
        return resize_bilinear(x, in_h, in_w)


def ResNet34_8s(num_classes: int, dilated_s2b: bool = False,
                dtype: torch.dtype = torch.float32, remat: bool = False) -> ResNetFCN:
    """The CoRL-2018 default backbone."""
    return ResNetFCN(num_classes, stage_sizes=(3, 4, 6, 3), output_stride=8,
                     dilated_s2b=dilated_s2b, dtype=dtype, remat=remat)


def ResNet18_8s(num_classes: int, dilated_s2b: bool = False,
                dtype: torch.dtype = torch.float32, remat: bool = False) -> ResNetFCN:
    return ResNetFCN(num_classes, stage_sizes=(2, 2, 2, 2), output_stride=8,
                     dilated_s2b=dilated_s2b, dtype=dtype, remat=remat)


def ResNet50_8s(num_classes: int, dilated_s2b: bool = False,
                dtype: torch.dtype = torch.float32, remat: bool = False) -> ResNetFCN:
    return ResNetFCN(num_classes, stage_sizes=(3, 4, 6, 3), output_stride=8,
                     bottleneck=True, dilated_s2b=dilated_s2b, dtype=dtype, remat=remat)


def ResNet101_8s(num_classes: int, dilated_s2b: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False) -> ResNetFCN:
    """The deeper variant of the paper's backbone ablation."""
    return ResNetFCN(num_classes, stage_sizes=(3, 4, 23, 3), output_stride=8,
                     bottleneck=True, dilated_s2b=dilated_s2b, dtype=dtype, remat=remat)


def _truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    # inverse-CDF sampling of N(0, std^2) truncated to [-2 std, 2 std]
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    with torch.no_grad():
        t.copy_((z * std).to(t.dtype))


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation of the convolutions with flax's defaults:
    kernels ``lecun_normal`` (truncated normal, variance 1/fan_in), biases 0.
    Draws on the CPU from ``generator`` so the weights do not depend on the
    device. BatchNorm keeps torch's initial values, which are flax's too
    (scale 1, bias 0, mean 0, var 1)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            # flax divides by the std of the [-2, 2]-truncated unit normal
            _truncated_normal_(m.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                               generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module
