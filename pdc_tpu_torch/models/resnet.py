"""Dilated ResNet FCN (ResNet-18/34-8s) in PyTorch.

Port of :mod:`pdc_tpu.models.resnet` (``BasicBlock`` :110-155, ``ResNetFCN``
:226-328, ``ResNet18_8s``/``ResNet34_8s`` :336-349): a ResNet whose last
stages trade stride for dilation, a 1x1 descriptor head with bias, and a
bilinear upsample back to the input size.

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
    (``tests/test_torch_import_numerics.py:95-134``).

The mode is torch's: ``module.train()`` normalises with the statistics of
the batch in hand and updates the running ones, ``module.eval()`` (the
default after construction) uses the running ones.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's train-mode rule (``nn.BatchNorm(momentum=0.9)``,
    ``pdc_tpu/models/resnet.py:132,142,151,268``): normalise with the
    biased variance of the batch, and update the running statistics as
    ``ra = 0.9 * ra + 0.1 * batch_stat`` with that same biased variance.
    Torch's own update uses the unbiased variance, so ``F.batch_norm`` is
    only used in eval mode."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        # flax's fast variance: E[x^2] - E[x]^2, clipped at 0
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]


class BasicBlock(nn.Module):
    """ResNet v1 basic block with optional dilation (stages 3/4 of -8s)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn1 = FlaxBatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FlaxBatchNorm2d(features)
        self.proj_conv: Optional[nn.Conv2d] = None
        self.proj_bn: Optional[FlaxBatchNorm2d] = None
        if in_features != features or stride != 1:
            self.proj_conv = nn.Conv2d(in_features, features, 1, stride=stride,
                                       bias=False)
            self.proj_bn = FlaxBatchNorm2d(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.proj_conv is None else self.proj_bn(self.proj_conv(x))
        return F.relu(y + residual)


class ResNetFCN(nn.Module):
    """Dilated ResNet FCN; ``output_stride`` 8 dilates stages 3 and 4.

    ``stage_sizes=(3, 4, 6, 3)`` is ResNet-34, ``(2, 2, 2, 2)`` ResNet-18.
    Input ``[B, 3, H, W]`` float32, output ``[B, num_classes, H, W]``.
    """

    _LAYOUTS = {8: ((1, 2, 1, 1), (1, 1, 2, 4)),
                16: ((1, 2, 2, 1), (1, 1, 1, 2)),
                32: ((1, 2, 2, 2), (1, 1, 1, 1))}

    def __init__(self, num_classes: int, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 8):
        super().__init__()
        if output_stride not in self._LAYOUTS:
            raise ValueError(f"output_stride must be 8, 16 or 32, got {output_stride}")
        strides, dilations = self._LAYOUTS[output_stride]
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = FlaxBatchNorm2d(64)
        self.block_names = []
        in_features = 64
        for stage, (blocks, feats) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            for block in range(blocks):
                name = f"stage{stage + 1}_block{block}"
                self.add_module(name, BasicBlock(
                    in_features, feats,
                    stride=strides[stage] if block == 0 else 1,
                    dilation=dilations[stage]))
                self.block_names.append(name)
                in_features = feats
        self.head = nn.Conv2d(in_features, num_classes, 1, bias=True)
        self.eval()

    def forward(self, x):
        in_h, in_w = x.shape[-2:]
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.head(x)
        return F.interpolate(x, size=(in_h, in_w), mode="bilinear",
                             align_corners=False)


def ResNet34_8s(num_classes: int) -> ResNetFCN:
    """The CoRL-2018 default backbone."""
    return ResNetFCN(num_classes, stage_sizes=(3, 4, 6, 3), output_stride=8)


def ResNet18_8s(num_classes: int) -> ResNetFCN:
    return ResNetFCN(num_classes, stage_sizes=(2, 2, 2, 2), output_stride=8)


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
