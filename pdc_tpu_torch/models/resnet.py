"""Dilated ResNet FCN (ResNet-18/34-8s) in PyTorch, eval mode.

Port of :mod:`pdc_tpu.models.resnet` (``BasicBlock`` :110-155, ``ResNetFCN``
:226-328, ``ResNet18_8s``/``ResNet34_8s`` :336-349): a ResNet whose last
stages trade stride for dilation, a 1x1 descriptor head with bias, and a
bilinear upsample back to the input size.

NCHW inside, as PyTorch convolutions expect; the flax module names are kept
as attribute names so :mod:`pdc_tpu_torch.models.convert` maps weights per
leaf. What must equal flax:

  * padding: 3x3 convs pad by their dilation, the 7x7/2 stem by 3, 1x1
    convs by 0 (flax ``SAME`` on a 1x1 kernel pads nothing);
  * BatchNorm eps 1e-5, running statistics only;
  * max-pool 3x3/2 with padding 1 (padded with -inf in both);
  * upsample ``F.interpolate(mode="bilinear", align_corners=False)``, which
    matches ``jax.image.resize(..., "linear")`` to ~2e-5
    (``tests/test_torch_import_numerics.py:95-134``).

Only eval-mode BatchNorm is ported: flax updates its running variance with
the biased batch variance where torch uses the unbiased one, so training
waits for the training slice and raises here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_TRAIN_MSG = ("train-mode BatchNorm is not ported yet: it waits for the "
              "training slice (flax's running-variance rule differs from "
              "torch's)")


class BasicBlock(nn.Module):
    """ResNet v1 basic block with optional dilation (stages 3/4 of -8s)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.proj_conv: Optional[nn.Conv2d] = None
        self.proj_bn: Optional[nn.BatchNorm2d] = None
        if in_features != features or stride != 1:
            self.proj_conv = nn.Conv2d(in_features, features, 1, stride=stride,
                                       bias=False)
            self.proj_bn = nn.BatchNorm2d(features, eps=1e-5)

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
        self.stem_bn = nn.BatchNorm2d(64, eps=1e-5)
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

    def forward(self, x, train: bool = False):
        if train or self.training:
            raise NotImplementedError(_TRAIN_MSG)
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
