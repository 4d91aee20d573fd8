"""UNet backbone in PyTorch.

Port of :mod:`pdc_tpu.models.unet` (:16-72), the reference's alternative
FCN: a 4-level encoder/decoder with skip connections. NCHW inside; the flax
module names are the attribute names (``down{l}``, ``bottleneck``,
``up_proj{l}``, ``up{l}``, ``head``; ``conv{i}``/``bn{i}`` in each
:class:`DoubleConv`) so :mod:`pdc_tpu_torch.models.convert` maps weights per
leaf.

  * ``DoubleConv``: twice a 3x3 ``SAME`` conv without bias, BatchNorm, ReLU;
  * encoder: 4 levels of ``DoubleConv`` at ``base_features * 2^l``, each
    followed by a 2x2/2 max-pool, then the bottleneck at ``16 * base``;
  * decoder, from level 3 down: a bilinear 2x upsample
    (``F.interpolate(align_corners=False)`` against
    ``jax.image.resize(..., "linear")``), a 1x1 ``up_proj{l}`` with bias,
    ``cat([skip, x])`` in that order, then ``up{l}``;
  * head: a 1x1 conv with bias; float32 out.

Every convolution is an :class:`~pdc_tpu_torch.models.resnet.Int8Conv` on
the float path; :func:`~pdc_tpu_torch.models.resnet.set_quantization`
switches them.
Inputs must have H and W divisible by 16 (640x480 is).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pdc_tpu_torch.models.resnet import FlaxBatchNorm2d, Int8Conv


class DoubleConv(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        for i, n_in in enumerate((in_features, features)):
            self.add_module(f"conv{i}", Int8Conv(n_in, features, 3, padding=1, bias=False))
            self.add_module(f"bn{i}", FlaxBatchNorm2d(features))

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


class UNet(nn.Module):
    """Input ``[B, 3, H, W]`` float32, output ``[B, num_classes, H, W]``."""

    quant_int8 = quant_static = False  # set by set_quantization

    def __init__(self, num_classes: int, base_features: int = 64):
        super().__init__()
        f = base_features
        in_features = 3
        for level in range(4):
            self.add_module(f"down{level}", DoubleConv(in_features, f * 2 ** level))
            in_features = f * 2 ** level
        self.bottleneck = DoubleConv(in_features, f * 16)
        in_features = f * 16
        for level in reversed(range(4)):
            feats = f * 2 ** level
            self.add_module(f"up_proj{level}", Int8Conv(in_features, feats, 1, bias=True))
            self.add_module(f"up{level}", DoubleConv(2 * feats, feats))
            in_features = feats
        self.head = Int8Conv(in_features, num_classes, 1, bias=True)
        self.eval()

    def forward(self, x):
        h, w = x.shape[-2:]
        if h % 16 or w % 16:
            raise ValueError(f"the UNet needs H and W divisible by 16, got input {h}x{w}")
        skips = []
        for level in range(4):
            x = getattr(self, f"down{level}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, stride=2)
        x = self.bottleneck(x)
        for level in reversed(range(4)):
            x = F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]), mode="bilinear",
                              align_corners=False)
            x = getattr(self, f"up_proj{level}")(x)
            x = torch.cat([skips[level], x], dim=1)
            x = getattr(self, f"up{level}")(x)
        return self.head(x).to(torch.float32)
