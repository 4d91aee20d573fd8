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
  * head: a 1x1 conv with bias; float32 out, also in bfloat16.

``dtype`` is the compute dtype, as in
:class:`~pdc_tpu_torch.models.resnet.ResNetFCN`: the input is cast to it at
entry, the parameters stay float32, and the output is float32 whatever it
is (``pdc_tpu/models/unet.py:46,71``). The JAX UNet has no ``remat``.

Every convolution is an :class:`~pdc_tpu_torch.models.resnet.Int8Conv` on
the float path; :func:`~pdc_tpu_torch.models.resnet.set_quantization`
switches them.
Inputs must have H and W divisible by 16 (640x480 is).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pdc_tpu_torch.models.resnet import FlaxBatchNorm2d, Int8Conv, resize_bilinear


class DoubleConv(nn.Module):
    """Input taken in ``dtype``, the compute dtype (a no-op inside
    :class:`UNet`, whose input is cast at entry)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, n_in in enumerate((in_features, features)):
            self.add_module(f"conv{i}", Int8Conv(n_in, features, 3, padding=1, bias=False))
            self.add_module(f"bn{i}", FlaxBatchNorm2d(features))

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x.to(self.dtype))))
        return F.relu(self.bn1(self.conv1(x)))


class UNet(nn.Module):
    """Input ``[B, 3, H, W]``, output ``[B, num_classes, H, W]`` float32."""

    quant_int8 = quant_static = False  # set by set_quantization

    def __init__(self, num_classes: int, base_features: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        f = base_features
        in_features = 3
        for level in range(4):
            self.add_module(f"down{level}", DoubleConv(in_features, f * 2 ** level, dtype))
            in_features = f * 2 ** level
        self.bottleneck = DoubleConv(in_features, f * 16, dtype)
        in_features = f * 16
        for level in reversed(range(4)):
            feats = f * 2 ** level
            self.add_module(f"up_proj{level}", Int8Conv(in_features, feats, 1, bias=True))
            self.add_module(f"up{level}", DoubleConv(2 * feats, feats, dtype))
            in_features = feats
        self.head = Int8Conv(in_features, num_classes, 1, bias=True)
        self.eval()

    def forward(self, x):
        h, w = x.shape[-2:]
        if h % 16 or w % 16:
            raise ValueError(f"the UNet needs H and W divisible by 16, got input {h}x{w}")
        x = x.to(self.dtype)
        skips = []
        for level in range(4):
            x = getattr(self, f"down{level}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, stride=2)
        x = self.bottleneck(x)
        for level in reversed(range(4)):
            x = resize_bilinear(x, 2 * x.shape[-2], 2 * x.shape[-1])
            x = getattr(self, f"up_proj{level}")(x)
            x = torch.cat([skips[level], x], dim=1)
            x = getattr(self, f"up{level}")(x)
        return self.head(x).to(torch.float32)
