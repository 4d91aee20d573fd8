"""The dilated ResNet FCNs of Dense Object Nets (Florence et al., CoRL
2018), as published: a ResNet (He et al. 2016) whose stages 3 and 4 trade
stride for dilation (output stride 8), a 1x1 descriptor head with a bias,
and a bilinear upsample (half-pixel centres) back to the input size.
Basic blocks for ResNet-34, v1.5 bottlenecks (stride on the 3x3) for
ResNet-101. BatchNorm (eps 1e-5) normalises in train mode with the biased
variance of the batch, ``E[x^2] - E[x]^2`` clipped at 0, and moves the
running statistics as ``0.9 * running + 0.1 * batch``; in eval mode it
uses the running statistics. Attribute names follow the state-dict layout
that the benchmark's weights are made in (:mod:`portbench.weights`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

ARCHS = {
    # name: (blocks per stage, bottleneck)
    "Resnet34_8s": ((3, 4, 6, 3), False),
    "Resnet101_8s": ((3, 4, 23, 3), True),
}
EPS = 1e-5
MOMENTUM = 0.9


class BatchNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * mean)
                self.running_var.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + EPS) * self.weight
        return (x - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]


def conv(c_in, c_out, k, stride=1, padding=0, dilation=1, bias=False):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding, dilation=dilation,
                     bias=bias)


class Basic(nn.Module):
    def __init__(self, c_in, feats, stride, dilation):
        super().__init__()
        self.conv1 = conv(c_in, feats, 3, stride, dilation, dilation)
        self.bn1 = BatchNorm(feats)
        self.conv2 = conv(feats, feats, 3, 1, dilation, dilation)
        self.bn2 = BatchNorm(feats)
        self.proj_conv = self.proj_bn = None
        if c_in != feats or stride != 1:
            self.proj_conv = conv(c_in, feats, 1, stride)
            self.proj_bn = BatchNorm(feats)
        self.out = feats

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.proj_conv is None else self.proj_bn(self.proj_conv(x))
        return F.relu(y + r)


class Bottleneck(nn.Module):
    def __init__(self, c_in, feats, stride, dilation):
        super().__init__()
        out = 4 * feats
        self.conv1 = conv(c_in, feats, 1)
        self.bn1 = BatchNorm(feats)
        self.conv2 = conv(feats, feats, 3, stride, dilation, dilation)
        self.bn2 = BatchNorm(feats)
        self.conv3 = conv(feats, out, 1)
        self.bn3 = BatchNorm(out)
        self.proj_conv = self.proj_bn = None
        if c_in != out or stride != 1:
            self.proj_conv = conv(c_in, out, 1, stride)
            self.proj_bn = BatchNorm(out)
        self.out = out

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.proj_conv is None else self.proj_bn(self.proj_conv(x))
        return F.relu(y + r)


class ResNetFCN(nn.Module):
    """``[B, 3, H, W]`` normalised images -> ``[B, D, H, W]`` descriptors."""

    def __init__(self, resnet_name: str, descriptor_dimension: int):
        super().__init__()
        stage_sizes, bottleneck = ARCHS[resnet_name]
        block = Bottleneck if bottleneck else Basic
        self.stem_conv = conv(3, 64, 7, 2, 3)
        self.stem_bn = BatchNorm(64)
        self.blocks = []
        c = 64
        for s, (n, feats) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            stride, dilation = ((1, 1), (2, 1), (1, 2), (1, 4))[s]
            for b in range(n):
                name = f"stage{s + 1}_block{b}"
                m = block(c, feats, stride if b == 0 else 1, dilation)
                self.add_module(name, m)
                self.blocks.append(name)
                c = m.out
        self.head = conv(c, descriptor_dimension, 1, bias=True)

    def forward(self, x):
        h, w = x.shape[-2:]
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return F.interpolate(self.head(x), size=(h, w), mode="bilinear", align_corners=False)
