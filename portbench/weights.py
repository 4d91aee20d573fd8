"""Seeded weights, made on the device in one large draw: every convolution
kernel ``lecun_normal`` (a normal truncated to two standard deviations,
variance ``1/fan_in``, flax's default initialiser, which the port's
``init_weights_`` follows), biases 0, BatchNorm scale 1, shift 0, running
mean 0 and variance 1. The state-dict layout is the reference model's;
the same dict is loaded into the program's module and into the
reference."""

from __future__ import annotations

import math

import torch

from portbench.reference.resnet import ResNetFCN
from portbench.seeds import torch_generator

# the standard deviation of the unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def layout(resnet_name: str, descriptor_dimension: int) -> dict:
    """``{name: (shape, dtype)}`` of the network's state dict."""
    with torch.device("meta"):
        m = ResNetFCN(resnet_name, descriptor_dimension)
    return {k: (tuple(v.shape), v.dtype) for k, v in m.state_dict().items()}


def make_weights(resnet_name: str, descriptor_dimension: int, seed: int, device) -> dict:
    """The state dict for ``seed``, on ``device``."""
    spec = layout(resnet_name, descriptor_dimension)
    kernels = [k for k, (shape, _) in spec.items() if len(shape) == 4]
    total = sum(math.prod(spec[k][0]) for k in kernels)
    g = torch_generator(seed, "weights", device)
    u = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    out, at = {}, 0
    for k, (shape, dtype) in spec.items():
        if k in kernels:
            n = math.prod(shape)
            fan_in = shape[1] * shape[2] * shape[3]
            out[k] = (z[at:at + n] * (math.sqrt(1.0 / fan_in) / TRUNC_STD)).view(shape)
            at += n
        elif k.endswith("running_var") or (k.endswith(".weight") and "bn" in k):
            out[k] = torch.ones(shape, dtype=dtype, device=device)
        else:  # biases, running means, batch counts
            out[k] = torch.zeros(shape, dtype=dtype, device=device)
    return out
