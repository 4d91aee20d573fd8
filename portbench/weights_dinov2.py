"""Seeded weights of the DINOv2 descriptor network
(:class:`portbench.reference.dinov2.Dinov2FCN`), made on the device in one
large draw of a unit normal truncated to two deviations, ``z``. No
parameter is constant, so that a dropped register, a missing LayerScale or
a misplaced position changes the result:

- the patch embedding, every linear layer and the head: ``lecun_normal``
  (variance ``1/fan_in``), as the port's convolutions are drawn;
- LayerNorm scales and LayerScale's ``gamma``: ``1 + 0.1 z``;
- biases and LayerNorm shifts: ``0.05 z``;
- the cls and register tokens and the position table: ``0.1 z``.

The state-dict layout is the reference model's; the same dict is loaded
into the program's module and into the reference."""

from __future__ import annotations

import math

import torch

from portbench.reference.dinov2 import Dinov2FCN
from portbench.seeds import torch_generator
from portbench.weights import TRUNC_STD

SCALE_STD, BIAS_STD, TOKEN_STD = 0.1, 0.05, 0.1
TOKENS = ("cls_token", "register_tokens", "pos_embed")


def layout(descriptor_dimension: int, widths: dict) -> dict:
    """``{name: shape}`` of the network's state dict."""
    with torch.device("meta"):
        m = Dinov2FCN(descriptor_dimension, **widths)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def draw(name: str, shape: tuple):
    """``(centre, deviation)`` of the parameter ``name``."""
    if name.endswith(".weight") and len(shape) >= 2:
        return 0.0, math.sqrt(1.0 / math.prod(shape[1:]))
    if name.endswith((".gamma", ".weight")):  # LayerScale, LayerNorm scales
        return 1.0, SCALE_STD
    if name.endswith(".bias"):
        return 0.0, BIAS_STD
    if name in TOKENS:
        return 0.0, TOKEN_STD
    raise ValueError(f"no draw for {name}")


def make_weights(descriptor_dimension: int, widths: dict, seed: int, device) -> dict:
    """The state dict for ``seed``, on ``device``; ``widths`` as the
    configuration's backbone block gives them (its other keys ignored)."""
    widths = {k: v for k, v in widths.items() if k not in ("model_class", "pretrained")}
    spec = layout(descriptor_dimension, widths)
    total = sum(math.prod(s) for s in spec.values())
    g = torch_generator(seed, "weights", device)
    u = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0) / TRUNC_STD
    out, at = {}, 0
    for k, shape in spec.items():
        n = math.prod(shape)
        centre, std = draw(k, shape)
        out[k] = (centre + std * z[at:at + n]).view(shape)
        at += n
    return out
