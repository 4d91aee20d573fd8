"""DINOv2 ViT-L/14 with registers as a dense-descriptor backbone, plainly:
the ``dinov2_vitl14_reg`` hub backbone (Oquab et al., arXiv:2304.07193;
Darcet et al., arXiv:2309.16588; ``facebookresearch/dinov2``,
``dinov2/hub/backbones.py``) with Dense Object Nets' descriptor head, in
float32. ``x`` is ``[B, 3, H, W]``; with ``C`` the width, ``P`` the patch:

  1. zeros padded bottom and right to multiples of ``P``;
  2. ``Conv2d(3, C, P, stride P)`` with bias, flattened row-major;
  3. cls prepended; position 0 to cls, positions 1: (a ``G x G`` grid) resized
     to the patch grid by bicubic interpolation with antialias (half-pixel
     centres, a target size, no offset) to the patches;
  4. the register tokens after cls, without a position;
  5. pre-norm blocks: ``h = x + g1 * Attn(LN1(x))``, ``x = h + g2 *
     MLP(LN2(h))``; attention ``softmax(q @ k^T / sqrt(C / heads)) @ v``
     written out, heads of ``C / heads``; the MLP with exact (erf) GELU;
     LayerNorm eps 1e-6;
  6. the final LayerNorm, the patch tokens kept;
  7. a linear head to ``D``, a bilinear resize (half-pixel centres) to the
     padded size, and the crop to ``H x W``.

Departures from the hub model: no mask token, drop path 0, the padding and
the head. With gradients on, each block is recomputed in the backward
(``torch.utils.checkpoint``, the same arithmetic) so that the cell's size
fits on the card. Attribute names follow the state-dict layout that the
benchmark's weights are made in (:mod:`portbench.weights_dinov2`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

# the published widths of dinov2_vitl14_reg
WIDTHS = {"embed_dim": 1024, "depth": 24, "num_heads": 16, "mlp_ratio": 4, "patch_size": 14,
          "num_register_tokens": 4, "pos_grid": 37, "layer_norm_eps": 1e-6}


def resize_positions(grid: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """``[1, C, G, G]`` -> ``[1, C, gh, gw]``."""
    return F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True,
                         align_corners=False)


def attention(q, k, v, scale: float):
    """``[B, heads, N, d]`` each -> ``[B, heads, N, d]``."""
    return torch.softmax((q @ k.transpose(-2, -1)) * scale, dim=-1) @ v


class LayerScale(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x):
        B, N, C = x.shape
        d = C // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v, 1.0 / math.sqrt(d))
        return self.proj(o.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(c, hidden)
        self.fc2 = nn.Linear(hidden, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, c: int, heads: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(c, eps=eps)
        self.attn = Attention(c, heads)
        self.ls1 = LayerScale(c)
        self.norm2 = nn.LayerNorm(c, eps=eps)
        self.mlp = Mlp(c, mlp_ratio * c)
        self.ls2 = LayerScale(c)

    def forward(self, x):
        h = x + self.ls1(self.attn(self.norm1(x)))
        return h + self.ls2(self.mlp(self.norm2(h)))


class Dinov2FCN(nn.Module):
    """``[B, 3, H, W]`` float32 -> ``[B, D, H, W]``; ``widths`` are
    :data:`WIDTHS`' keys (the published ones by default)."""

    def __init__(self, descriptor_dimension: int, **widths):
        super().__init__()
        w = dict(WIDTHS, **widths)
        c, p, g = int(w["embed_dim"]), int(w["patch_size"]), int(w["pos_grid"])
        self.patch, self.grid = p, g
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, c, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.register_tokens = nn.Parameter(torch.zeros(1, int(w["num_register_tokens"]), c))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + g * g, c))
        self.blocks = nn.ModuleList(
            Block(c, int(w["num_heads"]), int(w["mlp_ratio"]), float(w["layer_norm_eps"]))
            for _ in range(int(w["depth"])))
        self.norm = nn.LayerNorm(c, eps=float(w["layer_norm_eps"]))
        self.head = nn.Linear(c, descriptor_dimension)

    def tokens(self, x):
        """Steps 1-4: ``([B, N, C], gh, gw)``."""
        B, _, H, W = x.shape
        p, g = self.patch, self.grid
        gh, gw = math.ceil(H / p), math.ceil(W / p)
        x = F.pad(x, (0, gw * p - W, 0, gh * p - H))
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        c = x.shape[-1]
        grid = self.pos_embed[:, 1:].reshape(1, g, g, c).permute(0, 3, 1, 2)
        pos = resize_positions(grid, gh, gw).permute(0, 2, 3, 1).reshape(1, gh * gw, c)
        cls = self.cls_token.expand(B, -1, -1) + self.pos_embed[:, :1]
        regs = self.register_tokens.expand(B, -1, -1)
        return torch.cat([cls, regs, x + pos], dim=1), gh, gw

    def forward(self, x):
        B, _, H, W = x.shape
        t, gh, gw = self.tokens(x)
        for block in self.blocks:
            if torch.is_grad_enabled():
                t = torch.utils.checkpoint.checkpoint(block, t, use_reentrant=False)
            else:
                t = block(t)
        t = self.norm(t)[:, 1 + self.register_tokens.shape[1]:]
        y = self.head(t).transpose(1, 2).reshape(B, -1, gh, gw)
        y = F.interpolate(y, size=(gh * self.patch, gw * self.patch), mode="bilinear",
                          align_corners=False)
        return y[..., :H, :W]
