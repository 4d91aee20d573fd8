"""DINOv2 ViT with register tokens as a dense-descriptor backbone.

The ``dinov2_vitl14_reg`` hub backbone (Oquab et al., arXiv:2304.07193;
Darcet et al., "Vision Transformers Need Registers", arXiv:2309.16588;
``facebookresearch/dinov2``, ``dinov2/hub/backbones.py``) with Dense Object
Nets' descriptor head. ``x`` is ``[B, 3, H, W]``, normalised as the port
normalises frames; with ``C`` the width, ``P`` the patch, ``R`` the
register tokens and ``G`` the position grid:

  1. pad bottom and right with zeros to ``Hp = P*ceil(H/P)``,
     ``Wp = P*ceil(W/P)`` (480x640 -> 490x644);
  2. patch embedding ``Conv2d(3, C, P, stride P, bias)``, flattened
     row-major to ``[B, gh*gw, C]`` (``gh = Hp/P``, ``gw = Wp/P``);
  3. prepend ``cls``; ``pos[0]`` goes to cls, ``pos[1:]`` (a ``G x G``
     grid, channel-first) is resized to ``(gh, gw)`` by
     ``F.interpolate(mode="bicubic", antialias=True, align_corners=False,
     size=...)`` and goes to the patches. The table is learned, so the
     resize runs inside the forward and its gradient reaches the table; it
     is kept only under ``torch.no_grad()`` in eval mode, per shape, until
     the table changes (:meth:`Dinov2FCN.positions`);
  4. the ``R`` register tokens after cls, without a position:
     ``N = 1 + R + gh*gw`` (1615 at 480x640);
  5. ``depth`` pre-norm blocks: ``h = x + g1 * Attn(LN1(x))``,
     ``x = h + g2 * MLP(LN2(h))``; ``Attn`` is ``qkv = Linear(C, 3C,
     bias)``, ``num_heads`` heads, ``softmax(q k^T / sqrt(C/num_heads)) v``
     and ``Linear(C, C, bias)``; the MLP ``Linear(C, mlp_ratio*C, bias)``,
     exact (erf) GELU, ``Linear(mlp_ratio*C, C, bias)``; ``g1``, ``g2`` are
     per-channel LayerScale vectors; LayerNorm eps ``layer_norm_eps``;
  6. the final LayerNorm; the patch tokens kept, ``[B, C, gh, gw]``;
  7. the head of Dense Object Nets (as ``ResNetFCN.forward``): a 1x1
     ``Linear(C, D, bias)``, the port's bilinear resize to ``(Hp, Wp)``,
     then the crop to ``[:H, :W]``.

Attention runs through :func:`~pdc_tpu_torch.ops.flash_attention.flash_attention`:
on the card the repository's flash-attention kernels (K4,
``csrc/flash_attention.cu``: one forward launch a block and a backward of
two, float32 products at split-fp32), which read q, k and v where the qkv
projection put them, write o where the output projection reads it and
keep no ``N x N`` tensor for the backward; on the CPU its plain version. A shape that the kernels do not
take (a head dim that is not a multiple of 16 up to 128) raises on the
card instead of falling back to the plain form.

Departures from the hub model: no ``mask_token`` (DINOv2 uses it only in
pretraining), drop path 0, the zero padding to a multiple of the patch, and
the head, which is Dense Object Nets' own. Parameter names are the hub's
(``patch_embed.proj``, ``cls_token``, ``register_tokens``, ``pos_embed``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,mlp.fc1,mlp.fc2,
ls2.gamma}``, ``norm``) plus ``head``.

``dtype`` is the compute dtype as in
:class:`~pdc_tpu_torch.models.resnet.ResNetFCN`: the parameters stay
float32, each linear layer and the patch embedding cast their weights to
it, LayerNorm normalises in float32 and rounds once, attention computes in
it, and the descriptor image is returned in it. ``remat`` recomputes each
block in the backward (``torch.utils.checkpoint``) in train mode with
gradients on. Train and eval mode compute the same function (no dropout,
no BatchNorm).

The profiler ranges ``dinov2.patch_embed``, ``dinov2.attention``,
``dinov2.mlp`` and ``dinov2.head`` mark the forward's parts on every eager
path; a CUDA graph's replays do not fire them.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.profiler import record_function

from pdc_tpu_torch.models.resnet import _truncated_normal_, resize_bilinear
from pdc_tpu_torch.ops.flash_attention import flash_attention

# the published dinov2_vitl14_reg widths: the defaults of a Dinov2 backbone
DEFAULTS = {"embed_dim": 1024, "depth": 24, "num_heads": 16, "mlp_ratio": 4, "patch_size": 14,
            "num_register_tokens": 4, "pos_grid": 37, "layer_norm_eps": 1e-6}
# the seeded initialisation of the hub's training code (init_weights_vit_timm,
# DinoVisionTransformer.init_weights, init_values of the hub backbones)
LINEAR_STD, POS_STD, TOKEN_STD, LAYER_SCALE_INIT = 0.02, 0.02, 1e-6, 1.0


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    w, b = layer.weight, layer.bias
    if x.dtype != w.dtype:
        w, b = w.to(x.dtype), b.to(x.dtype)
    return F.linear(x, w, b)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        # qkv [B, N, 3*C] is [B, N, 3, heads, C/heads]; o [B, N, C] is [B, N, heads, C/heads]
        return _linear(flash_attention(_linear(x, self.qkv), self.num_heads, self.scale),
                       self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return _linear(F.gelu(_linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        with record_function("dinov2.attention"):
            x = x + self.ls1(self.attn(_layer_norm(x, self.norm1)))
        with record_function("dinov2.mlp"):
            return x + self.ls2(self.mlp(_layer_norm(x, self.norm2)))


class Dinov2FCN(nn.Module):
    """Input ``[B, 3, H, W]``, output ``[B, num_classes, H, W]`` in the
    compute dtype; the widths are :data:`DEFAULTS`' keys (the published
    ViT-L/14 with 4 registers by default)."""

    def __init__(self, num_classes: int, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, mlp_ratio: int = 4, patch_size: int = 14,
                 num_register_tokens: int = 4, pos_grid: int = 37,
                 layer_norm_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not split into {num_heads} heads")
        self.dtype, self.remat = dtype, bool(remat)
        self.patch_size, self.pos_grid = int(patch_size), int(pos_grid)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, layer_norm_eps)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps)
        self.head = nn.Linear(embed_dim, num_classes)
        # (gh, gw) -> (what the table was, its resize): eval mode, no gradient
        self._positions = {}
        self.eval()

    @classmethod
    def from_backbone(cls, backbone: dict, num_classes: int, dtype=torch.float32,
                      remat: bool = False) -> "Dinov2FCN":
        """From a config's ``backbone`` block (``model_class: Dinov2``, a
        false ``pretrained``, and any of :data:`DEFAULTS`' keys)."""
        unknown = set(backbone) - set(DEFAULTS) - {"model_class", "pretrained"}
        if unknown:
            raise ValueError(f"unknown keys of the Dinov2 backbone: {sorted(unknown)}")
        widths = {k: backbone.get(k, v) for k, v in DEFAULTS.items()}
        ints = {k: int(v) for k, v in widths.items() if k != "layer_norm_eps"}
        return cls(num_classes, layer_norm_eps=float(widths["layer_norm_eps"]), dtype=dtype,
                   remat=remat, **ints)

    def _resized_positions(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.pos_embed.to(torch.float32)
        c, g = pos.shape[-1], self.pos_grid
        grid = pos[:, 1:].reshape(1, g, g, c).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True,
                             align_corners=False)
        return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, c)], dim=1)

    def positions(self, gh: int, gw: int) -> torch.Tensor:
        """``[1, 1 + gh*gw, C]`` float32: cls's position and the grid
        resized to ``gh x gw``. Kept between calls only in eval mode without
        gradients, until the table is written or moved."""
        if self.training or torch.is_grad_enabled():
            return self._resized_positions(gh, gw)
        t = self.pos_embed
        version = (t._version, t.data_ptr(), t.device)
        kept = self._positions.get((gh, gw))
        if kept is None or kept[0] != version:
            kept = self._positions[(gh, gw)] = (version, self._resized_positions(gh, gw))
        return kept[1]

    def forward(self, x):
        B, _, H, W = x.shape
        p = self.patch_size
        gh, gw = -(-H // p), -(-W // p)
        with record_function("dinov2.patch_embed"):
            x = F.pad(x.to(self.dtype), (0, gw * p - W, 0, gh * p - H))
            proj = self.patch_embed.proj
            x = F.conv2d(x, proj.weight.to(self.dtype), proj.bias.to(self.dtype), stride=p)
            x = x.flatten(2).transpose(1, 2)  # [B, gh*gw, C], row-major
            x = torch.cat([self.cls_token.to(self.dtype).expand(B, -1, -1), x], dim=1)
            x = (x + self.positions(gh, gw)).to(self.dtype)
            r = self.register_tokens.to(self.dtype).expand(B, -1, -1)
            x = torch.cat([x[:, :1], r, x[:, 1:]], dim=1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = (torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False) if remat
                 else block(x))
        with record_function("dinov2.head"):
            x = _layer_norm(x, self.norm)[:, 1 + self.register_tokens.shape[1]:]
            y = _linear(x, self.head).transpose(1, 2).reshape(B, -1, gh, gw)
            return resize_bilinear(y, gh * p, gw * p)[..., :H, :W]

    def init_weights_(self, generator: torch.Generator) -> "Dinov2FCN":
        """Seeded initialisation, drawn on the CPU from ``generator`` in
        registration order: the patch embedding and the head as the port's
        convolutions (``lecun_normal``), every other linear layer a normal
        of deviation 0.02 truncated to two deviations, biases 0, LayerNorm
        1 and 0, LayerScale 1, the position table truncated normal of
        deviation 0.02, cls and registers normal of deviation 1e-6."""
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    if m is self.patch_embed.proj or m is self.head:
                        fan_in = math.prod(m.weight.shape[1:])
                        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    else:
                        std = LINEAR_STD
                    _truncated_normal_(m.weight, std, generator)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, LayerScale):
                    m.gamma.fill_(LAYER_SCALE_INIT)
            _truncated_normal_(self.pos_embed, POS_STD, generator)
            for t in (self.cls_token, self.register_tokens):
                t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float64)
                        .mul_(TOKEN_STD).to(t.dtype))
        return self
