"""FLOPs and the attention's bounds of the DINOv2 descriptor network
(ViT-L/14 with registers, a linear head to the descriptor dimension), from
a configuration's widths and frame size, two FLOPs a multiply-add.

Counted: the patch embedding, each block's qkv, the attention's two
products (``q k^T`` and ``P v``), its projection, the MLP's two layers,
and the head. LayerNorm, GELU, softmax, LayerScale, the residual adds and
the resizes are left out. A train step takes each counted product's
forward and the gradients of both its operands (each as many FLOPs as the
forward), less the patch embedding's input gradient, which no one needs;
a kernel's recomputation is not counted.

The attention's bound over a train step is its mathematics, whatever
kernel computes it: the forward's two products and the backward's four,
and, in float32, q, k, v, the output and the gradients dO, dQ, dK and dV
each read or written once."""

from __future__ import annotations

import math

from portbench.count.peaks import PEAK_FP32_FLOP_S, PEAK_HBM_BYTES_S

WIDTHS = {"embed_dim": 1024, "depth": 24, "num_heads": 16, "mlp_ratio": 4, "patch_size": 14,
          "num_register_tokens": 4}


def shapes(widths: dict, height: int, width: int) -> dict:
    """``C``, ``depth``, ``hidden``, ``P``, the patches ``Np`` and the
    tokens ``N`` of one frame (padded to multiples of the patch)."""
    w = {k: int(widths.get(k, v)) for k, v in WIDTHS.items()}
    p = w["patch_size"]
    n_patches = math.ceil(height / p) * math.ceil(width / p)
    return {"C": w["embed_dim"], "depth": w["depth"], "hidden": w["mlp_ratio"] * w["embed_dim"],
            "P": p, "Np": n_patches, "N": 1 + w["num_register_tokens"] + n_patches}


def layers(widths: dict, height: int, width: int, descriptor_dimension: int):
    """Every counted product of one frame's forward: ``(name, FLOPs)``."""
    s = shapes(widths, height, width)
    C, N, Np, hidden = s["C"], s["N"], s["Np"], s["hidden"]
    out = [("patch_embed", 2 * Np * C * 3 * s["P"] ** 2)]
    for i in range(s["depth"]):
        out += [(f"blocks.{i}.qkv", 2 * N * C * 3 * C), (f"blocks.{i}.qk", 2 * N * N * C),
                (f"blocks.{i}.pv", 2 * N * N * C), (f"blocks.{i}.proj", 2 * N * C * C),
                (f"blocks.{i}.fc1", 2 * N * C * hidden), (f"blocks.{i}.fc2", 2 * N * hidden * C)]
    return out + [("head", 2 * Np * C * descriptor_dimension)]


def forward_flops(widths: dict, height: int, width: int, descriptor_dimension: int) -> int:
    """FLOPs of one frame's forward."""
    return sum(f for _, f in layers(widths, height, width, descriptor_dimension))


def train_step_flops(widths: dict, height: int, width: int, descriptor_dimension: int,
                     frames: int) -> int:
    """FLOPs of one train step over ``frames`` frames (see the module
    docstring)."""
    ls = layers(widths, height, width, descriptor_dimension)
    return frames * (3 * sum(f for _, f in ls) - ls[0][1])


def attention_work(widths: dict, height: int, width: int, frames: int) -> dict:
    """``{"flops", "bytes"}`` of the attention of one train step over
    ``frames`` frames: six products of ``2 N^2 C`` FLOPs a block (two
    forward, four backward), and eight float32 ``[N, C]`` tensors a block
    (q, k, v, o, dO, dQ, dK, dV)."""
    s = shapes(widths, height, width)
    C, N = s["C"], s["N"]
    return {"flops": frames * s["depth"] * 6 * 2 * N * N * C,
            "bytes": frames * s["depth"] * 8 * N * C * 4}


def attention_bound_s(work: dict) -> float:
    """The least time of ``work`` (:func:`attention_work`) on the card: the
    larger of its FLOPs over the float32 peak and its bytes over the HBM
    peak."""
    return max(work["flops"] / PEAK_FP32_FLOP_S, work["bytes"] / PEAK_HBM_BYTES_S)
