"""Best-match search over descriptor images.

Port of :mod:`pdc_tpu.ops.matching` (:23-99) with the same contracts:
descriptor images ``[H, W, D]``, ``uv`` as ``[Q, 2]`` int32 ``(u, v)``, flat
pixel index ``n = v*W + u``. The computation runs on the device of ``res``,
in float32: a bfloat16 descriptor image (a bfloat16 network's) is upcast
first, as ``pdc_tpu/ops/matching.py:73-74`` upcasts it, so the best-match
kernel always gets the float32 planes it requires.

The unmasked batched search goes through :func:`pdc_tpu_torch.ops.best_match.best_match`
— the streaming CUDA kernel on a CUDA tensor, its plain version on a CPU
tensor. With a mask, masked-out pixels get ``+1e6`` added to their squared
distance before the argmin (the reference's masked best match,
``evaluation.py:1052-1059``); that case stays in plain torch, as the JAX
package keeps it off its kernel.
"""

from __future__ import annotations

import torch

from pdc_tpu_torch.ops.best_match import best_match, squared_distances


def _tensor(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def norm_diffs_for_descriptor(descriptor, res):
    """Per-pixel L2 distance image between a descriptor ``[D]`` and a
    descriptor image ``[H, W, D]`` -> ``[H, W]`` float32."""
    res = _tensor(res)
    d = _tensor(descriptor, res.device)
    return torch.sqrt(torch.clamp(torch.sum(torch.square(res - d), dim=-1), min=0.0))


def best_match_for_descriptor(descriptor, res):
    """Single-query best match.

    :return: (uv [2] int32, best_dist scalar float32, norm_diffs [H, W])
    """
    res = _tensor(res)
    W = res.shape[1]
    nd = norm_diffs_for_descriptor(descriptor, res)
    flat_idx = torch.argmin(nd.reshape(-1))
    uv = torch.stack([flat_idx % W, flat_idx // W]).to(torch.int32)
    return uv, nd.reshape(-1)[flat_idx], nd


def best_matches_batch(queries, res, mask=None):
    """Batched best-match search: ``Q`` query descriptors against one image.

    :param queries: [Q, D]
    :param res: [H, W, D]
    :param mask: optional [H, W]; nonzero = allowed
    :return: (uv [Q, 2] int32, best_dist [Q] float32)
    """
    res = _tensor(res)
    H, W, D = res.shape
    queries = _tensor(queries, res.device).reshape(1, -1, D).contiguous()
    planar = res.reshape(H * W, D).t().contiguous()[None]  # [1, D, HW]
    if mask is None:
        flat_idx, dist = best_match(planar, queries)
        flat_idx, dist = flat_idx[0], dist[0]
    else:
        d2 = squared_distances(planar, queries)[0]  # [Q, HW]
        blocked = (torch.as_tensor(mask, device=res.device).reshape(-1) == 0)
        d2 = d2 + blocked.to(torch.float32)[None, :] * 1e6
        flat_idx = torch.argmin(d2, dim=1)
        dist = torch.sqrt(torch.clamp(
            torch.gather(d2, 1, flat_idx[:, None])[:, 0], min=0.0))
    uv = torch.stack([flat_idx % W, flat_idx // W], dim=-1).to(torch.int32)
    return uv, dist


def gaussian_heatmap_from_norm_diffs(norm_diffs, variance: float = 0.03):
    """exp(-d / variance) heatmap in [0, 1] (colormapping stays host-side)."""
    return torch.exp(-_tensor(norm_diffs) / variance)
