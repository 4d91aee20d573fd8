"""Random pixel sampling with static shapes, batched over leading axes.

Port of :mod:`pdc_tpu.ops.sampling` (:17-86). Masks are sampled by inverse
CDF over their cumulative sum (uniform over the nonzero pixels, with
replacement), or from a precomputed valid-first pixel permutation.

Draws come from a ``torch.Generator`` through :func:`uniform` and
:func:`normal`, the only places the port's data pipeline makes random
numbers. They cannot reproduce ``jax.random``'s bits; the tests hold the
stages by feeding both packages the same draws and by distribution checks.
Indices are int64, torch's index type (int32 in the JAX package).
"""

from __future__ import annotations

import torch

from pdc_tpu_torch.utils.device import device_constant


def uniform(shape, generator: torch.Generator, device=None, dtype=torch.float32):
    """Uniform draws in [0, 1) from ``generator`` (made on the generator's
    device, then moved to ``device``)."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device, dtype=dtype)
    return u if device is None else u.to(device)


def normal(shape, generator: torch.Generator, device=None, dtype=torch.float32):
    """Standard normal draws (made on the generator's device, then moved to
    ``device``)."""
    n = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)
    return n if device is None else n.to(device)


def inverse_cdf(mask_flat, u):
    """Indices drawn uniformly from the nonzero entries of ``mask_flat``
    ``[..., N]`` for uniforms ``u [..., S]``: ``searchsorted(cumsum,
    u * total, right)`` as in the JAX package. Returns ``(idx [..., S]
    int64, valid [...] bool)``; ``valid`` is False for an empty mask."""
    flat = (mask_flat != 0).to(torch.float32)
    cdf = torch.cumsum(flat, dim=-1)
    total = cdf[..., -1]
    x = u.to(torch.float32) * torch.clamp(total, min=1.0)[..., None]
    idx = torch.searchsorted(cdf.contiguous(), x.contiguous(), right=True)
    return torch.clamp(idx, 0, flat.shape[-1] - 1), total > 0


def sample_from_mask(mask, num_samples: int, generator: torch.Generator):
    """``num_samples`` pixels uniform over the nonzero entries of
    ``mask [..., H, W]``: ``(uv [..., S, 2] int64 (u, v), valid [...])``."""
    W = mask.shape[-1]
    u = uniform(mask.shape[:-2] + (num_samples,), generator, mask.device)
    idx, valid = inverse_cdf(mask.reshape(mask.shape[:-2] + (-1,)), u)
    return torch.stack([idx % W, idx // W], dim=-1), valid


def sample_flat_from_mask(mask_flat, num_samples: int, generator: torch.Generator):
    """:func:`sample_from_mask` over an already-flat mask ``[..., N]``:
    ``(idx [..., S] int64, valid [...])``."""
    u = uniform(mask_flat.shape[:-1] + (num_samples,), generator, mask_flat.device)
    return inverse_cdf(mask_flat, u)


def sample_uniform_pixels(width: int, height: int, num_samples: int,
                          generator: torch.Generator, batch_shape=(), device=None):
    """Pixels uniform over the whole image, ``floor(U * (W, H))``:
    ``[*batch_shape, S, 2]`` int64 (u, v)."""
    u = uniform(tuple(batch_shape) + (num_samples, 2), generator, device)
    scale = device_constant((width, height), torch.float32, u.device)
    return torch.floor(u * scale).to(torch.int64)


def perm_gather(perm, lo, hi, u):
    """``perm[..., lo + floor(u * (hi - lo))]``: entries drawn uniformly
    from ``perm[..., lo:hi]`` for float64 uniforms ``u [..., S]``.
    ``lo``/``hi`` are ints or ``[...]`` tensors. Returns ``(idx [..., S]
    int64, valid [...] = hi > lo)``."""
    lo, hi = _index(lo, perm.device), _index(hi, perm.device)
    n = torch.clamp(hi - lo, min=1)
    r = torch.floor(u.to(torch.float64) * n[..., None].to(torch.float64)).to(torch.int64)
    r = lo[..., None] + torch.minimum(r, n[..., None] - 1)
    r = r.expand(perm.shape[:-1] + r.shape[-1:])
    return torch.gather(perm.to(torch.int64), -1, r), hi > lo


def _index(x, device) -> torch.Tensor:
    """An int or a tensor as int64 on ``device``; an int is filled in
    there, with no copy from host memory (which a CUDA graph cannot
    capture)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=device)


def sample_flat_from_perm(perm, lo, hi, num_samples: int, generator: torch.Generator):
    """Flat pixel indices uniform over ``perm[..., lo:hi]`` (with
    replacement), for a valid-first permutation from
    :func:`build_pixel_perm`: entries ``[0, count)`` are the mask's pixels,
    ``[count, HW)`` the background. One draw and one gather instead of an
    inverse-CDF search. Returns ``(idx [..., S] int64, valid [...])``."""
    u = uniform(perm.shape[:-1] + (num_samples,), generator, perm.device, torch.float64)
    return perm_gather(perm, lo, hi, u)


def build_pixel_perm(mask):
    """Valid-first pixel permutation of ``mask [..., H, W]``: ``(perm
    [..., HW] int64 — mask pixels first, each part in increasing order;
    count [...] int64 — the number of mask pixels)``."""
    flat = mask.reshape(mask.shape[:-2] + (-1,)) != 0
    perm = torch.argsort((~flat).to(torch.uint8), dim=-1, stable=True)
    return perm, flat.sum(dim=-1)
