"""Pixelwise contrastive loss pieces, validity-masked, batched over leading
axes.

Port of :mod:`pdc_tpu.losses.pixelwise_contrastive`: ``LossConfig``
(:24-43), ``match_loss_from_rows`` (:62-67) and ``hinge_from_rows``
(:70-84). Rows are pre-gathered float32 descriptors ``[..., N, D]`` with a
validity mask ``[..., N]``; invalid rows contribute exactly zero and counts
are mask sums. The per-pair losses (``match_loss``, the non-match and
triplet losses, ``get_loss_original``) wait for the per-pair loss slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The ``loss_function`` config block."""

    M_masked: float = 0.5
    M_background: float = 0.5
    M_pixel: float = 50.0
    match_loss_weight: float = 1.0
    non_match_loss_weight: float = 1.0
    use_l2_pixel_loss_on_masked_non_matches: bool = False
    use_l2_pixel_loss_on_background_non_matches: bool = False
    scale_by_hard_negatives: bool = True
    scale_by_hard_negatives_DIFFERENT_OBJECT: bool = True
    alpha_triplet: float = 0.1

    @staticmethod
    def from_dict(d: dict) -> "LossConfig":
        fields = {f.name for f in dataclasses.fields(LossConfig)}
        return LossConfig(**{k: v for k, v in d.items() if k in fields})


def match_loss_from_rows(da, db, valid):
    """Mean squared descriptor distance over valid matches:
    ``(loss [...], num_valid [...] int64)``."""
    sq = torch.sum(torch.square(da - db), dim=-1)
    num = valid.sum(dim=-1)
    loss = torch.where(valid, sq, torch.zeros_like(sq)).sum(dim=-1) / torch.clamp(num, min=1)
    return loss, num


def hinge_from_rows(da, db, valid, M: float = 0.5, invert: bool = False):
    """Summed squared hinge ``max(M - dist, 0)^2`` (or ``max(dist - M, 0)^2``
    with ``invert``) over valid row pairs, and the count of pairs where the
    hinge is positive: ``(loss_sum [...], num_hard [...] int64)``."""
    dist = torch.sqrt(torch.clamp(torch.sum(torch.square(da - db), dim=-1), min=1e-24))
    hinge = torch.clamp(dist - M if invert else M - dist, min=0.0)
    loss = torch.where(valid, torch.square(hinge), torch.zeros_like(hinge)).sum(dim=-1)
    return loss, (valid & (hinge > 0.0)).sum(dim=-1)
