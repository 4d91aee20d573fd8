"""Pixelwise contrastive loss, validity-masked, batched over leading axes.

Port of :mod:`pdc_tpu.losses.pixelwise_contrastive`: ``LossConfig``
(:24-43), ``_gather`` (:45-59), ``match_loss_from_rows`` (:62-67),
``hinge_from_rows`` (:70-84) and the per-pair losses ``match_loss``,
``non_match_descriptor_loss``, ``non_match_loss_descriptor_only``,
``l2_pixel_loss``, ``non_match_loss_with_l2_pixel_norm``, ``triplet_loss``
and ``get_loss_original`` (:87-233). Predictions are flat descriptor
images ``[..., H*W, D]`` (n = v*W + u), indices ``[..., N]`` with a
validity mask ``[..., N]``; invalid rows contribute exactly zero and counts
are mask sums.

Rows are gathered with ``index_select`` from the ``[B*HW, D]`` table, whose
backward is an ``index_add``: the function that the JAX package's
``take_rows`` computes with one-hot matmuls on the TPU (its bf16 rounding
of the cotangent under bf16 predictions is not reproduced; the port's
predictions are float32).
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


def gather_rows(image_pred, indices, valid):
    """Rows of ``image_pred [..., HW, D]`` at flat ``indices [..., N]``, as
    float32 ``[..., N, D]``; invalid rows read pixel 0 (their terms are
    masked out downstream)."""
    lead, (HW, D) = image_pred.shape[:-2], image_pred.shape[-2:]
    N = indices.shape[-1]
    n = 1
    for x in lead:
        n *= x
    idx = torch.where(valid, indices.to(torch.int64), 0).reshape(n, N)
    idx = idx + torch.arange(n, device=idx.device)[:, None] * HW
    rows = image_pred.reshape(n * HW, D).index_select(0, idx.reshape(-1))
    return rows.reshape(lead + (N, D)).to(torch.float32)


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


def match_loss(image_a_pred, image_b_pred, matches_a, matches_b, valid):
    """Mean squared descriptor distance over the valid matches:
    ``(loss [...], num_valid [...] int64)``."""
    return match_loss_from_rows(gather_rows(image_a_pred, matches_a, valid),
                                gather_rows(image_b_pred, matches_b, valid), valid)


def non_match_descriptor_loss(image_a_pred, image_b_pred, non_matches_a, non_matches_b, valid,
                              M: float = 0.5, invert: bool = False):
    """Per-element hinge ``max(M - dist, 0)^2`` (``max(dist - M, 0)^2`` with
    ``invert``), invalid elements zero: ``(loss_vec [..., N], num_hard
    [...] int64)``."""
    da = gather_rows(image_a_pred, non_matches_a, valid)
    db = gather_rows(image_b_pred, non_matches_b, valid)
    dist = torch.sqrt(torch.clamp(torch.sum(torch.square(da - db), dim=-1), min=1e-24))
    hinge = torch.clamp(dist - M if invert else M - dist, min=0.0)
    loss_vec = torch.where(valid, torch.square(hinge), torch.zeros_like(hinge))
    return loss_vec, (valid & (hinge > 0.0)).sum(dim=-1)


def non_match_loss_descriptor_only(image_a_pred, image_b_pred, non_matches_a, non_matches_b,
                                   valid, M: float = 0.5, invert: bool = False):
    """Summed hinge: ``(loss [...], num_hard [...])``."""
    loss_vec, num_hard = non_match_descriptor_loss(image_a_pred, image_b_pred, non_matches_a,
                                                   non_matches_b, valid, M=M, invert=invert)
    return loss_vec.sum(dim=-1), num_hard


def l2_pixel_loss(matches_b, non_matches_b, valid, image_width: int, M_pixel: float = 50.0):
    """Pixel-space weight in [0, 1], ``min(|uv_gt - uv|, M_pixel) / M_pixel``
    per element (0 where invalid); ``matches_b`` is the ground-truth index
    replicated to the non-match multiplicity. Flat indices become (u, v) in
    float32 as ``mod`` and ``floor`` of the division by the width."""
    w = float(image_width)

    def to_uv(flat):
        flat = torch.where(valid, flat, torch.zeros_like(flat)).to(torch.float32)
        return torch.stack([torch.remainder(flat, w), torch.floor(flat / w)], dim=-1)

    diff = to_uv(matches_b) - to_uv(non_matches_b)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return torch.where(valid, torch.clamp(dist, max=M_pixel) / M_pixel, torch.zeros_like(dist))


def non_match_loss_with_l2_pixel_norm(image_a_pred, image_b_pred, matches_b_rep, non_matches_a,
                                      non_matches_b, valid, image_width: int,
                                      M_descriptor: float = 0.5, M_pixel: float = 50.0):
    """The descriptor hinge weighted by :func:`l2_pixel_loss`:
    ``(loss [...], num_hard [...])``."""
    loss_vec, num_hard = non_match_descriptor_loss(image_a_pred, image_b_pred, non_matches_a,
                                                   non_matches_b, valid, M=M_descriptor)
    pix = l2_pixel_loss(matches_b_rep, non_matches_b, valid, image_width, M_pixel)
    return (loss_vec * pix).sum(dim=-1), num_hard


def triplet_loss(image_a_pred, image_b_pred, matches_a_rep, matches_b_rep, non_matches_b, valid,
                 alpha: float = 0.1):
    """``sum max(|da - db_match|^2 - |da - db_non_match|^2 + alpha, 0)`` over
    the valid elements, divided by their count (at least 1); every index
    set is at the non-match multiplicity. Returns ``[...]``."""
    da = gather_rows(image_a_pred, matches_a_rep, valid)
    db_m = gather_rows(image_b_pred, matches_b_rep, valid)
    db_n = gather_rows(image_b_pred, non_matches_b, valid)
    pos = torch.sum(torch.square(da - db_m), dim=-1)
    neg = torch.sum(torch.square(da - db_n), dim=-1)
    per = torch.clamp(pos - neg + alpha, min=0.0)
    num = torch.clamp(valid.sum(dim=-1), min=1)
    return torch.where(valid, per, torch.zeros_like(per)).sum(dim=-1) / num


def get_loss_original(image_a_pred, image_b_pred, matches_a, matches_b, non_matches_a,
                      non_matches_b, matches_valid=None, non_matches_valid=None,
                      M_margin: float = 0.5, non_match_loss_weight: float = 1.0):
    """The reference's pinned legacy loss: the match loss plus
    ``max(M - |da - db|^2, 0)`` (the margin against the squared distance,
    not squared) averaged over the valid non-matches. Validity masks of
    None mean all valid. Returns ``(loss, match_loss, non_match_loss)``,
    each ``[...]``."""
    if matches_valid is None:
        matches_valid = torch.ones(matches_a.shape, dtype=torch.bool, device=matches_a.device)
    if non_matches_valid is None:
        non_matches_valid = torch.ones(non_matches_a.shape, dtype=torch.bool,
                                       device=non_matches_a.device)
    m_loss, _ = match_loss(image_a_pred, image_b_pred, matches_a, matches_b, matches_valid)
    na = gather_rows(image_a_pred, non_matches_a, non_matches_valid)
    nb = gather_rows(image_b_pred, non_matches_b, non_matches_valid)
    hinge = torch.clamp(M_margin - torch.sum(torch.square(na - nb), dim=-1), min=0.0)
    n_n = torch.clamp(non_matches_valid.sum(dim=-1), min=1)
    nm_loss = non_match_loss_weight * torch.where(
        non_matches_valid, hinge, torch.zeros_like(hinge)).sum(dim=-1) / n_n
    return m_loss + nm_loss, m_loss, nm_loss
