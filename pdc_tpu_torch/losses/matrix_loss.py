"""Matrix-form (pooled) pixelwise contrastive loss, batched over pairs.

Port of :mod:`pdc_tpu.losses.matrix_loss`: ``MatrixSampleIndices`` (:46-63),
``pooled_non_match_loss_from_rows`` (:66-121) and ``compose_loss_matrix``
(:201-318); ``_gather_rows`` (:192-198) is
:func:`~pdc_tpu_torch.losses.pixelwise_contrastive.gather_rows`. Non-matches
are scored as a distance matrix of every match row against a shared pool of
image-b pixels (one pool on the object mask, one off it), with the
reference's hard-negative normalisation, so the loss equals the reference's
in expectation.

Where the JAX package vmaps one pair at a time, everything here carries a
leading batch axis ``B``: the pooled hinge of all pairs is one K1 launch
forward and one K2 launch backward per pool kind
(:mod:`pdc_tpu_torch.ops.pooled_hinge`). Descriptor rows are gathered with
``index_select`` from the ``[B*HW, D]`` table of predictions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pdc_tpu_torch.losses.composer import (
    MATCH_TYPE_DIFFERENT_OBJECT,
    MATCH_TYPE_EMPTY,
    MATCH_TYPE_MULTI_OBJECT,
    MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE,
    MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE,
    MATCH_TYPE_SYNTHETIC_MULTI_OBJECT,
    LossTerms,
)
from pdc_tpu_torch.losses.pixelwise_contrastive import (
    LossConfig,
    gather_rows,
    hinge_from_rows,
    match_loss_from_rows,
)
from pdc_tpu_torch.ops.pooled_hinge import pooled_hinge


class MatrixSampleIndices(NamedTuple):
    """Pooled index sets of a batch of pairs. Pixel indices are flat
    (n = v*W + u) int64 into the ``[B, H*W, D]`` predictions."""

    matches_a: torch.Tensor              # [B, Nm]
    matches_b: torch.Tensor              # [B, Nm]
    matches_uv_b: torch.Tensor           # [B, Nm, 2] float32
    matches_valid: torch.Tensor          # [B, Nm] bool
    masked_pool_b: torch.Tensor          # [B, Pm] on-object pool in image b
    masked_pool_valid: torch.Tensor      # [B, Pm] bool
    background_pool_b: torch.Tensor      # [B, Pb] off-object pool
    background_pool_valid: torch.Tensor  # [B, Pb] bool
    blind_nm_a: torch.Tensor             # [B, Nbl]
    blind_nm_b: torch.Tensor             # [B, Nbl]
    blind_nm_valid: torch.Tensor         # [B, Nbl] bool
    match_type: torch.Tensor             # [B] int


def pooled_non_match_loss_from_rows(da, db, matches_uv_b, matches_valid, pool_b, pool_valid,
                                    image_width: int, M: float = 0.5,
                                    use_l2_pixel_loss: bool = False, M_pixel: float = 50.0,
                                    hinge=pooled_hinge):
    """Summed hinge over each pair's ``[Nm, P]`` match x pool matrix, on
    gathered rows ``da [B, Nm, D]`` / ``db [B, P, D]``: ``(loss_sum [B],
    num_hard [B] int64)``. ``hinge`` computes it, by default the kernels'
    wrapper; :func:`pdc_tpu_torch.ops.pooled_hinge.pooled_hinge_reference`
    is the plain version with the same signature."""
    W = image_width
    uv = matches_uv_b.to(torch.float32)
    return hinge(
        da.contiguous(), db.contiguous(),
        uv[..., 0].contiguous(), uv[..., 1].contiguous(),
        matches_valid.to(torch.float32),
        (pool_b % W).to(torch.float32), (pool_b // W).to(torch.float32),
        pool_valid.to(torch.float32),
        float(M), bool(use_l2_pixel_loss), float(M_pixel))


def compose_loss_matrix(image_a_pred, image_b_pred, s: MatrixSampleIndices, cfg: LossConfig,
                        image_width: int, hinge=pooled_hinge) -> LossTerms:
    """Per-pair loss terms of a batch, dispatched on ``s.match_type``.

    :param image_*_pred: ``[B, H*W, D]`` predictions (flat n = v*W + u)
    :return: :class:`LossTerms` of ``[B]`` tensors
    """
    mt = s.match_type
    is_empty = mt == MATCH_TYPE_EMPTY
    is_within = ((mt == MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE) | (mt == MATCH_TYPE_MULTI_OBJECT)
                 | (mt == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT))
    is_across = mt == MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE
    is_diff = mt == MATCH_TYPE_DIFFERENT_OBJECT

    # one gather per row set, shared by every term that reads it
    da_m = gather_rows(image_a_pred, s.matches_a, s.matches_valid)
    db_m = gather_rows(image_b_pred, s.matches_b, s.matches_valid)
    pool_masked = gather_rows(image_b_pred, s.masked_pool_b, s.masked_pool_valid)
    pool_bg = gather_rows(image_b_pred, s.background_pool_b, s.background_pool_valid)
    blind_a = gather_rows(image_a_pred, s.blind_nm_a, s.blind_nm_valid)
    blind_b = gather_rows(image_b_pred, s.blind_nm_b, s.blind_nm_valid)

    m_loss, _ = match_loss_from_rows(da_m, db_m, s.matches_valid)
    masked_loss, n_masked_hard = pooled_non_match_loss_from_rows(
        da_m, pool_masked, s.matches_uv_b, s.matches_valid, s.masked_pool_b,
        s.masked_pool_valid, image_width, M=cfg.M_masked,
        use_l2_pixel_loss=cfg.use_l2_pixel_loss_on_masked_non_matches, M_pixel=cfg.M_pixel,
        hinge=hinge)
    bg_loss, n_bg_hard = pooled_non_match_loss_from_rows(
        da_m, pool_bg, s.matches_uv_b, s.matches_valid, s.background_pool_b,
        s.background_pool_valid, image_width, M=cfg.M_background,
        use_l2_pixel_loss=cfg.use_l2_pixel_loss_on_background_non_matches,
        M_pixel=cfg.M_pixel, hinge=hinge)
    blind_loss_w, n_blind_hard_w = hinge_from_rows(blind_a, blind_b, s.blind_nm_valid,
                                                   M=cfg.M_masked)

    n_blind_valid = torch.clamp(s.blind_nm_valid.sum(dim=-1), min=1)
    if cfg.scale_by_hard_negatives:
        scale = torch.clamp(n_masked_hard + n_bg_hard, min=1)
        masked_scaled = masked_loss / torch.clamp(n_masked_hard, min=1)
        bg_scaled = bg_loss / torch.clamp(n_bg_hard, min=1)
        blind_scaled_w = blind_loss_w / torch.clamp(n_blind_hard_w, min=1)
    else:
        n_valid = s.matches_valid.sum(dim=-1)
        n_masked = torch.clamp(n_valid * s.masked_pool_valid.sum(dim=-1), min=1)
        n_bg = torch.clamp(n_valid * s.background_pool_valid.sum(dim=-1), min=1)
        scale = n_masked + n_bg
        masked_scaled = masked_loss / n_masked
        bg_scaled = bg_loss / n_bg
        blind_scaled_w = blind_loss_w / n_blind_valid

    non_match = (masked_loss + bg_loss) / scale
    within_loss = cfg.match_loss_weight * m_loss + cfg.non_match_loss_weight * non_match

    diff_blind, n_diff_hard = hinge_from_rows(blind_a, blind_b, s.blind_nm_valid,
                                              M=cfg.M_background)
    diff_scale = (torch.clamp(n_diff_hard, min=1)
                  if cfg.scale_by_hard_negatives_DIFFERENT_OBJECT else n_blind_valid)
    diff_loss = diff_blind / diff_scale

    across_blind, n_across_hard = hinge_from_rows(blind_a, blind_b, s.blind_nm_valid,
                                                  M=cfg.M_masked, invert=True)
    across_scale = (torch.clamp(n_across_hard, min=1)
                    if cfg.scale_by_hard_negatives else n_blind_valid)
    across_loss = across_blind / across_scale

    zero = torch.zeros_like(m_loss)
    loss = torch.where(is_empty, zero, torch.where(
        is_within, within_loss, torch.where(
            is_diff, diff_loss, torch.where(is_across, across_loss, zero))))
    blind_reported = torch.where(is_within, blind_scaled_w, torch.where(
        is_diff, diff_loss, torch.where(is_across, across_loss, zero)))
    w = (is_within & ~is_empty).to(m_loss.dtype)
    return LossTerms(
        loss=loss,
        match_loss=m_loss * w,
        masked_non_match_loss=masked_scaled * w,
        background_non_match_loss=bg_scaled * w,
        blind_non_match_loss=torch.where(is_empty, zero, blind_reported),
    )
