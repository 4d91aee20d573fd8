"""Sample-type codes, the per-pair index sets and the per-pair loss.

Port of :mod:`pdc_tpu.losses.composer`: the codes, ``SampleIndices``,
``LossTerms`` (:36-71) and ``compose_loss`` (:74-183), the loss of the
``use_matrix_loss: false`` route. Every branch is computed for every pair
of the batch and the result selected per pair by its type, so a mixed
batch is one computation. The codes match the reference's
``SpartanDatasetDataType``:

    0 SINGLE_OBJECT_WITHIN_SCENE   matches + masked + background + blind
    1 SINGLE_OBJECT_ACROSS_SCENE   inverted blind hinge (same-object pull)
    2 DIFFERENT_OBJECT             blind repulsion only
    3 MULTI_OBJECT                 same as 0
    4 SYNTHETIC_MULTI_OBJECT       same as 0
   -1 EMPTY                        contributes zero loss

The matrix (pooled) form is
:func:`pdc_tpu_torch.losses.matrix_loss.compose_loss_matrix`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pdc_tpu_torch.losses.pixelwise_contrastive import (
    LossConfig,
    gather_rows,
    hinge_from_rows,
    match_loss,
    non_match_loss_descriptor_only,
    non_match_loss_with_l2_pixel_norm,
)

MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE = 0
MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE = 1
MATCH_TYPE_DIFFERENT_OBJECT = 2
MATCH_TYPE_MULTI_OBJECT = 3
MATCH_TYPE_SYNTHETIC_MULTI_OBJECT = 4
MATCH_TYPE_EMPTY = -1


class SampleIndices(NamedTuple):
    """Per-pair index sets of a batch. Pixel indices are flat (n = v*W + u)
    int64 into the ``[B, H*W, D]`` predictions; the non-match sets are at
    the non-match multiplicity, their ``*_gt_b`` the match's image-b index
    replicated (for the l2-pixel weight)."""

    matches_a: torch.Tensor            # [B, Nm]
    matches_b: torch.Tensor            # [B, Nm]
    matches_valid: torch.Tensor        # [B, Nm] bool
    masked_nm_a: torch.Tensor          # [B, Nm * Mm]
    masked_nm_b: torch.Tensor          # [B, Nm * Mm]
    masked_nm_valid: torch.Tensor      # [B, Nm * Mm] bool
    masked_nm_gt_b: torch.Tensor       # [B, Nm * Mm]
    background_nm_a: torch.Tensor      # [B, Nm * Mb]
    background_nm_b: torch.Tensor      # [B, Nm * Mb]
    background_nm_valid: torch.Tensor  # [B, Nm * Mb] bool
    background_nm_gt_b: torch.Tensor   # [B, Nm * Mb]
    blind_nm_a: torch.Tensor           # [B, Nbl]
    blind_nm_b: torch.Tensor           # [B, Nbl]
    blind_nm_valid: torch.Tensor       # [B, Nbl] bool
    match_type: torch.Tensor           # [B] int


class LossTerms(NamedTuple):
    """Per-sample loss terms, each ``[B]``."""

    loss: torch.Tensor
    match_loss: torch.Tensor
    masked_non_match_loss: torch.Tensor
    background_non_match_loss: torch.Tensor
    blind_non_match_loss: torch.Tensor


def compose_loss(image_a_pred, image_b_pred, s: SampleIndices, cfg: LossConfig,
                 image_width: int) -> LossTerms:
    """Per-pair loss terms of a batch, dispatched on ``s.match_type``: the
    within-scene types add the match loss to the masked and background
    hinges (scaled by their hard negatives, or by their valid counts); the
    blind set is a repulsion for different objects (margin ``M_background``),
    a pull for one object across scenes (inverted, margin ``M_masked``), and
    reported for the within-scene types; the empty type gives zero. The
    scaled terms are the reference's diagnostics.

    :param image_*_pred: ``[B, H*W, D]`` predictions (flat n = v*W + u)
    :return: :class:`LossTerms` of ``[B]`` tensors
    """
    mt = s.match_type
    is_empty = mt == MATCH_TYPE_EMPTY
    is_within = ((mt == MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE) | (mt == MATCH_TYPE_MULTI_OBJECT)
                 | (mt == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT))
    is_across = mt == MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE
    is_diff = mt == MATCH_TYPE_DIFFERENT_OBJECT

    m_loss, _ = match_loss(image_a_pred, image_b_pred, s.matches_a, s.matches_b,
                           s.matches_valid)

    def non_match(use_l2_pixel, gt_b, nm_a, nm_b, valid, M):
        if use_l2_pixel:
            return non_match_loss_with_l2_pixel_norm(
                image_a_pred, image_b_pred, gt_b, nm_a, nm_b, valid, image_width,
                M_descriptor=M, M_pixel=cfg.M_pixel)
        return non_match_loss_descriptor_only(image_a_pred, image_b_pred, nm_a, nm_b, valid,
                                              M=M)

    masked_loss, n_masked_hard = non_match(
        cfg.use_l2_pixel_loss_on_masked_non_matches, s.masked_nm_gt_b, s.masked_nm_a,
        s.masked_nm_b, s.masked_nm_valid, cfg.M_masked)
    bg_loss, n_bg_hard = non_match(
        cfg.use_l2_pixel_loss_on_background_non_matches, s.background_nm_gt_b,
        s.background_nm_a, s.background_nm_b, s.background_nm_valid, cfg.M_background)

    # the blind set, gathered once and scored under three (M, invert) settings
    blind_a = gather_rows(image_a_pred, s.blind_nm_a, s.blind_nm_valid)
    blind_b = gather_rows(image_b_pred, s.blind_nm_b, s.blind_nm_valid)
    blind_loss_w, n_blind_hard_w = hinge_from_rows(blind_a, blind_b, s.blind_nm_valid,
                                                   M=cfg.M_masked)
    diff_blind, n_diff_hard = hinge_from_rows(blind_a, blind_b, s.blind_nm_valid,
                                              M=cfg.M_background)
    across_blind, n_across_hard = hinge_from_rows(blind_a, blind_b, s.blind_nm_valid,
                                                  M=cfg.M_masked, invert=True)

    n_blind = torch.clamp(s.blind_nm_valid.sum(dim=-1), min=1)
    if cfg.scale_by_hard_negatives:
        scale = torch.clamp(n_masked_hard + n_bg_hard, min=1)
        masked_scaled = masked_loss / torch.clamp(n_masked_hard, min=1)
        bg_scaled = bg_loss / torch.clamp(n_bg_hard, min=1)
        blind_scaled_w = blind_loss_w / torch.clamp(n_blind_hard_w, min=1)
        across_scale = torch.clamp(n_across_hard, min=1)
    else:
        n_masked = torch.clamp(s.masked_nm_valid.sum(dim=-1), min=1)
        n_bg = torch.clamp(s.background_nm_valid.sum(dim=-1), min=1)
        scale = n_masked + n_bg
        masked_scaled = masked_loss / n_masked
        bg_scaled = bg_loss / n_bg
        blind_scaled_w = blind_loss_w / n_blind
        across_scale = n_blind
    within_loss = (cfg.match_loss_weight * m_loss
                   + cfg.non_match_loss_weight * (masked_loss + bg_loss) / scale)
    diff_scale = (torch.clamp(n_diff_hard, min=1)
                  if cfg.scale_by_hard_negatives_DIFFERENT_OBJECT else n_blind)
    diff_loss = diff_blind / diff_scale
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
