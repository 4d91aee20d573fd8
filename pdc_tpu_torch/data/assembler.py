"""Training-sample assembly for the matrix (pooled) loss, batched over pairs.

Port of :mod:`pdc_tpu.data.assembler`: ``AssemblerConfig`` with
``from_training_config`` (:52-101), ``_flatten_uv`` (:103-104),
``assemble_sample_matrix`` (:220-356) and ``assemble_batch_matrix``
(:422-483). From raw posed RGBD pairs it makes normalised images and the
flat index sets of :class:`~pdc_tpu_torch.losses.matrix_loss.MatrixSampleIndices`,
in the reference's stage order:

  1. correspondences on the unaugmented depth and poses
  2. background domain randomisation (p = 0.5 per image)
  3. 180-degree flip (p = 0.5 per image; indices remapped)
  4. masked and background non-match pools in the (flipped) image b
  5. blind non-matches from unmatched object pixels of image a
  6. ImageNet normalisation

Where the JAX package vmaps one sample at a time, every stage here works on
the whole batch at once on the batch's device. Two sampling routes, as
there: with ``perm_*``/``count_*`` in the batch (valid-first pixel
permutations of the unaugmented masks, :func:`~pdc_tpu_torch.ops.sampling.build_pixel_perm`)
every masked draw is a gather; without them, an inverse-CDF search of the
mask. Across-scene and different-object rows get plain mask samples for
their blind sets and no matches. Synthetic multi-object compositing is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from pdc_tpu_torch.losses.composer import (
    MATCH_TYPE_DIFFERENT_OBJECT,
    MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE,
)
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices
from pdc_tpu_torch.ops import sampling
from pdc_tpu_torch.ops.augmentation import (
    random_domain_randomize_background,
    random_flip_180,
)
from pdc_tpu_torch.ops.correspondence import (
    find_pixel_correspondences,
    make_blind_non_matches,
    make_blind_non_matches_perm,
)
from pdc_tpu_torch.utils.constants import DEFAULT_IMAGE_MEAN, DEFAULT_IMAGE_STD
from pdc_tpu_torch.utils.device import resolve_device

_SMO_MSG = ("SYNTHETIC_MULTI_OBJECT samples are not ported yet: they wait for the "
            "slice that ports DenseCorrespondenceTraining's other sample types")


@dataclasses.dataclass(frozen=True)
class AssemblerConfig:
    """Static sampling sizes and switches; defaults mirror
    ``configs/training.yaml``."""

    num_matching_attempts: int = 10000
    num_masked_non_matches_per_match: int = 75
    num_background_non_matches_per_match: int = 75
    num_blind_samples: int = 5000
    cross_scene_num_samples: int = 10000
    domain_randomize: bool = True
    flip_augmentation: bool = True
    sample_matches_only_off_mask: bool = True
    use_image_b_mask_inv: bool = True
    enable_synthetic_multi_object: bool = False
    use_matrix_loss: bool = True
    masked_pool_size: int = 1024
    background_pool_size: int = 1024
    image_mean: Tuple[float, float, float] = DEFAULT_IMAGE_MEAN
    image_std: Tuple[float, float, float] = DEFAULT_IMAGE_STD

    @staticmethod
    def from_training_config(tc: dict) -> "AssemblerConfig":
        t = tc["training"]
        nm = int(t["num_non_matches_per_match"])
        probs = t.get("data_type_probabilities", {})
        return AssemblerConfig(
            num_matching_attempts=int(t["num_matching_attempts"]),
            num_masked_non_matches_per_match=int(nm * float(t["fraction_masked_non_matches"])),
            num_background_non_matches_per_match=int(
                nm * float(t["fraction_background_non_matches"])),
            num_blind_samples=int(t.get("num_blind_samples", 5000)),
            cross_scene_num_samples=int(t.get("cross_scene_num_samples", 10000)),
            domain_randomize=bool(t.get("domain_randomize", True)),
            flip_augmentation=bool(t.get("flip_augmentation", True)),
            sample_matches_only_off_mask=bool(t.get("sample_matches_only_off_mask", True)),
            use_image_b_mask_inv=bool(t.get("use_image_b_mask_inv", True)),
            enable_synthetic_multi_object=float(probs.get("SYNTHETIC_MULTI_OBJECT", 0)) > 0,
            use_matrix_loss=bool(t.get("use_matrix_loss", True)),
            masked_pool_size=int(t.get("masked_pool_size", 1024)),
            background_pool_size=int(t.get("background_pool_size", 1024)),
        )


def _flatten_uv(uv, W: int):
    """(u, v) -> v*W + u, truncating float coordinates toward zero."""
    return uv[..., 1].to(torch.int64) * W + uv[..., 0].to(torch.int64)


def _to_device(x, device, dtype=None):
    if isinstance(x, np.ndarray) and x.dtype == np.uint16:
        x = x.astype(np.int32)  # millimetre depth; torch has no uint16 arithmetic
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


def _normalize(rgb, cfg: AssemblerConfig):
    mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=rgb.device)
    std = torch.tensor(cfg.image_std, dtype=torch.float32, device=rgb.device)
    return (rgb.to(torch.float32) / 255.0 - mean) / std


def assemble_batch_matrix(batch: dict, cfg: AssemblerConfig, generator: torch.Generator,
                          device="cuda"):
    """Assemble one batch of pairs on ``device``.

    :param batch: host (numpy) or device arrays with a leading batch axis B:
        ``rgb_a/rgb_b [B, H, W, 3]`` uint8, ``depth_a/depth_b [B, H, W]``
        (uint16 millimetres or float metres), ``mask_a/mask_b [B, H, W]``,
        ``pose_a/pose_b [B, 4, 4]``, ``K [B, 3, 3]``, ``match_type [B]`` and
        optionally ``perm_a/perm_b [B, H*W]`` with ``count_a/count_b [B]``
    :param generator: every draw comes from it
    :return: ``(img_a [B, H, W, 3] float32, img_b, MatrixSampleIndices)``
    """
    if cfg.enable_synthetic_multi_object:
        raise NotImplementedError(_SMO_MSG)
    dev = resolve_device(device)
    rgb_a = _to_device(batch["rgb_a"], dev, torch.uint8)
    rgb_b = _to_device(batch["rgb_b"], dev, torch.uint8)
    depth_a = _to_device(batch["depth_a"], dev)
    depth_b = _to_device(batch["depth_b"], dev)
    mask_a = _to_device(batch["mask_a"], dev)
    mask_b = _to_device(batch["mask_b"], dev)
    pose_a = _to_device(batch["pose_a"], dev, torch.float32)
    pose_b = _to_device(batch["pose_b"], dev, torch.float32)
    K = _to_device(batch["K"], dev, torch.float32)
    match_type = _to_device(batch["match_type"], dev, torch.int64)
    use_perm = "perm_a" in batch
    if use_perm:
        perm_a = _to_device(batch["perm_a"], dev, torch.int64)
        perm_b = _to_device(batch["perm_b"], dev, torch.int64)
        count_a = _to_device(batch["count_a"], dev, torch.int64)
        count_b = _to_device(batch["count_b"], dev, torch.int64)
    B, H, W = depth_a.shape
    HW = H * W
    g = generator
    is_within = ((match_type != MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE)
                 & (match_type != MATCH_TYPE_DIFFERENT_OBJECT) & (match_type >= 0))

    # 1. correspondences on the unaugmented frames
    only_mask = cfg.sample_matches_only_off_mask
    uv_a, uv_b, match_valid = find_pixel_correspondences(
        depth_a, pose_a, depth_b, pose_b, K, g, num_attempts=cfg.num_matching_attempts,
        mask_a=mask_a if only_mask else None,
        perm_a=perm_a if (only_mask and use_perm) else None,
        mask_count_a=count_a if (only_mask and use_perm) else None)
    match_valid = match_valid & is_within[:, None]

    # 2. domain randomisation, before the flip
    if cfg.domain_randomize:
        rgb_a = random_domain_randomize_background(rgb_a, mask_a, g)
        rgb_b = random_domain_randomize_background(rgb_b, mask_b, g)

    # 3. flips; uv_a with mask_a, uv_b with mask_b
    flip_a = flip_b = torch.zeros(B, dtype=torch.bool, device=dev)
    if cfg.flip_augmentation:
        rgb_a, uv_a, (mask_a,), flip_a = random_flip_180(rgb_a, uv_a, g, (mask_a,),
                                                         return_flag=True)
        rgb_b, uv_b, (mask_b,), flip_b = random_flip_180(rgb_b, uv_b, g, (mask_b,),
                                                         return_flag=True)
    matches_a = _flatten_uv(uv_a, W)
    matches_b = _flatten_uv(uv_b, W)

    # 4. non-match pools over the (flipped) image-b masks
    def perm_pool(lo, hi, size):
        raw, ok = sampling.sample_flat_from_perm(perm_b, lo, hi, size, g)
        return torch.where(flip_b[:, None], HW - 1 - raw, raw), ok[:, None].expand(B, size)

    def mask_pool(mask, size):
        uv, ok = sampling.sample_from_mask(mask, size, g)
        return _flatten_uv(uv, W), ok[:, None].expand(B, size)

    if use_perm:
        masked_pool, masked_valid = perm_pool(0, count_b, cfg.masked_pool_size)
    else:
        masked_pool, masked_valid = mask_pool(mask_b, cfg.masked_pool_size)
    if not cfg.use_image_b_mask_inv:
        bg_pool = _flatten_uv(sampling.sample_uniform_pixels(
            W, H, cfg.background_pool_size, g, (B,), dev), W)
        bg_valid = torch.ones_like(bg_pool, dtype=torch.bool)
    elif use_perm:
        bg_pool, bg_valid = perm_pool(count_b, HW, cfg.background_pool_size)
    else:
        bg_pool, bg_valid = mask_pool((mask_b == 0).to(torch.uint8), cfg.background_pool_size)

    # 5. blind non-matches: within-scene rows pair unmatched object pixels of
    # a with object pixels of b; the other types plain object samples of both
    nbl = cfg.num_blind_samples
    if use_perm:
        blind_a_w, blind_b_w, blind_valid_w = make_blind_non_matches_perm(
            g, perm_a, count_a, flip_a, matches_a, match_valid, perm_b, count_b, flip_b,
            HW, nbl)
        raw_ax, ok_ax = sampling.sample_flat_from_perm(perm_a, 0, count_a, nbl, g)
        raw_bx, ok_bx = sampling.sample_flat_from_perm(perm_b, 0, count_b, nbl, g)
        blind_a_x = torch.where(flip_a[:, None], HW - 1 - raw_ax, raw_ax)
        blind_b_x = torch.where(flip_b[:, None], HW - 1 - raw_bx, raw_bx)
    else:
        blind_a_w, blind_b_w, ok_w = make_blind_non_matches(
            g, mask_a, matches_a, match_valid, mask_b, nbl)
        blind_valid_w = ok_w[:, None].expand(B, nbl)
        uv_ax, ok_ax = sampling.sample_from_mask(mask_a, nbl, g)
        uv_bx, ok_bx = sampling.sample_from_mask(mask_b, nbl, g)
        blind_a_x, blind_b_x = _flatten_uv(uv_ax, W), _flatten_uv(uv_bx, W)
    within = is_within[:, None]
    blind_a = torch.where(within, blind_a_w, blind_a_x)
    blind_b = torch.where(within, blind_b_w, blind_b_x)
    blind_valid = torch.where(within, blind_valid_w, (ok_ax & ok_bx)[:, None].expand(B, nbl))
    blind_valid = blind_valid & (match_type >= 0)[:, None]

    # 6. normalisation
    indices = MatrixSampleIndices(
        matches_a=matches_a,
        matches_b=matches_b,
        matches_uv_b=uv_b.to(torch.float32),
        matches_valid=match_valid,
        masked_pool_b=masked_pool,
        masked_pool_valid=masked_valid,
        background_pool_b=bg_pool,
        background_pool_valid=bg_valid,
        blind_nm_a=blind_a,
        blind_nm_b=blind_b,
        blind_nm_valid=blind_valid,
        match_type=match_type,
    )
    return _normalize(rgb_a, cfg), _normalize(rgb_b, cfg), indices
