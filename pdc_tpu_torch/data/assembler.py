"""Training-sample assembly, batched over pairs: the matrix (pooled) route
and the per-pair route.

Port of :mod:`pdc_tpu.data.assembler`: ``AssemblerConfig`` with
``from_training_config`` (:52-101), ``_flatten_uv`` (:103-104),
``assemble_sample`` (:107-217) with ``assemble_batch`` (:581-629),
``assemble_sample_matrix`` (:220-356) with ``assemble_batch_matrix``
(:422-483), the synthetic multi-object samples
``assemble_synthetic_multi_object_sample_matrix`` (:359-419) and
``assemble_synthetic_multi_object_sample`` (:486-571), and
``_select_sample`` (:574). From raw posed RGBD pairs it makes normalised
images and the flat index sets of
:class:`~pdc_tpu_torch.losses.matrix_loss.MatrixSampleIndices` (pools of
non-matches) or :class:`~pdc_tpu_torch.losses.composer.SampleIndices`
(non-matches per match), in the reference's stage order:

  1. correspondences on the unaugmented depth and poses
  2. background domain randomisation (p = 0.5 per image)
  3. 180-degree flip (p = 0.5 per image; indices remapped)
  4. non-matches in the (flipped) image b: pools on and off the object
     (matrix), or per match, perturbed off the match (per-pair)
  5. blind non-matches from unmatched object pixels of image a
  6. ImageNet normalisation

Where the JAX package vmaps one sample at a time, every stage here works on
the whole batch at once on the batch's device. The matrix route samples
masks two ways, as there: with ``perm_*``/``count_*`` in the batch
(valid-first pixel permutations of the unaugmented masks,
:func:`~pdc_tpu_torch.ops.sampling.build_pixel_perm`) every masked draw is
a gather; without them, an inverse-CDF search of the mask. The per-pair
route always searches the masks. Across-scene and different-object rows
get plain mask samples for their blind sets and no matches.

Synthetic multi-object rows (type 4, with ``enable_synthetic_multi_object``
and the batch's ``*_2`` second pairs) composite the two pairs instead: half
the match attempts each (always on ``mask_a``), one composite per view, no
domain randomisation and no flip, non-matches over the merged mask of view
2, no blind set. They are computed for those rows only, after the other
rows' stages, and replace them; ``match_type`` stays the batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from pdc_tpu_torch.losses.composer import (
    MATCH_TYPE_DIFFERENT_OBJECT,
    MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE,
    MATCH_TYPE_SYNTHETIC_MULTI_OBJECT,
    SampleIndices,
)
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices
from pdc_tpu_torch.ops import sampling
from pdc_tpu_torch.ops.augmentation import (
    merge_images_with_occlusions,
    merge_matches,
    random_domain_randomize_background,
    random_flip_180,
)
from pdc_tpu_torch.ops.correspondence import (
    create_non_correspondences,
    find_pixel_correspondences,
    make_blind_non_matches,
    make_blind_non_matches_perm,
)
from pdc_tpu_torch.utils.constants import DEFAULT_IMAGE_MEAN, DEFAULT_IMAGE_STD
from pdc_tpu_torch.utils.device import device_constant, resolve_device


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
    if dtype is None and t.dtype == torch.uint16:  # depth gathered from a device cache
        dtype = torch.int32
    return t if dtype is None else t.to(dtype)


def _normalize(rgb, cfg: AssemblerConfig):
    mean = device_constant(cfg.image_mean, torch.float32, rgb.device)
    std = device_constant(cfg.image_std, torch.float32, rgb.device)
    return (rgb.to(torch.float32) / 255.0 - mean) / std


_FRAME_DTYPES = {"rgb_a": torch.uint8, "depth_a": None, "mask_a": None,
                 "pose_a": torch.float32, "rgb_b": torch.uint8, "depth_b": None,
                 "mask_b": None, "pose_b": torch.float32, "K": torch.float32}


def _frames(batch: dict, dev, suffix: str = "") -> dict:
    """The pair arrays of ``batch`` (or its second pairs, ``suffix="_2"``)
    on ``dev``, keyed without the suffix."""
    return {k: _to_device(batch[k + suffix], dev, dt) for k, dt in _FRAME_DTYPES.items()}


def _is_within(match_type):
    return ((match_type != MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE)
            & (match_type != MATCH_TYPE_DIFFERENT_OBJECT) & (match_type >= 0))


def _correspond_and_augment(f: dict, match_type, cfg: AssemblerConfig, g: torch.Generator,
                            perm_a=None, count_a=None):
    """Stages 1-3 of the module docstring on the pairs ``f``. Returns
    ``(rgb_a, rgb_b, mask_a, mask_b, uv_a, uv_b, match_valid, flip_a,
    flip_b)``, the images, masks and pixels as augmented."""
    only_mask = cfg.sample_matches_only_off_mask
    uv_a, uv_b, match_valid = find_pixel_correspondences(
        f["depth_a"], f["pose_a"], f["depth_b"], f["pose_b"], f["K"], g,
        num_attempts=cfg.num_matching_attempts, mask_a=f["mask_a"] if only_mask else None,
        perm_a=perm_a if only_mask else None, mask_count_a=count_a if only_mask else None)
    match_valid = match_valid & _is_within(match_type)[:, None]

    rgb_a, rgb_b, mask_a, mask_b = f["rgb_a"], f["rgb_b"], f["mask_a"], f["mask_b"]
    if cfg.domain_randomize:  # before the flip
        rgb_a = random_domain_randomize_background(rgb_a, mask_a, g)
        rgb_b = random_domain_randomize_background(rgb_b, mask_b, g)
    flip_a = flip_b = torch.zeros(mask_a.shape[0], dtype=torch.bool, device=mask_a.device)
    if cfg.flip_augmentation:
        rgb_a, uv_a, (mask_a,), flip_a = random_flip_180(rgb_a, uv_a, g, (mask_a,),
                                                         return_flag=True)
        rgb_b, uv_b, (mask_b,), flip_b = random_flip_180(rgb_b, uv_b, g, (mask_b,),
                                                         return_flag=True)
    return rgb_a, rgb_b, mask_a, mask_b, uv_a, uv_b, match_valid, flip_a, flip_b


def _mask_pool(mask, size: int, g: torch.Generator):
    """``size`` flat pixels uniform over ``mask [B, H, W]``, and their
    validity ``[B, size]`` (False for an empty mask)."""
    uv, ok = sampling.sample_from_mask(mask, size, g)
    return _flatten_uv(uv, mask.shape[-1]), ok[:, None].expand(mask.shape[0], size)


def _blind_by_mask(match_type, mask_a, mask_b, matches_a, match_valid, nbl: int,
                   g: torch.Generator):
    """Stage 5 by inverse-CDF search: within-scene rows pair unmatched object
    pixels of a with object pixels of b; the other types plain object
    samples of both. Returns ``(blind_a, blind_b, blind_valid)``, ``[B,
    nbl]`` each."""
    B, W = mask_a.shape[0], mask_a.shape[-1]
    blind_a_w, blind_b_w, ok_w = make_blind_non_matches(
        g, mask_a, matches_a, match_valid, mask_b, nbl)
    uv_ax, ok_ax = sampling.sample_from_mask(mask_a, nbl, g)
    uv_bx, ok_bx = sampling.sample_from_mask(mask_b, nbl, g)
    within = _is_within(match_type)[:, None]
    blind_a = torch.where(within, blind_a_w, _flatten_uv(uv_ax, W))
    blind_b = torch.where(within, blind_b_w, _flatten_uv(uv_bx, W))
    ok = torch.where(_is_within(match_type), ok_w, ok_ax & ok_bx) & (match_type >= 0)
    return blind_a, blind_b, ok[:, None].expand(B, nbl)


def assemble_batch_matrix(batch: dict, cfg: AssemblerConfig, generator: torch.Generator,
                          device="cuda", composite_every_row: bool = False):
    """Assemble one batch of pairs on ``device`` for the matrix loss.

    :param batch: host (numpy) or device arrays with a leading batch axis B:
        ``rgb_a/rgb_b [B, H, W, 3]`` uint8, ``depth_a/depth_b [B, H, W]``
        (uint16 millimetres or float metres), ``mask_a/mask_b [B, H, W]``,
        ``pose_a/pose_b [B, 4, 4]``, ``K [B, 3, 3]``, ``match_type [B]``,
        optionally ``perm_a/perm_b [B, H*W]`` with ``count_a/count_b [B]``,
        and with ``cfg.enable_synthetic_multi_object`` the second pairs
        (the same keys with ``_2``, no ``perm``)
    :param generator: every draw comes from it
    :param composite_every_row: synthetic multi-object rows as the device
        sampler makes them (:func:`_with_smo_rows`)
    :return: ``(img_a [B, H, W, 3] float32, img_b, MatrixSampleIndices)``
    """
    dev = resolve_device(device)
    f = _frames(batch, dev)
    match_type = _to_device(batch["match_type"], dev, torch.int64)
    use_perm = "perm_a" in batch
    perm_a = perm_b = count_a = count_b = None
    if use_perm:
        perm_a = _to_device(batch["perm_a"], dev, torch.int64)
        perm_b = _to_device(batch["perm_b"], dev, torch.int64)
        count_a = _to_device(batch["count_a"], dev, torch.int64)
        count_b = _to_device(batch["count_b"], dev, torch.int64)
    B, H, W = f["depth_a"].shape
    HW = H * W
    g = generator

    rgb_a, rgb_b, mask_a, mask_b, uv_a, uv_b, match_valid, flip_a, flip_b = \
        _correspond_and_augment(f, match_type, cfg, g, perm_a, count_a)
    matches_a = _flatten_uv(uv_a, W)
    matches_b = _flatten_uv(uv_b, W)

    # 4. non-match pools over the (flipped) image-b masks
    def perm_pool(lo, hi, size):
        raw, ok = sampling.sample_flat_from_perm(perm_b, lo, hi, size, g)
        return torch.where(flip_b[:, None], HW - 1 - raw, raw), ok[:, None].expand(B, size)

    if use_perm:
        masked_pool, masked_valid = perm_pool(0, count_b, cfg.masked_pool_size)
    else:
        masked_pool, masked_valid = _mask_pool(mask_b, cfg.masked_pool_size, g)
    if not cfg.use_image_b_mask_inv:
        bg_pool = _flatten_uv(sampling.sample_uniform_pixels(
            W, H, cfg.background_pool_size, g, (B,), dev), W)
        bg_valid = torch.ones_like(bg_pool, dtype=torch.bool)
    elif use_perm:
        bg_pool, bg_valid = perm_pool(count_b, HW, cfg.background_pool_size)
    else:
        bg_pool, bg_valid = _mask_pool((mask_b == 0).to(torch.uint8), cfg.background_pool_size, g)

    # 5. blind non-matches
    nbl = cfg.num_blind_samples
    if use_perm:
        blind_a_w, blind_b_w, blind_valid_w = make_blind_non_matches_perm(
            g, perm_a, count_a, flip_a, matches_a, match_valid, perm_b, count_b, flip_b,
            HW, nbl)
        raw_ax, ok_ax = sampling.sample_flat_from_perm(perm_a, 0, count_a, nbl, g)
        raw_bx, ok_bx = sampling.sample_flat_from_perm(perm_b, 0, count_b, nbl, g)
        within = _is_within(match_type)[:, None]
        blind_a = torch.where(within, blind_a_w,
                              torch.where(flip_a[:, None], HW - 1 - raw_ax, raw_ax))
        blind_b = torch.where(within, blind_b_w,
                              torch.where(flip_b[:, None], HW - 1 - raw_bx, raw_bx))
        blind_valid = torch.where(within, blind_valid_w,
                                  (ok_ax & ok_bx)[:, None].expand(B, nbl))
        blind_valid = blind_valid & (match_type >= 0)[:, None]
    else:
        blind_a, blind_b, blind_valid = _blind_by_mask(match_type, mask_a, mask_b, matches_a,
                                                       match_valid, nbl, g)

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
    out = (_normalize(rgb_a, cfg), _normalize(rgb_b, cfg), indices)
    if cfg.enable_synthetic_multi_object:
        out = _with_smo_rows(out, batch, f, dev, cfg, g,
                             assemble_synthetic_multi_object_sample_matrix, composite_every_row)
    return out


def _replicate(x, m: int):
    """Each entry of ``x [B, N]`` repeated ``m`` times in a row (row-major:
    the reference's repeat-transpose-reshape of create_non_matches)."""
    return torch.repeat_interleave(x, m, dim=-1)


def _per_pair_indices(matches_a, matches_b, match_valid, masked_uv, background_uv, blind_a,
                      blind_b, blind_valid, match_type, W: int, cfg: AssemblerConfig):
    B = matches_a.shape[0]
    Mm = cfg.num_masked_non_matches_per_match
    Mb = cfg.num_background_non_matches_per_match
    return SampleIndices(
        matches_a=matches_a,
        matches_b=matches_b,
        matches_valid=match_valid,
        masked_nm_a=_replicate(matches_a, Mm),
        masked_nm_b=_flatten_uv(masked_uv.reshape(B, -1, 2), W),
        masked_nm_valid=_replicate(match_valid, Mm),
        masked_nm_gt_b=_replicate(matches_b, Mm),
        background_nm_a=_replicate(matches_a, Mb),
        background_nm_b=_flatten_uv(background_uv.reshape(B, -1, 2), W),
        background_nm_valid=_replicate(match_valid, Mb),
        background_nm_gt_b=_replicate(matches_b, Mb),
        blind_nm_a=blind_a,
        blind_nm_b=blind_b,
        blind_nm_valid=blind_valid,
        match_type=match_type,
    )


def assemble_batch(batch: dict, cfg: AssemblerConfig, generator: torch.Generator,
                   device="cuda", composite_every_row: bool = False):
    """Assemble one batch of pairs on ``device`` for the per-pair loss.

    Stages 1-3 and 6 as :func:`assemble_batch_matrix`'s without
    permutations (``perm_*`` in the batch are not read); stage 4 draws
    ``num_masked_non_matches_per_match`` non-matches per match on the
    (flipped) object mask of image b and
    ``num_background_non_matches_per_match`` off it (anywhere in the image
    without ``use_image_b_mask_inv``), with
    :func:`~pdc_tpu_torch.ops.correspondence.create_non_correspondences`;
    the match indices are replicated to each multiplicity.

    :param batch: as :func:`assemble_batch_matrix`'s, and
        ``composite_every_row``
    :return: ``(img_a [B, H, W, 3] float32, img_b, SampleIndices)``
    """
    dev = resolve_device(device)
    f = _frames(batch, dev)
    match_type = _to_device(batch["match_type"], dev, torch.int64)
    B, H, W = f["depth_a"].shape
    g = generator

    rgb_a, rgb_b, mask_a, mask_b, uv_a, uv_b, match_valid, _, _ = \
        _correspond_and_augment(f, match_type, cfg, g)

    # 4. non-matches per match in the (flipped) image b
    masked_uv = create_non_correspondences(
        uv_b, (H, W), g, num_non_matches_per_match=cfg.num_masked_non_matches_per_match,
        mask_b=mask_b)
    background_uv = create_non_correspondences(
        uv_b, (H, W), g, num_non_matches_per_match=cfg.num_background_non_matches_per_match,
        mask_b=(mask_b == 0).to(torch.uint8) if cfg.use_image_b_mask_inv else None)
    matches_a = _flatten_uv(uv_a, W)
    matches_b = _flatten_uv(uv_b, W)

    # 5. blind non-matches
    blind = _blind_by_mask(match_type, mask_a, mask_b, matches_a, match_valid,
                           cfg.num_blind_samples, g)

    # 6. normalisation
    indices = _per_pair_indices(matches_a, matches_b, match_valid, masked_uv, background_uv,
                                *blind, match_type, W, cfg)
    out = (_normalize(rgb_a, cfg), _normalize(rgb_b, cfg), indices)
    if cfg.enable_synthetic_multi_object:
        out = _with_smo_rows(out, batch, f, dev, cfg, g, assemble_synthetic_multi_object_sample,
                             composite_every_row)
    return out


# -- synthetic multi-object rows ------------------------------------------------------

def _composite(p1: dict, p2: dict, cfg: AssemblerConfig, g: torch.Generator):
    """What both routes' synthetic multi-object samples share: half the
    match attempts in each pair (on its ``mask_a``), then one composite of
    the two pairs' first views and one of their second views, each
    invalidating the matches its front object covers (the first's validity
    feeds the second). Returns ``(merged_1, merged_2, merged_mask_2, uv_1
    [B, N, 2] int64, uv_2 [B, N, 2] float32, match_valid [B, N])``, pair 1's
    matches first."""
    half = cfg.num_matching_attempts // 2
    uv_a1, uv_a2, valid_a = find_pixel_correspondences(
        p1["depth_a"], p1["pose_a"], p1["depth_b"], p1["pose_b"], p1["K"], g,
        num_attempts=half, mask_a=p1["mask_a"])
    uv_b1, uv_b2, valid_b = find_pixel_correspondences(
        p2["depth_a"], p2["pose_a"], p2["depth_b"], p2["pose_b"], p2["K"], g,
        num_attempts=half, mask_a=p2["mask_a"])
    merged_1, _, (_, valid_a), (_, valid_b) = merge_images_with_occlusions(
        p1["rgb_a"], p2["rgb_a"], p1["mask_a"], p2["mask_a"], (uv_a1, uv_a2), (uv_b1, uv_b2),
        valid_a, valid_b, g)
    merged_2, merged_mask_2, (_, valid_a), (_, valid_b) = merge_images_with_occlusions(
        p1["rgb_b"], p2["rgb_b"], p1["mask_b"], p2["mask_b"], (uv_a2, uv_a1), (uv_b2, uv_b1),
        valid_a, valid_b, g)
    uv_1, match_valid = merge_matches(uv_a1, valid_a, uv_b1, valid_b)
    uv_2, _ = merge_matches(uv_a2.to(torch.float32), valid_a, uv_b2.to(torch.float32), valid_b)
    return merged_1, merged_2, merged_mask_2, uv_1, uv_2, match_valid


def _no_blind(B: int, cfg: AssemblerConfig, dev):
    n = cfg.num_blind_samples
    zeros = torch.zeros((B, n), dtype=torch.int64, device=dev)
    return zeros, zeros, torch.zeros((B, n), dtype=torch.bool, device=dev)


def assemble_synthetic_multi_object_sample_matrix(p1: dict, p2: dict, cfg: AssemblerConfig,
                                                  generator: torch.Generator):
    """Synthetic multi-object samples for the matrix loss: the composites of
    pairs ``p1`` and ``p2`` (dicts of ``[B, ...]`` device tensors, the keys
    of :func:`assemble_batch_matrix`'s batch) with pools over the merged
    mask of view 2 and, always, its complement. Returns ``(img_1, img_2,
    MatrixSampleIndices)`` with match type 4."""
    g = generator
    merged_1, merged_2, merged_mask_2, uv_1, uv_2, match_valid = _composite(p1, p2, cfg, g)
    B, H, W = merged_mask_2.shape
    masked_pool, masked_valid = _mask_pool(merged_mask_2, cfg.masked_pool_size, g)
    bg_pool, bg_valid = _mask_pool((merged_mask_2 == 0).to(torch.uint8),
                                   cfg.background_pool_size, g)
    blind_a, blind_b, blind_valid = _no_blind(B, cfg, merged_1.device)
    indices = MatrixSampleIndices(
        matches_a=_flatten_uv(uv_1, W),
        matches_b=_flatten_uv(uv_2, W),
        matches_uv_b=uv_2,
        matches_valid=match_valid,
        masked_pool_b=masked_pool,
        masked_pool_valid=masked_valid,
        background_pool_b=bg_pool,
        background_pool_valid=bg_valid,
        blind_nm_a=blind_a,
        blind_nm_b=blind_b,
        blind_nm_valid=blind_valid,
        match_type=torch.full((B,), MATCH_TYPE_SYNTHETIC_MULTI_OBJECT, dtype=torch.int64,
                              device=merged_1.device),
    )
    return _normalize(merged_1, cfg), _normalize(merged_2, cfg), indices


def assemble_synthetic_multi_object_sample(p1: dict, p2: dict, cfg: AssemblerConfig,
                                           generator: torch.Generator):
    """Synthetic multi-object samples for the per-pair loss: the composites
    of pairs ``p1`` and ``p2`` with non-matches per match on the merged mask
    of view 2 and off it (anywhere without ``use_image_b_mask_inv``).
    Returns ``(img_1, img_2, SampleIndices)`` with match type 4."""
    g = generator
    merged_1, merged_2, merged_mask_2, uv_1, uv_2, match_valid = _composite(p1, p2, cfg, g)
    B, H, W = merged_mask_2.shape
    masked_uv = create_non_correspondences(
        uv_2, (H, W), g, num_non_matches_per_match=cfg.num_masked_non_matches_per_match,
        mask_b=merged_mask_2)
    background_uv = create_non_correspondences(
        uv_2, (H, W), g, num_non_matches_per_match=cfg.num_background_non_matches_per_match,
        mask_b=(merged_mask_2 == 0).to(torch.uint8) if cfg.use_image_b_mask_inv else None)
    match_type = torch.full((B,), MATCH_TYPE_SYNTHETIC_MULTI_OBJECT, dtype=torch.int64,
                            device=merged_1.device)
    indices = _per_pair_indices(_flatten_uv(uv_1, W), _flatten_uv(uv_2, W), match_valid,
                                masked_uv, background_uv, *_no_blind(B, cfg, merged_1.device),
                                match_type, W, cfg)
    return _normalize(merged_1, cfg), _normalize(merged_2, cfg), indices


def _put_rows(x, rows, new):
    """``x`` with its ``rows`` replaced by ``new`` (a fresh tensor)."""
    out = x.clone(memory_format=torch.contiguous_format)
    out[rows] = new.to(out.dtype)
    return out


def _select_rows(is_smo, x, new):
    """``x`` with the rows where ``is_smo [B]`` is set taken from ``new``."""
    return torch.where(is_smo.view((-1,) + (1,) * (x.dim() - 1)), new.to(x.dtype), x)


def _with_smo_rows(out, batch: dict, f: dict, dev, cfg: AssemblerConfig, g: torch.Generator,
                   assemble_smo, every_row: bool):
    """The synthetic multi-object rows of an assembled batch ``out`` replaced
    by ``assemble_smo`` of their two pairs (``f`` and the batch's ``*_2``
    arrays); ``match_type`` stays the batch's. With ``every_row`` every row
    is composited and the type-4 ones are selected
    (``pdc_tpu/data/assembler.py:439-448``), with no host sync, so a CUDA
    graph can capture it; otherwise only those rows are composited, found
    with one host sync, and the draws that follow depend on how many there
    are."""
    img_a, img_b, indices = out
    is_smo = indices.match_type == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT
    if every_row:
        smo_a, smo_b, smo = assemble_smo(f, _frames(batch, dev, "_2"), cfg, g)
        merged = type(indices)(*[
            x if name == "match_type" else _select_rows(is_smo, x, y)
            for name, x, y in zip(indices._fields, indices, smo)])
        return _select_rows(is_smo, img_a, smo_a), _select_rows(is_smo, img_b, smo_b), merged
    rows = torch.nonzero(is_smo).flatten()
    if rows.numel() == 0:
        return out
    second = _frames(batch, dev, "_2")
    p1 = {k: v.index_select(0, rows) for k, v in f.items()}
    p2 = {k: v.index_select(0, rows) for k, v in second.items()}
    smo_a, smo_b, smo = assemble_smo(p1, p2, cfg, g)
    merged = type(indices)(*[
        x if name == "match_type" else _put_rows(x, rows, y)
        for name, x, y in zip(indices._fields, indices, smo)])
    return _put_rows(img_a, rows, smo_a), _put_rows(img_b, rows, smo_b), merged
