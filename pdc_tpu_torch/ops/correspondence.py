"""Correspondences between posed RGBD frames, with static shapes, batched
over leading axes.

Port of :mod:`pdc_tpu.ops.correspondence`: ``find_pixel_correspondences``
(:35-88), ``reproject_pixels`` (:91-146), ``_depth_to_metres`` (:149-153),
``create_non_correspondences`` (:156-233), ``make_blind_non_matches``
(:236-279) and ``make_blind_non_matches_perm`` (:282-325). Every stage
yields a validity mask over a fixed-size candidate set instead of pruning:

  1. sample candidate pixels in image a (uniform over a mask if given)
  2. unproject with depth a, camera a -> world -> camera b, project
  3. valid where (a) depth a > 0, (b) the projection lies in image b's field
     of view, (c) image b's depth at the truncated pixel is present and not
     closer than the projected depth minus a 3 mm margin
"""

from __future__ import annotations

import torch

from pdc_tpu_torch.geom.camera import project_to_image, unproject_to_camera
from pdc_tpu_torch.geom.transforms import invert_se3, transform_points
from pdc_tpu_torch.ops import sampling
from pdc_tpu_torch.utils.constants import DEPTH_IM_SCALE, OCCLUSION_MARGIN
from pdc_tpu_torch.utils.device import device_constant


def _depth_to_metres(depth):
    """Float depth is metres already; integer depth is millimetres."""
    depth = torch.as_tensor(depth)
    if depth.is_floating_point():
        return depth.to(torch.float32)
    return depth.to(torch.float32) / DEPTH_IM_SCALE


def _take_flat(image, flat):
    """``image [..., H, W]`` at flat indices ``[..., N]``."""
    img = image.reshape(image.shape[:-2] + (-1,))
    return torch.gather(img, -1, flat.to(torch.int64))


def reproject_pixels(uv_a, depth_a, pose_a, depth_b, pose_b, K):
    """Reproject pixels ``uv_a [..., N, 2]`` of image a into image b.

    :param depth_*: ``[..., H, W]`` (integer millimetres or float metres)
    :param pose_*: ``[..., 4, 4]`` camera-to-world; ``K [..., 3, 3]``
    :return: ``(uv_b [..., N, 2] float32, valid [..., N] bool)``
    """
    H, W = depth_a.shape[-2:]
    uv_a = torch.as_tensor(uv_a)
    n_flat_a = uv_a[..., 1].to(torch.int64) * W + uv_a[..., 0].to(torch.int64)
    z_a = _take_flat(_depth_to_metres(depth_a), n_flat_a)
    valid = z_a > 0.0

    pts_cam_a = unproject_to_camera(uv_a.to(torch.float32), z_a, K)
    pts_world = transform_points(pose_a, pts_cam_a)
    world_to_b = invert_se3(torch.as_tensor(pose_b, device=uv_a.device).to(torch.float32))
    uv_b, z_b = project_to_image(transform_points(world_to_b, pts_world), K)

    eps = 1e-3
    valid = valid & (uv_b[..., 0] >= 0.0) & (uv_b[..., 0] <= W - eps) \
        & (uv_b[..., 1] >= 0.0) & (uv_b[..., 1] <= H - eps) & (z_b > 0.0)

    # occlusion against image b's depth at the truncated pixel
    u_b = torch.clamp(uv_b[..., 0].to(torch.int64), 0, W - 1)
    v_b = torch.clamp(uv_b[..., 1].to(torch.int64), 0, H - 1)
    z_rendered = _take_flat(_depth_to_metres(depth_b), v_b * W + u_b)
    valid = valid & (z_rendered > 0.0) & (z_rendered >= z_b - OCCLUSION_MARGIN)
    return uv_b, valid


def find_pixel_correspondences(depth_a, pose_a, depth_b, pose_b, K,
                               generator: torch.Generator, num_attempts: int = 10000,
                               mask_a=None, perm_a=None, mask_count_a=None):
    """``num_attempts`` candidate pixels of image a (uniform over ``mask_a``,
    or over ``perm_a[:mask_count_a]``, or over the whole image), reprojected.

    :return: ``(uv_a [..., N, 2] int64, uv_b [..., N, 2] float32,
        valid [..., N] bool)``
    """
    H, W = depth_a.shape[-2:]
    batch = depth_a.shape[:-2]
    if perm_a is not None:
        flat_a, mask_ok = sampling.sample_flat_from_perm(perm_a, 0, mask_count_a,
                                                         num_attempts, generator)
        uv_a = torch.stack([flat_a % W, flat_a // W], dim=-1)
    elif mask_a is None:
        uv_a = sampling.sample_uniform_pixels(W, H, num_attempts, generator, batch,
                                              depth_a.device)
        mask_ok = torch.ones(batch, dtype=torch.bool, device=depth_a.device)
    else:
        uv_a, mask_ok = sampling.sample_from_mask(mask_a, num_attempts, generator)
    uv_b, valid = reproject_pixels(uv_a, depth_a, pose_a, depth_b, pose_b, K)
    return uv_a, uv_b, valid & mask_ok[..., None]


# create_non_correspondences draws its masked candidates from a pool of at
# most this many exact mask samples
NON_MATCH_POOL_SIZE = 8192


def create_non_correspondences(uv_b_matches, image_shape, generator: torch.Generator,
                               num_non_matches_per_match: int = 100, mask_b=None):
    """Non-matches in image b for each match, perturbing any that collide
    with it, as the reference does (perturb instead of prune).

    Candidates are uniform over image b, or over the nonzero pixels of
    ``mask_b [..., H, W]`` when given: a pool of ``min(N * M, 8192)`` exact
    inverse-CDF samples of the mask, then ``floor(u * pool_size)`` picks
    from it (the pool itself when it is that large); an empty mask falls
    back to uniform pixels. A candidate within 1 px of its row's match in u
    or in v is shifted by +-0.5 + N(0, 10) px (one scalar for both
    coordinates); coordinates then wrap once by ``dim - 1`` and are
    clipped to the image.

    Draw order: the pool, the picks, the uniform fallback (masked); the
    candidates (unmasked); then the signs and the normal noise.

    :param uv_b_matches: ``[..., N, 2]`` match pixels (u, v) in image b
    :param image_shape: ``(H, W)``
    :return: ``[..., N, M, 2]`` float32 non-match pixels
    """
    H, W = image_shape
    uv = torch.as_tensor(uv_b_matches).to(torch.float32)
    batch, N = uv.shape[:-2], uv.shape[-2]
    M = num_non_matches_per_match
    total = N * M
    dev = uv.device

    if mask_b is not None:
        mask_b = torch.as_tensor(mask_b, device=dev)
        pool_size = min(total, NON_MATCH_POOL_SIZE)
        pool, mask_ok = sampling.sample_from_mask(mask_b, pool_size, generator)
        if pool_size == total:
            cand = pool
        else:
            u = sampling.uniform(batch + (total,), generator, dev)
            pick = torch.clamp(torch.floor(u * pool_size).to(torch.int64), max=pool_size - 1)
            cand = torch.gather(pool, -2, pick[..., None].expand(batch + (total, 2)))
        fallback = sampling.sample_uniform_pixels(W, H, total, generator, batch, dev)
        cand = torch.where(mask_ok[..., None, None], cand, fallback)
    else:
        cand = sampling.sample_uniform_pixels(W, H, total, generator, batch, dev)
    cand = cand.reshape(batch + (N, M, 2)).to(torch.float32)

    diffs = torch.abs(uv[..., :, None, :] - cand)
    too_close = (diffs[..., 0] < 1.0) | (diffs[..., 1] < 1.0)

    sign = torch.floor(sampling.uniform(batch + (N, M), generator, dev) * 2.0) - 0.5
    minimal = sign * 2.0 * 0.5
    noise = sampling.normal(batch + (N, M), generator, dev) * 10.0 + minimal
    out = cand + torch.where(too_close, noise, torch.zeros_like(noise))[..., None]

    ub = device_constant((W - 1.0, H - 1.0), torch.float32, dev)
    out = torch.where(out > ub, out - ub, out)
    out = torch.where(out < 0.0, out + ub, out)
    return torch.minimum(torch.clamp(out, min=0.0), ub)


def _matched_bitmap(matches_a_flat, matches_valid, hw: int):
    """``[..., hw]`` bool: pixels of image a that are valid matches (invalid
    rows point at 0 and write False, so ``amax`` keeps any True there)."""
    idx = torch.where(matches_valid, matches_a_flat.to(torch.int64), 0)
    base = torch.zeros(matches_valid.shape[:-1] + (hw,), dtype=torch.int32,
                       device=matches_valid.device)
    return base.scatter_reduce(-1, idx, matches_valid.to(torch.int32), reduce="amax") > 0


def make_blind_non_matches(generator: torch.Generator, mask_a, matches_a_flat, matches_valid,
                           mask_b, num_samples: int):
    """Blind non-matches: ``num_samples`` unmatched object pixels of image a
    against random object pixels of image b.

    :return: ``(blind_a [..., S] int64, blind_b [..., S] int64,
        valid [...] bool)``
    """
    W = mask_a.shape[-1]
    mask_a_flat = mask_a.reshape(mask_a.shape[:-2] + (-1,)) != 0
    candidates = mask_a_flat & ~_matched_bitmap(matches_a_flat, matches_valid,
                                                mask_a_flat.shape[-1])
    blind_a, ok_a = sampling.sample_flat_from_mask(candidates, num_samples, generator)
    uv_b, ok_b = sampling.sample_from_mask(mask_b, num_samples, generator)
    return blind_a, uv_b[..., 1] * W + uv_b[..., 0], ok_a & ok_b


def make_blind_non_matches_perm(generator: torch.Generator, perm_a, count_a, flip_a,
                                matches_a_flat, matches_valid, perm_b, count_b, flip_b,
                                hw: int, num_samples: int):
    """:func:`make_blind_non_matches` on valid-first pixel permutations of
    the unaugmented masks. ``flip_*`` ``[...]`` bool say whether each image
    was rotated by 180 degrees after its permutation was built (flat index n
    maps to hw-1-n). A draw that hits a matched pixel is invalidated, so the
    valid draws are uniform over the unmatched object pixels.

    :return: ``(blind_a [..., S], blind_b [..., S] int64,
        valid [..., S] bool)``
    """
    raw_a, ok_a = sampling.sample_flat_from_perm(perm_a, 0, count_a, num_samples, generator)
    raw_b, ok_b = sampling.sample_flat_from_perm(perm_b, 0, count_b, num_samples, generator)
    blind_a = torch.where(flip_a[..., None], hw - 1 - raw_a, raw_a)
    blind_b = torch.where(flip_b[..., None], hw - 1 - raw_b, raw_b)
    hit = torch.gather(_matched_bitmap(matches_a_flat, matches_valid, hw), -1, blind_a)
    return blind_a, blind_b, (ok_a & ok_b)[..., None] & ~hit
