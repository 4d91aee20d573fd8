"""Data augmentation with joint image and pixel-index changes, batched over
leading axes.

Port of :mod:`pdc_tpu.ops.augmentation` (``flip_180`` :17-25,
``random_flip_180`` :28-44, ``domain_randomize_background`` :62-95,
``random_domain_randomize_background`` :98-103,
``merge_images_with_occlusions`` :106-156, ``merge_matches`` :159-164).
Images are ``[..., H, W, C]`` uint8, pixel positions ``[..., N, 2]``
(u, v). Every op keeps static shapes and selects per image with
``torch.where``.
"""

from __future__ import annotations

import torch

from pdc_tpu_torch.ops import sampling


def flip_180(image, uv):
    """Rotate images by 180 degrees and remap pixel positions."""
    H, W = image.shape[-3], image.shape[-2]
    uv = torch.as_tensor(uv)
    new_uv = torch.stack([(W - 1) - uv[..., 0], (H - 1) - uv[..., 1]], dim=-1)
    return torch.flip(image, dims=(-3, -2)), new_uv.to(uv.dtype)


def random_flip_180(image, uv, generator: torch.Generator, extra_images=(),
                    return_flag: bool = False):
    """With probability 0.5 per image, rotate ``image [..., H, W, C]`` and the
    ``extra_images [..., H, W]`` by 180 degrees and remap ``uv``. With
    ``return_flag`` also returns the coin ``[...]`` bool (a rotation maps
    flat index n to H*W-1-n)."""
    do = sampling.uniform(image.shape[:-3], generator, image.device) < 0.5
    flipped, new_uv = flip_180(image, uv)
    image_out = torch.where(do[..., None, None, None], flipped, image)
    uv_out = torch.where(do[..., None, None], new_uv, torch.as_tensor(uv))
    extras = tuple(torch.where(do[..., None, None], torch.flip(e, dims=(-2, -1)), e)
                   for e in extra_images)
    if return_flag:
        return image_out, uv_out, extras, do
    return image_out, uv_out, extras


def _random_colour(generator, batch, device):
    return torch.floor(sampling.uniform(batch + (3,), generator, device) * 255.0).to(torch.uint8)


def domain_randomize_background(image_rgb, mask, generator: torch.Generator):
    """Replace the background (``mask == 0``) of ``image_rgb [..., H, W, 3]``
    uint8 with a random solid colour or a horizontal or vertical gradient
    between two random colours, half of the time plus and minus uint8 noise
    in [0, 50) that wraps around on overflow, as the reference does on
    purpose.

    Draw order per call: kind, colour 1, colour 2, orientation, noise coin,
    noise image 1, noise image 2 (the JAX function's key order)."""
    image = torch.as_tensor(image_rgb).to(torch.uint8)
    batch = image.shape[:-3]
    H, W = image.shape[-3], image.shape[-2]
    dev = image.device
    kind = sampling.uniform(batch, generator, dev)
    c1 = _random_colour(generator, batch, dev)
    c2 = _random_colour(generator, batch, dev)
    vertical = sampling.uniform(batch, generator, dev) > 0.5
    noise_q = sampling.uniform(batch, generator, dev)
    n1 = torch.floor(sampling.uniform(image.shape, generator, dev) * 50.0).to(torch.uint8)
    n2 = torch.floor(sampling.uniform(image.shape, generator, dev) * 50.0).to(torch.uint8)

    ones = torch.ones(image.shape, dtype=torch.uint8, device=dev)
    solid = ones * c1[..., None, None, :]
    pv = (torch.arange(H, dtype=torch.float32, device=dev) / max(H - 1, 1))[:, None, None]
    ph = (torch.arange(W, dtype=torch.float32, device=dev) / max(W - 1, 1))[None, :, None]
    p = torch.where(vertical[..., None, None, None], pv.expand(H, W, 1), ph.expand(H, W, 1))
    grad = (c2.to(torch.float32)[..., None, None, :] * p
            + c1.to(torch.float32)[..., None, None, :] * (1.0 - p)).to(torch.uint8)
    rand_image = torch.where((kind < 0.5)[..., None, None, None], solid, grad)
    noisy = rand_image + n1 - n2  # uint8 arithmetic wraps, as in the reference
    rand_image = torch.where((noise_q < 0.5)[..., None, None, None], rand_image, noisy)
    obj = (torch.as_tensor(mask, device=dev) != 0)[..., None]
    return torch.where(obj, image, rand_image)


def random_domain_randomize_background(image_rgb, mask, generator: torch.Generator):
    """With probability 0.5 per image apply
    :func:`domain_randomize_background` (the coin is drawn first)."""
    image = torch.as_tensor(image_rgb).to(torch.uint8)
    do = sampling.uniform(image.shape[:-3], generator, image.device) < 0.5
    randomized = domain_randomize_background(image, mask, generator)
    return torch.where(do[..., None, None, None], randomized, image)


def merge_images_with_occlusions(image_a, image_b, mask_a, mask_b, matches_a_pair,
                                 matches_b_pair, valid_a, valid_b, generator: torch.Generator):
    """Composite two object crops into one image (synthetic multi-object
    samples) and invalidate the matches that the object in front covers.

    One coin per composite (``[...]``, drawn first) puts object a in front
    when below 0.5. A match of the object behind dies where the front
    object's mask covers its pixel in this image (uv truncated toward zero,
    then clipped to the image).

    :param image_*: ``[..., H, W, 3]`` uint8; ``mask_*``: ``[..., H, W]``
    :param matches_*_pair: ``(uv in this image [..., N, 2], uv in the
        partner image)`` of object a's and object b's matches
    :param valid_*: ``[..., N]`` bool
    :return: ``(merged image [..., H, W, 3] uint8, merged mask [..., H, W]
        int32 (the union), (matches_a_pair, valid_a), (matches_b_pair,
        valid_b))``
    """
    mask_a = torch.as_tensor(mask_a) != 0
    mask_b = torch.as_tensor(mask_b).to(mask_a.device) != 0
    H, W = mask_a.shape[-2:]
    a_is_fg = sampling.uniform(mask_a.shape[:-2], generator, mask_a.device) < 0.5
    fg_mask = torch.where(a_is_fg[..., None, None], mask_a, mask_b)
    image_a = torch.as_tensor(image_a).to(torch.uint8)
    image_b = torch.as_tensor(image_b).to(torch.uint8)
    a_front = a_is_fg[..., None, None, None]
    fg_img = torch.where(a_front, image_a, image_b)
    bg_img = torch.where(a_front, image_b, image_a)
    merged = torch.where(fg_mask[..., None], fg_img, bg_img)
    merged_mask = (mask_a | mask_b).to(torch.int32)

    fg_flat = fg_mask.reshape(fg_mask.shape[:-2] + (H * W,))

    def occluded(uv):
        u = torch.clamp(uv[..., 0].to(torch.int64), 0, W - 1)
        v = torch.clamp(uv[..., 1].to(torch.int64), 0, H - 1)
        return torch.gather(fg_flat, -1, v * W + u)

    fg = a_is_fg[..., None]
    valid_a = valid_a & (fg | ~occluded(matches_a_pair[0]))
    valid_b = valid_b & (~fg | ~occluded(matches_b_pair[0]))
    return merged, merged_mask, (matches_a_pair, valid_a), (matches_b_pair, valid_b)


def merge_matches(matches_one, valid_one, matches_two, valid_two):
    """Concatenate two match sets ``[..., N, 2]`` and their validity
    ``[..., N]`` along the match axis."""
    return (torch.cat([torch.as_tensor(matches_one), torch.as_tensor(matches_two)], dim=-2),
            torch.cat([torch.as_tensor(valid_one), torch.as_tensor(valid_two)], dim=-1))
