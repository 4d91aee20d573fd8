"""Qualitative evaluation: the panels researchers look at.

Port of :mod:`pdc_tpu.evaluation.qualitative`: best-match panels of sampled
pixels, descriptor colormaps, keypoint heatmap panels and 2-D cluster
plots, each written to a PNG (headless: no window, no cv2 HighGUI). The
best matches of a panel's sampled pixels are one call of
:func:`~pdc_tpu_torch.ops.matching.best_matches_batch`, the best-match
kernel on the card. matplotlib is imported by the functions that draw.

Random pixels come from a ``torch.Generator`` per image pair
(:func:`~pdc_tpu_torch.evaluation.evaluate.pair_generator`); they cannot
reproduce ``jax.random``'s draws, so a panel equals the JAX package's only
for the same pixels.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from pdc_tpu_torch.evaluation.evaluate import pair_generator, pair_seed
from pdc_tpu_torch.evaluation.plotting import normalize_descriptor, normalize_descriptor_pair
from pdc_tpu_torch.ops.matching import best_matches_batch
from pdc_tpu_torch.ops.sampling import sample_from_mask
from pdc_tpu_torch.utils.visualization import compute_gaussian_kernel_heatmap_from_norm_diffs

logger = logging.getLogger(__name__)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_gray_rgb(img):
    """uint8 RGB -> grayscale replicated to 3 channels (matches are drawn
    over grayscale images so that the coloured lines stand out)."""
    img = np.asarray(img)
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    return np.repeat(gray[..., None], 3, axis=2).astype(np.uint8)


def draw_correspondence_panel(rgb_a, rgb_b, uv_a, uv_b, ax=None, title=None,
                              gray: bool = True):
    """Side-by-side image pair with coloured lines joining correspondences
    (``uv_b`` in image b's frame). Returns the matplotlib Axes."""
    plt = _plt()
    rgb_a, rgb_b = np.asarray(rgb_a), np.asarray(rgb_b)
    Ha, Wa = rgb_a.shape[:2]
    Hb, Wb = rgb_b.shape[:2]
    panel = np.zeros((max(Ha, Hb), Wa + Wb, 3), np.uint8)
    panel[:Ha, :Wa] = _to_gray_rgb(rgb_a) if gray else rgb_a
    panel[:Hb, Wa:] = _to_gray_rgb(rgb_b) if gray else rgb_b
    if ax is None:
        _, ax = plt.subplots(figsize=(15, 6))
    ax.imshow(panel)
    uv_a = np.atleast_2d(np.asarray(_numpy(uv_a), np.float64))
    uv_b = np.atleast_2d(np.asarray(_numpy(uv_b), np.float64))
    cmap = plt.get_cmap("hsv")
    n = max(len(uv_a), 1)
    for i, ((ua, va), (ub, vb)) in enumerate(zip(uv_a, uv_b)):
        c = cmap(i / n)
        ax.plot([ua, ub + Wa], [va, vb], color=c, linewidth=1.0)
        ax.scatter([ua, ub + Wa], [va, vb], color=c, s=12)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    return ax


def plot_descriptor_colormaps(res_a, res_b, descriptor_image_stats=None,
                              mask_a=None, mask_b=None, plot_masked=False,
                              descriptor_norm_type="mask_image"):
    """RGB colormap figure of a descriptor-image pair, optionally with masked
    variants. D must be 1 or 3. Returns the matplotlib Figure."""
    plt = _plt()
    res_a, res_b = _numpy(res_a), _numpy(res_b)
    nrows = 2 if plot_masked else 1
    fig, axes = plt.subplots(nrows=nrows, ncols=2, squeeze=False, figsize=(15, 5 * nrows))
    if descriptor_image_stats is None:
        res_a_norm, res_b_norm = normalize_descriptor_pair(res_a, res_b)
    else:
        res_a_norm = normalize_descriptor(res_a, descriptor_image_stats[descriptor_norm_type])
        res_b_norm = normalize_descriptor(res_b, descriptor_image_stats[descriptor_norm_type])
    axes[0][0].imshow(np.squeeze(res_a_norm))
    axes[0][1].imshow(np.squeeze(res_b_norm))
    axes[0][0].set_title("descriptor image a")
    axes[0][1].set_title("descriptor image b")
    if plot_masked:
        if mask_a is None or mask_b is None:
            raise ValueError("plot_masked needs mask_a and mask_b")
        mask_a = np.asarray(mask_a) != 0
        mask_b = np.asarray(mask_b) != 0
        ma = mask_a[..., None].astype(res_a.dtype)
        mb = mask_b[..., None].astype(res_b.dtype)
        if descriptor_image_stats is None:
            # joint min/max over the masked pixels only
            both = np.concatenate([res_a[mask_a].reshape(-1, res_a.shape[-1]),
                                   res_b[mask_b].reshape(-1, res_b.shape[-1])], axis=0)
            stats = {"min": both.min(axis=0), "max": both.max(axis=0)}
            res_a_nm = normalize_descriptor(res_a, stats) * ma
            res_b_nm = normalize_descriptor(res_b, stats) * mb
        else:
            res_a_nm = normalize_descriptor(res_a * ma, descriptor_image_stats["mask_image"]) * ma
            res_b_nm = normalize_descriptor(res_b * mb, descriptor_image_stats["mask_image"]) * mb
        axes[1][0].imshow(np.squeeze(res_a_nm))
        axes[1][1].imshow(np.squeeze(res_b_nm))
        axes[1][0].set_title("masked descriptor image a")
        axes[1][1].set_title("masked descriptor image b")
    for row in axes:
        for ax in row:
            ax.set_axis_off()
    return fig


def single_image_pair_qualitative_analysis(dcn, dataset, rgb_a, rgb_b, mask_a, mask_b,
                                           num_matches: int = 10,
                                           generator: Optional[torch.Generator] = None):
    """Best-match panel of ``num_matches`` pixels sampled from mask a, and
    the descriptor colormaps. Returns (match figure, colormap figure or
    None)."""
    plt = _plt()
    if generator is None:
        generator = pair_generator(1)
    res_a = dcn.forward_on_img(rgb_a)
    res_b = dcn.forward_on_img(rgb_b)
    uv_a, ok = sample_from_mask(torch.as_tensor(np.asarray(mask_a), device=res_a.device),
                                num_matches, generator)
    if not bool(ok):
        logger.warning("empty mask; sampling uniformly for qualitative plot")
    queries = res_a[uv_a[:, 1], uv_a[:, 0], :]
    best_uv, _ = best_matches_batch(queries, res_b)
    fig, ax = plt.subplots(figsize=(15, 10))
    draw_correspondence_panel(rgb_a, rgb_b, uv_a, best_uv, ax=ax,
                              title="sampled pixels -> best matches")
    cfig = None
    if dcn.descriptor_dimension in (1, 3):
        try:
            stats = dcn.descriptor_image_stats
        except (OSError, ValueError):
            logger.info("no descriptor image stats; normalizing pair only")
            stats = None
        cfig = plot_descriptor_colormaps(res_a, res_b, descriptor_image_stats=stats,
                                         mask_a=mask_a, mask_b=mask_b, plot_masked=True)
    return fig, cfig


def single_same_scene_image_pair_qualitative_analysis(dcn, dataset, scene_name, img_a_idx,
                                                      img_b_idx, num_matches: int = 10,
                                                      generator=None):
    rgb_a, _, mask_a, _ = dataset.get_rgbd_mask_pose(scene_name, img_a_idx)
    rgb_b, _, mask_b, _ = dataset.get_rgbd_mask_pose(scene_name, img_b_idx)
    return single_image_pair_qualitative_analysis(dcn, dataset, rgb_a, rgb_b, mask_a, mask_b,
                                                  num_matches, generator)


def single_cross_scene_image_pair_qualitative_analysis(dcn, dataset, scene_name_a, img_a_idx,
                                                       scene_name_b, img_b_idx,
                                                       num_matches: int = 10, generator=None):
    rgb_a, _, mask_a, _ = dataset.get_rgbd_mask_pose(scene_name_a, img_a_idx)
    rgb_b, _, mask_b, _ = dataset.get_rgbd_mask_pose(scene_name_b, img_b_idx)
    return single_image_pair_qualitative_analysis(dcn, dataset, rgb_a, rgb_b, mask_a, mask_b,
                                                  num_matches, generator)


def single_image_pair_keypoint_qualitative_analysis(
        dcn, dataset, keypoint_data_a, keypoint_data_b,
        heatmap_kernel_variance: float = 0.25,
        blend_weight_original_image: float = 0.3,
        plot_title: str = "Keypoints"):
    """Keypoint best-match panel and the Gaussian heatmap of image b blended
    over it. ``keypoint_data_*`` are dicts with scene_name, image_idx, u, v.
    Returns the Figure."""
    plt = _plt()
    uv_a = dcn.clip_pixel_to_image_size_and_round((keypoint_data_a["u"], keypoint_data_a["v"]))
    uv_b = dcn.clip_pixel_to_image_size_and_round((keypoint_data_b["u"], keypoint_data_b["v"]))
    rgb_a = dataset.get_rgbd_mask_pose(keypoint_data_a["scene_name"],
                                       keypoint_data_a["image_idx"])[0]
    rgb_b = dataset.get_rgbd_mask_pose(keypoint_data_b["scene_name"],
                                       keypoint_data_b["image_idx"])[0]
    res_a = dcn.forward_on_img(rgb_a)
    res_b = dcn.forward_on_img(rgb_b)
    best_uv, _, norm_diffs = dcn.find_best_match(uv_a, res_a, res_b)
    fig, axes = plt.subplots(nrows=2, ncols=1, figsize=(15, 10))
    draw_correspondence_panel(rgb_a, rgb_b, [uv_a], [_numpy(best_uv)], ax=axes[0],
                              title=plot_title)
    axes[0].scatter([uv_b[0] + np.asarray(rgb_a).shape[1]], [uv_b[1]],
                    marker="x", color="lime", s=60, label="labeled target")
    axes[0].legend(loc="lower right")
    heatmap = compute_gaussian_kernel_heatmap_from_norm_diffs(norm_diffs,
                                                              heatmap_kernel_variance)
    alpha = blend_weight_original_image
    blended = (alpha * np.asarray(rgb_b, np.float32)
               + (1 - alpha) * np.asarray(heatmap, np.float32))
    axes[1].imshow(blended.astype(np.uint8))
    axes[1].set_axis_off()
    axes[1].set_title("best-match heatmap")
    return fig


def get_random_scenes_and_image_pairs(dataset, num_pairs: int = 5):
    """Random (scene, (idx_a, idx_b)) pose-separated pairs."""
    scene_names, img_pairs = [], []
    for _ in range(num_pairs):
        scene_name = dataset.get_random_scene_name()
        scene = dataset.get_scene(scene_name)
        idx_a = dataset.get_random_image_index(scene_name)
        idx_b = dataset.get_img_idx_with_different_pose(
            scene_name, scene.poses[scene.position(idx_a)])
        if idx_b is None:
            continue
        scene_names.append(scene_name)
        img_pairs.append((idx_a, idx_b))
    return scene_names, img_pairs


def evaluate_network_qualitative(dcn, dataset, num_image_pairs: int = 5,
                                 output_dir: Optional[str] = None,
                                 scene_image_pairs: Optional[list] = None,
                                 num_matches: int = 10, seed: int = 1):
    """For the train and test splits, ``num_image_pairs`` pose-separated
    pairs (or ``scene_image_pairs``, ``[(scene, idx_a, idx_b), ...]``), each
    with a best-match panel and descriptor colormaps. Returns dict mode ->
    list of written PNG paths (empty when ``output_dir`` is None)."""
    plt = _plt()
    written = {}
    n_pairs = 0
    original_mode = dataset.mode
    try:
        for mode in ("train", "test"):
            dataset.mode = mode
            if scene_image_pairs is not None:
                pairs = scene_image_pairs
            else:
                names, idxs = get_random_scenes_and_image_pairs(dataset, num_image_pairs)
                pairs = [(n, a, b) for n, (a, b) in zip(names, idxs)]
            files = []
            for i, (scene_name, idx_a, idx_b) in enumerate(pairs):
                fig, cfig = single_same_scene_image_pair_qualitative_analysis(
                    dcn, dataset, scene_name, idx_a, idx_b, num_matches=num_matches,
                    generator=pair_generator(pair_seed(seed, n_pairs)))
                n_pairs += 1
                if output_dir is not None:
                    os.makedirs(os.path.join(output_dir, mode), exist_ok=True)
                    p = os.path.join(output_dir, mode, f"qual_{i:02d}_matches.png")
                    fig.savefig(p, bbox_inches="tight")
                    files.append(p)
                    if cfig is not None:
                        p2 = os.path.join(output_dir, mode, f"qual_{i:02d}_descriptors.png")
                        cfig.savefig(p2, bbox_inches="tight")
                        files.append(p2)
                plt.close(fig)
                if cfig is not None:
                    plt.close(cfig)
            written[mode] = files
    finally:
        dataset.mode = original_mode
    return written


def make_2d_cluster_plot(dcn, dataset, num_images: int = 100, num_samples_per_image: int = 100,
                         plot_background: bool = False, output_dir: Optional[str] = None,
                         seed: int = 19680801):
    """Object-labelled scatter plots of sampled descriptors: xy, yz and xz
    projections for D=3, one plot for D=2, written as cluster_plot_*.png.
    Returns dict object_id -> [N, D] sampled descriptors (and 'background'
    with ``plot_background``)."""
    if dcn.descriptor_dimension not in (2, 3):
        raise ValueError("the cluster plot projects D = 2 or 3 descriptors")
    plt = _plt()
    num_objects = max(dataset.get_number_of_unique_single_objects(), 1)
    samples, background = {}, []
    for i in range(num_images):
        object_id, _ = dataset.get_random_object_id_and_int()
        scene_name = dataset.get_random_single_object_scene_name(object_id)
        img_idx = dataset.get_random_image_index(scene_name)
        rgb, _, mask, _ = dataset.get_rgbd_mask_pose(scene_name, img_idx)
        res = dcn.forward_on_img(rgb)
        gen = pair_generator(pair_seed(seed, i))
        mask = torch.as_tensor(np.asarray(mask), device=res.device)
        uv_obj, ok_obj = sample_from_mask(mask, num_samples_per_image, gen)
        uv_bg, ok_bg = sample_from_mask((mask == 0).to(torch.uint8),
                                        max(num_samples_per_image // num_objects, 1), gen)
        res = _numpy(res)
        if bool(ok_obj):
            uv = _numpy(uv_obj)
            samples.setdefault(object_id, []).append(res[uv[:, 1], uv[:, 0], :])
        if plot_background and bool(ok_bg):
            uv = _numpy(uv_bg)
            background.append(res[uv[:, 1], uv[:, 0], :])
    samples = {k: np.concatenate(v, axis=0) for k, v in samples.items()}
    if plot_background and background:
        samples["background"] = np.concatenate(background, axis=0)
    projections = ([((0, 1), "xy")] if dcn.descriptor_dimension == 2
                   else [((0, 1), "xy"), ((1, 2), "yz"), ((0, 2), "xz")])
    for (i, j), tag in projections:
        fig, ax = plt.subplots(figsize=(8, 8))
        for object_id, d in samples.items():
            ax.scatter(d[:, i], d[:, j], alpha=0.5, label=object_id, s=8)
        ax.legend()
        ax.set_xlabel(f"descriptor[{i}]")
        ax.set_ylabel(f"descriptor[{j}]")
        ax.set_title(f"descriptor clusters ({tag})")
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            fig.savefig(os.path.join(output_dir, f"cluster_plot_{tag}.png"), bbox_inches="tight")
        plt.close(fig)
    return samples
