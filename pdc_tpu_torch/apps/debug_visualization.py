"""Annotation replay viewer and the assembler's debug panels.

Port of :mod:`pdc_tpu.apps.debug_visualization` (:40-321). Two tools to
check by eye:

* :func:`visualize_saved_correspondences` replays a saved
  ``new_annotated_pairs.yaml`` with a coloured reticle per pixel (the
  reference's ``visualize_saved_correspondences.py:1-71``; n = next pair,
  q/ESC = quit). Headless, it writes ``pair_%03d_{a,b}.png`` with the port's
  own PNG encoder; ``interactive`` imports cv2.
* :func:`debug_batch_panels` draws what the port's assembler sampled for a
  few pairs: matches, masked and background non-matches, blind
  non-matches, and four mask panels (the reference's
  ``SpartanDataset(debug=True)``, ``spartan_dataset_masked.py:73-84`` and
  ``:772-835``). Types 0-3 go through
  :func:`~pdc_tpu_torch.data.assembler.assemble_batch` with one pair, type
  4 through :func:`~pdc_tpu_torch.data.assembler.assemble_synthetic_multi_object_sample`,
  with draws from a ``torch.Generator`` seeded with ``seed``. The panels
  need matplotlib.

    python -m pdc_tpu_torch debug-vis view --config <composite.yaml> \\
        --annotations new_annotated_pairs.yaml --out <dir>
    python -m pdc_tpu_torch debug-vis debug --config <composite.yaml> --out <dir> [--device cpu]
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np
import torch

from pdc_tpu_torch.apps.annotate_correspondences import LABEL_COLORS
from pdc_tpu_torch.utils.yaml_io import load_yaml

# matplotlib colours of the panel overlays (the reference's debug mode uses
# g/r/b/k circles, spartan_dataset_masked.py:790-835)
_MATCH_COLOR = "g"
_MASKED_NM_COLOR = "r"
_BACKGROUND_NM_COLOR = "b"
_BLIND_NM_COLOR = "k"


def _annotated_pair_images(dataset, ann: dict):
    """(img_a, img_b): uint8 RGB copies with the reticles of one saved
    annotation drawn."""
    from pdc_tpu_torch.utils.visualization import draw_reticle

    out = []
    for side in ("image_a", "image_b"):
        e = ann[side]
        rgb = np.array(dataset.get_rgbd_mask_pose(e["scene_name"], int(e["image_idx"]))[0],
                       dtype=np.uint8, copy=True)
        for i, px in enumerate(e["pixels"]):
            rgb = draw_reticle(rgb, int(px["u"]), int(px["v"]),
                               LABEL_COLORS[i % len(LABEL_COLORS)])
        out.append(rgb)
    return out[0], out[1]


def visualize_saved_correspondences(dataset, annotations: Union[str, List[dict]],
                                    output_dir: Optional[str] = None,
                                    interactive: bool = False):
    """Replay saved annotated pairs with coloured reticles.

    :param annotations: path of ``new_annotated_pairs.yaml`` or the loaded
        list (the labeler's format)
    :param output_dir: directory of the ``pair_%03d_{a,b}.png`` files
        (headless; default the current directory)
    :param interactive: cv2 windows with the reference's keys (n = next
        pair, wrapping; q/ESC = quit); nothing is written
    :return: the paths written (headless)
    """
    if isinstance(annotations, str):
        annotations = load_yaml(annotations)
    if not annotations:
        return []

    if interactive:  # pragma: no cover - interactive cv2 UI
        import cv2

        idx = 0
        while True:
            img_a, img_b = _annotated_pair_images(dataset, annotations[idx])
            cv2.imshow("image1", cv2.cvtColor(img_a, cv2.COLOR_RGB2BGR))
            cv2.imshow("image2", cv2.cvtColor(img_b, cv2.COLOR_RGB2BGR))
            k = cv2.waitKey(0) & 0xFF
            if k in (27, ord("q")):
                break
            if k == ord("n"):
                idx = (idx + 1) % len(annotations)
        cv2.destroyAllWindows()
        return []

    from pdc_tpu_torch.data.native_loader import write_png

    output_dir = output_dir or "."
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for j, ann in enumerate(annotations):
        img_a, img_b = _annotated_pair_images(dataset, ann)
        for tag, img in (("a", img_a), ("b", img_b)):
            path = os.path.join(output_dir, f"pair_{j:03d}_{tag}.png")
            write_png(path, img)
            paths.append(path)
    return paths


def _subsample(uv_a, uv_b, valid, n, rng):
    """Random subset of the valid rows (reference subsample_tuple_pair,
    spartan_dataset_masked.py:1285-1302)."""
    idx = np.where(np.asarray(valid))[0]
    if idx.size == 0:
        return np.zeros((0, 2)), np.zeros((0, 2))
    pick = rng.choice(idx, size=min(n, idx.size), replace=False)
    return np.asarray(uv_a)[pick], np.asarray(uv_b)[pick]


def _flat_to_uv(flat, W):
    flat = np.asarray(flat)
    return np.stack([flat % W, flat // W], axis=-1)


def detect_flip(flat_idx, valid, mask):
    """Was this image 180-flipped by augmentation after ``mask`` was read?
    Matches are sampled on the object, so the orientation whose mask covers
    more matched pixels is the indices' frame (a flat 180 flip reverses the
    index)."""
    valid = np.asarray(valid)
    if not valid.any():
        return False
    m = np.asarray(mask).reshape(-1) != 0
    hit = np.zeros(m.size, bool)
    hit[np.asarray(flat_idx)[valid]] = True
    return bool((hit & m[::-1]).sum() > (hit & m).sum())


def _one_pair_batch(pair) -> dict:
    """A sampled pair as a batch of one (and its second pair, type 4)."""
    batch = {"match_type": np.asarray([pair.match_type], np.int32)}
    for suffix, p in (("", pair), ("_2", pair.second)):
        if p is None:
            continue
        for key in ("rgb_a", "depth_a", "mask_a", "pose_a", "rgb_b", "depth_b", "mask_b",
                    "pose_b", "K"):
            x = np.asarray(getattr(p, key))
            if key.startswith("pose") or key == "K":
                x = x.astype(np.float32)
            batch[key + suffix] = x[None]
    return batch


def _panels_matplotlib():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("debug_batch_panels draws its panels with matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def debug_batch_panels(dataset, num_pairs: int, output_dir: str, seed: int = 0, cfg=None,
                       num_matches_to_plot: int = 10, match_type: Optional[int] = None,
                       device="cuda"):
    """Draw the assembler's sampling of ``num_pairs`` pairs.

    Per pair, four correspondence panels (PNG) after the reference's debug
    plots (spartan_dataset_masked.py:790-835): matches (green), masked
    non-matches (red) and background non-matches (blue), each over the
    matches, and blind non-matches (black); and a mask figure (object mask,
    background, matched pixels, object pixels without a match). The indices
    are the assembler's own, on ``device``, flips included.

    :return: list of (match_type, [png paths]) per pair
    """
    from pdc_tpu_torch.data.assembler import (
        AssemblerConfig,
        _frames,
        assemble_batch,
        assemble_synthetic_multi_object_sample,
    )
    from pdc_tpu_torch.ops.plotter import plot_correspondences_direct
    from pdc_tpu_torch.utils.device import resolve_device

    plt = _panels_matplotlib()
    dev = resolve_device(device)
    if cfg is None:
        # small counts: these are plots to look at, not training samples
        cfg = AssemblerConfig(num_matching_attempts=500,
                              num_masked_non_matches_per_match=3,
                              num_background_non_matches_per_match=3,
                              num_blind_samples=200)
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    results = []
    for p in range(num_pairs):
        pair = dataset.sample_pair(match_type)
        batch = _one_pair_batch(pair)
        if pair.second is not None:  # synthetic multi-object compositing
            img_a, img_b, s = assemble_synthetic_multi_object_sample(
                _frames(batch, dev), _frames(batch, dev, "_2"), cfg, gen)
        else:
            img_a, img_b, s = assemble_batch(batch, cfg, gen, device=dev)
        s = type(s)(*[x[0].cpu().numpy() for x in s])
        H, W = np.asarray(pair.depth_a).shape

        # de-normalised for display (the images as the assembler left them,
        # flipped or randomised; the indices refer to these pixels)
        mean = np.asarray(cfg.image_mean, np.float32)
        std = np.asarray(cfg.image_std, np.float32)
        disp_a = np.clip((img_a[0].cpu().numpy() * std + mean) * 255, 0, 255).astype(np.uint8)
        disp_b = np.clip((img_b[0].cpu().numpy() * std + mean) * 255, 0, 255).astype(np.uint8)
        depth_a = np.asarray(pair.depth_a)
        depth_b = np.asarray(pair.depth_b)

        uv_m_a = _flat_to_uv(s.matches_a, W)
        uv_m_b = _flat_to_uv(s.matches_b, W)
        m_valid = np.asarray(s.matches_valid)

        # the assembler may have flipped either image after the raw frames
        # were read: the indices are post-flip, the raw depth and mask
        # pre-flip. Match indices tell within-scene types; types without
        # matches fall back to the blind sets, sampled on the masks too.
        def side_flip(primary, primary_valid, fallback, fallback_valid, mask):
            if np.asarray(primary_valid).any():
                return detect_flip(primary, primary_valid, mask)
            return detect_flip(fallback, fallback_valid, mask)

        flip_a = side_flip(s.matches_a, m_valid, s.blind_nm_a, s.blind_nm_valid, pair.mask_a)
        flip_b = side_flip(s.matches_b, m_valid, s.blind_nm_b, s.blind_nm_valid, pair.mask_b)
        if flip_a:
            depth_a = depth_a[::-1, ::-1]
        if flip_b:
            depth_b = depth_b[::-1, ::-1]

        paths = []

        def panel(name, uv2_a, uv2_b, color):
            fig, axes = plot_correspondences_direct(
                disp_a, depth_a, disp_b, depth_b,
                *_subsample(uv_m_a, uv_m_b, m_valid, num_matches_to_plot, rng), show=False)
            plot_correspondences_direct(disp_a, depth_a, disp_b, depth_b, uv2_a, uv2_b,
                                        use_previous_plot=(fig, axes), circ_color=color,
                                        show=False)
            path = os.path.join(output_dir, f"pair_{p:03d}_{name}.png")
            fig.savefig(path)
            plt.close(fig)
            paths.append(path)

        def non_matches(a, b, valid, n):
            return _subsample(_flat_to_uv(a, W), _flat_to_uv(b, W), valid, n, rng)

        panel("matches", np.zeros((0, 2)), np.zeros((0, 2)), _MATCH_COLOR)
        panel("masked_non_matches",
              *non_matches(s.masked_nm_a, s.masked_nm_b, s.masked_nm_valid,
                           num_matches_to_plot * 3), _MASKED_NM_COLOR)
        panel("background_non_matches",
              *non_matches(s.background_nm_a, s.background_nm_b, s.background_nm_valid,
                           num_matches_to_plot * 3), _BACKGROUND_NM_COLOR)
        panel("blind_non_matches",
              *non_matches(s.blind_nm_a, s.blind_nm_b, s.blind_nm_valid,
                           num_matches_to_plot * 10), _BLIND_NM_COLOR)

        # the mask panels (spartan_dataset_masked.py:817-835), in the
        # indices' (post-flip) frame
        matched = np.zeros(H * W, bool)
        matched[np.asarray(s.matches_a)[m_valid]] = True
        matched = matched.reshape(H, W)
        mask_a = np.asarray(pair.mask_a) != 0
        if flip_a:
            mask_a = mask_a[::-1, ::-1]
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        for ax, img, title in ((axes[0, 0], mask_a, "mask of img a object pixels"),
                               (axes[0, 1], ~mask_a, "mask of img a background"),
                               (axes[1, 0], matched, "img a pixels with a match"),
                               (axes[1, 1], matched ^ (matched | mask_a),
                                "img a object pixels with NO match")):
            ax.imshow(img)
            ax.set_title(title)
            ax.axis("off")
        path = os.path.join(output_dir, f"pair_{p:03d}_masks.png")
        fig.savefig(path)
        plt.close(fig)
        paths.append(path)

        results.append((int(pair.match_type), paths))
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch debug-vis",
                                description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("view", help="replay saved annotated pairs")
    d = sub.add_parser("debug", help="render assembler debug panels")
    for s in (v, d):
        s.add_argument("--config", required=True, help="composite dataset yaml")
        s.add_argument("--data_dir", default=os.environ.get("DC_DATA_DIR", "."))
        s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    v.add_argument("--annotations", default="new_annotated_pairs.yaml")
    v.add_argument("--out", default=None, help="write PNGs here (headless)")
    v.add_argument("--interactive", action="store_true")
    d.add_argument("--num_pairs", type=int, default=4)
    d.add_argument("--out", default="debug_panels")
    d.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    dataset = SpartanDataset(config=load_yaml(args.config), data_dir=args.data_dir,
                             config_dir=os.path.dirname(os.path.abspath(args.config)))
    if args.cmd == "view":
        paths = visualize_saved_correspondences(dataset, args.annotations, output_dir=args.out,
                                                interactive=args.interactive)
    else:
        paths = [q for _, ps in debug_batch_panels(dataset, args.num_pairs, args.out,
                                                   seed=args.seed, device=device) for q in ps]
    print(f"wrote {len(paths)} PNGs")


if __name__ == "__main__":
    main()
