"""Cross-instance keypoint evaluation: the class-consistency benchmark.

Port of :mod:`pdc_tpu.evaluation.keypoints`. Human-labelled keypoints on
images of different object instances are matched through descriptor space,
and per-keypoint pixel, 3D and descriptor errors are aggregated. All
keypoints of an image pair, in both orderings, go through
:func:`~pdc_tpu_torch.evaluation.evaluate._match_statistics` (each side
unprojected with its own scene's intrinsics); descriptor images are
computed once per (scene, image) in batched forwards. As in the JAX
package, ``uv_1`` of the reverse ordering uses image 1's own u and v (the
reference mixes the two images' coordinates there).

Label format: a list of entries ``{scene_name, object_id, image_idx,
keypoints: {name: {u, v}}}``, or the path of a YAML file holding it.
Tables are :class:`~pdc_tpu_torch.evaluation.table.Table`s.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Optional

import numpy as np

from pdc_tpu_torch.evaluation.evaluate import (
    EVAL_COLUMNS,
    DenseCorrespondenceEvaluation,
    _match_statistics,
    _rows,
    _to_numpy,
)
from pdc_tpu_torch.evaluation.plotting import cdf_at_threshold, empirical_cdf
from pdc_tpu_torch.evaluation.table import Table
from pdc_tpu_torch.utils.yaml_io import load_yaml, save_yaml

logger = logging.getLogger(__name__)

KEYPOINT_STAT_COLUMNS = [
    "keypoint_name", "num_pairs", "pixel_match_error_l2_mean",
    "pixel_match_error_l2_median", "norm_diff_descriptor_mean",
    "norm_diff_pred_3d_mean", "norm_diff_pred_3d_median",
    "fraction_pixels_closer_than_ground_truth_mean",
]


def single_image_pair_cross_scene_keypoints_quantitative_analysis(
        dcn, dataset, keypoint_data_a: dict, keypoint_data_b: dict, res_a=None, res_b=None):
    """Per-keypoint match statistics of one cross-instance image pair, both
    orderings (a -> b, then b -> a). Returns a list of row dicts in the
    23-column schema."""
    scene_a, scene_b = keypoint_data_a["scene_name"], keypoint_data_b["scene_name"]
    idx_a, idx_b = int(keypoint_data_a["image_idx"]), int(keypoint_data_b["image_idx"])
    rgb_a, depth_a, mask_a, pose_a = dataset.get_rgbd_mask_pose(scene_a, idx_a)
    rgb_b, depth_b, mask_b, pose_b = dataset.get_rgbd_mask_pose(scene_b, idx_b)
    if res_a is None:
        res_a = dcn.forward_on_img(rgb_a)
    if res_b is None:
        res_b = dcn.forward_on_img(rgb_b)
    K_a, K_b = dataset.get_scene(scene_a).K, dataset.get_scene(scene_b).K
    kps_a, kps_b = keypoint_data_a["keypoints"], keypoint_data_b["keypoints"]
    kp_names = sorted(kps_a.keys())
    for name in kp_names:
        if name not in kps_b:
            raise ValueError(
                f"keypoint {name} appears in one list of annotated data but not the other")

    def clip_uv(kp):
        return dcn.clip_pixel_to_image_size_and_round((kp["u"], kp["v"]))

    uv_a = np.asarray([clip_uv(kps_a[n]) for n in kp_names], np.int64)
    uv_b = np.asarray([clip_uv(kps_b[n]) for n in kp_names], np.int64)
    orderings = [
        (depth_a, depth_b, mask_b, pose_a, pose_b, res_a, res_b, uv_a, uv_b, K_a, K_b,
         scene_a, scene_b, idx_a, idx_b, keypoint_data_a.get("object_id"),
         keypoint_data_b.get("object_id")),
        (depth_b, depth_a, mask_a, pose_b, pose_a, res_b, res_a, uv_b, uv_a, K_b, K_a,
         scene_b, scene_a, idx_b, idx_a, keypoint_data_b.get("object_id"),
         keypoint_data_a.get("object_id")),
    ]
    rows = []
    for d1, d2, m2, p1, p2, r1, r2, uv1, uv2, K1, K2, sn1, sn2, i1, i2, o1, o2 in orderings:
        stats = _to_numpy(_match_statistics(d1, d2, m2, uv1, uv2, p1, p2, r1, r2, K1, K2))
        for row, name in zip(_rows(stats, range(len(kp_names)), scene_name_a=sn1,
                                   scene_name_b=sn2, img_a_idx=i1, img_b_idx=i2,
                                   object_id_a=o1, object_id_b=o2), kp_names):
            row["keypoint_name"] = name
            rows.append(row)
    return rows


def evaluate_network_cross_scene_keypoints(dcn, dataset, keypoint_labels):
    """Keypoint statistics of every pair of labelled images, both
    orderings: a table in the 23-column schema."""
    if isinstance(keypoint_labels, str):
        keypoint_labels = load_yaml(keypoint_labels)
    logger.info("num cross instance labels: %d", len(keypoint_labels))
    images = DenseCorrespondenceEvaluation.compute_descriptor_images_batched(
        dcn, dataset, [(e["scene_name"], int(e["image_idx"])) for e in keypoint_labels])
    rows = []
    num_pairs = 0
    for a, b in itertools.combinations(keypoint_labels, 2):
        num_pairs += 1
        rows.extend(single_image_pair_cross_scene_keypoints_quantitative_analysis(
            dcn, dataset, a, b, res_a=images[(a["scene_name"], int(a["image_idx"]))],
            res_b=images[(b["scene_name"], int(b["image_idx"]))]))
    logger.info("num_pairs considered: %d", num_pairs)
    return Table.from_rows(rows, EVAL_COLUMNS)


def _groups(table):
    """(keypoint name, row mask) for each named keypoint, names sorted."""
    names = table["keypoint_name"]
    for name in sorted({n for n in names if n is not None}):
        yield name, np.array([n == name for n in names])


def _finite(x):
    x = np.asarray(x, np.float64)
    return x[~np.isnan(x)]


def keypoint_statistics(table) -> Table:
    """Per-keypoint aggregates of a keypoint table."""
    rows = []
    for name, sel in _groups(table):
        px = _finite(table["pixel_match_error_l2"][sel])
        d3 = _finite(table["norm_diff_pred_3d"][sel])
        rows.append({
            "keypoint_name": name,
            "num_pairs": int(sel.sum()),
            "pixel_match_error_l2_mean": float(px.mean()) if px.size else np.nan,
            "pixel_match_error_l2_median": float(np.median(px)) if px.size else np.nan,
            "norm_diff_descriptor_mean": float(_finite(table["norm_diff_descriptor"][sel]).mean()),
            "norm_diff_pred_3d_mean": float(d3.mean()) if d3.size else np.nan,
            "norm_diff_pred_3d_median": float(np.median(d3)) if d3.size else np.nan,
            "fraction_pixels_closer_than_ground_truth_mean": float(_finite(
                table["fraction_pixels_closer_than_ground_truth"][sel]).mean()),
        })
    return Table.from_rows(rows, KEYPOINT_STAT_COLUMNS)


def plot_keypoint_cdfs(table, output_path: Optional[str] = None):
    """PCK at 5, 10 and 25 px per keypoint and overall; with matplotlib, the
    pixel-error CDF of each keypoint and the overall one, written to
    ``output_path``. Returns the stats dict."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 6))
    except ImportError:
        plt = fig = ax = None

    def pck(px):
        return {f"pck_at_{k}px": cdf_at_threshold(px, k) for k in (5, 10, 25)}

    stats = {}
    for name, sel in _groups(table):
        px = _finite(table["pixel_match_error_l2"][sel])
        stats[str(name)] = pck(px)
        if ax is not None and px.size:
            ax.plot(*empirical_cdf(px), label=str(name))
    overall = _finite(table["pixel_match_error_l2"])
    stats["overall"] = pck(overall)
    if ax is not None:
        if overall.size:
            ax.plot(*empirical_cdf(overall), "k--", label="overall", linewidth=2)
        ax.set_xlabel("keypoint pixel match error (L2)")
        ax.set_ylabel("fraction of pairs")
        ax.legend()
        if output_path is not None:
            fig.savefig(output_path, bbox_inches="tight")
        plt.close(fig)
    return stats


def run_cross_instance_keypoint_evaluation_on_network(
        model_folder: str, path_to_cross_instance_labels,
        save_folder_name: str = "analysis/cross_scene_keypoints",
        dataset=None, save: bool = True, num_qualitative_pairs: int = 0, device="cuda"):
    """The keypoint analysis of a model folder: ``data.csv``,
    ``keypoint_statistics.csv``, ``keypoint_stats.yaml`` and, with
    matplotlib, ``keypoint_cdf.png`` (and keypoint heatmap panels of the
    first ``num_qualitative_pairs`` label pairs) under
    ``<model_folder>/<save_folder_name>``. ``dataset`` defaults to the one
    the folder's ``dataset.yaml`` records. Returns the per-match table."""
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    dcn = DenseCorrespondenceNetwork.from_model_folder(model_folder, device=device)
    if dataset is None:
        dataset = DenseCorrespondenceEvaluation.load_dataset_from_model_folder(model_folder)
    labels = path_to_cross_instance_labels
    if isinstance(labels, str):
        labels = load_yaml(labels)
    table = evaluate_network_cross_scene_keypoints(dcn, dataset, labels)
    if save:
        output_dir = os.path.join(model_folder, save_folder_name)
        os.makedirs(output_dir, exist_ok=True)
        table.to_csv(os.path.join(output_dir, "data.csv"))
        keypoint_statistics(table).to_csv(os.path.join(output_dir, "keypoint_statistics.csv"))
        stats = plot_keypoint_cdfs(table, output_path=os.path.join(output_dir,
                                                                   "keypoint_cdf.png"))
        save_yaml(stats, os.path.join(output_dir, "keypoint_stats.yaml"))
        if num_qualitative_pairs > 0:
            _write_keypoint_qualitative(dcn, dataset, labels, output_dir, num_qualitative_pairs)
    logger.info("finished cross-scene keypoint evaluation")
    return table


def _write_keypoint_qualitative(dcn, dataset, labels, output_dir: str, num_pairs: int):
    """Keypoint heatmap panels of the first ``num_pairs`` label pairs, one
    per shared keypoint (needs matplotlib)."""
    import matplotlib.pyplot as plt

    from pdc_tpu_torch.evaluation.qualitative import (
        single_image_pair_keypoint_qualitative_analysis,
    )

    for written, (a, b) in enumerate(itertools.combinations(labels, 2)):
        if written >= num_pairs:
            break
        for name in sorted(a["keypoints"]):
            if name not in b["keypoints"]:
                continue
            kd_a = dict(scene_name=a["scene_name"], image_idx=a["image_idx"],
                        **a["keypoints"][name])
            kd_b = dict(scene_name=b["scene_name"], image_idx=b["image_idx"],
                        **b["keypoints"][name])
            fig = single_image_pair_keypoint_qualitative_analysis(
                dcn, dataset, kd_a, kd_b, plot_title=f"keypoint {name}")
            fig.savefig(os.path.join(output_dir, f"keypoint_qual_{written:02d}_{name}.png"),
                        bbox_inches="tight")
            plt.close(fig)
