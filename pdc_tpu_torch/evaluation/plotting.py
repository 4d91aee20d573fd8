"""Evaluation plotting: descriptor display normalization, CDFs, the area
above the curve, PCK readings, and the CDF figure with its ``stats.yaml``.

Port of :mod:`pdc_tpu.evaluation.plotting` (:21-215). The CDF is plain
numpy (equal-width bins over the data range, ``scipy.stats.cumfreq``'s
construction). The plotter reads a :class:`~pdc_tpu_torch.evaluation.table.Table`
or an evaluation CSV through :func:`~pdc_tpu_torch.evaluation.table.read_csv`,
always writes ``stats.yaml`` with the port's emitter, and draws its figures
only when matplotlib imports, as the JAX package does (without matplotlib
the figure is skipped and the stats are still written).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pdc_tpu_torch.evaluation.table import read_csv
from pdc_tpu_torch.utils.yaml_io import save_yaml


def normalize_descriptor(res, stats: Optional[dict] = None):
    """Map a [H, W, D] descriptor image to [0, 1] per channel for display.
    ``stats`` may hold {'min': [D], 'max': [D]} (e.g. the saved
    descriptor_statistics.yaml entire_image entry)."""
    res = np.asarray(res, np.float64)
    if stats is None:
        res_min = res.min(axis=(0, 1))
        res_max = res.max(axis=(0, 1))
    else:
        res_min = np.asarray(stats["min"], np.float64)
        res_max = np.asarray(stats["max"], np.float64)
    scale = np.maximum(res_max - res_min, 1e-12)
    return np.clip((res - res_min) / scale, 0.0, 1.0)


def normalize_descriptor_pair(res_a, res_b):
    """Normalize two descriptor images with their joint min/max so colors are
    comparable across the pair."""
    res_a, res_b = np.asarray(res_a, np.float64), np.asarray(res_b, np.float64)
    both = np.concatenate([res_a.reshape(-1, res_a.shape[-1]),
                           res_b.reshape(-1, res_b.shape[-1])], axis=0)
    mn, mx = both.min(axis=0), both.max(axis=0)
    scale = np.maximum(mx - mn, 1e-12)
    return (
        np.clip((res_a - mn) / scale, 0, 1),
        np.clip((res_b - mn) / scale, 0, 1),
    )


def empirical_cdf(data, num_bins: int = 100):
    """(x, F(x)) over equal-width bins of the finite values."""
    data = np.asarray(data, np.float64)
    data = data[np.isfinite(data)]
    if data.size == 0:
        return np.zeros(num_bins), np.zeros(num_bins)
    lo, hi = float(data.min()), float(data.max())
    width = (hi - lo) / num_bins if hi > lo else 1.0
    hist, _ = np.histogram(data, bins=num_bins, range=(lo, lo + width * num_bins))
    cum = np.cumsum(hist) / data.size
    x = lo + width * np.arange(num_bins)
    return x, cum


def compute_area_above_curve(data, num_bins: int = 100):
    """The area above the CDF: bin_width * sum(1 - CDF)."""
    data = np.asarray(data, np.float64)
    data = data[np.isfinite(data)]
    if data.size == 0:
        return float("nan")
    lo, hi = float(data.min()), float(data.max())
    width = (hi - lo) / num_bins if hi > lo else 1.0
    _, cum = empirical_cdf(data, num_bins)
    return float(width * np.sum(1.0 - cum))


def cdf_at_threshold(data, threshold: float):
    """P(error <= threshold) over the finite values: the PCK@k reading of
    the pixel-match-error CDF."""
    data = np.asarray(data, np.float64)
    data = data[np.isfinite(data)]
    if data.size == 0:
        return float("nan")
    return float(np.mean(data <= threshold))


def _values(table, column) -> np.ndarray:
    """A numeric column without its empty cells (pandas' ``dropna``)."""
    col = np.asarray(table[column])
    if col.dtype == object:
        col = np.array([np.nan if v is None else v for v in col], np.float64)
    col = col.astype(np.float64)
    return col[~np.isnan(col)]


def _load(path_to_df_csv, dataframe, output_dir):
    if dataframe is not None:
        return dataframe, output_dir
    return read_csv(path_to_df_csv, index_col=0), (
        output_dir if output_dir is not None else os.path.dirname(path_to_df_csv))


class DenseCorrespondenceEvaluationPlotter:
    """The CDF figure and its summary stats."""

    # (column, masked column, xlabel, x scale factor)
    PLOTS = [
        ("pixel_match_error_l2", "pixel_match_error_l2_masked",
         "Pixel match error (fraction of image diagonal 800)", 800.0),
        ("norm_diff_pred_3d", "norm_diff_pred_3d_masked",
         "3D match error (m)", 1.0),
        ("norm_diff_descriptor_ground_truth", None,
         "Descriptor distance of ground-truth match", 1.0),
        ("fraction_pixels_closer_than_ground_truth",
         "fraction_pixels_closer_than_ground_truth_masked",
         "Fraction of pixels closer than ground truth", 1.0),
        ("average_l2_distance_for_false_positives",
         "average_l2_distance_for_false_positives_masked",
         "Average pixel distance of false positives", 1.0),
    ]

    @staticmethod
    def run_on_single_dataframe(path_to_df_csv, label=None, output_dir=None,
                                save: bool = True, dataframe=None,
                                previous_fig_axes=None,
                                return_fig_axes: bool = False):
        """The 5-CDF figure and ``stats.yaml`` of one evaluation table (or
        CSV). Returns the summary stats dict, writing ``quant_plots.png``
        (with matplotlib) and ``stats.yaml`` when ``save``. With
        ``return_fig_axes`` returns ``(stats, (fig, axes))`` so that callers
        overlay further curves through ``previous_fig_axes``; without
        matplotlib, ``(fig, axes)`` is ``(None, None)``."""
        DCEP = DenseCorrespondenceEvaluationPlotter
        df, output_dir = _load(path_to_df_csv, dataframe, output_dir)

        stats = {
            "norm_diff_3d_area_above_curve": compute_area_above_curve(
                _values(df, "norm_diff_pred_3d"))
        }
        px = _values(df, "pixel_match_error_l2")
        for k in (5, 10, 25, 50, 100):
            stats[f"pck_at_{k}px"] = cdf_at_threshold(px, k)

        fig = axes = None
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            use_masked = "is_valid_masked" in df and _values(df, "is_valid_masked").size > 0
            n = len(DCEP.PLOTS)
            if previous_fig_axes is None:
                fig, axes = plt.subplots(
                    nrows=n, ncols=2 if use_masked else 1, figsize=(15, n * 5),
                    squeeze=False,
                )
            else:
                fig, axes = previous_fig_axes
            for i, (col, col_masked, xlabel, scale) in enumerate(DCEP.PLOTS):
                specs = [(col, axes[i][0])]
                if (col_masked is not None and col_masked in df
                        and axes.shape[1] > 1):
                    specs.append((col_masked, axes[i][1]))
                for c, ax in specs:
                    x, cum = empirical_cdf(_values(df, c))
                    ax.plot(x / scale, cum, label=label)
                    ax.set_xlabel(xlabel + (" (masked)" if c.endswith("_masked") else ""))
                    ax.set_ylabel("Fraction of matches")
                    if label:
                        ax.legend()
            if save and output_dir is not None:
                fig.savefig(os.path.join(output_dir, "quant_plots.png"))
            if not return_fig_axes:
                plt.close(fig)
        except ImportError:
            pass

        if save and output_dir is not None:
            save_yaml(stats, os.path.join(output_dir, "stats.yaml"))
        if return_fig_axes:
            return stats, (fig, axes)
        return stats

    @staticmethod
    def run_on_single_dataframe_across_objects(path_to_df_csv, output_dir=None,
                                               save: bool = True, dataframe=None):
        """Stats of the across-object best-match distances (higher is better:
        different objects should be far apart); writes
        ``across_object_stats.yaml`` when ``save``."""
        df, output_dir = _load(path_to_df_csv, dataframe, output_dir)
        data = _values(df, "norm_diff_descriptor_best_match")
        stats = {
            "across_object_mean_best_match_distance":
                float(np.mean(data)) if data.size else float("nan"),
            "across_object_area_above_curve": compute_area_above_curve(data),
        }
        if save and output_dir is not None:
            save_yaml(stats, os.path.join(output_dir, "across_object_stats.yaml"))
        return stats


def draw_reticle(img, u, v, color=(0, 255, 0)):
    """Reticle marker, pure numpy so it works without cv2."""
    img = np.asarray(img).copy()
    H, W = img.shape[:2]
    u, v = int(round(u)), int(round(v))
    for r in range(-10, 11):
        if 0 <= v + r < H and 0 <= u < W:
            img[v + r, u] = color
        if 0 <= v < H and 0 <= u + r < W:
            img[v, u + r] = color
    return img
