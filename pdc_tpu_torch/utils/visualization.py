"""Heatmaps of descriptor distances, for display.

Port of :mod:`pdc_tpu.utils.visualization`: Gaussian-kernel heatmaps from
descriptor norm-diff images, JET-colormapped on the host with cv2 where it
imports and with a numpy approximation elsewhere (the JAX package's two
paths, kept as they are).
"""

from __future__ import annotations

import numpy as np

from pdc_tpu_torch.ops.matching import gaussian_heatmap_from_norm_diffs


def compute_gaussian_kernel_heatmap_from_norm_diffs(norm_diffs, variance: float = 0.03):
    """``exp(-d / variance)`` scaled to uint8 (truncating) and
    JET-colormapped.

    :param norm_diffs: [H, W] numpy array or tensor
    :return: [H, W, 3] uint8 BGR heatmap
    """
    heatmap = gaussian_heatmap_from_norm_diffs(norm_diffs, variance).cpu().numpy()
    heatmap_u8 = (heatmap * 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        return _jet_colormap(heatmap)
    return cv2.applyColorMap(heatmap_u8, cv2.COLORMAP_JET)


def _jet_colormap(x):
    """Numpy JET approximation: x in [0, 1] -> BGR uint8."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def draw_reticle(img, u, v, label_color=(0, 255, 0)):
    """Crosshair and circles with cv2; a plain cross without it."""
    try:
        import cv2
    except ImportError:
        from pdc_tpu_torch.evaluation.plotting import draw_reticle as dr

        return dr(img, u, v, label_color)
    img = np.ascontiguousarray(img)
    white = (255, 255, 255)
    cv2.circle(img, (u, v), 10, label_color, 1)
    cv2.circle(img, (u, v), 11, white, 1)
    cv2.circle(img, (u, v), 12, label_color, 1)
    cv2.line(img, (u, v + 1), (u, v + 3), white, 1)
    cv2.line(img, (u + 1, v), (u + 3, v), white, 1)
    cv2.line(img, (u, v - 1), (u, v - 3), white, 1)
    cv2.line(img, (u - 1, v), (u - 3, v), white, 1)
    return img
