"""Correspondence debug plotting.

Port of :mod:`pdc_tpu.ops.plotter` (:13-60), a rebuild of the reference's
``correspondence_tools/correspondence_plotter.py`` (matplotlib circles on
image pairs). matplotlib is imported inside the function, so nothing else
of the port needs it.
"""

from __future__ import annotations

import numpy as np


def _uv_array(uv):
    uv = np.asarray(uv)
    if uv.ndim == 2 and uv.shape[0] == 2 and uv.shape[1] != 2:
        uv = uv.T
    return uv.reshape(-1, 2)


def plot_correspondences_direct(img_a_rgb, img_a_depth, img_b_rgb, img_b_depth,
                                uv_a, uv_b, use_previous_plot=None,
                                circ_color="g", show=True, save_path=None):
    """2x2 grid (rgb_a, rgb_b, depth_a, depth_b) with one circle per
    correspondence, in the reference's layout (correspondence_plotter.py:44-61).

    :param uv_a, uv_b: [N, 2] arrays or (u_list, v_list) tuples
    :return: (fig, axes)
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    uv_a = _uv_array(uv_a)
    uv_b = _uv_array(uv_b)

    if use_previous_plot is None:
        fig, axes = plt.subplots(nrows=2, ncols=2, figsize=(12, 9))
        for ax, im in zip(axes.flat, [img_a_rgb, img_b_rgb, img_a_depth, img_b_depth]):
            ax.imshow(np.asarray(im))
            ax.axis("off")
    else:
        fig, axes = use_previous_plot

    for a, b in zip(uv_a, uv_b):
        for ax, uv in ((axes[0, 0], a), (axes[0, 1], b), (axes[1, 0], a), (axes[1, 1], b)):
            ax.add_patch(Circle((uv[0], uv[1]), radius=3, facecolor="none",
                                edgecolor=circ_color, linewidth=1.5))
    if save_path:
        fig.savefig(save_path)
    if show:  # pragma: no cover - interactive
        plt.show()
    return fig, axes
