"""Live correspondence heatmap explorer and the grasp-point stream.

Port of :mod:`pdc_tpu.apps.live_heatmap_visualization` (:30-209), a rebuild
of the reference's ``live_heatmap_visualization.py:38-371``: load one or more
trained networks, show a random image pair, and on mouse-move find the best
match of the pixel under the cursor in the other image, with a Gaussian
descriptor-distance heatmap blended over it (n = new pair, s = swap source
and target, q = quit).

The descriptor images, the norm-diff image, its argmin and the heatmap stay
on the network's device; only the ``[H, W]`` heatmap, the best pixel and its
distance reach the host per event. :class:`HeatmapEngine` and
:class:`GraspPointStream` need no display; the cv2 window loop imports cv2
in :meth:`HeatmapVisualization.run`.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from pdc_tpu_torch.apps import INT8_NOT_PORTED
from pdc_tpu_torch.ops.matching import (
    best_match_for_descriptor,
    best_matches_batch,
    gaussian_heatmap_from_norm_diffs,
)


class HeatmapEngine:
    """Headless core: descriptor images on the device, queries per pixel."""

    def __init__(self, dcns: List, variance: float = 0.03):
        self._dcns = dcns
        self._variance = variance
        self._res_a = None
        self._res_b = None

    def set_images(self, rgb_a, rgb_b):
        """Forward both images through every network; each network's
        ``[H, W, D]`` descriptor images stay on its device."""
        self._res_a = [dcn.forward_on_img(rgb_a) for dcn in self._dcns]
        self._res_b = [dcn.forward_on_img(rgb_b) for dcn in self._dcns]

    def swap(self):
        self._res_a, self._res_b = self._res_b, self._res_a

    def find_best_match(self, u: int, v: int, reverse: bool = False):
        """Best match and heatmap of the pixel (u, v) for each network: the
        norm diffs of its descriptor against the other image, their argmin,
        and ``exp(-norm_diff / variance)``.

        :return: list of (best_uv [2] np.int32, best_diff float, heatmap [H, W] np.float32)
        """
        src = self._res_b if reverse else self._res_a
        dst = self._res_a if reverse else self._res_b
        out = []
        for res_a, res_b in zip(src, dst):
            best_uv, diff, nd = best_match_for_descriptor(res_a[v, u], res_b)
            heat = gaussian_heatmap_from_norm_diffs(nd, self._variance)
            out.append((best_uv.cpu().numpy(), float(diff), heat.cpu().numpy()))
        return out


def compose_target_panel(tgt_bgr, heat, best_uv):
    """The target window of the interactive loop: a 50/50 blend of the
    target frame with the grayscale heat image and a red reticle on the best
    match (reference live_heatmap_visualization.py:254-331). With cv2 the
    blend is ``cv2.addWeighted``; without it ``floor(x + 0.5)``, which rounds
    half up as the JAX package's fallback does (not cv2's half to even).

    :param tgt_bgr: [H, W, 3] uint8 target frame (BGR)
    :param heat: [H, W] float heat in [0, 1] (:meth:`HeatmapEngine.find_best_match`)
    :return: [H, W, 3] uint8 BGR panel
    """
    from pdc_tpu_torch.utils.visualization import draw_reticle

    heat = np.asarray(heat, np.float64)
    heat_color = (np.stack([heat] * 3, -1) * 255).astype(np.uint8)
    try:
        import cv2

        blended = cv2.addWeighted(np.asarray(tgt_bgr), 0.5, heat_color, 0.5, 0)
    except ImportError:
        blended = np.floor(0.5 * np.asarray(tgt_bgr, np.float64)
                           + 0.5 * heat_color.astype(np.float64) + 0.5).astype(np.uint8)
    return draw_reticle(blended, int(best_uv[0]), int(best_uv[1]), (0, 0, 255))


class HeatmapVisualization:
    """cv2 UI wrapper (reference HeatmapVisualization)."""

    def __init__(self, dataset, model_folders: List[str], variance: float = 0.03,
                 quantize: bool = False, device="cuda"):
        from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

        if quantize:
            raise NotImplementedError("quantize_int8 is not ported to pdc_tpu_torch yet: "
                                      + INT8_NOT_PORTED["int8"])
        self._dataset = dataset
        self._dcns = [DenseCorrespondenceNetwork.from_model_folder(f, device=device)
                      for f in model_folders]
        self._engine = HeatmapEngine(self._dcns, variance)
        self._rgb_a = self._rgb_b = None

    @staticmethod
    def from_config(dataset, config, networks_root: str = "trained_models", device="cuda"):
        """Build from a heatmap_vis config (``configs/heatmap_vis.yaml``, a
        dict or its path, read with the port's reader; the reference's
        heatmap.yaml schema: a ``networks`` name list and
        ``kernel_variance``). ``quantize_int8: true`` raises until int8
        serving is ported."""
        if isinstance(config, str):
            from pdc_tpu_torch.utils.yaml_io import load_yaml

            config = load_yaml(config)
        folders = [os.path.join(networks_root, n) for n in config["networks"]]
        return HeatmapVisualization(
            dataset, folders, variance=float(config.get("kernel_variance", 0.25)),
            quantize=bool(config.get("quantize_int8", False)), device=device)

    def _get_new_images(self):
        pair = self._dataset.sample_pair()
        self._rgb_a, self._rgb_b = pair.rgb_a, pair.rgb_b
        self._engine.set_images(self._rgb_a, self._rgb_b)

    def run(self):  # pragma: no cover - interactive
        import cv2

        from pdc_tpu_torch.utils.visualization import draw_reticle

        self._get_new_images()
        cv2.namedWindow("source")
        cv2.namedWindow("target")

        def on_mouse(event, u, v, flags, param):
            results = self._engine.find_best_match(u, v)
            src = cv2.cvtColor(self._rgb_a, cv2.COLOR_RGB2BGR)
            draw_reticle(src, u, v)
            cv2.imshow("source", src)
            best_uv, _, heat = results[0]
            tgt = cv2.cvtColor(self._rgb_b, cv2.COLOR_RGB2BGR)
            cv2.imshow("target", compose_target_panel(tgt, heat, best_uv))

        cv2.setMouseCallback("source", on_mouse)
        while True:
            k = cv2.waitKey(20) & 0xFF
            if k == ord("q"):
                break
            if k == ord("n"):
                self._get_new_images()
            if k == ord("s"):
                self._engine.swap()
                self._rgb_a, self._rgb_b = self._rgb_b, self._rgb_a
        cv2.destroyAllWindows()


class GraspPointStream:
    """Batched manipulation inference: track Q stored grasp-point
    descriptors over a stream of frames (the reference's
    ``find_best_match_for_descriptor``, dense_correspondence_network.py:527-550,
    for Q descriptors at once).

    Per frame: the uint8 frame goes to the network's device and is
    normalised there (:meth:`upload`), one eval-mode forward
    (:meth:`forward`), then :func:`~pdc_tpu_torch.ops.matching.best_matches_batch`
    (:meth:`match`), one launch of the best-match kernel on a CUDA card,
    whose distance is the difference form ``sum_d (r_d - q_d)^2`` (the JAX
    package expands it and cancels near zero, ROADMAP F1).
    :meth:`process_frame` chains them and fetches the result.
    """

    def __init__(self, dcn, grasp_descriptors):
        self._dcn = dcn
        self._queries = torch.as_tensor(np.asarray(grasp_descriptors, np.float32),
                                        device=dcn.device)  # [Q, D]

    def upload(self, rgb_u8):
        """uint8 [H, W, 3] -> normalised float32 [H, W, 3] on the device."""
        return self._dcn.normalize_on_device(rgb_u8)

    def forward(self, x):
        """Normalised [H, W, 3] -> [H, W, D] descriptor image."""
        return self._dcn.forward_single_image_tensor(x)

    def match(self, res):
        """[H, W, D] -> (uv [Q, 2] int32, dist [Q] float32) on the device."""
        return best_matches_batch(self._queries, res)

    def process_frame(self, rgb_u8):
        """:return: (uv [Q, 2] np.int32, dist [Q] np.float32)"""
        uv, dist = self.match(self.forward(self.upload(rgb_u8)))
        return uv.cpu().numpy(), dist.cpu().numpy()
