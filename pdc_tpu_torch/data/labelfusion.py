"""LabelFusion logs: ElasticFusion poses and utime-keyed frames.

Port of :mod:`pdc_tpu.data.labelfusion` (``load_posegraph``,
``LabelFusionScene``, :19-93). Poses come from ``posegraph.posegraph`` (one
line per frame: ``utime x y z qx qy qz qw``), frames from
``images/%010d_{rgb,depth,labels}.png`` keyed by utime, decoded by
:mod:`pdc_tpu_torch.data.native_loader` (``decoder="auto"``).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from pdc_tpu_torch.geom.transforms import se3_from_quat_trans


def load_posegraph(posegraph_file: str) -> List[dict]:
    """``[{"utime", "camera_to_world"}]`` of an ElasticFusion posegraph; the
    file's xyzw quaternion becomes the port's wxyz. Lines of fewer than 8
    fields are skipped."""
    entries = []
    with open(posegraph_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8:
                continue
            x, y, z = map(float, parts[1:4])
            qx, qy, qz, qw = map(float, parts[4:8])
            entries.append({"utime": int(float(parts[0])),
                            "camera_to_world": se3_from_quat_trans([qw, qx, qy, qz], [x, y, z])})
    return entries


class LabelFusionScene:
    """One LabelFusion log directory: ``images/`` and ``posegraph.posegraph``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.posegraph = load_posegraph(os.path.join(log_dir, "posegraph.posegraph"))

    @property
    def num_frames(self):
        return len(self.posegraph)

    def pose(self, idx: int) -> np.ndarray:
        return self.posegraph[idx]["camera_to_world"]

    def _image_path(self, idx: int, suffix: str):
        utime = self.posegraph[idx]["utime"]
        return os.path.join(self.log_dir, "images", "%010d_%s" % (utime, suffix))

    def rgb_path(self, idx: int):
        return self._image_path(idx, "rgb.png")

    def depth_path(self, idx: int):
        return self._image_path(idx, "depth.png")

    def mask_path(self, idx: int):
        return self._image_path(idx, "labels.png")

    def load_frame(self, idx: int):
        """(rgb [H,W,3] u8, depth [H,W] u16, mask [H,W] u8 of 0/1, pose);
        the mask is all ones where the log has no labels image."""
        from pdc_tpu_torch.data.native_loader import (
            KIND_GRAY16,
            KIND_MASK8,
            KIND_RGB8,
            decode_batch,
            image_size,
        )

        h, w = image_size(self.rgb_path(idx))
        rgb = np.zeros((h, w, 3), np.uint8)
        depth = np.zeros((h, w), np.uint16)
        mask = np.zeros((h, w), np.uint8)
        items = [(self.rgb_path(idx), KIND_RGB8, rgb), (self.depth_path(idx), KIND_GRAY16, depth)]
        if os.path.exists(self.mask_path(idx)):
            items.append((self.mask_path(idx), KIND_MASK8, mask))
        else:
            mask[...] = 1
        decode_batch(items, h, w)
        return rgb, depth, mask, self.pose(idx)

    def to_scene_data(self, name: str, K: np.ndarray, object_id=None):
        """The log as an in-memory :class:`~pdc_tpu_torch.data.dataset.SceneData`."""
        from pdc_tpu_torch.data.dataset import SceneData

        frames = [self.load_frame(i) for i in range(self.num_frames)]
        return SceneData(name=name, rgb=np.stack([f[0] for f in frames]),
                         depth=np.stack([f[1] for f in frames]),
                         mask=np.stack([f[2] for f in frames]),
                         poses=np.stack([f[3] for f in frames]), K=np.asarray(K),
                         object_id=object_id)
