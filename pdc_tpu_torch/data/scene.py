"""Path schema and metadata of a processed pdc scene log.

Port of :mod:`pdc_tpu.data.scene` (``SceneStructure`` :27-101). A processed
scene directory looks like

    <scene>/processed/
        images/%06d_rgb.png             RGB frames
        images/pose_data.yaml           camera-to-world per frame
        images/camera_info.yaml         pinhole intrinsics
        rendered_images/%06d_depth.png  uint16 depth (mm), mesh-rendered
        image_masks/%06d_mask.png       object masks
        fusion_mesh.ply                 TSDF mesh (not needed by training)
"""

from __future__ import annotations

import os

import numpy as np

from pdc_tpu_torch.geom.camera import CameraIntrinsics
from pdc_tpu_torch.geom.transforms import se3_from_dict
from pdc_tpu_torch.utils.yaml_io import load_yaml


class SceneStructure:
    def __init__(self, processed_folder: str):
        self._processed_folder = processed_folder

    @property
    def processed_folder(self):
        return self._processed_folder

    @property
    def images_dir(self):
        return os.path.join(self._processed_folder, "images")

    @property
    def rendered_images_dir(self):
        return os.path.join(self._processed_folder, "rendered_images")

    @property
    def masks_dir(self):
        return os.path.join(self._processed_folder, "image_masks")

    @property
    def fusion_mesh_filename(self):
        return os.path.join(self._processed_folder, "fusion_mesh.ply")

    @property
    def camera_info_filename(self):
        return os.path.join(self.images_dir, "camera_info.yaml")

    @property
    def pose_data_filename(self):
        return os.path.join(self.images_dir, "pose_data.yaml")

    # -- per-frame files -----------------------------------------------------

    def rgb_image_filename(self, idx: int):
        return os.path.join(self.images_dir, "%06d_rgb.png" % idx)

    def depth_image_filename(self, idx: int):
        return os.path.join(self.rendered_images_dir, "%06d_depth.png" % idx)

    def mask_image_filename(self, idx: int):
        return os.path.join(self.masks_dir, "%06d_mask.png" % idx)

    def descriptor_image_filename(self, network_name: str, idx: int):
        """A network's precomputed descriptor image of frame ``idx``."""
        return os.path.join(self._processed_folder, "descriptor_images", network_name,
                            "%06d_descriptor.npy" % idx)

    # -- metadata ------------------------------------------------------------

    def load_camera_intrinsics(self) -> CameraIntrinsics:
        return CameraIntrinsics.from_yaml_file(self.camera_info_filename)

    def load_pose_data(self):
        """``{frame index: 4x4 camera-to-world}`` (numpy float64)."""
        raw = load_yaml(self.pose_data_filename)
        return {int(idx): np.asarray(se3_from_dict(entry["camera_to_world"]))
                for idx, entry in raw.items()}

    def frame_indices(self):
        """Sorted indices of the RGB frames on disk."""
        if not os.path.isdir(self.images_dir):
            return []
        return sorted(int(f.split("_")[0]) for f in os.listdir(self.images_dir)
                      if f.endswith("_rgb.png"))
