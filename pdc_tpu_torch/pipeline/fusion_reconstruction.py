"""Fused-scene reconstruction access.

Port of :mod:`pdc_tpu.pipeline.fusion_reconstruction`, the rebuild of the
reference's ``fusion_reconstruction.py:81-398`` (``CameraPoses``,
``TSDFReconstruction``): a processed scene's TSDF fusion mesh and camera
poses, ``get_camera_to_world(idx)`` lookups and crop-box-filtered geometry,
the inputs of change detection. Renders go through
:mod:`pdc_tpu_torch.pipeline.renderer` on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pdc_tpu_torch.data.scene import SceneStructure
from pdc_tpu_torch.pipeline import renderer
from pdc_tpu_torch.pipeline.change_detection import CropBox
from pdc_tpu_torch.utils.device import resolve_device


class CameraPoses:
    """Pose lookup by frame index (the reference's ``CameraPoses``)."""

    def __init__(self, pose_map: dict):
        self._pose_map = dict(pose_map)

    @staticmethod
    def from_scene(structure: SceneStructure) -> "CameraPoses":
        return CameraPoses(structure.load_pose_data())

    def get_camera_to_world(self, idx: int) -> np.ndarray:
        return self._pose_map[idx]

    @property
    def indices(self):
        return sorted(self._pose_map.keys())

    def __len__(self):
        return len(self._pose_map)


class TSDFReconstruction:
    """A fused scene: mesh vertices (and faces), camera poses, intrinsics
    (the reference's ``TSDFReconstruction``)."""

    def __init__(self, points: np.ndarray, poses: CameraPoses, intrinsics,
                 crop_box: Optional[CropBox] = None, faces: Optional[np.ndarray] = None,
                 device="cuda"):
        self._all_points = np.asarray(points, np.float32)
        self.faces = None if faces is None else np.asarray(faces, np.int32)
        self.poses = poses
        self.intrinsics = intrinsics
        self.crop_box = crop_box
        self.device = resolve_device(device)

    @staticmethod
    def from_data_folder(processed_folder: str, crop_box: Optional[CropBox] = None,
                         device="cuda") -> "TSDFReconstruction":
        structure = SceneStructure(processed_folder)
        mesh_file = structure.fusion_mesh_filename
        if not os.path.exists(mesh_file):
            raise FileNotFoundError(mesh_file)
        points, faces = renderer.read_ply_mesh(mesh_file)
        return TSDFReconstruction(points, CameraPoses.from_scene(structure),
                                  structure.load_camera_intrinsics(), crop_box=crop_box,
                                  faces=faces, device=device)

    @property
    def points(self) -> np.ndarray:
        """Crop-box-filtered geometry (the foreground object's points)."""
        if self.crop_box is None:
            return self._all_points
        return self.crop_box.filter(self._all_points)

    @property
    def all_points(self) -> np.ndarray:
        return self._all_points

    def get_camera_to_world(self, idx: int) -> np.ndarray:
        return self.poses.get_camera_to_world(idx)

    def render_depth(self, idx: int, cropped: bool = False, splat_radius: int = 1):
        """[H, W] float32 numpy depth at frame ``idx``'s pose: the triangles
        (the cropped faces when ``cropped``), at the tile that covers them,
        when the mesh has faces; point splats otherwise."""
        pose = np.asarray(self.get_camera_to_world(idx), np.float32)
        K = np.asarray(self.intrinsics.K, np.float32)
        H, W = self.intrinsics.height, self.intrinsics.width
        if self.faces is not None:
            faces = self.faces
            if cropped and self.crop_box is not None:
                inside = self.crop_box.contains(self._all_points)
                faces = faces[np.any(inside[faces], axis=1)]
            tile = renderer.pick_raster_tile(self._all_points, faces, pose, K, H, W)
            d = renderer.render_depth_from_mesh(self._all_points, faces, pose, K, H, W,
                                                tile=tile, device=self.device)
        else:
            pts = self.points if cropped else self._all_points
            d = renderer.render_depth_from_points(pts, pose, K, H, W,
                                                  splat_radius=splat_radius, device=self.device)
        return d.cpu().numpy()


# the reference's ElasticFusion-era base class reads the same data
FusionReconstruction = TSDFReconstruction
