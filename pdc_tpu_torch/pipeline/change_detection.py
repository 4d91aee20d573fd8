"""Change detection: object masks and rendered depth of a scene's frames.

Port of :mod:`pdc_tpu.pipeline.change_detection` (:32-489), the GL-free
rebuild of the reference's ``change_detection.py:75-455``: for every frame
of a scene log, the object mask comes from rendering the scene geometry with
and without the cropped foreground and comparing depths. The renders come
from :mod:`pdc_tpu_torch.pipeline.renderer` on the card (``device``,
default ``"cuda"``; the CPU only when asked for).

Mask rules (reference :274-329):
  * depth-pair strategy: foreground where the foreground render is closer
    than the background render by more than ``threshold``;
  * crop strategy: foreground wherever the cropped-geometry render returns
    any depth at all.

The PNGs go through the port's codec
(:func:`pdc_tpu_torch.data.native_loader.encode_batch`). The per-scene
program (:meth:`ChangeDetection.process_scene_start`) queues its device work
and returns without waiting for it, so the all-logs driver overlaps the next
scene's host work with this scene's render, as the JAX package leans on its
asynchronous dispatch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from pdc_tpu_torch.pipeline import renderer
from pdc_tpu_torch.utils.constants import DEPTH_IM_SCALE
from pdc_tpu_torch.utils.device import resolve_device


def compute_foreground_mask_from_depth_image_pair(depth_f, depth_b, threshold: float):
    """Foreground = pixels where the foreground render is closer by more than
    ``threshold`` metres (float math, so no uint16 wrap-around).

    :param depth_f: [H, W] foreground-scene depth (0 = no return)
    :param depth_b: [H, W] background-scene depth
    :return: [H, W] uint8 mask
    """
    depth_f = np.asarray(depth_f, np.float64)
    depth_b = np.asarray(depth_b, np.float64)
    has_f = depth_f > 0
    far_b = np.where(depth_b > 0, depth_b, np.inf)
    return (has_f & ((far_b - depth_f) > threshold)).astype(np.uint8)


def compute_foreground_mask_using_crop_strategy(depth_cropped):
    """Foreground = anything the cropped geometry renders."""
    return (np.asarray(depth_cropped) > 0).astype(np.uint8)


@dataclasses.dataclass
class CropBox:
    """Axis-aligned world-frame crop box isolating the object on the table."""

    min_pt: tuple
    max_pt: tuple

    def contains(self, points):
        p = np.asarray(points)
        return np.all((p >= np.asarray(self.min_pt)) & (p <= np.asarray(self.max_pt)), axis=1)

    def filter(self, points):
        p = np.asarray(points)
        return p[self.contains(p)]


@dataclasses.dataclass
class OrientedCropBox:
    """Posed crop box in the station-config format
    (``config/stations/*/change_detection.yaml``: a center transform, a
    quaternion and a translation, and the x/y/z extents)."""

    transform: np.ndarray  # [4, 4] box-to-world
    dimensions: tuple      # (x, y, z) full extents

    def contains(self, points):
        """Points in the box. The box frame is computed as the JAX package
        computes it: the inverse pose in float64, then the points moved in
        float32 by its (eager) ``transform_points``, whose product XLA's CPU
        code rounds term by term: ``(x0*m0 + x1*m1) + x2*m2``, then the
        offset."""
        from pdc_tpu_torch.geom.transforms import invert_se3

        T = invert_se3(np.asarray(self.transform, np.float64)).astype(np.float32)
        p = np.asarray(points, np.float32)
        local = (p[:, 0:1] * T[:3, 0] + p[:, 1:2] * T[:3, 1]) + p[:, 2:3] * T[:3, 2]
        local = local + T[:3, 3]
        half = np.asarray(self.dimensions, np.float64) / 2.0
        return np.all(np.abs(local) <= half, axis=1)

    def filter(self, points):
        p = np.asarray(points)
        return p[self.contains(points)]

    @staticmethod
    def from_station_config(config: dict) -> "OrientedCropBox":
        """The station YAML's ``crop_box`` block."""
        from pdc_tpu_torch.geom.transforms import se3_from_quat_trans

        cb = config["crop_box"]
        q = cb["transform"]["quaternion"]
        t = cb["transform"]["translation"]
        T = se3_from_quat_trans([q["w"], q["x"], q["y"], q["z"]], [t["x"], t["y"], t["z"]])
        dims = (cb["dimensions"]["x"], cb["dimensions"]["y"], cb["dimensions"]["z"])
        return OrientedCropBox(transform=np.asarray(T), dimensions=dims)

    def to_station_config(self) -> dict:
        """The station YAML's ``crop_box`` block of this box."""
        from pdc_tpu_torch.geom.transforms import quaternion_from_matrix

        w, x, y, z = np.asarray(quaternion_from_matrix(self.transform[:3, :3]), np.float64)
        tx, ty, tz = np.asarray(self.transform[:3, 3], np.float64)
        return {"crop_box": {
            "transform": {
                "quaternion": {"w": float(w), "x": float(x), "y": float(y), "z": float(z)},
                "translation": {"x": float(tx), "y": float(ty), "z": float(tz)},
            },
            "dimensions": {"x": float(self.dimensions[0]), "y": float(self.dimensions[1]),
                           "z": float(self.dimensions[2])},
        }}


def fit_crop_box(points, table_quantile: float = 0.1, above_table: float = 0.01,
                 bound_quantile: float = 0.01, margin: float = 0.05):
    """A crop box from scene geometry, the headless counterpart of the
    reference's drag-a-cube authoring (mesh_processing.py:32-108): the table
    at a low z-quantile, the points above it, their robust bounds plus a
    margin, the floor on the table.

    :param points: [N, 3] world-frame scene points (fusion-mesh vertices)
    :return: :class:`OrientedCropBox` with the identity rotation
    """
    p = np.asarray(points, np.float64)
    z_table = np.quantile(p[:, 2], table_quantile)
    obj = p[p[:, 2] > z_table + above_table]
    if obj.shape[0] < 10:
        raise ValueError("no points above the estimated table surface; pass a crop box "
                         f"explicitly (z_table={z_table:.3f})")
    lo = np.quantile(obj, bound_quantile, axis=0) - margin
    hi = np.quantile(obj, 1.0 - bound_quantile, axis=0) + margin
    lo[2] = z_table + above_table / 2.0  # the box floor sits on the table
    T = np.eye(4)
    T[:3, 3] = (lo + hi) / 2.0
    return OrientedCropBox(transform=T, dimensions=tuple(hi - lo))


class ChangeDetection:
    """Per-scene mask and depth generation (the reference's
    ``ChangeDetection``), rendering on ``device``."""

    # process_scene_start's answer when the fused render's host prep ran but
    # its fragments exceed the budget: go to process_scene_two_pass
    OVER_BUDGET = "over_budget"

    def __init__(self, points_world: np.ndarray, K: np.ndarray, image_height: int,
                 image_width: int, crop_box: Optional[CropBox] = None,
                 background_points: Optional[np.ndarray] = None,
                 depth_threshold: float = 0.01, splat_radius: int = 1,
                 faces: Optional[np.ndarray] = None,
                 background_faces: Optional[np.ndarray] = None,
                 raster_tile: Optional[int] = None, device="cuda"):
        """
        :param points_world: scene geometry as world-frame points (the fusion
            mesh's vertices)
        :param faces: optional [F, 3] triangles over ``points_world``:
            renders rasterise them (hole-free) instead of splatting points
        :param background_points: geometry of the background-only scene; if
            None, the crop strategy is used
        :param raster_tile: one tile for every triangle; None (default) bins
            the faces by projected extent (renderer.prepare_sorted_render)
        """
        self.device = resolve_device(device)
        self.points = np.asarray(points_world, np.float32)
        self.faces = None if faces is None else np.asarray(faces, np.int32)
        self.K = np.asarray(K, np.float32)
        self.H, self.W = image_height, image_width
        self.background_points = (None if background_points is None
                                  else np.asarray(background_points, np.float32))
        self.background_faces = (None if background_faces is None
                                 else np.asarray(background_faces, np.int32))
        self.depth_threshold = depth_threshold
        self.splat_radius = splat_radius
        self.raster_tile = raster_tile
        self.set_crop_box(crop_box)

    def set_crop_box(self, crop_box: Optional[CropBox]):
        """(Re)apply the foreground crop. With faces, every vertex stays (the
        face indices stay valid) and the faces with any vertex inside the
        box are the foreground: VTK's crop clips triangles at the boundary,
        so keeping the straddling ones is closer than dropping them."""
        self.crop_box = crop_box
        if crop_box is None:
            self._fg_points, self._fg_faces = self.points, self.faces
        elif self.faces is None:
            self._fg_points, self._fg_faces = crop_box.filter(self.points), None
        else:
            inside = crop_box.contains(self.points)
            self._fg_points = self.points
            self._fg_faces = self.faces[np.any(inside[self.faces], axis=1)]

    @staticmethod
    def from_data_folder(processed_folder: str, crop_box: Optional[CropBox] = None, **kwargs):
        """Geometry and intrinsics of a processed scene folder; faces in
        ``fusion_mesh.ply`` turn on triangle rasterisation.

        :return: ``(ChangeDetection, SceneStructure)``
        """
        from pdc_tpu_torch.data.scene import SceneStructure

        structure = SceneStructure(processed_folder)
        points, faces = renderer.read_ply_mesh(structure.fusion_mesh_filename)
        intr = structure.load_camera_intrinsics()
        return ChangeDetection(points, intr.K, intr.height, intr.width, crop_box=crop_box,
                               faces=faces, **kwargs), structure

    # -- per frame -----------------------------------------------------------------------

    def render_depth(self, camera_to_world, points=None, faces=None):
        """[H, W] float32 numpy depth of one pose: triangles at the tile that
        covers them (:func:`~pdc_tpu_torch.pipeline.renderer.pick_raster_tile`,
        or ``raster_tile``) when there are faces, else point splats."""
        pts = self.points if points is None else points
        if points is None and faces is None:
            faces = self.faces
        if faces is not None:
            tile = self.raster_tile
            if tile is None:
                tile = renderer.pick_raster_tile(pts, faces, camera_to_world, self.K,
                                                 self.H, self.W)
            d = renderer.render_depth_from_mesh(pts, faces, camera_to_world, self.K, self.H,
                                                self.W, tile=tile, device=self.device)
        else:
            d = renderer.render_depth_from_points(pts, camera_to_world, self.K, self.H, self.W,
                                                  splat_radius=self.splat_radius,
                                                  device=self.device)
        return d.cpu().numpy()

    def _render_depth_many(self, poses, points, faces):
        """[P, H, W] float32 numpy depths of a stack of poses."""
        poses = np.asarray(poses, np.float32)
        if faces is None:
            d = renderer.render_depth_from_points_many(points, poses, self.K, self.H, self.W,
                                                       splat_radius=self.splat_radius,
                                                       device=self.device)
        elif self.raster_tile is None:
            d = renderer.render_depth_from_mesh_sorted_many(points, faces, poses, self.K,
                                                            self.H, self.W, device=self.device)
        else:
            d = renderer.render_depth_from_mesh_many(points, faces, poses, self.K, self.H,
                                                     self.W, tile=self.raster_tile,
                                                     device=self.device)
        return d.cpu().numpy()

    def compute_mask(self, camera_to_world):
        mask, depth_fg = self.compute_masks(np.asarray(camera_to_world, np.float32)[None])
        return mask[0], depth_fg[0]

    def compute_masks(self, poses):
        """Masks and foreground depth of a stack of poses.

        :param poses: [P, 4, 4]
        :return: (masks [P, H, W] uint8, depth_fg [P, H, W] float32)
        """
        depth_fg = self._render_depth_many(poses, self._fg_points, self._fg_faces)
        if self.background_points is None:
            return np.stack([compute_foreground_mask_using_crop_strategy(d)
                             for d in depth_fg]), depth_fg
        depth_bg = self._render_depth_many(poses, self.background_points,
                                           self.background_faces)
        masks = np.stack([compute_foreground_mask_from_depth_image_pair(f, b,
                                                                        self.depth_threshold)
                          for f, b in zip(depth_fg, depth_bg)])
        return masks, depth_fg

    # -- whole scenes ----------------------------------------------------------------------

    @staticmethod
    def _write(items, height, width):
        from pdc_tpu_torch.data.native_loader import encode_batch

        if items:
            encode_batch(items, height, width)

    def run(self, structure, pose_map=None, save: bool = True):
        """Write ``%06d_mask.png`` and ``%06d_depth_cropped.png`` for every
        frame (the reference's ``run``, :336-408); returns the frame count."""
        from pdc_tpu_torch.data.native_loader import KIND_ENC_GRAY8, KIND_ENC_GRAY16

        if pose_map is None:
            pose_map = structure.load_pose_data()
        os.makedirs(structure.masks_dir, exist_ok=True)
        os.makedirs(structure.rendered_images_dir, exist_ok=True)
        indices = sorted(pose_map.keys())
        masks, depths_fg = self.compute_masks(np.stack([pose_map[i] for i in indices]))
        writes = []
        if save:
            for idx, mask, depth_fg in zip(indices, masks, depths_fg):
                writes.append((os.path.join(structure.masks_dir, "%06d_mask.png" % idx),
                               KIND_ENC_GRAY8, (mask * 255).astype(np.uint8)))
                depth_mm = np.clip(depth_fg * DEPTH_IM_SCALE, 0, 65535).astype(np.uint16)
                writes.append((os.path.join(structure.rendered_images_dir,
                                            "%06d_depth_cropped.png" % idx),
                               KIND_ENC_GRAY16, depth_mm))
        self._write(writes, self.H, self.W)
        return len(pose_map)

    def process_scene(self, structure, pose_map=None, save: bool = True,
                      render_full_depth: bool = True):
        """Masks, cropped depth and full depth of every frame from one device
        program, the on-disk encodings applied on the device
        (:func:`~pdc_tpu_torch.pipeline.renderer.render_scene_products`);
        the same files as :meth:`run` plus :meth:`render_depth_images`, which
        it falls back to for the pair strategy, point splats, a fixed tile or
        a fragment count over budget. Returns the frame count."""
        handle = self.process_scene_start(structure, pose_map=pose_map,
                                          render_full_depth=render_full_depth)
        if handle is None or handle is self.OVER_BUDGET:
            return self.process_scene_two_pass(structure, pose_map=pose_map, save=save,
                                               render_full_depth=render_full_depth)
        return self.process_scene_finish(handle, save=save)

    def process_scene_two_pass(self, structure, pose_map=None, save: bool = True,
                               render_full_depth: bool = True):
        """The face-chunked fallback (:meth:`run`, then
        :meth:`render_depth_images`) as one call."""
        n = self.run(structure, pose_map=pose_map, save=save)
        if render_full_depth:
            self.render_depth_images(structure, pose_map=pose_map, save=save)
        return n

    def process_scene_start(self, structure, pose_map=None, render_full_depth: bool = True):
        """The asynchronous half of :meth:`process_scene`: host prep, then the
        device work queued without waiting for it. Returns a handle for
        :meth:`process_scene_finish`; None when the scene needs the two-pass
        flow (no faces, the pair strategy, a fixed tile); or
        :attr:`OVER_BUDGET` when the fused render's fragments exceed the
        budget (then :meth:`process_scene_two_pass`, not :meth:`process_scene`,
        which would repeat the host prep)."""
        if (self.faces is None or self.background_points is not None
                or self.raster_tile is not None):
            return None
        if pose_map is None:
            pose_map = structure.load_pose_data()
        indices = sorted(pose_map.keys())
        poses = np.stack([pose_map[i] for i in indices])
        # without the full render, the foreground render stands in for it
        full_faces = self.faces if render_full_depth else self._fg_faces
        out = renderer.render_scene_products_start(
            self.points, self._fg_faces, full_faces, poses, self.K, self.H, self.W,
            DEPTH_IM_SCALE, device=self.device)
        if out is None:
            return self.OVER_BUDGET
        return {"out": out, "indices": indices, "structure": structure,
                "render_full_depth": render_full_depth}

    def process_scene_finish(self, handle, save: bool = True):
        """The blocking half: fetch the packed buffer, unpack it, write the
        PNGs. Returns the frame count."""
        from pdc_tpu_torch.data.native_loader import KIND_ENC_GRAY8, KIND_ENC_GRAY16

        structure, indices = handle["structure"], handle["indices"]
        os.makedirs(structure.masks_dir, exist_ok=True)
        os.makedirs(structure.rendered_images_dir, exist_ok=True)
        masks, depth_crop_mm, depth_full_mm = renderer.unpack_scene_products(
            handle["out"], self.H, self.W)
        writes = []
        if save:
            for k, idx in enumerate(indices):
                writes.append((os.path.join(structure.masks_dir, "%06d_mask.png" % idx),
                               KIND_ENC_GRAY8, (masks[k] * 255).astype(np.uint8)))
                writes.append((os.path.join(structure.rendered_images_dir,
                                            "%06d_depth_cropped.png" % idx),
                               KIND_ENC_GRAY16, depth_crop_mm[k]))
                if handle["render_full_depth"]:
                    writes.append((os.path.join(structure.rendered_images_dir,
                                                "%06d_depth.png" % idx),
                                   KIND_ENC_GRAY16, depth_full_mm[k]))
        self._write(writes, self.H, self.W)
        return len(indices)

    def render_depth_images(self, structure, pose_map=None, save: bool = True):
        """Full-scene depth re-rendering (the reference's
        ``render_depth_images``, :410-454) into ``%06d_depth.png``."""
        from pdc_tpu_torch.data.native_loader import KIND_ENC_GRAY16

        if pose_map is None:
            pose_map = structure.load_pose_data()
        os.makedirs(structure.rendered_images_dir, exist_ok=True)
        indices = sorted(pose_map.keys())
        depths = self._render_depth_many(np.stack([pose_map[i] for i in indices]),
                                         self.points, self.faces)
        writes = []
        if save:
            for idx, depth in zip(indices, depths):
                depth_mm = np.clip(depth * DEPTH_IM_SCALE, 0, 65535).astype(np.uint16)
                writes.append((os.path.join(structure.rendered_images_dir,
                                            "%06d_depth.png" % idx), KIND_ENC_GRAY16, depth_mm))
        self._write(writes, self.H, self.W)
        return len(pose_map)
