"""Analytic synthetic RGBD scene generator (numpy).

Port of :mod:`pdc_tpu.data.synthetic` (``make_orbit_pose`` :27-50,
``SyntheticScene`` :53-315): a textured ground plane carrying a disc-shaped
object, plus an optional elevated occluder, seen by a ring of cameras. Every
depth value satisfies the pinhole model exactly. The code is numpy, as the
original; it differs only in importing the port's own geometry, so the same
arguments render the same frames bit for bit. :meth:`SyntheticScene.write_scene`
writes a scene in the pdc processed-log layout through the port's PNG
encoder (:mod:`pdc_tpu_torch.data.native_loader`) and YAML emitter, with the
fusion geometry as ``fusion_mesh.ply``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pdc_tpu_torch.geom.camera import CameraIntrinsics
from pdc_tpu_torch.geom.transforms import dict_from_se3
from pdc_tpu_torch.utils.constants import DEPTH_IM_SCALE


def make_orbit_pose(angle, radius=0.8, height=0.6, target=(0.0, 0.0, 0.0)):
    """Camera-to-world SE(3) for a camera on a ring looking at ``target``.

    Camera frame is RDF (x right, y down, z forward).
    """
    target = np.asarray(target, dtype=np.float64)
    c = np.array([radius * np.cos(angle), radius * np.sin(angle), height])
    forward = target - c
    forward = forward / np.linalg.norm(forward)
    world_down = np.array([0.0, 0.0, -1.0])
    right = np.cross(world_down, forward)
    nr = np.linalg.norm(right)
    if nr < 1e-8:  # looking straight down
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    down = np.cross(forward, right)
    T = np.eye(4)
    T[:3, 0] = right
    T[:3, 1] = down
    T[:3, 2] = forward
    T[:3, 3] = c
    return T


@dataclasses.dataclass
class SyntheticScene:
    """A ring of cameras around a textured plane with a disc object."""

    width: int = 64
    height: int = 48
    num_frames: int = 8
    radius: float = 0.8
    cam_height: float = 0.6
    object_radius: float = 0.25
    # Optional occluder: elevated rectangle [x0, x1] x [y0, y1] at height z
    occluder: tuple | None = None  # e.g. (0.05, 0.25, -0.1, 0.1, 0.15)
    seed: int = 0
    # texture identity: scenes of the same physical object must share it
    # (across-scene attraction assumes the object looks the same); different
    # objects should differ so different-object repulsion is learnable
    texture_seed: int = 0

    def __post_init__(self):
        f = 0.9 * self.width  # focal
        self.intrinsics = CameraIntrinsics(
            cx=self.width / 2.0 - 0.5,
            cy=self.height / 2.0 - 0.5,
            fx=f,
            fy=f,
            width=self.width,
            height=self.height,
        )
        self.K = self.intrinsics.K
        # ``seed`` varies the camera TRAJECTORY (orbit phase, radius, and
        # height), not the world: two scenes with different seeds are two
        # capture logs of the same physical object — so train/test splits
        # and across-scene evaluation see genuinely held-out viewpoints.
        # seed=0 keeps the historical canonical orbit exactly.
        if self.seed:
            rng = np.random.RandomState(self.seed)
            phase = rng.uniform(0.0, 2.0 * np.pi)
            radius = self.radius * rng.uniform(0.85, 1.15)
            cam_height = self.cam_height * rng.uniform(0.85, 1.15)
        else:
            phase, radius, cam_height = 0.0, self.radius, self.cam_height
        self.poses = [
            make_orbit_pose(
                phase + 2.0 * np.pi * i / self.num_frames, radius, cam_height
            )
            for i in range(self.num_frames)
        ]

    # -- rendering ---------------------------------------------------------

    def _rays_world(self, pose):
        """Per-pixel unit-z camera rays expressed in the world frame."""
        H, W = self.height, self.width
        u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
        K_inv = np.linalg.inv(self.K)
        d_cam = np.stack([u, v, np.ones_like(u)], axis=-1) @ K_inv.T  # [H,W,3], z=1
        d_world = d_cam @ pose[:3, :3].T
        return d_world, pose[:3, 3]

    def render(self, frame_idx):
        """Render one frame analytically.

        :return: (rgb [H,W,3] uint8, depth [H,W] uint16 millimetres,
                  mask [H,W] uint8, pose [4,4])
        """
        pose = self.poses[frame_idx]
        d_world, c = self._rays_world(pose)
        dz = d_world[..., 2]

        # Ground plane z=0: camera-frame depth t solves c_z + t*dz = 0.
        # (t is the camera-frame z because the camera ray has unit z.)
        with np.errstate(divide="ignore", invalid="ignore"):
            t_plane = np.where(dz < -1e-9, -c[2] / dz, np.inf)

        hits = [("plane", t_plane)]
        if self.occluder is not None:
            x0, x1, y0, y1, zo = self.occluder
            with np.errstate(divide="ignore", invalid="ignore"):
                t_occ = np.where(np.abs(dz) > 1e-9, (zo - c[2]) / dz, np.inf)
            p_occ = c[None, None, :] + t_occ[..., None] * d_world
            inside = (
                (t_occ > 1e-6)
                & (p_occ[..., 0] >= x0)
                & (p_occ[..., 0] <= x1)
                & (p_occ[..., 1] >= y0)
                & (p_occ[..., 1] <= y1)
            )
            t_occ = np.where(inside, t_occ, np.inf)
            hits.append(("occluder", t_occ))

        t_all = np.stack([t for _, t in hits], axis=0)
        nearest = np.argmin(t_all, axis=0)
        t = np.min(t_all, axis=0)
        visible = np.isfinite(t) & (t > 1e-6)
        t = np.where(visible, t, 0.0)

        p_world = c[None, None, :] + t[..., None] * d_world

        # Object mask: disc on the ground plane (only where the plane is the
        # nearest hit).
        r2 = p_world[..., 0] ** 2 + p_world[..., 1] ** 2
        mask = (visible & (nearest == 0) & (r2 <= self.object_radius**2)).astype(np.uint8)

        # Procedural texture from world coordinates -> view-consistent RGB.
        # One linear channel plus two with nonlinear (xy, quadratic) phases:
        # the nonlinear terms break translation invariance, so no global
        # lattice of aliased colors exists and best-match ground truth is
        # unambiguous over the working area.
        x, y = p_world[..., 0], p_world[..., 1]
        ts = float(self.texture_seed)
        rgb = np.stack(
            [
                0.5 + 0.5 * np.sin(21.0 * x + 9.0 * y + 2.4 * ts),
                0.5 + 0.5 * np.sin(-7.0 * x + 25.0 * y + 30.0 * x * y + 1.0 + 4.9 * ts),
                0.5 + 0.5 * np.sin(40.0 * (x * x - y * y) + 13.0 * x - 11.0 * y
                                   + 2.0 + 7.6 * ts + 8.0 * ts * x),
            ],
            axis=-1,
        )
        rgb = np.where(visible[..., None], rgb, 0.0)
        rgb = np.where(mask[..., None] > 0, rgb, rgb * 0.6 + 0.2)
        rgb_u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

        depth_mm = np.clip(t * DEPTH_IM_SCALE, 0, 65535).astype(np.uint16)
        return rgb_u8, depth_mm, mask, pose

    def render_all(self):
        frames = [self.render(i) for i in range(self.num_frames)]
        rgb = np.stack([f[0] for f in frames])
        depth = np.stack([f[1] for f in frames])
        mask = np.stack([f[2] for f in frames])
        poses = np.stack([f[3] for f in frames])
        return rgb, depth, mask, poses

    # -- the pdc on-disk layout ----------------------------------------------

    def fusion_points(self, plane_step: float = 0.02, object_step: float = 0.005,
                      plane_extent: float = 0.8, object_height: float = 0.02):
        """World-frame scene geometry as points, the stand-in for a TSDF
        fusion mesh: the ground plane at z=0 around the object, and the
        object disc as a thin puck at ``object_height``.

        :return: [N, 3] float32
        """
        xs = np.arange(-plane_extent, plane_extent, plane_step)
        gx, gy = np.meshgrid(xs, xs)
        plane = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
        plane = plane[plane[:, 0] ** 2 + plane[:, 1] ** 2 > self.object_radius**2]
        xo = np.arange(-self.object_radius, self.object_radius, object_step)
        ox, oy = np.meshgrid(xo, xo)
        disc = np.stack([ox.ravel(), oy.ravel(), np.full(ox.size, object_height)], axis=1)
        disc = disc[disc[:, 0] ** 2 + disc[:, 1] ** 2 <= self.object_radius**2]
        return np.concatenate([plane, disc]).astype(np.float32)

    def fusion_mesh(self, plane_step: float = 0.02, object_step: float = 0.005,
                    plane_extent: float = 0.8, object_height: float = 0.02):
        """Triangulated scene geometry (the plane around the object and the
        object's disc), the stand-in for a TSDF fusion mesh.

        :return: (vertices [N, 3] float32, faces [F, 3] int32)
        """

        def grid(xs, z, face_keep):
            gx, gy = np.meshgrid(xs, xs)
            verts = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], axis=1)
            w = len(xs)
            r, c = np.meshgrid(np.arange(w - 1), np.arange(w - 1), indexing="ij")
            i = (r * w + c).ravel()
            quads = np.stack([i, i + 1, i + w + 1, i + w], axis=1)
            faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=0)
            centroid = verts[faces].mean(axis=1)
            return verts, faces[face_keep(centroid)]

        r_obj2 = self.object_radius**2
        plane_v, plane_f = grid(np.arange(-plane_extent, plane_extent, plane_step), 0.0,
                                lambda c: c[:, 0] ** 2 + c[:, 1] ** 2 > r_obj2)
        disc_v, disc_f = grid(np.arange(-self.object_radius - object_step,
                                        self.object_radius + object_step, object_step),
                              object_height, lambda c: c[:, 0] ** 2 + c[:, 1] ** 2 <= r_obj2)
        verts = np.concatenate([plane_v, disc_v]).astype(np.float32)
        faces = np.concatenate([plane_f, disc_f + len(plane_v)]).astype(np.int32)
        return verts, faces

    def write_fusion_mesh(self, processed_dir, with_faces: bool = True, **mesh_kwargs):
        """Write ``fusion_mesh.ply`` (ASCII) into a processed scene folder:
        the triangulated mesh (``mesh_kwargs`` go to :meth:`fusion_mesh`:
        ``plane_step=0.004, object_step=0.002`` gives 392,064 faces at the
        default object radius, a TSDF mesh's scale), or with
        ``with_faces=False`` its points only."""
        if with_faces:
            pts, faces = self.fusion_mesh(**mesh_kwargs)
        else:
            pts, faces = self.fusion_points(), None
        lines = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
                 "property float x", "property float y", "property float z"]
        if faces is not None:
            lines += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
        lines.append("end_header")
        lines += [f"{x:.5f} {y:.5f} {z:.5f}" for x, y, z in pts.tolist()]
        if faces is not None:
            lines += [f"3 {a} {b} {c}" for a, b, c in faces.tolist()]
        path = os.path.join(processed_dir, "fusion_mesh.ply")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    def write_scene(self, scene_dir):
        """Write this scene in the pdc processed-log layout under
        ``<scene_dir>/processed``: RGB, depth and mask PNGs (the mask as
        0/255) through :func:`~pdc_tpu_torch.data.native_loader.encode_batch`,
        ``pose_data.yaml``, ``camera_info.yaml`` and ``fusion_mesh.ply``.
        Returns the processed folder."""
        from pdc_tpu_torch.data.native_loader import (
            KIND_ENC_GRAY8,
            KIND_ENC_GRAY16,
            KIND_ENC_RGB8,
            encode_batch,
        )
        from pdc_tpu_torch.utils.yaml_io import save_yaml

        processed = os.path.join(scene_dir, "processed")
        img_dir = os.path.join(processed, "images")
        depth_dir = os.path.join(processed, "rendered_images")
        mask_dir = os.path.join(processed, "image_masks")
        for d in (img_dir, depth_dir, mask_dir):
            os.makedirs(d, exist_ok=True)

        items, pose_data = [], {}
        for i in range(self.num_frames):
            rgb, depth, mask, pose = self.render(i)
            items += [(os.path.join(img_dir, "%06d_rgb.png" % i), KIND_ENC_RGB8, rgb),
                      (os.path.join(depth_dir, "%06d_depth.png" % i), KIND_ENC_GRAY16, depth),
                      (os.path.join(mask_dir, "%06d_mask.png" % i), KIND_ENC_GRAY8, mask * 255)]
            pose_data[i] = {
                "camera_to_world": dict_from_se3(pose),
                "timestamp": float(i),
                "rgb_image_filename": "%06d_rgb.png" % i,
                "depth_image_filename": "%06d_depth.png" % i,
            }
        encode_batch(items, self.height, self.width)
        save_yaml(pose_data, os.path.join(img_dir, "pose_data.yaml"))
        self.write_fusion_mesh(processed)
        intr = self.intrinsics
        save_yaml({"camera_matrix": {"data": [intr.fx, 0.0, intr.cx, 0.0, intr.fy, intr.cy,
                                              0.0, 0.0, 1.0]},
                   "image_width": self.width, "image_height": self.height},
                  os.path.join(img_dir, "camera_info.yaml"))
        return processed
