"""Synthetic posed RGBD scenes, rendered on the device from the seed.

The benchmark's own copy of the port's synthetic scene maker
(``pdc_tpu_torch/data/synthetic.py``, itself a port of
``pdc_tpu/data/synthetic.py``): a textured ground plane carrying a
disc-shaped object, seen by a ring of cameras looking at it, every depth
exact under the pinhole model. It renders every frame of every scene in
float64 on the device at once instead of a frame at a time on the host;
the arithmetic is the same. Each scene is one capture log of the same
object: the seed draws each scene's orbit (phase, radius and height
within 15% of the nominal ones) and the object's texture phase, so every
seed gives scenes of the same sizes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.seeds import numpy_rng

DEPTH_SCALE = 1000.0  # uint16 millimetres
RENDER_CHUNK = 16  # frames rendered at once (a frame's float64 rays and points take about 40 MB)


@dataclasses.dataclass
class Scenes:
    """Frames of every scene, scene after scene, on the device: ``rgb [F,
    H, W, 3]`` uint8, ``depth [F, H, W]`` int32 millimetres, ``mask [F,
    H, W]`` uint8, ``poses [F, 4, 4]`` float64 camera-to-world, ``K [3,
    3]`` float64, ``lengths`` frames per scene."""

    rgb: torch.Tensor
    depth: torch.Tensor
    mask: torch.Tensor
    poses: torch.Tensor
    K: torch.Tensor
    lengths: list

    @property
    def offsets(self):
        return list(np.cumsum([0] + self.lengths[:-1]))


def orbit_pose(angle: float, radius: float, height: float) -> np.ndarray:
    """Camera-to-world pose (x right, y down, z forward) of a camera on a
    ring, looking at the origin."""
    c = np.array([radius * np.cos(angle), radius * np.sin(angle), height])
    forward = -c / np.linalg.norm(c)
    right = np.cross(np.array([0.0, 0.0, -1.0]), forward)
    right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, forward, c
    return T


def intrinsics(width: int, height: int) -> np.ndarray:
    f = 0.9 * width
    return np.array([[f, 0.0, width / 2.0 - 0.5], [0.0, f, height / 2.0 - 0.5],
                     [0.0, 0.0, 1.0]])


def render(poses: torch.Tensor, K: np.ndarray, width: int, height: int, object_radius: float,
           texture: float):
    """Frames of the poses ``[F, 4, 4]`` (float64, on the device)."""
    dev = poses.device
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=dev),
                          torch.arange(width, dtype=torch.float64, device=dev), indexing="ij")
    K_inv = torch.as_tensor(np.linalg.inv(K), device=dev)
    d_cam = torch.stack([u, v, torch.ones_like(u)], dim=-1) @ K_inv.T     # [H, W, 3]
    d = torch.einsum("hwj,fij->fhwi", d_cam, poses[:, :3, :3])           # world rays
    c = poses[:, :3, 3][:, None, None, :]
    dz = d[..., 2]
    t = torch.where(dz < -1e-9, -c[..., 2] / dz, torch.full_like(dz, float("inf")))
    visible = torch.isfinite(t) & (t > 1e-6)
    t = torch.where(visible, t, torch.zeros_like(t))
    p = c + t[..., None] * d
    x, y = p[..., 0], p[..., 1]
    mask = visible & (x * x + y * y <= object_radius ** 2)
    ts = texture
    rgb = torch.stack([
        0.5 + 0.5 * torch.sin(21.0 * x + 9.0 * y + 2.4 * ts),
        0.5 + 0.5 * torch.sin(-7.0 * x + 25.0 * y + 30.0 * x * y + 1.0 + 4.9 * ts),
        0.5 + 0.5 * torch.sin(40.0 * (x * x - y * y) + 13.0 * x - 11.0 * y + 2.0 + 7.6 * ts
                              + 8.0 * ts * x),
    ], dim=-1)
    rgb = torch.where(visible[..., None], rgb, torch.zeros_like(rgb))
    rgb = torch.where(mask[..., None], rgb, rgb * 0.6 + 0.2)
    rgb_u8 = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    depth = torch.clamp(t * DEPTH_SCALE, 0.0, 65535.0).to(torch.int32)
    return rgb_u8, depth, mask.to(torch.uint8)


def make_scenes(seed: int, spec: dict, device) -> Scenes:
    """The scenes of a configuration's ``scenes`` block for ``seed``:
    ``num_scenes``, ``frames_per_scene``, ``width``, ``height``,
    ``radius``, ``cam_height``, ``object_radius``."""
    rng = numpy_rng(seed, "scenes")
    n, per = int(spec["num_scenes"]), int(spec["frames_per_scene"])
    texture = float(rng.uniform(0.0, 10.0))
    poses = []
    for _ in range(n):
        phase = rng.uniform(0.0, 2.0 * np.pi)
        radius = spec["radius"] * rng.uniform(0.85, 1.15)
        height = spec["cam_height"] * rng.uniform(0.85, 1.15)
        poses += [orbit_pose(phase + 2.0 * np.pi * i / per, radius, height) for i in range(per)]
    poses = torch.as_tensor(np.stack(poses), device=device)
    K = intrinsics(spec["width"], spec["height"])
    parts = [render(poses[i:i + RENDER_CHUNK], K, spec["width"], spec["height"],
                    spec["object_radius"], texture) for i in range(0, n * per, RENDER_CHUNK)]
    rgb, depth, mask = (torch.cat([p[j] for p in parts]) for j in range(3))
    return Scenes(rgb=rgb, depth=depth, mask=mask, poses=poses,
                  K=torch.as_tensor(K, device=device), lengths=[per] * n)
