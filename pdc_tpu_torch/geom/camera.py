"""Pinhole camera model in PyTorch, batched over leading axes.

Port of :mod:`pdc_tpu.geom.camera` (``CameraIntrinsics`` :22-78, with
``from_yaml_file`` reading through the port's own YAML reader,
``default_K_matrix`` :74-83, ``unproject_to_camera`` :92-108, ``project_to_image`` :111-126,
``uv_to_flat``/``flat_to_uv`` :129-142). Conventions are the same:

  * pixel coordinates are (u, v) = (column/right, row/down)
  * the camera frame is RDF (x right, y down, z forward)
  * a flattened pixel index is n = v * W + u

``K`` may carry leading batch axes (``[..., 3, 3]``) that broadcast against
the points'.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pdc_tpu_torch.utils.yaml_io import load_yaml


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Host-side pinhole camera matrix; ``from_dict`` reads the
    ``camera_info.yaml`` contract (``camera_matrix.data`` row-major)."""

    cx: float
    cy: float
    fx: float
    fy: float
    width: int
    height: int

    @property
    def K(self) -> np.ndarray:
        K = np.zeros((3, 3), dtype=np.float64)
        K[0, 0] = self.fx
        K[1, 1] = self.fy
        K[0, 2] = self.cx
        K[1, 2] = self.cy
        K[2, 2] = 1.0
        return K

    @staticmethod
    def from_yaml_file(filename: str) -> "CameraIntrinsics":
        """Read a ``camera_info.yaml``: the plain one, or the ROS
        calibration variant whose distortion, rectification and projection
        blocks surround the ``camera_matrix``."""
        return CameraIntrinsics.from_dict(load_yaml(filename))

    @staticmethod
    def from_dict(config: dict) -> "CameraIntrinsics":
        data = config["camera_matrix"]["data"]
        return CameraIntrinsics(cx=data[2], cy=data[5], fx=data[0], fy=data[4],
                                width=config["image_width"], height=config["image_height"])

    @staticmethod
    def from_K(K, width: int, height: int) -> "CameraIntrinsics":
        K = np.asarray(K)
        return CameraIntrinsics(cx=float(K[0, 2]), cy=float(K[1, 2]),
                                fx=float(K[0, 0]), fy=float(K[1, 1]),
                                width=width, height=height)


def default_K_matrix() -> np.ndarray:
    """The reference's hard-coded default intrinsics (float64 ``[3, 3]``),
    kept for parity with it."""
    K = np.zeros((3, 3))
    K[0, 0] = 533.6422696034836
    K[1, 1] = 534.7824445233571
    K[0, 2] = 319.4091030774892
    K[1, 2] = 236.4374299691866
    K[2, 2] = 1.0
    return K


def unproject_to_camera(uv, z, K):
    """Lift pixels to camera-frame points: ``p = z * K^-1 [u, v, 1]^T``.

    :param uv: ``[..., N, 2]`` pixel coordinates, float or int
    :param z: ``[..., N]`` metric depth
    :param K: ``[..., 3, 3]`` intrinsics
    :return: ``[..., N, 3]`` float32 points in the camera frame
    """
    uv = torch.as_tensor(uv).to(torch.float32)
    z = torch.as_tensor(z, device=uv.device).to(torch.float32)
    K = torch.as_tensor(K, device=uv.device).to(torch.float32)
    uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    rays = uv1 @ torch.linalg.inv(K).transpose(-1, -2)
    return rays * z[..., None]


def project_to_image(points_cam, K):
    """Project camera-frame points to pixels.

    :return: ``(uv [..., N, 2] float32, z [..., N] float32)``; ``z`` is the
        camera-frame depth, and the caller decides how to treat ``z <= 0``
    """
    points_cam = torch.as_tensor(points_cam).to(torch.float32)
    K = torch.as_tensor(K, device=points_cam.device).to(torch.float32)
    proj = points_cam @ K.transpose(-1, -2)
    z = points_cam[..., 2]
    denom = proj[..., 2:3]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    return proj[..., :2] / denom, z


def uv_to_flat(uv, image_width: int):
    """(u, v) -> n = v * W + u, truncating float coordinates toward zero."""
    uv = torch.as_tensor(uv)
    return uv[..., 1].to(torch.int32) * image_width + uv[..., 0].to(torch.int32)


def flat_to_uv(flat, image_width: int):
    """n -> (u, v) with u = n % W, v = n // W (int32)."""
    flat = torch.as_tensor(flat).to(torch.int32)
    return torch.stack([flat % image_width, flat // image_width], dim=-1)
