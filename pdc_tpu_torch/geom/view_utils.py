"""VTK-free rebuild of the reference's director camera utilities.

Port of :mod:`pdc_tpu.geom.view_utils` (:45-131), numpy only, line for line.

The reference's ``modules/dense_correspondence_manipulation/utils/
director_utils.py`` maps between OpenCV-style camera geometry and a VTK
render view: an RDF (x-right, y-down, z-forward) camera-to-world transform
is encoded as the VTK camera triple (position, focal point, view-up), and
pinhole intrinsics become a VTK view angle + window center + user transform.
The JAX package renders without VTK (its ``pipeline/renderer.py`` projects
with K directly), but the *conversions* are useful on their own — interop with
any lookat-style renderer or viewer — so the function surface is kept:

* :func:`transform_from_pose`          (``director_utils.py:22``)
* :class:`ViewCamera` + :func:`camera_transform_from_view` (``:42``
  getCameraTransform) / :func:`view_from_camera_transform` (``:73``
  setCameraTransform)
* :func:`focal_length_to_view_angle` (``:95``) /
  :func:`view_angle_to_focal_length` (``:100``)
* :func:`view_params_from_intrinsics`  (``:105`` setCameraIntrinsics — the
  window-center / view-angle / fx-fy aspect numbers it feeds VTK)

The box/segment crop helpers that shared this file live with the other
point-cloud filters (the JAX package's ``pipeline/segmentation.py`` and
``pipeline/change_detection.py``; the preprocessing slice ports them).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pdc_tpu_torch.geom.transforms import se3_from_dict

__all__ = [
    "ViewCamera",
    "transform_from_pose",
    "camera_transform_from_view",
    "view_from_camera_transform",
    "focal_length_to_view_angle",
    "view_angle_to_focal_length",
    "view_params_from_intrinsics",
]


def transform_from_pose(d: dict) -> np.ndarray:
    """4x4 transform from the standard pose-dict encoding
    (``director_utils.transformFromPose``; same format as pose_data.yaml)."""
    return se3_from_dict(d)


@dataclasses.dataclass
class ViewCamera:
    """The lookat triple a VTK/OpenGL-style camera is parameterized by."""

    position: np.ndarray      # [3] world
    focal_point: np.ndarray   # [3] world (defines the forward direction)
    view_up: np.ndarray       # [3] world (need not be orthogonal to forward)

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float64)
        self.focal_point = np.asarray(self.focal_point, np.float64)
        self.view_up = np.asarray(self.view_up, np.float64)


def camera_transform_from_view(camera: ViewCamera) -> np.ndarray:
    """RDF camera-to-world transform from a lookat triple
    (``director_utils.getCameraTransform``).

    Convention: x-right, y-down, z-forward.  VTK's view-up and forward need
    not be orthogonal, so the frame is re-orthonormalized the same way the
    reference does: y = -up, z = forward, x = y x z, then y = z x x.
    """
    forward = camera.focal_point - camera.position
    if np.linalg.norm(forward) < 1e-8:
        forward = np.array([1.0, 0.0, 0.0])
    yaxis = -camera.view_up
    zaxis = forward
    xaxis = np.cross(yaxis, zaxis)
    yaxis = np.cross(zaxis, xaxis)
    T = np.eye(4)
    T[:3, 0] = xaxis / np.linalg.norm(xaxis)
    T[:3, 1] = yaxis / np.linalg.norm(yaxis)
    T[:3, 2] = zaxis / np.linalg.norm(zaxis)
    T[:3, 3] = camera.position
    return T


def view_from_camera_transform(camera_to_world: np.ndarray,
                               focal_distance: float = 1.0) -> ViewCamera:
    """Lookat triple from an RDF camera-to-world transform
    (``director_utils.setCameraTransform``): position = origin, focal point
    one ``focal_distance`` along +z, view-up = -y."""
    T = np.asarray(camera_to_world, np.float64)
    origin = T[:3, 3]
    return ViewCamera(position=origin,
                      focal_point=origin + focal_distance * T[:3, 2],
                      view_up=-T[:3, 1])


def focal_length_to_view_angle(focal_length: float,
                               image_height: int) -> float:
    """Vertical view angle in degrees for a pinhole focal length
    (``director_utils.focalLengthToViewAngle``)."""
    return float(np.degrees(2.0 * np.arctan2(image_height / 2.0,
                                             focal_length)))


def view_angle_to_focal_length(view_angle: float,
                               image_height: int) -> float:
    """Inverse of :func:`focal_length_to_view_angle`."""
    return float((image_height / 2.0)
                 / np.tan(np.radians(view_angle / 2.0)))


def view_params_from_intrinsics(intrinsics) -> dict:
    """The render-view parameters VTK derives from pinhole intrinsics
    (``director_utils.setCameraIntrinsics``): normalized window center
    offsets for (cx, cy), the fy-derived vertical view angle, and the
    fx/fy anisotropy the reference applies as a camera user transform.

    ``intrinsics`` is any object with cx/cy/fx/fy/width/height attributes
    (:class:`pdc_tpu_torch.geom.camera.CameraIntrinsics` qualifies).
    """
    w, h = float(intrinsics.width), float(intrinsics.height)
    return {
        "window_center": (-2.0 * (intrinsics.cx - w / 2.0) / w,
                          2.0 * (intrinsics.cy - h / 2.0) / h),
        "view_angle": focal_length_to_view_angle(intrinsics.fy,
                                                 intrinsics.height),
        "aspect_scale": float(intrinsics.fx) / float(intrinsics.fy),
    }
