"""SE(3) and quaternion helpers.

Port of :mod:`pdc_tpu.geom.transforms` (:20-163). The host-side helpers
work in float64 numpy, as there; ``invert_se3`` takes numpy or torch, and
``transform_points`` is torch, batched over leading axes. Quaternions are
(w, x, y, z), as in the ``pose_data.yaml`` files of the pdc scene layout
(:func:`se3_from_dict`, :func:`dict_from_se3`).
"""

from __future__ import annotations

import numpy as np
import torch


def _quat_to_mat_np(w, x, y, z):
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quaternion_matrix(q):
    """3x3 rotation (numpy) of a quaternion (w, x, y, z), normalised first;
    the identity for a (near-)zero quaternion."""
    q = np.asarray(q, dtype=np.float64)
    n = np.dot(q, q)
    if n < 1e-12:
        return np.eye(3)
    w, x, y, z = q / np.sqrt(n)
    return _quat_to_mat_np(w, x, y, z)


def quaternion_from_matrix(R):
    """Unit quaternion (w, x, y, z) of a 3x3 (or 4x4) rotation matrix, by
    Shepperd's branch on the largest diagonal term."""
    R = np.asarray(R, dtype=np.float64)[:3, :3]
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def se3_from_quat_trans(quat_wxyz, translation):
    """4x4 homogeneous transform (numpy) from a quaternion and a translation."""
    T = np.eye(4)
    w, x, y, z = np.asarray(quat_wxyz, dtype=np.float64)
    T[:3, :3] = _quat_to_mat_np(w, x, y, z)
    T[:3, 3] = np.asarray(translation, dtype=np.float64)
    return T


def se3_from_dict(d):
    """4x4 camera-to-world transform of a ``pose_data.yaml`` entry:
    ``{"quaternion": {"w", "x", "y", "z"}, "translation": {"x", "y", "z"}}``,
    where the rotation key may also be spelled ``orientation`` or
    ``rotation``."""
    q = next((d[k] for k in ("quaternion", "orientation", "rotation") if k in d), None)
    if q is None:
        raise ValueError(f"pose dict has no quaternion/orientation/rotation key: {sorted(d)}")
    t = d["translation"]
    return se3_from_quat_trans([q["w"], q["x"], q["y"], q["z"]], [t["x"], t["y"], t["z"]])


def dict_from_se3(T):
    """The ``pose_data.yaml`` entry of a 4x4 transform (inverse of
    :func:`se3_from_dict`)."""
    T = np.asarray(T)
    q = quaternion_from_matrix(T[:3, :3])
    return {
        "quaternion": {"w": float(q[0]), "x": float(q[1]), "y": float(q[2]), "z": float(q[3])},
        "translation": {"x": float(T[0, 3]), "y": float(T[1, 3]), "z": float(T[2, 3])},
    }


def invert_se3(T):
    """Inverse of ``[..., 4, 4]`` rigid transforms: ``[R^T, -R^T t]``.
    Numpy in, numpy out; torch in, torch out."""
    if isinstance(T, torch.Tensor):
        R, t = T[..., :3, :3], T[..., :3, 3]
        Rt = R.transpose(-1, -2)
        out = torch.zeros_like(T)
        out[..., :3, :3] = Rt
        out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
        out[..., 3, 3].fill_(1.0)  # in place, no tensor made from host memory
        return out
    T = np.asarray(T)
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3][..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def transform_points(T, points):
    """Apply ``[..., 4, 4]`` transforms to ``[..., N, 3]`` points (float32)."""
    points = torch.as_tensor(points).to(torch.float32)
    T = torch.as_tensor(T, device=points.device).to(torch.float32)
    return points @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def pose_distance(T_a, T_b) -> float:
    """Euclidean distance between the translations."""
    T_a, T_b = np.asarray(T_a), np.asarray(T_b)
    return float(np.linalg.norm(T_a[:3, 3] - T_b[:3, 3]))


def pose_angle(T_a, T_b) -> float:
    """Relative rotation angle in radians."""
    T_a, T_b = np.asarray(T_a), np.asarray(T_b)
    c = (np.trace(T_a[:3, :3].T @ T_b[:3, :3]) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))
