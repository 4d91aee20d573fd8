"""Per-vertex mesh descriptors.

Port of :mod:`pdc_tpu.apps.mesh_descriptors` (:24-90). The reference keeps
per-network mesh-descriptor ``.npz`` files beside each scene
(``scene_structure.py:100-124``). Every mesh vertex is projected into each
frame, tested for visibility against the frame's depth, and given the
average of the descriptors sampled in the frames that see it. Each frame's
projection, test, gather and sum run on the network's device, in float32;
pixel coordinates round half to even (``torch.round``, as ``jnp.round``),
integer depth is in millimetres (divided by ``DEPTH_IM_SCALE``), and the
frames are summed in the order given.

A vertex's pixel is a rounding of float32 arithmetic, so one ulp moves it
across a half-pixel now and then. The 3x3 products are therefore written
out element by element with the rounding of each step fixed, as XLA's CPU
code for the JAX package's jitted frame rounds them: ``x0*m0``, then a
fused multiply-add for each further term (``fma(x2, m2, fma(x1, m1,
x0*m0))``, the product taken in float64, where it is exact, and the sum
rounded to float32), then the offset. The same bits come out on the CPU
and on a CUDA card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pdc_tpu_torch.utils.constants import DEPTH_IM_SCALE, OCCLUSION_MARGIN


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once (the float64 product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _times(x, M, offset=None):
    """``x [..., 3] @ M.T (+ offset)`` in the rounding of the module
    docstring."""
    rows = []
    for r in range(3):
        y = _fma(x[..., 2], M[r, 2], _fma(x[..., 1], M[r, 1], x[..., 0] * M[r, 0]))
        rows.append(y if offset is None else y + offset[r])
    return torch.stack(rows, dim=-1)


def _accumulate_frame(points_world, cam_to_world, K, depth, res):
    """One frame's contribution, all tensors on one device: per-vertex
    (descriptor sum [N, D], weight [N])."""
    H, W = depth.shape
    Rt = cam_to_world[:3, :3].t()
    pts_cam = _times(points_world, Rt, -_times(cam_to_world[:3, 3], Rt))
    z = pts_cam[:, 2]
    proj = _times(pts_cam, K)
    denom = torch.where(proj[:, 2].abs() < 1e-9, torch.full_like(proj[:, 2], 1e-9), proj[:, 2])
    u = proj[:, 0] / denom
    v = proj[:, 1] / denom

    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    in_fov = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)

    d = depth.to(torch.float32)
    if not depth.is_floating_point():
        d = d / DEPTH_IM_SCALE
    d_at = d[vi, ui]
    visible = in_fov & (d_at > 0) & (d_at >= z - 2 * OCCLUSION_MARGIN)

    w = visible.to(torch.float32)
    return res[vi, ui, :] * w[:, None], w


def accumulate_mesh_descriptors(scene, points_world, descriptor_image, frame_indices=None,
                                device="cuda"):
    """Average descriptor per vertex over the frames that see it, from
    ``descriptor_image(position) -> [H, W, D]`` (any device; moved to
    ``device``).

    :param scene: :class:`~pdc_tpu_torch.data.dataset.SceneData`
    :param points_world: [N, 3] mesh vertices (world frame)
    :param frame_indices: the frames' ``%06d`` file indices (default: all)
    :return: dict with 'vertices' [N, 3], 'descriptors' [N, D] and
        'num_observations' [N] (float32), as numpy
    """
    pts = torch.as_tensor(np.asarray(points_world, np.float32), device=device)
    K = torch.as_tensor(np.asarray(scene.K), dtype=torch.float32, device=device)
    if frame_indices is None:
        frame_indices = scene.file_indices
    acc = wsum = None
    for idx in frame_indices:
        i = scene.position(int(idx))
        depth = np.asarray(scene.depth[i])
        if depth.dtype == np.uint16:
            depth = depth.astype(np.int32)  # torch has no uint16 arithmetic
        s, w = _accumulate_frame(
            pts, torch.as_tensor(np.asarray(scene.poses[i]), dtype=torch.float32, device=device),
            K, torch.as_tensor(depth, device=device),
            torch.as_tensor(descriptor_image(i), device=device))
        acc = s if acc is None else acc + s
        wsum = w if wsum is None else wsum + w
    acc, wsum = acc.cpu().numpy(), wsum.cpu().numpy()
    return {
        "vertices": np.asarray(points_world),
        "descriptors": acc / np.maximum(wsum[:, None], 1.0),
        "num_observations": wsum,
    }


def compute_mesh_descriptors(dcn, scene, points_world, frame_indices=None):
    """:func:`accumulate_mesh_descriptors` of the network's descriptor
    images (``dcn.forward_on_img``), on the network's device."""
    with torch.inference_mode():
        return accumulate_mesh_descriptors(
            scene, points_world, lambda i: dcn.forward_on_img(scene.rgb[i]),
            frame_indices=frame_indices, device=dcn.device)


def save_mesh_descriptors(result: dict, structure, network_name: str):
    """Write the per-network mesh-descriptor npz at the SceneStructure path."""
    out = os.path.join(structure.processed_folder, "mesh_descriptors", network_name,
                       "mesh_descriptors.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(out, **result)
    return out
