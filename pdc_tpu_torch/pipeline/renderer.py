"""Depth rendering of a scene's fusion geometry: point splats and triangles.

Port of :mod:`pdc_tpu.pipeline.renderer` (the reference's VTK/OpenGL
``DepthScanner`` without a GL context): a metric depth image of a point
cloud or a triangle mesh under a camera pose, through a z-buffer that keeps
each pixel's nearest fragment. Every public function of the JAX module is
here with its name, arguments and outputs, except
``render_scene_products_sharded``, which needs the multi-device layer.

What the port keeps of the JAX geometry, bit for bit:

  * the projection, rounded as XLA's CPU code rounds the JAX package's
    ``invert_se3`` and ``transform_points``: ``x0*m0``, then a fused
    multiply-add per further term (the float64 product is exact), then the
    offset (:func:`_times`);
  * the fragment geometry of ``_fragments_from_faces``
    (``pdc_tpu/pipeline/renderer.py:100-154``), each edge function
    ``a*b - c*d`` a fused multiply-add of ``a*b`` onto the rounded ``-c*d``
    as XLA's CPU code contracts it (:func:`_cross`): each face rasterises a
    ``tile`` x ``tile`` block anchored at ``ceil(min - 0.5)`` (clamped at
    0), edge functions accepting both windings, perspective-correct depth
    ``1 / max(l0/z0 + l1/z1 + l2/z2, 1e-9)`` with ``l_i = w_i / area``, all
    in float32 in that order; ``(w / area) / z`` is ``w / (area * z)``, as
    XLA's algebraic simplifier rewrites it;
  * the host metric of :func:`projected_face_pixel_counts` (float64 numpy
    with its ``eps`` widening), which decides culling and the tile bins.

One reducer. The JAX package has two z-buffers, a fragment scatter-min and a
sort-based one, because the TPU's scatter-min is slow. On the card one
reducer does: ``scatter_reduce_(..., "amin")`` into a buffer filled with
``INVALID_DEPTH``. Masked fragments go to a sentinel slot ``H*W`` past the
image (never to pixel 0, where they would become contended atomics on one
address). A minimum does not depend on the order its updates arrive in, so
the card's result is deterministic and equals the CPU's. The ``_sorted_``
and ``_binned_`` functions keep their names, arguments and outputs; they
differ only in how the faces are grouped (per-pose culled sets in tile bins,
or all faces in tile bins, chunked) before that one reducer.

Memory is bounded: the culled ("sorted") path renders the poses in groups
whose fragments (faces x tile^2) stay within :data:`GROUP_FRAGMENTS`, and,
as in the JAX package, falls back to the face-chunked binned path when one
pose's fragments exceed ``max_fragments``.

Inputs are numpy arrays or tensors; work runs on ``device`` (default
``"cuda"``; ``resolve_device`` raises without CUDA unless ``"cpu"`` is
asked for). Depths come back as float32 tensors on that device, host
metrics as numpy.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pdc_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

INVALID_DEPTH = 1e9  # a float32 constant where it meets the depths
# fragments rendered at once by the per-pose culled path (poses are grouped
# under it; the JAX package renders one pose at a time)
GROUP_FRAGMENTS = 64_000_000


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _faces(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _poses_3d(poses):
    poses = np.asarray(poses.cpu() if isinstance(poses, torch.Tensor) else poses)
    return poses[None] if poses.ndim == 2 else poses


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once (the float64 product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _times(x, M, offset=None):
    """``x [..., N, 3] @ M[..., 3, 3].T (+ offset [..., 3])`` rounded as
    XLA's CPU code rounds the JAX package's product (the module docstring);
    ``M`` and ``offset`` may carry a leading pose axis."""
    batched = M.dim() == 3
    rows = []
    for r in range(3):
        m = [M[:, r, c, None] if batched else M[r, c] for c in range(3)]
        y = _fma(x[..., 2], m[2], _fma(x[..., 1], m[1], x[..., 0] * m[0]))
        if offset is not None:
            y = y + (offset[:, r, None] if batched else offset[r])
        rows.append(y)
    return torch.stack(rows, dim=-1)


def _project_vertices(vertices, poses, K):
    """Screen ``(u, v)`` and camera depth ``z`` of every vertex under every
    pose: ``[P, N]`` each, for ``poses [P, 4, 4]`` (all tensors)."""
    Rt = poses[:, :3, :3].transpose(1, 2)
    t = -_times(poses[:, None, :3, 3], Rt)[:, 0]  # invert_se3: -R^T t
    pts_cam = _times(vertices, Rt, t)  # [P, N, 3]
    proj = _times(pts_cam, K)
    denom = torch.where(proj[..., 2].abs() < 1e-9, torch.full_like(proj[..., 2], 1e-9),
                        proj[..., 2])
    return proj[..., 0] / denom, proj[..., 1] / denom, pts_cam[..., 2]


def _to_int(x):
    """float32 -> int64, as XLA converts in range; values far outside any
    image are clamped first, so they stay outside it."""
    return torch.clamp(x, -2.0 ** 30, 2.0 ** 30).to(torch.int64)


def _cross(a, b, c, d):
    """``a*b - c*d`` as XLA's CPU code computes the edge functions: the
    second product rounded, the first fused into the subtraction."""
    return _fma(a, b, -(c * d))


def _fragments(u, v, z, faces, height: int, width: int, tile: int):
    """Fragments of ``faces [P, C, 3]`` (vertex ids) over the projections
    ``u, v, z [P, N]``: ``(flat [P, C*tile^2] pixel ids, H*W where masked;
    val [P, C*tile^2] float32 depths, INVALID_DEPTH where masked)``, in the
    order and rounding of ``_fragments_from_faces``."""
    dev = u.device
    off = torch.arange(tile, device=dev)
    du = off.repeat(tile)  # meshgrid(off, off, indexing="xy"), flattened
    dv = off.repeat_interleave(tile)
    P, C = faces.shape[:2]
    pi = torch.arange(P, device=dev)[:, None, None]
    tu, tv, tz = u[pi, faces], v[pi, faces], z[pi, faces]  # [P, C, 3]
    in_front = (tz > 1e-6).all(dim=-1)

    u0 = _to_int(torch.clamp(torch.ceil(tu.min(dim=-1).values - 0.5), min=0.0))
    v0 = _to_int(torch.clamp(torch.ceil(tv.min(dim=-1).values - 0.5), min=0.0))
    ui = u0[..., None] + du  # [P, C, T2]
    vi = v0[..., None] + dv
    px = ui.to(torch.float32) + 0.5
    py = vi.to(torch.float32) + 0.5

    x1, x2, x3 = tu[..., 0:1], tu[..., 1:2], tu[..., 2:3]
    y1, y2, y3 = tv[..., 0:1], tv[..., 1:2], tv[..., 2:3]
    w0 = _cross(x3 - x2, py - y2, y3 - y2, px - x2)
    w1 = _cross(x1 - x3, py - y3, y1 - y3, px - x3)
    w2 = _cross(x2 - x1, py - y1, y2 - y1, px - x1)
    area = _cross(x2 - x1, y3 - y1, y2 - y1, x3 - x1)  # [P, C, 1]
    pos = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    neg = (w0 <= 0) & (w1 <= 0) & (w2 <= 0)
    ok_area = area.abs() > 1e-12
    inside = (pos | neg) & ok_area & in_front[..., None]

    # (w / area) / z as XLA simplifies it: w / (area * z)
    safe_area = torch.where(ok_area, area, torch.ones_like(area))
    inv_z = w0 / (safe_area * tz[..., 0:1]) + w1 / (safe_area * tz[..., 1:2]) \
        + w2 / (safe_area * tz[..., 2:3])
    depth = 1.0 / torch.clamp(inv_z, min=1e-9)

    ok = inside & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    flat = torch.where(ok, vi * width + ui, height * width)
    val = torch.where(ok, depth, torch.full_like(depth, INVALID_DEPTH))
    return flat.reshape(P, -1), val.reshape(P, -1)


def _new_zbuf(P: int, hw: int, device) -> torch.Tensor:
    """``[P, hw + 1]`` z-buffers; slot ``hw`` of each takes masked fragments."""
    return torch.full((P, hw + 1), INVALID_DEPTH, dtype=torch.float32, device=device)


def _reduce(zbuf, flat, val):
    """``zbuf[p, flat] = min(zbuf[p, flat], val)`` for every fragment."""
    zbuf.scatter_reduce_(1, flat, val, reduce="amin", include_self=True)


def _depth_of(zbuf, height: int, width: int):
    d = zbuf[:, : height * width]
    return torch.where(d >= INVALID_DEPTH, torch.zeros_like(d), d).reshape(-1, height, width)


def _render_faces(u, v, z, faces, height, width, tile, chunk, zbuf):
    """Reduce the fragments of ``faces [F, 3]`` (the same faces for every
    pose) into ``zbuf``, ``chunk`` faces at a time."""
    P = u.shape[0]
    for s in range(0, faces.shape[0], chunk):
        f = faces[s:s + chunk]
        _reduce(zbuf, *_fragments(u, v, z, f[None].expand(P, -1, -1), height, width, tile))


# -- point splats ------------------------------------------------------------------------------


def render_depth_from_points_many(points_world, poses, K, height: int, width: int,
                                  splat_radius: int = 1, device="cuda"):
    """Depth images ``[P, H, W]`` float32 of world-frame points ``[N, 3]``
    under ``poses [P, 4, 4]`` (0 where nothing projects): each point in
    front of the camera splats its depth into the ``(2r+1)^2`` pixels around
    its rounded projection (half to even, as ``jnp.round``)."""
    dev = resolve_device(device)
    poses_t = _f32(_poses_3d(poses), dev)
    u, v, z = _project_vertices(_f32(points_world, dev), poses_t, _f32(K, dev))
    hw = height * width
    zbuf = _new_zbuf(poses_t.shape[0], hw, dev)
    in_front = z > 1e-6
    ur, vr = _to_int(torch.round(u)), _to_int(torch.round(v))
    for du in range(-splat_radius, splat_radius + 1):
        for dv in range(-splat_radius, splat_radius + 1):
            ui, vi = ur + du, vr + dv
            ok = in_front & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
            _reduce(zbuf, torch.where(ok, vi * width + ui, hw),
                    torch.where(ok, z, torch.full_like(z, INVALID_DEPTH)))
    return _depth_of(zbuf, height, width)


def render_depth_from_points(points_world, camera_to_world, K, height: int, width: int,
                             splat_radius: int = 1, device="cuda"):
    """:func:`render_depth_from_points_many` of one pose: ``[H, W]``."""
    return render_depth_from_points_many(points_world, camera_to_world, K, height, width,
                                         splat_radius, device)[0]


def render_depth_from_points_sorted_many(points_world, poses, K, height: int, width: int,
                                         splat_radius: int = 1, device="cuda"):
    """The JAX package's sort-based variant of
    :func:`render_depth_from_points_many`. The same minimum over the same
    fragments, so here the same function (one reducer on the card)."""
    return render_depth_from_points_many(points_world, poses, K, height, width,
                                         splat_radius, device)


# -- triangles ---------------------------------------------------------------------------------


def render_depth_from_mesh_many(vertices_world, faces, poses, K, height: int, width: int,
                                tile: int = 8, chunk: int = 65536, device="cuda"):
    """Depth images ``[P, H, W]`` float32 of a triangle mesh (``vertices
    [N, 3]``, ``faces [F, 3]`` vertex ids) under ``poses [P, 4, 4]``, every
    face rasterised in one ``tile`` x ``tile`` block, ``chunk`` faces at a
    time (faces larger than the tile render truncated:
    :func:`pick_raster_tile` chooses one that covers them)."""
    dev = resolve_device(device)
    poses_t = _f32(_poses_3d(poses), dev)
    u, v, z = _project_vertices(_f32(vertices_world, dev), poses_t, _f32(K, dev))
    zbuf = _new_zbuf(poses_t.shape[0], height * width, dev)
    _render_faces(u, v, z, _faces(faces, dev), height, width, tile, chunk, zbuf)
    return _depth_of(zbuf, height, width)


def render_depth_from_mesh(vertices_world, faces, camera_to_world, K, height: int,
                           width: int, tile: int = 8, chunk: int = 65536, device="cuda"):
    """:func:`render_depth_from_mesh_many` of one pose: ``[H, W]``."""
    return render_depth_from_mesh_many(vertices_world, faces, camera_to_world, K, height,
                                       width, tile, chunk, device)[0]


def projected_face_pixel_counts(vertices_world, faces, camera_to_world, K, height: int,
                                width: int, eps: float = 1e-3):
    """Host-side per-face count of candidate pixel CENTERS under one pose,
    float64 numpy ``[F]``: the tile size the rasteriser needs (its block is
    anchored at ``ceil(min-0.5)``; a center ``u+0.5`` can be covered iff
    ``ceil(min-0.5) <= u <= floor(max-0.5)``), 0 for faces that cannot
    produce a fragment (behind the camera, clear of the viewport, or no
    center inside the bbox). ``eps`` (pixels) widens the range outward so
    the float64 metric never undercounts the float32 geometry at exact
    boundaries. ``pdc_tpu/pipeline/renderer.py:182-222``, unchanged."""
    V = np.asarray(vertices_world, np.float64)
    T = np.asarray(camera_to_world, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    pts_cam = (V - t) @ R
    z = pts_cam[:, 2]
    proj = pts_cam @ np.asarray(K, np.float64).T
    denom = np.where(np.abs(proj[:, 2]) < 1e-9, 1e-9, proj[:, 2])
    u = proj[:, 0] / denom
    v = proj[:, 1] / denom

    f = np.asarray(faces, np.int64)
    tu, tv, tz = u[f], v[f], z[f]
    in_front = np.all(tz > 0.5e-6, axis=1)  # the float32 cull is z > 1e-6
    lo_u = np.ceil(tu.min(axis=1) - 0.5 - eps)
    hi_u = np.floor(tu.max(axis=1) - 0.5 + eps)
    lo_v = np.ceil(tv.min(axis=1) - 0.5 - eps)
    hi_v = np.floor(tv.max(axis=1) - 0.5 + eps)
    cu = np.minimum(hi_u, width - 1) - np.maximum(lo_u, 0) + 1
    cv = np.minimum(hi_v, height - 1) - np.maximum(lo_v, 0) + 1
    count = np.maximum(np.maximum(cu, cv), 0)
    visible = in_front & (cu > 0) & (cv > 0)
    return np.where(visible, count, 0.0)


def _tile_bins(worst, min_tile: int, max_tile: int):
    """``[(selection [F] bool, tile)]``: the faces whose count lies in
    ``(previous tile, tile]``, tiles the powers of two from ``min_tile`` to
    ``max_tile`` (the last bin takes everything above), empty bins left out."""
    bins, lo, tile = [], 0.0, min_tile
    while True:
        hi = tile if tile < max_tile else np.inf
        sel = (worst > lo) & (worst <= hi)
        if sel.any():
            bins.append((sel, tile))
        if tile >= max_tile:
            break
        lo, tile = float(tile), tile * 2
    n_trunc = int((worst > max_tile).sum())
    if n_trunc:
        logger.warning("mesh rasterization: %d faces project larger than max_tile=%d and will "
                       "render truncated", n_trunc, max_tile)
    return bins


def _pose_counts(vertices_world, faces, poses, K, height, width):
    return np.stack([projected_face_pixel_counts(vertices_world, faces, pose, K, height, width)
                     for pose in poses])  # [P, F]


def bin_faces_by_extent(vertices_world, faces, poses, K, height: int, width: int,
                        min_tile: int = 4, max_tile: int = 64):
    """Faces in power-of-two tile bins by their worst-case (over ``poses``)
    candidate-center count (:func:`projected_face_pixel_counts`); faces
    never visible are dropped.

    :return: list of ``(faces [Fi, 3] int32, tile)`` with ``Fi > 0`` (one
        bin of at most one face when nothing is visible)
    """
    faces = np.asarray(faces, np.int32)
    worst = _pose_counts(vertices_world, faces, _poses_3d(poses), K, height,
                         width).max(axis=0)
    bins = [(faces[sel], tile) for sel, tile in _tile_bins(worst, min_tile, max_tile)]
    return bins or [(faces[:1], min_tile)]


def prepare_sorted_render(vertices_world, faces, poses, K, height: int, width: int,
                          min_tile: int = 2, max_tile: int = 64):
    """One host pass for the per-pose culled render: the candidate-center
    counts of every face under every pose (``[P, F]``) give both the tile
    bins (worst case over poses) and each pose's visible faces.

    :return: list of ``(faces [Fi+1, 3] int32 with a trailing degenerate
        sentinel row, idx [P, Vmax_i] int32 visible-face indices per pose
        padded with the sentinel index Fi, tile)``
    """
    poses = _poses_3d(poses)
    faces = np.asarray(faces, np.int32)
    counts = _pose_counts(vertices_world, faces, poses, K, height, width)
    prep = []
    for sel, tile in _tile_bins(counts.max(axis=0), min_tile, max_tile):
        fb = faces[sel]
        vis = counts[:, sel] > 0
        vmax = max(int(vis.sum(axis=1).max()), 1)
        idx = np.full((len(poses), vmax), len(fb), np.int32)
        for p in range(len(poses)):
            s = np.nonzero(vis[p])[0]
            idx[p, :len(s)] = s
        prep.append((np.concatenate([fb, np.zeros((1, 3), np.int32)]), idx, int(tile)))
    return prep or [(np.zeros((1, 3), np.int32), np.zeros((len(poses), 1), np.int32),
                     min_tile)]


def _fragments_per_pose(prep) -> int:
    return sum(idx.shape[1] * t * t for _, idx, t in prep)


def _upload(a, device, dtype):
    """A host array on ``device`` without making the host wait for the
    device's queue (pinned memory and an asynchronous copy on a card)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _render_prepared(vertices, poses_t, K, preps, height, width, device):
    """Culled per-pose renders of several prepared meshes over the same
    vertices: ``[P, H*W + 1]`` z-buffer for each prep. Poses go in groups
    whose fragments stay within :data:`GROUP_FRAGMENTS`; no host
    synchronisation."""
    P = poses_t.shape[0]
    per_pose = max(sum(_fragments_per_pose(p) for p in preps), 1)
    group = max(1, GROUP_FRAGMENTS // per_pose)
    uploaded = [[(_upload(fb, device, torch.int64), _upload(idx, device, torch.int64), t)
                 for fb, idx, t in prep] for prep in preps]
    zbufs = [_new_zbuf(P, height * width, device) for _ in preps]
    for s in range(0, P, group):
        u, v, z = _project_vertices(vertices, poses_t[s:s + group], K)
        for zbuf, prep in zip(zbufs, uploaded):
            for fb, idx, tile in prep:
                _reduce(zbuf[s:s + group],
                        *_fragments(u, v, z, fb[idx[s:s + group]], height, width, tile))
    return zbufs


def render_depth_from_mesh_binned_many(vertices_world, faces, poses, K, height: int,
                                       width: int, min_tile: int = 4, max_tile: int = 64,
                                       chunk: int = 65536, device="cuda"):
    """:func:`render_depth_from_mesh_many` with each face rasterised at the
    tile of its size bin (:func:`bin_faces_by_extent`): the same depths
    (the z-buffer minimum does not depend on the order), several times
    fewer fragments on a voxel-scale mesh."""
    bins = bin_faces_by_extent(vertices_world, faces, poses, K, height, width,
                               min_tile=min_tile, max_tile=max_tile)
    return _render_binned(vertices_world, bins, poses, K, height, width, chunk, device)


def _render_binned(vertices_world, bins, poses, K, height, width, chunk, device):
    dev = resolve_device(device)
    poses_t = _f32(_poses_3d(poses), dev)
    u, v, z = _project_vertices(_f32(vertices_world, dev), poses_t, _f32(K, dev))
    zbuf = _new_zbuf(poses_t.shape[0], height * width, dev)
    for fb, tile in bins:
        # per-bin chunk, as the JAX package sizes it
        _render_faces(u, v, z, _faces(fb, dev), height, width, tile,
                      min(chunk, max(len(fb), 1)), zbuf)
    return _depth_of(zbuf, height, width)


def render_depth_from_mesh_sorted_many(vertices_world, faces, poses, K, height: int,
                                       width: int, min_tile: int = 2, max_tile: int = 64,
                                       max_fragments: int = 64_000_000, device="cuda"):
    """Depth images ``[P, H, W]`` of a mesh with each pose's faces culled on
    the host first (:func:`prepare_sorted_render`), in per-extent tile bins.
    The JAX package reduces these fragments by sorting them (the TPU's
    scatter-min is slow); here the one reducer of the module docstring
    takes them, so the depths equal the binned route's bit for bit. When
    one pose's fragments exceed ``max_fragments`` (close-up poses pushing
    faces into large tiles), the face-chunked binned route renders instead,
    on the same bins."""
    dev = resolve_device(device)
    prep = prepare_sorted_render(vertices_world, faces, poses, K, height, width,
                                 min_tile=min_tile, max_tile=max_tile)
    n_fragments = _fragments_per_pose(prep)
    if n_fragments > max_fragments:
        logger.info("sorted renderer: %d fragments exceed the %d budget; using the "
                    "chunk-bounded scatter path", n_fragments, max_fragments)
        return _render_binned(vertices_world, [(fb[:-1], t) for fb, _, t in prep], poses, K,
                              height, width, 65536, dev)
    (zbuf,) = _render_prepared(_f32(vertices_world, dev), _f32(_poses_3d(poses), dev),
                               _f32(K, dev), [prep], height, width, dev)
    return _depth_of(zbuf, height, width)


# -- the preprocessing pipeline's per-scene program ------------------------------------------


def _packed(zbuf_fg, zbuf_full, height: int, width: int, depth_scale: float):
    """``[P, 2*hw + ceil(hw/16)]`` int16 whose bits are the JAX package's
    uint16 buffer: ``concat(depth_cropped_mm, depth_full_mm, mask_bits)``,
    mask bit ``i`` of word ``w`` the pixel ``w*16 + i``; millimetres are
    ``clip(d * depth_scale, 0, 65535)`` truncated (int32 arithmetic: torch
    has little uint16)."""
    hw = height * width
    d_fg = _depth_of(zbuf_fg, height, width).reshape(-1, hw)
    d_full = _depth_of(zbuf_full, height, width).reshape(-1, hw)

    def to_mm(d):
        return torch.clamp(d * depth_scale, 0.0, 65535.0).to(torch.int32)

    n_words = -(-hw // 16)
    mask = (d_fg > 0).to(torch.int32)
    mask = torch.nn.functional.pad(mask, (0, n_words * 16 - hw)).reshape(-1, n_words, 16)
    weights = torch.bitwise_left_shift(
        torch.ones(16, dtype=torch.int32, device=mask.device),
        torch.arange(16, dtype=torch.int32, device=mask.device))
    words = (mask * weights).sum(dim=-1, dtype=torch.int32)
    out = torch.cat([to_mm(d_fg), to_mm(d_full), words], dim=1)
    return torch.where(out >= 32768, out - 65536, out).to(torch.int16)


def render_scene_products_start(vertices_world, fg_faces, full_faces, poses, K, height: int,
                                width: int, depth_scale: float, min_tile: int = 2,
                                max_tile: int = 64, max_fragments: int = 64_000_000,
                                device="cuda"):
    """The asynchronous half of :func:`render_scene_products`: host prep
    (one projection pass a mesh, :func:`prepare_sorted_render`) and the
    device work, queued without waiting for it. For each pose: the
    crop-filtered foreground mesh and the full mesh rendered, the
    crop-strategy mask (the foreground renders anything), both depths in
    millimetres and the mask bit-packed, all in one buffer on the device
    (:func:`unpack_scene_products` fetches and unpacks it).

    Returns None when one pose's fragments exceed ``max_fragments``
    (``None`` disables the budget): the caller takes the chunk-bounded
    two-pass flow instead."""
    dev = resolve_device(device)
    poses3 = _poses_3d(poses)
    prep_fg = prepare_sorted_render(vertices_world, fg_faces, poses3, K, height, width,
                                    min_tile, max_tile)
    prep_full = prepare_sorted_render(vertices_world, full_faces, poses3, K, height, width,
                                      min_tile, max_tile)
    n_fragments = _fragments_per_pose(prep_fg) + _fragments_per_pose(prep_full)
    if max_fragments is not None and n_fragments > max_fragments:
        logger.info("fused scene render: %d fragments exceed the %d budget; caller should "
                    "use the chunk-bounded two-pass flow", n_fragments, max_fragments)
        return None
    zbuf_fg, zbuf_full = _render_prepared(
        _upload(np.asarray(vertices_world, np.float32), dev, torch.float32),
        _upload(np.asarray(poses3, np.float32), dev, torch.float32),
        _upload(np.asarray(K, np.float32), dev, torch.float32),
        [prep_fg, prep_full], height, width, dev)
    return _packed(zbuf_fg, zbuf_full, height, width, float(depth_scale))


def unpack_scene_products(packed, height: int, width: int):
    """Fetch (one device-to-host copy) and unpack the buffer of
    :func:`render_scene_products_start`.

    :return: ``(mask [P, H, W] uint8, depth_cropped_mm [P, H, W] uint16,
        depth_full_mm [P, H, W] uint16)`` numpy arrays
    """
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed).view(np.uint16)
    P, hw = packed.shape[0], height * width
    depth_crop = packed[:, :hw].reshape(P, height, width)
    depth_full = packed[:, hw:2 * hw].reshape(P, height, width)
    bits = (packed[:, 2 * hw:, None] >> np.arange(16, dtype=np.uint16)) & 1
    mask = bits.reshape(P, -1)[:, :hw].reshape(P, height, width).astype(np.uint8)
    return mask, depth_crop, depth_full


def render_scene_products(vertices_world, fg_faces, full_faces, poses, K, height: int,
                          width: int, depth_scale: float, min_tile: int = 2,
                          max_tile: int = 64, device="cuda"):
    """Masks and millimetre depths of a scene in one call (no fragment
    budget beyond the pose groups; ``ChangeDetection.process_scene`` keeps
    the two-pass fallback). ``fg_faces`` and ``full_faces`` index the same
    vertices (the foreground is a crop-box subset of the faces)."""
    return unpack_scene_products(
        render_scene_products_start(vertices_world, fg_faces, full_faces, poses, K, height,
                                    width, depth_scale, min_tile, max_tile,
                                    max_fragments=None, device=device), height, width)


def render_scene_products_sharded(*args, **kwargs):
    """The poses axis of :func:`render_scene_products` sharded over several
    devices: not ported yet; it waits for the parallel layer (ROADMAP queue
    1 item 9)."""
    raise NotImplementedError(
        "render_scene_products_sharded is not ported yet: it needs the multi-device layer "
        "(ROADMAP queue 1 item 9); render_scene_products renders on one card")


# -- host helpers ------------------------------------------------------------------------------


def projected_face_extents(vertices_world, faces, camera_to_world, K, height: int,
                           width: int):
    """Host-side screen bbox extent (max of width and height, px) of every
    face under one pose; 0 for faces behind the camera or clear of the
    viewport. ``pdc_tpu/pipeline/renderer.py:769-794``, unchanged."""
    V = np.asarray(vertices_world, np.float64)
    T = np.asarray(camera_to_world, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    pts_cam = (V - t) @ R
    z = pts_cam[:, 2]
    proj = pts_cam @ np.asarray(K, np.float64).T
    denom = np.where(np.abs(proj[:, 2]) < 1e-9, 1e-9, proj[:, 2])
    u = proj[:, 0] / denom
    v = proj[:, 1] / denom
    f = np.asarray(faces, np.int64)
    tu, tv, tz = u[f], v[f], z[f]
    in_front = np.all(tz > 1e-6, axis=1)
    u0, u1 = tu.min(axis=1), tu.max(axis=1)
    v0, v1 = tv.min(axis=1), tv.max(axis=1)
    on_screen = (u1 >= 0) & (u0 < width) & (v1 >= 0) & (v0 < height)
    ext = np.maximum(u1 - u0, v1 - v0) + 1.0
    return np.where(in_front & on_screen, ext, 0.0)


def pick_raster_tile(vertices_world, faces, poses, K, height: int, width: int,
                     min_tile: int = 8, max_tile: int = 64):
    """The smallest power-of-two tile (from ``min_tile``, at most
    ``max_tile``) covering every visible face's screen bbox under ``poses``;
    warns with the count of faces that will render truncated."""
    max_ext, worst = 0.0, None
    for pose in _poses_3d(poses):
        ext = projected_face_extents(vertices_world, faces, pose, K, height, width)
        m = float(ext.max()) if ext.size else 0.0
        if m > max_ext:
            max_ext, worst = m, ext
    tile = min_tile
    while tile < max_ext and tile < max_tile:
        tile *= 2
    if max_ext > tile:
        logger.warning("mesh rasterization: %d faces project larger than the maximum tile "
                       "(%d px; largest %.0f px) and will render truncated: subdivide the "
                       "mesh or raise max_tile", int((worst > tile).sum()), tile, max_ext)
    return tile


def mesh_vertices_from_ply(path: str):
    """The vertices of a PLY file (:func:`read_ply_mesh`)."""
    return read_ply_mesh(path)[0]


_PLY_TYPES = {"float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
              "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1", "short": "i2",
              "ushort": "u2", "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4"}


def read_ply_mesh(path: str):
    """ASCII or binary little-endian PLY: vertices and triangles.

    :return: ``(vertices [N, 3] float32, faces [F, 3] int32, or None when
        the file has no face element)``; ASCII faces that are not triangles
        are skipped, binary ones raise ``ValueError``
    """
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vertex = n_face = 0
        fmt = "ascii"
        props = []
        face_list_types = ("uchar", "int")
        reading_vertex_props = False
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vertex = int(line.split()[-1])
                reading_vertex_props = True
            elif line.startswith("element face"):
                n_face = int(line.split()[-1])
                reading_vertex_props = False
            elif line.startswith("element"):
                reading_vertex_props = False
            elif line.startswith("property") and reading_vertex_props:
                parts = line.split()
                props.append((parts[-1], parts[1]))
            elif line.startswith("property list"):
                parts = line.split()  # property list <count type> <index type> name
                face_list_types = (parts[2], parts[3])

        if fmt == "ascii":
            rows = [[float(x) for x in f.readline().split()[:3]] for _ in range(n_vertex)]
            verts = np.asarray(rows, np.float32).reshape(n_vertex, 3)
            faces = None
            if n_face:
                frows = []
                for _ in range(n_face):
                    vals = [int(x) for x in f.readline().split()]
                    if vals[0] == 3:  # triangles only
                        frows.append(vals[1:4])
                faces = np.asarray(frows, np.int32).reshape(-1, 3)
            return verts, faces

        dtype = np.dtype([(name, "<" + _PLY_TYPES[t]) for name, t in props])
        data = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
        verts = np.stack([data["x"].astype(np.float32), data["y"].astype(np.float32),
                          data["z"].astype(np.float32)], axis=-1)
        faces = None
        if n_face:
            fdtype = np.dtype([("n", "<" + _PLY_TYPES[face_list_types[0]]),
                               ("idx", "<" + _PLY_TYPES[face_list_types[1]], (3,))])
            fdata = np.frombuffer(f.read(fdtype.itemsize * n_face), dtype=fdtype, count=n_face)
            if not np.all(fdata["n"] == 3):
                raise ValueError(f"non-triangular faces in {path} (counts "
                                 f"{np.unique(fdata['n'])}); triangulate the mesh first")
            faces = fdata["idx"].astype(np.int32)
        return verts, faces
