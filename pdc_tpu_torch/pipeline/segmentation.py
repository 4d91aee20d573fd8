"""Point-cloud segmentation toolbox (the DRC/PCL-filter analog).

Port of :mod:`pdc_tpu.pipeline.segmentation`, which is numpy host tooling
in the JAX package too: this is its own copy (the port imports nothing of
``pdc_tpu``), with the same functions, seeds and numerics, so equal inputs
and seeds give equal results.

The reference vendors a Director/DRC segmentation module whose pipelines
sit on PCL C++ filters; neither its change detection nor its fusion code
calls into it. These are the operations those pipelines are built from, with
the same geometric semantics and no VTK/PCL/director dependency:

* :func:`voxel_down_sample`       (``pcl::VoxelGrid`` / applyVoxelGrid)
* :func:`fit_plane_ransac`        (applyPlaneFit / PCL SAC)
* :func:`segment_table`           (table-top extraction; composes with
                                   :func:`~pdc_tpu_torch.pipeline.change_detection.fit_crop_box`)
* :func:`euclidean_cluster`       (``pcl::EuclideanClusterExtraction``)
* :func:`remove_radius_outliers`  (``pcl::RadiusOutlierRemoval``)
* :func:`estimate_normals`        (``pcl::NormalEstimation``, kNN PCA)
* :func:`icp_point_to_point`      (``pcl::IterativeClosestPoint``)
* :func:`crop_to_line_segment`    (``director_utils.py:151`` cropToLineSegment)

Everything is fixed-cost numpy over [N,3] float arrays; neighbour queries use
a uniform grid hash (cell = query radius), so no spatial index is needed.
They run on the host; the device path (mask rendering) lives in
:mod:`pdc_tpu_torch.pipeline.change_detection` and
:mod:`pdc_tpu_torch.pipeline.renderer`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "voxel_down_sample",
    "fit_plane_ransac",
    "refine_plane_least_squares",
    "segment_table",
    "euclidean_cluster",
    "remove_radius_outliers",
    "estimate_normals",
    "icp_point_to_point",
    "crop_to_line_segment",
]


# ---------------------------------------------------------------------------
# grid hashing (shared neighbor-query machinery)
# ---------------------------------------------------------------------------

def _grid_keys(points: np.ndarray, cell: float) -> np.ndarray:
    """Integer [N,3] grid coordinates of each point at the given cell size."""
    return np.floor(points / cell).astype(np.int64)


def _pack_keys(ijk: np.ndarray) -> np.ndarray:
    """[N,3] int grid coords -> [N] scalar keys (collision-free via offset)."""
    mins = ijk.min(axis=0)
    shifted = ijk - mins  # non-negative
    dims = shifted.max(axis=0) + 1
    return (shifted[:, 0] * dims[1] + shifted[:, 1]) * dims[2] + shifted[:, 2]


def _neighbor_pairs(points: np.ndarray, radius: float,
                    max_pairs: int = 20_000_000) -> Tuple[np.ndarray, np.ndarray]:
    """All index pairs (i, j), i != j, with ||p_i - p_j|| <= radius.

    Uniform grid with cell == radius: every neighbor of a point lies in its
    own or one of the 26 adjacent cells.  Returns both (i,j) and (j,i) —
    symmetric adjacency, convenient for degree counts and union-find.
    """
    n = len(points)
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    finite = np.isfinite(points).all(axis=1)
    if not finite.all():
        # NaN/inf points (PCL's is_dense=False case) get no neighbors; a
        # single bad point must not poison the grid extents for the rest
        fidx = np.nonzero(finite)[0]
        s, d = _neighbor_pairs(points[finite], radius, max_pairs)
        return fidx[s], fidx[d]
    ijk = _grid_keys(points, radius)
    keys = _pack_keys(ijk)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    # cell id for each point + bucket boundaries
    uniq, starts = np.unique(sorted_keys, return_index=True)
    ends = np.append(starts[1:], n)

    # bucket lookup table: sorted unique key -> slice into `order`
    def bucket(cell_keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        pos = np.searchsorted(uniq, cell_keys)
        pos = np.clip(pos, 0, len(uniq) - 1)
        hit = uniq[pos] == cell_keys
        return pos, hit

    mins = ijk.min(axis=0)
    dims = (ijk - mins).max(axis=0) + 1

    src_list, dst_list = [], []
    r2 = radius * radius
    total = 0
    # 27 neighbor offsets; for each, pair every point with every point in the
    # offset cell (vectorized per offset via repeat/concatenate over buckets)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nb = ijk + np.array([dx, dy, dz])
                shifted = nb - mins
                valid = np.all((shifted >= 0) & (shifted < dims), axis=1)
                nb_keys = np.where(
                    valid,
                    (shifted[:, 0] * dims[1] + shifted[:, 1]) * dims[2]
                    + shifted[:, 2],
                    -1)
                pos, hit = bucket(nb_keys)
                hit &= valid
                if not hit.any():
                    continue
                qi = np.nonzero(hit)[0]
                b_starts = starts[pos[qi]]
                b_counts = ends[pos[qi]] - b_starts
                # the memory hazard is the CANDIDATE expansion below, not the
                # post-filter kept pairs — bound it before allocating (a
                # radius ~ cloud extent puts everything in one cell: n^2
                # candidates)
                cand = int(b_counts.sum())
                if total + cand > max_pairs:
                    raise ValueError(
                        f"neighbor-candidate expansion exceeds {max_pairs} "
                        "pairs; raise max_pairs, shrink the radius, or "
                        "voxel_down_sample first")
                # expand: query index repeated per bucket occupant
                reps = np.repeat(qi, b_counts)
                flat = np.concatenate(
                    [order[s:s + c] for s, c in zip(b_starts, b_counts)]
                ) if len(qi) else np.empty(0, np.int64)
                d2 = np.sum((points[reps] - points[flat]) ** 2, axis=1)
                keep = (d2 <= r2) & (reps != flat)
                total += int(keep.sum())
                if total > max_pairs:
                    raise ValueError(
                        f"neighbor graph exceeds {max_pairs} pairs; "
                        "raise max_pairs or voxel_down_sample first")
                src_list.append(reps[keep])
                dst_list.append(flat[keep])
    if not src_list:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    return np.concatenate(src_list), np.concatenate(dst_list)


# ---------------------------------------------------------------------------
# voxel grid
# ---------------------------------------------------------------------------

def voxel_down_sample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Centroid-per-occupied-voxel downsample (``pcl::VoxelGrid`` semantics).

    Returns the [M,3] centroids ordered by first occurrence of each voxel in
    the input (deterministic for a given input ordering).
    """
    points = np.asarray(points, np.float64)
    points = points[np.isfinite(points).all(axis=1)]  # PCL skips non-finite
    if len(points) == 0:
        return points.reshape(0, 3)
    keys = _pack_keys(_grid_keys(points, float(voxel_size)))
    uniq, first_idx, inverse = np.unique(keys, return_index=True,
                                         return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inverse, points)
    counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
    centroids = sums / counts[:, None]
    # order by first appearance in the input, not by key value
    return centroids[np.argsort(first_idx, kind="stable")]


# ---------------------------------------------------------------------------
# plane fitting
# ---------------------------------------------------------------------------

def refine_plane_least_squares(points: np.ndarray
                               ) -> Tuple[np.ndarray, float]:
    """Total-least-squares plane through a point set.

    Returns (unit normal n, offset d) with the plane {x : n.x + d = 0}; the
    normal is the smallest-eigenvalue direction of the centered covariance.
    """
    pts = np.asarray(points, np.float64)
    centroid = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - centroid, full_matrices=False)
    normal = vt[-1]
    normal = normal / np.linalg.norm(normal)
    return normal, float(-normal @ centroid)


def fit_plane_ransac(points: np.ndarray,
                     distance_threshold: float = 0.01,
                     num_iterations: int = 200,
                     seed: int = 0,
                     refine: bool = True
                     ) -> Tuple[np.ndarray, float, np.ndarray]:
    """RANSAC plane fit (PCL ``SACMODEL_PLANE`` / DRC applyPlaneFit analog).

    Vectorized over hypotheses: draws ``num_iterations`` 3-point samples at
    once, scores all candidate planes against all points in one [I,N]
    distance matrix, keeps the inlier-richest, then (optionally) refines on
    its inliers with total least squares.

    Returns ``(normal, d, inlier_mask)`` for the plane {x : n.x + d = 0}.
    """
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n < 3:
        raise ValueError("need at least 3 points to fit a plane")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(num_iterations, 3))
    a, b, c = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    normals = np.cross(b - a, c - a)  # [I,3]
    norms = np.linalg.norm(normals, axis=1)
    ok = norms > 1e-12  # degenerate (collinear) samples score zero inliers
    normals[ok] /= norms[ok, None]
    ds = -np.einsum("ij,ij->i", normals, a)  # [I]
    dist = np.abs(pts @ normals.T + ds)  # [N,I]
    counts = np.where(ok, (dist <= distance_threshold).sum(axis=0), 0)
    best = int(np.argmax(counts))
    if counts[best] == 0:
        # every 3-point sample was degenerate (collinear/duplicate input) —
        # a valid hypothesis always counts its own sample points as inliers
        raise ValueError("RANSAC found no valid plane hypothesis "
                         "(all sampled point triples were degenerate)")
    normal, d = normals[best], float(ds[best])
    inliers = dist[:, best] <= distance_threshold
    if refine and inliers.sum() >= 3:
        normal, d = refine_plane_least_squares(pts[inliers])
        inliers = np.abs(pts @ normal + d) <= distance_threshold
    return normal, d, inliers


def segment_table(points: np.ndarray,
                  distance_threshold: float = 0.01,
                  above_table: float = 0.01,
                  num_iterations: int = 200,
                  seed: int = 0) -> dict:
    """Dominant-plane table-top segmentation (the DRC tabletop pipeline).

    Fits the largest plane, orients its normal toward the side holding the
    majority of the off-plane points (the "up" side), and splits the cloud
    into ``table`` (plane inliers), ``above`` (objects: more than
    ``above_table`` up from the plane) and ``below``.

    Complements :func:`pdc_tpu_torch.pipeline.change_detection.fit_crop_box`, which
    assumes a z-up axis-aligned table; this variant recovers an arbitrary
    table orientation first.
    """
    pts = np.asarray(points, np.float64)
    normal, d, inliers = fit_plane_ransac(
        pts, distance_threshold=distance_threshold,
        num_iterations=num_iterations, seed=seed)
    signed = pts @ normal + d
    off = ~inliers
    if off.any() and np.median(signed[off]) < 0:
        normal, d, signed = -normal, -d, -signed
    above = off & (signed > above_table)
    below = off & (signed < 0)
    return {
        "normal": normal,
        "d": d,
        "table_mask": inliers,
        "above_mask": above,
        # strictly the under-side of the plane — up-side points inside the
        # (threshold, above_table] band are near_mask, NOT below (a caller
        # dropping below_mask must not delete low-lying object geometry)
        "below_mask": below,
        "near_mask": off & ~above & ~below,
        "table": pts[inliers],
        "above": pts[above],
    }


# ---------------------------------------------------------------------------
# clustering / outlier removal / normals
# ---------------------------------------------------------------------------

def euclidean_cluster(points: np.ndarray, radius: float,
                      min_cluster_size: int = 1) -> np.ndarray:
    """Connected components of the fixed-radius neighbor graph.

    PCL ``EuclideanClusterExtraction`` semantics: two points belong to the
    same cluster iff linked by a chain of <=radius hops.  Returns an [N]
    int label array, clusters numbered 0.. by decreasing size; points in
    clusters smaller than ``min_cluster_size`` get label -1.
    """
    pts = np.asarray(points, np.float64)
    n = len(pts)
    finite = np.isfinite(pts).all(axis=1)
    if not finite.all():
        out = np.full(n, -1, np.int64)  # PCL skips non-finite points
        out[finite] = euclidean_cluster(pts[finite], radius,
                                        min_cluster_size)
        return out
    src, dst = _neighbor_pairs(pts, radius)
    # vectorized connected components: min-label propagation over the edge
    # list with pointer jumping (O(E) numpy work per round, O(log diameter)
    # rounds) — a per-edge Python union-find loop dominates runtime on dense
    # clouds with tens of millions of edges
    roots = np.arange(n)
    while True:
        nxt = roots.copy()
        np.minimum.at(nxt, src, roots[dst])  # pull each neighborhood's min
        nxt = np.minimum(nxt, nxt[nxt])      # pointer jumping
        if np.array_equal(nxt, roots):
            break
        roots = nxt
    uniq, inverse, counts = np.unique(roots, return_inverse=True,
                                      return_counts=True)
    # relabel by decreasing size
    order = np.argsort(-counts, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    labels = rank[inverse]
    labels[counts[inverse] < min_cluster_size] = -1
    return labels


def remove_radius_outliers(points: np.ndarray, radius: float,
                           min_neighbors: int = 2
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """PCL ``RadiusOutlierRemoval``: keep points whose radius search finds
    >= min_neighbors points.  PCL's radiusSearch over the same cloud counts
    the query point itself (distance 0), so the count here is self + others
    — PCL-tuned ``min_neighbors`` values transfer unchanged.  Returns
    (filtered_points, keep_mask)."""
    pts = np.asarray(points, np.float64)
    src, _ = _neighbor_pairs(pts, radius)
    degree = np.bincount(src, minlength=len(pts)) + 1  # + self, as in PCL
    keep = (degree >= min_neighbors) & np.isfinite(pts).all(axis=1)
    return pts[keep], keep


def estimate_normals(points: np.ndarray, radius: float,
                     orient_toward: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """Per-point PCA normals from the fixed-radius neighborhood
    (``pcl::NormalEstimation``).  Points with <2 neighbors get NaN normals.
    ``orient_toward`` (e.g. the camera origin) flips each normal to face it.
    """
    pts = np.asarray(points, np.float64)
    n = len(pts)
    src, dst = _neighbor_pairs(pts, radius)
    # accumulate neighborhood first/second moments (including self)
    counts = np.bincount(src, minlength=n).astype(np.float64) + 1.0
    sums = pts.copy()
    np.add.at(sums, src, pts[dst])
    means = sums / counts[:, None]
    outer = pts[:, :, None] * pts[:, None, :]
    acc = outer.copy()
    np.add.at(acc, src, pts[dst, :, None] * pts[dst, None, :])
    cov = acc / counts[:, None, None] - means[:, :, None] * means[:, None, :]
    normals = np.full((n, 3), np.nan)
    enough = counts >= 3.0  # self + >=2 neighbors spans a plane
    if enough.any():
        # eigh on the stack of 3x3 covariances; smallest eigenvector = normal
        w, v = np.linalg.eigh(cov[enough])
        nrm = v[:, :, 0]
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        normals[enough] = nrm
    if orient_toward is not None:
        to_view = np.asarray(orient_toward, np.float64) - pts
        flip = np.einsum("ij,ij->i", normals, to_view) < 0
        normals[flip & ~np.isnan(normals[:, 0])] *= -1
    return normals


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------

def _nearest_neighbors(query: np.ndarray, target: np.ndarray,
                       max_dist: float) -> Tuple[np.ndarray, np.ndarray]:
    """Index of the nearest target point within max_dist for each query
    point (or -1).  Grid hash at cell = max_dist over the combined cloud."""
    nq, nt = len(query), len(target)
    both = np.concatenate([query, target])
    src, dst = _neighbor_pairs(both, max_dist)
    # keep only query -> target edges
    sel = (src < nq) & (dst >= nq)
    qi, ti = src[sel], dst[sel] - nq
    d2 = np.sum((query[qi] - target[ti]) ** 2, axis=1)
    best = np.full(nq, -1, np.int64)
    best_d2 = np.full(nq, np.inf)
    # per-query argmin via sort (stable lexicographic by (qi, d2))
    order = np.lexsort((d2, qi))
    qi_s, ti_s, d2_s = qi[order], ti[order], d2[order]
    first = np.ones(len(qi_s), bool)
    first[1:] = qi_s[1:] != qi_s[:-1]
    best[qi_s[first]] = ti_s[first]
    best_d2[qi_s[first]] = d2_s[first]
    return best, np.sqrt(best_d2)


def icp_point_to_point(source: np.ndarray, target: np.ndarray,
                       max_correspondence_distance: float,
                       init: Optional[np.ndarray] = None,
                       max_iterations: int = 30,
                       tolerance: float = 1e-7) -> dict:
    """Point-to-point ICP (``pcl::IterativeClosestPoint`` semantics).

    Each sweep pairs every transformed source point with its nearest target
    point inside ``max_correspondence_distance`` and solves the pairing's
    rigid alignment in closed form (Kabsch/SVD, reflection-guarded).  Stops
    when the inlier RMSE improves by less than ``tolerance``.

    Returns ``{"transform": T (4x4 source->target), "rmse": float,
    "num_correspondences": int, "iterations": int}``.
    """
    src = np.asarray(source, np.float64)
    tgt = np.asarray(target, np.float64)
    T = np.eye(4) if init is None else np.asarray(init, np.float64).copy()
    prev_rmse = np.inf
    rmse, ncorr, it = np.inf, 0, 0
    for it in range(1, max_iterations + 1):
        moved = src @ T[:3, :3].T + T[:3, 3]
        nn, dist = _nearest_neighbors(moved, tgt,
                                      max_correspondence_distance)
        ok = nn >= 0
        ncorr = int(ok.sum())
        if ncorr < 3:
            break
        p = moved[ok]
        q = tgt[nn[ok]]
        rmse = float(np.sqrt(np.mean(dist[ok] ** 2)))
        # Kabsch: rotation aligning centered p onto centered q
        pc, qc = p.mean(axis=0), q.mean(axis=0)
        h = (p - pc).T @ (q - qc)
        u, _, vt = np.linalg.svd(h)
        sign = np.sign(np.linalg.det(vt.T @ u.T))
        d = np.diag([1.0, 1.0, sign])
        r = vt.T @ d @ u.T
        t = qc - r @ pc
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = r, t
        T = step @ T
        if abs(prev_rmse - rmse) < tolerance:
            break
        prev_rmse = rmse
    return {"transform": T, "rmse": rmse,
            "num_correspondences": ncorr, "iterations": it}


# ---------------------------------------------------------------------------
# crop primitives (director_utils.py:151-180)
# ---------------------------------------------------------------------------

def crop_to_line_segment(points: np.ndarray, point1, point2
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep points whose projection onto segment p1->p2 lies within it
    (``director_utils.cropToLineSegment``, the primitive ``cropToBox``
    applies once per box axis).  Returns (filtered_points, keep_mask)."""
    pts = np.asarray(points, np.float64)
    p1 = np.asarray(point1, np.float64)
    p2 = np.asarray(point2, np.float64)
    line = p2 - p1
    length = np.linalg.norm(line)
    if length < 1e-12:
        raise ValueError("degenerate segment")
    along = (pts - p1) @ (line / length)
    keep = (along >= 0.0) & (along <= length)
    return pts[keep], keep
