"""The port's preprocessing pipeline (pdc_tpu_torch.pipeline: renderer,
change_detection, fusion_reconstruction, segmentation, preprocessing, and
``python -m pdc_tpu_torch preprocess``) against pdc_tpu.pipeline on the
CPU, at 48x64 with synthetic scenes and their fusion meshes.

Tolerances. Depths, masks and millimetre PNGs are held bit for bit: the
port computes the projection and the fragment geometry in the rounding of
XLA's CPU code, and a z-buffer minimum does not depend on the order of its
updates (measured: 0 differing pixels on every route). A route's
difference is still counted pixel by pixel before the assertion, so a
future edge tie shows as a count. The host metrics (face counts, bins,
extents, tiles, crop boxes, segmentation) are the same numpy code: equal.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdc_tpu.pipeline.change_detection as jcd
import pdc_tpu.pipeline.fusion_reconstruction as jfusion
import pdc_tpu.pipeline.renderer as jr
import pdc_tpu.pipeline.segmentation as jseg
from pdc_tpu.data.synthetic import SyntheticScene as JaxSyntheticScene
from pdc_tpu_torch.data.native_loader import KIND_GRAY16, KIND_MASK8, decode_batch
from pdc_tpu_torch.data.synthetic import SyntheticScene
from pdc_tpu_torch.pipeline import change_detection as cd
from pdc_tpu_torch.pipeline import fusion_reconstruction as fusion
from pdc_tpu_torch.pipeline import preprocessing as pre
from pdc_tpu_torch.pipeline import renderer as pr
from pdc_tpu_torch.pipeline import segmentation as seg

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """These tests write scene trees and fusion meshes: remove them when the test ends, so that a
    whole run leaves no large files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


H, W = 48, 64
CPU = "cpu"


@pytest.fixture(scope="module")
def scene():
    """A synthetic scene's mesh at two resolutions, its 6 poses and K."""
    sc = JaxSyntheticScene(width=W, height=H, num_frames=6)
    _, _, mask, poses = sc.render_all()
    coarse = sc.fusion_mesh()
    fine = sc.fusion_mesh(plane_step=0.05, object_step=0.02)
    return dict(coarse=coarse, fine=fine, poses=poses.astype(np.float32),
                K=sc.K.astype(np.float32), mask=mask, points=sc.fusion_points())


def _equal(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    differ = int((got != want).sum())
    assert differ == 0, f"{what}: {differ} of {want.size} values differ"


# -- (v) the renderer ------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["coarse", "fine"])
def test_mesh_routes_equal_jax(scene, mesh):
    verts, faces = scene[mesh]
    poses, K = scene["poses"], scene["K"]
    want = np.asarray(jr.render_depth_from_mesh_sorted_many(verts, faces, poses, K, H, W))
    assert (want > 0).mean() > 0.5
    _equal(pr.render_depth_from_mesh_sorted_many(verts, faces, poses, K, H, W, device=CPU),
           want, "sorted")
    _equal(pr.render_depth_from_mesh_binned_many(verts, faces, poses, K, H, W, device=CPU),
           np.asarray(jr.render_depth_from_mesh_binned_many(verts, faces, poses, K, H, W)),
           "binned")
    tile = jr.pick_raster_tile(verts, faces, poses, K, H, W)
    assert tile == pr.pick_raster_tile(verts, faces, poses, K, H, W)
    jm = np.asarray(jr.render_depth_from_mesh_many(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(poses), jnp.asarray(K), H, W,
        tile=tile, chunk=1000))
    _equal(pr.render_depth_from_mesh_many(verts, faces, poses, K, H, W, tile=tile, chunk=1000,
                                          device=CPU), jm, "many")
    _equal(pr.render_depth_from_mesh(verts, faces, poses[2], K, H, W, tile=tile, device=CPU),
           np.asarray(jr.render_depth_from_mesh(verts, faces, poses[2], K, H, W, tile=tile)),
           "one pose")
    # over the fragment budget the sorted route takes the binned one: the same depths
    _equal(pr.render_depth_from_mesh_sorted_many(verts, faces, poses, K, H, W,
                                                 max_fragments=10, device=CPU), want,
           "sorted over budget")


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_point_routes_equal_jax(scene, radius):
    pts, poses, K = scene["points"], scene["poses"], scene["K"]
    want = np.asarray(jr.render_depth_from_points_many(
        jnp.asarray(pts), jnp.asarray(poses), jnp.asarray(K), H, W, splat_radius=radius))
    _equal(pr.render_depth_from_points_many(pts, poses, K, H, W, radius, device=CPU), want,
           "points")
    _equal(pr.render_depth_from_points_sorted_many(pts, poses, K, H, W, radius, device=CPU),
           np.asarray(jr.render_depth_from_points_sorted_many(pts, poses, K, H, W, radius)),
           "points sorted")
    _equal(pr.render_depth_from_points(pts, poses[1], K, H, W, radius, device=CPU),
           np.asarray(jr.render_depth_from_points(jnp.asarray(pts), jnp.asarray(poses[1]),
                                                  jnp.asarray(K), H, W, splat_radius=radius)),
           "points one pose")


def test_scene_products_equal_jax(scene):
    verts, faces = scene["fine"]
    poses, K = scene["poses"], scene["K"]
    box = jcd.fit_crop_box(verts)
    fg = faces[np.any(box.contains(verts)[faces], axis=1)]
    assert 0 < len(fg) < len(faces)
    want = jr.render_scene_products(verts, fg, faces, poses, K, H, W, 1000.0)
    got = pr.render_scene_products(verts, fg, faces, poses, K, H, W, 1000.0, device=CPU)
    for g, w, what in zip(got, want, ("mask", "depth_cropped_mm", "depth_full_mm")):
        _equal(g, w, what)
    assert want[0].any() and (want[1] > 0).any()
    # the packed buffer itself: the JAX package's uint16 layout
    packed_j = np.asarray(jr.render_scene_products_start(verts, fg, faces, poses, K, H, W,
                                                         1000.0))
    packed = pr.render_scene_products_start(verts, fg, faces, poses, K, H, W, 1000.0,
                                            device=CPU)
    assert packed.dtype == torch.int16
    _equal(packed.numpy().view(np.uint16), packed_j, "packed")
    for g, w in zip(pr.unpack_scene_products(packed, H, W),
                    jr.unpack_scene_products(packed_j, H, W)):
        _equal(g, w, "unpacked")
    assert pr.render_scene_products_start(verts, fg, faces, poses, K, H, W, 1000.0,
                                          max_fragments=10, device=CPU) is None
    # the sharded renderer is ported: on a mesh of one process it equals the
    # unsharded one (tests/test_torch_port_parallel.py holds 2 gloo ranks)
    from pdc_tpu_torch.parallel.mesh import make_mesh

    for g, w, what in zip(pr.render_scene_products_sharded(
            verts, fg, faces, poses, K, H, W, 1000.0, make_mesh(device=CPU)), want,
            ("mask", "depth_cropped_mm", "depth_full_mm")):
        _equal(g, w, "sharded " + what)


def test_host_metrics_equal_jax(scene):
    verts, faces = scene["fine"]
    poses, K = scene["poses"], scene["K"]
    np.testing.assert_array_equal(
        pr.projected_face_pixel_counts(verts, faces, poses[0], K, H, W),
        jr.projected_face_pixel_counts(verts, faces, poses[0], K, H, W))
    np.testing.assert_array_equal(pr.projected_face_extents(verts, faces, poses[3], K, H, W),
                                  jr.projected_face_extents(verts, faces, poses[3], K, H, W))
    for got, want in zip(pr.bin_faces_by_extent(verts, faces, poses, K, H, W),
                         jr.bin_faces_by_extent(verts, faces, poses, K, H, W)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    got, want = (m.prepare_sorted_render(verts, faces, poses, K, H, W) for m in (pr, jr))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2]
    # nothing in view: one sentinel bin, and black depths
    away = np.eye(4, dtype=np.float32)
    away[:3, 3] = (0.0, 0.0, 50.0)
    empty = pr.prepare_sorted_render(verts, faces, away, K, H, W)
    assert len(empty) == 1 and empty[0][1].shape == (1, 1)
    assert not pr.render_depth_from_mesh_sorted_many(verts, faces, away, K, H, W,
                                                     device=CPU).any()


@pytest.mark.parametrize("binary", [False, True])
def test_read_ply_mesh_equals_jax(tmp_path, scene, binary):
    verts, faces = scene["coarse"]
    path = str(tmp_path / "mesh.ply")
    with open(path, "wb") as f:
        head = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
                f"element vertex {len(verts)}", "property float x", "property float y",
                "property float z", "property uchar red", f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(head) + "\n").encode())
        if binary:
            v = np.zeros(len(verts), [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("r", "u1")])
            v["x"], v["y"], v["z"] = verts.T
            f.write(v.tobytes())
            fa = np.zeros(len(faces), [("n", "u1"), ("i", "<i4", (3,))])
            fa["n"], fa["i"] = 3, faces
            f.write(fa.tobytes())
        else:
            f.write("".join(f"{x} {y} {z} 7\n" for x, y, z in verts.tolist()).encode())
            f.write("".join(f"3 {a} {b} {c}\n" for a, b, c in faces.tolist()).encode())
    got, want = pr.read_ply_mesh(path), jr.read_ply_mesh(path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    np.testing.assert_array_equal(pr.mesh_vertices_from_ply(path),
                                  jr.mesh_vertices_from_ply(path))


def test_renderer_needs_cuda_unless_cpu_is_asked(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces = scene["coarse"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pr.render_depth_from_mesh_sorted_many(verts, faces, scene["poses"], scene["K"], H, W)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cd.ChangeDetection(verts, scene["K"], H, W, faces=faces)


# -- (vi) change detection and crop boxes ------------------------------------------------------


def test_mask_rules_equal_jax():
    rng = np.random.default_rng(0)
    f = np.where(rng.random((H, W)) < 0.3, 0.0, rng.uniform(0.5, 2.0, (H, W)))
    b = np.where(rng.random((H, W)) < 0.3, 0.0, rng.uniform(0.5, 2.0, (H, W)))
    for th in (0.0, 0.01, 0.3):
        np.testing.assert_array_equal(
            cd.compute_foreground_mask_from_depth_image_pair(f, b, th),
            jcd.compute_foreground_mask_from_depth_image_pair(f, b, th))
    np.testing.assert_array_equal(cd.compute_foreground_mask_using_crop_strategy(f),
                                  jcd.compute_foreground_mask_using_crop_strategy(f))


def test_crop_boxes_and_station_config_in_and_out(tmp_path, scene):
    from pdc_tpu.utils.yaml_io import load_yaml as jax_load_yaml
    from pdc_tpu.utils.yaml_io import save_yaml as jax_save_yaml
    from pdc_tpu_torch.utils.yaml_io import load_yaml, save_yaml

    verts = scene["fine"][0]
    box, jbox = cd.fit_crop_box(verts), jcd.fit_crop_box(verts)
    np.testing.assert_array_equal(box.transform, jbox.transform)
    assert box.dimensions == jbox.dimensions
    # a posed box, and points on and around its faces
    theta = 0.3
    T = np.eye(4)
    T[:3, :3] = [[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                 [0, 0, 1]]
    T[:3, 3] = (0.05, -0.02, 0.03)
    posed = cd.OrientedCropBox(T, (0.3, 0.2, 0.1))
    jposed = jcd.OrientedCropBox(T, (0.3, 0.2, 0.1))
    rng = np.random.default_rng(1)
    local = rng.uniform(-0.2, 0.2, (20000, 3)) * np.array([1.0, 0.7, 0.35])
    local[:2000, 0] = 0.15  # on a face, where float32 rounding decides
    pts = (local @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    inside = posed.contains(pts)
    np.testing.assert_array_equal(inside, jposed.contains(pts))
    assert 0 < inside.sum() < len(pts)
    np.testing.assert_array_equal(posed.filter(pts), jposed.filter(pts))
    axis = cd.CropBox((-0.1, -0.1, 0.0), (0.1, 0.1, 0.05))
    np.testing.assert_array_equal(axis.contains(pts), jcd.CropBox(
        (-0.1, -0.1, 0.0), (0.1, 0.1, 0.05)).contains(pts))
    np.testing.assert_array_equal(axis.filter(pts), jcd.CropBox(
        (-0.1, -0.1, 0.0), (0.1, 0.1, 0.05)).filter(pts))

    # station config out of the port, into pdc_tpu, and back
    cfg = posed.to_station_config()
    assert cfg == jposed.to_station_config()
    save_yaml(cfg, str(tmp_path / "port.yaml"))
    again = jcd.OrientedCropBox.from_station_config(jax_load_yaml(str(tmp_path / "port.yaml")))
    np.testing.assert_allclose(again.transform, T, atol=1e-12)
    jax_save_yaml(jposed.to_station_config(), str(tmp_path / "jax.yaml"))
    back = cd.OrientedCropBox.from_station_config(load_yaml(str(tmp_path / "jax.yaml")))
    np.testing.assert_array_equal(back.transform, again.transform)
    assert back.dimensions == again.dimensions == (0.3, 0.2, 0.1)


def _scene_dir(tmp_path, name, seed=4, frames=3):
    d = tmp_path / name / "scene"
    SyntheticScene(width=W, height=H, num_frames=frames, seed=seed).write_scene(str(d))
    return str(d / "processed")


def _read_pngs(structure, indices, kinds=("mask", "depth_cropped", "depth")):
    out = {}
    for k in kinds:
        for i in indices:
            if k == "mask":
                path, kind = os.path.join(structure.masks_dir, "%06d_mask.png" % i), KIND_MASK8
                arr = np.zeros((H, W), np.uint8)
            else:
                path = os.path.join(structure.rendered_images_dir, f"%06d_{k}.png" % i)
                kind, arr = KIND_GRAY16, np.zeros((H, W), np.uint16)
            decode_batch([(path, kind, arr)], H, W)
            out[k, i] = arr
    return out


@pytest.mark.parametrize("flow", ["process_scene", "two_pass", "start_finish"])
def test_change_detection_writes_what_jax_writes(tmp_path, flow):
    """Both packages on copies of one scene: the same PNG arrays, from each
    flow (the fused program, the two-pass fallback, and start/finish)."""
    port_dir = _scene_dir(tmp_path, "port")
    jax_dir = str(tmp_path / "jax")
    shutil.copytree(os.path.dirname(os.path.dirname(port_dir)), jax_dir)
    jax_dir = os.path.join(jax_dir, "scene", "processed")
    c, structure = cd.ChangeDetection.from_data_folder(port_dir, device=CPU)
    jc, jstructure = jcd.ChangeDetection.from_data_folder(jax_dir)
    c.set_crop_box(cd.fit_crop_box(c.points))
    jc.set_crop_box(jcd.fit_crop_box(jc.points))
    np.testing.assert_array_equal(c._fg_faces, jc._fg_faces)
    if flow == "process_scene":
        n, jn = c.process_scene(structure), jc.process_scene(jstructure)
    elif flow == "two_pass":
        n, jn = c.process_scene_two_pass(structure), jc.process_scene_two_pass(jstructure)
    else:
        handle = c.process_scene_start(structure)
        assert isinstance(handle["out"], torch.Tensor)
        n, jn = c.process_scene_finish(handle), jc.process_scene(jstructure)
    assert n == jn == 3
    got, want = _read_pngs(structure, range(3)), _read_pngs(jstructure, range(3))
    for key in want:
        _equal(got[key], want[key], key)
    assert any(got["mask", i].any() for i in range(3))


def test_change_detection_per_frame_points_and_pair_strategy(scene):
    verts, faces = scene["coarse"]
    poses, K = scene["poses"], scene["K"]
    box = jcd.fit_crop_box(verts)
    c = cd.ChangeDetection(verts, K, H, W, faces=faces, device=CPU)
    jc = jcd.ChangeDetection(verts, K, H, W, faces=faces)
    _equal(c.render_depth(poses[1]), jc.render_depth(poses[1]), "render_depth")
    c.set_crop_box(cd.OrientedCropBox(box.transform, box.dimensions))
    jc.set_crop_box(box)
    for g, w in zip(c.compute_mask(poses[2]), jc.compute_mask(poses[2])):
        _equal(g, w, "compute_mask")
    # a fixed tile, then points only, then the depth-pair strategy
    for kw in ({"faces": faces, "raster_tile": 16}, {}, {"background_points": verts[::2]}):
        c = cd.ChangeDetection(verts, K, H, W, device=CPU, **kw)
        jc = jcd.ChangeDetection(verts, K, H, W, **kw)
        if "background_points" not in kw:
            c.set_crop_box(cd.OrientedCropBox(box.transform, box.dimensions))
            jc.set_crop_box(box)
        for g, w in zip(c.compute_masks(poses), jc.compute_masks(poses)):
            _equal(g, w, str(sorted(kw)))
        assert c.process_scene_start(None, pose_map={0: poses[0]}) is None


def test_over_budget_goes_to_two_pass_once(tmp_path, monkeypatch):
    root = tmp_path / "logs"
    SyntheticScene(width=W, height=H, num_frames=3, seed=2).write_scene(str(root / "scene_hot"))
    calls = []
    real = pr.render_scene_products_start

    def over_budget(*args, **kwargs):
        calls.append(1)
        return real(*args, **{**kwargs, "max_fragments": 0})

    monkeypatch.setattr(pr, "render_scene_products_start", over_budget)
    c, structure = cd.ChangeDetection.from_data_folder(str(root / "scene_hot" / "processed"),
                                                       device=CPU)
    c.set_crop_box(cd.fit_crop_box(c.points))
    assert c.process_scene_start(structure) is cd.ChangeDetection.OVER_BUDGET
    calls.clear()
    assert list(pre.run_change_detection_pipeline(str(root), redo=True,
                                                  device=CPU).values()) == [3]
    assert len(calls) == 1


# -- fused-scene access ---------------------------------------------------------------------------


def test_tsdf_reconstruction_equals_jax(tmp_path):
    processed = _scene_dir(tmp_path, "tsdf", seed=3, frames=2)
    r = fusion.TSDFReconstruction.from_data_folder(processed, device=CPU)
    jrec = jfusion.TSDFReconstruction.from_data_folder(processed)
    assert r.poses.indices == jrec.poses.indices == [0, 1] and len(r.poses) == 2
    np.testing.assert_array_equal(r.get_camera_to_world(1), jrec.get_camera_to_world(1))
    np.testing.assert_array_equal(r.all_points, jrec.all_points)
    box = jcd.fit_crop_box(r.all_points)
    for rec in (r, jrec):
        rec.crop_box = box
    r.crop_box = cd.OrientedCropBox(box.transform, box.dimensions)
    np.testing.assert_array_equal(r.points, jrec.points)
    for cropped in (False, True):
        _equal(r.render_depth(1, cropped=cropped), jrec.render_depth(1, cropped=cropped),
               f"cropped={cropped}")
    points_only = fusion.TSDFReconstruction(r.all_points, r.poses, r.intrinsics, device=CPU)
    jpoints = jfusion.TSDFReconstruction(r.all_points, jrec.poses, jrec.intrinsics)
    _equal(points_only.render_depth(0), jpoints.render_depth(0), "points")
    assert fusion.FusionReconstruction is fusion.TSDFReconstruction
    with pytest.raises(FileNotFoundError):
        fusion.TSDFReconstruction.from_data_folder(str(tmp_path / "nowhere"), device=CPU)


# -- (vii) segmentation ------------------------------------------------------------------------


def _cloud(seed=0):
    rng = np.random.default_rng(seed)
    table = np.c_[rng.uniform(-0.5, 0.5, (3000, 2)), rng.normal(0, 0.002, 3000)]
    blob = rng.normal((0.1, 0.0, 0.08), 0.02, (600, 3))
    blob2 = rng.normal((-0.2, 0.2, 0.06), 0.015, (300, 3))
    return np.concatenate([table, blob, blob2, rng.uniform(-0.5, 0.5, (20, 3))])


@pytest.mark.parametrize("name", ["voxel_down_sample", "fit_plane_ransac",
                                  "refine_plane_least_squares", "segment_table",
                                  "euclidean_cluster", "remove_radius_outliers",
                                  "estimate_normals", "icp_point_to_point",
                                  "crop_to_line_segment"])
def test_segmentation_equals_jax(name):
    pts = _cloud()
    angle = 0.05
    R = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                  [0, 0, 1]])
    args = {"voxel_down_sample": (pts, 0.03),
            "fit_plane_ransac": (pts,),
            "refine_plane_least_squares": (pts[:3000],),
            "segment_table": (pts,),
            "euclidean_cluster": (pts[3000:], 0.02),
            "remove_radius_outliers": (pts, 0.02, 3),
            "estimate_normals": (pts[::3], 0.05, np.zeros(3) + [0, 0, 1.0]),
            "icp_point_to_point": (pts[3000:3600], pts[3000:3600] @ R.T + 0.01, 0.05),
            "crop_to_line_segment": (pts, (-0.3, 0, 0), (0.3, 0.1, 0.1))}[name]
    kwargs = {"fit_plane_ransac": {"seed": 5}, "segment_table": {"seed": 7},
              "euclidean_cluster": {"min_cluster_size": 50}}.get(name, {})
    got = getattr(seg, name)(*args, **kwargs)
    want = getattr(jseg, name)(*args, **kwargs)
    flat_g = got if isinstance(got, (tuple, list)) else (
        [got[k] for k in sorted(got)] if isinstance(got, dict) else [got])
    flat_w = want if isinstance(want, (tuple, list)) else (
        [want[k] for k in sorted(want)] if isinstance(want, dict) else [want])
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert seg.__all__ == jseg.__all__


def test_segmentation_edge_cases_equal_jax():
    pts = _cloud(1)
    bad = pts.copy()
    bad[5] = np.nan
    np.testing.assert_array_equal(seg.euclidean_cluster(bad, 0.02),
                                  jseg.euclidean_cluster(bad, 0.02))
    np.testing.assert_array_equal(seg.voxel_down_sample(bad, 0.05),
                                  jseg.voxel_down_sample(bad, 0.05))
    assert seg.voxel_down_sample(np.zeros((0, 3)), 0.1).shape == (0, 3)
    with pytest.raises(ValueError, match="degenerate"):
        seg.fit_plane_ransac(np.zeros((10, 3)))
    with pytest.raises(ValueError, match="max_pairs"):
        seg._neighbor_pairs(pts, 10.0, max_pairs=1000)
    with pytest.raises(ValueError, match="degenerate segment"):
        seg.crop_to_line_segment(pts, (0, 0, 0), (0, 0, 0))


# -- (viii) the command -----------------------------------------------------------------------


def test_preprocess_command_equals_pdc_tpu(tmp_path, capsys):
    """``python -m pdc_tpu_torch preprocess --device cpu`` on a tree of two
    scenes against ``python -m pdc_tpu preprocess`` on a copy: both skip
    scenes that have masks, and with ``--redo`` write the same PNG arrays
    and the same fitted crop boxes; ``--no_depth`` leaves the full depth."""
    from pdc_tpu import __main__ as jax_cli
    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.data.scene import SceneStructure
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    logs = tmp_path / "port" / "logs_proto"
    for i in range(2):
        SyntheticScene(width=W, height=H, num_frames=3, seed=i).write_scene(
            str(logs / f"scene_{i}"))
    jlogs = tmp_path / "jax" / "logs_proto"
    shutil.copytree(logs, jlogs)
    assert cli.main(["preprocess", "--data_dir", str(logs), "--device", "cpu"]) == 0
    jax_cli.main(["preprocess", "--data_dir", str(jlogs)])
    out = capsys.readouterr().out
    assert out.count("processed 0 scenes (2 already done)") == 2
    assert not os.path.exists(logs / "scene_0" / "processed" / "crop_box.yaml")

    before = _read_pngs(SceneStructure(str(logs / "scene_1" / "processed")), range(3),
                        ("depth",))
    assert cli.main(["preprocess", "--data_dir", str(logs), "--device", "cpu", "--redo"]) == 0
    jax_cli.main(["preprocess", "--data_dir", str(jlogs), "--redo"])
    assert capsys.readouterr().out.count("processed 2 scenes (0 already done)") == 2
    for i in range(2):
        s = SceneStructure(str(logs / f"scene_{i}" / "processed"))
        js = SceneStructure(str(jlogs / f"scene_{i}" / "processed"))
        got, want = _read_pngs(s, range(3)), _read_pngs(js, range(3))
        for key in want:
            _equal(got[key], want[key], (i,) + key)
        assert load_yaml(os.path.join(s.processed_folder, "crop_box.yaml")) == load_yaml(
            os.path.join(js.processed_folder, "crop_box.yaml"))
    # the re-rendered depth is the mesh's, not the synthetic renderer's
    after = _read_pngs(SceneStructure(str(logs / "scene_1" / "processed")), range(3),
                       ("depth",))
    assert any(not np.array_equal(after[k], before[k]) for k in before)

    # a station config, and no full depth
    station = tmp_path / "station.yaml"
    from pdc_tpu_torch.utils.yaml_io import save_yaml

    save_yaml(cd.OrientedCropBox(np.eye(4), (0.8, 0.8, 0.2)).to_station_config(), str(station))
    for d in (logs, jlogs):
        for i in range(2):
            os.remove(d / f"scene_{i}" / "processed" / "rendered_images" / "000001_depth.png")
    assert cli.main(["preprocess", "--data_dir", str(logs), "--device", "cpu", "--redo",
                     "--no_depth", "--config_file", str(station)]) == 0
    jax_cli.main(["preprocess", "--data_dir", str(jlogs), "--redo", "--no_depth",
                  "--config_file", str(station)])
    for i in range(2):
        s = SceneStructure(str(logs / f"scene_{i}" / "processed"))
        js = SceneStructure(str(jlogs / f"scene_{i}" / "processed"))
        assert not os.path.exists(os.path.join(s.rendered_images_dir, "000001_depth.png"))
        got, want = (_read_pngs(x, range(3), ("mask", "depth_cropped")) for x in (s, js))
        for key in want:
            _equal(got[key], want[key], ("station", i) + key)


def test_preprocess_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    from pdc_tpu_torch import __main__ as cli

    SyntheticScene(width=W, height=H, num_frames=2).write_scene(str(tmp_path / "s"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["preprocess", "--data_dir", str(tmp_path), "--redo"])
    with pytest.raises(ValueError, match="run fusion"):
        os.makedirs(tmp_path / "unfused")
        pre.discover_processed_scenes(str(tmp_path))
