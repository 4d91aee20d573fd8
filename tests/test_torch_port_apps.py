"""The port's apps (pdc_tpu_torch.apps, geom/view_utils, ops/plotter)
against pdc_tpu, on the CPU at 64x48 with ResNet-18-8s, D=3 (weights carried
across by models/convert.py, so both packages run the same network).

Tolerances, and why:

  * 1e-12 on view_utils: the same float64 numpy operations;
  * equality on file names, annotation entries, figure pixels, the
    grasp stream's picks (but float64 near-ties, below), PNG pixels that do
    not depend on the network, masks and observation counts;
  * FWD = 1e-4 of the descriptors' scale where a number comes out of the two
    packages' networks: their CPU forwards agree within 2e-5 of that scale
    (tests/test_torch_port_dcn.py); a descriptor PNG may then differ by one
    level where a value sits on a level boundary;
  * 1e-6 with one fixed descriptor function in both packages (as
    tests/test_pipeline.py:128-146 does): the same float32 operations;
  * the grasp stream's distance: within 1e-5 of float64 (the port's
    difference form) and 1e-2 of pdc_tpu's (its expanded form cancels near
    zero, ROADMAP F1; tests/test_pipeline.py:165). Where the two packages
    pick other pixels, the picks' float64 squared distances on the port's
    descriptor image differ by no more than the expanded form's rounding
    (8 ulps of the largest ``|r|^2`` plus ``|q|^2``) plus what the two
    networks' difference can move a squared distance.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pdc_tpu.apps import annotate_correspondences as j_annotate
from pdc_tpu.apps import compute_descriptor_images as j_cdi
from pdc_tpu.apps import debug_visualization as j_debug
from pdc_tpu.apps import live_heatmap_visualization as j_live
from pdc_tpu.apps import make_descriptor_video as j_video
from pdc_tpu.apps import mesh_descriptors as j_mesh
from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.data.dataset import SceneData as JaxSceneData
from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset
from pdc_tpu.geom import view_utils as j_view
from pdc_tpu.geom.camera import CameraIntrinsics as JaxCameraIntrinsics
from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu.ops import plotter as j_plotter
from pdc_tpu_torch import __main__ as cli
from pdc_tpu_torch.apps import annotate_correspondences as annotate
from pdc_tpu_torch.apps import compute_descriptor_images as cdi
from pdc_tpu_torch.apps import debug_visualization as debug
from pdc_tpu_torch.apps import live_heatmap_visualization as live
from pdc_tpu_torch.apps import make_descriptor_video as video
from pdc_tpu_torch.apps import mesh_descriptors as mesh
from pdc_tpu_torch.data import native_loader
from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.data.dataset import SceneData, SpartanDataset
from pdc_tpu_torch.data.synthetic import SyntheticScene
from pdc_tpu_torch.geom import view_utils
from pdc_tpu_torch.geom.camera import CameraIntrinsics
from pdc_tpu_torch.models.convert import flax_to_state_dict
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.ops import best_match as bm
from pdc_tpu_torch.ops import plotter
from pdc_tpu_torch.utils.yaml_io import load_yaml, save_yaml

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """The apps' tests write model folders, scene trees and their outputs: remove them when the
    test ends, so that a whole run leaves no large files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


W, H, D = 64, 48, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "fixtures", "goldens")
SYNTH = dict(num_scenes=2, num_objects=2, width=W, height=H, num_frames=4, object_radius=0.3)
NET_CFG = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
FWD = 1e-4
F32_EPS = 2.0 ** -23
MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def nets():
    jdcn = JaxDCN.from_config(NET_CFG, rng=jax.random.PRNGKey(3))
    dcn = DenseCorrespondenceNetwork.from_config(jdcn.config, device="cpu")
    dcn.module.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jdcn.variables)))
    return jdcn, dcn


@pytest.fixture(scope="module")
def datasets():
    return JaxSpartanDataset.make_synthetic(**SYNTH), SpartanDataset.make_synthetic(**SYNTH)


@pytest.fixture(scope="module")
def folder(nets, tmp_path_factory):
    """A model folder the port wrote: training.yaml, 000000.ckpt and
    descriptor statistics (removed with the module)."""
    _, dcn = nets
    root = tmp_path_factory.mktemp("models")
    path = str(root / "net")
    os.makedirs(path)
    save_yaml({"dense_correspondence_network": NET_CFG}, os.path.join(path, "training.yaml"))
    dcn.save_checkpoint(os.path.join(path, "000000.ckpt"))
    res = dcn.forward_on_images(np.stack([SyntheticScene(**_scene_kw(0)).render(i)[0]
                                          for i in range(2)])).numpy()
    entry = {"min": res.min(axis=(0, 1, 2)).tolist(), "max": res.max(axis=(0, 1, 2)).tolist(),
             "mean": res.mean(axis=(0, 1, 2)).tolist(), "std": res.std(axis=(0, 1, 2)).tolist()}
    save_yaml({"entire_image": entry, "mask_image": entry, "background_image": entry},
              os.path.join(path, "descriptor_statistics.yaml"))
    yield path
    shutil.rmtree(root, ignore_errors=True)


def _scene_kw(seed):
    return dict(width=W, height=H, num_frames=4, object_radius=0.3, seed=seed, texture_seed=seed)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two scenes in the pdc layout and a composite config naming them
    (removed with the module)."""
    root = tmp_path_factory.mktemp("data")
    for i in range(2):
        SyntheticScene(**_scene_kw(i)).write_scene(str(root / "logs_proto" / f"scene_{i}"))
    save_yaml({"object_id": "disc", "train": ["scene_0", "scene_1"], "test": ["scene_1"]},
              str(root / "config" / "disc.yaml"))
    composite = str(root / "config" / "composite.yaml")
    save_yaml({"logs_root_path": "logs_proto", "single_object_scenes_config_files": ["disc.yaml"]},
              composite)
    yield {"root": str(root), "composite": composite}
    shutil.rmtree(root, ignore_errors=True)


def _descriptors(x):
    """A fixed descriptor function of normalised images: the same float32
    numbers for both packages."""
    x = np.asarray(x, np.float32)
    m = np.asarray([[0.9, -0.4, 0.3], [0.2, 1.1, -0.5], [-0.6, 0.3, 0.8]], np.float32)
    return (np.sin(x @ m * np.float32(1.7)) * np.float32(2.0) + x).astype(np.float32)


class _FakeJaxNet:
    descriptor_dimension = D
    image_mean = MEAN
    image_std_dev = STD

    def forward_on_img(self, rgb):
        return jnp.asarray(_descriptors((np.asarray(rgb, np.float32) / 255.0 - MEAN) / STD))


class _FakeNet(_FakeJaxNet):
    device = torch.device("cpu")

    def forward_on_img(self, rgb):
        return torch.as_tensor(np.array(super().forward_on_img(rgb)))


def _scale_tol(want):
    return FWD * float(np.abs(want).max())


def _read_png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def _port_decode(path):
    out = np.empty((H, W, 3), np.uint8)
    native_loader.decode_batch([(path, native_loader.KIND_RGB8, out)], H, W, decoder="zlib")
    return out


# -- geom/view_utils and ops/plotter -------------------------------------------------------


def _random_rotation(rng):
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _view_case(mod, intrinsics_cls, case):
    """One case of tests/test_segmentation_toolbox.py:200-255 through
    ``mod``; returns the numbers it computes."""
    if case == "transform_from_pose":
        return mod.transform_from_pose({"quaternion": {"w": 0.9, "x": 0.1, "y": -0.3, "z": 0.2},
                                        "translation": {"x": 1.0, "y": 2.0, "z": 3.0}})
    if case == "round_trip":
        rng = np.random.default_rng(8)
        out = []
        for _ in range(20):
            T = np.eye(4)
            T[:3, :3] = _random_rotation(rng)
            T[:3, 3] = rng.uniform(-2, 2, 3)
            view = mod.view_from_camera_transform(T, focal_distance=1.5)
            out += [view.position, view.focal_point, view.view_up,
                    mod.camera_transform_from_view(view).ravel()]
        return np.concatenate(out)
    if case == "skew_view_up":
        return mod.camera_transform_from_view(mod.ViewCamera(
            position=[0, 0, 0], focal_point=[0, 0, 2], view_up=[0.3, -1.0, 0.4]))
    if case == "view_angle":
        a = mod.focal_length_to_view_angle(528.0, 480)
        return np.array([a, mod.view_angle_to_focal_length(a, 480)])
    cams = [intrinsics_cls(cx=320.0, cy=240.0, fx=528.0, fy=528.0, width=640, height=480),
            intrinsics_cls(cx=330.0, cy=230.0, fx=600.0, fy=500.0, width=640, height=480)]
    out = []
    for cam in cams:
        p = mod.view_params_from_intrinsics(cam)
        out += [*p["window_center"], p["view_angle"], p["aspect_scale"]]
    return np.asarray(out)


@pytest.mark.parametrize("case", ["transform_from_pose", "round_trip", "skew_view_up",
                                  "view_angle", "intrinsics"])
def test_view_utils_equal_jax(case):
    got = _view_case(view_utils, CameraIntrinsics, case)
    want = _view_case(j_view, JaxCameraIntrinsics, case)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_plot_correspondences_direct_draws_the_pixels_of_jax():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scene = SyntheticScene(**_scene_kw(1))
    rgb_a, depth_a, _, _ = scene.render(0)
    rgb_b, depth_b, _, _ = scene.render(1)
    rng = np.random.RandomState(2)
    uv_a = np.stack([rng.randint(0, W, 7), rng.randint(0, H, 7)], -1)
    uv_b = np.stack([rng.randint(0, W, 7), rng.randint(0, H, 7)], -1)
    images = []
    for fn in (plotter.plot_correspondences_direct, j_plotter.plot_correspondences_direct):
        fig, axes = fn(rgb_a, depth_a, rgb_b, depth_b, uv_a, uv_b, show=False)
        fn(rgb_a, depth_a, rgb_b, depth_b, (uv_b[:, 0], uv_b[:, 1]), (uv_a[:, 0], uv_a[:, 1]),
           use_previous_plot=(fig, axes), circ_color="r", show=False)
        fig.canvas.draw()
        images.append(np.asarray(fig.canvas.buffer_rgba()).copy())
        plt.close(fig)
    np.testing.assert_array_equal(images[0], images[1])
    assert (images[0] != 255).any()


# -- annotations ---------------------------------------------------------------------------


def test_annotations_equal_jax_and_read_back(tmp_path, monkeypatch):
    args = [("scene_000", 0, [(10, 12), (30, 20)], "scene_001", 1, [(11, 13), (31, 21)]),
            ("scene_000", 2, [(5, 5)], "scene_000", 3, [(6, 6)]),
            ("scene_001", 3, [], "scene_000", 1, [])]
    anns = [annotate.make_annotation_entry(*a) for a in args]
    assert anns == [j_annotate.make_annotation_entry(*a) for a in args]
    assert annotate.LABEL_COLORS == j_annotate.LABEL_COLORS
    port_file, jax_file = str(tmp_path / "port.yaml"), str(tmp_path / "jax.yaml")
    annotate.save_annotations(anns, port_file)
    j_annotate.save_annotations(anns, jax_file)
    with open(port_file) as f, open(jax_file) as g:
        assert f.read() == g.read()
    assert yaml.safe_load(open(port_file)) == anns
    monkeypatch.setitem(sys.modules, "yaml", None)  # the port's own reader
    assert load_yaml(port_file) == anns


# -- descriptor images ---------------------------------------------------------------------


def _scene_pair(frame_ids):
    """The same frames as a port and a pdc_tpu SceneData, with ``frame_ids``
    as their on-disk file indices."""
    rgb, depth, mask, poses = SyntheticScene(**{**_scene_kw(2), "num_frames": 5}).render_all()
    kw = dict(name="s", rgb=rgb, depth=depth, mask=mask, poses=poses,
              K=SyntheticScene(**_scene_kw(2)).K, frame_ids=frame_ids)
    return SceneData(**kw), JaxSceneData(**kw)


def test_descriptor_images_equal_jax(nets, tmp_path):
    jdcn, dcn = nets
    scene, jscene = _scene_pair(np.asarray([2, 3, 7, 8, 11]))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    timings = {}
    assert cdi.compute_descriptor_images_for_scene(dcn, scene, port_dir, batch_size=2,
                                                   timings=timings) == 5
    assert j_cdi.compute_descriptor_images_for_scene(jdcn, jscene, jax_dir, batch_size=2) == 5
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) == [
        "%06d_descriptor.npy" % i for i in (2, 3, 7, 8, 11)]
    assert set(timings) == {"forward", "save"}
    for name in names:
        got, want = np.load(os.path.join(port_dir, name)), np.load(os.path.join(jax_dir, name))
        assert got.dtype == np.float32 and got.shape == (H, W, D)
        np.testing.assert_allclose(got, want, rtol=FWD, atol=_scale_tol(want))
    # the ragged last batch changes nothing: every frame equals its own forward
    np.testing.assert_allclose(np.load(os.path.join(port_dir, names[-1])),
                               dcn.forward_on_img(scene.rgb[4]).numpy(), rtol=1e-5, atol=1e-5)


def test_descriptor_images_run_writes_the_jax_tree(nets, datasets, folder, tmp_path, monkeypatch):
    jds, ds = datasets
    monkeypatch.chdir(tmp_path)
    assert cdi.run(folder, ds, batch_size=3, device="cpu") == 8
    port = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                  for d, _, fs in os.walk(tmp_path / "descriptor_images_out") for f in fs)
    os.rename(tmp_path / "descriptor_images_out", tmp_path / "port")
    assert j_cdi.run(folder, jds, batch_size=3) == 8
    jax_files = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                       for d, _, fs in os.walk(tmp_path / "descriptor_images_out") for f in fs)
    assert port == jax_files and len(port) == 8
    assert port[0] == os.path.join("descriptor_images_out", "scene_000", "descriptor_images",
                                   "net", "000000_descriptor.npy")


# -- heatmap engine, target panel, grasp stream ----------------------------------------------


def _engine_results(engine_cls, dcns, rgb_a, rgb_b, pixels, variance):
    eng = engine_cls(dcns, variance)
    eng.set_images(rgb_a, rgb_b)
    out = [eng.find_best_match(u, v) for u, v in pixels]
    out += [eng.find_best_match(u, v, reverse=True) for u, v in pixels]
    eng.swap()
    out += [eng.find_best_match(u, v) for u, v in pixels[:2]]
    return [r for rs in out for r in rs]


@pytest.mark.parametrize("variance", [0.03, 0.25])
def test_heatmap_engine_equal_jax_with_one_descriptor_function(datasets, variance):
    _, ds = datasets
    scene = ds.get_scene("scene_000")
    pixels = [(10, 10), (0, 0), (W - 1, H - 1), (33, 20), (5, 40)]
    got = _engine_results(live.HeatmapEngine, [_FakeNet(), _FakeNet()], scene.rgb[0],
                          scene.rgb[2], pixels, variance)
    want = _engine_results(j_live.HeatmapEngine, [_FakeJaxNet(), _FakeJaxNet()], scene.rgb[0],
                           scene.rgb[2], pixels, variance)
    assert len(got) == len(want) == 24
    for (uv, diff, heat), (juv, jdiff, jheat) in zip(got, want):
        assert uv.dtype == np.int32 and heat.shape == (H, W) and heat.dtype == np.float32
        np.testing.assert_array_equal(uv, juv)
        assert abs(diff - jdiff) <= 1e-6
        np.testing.assert_allclose(heat, jheat, rtol=0, atol=1e-6)
    # a pixel against its own image: distance 0 and heat 1 at the best match
    eng = live.HeatmapEngine([_FakeNet()])
    eng.set_images(scene.rgb[0], scene.rgb[0])
    (uv, diff, heat), = eng.find_best_match(10, 10)
    assert diff == 0.0 and heat[uv[1], uv[0]] == 1.0


def test_heatmap_engine_equal_jax_with_the_networks(nets, datasets):
    jdcn, dcn = nets
    _, ds = datasets
    scene = ds.get_scene("scene_001")
    pixels = [(12, 30), (40, 8), (63, 47)]
    got = _engine_results(live.HeatmapEngine, [dcn], scene.rgb[1], scene.rgb[3], pixels, 0.25)
    want = _engine_results(j_live.HeatmapEngine, [jdcn], scene.rgb[1], scene.rgb[3], pixels,
                           0.25)
    res_b = np.asarray(jdcn.forward_on_img(scene.rgb[3]), np.float64)
    for i, ((uv, diff, heat), (juv, jdiff, jheat)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(heat, jheat, rtol=0, atol=FWD)
        assert abs(diff - jdiff) <= _scale_tol(res_b)
        if not np.array_equal(uv, juv):  # a near-tie: the other pick is as close
            nd = -np.log(np.maximum(jheat.astype(np.float64), 1e-300)) * 0.25
            assert abs(nd[uv[1], uv[0]] - nd[juv[1], juv[0]]) <= _scale_tol(res_b), i


def test_compose_target_panel_heat_blend_golden():
    pytest.importorskip("cv2")
    rng = np.random.RandomState(3)
    tgt = rng.randint(0, 255, (24, 32, 3), dtype=np.uint8)
    heat = np.clip(np.abs(rng.randn(24, 32)) * 0.5, 0, 1)
    want = np.load(os.path.join(GOLDEN_DIR, "heat_blend.npz"))["data"]
    got = live.compose_target_panel(tgt, heat, (20, 10))
    np.testing.assert_array_equal(got, want)


def test_compose_target_panel_without_cv2_equals_jax_fallback(monkeypatch):
    rng = np.random.RandomState(4)
    tgt = rng.randint(0, 255, (24, 32, 3), dtype=np.uint8)
    heat = rng.rand(24, 32)
    heat[0, :8] = np.arange(8) / 255.0 + 0.5 / 255.0  # blends that land on .5
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = live.compose_target_panel(tgt, heat, (20, 10))
    want = j_live.compose_target_panel(tgt, heat, (20, 10))
    np.testing.assert_array_equal(got, want)
    # rounds half up, as pdc_tpu's fallback does (not cv2's half to even)
    half = np.floor(0.5 * tgt.astype(np.float64)
                    + 0.5 * (np.stack([heat] * 3, -1) * 255).astype(np.uint8) + 0.5)
    np.testing.assert_array_equal(got[0, :8], half[0, :8].astype(np.uint8))


def _stream_case(nets, datasets):
    jdcn, dcn = nets
    _, ds = datasets
    scene = ds.get_scene("scene_000")
    res0 = dcn.forward_on_img(scene.rgb[0]).numpy()
    obj = np.argwhere(scene.mask[0] > 0)[::7][:16]  # (v, u) on the object
    queries = res0[obj[:, 0], obj[:, 1]]
    return jdcn, dcn, scene, obj, queries


def test_grasp_point_stream_equal_jax_and_float64(nets, datasets):
    jdcn, dcn, scene, obj, queries = _stream_case(nets, datasets)
    stream = live.GraspPointStream(dcn, queries)
    jstream = j_live.GraspPointStream(jdcn, queries)
    q64 = queries.astype(np.float64)
    for f in range(scene.num_frames):
        before = bm.launches
        uv, dist = stream.process_frame(scene.rgb[f])
        assert bm.launches == before  # CPU tensors: the plain version, no launch
        juv, jdist = jstream.process_frame(scene.rgb[f])
        assert uv.dtype == np.int32 and uv.shape == (16, 2) and dist.dtype == np.float32
        res = dcn.forward_on_img(scene.rgb[f]).numpy().astype(np.float64).reshape(-1, D)
        jres = np.asarray(jdcn.forward_on_img(scene.rgb[f]), np.float64).reshape(-1, D)
        d2 = ((res[None, :, :] - q64[:, None, :]) ** 2).sum(-1)  # [Q, HW]
        pick = uv[:, 1] * W + uv[:, 0]
        jpick = juv[:, 1] * W + juv[:, 0]
        rows = np.arange(16)
        true_min = d2.min(1)
        np.testing.assert_allclose(d2[rows, pick], true_min, rtol=0, atol=1e-12)
        np.testing.assert_allclose(dist, np.sqrt(true_min), rtol=0, atol=1e-5)
        np.testing.assert_allclose(dist, jdist, rtol=0, atol=1e-2)
        # picks equal but float64 near-ties: the expanded form's rounding plus
        # what the other network's descriptors move a squared distance
        e = np.sqrt(D) * float(np.abs(res - jres).max())
        rmax = float((jres ** 2).sum(-1).max())
        tie = 8 * F32_EPS * (rmax + (q64 ** 2).sum(-1)) + 2 * np.sqrt(d2[rows, jpick]) * e + e * e
        differ = pick != jpick
        assert np.all(d2[rows, jpick][differ] - true_min[differ] <= tie[differ])
        if f == 0:  # every query matches its own pixel, or a tie at distance 0
            assert np.all(dist <= 1e-5)
            own = obj[:, 0] * W + obj[:, 1]
            assert np.all((pick == own) | (d2[rows, own] == d2[rows, pick]))


# -- descriptor video ----------------------------------------------------------------------


def test_descriptor_video_equal_jax(nets, datasets, folder, tmp_path, monkeypatch):
    jds, ds = datasets
    monkeypatch.setattr("shutil.which", lambda name: None)  # no ffmpeg: the frames alone
    out = video.run(folder, ds, scene_names=["scene_001"], output_dir=str(tmp_path / "port"),
                    batch_size=3, masked=True, device="cpu")
    jout = j_video.run(folder, jds, scene_names=["scene_001"], output_dir=str(tmp_path / "jax"),
                       batch_size=3, masked=True)
    assert out == {"scene_001": {"frames": 4, "videos": []}}
    assert jout == out
    scene = ds.get_scene("scene_001")
    port_dir = tmp_path / "port" / "scene_001" / "video_images"
    jax_dir = tmp_path / "jax" / "scene_001" / "video_images"
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) and len(names) == 12
    for idx in range(4):
        rgb = _port_decode(str(port_dir / ("%06d_rgb.png" % idx)))
        np.testing.assert_array_equal(rgb, _read_png(str(jax_dir / ("%06d_rgb.png" % idx))))
        np.testing.assert_array_equal(rgb, scene.rgb[idx])
        res = _port_decode(str(port_dir / ("%06d_res.png" % idx)))
        np.testing.assert_array_equal(res, _read_png(str(port_dir / ("%06d_res.png" % idx))))
        jres = _read_png(str(jax_dir / ("%06d_res.png" % idx)))
        assert np.abs(res.astype(int) - jres).max() <= 1
        masked = _port_decode(str(port_dir / ("%06d_res_masked.png" % idx)))
        off = scene.mask[idx] == 0
        assert off.any() and (~off).any()
        assert (masked[off] == 0).all()
        np.testing.assert_array_equal(masked[~off], res[~off])


def test_make_videos_without_ffmpeg_returns_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr("shutil.which", lambda name: None)
    assert video.make_videos(str(tmp_path), str(tmp_path / "v"), "log", masked=True) == []
    assert not (tmp_path / "v").exists()


# -- mesh descriptors ----------------------------------------------------------------------


@pytest.mark.parametrize("depth_in", ["millimetres", "metres"])
def test_mesh_descriptors_equal_jax_with_one_descriptor_function(depth_in):
    sc = SyntheticScene(**{**_scene_kw(3), "num_frames": 5})
    verts, _ = sc.fusion_mesh()
    scene, jscene = _scene_pair(np.asarray([4, 5, 6, 9, 10]))
    if depth_in == "metres":
        scene.depth = jscene.depth = scene.depth.astype(np.float32) / 1000.0
    ids = [10, 4, 6, 9]  # summed in this order
    got = mesh.compute_mesh_descriptors(_FakeNet(), scene, verts, frame_indices=ids)
    want = j_mesh.compute_mesh_descriptors(_FakeJaxNet(), jscene, verts, frame_indices=ids)
    np.testing.assert_array_equal(got["vertices"], want["vertices"])
    np.testing.assert_array_equal(got["num_observations"], want["num_observations"])
    seen = got["num_observations"] > 0
    assert 0.1 < seen.mean() < 1.0
    np.testing.assert_allclose(got["descriptors"], want["descriptors"], rtol=0, atol=1e-6)
    assert (got["descriptors"][~seen] == 0).all()


def test_mesh_descriptors_equal_jax_with_the_networks_and_save(nets, tmp_path):
    jdcn, dcn = nets
    verts, _ = SyntheticScene(**_scene_kw(2)).fusion_mesh()
    scene, jscene = _scene_pair(None)
    got = mesh.compute_mesh_descriptors(dcn, scene, verts)
    want = j_mesh.compute_mesh_descriptors(jdcn, jscene, verts)
    np.testing.assert_array_equal(got["num_observations"], want["num_observations"])
    np.testing.assert_allclose(got["descriptors"], want["descriptors"], rtol=FWD,
                               atol=_scale_tol(want["descriptors"]))

    class Structure:
        processed_folder = str(tmp_path)

    path = mesh.save_mesh_descriptors(got, Structure, "net")
    assert path == j_mesh.save_mesh_descriptors(want, Structure, "net")
    with np.load(path) as z:
        assert sorted(z.files) == ["descriptors", "num_observations", "vertices"]


# -- debug visualization -------------------------------------------------------------------


def test_detect_flip_subsample_flat_to_uv_equal_jax():
    rng = np.random.RandomState(0)
    h, w = 8, 10
    mask = np.zeros((h, w), np.uint8)
    mask[1:3, 1:4] = 1
    on = np.flatnonzero(mask.reshape(-1))
    valid = np.ones(on.size, bool)
    for idx, val in ((on, valid), (h * w - 1 - on, valid), (on, ~valid),
                     (rng.randint(0, h * w, 20), rng.rand(20) > 0.5)):
        assert debug.detect_flip(idx, val, mask) == j_debug.detect_flip(idx, val, mask)
    assert debug.detect_flip(h * w - 1 - on, valid, mask) is True
    flat = rng.randint(0, h * w, 30)
    np.testing.assert_array_equal(debug._flat_to_uv(flat, w), j_debug._flat_to_uv(flat, w))
    uv_a, uv_b, v = rng.randint(0, 9, (30, 2)), rng.randint(0, 9, (30, 2)), rng.rand(30) > 0.3
    for n in (0, 5, 100):
        got = debug._subsample(uv_a, uv_b, v, n, np.random.RandomState(n))
        want = j_debug._subsample(uv_a, uv_b, v, n, np.random.RandomState(n))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for a in debug._subsample(uv_a, uv_b, np.zeros(30, bool), 5, rng):
        assert a.shape == (0, 2)


ANNOTATIONS = [("scene_000", 0, [(10, 12), (30, 20)], "scene_001", 1, [(11, 13), (31, 21)]),
               ("scene_000", 2, [(5, 5)], "scene_000", 3, [(50, 40)])]


@pytest.mark.parametrize("with_cv2", [True, False])
def test_visualize_saved_correspondences_equal_jax(datasets, tmp_path, monkeypatch, with_cv2):
    if with_cv2:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    jds, ds = datasets
    anns = [annotate.make_annotation_entry(*a) for a in ANNOTATIONS]
    path = str(tmp_path / "new_annotated_pairs.yaml")
    annotate.save_annotations(anns, path)
    got = debug.visualize_saved_correspondences(ds, path, output_dir=str(tmp_path / "port"))
    want = j_debug.visualize_saved_correspondences(jds, path, output_dir=str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "pair_000_a.png", "pair_000_b.png", "pair_001_a.png", "pair_001_b.png"]
    for p, q in zip(got, want):
        img = _port_decode(p)
        np.testing.assert_array_equal(img, _read_png(q))
        np.testing.assert_array_equal(img, _read_png(p))
    # each reticle's colour on its ring (and, without cv2, on the clicked pixel)
    for j, ann in enumerate(anns):
        for tag in ("a", "b"):
            img = _port_decode(got[2 * j + (tag == "b")])
            for i, px in enumerate(ann[f"image_{tag}"]["pixels"]):
                colour = annotate.LABEL_COLORS[i]
                u, v = px["u"], px["v"]
                ring = (u + 10, v) if u + 10 < W else (u - 10, v)
                assert tuple(img[ring[1], ring[0]]) == colour
                if not with_cv2:
                    assert tuple(img[v, u]) == colour
    assert debug.visualize_saved_correspondences(ds, [], output_dir=str(tmp_path)) == []


@pytest.mark.parametrize("case", ["within_scene", "synthetic_multi_object", "flip_augmented"])
def test_debug_batch_panels_names_equal_jax(case, tmp_path):
    pytest.importorskip("matplotlib")
    kw = {"within_scene": dict(num_pairs=1, seed=0, match_type=0),
          "synthetic_multi_object": dict(num_pairs=1, seed=1, match_type=4),
          "flip_augmented": dict(num_pairs=2, seed=5, match_type=0)}[case]
    cfgs = {}
    if case == "flip_augmented":
        small = dict(num_matching_attempts=500, num_masked_non_matches_per_match=3,
                     num_background_non_matches_per_match=3, num_blind_samples=200,
                     flip_augmentation=True, domain_randomize=True)
        cfgs = {"port": AssemblerConfig(**small), "jax": JaxAssemblerConfig(**small)}
    jds, ds = JaxSpartanDataset.make_synthetic(**SYNTH), SpartanDataset.make_synthetic(**SYNTH)
    got = debug.debug_batch_panels(ds, output_dir=str(tmp_path / "port"), cfg=cfgs.get("port"),
                                   device="cpu", **kw)
    want = j_debug.debug_batch_panels(jds, output_dir=str(tmp_path / "jax"),
                                      cfg=cfgs.get("jax"), **kw)
    assert [t for t, _ in got] == [t for t, _ in want] == [kw["match_type"]] * kw["num_pairs"]
    assert ([[os.path.basename(p) for p in ps] for _, ps in got]
            == [[os.path.basename(p) for p in ps] for _, ps in want])
    for _, paths in got:
        assert len(paths) == 5 and all(os.path.getsize(p) > 1000 for p in paths)


def test_debug_batch_panels_without_matplotlib_raises_naming_it(datasets, tmp_path,
                                                                monkeypatch):
    _, ds = datasets
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        debug.debug_batch_panels(ds, 1, str(tmp_path), device="cpu")


# -- the heatmap UI's config, and the CLI ----------------------------------------------------


def test_heatmap_visualization_reads_its_config_and_refuses_int8(datasets, folder, tmp_path):
    """``quantize_int8: true`` was refused until int8 serving was ported;
    now it builds engines on ``dcn.quantized()`` clones."""
    _, ds = datasets
    cfg = load_yaml(os.path.join(ROOT, "configs", "heatmap_vis.yaml"))
    assert cfg == yaml.safe_load(open(os.path.join(ROOT, "configs", "heatmap_vis.yaml")))
    root, name = os.path.split(folder)
    vis = live.HeatmapVisualization.from_config(ds, {**cfg, "networks": [name]},
                                                networks_root=root, device="cpu")
    vis._get_new_images()
    (uv, _, heat), = vis._engine.find_best_match(3, 4)
    assert heat.shape == (H, W) and 0 <= uv[0] < W and 0 <= uv[1] < H
    path = str(tmp_path / "vis.yaml")
    save_yaml({**cfg, "networks": [name], "quantize_int8": True}, path)
    qvis = live.HeatmapVisualization.from_config(ds, path, networks_root=root, device="cpu")
    (qdcn,) = qvis._dcns
    assert qdcn.module.quant_int8 and not qdcn.module.quant_static
    assert not vis._dcns[0].module.quant_int8
    qvis._get_new_images()
    (uv, _, heat), = qvis._engine.find_best_match(3, 4)
    assert heat.shape == (H, W) and 0 <= uv[0] < W and 0 <= uv[1] < H


def _cli_argv(cmd, folder, tree, tmp_path):
    common = ["--config", tree["composite"], "--data_dir", tree["root"]]
    anns = str(tmp_path / "anns.yaml")
    annotate.save_annotations([annotate.make_annotation_entry(
        "scene_0", 0, [(10, 12)], "scene_1", 2, [(20, 22)])], anns)
    return {"descriptor-images": ["descriptor-images", "--model_folder", folder, *common,
                                  "--batch_size", "3"],
            "descriptor-video": ["descriptor-video", "--model_folder", folder, *common,
                                 "--output_dir", str(tmp_path / "videos"), "--masked"],
            "debug-vis view": ["debug-vis", "view", *common, "--annotations", anns,
                               "--out", str(tmp_path / "view")],
            "debug-vis debug": ["debug-vis", "debug", *common, "--num_pairs", "1",
                                "--out", str(tmp_path / "debug")]}[cmd]


@pytest.mark.parametrize("cmd", ["descriptor-images", "descriptor-video", "debug-vis view",
                                 "debug-vis debug"])
def test_cli_runs_on_the_cpu_when_asked(cmd, folder, tree, tmp_path, monkeypatch, capsys):
    if cmd == "debug-vis debug":
        pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("shutil.which", lambda name: None)
    assert cli.main(_cli_argv(cmd, folder, tree, tmp_path) + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    if cmd == "descriptor-images":
        assert "wrote descriptor images for 8 frames" in out
        files = os.listdir(tmp_path / "descriptor_images_out" / "scene_1" / "descriptor_images"
                           / "net")
        assert sorted(files) == ["%06d_descriptor.npy" % i for i in range(4)]
    elif cmd == "descriptor-video":
        assert "scene_0 4 frames 0 videos" in out and "scene_1 4 frames 0 videos" in out
        assert len(os.listdir(tmp_path / "videos" / "scene_1" / "video_images")) == 12
    elif cmd == "debug-vis view":
        assert "wrote 2 PNGs" in out
    else:
        assert "wrote 5 PNGs" in out


@pytest.mark.parametrize("cmd", ["descriptor-images", "descriptor-video", "debug-vis view",
                                 "debug-vis debug"])
def test_cli_needs_cuda_unless_cpu_is_asked(cmd, folder, tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_cli_argv(cmd, folder, tree, tmp_path))


@pytest.mark.parametrize("flag", ["--int8", "--int8_static"])
def test_cli_descriptor_images_refuses_int8(flag, folder, tree, tmp_path, monkeypatch, capsys):
    """The int8 flags were refused (exit 2) until int8 serving was ported;
    now they write the int8 clone's descriptor images: ``--int8`` the
    dynamic clone's, ``--int8_static`` those of a clone calibrated on the
    first scene's first 16 frames. Same frames in the same batches of 3 on
    the CPU: equal within 1e-6 of the scale (float32 operations repeated)."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(_cli_argv("descriptor-images", folder, tree, tmp_path)
                    + [flag, "--device", "cpu"]) == 0
    assert "wrote descriptor images for 8 frames" in capsys.readouterr().out
    ds = SpartanDataset(config=load_yaml(tree["composite"]), data_dir=tree["root"],
                        config_dir=os.path.dirname(tree["composite"]))
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    first = next(iter(ds.scenes.values()))
    q = (dcn.calibrate_quantization(list(first.rgb[:16]), batch_size=3)
         if flag == "--int8_static" else dcn.quantized())
    for name, scene in ds.scenes.items():
        out = tmp_path / "descriptor_images_out" / name / "descriptor_images" / "net"
        for start in range(0, scene.num_frames, 3):
            want = q.forward_on_images(scene.rgb[start:start + 3]).numpy()
            for j in range(want.shape[0]):
                got = np.load(out / ("%06d_descriptor.npy" % scene.frame_id(start + j)))
                np.testing.assert_allclose(got, want[j], rtol=1e-6,
                                           atol=1e-6 * float(np.abs(want).max()))
