"""The port's evaluation (pdc_tpu_torch.evaluation) against pdc_tpu, on the
CPU at 64x48 with ResNet-18-8s (weights carried across by models/convert.py).

Tolerances, and why:

  * F1_D2, per query: the JAX statistics expand ``|r|^2 - 2<r,q> + |q|^2``
    in float32 and round each term, so their squared distances are off by a
    few ulps of ``|r|^2 + |q|^2`` (ROADMAP F1: 7.8e-3 in distance at
    ``|r|^2`` of 271, about 2.3 ulps); the bound is 8 ulps of the image's
    largest ``|r|^2`` plus ``|q|^2``. Where the two packages pick different
    pixels, the two picks' float64 squared distances must differ by less;
    a fraction-closer count may differ only by the pixels whose float64
    squared distance lies within it of the ground truth's;
  * MASK_ROUND: an empty mask adds 1e6 to every distance after the square
    root, where float32 values are 0.0625 apart; both packages round there,
    so their masked values and picks may differ by two such steps;
  * 1e-5 (relative and absolute) on every value that does not depend on a
    pick, and on the pick's values where both pick the same pixel: the same
    float32 operations in another order;
  * the sweeps' rows of the port's two routes, its pair lists, the CSVs and
    the plotter's stats are compared for equality.

The descriptor statistics, the across-object rows, the keypoints and the
cross-scene rows are held with a fixed descriptor function in place of the
network, the same numbers in both packages, so that only the evaluation
code differs; the networks themselves agree within 2e-5 of the descriptors'
scale (tests/test_torch_port_dcn.py), which the descriptor statistics are
also held to with the real networks.
"""

import copy
import itertools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import pdc_tpu.ops.sampling as jax_sampling
from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset
from pdc_tpu.evaluation import keypoints as jax_keypoints
from pdc_tpu.evaluation import qualitative as jax_qualitative
from pdc_tpu.evaluation import utils as jax_eval_utils
from pdc_tpu.evaluation.evaluate import DenseCorrespondenceEvaluation as JaxDCE
from pdc_tpu.evaluation.evaluate import _match_statistics_device
from pdc_tpu.evaluation.plotting import DenseCorrespondenceEvaluationPlotter as JaxPlotter
from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu_torch import __main__ as cli
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.evaluation import evaluate as ev
from pdc_tpu_torch.evaluation import keypoints, plotting, qualitative, table
from pdc_tpu_torch.evaluation import utils as eval_utils
from pdc_tpu_torch.evaluation.evaluate import EVAL_COLUMNS
from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation as DCE
from pdc_tpu_torch.models.convert import flax_to_state_dict
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.ops import sampling
from pdc_tpu_torch.utils import visualization

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """The evaluation tests write model folders and their analysis: remove them when the test
    ends, so that a whole run leaves no large files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


W, H, D = 64, 48, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "fixtures", "goldens")
SYNTH = dict(num_scenes=2, num_objects=2, width=W, height=H, num_frames=4, object_radius=0.3)
F32_EPS = 2.0 ** -23
MASK_ROUND = 2 * 0.0625
TOL = 1e-5
NET_CFG = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}


@pytest.fixture(scope="module")
def nets():
    jdcn = JaxDCN.from_config(NET_CFG, rng=jax.random.PRNGKey(7))
    dcn = DenseCorrespondenceNetwork.from_config(jdcn.config, device="cpu")
    dcn.module.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jdcn.variables)))
    return jdcn, dcn


@pytest.fixture(scope="module")
def datasets():
    return JaxSpartanDataset.make_synthetic(**SYNTH), SpartanDataset.make_synthetic(**SYNTH)


def _descriptors(x):
    """A fixed descriptor function of normalized images [..., H, W, 3]:
    the same float32 numbers for both packages."""
    x = np.asarray(x, np.float32)
    m = np.asarray([[0.9, -0.4, 0.3], [0.2, 1.1, -0.5], [-0.6, 0.3, 0.8]], np.float32)
    return (np.sin(x @ m * np.float32(1.7)) * np.float32(2.0) + x).astype(np.float32)


class _FakeJaxNet:
    descriptor_dimension = D

    def forward(self, imgs):
        return jnp.asarray(_descriptors(imgs))

    def forward_on_img(self, rgb):
        x = (np.asarray(rgb, np.float32) / 255.0 - np.asarray([0.485, 0.456, 0.406], np.float32)
             ) / np.asarray([0.229, 0.224, 0.225], np.float32)
        return jnp.asarray(_descriptors(x))

    def clip_pixel_to_image_size_and_round(self, uv):
        return [max(min(int(round(uv[0])), W - 1), 0), max(min(int(round(uv[1])), H - 1), 0)]


class _FakeNet(_FakeJaxNet):
    def forward(self, imgs):
        return torch.as_tensor(_descriptors(imgs))

    def forward_on_img(self, rgb):
        return torch.as_tensor(np.asarray(super().forward_on_img(rgb)))


# -- _match_statistics against _match_statistics_device -------------------------------------


def _f1_d2(res_b, q):
    """F1_D2 of the module docstring, per query: [N]."""
    rmax = float(np.max(np.sum(res_b.astype(np.float64) ** 2, -1)))
    return 8 * F32_EPS * (rmax + np.sum(q.astype(np.float64) ** 2, -1))


def _stats_case(name, datasets, nets):
    _, ds = datasets
    jdcn, _ = nets
    rng = np.random.default_rng(sum(map(ord, name)))
    scene = ds.get_scene("scene_000")
    frame_b = 0 if name == "exact_matches_scaled" else 1
    rgb_a, depth_a, mask_a, pose_a = (scene.rgb[0], scene.depth[0], scene.mask[0], scene.poses[0])
    _, depth_b, mask_b, pose_b = (scene.rgb[frame_b], scene.depth[frame_b], scene.mask[frame_b],
                                  scene.poses[frame_b])
    res_a = np.asarray(jdcn.forward_on_img(rgb_a))
    res_b = np.asarray(jdcn.forward_on_img(scene.rgb[frame_b]))
    K = np.asarray(scene.K, np.float32)
    K_b = None
    n = 64
    uv_a = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], -1).astype(np.int32)
    uv_b = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], -1).astype(np.int32)
    if name == "per_side_K":
        K_b = K.copy()
        K_b[0, 0] *= 1.3
        K_b[1, 1] *= 0.8
        K_b[0, 2] += 3.0
    if name == "exact_matches_scaled":
        # the same frame, larger descriptors: every query has an exact match,
        # where the expansion cancels most
        res_a = res_b = (res_a * 16.0).astype(np.float32)
        uv_b = uv_a.copy()
    if name == "empty_mask":
        mask_b = np.zeros_like(mask_b)
    return dict(depth_a=depth_a, depth_b=depth_b, mask_b=mask_b, uv_a=uv_a, uv_b=uv_b,
                pose_a=np.asarray(pose_a, np.float32), pose_b=np.asarray(pose_b, np.float32),
                res_a=res_a, res_b=res_b, K=K, K_b=K_b)


@pytest.mark.parametrize("name", ["same_scene", "per_side_K", "exact_matches_scaled",
                                  "empty_mask"])
def test_match_statistics_against_jax(name, datasets, nets):
    c = _stats_case(name, datasets, nets)
    args = [c[k] for k in ("depth_a", "depth_b", "mask_b", "uv_a", "uv_b", "pose_a", "pose_b",
                           "res_a", "res_b", "K")]
    kb = () if c["K_b"] is None else (c["K_b"],)
    want = {k: np.asarray(v) for k, v in _match_statistics_device(
        *[jnp.asarray(a) for a in args], *[jnp.asarray(k) for k in kb]).items()}
    got = {k: v.numpy() for k, v in ev._match_statistics(*args, *kb).items()}
    assert set(got) == set(want) and len(got) == 17

    N, HW = len(c["uv_a"]), H * W
    rb = c["res_b"].reshape(HW, D).astype(np.float64)
    q = c["res_a"][c["uv_a"][:, 1], c["uv_a"][:, 0]].astype(np.float64)
    d2 = ((rb[None, :, :] - q[:, None, :]) ** 2).sum(-1)  # [N, HW] float64
    f1 = _f1_d2(c["res_b"], q)
    rows = np.arange(N)

    def flat(uv):
        return uv[:, 1] * W + uv[:, 0]

    # the unmasked picks: equal, or float64 near-ties within F1
    pj, pp = flat(want["uv_b_pred"]), flat(got["uv_b_pred"])
    same = pj == pp
    assert np.all(np.abs(d2[rows, pj] - d2[rows, pp]) <= f1)
    # the port's pick is the float64 argmin within its own rounding
    assert np.all(d2[rows, pp] - d2.min(1) <= 1e-5)
    assert np.all(np.abs(want["norm_diff_descriptor"].astype(np.float64) ** 2
                         - got["norm_diff_descriptor"].astype(np.float64) ** 2) <= f1 + 1e-6)
    for k in ("pixel_match_error_l2", "pixel_match_error_l1", "norm_diff_pred_3d", "is_valid"):
        np.testing.assert_allclose(got[k][same].astype(np.float64),
                                   want[k][same].astype(np.float64), rtol=TOL, atol=TOL,
                                   err_msg=k)
    # the masked picks, after the square root's +1e6
    mask = (c["mask_b"].reshape(HW) != 0)
    mj, mp = flat(want["uv_b_pred_masked"]), flat(got["uv_b_pred_masked"])
    same_m = mj == mp
    dist_port = np.sqrt(((c["res_b"].reshape(HW, D)[None] - q.astype(np.float32)[:, None]) ** 2)
                        .sum(-1, dtype=np.float32)).astype(np.float32)  # the port's arithmetic
    if mask.any():
        assert mask[mj].all() and mask[mp].all()
        assert np.all(np.abs(d2[rows, mj] - d2[rows, mp]) <= f1)
        # the distance itself (torch's vectorised sqrt is within an ulp)
        np.testing.assert_allclose(got["norm_diff_descriptor_masked"], dist_port[rows, mp],
                                   rtol=2 * F32_EPS, atol=0)
    else:
        # every pixel is blocked: the values are float32(d + 1e6)
        assert np.all(np.abs(np.sqrt(d2[rows, mj]) - np.sqrt(d2[rows, mp]))
                      <= np.sqrt(f1) + MASK_ROUND)
        np.testing.assert_allclose(got["norm_diff_descriptor_masked"],
                                   dist_port[rows, mp] + np.float32(1e6), rtol=0, atol=0.0625)
        assert np.all(np.abs(got["norm_diff_descriptor_masked"].astype(np.float64)
                             - want["norm_diff_descriptor_masked"]) <= MASK_ROUND)
    for k in ("pixel_match_error_l2_masked", "norm_diff_pred_3d_masked", "is_valid_masked"):
        np.testing.assert_allclose(got[k][same_m].astype(np.float64),
                                   want[k][same_m].astype(np.float64), rtol=TOL, atol=TOL,
                                   err_msg=k)
    # pick-independent columns
    for k in ("norm_diff_descriptor_ground_truth", "norm_diff_ground_truth_3d"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
    # fraction closer: counts differ only by the pixels within F1 of the ground truth
    gt2 = ((q - c["res_b"][c["uv_b"][:, 1], c["uv_b"][:, 0]].astype(np.float64)) ** 2).sum(-1)
    near = np.abs(d2 - gt2[:, None]) <= f1[:, None]  # [N, HW]
    n_mask = max(int(mask.sum()), 1)
    for k, total, count_near in (
            ("fraction_pixels_closer_than_ground_truth", HW, near.sum(1)),
            ("fraction_pixels_closer_than_ground_truth_masked", n_mask, (near & mask).sum(1))):
        nj = np.rint(want[k].astype(np.float64) * total)
        npo = np.rint(got[k].astype(np.float64) * total)
        assert np.all(np.abs(nj - npo) <= count_near), k
        fp = k.replace("fraction_pixels_closer_than_ground_truth",
                       "average_l2_distance_for_false_positives")
        eq = nj == npo
        np.testing.assert_allclose(got[fp][eq], want[fp][eq], rtol=TOL, atol=TOL, err_msg=fp)


def test_match_statistics_pixel_chunks_change_nothing(datasets, nets, monkeypatch):
    c = _stats_case("same_scene", datasets, nets)
    args = [c[k] for k in ("depth_a", "depth_b", "mask_b", "uv_a", "uv_b", "pose_a", "pose_b",
                           "res_a", "res_b", "K")]
    whole = ev._match_statistics(*args)
    # chunks of 7 pixels: 439 chunks, the last one ragged
    monkeypatch.setattr(ev, "STATS_CHUNK_BYTES", 4 * 64 * 7)
    assert ev._pixel_chunk(1, 64, H * W) == 7
    chunked = ev._match_statistics(*args)
    for k, v in whole.items():
        torch.testing.assert_close(chunked[k], v, rtol=0, atol=0, equal_nan=True, msg=k)


# -- the sweeps -----------------------------------------------------------------------------


def test_pair_list_equals_jax(datasets, monkeypatch):
    jds, ds = datasets
    captured = {}

    def capture(dataset, pair_list, *args, **kwargs):
        captured["pairs"] = [(s, a, b) for s, a, b, _ in pair_list]
        raise StopIteration  # the pair list is all this test needs

    monkeypatch.setattr(JaxDCE, "compute_descriptor_images_batched",
                        staticmethod(lambda *a, **k: {}))
    monkeypatch.setattr(JaxDCE, "_quantitative_sweep_fused", staticmethod(capture))
    for mode in ("train", "test"):
        jds.mode = ds.mode = mode
        with pytest.raises(StopIteration):
            JaxDCE.evaluate_network_quantitative(None, jds, num_image_pairs=12, seed=1)
        port = ev.image_pair_list(ds, 12, seed=1)
        assert [(s, a, b) for s, a, b, _ in port] == captured["pairs"]
        assert len(port) >= 10
        assert len({ps for *_, ps in port}) == len(port)  # a generator seed per pair
    jds.mode = ds.mode = "train"


@pytest.fixture(scope="module")
def port_sweeps(datasets, nets):
    _, ds = datasets
    _, dcn = nets
    kw = dict(num_image_pairs=5, num_matches_per_image_pair=20, seed=1)
    return (DCE.evaluate_network_quantitative(dcn, ds, fused=True, **kw),
            DCE.evaluate_network_quantitative(dcn, ds, fused=False, **kw))


def test_fused_and_per_pair_routes_give_equal_rows(port_sweeps, datasets, nets, monkeypatch):
    fused, loop = port_sweeps
    assert isinstance(fused, table.Table) and fused.columns == EVAL_COLUMNS
    assert len(fused) == len(loop) > 0
    assert fused.rows() == loop.rows() or all(
        np.array_equal(fused[c], loop[c], equal_nan=fused[c].dtype.kind == "f")
        for c in EVAL_COLUMNS)
    # chunks of 2 pairs (3 chunks for 5 pairs) change no row
    _, ds = datasets
    _, dcn = nets
    monkeypatch.setattr(ev, "SWEEP_PAIR_CHUNK", 2)
    monkeypatch.setattr(DCE._quantitative_sweep_fused, "__defaults__", (2000, 2, None))
    again = DCE.evaluate_network_quantitative(dcn, ds, num_image_pairs=5,
                                              num_matches_per_image_pair=20, seed=1)
    for c in EVAL_COLUMNS:
        np.testing.assert_array_equal(again[c], fused[c], err_msg=c)


def test_sweep_is_reproducible_and_keeps_its_schema(port_sweeps, datasets, nets, monkeypatch):
    fused, _ = port_sweeps
    assert fused["is_valid"].dtype == bool and fused["img_a_idx"].dtype == np.int64
    assert fused["scene_name_a"].dtype == object and all(v is None for v in fused["scene_name_a"])
    assert np.isfinite(fused["norm_diff_descriptor"]).all()
    assert (fused["fraction_pixels_closer_than_ground_truth"] <= 1).all()
    _, ds = datasets
    _, dcn = nets
    again = DCE.evaluate_network_quantitative(dcn, ds, num_image_pairs=5,
                                              num_matches_per_image_pair=20, seed=1)
    assert again.rows() == fused.rows() or all(
        np.array_equal(again[c], fused[c], equal_nan=True) for c in EVAL_COLUMNS[9:22])
    # mesh= is ported: a mesh of one process (no process group) gives the same rows
    # (tests/test_torch_port_parallel.py holds 2 and 4 gloo ranks)
    from pdc_tpu_torch.parallel.mesh import make_mesh

    meshed = DCE.evaluate_network_quantitative(dcn, ds, num_image_pairs=5,
                                               num_matches_per_image_pair=20, seed=1,
                                               mesh=make_mesh(device="cpu"))
    assert meshed.rows() == fused.rows() or all(
        np.array_equal(meshed[c], fused[c], equal_nan=True) for c in EVAL_COLUMNS[9:22])
    # the test loss over a dataset runs and agrees with pdc_tpu's on the same
    # batches (tests/test_torch_port_per_pair.py holds it at 1e-5 on a smaller one)
    from tests.test_torch_port_per_pair import compute_loss_against_jax

    jdcn, _ = nets
    got, want = compute_loss_against_jax(monkeypatch, jdcn, _jax_fake_dataset(), dcn,
                                         SpartanDataset.make_synthetic(**SYNTH), {},
                                         num_iterations=1, batch_size=1, seed=0)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=1e-5, atol=1e-5)


def _jax_fake_dataset():
    return JaxSpartanDataset.make_synthetic(**SYNTH)


def test_descriptor_statistics_equal_jax(datasets, nets):
    jds, ds = datasets
    # the same descriptor function in both packages: only the statistics differ
    jds.reset_seed(3)
    ds.reset_seed(3)
    want = JaxDCE.compute_descriptor_statistics_on_dataset(_FakeJaxNet(), jds, num_images=7,
                                                           save_to_file=False, batch_size=3)
    got = DCE.compute_descriptor_statistics_on_dataset(_FakeNet(), ds, num_images=7,
                                                       save_to_file=False, batch_size=3)
    for part in ("entire_image", "mask_image"):
        for k in ("min", "max", "mean"):
            np.testing.assert_allclose(got[part][k], want[part][k], rtol=TOL, atol=TOL)
    # the real networks: within their forward's 2e-5 of the descriptors' scale
    jdcn, dcn = nets
    jds.reset_seed(3)
    ds.reset_seed(3)
    want = JaxDCE.compute_descriptor_statistics_on_dataset(jdcn, jds, num_images=7,
                                                           save_to_file=False, batch_size=3)
    got = DCE.compute_descriptor_statistics_on_dataset(dcn, ds, num_images=7,
                                                       save_to_file=False, batch_size=3)
    scale = max(abs(x) for k in ("min", "max") for x in want["entire_image"][k])
    for part in ("entire_image", "mask_image"):
        for k in ("min", "max", "mean"):
            np.testing.assert_allclose(got[part][k], want[part][k], rtol=2e-5,
                                       atol=2e-5 * scale)


def test_across_object_rows_on_injected_queries(datasets, monkeypatch):
    jds, ds = datasets
    rng = np.random.default_rng(5)
    n_pairs, n_q = 4, 24
    uvs = [np.stack([rng.integers(0, W, n_q), rng.integers(0, H, n_q)], -1) for _ in range(n_pairs)]
    calls = {"jax": 0, "port": 0}

    def jax_sample(key, mask, num):
        uv = uvs[calls["jax"]]
        calls["jax"] += 1
        return jnp.asarray(uv, jnp.int32), jnp.asarray(True)

    def port_sample(mask, num, generator):
        uv = uvs[calls["port"]]
        calls["port"] += 1
        return torch.as_tensor(uv), torch.tensor(True)

    monkeypatch.setattr(jax_sampling, "sample_from_mask", jax_sample)
    monkeypatch.setattr(sampling, "sample_from_mask", port_sample)
    want = JaxDCE.evaluate_network_across_objects(_FakeJaxNet(), jds, num_image_pairs=n_pairs,
                                                  num_queries=n_q, seed=2, fused=False)
    got = DCE.evaluate_network_across_objects(_FakeNet(), ds, num_image_pairs=n_pairs,
                                              num_queries=n_q, seed=2)
    assert got.columns == list(want.columns) and len(got) == len(want) == n_pairs * n_q
    for c in ev.ACROSS_OBJECT_COLUMNS[:-1]:
        assert list(got[c]) == list(want[c]), c
    # sqrt(d2 + 1e6 blocked) of the best masked match, within F1 in d2
    jds.reset_seed(2)
    pairs = [jds.sample_pair(match_type=2) for _ in range(n_pairs)]
    vj = want["norm_diff_descriptor_best_match"].to_numpy().reshape(n_pairs, n_q)
    vp = got["norm_diff_descriptor_best_match"].reshape(n_pairs, n_q)
    for p, pair in enumerate(pairs):
        res_a = np.asarray(_FakeJaxNet().forward_on_img(pair.rgb_a))
        res_b = np.asarray(_FakeJaxNet().forward_on_img(pair.rgb_b))
        q = res_a[uvs[p][:, 1], uvs[p][:, 0]]
        f1 = _f1_d2(res_b, q) + 8 * F32_EPS * 1e6 * (~(np.asarray(pair.mask_b) != 0)).any()
        assert np.all(np.abs(vj[p].astype(np.float64) ** 2 - vp[p].astype(np.float64) ** 2)
                      <= f1 + 1e-6)


def test_cross_scene_rows_equal_jax(datasets):
    jds, ds = datasets
    rng = np.random.default_rng(9)
    annotations = []
    for idx_a, idx_b in ((0, 2), (1, 3)):
        pix = [{"u": int(rng.integers(0, W)), "v": int(rng.integers(0, H)),
                "keypoint": f"k{i}"} for i in range(5)]
        pix_b = [{"u": int(rng.integers(0, W)), "v": int(rng.integers(0, H))} for _ in range(5)]
        annotations.append({"image_a": {"scene_name": "scene_000", "image_idx": idx_a,
                                        "pixels": pix},
                            "image_b": {"scene_name": "scene_001", "image_idx": idx_b,
                                        "pixels": pix_b}})
    want = JaxDCE.evaluate_network_cross_scene(_FakeJaxNet(), jds, annotations)
    got = DCE.evaluate_network_cross_scene(_FakeNet(), ds, annotations)
    near = _near_counts(ds, [
        (a["image_a"]["scene_name"], a["image_a"]["image_idx"], (pa["u"], pa["v"]),
         a["image_b"]["scene_name"], a["image_b"]["image_idx"], (pb["u"], pb["v"]))
        for a in annotations for pa, pb in zip(a["image_a"]["pixels"], a["image_b"]["pixels"])])
    _assert_rows_close(got, want, near=near)


# F1_D2 for the fixed descriptor function: its values lie within 2 + 2.7 of 0
# (sin times 2, plus the normalized image), so |r|^2 and |q|^2 are below 66
FAKE_F1_D2 = 8 * F32_EPS * 2 * 66.0
# the columns the JAX package computes from its expanded distance
EXPANDED = ("norm_diff_descriptor", "norm_diff_descriptor_masked")


def _near_counts(ds, matches):
    """For each match ``(scene_a, idx_a, uv_a, scene_b, idx_b, uv_b)``, the
    pixels of image b (all, and those in its mask) whose float64 squared
    distance to the query lies within FAKE_F1_D2 of the ground truth's,
    where a fraction-closer count may differ, and the mask's size."""
    net, out = _FakeJaxNet(), []
    for sa, ia, uva, sb, ib, uvb in matches:
        ra = np.asarray(net.forward_on_img(ds.get_rgbd_mask_pose(sa, ia)[0]), np.float64)
        _, _, mask_b, _ = ds.get_rgbd_mask_pose(sb, ib)
        rb = np.asarray(net.forward_on_img(ds.get_rgbd_mask_pose(sb, ib)[0]), np.float64)
        q = ra[uva[1], uva[0]]
        d2 = ((rb - q) ** 2).sum(-1)
        near = np.abs(d2 - ((rb[uvb[1], uvb[0]] - q) ** 2).sum()) <= FAKE_F1_D2
        in_mask = np.asarray(mask_b) != 0
        out.append((int(near.sum()), int((near & in_mask).sum()), int(in_mask.sum())))
    return np.asarray(out)


def _assert_rows_close(got, want, atol=None, near=None):
    """Tables with equal keys, the expanded distances within FAKE_F1_D2 in
    squared distance, the fraction-closer counts within ``near`` (the counts
    of :func:`_near_counts`, per row), the false-positive averages within
    TOL where those counts agree, and the other values within TOL, or
    ``atol[column]`` (the fixed descriptor function's picks have no
    near-ties: the pixel errors, which follow the picks, are held within
    TOL)."""
    assert got.columns == list(want.columns) and len(got) == len(want) > 0
    counts_equal = {}
    for c, j in (("fraction_pixels_closer_than_ground_truth", 0),
                 ("fraction_pixels_closer_than_ground_truth_masked", 1)):
        if near is None or c not in got.columns:
            continue
        fp = c.replace("fraction_pixels_closer_than_ground_truth",
                       "average_l2_distance_for_false_positives")
        total = H * W if j == 0 else np.maximum(near[:, 2], 1)
        nj = np.rint(want[c].to_numpy().astype(np.float64) * total)
        npo = np.rint(got[c].astype(np.float64) * total)
        assert np.all(np.abs(nj - npo) <= near[:, j]), c
        counts_equal[c] = counts_equal[fp] = nj == npo
    for c in got.columns:
        g, w = got[c], want[c].to_numpy()
        if c in counts_equal:
            g, w = g[counts_equal[c]], w[counts_equal[c]]
        if c in EXPANDED:
            assert np.all(np.abs(g.astype(np.float64) ** 2 - w.astype(np.float64) ** 2)
                          <= FAKE_F1_D2), c
        elif g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=TOL,
                                       atol=(atol or {}).get(c, TOL), err_msg=c)
        else:
            assert [None if isinstance(x, float) and np.isnan(x) else x for x in w] == \
                list(g), c


# -- plotter and CSV ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sweep(datasets, nets, tmp_path_factory):
    jds, _ = datasets
    jdcn, _ = nets
    df = JaxDCE.evaluate_network_quantitative(jdcn, jds, num_image_pairs=3,
                                              num_matches_per_image_pair=15, seed=1)
    path = str(tmp_path_factory.mktemp("jax_sweep") / "data.csv")
    df.to_csv(path)
    return df, path


def test_plotter_stats_on_a_jax_csv_equal_jax(jax_sweep, tmp_path, monkeypatch):
    df, path = jax_sweep
    want = JaxPlotter.run_on_single_dataframe(path, save=False)
    got = plotting.DenseCorrespondenceEvaluationPlotter.run_on_single_dataframe(path, save=False)
    assert got == want and set(got) == {"norm_diff_3d_area_above_curve", "pck_at_5px",
                                        "pck_at_10px", "pck_at_25px", "pck_at_50px",
                                        "pck_at_100px"}
    # a table gives the same; without matplotlib the stats are still written
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got2, fig_axes = plotting.DenseCorrespondenceEvaluationPlotter.run_on_single_dataframe(
        None, dataframe=table.read_csv(path), output_dir=str(tmp_path), return_fig_axes=True)
    assert got2 == want and fig_axes == (None, None)
    assert yaml.safe_load((tmp_path / "stats.yaml").read_text()) == want
    ao = pd.DataFrame({"norm_diff_descriptor_best_match": [0.5, np.nan, 1.5, 2.0]})
    ao.to_csv(tmp_path / "ao.csv")
    assert plotting.DenseCorrespondenceEvaluationPlotter.run_on_single_dataframe_across_objects(
        str(tmp_path / "ao.csv"), save=False) == \
        JaxPlotter.run_on_single_dataframe_across_objects(str(tmp_path / "ao.csv"), save=False)


def test_table_csv_reads_back_in_pandas_as_the_jax_csv(jax_sweep, port_sweeps, tmp_path):
    df, path = jax_sweep
    t = table.Table.from_rows(df.to_dict("records"), list(df.columns))
    t.to_csv(str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_text() == open(path).read()
    pd.testing.assert_frame_equal(pd.read_csv(str(tmp_path / "port.csv"), index_col=0),
                                  pd.read_csv(path, index_col=0))
    # the port's reader reads it with pandas' types, and every value as the
    # DataFrame held it (pandas' own parser may miss a float's last digit)
    back = table.read_csv(path)
    read = pd.read_csv(path, index_col=0)
    assert back.columns == EVAL_COLUMNS and len(back) == len(df)
    for c in EVAL_COLUMNS:
        if read[c].dtype.kind in "fib":
            assert back[c].dtype == read[c].dtype, c
            np.testing.assert_array_equal(back[c], df[c].to_numpy().astype(read[c].dtype),
                                          err_msg=c)
    # a port sweep's CSV, in pandas
    fused, _ = port_sweeps
    fused.to_csv(str(tmp_path / "sweep.csv"))
    p = pd.read_csv(str(tmp_path / "sweep.csv"), index_col=0, float_precision="round_trip")
    assert list(p.columns) == EVAL_COLUMNS and len(p) == len(fused)
    assert p["is_valid"].dtype == bool and p["img_b_idx"].dtype == np.int64
    np.testing.assert_array_equal(p["pixel_match_error_l2"].to_numpy(),
                                  fused["pixel_match_error_l2"])


def test_table_edge_cases(tmp_path):
    t = table.Table.from_rows([{"a": 1, "b": None, "c": "x,\"y\""}, {"a": None, "b": True}],
                              ["a", "b", "c"])
    assert t["a"].dtype == np.float64 and np.isnan(t["a"][1]) and t["b"].dtype == object
    t.to_csv(str(tmp_path / "t.csv"))
    pd.DataFrame([{"a": 1, "b": None, "c": "x,\"y\""}, {"a": None, "b": True}],
                 columns=["a", "b", "c"]).to_csv(str(tmp_path / "p.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "p.csv").read_text()
    back = table.read_csv(str(tmp_path / "t.csv"))
    assert back.rows()[0]["c"] == "x,\"y\"" and back.rows()[1]["c"] is None
    assert len(t.where(np.array([True, False]))) == 1
    empty = table.Table.from_rows([], EVAL_COLUMNS)
    empty.to_csv(str(tmp_path / "e.csv"))
    assert len(table.read_csv(str(tmp_path / "e.csv"))) == 0
    assert list(pd.read_csv(str(tmp_path / "e.csv"), index_col=0).columns) == EVAL_COLUMNS
    with pytest.raises(ValueError):
        t.where(np.array([True]))


# -- the whole analysis and its command ------------------------------------------------------


@pytest.fixture(scope="module")
def port_folder(tmp_path_factory):
    """A model folder trained by the port's command, 2 iterations at 64x48
    (removed with the module)."""
    from pdc_tpu_torch.training.train import DenseCorrespondenceTraining
    from pdc_tpu_torch.utils.yaml_io import save_yaml

    root = tmp_path_factory.mktemp("port_folder")
    cfg = copy.deepcopy(DenseCorrespondenceTraining.load_default_config())
    cfg["training"].update(batch_size=2, num_matching_attempts=256, num_non_matches_per_match=10,
                           cross_scene_num_samples=128, save_rate=1000, logging_rate=1000,
                           masked_pool_size=64, background_pool_size=64, num_blind_samples=100,
                           use_tensorboard=False, num_iterations=2, logging_dir=str(root),
                           logging_dir_name="net")
    cfg["dense_correspondence_network"].update(image_width=W, image_height=H)
    cfg["dense_correspondence_network"]["backbone"]["resnet_name"] = "Resnet18_8s"
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    yield trainer.run()
    shutil.rmtree(root, ignore_errors=True)


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_cli_evaluate_writes_the_tree_pdc_tpu_writes(port_folder, tmp_path, capsys):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxDCE.run_evaluation_on_network(port_folder, num_image_pairs=3,
                                     num_matches_per_image_pair=10, output_dir=jax_out,
                                     qualitative=False)
    jax_stats = yaml.safe_load(open(os.path.join(port_folder, "descriptor_statistics.yaml")))
    os.remove(os.path.join(port_folder, "descriptor_statistics.yaml"))
    assert cli.main(["evaluate", "--model_folder", port_folder, "--num_image_pairs", "3",
                     "--num_matches_per_image_pair", "10", "--output_dir", port_out,
                     "--no_qualitative", "--device", "cpu"]) == 0
    assert "analysis written" in capsys.readouterr().out
    assert _tree(port_out) == _tree(jax_out)
    assert {"train/data.csv", "train/stats.yaml", "test/data.csv", "test/stats.yaml",
            "across_object/data.csv", "across_object/across_object_stats.yaml",
            "quant_plots.png"} <= set(_tree(port_out))
    port_stats = yaml.safe_load(open(os.path.join(port_folder, "descriptor_statistics.yaml")))
    assert set(port_stats) == set(jax_stats) == {"entire_image", "mask_image"}
    for mode in ("train", "test"):
        pj = pd.read_csv(os.path.join(jax_out, mode, "data.csv"), index_col=0)
        pp = pd.read_csv(os.path.join(port_out, mode, "data.csv"), index_col=0)
        assert list(pp.columns) == list(pj.columns) == EVAL_COLUMNS
        pairs = [list(dict.fromkeys(zip(x["scene_name"], x["img_a_idx"], x["img_b_idx"])))
                 for x in (pj, pp)]
        assert pairs[0] == pairs[1]
        assert set(yaml.safe_load(open(os.path.join(port_out, mode, "stats.yaml")))) == set(
            yaml.safe_load(open(os.path.join(jax_out, mode, "stats.yaml"))))


def test_cli_evaluate_needs_cuda_or_cpu_and_matplotlib_for_panels(port_folder, monkeypatch,
                                                                   capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["evaluate", "--model_folder", port_folder, "--no_qualitative"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit):
        cli.main(["evaluate", "--model_folder", port_folder, "--device", "cpu"])
    assert "--no_qualitative" in capsys.readouterr().err


def test_quantitative_path_needs_no_pandas_matplotlib_or_cv2(port_folder, tmp_path, monkeypatch):
    for name in ("pandas", "matplotlib", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    out = DCE.run_evaluation_on_network(port_folder, num_image_pairs=2,
                                        num_matches_per_image_pair=5, output_dir=str(tmp_path),
                                        qualitative=False, device="cpu")
    assert {"train", "test", "train_csv", "across_object"} <= set(out)
    assert "quant_plots.png" not in _tree(str(tmp_path))
    assert len(table.read_csv(out["train_csv"])) > 0


def test_registry_and_compare_networks(port_folder, tmp_path):
    cfg = {"networks": {"a": {"model_folder": port_folder},
                        "b": {"path_to_network_params": os.path.join(port_folder,
                                                                      "000002.ckpt")}},
           "params": {"num_image_pairs": 2, "num_matches_per_image_pair": 5},
           "output_dir": str(tmp_path)}
    dce = DCE(cfg, device="cpu")
    assert dce.network_names() == ["a", "b"]
    stats = dce.compare_networks(mode="test", tag="t")
    assert set(stats) == {"a", "b"} and stats["a"] == stats["b"]
    assert {"a/test/data.csv", "b/test/data.csv", "comparison_test_t.yaml",
            "comparison_test_t.png"} <= set(_tree(str(tmp_path)))
    with pytest.raises(ValueError, match="not in config"):
        dce.load_network_from_config("c")


# -- keypoints, qualitative, utils, SIFT ------------------------------------------------------


def _keypoint_labels():
    rng = np.random.default_rng(4)
    labels = []
    for scene, idx, oid in (("scene_000", 0, "object_0"), ("scene_001", 2, "object_1"),
                            ("scene_000", 3, "object_0")):
        labels.append({"scene_name": scene, "image_idx": idx, "object_id": oid,
                       "keypoints": {n: {"u": float(rng.uniform(0, W)),
                                         "v": float(rng.uniform(0, H))}
                                     for n in ("toe", "heel", "top")}})
    return labels


def test_keypoint_rows_and_statistics_equal_jax(datasets, tmp_path):
    jds, ds = datasets
    labels = _keypoint_labels()
    want = jax_keypoints.evaluate_network_cross_scene_keypoints(_FakeJaxNet(), jds, labels,
                                                                fused=False)
    path = str(tmp_path / "labels.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(labels, f)
    got = keypoints.evaluate_network_cross_scene_keypoints(_FakeNet(), ds, path)
    clip = _FakeNet().clip_pixel_to_image_size_and_round
    matches = []
    for a, b in itertools.combinations(labels, 2):
        for x, y in ((a, b), (b, a)):
            matches += [(x["scene_name"], x["image_idx"], clip((x["keypoints"][n]["u"],
                                                               x["keypoints"][n]["v"])),
                         y["scene_name"], y["image_idx"], clip((y["keypoints"][n]["u"],
                                                               y["keypoints"][n]["v"])))
                        for n in sorted(x["keypoints"])]
    near = _near_counts(ds, matches)
    _assert_rows_close(got, want, near=near)
    # a mean of distances each within FAKE_F1_D2 in squared distance is
    # within its square root; a mean of fractions within the largest count
    # that may differ
    _assert_rows_close(keypoints.keypoint_statistics(got), jax_keypoints.keypoint_statistics(want),
                       atol={"norm_diff_descriptor_mean": float(np.sqrt(FAKE_F1_D2)),
                             "fraction_pixels_closer_than_ground_truth_mean":
                                 TOL + near[:, 0].max() / (H * W)})
    assert keypoints.plot_keypoint_cdfs(got, str(tmp_path / "cdf.png")) == \
        jax_keypoints.plot_keypoint_cdfs(want)
    bad = copy.deepcopy(labels)
    del bad[1]["keypoints"]["toe"]
    with pytest.raises(ValueError, match="toe"):
        keypoints.evaluate_network_cross_scene_keypoints(_FakeNet(), ds, bad)


def test_keypoint_pipeline_on_a_model_folder(port_folder, tmp_path):
    labels = _keypoint_labels()
    t = keypoints.run_cross_instance_keypoint_evaluation_on_network(
        port_folder, labels, save_folder_name="kp", num_qualitative_pairs=1, device="cpu")
    assert len(t) == 3 * 2 * 3
    files = set(_tree(os.path.join(port_folder, "kp")))
    assert {"data.csv", "keypoint_statistics.csv", "keypoint_cdf.png", "keypoint_stats.yaml",
            "keypoint_qual_00_heel.png"} <= files


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["data"]


def _fig_rgb(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()


def test_numpy_goldens_of_the_jax_package():
    rng = np.random.RandomState(42)
    res_a = rng.randn(12, 16, 3) * 2.0 + 0.3
    res_b = rng.randn(12, 16, 3) * 0.5 - 1.0
    np.testing.assert_allclose(plotting.normalize_descriptor(res_a), _golden("normalize_plain"),
                               atol=1e-12)
    stats = {"min": [-1.0, -2.0, -1.5], "max": [2.5, 2.0, 3.0]}
    np.testing.assert_allclose(plotting.normalize_descriptor(res_a, stats),
                               _golden("normalize_stats"), atol=1e-12)
    na, nb = plotting.normalize_descriptor_pair(res_a, res_b)
    np.testing.assert_allclose(na, _golden("normalize_pair_a"), atol=1e-12)
    np.testing.assert_allclose(nb, _golden("normalize_pair_b"), atol=1e-12)
    rng = np.random.RandomState(7)
    norm_diffs = np.abs(rng.randn(24, 32)).astype(np.float32) * 0.3
    from pdc_tpu_torch.ops.matching import gaussian_heatmap_from_norm_diffs

    np.testing.assert_allclose(gaussian_heatmap_from_norm_diffs(norm_diffs).numpy(),
                               _golden("heat_gray"), atol=1e-6)
    ramp = np.linspace(0.0, 1.0, 256).reshape(8, 32)
    np.testing.assert_array_equal(visualization._jet_colormap(ramp), _golden("jet_numpy"))
    np.testing.assert_array_equal(
        visualization.compute_gaussian_kernel_heatmap_from_norm_diffs(norm_diffs),
        _golden("heat_jet_cv2"))


def test_panel_goldens_of_the_jax_package():
    import matplotlib.pyplot as plt

    from pdc_tpu_torch.data.synthetic import SyntheticScene

    sc = SyntheticScene(width=64, height=48, num_frames=2, seed=5)
    rgb, _, _, _ = sc.render_all()
    rng = np.random.RandomState(5)
    uv_a = np.stack([rng.randint(0, 64, 6), rng.randint(0, 48, 6)], -1)
    uv_b = np.stack([rng.randint(0, 64, 6), rng.randint(0, 48, 6)], -1)
    ax = qualitative.draw_correspondence_panel(rgb[0], rgb[1], uv_a, uv_b, title="golden panel")
    img = _fig_rgb(ax.figure)
    plt.close(ax.figure)
    want = _golden("panel_correspondence")
    assert img.shape == want.shape and np.abs(img.astype(float) - want).mean() <= 1.0
    rng = np.random.RandomState(11)
    res_a = rng.randn(48, 64, 3)
    res_b = rng.randn(48, 64, 3) * 0.7 + 0.2
    mask = (rng.rand(48, 64) > 0.4).astype(np.uint8)
    fig = qualitative.plot_descriptor_colormaps(res_a, res_b, mask_a=mask, mask_b=mask,
                                                plot_masked=True)
    img = _fig_rgb(fig)
    plt.close(fig)
    want = _golden("panel_colormaps")
    assert img.shape == want.shape and np.abs(img.astype(float) - want).mean() <= 1.0


def test_qualitative_suite_writes_its_panels(nets, datasets, tmp_path):
    _, ds = datasets
    _, dcn = nets
    written = qualitative.evaluate_network_qualitative(dcn, ds, num_image_pairs=2,
                                                       output_dir=str(tmp_path / "q"))
    assert set(written) == {"train", "test"} and all(len(v) == 4 for v in written.values())
    samples = qualitative.make_2d_cluster_plot(dcn, ds, num_images=3, num_samples_per_image=8,
                                               plot_background=True,
                                               output_dir=str(tmp_path / "c"))
    assert "background" in samples and all(v.shape[1] == D for v in samples.values())
    assert _tree(str(tmp_path / "c")) == ["cluster_plot_xy.png", "cluster_plot_xz.png",
                                          "cluster_plot_yz.png"]
    # the same panels as pdc_tpu's for the same pixels
    jds, _ = datasets
    jds.reset_seed(5)
    ds.reset_seed(5)
    assert jax_qualitative.get_random_scenes_and_image_pairs(jds, 3) == \
        qualitative.get_random_scenes_and_image_pairs(ds, 3)


def test_utils_equal_jax(nets, datasets, tmp_path):
    cols = ["a", "b"]
    w, jw = eval_utils.PandaDataFrameWrapper(cols), jax_eval_utils.PandaDataFrameWrapper(cols)
    for x in (w, jw):
        x.set_value("a", 3)
        with pytest.raises(KeyError):
            x.set_value("c", 1)
    pd.testing.assert_frame_equal(w.dataframe.to_pandas(), jw.dataframe)
    anns = [{"image_a": {"scene_name": "s", "image_idx": 1,
                         "pixels": [{"u": 1, "v": 2, "keypoint": "k"}, {"u": 3, "v": 4}]},
             "image_b": {"scene_name": "t", "image_idx": 2, "pixels": [{"u": 5, "v": 6},
                                                                      {"u": 7, "v": 8}]}}]
    pd.testing.assert_frame_equal(eval_utils.convert_keypoint_annotations_to_dataframe(anns)
                                  .to_pandas(),
                                  jax_eval_utils.convert_keypoint_annotations_to_dataframe(anns))
    # the descriptor-image export writes the files pdc_tpu's writes
    jdcn, dcn = nets
    jds, ds = datasets
    n = eval_utils.extract_descriptor_images_for_scene(dcn, ds, "scene_001",
                                                       str(tmp_path / "port"), batch_size=3)
    jn = jax_eval_utils.extract_descriptor_images_for_scene(jdcn, jds, "scene_001",
                                                            str(tmp_path / "jax"), batch_size=3)
    names = sorted(os.listdir(tmp_path / "port"))
    assert n == jn == 4 and names == sorted(os.listdir(tmp_path / "jax")) == [
        "%06d_descriptor.npy" % i for i in range(4)]
    for name in names:
        want = np.load(tmp_path / "jax" / name)
        np.testing.assert_allclose(np.load(tmp_path / "port" / name), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_sift_baseline_equals_jax(datasets, tmp_path):
    pytest.importorskip("cv2")
    jds, ds = datasets
    want = JaxDCE.compare_against_sift(jds, num_image_pairs=4, seed=1)
    got = DCE.compare_against_sift(ds, num_image_pairs=4, seed=1)
    _assert_rows_close(got, want)
    r = DCE.single_image_pair_sift_analysis(ds, "scene_000", 0, 2, detector="orb",
                                            output_path=str(tmp_path / "orb.png"))
    rj = JaxDCE.single_image_pair_sift_analysis(jds, "scene_000", 0, 2, detector="orb")
    assert r["good"] == rj["good"] and r["num_keypoints_a"] == rj["num_keypoints_a"]
    np.testing.assert_allclose([x["norm_diff_pred_3d"] for x in r["rows"]],
                               [x["norm_diff_pred_3d"] for x in rj["rows"]], rtol=TOL, atol=TOL)


# -- the anchor: the committed trained model folder ------------------------------------------


@pytest.mark.slow
def test_trained_tpu_journey_pck_against_jax_and_the_bf16_summary():
    """trained_models/tpu_journey on its test split, 50 pairs x 100 matches,
    seed 1, fp32, both packages on the CPU."""
    folder = os.path.join(ROOT, "trained_models", "tpu_journey")
    if not os.path.exists(os.path.join(folder, "003500.ckpt")):
        pytest.skip("trained_models/tpu_journey/003500.ckpt is not in this checkout")
    jdcn = JaxDCN.from_model_folder(folder)
    jds = JaxDCE.load_dataset_from_model_folder(folder)
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    ds = DCE.load_dataset_from_model_folder(folder)
    jds.set_test_mode()
    ds.set_test_mode()
    kw = dict(num_image_pairs=50, num_matches_per_image_pair=100, seed=1)
    assert [p[:3] for p in ev.image_pair_list(ds, 50, 1)] == [
        p[:3] for p in ev.image_pair_list(jds, 50, 1)]
    want = JaxDCE.evaluate_network_quantitative(jdcn, jds, **kw)
    got = DCE.evaluate_network_quantitative(dcn, ds, **kw)
    with open(os.path.join(ROOT, "trained_models", "quantized_serving", "summary.json")) as f:
        bf16 = json.load(f)
    for k in (5, 10):
        px_j = want["pixel_match_error_l2"].to_numpy()
        pair_j = want[["scene_name", "img_a_idx", "img_b_idx"]].astype(str).agg("/".join, axis=1)
        per_pair = pd.Series(px_j <= k).groupby(pair_j.to_numpy()).mean()
        # 3 standard deviations of the PCK over 50 pairs: the spread of the
        # per-pair PCK over the pairs, over sqrt(pairs)
        margin = 3 * float(per_pair.std()) / np.sqrt(len(per_pair))
        pck_j = float(np.mean(px_j <= k))
        pck_p = plotting.cdf_at_threshold(got["pixel_match_error_l2"], k)
        print(f"tpu_journey on the CPU: PCK@{k} port {pck_p:.4f}, pdc_tpu {pck_j:.4f}, "
              f"margin {margin:.4f}")
        assert abs(pck_p - pck_j) <= margin, (k, pck_p, pck_j, margin)
        # the committed bf16 summary: a band, fp32 against bf16 inference on
        # other pixel draws, of the same margin plus 0.05 for the dtype
        ref = bf16["results"]["bf16"][f"pck@{k}px"]
        for v in (pck_j, pck_p):
            assert abs(v - ref) <= margin + 0.05, (k, v, ref, margin)
