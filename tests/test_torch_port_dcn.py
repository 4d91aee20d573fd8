"""Port DenseCorrespondenceNetwork (pdc_tpu_torch.models.dcn) against the JAX
one: same weights -> same descriptor images and best matches; model folders
written by either package load in the other; entry points default to CUDA."""

import inspect
import os

import jax
import numpy as np
import pytest
import torch

from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu.utils.yaml_io import save_yaml
from pdc_tpu_torch.models.convert import flax_to_state_dict
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork, build_backbone
from pdc_tpu_torch.models.dcn import find_latest_checkpoint

torch.set_num_threads(2)

W, H, D = 64, 48, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name="Resnet34_8s", normalize=False, w=W, h=H):
    return {"descriptor_dimension": D, "image_width": w, "image_height": h,
            "normalize": normalize,
            "backbone": {"model_class": "Resnet", "resnet_name": name}}


def _port_from_jax(jdcn, device="cpu"):
    dcn = DenseCorrespondenceNetwork.from_config(jdcn.config, device=device)
    dcn.module.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jdcn.variables)))
    return dcn


def _frame(seed, h=H, w=W):
    return np.random.RandomState(seed).randint(0, 256, size=(h, w, 3), dtype=np.uint8)


# descriptors: fp32 convolutions in another summation order and the upsample's
# weights (~2e-5, tests/test_torch_import_numerics.py), relative to the scale
def _assert_desc_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jdcn():
    return JaxDCN.from_config(_cfg(), rng=jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def dcn(jdcn):
    return _port_from_jax(jdcn)


def test_forward_on_img_matches_jax(dcn, jdcn):
    for seed in (0, 1):
        rgb = _frame(seed)
        got = dcn.forward_on_img(rgb)
        assert got.shape == (H, W, D) and got.dtype == torch.float32
        _assert_desc_close(got, jdcn.forward_on_img(rgb))


def test_forward_batch_and_process_network_output(dcn, jdcn):
    x = np.random.RandomState(2).standard_normal((2, H, W, 3)).astype(np.float32)
    out = dcn.forward(x)
    _assert_desc_close(out, jdcn.forward(x))
    flat = dcn.process_network_output(out, 2)
    assert flat.shape == (2, H * W, D)
    v, u = 17, 41
    assert torch.equal(flat[1, v * W + u], out[1, v, u])
    np.testing.assert_array_equal(np.asarray(flat), np.asarray(jdcn.process_network_output(
        np.asarray(out), 2)))


def test_normalize_option_matches_jax(jdcn):
    jn = JaxDCN(jdcn.module, jdcn.variables, D, W, H, normalize=True, config=_cfg(normalize=True))
    pn = _port_from_jax(jn)
    rgb = _frame(3)
    got = pn.forward_on_img(rgb)
    _assert_desc_close(got, jn.forward_on_img(rgb))
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, rtol=1e-5)


def test_best_matches_match_jax(dcn, jdcn):
    rgb_a, rgb_b = _frame(4), _frame(5)
    res_a, res_b = dcn.forward_on_img(rgb_a), dcn.forward_on_img(rgb_b)
    rng = np.random.RandomState(6)
    pts = np.stack([rng.randint(0, W, 12), rng.randint(0, H, 12)], 1)
    queries = res_a[pts[:, 1], pts[:, 0]]
    uv, dist = dcn.find_best_matches_batch(queries, res_b)
    juv, jdist = jdcn.find_best_matches_batch(queries.numpy(), res_b.numpy())
    # tie-tolerant: both chosen pixels lie within the expansion form's
    # cancellation bound (tests/test_torch_port_matching.py) of the true minimum
    r = res_b.numpy().reshape(-1, D).astype(np.float64)
    d2 = ((r[:, None, :] - queries.numpy()[None].astype(np.float64)) ** 2).sum(-1)
    tol = 8 * np.finfo(np.float32).eps * (float((r ** 2).sum(-1).max())
                                         + (queries.numpy().astype(np.float64) ** 2).sum(-1))
    for cand in (uv.numpy(), np.asarray(juv)):
        chosen = d2[cand[:, 1] * W + cand[:, 0], np.arange(12)]
        assert np.all(chosen - d2.min(0) <= tol)
    np.testing.assert_allclose(dist.numpy(), np.sqrt(d2.min(0)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dist.numpy() ** 2, np.asarray(jdist) ** 2, atol=tol.max())

    # single-query API: find_best_match from a pixel of image a
    u0, v0 = map(int, pts[0])
    buv, bdist, nd = dcn.find_best_match((u0, v0), res_a, res_b)
    jbuv, jbdist, jnd = JaxDCN.find_best_match((u0, v0), res_a.numpy(), res_b.numpy())
    np.testing.assert_array_equal(buv.numpy(), np.asarray(jbuv))
    np.testing.assert_allclose(nd.numpy(), np.asarray(jnd), rtol=1e-5, atol=1e-6)
    duv, ddist, _ = dcn.find_best_match_for_descriptor(queries[0], res_b)
    np.testing.assert_array_equal(duv.numpy(), buv.numpy())

    kp = np.array([[3.4, 5.6], [100.0, -4.0], [W - 1, H - 1]])
    np.testing.assert_array_equal(dcn.evaluate_descriptor_at_keypoints(res_b, kp),
                                  jdcn.evaluate_descriptor_at_keypoints(res_b.numpy(), kp))
    for uvp in ((3.4, 5.6), (1e4, -3.0), (-0.6, 47.5)):
        assert (dcn.clip_pixel_to_image_size_and_round(uvp)
                == jdcn.clip_pixel_to_image_size_and_round(uvp))


def _write_folder(folder, jdcn, step):
    os.makedirs(folder, exist_ok=True)
    save_yaml({"dense_correspondence_network": dict(_cfg())},
              os.path.join(folder, "training.yaml"))
    save_yaml({"id": "abc123"}, os.path.join(folder, "identifier.yaml"))
    jdcn.save_checkpoint(os.path.join(folder, "%06d.ckpt" % step))


def test_from_model_folder_reads_jax_checkpoint(tmp_path, jdcn):
    folder = str(tmp_path / "net")
    _write_folder(folder, jdcn, 20)
    other = JaxDCN.from_config(_cfg(), rng=jax.random.PRNGKey(99))
    other.save_checkpoint(os.path.join(folder, "000003.ckpt"))  # older step: not picked
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    assert dcn.model_folder == folder and dcn.constructed_from_model_folder
    assert dcn.unique_identifier == "abc123+000020.ckpt"
    assert find_latest_checkpoint(folder) == os.path.join(folder, "000020.ckpt")
    rgb = _frame(8)
    _assert_desc_close(dcn.forward_on_img(rgb), JaxDCN.from_model_folder(folder).forward_on_img(rgb))
    old = DenseCorrespondenceNetwork.from_model_folder(folder, iteration=3, device="cpu")
    _assert_desc_close(old.forward_on_img(rgb), other.forward_on_img(rgb))
    with pytest.raises(FileNotFoundError):
        DenseCorrespondenceNetwork.from_model_folder(folder, iteration=4, device="cpu")


def test_port_checkpoint_loads_in_pdc_tpu(tmp_path, dcn, jdcn):
    folder = str(tmp_path / "net")
    os.makedirs(folder)
    save_yaml({"dense_correspondence_network": dict(_cfg())},
              os.path.join(folder, "training.yaml"))
    dcn.save_checkpoint(os.path.join(folder, "000005.ckpt"))
    back = JaxDCN.from_model_folder(folder)
    for a, b in zip(jax.tree_util.tree_leaves(back.variables),
                    jax.tree_util.tree_leaves(jdcn.variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    for fn in (DenseCorrespondenceNetwork.from_config,
               DenseCorrespondenceNetwork.from_model_folder,
               DenseCorrespondenceNetwork.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseCorrespondenceNetwork.from_config(_cfg("Resnet18_8s"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseCorrespondenceNetwork.from_config(_cfg("Resnet18_8s"), device="cuda:0")
    dcn = DenseCorrespondenceNetwork.from_config(_cfg("Resnet18_8s"), device="cpu")
    assert dcn.device.type == "cpu"
    assert next(dcn.module.parameters()).device.type == "cpu"


def test_seeded_init_is_device_independent_and_reproducible():
    a = DenseCorrespondenceNetwork.from_config(_cfg("Resnet18_8s"), device="cpu")
    b = DenseCorrespondenceNetwork.from_config(_cfg("Resnet18_8s"), device="cpu")
    c = DenseCorrespondenceNetwork.from_config(
        _cfg("Resnet18_8s"), generator=torch.Generator().manual_seed(1), device="cpu")
    rgb = _frame(9)
    assert torch.equal(a.forward_on_img(rgb), b.forward_on_img(rgb))
    assert not torch.equal(a.forward_on_img(rgb), c.forward_on_img(rgb))


@pytest.mark.parametrize("change", [
    {"backbone": {"model_class": "Unet"}},
    {"backbone": {"model_class": "Resnet", "resnet_name": "Resnet50_8s"}},
    {"compute_dtype": "bfloat16"},
    {"dilated_s2b": True},
    {"quant_int8": True},
    {"backbone": {"model_class": "Resnet", "resnet_name": "Resnet34_8s", "pretrained": True}},
])
def test_unported_options_raise(change, tmp_path, monkeypatch):
    """The options the JAX package offers: the UNet, ResNet-50-8s,
    dilated_s2b, quant_int8 and bfloat16 compute are ported now and build
    and run (their numbers are held against pdc_tpu in
    tests/test_torch_port_variants.py, tests/test_torch_port_int8.py and
    tests/test_torch_port_compute_dtype.py). from_config computes in
    float32 unless asked (pdc_tpu's rule); build_backbone follows the
    config's compute_dtype."""
    cfg = {**_cfg(), **change}
    if change.get("dilated_s2b"):
        cfg.update(image_width=96, image_height=64)  # H/8 and W/8 divisible by 4
    if "pretrained" in str(change):
        # ported: the ImageNet backbone comes from a local file, and without
        # one from_config raises instead of downloading
        monkeypatch.setenv("HOME", str(tmp_path))
        monkeypatch.delenv("PDC_PRETRAINED_WEIGHTS", raising=False)
        with pytest.raises(FileNotFoundError):
            DenseCorrespondenceNetwork.from_config(cfg, device="cpu")
        return
    if "compute_dtype" in change:
        assert build_backbone(cfg).dtype == torch.bfloat16
        dcn = DenseCorrespondenceNetwork.from_config(cfg, device="cpu", dtype=None)
        out = dcn.forward_on_img(_frame(3))
        assert out.dtype == torch.bfloat16 and out.shape == (cfg["image_height"],
                                                             cfg["image_width"], D)
        assert torch.isfinite(out.float()).all()
        assert DenseCorrespondenceNetwork.from_config(cfg, device="cpu").module.dtype == \
            torch.float32
        return
    dcn = DenseCorrespondenceNetwork.from_config(cfg, device="cpu")
    h, w = cfg["image_height"], cfg["image_width"]
    out = dcn.forward_on_img(_frame(3, h=h, w=w))
    assert out.shape == (h, w, D) and torch.isfinite(out).all()
    assert type(build_backbone(cfg)) is type(dcn.module)
    assert dcn.module.quant_int8 == bool(change.get("quant_int8"))


@pytest.mark.slow
def test_trained_resnet34_8s_matches_jax_at_640x480():
    """The committed trained model folder (ResNet-34-8s, 640x480, D=3)."""
    folder = os.path.join(ROOT, "trained_models", "tpu_journey")
    if not os.path.exists(os.path.join(folder, "003500.ckpt")):
        pytest.skip("trained_models/tpu_journey/003500.ckpt is not in this checkout")
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    jdcn = JaxDCN.from_model_folder(folder)
    rgb = _frame(10, h=480, w=640)
    got = dcn.forward_on_img(rgb)
    _assert_desc_close(got, jdcn.forward_on_img(rgb))
    queries = got[[10, 200, 470], [5, 320, 630]]
    uv, dist = dcn.find_best_matches_batch(queries, got)
    assert torch.all(dist < 1e-3)
    np.testing.assert_allclose(got[uv[:, 1].long(), uv[:, 0].long()].numpy(), queries.numpy(),
                               atol=1e-3)


def test_forward_runs_in_eval_mode_whatever_the_module_mode():
    # after training switched the module to train mode, a forward must still
    # give the eval-mode result, move no BatchNorm buffer and hand the mode back
    cfg = _cfg("Resnet18_8s")
    dcn = DenseCorrespondenceNetwork.from_config(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    fresh = DenseCorrespondenceNetwork.from_config(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(1, H, W, 3, generator=torch.Generator().manual_seed(0))
    dcn.module.train()
    buffers = {k: v.clone() for k, v in dcn.module.named_buffers()}
    got = dcn.forward_single_image_tensor(x[0])
    assert dcn.module.training and all(m.training for m in dcn.module.modules())
    for k, v in dcn.module.named_buffers():
        assert torch.equal(v, buffers[k]), k
    want = fresh.forward_single_image_tensor(x[0])
    assert not fresh.module.training
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # the mode comes back also when the forward raises
    with pytest.raises(RuntimeError):
        dcn.forward(torch.zeros(1, H, W, 5))
    assert dcn.module.training


def test_forward_on_img_tensor_warns_and_skips_normalisation_as_jax(dcn, jdcn):
    img = np.random.RandomState(5).uniform(0, 1, (H, W, 3)).astype(np.float32)
    with pytest.warns(DeprecationWarning):
        want = np.asarray(jdcn.forward_on_img_tensor(img))
    with pytest.warns(DeprecationWarning, match="forward_on_img"):
        got = dcn.forward_on_img_tensor(img)
    assert got.shape == (H, W, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    # no mean/std: the normalised frame gives forward_single_image_tensor's answer
    x = (img - np.asarray(dcn.image_mean, np.float32)) / np.asarray(dcn.image_std_dev, np.float32)
    with pytest.warns(DeprecationWarning):
        np.testing.assert_array_equal(dcn.forward_on_img_tensor(x).numpy(),
                                      dcn.forward_single_image_tensor(x).numpy())
