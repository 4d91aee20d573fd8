"""The port's deeper backbones (pdc_tpu_torch.models.resnet BottleneckBlock,
ResNet-50/101-8s, dilated_s2b; pdc_tpu_torch.models.unet UNet) against the
JAX package's flax modules, on the CPU at small sizes: the same flax
variables, converted by models/convert.py, give the same outputs in eval
mode and in one train-mode forward (running statistics and gradients
included); build_backbone, the converters and a training run take them.

Tolerances, as tests/test_torch_port_train.py states them for ResNet-18-8s:
outputs 2e-5 relative to their scale (fp32 convolutions summed in another
order, and the bilinear upsample's weights, ~2e-5 per
tests/test_torch_import_numerics.py); gradients 3e-5 of each tensor's
largest; running statistics 1e-5. The train-mode reference is flax's apply
in float64 (``dtype=float64`` under ``jax.enable_x64``): train-mode
BatchNorm's variance ``E[x^2] - E[x]^2`` cancels in fp32, and on the
bottleneck ResNet at 48x64 flax's own fp32 gradients are up to 6% off its
float64 ones where the port's fp32 ones are within 7e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.models import resnet as jax_resnet
from pdc_tpu.models import torch_import as jax_torch_import
from pdc_tpu.models.unet import UNet as JaxUNet
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.models import torch_import
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork, build_backbone
from pdc_tpu_torch.models.resnet import (
    BottleneckBlock,
    ResNet50_8s,
    ResNet101_8s,
    ResNetFCN,
    batch_to_space,
    init_weights_,
    space_to_batch,
)
from pdc_tpu_torch.models.unet import UNet
from pdc_tpu_torch.training.train import DenseCorrespondenceTraining

torch.set_num_threads(2)

D = 3
TINY_BOTTLENECK = (1, 1, 2, 1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(variables, seed):
    """Random BatchNorm scale, bias, mean and var on top of the init, so that
    eval-mode BN is not the identity and a mixed-up statistic shows."""
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, variables)


def _init(jmod, x, seed):
    v = jax.jit(lambda k: jmod.init(k, jnp.asarray(x), train=False))(jax.random.PRNGKey(seed))
    return _perturbed(_np(v), seed)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def _eval_and_train_match(jmod, port, x, seed):
    """Eval forward, then one train-mode forward with its gradients and
    running statistics, flax against the port on the same variables."""
    variables = _init(jmod, x, seed)
    port.load_state_dict(flax_to_state_dict(variables))
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x))
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    _close(got, want)

    cot = np.random.RandomState(seed + 1).standard_normal(want.shape).astype(np.float32)
    with jax.enable_x64(True):
        j64 = jmod.clone(dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def f(params):
            out, mut = j64.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                 jnp.asarray(x, jnp.float64), train=True,
                                 mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (want_t, want_stats)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            v64["params"])
        want_t, want_stats, grads = (jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), t) for t in (want_t, want_stats, grads))
    port.train()
    out = port(_nchw(x))
    (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    _close(out.permute(0, 2, 3, 1).detach().numpy(), want_t)
    gsd = flax_to_state_dict({"params": grads, "batch_stats": variables["batch_stats"]})
    for name, p in port.named_parameters():
        g = gsd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=3e-5 * float(np.abs(g).max()), err_msg=name)
    ssd = flax_to_state_dict({"params": variables["params"], "batch_stats": want_stats})
    for name, buf in port.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ssd[name].numpy(), atol=1e-5, err_msg=name)


# -- BottleneckBlock and the bottleneck ResNets ----------------------------------------------


@pytest.mark.parametrize("in_f,feats,stride,dilation", [
    (16, 4, 1, 1),   # no projection: in == 4 * features, stride 1
    (8, 4, 2, 1),    # projection for the width and the stride
    (16, 8, 1, 2),   # projection for the width; dilated 3x3
])
def test_bottleneck_block_matches_flax(in_f, feats, stride, dilation):
    jmod = jax_resnet.BottleneckBlock(features=feats, stride=stride, dilation=dilation)
    x = np.random.RandomState(in_f + feats).standard_normal((2, 12, 10, in_f)).astype(np.float32)
    port = BottleneckBlock(in_f, feats, stride=stride, dilation=dilation)
    assert (port.proj_conv is None) == (in_f == 4 * feats and stride == 1)
    _eval_and_train_match(jmod, port, x, seed=in_f + stride)


def test_bottleneck_resnet_fcn_matches_flax():
    jmod = jax_resnet.ResNetFCN(num_classes=D, stage_sizes=TINY_BOTTLENECK, bottleneck=True)
    port = ResNetFCN(D, stage_sizes=TINY_BOTTLENECK, bottleneck=True)
    assert port.head.in_channels == 2048
    x = np.random.RandomState(3).standard_normal((2, 48, 64, 3)).astype(np.float32)
    _eval_and_train_match(jmod, port, x, seed=5)


@pytest.mark.parametrize("name", ["Resnet50_8s", "Resnet101_8s", "Unet"])
def test_parameter_counts_equal_flax(name):
    port_fn = {"Resnet50_8s": ResNet50_8s, "Resnet101_8s": ResNet101_8s, "Unet": UNet}[name]
    jax_fn = {"Resnet50_8s": jax_resnet.ResNet50_8s, "Resnet101_8s": jax_resnet.ResNet101_8s,
              "Unet": lambda d: JaxUNet(num_classes=d)}[name]
    shapes = jax.eval_shape(lambda: jax_fn(D).init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 32, 32, 3)), train=False))
    want = {k: v.shape for k, v in flax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    got = {k: tuple(v.shape) for k, v in port_fn(D).state_dict().items()}
    assert got == want
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port_fn(D).parameters()) == n_flax


@pytest.mark.slow
def test_resnet101_8s_matches_flax_at_64x48():
    jmod = jax_resnet.ResNet101_8s(D)
    port = ResNet101_8s(D)
    x = np.random.RandomState(4).standard_normal((1, 48, 64, 3)).astype(np.float32)
    variables = _init(jmod, x, seed=6)
    port.load_state_dict(flax_to_state_dict(variables))
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, want)


# -- dilated_s2b ---------------------------------------------------------------------------------


def test_space_to_batch_round_trip_and_layout():
    x = torch.arange(2 * 3 * 8 * 12, dtype=torch.float32).reshape(2, 3, 8, 12)
    s = space_to_batch(x, 2)
    assert s.shape == (8, 3, 4, 6)
    # residue (1, 0) of image 1 is batch entry (1 * 2 + 0) * 2 + 1
    assert torch.equal(s[5], x[1, :, 1::2, 0::2])
    assert torch.equal(batch_to_space(s, 2, 2), x)
    j = np.asarray(jax_resnet.space_to_batch(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), 2))
    assert np.array_equal(s.permute(0, 2, 3, 1).numpy(), j)


@pytest.mark.parametrize("bottleneck", [False, True])
def test_dilated_s2b_equals_the_dilated_model(bottleneck):
    """The port's s2b model against its dilated model on the same weights
    (the JAX package's own bar, tests/test_models.py:240-280: outputs 2e-5,
    running statistics 1e-5, gradients 1e-5 of the largest), and against
    JAX's s2b model in eval mode."""
    stages = TINY_BOTTLENECK if bottleneck else (2, 2, 2, 2)
    plain = ResNetFCN(D, stage_sizes=stages, bottleneck=bottleneck)
    s2b = ResNetFCN(D, stage_sizes=stages, bottleneck=bottleneck, dilated_s2b=True)
    jmod = jax_resnet.ResNetFCN(num_classes=D, stage_sizes=stages, bottleneck=bottleneck,
                                dilated_s2b=True)
    x = np.random.RandomState(7).standard_normal((2, 64, 96, 3)).astype(np.float32)
    variables = _init(jmod, x, seed=8)
    sd = flax_to_state_dict(variables)
    plain.load_state_dict(sd)
    s2b.load_state_dict(sd)
    xt = _nchw(x)
    with torch.no_grad():
        a, b = plain(xt), s2b(xt)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x))
    _close(b.permute(0, 2, 3, 1).numpy(), want)

    plain.train()
    s2b.train()
    a, b = plain(xt), s2b(xt)
    np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=2e-5)
    for (name, ra), rb in zip(plain.named_buffers(), s2b.buffers()):
        if "running" in name:
            np.testing.assert_allclose(rb.numpy(), ra.numpy(), atol=1e-5, err_msg=name)
    (a * a).sum().backward()
    (b * b).sum().backward()
    for (name, pa), pb in zip(plain.named_parameters(), s2b.parameters()):
        scale = max(float(pa.grad.abs().max()), 1.0)
        np.testing.assert_allclose(pb.grad.numpy() / scale, pa.grad.numpy() / scale, atol=1e-5,
                                   err_msg=name)


def test_dilated_s2b_shape_error_matches_jax():
    x = np.zeros((1, 48, 64, 3), np.float32)  # H/8 = 6 is not divisible by 4
    jmod = jax_resnet.ResNet18_8s(D, dilated_s2b=True)
    with pytest.raises(ValueError, match="divisible by 4") as jerr:
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    with pytest.raises(ValueError, match="divisible by 4") as perr:
        ResNetFCN(D, stage_sizes=(2, 2, 2, 2), dilated_s2b=True)(_nchw(x))
    assert str(perr.value) == str(jerr.value)


# -- UNet ------------------------------------------------------------------------------------------


def test_unet_matches_flax():
    jmod = JaxUNet(num_classes=D, base_features=8)
    port = UNet(D, base_features=8)
    x = np.random.RandomState(9).standard_normal((2, 48, 64, 3)).astype(np.float32)
    _eval_and_train_match(jmod, port, x, seed=10)


def test_unet_rejects_sizes_not_divisible_by_16():
    with pytest.raises(ValueError, match="divisible by 16"):
        UNet(D, base_features=4)(torch.zeros(1, 3, 40, 64))


# -- build_backbone, the converters, model folders, training -------------------------------------


def _cfg(backbone, **extra):
    return {"descriptor_dimension": D, "image_width": 64, "image_height": 48,
            "backbone": backbone, **extra}


@pytest.mark.parametrize("backbone,extra,kind", [
    ({"model_class": "Resnet", "resnet_name": "Resnet18_8s"}, {}, (2, 2, 2, 2)),
    ({"model_class": "Resnet", "resnet_name": "Resnet34_8s"}, {}, (3, 4, 6, 3)),
    ({"model_class": "Resnet", "resnet_name": "Resnet50_8s"}, {}, (3, 4, 6, 3)),
    ({"model_class": "Resnet", "resnet_name": "Resnet101_8s"}, {}, (3, 4, 23, 3)),
    ({"model_class": "Resnet", "resnet_name": "Resnet34_8s"}, {"dilated_s2b": True}, "s2b"),
    ({"model_class": "Resnet", "resnet_name": "Resnet18_8s"}, {"quant_int8": True}, "int8"),
    ({"model_class": "Unet"}, {}, "unet"),
    ({"model_class": "Unet"}, {"quant_int8": True}, "int8"),
])
def test_build_backbone_builds_every_variant(backbone, extra, kind):
    m = build_backbone(_cfg(backbone, **extra))
    if isinstance(kind, tuple):
        assert [len(s) for s in m.stage_blocks] == list(kind)
        assert (m.head.in_channels == 2048) == ("50" in backbone["resnet_name"]
                                               or "101" in backbone["resnet_name"])
    elif kind == "s2b":
        assert m.use_s2b
    elif kind == "unet":
        assert isinstance(m, UNet) and m.head.in_channels == 64
    else:
        assert m.quant_int8 and not m.quant_static
        assert all(c.quant_int8 for c in m.modules() if isinstance(c, torch.nn.Conv2d))


def test_bf16_still_raises_naming_its_slice():
    """bfloat16 compute is ported: it builds every backbone (float32
    parameters, bfloat16 compute; tests/test_torch_port_compute_dtype.py
    holds the numbers), and unknown backbones still raise."""
    for backbone in ({"model_class": "Resnet", "resnet_name": n}
                     for n in ("Resnet18_8s", "Resnet34_8s", "Resnet50_8s", "Resnet101_8s")):
        m = build_backbone(_cfg(backbone, compute_dtype="bfloat16"))
        assert m.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in m.parameters())
    unet = build_backbone(_cfg({"model_class": "Unet"}, compute_dtype="bfloat16"))
    assert isinstance(unet, UNet) and unet.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unsupported resnet_name"):
        build_backbone(_cfg({"model_class": "Resnet", "resnet_name": "Resnet152_8s"}))
    with pytest.raises(ValueError, match="unknown backbone"):
        build_backbone(_cfg({"model_class": "Vgg"}))


@pytest.mark.parametrize("model", ["bottleneck", "unet"])
def test_convert_round_trip_and_flax_layout(model):
    if model == "bottleneck":
        port = ResNetFCN(D, stage_sizes=TINY_BOTTLENECK, bottleneck=True)
        jmod = jax_resnet.ResNetFCN(num_classes=D, stage_sizes=TINY_BOTTLENECK, bottleneck=True)
    else:
        port, jmod = UNet(D, base_features=4), JaxUNet(num_classes=D, base_features=4)
    init_weights_(port, torch.Generator().manual_seed(2))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 48, 3)),
                                              train=False))
    tree = state_dict_to_flax(port.state_dict())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda s: 0, shapes))
    for a, s in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    back = flax_to_state_dict(tree)
    for name, value in port.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(back[name], value), name
    tree["params"]["head"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected flax leaves"):
        flax_to_state_dict(tree)


def _torchvision_layout(module, seed=0):
    """A torchvision-layout state dict of seeded random values for the port
    module's backbone (conv3/bn3 of the bottleneck blocks included)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, value in module.state_dict().items():
        if name.startswith("head."):
            continue
        tv = name.replace("stem_conv", "conv1").replace("stem_bn", "bn1")
        tv = tv.replace("proj_conv", "downsample.0").replace("proj_bn", "downsample.1")
        if tv.startswith("stage"):
            stage, rest = tv.split("_block", 1)
            tv = f"layer{stage[5:]}.{rest}"
        out[tv] = (torch.tensor(7) if value.dtype == torch.long else
                   torch.rand(value.shape, generator=g) + (0.5 if "running_var" in tv else 0))
    return out


def test_torchvision_bottleneck_and_reference_resnet101_folders_convert_like_pdc_tpu():
    module = init_weights_(ResNetFCN(D, stage_sizes=TINY_BOTTLENECK, bottleneck=True),
                           torch.Generator().manual_seed(0))
    tv = _torchvision_layout(module)
    assert "layer3.1.conv3.weight" in tv and "layer1.0.bn3.running_mean" in tv
    variables = state_dict_to_flax(module.state_dict())
    want = flax_to_state_dict(jax_torch_import.convert_torchvision_resnet(
        {k: v.numpy() for k, v in tv.items()}, variables))
    got = torch_import.convert_torchvision_resnet(tv, module.state_dict())
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    assert torch.equal(got["stage3_block1.conv3.weight"], tv["layer3.1.conv3.weight"])

    # a reference-trained checkpoint of the ResNet-101-8s wrapper
    ref = {f"fcn.resnet101_8s.{k}": v for k, v in tv.items()}
    ref["fcn.resnet101_8s.fc.weight"] = torch.rand(D, 2048, 1, 1)
    ref["fcn.resnet101_8s.fc.bias"] = torch.rand(D)
    want = flax_to_state_dict(jax_torch_import.convert_reference_dcn(
        {k: v.numpy() for k, v in ref.items()}, variables))
    got = torch_import.convert_reference_dcn(ref, module.state_dict())
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    assert torch.equal(got["head.weight"], ref["fcn.resnet101_8s.fc.weight"])


@pytest.mark.parametrize("backbone,extra", [
    ({"model_class": "Resnet", "resnet_name": "Resnet50_8s"}, {}),
    ({"model_class": "Unet"}, {}),
    ({"model_class": "Resnet", "resnet_name": "Resnet18_8s"}, {"dilated_s2b": True}),
])
def test_training_driver_trains_the_variants_and_pdc_tpu_reads_the_folder(
        tmp_path, backbone, extra):
    """A few iterations through the driver's default route (K1/K2's plain
    versions on the CPU), finite metrics, moving weights, and a folder that
    pdc_tpu's from_model_folder forwards like the port (1e-4 relative)."""
    from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN

    h, w = (64, 96) if extra.get("dilated_s2b") else (48, 64)
    cfg = copy.deepcopy(DenseCorrespondenceTraining.load_default_config())
    cfg["training"].update(
        num_iterations=3, batch_size=1, num_matching_attempts=128, num_non_matches_per_match=10,
        cross_scene_num_samples=64, save_rate=1000, logging_rate=1000, masked_pool_size=32,
        background_pool_size=32, num_blind_samples=50, use_tensorboard=False,
        logging_dir=str(tmp_path), logging_dir_name="variant")
    net = cfg["dense_correspondence_network"]
    net.update(image_width=w, image_height=h, backbone=backbone, **extra)
    ds = SpartanDataset.make_synthetic(num_scenes=1, width=w, height=h, num_frames=4)
    trainer = DenseCorrespondenceTraining(cfg, ds, device="cpu")
    trainer._ensure_state()
    before = {k: v.detach().clone() for k, v in trainer.state.module.named_parameters()}
    folder = trainer.run()
    losses = trainer._logging_dict["train"]["loss"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    moved = [k for k, v in trainer.state.module.named_parameters()
             if v.dim() > 1 and not torch.equal(v.detach(), before[k])]
    assert moved
    frame = ds.scenes["scene_000"].rgb[0]
    got = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu").forward_on_img(frame)
    want = np.asarray(JaxDCN.from_model_folder(folder).forward_on_img(frame))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
