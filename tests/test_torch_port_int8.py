"""The port's int8 serving path (pdc_tpu_torch.ops.int8_conv,
models/resnet.py Int8Conv, DenseCorrespondenceNetwork.quantized and
calibrate_quantization, and the apps' int8 options) against the JAX
package's Int8Conv and quantized clones, on the CPU at small sizes.

Tolerances:
  * the integer product: the ``torch._int_mm`` route and the float64 plain
    version, bit for bit (both are exact);
  * one Int8Conv against flax's jitted apply (as the JAX package runs it)
    on the same weights and input: the scales bit for bit (``/ 127`` as
    XLA's reciprocal product), the outputs within 2 ulps of their largest
    (the integers agree; XLA fuses the dequantization, a multiply-add with
    the bias, and rounds it otherwise in the last bit);
  * whole quantized networks against JAX's on the same input and scales:
    the float32 parts (BatchNorm, the residual adds, the upsample) round
    alike to an ulp or two, but an ulp can flip a later layer's rounding
    by one int8 step; the outputs stay within a tenth of JAX's own int8
    error (its int8 output against its float output), and their L2
    distance within 1% of that error's;
  * calibrated activation scales: each the port's own ``headroom *
    max|x| * fl(1/127)`` over its inputs, bit for bit; against JAX's
    ``quant_scales`` (the frames normalised once, an ulp apart from JAX's
    jitted normalisation) the stem's within 1e-6 relative, and every
    layer's within one int8 step, 1/127 relative: an earlier layer's
    flipped rounding moves the largest activation by a fraction of a step
    (at most 1.4e-3 relative measured);
  * train mode: the float path, bit for bit.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from pdc_tpu.models import resnet as jax_resnet
from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu.models.unet import UNet as JaxUNet
from pdc_tpu_torch import __main__ as cli
from pdc_tpu_torch.apps import serve
from pdc_tpu_torch.apps.live_heatmap_visualization import GraspPointStream
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.models.resnet import (
    Int8Conv,
    ResNetFCN,
    init_weights_,
    int8_convs,
    set_quantization,
)
from pdc_tpu_torch.models.unet import UNet
from pdc_tpu_torch.ops import best_match as bm
from pdc_tpu_torch.ops import int8_conv as ic
from pdc_tpu_torch.utils.yaml_io import save_yaml

torch.set_num_threads(2)

W, H, D = 64, 48, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_CFG = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
SYNTH = {"num_scenes": 2, "num_frames": 5, "width": W, "height": H}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _frames(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n, H, W, 3), dtype=np.uint8)


# -- the integer product -------------------------------------------------------------------------

# (B, C, H, W, O, k, stride, padding, dilation): the conv shapes of ResNet-34-8s
# (the stem's K=147, the stride-2 3x3 and 1x1 projections, the dilated 3x3s,
# the head's N=3) and of the UNet (its first conv's K=27, up3's K=9216, the
# 1x1 up_proj with N not a multiple of 8 below), at small spatial sizes; then
# shapes with M <= 16 and K, N not multiples of 8
SHAPES = [
    (2, 3, 24, 32, 64, 7, 2, 3, 1), (1, 64, 6, 8, 64, 3, 1, 1, 1),
    (2, 64, 6, 8, 128, 3, 2, 1, 1), (2, 64, 6, 8, 128, 1, 2, 0, 1),
    (1, 128, 6, 8, 256, 3, 1, 2, 2), (1, 256, 6, 8, 512, 3, 1, 4, 4),
    (2, 512, 6, 8, 3, 1, 1, 0, 1), (1, 3, 16, 16, 64, 3, 1, 1, 1),
    (1, 1024, 4, 6, 512, 3, 1, 1, 1), (1, 24, 4, 4, 12, 1, 1, 0, 1),
    (1, 5, 3, 4, 7, 3, 1, 1, 1), (1, 13, 2, 3, 3, 1, 1, 0, 1), (3, 9, 2, 2, 17, 3, 2, 1, 1),
    (1, 11, 5, 4, 5, 3, 1, 2, 2),
]


@pytest.mark.parametrize("B,C,h,w,O,k,s,p,d", SHAPES)
def test_int_mm_route_equals_the_plain_version(B, C, h, w, O, k, s, p, d):
    g = torch.Generator().manual_seed(B * 7 + C + O + k)
    x = torch.randint(-127, 128, (B, C, h, w), dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (O, C, k, k), dtype=torch.int8, generator=g)
    want = ic.int8_conv2d_reference(x, wq, s, p, d)
    got = ic.int8_conv2d_int_mm(x, wq, s, p, d)
    assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    # the wrapper takes the plain version on a CPU tensor, and counts nothing
    before = ic.launches
    assert torch.equal(ic.int8_conv2d(x, wq, s, p, d), want)
    assert ic.launches == before


def test_plain_version_is_exact_at_the_largest_sums():
    x = torch.full((1, 1024, 3, 3), -127, dtype=torch.int8)
    wq = torch.full((2, 1024, 3, 3), 127, dtype=torch.int8)
    y = ic.int8_conv2d_reference(x, wq, 1, 0, 1)
    assert int(y[0, 0, 0, 0]) == -127 * 127 * 9216
    assert torch.equal(ic.int8_conv2d_int_mm(x, wq, 1, 0, 1), y)
    with pytest.raises(TypeError, match="int8"):
        ic.int8_conv2d(x.float(), wq)
    with pytest.raises(ValueError):
        ic.int8_conv2d(x, wq[:, :7])


@pytest.mark.parametrize("model", ["resnet", "unet"])
def test_int_mm_route_through_a_whole_network(model, monkeypatch):
    """The route the card takes, run here through a whole quantized network
    on real activations (non-contiguous ones included): the same outputs as
    the plain version's bit for bit, contiguous NCHW as F.conv2d's."""
    from pdc_tpu_torch.models import resnet

    torch.manual_seed(0)
    m = (ResNetFCN(D, stage_sizes=(1, 1, 1, 1)) if model == "resnet"
         else UNet(D, base_features=4))
    set_quantization(init_weights_(m, torch.Generator().manual_seed(1)), True)
    x = torch.randn(2, 3, H, W, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = m(x)
        monkeypatch.setattr(resnet, "int8_conv2d", ic.int8_conv2d_int_mm)
        got = m(x)
    assert got.is_contiguous() and torch.equal(got, want)


# -- Int8Conv against flax ---------------------------------------------------------------------


def _ulps(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -22 * float(np.abs(want).max()))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("k,stride,dilation,bias", [(3, 2, 2, True), (7, 2, 1, False),
                                                     (1, 1, 1, True)])
def test_int8_conv_matches_flax(static, k, stride, dilation, bias):
    rng = np.random.RandomState(k + stride + dilation)
    pad = dilation * (k // 2)
    jc = jax_resnet.Int8Conv(16, (k, k), strides=(stride, stride), padding=[(pad, pad)] * 2,
                             kernel_dilation=(dilation, dilation), use_bias=bias,
                             quant_int8=True, quant_static=static)
    x = (rng.standard_normal((2, 20, 22, 8)) * 3).astype(np.float32)
    v = _np(jc.init(jax.random.PRNGKey(k), x))
    if bias:
        v["params"]["bias"] = rng.standard_normal(16).astype(np.float32)
    pc = Int8Conv(8, 16, k, stride=stride, padding=pad, dilation=dilation, bias=bias).eval()
    pc.set_quantization(True, static)
    pc.load_state_dict(flax_to_state_dict({"params": v["params"],
                                           **({"quant_scales": v["quant_scales"]}
                                              if static else {})}))
    xt = _nchw(x)
    if static:
        # a calibrating pass: the scale rises to max|x| / 127 first, and the
        # same pass quantizes with it; then a pass with the scale as it stands
        want, mut = jax.jit(lambda v, x: jc.apply(v, x, mutable=["quant_scales"]))(v, x)
        pc.calibrating = True
        with torch.no_grad():
            got = pc(xt)
        pc.calibrating = False
        assert float(pc.act_scale) == float(mut["quant_scales"]["act_scale"]) > 0
        _ulps(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
        v = {**v, "quant_scales": _np(mut["quant_scales"])}
        x = x * 1.5  # beyond the calibrated range: saturates at +-127 in both
        xt = _nchw(x)
    want = np.asarray(jax.jit(jc.apply)(v, x))
    with torch.no_grad():
        got = pc(xt).permute(0, 2, 3, 1).numpy()
    _ulps(got, want)
    assert set(pc.state_dict()) == {"weight", *(["bias"] if bias else []),
                                    *(["act_scale"] if static else [])}


# -- whole quantized networks against JAX ---------------------------------------------------------


def _close_to_jax_int8(got, want_q, want_f):
    """The module docstring's bound for a whole quantized network."""
    err = float(np.abs(want_q - want_f).max())
    assert err > 0
    diff = np.abs(got - want_q)
    assert float(diff.max()) <= 0.1 * err, (float(diff.max()), err)
    assert float(np.linalg.norm(diff)) <= 0.01 * float(np.linalg.norm(want_q - want_f))


@pytest.mark.parametrize("model", ["resnet", "unet"])
def test_quantized_network_matches_jax(model):
    if model == "resnet":
        jmod = jax_resnet.ResNetFCN(num_classes=D, stage_sizes=(1, 1, 1, 1))
        port = ResNetFCN(D, stage_sizes=(1, 1, 1, 1))
    else:
        jmod, port = JaxUNet(num_classes=D, base_features=8), UNet(D, base_features=8)
    x = np.random.RandomState(0).standard_normal((2, H, W, 3)).astype(np.float32)
    v = _np(jax.jit(lambda k: jmod.init(k, x, train=False))(jax.random.PRNGKey(0)))
    jq = dataclasses.replace(jmod, quant_int8=True)
    want_q = np.asarray(jax.jit(lambda v, x: jq.apply(v, x, train=False))(v, x))
    want_f = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(v, x))
    port.load_state_dict(flax_to_state_dict(v))
    set_quantization(port, True)
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close_to_jax_int8(got, want_q, want_f)


@pytest.fixture(scope="module")
def nets():
    jdcn = JaxDCN.from_config(NET_CFG, rng=jax.random.PRNGKey(4))
    dcn = DenseCorrespondenceNetwork.from_config(NET_CFG, device="cpu")
    dcn.module.load_state_dict(flax_to_state_dict(_np(jdcn.variables)))
    return jdcn, dcn


def test_calibrated_scales_match_jax(nets):
    jdcn, dcn = nets
    frames = list(_frames(1, 5))
    seen = {}

    def record(name):
        def hook(module, args):
            if module.calibrating:
                seen[name] = max(seen.get(name, 0.0), float(args[0].abs().max()))
        return hook

    convs = int8_convs(dcn.module)
    handles = [c.register_forward_pre_hook(record(n)) for n, c in convs]
    try:
        jq = jdcn.calibrate_quantization(frames, batch_size=2, headroom=1.25)
        q = dcn.calibrate_quantization(frames, batch_size=2, headroom=1.25)
    finally:
        for h in handles:
            h.remove()
    want = flax_to_state_dict(_np(jq.variables))
    convs = int8_convs(q.module)
    assert len(convs) == len(seen) == len([k for k in want if k.endswith("act_scale")]) == 21
    inv = np.float32(1) / np.float32(127)
    for name, conv in convs:
        got = float(conv.act_scale)
        assert got == float(np.float32(np.float32(seen[name]) * inv) * np.float32(1.25)), name
        w = float(want[f"{name}.act_scale"])
        assert w > 0 and abs(got - w) <= (1e-6 if name == "stem_conv" else 1 / 127) * w, name
        assert conv.quant_static and not conv.calibrating
    # JAX's scales through quantized(static=True, variables=...), in flax's
    # layout; its descriptors against JAX's static clone's on the same input
    q2 = dcn.quantized(static=True, variables=_np(jq.variables))
    assert all(float(c.act_scale) == float(want[f"{n}.act_scale"])
               for n, c in int8_convs(q2.module))
    x = np.asarray(dcn.normalize_on_device(_frames(2, 2)))
    _close_to_jax_int8(q2.forward(x).numpy(), np.asarray(jq.forward(x)),
                       np.asarray(jdcn.forward(x)))


def test_train_mode_runs_the_float_path(nets):
    _, dcn = nets
    x = _nchw(np.random.RandomState(3).standard_normal((2, H, W, 3)).astype(np.float32))
    outs, grads = [], []
    for quant in (False, True):
        m = init_weights_(ResNetFCN(D, stage_sizes=(2, 2, 2, 2)), torch.Generator().manual_seed(0))
        set_quantization(m, quant)
        m.train()
        y = m(x)
        (y * y).sum().backward()
        outs.append(y.detach())
        grads.append([p.grad for p in m.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert sum(float(g.abs().sum()) for g in grads[1]) > 0
    # a quant_int8 training config trains the float convolutions
    cfg = dict(NET_CFG, quant_int8=True)
    m = DenseCorrespondenceNetwork.from_config(cfg, device="cpu").module
    assert m.quant_int8 and all(c.quant_int8 for _, c in int8_convs(m))


def test_quantized_clone_shares_weights_and_leaves_the_float_forward(nets):
    _, dcn = nets
    rgb = _frames(5, 1)[0]
    before = dcn.forward_on_img(rgb)
    q = dcn.quantized()
    s = dcn.calibrate_quantization(list(_frames(6, 3)))
    assert torch.equal(dcn.forward_on_img(rgb), before)
    assert not dcn.module.quant_int8 and q.module.quant_int8 and not q.module.quant_static
    assert s.module.quant_static and q.config["quant_int8"] and "quant_int8" not in dcn.config
    for clone in (q, s):
        assert clone.module is not dcn.module
        for (n, a), b in zip(dcn.module.named_parameters(), clone.module.parameters()):
            assert a is b, n
        assert clone.module.stem_bn.running_var is dcn.module.stem_bn.running_var
        assert clone.module.stem_conv.act_scale is not dcn.module.stem_conv.act_scale
    assert not any(k.endswith("act_scale") for k in dcn.module.state_dict())
    assert not any(k.endswith("act_scale") for k in q.module.state_dict())
    # the static clone's scales go to a checkpoint as flax's quant_scales
    tree = state_dict_to_flax(s.module.state_dict())
    assert set(tree) == {"params", "batch_stats", "quant_scales"}
    assert float(tree["quant_scales"]["stage4_block1"]["conv2"]["act_scale"]) == float(
        s.module.stage4_block1.conv2.act_scale)
    back = flax_to_state_dict(tree)
    assert torch.equal(back["head.act_scale"], s.module.head.act_scale)
    tree["quant_scales"]["head"]["other"] = np.float32(1)
    with pytest.raises(ValueError, match="unexpected quant_scales leaf"):
        flax_to_state_dict(tree)
    # shared: a change to the float network's weights shows in its clones
    got = q.forward_on_img(rgb)
    with torch.no_grad():
        dcn.module.head.bias.add_(1.0)
    try:
        assert torch.allclose(q.forward_on_img(rgb), got + 1.0, atol=1e-5)
    finally:
        with torch.no_grad():
            dcn.module.head.bias.sub_(1.0)


def test_quantized_and_calibrate_errors(nets):
    _, dcn = nets
    with pytest.raises(ValueError, match="calibrate_quantization"):
        dcn.quantized(static=True)
    with pytest.raises(ValueError, match="calibrate_quantization"):
        dcn.quantized(static=True, variables={"head.act_scale": 0.1})
    with pytest.raises(ValueError, match="at least one frame"):
        dcn.calibrate_quantization([])
    plain = DenseCorrespondenceNetwork(torch.nn.Conv2d(3, D, 1), D, W, H, device="cpu")
    with pytest.raises(ValueError, match="no int8 serving path"):
        plain.quantized()
    with pytest.raises(ValueError, match="no static int8 path"):
        plain.calibrate_quantization(list(_frames(0, 1)))
    # a static clone's own scales serve quantized(static=True) of it
    s = dcn.calibrate_quantization(list(_frames(7, 2)))
    s2 = s.quantized(static=True)
    assert all(float(a.act_scale) == float(b.act_scale) for (_, a), (_, b) in
               zip(int8_convs(s.module), int8_convs(s2.module)))


def test_grasp_stream_on_a_quantized_network(nets):
    _, dcn = nets
    q = dcn.calibrate_quantization(list(_frames(8, 4)))
    frames = _frames(9, 3)
    res0 = q.forward_on_img(frames[0])
    descriptors = res0[[5, 20, 40], [3, 30, 60]].numpy()
    stream = GraspPointStream(q, descriptors)
    before = bm.launches
    for f in frames:
        uv, dist = stream.process_frame(f)
        res = q.forward_on_img(f).permute(2, 0, 1).reshape(1, D, H * W).contiguous()
        idx, d = bm.best_match_reference(res, torch.from_numpy(descriptors)[None])
        assert np.array_equal(uv[:, 1] * W + uv[:, 0], idx[0].numpy())
        np.testing.assert_allclose(dist, d[0].numpy(), atol=1e-6)
    assert bm.launches == before  # the plain version on the CPU


# -- the CLIs -----------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(nets, tmp_path_factory):
    """A model folder the port wrote, with a synthetic dataset record."""
    _, dcn = nets
    path = str(tmp_path_factory.mktemp("models") / "net")
    os.makedirs(path)
    save_yaml({"dense_correspondence_network": NET_CFG}, os.path.join(path, "training.yaml"))
    save_yaml({"synthetic": SYNTH}, os.path.join(path, "dataset.yaml"))
    dcn.save_checkpoint(os.path.join(path, "000010.ckpt"))
    return path


@pytest.mark.parametrize("flag", ["--int8", "--int8_static"])
def test_cli_serve_with_int8(flag, folder, monkeypatch, capsys):
    """``serve --int8_static`` serves a clone calibrated on the first 16
    frames of the first scene of the folder's dataset, ``--int8`` the
    dynamic clone (one-frame batches: its scales depend on the batch). The
    answers equal that clone's forward_on_img within 1e-4 of the scale and
    the plain best match on it."""
    served = {}

    def serve_a_few(self):
        self.start()
        host, port = self.address
        with serve.DescriptorClient(host, port, timeout=60.0) as c:
            for seed in range(2):
                rgb = _frames(20 + seed, 1)[0]
                served[seed] = (rgb, c.descriptors(rgb),
                                c.best_match(rgb, np.asarray([[0.1, 0.2, 0.3]], np.float32)))

    monkeypatch.setattr(serve.DescriptorServer, "serve_forever", serve_a_few)
    assert cli.main(["serve", "--model_folder", folder, "--port", "0", "--max_batch", "1",
                     "--device", "cpu", flag]) in (0, None)
    assert "serving" in capsys.readouterr().out
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    if flag == "--int8_static":
        first = SpartanDataset.make_synthetic(**SYNTH).scenes["scene_000"]
        q = dcn.calibrate_quantization(list(first.rgb[:16]))
    else:
        q = dcn.quantized()
    for rgb, desc, (uv, dist) in served.values():
        want = q.forward_on_img(rgb)
        np.testing.assert_allclose(desc, want.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
        res = want.permute(2, 0, 1).reshape(1, D, H * W).contiguous()
        idx, d = bm.best_match_reference(res, torch.tensor([[[0.1, 0.2, 0.3]]]))
        assert int(uv[0, 1]) * W + int(uv[0, 0]) == int(idx[0, 0])
        np.testing.assert_allclose(dist, d[0].numpy(), rtol=1e-4, atol=1e-5)


# -- the trained model on its test split ----------------------------------------------------------


def _exact_jax_int8_product(monkeypatch):
    """Route pdc_tpu's s8 x s8 -> s32 convolution (an XLA integer convolution,
    about 20 s a 320x240 ResNet-34-8s forward on a CPU) through two float32
    convolutions of the same weights: ``x = 16 * (x >> 4) + (x & 15)``, and
    each part's sums are integers of magnitude at most ``15 * 127 * K <
    2^24``, so exact in any order. The int32 result is the same."""
    conv = jax.lax.conv_general_dilated
    jnp = jax.numpy

    def exact(lhs, rhs, *args, preferred_element_type=None, **kw):
        if lhs.dtype != jnp.int8 or preferred_element_type != jnp.int32:
            return conv(lhs, rhs, *args, preferred_element_type=preferred_element_type, **kw)
        k = rhs.size // rhs.shape[-1]  # HWIO: K = KH * KW * C
        assert 15 * 127 * k < 2 ** 24, k
        xi, w = lhs.astype(jnp.int32), rhs.astype(jnp.float32)
        hi, lo = (conv(p.astype(jnp.float32), w, *args, **kw).astype(jnp.int32)
                  for p in (xi >> 4, xi & 15))
        return 16 * hi + lo

    rng = np.random.RandomState(0)
    x = rng.randint(-127, 128, (2, 9, 11, 512)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 512, 64)).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    args = (x, w, (1, 1), [(2, 2), (2, 2)])
    kw = dict(rhs_dilation=(2, 2), dimension_numbers=dn, preferred_element_type=jnp.int32)
    assert np.array_equal(np.asarray(exact(*args, **kw)), np.asarray(conv(*args, **kw)))
    monkeypatch.setattr(jax.lax, "conv_general_dilated", exact)


@pytest.mark.slow
def test_trained_tpu_journey_int8_pck_against_jax(monkeypatch):
    """trained_models/tpu_journey on its test split, 50 pairs x 100 matches,
    seed 1: the port's int8 and int8-static clones against pdc_tpu's on the
    CPU (static scales from 16 train frames, seed 7, batches of 8, as
    examples/quantized_serving_eval.py calibrates), PCK@5 and PCK@10 within
    3 standard deviations of the per-pair PCK over the pairs. Both integer
    products take an exact route that is fast on a CPU: the port's
    ``torch._int_mm`` route (bit for bit the plain version, above), and
    pdc_tpu's through :func:`_exact_jax_int8_product`."""
    import pandas as pd

    from pdc_tpu.evaluation.evaluate import DenseCorrespondenceEvaluation as JaxDCE
    from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation as DCE
    from pdc_tpu_torch.evaluation.plotting import cdf_at_threshold

    folder = os.path.join(ROOT, "trained_models", "tpu_journey")
    if not os.path.exists(os.path.join(folder, "003500.ckpt")):
        pytest.skip("trained_models/tpu_journey/003500.ckpt is not in this checkout")
    torch.set_num_threads(max(2, min(8, os.cpu_count() or 2)))
    _exact_jax_int8_product(monkeypatch)
    monkeypatch.setattr(ic, "int8_conv2d_reference", ic.int8_conv2d_int_mm)
    nets = {}
    for name, cls, kw in (("jax", JaxDCN, {}), ("port", DenseCorrespondenceNetwork,
                                                 {"device": "cpu"})):
        dcn = cls.from_model_folder(folder, **kw)
        train = dcn.load_training_dataset("train")
        train.reset_seed(7)
        calib = [train.get_random_rgbd_mask_pose()[0] for _ in range(16)]
        nets[name] = {"int8": dcn.quantized(),
                      "int8_static": dcn.calibrate_quantization(calib, batch_size=8)}
    jds = JaxDCE.load_dataset_from_model_folder(folder)
    ds = DCE.load_dataset_from_model_folder(folder)
    jds.set_test_mode()
    ds.set_test_mode()
    kw = dict(num_image_pairs=50, num_matches_per_image_pair=100, seed=1)
    with open(os.path.join(ROOT, "trained_models", "quantized_serving", "summary.json")) as f:
        summary = json.load(f)["results"]
    for label in ("int8", "int8_static"):
        want = JaxDCE.evaluate_network_quantitative(nets["jax"][label], jds, **kw)
        got = DCE.evaluate_network_quantitative(nets["port"][label], ds, **kw)
        px_j = want["pixel_match_error_l2"].to_numpy()
        pair_j = want[["scene_name", "img_a_idx", "img_b_idx"]].astype(str).agg("/".join, axis=1)
        for k in (5, 10):
            per_pair = pd.Series(px_j <= k).groupby(pair_j.to_numpy()).mean()
            margin = 3 * float(per_pair.std()) / np.sqrt(len(per_pair))
            pck_j = float(np.mean(px_j <= k))
            pck_p = cdf_at_threshold(got["pixel_match_error_l2"], k)
            print(f"tpu_journey {label} on the CPU: PCK@{k} port {pck_p:.4f}, pdc_tpu "
                  f"{pck_j:.4f}, margin {margin:.4f}, summary {summary[label][f'pck@{k}px']}")
            assert abs(pck_p - pck_j) <= margin, (label, k, pck_p, pck_j, margin)


@pytest.mark.slow
def test_int8_witness_against_jax(monkeypatch):
    """The evidence for ``chip_smoke.py`` phase 13 (d)'s int8 bars, as
    ``tools/torch_int8_witness.py`` describes it: phase 8's folder trained on
    the card (its convolution weights rounded to float16) read on the 240x320
    crops of its frames by ``pdc_tpu``'s quantized clones and by the port's on
    the CPU, each with its own fp32 forward as the reference. Skips without
    the files that script writes on the card.

      * JAX's cosine and the port's: within 5% of JAX's own int8 loss
        (1 - cosine), for the dynamic and static clones and the control
        (truncation instead of rounding), where an ulp flips a rounding;
      * the port's on the CPU against the port's on the card, same weights
        and crops: within 10% of that loss (cuDNN's float32 convolutions and
        the CPU's differ by ulps, and each flips some roundings);
      * phase 13 (d)'s cosine bar lies between the control and every
        reading: JAX's on the crops, the card's on the full frames.
    """
    import importlib.util

    wdir = os.path.join(ROOT, "chiprun_out", "int8_witness")
    if not os.path.exists(os.path.join(wdir, "readings.json")):
        pytest.skip("run tools/torch_int8_witness.py on the card first")
    spec = importlib.util.spec_from_file_location(
        "torch_int8_witness", os.path.join(ROOT, "tools", "torch_int8_witness.py"))
    wit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wit)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.set_num_threads(max(2, min(8, os.cpu_count() or 2)))
    _exact_jax_int8_product(monkeypatch)
    monkeypatch.setattr(ic, "int8_conv2d_reference", ic.int8_conv2d_int_mm)

    with open(os.path.join(wdir, "readings.json")) as f:
        record = json.load(f)
    state = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in np.load(os.path.join(wdir, "weights.npz")).items()}
    saved = np.load(os.path.join(wdir, "frames.npz"))
    rgb, mask0 = wit.crop(saved["rgb"]), wit.crop(saved["mask"])[0]
    cfg = dict(record["config"], image_width=rgb.shape[2], image_height=rgb.shape[1])
    cfg["backbone"] = {k: v for k, v in cfg["backbone"].items() if k != "pretrained"}
    port = DenseCorrespondenceNetwork.from_config(cfg, device="cpu")
    port.module.load_state_dict(state)
    jdcn = JaxDCN.from_config(cfg)
    jdcn.variables = state_dict_to_flax({k: v.numpy() for k, v in state.items()})

    def read(net, clone, to_np):
        fp32 = np.stack([to_np(net.forward_on_img(f)) for f in rgb[:4]])
        return wit.int8_readings(fp32, np.stack([to_np(clone.forward_on_img(f))
                                                 for f in rgb[:4]]), mask0)

    got = {}
    for name, net, to_np in (("jax", jdcn, np.asarray), ("port", port, lambda t: t.numpy())):
        with torch.inference_mode():
            got[name] = {"dynamic": read(net, net.quantized(), to_np),
                         "static": read(net, net.calibrate_quantization(list(rgb)), to_np)}
            if name == "jax":
                with monkeypatch.context() as m:
                    m.setattr(jax.numpy, "round", jax.numpy.trunc)
                    got[name]["control"] = read(net, net.quantized(), to_np)
            else:
                with wit.truncating(torch):
                    got[name]["control"] = read(net, net.quantized(), to_np)
    card = record["readings"]["float16 weights"]
    for label in ("dynamic", "static", "control"):
        j, p, c = got["jax"][label], got["port"][label], card[f"crop {label}"]
        print(f"int8 witness, {label}, 240x320 crops: cosine pdc_tpu {j['cos']:.6f}, port "
              f"CPU {p['cos']:.6f}, port card {c['cos']:.6f}; picks near/exact of "
              f"{wit.N_QUERIES}: pdc_tpu {j['near']}/{j['exact']}, port CPU "
              f"{p['near']}/{p['exact']}, card {c['near']}/{c['exact']}; full frames on the "
              f"card {card[f'full {label}']}")
        assert abs(j["cos"] - p["cos"]) <= 0.05 * (1 - j["cos"]), label
        assert abs(p["cos"] - c["cos"]) <= 0.1 * (1 - j["cos"]), label
    readings = [got["jax"][k]["cos"] for k in ("dynamic", "static")] + [
        card[f"full {k}"]["cos"] for k in ("dynamic", "static")]
    controls = [got["jax"]["control"]["cos"], card["full control"]["cos"]]
    assert max(controls) < cs.INT8_COS_MIN < min(readings), (controls, readings)
