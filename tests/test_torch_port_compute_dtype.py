"""bfloat16 compute and remat of the port (pdc_tpu_torch.models.resnet,
models/unet.py, models/dcn.py build_backbone, ops/scatter_free.py
take_rows, the losses' gathers, training/train.py) against the JAX
package's ``dtype=jnp.bfloat16`` modules and steps, on the CPU at 48x64.

How the reference is read. XLA's CPU backend keeps a bfloat16
convolution's float32 accumulator when the consumer upcasts it (BatchNorm
computes in float32), where flax's contract, the port and cuDNN round the
convolution's output to bfloat16 first. With that rounding in place
(``lax.reduce_precision`` on every ``nn.Conv`` output, through
``nn.intercept_methods``: :func:`_rounded`) a single layer of the port
equals flax's in all but ~1e-4 of its outputs, where the two float32
accumulation orders round to neighbouring bfloat16 values; without it a
quarter of the first BatchNorm's outputs differ. Over a whole random
network those rare flips grow, so a network is held by a ratio: the
relative RMS difference from flax's bfloat16 output against the one from
the port's own float32 output (the size of bfloat16's effect).

Bars, from readings on this CPU (3 seeds x 2 inputs, 2 threads): whole
networks, eval and train mode, ratio at most 0.67 (bar 0.75); single
blocks at most 0.02 (bar 0.1). The resize in bfloat16 is XLA's bit for
bit. ``take_rows``' backward equals the JAX one-hot matmul's to one
bfloat16 ulp (float32 sums in another order). A bfloat16 step is held at
the F3 bar of tests/test_torch_port_train.py (gradient relative L2 1e-2).
remat is bit-equal to no remat on the CPU.
"""

import copy
import os

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import optax
import pytest
import torch

from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.data.assembler import assemble_batch_matrix as jax_assemble
from pdc_tpu.data.synthetic import SyntheticScene as JaxSyntheticScene
from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
from pdc_tpu.models import resnet as jax_resnet
from pdc_tpu.models.unet import DoubleConv as JaxDoubleConv
from pdc_tpu.models.unet import UNet as JaxUNet
from pdc_tpu.ops.scatter_free import take_rows as jax_take_rows
from pdc_tpu.training.train import build_loss_fn as jax_build_loss_fn
from pdc_tpu.training.train import make_optimizer as jax_make_optimizer
from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.data.synthetic import SyntheticScene
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig, gather_rows
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork, build_backbone
from pdc_tpu_torch.models.resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNetFCN,
    init_weights_,
    resize_bilinear,
)
from pdc_tpu_torch.models.unet import DoubleConv, UNet
from pdc_tpu_torch.ops.scatter_free import take_rows
from pdc_tpu_torch.training.train import create_train_state, make_train_step

torch.set_num_threads(2)

H, W, D = 48, 64, 3
TINY = (1, 1, 1, 1)
BF16 = torch.bfloat16
LR = 1e-4
TC = {"training": {"learning_rate": LR, "learning_rate_decay": 0.9,
                   "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _round_conv_outputs(next_fun, args, kwargs, context):
    out = next_fun(*args, **kwargs)
    if (isinstance(context.module, nn.Conv) and context.method_name == "__call__"
            and out.dtype == jnp.bfloat16):
        out = jax.lax.reduce_precision(out.astype(jnp.float32), exponent_bits=8,
                                       mantissa_bits=7).astype(jnp.bfloat16)
    return out


def _rounded(fn):
    """``fn`` traced with every flax convolution's bfloat16 output rounded
    to bfloat16 (see the module docstring)."""
    def wrapped(*args):
        with nn.intercept_methods(_round_conv_outputs):
            return fn(*args)
    return wrapped


def _perturbed(variables, seed):
    """Random BatchNorm scale, bias, mean and var, so eval mode is not the
    identity."""
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


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _frames(n=2):
    scene = SyntheticScene(width=W, height=H, num_frames=n)
    rgb = np.stack([scene.render(i)[0] for i in range(n)]).astype(np.float32) / 255.0
    return ((rgb - np.array([0.485, 0.456, 0.406], np.float32))
            / np.array([0.229, 0.224, 0.225], np.float32))


def _compare(jmod32, jmod16, port32, port16, x, seed, train, bar):
    """Port bfloat16 against flax bfloat16 and port float32, on the same
    perturbed flax variables; returns the ratio of the module docstring."""
    variables = _perturbed(_np(jax.jit(lambda k: jmod32.init(k, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(seed))), seed)
    sd = flax_to_state_dict(variables)
    port32.load_state_dict(sd)
    port16.load_state_dict(sd)

    def apply(v, x):
        if train:
            return jmod16.apply(v, x, train=True, mutable=["batch_stats"])[0]
        return jmod16.apply(v, x, train=False)

    want = np.asarray(jax.jit(_rounded(apply))(variables, x).astype(jnp.float32))
    port32.train(train)
    port16.train(train)
    with torch.no_grad():
        got16 = port16(_nchw(x))
        got32 = port32(_nchw(x))
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    assert all(b.dtype != BF16 for b in port16.buffers())
    got16 = got16.to(torch.float32).permute(0, 2, 3, 1).numpy()
    got32 = got32.permute(0, 2, 3, 1).numpy()
    assert got16.shape == want.shape
    ratio = _rms(got16, want) / _rms(got16, got32)
    assert ratio <= bar, (ratio, _rms(got16, want), _rms(got16, got32))
    return ratio


# -- the forward --------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["basic", "bottleneck", "unet"])
@pytest.mark.parametrize("inputs", ["noise", "frames"])
def test_bf16_network_matches_flax(kind, train, inputs):
    x = (np.random.RandomState(3).standard_normal((2, H, W, 3)).astype(np.float32)
         if inputs == "noise" else _frames())
    if kind == "unet":
        jm32, jm16 = JaxUNet(num_classes=D, base_features=8), JaxUNet(
            num_classes=D, base_features=8, dtype=jnp.bfloat16)
        p32, p16 = UNet(D, 8), UNet(D, 8, dtype=BF16)
    else:
        b = kind == "bottleneck"
        jm32 = jax_resnet.ResNetFCN(num_classes=D, stage_sizes=TINY, bottleneck=b)
        jm16 = jax_resnet.ResNetFCN(num_classes=D, stage_sizes=TINY, bottleneck=b,
                                    dtype=jnp.bfloat16)
        p32 = ResNetFCN(D, TINY, bottleneck=b)
        p16 = ResNetFCN(D, TINY, bottleneck=b, dtype=BF16)
    with torch.no_grad():
        out_dtype = p16(_nchw(x)).dtype
    # the ResNet's descriptor image is bfloat16, as in JAX; the UNet's float32
    assert out_dtype == (torch.float32 if kind == "unet" else BF16)
    _compare(jm32, jm16, p32, p16, x, 3, train, bar=0.75)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["basic", "bottleneck", "double_conv"])
def test_bf16_block_matches_flax(kind, train):
    x = np.random.RandomState(5).standard_normal((2, 12, 16, 16)).astype(np.float32)
    if kind == "basic":
        jm32, jm16 = (jax_resnet.BasicBlock(features=8, stride=2, dtype=dt)
                      for dt in (jnp.float32, jnp.bfloat16))
        p32, p16 = (BasicBlock(16, 8, stride=2, dtype=dt) for dt in (torch.float32, BF16))
    elif kind == "bottleneck":
        jm32, jm16 = (jax_resnet.BottleneckBlock(features=8, dilation=2, dtype=dt)
                      for dt in (jnp.float32, jnp.bfloat16))
        p32, p16 = (BottleneckBlock(16, 8, dilation=2, dtype=dt) for dt in (torch.float32, BF16))
    else:
        jm32, jm16 = (JaxDoubleConv(features=8, dtype=dt) for dt in (jnp.float32, jnp.bfloat16))
        p32, p16 = DoubleConv(16, 8), DoubleConv(16, 8, dtype=BF16)
    # a block's input is the network's, already in the compute dtype
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    _compare(jm32, jm16, p32, p16, xb, 5, train, bar=0.1)


@pytest.mark.parametrize("shape", [(6, 8, 48, 64), (3, 4, 6, 8), (24, 32, 48, 64)])
def test_bf16_resize_is_xlas_bit_for_bit(shape):
    h, w, Ho, Wo = shape
    x = np.random.RandomState(h).standard_normal((2, h, w, 5)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda a: jax.image.resize(a, (2, Ho, Wo, 5), "linear"))(xb)
                      .astype(jnp.float32))
    got = resize_bilinear(_nchw(np.asarray(xb.astype(jnp.float32))).to(BF16), Ho, Wo)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


# -- take_rows ------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_take_rows_backward_matches_jax(dtype):
    """Rows gathered with repeats (each of 40 pixels drawn ~25 times) and an
    upcast, as the losses gather them; the gradient of a float32 loss of the
    rows. bfloat16: equal to JAX's within one bfloat16 ulp of each value
    (float32 sums in another order, rounded once); float32: rtol 1e-6."""
    rng = np.random.default_rng(0)
    HW, N = 40, 1000
    table = rng.standard_normal((HW, D)).astype(np.float32)
    idx = rng.integers(0, HW, N)
    cot = rng.standard_normal((N, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jloss(p):
        return jnp.sum(jax_take_rows(p, jnp.asarray(idx, jnp.int32)).astype(jnp.float32) * cot)

    jt = jnp.asarray(table, jdt)
    want = np.asarray(jax.jit(jax.grad(jloss))(jt).astype(jnp.float32))
    tt = torch.tensor(np.asarray(jt.astype(jnp.float32))).to(getattr(torch, dtype))
    tt.requires_grad_(True)
    rows = take_rows(tt, torch.as_tensor(idx))
    assert rows.dtype == tt.dtype
    np.testing.assert_array_equal(rows.float().detach().numpy(),
                                  np.asarray(jt.astype(jnp.float32))[idx])
    (rows.to(torch.float32) * torch.as_tensor(cot)).sum().backward()
    assert tt.grad.dtype == tt.dtype
    got = tt.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
    # accumulated in float32: a running sum rounded to bfloat16 after each of
    # the ~25 rows of a pixel is off by several ulps
    acc = torch.zeros(HW, D, dtype=BF16)
    rows16 = torch.as_tensor(cot).to(BF16)
    for n, i in enumerate(idx.tolist()):
        acc[i] = acc[i] + rows16[n]
    assert np.abs(acc.float().numpy() - want).max() > 4 * np.abs(got - want).max()


def test_gather_rows_upcasts_and_keeps_the_gradient_in_the_prediction_dtype():
    pred = torch.randn(2, H * W, D, generator=torch.Generator().manual_seed(0)).to(BF16)
    pred.requires_grad_(True)
    idx = torch.randint(0, H * W, (2, 50), generator=torch.Generator().manual_seed(1))
    valid = torch.ones(2, 50, dtype=torch.bool)
    valid[0, :5] = False
    rows = gather_rows(pred, idx, valid)
    assert rows.dtype == torch.float32 and rows.shape == (2, 50, D)
    rows.sum().backward()
    assert pred.grad.dtype == BF16
    # invalid rows read pixel 0
    assert torch.equal(rows[0, :5], pred[0, :1].float().detach().expand(5, D))


# -- one bfloat16 train step against JAX's ----------------------------------------------------


def _batch():
    scene = JaxSyntheticScene(width=W, height=H, num_frames=6)
    rgb, depth, mask, poses = scene.render_all()
    ia, ib = np.array([0, 1]), np.array([2, 4])
    return dict(rgb_a=rgb[ia], depth_a=depth[ia], mask_a=mask[ia],
                pose_a=poses[ia].astype(np.float32), rgb_b=rgb[ib], depth_b=depth[ib],
                mask_b=mask[ib], pose_b=poses[ib].astype(np.float32),
                K=np.stack([scene.K] * 2).astype(np.float32), match_type=np.zeros(2, np.int32))


def _grads_rel_l2(module, jgrads):
    num = den = 0.0
    for name, p in module.named_parameters():
        g = jgrads[name].numpy()
        num += float(((p.grad.numpy() - g) ** 2).sum())
        den += float((g ** 2).sum())
    return (num / den) ** 0.5


def _assembled(matrix):
    """A batch of B=2 within-scene pairs that JAX assembled, its JAX
    composer, and the port's indices of it."""
    cfg = JaxAssemblerConfig(num_matching_attempts=300, masked_pool_size=64,
                             background_pool_size=64, num_blind_samples=100,
                             num_masked_non_matches_per_match=6,
                             num_background_non_matches_per_match=5, use_matrix_loss=matrix)
    if matrix:
        from pdc_tpu.losses.matrix_loss import compose_loss_matrix as compose

        img_a, img_b, idx = jax_assemble(jax.random.PRNGKey(0), _batch(), cfg)
        s = MatrixSampleIndices(*[torch.as_tensor(np.array(x)) for x in idx])
    else:
        from pdc_tpu.data.assembler import assemble_batch
        from pdc_tpu.losses.composer import compose_loss as compose
        from pdc_tpu_torch.losses.composer import SampleIndices

        img_a, img_b, idx = assemble_batch(jax.random.PRNGKey(0), _batch(), cfg)
        s = SampleIndices(*[torch.as_tensor(np.array(x)) for x in idx])
    return np.asarray(img_a), np.asarray(img_b), idx, compose, s


def _jax_step(dtype, compose, variables, img_a, img_b, idx):
    jm = jax_resnet.ResNetFCN(num_classes=D, stage_sizes=(2, 2, 2, 2), dtype=dtype)
    loss_fn = jax.value_and_grad(jax_build_loss_fn(jm, JaxLossConfig(), W, compose),
                                 has_aux=True)
    if dtype == jnp.bfloat16:
        loss_fn = _rounded(loss_fn)
    (_, (stats, metrics)), grads = jax.jit(loss_fn)(
        variables["params"], variables["batch_stats"], img_a, img_b, idx)
    return _np(metrics), flax_to_state_dict({"params": _np(grads), "batch_stats": _np(stats)})


@pytest.mark.parametrize("matrix", [True, False], ids=["matrix", "per_pair"])
def test_bf16_loss_on_the_same_predictions_matches_jax(matrix):
    """The loss of a bfloat16 network, on JAX's own bfloat16 train-mode
    predictions of the batch: every metric rtol 1e-5, and the gradient with
    respect to the bfloat16 predictions (the cotangent rounded to bfloat16,
    summed in float32 per pixel, returned in bfloat16) equal to JAX's within
    one bfloat16 ulp of each value (atol 1e-3 of the largest). The matrix
    loss's pooled hinge takes the float32 rows the gather upcasts."""
    img_a, img_b, idx, compose, s = _assembled(matrix)
    jm = jax_resnet.ResNetFCN(num_classes=D, stage_sizes=(2, 2, 2, 2), dtype=jnp.bfloat16)
    variables = state_dict_to_flax(init_weights_(ResNetFCN(D, (2, 2, 2, 2)),
                                                 torch.Generator().manual_seed(1)).state_dict())
    imgs = np.concatenate([img_a, img_b])
    pred = jax.jit(_rounded(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0]))(
        variables, imgs).reshape(len(imgs), H * W, D)
    assert pred.dtype == jnp.bfloat16
    B = len(img_a)
    non_empty = (np.asarray(idx.match_type) >= 0).astype(np.float32)

    def jloss(p):
        t = jax.vmap(lambda x, y, r: compose(x, y, r, JaxLossConfig(), W))(p[:B], p[B:], idx)
        return jnp.sum(t.loss * non_empty) / non_empty.sum(), t

    (jl, jt), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(pred)
    from pdc_tpu_torch.training.train import pick_assembly

    tp = torch.tensor(np.asarray(pred.astype(jnp.float32))).to(BF16).requires_grad_(True)
    t = pick_assembly(AssemblerConfig(use_matrix_loss=matrix))[1](
        tp[:B], tp[B:], s, LossConfig(), W)
    ne = torch.as_tensor(non_empty)
    loss = (t.loss * ne).sum() / ne.sum()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("loss", "match_loss", "masked_non_match_loss", "background_non_match_loss",
              "blind_non_match_loss"):
        np.testing.assert_allclose(getattr(t, k).detach().numpy(), np.asarray(getattr(jt, k)),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    loss.backward()
    assert tp.grad.dtype == BF16
    got, want = tp.grad.float().numpy(), np.asarray(jg.astype(jnp.float32))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("matrix", [True, False], ids=["matrix", "per_pair"])
def test_one_bf16_step_matches_jax(matrix):
    """ResNet-18-8s with ``compute_dtype: bfloat16``, one step on a batch that
    JAX assembled, on the same weights, against JAX's bfloat16 step.

    F3's gradient bar (relative L2 1e-2, which the float32 step meets at
    2e-4 on this batch) cannot hold in bfloat16: bfloat16's own effect on
    the gradients is a relative L2 of 0.25-0.28 in both packages (each
    against its float32 step), because the backward's bfloat16 roundings
    land in cancelling sums. So the bars read that band: the port's
    gradients within 0.9 of JAX's own bfloat16-to-float32 distance of JAX's
    (read 0.22 against 0.27, on both losses); the loss rtol 1e-2 (read
    5e-3) and each metric 5e-2 (a hard-negative count that one rounding
    moves normalises a term: read up to 2.8e-2); every parameter within 2 lr
    of JAX's after Adam's first step; running statistics atol 1e-3. The
    parameters, their gradients, Adam's moments and the running statistics
    stay float32."""
    img_a, img_b, idx, compose, s = _assembled(matrix)
    variables = state_dict_to_flax(init_weights_(ResNetFCN(D, (2, 2, 2, 2)),
                                                 torch.Generator().manual_seed(1)).state_dict())
    jmetrics, jgrads = _jax_step(jnp.bfloat16, compose, variables, img_a, img_b, idx)
    _, jgrads32 = _jax_step(jnp.float32, compose, variables, img_a, img_b, idx)
    grads = jax.tree_util.tree_map(np.asarray, state_dict_to_flax(jgrads)["params"])
    tx = jax_make_optimizer(TC)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    after_j = flax_to_state_dict({"params": _np(optax.apply_updates(variables["params"],
                                                                    updates)),
                                  "batch_stats": state_dict_to_flax(jgrads)["batch_stats"]})

    port = build_backbone({"descriptor_dimension": D, "compute_dtype": "bfloat16",
                           "backbone": {"model_class": "Resnet",
                                        "resnet_name": "Resnet18_8s"}})
    assert port.dtype == BF16
    port.load_state_dict(flax_to_state_dict(_np(variables)))
    state = create_train_state(port, TC, device="cpu")
    step = make_train_step(TC, LossConfig(), AssemblerConfig(use_matrix_loss=matrix), W)
    metrics = step.update(state, torch.as_tensor(img_a), torch.as_tensor(img_b), s)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-2)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=5e-2, err_msg=k)

    def rel(a, b):
        num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in b)
        return (num / sum(float((b[n] ** 2).sum()) for n in b)) ** 0.5

    names = [n for n, _ in state.module.named_parameters()]
    mine = {n: p.grad for n, p in state.module.named_parameters()}
    bf16_effect = rel({n: jgrads[n] for n in names}, {n: jgrads32[n] for n in names})
    assert 0.1 < bf16_effect
    assert rel(mine, {n: jgrads[n] for n in names}) <= 0.9 * bf16_effect
    after = state.module.state_dict()
    for name, p in state.module.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        opt = state.optimizer.state[p]
        assert opt["exp_avg"].dtype == opt["exp_avg_sq"].dtype == torch.float32
        d = np.abs(after[name].numpy() - after_j[name].numpy())
        assert d.max() <= 2 * LR * (1 + 1e-3), name
    for name, buf in after.items():
        if "running" in name:
            assert buf.dtype == torch.float32
            np.testing.assert_allclose(buf.numpy(), after_j[name].numpy(), atol=1e-3,
                                       err_msg=name)


# -- remat --------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bottleneck", [False, True], ids=["basic", "bottleneck"])
def test_remat_step_equals_no_remat_bit_for_bit(bottleneck, dtype):
    """A train step with ``remat: true`` against one without, from the same
    weights and batch: the loss, every gradient, the parameters after Adam,
    the running statistics and ``num_batches_tracked`` (moved by exactly
    one) are equal bit for bit on the CPU."""
    cfg = {"descriptor_dimension": D, "compute_dtype": dtype,
           "backbone": {"model_class": "Resnet",
                        "resnet_name": "Resnet50_8s" if bottleneck else "Resnet18_8s"}}
    scene = SyntheticScene(width=W, height=H, num_frames=4)
    rgb, depth, mask, poses = scene.render_all()
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in dict(
        rgb_a=rgb[[0, 1]], depth_a=depth[[0, 1]], mask_a=mask[[0, 1]],
        pose_a=poses[[0, 1]].astype(np.float32), rgb_b=rgb[[2, 3]], depth_b=depth[[2, 3]],
        mask_b=mask[[2, 3]], pose_b=poses[[2, 3]].astype(np.float32),
        K=np.stack([scene.K] * 2).astype(np.float32),
        match_type=np.zeros(2, np.int32)).items()}
    asm = AssemblerConfig(num_matching_attempts=300, masked_pool_size=64,
                          background_pool_size=64, num_blind_samples=100)
    base = init_weights_(build_backbone(cfg), torch.Generator().manual_seed(2))
    runs = []
    for remat in (False, True):
        module = copy.deepcopy(base)
        module.remat = remat
        state = create_train_state(module, TC, device="cpu")
        step = make_train_step(TC, LossConfig(), asm, W)
        metrics = step(state, batch, torch.Generator().manual_seed(0))
        runs.append((metrics, state))
    (m0, s0), (m1, s1) = runs
    assert s1.module.remat and not s0.module.remat
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for (n, p0), p1 in zip(s0.module.named_parameters(), s1.module.parameters()):
        assert torch.equal(p0.grad, p1.grad), n
        assert torch.equal(p0, p1), n
    for (n, b0), b1 in zip(s0.module.state_dict().items(), s1.module.state_dict().values()):
        assert torch.equal(b0, b1), n
        if n.endswith("num_batches_tracked"):
            assert int(b1) == 1, n


def test_remat_recomputes_only_in_train_mode_with_gradients(monkeypatch):
    from pdc_tpu_torch.models import resnet as port_resnet

    calls = []
    real = port_resnet.remat_block
    monkeypatch.setattr(port_resnet, "remat_block",
                        lambda block, x: calls.append(1) or real(block, x))
    m = init_weights_(ResNetFCN(D, TINY, remat=True), torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, H, W)
    with torch.no_grad():
        m.eval()(x)
        m.train()(x)
    assert not calls
    m.train()(x).sum().backward()
    assert len(calls) == 4  # one per residual block
    assert int(m.stem_bn.num_batches_tracked) == 2  # the no-grad train forward, then this one


# -- build_backbone and the constructors ------------------------------------------------------


@pytest.mark.parametrize("backbone", [
    {"model_class": "Resnet", "resnet_name": "Resnet18_8s"},
    {"model_class": "Resnet", "resnet_name": "Resnet34_8s"},
    {"model_class": "Resnet", "resnet_name": "Resnet50_8s"},
    {"model_class": "Resnet", "resnet_name": "Resnet101_8s"},
    {"model_class": "Unet"},
], ids=lambda b: b.get("resnet_name", b["model_class"]))
def test_build_backbone_reads_compute_dtype_and_remat(backbone):
    cfg = {"descriptor_dimension": D, "backbone": backbone, "compute_dtype": "bfloat16",
           "remat": True}
    m = build_backbone(cfg)
    assert m.dtype == BF16
    assert all(p.dtype == torch.float32 for p in m.parameters())
    if backbone["model_class"] == "Resnet":
        assert m.remat
    assert build_backbone(cfg, dtype=torch.float32).dtype == torch.float32
    assert build_backbone({**cfg, "compute_dtype": "float32"}).dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        build_backbone({**cfg, "compute_dtype": "float16"})


def test_from_config_and_model_folder_default_to_float32(tmp_path):
    """As in pdc_tpu: the constructors compute in float32 unless asked,
    whatever the config's compute_dtype; a bfloat16 network's checkpoint is
    the float32 layout and reloads into either."""
    from pdc_tpu_torch.utils.yaml_io import save_yaml

    net = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "compute_dtype": "bfloat16",
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
    assert DenseCorrespondenceNetwork.from_config(net, device="cpu").module.dtype == torch.float32
    dcn16 = DenseCorrespondenceNetwork.from_config(net, device="cpu", dtype=None)
    assert dcn16.module.dtype == BF16
    save_yaml({"dense_correspondence_network": net}, str(tmp_path / "training.yaml"))
    dcn16.save_checkpoint(str(tmp_path / "000001.ckpt"))
    a = DenseCorrespondenceNetwork.from_model_folder(str(tmp_path), device="cpu")
    b = DenseCorrespondenceNetwork.from_model_folder(str(tmp_path), device="cpu", dtype=BF16)
    assert a.module.dtype == torch.float32 and b.module.dtype == BF16
    for (n, x), y in zip(a.module.state_dict().items(), dcn16.module.state_dict().values()):
        assert torch.equal(x, y), n
    rgb = np.random.default_rng(0).integers(0, 255, (H, W, 3), dtype=np.uint8)
    r32, r16 = a.forward_on_img(rgb), b.forward_on_img(rgb)
    assert r32.dtype == torch.float32 and r16.dtype == BF16
    assert torch.equal(r16, dcn16.forward_on_img(rgb))
    assert _rms(r16.float().numpy(), r32.numpy()) < 0.05


# -- the driver, the command line and the entry points in bfloat16 ----------------------------


def _bf16_training_config(tmp_path):
    from pdc_tpu_torch.training.train import DenseCorrespondenceTraining

    cfg = copy.deepcopy(DenseCorrespondenceTraining.load_default_config())
    cfg["training"].update(
        num_iterations=2, batch_size=2, num_matching_attempts=256, num_non_matches_per_match=10,
        cross_scene_num_samples=128, save_rate=1000, logging_rate=1000, masked_pool_size=64,
        background_pool_size=64, num_blind_samples=100, use_tensorboard=False,
        logging_dir=str(tmp_path / "models"), logging_dir_name="bf16")
    net = cfg["dense_correspondence_network"]
    net.update(image_width=W, image_height=H, compute_dtype="bfloat16", remat=True)
    net["backbone"]["resnet_name"] = "Resnet18_8s"
    return cfg


def test_bf16_remat_trains_through_the_cli_and_serves_evaluates_and_streams(tmp_path):
    """``compute_dtype: bfloat16`` with ``remat: true``: ``python -m
    pdc_tpu_torch train`` writes a folder whose checkpoint and Adam state
    are float32 (flax's layout); ``from_model_folder`` builds float32 by
    default and bfloat16 on request; the bfloat16 network's descriptors are
    served (float32 on the wire), evaluated, streamed and saved without a
    dtype error, each within bfloat16's reach of the float32 network."""
    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.apps.compute_descriptor_images import compute_descriptor_images_for_scene
    from pdc_tpu_torch.apps.live_heatmap_visualization import GraspPointStream
    from pdc_tpu_torch.apps.serve import DescriptorClient, DescriptorServer
    from pdc_tpu_torch.data.dataset import SceneData, SpartanDataset
    from pdc_tpu_torch.data.scene import SceneStructure
    from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation
    from pdc_tpu_torch.models.checkpoint import read_checkpoint
    from pdc_tpu_torch.utils.yaml_io import save_yaml

    root = tmp_path / "data"
    for i in range(2):
        SyntheticScene(width=W, height=H, num_frames=4, seed=i).write_scene(
            str(root / "logs_proto" / f"scene_{i}"))
    save_yaml({"object_id": "disc", "train": ["scene_0", "scene_1"], "test": ["scene_1"]},
              str(root / "config" / "disc.yaml"))
    save_yaml({"logs_root_path": "logs_proto", "single_object_scenes_config_files": ["disc.yaml"]},
              str(root / "config" / "composite.yaml"))
    cfg_path = str(tmp_path / "training.yaml")
    save_yaml(_bf16_training_config(tmp_path), cfg_path)
    assert cli.main(["train", "--config", cfg_path, "--dataset_config",
                     str(root / "config" / "composite.yaml"), "--data_dir", str(root),
                     "--device", "cpu"]) == 0
    folder = str(tmp_path / "models" / "bf16")
    for name in ("000002.ckpt", "000002.ckpt.opt"):
        leaves = jax.tree_util.tree_leaves(read_checkpoint(os.path.join(folder, name)))
        floats = [x for x in leaves if np.asarray(x).dtype.kind == "f"]
        assert floats and all(np.asarray(x).dtype == np.float32 for x in floats), name

    dcn32 = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    dcn16 = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu", dtype=BF16)
    assert dcn32.module.dtype == torch.float32 and dcn16.module.dtype == BF16
    assert dcn16.module.remat
    scene = SceneData.from_structure(SceneStructure(str(root / "logs_proto" / "scene_1" /
                                                        "processed")), "scene_1")
    rgb = scene.rgb[1]
    r16, r32 = dcn16.forward_on_img(rgb), dcn32.forward_on_img(rgb)
    assert r16.dtype == BF16
    assert _rms(r16.float().numpy(), r32.numpy()) < 0.05

    # serving: float32 descriptors, and the best match through the kernel's wrapper
    server = DescriptorServer(dcn16, port=0, max_batch=2, max_wait_ms=5.0)
    server.warmup()
    server.start()
    try:
        with DescriptorClient(*server.address, timeout=60.0) as c:
            desc = c.descriptors(rgb)
            uv, dist = c.best_match(rgb, r16.float().numpy()[[5, 20], [7, 30]])
    finally:
        server.shutdown()
    assert desc.dtype == np.float32
    np.testing.assert_array_equal(desc, r16.float().numpy())
    assert uv.shape == (2, 2) and np.all(dist <= 1e-6)

    # the grasp-point stream and descriptor images
    stream = GraspPointStream(dcn16, r16.float().numpy()[[10, 30], [12, 40]])
    uv, dist = stream.process_frame(rgb)
    assert uv.dtype == np.int32 and np.all(dist <= 1e-6)
    out = tmp_path / "desc"
    assert compute_descriptor_images_for_scene(dcn16, scene, str(out)) == scene.num_frames
    saved = np.load(out / "000001_descriptor.npy")
    assert saved.dtype == np.float32
    np.testing.assert_array_equal(saved, r16.float().numpy())

    # evaluation of the bfloat16 network
    ds = SpartanDataset.make_synthetic(num_scenes=2, width=W, height=H, num_frames=4)
    table = DenseCorrespondenceEvaluation.evaluate_network_quantitative(
        dcn16, ds, num_image_pairs=2, num_matches_per_image_pair=5)
    assert len(table) > 0
    stats = DenseCorrespondenceEvaluation.compute_descriptor_statistics_on_dataset(
        dcn16, ds, num_images=3, save_to_file=False)
    assert np.all(np.isfinite(np.asarray(stats["entire_image"]["mean"], np.float64)))


@pytest.mark.slow
def test_trained_tpu_journey_bf16_pck_against_jax():
    """trained_models/tpu_journey served in bfloat16 by both packages on the
    CPU, test split, 50 pairs x 100 matches, seed 1: the port's PCK@5 and
    PCK@10 within 3 standard deviations (of the per-pair PCK, over
    sqrt(pairs)) of pdc_tpu's, and both within the fp32 anchor's margins of
    its values (PCK@5 0.3484 +- 0.072, PCK@10 0.6364 +- 0.081), as the card
    twin holds the port."""
    from pdc_tpu.evaluation.evaluate import DenseCorrespondenceEvaluation as JaxDCE
    from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
    from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation as DCE
    from pdc_tpu_torch.evaluation.plotting import cdf_at_threshold

    folder = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "trained_models", "tpu_journey")
    if not os.path.exists(os.path.join(folder, "003500.ckpt")):
        pytest.skip("trained_models/tpu_journey/003500.ckpt is not in this checkout")
    jdcn = JaxDCN.from_model_folder(folder, dtype=jnp.bfloat16)
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu", dtype=BF16)
    jds = JaxDCE.load_dataset_from_model_folder(folder)
    ds = DCE.load_dataset_from_model_folder(folder)
    jds.set_test_mode()
    ds.set_test_mode()
    kw = dict(num_image_pairs=50, num_matches_per_image_pair=100, seed=1)
    want = JaxDCE.evaluate_network_quantitative(jdcn, jds, **kw)
    got = DCE.evaluate_network_quantitative(dcn, ds, **kw)
    px_j = want["pixel_match_error_l2"].to_numpy()
    pairs = want[["scene_name", "img_a_idx", "img_b_idx"]].astype(str).agg("/".join, axis=1)
    for k, (anchor, anchor_margin) in {5: (0.3484, 0.072), 10: (0.6364, 0.081)}.items():
        per_pair = [float(np.mean(px_j[(pairs == p).to_numpy()] <= k))
                    for p in dict.fromkeys(pairs)]
        margin = 3 * float(np.std(per_pair, ddof=1)) / np.sqrt(len(per_pair))
        pck_j = float(np.mean(px_j <= k))
        pck_p = cdf_at_threshold(got["pixel_match_error_l2"], k)
        print(f"tpu_journey bf16 on the CPU: PCK@{k} port {pck_p:.4f}, pdc_tpu {pck_j:.4f}, "
              f"margin {margin:.4f}")
        assert abs(pck_p - pck_j) <= margin, (k, pck_p, pck_j, margin)
        for v in (pck_p, pck_j):
            assert abs(v - anchor) <= anchor_margin, (k, v, anchor)
