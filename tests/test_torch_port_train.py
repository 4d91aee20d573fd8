"""Port train step (pdc_tpu_torch.training.train) against the JAX step:
train-mode BatchNorm against flax ``train=True``, one step of ResNet-18-8s
on the same converted weights and the same JAX-assembled batch, the LR
schedule and optimizer, a few steps where the loss falls, and
chip_smoke.py's inline training values against configs/training.yaml.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.data.assembler import assemble_batch_matrix as jax_assemble
from pdc_tpu.data.synthetic import SyntheticScene
from pdc_tpu.losses.matrix_loss import compose_loss_matrix as jax_compose
from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
from pdc_tpu.models.resnet import ResNetFCN as JaxResNetFCN
from pdc_tpu.training import schedule as jax_schedule
from pdc_tpu.training.train import build_loss_fn as jax_build_loss_fn
from pdc_tpu.training.train import make_optimizer as jax_make_optimizer
from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models.convert import flax_to_state_dict
from pdc_tpu_torch.models.resnet import ResNetFCN, init_weights_
from pdc_tpu_torch.training import schedule
from pdc_tpu_torch.training.train import create_train_state, make_train_step

torch.set_num_threads(2)

H, W, D = 48, 64, 3
R18 = (2, 2, 2, 2)
LR = 1e-4
TC = {"training": {"learning_rate": LR, "learning_rate_decay": 0.9,
                   "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _state_dict(params, batch_stats):
    return flax_to_state_dict({"params": _np_tree(params), "batch_stats": _np_tree(batch_stats)})


def test_train_mode_batchnorm_matches_flax():
    """Output, parameter gradients and updated running statistics of one
    train-mode forward of 2B images. Tolerances: outputs 2e-5 of their
    scale, gradients 3e-5 of each leaf's largest (fp32 convolutions summed
    in another order), statistics atol 1e-5."""
    jm = JaxResNetFCN(num_classes=D, stage_sizes=R18)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 24, 32, 3)), train=False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 24, 32, 3)).astype(np.float32)
    cot = rng.standard_normal((4, 24, 32, D)).astype(np.float32)

    def f(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (want, want_stats)), grads = jax.value_and_grad(f, has_aux=True)(variables["params"])
    port = ResNetFCN(D, stage_sizes=R18)
    port.load_state_dict(_state_dict(variables["params"], variables["batch_stats"]))
    port.train()
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), want, rtol=2e-5,
                               atol=2e-5 * float(np.abs(want).max()))
    gsd = _state_dict(grads, variables["batch_stats"])
    for name, p in port.named_parameters():
        g = gsd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=3e-5 * float(np.abs(g).max()),
                                   err_msg=name)
    ssd = _state_dict(variables["params"], want_stats)
    for name, buf in port.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ssd[name].numpy(), atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def jax_step():
    """One JAX step (loss, gradients, parameters, batch_stats after it) on a
    JAX-assembled batch of B=2 within-scene pairs, and its inputs."""
    scene = SyntheticScene(width=W, height=H, num_frames=6)
    rgb, depth, mask, poses = scene.render_all()
    ia, ib = np.array([0, 1]), np.array([2, 4])
    batch = dict(rgb_a=rgb[ia], depth_a=depth[ia], mask_a=mask[ia],
                 pose_a=poses[ia].astype(np.float32), rgb_b=rgb[ib], depth_b=depth[ib],
                 mask_b=mask[ib], pose_b=poses[ib].astype(np.float32),
                 K=np.stack([scene.K] * 2).astype(np.float32), match_type=np.zeros(2, np.int32))
    cfg = JaxAssemblerConfig(num_matching_attempts=300, masked_pool_size=64,
                             background_pool_size=64, num_blind_samples=100)
    img_a, img_b, idx = jax_assemble(jax.random.PRNGKey(0), batch, cfg)
    jm = JaxResNetFCN(num_classes=D, stage_sizes=R18)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)), train=False)
    loss_fn = jax_build_loss_fn(jm, JaxLossConfig(), W, jax_compose)
    (loss, (stats, metrics)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], variables["batch_stats"], img_a, img_b, idx)
    tx = jax_make_optimizer(TC)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    params = optax.apply_updates(variables["params"], updates)
    return dict(variables=variables, img_a=np.asarray(img_a), img_b=np.asarray(img_b),
                idx=_np_tree(idx), metrics=_np_tree(metrics),
                grads=_state_dict(grads, variables["batch_stats"]),
                after=_state_dict(params, stats))


def test_one_step_matches_jax(jax_step):
    """Tolerances, and why: the loss and its metrics rtol 1e-4 (measured
    ~1e-6; the blind term ~5e-5). Gradients by relative L2 norm over all
    leaves, 1e-2: the model alone agrees to 3e-5 (above) and the loss's
    gradient on identical predictions to 1e-6
    (tests/test_torch_port_matrix_loss.py), but composed on this batch a
    rounding-level difference in the forward flips a few ReLU gates and
    moves whole upstream gradients (a few 1e-3 on this batch). Parameters after Adam's first step move by
    about lr * sign(g): all within 2 lr of JAX's, and 99.9% of the elements
    whose |g| exceeds 1e-3 of their leaf's largest within 1e-2 lr.
    BatchNorm statistics atol 1e-5."""
    v = jax_step["variables"]
    port = ResNetFCN(D, stage_sizes=R18)
    port.load_state_dict(_state_dict(v["params"], v["batch_stats"]))
    state = create_train_state(port, TC, device="cpu")
    step = make_train_step(TC, LossConfig(), AssemblerConfig(), W)
    idx = MatrixSampleIndices(*[torch.as_tensor(np.array(x)) for x in jax_step["idx"]])
    metrics = step.update(state, torch.as_tensor(jax_step["img_a"]),
                          torch.as_tensor(jax_step["img_b"]), idx)
    assert state.step == 1 and set(metrics) == set(jax_step["metrics"])
    for k, want in jax_step["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4, err_msg=k)

    num = den = 0.0
    close = total = 0
    after = state.module.state_dict()
    for name, p in state.module.named_parameters():
        g = jax_step["grads"][name].numpy()
        num += float(((p.grad.numpy() - g) ** 2).sum())
        den += float((g ** 2).sum())
        d = np.abs(after[name].numpy() - jax_step["after"][name].numpy())
        assert d.max() <= 2 * LR * (1 + 1e-3), name
        sig = np.abs(g) > 1e-3 * np.abs(g).max()
        close += int((d[sig] <= 1e-2 * LR).sum())
        total += int(sig.sum())
    assert (num / den) ** 0.5 <= 1e-2
    assert close >= 0.999 * total
    for name, buf in after.items():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), jax_step["after"][name].numpy(), atol=1e-5,
                                       err_msg=name)


def test_lr_schedule_and_optimizer(tmp_path, monkeypatch):
    for i in (0, 1, 249, 250, 251, 999, 3499):
        assert schedule.host_lr(TC, i) == jax_schedule.host_lr(TC, i)
    state = create_train_state(ResNetFCN(D, stage_sizes=R18), TC, device="cpu")
    group = state.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-4 and group["lr"] == LR
    # ImageNet initialisation reads a local file and never downloads: none
    # there raises (tests/test_torch_port_training_driver.py loads one)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("PDC_PRETRAINED_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="pretrained"):
        pretrained = {**TC, "dense_correspondence_network": {"backbone": {"pretrained": True}}}
        create_train_state(ResNetFCN(D, stage_sizes=R18), pretrained, device="cpu")
    with pytest.raises(NotImplementedError, match="per-pair"):
        make_train_step(TC, LossConfig(), AssemblerConfig(use_matrix_loss=False), W)
    if not torch.cuda.is_available():  # the default device is cuda, never a silent CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            create_train_state(ResNetFCN(D, stage_sizes=R18), TC)


def test_loss_falls_over_a_few_steps():
    """Eight steps of the port alone on one assembled synthetic batch (its
    own assembly, torch.Generator draws): the loss falls."""
    scene = SyntheticScene(width=W, height=H, num_frames=6)
    rgb, depth, mask, poses = scene.render_all()
    ia, ib = np.array([0, 3]), np.array([1, 4])
    batch = dict(rgb_a=rgb[ia], depth_a=depth[ia], mask_a=mask[ia], pose_a=poses[ia],
                 rgb_b=rgb[ib], depth_b=depth[ib], mask_b=mask[ib], pose_b=poses[ib],
                 K=np.stack([scene.K] * 2), match_type=np.zeros(2, np.int32))
    tc = copy.deepcopy(TC)
    tc["training"]["learning_rate"] = 1e-3
    module = init_weights_(ResNetFCN(D, stage_sizes=R18), torch.Generator().manual_seed(0))
    state = create_train_state(module, tc, device="cpu")
    step = make_train_step(tc, LossConfig(),
                           AssemblerConfig(num_matching_attempts=500, masked_pool_size=128,
                                           background_pool_size=128, num_blind_samples=200), W)
    assembled = step.assemble(state, batch, torch.Generator().manual_seed(1))
    losses = [float(step.update(state, *assembled)["loss"]) for _ in range(8)]
    assert np.isfinite(losses).all() and state.step == 8
    assert np.mean(losses[-2:]) < 0.9 * losses[0], losses


def test_chip_smoke_training_values_match_the_yaml():
    """chip_smoke.py states the training values inline (the card's machine
    has no yaml); they must equal configs/training.yaml."""
    import yaml

    import chip_smoke

    with open("configs/training.yaml") as f:
        cfg = yaml.safe_load(f)
    inline = chip_smoke.TRAINING_CONFIG
    for section, values in inline.items():
        for key, value in values.items():
            assert cfg[section][key] == value, (section, key)
    assert AssemblerConfig.from_training_config(inline) == AssemblerConfig.from_training_config(cfg)
    assert (LossConfig.from_dict(inline["loss_function"])
            == LossConfig.from_dict(cfg["loss_function"]))
