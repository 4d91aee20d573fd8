"""The port's training driver (pdc_tpu_torch.training.train
DenseCorrespondenceTraining and make_eval_loss_step), its Adam-state
converter (models/convert.py) and ImageNet import (models/torch_import.py)
against pdc_tpu, on the CPU at 64x48 with ResNet-18-8s.

  * the test-loss step on the same weights and the same JAX-assembled
    batch: its three metrics within rtol 1e-4 (the train step's bar,
    tests/test_torch_port_train.py: fp32 convolutions summed in another
    order);
  * ``.ckpt.opt`` both ways, bit-exact: the port reads the optax Adam state
    that pdc_tpu's save_network wrote, and flax reads what the port writes;
  * model folders both ways: a folder the port's run wrote loads in
    pdc_tpu's from_model_folder (forward within 1e-4) and resumes in its
    load_pretrained; a folder pdc_tpu wrote resumes in the port's
    run_from_pretrained at its step, with host_lr's LR;
  * each route taken under its config, with finite, falling losses;
    SIGTERM's checkpoint; torchvision weights converted bit-equal to
    pdc_tpu's converter.
"""

import copy
import logging
import os
import shutil
import signal
import sys
import types

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.data.assembler import assemble_batch_matrix as jax_assemble
from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset
from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
from pdc_tpu.models import torch_import as jax_torch_import
from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu.training.train import DenseCorrespondenceTraining as JaxTraining
from pdc_tpu.training.train import TrainState as JaxTrainState
from pdc_tpu.training.train import make_eval_loss_step as jax_make_eval_loss_step
from pdc_tpu.training.train import make_optimizer as jax_make_optimizer
from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models import torch_import
from pdc_tpu_torch.models.checkpoint import packb, read_checkpoint
from pdc_tpu_torch.models.convert import (
    adam_state_to_flax,
    flax_params_to_torch,
    flax_to_state_dict,
    load_adam_state_from_flax,
    state_dict_to_flax,
)
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.models.resnet import ResNet18_8s, init_weights_
from pdc_tpu_torch.training import train as port_train
from pdc_tpu_torch.training.schedule import host_lr
from pdc_tpu_torch.training.train import (
    DenseCorrespondenceTraining,
    create_train_state,
    make_eval_loss_step,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """Each run writes model folders of checkpoints and Adam states (a few hundred MB a test):
    remove them when the test ends, so that a whole run leaves no large files in the
    temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


W, H, D = 64, 48, 3
SYNTH = dict(num_scenes=2, width=W, height=H, num_frames=6)


def tiny_config(tmp_path, name, iters=4, **training):
    cfg = copy.deepcopy(DenseCorrespondenceTraining.load_default_config())
    t = cfg["training"]
    t.update(num_iterations=iters, batch_size=2, num_matching_attempts=256,
             num_non_matches_per_match=10, cross_scene_num_samples=128, save_rate=1000,
             logging_rate=1000, masked_pool_size=64, background_pool_size=64,
             num_blind_samples=100, use_tensorboard=False,
             logging_dir=str(tmp_path), logging_dir_name=name)
    t.update(training)
    net = cfg["dense_correspondence_network"]
    net.update(image_width=W, image_height=H)
    net["backbone"]["resnet_name"] = "Resnet18_8s"
    return cfg


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# -- a folder pdc_tpu wrote; the Adam state both ways ---------------------------------


@pytest.fixture(scope="module")
def jax_folder(tmp_path_factory):
    """A model folder written by pdc_tpu's save_network after 3 Adam steps
    (seeded random gradients; no JAX train step is compiled), removed with
    the module."""
    root = tmp_path_factory.mktemp("jax")
    cfg = tiny_config(root, "jax_run", steps_between_learning_rate_decay=2)
    trainer = JaxTraining(config=cfg, dataset=JaxSpartanDataset.make_synthetic(**SYNTH))
    model, _ = trainer.build_network()
    # the state _ensure_state makes, with the init jitted (op by op it is slow)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, H, W, 3)), train=False))(
        jax.random.PRNGKey(0))
    tx = jax_make_optimizer(cfg)
    params, opt_state = variables["params"], tx.init(variables["params"])
    update = jax.jit(tx.update)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    trainer._model, trainer._tx = model, tx
    trainer._state = JaxTrainState(step=jnp.asarray(3, jnp.int32), params=params,
                                   batch_stats=variables["batch_stats"], opt_state=opt_state)
    trainer.setup_logging_dir()
    trainer.save_configs()
    trainer.save_network(3)
    yield trainer.logging_dir, cfg, _np_tree(params), _np_tree(opt_state), trainer
    shutil.rmtree(root, ignore_errors=True)


# -- the test-loss step ----------------------------------------------------------


def test_eval_loss_step_matches_jax(jax_folder):
    trainer = jax_folder[-1]  # its weights after 3 Adam steps
    ds = JaxSpartanDataset.make_synthetic(**SYNTH)
    batch = ds.make_host_batch(2)
    jcfg = JaxAssemblerConfig(num_matching_attempts=300, masked_pool_size=64,
                              background_pool_size=64, num_blind_samples=100)
    key = jax.random.PRNGKey(0)
    img_a, img_b, idx = jax_assemble(key, batch, jcfg)
    variables = _np_tree({"params": trainer._state.params,
                          "batch_stats": trainer._state.batch_stats})
    want = jax_make_eval_loss_step(trainer._model, JaxLossConfig(), jcfg, W)(
        trainer._state, batch, key)

    module = ResNet18_8s(D)
    module.load_state_dict(flax_to_state_dict(variables))
    port_state = create_train_state(module, {"training": {"learning_rate": 1e-4,
                                                          "learning_rate_decay": 0.9,
                                                          "steps_between_learning_rate_decay": 250,
                                                          "weight_decay": 1e-4}}, device="cpu")
    step = make_eval_loss_step(LossConfig(), AssemblerConfig(), W)
    indices = MatrixSampleIndices(*[torch.as_tensor(np.array(x)) for x in _np_tree(idx)])
    before = {k: v.clone() for k, v in module.state_dict().items()}
    module.train()
    got = step.evaluate(port_state, torch.as_tensor(np.array(img_a)),
                        torch.as_tensor(np.array(img_b)), indices)
    assert set(got) == {"loss", "match_loss", "non_match_loss"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    # eval mode for the call, no update, the caller's mode restored
    assert module.training
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in module.parameters())


def _port_state(cfg):
    module = init_weights_(ResNet18_8s(D), torch.Generator().manual_seed(0))
    return create_train_state(module, cfg, device="cpu")


def test_port_reads_the_adam_state_pdc_tpu_wrote_bit_for_bit(jax_folder):
    folder, cfg, _, opt_state, _ = jax_folder
    state = _port_state(cfg)
    tree = read_checkpoint(os.path.join(folder, "000003.ckpt.opt"))
    assert sorted(tree) == ["0", "1", "2"] and tree["0"] == {}
    adam_count, schedule_count = load_adam_state_from_flax(state.module, state.optimizer, tree)
    assert adam_count == schedule_count == 3
    mu, _ = flax_params_to_torch(opt_state[1].mu)
    nu, _ = flax_params_to_torch(opt_state[1].nu)
    for name, p in state.module.named_parameters():
        st = state.optimizer.state[p]
        assert float(st["step"]) == int(opt_state[1].count) == 3
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
    # the layout mapping, spelled out for one convolution and one BatchNorm
    p = dict(state.module.named_parameters())
    k = opt_state[1].mu["stage2_block0"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        state.optimizer.state[p["stage2_block0.conv1.weight"]]["exp_avg"].numpy(),
        np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        state.optimizer.state[p["stem_bn.weight"]]["exp_avg_sq"].numpy(),
        opt_state[1].nu["stem_bn"]["scale"])

    # and back: flax reads what the port writes, bit for bit
    data = packb(adam_state_to_flax(state.module, state.optimizer, schedule_count))
    back = flax.serialization.from_bytes(opt_state, data)
    _assert_trees_equal(_np_tree(back), opt_state)


def test_pdc_tpu_folder_resumes_in_the_port(tmp_path, jax_folder):
    folder, cfg, params, _, _ = jax_folder
    cfg = copy.deepcopy(cfg)
    cfg["training"].update(num_iterations=2, logging_dir=str(tmp_path), logging_dir_name="resumed")
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    assert trainer.load_pretrained(folder) == 3
    sd = trainer.state.module.state_dict()
    for name, value in flax_to_state_dict({"params": params,
                                           "batch_stats": read_checkpoint(os.path.join(
                                               folder, "000003.ckpt"))["batch_stats"]}).items():
        assert torch.equal(sd[name], value), name
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    out = trainer.run_from_pretrained(folder)
    state = trainer.state
    assert state.step == 5 and state.schedule_start == 0
    # the LR of the last step (iteration 4) is host_lr(4): decayed twice
    assert state.optimizer.param_groups[0]["lr"] == host_lr(cfg, 4) == 1e-4 * 0.9 ** 2
    assert trainer._logging_dict["train"]["iteration"] == [4, 5]
    assert all(float(s["step"]) == 5 for s in state.optimizer.state.values())
    assert sorted(f for f in os.listdir(out) if f.endswith(".ckpt")) == ["000005.ckpt"]

    # a new learning rate starts a fresh Adam state and LR schedule
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    trainer.run_from_pretrained(folder, learning_rate=5e-4)
    state = trainer.state
    assert state.step == 5 and state.schedule_start == 3
    assert state.optimizer.param_groups[0]["lr"] == host_lr(trainer._config, 1) == 5e-4
    assert all(float(s["step"]) == 2 for s in state.optimizer.state.values())
    tree = read_checkpoint(os.path.join(trainer.logging_dir, "000005.ckpt.opt"))
    assert int(tree["1"]["count"]) == 2 and int(tree["2"]["count"]) == 2


# -- a folder the port wrote -------------------------------------------------------------


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A folder of 4 iterations, checkpoints every 2 (2 steps a call; the
    JAX cadence), removed with the module."""
    root = tmp_path_factory.mktemp("port")
    cfg = tiny_config(root, "port_run", iters=4, save_rate=2, steps_per_dispatch=2)
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    yield trainer, trainer.run()
    shutil.rmtree(root, ignore_errors=True)


def test_port_folder_holds_the_model_folder_contract(port_run):
    trainer, folder = port_run
    assert trainer.route == port_train.ROUTE_DEVICE_SAMPLER
    files = set(os.listdir(folder))
    for it in (0, 2, 4):
        assert {"%06d.ckpt" % it, "%06d.ckpt.opt" % it, "%06d_log_history.yaml" % it} <= files
    assert {"training.yaml", "dataset.yaml", "identifier.yaml", "loss.yaml"} <= files
    assert not any(f.endswith(".tmp") for f in files)
    import yaml

    with open(os.path.join(folder, "loss.yaml")) as f:
        loss = yaml.safe_load(f)
    assert loss["train"]["iteration"] == 4 and loss["test"]["loss"] == -1
    assert isinstance(loss["train"]["learning_rate"], float)
    with open(os.path.join(folder, "dataset.yaml")) as f:
        assert yaml.safe_load(f) == {"synthetic": dict(SYNTH, num_objects=2, num_test_scenes=0,
                                                       seed_offset=0)}


def test_port_folder_loads_and_resumes_in_pdc_tpu(port_run):
    trainer, folder = port_run
    jdcn = JaxDCN.from_model_folder(folder)
    pdcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    frame = SpartanDataset.make_synthetic(**SYNTH).scenes["scene_000"].rgb[1]
    want = np.asarray(jdcn.forward_on_img(frame))
    got = pdcn.forward_on_img(frame).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    live = trainer.get_dcn().forward_on_img(frame)
    assert torch.equal(live, pdcn.forward_on_img(frame))

    jtrainer = JaxTraining(config=trainer._config,
                           dataset=JaxSpartanDataset.make_synthetic(**SYNTH))
    assert jtrainer.load_pretrained(folder) == 4
    sd = flax_to_state_dict({"params": _np_tree(jtrainer._state.params),
                             "batch_stats": _np_tree(jtrainer._state.batch_stats)})
    for name, value in trainer.state.module.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(sd[name], value), name
    opt = jtrainer._state.opt_state
    assert int(opt[1].count) == int(opt[2].count) == 4
    mu, _ = flax_params_to_torch(_np_tree(opt[1].mu))
    for name, p in trainer.state.module.named_parameters():
        assert torch.equal(mu[name], trainer.state.optimizer.state[p]["exp_avg"]), name


# -- routes, preemption, options -----------------------------------------------------------


@pytest.mark.parametrize("route,training", [
    (port_train.ROUTE_DEVICE_SAMPLER, {}),
    (port_train.ROUTE_CACHED_HOST_SAMPLER, {"steps_per_dispatch": 1}),
    (port_train.ROUTE_HOST_STREAMING, {"cache_dataset_on_device": False}),
])
def test_each_route_is_taken_and_its_loss_falls(tmp_path, route, training):
    cfg = tiny_config(tmp_path, "route", iters=12, learning_rate=1e-3, **training)
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    trainer.run()
    assert trainer.route == route
    losses = trainer._logging_dict["train"]["loss"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


class FakeSummaryWriter:
    """torch.utils.tensorboard's writer as the driver uses it (the real one
    imports TensorFlow here, which takes longer than the run)."""

    instances = []

    def __init__(self, log_dir):
        self.log_dir, self.scalars, self.closed = log_dir, [], False
        FakeSummaryWriter.instances.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def flush(self):
        pass

    def close(self):
        self.closed = True


def test_budget_fallback_test_loss_tensorboard_and_profiler(tmp_path, monkeypatch):
    """A cache budget too small for the frames falls back to host
    streaming; the test loss runs at its rate; TensorBoard gets every
    step's scalars under the reference's tags; profile_dir gets a trace."""
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = FakeSummaryWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    cfg = tiny_config(tmp_path, "budget", iters=6, device_cache_max_bytes=1000,
                      compute_test_loss=True, compute_test_loss_rate=6,
                      test_loss_num_iterations=4, use_tensorboard=True, logging_rate=3,
                      profile_dir=str(tmp_path / "profile"), profile_num_steps=2)
    ds = SpartanDataset.make_synthetic(**SYNTH)
    trainer = DenseCorrespondenceTraining(cfg, ds, dataset_test=ds, device="cpu")
    folder = trainer.run()
    assert trainer.route == port_train.ROUTE_HOST_STREAMING
    te = trainer._logging_dict["test"]
    assert te["iteration"] == [6]
    assert all(np.isfinite(te[k][0]) for k in ("loss", "match_loss", "non_match_loss"))
    (writer,) = FakeSummaryWriter.instances
    assert writer.log_dir == os.path.join(folder, "tensorboard") and writer.closed
    tags = {"train loss", "train match loss", "train masked non match loss",
            "train background non match loss", "train blind non match loss", "learning rate"}
    assert {t for t, _, _ in writer.scalars} == tags
    assert sorted(it for t, _, it in writer.scalars if t == "train loss") == [1, 2, 3, 4, 5, 6]
    losses = trainer._logging_dict["train"]["loss"]
    assert [v for t, v, _ in writer.scalars if t == "train loss"] == losses
    assert os.path.getsize(tmp_path / "profile" / "trace.json") > 0


def test_sigterm_writes_a_checkpoint_and_returns(tmp_path):
    # 2 steps a call: the checkpoint lands on the end of the first call, at 2
    cfg = tiny_config(tmp_path, "preempt", iters=6, steps_per_dispatch=2)
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    before = signal.getsignal(signal.SIGTERM)

    def kill_at_two(it, metrics):
        if it == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    folder = trainer.run(progress_callback=kill_at_two)
    assert trainer.preempted and trainer.state.step == 2
    assert {"000002.ckpt", "000002.ckpt.opt"} <= set(os.listdir(folder))
    assert "000006.ckpt" not in os.listdir(folder)
    assert signal.getsignal(signal.SIGTERM) is before
    resumed = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    cfg["training"]["num_iterations"] = 1
    assert resumed.load_pretrained(folder) == 2


def test_multi_device_layouts_wait_for_their_slice(tmp_path, caplog):
    ds = SpartanDataset.make_synthetic(**SYNTH)
    # the model axes on one process: JAX's errors (k does not divide 1 device; both set)
    for key in ("tensor_parallel", "pipeline"):
        trainer = DenseCorrespondenceTraining(tiny_config(tmp_path, key, **{key: 2}), ds,
                                              device="cpu")
        with pytest.raises(ValueError, match=f"{key}=2 does not divide the 1 visible devices"):
            trainer.run()
    trainer = DenseCorrespondenceTraining(tiny_config(tmp_path, "both", tensor_parallel=2,
                                                      pipeline=2), ds, device="cpu")
    with pytest.raises(ValueError, match="separate mesh layouts"):
        trainer.run()
    # data_parallel on one process: the JAX package's warning, and one device
    cfg = tiny_config(tmp_path, "dp", iters=1, data_parallel=True, steps_per_dispatch=1)
    with caplog.at_level(logging.WARNING, logger=port_train.logger.name):
        trainer = DenseCorrespondenceTraining(cfg, ds, device="cpu")
        trainer.run()
    assert "data_parallel/fsdp IGNORED" in caplog.text
    assert trainer.writes and trainer._mesh is None
    # on the device-sampler route too it trains on the one device
    # (tests/test_torch_port_parallel.py runs it over 2 gloo ranks)
    cfg = tiny_config(tmp_path, "dp_sampler", iters=2, data_parallel=True, fsdp=True,
                      steps_per_dispatch=2)
    trainer = DenseCorrespondenceTraining(cfg, ds, device="cpu")
    trainer.run()
    assert trainer.route == port_train.ROUTE_DEVICE_SAMPLER and trainer.state.fsdp is None
    if not torch.cuda.is_available():  # the default device is cuda, never a silent CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            DenseCorrespondenceTraining(cfg, ds)


# -- ImageNet initialisation -----------------------------------------------------------------


def _torchvision_state_dict(seed=0):
    """A torchvision-layout ResNet-18 state dict of seeded random values."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, value in ResNet18_8s(D).state_dict().items():
        if name.startswith("head."):
            continue
        tv = name.replace("stem_conv", "conv1").replace("stem_bn", "bn1")
        tv = tv.replace("proj_conv", "downsample.0").replace("proj_bn", "downsample.1")
        if tv.startswith("stage"):
            stage, rest = tv.split("_block", 1)
            tv = f"layer{stage[5:]}.{rest}"
        if value.dtype == torch.long:
            out[tv] = torch.tensor(7)
        else:
            out[tv] = torch.rand(value.shape, generator=g) + (0.5 if "running_var" in tv else 0)
    out["fc.weight"] = torch.rand(1000, 512, generator=g)
    out["fc.bias"] = torch.rand(1000, generator=g)
    return out


def test_torchvision_weights_convert_bit_equal_to_pdc_tpu(tmp_path, monkeypatch):
    tv = _torchvision_state_dict()
    path = str(tmp_path / "resnet18.pth")
    torch.save(tv, path)
    module = init_weights_(ResNet18_8s(D), torch.Generator().manual_seed(0))
    variables = state_dict_to_flax(module.state_dict())
    net_cfg = {"backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s",
                            "pretrained": path}}
    torch_import.maybe_load_pretrained_backbone(module, net_cfg)
    want = flax_to_state_dict(jax_torch_import.convert_torchvision_resnet(
        {k: v.numpy() for k, v in tv.items()}, variables))
    got = module.state_dict()
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    assert torch.equal(got["stem_conv.weight"], tv["conv1.weight"])
    assert torch.equal(got["stage4_block0.proj_bn.running_var"], tv["layer4.0.downsample.1.running_var"])

    # the lookup order of both packages: a path, $PDC_PRETRAINED_WEIGHTS, ~/.cache
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("PDC_PRETRAINED_WEIGHTS", raising=False)
    on = {"backbone": {"resnet_name": "Resnet18_8s", "pretrained": True}}
    for resolve in (torch_import.resolve_pretrained_weights,
                    jax_torch_import.resolve_pretrained_weights):
        assert resolve({"backbone": {"pretrained": False}}) is None
        assert resolve(net_cfg) == path
        with pytest.raises(FileNotFoundError):
            resolve(on)
        with pytest.raises(FileNotFoundError):
            resolve({"backbone": {"pretrained": str(tmp_path / "missing.pth")}})
    cache = tmp_path / ".cache" / "pdc_tpu" / "pretrained"
    cache.mkdir(parents=True)
    torch.save(tv, str(cache / "resnet18.pth"))
    assert torch_import.resolve_pretrained_weights(on) == str(cache / "resnet18.pth")
    monkeypatch.setenv("PDC_PRETRAINED_WEIGHTS", path)
    assert torch_import.resolve_pretrained_weights(on) == path

    # the training driver's state and from_config take the same route
    cfg = tiny_config(tmp_path, "pretrained")
    cfg["dense_correspondence_network"]["backbone"]["pretrained"] = True
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    trainer._ensure_state()
    assert torch.equal(trainer.state.module.stem_conv.weight.detach(), tv["conv1.weight"])
    dcn = DenseCorrespondenceNetwork.from_config(cfg["dense_correspondence_network"],
                                                 device="cpu")
    assert torch.equal(dcn.module.stem_bn.running_mean, tv["bn1.running_mean"])


def test_load_pretrained_backbone_in_place_bit_equal_to_pdc_tpu(tmp_path):
    """``load_pretrained_backbone(dcn, pth)`` against pdc_tpu's on the same
    starting weights: every backbone entry is the torchvision one, the head
    keeps its weights, and the whole state equals pdc_tpu's conversion."""
    tv = _torchvision_state_dict(seed=3)
    path = str(tmp_path / "resnet18.pth")
    torch.save(tv, path)
    dcn = DenseCorrespondenceNetwork.from_config(
        {"descriptor_dimension": D, "image_width": W, "image_height": H,
         "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}, device="cpu")
    head = dcn.module.head.weight.detach().clone()
    jax_dcn = types.SimpleNamespace(variables=state_dict_to_flax(dcn.module.state_dict()))
    jax_torch_import.load_pretrained_backbone(jax_dcn, path)
    assert torch_import.load_pretrained_backbone(dcn, path) is dcn
    got = dcn.module.state_dict()
    want = flax_to_state_dict(jax_dcn.variables)
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    assert torch.equal(got["stage2_block1.conv1.weight"], tv["layer2.1.conv1.weight"])
    assert torch.equal(got["head.weight"], head)
