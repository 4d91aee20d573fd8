"""K train steps per call (pdc_tpu_torch.training.scanned
make_scanned_train_step, training.schedule make_lr_schedule and the
trainer's cadence on the device-sampler route) against pdc_tpu, on the CPU
at 64x48 with ResNet-18-8s.

  * make_lr_schedule equals optax's staircase exponential_decay bit for
    bit at every count from 0 to 3 x steps_between_learning_rate_decay,
    also from a resumed state (the count is the steps since the schedule
    started); the capturable update reads it from the device count;
  * device_sample_pairs is device_sample_pairs_mixed's type-0 case, draw
    for draw;
  * one call of K steps equals K single steps from a clone of the state
    and the generator, bit for bit on the CPU: parameters, running
    statistics, Adam's moments and counts, the [K] metrics and the
    generator, within-scene and with synthetic multi-object rows; a call
    reckons 2K pooled-hinge passes each way;
  * the [K] metrics have the keys and shapes of pdc_tpu's
    make_scanned_train_step on a cache of the same dataset;
  * synthetic multi-object rows composited in every row and selected by
    type (the assembly's composite_every_row, JAX's form): JAX's rows on
    the same draws,
    and on the matrix route the batch assembled without compositing in the
    other rows;
  * the trainer with K=4, save_rate 6, logging_rate 2 and 12 iterations
    against pdc_tpu's trainer: the same iterations, learning rates,
    checkpoint names and callback iterations, and a SIGTERM checkpoint at
    the end of the first call in both.
"""

import copy
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset
from pdc_tpu.data.device_cache import DeviceCache as JaxDeviceCache
from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
from pdc_tpu.models.dcn import build_backbone as jax_build_backbone
from pdc_tpu.training.scanned import make_scanned_train_step as jax_make_scanned_train_step
from pdc_tpu.training.schedule import make_lr_schedule as jax_make_lr_schedule
from pdc_tpu.training.train import DenseCorrespondenceTraining as JaxTraining
from pdc_tpu.training.train import create_train_state as jax_create_train_state
from pdc_tpu_torch.data import assembler as tasm
from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.data.device_cache import DeviceCache
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.training import scanned
from pdc_tpu_torch.training import train as port_train
from pdc_tpu_torch.training.schedule import host_lr, make_lr_schedule
from pdc_tpu_torch.training.train import DenseCorrespondenceTraining, create_train_state
from tests.test_torch_port_per_pair import (  # noqa: F401 (draws and jax_assembled are fixtures)
    JAX_CFG,
    MATCH_TYPES,
    _jax_per_pair_draws,
    _stack_draws,
    assert_indices_agree,
    draws,
    jax_assembled,
    jax_smo_draws,
    port_config,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """The trainers' runs write model folders (checkpoints and Adam states): remove them
    when the test ends, so that a whole run leaves no large files in the temporary
    directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


W, H = 64, 48
SYNTH = dict(num_scenes=2, width=W, height=H, num_frames=6)
# two objects, for synthetic multi-object rows
SYNTH_OBJECTS = dict(num_scenes=4, num_objects=2, width=W, height=H, num_frames=6)
WITHIN = {"SINGLE_OBJECT_WITHIN_SCENE": 1.0}
SMO_MIX = {"SINGLE_OBJECT_WITHIN_SCENE": 0.5, "SYNTHETIC_MULTI_OBJECT": 0.5}
K = 3
# the trainer's case: pdc_tpu saves at 0 and 12, and calls back at 4, 8 and 12
CADENCE = dict(iters=12, steps_per_dispatch=4, save_rate=6, logging_rate=2)


def tiny_config(root, name, iters=4, **training):
    cfg = copy.deepcopy(DenseCorrespondenceTraining.load_default_config())
    t = cfg["training"]
    t.update(num_iterations=iters, batch_size=2, num_matching_attempts=256,
             num_non_matches_per_match=10, cross_scene_num_samples=128, save_rate=1000,
             logging_rate=1000, masked_pool_size=64, background_pool_size=64,
             num_blind_samples=100, use_tensorboard=False, logging_dir=str(root),
             logging_dir_name=name)
    t.update(training)
    net = cfg["dense_correspondence_network"]
    net.update(image_width=W, image_height=H)
    net["backbone"]["resnet_name"] = "Resnet18_8s"
    return cfg


def _port_setup(mix, synth=SYNTH):
    cfg = tiny_config("unused", "unused", data_type_probabilities=mix)
    ds = SpartanDataset.make_synthetic(**synth)
    ds.set_parameters_from_training_config(cfg)
    cache = DeviceCache.from_dataset(ds, device="cpu")
    module, _ = DenseCorrespondenceTraining(cfg, ds, device="cpu").build_network()
    state = create_train_state(module, cfg, device="cpu")
    probs = tuple(sorted(ds._data_type_probabilities.items()))
    args = (cfg, LossConfig.from_dict(cfg["loss_function"]),
            AssemblerConfig.from_training_config(cfg), W, cache, 2)
    return cfg, state, probs, args


def _clone_generator(gen):
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


# -- the learning-rate schedule --------------------------------------------------------


@pytest.mark.parametrize("lr,decay,steps", [(1e-4, 0.9, 250), (3e-4, 0.9, 5), (2.5e-5, 0.95, 3)],
                         ids=["default", "short", "other_rate"])
@pytest.mark.parametrize("schedule_start", [0, 7], ids=["fresh", "resumed"])
def test_lr_schedule_equals_optax(lr, decay, steps, schedule_start):
    cfg = {"training": {"learning_rate": lr, "learning_rate_decay": decay,
                        "steps_between_learning_rate_decay": steps}}
    counts = np.arange(3 * steps + 1)
    want = np.asarray(jax.jit(jax.vmap(jax_make_lr_schedule(cfg)))(jnp.asarray(counts,
                                                                               jnp.int32)))
    schedule = make_lr_schedule(cfg)
    for step in range(schedule_start, schedule_start + 3 * steps + 1):
        count = step - schedule_start  # TrainState.step - schedule_start
        got = schedule(torch.tensor(count))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy() == want[count], (count, float(got), want[count])
        assert float(got) == pytest.approx(host_lr(cfg, count), rel=1e-6)


def test_device_update_reads_the_schedule_at_the_device_count():
    """The capturable update's LR is the schedule of the steps since it
    started (a resumed state: step 260, schedule started at 5), written into
    Adam's LR tensor; the device count then advances and the host count is
    the caller's. A float Adam on the CPU with a tensor LR stands in for the
    capturable one (CUDA only)."""
    cfg, state, probs, args = _port_setup(WITHIN)  # 250 steps between decays
    step = scanned.make_device_sampled_train_step(*args, probs)
    state.optimizer = torch.optim.Adam(state.module.parameters(), lr=torch.tensor(1.0),
                                       foreach=False, weight_decay=1e-4)
    state.step, state.schedule_start = 260, 5
    step.count.fill_(state.step - state.schedule_start)
    gen = torch.Generator().manual_seed(0)
    batch = step.cache.gather(step.sample(gen))
    metrics = step.device_update(state, *step.assemble(state, batch, gen))
    want = np.asarray(jax_make_lr_schedule(cfg)(jnp.int32(255)))
    assert state.optimizer.param_groups[0]["lr"].numpy() == want
    assert float(want) == pytest.approx(1e-4 * 0.9, rel=1e-6)
    assert int(step.count) == 256 and state.step == 260
    assert np.isfinite(float(metrics["loss"]))


# -- the sampler -------------------------------------------------------------------------


def test_device_sample_pairs_is_the_type0_case_of_the_mixed_sampler():
    ds = SpartanDataset.make_synthetic(**SYNTH_OBJECTS)
    cache = DeviceCache.from_dataset(ds, device="cpu")
    tables = scanned.build_sampling_tables(cache)
    poses = torch.as_tensor(cache.poses, dtype=torch.float32)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = scanned.device_sample_pairs(g1, tables["scene_offsets"], tables["scene_lengths"],
                                      poses, 64)
    want = scanned.device_sample_pairs_mixed(g2, tables, poses, 64, ((0, 1.0),))
    for a, b in zip(got, want):
        assert a.dtype == torch.int64 and torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())
    fa, fb, mt = got
    assert set(mt.tolist()) <= {0, -1} and (mt == 0).float().mean() > 0.8
    scene = np.searchsorted(tables["scene_offsets"].numpy(), fa.numpy(), side="right")
    assert (scene == np.searchsorted(tables["scene_offsets"].numpy(), fb.numpy(),
                                     side="right")).all()


# -- one call of K steps against K steps ---------------------------------------------------


def _adam_state(state):
    return [(p, {k: v.clone() for k, v in state.optimizer.state[p].items()})
            for p in state.module.parameters()]


@pytest.mark.parametrize("mix,synth", [(WITHIN, SYNTH), (SMO_MIX, SYNTH_OBJECTS)],
                         ids=["within_scene", "synthetic_multi_object"])
def test_one_call_of_k_steps_equals_k_single_steps(mix, synth):
    cfg, state, probs, args = _port_setup(mix, synth)
    call = scanned.make_scanned_train_step(*args, K, type_probs=probs)
    assert isinstance(call, scanned.ScannedTrainStep) and not call.graphed
    single = scanned.make_device_sampled_train_step(*args, probs)
    gen = torch.Generator().manual_seed(11)
    twin, twin_gen = copy.deepcopy(state), _clone_generator(gen)
    got = call(state, gen)
    want = [single(twin, twin_gen) for _ in range(K)]
    assert set(got) == set(want[0])
    for k, v in got.items():
        assert v.shape == (K,) and v.dtype == torch.float32
        assert torch.equal(v, torch.stack([m[k] for m in want])), k
    assert state.step == twin.step == K
    for (a, b) in zip(state.module.state_dict().items(), twin.module.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    for (p, st), (q, st2) in zip(_adam_state(state), _adam_state(twin)):
        assert st.keys() == st2.keys() and all(torch.equal(st[k], st2[k]) for k in st)
    assert torch.equal(gen.get_state(), twin_gen.get_state())
    if mix is SMO_MIX:
        assert (got["loss"] > 0).all()


def test_a_call_reckons_2k_pooled_hinge_passes_each_way():
    """On the CPU the plain hinge stands in for K1 and K2, and a call
    records its passes: 2 a step (masked and background pools), 2K a
    call, each way. On the card the capture records them and every replay
    counts them (tests/test_torch_port_cuda.py)."""
    _, state, probs, args = _port_setup(WITHIN)
    call = scanned.make_scanned_train_step(*args, 2, type_probs=probs)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        call(state, gen)
        assert call.launches_per_dispatch == {"forward": 4, "backward": 4}


def test_metrics_keys_and_shapes_equal_jax():
    """pdc_tpu's scanned step and the port's on caches of the same seeded
    dataset, 2 steps a call: the same metric names, each of shape [2]."""
    acfg = JaxAssemblerConfig(num_matching_attempts=128, masked_pool_size=64,
                              background_pool_size=64, num_blind_samples=32)
    jds = JaxSpartanDataset.make_synthetic(**SYNTH)
    jcache = JaxDeviceCache.from_dataset(jds)
    config = {"training": {"learning_rate": 1e-3, "learning_rate_decay": 0.9,
                           "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4},
              "dense_correspondence_network": {
                  "descriptor_dimension": 3,
                  "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}}
    model = jax_build_backbone(config["dense_correspondence_network"])
    jstate, tx = jax_create_train_state(model, config, jax.random.PRNGKey(0), (H, W))
    jstep = jax_make_scanned_train_step(model, tx, JaxLossConfig(), acfg, W, jcache,
                                        batch_size=2, steps_per_dispatch=2)
    jstate, jm = jstep(jstate, jax.random.PRNGKey(1))

    cfg = tiny_config("unused", "unused")
    cfg["training"].update(config["training"])
    ds = SpartanDataset.make_synthetic(**SYNTH)
    cache = DeviceCache.from_dataset(ds, device="cpu")
    module, _ = DenseCorrespondenceTraining(cfg, ds, device="cpu").build_network()
    state = create_train_state(module, cfg, device="cpu")
    call = scanned.make_scanned_train_step(cfg, LossConfig(), port_config(acfg), W, cache, 2, 2)
    m = call(state, torch.Generator().manual_seed(1))
    assert set(m) == set(jm)
    for k in jm:
        assert tuple(m[k].shape) == np.asarray(jm[k]).shape == (2,), k
        assert m[k].dtype == torch.float32 and np.asarray(jm[k]).dtype == np.float32
        assert np.isfinite(m[k].numpy()).all()
    assert int(jstate.step) == state.step == 2


# -- synthetic multi-object rows composited in every row --------------------------------


def test_select_form_rows_equal_jax_on_the_same_draws(draws, jax_assembled):
    """assemble_batch with composite_every_row given JAX's draws: each row's
    own stages, then every row's synthetic multi-object sample (JAX's
    assemble_batch composites every row and keeps the type-4 ones), gives
    JAX's rows (as tests/test_torch_port_per_pair.py's bars)."""
    batch, _, jimg_b, jidx = jax_assembled
    keys = jax.random.split(jax.random.PRNGKey(0), len(MATCH_TYPES))
    given = _stack_draws([_jax_per_pair_draws(k, JAX_CFG) for k in keys])
    given += _stack_draws([jax_smo_draws(k, JAX_CFG, matrix=False) for k in keys])
    d = draws(given)
    _, img_b, s = tasm.assemble_batch(batch, port_config(JAX_CFG),
                                      torch.Generator().manual_seed(0), "cpu",
                                      composite_every_row=True)
    assert not d.given
    np.testing.assert_allclose(img_b.numpy(), jimg_b, rtol=1e-6, atol=1e-6)
    assert s.match_type.tolist() == MATCH_TYPES.tolist()
    assert_indices_agree(s, jidx, exact=("matches_a", "masked_nm_a", "background_nm_a",
                                         "match_type"))


def test_select_form_on_the_matrix_route_keeps_the_other_rows():
    """The matrix route with composite_every_row: the rows of other types
    are the batch assembled without compositing, the type-4 rows the
    matrix sample of every row's two pairs on the generator that follows."""
    ds = SpartanDataset.make_synthetic(**SYNTH_OBJECTS)
    ds._data_type_probabilities = {0: 0.4, 2: 0.2, 4: 0.4}
    ds.reset_seed(3)
    batch = ds.make_host_batch(6)
    smo = batch["match_type"] == 4
    assert smo.any() and (~smo).any()
    cfg = tasm.AssemblerConfig(num_matching_attempts=200, num_blind_samples=50,
                               masked_pool_size=48, background_pool_size=40,
                               enable_synthetic_multi_object=True)
    img_a, img_b, s = tasm.assemble_batch_matrix(batch, cfg, torch.Generator().manual_seed(9),
                                                 "cpu", composite_every_row=True)
    g = torch.Generator().manual_seed(9)
    base = tasm.assemble_batch_matrix(
        batch, dataclasses.replace(cfg, enable_synthetic_multi_object=False), g, "cpu")
    every = tasm.assemble_synthetic_multi_object_sample_matrix(
        tasm._frames(batch, "cpu"), tasm._frames(batch, "cpu", "_2"), cfg, g)
    keep, rows = torch.as_tensor(~smo), torch.as_tensor(smo)
    np.testing.assert_array_equal(s.match_type.numpy(), batch["match_type"])
    for got, want_base, want_smo in zip((img_a, img_b) + tuple(s), base[:2] + tuple(base[2]),
                                        every[:2] + tuple(every[2])):
        assert torch.equal(got[keep], want_base[keep])
        if got is not s.match_type:
            assert torch.equal(got[rows], want_smo[rows].to(got.dtype))


# -- the trainer's cadence against pdc_tpu's ------------------------------------------------


def _run_both(root, name, callback_for, **training):
    """pdc_tpu's trainer and the port's on the same config and seeded
    dataset; returns each one's (trainer, folder, callback record)."""
    out = {}
    for pkg, cls, ds_cls, kw in (("jax", JaxTraining, JaxSpartanDataset, {}),
                                 ("port", DenseCorrespondenceTraining, SpartanDataset,
                                  {"device": "cpu"})):
        cfg = tiny_config(os.path.join(root, pkg), name, **training)
        trainer = cls(config=cfg, dataset=ds_cls.make_synthetic(**SYNTH), **kw)
        called = []
        folder = trainer.run(progress_callback=callback_for(called))
        out[pkg] = (trainer, folder, called)
    return out


def _record(called):
    def callback(it, metrics):
        called.append((it, {k: tuple(np.asarray(v).shape) for k, v in metrics.items()}))
    return callback


def test_trainer_keeps_pdc_tpu_cadence(tmp_path):
    """K=4, save_rate 6, logging_rate 2, 12 iterations: both save at 0 and 12
    only (6 is no call's end), call back at 4, 8 and 12 with [4] metrics,
    and log 12 iterations with the same learning rates."""
    runs = _run_both(str(tmp_path), "cadence", _record, **CADENCE)
    (jt, jfolder, jcalled), (pt, pfolder, pcalled) = runs["jax"], runs["port"]
    assert pt.route == port_train.ROUTE_DEVICE_SAMPLER
    assert [it for it, _ in pcalled] == [it for it, _ in jcalled] == [4, 8, 12]
    assert [m for _, m in pcalled] == [m for _, m in jcalled]
    assert all(shape == (4,) for _, m in pcalled for shape in m.values())
    ckpts = {f for f in os.listdir(pfolder) if ".ckpt" in f}
    assert ckpts == {f for f in os.listdir(jfolder) if ".ckpt" in f} == {
        "000000.ckpt", "000000.ckpt.opt", "000012.ckpt", "000012.ckpt.opt"}
    for key in ("iteration", "learning_rate"):
        assert pt._logging_dict["train"][key] == jt._logging_dict["train"][key], key
    assert pt._logging_dict["train"]["iteration"] == list(range(1, 13))
    assert len(pt._logging_dict["train"]["loss"]) == 12
    assert len(pt.step_seconds) == 3 and pt.state.step == int(jt._state.step) == 12


def test_sigterm_checkpoint_lands_on_the_call_boundary(tmp_path):
    """SIGTERM during the first call of 4 steps: both trainers write the
    checkpoint of iteration 4 and stop there."""
    def kill_once(called):
        def callback(it, metrics):
            called.append(it)
            if len(called) == 1:
                os.kill(os.getpid(), signal.SIGTERM)
        return callback

    before = signal.getsignal(signal.SIGTERM)
    runs = _run_both(str(tmp_path), "preempt", kill_once, **CADENCE)
    for pkg, (trainer, folder, called) in runs.items():
        assert trainer.preempted and called == [4], pkg
        files = set(os.listdir(folder))
        assert {"000004.ckpt", "000004.ckpt.opt"} <= files, pkg
        assert not any(f.startswith(("000008", "000012")) for f in files), pkg
    assert runs["port"][0].state.step == int(runs["jax"][0]._state.step) == 4
    assert signal.getsignal(signal.SIGTERM) is before



def test_constants_cached_for_the_graph_serve_autograd_after_inference_mode():
    """What the captured step caches per device (utils/device.py
    device_constant, the bf16 resize weights) is made once, whichever mode
    asks first: made under inference_mode (a server's forward), it still
    serves a training step's autograd."""
    from pdc_tpu_torch.models.resnet import resize_bilinear
    from pdc_tpu_torch.utils.device import device_constant

    values = (0.125, 0.375)
    with torch.inference_mode():
        resize_bilinear(torch.zeros(1, 3, 5, 7, dtype=torch.bfloat16), 10, 14)
        made = device_constant(values, torch.float32, "cpu")
    x = torch.ones(1, 3, 5, 7, dtype=torch.bfloat16, requires_grad=True)
    resize_bilinear(x, 10, 14).float().sum().backward()
    y = torch.ones(2, requires_grad=True)
    (y * device_constant(values, torch.float32, "cpu")).sum().backward()
    assert not made.is_inference() and x.grad is not None and torch.equal(y.grad, made)


def test_capturable_adam_keeps_the_state_and_the_checkpoint_format():
    """to_capturable swaps in a capturable Adam (a tensor LR, the counts on
    the parameters' device) with the same moments: the .ckpt.opt tree it
    writes equals the one the float Adam writes, and reading a tree back
    into it keeps the counts where a capturable Adam needs them."""
    from pdc_tpu_torch.models.convert import adam_state_to_flax, load_adam_state_from_flax

    cfg, state, probs, args = _port_setup(WITHIN)
    single = scanned.make_device_sampled_train_step(*args, probs)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        single(state, gen)
    before = adam_state_to_flax(state.module, state.optimizer, state.step)
    params = [p.detach().clone() for p in state.module.parameters()]
    scanned.to_capturable(state, cfg)
    opt = state.optimizer
    assert opt.defaults["capturable"] and torch.is_tensor(opt.param_groups[0]["lr"])
    assert all(torch.equal(p, q) for p, q in zip(state.module.parameters(), params))
    after = adam_state_to_flax(state.module, opt, state.step)
    flat = jax.tree_util.tree_leaves_with_path
    assert [k for k, _ in flat(before)] == [k for k, _ in flat(after)]
    for (_, a), (_, b) in zip(flat(before), flat(after)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for p in state.module.parameters():
        opt.state[p]["step"] = torch.tensor(5.0)  # as a checkpoint of another count
    load_adam_state_from_flax(state.module, opt, after)
    steps = [opt.state[p]["step"] for p in state.module.parameters()]
    assert all(s.device == p.device and float(s) == 2.0
               for s, p in zip(steps, state.module.parameters()))
    scanned.to_capturable(state, cfg)  # already capturable: nothing changes
    assert state.optimizer is opt
