"""The model axes of the port's parallel layer (tensor parallelism and the
GPipe pipeline, pdc_tpu_torch.parallel.tensor_parallel and .pipeline, and
the trainer's, the CLI's and the server's routes to them) on the CPU: 2 and
4 gloo ranks started by ``parallel.distributed.spawn``, held against
pdc_tpu's programs on meshes of the same shapes built from the 8 virtual
CPU devices (tests/conftest.py), fed the same numpy weights and the same
assembled batch, and against the port's own single-device routes.

The ranks run ``_rank_body`` of this module, which imports no jax: the JAX
references run only in this process (the fixtures import jax inside). One
spawn per world size runs every check of that size.

Bars (JAX's own, tests/test_tensor_parallel.py, test_pipeline_parallel.py,
test_trainer_model_parallel.py): TP inference rtol 1e-4, atol 1e-5; the
TP step's loss rtol 1e-4 and each leaf's SGD update within 6%; the
pipelined forward atol 2e-5; the PP step's loss 2e-4 relative and its
update 0.06 relative L2; the trainers' step-1 loss 2e-5 (TP) and 2e-4 (PP)
relative, every step 2e-2 and 5e-2.
"""

import copy
import dataclasses
import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from pdc_tpu_torch.apps.serve import DescriptorServer, _Laps, _Request
from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.data.synthetic import SyntheticScene
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models.checkpoint import read_checkpoint
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.models.resnet import Int8Conv, ResNetFCN
from pdc_tpu_torch.models.unet import UNet
from pdc_tpu_torch.parallel import (
    Mesh,
    make_frozen_bn_train_step,
    make_mesh,
    make_pp_inference,
    make_pp_train_step,
    make_tp_inference,
    make_tp_train_step,
    pack_pipeline_variables,
    spawn,
    unpack_pipeline_variables,
)
from pdc_tpu_torch.parallel import pipeline as pp
from pdc_tpu_torch.parallel import tensor_parallel as tp
from pdc_tpu_torch.training import train as port_train
from pdc_tpu_torch.training.train import DenseCorrespondenceTraining, create_train_state

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """The trainer's runs write model folders (checkpoints and Adam states): remove them when the
    test ends, so that a whole run leaves no large files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


H, W, D = 48, 64, 3
R18 = (2, 2, 2, 2)
UNET_BASE = 8
B = 4  # pairs of the global batch
ASM = dict(num_matching_attempts=300, masked_pool_size=64, background_pool_size=64,
           num_blind_samples=100)
TC = {"training": {"learning_rate": 1e-4, "learning_rate_decay": 0.9,
                   "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}
SGD_LR = 0.05  # tests/test_tensor_parallel.py's optax.sgd(0.05)
TC_SGD = {"training": {"learning_rate": SGD_LR, "learning_rate_decay": 1.0,
                       "steps_between_learning_rate_decay": 250, "weight_decay": 0.0}}
ADAM_STEPS = 3
SYNTH = dict(num_scenes=2, num_objects=2, width=W, height=H, num_frames=4, object_radius=0.3)
TRAIN_ITERS = 4


# -- what the ranks run (no jax) ------------------------------------------------------------


def _resnet(sd):
    m = ResNetFCN(D, stage_sizes=R18)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return m.eval()


def _indices(idx, sl=slice(None)):
    return MatrixSampleIndices(*[torch.as_tensor(np.asarray(x)[sl]) for x in idx])


def _numpy(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _plain(module, imgs):
    with torch.no_grad():
        return module.eval()(torch.as_tensor(imgs)).numpy()


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def train_config(root, name, **training):
    cfg = copy.deepcopy(DenseCorrespondenceTraining.load_default_config())
    t = cfg["training"]
    t.update(num_iterations=TRAIN_ITERS, batch_size=2, num_matching_attempts=256,
             num_non_matches_per_match=10, cross_scene_num_samples=128, save_rate=1000,
             logging_rate=1000, masked_pool_size=64, background_pool_size=64,
             num_blind_samples=100, use_tensorboard=False, cache_dataset_on_device=False,
             seed=3, logging_dir=str(root), logging_dir_name=name)
    t.update(training)
    cfg["dense_correspondence_network"].update(image_width=W, image_height=H)
    cfg["dense_correspondence_network"]["backbone"]["resnet_name"] = "Resnet18_8s"
    return cfg


def _tp_steps(p, mesh, d):
    """(b) one SGD step against JAX's replicated step, and (c) ADAM_STEPS
    Adam steps, on data rank ``d``'s block of the global batch."""
    asm = AssemblerConfig(**ASM)
    b = B // mesh.shape["data"]
    sl = slice(d * b, (d + 1) * b)
    args = (torch.as_tensor(p["img_a"][sl]), torch.as_tensor(p["img_b"][sl]),
            _indices(p["idx"], sl))
    state = create_train_state(_resnet(p["sd"]), TC_SGD, device="cpu")
    state.optimizer = torch.optim.SGD(state.module.parameters(), lr=SGD_LR)
    step, state = make_tp_train_step(TC_SGD, LossConfig(), asm, W, mesh, state)
    m = step.update(state, *args)
    out = {"sgd": dict(loss=float(m["loss"]), after=_numpy(
        tp.unshard_channels(state.module).state_dict()))}
    state = create_train_state(_resnet(p["sd"]), TC, device="cpu")
    step, state = make_tp_train_step(TC, LossConfig(), asm, W, mesh, state)
    losses = [float(step.update(state, *args)["loss"]) for _ in range(ADAM_STEPS)]
    replicated = {k: _digest(v) for k, v in state.module.state_dict().items()
                  if k.rsplit(".", 1)[0] not in {n for n, mod in state.module.named_modules()
                                                 if isinstance(mod, tp.ColumnParallelConv)}}
    plain = tp.unshard_channels(state.module)
    out["adam"] = dict(losses=losses, replicated=replicated,
                       state_bytes=state.tp.state_bytes(state.module, state.optimizer),
                       sharded_size=tp.sharded_size_bytes(
                           dict(plain.named_parameters()), tp.tp_shardings(state.module), mesh),
                       sharded=sorted(state.tp.sharded))
    return out


def _pp_step(p, mesh, microbatch):
    """One pipelined step on data rank d's block of the global batch; the
    whole network's variables after it."""
    d = mesh.index["data"]
    b = B // mesh.shape["data"]
    sl = slice(d * b, (d + 1) * b)
    state = create_train_state(_resnet(p["sd"]), TC, device="cpu")
    step, pp_state, meta = make_pp_train_step(TC, LossConfig(), AssemblerConfig(**ASM), W, mesh,
                                              state, (H, W), microbatch=microbatch)
    m = step.update(pp_state, torch.as_tensor(p["img_a"][sl]), torch.as_tensor(p["img_b"][sl]),
                    _indices(p["idx"], sl))
    variables = unpack_pipeline_variables(pp_state.pack, meta, mesh)
    held = sum(t.numel() for t in pp_state.stage.parameters())
    return dict(metrics={k: float(v) for k, v in m.items()}, after=flax_to_state_dict(variables),
                held=held, step=pp_state.step)


def _trainer(p, name, **training):
    cfg = train_config(p["root"], name, **training)
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    folder = trainer.run()
    dcn = trainer.get_dcn()  # a collective in a sharded run
    return dict(folder=folder, route=trainer.route, writes=trainer.writes,
                saves=len(trainer.save_seconds), losses=list(trainer._logging_dict["train"]["loss"]),
                mesh=dict(trainer._mesh.shape), after=_numpy(dcn.module.state_dict()))


def _rank_body(rank, world, p):
    """Every multi-rank check of one world size; returns what the tests
    compare."""
    torch.set_num_threads(1)
    imgs = torch.as_tensor(p["imgs"])
    out = {"rank": rank}
    if world == 4:
        mesh = make_mesh(("data", "model"), shape=(2, 2), device="cpu")
        out["index"] = dict(mesh.index)
        fwd, sharded = make_tp_inference(_resnet(p["sd"]), mesh, data_axis="data")()
        out["tp (2, 2)"] = fwd(sharded, imgs).numpy()
        out.update(_tp_steps(p, mesh, mesh.index["data"]))
        for mb in (1, 2):  # the plain forward a microbatch at a time, at this rank's threads
            out[("plain", mb)] = np.concatenate([_plain(_resnet(p["sd"]), imgs[i:i + mb])
                                                 for i in range(0, len(imgs), mb)])
        for shape in ((1, 4), (2, 2)):
            pmesh = make_mesh(("data", "pipe"), shape=shape, device="cpu")
            for mb in (1, 2):
                f, pack = make_pp_inference(_resnet(p["sd"]), pmesh, (H, W), microbatch=mb,
                                            data_axis="data")()
                out[("pp", shape, mb)] = f(pack, imgs).numpy()
        out["pp step"] = _pp_step(p, make_mesh(("data", "pipe"), shape=(2, 2), device="cpu"), 1)
    else:
        mesh = make_mesh(("data", "model"), shape=(1, 2), device="cpu")
        for name, module in (("tp (1, 2)", _resnet(p["sd"])), ("unet", p["unet"]),
                             ("int8 static", p["int8"])):
            fwd, sharded = make_tp_inference(module, mesh)()
            out[name] = fwd(sharded, imgs).numpy()
            out[name + " plain"] = _plain(module, imgs)  # at this rank's threads
        out["trainer"] = {"tp": _trainer(p, "tp", tensor_parallel=2),
                          "pp": _trainer(p, "pp", pipeline=2, pipeline_microbatch=2)}
    if rank:  # the other ranks send digests of the weights, not the weights
        for part in list(out.get("trainer", {}).values()) + [out.get("sgd"), out.get("pp step")]:
            if part:
                part["after"] = {k: _digest(torch.as_tensor(v)) for k, v in part["after"].items()}
    return out


# -- the JAX references and the spawns ------------------------------------------------------


def _np_tree(t):
    import jax

    return jax.tree_util.tree_map(np.asarray, t)


def _sd(variables):
    return {k: v.numpy() for k, v in flax_to_state_dict(_np_tree(variables)).items()}


def _calibrated_unet_and_int8(sd):
    """The UNet (base 8) from seeded weights, and a static int8 clone of the
    ResNet calibrated on two frames, as the port builds them."""
    from pdc_tpu_torch.models.resnet import init_weights_

    unet = init_weights_(UNet(D, base_features=UNET_BASE), torch.Generator().manual_seed(3))
    dcn = DenseCorrespondenceNetwork(_resnet(sd), D, image_width=W, image_height=H, device="cpu")
    frames = np.random.default_rng(4).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    return unet.eval(), dcn.calibrate_quantization(list(frames), batch_size=2).module


@pytest.fixture(scope="module")
def ref():
    """pdc_tpu's side on meshes of the virtual devices, and the inputs: the
    port's seeded weights (running statistics moved away from 0 and 1, so
    that frozen BatchNorm does something) and a global batch the port
    assembled, fed to both packages as numpy arrays."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pdc_tpu.losses.matrix_loss import MatrixSampleIndices as JaxIndices
    from pdc_tpu.losses.matrix_loss import compose_loss_matrix as jax_compose
    from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
    from pdc_tpu.models.resnet import ResNetFCN as JaxResNetFCN
    from pdc_tpu.models.unet import UNet as JaxUNet
    from pdc_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from pdc_tpu.parallel.pipeline import make_pp_inference as jax_pp_inference
    from pdc_tpu.parallel.tensor_parallel import make_tp_inference as jax_tp_inference
    from pdc_tpu.training.train import build_loss_fn, make_optimizer
    from pdc_tpu_torch.data.assembler import assemble_batch_matrix
    from pdc_tpu_torch.models.resnet import init_weights_

    module = init_weights_(ResNetFCN(D, stage_sizes=R18), torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for bn in module.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.running_mean.copy_(torch.rand(bn.num_features, generator=g) * 0.2 - 0.1)
                bn.running_var.copy_(torch.rand(bn.num_features, generator=g) + 0.5)
    sd = _numpy(module.state_dict())
    variables = state_dict_to_flax(module.state_dict())
    scene = SyntheticScene(width=W, height=H, num_frames=8)
    rgb, depth, mask, poses = scene.render_all()
    ia, ib = np.array([0, 1, 2, 3]), np.array([4, 6, 7, 5])
    batch = dict(match_type=np.zeros(B, np.int32), rgb_a=rgb[ia], depth_a=depth[ia],
                 mask_a=mask[ia], pose_a=poses[ia].astype(np.float32), rgb_b=rgb[ib],
                 depth_b=depth[ib], mask_b=mask[ib], pose_b=poses[ib].astype(np.float32),
                 K=np.stack([scene.K] * B).astype(np.float32))
    img_a, img_b, idx = assemble_batch_matrix(batch, AssemblerConfig(**ASM),
                                              torch.Generator().manual_seed(0), device="cpu")
    img_a, img_b = img_a.numpy(), img_b.numpy()
    idx = [x.numpy() for x in idx]
    jidx = JaxIndices(*[jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
                        for x in idx])
    rng = np.random.default_rng(2)
    imgs = rng.standard_normal((4, H, W, 3)).astype(np.float32)
    out = dict(sd=sd, img_a=img_a, img_b=img_b, idx=idx, imgs=imgs)
    jm = JaxResNetFCN(num_classes=D, stage_sizes=R18)

    def devices(n):
        return jax.devices()[:n]

    # TP inference on (1, 2) and (2, 2) (data, model) meshes
    for shape in ((1, 2), (2, 2)):
        mesh = jax_make_mesh(("data", "model"), shape=shape, devices=devices(shape[0] * shape[1]))
        fwd, vsh = jax_tp_inference(jm, mesh, data_axis="data")(variables)
        out[f"tp {shape}"] = np.asarray(fwd(vsh, jax.device_put(imgs, NamedSharding(mesh, P(
            "data")))))
    mesh12 = jax_make_mesh(("data", "model"), shape=(1, 2), devices=devices(2))
    unet, int8 = _calibrated_unet_and_int8(sd)
    out["unet_module"], out["int8_module"] = unet, int8
    fwd, vsh = jax_tp_inference(JaxUNet(num_classes=D, base_features=UNET_BASE), mesh12)(
        state_dict_to_flax(unet.state_dict()))
    out["unet"] = np.asarray(fwd(vsh, imgs))
    jq = dataclasses.replace(jm, quant_int8=True, quant_static=True)
    fwd, vsh = jax_tp_inference(jq, mesh12)(state_dict_to_flax(int8.state_dict()))
    out["int8 static"] = np.asarray(fwd(vsh, imgs))

    # the pipelined forward on (1, 4) and (2, 2) (data, pipe) meshes
    for shape in ((1, 4), (2, 2)):
        mesh = jax_make_mesh(("data", "pipe"), shape=shape, devices=devices(4))
        for mb in (1, 2):
            fwd, pack = jax_pp_inference(jm, mesh, (H, W), microbatch=mb,
                                         data_axis="data")(variables)
            out[("pp", shape, mb)] = np.asarray(fwd(pack, imgs))

    # the TP step's reference: JAX's replicated step (train-mode BatchNorm over the
    # global batch, the loss's mean over its pairs) with SGD, whose update is -lr * grad
    params, stats = variables["params"], variables["batch_stats"]
    vg = jax.jit(jax.value_and_grad(build_loss_fn(jm, JaxLossConfig(), W, jax_compose),
                                    has_aux=True))
    (loss, (new_stats, _)), grads = vg(params, stats, img_a, img_b, jidx)
    out["sgd"] = dict(loss=float(loss), after=_sd({
        "params": jax.tree_util.tree_map(lambda p, g: p - SGD_LR * g, params, grads),
        "batch_stats": new_stats}))

    # the PP step's reference: JAX's frozen-BN loss and gradients on the same batch, and
    # Adam's update (tests/test_pipeline_parallel.py:112-191)
    lcfg = JaxLossConfig()

    def frozen_loss(params):
        o = jm.apply({"params": params, "batch_stats": stats},
                     jnp.concatenate([img_a, img_b], axis=0), train=False)
        pred = o.reshape(2 * B, H * W, o.shape[-1])
        terms = jax.vmap(lambda pa, pb, s: jax_compose(pa, pb, s, lcfg, W))(pred[:B], pred[B:],
                                                                             jidx)
        non_empty = (jidx.match_type >= 0).astype(jnp.float32)
        return jnp.sum(terms.loss * non_empty) / jnp.maximum(jnp.sum(non_empty), 1.0)

    loss, grads = jax.jit(jax.value_and_grad(frozen_loss))(params)
    adam = make_optimizer(TC)
    updates, _ = jax.jit(lambda g, p: adam.update(g, adam.init(p), p))(grads, params)
    out["pp step"] = dict(loss=float(loss), after=_sd(
        {"params": optax.apply_updates(params, updates), "batch_stats": stats}))
    return out


def _imgs(ref):
    """The inference images, NCHW as the port's modules take them."""
    return np.ascontiguousarray(ref["imgs"].transpose(0, 3, 1, 2))


def _payload(ref, tmp):
    return dict(sd=ref["sd"], img_a=ref["img_a"], img_b=ref["img_b"], imgs=_imgs(ref),
                idx=[np.asarray(x) for x in ref["idx"]], unet=ref["unet_module"],
                int8=ref["int8_module"], root=str(tmp / "models"))


_SPAWNED = {}


def _spawned(world, ref, tmp_path_factory):
    """The ranks' results of one world size, spawned once per module."""
    if world not in _SPAWNED:
        payload = _payload(ref, tmp_path_factory.mktemp(f"axes{world}"))
        _SPAWNED[world] = (payload, spawn(_rank_body, world, "cpu", payload))
    return _SPAWNED[world]


@pytest.fixture(scope="module")
def ranks2(ref, tmp_path_factory):
    return _spawned(2, ref, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(ref, tmp_path_factory):
    return _spawned(4, ref, tmp_path_factory)


def _nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


# -- channel_shardings (no spawn) -------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["resnet18", "unet"])
@pytest.mark.parametrize("n", [2, 4])
def test_channel_shardings_are_jax(backbone, n):
    """JAX's rule leaf by leaf on the flax layout of the same network, and
    the port's own layout: every convolution whose output channels divide
    is a ColumnParallelConv holding 1/n of them (weight and bias), the rest
    (BatchNorm, the D=3 head) replicated."""
    import jax
    import jax.numpy as jnp

    from pdc_tpu.models.resnet import ResNetFCN as JaxResNetFCN
    from pdc_tpu.models.unet import UNet as JaxUNet
    from pdc_tpu.parallel import tensor_parallel as jtp
    from pdc_tpu.parallel.mesh import make_mesh as jax_make_mesh

    if backbone == "resnet18":
        jmod, port = JaxResNetFCN(num_classes=D, stage_sizes=R18), ResNetFCN(D, stage_sizes=R18)
    else:
        jmod, port = JaxUNet(num_classes=D, base_features=UNET_BASE), UNet(D, UNET_BASE)
    shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.zeros((1, H, W, 3)), train=False),
                            jax.random.PRNGKey(0))
    jmesh = jax_make_mesh(("data", "model"), shape=(8 // n, n))
    want = jax.tree_util.tree_leaves(jtp.channel_shardings(shapes, jmesh))
    flax = state_dict_to_flax(port.state_dict())
    mesh = Mesh(("data", "model"), (8 // n, n), 0, torch.device("cpu"), {})
    got = jax.tree_util.tree_leaves(tp.channel_shardings(flax, mesh),
                                    is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(flax)
    assert [tuple(s.spec) for s in want] == got
    # the port's layout: the convolutions JAX shards on Cout, and nothing else
    convs = {k for k, m in port.named_modules() if isinstance(m, Int8Conv)}
    sharded = tp.shard_channels(copy.deepcopy(port), tp.LocalChannels(["cpu"] * n))
    specs = tp.tp_shardings(sharded)
    for name, p in port.named_parameters():
        module = name.rsplit(".", 1)[0]
        node = shapes["params"]
        for part in module.split("."):
            node = node[part]
        if module in convs:
            jax_sharded = node["kernel"].shape[3] % n == 0
            assert (specs[name] != ()) == jax_sharded, name
            if jax_sharded:
                assert getattr(sharded.get_submodule(module), name.rsplit(".", 1)[1]).shape[0] \
                    == p.shape[0] // n
        else:
            assert specs[name] == (), name  # BatchNorm vectors: replicated (ROADMAP §3)
    assert any(s for s in specs.values()) and specs["head.weight"] == ()


# -- tensor parallelism ------------------------------------------------------------------------


def test_tp_inference_matches_jax_and_the_unsharded_forward(ranks2, ranks4, ref):
    """(1, 2) and (2, 2) meshes against make_tp_inference on meshes of the
    same shapes and against the port's unsharded forward (rtol 1e-4, atol
    1e-5, JAX's bars; measured 3.6e-6 and 3.3e-6 from JAX); the port's
    sharded forward is bit-equal to its unsharded one on the CPU (the
    blocks of output channels round as the whole convolution does), on
    every rank."""
    imgs = _imgs(ref)
    plain = _nhwc(_plain(_resnet(ref["sd"]), imgs))
    for key, outs in (("tp (1, 2)", ranks2[1]), ("tp (2, 2)", ranks4[1])):
        got = _nhwc(outs[0][key])
        np.testing.assert_allclose(got, ref[key], rtol=1e-4, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-5, err_msg=key)
        for o in outs:
            np.testing.assert_array_equal(o[key], outs[0][key])
    for o in ranks2[1]:
        np.testing.assert_array_equal(o["tp (1, 2)"], o["tp (1, 2) plain"])


def test_tp_inference_unet_and_int8_static(ranks2, ref):
    """The UNet's convolutions shard alike (JAX's test_tp_inference_unet_
    backbone), and a static int8 clone keeps its per-tensor activation
    scales and per-channel weight scales: both bit-equal to their unsharded
    forward; against JAX, the UNet within rtol 1e-4, atol 1e-5 (measured
    2.4e-7) and the int8 clone within tests/test_torch_port_int8.py's bound
    for a quantized network, a tenth of JAX's own int8 error (measured
    4.8e-7 against an error of 0.19)."""
    _, outs = ranks2
    imgs = _imgs(ref)
    unet = _nhwc(outs[0]["unet"])
    np.testing.assert_allclose(unet, ref["unet"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(unet, _nhwc(_plain(ref["unet_module"], imgs)), rtol=1e-4,
                               atol=1e-5)
    q = _nhwc(outs[0]["int8 static"])
    for o in outs:
        np.testing.assert_array_equal(o["unet"], o["unet plain"])
        np.testing.assert_array_equal(o["int8 static"], o["int8 static plain"])
    err = np.abs(ref["int8 static"] - ref["tp (1, 2)"])
    assert float(err.max()) > 0
    assert float(np.abs(q - ref["int8 static"]).max()) <= 0.1 * float(err.max())
    for o in outs[1:]:
        np.testing.assert_array_equal(o["unet"], outs[0]["unet"])
        np.testing.assert_array_equal(o["int8 static"], outs[0]["int8 static"])


def test_tp_step_matches_jax_replicated_step(ranks4, ref):
    """One SGD step of the DP x TP step on a (2, 2) mesh against JAX's
    replicated step on the same batch and weights (tests/test_tensor_parallel
    .py:144-188's bars): loss rtol 1e-4 (measured 4.5e-7), each leaf's
    update within 6% (the worst 0.47%), a leaf with no update (the head's
    bias: a constant offset cancels in every distance) none. Every rank
    holds the same whole weights after it."""
    _, outs = ranks4
    got, want = outs[0]["sgd"], ref["sgd"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4, atol=1e-6)
    before = ref["sd"]
    for name, w in want["after"].items():
        if "running" in name or name.endswith("num_batches_tracked"):
            continue
        du_ref = w.astype(np.float64) - before[name]
        du_got = got["after"][name].astype(np.float64) - before[name]
        n_ref = np.linalg.norm(du_ref)
        if n_ref < 1e-8:
            assert np.linalg.norm(du_got) < 1e-7, name
            continue
        assert np.linalg.norm(du_got - du_ref) / n_ref < 0.06, name
    for o in outs[1:]:
        assert o["sgd"]["after"] == {k: _digest(torch.as_tensor(v))
                                     for k, v in got["after"].items()}
        assert o["sgd"]["loss"] == got["loss"]


def test_tp_state_is_one_nth_and_replicated_leaves_stay_equal(ranks4):
    """After ADAM_STEPS Adam steps on (2, 2): each rank stores exactly the
    sharded leaves' bytes over 2 plus the replicated leaves' bytes, for the
    parameters and both moments; the replicated leaves (BatchNorm, the head,
    the running statistics) are bit-equal on every rank; the losses equal
    across ranks."""
    _, outs = ranks4
    plain = ResNetFCN(D, stage_sizes=R18)
    n = 2
    shardable = {f"{k}.{leaf}" for k, m in plain.named_modules()
                 if isinstance(m, Int8Conv) and m.out_channels % n == 0
                 for leaf in ("weight", "bias") if getattr(m, leaf) is not None}
    per_rank = sum(p.numel() * 4 // (n if k in shardable else 1)
                   for k, p in plain.named_parameters())
    for o in outs:
        a = o["adam"]
        assert a["state_bytes"] == 3 * per_rank == 3 * a["sharded_size"]
        assert set(a["sharded"]) == shardable
        assert a["replicated"] == outs[0]["adam"]["replicated"]
        assert a["losses"] == outs[0]["adam"]["losses"] and np.isfinite(a["losses"]).all()
    assert {o["index"]["model"] for o in outs} == {0, 1}


# -- the pipeline -------------------------------------------------------------------------------


def test_pack_unpack_roundtrip_and_stage_grouping(ref):
    """Pack then unpack is bit-equal to the flax variables; the stage
    grouping for S = 1, 2 and 4 is JAX's; S = 3 is JAX's error; the
    pipeline refuses what JAX's refuses."""
    import jax

    from pdc_tpu.models.resnet import ResNetFCN as JaxResNetFCN
    from pdc_tpu.parallel import pipeline as jpp

    module = _resnet(ref["sd"])
    want = state_dict_to_flax(module.state_dict())
    jm = JaxResNetFCN(num_classes=D, stage_sizes=R18)
    jvars = {"params": want["params"], "batch_stats": want["batch_stats"]}
    for S in (1, 2, 4):
        pack, meta = pack_pipeline_variables(module, S)
        got = unpack_pipeline_variables(pack, meta)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
        _, jmeta = jpp.pack_pipeline_variables(jm, jvars, S)
        assert meta.groups == jmeta.groups
        assert sum(sum(p.numel() for p in st.parameters()) for st in pack.stages.values()) == \
            sum(p.numel() for p in module.parameters())
    with pytest.raises(ValueError, match="must divide the 4 base segments"):
        pack_pipeline_variables(module, 3)
    for bad, match in ((UNet(D, UNET_BASE), "supports ResNetFCN"),
                       (ResNetFCN(D, stage_sizes=R18, output_stride=16), "output_stride=8"),
                       (ResNetFCN(D, stage_sizes=R18, dilated_s2b=True), "dilated_s2b")):
        with pytest.raises(ValueError, match=match):
            pack_pipeline_variables(bad, 2)
    from pdc_tpu_torch.models.resnet import quantized_copy

    with pytest.raises(ValueError, match="int8"):
        pack_pipeline_variables(quantized_copy(module), 2)


def test_pp_inference_matches_plain_and_jax(ranks4, ref):
    """(1, 4) and (2, 2) (data, pipe) meshes, microbatch 1 and 2: the
    pipelined forward equals the plain forward within JAX's 2e-5, and
    bit for bit the plain forward of the same microbatch size (the
    segments run ResNetFCN.forward's ops in its order); JAX's
    make_pp_inference on meshes of the same shapes within 2e-5 (measured
    3.1e-6 to 4.1e-6); every rank returns the same descriptors."""
    _, outs = ranks4
    imgs = _imgs(ref)
    module = _resnet(ref["sd"])
    plain = _plain(module, imgs)
    for shape in ((1, 4), (2, 2)):
        for mb in (1, 2):
            key = ("pp", shape, mb)
            got = outs[0][key]
            np.testing.assert_allclose(got, plain, rtol=0, atol=2e-5, err_msg=str(key))
            np.testing.assert_allclose(_nhwc(got), ref[key], rtol=0, atol=2e-5, err_msg=str(key))
            for o in outs:
                np.testing.assert_array_equal(o[key], o[("plain", mb)], err_msg=str(key))
                np.testing.assert_array_equal(o[key], got)


def test_pp_step_matches_jax_frozen_bn(ranks4, ref):
    """One DP x PP step on (2, 2), microbatch 1, against JAX's frozen-BN
    loss and Adam update on the same global batch and weights: loss 2e-4
    relative (measured equal), update 0.06 relative L2 (measured 1.5e-3;
    tests/test_pipeline_parallel.py:112-191); the running statistics
    untouched; each rank holds its stage's
    parameters alone; every rank ends with the same whole network."""
    _, outs = ranks4
    got, want = outs[0]["pp step"], ref["pp step"]
    assert got["metrics"]["loss"] == pytest.approx(want["loss"], rel=2e-4)
    num = den = 0.0
    for name, w in want["after"].items():
        if name.endswith("num_batches_tracked"):
            continue
        if "running" in name:
            np.testing.assert_array_equal(got["after"][name].numpy(), w, err_msg=name)
            continue
        d_ref = w.astype(np.float64) - ref["sd"][name]
        d_pp = got["after"][name].numpy().astype(np.float64) - ref["sd"][name]
        num += float(((d_ref - d_pp) ** 2).sum())
        den += float((d_ref ** 2).sum())
    assert den > 0 and np.sqrt(num / den) < 0.06, np.sqrt(num / den)
    total = sum(p.numel() for p in _resnet(ref["sd"]).parameters())
    for o in outs:
        assert o["pp step"]["metrics"] == got["metrics"] and o["pp step"]["step"] == 1
        assert 0 < o["pp step"]["held"] < total
    assert sum(o["pp step"]["held"] for o in outs) == 2 * total  # two data replicas of each stage
    for o in outs[1:]:
        assert o["pp step"]["after"] == {k: _digest(v) for k, v in got["after"].items()}


# -- the trainer --------------------------------------------------------------------------------


def _single_losses(root, name, **training):
    cfg = train_config(root, name, **training)
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    trainer.run()
    assert trainer.route == port_train.ROUTE_HOST_STREAMING
    return trainer._logging_dict["train"]["loss"]


def test_trainer_tensor_parallel_on_two_ranks(ranks2, tmp_path):
    """``tensor_parallel: 2`` on 2 gloo ranks, 4 iterations: the
    model-parallel route on a (1, 2) mesh; step 1's loss within 2e-5 of
    the port's single run on the same batches and draws, every step
    within 2e-2 (tests/test_trainer_model_parallel.py; measured: step 1
    equal, the others within 2.3e-6); rank 0 alone writes
    ``.ckpt`` and ``.ckpt.opt``, whole: a plain network and a single trainer
    load them."""
    _, outs = ranks2
    r0, r1 = outs[0]["trainer"]["tp"], outs[1]["trainer"]["tp"]
    assert r0["route"] == r1["route"] == port_train.ROUTE_MODEL_PARALLEL
    assert r0["mesh"] == {"data": 1, "model": 2}
    assert r0["writes"] and not r1["writes"] and r1["saves"] == 0 and r0["saves"] == 2
    assert r0["losses"] == r1["losses"] and np.isfinite(r0["losses"]).all()
    single = _single_losses(tmp_path, "single")
    np.testing.assert_allclose(r0["losses"][:1], single[:1], rtol=2e-5)
    np.testing.assert_allclose(r0["losses"], single, rtol=2e-2)
    folder = r0["folder"]
    assert {"000000.ckpt", "000000.ckpt.opt", "000004.ckpt", "000004.ckpt.opt"} <= set(
        os.listdir(folder))
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    for k, v in dcn.module.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), r0["after"][k], err_msg=k)
    assert r1["after"] == {k: _digest(torch.as_tensor(v)) for k, v in r0["after"].items()}
    cfg = train_config(os.path.dirname(folder), "tp", num_iterations=1)
    trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                          device="cpu")
    assert trainer.load_pretrained(folder) == TRAIN_ITERS
    for p in trainer.state.module.parameters():
        st = trainer.state.optimizer.state[p]
        assert st["exp_avg"].shape == p.shape and int(st["step"]) == TRAIN_ITERS
        assert float(st["exp_avg_sq"].abs().max()) > 0 or p.dim() == 1


def test_trainer_pipeline_on_two_ranks(ranks2, tmp_path):
    """``pipeline: 2, pipeline_microbatch: 2`` on 2 gloo ranks: the losses
    against a replay of the same batches and draws through
    make_frozen_bn_train_step on one process (step 1 within 2e-4, every
    step within 5e-2); ``.ckpt`` in the standard layout, no ``.ckpt.opt``;
    the folder loads into a plain network equal to the live one."""
    _, outs = ranks2
    r0, r1 = outs[0]["trainer"]["pp"], outs[1]["trainer"]["pp"]
    assert r0["route"] == r1["route"] == port_train.ROUTE_MODEL_PARALLEL
    assert r0["mesh"] == {"data": 1, "pipe": 2}
    assert r0["losses"] == r1["losses"] and np.isfinite(r0["losses"]).all()
    cfg = train_config(tmp_path, "replay")
    replay = DenseCorrespondenceTraining(cfg, device="cpu")
    module, _ = replay.build_network()
    state = create_train_state(module, cfg, device="cpu")
    t = cfg["training"]
    ds = SpartanDataset.make_synthetic(**SYNTH)
    ds.set_parameters_from_training_config(cfg)
    step = make_frozen_bn_train_step(cfg, LossConfig.from_dict(cfg["loss_function"]),
                                     AssemblerConfig.from_training_config(cfg), W, (H, W))
    gen = torch.Generator().manual_seed(int(t["seed"]))
    want = [float(step(state, {k: torch.as_tensor(v) for k, v in
                               ds.make_host_batch(t["batch_size"]).items()}, gen)["loss"])
            for _ in range(TRAIN_ITERS)]
    np.testing.assert_allclose(r0["losses"][:1], want[:1], rtol=2e-4)
    np.testing.assert_allclose(r0["losses"], want, rtol=5e-2)
    folder = r0["folder"]
    files = set(os.listdir(folder))
    assert "000004.ckpt" in files and not any(f.endswith(".ckpt.opt") for f in files)
    tree = read_checkpoint(os.path.join(folder, "000004.ckpt"))
    assert set(tree) == {"params", "batch_stats"}
    loaded = ResNetFCN(D, stage_sizes=R18)
    loaded.load_state_dict(flax_to_state_dict(tree))
    for k, v in loaded.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), r0["after"][k], err_msg=k)
            if "running" in k:  # frozen BatchNorm: the statistics of the init
                np.testing.assert_array_equal(v.numpy(), module.state_dict()[k].numpy())
    shutil.rmtree(os.path.dirname(folder))


def test_model_parallel_config_errors_on_one_process(tmp_path):
    """JAX's three errors (tests/test_trainer_model_parallel.py:98-126):
    both layouts set; a k that does not divide the devices (one process
    here); a batch that is not a multiple of the data axis (as on 8
    devices). And a microbatch that does not split a data shard's images,
    refused before any collective or send."""
    ds = SpartanDataset.make_synthetic(**SYNTH)
    for training, match in (({"tensor_parallel": 2, "pipeline": 2}, "separate mesh layouts"),
                            ({"tensor_parallel": 3}, "does not divide"),
                            ({"pipeline": 2}, "does not divide")):
        trainer = DenseCorrespondenceTraining(train_config(tmp_path, "x", **training), ds,
                                              device="cpu")
        with pytest.raises(ValueError, match=match):
            trainer.run()
    with pytest.raises(ValueError, match="multiple of.*data axis"):
        port_train.model_parallel_layout({"tensor_parallel": 2}, 8, 2)
    assert port_train.model_parallel_layout({"tensor_parallel": 2}, 8, 4) == (
        "tensor_parallel", 2, 4)
    assert port_train.model_parallel_layout({"pipeline": 4}, 8, 2) == ("pipeline", 4, 2)
    assert port_train.model_parallel_layout({"tensor_parallel": 1, "pipeline": 0}, 8, 3) is None
    # microbatches that do not split a data shard's images: refused before any send
    mesh = make_mesh(("data", "pipe"), shape=(1, 1), device="cpu")
    state = create_train_state(ResNetFCN(D, stage_sizes=R18), TC, device="cpu")
    step, pp_state, _ = make_pp_train_step(TC, LossConfig(), AssemblerConfig(**ASM), W, mesh,
                                           state, (H, W), microbatch=3)
    img = torch.zeros(2, H, W, 3)
    with pytest.raises(ValueError, match="do not split into microbatches of 3"):
        step.update(pp_state, img, img, None)
    fwd, pack = make_pp_inference(ResNetFCN(D, stage_sizes=R18), mesh, (H, W), microbatch=3)()
    with pytest.raises(ValueError, match="microbatches of 3"):
        fwd(pack, torch.zeros(4, 3, H, W))


# -- the server ---------------------------------------------------------------------------------


def test_model_parallel_server_answers_as_the_plain_server(ref):
    """``DescriptorServer(devices=["cpu", "cpu"], model_parallel=2)``: one
    replica channel-sharded over the two devices (every shardable
    convolution a ColumnParallelConv), answering each request as the plain
    server does; ``model_parallel`` that does not divide the devices is
    refused with JAX's message."""
    dcn = DenseCorrespondenceNetwork(_resnet(ref["sd"]), D, image_width=W, image_height=H,
                                     device="cpu")
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    queries = rng.standard_normal((3, 2, D)).astype(np.float32)
    answers = []
    for kw in ({}, {"devices": ["cpu", "cpu"], "model_parallel": 2}):
        server = DescriptorServer(dcn, port=0, max_batch=4, **kw)
        try:
            (device, module), = server._replicas
            convs = [m for m in module.modules() if isinstance(m, tp.ColumnParallelConv)]
            assert bool(convs) == bool(kw) and all(len(c.replicas) == 1 for c in convs)
            assert server._buckets == (1, 2, 4)
            batch = [_Request(frames[0], queries[0]), _Request(frames[1]),
                     _Request(frames[2], queries[2])]
            server._run_batch(batch, _Laps())
            assert all(r.error is None for r in batch), [r.error for r in batch]
            answers.append([r.result for r in batch])
        finally:
            server.shutdown()
    for one, two in zip(*answers):
        for a, b in zip(one, two):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="--model_parallel 2 does not divide 3 devices"):
        DescriptorServer(dcn, port=0, devices=["cpu"] * 3, model_parallel=2)
