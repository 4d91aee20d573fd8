"""The data axis of the port's parallel layer (pdc_tpu_torch.parallel) on the
CPU: 2 and 4 gloo ranks started by ``parallel.distributed.spawn``, held
against pdc_tpu's programs on meshes of 2 and 4 of the 8 virtual CPU
devices (tests/conftest.py) and against the port's own single-device
routes.

The ranks run ``_rank_body`` of this module, which imports no jax: the JAX
references run only in this process (the fixtures import jax inside). One
spawn per world size runs every check of that size, so each pays the
start-up of its processes once.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

from pdc_tpu_torch.apps.serve import DescriptorServer, _Laps, _Request
from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.data.synthetic import SyntheticScene
from pdc_tpu_torch.evaluation.evaluate import EVAL_COLUMNS
from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation as DCE
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.models.resnet import ResNetFCN
from pdc_tpu_torch.ops.best_match import best_match
from pdc_tpu_torch.parallel import (
    distributed,
    make_fsdp_train_step,
    make_mesh,
    make_pixel_sharded_best_match,
    make_sharded_inference,
    make_sharded_train_step,
    spawn,
)
from pdc_tpu_torch.parallel import tensor_parallel as tp
from pdc_tpu_torch.parallel.sharded_train import data_parallel_update, rank_seed
from pdc_tpu_torch.pipeline import renderer as pr
from pdc_tpu_torch.training.train import (
    DenseCorrespondenceTraining,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """The trainer's runs write model folders (checkpoints and Adam states): remove them when the
    test ends, so that a whole run leaves no large files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


H, W, D = 48, 64, 3
R18 = (2, 2, 2, 2)
LR = 1e-4
TC = {"training": {"learning_rate": LR, "learning_rate_decay": 0.9,
                   "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}
ASM = dict(num_matching_attempts=300, masked_pool_size=64, background_pool_size=64,
           num_blind_samples=100)
B = 4  # pairs of the global batch
FSDP_STEPS = 3
SYNTH = dict(num_scenes=2, num_objects=2, width=W, height=H, num_frames=4, object_radius=0.3)
NET_CFG = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
EVAL = dict(num_image_pairs=5, num_matches_per_image_pair=20, seed=1)
STATS = dict(num_images=6, batch_size=4, save_to_file=False)
HW_RAGGED, HW_EVEN, N_QUERIES = 1001, 1000, 9
N_POSES = 5  # odd: the sharded renderer pads


# -- what the ranks run (no jax) ------------------------------------------------------------


def _module(sd):
    m = ResNetFCN(D, stage_sizes=R18)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return m


def _state(sd):
    return create_train_state(_module(sd), TC, device="cpu")


def _indices(idx, sl=slice(None)):
    return MatrixSampleIndices(*[torch.as_tensor(np.asarray(x)[sl]) for x in idx])


def _numpy_state(state):
    return {k: v.detach().numpy().copy() for k, v in state.module.state_dict().items()}


def _grads(state):
    return {k: p.grad.detach().numpy().copy() for k, p in state.module.named_parameters()}


def _float_metrics(m):
    return {k: float(v) for k, v in m.items()}


def _digest(arrays: dict) -> dict:
    """A hash of each array's bytes: what ranks other than 0 send back of
    the weights, to show that every rank holds the same ones."""
    import hashlib

    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def _eval_inputs():
    ds = SpartanDataset.make_synthetic(**SYNTH)
    dcn = DenseCorrespondenceNetwork.from_config(
        NET_CFG, generator=torch.Generator().manual_seed(7), device="cpu")
    return ds, dcn


def _render_inputs():
    scene = SyntheticScene(width=W, height=H, num_frames=N_POSES)
    _, _, _, poses = scene.render_all()
    verts, faces = scene.fusion_mesh(plane_step=0.05, object_step=0.02)
    fg = faces[: len(faces) // 2]
    return verts, fg, faces, poses.astype(np.float32), scene.K


def train_config(root, name, iters, **training):
    cfg = copy.deepcopy(DenseCorrespondenceTraining.load_default_config())
    t = cfg["training"]
    t.update(num_iterations=iters, batch_size=2, num_matching_attempts=256,
             num_non_matches_per_match=10, cross_scene_num_samples=128, save_rate=2,
             logging_rate=1000, masked_pool_size=64, background_pool_size=64,
             num_blind_samples=100, use_tensorboard=False,
             logging_dir=str(root), logging_dir_name=name)
    t.update(training)
    cfg["dense_correspondence_network"].update(image_width=W, image_height=H)
    cfg["dense_correspondence_network"]["backbone"]["resnet_name"] = "Resnet18_8s"
    return cfg


def _rank_body(rank, world, p):
    """Every multi-rank check of one world size; returns what the tests
    compare."""
    mesh = make_mesh(device="cpu")
    out = {"rank": rank, "mesh": (dict(mesh.shape), dict(mesh.index))}
    b = B // world
    sl = slice(rank * b, (rank + 1) * b)
    asm = AssemblerConfig(**ASM)
    img_a, img_b = torch.as_tensor(p["img_a"]), torch.as_tensor(p["img_b"])

    # (a) the global-batch step, replicated and in ZeRO storage
    state = _state(p["sd"])
    step = make_sharded_train_step(TC, LossConfig(), asm, W, mesh)
    m = step.update(state, img_a[sl], img_b[sl], _indices(p["idx"], sl))
    out["gspmd"] = dict(metrics=_float_metrics(m), grads=_grads(state), after=_numpy_state(state))
    fstep, fstate = make_fsdp_train_step(TC, LossConfig(), asm, W, mesh, _state(p["sd"]))
    fstep.update(fstate, img_a[sl], img_b[sl], _indices(p["idx"], sl))
    out["gspmd_fsdp_after"] = _numpy_state(fstate)

    # (b) the scanned step's DP reduction on this rank's own batch
    a_r, b_r, idx_r = p["dp"][rank]
    tstep = make_train_step(TC, LossConfig(), asm, W)
    state = _state(p["sd"])
    m = data_parallel_update(tstep, state, torch.as_tensor(a_r), torch.as_tensor(b_r),
                             _indices(idx_r), mesh)
    out["dp"] = dict(metrics=_float_metrics(m), grads=_grads(state), after=_numpy_state(state))

    # (c) FSDP steps against replicated DP steps
    rep, zero = _state(p["sd"]), _state(p["sd"])
    tp.to_fsdp_state(zero, TC, mesh)
    replicated_bytes = sum(t.numel() * t.element_size() for t in rep.module.parameters())
    for _ in range(FSDP_STEPS):
        for st in (rep, zero):
            data_parallel_update(tstep, st, torch.as_tensor(a_r), torch.as_tensor(b_r),
                                 _indices(idx_r), mesh)
    named = dict(zero.module.named_parameters())
    tc = copy.deepcopy(TC)
    tc["training"]["learning_rate"] = 1e-3
    falls = _state(p["sd"])
    tp.to_fsdp_state(falls, tc, mesh)
    fast = make_train_step(tc, LossConfig(), asm, W)
    losses = [float(data_parallel_update(fast, falls, torch.as_tensor(a_r), torch.as_tensor(b_r),
                                         _indices(idx_r), mesh)["loss"])
              for _ in range(8 if world == 2 else 0)]
    out["fsdp"] = dict(falls=losses,
        max_diff=max(float((a - b).abs().max()) for a, b in
                     zip(rep.module.state_dict().values(), zero.module.state_dict().values())),
        close=float(np.mean(np.concatenate([
            ((a - b).abs() <= 1e-7).numpy().ravel() for a, b in
            zip(rep.module.state_dict().values(), zero.module.state_dict().values())]))),
        state_bytes=zero.fsdp.state_bytes(zero.optimizer),
        replicated_bytes=3 * replicated_bytes,
        sharded_size=tp.sharded_size_bytes(named, tp.fsdp_shardings(named, mesh), mesh),
        params_bytes=replicated_bytes, axes=dict(zero.fsdp.axes),
        moments_diff=max(
            float((rep.optimizer.state[a]["exp_avg"] - g.state[b]["exp_avg"]).abs().max())
            for g in [zero.fsdp.gathered_optimizer(zero.optimizer)]
            for a, b in zip(rep.module.parameters(), zero.module.parameters())))

    # (e) pixel-sharded best match, a ragged HW and an even one
    fn = make_pixel_sharded_best_match(mesh)
    out["best_match"] = {hw: [t.numpy() for t in fn(torch.as_tensor(p["res"][:hw]),
                                                  torch.as_tensor(p["queries"]))]
                         for hw in (HW_RAGGED, HW_EVEN)}

    # sharded inference
    ds, dcn = _eval_inputs()
    imgs = torch.as_tensor(p["imgs"])
    out["inference"] = make_sharded_inference(dcn.module, mesh)(imgs).numpy()

    # (f) mesh= evaluation and descriptor statistics
    table = DCE.evaluate_network_quantitative(dcn, ds, mesh=mesh, **EVAL)
    out["eval"] = {c: table[c] for c in EVAL_COLUMNS}
    out["stats"] = DCE.compute_descriptor_statistics_on_dataset(
        dcn, SpartanDataset.make_synthetic(**SYNTH), mesh=mesh, **STATS)

    if world == 2:
        # (g) the sharded renderer, an odd number of poses
        verts, fg, faces, poses, K = _render_inputs()
        out["render"] = pr.render_scene_products_sharded(verts, fg, faces, poses, K, H, W,
                                                         1000.0, mesh)

        # (h) the trainer, data-parallel and with ZeRO storage
        out["trainer"] = {}
        for name, extra in (("dp", {}), ("fsdp", {"fsdp": True})):
            # 2 steps a call, so that the checkpoints of iteration 2 lie on a call's end
            cfg = train_config(p["root"], name, iters=4, data_parallel=True, steps_per_dispatch=2,
                               **extra)
            trainer = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                                  device="cpu")
            folder = trainer.run()
            out["trainer"][name] = dict(
                folder=folder, route=trainer.route, writes=trainer.writes,
                saves=len(trainer.save_seconds), fsdp=trainer.state.fsdp is not None,
                losses=list(trainer._logging_dict["train"]["loss"]),
                after=_numpy_state(trainer.state))
        # a first-use build reached by both ranks at once compiles once
        from pdc_tpu_torch.ops import _build

        _build.BUILD_DIR = type(_build.BUILD_DIR)(p["build_dir"])
        _build.load("png_loader")
        out["compiled"] = "png_loader" in _build.build_logs
    if rank:  # the others send digests of their weights, not the weights
        for part in [out["gspmd"], out["dp"]] + list(out.get("trainer", {}).values()):
            part["after"] = _digest(part["after"])
            part.pop("grads", None)
        out.pop("gspmd_fsdp_after")
    return out


# -- the JAX references and the spawns ------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """pdc_tpu's side: the JAX-assembled global batch, its single-device
    gradients, metrics and statistics, the sharded step on 2- and 4-device
    meshes, and the per-shard gradients that the scanned DP step averages."""
    import jax
    import jax.numpy as jnp

    from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
    from pdc_tpu.data.assembler import assemble_batch_matrix as jax_assemble
    from pdc_tpu.data.synthetic import SyntheticScene as JaxSyntheticScene
    from pdc_tpu.losses.matrix_loss import compose_loss_matrix as jax_compose
    from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
    from pdc_tpu.models.resnet import ResNetFCN as JaxResNetFCN
    from pdc_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from pdc_tpu.parallel.sharded_train import make_sharded_train_step as jax_sharded_step
    from pdc_tpu.training.train import TrainState, build_loss_fn, make_optimizer

    scene = JaxSyntheticScene(width=W, height=H, num_frames=8)
    rgb, depth, mask, poses = scene.render_all()
    ia, ib = np.array([0, 1, 2, 3]), np.array([4, 6, 7, 5])
    batch = dict(match_type=np.zeros(B, np.int32), rgb_a=rgb[ia], depth_a=depth[ia],
                 mask_a=mask[ia], pose_a=poses[ia].astype(np.float32), rgb_b=rgb[ib],
                 depth_b=depth[ib], mask_b=mask[ib], pose_b=poses[ib].astype(np.float32),
                 K=np.stack([scene.K] * B).astype(np.float32))
    key = jax.random.PRNGKey(0)
    jcfg = JaxAssemblerConfig(**ASM)
    img_a, img_b, idx = jax_assemble(key, batch, jcfg)
    jm = JaxResNetFCN(num_classes=D, stage_sizes=R18)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)), train=False)
    vg = jax.jit(jax.value_and_grad(build_loss_fn(jm, JaxLossConfig(), W, jax_compose),
                                    has_aux=True))

    def np_tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    def sd(params, stats):
        return {k: v.numpy() for k, v in flax_to_state_dict(
            {"params": np_tree(params), "batch_stats": np_tree(stats)}).items()}

    params, stats0 = variables["params"], variables["batch_stats"]
    (_, (stats, metrics)), grads = vg(params, stats0, img_a, img_b, idx)
    out = dict(sd=sd(params, stats0), img_a=np.asarray(img_a), img_b=np.asarray(img_b),
               idx=np_tree(idx), metrics=np_tree(metrics), grads=sd(grads, stats0),
               stats=sd(params, stats), meshes={}, dp={}, batch=batch)
    tx = make_optimizer(TC)
    for n in (2, 4):
        mesh = jax_make_mesh(devices=jax.devices()[:n])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats0,
                           opt_state=tx.init(params))
        new, m = jax_sharded_step(jm, tx, JaxLossConfig(), jcfg, W, mesh)(state, batch, key)
        out["meshes"][n] = dict(metrics=np_tree(m), after=sd(new.params, new.batch_stats))
        # the scanned DP step's reduction: per-shard gradients, stats and metrics, averaged
        b = B // n
        shards = [vg(params, stats0, img_a[r * b:(r + 1) * b], img_b[r * b:(r + 1) * b],
                     jax.tree_util.tree_map(lambda x: x[r * b:(r + 1) * b], idx))
                  for r in range(n)]
        mean = lambda *xs: sum(np.asarray(x, np.float64) for x in xs) / n  # noqa: E731
        out["dp"][n] = dict(
            grads=sd(jax.tree_util.tree_map(mean, *[g for _, g in shards]), stats0),
            stats=sd(params, jax.tree_util.tree_map(mean, *[s[0][1][0] for s in shards])),
            metrics={k: float(np.mean([float(s[0][1][1][k]) for s in shards]))
                     for k in metrics})
    return out


def _payload(ref, world, tmp):
    rng = np.random.default_rng(5)
    res = rng.standard_normal((HW_RAGGED, D)).astype(np.float32)
    queries = rng.standard_normal((N_QUERIES, D)).astype(np.float32)
    res[900] = res[10]  # an exact tie across blocks: the first block wins
    queries[0] = res[10]
    b = B // world
    dp = [(ref["img_a"][r * b:(r + 1) * b], ref["img_b"][r * b:(r + 1) * b],
           [np.asarray(x)[r * b:(r + 1) * b] for x in ref["idx"]]) for r in range(world)]
    imgs = rng.standard_normal((3, 3, H, W)).astype(np.float32)  # 3 images: padded
    return dict(sd=ref["sd"], img_a=ref["img_a"], img_b=ref["img_b"],
                idx=[np.asarray(x) for x in ref["idx"]], dp=dp, res=res, queries=queries,
                imgs=imgs, root=str(tmp / "models"), build_dir=str(tmp / "build"))


_SPAWNED = {}


def _spawned(world, ref, tmp_path_factory):
    """The ranks' results of one world size, spawned once per module."""
    if world not in _SPAWNED:
        payload = _payload(ref, world, tmp_path_factory.mktemp(f"ranks{world}"))
        _SPAWNED[world] = (world, payload, spawn(_rank_body, world, "cpu", payload))
    return _SPAWNED[world]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def ranks(request, ref, tmp_path_factory):
    return _spawned(request.param, ref, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks2(ref, tmp_path_factory):
    """The 2-rank results alone (the trainer and the renderer run there)."""
    return _spawned(2, ref, tmp_path_factory)


@pytest.fixture(scope="module")
def single(ref):
    """The port's single-device step on the whole global batch."""
    state = _state(ref["sd"])
    step = make_train_step(TC, LossConfig(), AssemblerConfig(**ASM), W)
    m = step.update(state, torch.as_tensor(ref["img_a"]), torch.as_tensor(ref["img_b"]),
                    _indices(ref["idx"]))
    return dict(metrics=_float_metrics(m), grads=_grads(state), after=_numpy_state(state))


def _rel_l2(got: dict, want: dict, names):
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in names)
    den = sum(float((want[k] ** 2).sum()) for k in names)
    return (num / den) ** 0.5


# -- the tests -------------------------------------------------------------------------------


def test_mesh_and_every_rank_agree(ranks):
    world, _, outs = ranks
    assert [o["rank"] for o in outs] == list(range(world))
    for r, o in enumerate(outs):
        assert o["mesh"] == ({"data": world}, {"data": r})
    for o in outs[1:]:  # replicated results are the same on every rank
        assert o["gspmd"]["metrics"] == outs[0]["gspmd"]["metrics"]
        assert o["gspmd"]["after"] == _digest(outs[0]["gspmd"]["after"])
        np.testing.assert_array_equal(o["inference"], outs[0]["inference"])


def test_global_batch_step_matches_jax_mesh_and_the_single_step(ranks, ref, single):
    """(a) Against pdc_tpu's sharded step on a mesh of as many devices, with
    F3's tolerances (tests/test_torch_port_train.py): metrics rtol 1e-4,
    gradients against JAX's global-batch gradients 1e-2 relative L2
    (measured 2.1e-3), parameters after Adam within 2 lr, BatchNorm
    statistics atol 1e-5. Against the port's single-device step on the
    whole batch, which sums the same terms in another order: metrics rtol
    2e-5 (measured 6.0e-6 on 2 ranks, 4.4e-6 on 4), gradients 1e-3
    relative L2 (3.8e-4 and 3.6e-4: a rounding-level difference flips a
    ReLU gate, as F3 says), parameters after Adam within 2 lr and 99.9%
    of them within 1e-7 (99.988% on both: Adam's first step moves an
    element by lr times the sign of its gradient, and a near-zero gradient
    can change sign), statistics atol 1e-6 (2.4e-7)."""
    world, _, outs = ranks
    got = outs[0]["gspmd"]
    jmesh = ref["meshes"][world]
    for k, want in jmesh["metrics"].items():  # JAX's mesh equals JAX's single device
        np.testing.assert_allclose(float(want), float(ref["metrics"][k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["metrics"][k], float(want), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["metrics"][k], single["metrics"][k], rtol=2e-5,
                                   err_msg=k)
    names = list(got["grads"])
    assert _rel_l2(got["grads"], ref["grads"], names) <= 1e-2
    assert _rel_l2(got["grads"], single["grads"], names) <= 1e-3
    close = np.concatenate([(np.abs(got["after"][k] - single["after"][k]) <= 1e-7).ravel()
                            for k in names])
    assert close.mean() >= 0.999
    for name, v in got["after"].items():
        if "running" in name:
            np.testing.assert_allclose(v, jmesh["after"][name], atol=1e-5, err_msg=name)
            np.testing.assert_allclose(v, single["after"][name], atol=1e-6, err_msg=name)
        elif name in got["grads"]:
            assert np.abs(v - jmesh["after"][name]).max() <= 2 * LR * (1 + 1e-3), name
            assert np.abs(v - single["after"][name]).max() <= 2 * LR * (1 + 1e-3), name
    # ZeRO storage changes no number of the step but for the sums' order (as above)
    zero = outs[0]["gspmd_fsdp_after"]
    assert all(np.abs(zero[k] - got["after"][k]).max() <= 2 * LR for k in names)
    assert np.concatenate([(np.abs(zero[k] - got["after"][k]) <= 1e-7).ravel()
                           for k in names]).mean() >= 0.999


def test_scanned_dp_reduction_matches_jax_per_shard_mean(ranks, ref):
    """(b) Each rank's own batch and BatchNorm, then the mean over ranks of
    the gradients, running statistics and metrics, against JAX's per-shard
    values averaged (pdc_tpu/training/scanned.py:630-656): metrics rtol
    1e-4, gradients 1e-2 relative L2, statistics atol 1e-5 (F3)."""
    world, _, outs = ranks
    want = ref["dp"][world]
    got = outs[0]["dp"]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    assert _rel_l2(got["grads"], want["grads"], list(got["grads"])) <= 1e-2
    for name, v in got["after"].items():
        if "running" in name:
            np.testing.assert_allclose(v, want["stats"][name], atol=1e-5, err_msg=name)
    for o in outs[1:]:
        assert o["dp"]["after"] == _digest(got["after"])


@pytest.mark.parametrize("backbone", [(2, 2, 2, 2), (3, 4, 6, 3)], ids=["resnet18", "resnet34"])
@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_shard_axes_are_jax(backbone, n):
    """(c) The per-leaf shard axis equals JAX's exactly on the flax layout,
    and the port's parameter axis is JAX's mapped from HWIO to OIHW."""
    import jax
    import jax.numpy as jnp

    from pdc_tpu.models.resnet import ResNetFCN as JaxResNetFCN
    from pdc_tpu.parallel import tensor_parallel as jtp

    shapes = jax.eval_shape(lambda k: JaxResNetFCN(num_classes=D, stage_sizes=backbone).init(
        k, jnp.zeros((1, H, W, 3)), train=False), jax.random.PRNGKey(0))["params"]
    port = ResNetFCN(D, stage_sizes=backbone)
    flax = state_dict_to_flax(port.state_dict())["params"]
    want = jtp.tree_shard_axes(shapes, n)
    assert tp.tree_shard_axes(flax, n) == want
    specs = tp.tree_shard_specs(flax, n, "data")
    jspecs = jtp.tree_shard_specs(shapes, n, "data")
    flat_want = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    flat_got = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(s) for s in flat_want] == flat_got
    for j in range(8):
        assert tp.best_shard_axis(tuple(range(j)), n) == jtp.best_shard_axis(tuple(range(j)), n)
    for name, p in port.named_parameters():
        module, leaf = name.rsplit(".", 1)
        node = want
        for part in module.split("."):
            node = node[part]
        jax_axis = node["kernel" if p.dim() == 4 else ("scale" if leaf == "weight" else "bias")]
        port_axis = tp.param_shard_axis(p.shape, n)
        assert port_axis == (None if jax_axis is None else
                             ((2, 3, 1, 0)[jax_axis] if p.dim() == 4 else jax_axis)), name


def test_fsdp_steps_equal_replicated_steps(ranks):
    """(c) Three ZeRO steps equal three replicated DP steps, and each rank
    stores 1/n of the parameters and moments, but for the few leaves no
    axis divides. On 2 ranks the reduce-scatter adds the same two numbers
    as the all-reduce: equal within 1e-7, the gathered Adam moments within
    1e-9. On 4 ranks gloo sums in another order, and Adam's normalisation
    turns a rounding-level difference of a near-zero gradient into up to
    one lr per step, which later steps carry on: every element within 2 lr
    per step and 95% within 1e-7 (measured 97.3% to 99.996% with other
    weights and collective layouts). Eight ZeRO steps at
    lr 1e-3 on each of 2 ranks' fixed batch lower the loss."""
    world, _, outs = ranks
    for o in outs:
        f = o["fsdp"]
        if world == 2:
            assert f["max_diff"] <= 1e-7 and f["moments_diff"] <= 1e-9
        assert f["max_diff"] <= 2 * LR * FSDP_STEPS and f["close"] >= 0.95
        losses = f["falls"]
        if world == 2:
            assert np.isfinite(losses).all() and np.mean(losses[-2:]) < 0.9 * losses[0], losses
        replicated = sum(1 for ax in f["axes"].values() if ax is None)
        assert replicated <= 2, f["axes"]  # the D=3 head's bias (and nothing else of size)
        assert f["sharded_size"] <= f["params_bytes"] / world + 64
        assert f["state_bytes"] <= f["replicated_bytes"] / world + 3 * 64


def test_pixel_sharded_best_match(ranks, ref):
    """(e) Every rank returns the single-device best match exactly (a ragged
    HW included; an exact tie across blocks goes to the lower index), and
    pdc_tpu's pixel-sharded program within F1's bound: distances within
    7.8e-3 of the port's, picks equal unless their float64 distances tie
    within 1e-5."""
    world, payload, outs = ranks
    for hw in (HW_RAGGED, HW_EVEN):
        res = torch.as_tensor(payload["res"][:hw])
        q = torch.as_tensor(payload["queries"])
        want_idx, want_dist = best_match(res.t().contiguous()[None], q[None])
        for o in outs:
            idx, dist = o["best_match"][hw]
            np.testing.assert_array_equal(idx, want_idx[0].numpy())
            np.testing.assert_array_equal(dist, want_dist[0].numpy())
        assert outs[0]["best_match"][hw][0][0] == 10
    import jax
    import jax.numpy as jnp

    from pdc_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from pdc_tpu.parallel.sharded_train import make_pixel_sharded_best_match as jax_pixel

    res = payload["res"][:HW_EVEN]
    jidx, jdist = jax_pixel(jax_make_mesh(devices=jax.devices()[:world]))(
        jnp.asarray(res), jnp.asarray(payload["queries"]))
    idx, dist = outs[0]["best_match"][HW_EVEN]
    np.testing.assert_allclose(dist, np.asarray(jdist), atol=7.8e-3)
    d2 = ((res[None].astype(np.float64) - payload["queries"][:, None]) ** 2).sum(-1)
    rows = np.arange(len(idx))
    assert np.all((np.asarray(jidx) == idx)
                  | (np.abs(d2[rows, np.asarray(jidx)] - d2[rows, idx]) <= 1e-5))


def test_sharded_inference_equals_the_whole_batch(ranks):
    world, payload, outs = ranks
    _, dcn = _eval_inputs()
    module = dcn.module.eval()
    with torch.no_grad():
        want = module(torch.as_tensor(payload["imgs"])).numpy()
    np.testing.assert_allclose(outs[0]["inference"], want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_mesh_evaluation_and_statistics_equal_mesh_none(ranks):
    """(f) Every rank's sweep equals the unsharded sweep row for row (the
    forwards are whole on every rank, as in pdc_tpu). The descriptor
    statistics forward each rank's block of a batch, and a CPU convolution
    of 2 or 1 images rounds apart from one of 4: they equal the unsharded
    ones within 1e-5 (measured 8.5e-7), the same on every rank."""
    world, _, outs = ranks
    ds, dcn = _eval_inputs()
    want = DCE.evaluate_network_quantitative(dcn, ds, **EVAL)
    stats = DCE.compute_descriptor_statistics_on_dataset(
        dcn, SpartanDataset.make_synthetic(**SYNTH), **STATS)
    assert len(want) > 0
    for o in outs:
        for c in EVAL_COLUMNS:
            got = o["eval"][c]
            assert len(got) == len(want[c]), c
            if got.dtype.kind == "f":
                np.testing.assert_array_equal(got, want[c], err_msg=c)
            else:
                assert list(got) == list(want[c]), c
        assert o["stats"] == outs[0]["stats"]
        for part in stats:
            for k in stats[part]:
                np.testing.assert_allclose(o["stats"][part][k], stats[part][k], rtol=0,
                                           atol=1e-5, err_msg=(part, k))


def test_sharded_renderer_equals_unsharded(ranks2):
    """(g) 5 poses over 2 ranks (padded) equal render_scene_products bit
    for bit."""
    _, _, outs = ranks2
    verts, fg, faces, poses, K = _render_inputs()
    want = pr.render_scene_products(verts, fg, faces, poses, K, H, W, 1000.0, device="cpu")
    for o in outs:
        for g, w, what in zip(o["render"], want, ("mask", "depth_cropped_mm", "depth_full_mm")):
            assert g.shape == w.shape == (N_POSES, H, W) and g.dtype == w.dtype, what
            np.testing.assert_array_equal(g, w, err_msg=what)
    assert want[0].any() and (want[2] > 0).any()


def test_data_parallel_trainer_on_two_ranks(ranks2):
    """(h) ``training.data_parallel`` (and ``fsdp``) on 2 gloo ranks: the
    device-sampler route, finite losses (the same on both ranks), every
    rank ends with the same weights, rank 0 alone writes, and the folder
    loads in the single route (Adam's moments whole) and in pdc_tpu. The
    loss's fall is held on fixed batches (the ZeRO steps above): over a few
    sampled steps at this size it rises on one device too (1.53 to 6.84 in
    6 steps)."""
    _, _, outs = ranks2
    for name in ("dp", "fsdp"):
        r0, r1 = outs[0]["trainer"][name], outs[1]["trainer"][name]
        assert r0["route"] == r1["route"] == "device sampler"
        # saves at 0, 2 and 4, and the final one at 4
        assert r0["writes"] and not r1["writes"] and r1["saves"] == 0 and r0["saves"] == 4
        assert r0["fsdp"] == r1["fsdp"] == (name == "fsdp")
        losses = r0["losses"]
        assert len(losses) == 4 and np.isfinite(losses).all() and losses == r1["losses"]
        assert r1["after"] == _digest(r0["after"])
        folder = r0["folder"]
        assert {"000000.ckpt", "000002.ckpt", "000004.ckpt.opt", "training.yaml"} <= set(
            os.listdir(folder))
        cfg = train_config(os.path.dirname(folder), name, iters=1)
        single = DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                             device="cpu")
        assert single.load_pretrained(folder) == 4
        for k, v in single.state.module.state_dict().items():
            if not k.endswith("num_batches_tracked"):  # not in the checkpoint format
                np.testing.assert_array_equal(v.numpy(), r0["after"][k], err_msg=k)
        assert all(single.state.optimizer.state[p]["exp_avg"].shape == p.shape
                   for p in single.state.module.parameters())
    from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN

    jdcn = JaxDCN.from_model_folder(outs[0]["trainer"]["fsdp"]["folder"])
    got = flax_to_state_dict({k: v for k, v in jdcn.variables.items()})
    for k, v in got.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), outs[0]["trainer"]["fsdp"]["after"][k])
    # the two folders hold about 1 GB of checkpoints and Adam states
    shutil.rmtree(os.path.dirname(outs[0]["trainer"]["fsdp"]["folder"]))
    assert sum(o["compiled"] for o in outs) == 1  # the build lock: one compile


def test_rank_seed_and_process_info():
    assert rank_seed(7, 0) == 7 and rank_seed(7, 1) != rank_seed(7, 2) != 7
    assert distributed.process_info()["process_count"] == 1
    names = [f"s{i}" for i in (3, 1, 0, 2, 4)]
    assert distributed.local_scene_subset(names, 1, 2) == ["s1", "s3"]
    assert distributed.local_scene_subset(names) == sorted(names)
    # the model axes are ported: channel_shardings and make_tp_train_step no longer raise
    mesh = make_mesh(("data", "model"), shape=(1, 1), device="cpu")
    assert tp.channel_shardings({"k": torch.zeros(1, 1, 1, 4), "b": torch.zeros(3)}, mesh) == {
        "k": (None, None, None, "model"), "b": ("model",)}
    state = create_train_state(ResNetFCN(D, stage_sizes=R18), TC, device="cpu")
    step, state = tp.make_tp_train_step(TC, LossConfig(), AssemblerConfig(**ASM), W, mesh, state)
    assert state.tp is not None and any(isinstance(m, tp.ColumnParallelConv)
                                        for m in state.module.modules())


def test_data_parallel_server_answers_in_request_order():
    """(i) Two replicas (devices=["cpu", "cpu"]) split each coalesced batch:
    the answers equal the one-replica server's, request by request."""
    _, dcn = _eval_inputs()
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    queries = rng.standard_normal((3, 2, D)).astype(np.float32)
    answers = []
    for devices in (None, ["cpu", "cpu"]):
        server = DescriptorServer(dcn, port=0, max_batch=4, devices=devices)
        try:
            assert server._buckets == ((1, 2, 4) if devices is None else (2, 4))
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
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * float(np.abs(a).max()))
