"""The sharded device cache and its bounded samplers
(pdc_tpu_torch.data.device_cache.ShardedDeviceCache,
pdc_tpu_torch.training.scanned) against pdc_tpu's on the CPU.

``partition_scenes`` and every shard's padded tables must equal the JAX
cache's on a mesh of as many virtual devices exactly, and each rank's frame
block the JAX cache's rows of that shard. A rank's view is built here
without a process group (a :class:`~pdc_tpu_torch.parallel.mesh.Mesh` of
the rank's index whose collectives are not needed to build it). The
bounded samplers draw from a torch.Generator, so they are held by
invariants: every pair inside the rank's own scenes, the pose rule, and
the host sampler's fallbacks. Training over the sharded cache runs on 2
gloo ranks (``_train_ranks``, which imports no jax).
"""

import numpy as np
import pytest
import torch

from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.data.device_cache import ShardedDeviceCache, partition_scenes, sharded_tables
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models.resnet import ResNetFCN, init_weights_
from pdc_tpu_torch.parallel import make_mesh, spawn
from pdc_tpu_torch.parallel.mesh import Mesh
from pdc_tpu_torch.training import scanned
from pdc_tpu_torch.training.train import create_train_state

torch.set_num_threads(2)

W, H = 64, 48
SYNTH = dict(num_scenes=5, num_objects=2, width=W, height=H, num_frames=6)
FRAMES = (6, 3, 5, 4, 6)  # scene i keeps FRAMES[i] frames: unequal loads
TC = {"training": {"learning_rate": 1e-3, "learning_rate_decay": 0.9,
                   "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}
ASM = dict(num_matching_attempts=256, masked_pool_size=64, background_pool_size=64,
           num_blind_samples=100)
MIXES = {"within": ((0, 1.0),), "mixed": ((0, 0.4), (1, 0.2), (2, 0.2), (4, 0.2))}


def _truncate(ds):
    """Unequal scene lengths, so the greedy partition has loads to balance."""
    for i, name in enumerate(ds.scenes):
        s = ds.scenes[name]
        for field in ("rgb", "depth", "mask", "poses"):
            setattr(s, field, getattr(s, field)[:FRAMES[i]])
    return ds


def _view(n, c):
    """Rank ``c`` of an ``n``-rank data axis, without a process group."""
    return Mesh(("data",), (n,), c, torch.device("cpu"), {"data": None})


@pytest.fixture(scope="module")
def datasets():
    from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset

    return _truncate(SpartanDataset.make_synthetic(**SYNTH)), _truncate(
        JaxSpartanDataset.make_synthetic(**SYNTH))


@pytest.mark.parametrize("by_object", [False, True], ids=["by_scene", "by_object"])
@pytest.mark.parametrize("n", [2, 4])
def test_partition_and_tables_equal_jax(datasets, n, by_object):
    import jax

    from pdc_tpu.data.device_cache import ShardedDeviceCache as JaxShardedDeviceCache
    from pdc_tpu.data.device_cache import partition_scenes as jax_partition
    from pdc_tpu.parallel.mesh import make_mesh as jax_make_mesh

    port, ref = datasets
    if by_object and n == 4:  # 2 objects for 4 shards: both packages refuse
        for fn, ds in ((partition_scenes, port), (jax_partition, ref)):
            with pytest.raises(ValueError, match="too few objects"):
                fn(ds, n, by_object=True)
        return
    shards = partition_scenes(port, n, by_object=by_object)
    assert shards == jax_partition(ref, n, by_object=by_object)
    jcache = JaxShardedDeviceCache.from_dataset(
        ref, jax_make_mesh(devices=jax.devices()[:n]), by_object=by_object)
    tables = sharded_tables(port, shards)
    assert tables["frames_per_shard"] == jcache.frames_per_shard
    for name in ("scene_offsets", "scene_lengths", "num_scenes", "scenes_by_object",
                 "scenes_per_object", "num_objects"):
        want = np.asarray(getattr(jcache, name))
        assert tables[name].dtype == want.dtype and tables[name].shape == want.shape, name
        np.testing.assert_array_equal(tables[name], want, err_msg=name)
    fmax = jcache.frames_per_shard
    for c in range(n):
        cache = ShardedDeviceCache.from_dataset(port, _view(n, c), by_object=by_object)
        assert cache.assignment == jcache.assignment and cache.frames_per_shard == fmax
        rows = slice(c * fmax, (c + 1) * fmax)
        for name in ("rgb", "depth", "mask", "poses", "Ks", "pixel_perm", "mask_count"):
            np.testing.assert_array_equal(getattr(cache, name).numpy(),
                                          np.asarray(getattr(jcache, name))[rows], err_msg=name)
        assert cache.nbytes_per_device == jcache.nbytes_per_device
        np.testing.assert_array_equal(cache.scene_offsets.numpy(), tables["scene_offsets"][c])
        assert cache.num_scenes == tables["num_scenes"][c, 0]


def _scene_of(cache):
    """Local frame -> local scene slot (-1 for padding rows)."""
    out = np.full(cache.frames_per_shard, -1)
    for s in range(cache.num_scenes):
        o, n = int(cache.scene_offsets[s]), int(cache.scene_lengths[s])
        out[o:o + n] = s
    return out


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_bounded_samplers_stay_on_their_rank(datasets, mix):
    """Every drawn frame is one of the rank's real frames, within-scene rows
    keep one scene and pass the pose rule (or are the empty pair, frame a
    twice), across-scene rows keep one object, and the fallbacks: a rank
    with one object draws no different-object row (type 0 instead), its
    synthetic multi-object rows composite that object twice, and an object
    with one scene gives across-scene rows within that scene."""
    port, _ = datasets
    probs = MIXES[mix]
    for by_object, n in ((False, 2), (True, 2), (False, 4)):
        for c in range(n):
            cache = ShardedDeviceCache.from_dataset(port, _view(n, c), by_object=by_object)
            g = torch.Generator().manual_seed(11 + c)
            if mix == "within":
                fa, fb, mt = scanned.device_sample_pairs_bounded(
                    g, cache.scene_offsets, cache.scene_lengths, cache.num_scenes, cache.poses,
                    512)
                fa2, fb2 = fa, fb
            else:
                fa, fb, fa2, fb2, mt = scanned.device_sample_pairs_mixed_bounded(
                    g, cache.scene_offsets, cache.scene_lengths, cache.num_scenes,
                    cache.scenes_by_object, cache.scenes_per_object, cache.num_objects,
                    cache.poses, 512, probs, with_second=True)
            fa, fb, fa2, fb2, mt = (x.numpy() for x in (fa, fb, fa2, fb2, mt))
            scene = _scene_of(cache)
            names = sorted(n_ for n_, k in cache.assignment.items() if k == c)
            obj = np.array([port.scenes[names[s]].object_id for s in range(len(names))])
            for f in (fa, fb, fa2, fb2):
                assert (scene[f] >= 0).all()  # never a padding row
            ok = scanned._pose_ok(cache.poses[fa], cache.poses[fb][:, None])[:, 0].numpy()
            within = (mt == 0) | (mt == 4)
            assert (scene[fa[within]] == scene[fb[within]]).all() and ok[within].all()
            assert ((mt != -1) | (fa == fb)).all()
            across = mt == 1
            assert (obj[scene[fa[across]]] == obj[scene[fb[across]]]).all()
            singles = [s for s in range(len(names)) if (obj == obj[s]).sum() == 1]
            lone = across & np.isin(scene[fa], singles)
            assert (scene[fa[lone]] == scene[fb[lone]]).all()
            one_object = cache.num_objects == 1
            if one_object:
                assert not (mt == 2).any()
                smo = mt == 4
                assert (obj[scene[fa2[smo]]] == obj[scene[fa[smo]]]).all()
            elif mix == "mixed":
                diff = mt == 2
                assert diff.any() and (obj[scene[fa[diff]]] != obj[scene[fb[diff]]]).all()
            if mix == "mixed":
                assert (mt == 4).any() and (mt == 0).any()


def _train_ranks(rank, world, probs, fsdp):
    """Two steps over a by-object sharded cache on each rank."""
    mesh = make_mesh(device="cpu")
    ds = _truncate(SpartanDataset.make_synthetic(**SYNTH))
    cache = ShardedDeviceCache.from_dataset(ds, mesh, by_object=True)
    module = init_weights_(ResNetFCN(3, stage_sizes=(2, 2, 2, 2)), torch.Generator().manual_seed(0))
    state = create_train_state(module, TC, device="cpu")
    step = scanned.make_sharded_cache_train_step(TC, LossConfig(), AssemblerConfig(**ASM), W,
                                                 cache, batch_size=2, type_probs=probs,
                                                 fsdp=fsdp)
    gen = torch.Generator().manual_seed(100 + rank)
    losses = [float(step(state, gen)["loss"]) for _ in range(2)]
    return dict(losses=losses, fsdp=state.fsdp is not None, nbytes=cache.nbytes_per_device,
                scenes=sorted(k for k, v in cache.assignment.items() if v == rank),
                params={k: v.detach().clone() for k, v in state.module.state_dict().items()})


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
def test_sharded_cache_training_on_two_ranks(fsdp):
    """Each rank trains from its own scenes (one object each); the metrics
    and the weights after every step are the same on both ranks, and each
    rank holds only a block the size of the larger shard (17 of the 24
    frames: one object's scenes)."""
    probs = MIXES["mixed"]
    outs = spawn(_train_ranks, 2, "cpu", probs, fsdp)
    assert outs[0]["scenes"] and outs[1]["scenes"]
    assert not set(outs[0]["scenes"]) & set(outs[1]["scenes"])
    ds = _truncate(SpartanDataset.make_synthetic(**SYNTH))
    total = sum(s.rgb.nbytes + s.depth.nbytes + s.mask.nbytes for s in ds.scenes.values())
    for o in outs:
        assert o["fsdp"] == fsdp
        assert np.isfinite(o["losses"]).all() and o["losses"] == outs[0]["losses"]
        assert o["nbytes"] == outs[0]["nbytes"] == total * 17 // 24
        for k, v in o["params"].items():
            assert torch.equal(v, outs[0]["params"][k]), k


def _scanned_ranks(rank, world):
    """One call of 2 steps a call over a sharded cache against 2 one-step
    calls from a copy of the state and the generator."""
    import copy

    mesh = make_mesh(device="cpu")
    ds = _truncate(SpartanDataset.make_synthetic(**SYNTH))
    cache = ShardedDeviceCache.from_dataset(ds, mesh, by_object=True)
    module = init_weights_(ResNetFCN(3, stage_sizes=(2, 2, 2, 2)), torch.Generator().manual_seed(0))
    state = create_train_state(module, TC, device="cpu")
    twin = copy.deepcopy(state)
    args = (TC, LossConfig(), AssemblerConfig(**ASM), W, cache)
    call = scanned.make_sharded_cache_train_step(*args, batch_size=2, type_probs=MIXES["mixed"],
                                                 steps_per_dispatch=2)
    one = scanned.make_sharded_cache_train_step(*args, batch_size=2, type_probs=MIXES["mixed"])
    gen, gen_twin = (torch.Generator().manual_seed(100 + rank) for _ in range(2))
    got = call(state, gen)
    want = [one(twin, gen_twin) for _ in range(2)]
    return dict(graphed=call.graphed, launches=call.launches_per_dispatch, steps=state.step,
                same_metrics=all(torch.equal(v, torch.stack([m[k] for m in want]))
                                 for k, v in got.items()),
                shapes={k: tuple(v.shape) for k, v in got.items()},
                same_state=all(torch.equal(a, b) for a, b in zip(
                    state.module.state_dict().values(), twin.module.state_dict().values())),
                same_generator=torch.equal(gen.get_state(), gen_twin.get_state()))


def test_sharded_cache_takes_k_steps_a_call_on_two_ranks():
    """make_sharded_cache_train_step with steps_per_dispatch=2 (JAX's K-step
    scan) on 2 gloo ranks: one call is 2 steps of the one-step route, bit for
    bit (metrics [2], weights, generator), run eagerly (a process group's
    collectives are not captured), 4 pooled-hinge passes each way."""
    for o in spawn(_scanned_ranks, 2, "cpu"):
        assert not o["graphed"] and o["steps"] == 2
        assert o["same_metrics"] and o["same_state"] and o["same_generator"]
        assert set(o["shapes"].values()) == {(2,)}
        assert o["launches"] == {"forward": 4, "backward": 4}
