"""The port's device cache (pdc_tpu_torch.data.device_cache) and on-device
pair sampler (pdc_tpu_torch.training.scanned) against pdc_tpu, on the CPU.

The cache's stacks, scene offsets, pixel permutations and mask counts, its
host-sampled index batches and its gathers must equal the JAX cache's
exactly (same seeded dataset). The sampling tables and the pose test must
be exactly equal. The device sampler draws from a torch.Generator, so its
rows are held by distribution (type frequencies within 4 sigma of the JAX
sampler's over 4096 draws each) and by invariants (one scene per
within-scene row, the pose test passed or the row empty, a synthetic
multi-object row's second pair in another object's scene).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset
from pdc_tpu.data.device_cache import DeviceCache as JaxDeviceCache
from pdc_tpu.training import scanned as jax_scanned
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.data.device_cache import DeviceCache
from pdc_tpu_torch.training import scanned

torch.set_num_threads(2)

W, H = 64, 48
SYNTH = dict(num_scenes=4, num_objects=2, num_test_scenes=1, width=W, height=H, num_frames=6)
MIX = {"SINGLE_OBJECT_WITHIN_SCENE": 0.4, "SINGLE_OBJECT_ACROSS_SCENE": 0.2,
       "DIFFERENT_OBJECT": 0.2, "SYNTHETIC_MULTI_OBJECT": 0.2}
N_DRAWS = 4096


def _config(mix):
    return {"training": {"num_matching_attempts": 256, "sample_matches_only_off_mask": True,
                         "num_non_matches_per_match": 10, "fraction_masked_non_matches": 0.5,
                         "fraction_background_non_matches": 0.5, "data_type_probabilities": mix}}


@pytest.fixture(scope="module")
def caches():
    port = SpartanDataset.make_synthetic(**SYNTH)
    ref = JaxSpartanDataset.make_synthetic(**SYNTH)
    for ds in (port, ref):
        ds.set_parameters_from_training_config(_config(MIX))
    return DeviceCache.from_dataset(port, device="cpu"), JaxDeviceCache.from_dataset(ref)


def test_cache_stacks_offsets_and_permutations_equal_jax(caches):
    port, ref = caches
    assert port.scene_offsets == ref.scene_offsets
    assert port.scene_lengths == ref.scene_lengths
    assert port.rgb.dtype == torch.uint8 and port.depth.dtype == torch.uint16
    assert port.pixel_perm.dtype == torch.int32 and port.mask_count.dtype == torch.int32
    for name in ("rgb", "depth", "mask", "pixel_perm", "mask_count"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("poses", "Ks"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    assert port.nbytes == ref.nbytes


def test_index_batches_and_gathers_equal_jax(caches):
    port, ref = caches
    for _ in range(3):
        a, b = port.sample_index_batch(4), ref.sample_index_batch(4)
        assert sorted(a) == sorted(b) and "frame_a_2" in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        ga, gb = port.gather(a), ref.gather(b)
        assert sorted(ga) == sorted(gb)
        for k in ga:
            np.testing.assert_array_equal(ga[k].numpy(), np.asarray(gb[k]), err_msg=k)


def test_cache_budget_raises_memory_error():
    ds = SpartanDataset.make_synthetic(num_scenes=2, width=W, height=H, num_frames=3)
    frame = W * H * (3 + 2 + 1)
    with pytest.raises(MemoryError):
        DeviceCache.from_dataset(ds, max_bytes=5 * frame, device="cpu")
    assert DeviceCache.from_dataset(ds, max_bytes=6 * frame, device="cpu").nbytes == 6 * frame


def test_sampling_tables_equal_jax(caches):
    port, ref = caches
    got = scanned.build_sampling_tables(port)
    want = jax_scanned.build_sampling_tables(ref)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _random_poses(rng, n):
    """Rotations about random axes by angles around the 20-degree threshold,
    translations around the 0.2 m one."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(rng.uniform(0, 40))
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        out[i, :3, :3] = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
        out[i, :3, 3] = rng.standard_normal(3) * 0.05
    return out.astype(np.float32)


def test_pose_test_equals_jax(caches):
    port, _ = caches
    rng = np.random.default_rng(0)
    poses = np.concatenate([port.poses, _random_poses(rng, 64)])
    P = torch.from_numpy(poses)
    got = scanned._pose_ok(P, P[None].expand(len(P), -1, -1, -1))  # every pose against all
    want = np.stack([np.asarray(jax_scanned._pose_ok(jnp.asarray(p), jnp.asarray(poses)))
                     for p in poses])
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95  # both outcomes are exercised


def test_draw_below_stays_below_the_bound_at_the_edge():
    edge = np.nextafter(1.0, 0.0)
    u = torch.tensor([0.0, 0.5, edge, edge, edge, edge], dtype=torch.float64)
    n = torch.tensor([1, 3, 3, 2 ** 31 - 1, 2 ** 40 + 1, 0])
    r = scanned.draw_below(u, n)
    assert r.tolist() == [0, 1, 2, 2 ** 31 - 2, 2 ** 40, 0]
    # in float32 the edge rounds up to the bound itself: the reason for float64
    # draws and the clamp
    assert int(np.floor(np.float32(edge) * np.float32(3))) == 3


def _port_draws(cache, probs, n=N_DRAWS, seed=0):
    tables = scanned.build_sampling_tables(cache)
    poses = torch.from_numpy(cache.poses)
    g = torch.Generator().manual_seed(seed)
    return [x.numpy() for x in scanned.device_sample_pairs_mixed(
        g, tables, poses, n, probs, with_second=True)]


def _jax_draws(cache, probs, n=N_DRAWS):
    tables = jax_scanned.build_sampling_tables(cache)
    out = jax_scanned.device_sample_pairs_mixed(
        jax.random.PRNGKey(0), tables, jnp.asarray(cache.poses), n, probs, with_second=True)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("probs", [((0, 1.0),), ((0, 0.5), (1, 0.25), (2, 0.25)),
                                   ((0, 0.4), (1, 0.2), (2, 0.2), (4, 0.2))],
                         ids=["within", "mixed", "mixed-smo"])
def test_device_sampler_type_frequencies_match_jax(caches, probs):
    port, ref = caches
    got, want = _port_draws(port, probs)[-1], _jax_draws(ref, probs)[-1]
    for t in (-1, 0, 1, 2, 4):
        p1, p2 = (got == t).mean(), (want == t).mean()
        p = (p1 + p2) / 2
        sigma = np.sqrt(max(p * (1 - p), 1.0 / N_DRAWS) * 2.0 / N_DRAWS)
        assert abs(p1 - p2) <= 4 * sigma, (t, p1, p2)


def test_device_sampler_rows_keep_their_invariants(caches):
    port, _ = caches
    probs = ((0, 0.4), (1, 0.2), (2, 0.2), (4, 0.2))
    fa, fb, fa2, fb2, mt = _port_draws(port, probs, seed=3)
    names = sorted(port.scene_offsets)
    starts = np.array([port.scene_offsets[n] for n in names])
    scene_of = np.searchsorted(starts, np.arange(len(port.poses)), side="right") - 1
    obj = np.array([port.dataset.scenes[names[s]].object_id for s in scene_of])
    ok = scanned._pose_ok(torch.from_numpy(port.poses[fa]),
                          torch.from_numpy(port.poses[fb])[:, None])[:, 0].numpy()
    for t in (0, 4):  # within-scene pairs: one scene, poses apart
        rows = mt == t
        assert rows.any()
        assert (scene_of[fa[rows]] == scene_of[fb[rows]]).all()
        assert ok[rows].all()
    assert ((mt != -1) | (fa == fb)).all()  # the empty pair is frame a twice
    across = mt == 1
    assert (obj[fa[across]] == obj[fb[across]]).all()
    assert (scene_of[fa[across]] != scene_of[fb[across]]).all()  # 2 scenes per object
    diff = mt == 2
    assert (obj[fa[diff]] != obj[fb[diff]]).all()
    smo = mt == 4
    assert (scene_of[fa2[smo]] == scene_of[fb2[smo]]).all()
    assert (obj[fa2[smo]] != obj[fa[smo]]).all()  # the second pair is another object's
    ok2 = scanned._pose_ok(torch.from_numpy(port.poses[fa2[smo]]),
                           torch.from_numpy(port.poses[fb2[smo]])[:, None])[:, 0].numpy()
    assert ok2.all()
    other = mt != 4
    assert (fa2[other] == fa[other]).all() and (fb2[other] == fb[other]).all()
    with pytest.raises(ValueError, match="with_second"):
        scanned.device_sample_pairs_mixed(torch.Generator(), scanned.build_sampling_tables(port),
                                          torch.from_numpy(port.poses), 2, probs)
    with pytest.raises(ValueError, match="types"):
        scanned.device_sample_pairs_mixed(torch.Generator(), scanned.build_sampling_tables(port),
                                          torch.from_numpy(port.poses), 2, ((3, 1.0),))
