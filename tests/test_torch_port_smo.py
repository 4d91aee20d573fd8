"""The port's synthetic multi-object samples (type 4) against pdc_tpu, on the
CPU at 64x48:

  * merge_images_with_occlusions given JAX's coin: the composite, the
    merged mask and the validity bit-equal to JAX's; merge_matches equal;
  * the synthetic multi-object sample of each route
    (assemble_synthetic_multi_object_sample and its matrix twin) given
    JAX's draws: the index sets as JAX's (through image b's reprojection,
    at least 99% of the entries equal; uv within 1e-3 px), the images
    equal;
  * mixed batches on both routes with the port's own draws: the invariants
    of tests/test_synthetic_multi_object.py and tests/test_smo_matrix.py
    (match types kept, matches in every non-empty row, no blind set, in
    range), every valid match showing its own object in both composites
    (the front object's pixels kill the matches behind them), the other
    rows exactly those of the batch assembled without compositing, and the
    composited rows exactly the sample function's on those rows; the
    matrix route draws the composites' pools by inverse CDF of the merged
    mask even with permutations in the batch;
  * compose_loss_matrix on indices of JAX's assemble_batch_matrix with a
    composited row: terms rtol 1e-6 / atol 1e-7, gradients relative L2
    1e-5, as the per-pair losses (tests/test_torch_port_per_pair.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.data.assembler import assemble_batch_matrix as jax_assemble_matrix
from pdc_tpu.data.assembler import assemble_synthetic_multi_object_sample as jax_smo
from pdc_tpu.data.assembler import (
    assemble_synthetic_multi_object_sample_matrix as jax_smo_matrix,
)
from pdc_tpu.losses.matrix_loss import compose_loss_matrix as jax_compose_matrix
from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
from pdc_tpu.ops import augmentation as jaug
from pdc_tpu_torch.data import assembler as tasm
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices, compose_loss_matrix
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.ops import augmentation as taug
from pdc_tpu_torch.ops import sampling as tsamp
from tests.test_torch_port_per_pair import (  # noqa: F401 (draws is a fixture)
    GRAD_RL2,
    VAL_ATOL,
    VAL_RTOL,
    _frames_batch,
    _np_tree,
    _rel_l2,
    _stack_draws,
    assert_indices_agree,
    draws,
    jax_smo_draws,
    port_config,
)

torch.set_num_threads(2)

H, W, D = 48, 64, 3
HW = H * W
G = torch.Generator().manual_seed(0)
P1_KEYS = ("rgb_a", "depth_a", "mask_a", "pose_a", "rgb_b", "depth_b", "mask_b", "pose_b", "K")


def _pairs(batch, rows):
    """The two pairs of the given rows as JAX's sample functions take them
    (numpy, one row) and as the port's do (tensors, rows stacked)."""
    p1 = [{k: batch[k][r] for k in P1_KEYS} for r in rows]
    p2 = [{k: batch[k + "_2"][r] for k in P1_KEYS} for r in rows]
    frames = tasm._frames(batch, "cpu")
    second = tasm._frames(batch, "cpu", "_2")
    idx = torch.as_tensor(rows)
    return p1, p2, ({k: v[idx] for k, v in frames.items()},
                    {k: v[idx] for k, v in second.items()})


# -- the composite ---------------------------------------------------------------


def test_merge_with_jax_coin_is_bit_equal(draws):
    batch = _frames_batch(np.zeros(4, np.int32))
    rng = np.random.default_rng(0)
    n = 200
    uv = [np.stack([rng.integers(0, W, (4, n)), rng.integers(0, H, (4, n))], -1)
          for _ in range(2)]
    uvf = [(u + rng.random(u.shape)).astype(np.float32) for u in uv]
    va, vb = rng.random((4, n)) < 0.8, rng.random((4, n)) < 0.8
    keys = [jax.random.PRNGKey(k) for k in range(4)]
    coins = np.stack([np.asarray(jax.random.uniform(k)) for k in keys])
    assert (coins < 0.5).any() and (coins >= 0.5).any()  # both objects in front
    want = [jaug.merge_images_with_occlusions(
        keys[i], batch["rgb_a"][i], batch["rgb_a_2"][i], batch["mask_a"][i],
        batch["mask_a_2"][i], (uv[0][i], uvf[1][i]), (uvf[0][i], uv[1][i]), va[i], vb[i])
        for i in range(4)]
    draws([("uniform", coins)])
    t = torch.as_tensor
    merged, mask, (pa, got_va), (pb, got_vb) = taug.merge_images_with_occlusions(
        t(batch["rgb_a"]), t(batch["rgb_a_2"]), t(batch["mask_a"]), t(batch["mask_a_2"]),
        (t(uv[0]), t(uvf[1])), (t(uvf[0]), t(uv[1])), t(va), t(vb), G)
    assert merged.dtype == torch.uint8 and mask.dtype == torch.int32
    for i, (jm, jmask, (_, jva), (_, jvb)) in enumerate(want):
        np.testing.assert_array_equal(merged[i].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(got_va[i].numpy(), np.asarray(jva))
        np.testing.assert_array_equal(got_vb[i].numpy(), np.asarray(jvb))
    assert (got_va != t(va)).any() or (got_vb != t(vb)).any()  # something was occluded
    assert pa[0] is not None and torch.equal(pa[0], t(uv[0]))
    # merge_matches
    juv, jv = jaug.merge_matches(uv[0][0], va[0], uvf[1][0], vb[0])
    tuv, tv = taug.merge_matches(t(uv[0]), t(va), t(uvf[1]), t(vb))
    np.testing.assert_array_equal(tuv[0].numpy(), np.asarray(juv))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))


# -- the synthetic multi-object sample of each route, given JAX's draws -----------------

SMO_CFG = JaxAssemblerConfig(num_matching_attempts=300, num_masked_non_matches_per_match=6,
                             num_background_non_matches_per_match=5, num_blind_samples=40,
                             masked_pool_size=64, background_pool_size=80,
                             enable_synthetic_multi_object=True)


@pytest.mark.parametrize("matrix,inverse_background", [
    (False, True), (False, False), (True, True)], ids=["per_pair", "per_pair_uniform_bg",
                                                      "matrix"])
def test_smo_sample_with_jax_draws(draws, matrix, inverse_background):
    cfg = dataclasses.replace(SMO_CFG, use_image_b_mask_inv=inverse_background,
                              use_matrix_loss=matrix)
    batch = _frames_batch(np.full(3, 4, np.int32))
    rows = [0, 1, 2]
    p1, p2, (t1, t2) = _pairs(batch, rows)
    keys = [jax.random.PRNGKey(20 + r) for r in rows]
    fn = jax.jit(jax_smo_matrix if matrix else jax_smo, static_argnums=3)
    want = [jax.tree_util.tree_map(np.asarray, fn(keys[i], p1[i], p2[i], cfg)) for i in rows]
    d = draws(_stack_draws([jax_smo_draws(k, cfg, matrix) for k in keys]))
    port_fn = (tasm.assemble_synthetic_multi_object_sample_matrix if matrix
               else tasm.assemble_synthetic_multi_object_sample)
    img_1, img_2, s = port_fn(t1, t2, port_config(cfg), G)
    assert not d.given
    stacked = type(want[0][2])(*[np.stack(x) for x in zip(*[w[2] for w in want])])
    for img, j in ((img_1, 0), (img_2, 1)):
        np.testing.assert_allclose(img.numpy(), np.stack([w[j] for w in want]), rtol=1e-6,
                                   atol=1e-6)
    assert_indices_agree(s, stacked, exact=("matches_a", "masked_nm_a", "background_nm_a",
                                            "blind_nm_a", "blind_nm_b", "blind_nm_valid",
                                            "match_type"))
    assert s.matches_valid.any(1).all() and not s.blind_nm_valid.any()
    assert (s.match_type == 4).all()


# -- mixed batches with the port's own draws ----------------------------------------------


@pytest.fixture(scope="module")
def mixed_batch():
    ds = SpartanDataset.make_synthetic(num_scenes=4, num_objects=2, width=W, height=H,
                                       num_frames=6)
    ds._data_type_probabilities = {0: 0.3, 1: 0.1, 2: 0.2, 4: 0.4}
    ds.reset_seed(3)
    batch = ds.make_host_batch(8)
    assert (batch["match_type"] == 4).sum() >= 2 and (batch["match_type"] != 4).sum() >= 2
    return batch


def _front_mask(img, p1, p2, view, j, cfg):
    """The mask of the object in front in composite ``img`` of row ``j``:
    the composite is ``where(front mask, front, back)``, so it equals
    exactly one of the two orders (their backgrounds differ)."""
    norm = [tasm._normalize(p["rgb_" + view][j], cfg) for p in (p1, p2)]
    masks = [p["mask_" + view][j] != 0 for p in (p1, p2)]
    first = torch.equal(img, torch.where(masks[0][..., None], norm[0], norm[1]))
    second = torch.equal(img, torch.where(masks[1][..., None], norm[1], norm[0]))
    assert first != second
    return masks[0] if first else masks[1], first


def _uncovered(front, uv):
    """Whether the truncated pixels ``uv [N, 2]`` lie off ``front``."""
    return ~front[uv[:, 1].to(torch.int64), uv[:, 0].to(torch.int64)]


@pytest.mark.parametrize("matrix,with_perm", [(False, False), (True, False), (True, True)],
                         ids=["per_pair", "matrix", "matrix_with_permutations"])
def test_mixed_batch_structure(mixed_batch, matrix, with_perm):
    batch = dict(mixed_batch)
    if with_perm:
        for s in "ab":
            perm, count = tsamp.build_pixel_perm(torch.as_tensor(batch["mask_" + s]))
            batch["perm_" + s], batch["count_" + s] = perm.numpy(), count.numpy()
    cfg = tasm.AssemblerConfig(num_matching_attempts=200, num_masked_non_matches_per_match=4,
                               num_background_non_matches_per_match=3, num_blind_samples=50,
                               masked_pool_size=48, background_pool_size=40,
                               enable_synthetic_multi_object=True, use_matrix_loss=matrix)
    assemble = tasm.assemble_batch_matrix if matrix else tasm.assemble_batch
    smo_fn = (tasm.assemble_synthetic_multi_object_sample_matrix if matrix
              else tasm.assemble_synthetic_multi_object_sample)
    img_a, img_b, s = assemble(batch, cfg, torch.Generator().manual_seed(9), "cpu")
    types = batch["match_type"]
    np.testing.assert_array_equal(s.match_type.numpy(), types)
    has_matches = s.matches_valid.any(1).numpy()
    assert has_matches[(types == 0) | (types == 4)].all() and not has_matches[types == 2].any()
    smo = types == 4
    assert not s.blind_nm_valid.numpy()[smo].any() and s.blind_nm_valid.numpy()[types == 2].all()
    for x in s:
        if x.dtype == torch.int64 and x.dim() == 2:
            assert int(x.min()) >= 0 and int(x.max()) < HW
    rows = np.flatnonzero(smo).tolist()
    _, _, (p1, p2) = _pairs(batch, rows)
    half = cfg.num_matching_attempts // 2
    uv_2 = (s.matches_uv_b if matrix else torch.stack(
        [s.matches_b % W, s.matches_b // W], -1))
    uv_1 = torch.stack([s.matches_a % W, s.matches_a // W], -1)
    killed = 0
    for j, r in enumerate(rows):  # a valid match of the object behind is not covered
        valid = s.matches_valid[r]
        for img, view, uv in ((img_a, "a", uv_1), (img_b, "b", uv_2)):
            front, first_in_front = _front_mask(img[r], p1, p2, view, j, cfg)
            behind = slice(half, None) if first_in_front else slice(0, half)
            open_ = _uncovered(front, uv[r, behind])
            assert not (valid[behind] & ~open_).any()
            killed += int((~open_).sum())
    assert killed > 0
    # the other rows are the batch assembled without compositing, and the
    # composited rows the sample function's on the generator that follows
    g = torch.Generator().manual_seed(9)
    base = assemble(batch, dataclasses.replace(cfg, enable_synthetic_multi_object=False), g,
                    "cpu")
    smo_out = smo_fn(p1, p2, cfg, g)
    keep = torch.as_tensor(~smo)
    for got, want_base, want_smo in zip((img_a, img_b) + tuple(s),
                                        base[:2] + tuple(base[2]),
                                        smo_out[:2] + tuple(smo_out[2])):
        assert torch.equal(got[keep], want_base[keep])
        if got is not s.match_type:
            assert torch.equal(got[torch.as_tensor(smo)], want_smo.to(got.dtype))
    if matrix:  # the pools over the merged mask of view 2 and its complement
        merged = (p1["mask_b"] != 0) | (p2["mask_b"] != 0)
        on = torch.gather(merged.reshape(len(rows), -1), 1, s.masked_pool_b[smo])
        off = torch.gather(merged.reshape(len(rows), -1), 1, s.background_pool_b[smo])
        assert on.all() and not off.any()


# -- compose_loss_matrix on a composited row of JAX's assembly ----------------------------


def test_compose_loss_matrix_on_jax_smo_indices():
    types = np.array([0, 4, 2, 4], np.int32)
    batch = _frames_batch(types)
    cfg = dataclasses.replace(SMO_CFG, use_matrix_loss=True)
    _, _, idx = jax_assemble_matrix(jax.random.PRNGKey(2), batch, cfg)
    idx = _np_tree(idx)
    assert not idx.blind_nm_valid[1].any() and idx.matches_valid[1].any()
    rng = np.random.default_rng(5)
    pa = (rng.standard_normal((4, HW, D)) * 0.3).astype(np.float32)
    pb = (rng.standard_normal((4, HW, D)) * 0.3).astype(np.float32)
    w = rng.random(4).astype(np.float32)

    def jax_terms(a, b):
        return jax.vmap(lambda x, y, r: jax_compose_matrix(x, y, r, JaxLossConfig(), W))(
            a, b, idx)

    want, (ga, gb) = jax.jit(lambda a, b: (jax_terms(a, b), jax.grad(
        lambda a, b: jnp.sum(jax_terms(a, b).loss * w), argnums=(0, 1))(a, b)))(pa, pb)
    ta = torch.tensor(pa, requires_grad=True)
    tb = torch.tensor(pb, requires_grad=True)
    got = compose_loss_matrix(ta, tb, MatrixSampleIndices(
        *[torch.as_tensor(np.array(x)) for x in idx]), LossConfig(), W)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=VAL_RTOL,
                                   atol=VAL_ATOL, err_msg=name)
    (got.loss * torch.as_tensor(w)).sum().backward()
    assert _rel_l2(ta.grad.numpy(), ga) <= GRAD_RL2 and _rel_l2(tb.grad.numpy(), gb) <= GRAD_RL2
