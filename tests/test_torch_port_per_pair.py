"""The port's per-pair loss route (use_matrix_loss: false) against pdc_tpu,
on the CPU at 64x48, D=3, ResNet-18-8s:

  * every per-pair loss function of pdc_tpu_torch.losses.pixelwise_contrastive
    against its JAX function (vmapped over the batch) on the same numpy
    predictions and indices, with an all-invalid row in every case: values
    rtol 1e-6 / atol 1e-7, gradients with respect to both predictions
    within relative L2 1e-5 (the same float32 operations, summed in
    another order; the JAX gather's backward is take_rows' one-hot
    matmuls, the port's index_select's index_add);
  * compose_loss for the match types 0-4 and -1 in one batch, under both
    hard-negative scale switches and both l2-pixel switches, on
    SampleIndices that JAX's assemble_batch made: the same bars;
  * create_non_correspondences fed JAX's uniform, randint and normal draws
    through pdc_tpu_torch.ops.sampling (a randint pick as (pick + 0.5) /
    pool_size): within 1e-4 px; and by distribution over an object mask
    with the port's own generator;
  * assemble_batch fed JAX's draws: the same index sets (uv_b within
    1e-3 px, flat image-b indices and validity agreeing on at least 99%,
    as tests/test_torch_port_correspondence.py holds the matrix route);
  * one per-pair train step against JAX's, at the bar of
    tests/test_torch_port_train.py::test_one_step_matches_jax (ROADMAP F3);
  * DenseCorrespondenceTraining takes the route the JAX package takes;
  * DCE.compute_loss_on_dataset on the same assembled batches: within 1e-5.
"""

import copy
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pdc_tpu.losses.pixelwise_contrastive as jloss
from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.data.assembler import assemble_batch as jax_assemble
from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset
from pdc_tpu.data.synthetic import SyntheticScene as JaxSyntheticScene
from pdc_tpu.evaluation.evaluate import DenseCorrespondenceEvaluation as JaxDCE
from pdc_tpu.losses.composer import compose_loss as jax_compose
from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu.models.dcn import build_backbone as jax_build_backbone
from pdc_tpu.models.resnet import ResNetFCN as JaxResNetFCN
from pdc_tpu.ops import correspondence as jcorr
from pdc_tpu.ops import sampling as jsamp
from pdc_tpu.training.train import build_loss_fn as jax_build_loss_fn
from pdc_tpu.training.train import make_optimizer as jax_make_optimizer
from pdc_tpu_torch import losses as tlosses
from pdc_tpu_torch.data import assembler as tasm
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation as DCE
from pdc_tpu_torch.losses import pixelwise_contrastive as tloss
from pdc_tpu_torch.losses.composer import SampleIndices, compose_loss
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.models.resnet import ResNetFCN, init_weights_
from pdc_tpu_torch.ops import correspondence as tcorr
from pdc_tpu_torch.ops import sampling as tsamp
from pdc_tpu_torch.training import train as port_train

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """The trainer's runs write model folders (checkpoints and Adam states): remove them when the
    test ends, so that a whole run leaves no large files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


H, W, D = 48, 64, 3
HW = H * W
R18 = (2, 2, 2, 2)
LR = 1e-4
TC = {"training": {"learning_rate": LR, "learning_rate_decay": 0.9,
                   "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}
VAL_RTOL, VAL_ATOL, GRAD_RL2 = 1e-6, 1e-7, 1e-5


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _rel_l2(got, want):
    num = float(np.sqrt(np.sum((np.asarray(got, np.float64) - np.asarray(want, np.float64)) ** 2)))
    den = float(np.sqrt(np.sum(np.asarray(want, np.float64) ** 2)))
    return num / den if den else num


class Draws:
    """Stand-in for ``sampling.uniform`` and ``sampling.normal``: hands out
    the given ``(kind, array)`` pairs in call order, checking the kind and
    the shape."""

    def __init__(self, given):
        self.given = list(given)

    def take(self, kind, shape, dtype, device):
        assert self.given, f"no draw left for a {kind} of shape {tuple(shape)}"
        want_kind, u = self.given.pop(0)
        u = np.asarray(u)
        assert (want_kind, u.shape) == (kind, tuple(shape)), (want_kind, u.shape, kind, shape)
        return torch.as_tensor(np.array(u), dtype=dtype, device=device)

    def uniform(self, shape, generator, device=None, dtype=torch.float32):
        return self.take("uniform", shape, dtype, device)

    def normal(self, shape, generator, device=None, dtype=torch.float32):
        return self.take("normal", shape, dtype, device)


@pytest.fixture
def draws(monkeypatch):
    def install(given):
        d = Draws(given)
        monkeypatch.setattr(tsamp, "uniform", d.uniform)
        monkeypatch.setattr(tsamp, "normal", d.normal)
        return d
    return install


G = torch.Generator().manual_seed(0)


# -- the loss functions ----------------------------------------------------------------

B_L, N_L = 3, 500


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(0)
    pa = (rng.standard_normal((B_L, HW, D)) * 0.3).astype(np.float32)
    pb = (rng.standard_normal((B_L, HW, D)) * 0.3).astype(np.float32)
    ix = {k: rng.integers(0, HW, (B_L, N_L)).astype(np.int32) for k in ("a", "b", "gt", "a2")}
    ix["gt"][:, :50] = ix["b"][:, :50]  # non-matches on their ground truth: l2 weight 0
    valid = rng.random((B_L, N_L)) < 0.7
    valid[2] = False  # an all-invalid row
    valid2 = rng.random((B_L, N_L)) < 0.5
    valid2[2] = False
    return pa, pb, ix, valid, valid2


# name -> f(losses module, pa, pb, idx a, idx b, idx gt, idx a2, valid, valid2): a tuple
# whose first entry is differentiated (None: no predictions)
LOSS_CASES = {
    "match_loss": (lambda m, pa, pb, a, b, gt, a2, v, v2: m.match_loss(pa, pb, a, b, v), True),
    "non_match_descriptor_loss": (lambda m, pa, pb, a, b, gt, a2, v, v2:
                                  m.non_match_descriptor_loss(pa, pb, a, b, v, M=0.5), True),
    "non_match_descriptor_loss_invert": (
        lambda m, pa, pb, a, b, gt, a2, v, v2:
        m.non_match_descriptor_loss(pa, pb, a, b, v, M=0.4, invert=True), True),
    "non_match_loss_descriptor_only": (
        lambda m, pa, pb, a, b, gt, a2, v, v2:
        m.non_match_loss_descriptor_only(pa, pb, a, b, v, M=0.6), True),
    "non_match_loss_descriptor_only_invert": (
        lambda m, pa, pb, a, b, gt, a2, v, v2:
        m.non_match_loss_descriptor_only(pa, pb, a, b, v, M=0.5, invert=True), True),
    "l2_pixel_loss": (lambda m, pa, pb, a, b, gt, a2, v, v2:
                      (m.l2_pixel_loss(gt, b, v, W, M_pixel=20.0),), False),
    "non_match_loss_with_l2_pixel_norm": (
        lambda m, pa, pb, a, b, gt, a2, v, v2:
        m.non_match_loss_with_l2_pixel_norm(pa, pb, gt, a, b, v, W, M_descriptor=0.6,
                                            M_pixel=20.0), True),
    "triplet_loss": (lambda m, pa, pb, a, b, gt, a2, v, v2:
                     (m.triplet_loss(pa, pb, a, gt, b, v, alpha=0.1),), True),
    "get_loss_original": (lambda m, pa, pb, a, b, gt, a2, v, v2:
                          m.get_loss_original(pa, pb, a, gt, a2, b, v, v2, M_margin=0.5,
                                              non_match_loss_weight=0.7), True),
    "get_loss_original_all_valid": (lambda m, pa, pb, a, b, gt, a2, v, v2:
                                    m.get_loss_original(pa, pb, a, gt, a2, b), True),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_function_matches_jax(loss_inputs, name):
    fn, differentiable = LOSS_CASES[name]
    pa, pb, ix, valid, valid2 = loss_inputs
    args = (ix["a"], ix["b"], ix["gt"], ix["a2"], valid, valid2)
    rng = np.random.default_rng(1)

    def jax_fn(a, b):
        return jax.vmap(lambda x, y, *r: fn(jloss, x, y, *r))(a, b, *args)

    want = jax_fn(pa, pb)
    w = rng.random(np.shape(want[0])).astype(np.float32)
    ta = torch.tensor(pa, requires_grad=True)
    tb = torch.tensor(pb, requires_grad=True)
    got = fn(tloss, ta, tb, *[torch.as_tensor(x) for x in args])
    assert len(got) == len(want)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(j), rtol=VAL_RTOL,
                                   atol=VAL_ATOL, err_msg=name)
    assert float(got[0].detach()[2].abs().sum()) == 0.0 or name == "get_loss_original_all_valid"
    if not differentiable:
        return
    ga, gb = jax.grad(lambda a, b: jnp.sum(jax_fn(a, b)[0] * w), argnums=(0, 1))(pa, pb)
    (got[0] * torch.as_tensor(w)).sum().backward()
    assert _rel_l2(ta.grad.numpy(), ga) <= GRAD_RL2 and _rel_l2(tb.grad.numpy(), gb) <= GRAD_RL2
    assert float(np.abs(ga).max()) > 0


def test_package_exports_the_jax_package_names():
    import pdc_tpu.losses as jl

    names = [n for n in dir(jl) if not n.startswith("_") and n.isidentifier()
             and n not in ("composer", "pixelwise_contrastive", "matrix_loss")]
    assert names and all(hasattr(tlosses, n) for n in names), names


# -- compose_loss on JAX-assembled indices ---------------------------------------------

# within, multi-object, across-scene, different-object, synthetic multi-object, empty
MATCH_TYPES = np.array([0, 3, 1, 2, 4, -1], np.int32)
JAX_CFG = JaxAssemblerConfig(num_matching_attempts=300, num_masked_non_matches_per_match=6,
                             num_background_non_matches_per_match=5, num_blind_samples=120,
                             domain_randomize=False, enable_synthetic_multi_object=True,
                             use_matrix_loss=False)


def _frames_batch(match_types):
    """A batch of pairs of one 64x48 scene with the given types, the second
    pairs (``*_2``) from another scene, as numpy arrays."""
    s1 = JaxSyntheticScene(width=W, height=H, num_frames=6)
    s2 = JaxSyntheticScene(width=W, height=H, num_frames=6, seed=5)
    B = len(match_types)
    batch = {"match_type": np.asarray(match_types, np.int32)}
    for scene, sfx in ((s1, ""), (s2, "_2")):
        rgb, depth, mask, poses = scene.render_all()
        ia, ib = np.arange(B) % 6, (np.arange(B) + 2) % 6
        batch.update({"rgb_a" + sfx: rgb[ia], "depth_a" + sfx: depth[ia],
                      "mask_a" + sfx: mask[ia], "pose_a" + sfx: poses[ia].astype(np.float32),
                      "rgb_b" + sfx: rgb[ib], "depth_b" + sfx: depth[ib],
                      "mask_b" + sfx: mask[ib], "pose_b" + sfx: poses[ib].astype(np.float32),
                      "K" + sfx: np.stack([scene.K] * B).astype(np.float32)})
    return batch


@pytest.fixture(scope="module")
def jax_assembled():
    batch = _frames_batch(MATCH_TYPES)
    img_a, img_b, idx = jax_assemble(jax.random.PRNGKey(0), batch, JAX_CFG)
    return batch, np.asarray(img_a), np.asarray(img_b), _np_tree(idx)


def _to_port(idx):
    return SampleIndices(*[torch.as_tensor(np.array(x)) for x in idx])


@pytest.mark.parametrize("overrides", [
    {},
    {"scale_by_hard_negatives": False},
    {"scale_by_hard_negatives_DIFFERENT_OBJECT": False},
    {"use_l2_pixel_loss_on_masked_non_matches": True, "M_pixel": 20.0},
    {"use_l2_pixel_loss_on_background_non_matches": True, "M_background": 0.8},
], ids=["default", "no_hard_scaling", "no_hard_scaling_different_object", "pixel_masked",
        "pixel_background"])
def test_compose_loss_matches_jax_for_every_type(jax_assembled, overrides):
    _, _, _, idx = jax_assembled
    jcfg = dataclasses.replace(JaxLossConfig(), **overrides)
    cfg = dataclasses.replace(LossConfig(), **overrides)
    rng = np.random.default_rng(3)
    B = len(MATCH_TYPES)
    pa = (rng.standard_normal((B, HW, D)) * 0.3).astype(np.float32)
    pb = (rng.standard_normal((B, HW, D)) * 0.3).astype(np.float32)
    w = rng.random(B).astype(np.float32)

    def jax_terms(a, b):
        return jax.vmap(lambda x, y, s: jax_compose(x, y, s, jcfg, W))(a, b, idx)

    want, (ga, gb) = jax.jit(lambda a, b: (jax_terms(a, b), jax.grad(
        lambda a, b: jnp.sum(jax_terms(a, b).loss * w), argnums=(0, 1))(a, b)))(pa, pb)
    ta = torch.tensor(pa, requires_grad=True)
    tb = torch.tensor(pb, requires_grad=True)
    got = compose_loss(ta, tb, _to_port(idx), cfg, W)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=VAL_RTOL,
                                   atol=VAL_ATOL, err_msg=name)
    (got.loss * torch.as_tensor(w)).sum().backward()
    assert _rel_l2(ta.grad.numpy(), ga) <= GRAD_RL2 and _rel_l2(tb.grad.numpy(), gb) <= GRAD_RL2
    loss = got.loss.detach().numpy()
    assert loss[-1] == 0.0 and (loss[:-1] > 0).all()  # the empty pair gives zero


# -- create_non_correspondences ----------------------------------------------------------


def _jax_non_match_draws(key, total, n, m, masked, pool_size=None):
    """The draws of JAX's create_non_correspondences from ``key``, in the
    port's order, a randint pick fed as (pick + 0.5) / pool_size."""
    k_pool, k_cand, k_fallback, k_flip, k_noise = jax.random.split(key, 5)
    out = []
    if masked:
        out.append(("uniform", jax.random.uniform(k_pool, (pool_size,))))
        if pool_size != total:
            pick = jax.random.randint(k_cand, (total,), 0, pool_size)
            out.append(("uniform", (np.asarray(pick) + 0.5) / pool_size))
        out.append(("uniform", jax.random.uniform(k_fallback, (total, 2))))
    else:
        out.append(("uniform", jax.random.uniform(k_cand, (total, 2))))
    out.append(("uniform", jax.random.uniform(k_flip, (n, m))))
    out.append(("normal", jax.random.normal(k_noise, (n, m))))
    return [(k, np.asarray(u)) for k, u in out]


def _stack_draws(rows):
    return [(k, np.stack([r[i][1] for r in rows])) for i, (k, _) in enumerate(rows[0])]


@pytest.mark.parametrize("n,m", [(200, 50), (40, 20)], ids=["pooled", "pool_is_all"])
def test_create_non_correspondences_with_jax_draws(draws, n, m):
    """Masked rows (an object mask and an empty mask, which falls back to
    uniform pixels) in one batched call, and the unmasked route; matches at
    random subpixel positions and on a few candidates' own pixels."""
    scene = JaxSyntheticScene(width=W, height=H, num_frames=2)
    mask = scene.render_all()[2][0]
    rng = np.random.default_rng(n)
    uv = np.stack([rng.uniform(0, W - 1, (2, n)), rng.uniform(0, H - 1, (2, n))],
                  -1).astype(np.float32)
    masks = np.stack([mask, np.zeros_like(mask)])
    total = n * m
    pool = min(total, 8192)
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    want = np.stack([np.asarray(jcorr.create_non_correspondences(
        keys[i], uv[i], (H, W), num_non_matches_per_match=m, mask_b=masks[i]))
        for i in range(2)])
    draws(_stack_draws([_jax_non_match_draws(k, total, n, m, True, pool) for k in keys]))
    got = tcorr.create_non_correspondences(torch.as_tensor(uv), (H, W), G,
                                           num_non_matches_per_match=m,
                                           mask_b=torch.as_tensor(masks))
    assert got.shape == (2, n, m, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    on = mask.reshape(-1) != 0
    whole = got[0].reshape(-1, 2).numpy()
    kept = (whole == np.floor(whole)).all(-1)
    assert on[(whole[kept, 1] * W + whole[kept, 0]).astype(int)].all()
    # unmasked
    key = jax.random.PRNGKey(3)
    want = np.asarray(jcorr.create_non_correspondences(key, uv[0], (H, W),
                                                       num_non_matches_per_match=m))
    draws(_jax_non_match_draws(key, total, n, m, False))
    got = tcorr.create_non_correspondences(torch.as_tensor(uv[0]), (H, W), G,
                                           num_non_matches_per_match=m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_create_non_correspondences_distribution_over_a_mask():
    """The port's own draws: the candidates that no match displaced are
    object pixels spread over the whole mask; the displaced ones moved off
    the integer grid and stay in the image."""
    scene = JaxSyntheticScene(width=W, height=H, num_frames=2)
    mask = scene.render_all()[2][1]
    on = mask.reshape(-1) != 0
    rng = np.random.default_rng(4)
    uv = np.stack([rng.integers(0, W, 300), rng.integers(0, H, 300)], -1).astype(np.float32)
    got = tcorr.create_non_correspondences(torch.as_tensor(uv), (H, W),
                                           torch.Generator().manual_seed(2),
                                           num_non_matches_per_match=100,
                                           mask_b=torch.as_tensor(mask)).numpy()
    flat = got.reshape(-1, 2)
    kept = (flat == np.floor(flat)).all(-1)
    assert (flat >= 0).all() and (flat[:, 0] <= W - 1).all() and (flat[:, 1] <= H - 1).all()
    pix = (flat[kept, 1] * W + flat[kept, 0]).astype(int)
    assert on[pix].all()
    counts = np.bincount(pix, minlength=HW)[on]
    assert (counts > 0).mean() > 0.9  # a pool of 8192 covers the object's pixels
    # a candidate within 1 px of its match (in u or v) was displaced off the
    # integer grid; the displaced ones are the few that collided
    too_close = ((np.abs(uv[:, None, :] - got) < 1.0).any(-1)).reshape(-1)
    assert not too_close[kept].any() and 0.01 < (~kept).mean() < 0.2


# -- assemble_batch with JAX's draws ----------------------------------------------------


def _jax_per_pair_draws(key, cfg):
    """The draws of JAX's assemble_sample from ``key`` (domain
    randomisation off), in the port's order."""
    keys = jax.random.split(key, 10)
    N = cfg.num_matching_attempts
    out = [("uniform", jax.random.uniform(jax.random.split(keys[0])[0], (N,))),
           ("uniform", jax.random.uniform(keys[3])), ("uniform", jax.random.uniform(keys[4]))]
    for k, M in ((keys[5], cfg.num_masked_non_matches_per_match),
                 (keys[6], cfg.num_background_non_matches_per_match)):
        out += _jax_non_match_draws(k, N * M, N, M, True, min(N * M, 8192))
    k_a, k_b = jax.random.split(keys[7])
    nbl = cfg.num_blind_samples
    out += [("uniform", jax.random.uniform(k, (nbl,))) for k in (k_a, k_b, keys[8], keys[9])]
    return [(k, np.asarray(u)) for k, u in out]


def jax_smo_draws(key, cfg, matrix: bool):
    """The draws of JAX's assemble_synthetic_multi_object_sample(_matrix)
    from ``key``, in the port's order: the two pairs' correspondences, the
    two composites' coins, then the non-matches (per-pair) or the pools
    (matrix)."""
    keys = jax.random.split(key, 8)
    half = cfg.num_matching_attempts // 2
    out = [("uniform", jax.random.uniform(jax.random.split(keys[i])[0], (half,)))
           for i in (0, 1)]
    out += [("uniform", jax.random.uniform(keys[i])) for i in (2, 3)]
    if matrix:
        out += [("uniform", jax.random.uniform(keys[4], (cfg.masked_pool_size,))),
                ("uniform", jax.random.uniform(keys[5], (cfg.background_pool_size,)))]
    else:
        N = 2 * half
        for k, M, masked in ((keys[4], cfg.num_masked_non_matches_per_match, True),
                             (keys[5], cfg.num_background_non_matches_per_match,
                              cfg.use_image_b_mask_inv)):
            out += _jax_non_match_draws(k, N * M, N, M, masked, min(N * M, 8192))
    return [(k, np.asarray(u)) for k, u in out]


def port_config(jax_cfg):
    return tasm.AssemblerConfig(**{f.name: getattr(jax_cfg, f.name)
                                   for f in dataclasses.fields(jax_cfg)})


def assert_indices_agree(got_indices, want_indices, exact=()):
    """Index sets field by field: ``exact`` ones equal, the rest (through
    image b's reprojection, where a pixel at a boundary may differ) equal
    on at least 99% of their entries, subpixel positions within 1e-3 px."""
    for name in got_indices._fields:
        got, want = getattr(got_indices, name).numpy(), np.asarray(getattr(want_indices, name))
        assert got.shape == want.shape, name
        if name in exact:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            same = np.abs(got - want) <= 1e-3 if got.dtype.kind == "f" else got == want
            assert np.mean(same) >= 0.99, (name, np.mean(same))


def test_assemble_batch_with_jax_draws(draws, jax_assembled):
    """Every type in one batch, the synthetic multi-object row composited
    after the other rows' stages, as JAX's assemble_batch gives them."""
    batch, _, jimg_b, jidx = jax_assembled
    keys = jax.random.split(jax.random.PRNGKey(0), len(MATCH_TYPES))
    given = _stack_draws([_jax_per_pair_draws(k, JAX_CFG) for k in keys])
    given += _stack_draws([jax_smo_draws(keys[4], JAX_CFG, matrix=False)])
    d = draws(given)
    img_a, img_b, s = tasm.assemble_batch(batch, port_config(JAX_CFG), G, device="cpu")
    assert not d.given
    np.testing.assert_allclose(img_b.numpy(), jimg_b, rtol=1e-6, atol=1e-6)
    assert s.match_type.tolist() == MATCH_TYPES.tolist()
    assert_indices_agree(s, jidx, exact=("matches_a", "masked_nm_a", "background_nm_a",
                                         "match_type"))
    Mm = JAX_CFG.num_masked_non_matches_per_match
    Mb = JAX_CFG.num_background_non_matches_per_match
    v = s.matches_valid.numpy()
    assert v[[0, 1, 4]].mean(1).min() > 0.3 and not v[[2, 3, 5]].any()
    np.testing.assert_array_equal(s.masked_nm_a.numpy(), np.repeat(s.matches_a.numpy(), Mm, -1))
    np.testing.assert_array_equal(s.background_nm_gt_b.numpy(),
                                  np.repeat(s.matches_b.numpy(), Mb, -1))
    bv = s.blind_nm_valid.numpy()
    assert bv[[0, 1, 2, 3]].all() and not bv[[4, 5]].any()


# -- one per-pair train step -----------------------------------------------------------


def _state_dict(params, batch_stats):
    return flax_to_state_dict({"params": _np_tree(params), "batch_stats": _np_tree(batch_stats)})


# the hard-negative counts that each metric's normalisation reads
COUNTS_OF = {"loss": ("masked", "background", "blind"), "match_loss": (),
             "masked_non_match_loss": ("masked",), "background_non_match_loss": ("background",),
             "blind_non_match_loss": ("blind",), "num_valid_matches": ()}


def _hard_counts(pred, s: SampleIndices):
    """Per pair, the hard negatives of train-mode predictions ``[2B, HW, D]``
    (a then b) at the default margins: masked, background, and the blind
    set at 0.5 and inverted."""
    p = torch.as_tensor(np.array(pred))
    B = p.shape[0] // 2
    a, b = p[:B], p[B:]

    def hard(nm_a, nm_b, valid, invert=False):
        return tloss.non_match_descriptor_loss(a, b, nm_a, nm_b, valid, M=0.5, invert=invert)[1]

    return {"masked": hard(s.masked_nm_a, s.masked_nm_b, s.masked_nm_valid),
            "background": hard(s.background_nm_a, s.background_nm_b, s.background_nm_valid),
            "blind": torch.stack([hard(s.blind_nm_a, s.blind_nm_b, s.blind_nm_valid, inv)
                                  for inv in (False, True)])}


def test_one_per_pair_step_matches_jax(jax_assembled):
    """At the bar of test_one_step_matches_jax (ROADMAP F3): metrics rtol
    1e-4, gradients relative L2 1e-2 over all leaves, parameters after
    Adam's first step within 2 lr and 99.9% of the significant ones within
    1e-2 lr, BatchNorm statistics atol 1e-5.

    The two forwards agree to rounding (F3). Where that moves one non-match
    across the margin, a hard-negative count differs by one, and each
    metric normalised by it jumps by about 1/count (a SMO row of 48 hard
    negatives: 2%). So every metric is held to JAX's composer on the port's
    own train-mode predictions (rtol 1e-5), and to JAX's step at rtol 1e-4
    wherever the counts it reads agree between the two forwards; a count
    may differ by at most one pair."""
    _, img_a, img_b, idx = jax_assembled
    jm = JaxResNetFCN(num_classes=D, stage_sizes=R18)
    # seeded weights of the port's initialiser, carried to flax (no flax init to compile)
    variables = state_dict_to_flax(init_weights_(ResNetFCN(D, stage_sizes=R18),
                                                 torch.Generator().manual_seed(1)).state_dict())
    loss_fn = jax_build_loss_fn(jm, JaxLossConfig(), W, jax_compose)
    (_, (stats, jmetrics)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], img_a, img_b, idx)
    imgs = np.concatenate([img_a, img_b])
    jpred = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0])(
        variables, imgs)).reshape(len(imgs), HW, D)
    tx = jax_make_optimizer(TC)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    jgrads = _state_dict(grads, variables["batch_stats"])
    after_j = _state_dict(optax.apply_updates(variables["params"], updates), stats)

    port = ResNetFCN(D, stage_sizes=R18)
    port.load_state_dict(_state_dict(variables["params"], variables["batch_stats"]))
    twin = copy.deepcopy(port).train()
    with torch.no_grad():
        pred = twin(torch.as_tensor(imgs).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    pred = pred.reshape(len(imgs), HW, D).numpy()
    state = port_train.create_train_state(port, TC, device="cpu")
    step = port_train.make_train_step(TC, LossConfig(),
                                      tasm.AssemblerConfig(use_matrix_loss=False), W)
    assert step.assemble_fn is tasm.assemble_batch
    s = _to_port(idx)
    metrics = step.update(state, torch.as_tensor(img_a), torch.as_tensor(img_b), s)
    assert state.step == 1 and set(metrics) == set(jmetrics) == set(COUNTS_OF)

    B = len(img_a)
    t = jax.jit(jax.vmap(lambda x, y, r: jax_compose(x, y, r, JaxLossConfig(), W)))(
        pred[:B], pred[B:], idx)
    non_empty = (np.asarray(idx.match_type) >= 0).astype(np.float32)
    own = {k: float(np.sum(np.asarray(getattr(t, k)) * non_empty) / non_empty.sum())
           for k in COUNTS_OF if k != "num_valid_matches"}
    own["num_valid_matches"] = float(np.sum(idx.matches_valid) / non_empty.sum())
    counts_j, counts_p = _hard_counts(jpred, s), _hard_counts(pred, s)
    for c in counts_j:
        assert int((counts_j[c] - counts_p[c]).abs().max()) <= 1, c
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), own[k], rtol=1e-5, err_msg=k)
        if all(torch.equal(counts_j[c], counts_p[c]) for c in COUNTS_OF[k]):
            np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4, err_msg=k)

    num = den = 0.0
    close = total = 0
    after = state.module.state_dict()
    for name, p in state.module.named_parameters():
        g = jgrads[name].numpy()
        num += float(((p.grad.numpy() - g) ** 2).sum())
        den += float((g ** 2).sum())
        d = np.abs(after[name].numpy() - after_j[name].numpy())
        assert d.max() <= 2 * LR * (1 + 1e-3), name
        sig = np.abs(g) > 1e-3 * np.abs(g).max()
        close += int((d[sig] <= 1e-2 * LR).sum())
        total += int(sig.sum())
    assert (num / den) ** 0.5 <= 1e-2
    assert close >= 0.999 * total
    for name, buf in after.items():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), after_j[name].numpy(), atol=1e-5,
                                       err_msg=name)


# -- the driver's route -------------------------------------------------------------------

SYNTH = dict(num_scenes=2, num_objects=2, width=W, height=H, num_frames=4, object_radius=0.3)
SHOES_MIX = {"SINGLE_OBJECT_WITHIN_SCENE": 0.33, "SINGLE_OBJECT_ACROSS_SCENE": 0,
             "DIFFERENT_OBJECT": 0.33, "MULTI_OBJECT": 0, "SYNTHETIC_MULTI_OBJECT": 0.33}


def _tiny_config(tmp_path, name, **training):
    cfg = copy.deepcopy(port_train.DenseCorrespondenceTraining.load_default_config())
    t = cfg["training"]
    t.update(num_iterations=2, batch_size=2, num_matching_attempts=128,
             num_non_matches_per_match=6, save_rate=1000, logging_rate=1000,
             masked_pool_size=64, background_pool_size=64, num_blind_samples=60,
             use_tensorboard=False, logging_dir=str(tmp_path), logging_dir_name=name)
    t.update(training)
    net = cfg["dense_correspondence_network"]
    net.update(image_width=W, image_height=H)
    net["backbone"]["resnet_name"] = "Resnet18_8s"
    return cfg


class _Chosen(Exception):
    pass


def _jax_route(monkeypatch, cfg):
    """The route pdc_tpu's run takes for ``cfg``: it stops at the step
    factory it calls (nothing is compiled but the pixel permutations)."""
    import pdc_tpu.data.device_cache as jdc
    import pdc_tpu.training.scanned as jscanned
    import pdc_tpu.training.train as jtrain

    def stop(route):
        def f(*a, **k):
            raise _Chosen(route)
        return f

    monkeypatch.setattr(jscanned, "make_scanned_train_step",
                        stop(port_train.ROUTE_DEVICE_SAMPLER))
    monkeypatch.setattr(jdc, "make_cached_train_step", stop(port_train.ROUTE_CACHED_HOST_SAMPLER))
    monkeypatch.setattr(jtrain, "make_train_step", stop(port_train.ROUTE_HOST_STREAMING))
    trainer = jtrain.DenseCorrespondenceTraining(
        config=cfg, dataset=JaxSpartanDataset.make_synthetic(**SYNTH))
    trainer._state = trainer._model = trainer._tx = object()  # no network is built
    with pytest.raises(_Chosen) as chosen:
        trainer.run()
    return str(chosen.value)


@pytest.mark.parametrize("training", [
    {"use_matrix_loss": False},
    {"use_matrix_loss": False, "data_type_probabilities": SHOES_MIX},
    {"data_type_probabilities": SHOES_MIX},
    {"data_type_probabilities": SHOES_MIX, "steps_per_dispatch": 1},
], ids=["per_pair", "per_pair_shoes_mix", "matrix_shoes_mix", "matrix_shoes_mix_one_step"])
def test_driver_takes_the_jax_route(tmp_path, monkeypatch, training):
    cfg = _tiny_config(tmp_path, "route", **training)
    want = _jax_route(monkeypatch, copy.deepcopy(cfg))
    trainer = port_train.DenseCorrespondenceTraining(cfg, SpartanDataset.make_synthetic(**SYNTH),
                                                     device="cpu")
    trainer._dataset.set_parameters_from_training_config(cfg)
    route, step, _ = trainer._choose_route(
        LossConfig.from_dict(cfg["loss_function"]),
        tasm.AssemblerConfig.from_training_config(cfg), W)
    assert route == want
    if route == port_train.ROUTE_DEVICE_SAMPLER:  # K steps a call of one device-sampled step
        step = step.step
    assert step.assemble_fn is (tasm.assemble_batch_matrix
                                if cfg["training"].get("use_matrix_loss", True)
                                else tasm.assemble_batch)


def test_per_pair_run_with_synthetic_multi_object_rows(tmp_path, monkeypatch):
    """run() on the per-pair route with the shoes mix: finite losses, the
    folder written, and type-4 rows composited."""
    cfg = _tiny_config(tmp_path, "per_pair", num_iterations=3, use_matrix_loss=False,
                       data_type_probabilities=SHOES_MIX)
    ds = SpartanDataset.make_synthetic(**SYNTH)
    trainer = port_train.DenseCorrespondenceTraining(cfg, ds, device="cpu")
    seen = []
    real = tasm.assemble_synthetic_multi_object_sample

    def spy(p1, p2, acfg, g):
        out = real(p1, p2, acfg, g)
        seen.append(out[2].match_type.shape[0])
        return out

    monkeypatch.setattr(tasm, "assemble_synthetic_multi_object_sample", spy)
    folder = trainer.run()
    assert trainer.route == port_train.ROUTE_CACHED_HOST_SAMPLER
    assert np.isfinite(trainer._logging_dict["train"]["loss"]).all() and trainer.state.step == 3
    assert "000003.ckpt" in os.listdir(folder)
    assert sum(seen) > 0


# -- compute_loss_on_dataset ----------------------------------------------------------------


def compute_loss_against_jax(monkeypatch, jdcn, jds, dcn, ds, loss_config, num_iterations,
                             batch_size, seed):
    """Both packages' DCE.compute_loss_on_dataset on networks of the same
    weights and datasets of the same pairs; the port is handed the batches
    that JAX's assembled (the same host pairs, the keys its loop splits), so
    only the forward and the loss differ. Returns ``(port's, JAX's)``
    triples after checking the port's call: the JAX package's assembler
    config, the same pairs, the module's mode restored."""
    jds.reset_seed(11)
    acfg = JaxAssemblerConfig(
        num_matching_attempts=min(jds.num_matching_attempts, 5000),
        num_masked_non_matches_per_match=jds.num_masked_non_matches_per_match,
        num_background_non_matches_per_match=jds.num_background_non_matches_per_match)
    key = jax.random.PRNGKey(seed)
    assembled = []
    for _ in range(num_iterations):
        key, sub = jax.random.split(key)
        b = jds.make_host_batch(batch_size)
        assembled.append((b, jax.tree_util.tree_map(np.asarray, jax_assemble(sub, b, acfg))))
    jds.reset_seed(11)
    want = JaxDCE.compute_loss_on_dataset(jdcn, jds, loss_config, num_iterations=num_iterations,
                                          batch_size=batch_size, seed=seed)
    calls = []

    def replay(batch, cfg, generator, device):
        host, (img_a, img_b, idx) = assembled[len(calls)]
        calls.append(cfg)
        for k, v in host.items():  # the port drew the same pairs
            np.testing.assert_array_equal(batch[k], v)
        return torch.as_tensor(img_a), torch.as_tensor(img_b), _to_port(idx)

    monkeypatch.setattr(tasm, "assemble_batch", replay)
    ds.reset_seed(11)
    training = dcn.module.training
    got = DCE.compute_loss_on_dataset(dcn, ds, loss_config, num_iterations=num_iterations,
                                      batch_size=batch_size, seed=seed)
    assert len(calls) == num_iterations
    assert dataclasses.asdict(calls[0]) == dataclasses.asdict(acfg)
    assert dcn.module.training == training
    return got, want


def test_compute_loss_on_dataset_matches_jax(monkeypatch):
    """Within 1e-5 (ResNet-18-8s in train mode before the call: the
    evaluation switches it to eval mode and back)."""
    net_cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
               "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
    dcn = DenseCorrespondenceNetwork.from_config(
        net_cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    jdcn = JaxDCN(jax_build_backbone(net_cfg), state_dict_to_flax(dcn.module.state_dict()),
                  descriptor_dimension=D, image_width=W, image_height=H, config=net_cfg)
    dcn.module.train()
    jds, ds = JaxSpartanDataset.make_synthetic(**SYNTH), SpartanDataset.make_synthetic(**SYNTH)
    for d in (jds, ds):
        d.num_matching_attempts = 200
    got, want = compute_loss_against_jax(
        monkeypatch, jdcn, jds, dcn, ds,
        {"M_masked": 0.5, "M_background": 0.5, "scale_by_hard_negatives": True},
        num_iterations=2, batch_size=2, seed=3)
    assert len(got) == 3 and all(np.isfinite(got)) and got[0] > 0
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=1e-5, atol=1e-5)
