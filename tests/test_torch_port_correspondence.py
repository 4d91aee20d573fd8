"""Port data pipeline (pdc_tpu_torch.data.synthetic, ops.sampling,
ops.correspondence, ops.augmentation, data.assembler) against the JAX
package on 64x48 synthetic frames.

A torch.Generator cannot reproduce jax.random's bits, so every random stage
draws through ``pdc_tpu_torch.ops.sampling.uniform``, and these tests
replace that function to feed the port chosen draws: either the exact draws
the JAX function makes from its key (then the outputs must be equal), or
numpy draws from which the test computes the expected result with the JAX
stage functions. What no injected draw can pin is checked by distribution:
in-mask, valid-first, uniform.

Reprojection runs float32 matrix products whose sums are ordered
differently in the two frameworks: uv_b is compared at atol 1e-3 px, and
validity and flat indices (which truncate uv_b to integers, so a one-ulp
difference can move a pixel at a boundary) by the share that agree, at
least 99%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.data import synthetic as jsyn
from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.ops import augmentation as jaug
from pdc_tpu.ops import correspondence as jcorr
from pdc_tpu.ops import sampling as jsamp
from pdc_tpu_torch.data import synthetic as tsyn
from pdc_tpu_torch.data.assembler import AssemblerConfig, assemble_batch_matrix
from pdc_tpu_torch.ops import augmentation as taug
from pdc_tpu_torch.ops import correspondence as tcorr
from pdc_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)

H, W = 48, 64
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def frames():
    return tsyn.SyntheticScene(width=W, height=H, num_frames=6,
                               occluder=(0.05, 0.25, -0.1, 0.1, 0.15)).render_all()


class Draws:
    """Stand-in for ``sampling.uniform``: hands out the given arrays in call
    order (checking each shape), or, once they run out, numpy draws from a
    seeded generator; records everything it handed out."""

    def __init__(self, given=(), seed=0):
        self.given = list(given)
        self.rng = np.random.default_rng(seed)
        self.record = []

    def __call__(self, shape, generator, device=None, dtype=torch.float32):
        shape = tuple(shape)
        if self.given:
            u = np.asarray(self.given.pop(0))
            assert u.shape == shape, (u.shape, shape)
        else:
            u = self.rng.random(shape)
        self.record.append(u)
        return torch.as_tensor(np.array(u), dtype=dtype, device=device)


@pytest.fixture
def draws(monkeypatch):
    def install(given=(), seed=0):
        d = Draws(given, seed)
        monkeypatch.setattr(tsamp, "uniform", d)
        return d
    return install


G = torch.Generator().manual_seed(0)


def test_synthetic_scene_renders_the_same_frames():
    kw = dict(width=W, height=H, num_frames=4, occluder=(0.05, 0.25, -0.1, 0.1, 0.15), seed=3)
    a, b = jsyn.SyntheticScene(**kw), tsyn.SyntheticScene(**kw)
    np.testing.assert_array_equal(a.K, b.K)
    for x, y in zip(a.render_all(), b.render_all()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tsyn.make_orbit_pose(0.3), jsyn.make_orbit_pose(0.3))


def test_reprojection_matches_jax(frames):
    rgb, depth, mask, poses = frames
    K = np.asarray(tsyn.SyntheticScene(width=W, height=H).K, np.float32)
    rng = np.random.default_rng(0)
    ia, ib = np.array([0, 1, 2, 5]), np.array([1, 3, 4, 0])
    uv_a = np.stack([rng.integers(0, W, (4, 2000)), rng.integers(0, H, (4, 2000))], -1)
    uv_b, valid = tcorr.reproject_pixels(
        torch.as_tensor(uv_a), torch.as_tensor(depth[ia].astype(np.int32)),
        torch.as_tensor(poses[ia], dtype=torch.float32),
        torch.as_tensor(depth[ib].astype(np.int32)),
        torch.as_tensor(poses[ib], dtype=torch.float32), torch.as_tensor(K).expand(4, 3, 3))
    for b in range(4):
        juv, jvalid = jcorr.reproject_pixels(uv_a[b], depth[ia[b]], poses[ia[b]], depth[ib[b]],
                                             poses[ib[b]], K)
        juv, jvalid = np.asarray(juv), np.asarray(jvalid)
        both = jvalid & valid[b].numpy()
        assert jvalid.mean() > 0.3 and np.mean(jvalid == valid[b].numpy()) >= 0.99
        np.testing.assert_allclose(uv_b[b].numpy()[both], juv[both], atol=1e-3)


def test_find_correspondences_with_jax_draws(frames, draws):
    rgb, depth, mask, poses = frames
    K = np.asarray(tsyn.SyntheticScene(width=W, height=H).K, np.float32)
    key = jax.random.PRNGKey(3)
    juv_a, juv_b, jvalid = jcorr.find_pixel_correspondences(
        depth[0], poses[0], depth[2], poses[2], K, key, num_attempts=500, mask_a=mask[0])
    k_sample, _ = jax.random.split(key)
    draws([jax.random.uniform(k_sample, (500,))])
    uv_a, uv_b, valid = tcorr.find_pixel_correspondences(
        torch.as_tensor(depth[0].astype(np.int32)), torch.as_tensor(poses[0]).float(),
        torch.as_tensor(depth[2].astype(np.int32)), torch.as_tensor(poses[2]).float(),
        torch.as_tensor(K), G, num_attempts=500, mask_a=torch.as_tensor(mask[0]))
    np.testing.assert_array_equal(uv_a.numpy(), np.asarray(juv_a))
    assert np.mean(valid.numpy() == np.asarray(jvalid)) >= 0.99
    both = valid.numpy() & np.asarray(jvalid)
    np.testing.assert_allclose(uv_b.numpy()[both], np.asarray(juv_b)[both], atol=1e-3)


def test_sample_from_mask_with_jax_draws(frames, draws):
    mask = frames[2]
    for i, n in ((0, 300), (3, 1000)):
        key = jax.random.PRNGKey(i)
        juv, jok = jsamp.sample_from_mask(key, mask[i], n)
        draws([jax.random.uniform(key, (n,))])
        uv, ok = tsamp.sample_from_mask(torch.as_tensor(mask[i]), n, G)
        np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
        assert bool(ok) == bool(jok)


def test_sampling_distributions(frames):
    mask = torch.as_tensor(frames[2][:2])
    g = torch.Generator().manual_seed(1)
    uv, ok = tsamp.sample_from_mask(mask, 20000, g)
    assert ok.all() and uv.shape == (2, 20000, 2)
    assert bool((mask[0][uv[0, :, 1], uv[0, :, 0]] != 0).all())
    # uniform over the mask's pixels: every pixel drawn, counts within 6 sigma
    flat = uv[0, :, 1] * W + uv[0, :, 0]
    n_pix = int((mask[0] != 0).sum())
    counts = torch.bincount(flat, minlength=H * W)[mask[0].reshape(-1) != 0].double()
    mean = 20000 / n_pix
    assert counts.min() > 0 and float((counts - mean).abs().max()) < 6 * mean ** 0.5 + 1
    _, empty_ok = tsamp.sample_from_mask(torch.zeros(H, W), 5, g)
    assert not bool(empty_ok)
    # valid-first permutations, and draws from each part
    perm, count = tsamp.build_pixel_perm(mask)
    for b in range(2):
        jperm, jcount = jsamp.build_pixel_perm(np.asarray(mask[b]))
        np.testing.assert_array_equal(perm[b].numpy(), np.asarray(jperm))
        assert int(count[b]) == int(jcount)
    on, ok_on = tsamp.sample_flat_from_perm(perm, 0, count, 5000, g)
    off, ok_off = tsamp.sample_flat_from_perm(perm, count, H * W, 5000, g)
    mflat = mask.reshape(2, -1) != 0
    assert ok_on.all() and ok_off.all()
    assert bool(torch.gather(mflat, 1, on).all()) and not bool(torch.gather(mflat, 1, off).any())
    px = tsamp.sample_uniform_pixels(W, H, 5000, g, (2,))
    assert px.shape == (2, 5000, 2) and int(px[..., 0].max()) == W - 1
    assert int(px[..., 1].max()) == H - 1 and int(px.min()) == 0


def test_perm_gather_matches_jax_take():
    rng = np.random.default_rng(2)
    perm = np.stack([rng.permutation(H * W) for _ in range(3)]).astype(np.int32)
    lo, hi = np.array([0, 100, 5]), np.array([700, H * W, 6])
    u = rng.random((3, 400))
    got, ok = tsamp.perm_gather(torch.as_tensor(perm), torch.as_tensor(lo),
                                torch.as_tensor(hi), torch.as_tensor(u))
    for b in range(3):
        r = lo[b] + np.minimum(np.floor(u[b] * (hi[b] - lo[b])).astype(np.int64),
                               hi[b] - lo[b] - 1)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(jnp.take(perm[b], r)))
    assert ok.all()
    assert not tsamp.perm_gather(torch.as_tensor(perm[:1]), 4, 4, torch.as_tensor(u[:1]))[1]


def test_blind_non_matches_with_jax_draws(frames, draws):
    mask = frames[2]
    rng = np.random.default_rng(4)
    matches = rng.integers(0, H * W, 200).astype(np.int32)
    mvalid = rng.random(200) < 0.7
    key = jax.random.PRNGKey(7)
    ja, jb, jok = jcorr.make_blind_non_matches(key, mask[0], matches, mvalid, mask[1], 400)
    k_a, k_b = jax.random.split(key)
    draws([jax.random.uniform(k_a, (400,)), jax.random.uniform(k_b, (400,))])
    a, b, ok = tcorr.make_blind_non_matches(G, torch.as_tensor(mask[0]),
                                            torch.as_tensor(matches), torch.as_tensor(mvalid),
                                            torch.as_tensor(mask[1]), 400)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert bool(ok) == bool(jok)
    hit = set(matches[mvalid].tolist())
    assert not hit & set(a.tolist())


def test_blind_non_matches_perm_given_draws(frames, draws):
    mask = torch.as_tensor(frames[2][:2])
    perm, count = tsamp.build_pixel_perm(mask)
    rng = np.random.default_rng(5)
    matches = torch.as_tensor(rng.integers(0, H * W, (2, 300)))
    mvalid = torch.as_tensor(rng.random((2, 300)) < 0.8)
    flip_a, flip_b = torch.tensor([True, False]), torch.tensor([False, True])
    d = draws(seed=6)
    a, b, ok = tcorr.make_blind_non_matches_perm(G, perm, count, flip_a, matches, mvalid,
                                                 perm, count, flip_b, H * W, 500)
    u_a, u_b = d.record
    for i in range(2):
        n = int(count[i])
        raw_a = perm[i].numpy()[np.floor(u_a[i] * n).astype(int)]
        raw_b = perm[i].numpy()[np.floor(u_b[i] * n).astype(int)]
        want_a = H * W - 1 - raw_a if flip_a[i] else raw_a
        want_b = H * W - 1 - raw_b if flip_b[i] else raw_b
        np.testing.assert_array_equal(a[i].numpy(), want_a)
        np.testing.assert_array_equal(b[i].numpy(), want_b)
        matched = np.zeros(H * W, bool)
        matched[matches[i].numpy()[mvalid[i].numpy()]] = True
        np.testing.assert_array_equal(ok[i].numpy(), ~matched[want_a])


def test_flips_match_jax(draws):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    uv = rng.uniform(0, 40, (50, 2)).astype(np.float32)
    jimg, juv = jaug.flip_180(img, uv)
    timg, tuv = taug.flip_180(torch.as_tensor(img), torch.as_tensor(uv))
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    m = rng.integers(0, 2, (H, W)).astype(np.uint8)
    for k in range(4):
        key = jax.random.PRNGKey(k)
        ji, ju, (jm,), jflag = jaug.random_flip_180(key, img, uv, (m,), return_flag=True)
        draws([np.asarray(jax.random.uniform(key))])
        ti, tu, (tm,), tflag = taug.random_flip_180(torch.as_tensor(img), torch.as_tensor(uv),
                                                    G, (torch.as_tensor(m),), return_flag=True)
        assert bool(tflag) == bool(jflag)
        for x, y in ((ti, ji), (tu, ju), (tm, jm)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _jax_dr_draws(key, shape):
    k_kind, k_c1, k_c2, k_vert, k_noise_q, k_n1, k_n2 = jax.random.split(key, 7)
    return [jax.random.uniform(k_kind), jax.random.uniform(k_c1, (3,)),
            jax.random.uniform(k_c2, (3,)), jax.random.uniform(k_vert),
            jax.random.uniform(k_noise_q), jax.random.uniform(k_n1, shape),
            jax.random.uniform(k_n2, shape)]


def test_domain_randomization_matches_jax(frames, draws):
    """Solid and gradient backgrounds, with and without the wrapping uint8
    noise, equal the JAX function's output for the same draws."""
    rgb, _, mask, _ = frames
    seen = set()
    for k in range(12):
        key = jax.random.PRNGKey(100 + k)
        want = np.asarray(jaug.domain_randomize_background(key, rgb[1], mask[1]))
        d = _jax_dr_draws(key, rgb[1].shape)
        seen.add((float(d[0]) < 0.5, float(d[4]) < 0.5))
        draws(d)
        got = taug.domain_randomize_background(torch.as_tensor(rgb[1]), torch.as_tensor(mask[1]),
                                               G).numpy()
        np.testing.assert_array_equal(got, want)
        obj = mask[1] != 0
        np.testing.assert_array_equal(got[obj], rgb[1][obj])
    assert len(seen) == 4  # solid/gradient x noise/no noise all covered
    # the coin-flipped wrapper: coin first, then the randomization's draws
    key = jax.random.PRNGKey(1)
    want = np.asarray(jaug.random_domain_randomize_background(key, rgb[1], mask[1]))
    k_coin, k_dr = jax.random.split(key)
    draws([jax.random.uniform(k_coin)] + _jax_dr_draws(k_dr, rgb[1].shape))
    got = taug.random_domain_randomize_background(torch.as_tensor(rgb[1]),
                                                  torch.as_tensor(mask[1]), G)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uint8_noise_wraps():
    img = torch.full((2, 2, 3), 10, dtype=torch.uint8)
    n1 = torch.full_like(img, 250)
    n2 = torch.full_like(img, 20)
    assert (img + n1 - n2).tolist()[0][0] == [240, 240, 240]  # 260 wraps to 4, 4-20 to 240
    assert ((img + n1 - n2).numpy() == (img.numpy() + n1.numpy() - n2.numpy())).all()


def _batch(frames, with_perm):
    rgb, depth, mask, poses = frames
    K = np.asarray(tsyn.SyntheticScene(width=W, height=H).K, np.float32)
    ia, ib = np.array([0, 1, 3]), np.array([1, 2, 5])
    batch = dict(rgb_a=rgb[ia], depth_a=depth[ia], mask_a=mask[ia],
                 pose_a=poses[ia].astype(np.float32), rgb_b=rgb[ib], depth_b=depth[ib],
                 mask_b=mask[ib], pose_b=poses[ib].astype(np.float32),
                 K=np.stack([K] * 3), match_type=np.array([0, 0, 2], np.int32))
    if with_perm:
        for s in "ab":
            perm, count = tsamp.build_pixel_perm(torch.as_tensor(batch["mask_" + s]))
            batch["perm_" + s], batch["count_" + s] = perm.numpy(), count.numpy()
    return batch


CFG = AssemblerConfig(num_matching_attempts=400, masked_pool_size=64,
                      background_pool_size=96, num_blind_samples=128, domain_randomize=False)


def test_assembler_deterministic_stages_perm_path(frames, draws):
    """Given the draws, every deterministic stage equals the JAX stage
    functions: perm gathers, reprojection, flips, pools, blind pairing and
    normalisation."""
    batch = _batch(frames, with_perm=True)
    d = draws(seed=9)
    img_a, img_b, s = assemble_batch_matrix(batch, CFG, G, device="cpu")
    u_match, coin_a, coin_b, u_mp, u_bp, u_bla, u_blb, u_ax, u_bx = d.record
    HW = H * W
    within = batch["match_type"] == 0
    for i in range(3):
        pa, ca = batch["perm_a"][i], int(batch["count_a"][i])
        pb, cb = batch["perm_b"][i], int(batch["count_b"][i])
        fa, fb = coin_a[i] < 0.5, coin_b[i] < 0.5
        flat_a = pa[np.floor(u_match[i] * ca).astype(int)]
        uv_a = np.stack([flat_a % W, flat_a // W], -1)
        juv_b, jvalid = jcorr.reproject_pixels(uv_a, batch["depth_a"][i], batch["pose_a"][i],
                                               batch["depth_b"][i], batch["pose_b"][i],
                                               batch["K"][i])
        juv_b, jvalid = np.asarray(juv_b), np.asarray(jvalid) & within[i]
        if fa:
            uv_a = np.stack([W - 1 - uv_a[:, 0], H - 1 - uv_a[:, 1]], -1)
        if fb:
            juv_b = np.stack([W - 1 - juv_b[:, 0], H - 1 - juv_b[:, 1]], -1)
        np.testing.assert_array_equal(s.matches_a[i].numpy(), uv_a[:, 1] * W + uv_a[:, 0])
        valid = s.matches_valid[i].numpy()
        assert np.mean(valid == jvalid) >= 0.99
        both = valid & jvalid
        np.testing.assert_allclose(s.matches_uv_b[i].numpy()[both], juv_b[both], atol=1e-3)
        jflat_b = juv_b[:, 1].astype(np.int32) * W + juv_b[:, 0].astype(np.int32)
        if within[i]:
            assert both.mean() > 0.3
            assert np.mean(s.matches_b[i].numpy()[both] == jflat_b[both]) >= 0.99

        def flipped(raw, f):
            return HW - 1 - raw if f else raw
        np.testing.assert_array_equal(
            s.masked_pool_b[i].numpy(), flipped(pb[np.floor(u_mp[i] * cb).astype(int)], fb))
        np.testing.assert_array_equal(
            s.background_pool_b[i].numpy(),
            flipped(pb[cb + np.floor(u_bp[i] * (HW - cb)).astype(int)], fb))
        if within[i]:
            blind_a = flipped(pa[np.floor(u_bla[i] * ca).astype(int)], fa)
            blind_b = flipped(pb[np.floor(u_blb[i] * cb).astype(int)], fb)
            matched = np.zeros(HW, bool)
            matched[s.matches_a[i].numpy()[valid]] = True
            np.testing.assert_array_equal(s.blind_nm_valid[i].numpy(), ~matched[blind_a])
        else:
            blind_a = flipped(pa[np.floor(u_ax[i] * ca).astype(int)], fa)
            blind_b = flipped(pb[np.floor(u_bx[i] * cb).astype(int)], fb)
            assert s.blind_nm_valid[i].all() and not valid.any()
        np.testing.assert_array_equal(s.blind_nm_a[i].numpy(), blind_a)
        np.testing.assert_array_equal(s.blind_nm_b[i].numpy(), blind_b)
        for img, rgb, f in ((img_a, batch["rgb_a"][i], fa), (img_b, batch["rgb_b"][i], fb)):
            rgb = np.asarray(jaug.flip_180(rgb, uv_a)[0]) if f else rgb
            want = (rgb.astype(np.float32) / np.float32(255.0) - MEAN) / STD
            np.testing.assert_allclose(img[i].numpy(), want, rtol=1e-6, atol=1e-6)
    assert s.match_type.tolist() == [0, 0, 2]


def test_assembler_mask_path_and_augmentation(frames):
    """The inverse-CDF route (no permutations) and domain randomisation on:
    shapes, ranges, pools on and off the (flipped) object, blind pixels on
    the object and unmatched."""
    batch = _batch(frames, with_perm=False)
    cfg = AssemblerConfig(**{**CFG.__dict__, "domain_randomize": True})
    img_a, img_b, s = assemble_batch_matrix(batch, cfg, torch.Generator().manual_seed(3),
                                            device="cpu")
    assert img_a.shape == img_b.shape == (3, H, W, 3) and img_a.dtype == torch.float32
    assert s.matches_a.shape == (3, 400) and s.blind_nm_a.shape == (3, 128)
    for x in (s.matches_a, s.matches_b, s.masked_pool_b, s.background_pool_b, s.blind_nm_a,
              s.blind_nm_b):
        assert int(x.min()) >= 0 and int(x.max()) < H * W
    assert s.matches_valid[:2].float().mean() > 0.5 and not s.matches_valid[2].any()
    # image b's mask as augmented: recover the flip from the masked pool
    for i in range(3):
        mb = batch["mask_b"][i].reshape(-1) != 0
        on = s.masked_pool_b[i].numpy()
        if not mb[on].all():
            mb = mb[::-1]
        assert mb[on].all() and not mb[s.background_pool_b[i].numpy()].any()
        if i < 2:
            blind = s.blind_nm_a[i].numpy()[s.blind_nm_valid[i].numpy()]
            assert not set(blind.tolist()) & set(
                s.matches_a[i].numpy()[s.matches_valid[i].numpy()].tolist())


def test_assembler_config_from_training_config(frames):
    import copy

    import yaml

    with open("configs/training.yaml") as f:
        tc = yaml.safe_load(f)
    got = AssemblerConfig.from_training_config(tc)
    want = JaxAssemblerConfig.from_training_config(tc)
    assert got.__dict__ == want.__dict__
    # the shoes experiments' mix on both loss routes
    smo = copy.deepcopy(tc)
    smo["training"]["data_type_probabilities"].update(
        SINGLE_OBJECT_WITHIN_SCENE=0.33, DIFFERENT_OBJECT=0.33, SYNTHETIC_MULTI_OBJECT=0.33)
    for use_matrix_loss in (True, False):
        smo["training"]["use_matrix_loss"] = use_matrix_loss
        got = AssemblerConfig.from_training_config(smo)
        assert got.__dict__ == JaxAssemblerConfig.from_training_config(smo).__dict__
        assert got.enable_synthetic_multi_object and got.use_matrix_loss == use_matrix_loss
    # a synthetic multi-object row assembles (tests/test_torch_port_smo.py holds
    # its values against the JAX package's)
    rgb, depth, mask, poses = frames
    ia, ib = np.array([2, 3, 4]), np.array([4, 5, 0])
    batch = _batch(frames, with_perm=True)
    batch.update(rgb_a_2=rgb[ia], depth_a_2=depth[ia], mask_a_2=mask[ia],
                 pose_a_2=poses[ia].astype(np.float32), rgb_b_2=rgb[ib], depth_b_2=depth[ib],
                 mask_b_2=mask[ib], pose_b_2=poses[ib].astype(np.float32), K_2=batch["K"],
                 match_type=np.array([0, 4, 2], np.int32))
    cfg = AssemblerConfig(**{**CFG.__dict__, "enable_synthetic_multi_object": True})
    img_a, _, s = assemble_batch_matrix(batch, cfg, G, "cpu")
    assert img_a.shape == (3, H, W, 3) and s.matches_a.shape == (3, 400)
    assert s.match_type.tolist() == [0, 4, 2] and s.matches_valid[1].any()
    assert not s.blind_nm_valid[1].any() and s.blind_nm_valid[2].all()
    if not torch.cuda.is_available():  # the default device is cuda, never a silent CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            assemble_batch_matrix({}, AssemblerConfig(), G)
