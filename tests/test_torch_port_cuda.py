"""The port's CUDA kernels on the card: the best-match kernel (K3) and the
pooled-hinge forward and backward (K1, K2) against their plain versions,
their launch counters, determinism, the server's batched best match, one
train step through K1/K2, the device cache and pair sampler on the card,
three iterations of the training driver, the per-pair loss and synthetic
multi-object rows (a composited matrix step with the kernels against the
plain hinge, the per-pair terms against the CPU's), and the on-disk slice:
the PNG codecs at 640x480 and ``python -m pdc_tpu_torch train`` from a
scene tree.

Needs an NVIDIA GPU with nvcc; skips elsewhere. Imports no JAX, so it runs
on a GPU host without the JAX package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from pdc_tpu_torch.ops import best_match as bm
from pdc_tpu_torch.ops import pooled_hinge as ph

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    # every comparison below is in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _check(res, q, idx, dist):
    """Tie-tolerant against float64: the chosen pixel's squared distance is
    within 1e-5 of the true minimum, the distance within 1e-4."""
    r = res.double()
    d2 = bm.squared_distances(r, q.double())
    true_min = d2.min(-1).values
    chosen = torch.gather(d2, -1, idx.long()[..., None])[..., 0]
    assert int(((chosen - true_min) > 1e-5).sum()) == 0
    assert float((dist.double() - true_min.sqrt()).abs().max()) <= 1e-4


# (B, D, HW, Q): ragged HW (not a multiple of the 1024-pixel step, nor of 4:
# the scalar loads), one pixel and fewer than one block's step, every D
# template (exact up to 4, then 8 and 16), Q across several 16- and 32-query
# groups, B=8 with Q=1 and Q=16
@pytest.mark.parametrize("B,D,HW,Q", [(1, 3, 5000, 4), (1, 16, 3072, 8), (3, 1, 1, 5),
                                      (2, 8, 1025, 40), (1, 5, 70000, 17), (4, 3, 4800, 1),
                                      (8, 3, 5001, 16), (8, 3, 4096, 1), (2, 3, 30001, 17),
                                      (1, 3, 100003, 1024), (1, 16, 1000, 17), (3, 1, 999, 1024),
                                      (1, 2, 3, 33), (1, 4, 2050, 64), (2, 12, 700, 20)])
def test_kernel_matches_plain(cuda, B, D, HW, Q):
    g = np.random.default_rng(B * 1000 + D * 100 + Q)
    res = torch.as_tensor(g.standard_normal((B, D, HW), dtype=np.float32), device=cuda)
    q = torch.as_tensor(g.standard_normal((B, Q, D), dtype=np.float32), device=cuda)
    before = bm.launches
    idx, dist = bm.best_match(res, q)
    torch.cuda.synchronize()
    assert bm.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (B, Q) and dist.shape == (B, Q)
    _check(res, q, idx, dist)
    pidx, pdist = bm.best_match_reference(res, q)
    # same sum of squared differences in the same order; only the FMA rounds differently
    assert float((dist - pdist).abs().max()) <= 1e-4


def test_kernel_ties_and_padding(cuda):
    res = torch.zeros(1, 3, 2048 + 77, device=cuda)
    res[0, :, [5, 1200, 2100]] = 1.0
    res[0, :, 2048 + 76] = 5.0
    q = torch.tensor([[[1.0, 1.0, 1.0], [5.0, 5.0, 5.0], [0.0, 0.0, 0.0]]], device=cuda)
    idx, dist = bm.best_match(res, q)
    assert idx.tolist() == [[5, 2048 + 76, 0]]
    assert dist.tolist() == [[0.0, 0.0, 0.0]]


@pytest.mark.parametrize("B,HW,Q", [(2, 307200, 3), (1, 307203, 40)])
def test_kernel_ties_across_blocks_go_to_the_lowest_index(cuda, B, HW, Q):
    # exact matches planted at several pixels per query: within one thread's
    # 4 pixels, across neighbouring threads and steps, across the slices of
    # the grid and, with Q=40, in both query groups
    slices, groups, per_group, steps = bm.plan(B, 3, HW, Q, cuda)
    assert slices > 2
    S = steps * 1024  # pixels per slice
    spots = {0: [S - 1, S, 2 * S + 5, HW - 1], 1: [4 * 77 + 2, 4 * 77 + 3, S + 1],
             2: [4 * 99 + 3, 4 * 99 + 4, 4 * 99 + 1024]}
    if Q > 32:
        spots.update({33: [2 * S, 3 * S - 1], Q - 1: [HW - 2, HW - 1]})
    g = np.random.default_rng(HW + Q)
    res = g.uniform(1.0, 2.0, (B, 3, HW)).astype(np.float32)
    q = g.uniform(1.0, 2.0, (B, Q, 3)).astype(np.float32)
    for k, pixels in spots.items():
        res[:, :, pixels] = -1.0 - k
        q[:, k] = -1.0 - k
    res, q = torch.as_tensor(res, device=cuda), torch.as_tensor(q, device=cuda)
    idx, dist = bm.best_match(res, q)
    for k, pixels in spots.items():
        assert idx[:, k].tolist() == [min(pixels)] * B and dist[:, k].tolist() == [0.0] * B
    _check(res, q, idx, dist)


def test_kernel_all_nan_image_gives_pixel_zero(cuda):
    res = torch.full((2, 3, 5000), float("nan"), device=cuda)
    q = torch.randn(2, 20, 3, device=cuda)
    idx, dist = bm.best_match(res, q)
    assert not idx.any() and torch.isinf(dist).all()


def test_kernel_is_deterministic_and_one_launch(cuda):
    from torch.profiler import ProfilerActivity, profile
    g = np.random.default_rng(3)
    for B, Q in ((8, 16), (1, 1024)):
        res = torch.as_tensor(g.standard_normal((B, 3, 307200), dtype=np.float32), device=cuda)
        q = torch.as_tensor(g.standard_normal((B, Q, 3), dtype=np.float32), device=cuda)
        a = bm.best_match(res, q)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            b = bm.best_match(res, q)
            torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert sum("best_match" in e.name for e in prof.events()) == 1


def test_kernel_raises_instead_of_falling_back(cuda, monkeypatch):
    with pytest.raises(ValueError):
        bm.best_match(torch.zeros(1, 17, 10, device=cuda), torch.zeros(1, 1, 17, device=cuda))

    def no_library():
        raise RuntimeError("no library")
    monkeypatch.setattr(bm, "_library", no_library)
    with pytest.raises(RuntimeError, match="no library"):
        bm.best_match(torch.zeros(1, 3, 10, device=cuda), torch.zeros(1, 1, 3, device=cuda))


def test_server_best_match_runs_the_kernel(cuda):
    from pdc_tpu_torch.apps.serve import DescriptorClient, DescriptorServer
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    cfg = {"descriptor_dimension": 3, "image_width": 64, "image_height": 48,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
    dcn = DenseCorrespondenceNetwork.from_config(cfg)  # default device: cuda
    assert dcn.device.type == "cuda"
    rgb = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    res = dcn.forward_on_img(rgb)
    q = res[[3, 20, 40], [5, 30, 60]].cpu().numpy()
    s = DescriptorServer(dcn, port=0, max_batch=2)
    s.start()
    try:
        before = bm.launches
        with DescriptorClient(*s.address, timeout=60.0) as c:
            uv, dist = c.best_match(rgb, q)
            desc = c.descriptors(rgb)
        assert bm.launches == before + 1
    finally:
        s.shutdown()
    np.testing.assert_allclose(desc, res.cpu().numpy(), atol=1e-4, rtol=1e-4)
    planar = res.permute(2, 0, 1).reshape(1, 3, -1).contiguous()
    idx = torch.as_tensor(uv[:, 1] * 64 + uv[:, 0], device=cuda)[None]
    _check(planar, torch.as_tensor(q, device=cuda)[None], idx,
           torch.as_tensor(np.array(dist), device=cuda)[None])


def _hinge_case(dev, B, Nm, P, D, seed, valid_frac=0.8, scale=0.3, collide=0):
    """Random rows at the loss's scale, match/pool pixels on a 64x48 image;
    ``collide`` pool entries are moved onto row 0's true match."""
    g = np.random.default_rng(seed)
    da = (g.standard_normal((B, Nm, D)) * scale).astype(np.float32)
    db = (g.standard_normal((B, P, D)) * scale).astype(np.float32)
    mu = g.integers(0, 64, (B, Nm)).astype(np.float32)
    mv = g.integers(0, 48, (B, Nm)).astype(np.float32)
    pu = g.integers(0, 64, (B, P)).astype(np.float32)
    pv = g.integers(0, 48, (B, P)).astype(np.float32)
    pu[:, :collide] = mu[:, :1]
    pv[:, :collide] = mv[:, :1]
    mvalid = (g.random((B, Nm)) < valid_frac).astype(np.float32)
    pvalid = (g.random((B, P)) < valid_frac).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (da, db, mu, mv, mvalid, pu, pv, pvalid)]


def _kernel_and_plain(case, use_pix, M_pixel=20.0):
    da, db = case[0].clone().requires_grad_(), case[1].clone().requires_grad_()
    g = torch.linspace(0.5, 1.5, case[0].shape[0], device=case[0].device)
    f0, b0 = ph.forward_launches, ph.backward_launches
    loss, hard = ph.pooled_hinge(da, db, *case[2:], 0.5, use_pix, M_pixel)
    (loss * g).sum().backward()
    torch.cuda.synchronize()
    assert (ph.forward_launches, ph.backward_launches) == (f0 + 1, b0 + 1)
    ploss, phard = ph.pooled_hinge_reference(*case, 0.5, use_pix, M_pixel)
    pgda, pgdb = ph.pooled_hinge_backward_reference(g, *case, 0.5, use_pix, M_pixel)
    return (loss, hard, da.grad, db.grad), (ploss, phard, pgda, pgdb)


# (B, Nm, P, D, scale): ragged Nm (not a multiple of K1's 64-row tile or of
# K2's 8-warp row tile), P beyond one pool chunk (K1: 512 entries; K2: 256
# for D <= 4, 128 above) and not a multiple of 32, P below one chunk
# and below one warp, every D template (K2: exact D up to 4, then 8 and 16),
# and rows at scale 0.05, where most pairs count (the counted path and the
# gb reduction under load)
@pytest.mark.parametrize("use_pix", [False, True])
@pytest.mark.parametrize("B,Nm,P,D,scale", [
    (2, 700, 256, 3, 0.3), (1, 65, 1030, 1, 0.3), (3, 130, 77, 16, 0.3),
    (4, 10000, 1024, 3, 0.3),
    (2, 1001, 600, 3, 0.3), (3, 57, 513, 2, 0.3), (2, 333, 300, 8, 0.3), (1, 71, 257, 6, 0.3),
    (2, 300, 20, 3, 0.3), (1, 9, 1, 4, 0.3), (2, 1000, 129, 12, 0.3),
    (4, 3000, 1024, 3, 0.05), (2, 500, 700, 4, 0.05), (1, 200, 300, 16, 0.05)])
def test_pooled_hinge_kernels_match_plain(cuda, B, Nm, P, D, scale, use_pix):
    case = _hinge_case(cuda, B, Nm, P, D, seed=Nm + P + D, scale=scale, collide=5)
    (loss, hard, gda, gdb), (ploss, phard, pgda, pgdb) = _kernel_and_plain(case, use_pix)
    assert hard.dtype == torch.int64 and loss.shape == hard.shape == (B,)
    # every term is bit-identical (no FMA contraction in the kernel), so the
    # count is exact and only the order of the sums differs
    assert torch.equal(hard, phard)
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=0)
    for got, want in ((gda, pgda), (gdb, pgdb)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _threshold(M):
    """The least float32 T >= 0 with sqrt(T) >= M (numpy's sqrt is correctly
    rounded), by bisection over the bit patterns of non-negative floats."""
    M = np.float32(M)
    lo, hi = 0, 0x7F800000
    while lo < hi:
        mid = (lo + hi) // 2
        if np.sqrt(np.array(mid, np.uint32).view(np.float32)) >= M:
            hi = mid
        else:
            lo = mid + 1
    return float(np.array(lo, np.uint32).view(np.float32))


def test_pooled_hinge_threshold_matches_numpy(cuda):
    lib = ph._library()
    for M in (0.5, 0.3, 1.7, 2.0, 1e-13, 0.0, -1.0, float("inf"), 1e30):
        assert lib.pdc_pooled_hinge_threshold(M) == _threshold(M), M
    assert _threshold(0.5) == 0.25


def test_pooled_hinge_boundary_rows_count_exactly(cuda):
    # rows whose distance to the (zero) pool rows straddles M = 0.5 by a few
    # ulps: d2 lands on both sides of the threshold 0.25, and the hard count
    # and the gradients must still equal the plain version's
    g = np.random.default_rng(11)
    v = g.standard_normal((1, 64, 3)).astype(np.float32)
    v *= np.float32(0.5) / np.linalg.norm(v, axis=-1, keepdims=True).astype(np.float32)
    steps = np.arange(-32, 32, dtype=np.int32)
    v[0, :, 0] = (v[0, :, 0].view(np.int32) + steps).view(np.float32)
    d2 = ((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]).astype(np.float32)
          + v[..., 2] * v[..., 2]).astype(np.float32)
    assert (d2 < 0.25).any() and (d2 >= 0.25).any()
    case = _hinge_case(cuda, 1, 64, 40, 3, seed=12, valid_frac=1.0)
    case[0].copy_(torch.as_tensor(v, device=cuda))
    case[1].zero_()
    case[5].fill_(100.0), case[6].fill_(100.0)  # no collision
    for use_pix in (False, True):
        (loss, hard, gda, gdb), (ploss, phard, pgda, pgdb) = _kernel_and_plain(case, use_pix)
        assert torch.equal(hard, phard) and 0 < hard.item() < 64 * 40
        torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=0)
        for got, want in ((gda, pgda), (gdb, pgdb)):
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_pooled_hinge_all_invalid_and_collisions(cuda):
    case = _hinge_case(cuda, 2, 100, 64, 3, seed=4)
    case[4].zero_()  # no valid match row
    (loss, hard, gda, gdb), _ = _kernel_and_plain(case, False)
    assert loss.tolist() == [0.0, 0.0] and hard.tolist() == [0, 0]
    assert not gda.any() and not gdb.any()
    # every pool entry on every row's match pixel: all pairs collide
    case = _hinge_case(cuda, 1, 50, 40, 3, seed=5)
    case[2].fill_(10.0), case[3].fill_(10.0), case[5].fill_(10.0), case[6].fill_(20.0)
    (loss, hard, _, _), _ = _kernel_and_plain(case, False)
    assert loss.item() == 0.0 and hard.item() == 0


def test_pooled_hinge_identical_rows_zero_grad(cuda):
    case = _hinge_case(cuda, 1, 8, 16, 3, seed=6, valid_frac=1.0)
    case[0].zero_(), case[1].zero_()
    case[2].fill_(30.0), case[3].fill_(30.0)
    case[5].copy_(torch.arange(16.0, device=cuda)[None]), case[6].zero_()  # far from (30, 30)
    (loss, hard, gda, gdb), _ = _kernel_and_plain(case, False)
    assert hard.item() == 8 * 16 and loss.item() == pytest.approx(8 * 16 * 0.25)
    assert not gda.any() and not gdb.any()


def test_pooled_hinge_near_identical_rows(cuda):
    # d2 from 1e-30 to 1e-20, across K2's 1e-24 floor: K1 counts every pair
    # (dist = max(sqrt(d2), 1e-12)), K2 gives a gradient only where d2 > 1e-24
    case = _hinge_case(cuda, 1, 64, 16, 3, seed=13, valid_frac=1.0)
    eps = torch.logspace(-15, -10, 64, device=cuda)
    case[0].zero_(), case[1].zero_()
    case[0][0, :, 0] = eps
    case[2].fill_(30.0), case[3].fill_(30.0)
    case[5].copy_(torch.arange(16.0, device=cuda)[None]), case[6].zero_()  # far from (30, 30)
    d2 = eps * eps
    assert (d2 <= 1e-24).any() and (d2 > 1e-24).any()
    for use_pix in (False, True):
        (loss, hard, gda, gdb), (ploss, phard, pgda, pgdb) = _kernel_and_plain(case, use_pix)
        assert hard.item() == phard.item() == 64 * 16
        torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=0)
        assert torch.equal(pgda[0, :, 0] != 0, d2 > 1e-24)
        for got, want in ((gda, pgda), (gdb, pgdb)):
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _f5_case(dev, where, D):
    """_hinge_case with one non-finite descriptor value (or two) placed as
    ``where`` says, in pair 0 or 1."""
    case = _hinge_case(dev, 2, 700, 300, D, seed=21 + D, scale=0.3 * (3 / D) ** 0.5)
    da, db, mvalid, pvalid = case[0], case[1], case[4], case[7]
    nan, inf = float("nan"), float("inf")

    def first(valid, want, b):
        return int(torch.nonzero(valid[b] == want)[0, 0])
    c1, c2 = min(1, D - 1), min(2, D - 1)
    if where == "NaN in a valid row":
        da[0, first(mvalid, 1.0, 0), c1] = nan
    elif where == "NaN in an invalid row":
        da[1, first(mvalid, 0.0, 1), 0] = nan
    elif where == "NaN in a valid entry":
        db[1, first(pvalid, 1.0, 1), c2] = nan
    elif where == "NaN in an invalid entry":
        db[0, first(pvalid, 0.0, 0), 0] = nan
    elif where == "+inf in a row":
        da[0, first(mvalid, 1.0, 0), c1] = inf
    elif where == "-inf in an entry":
        db[1, first(pvalid, 1.0, 1), 0] = -inf
    elif where == "the same inf in a row and an entry":
        da[0, first(mvalid, 1.0, 0), c2] = -inf
        db[0, first(pvalid, 0.0, 0), c2] = -inf
    elif where == "opposite infs in a row and an entry":
        da[1, first(mvalid, 0.0, 1), 0] = inf
        db[1, first(pvalid, 1.0, 1), 0] = -inf
    return case


def _assert_like_plain(got, want, tol):
    """NaN and infinities exactly where the plain version has them, the
    finite entries within ``tol`` of the plain version's largest."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])
    f = torch.isfinite(want)
    if f.any():
        assert float((got[f] - want[f]).abs().max()) <= tol * float(want[f].abs().max())


# fault F5: K1 and K2 give the plain version's NaN where a descriptor is not
# finite; the finite results are held to the bars above
@pytest.mark.parametrize("use_pix", [False, True])
@pytest.mark.parametrize("D", [3, 16])
@pytest.mark.parametrize("where", [
    "NaN in a valid row", "NaN in an invalid row", "NaN in a valid entry",
    "NaN in an invalid entry", "+inf in a row", "-inf in an entry",
    "the same inf in a row and an entry", "opposite infs in a row and an entry"])
def test_pooled_hinge_nonfinite_like_plain(cuda, where, D, use_pix):
    case = _f5_case(cuda, where, D)
    (loss, hard, gda, gdb), (ploss, phard, pgda, pgdb) = _kernel_and_plain(case, use_pix)
    assert torch.equal(hard, phard)
    assert torch.equal(torch.isnan(loss), torch.isnan(ploss))
    assert torch.isnan(ploss).any() == (where.startswith("NaN") or where.startswith("the same"))
    f = torch.isfinite(ploss)
    torch.testing.assert_close(loss[f], ploss[f], rtol=1e-5, atol=0)
    assert torch.isnan(pgda).any() and torch.isnan(pgdb).any()
    for got, want in ((gda, pgda), (gdb, pgdb)):
        _assert_like_plain(got, want, 1e-5)


def test_pooled_hinge_is_deterministic(cuda):
    case = _hinge_case(cuda, 4, 3000, 1024, 3, seed=7)
    a, _ = _kernel_and_plain(case, True)
    b, _ = _kernel_and_plain(case, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pooled_hinge_raises_instead_of_falling_back(cuda, monkeypatch):
    case = _hinge_case(cuda, 1, 10, 10, 3, seed=8)
    with pytest.raises(TypeError):
        ph.pooled_hinge(case[0].double(), *case[1:], 0.5, False, 50.0)

    def no_library():
        raise RuntimeError("no library")
    monkeypatch.setattr(ph, "_library", no_library)
    with pytest.raises(RuntimeError, match="no library"):
        ph.pooled_hinge(*case, 0.5, False, 50.0)


def test_train_step_runs_the_pooled_hinge_kernels(cuda):
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.resnet import ResNet18_8s, init_weights_
    from pdc_tpu_torch.training.train import create_train_state, make_train_step

    scene = SyntheticScene(width=64, height=48, num_frames=4)
    rgb, depth, mask, poses = scene.render_all()
    ia, ib = np.array([0, 1]), np.array([2, 3])
    batch = dict(rgb_a=rgb[ia], depth_a=depth[ia], mask_a=mask[ia], pose_a=poses[ia],
                 rgb_b=rgb[ib], depth_b=depth[ib], mask_b=mask[ib], pose_b=poses[ib],
                 K=np.stack([scene.K] * 2), match_type=np.zeros(2, np.int32))
    tc = {"training": {"learning_rate": 1e-4, "learning_rate_decay": 0.9,
                       "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}
    state = create_train_state(init_weights_(ResNet18_8s(3), torch.Generator().manual_seed(0)),
                               tc)  # default device: cuda
    step = make_train_step(tc, LossConfig(), AssemblerConfig(
        num_matching_attempts=500, masked_pool_size=128, background_pool_size=128,
        num_blind_samples=200), 64)
    g = torch.Generator(device=cuda).manual_seed(0)
    f0, b0 = ph.forward_launches, ph.backward_launches
    losses = [float(step(state, batch, g)["loss"]) for _ in range(3)]
    assert (ph.forward_launches - f0, ph.backward_launches - b0) == (6, 6)
    assert np.isfinite(losses).all() and state.step == 3


def _synthetic_cache(device, mix=None):
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.data.device_cache import DeviceCache

    ds = SpartanDataset.make_synthetic(num_scenes=4, num_objects=2, width=64, height=48,
                                       num_frames=6)
    if mix is not None:
        ds._data_type_probabilities = mix
    return DeviceCache.from_dataset(ds, device=device)


def test_device_sampler_on_the_card_keeps_its_invariants(cuda):
    """The CPU test's invariants (tests/test_torch_port_device_cache.py) on a
    CUDA generator: within-scene rows in one scene with poses apart or empty,
    across-scene rows one object in two scenes, different-object rows two
    objects, a synthetic multi-object row's second pair another object's."""
    from pdc_tpu_torch.training import scanned

    cache = _synthetic_cache(cuda)
    tables = scanned.build_sampling_tables(cache)
    assert all(t.device.type == "cuda" for t in tables.values())
    poses = torch.as_tensor(cache.poses, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    probs = ((0, 0.4), (1, 0.2), (2, 0.2), (4, 0.2))
    out = scanned.device_sample_pairs_mixed(g, tables, poses, 4096, probs, with_second=True)
    assert all(x.device.type == "cuda" for x in out)
    fa, fb, fa2, fb2, mt = [x.cpu().numpy() for x in out]
    names = sorted(cache.scene_offsets)
    starts = np.array([cache.scene_offsets[n] for n in names])
    scene_of = np.searchsorted(starts, np.arange(len(cache.poses)), side="right") - 1
    obj = np.array([cache.dataset.scenes[names[s]].object_id for s in scene_of])
    P = torch.from_numpy(cache.poses)
    ok = scanned._pose_ok(P[fa], P[fb][:, None])[:, 0].numpy()
    for t in (0, 4):
        rows = mt == t
        assert rows.any() and (scene_of[fa[rows]] == scene_of[fb[rows]]).all() and ok[rows].all()
    assert ((mt != -1) | (fa == fb)).all()
    for t, frac in ((0, 0.4), (1, 0.2), (2, 0.2), (4, 0.2)):
        assert abs((mt == t).mean() + (t == 0) * (mt == -1).mean() - frac) < 0.05, t
    assert (obj[fa[mt == 1]] == obj[fb[mt == 1]]).all()
    assert (scene_of[fa[mt == 1]] != scene_of[fb[mt == 1]]).all()
    assert (obj[fa[mt == 2]] != obj[fb[mt == 2]]).all()
    smo = mt == 4
    assert (scene_of[fa2[smo]] == scene_of[fb2[smo]]).all()
    assert (obj[fa2[smo]] != obj[fa[smo]]).all()


def test_device_cache_on_the_card_gathers_what_the_cpu_cache_gathers(cuda):
    mix = {0: 0.5, 1: 0.25, 2: 0.25}
    on_card, on_cpu = _synthetic_cache(cuda, mix), _synthetic_cache("cpu", mix)
    assert on_card.depth.dtype == torch.uint16 and on_card.depth.device.type == "cuda"
    for name in ("rgb", "depth", "mask", "pixel_perm", "mask_count"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name)), name
    for _ in range(3):
        a, b = on_card.sample_index_batch(4), on_cpu.sample_index_batch(4)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        ga, gb = on_card.gather(a), on_cpu.gather(b)
        assert sorted(ga) == sorted(gb)
        for k in ga:
            assert ga[k].device.type == "cuda" and torch.equal(ga[k].cpu(), gb[k]), k


def test_training_driver_runs_three_iterations_on_the_card(cuda, tmp_path):
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.training.train import ROUTE_DEVICE_SAMPLER, DenseCorrespondenceTraining

    cfg = DenseCorrespondenceTraining.load_default_config()  # the port's reader without yaml
    cfg["training"].update(num_iterations=3, batch_size=2, num_matching_attempts=500,
                           masked_pool_size=128, background_pool_size=128,
                           num_blind_samples=200, use_tensorboard=False, save_rate=1000,
                           logging_dir=str(tmp_path), logging_dir_name="card")
    net = cfg["dense_correspondence_network"]
    net.update(image_width=64, image_height=48)
    net["backbone"]["resnet_name"] = "Resnet18_8s"
    ds = SpartanDataset.make_synthetic(num_scenes=2, width=64, height=48, num_frames=6)
    trainer = DenseCorrespondenceTraining(cfg, ds)  # default device: cuda
    f0, b0 = ph.forward_launches, ph.backward_launches
    folder = trainer.run()
    assert trainer.route == ROUTE_DEVICE_SAMPLER
    assert (ph.forward_launches - f0, ph.backward_launches - b0) == (6, 6)
    assert np.isfinite(trainer._logging_dict["train"]["loss"]).all()
    assert trainer.state.step == 3
    assert {"000000.ckpt", "000003.ckpt", "000003.ckpt.opt"} <= set(os.listdir(folder))
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder)
    frame = ds.scenes["scene_000"].rgb[0]
    assert torch.allclose(dcn.forward_on_img(frame), trainer.get_dcn().forward_on_img(frame),
                          atol=1e-6, rtol=0)


# -- the per-pair loss and synthetic multi-object samples ------------------------------------


def _smo_dataset():
    from pdc_tpu_torch.data.dataset import SpartanDataset

    ds = SpartanDataset.make_synthetic(num_scenes=4, num_objects=2, width=64, height=48,
                                       num_frames=6)
    ds._data_type_probabilities = {0: 0.4, 2: 0.2, 4: 0.4}
    ds.reset_seed(3)
    return ds


def test_smo_matrix_step_with_the_kernels_equals_the_plain_hinge(cuda):
    """A batch with synthetic multi-object rows on the matrix route: one
    step with K1/K2 (2 launches each) and one with the plain pooled hinge,
    on the same assembled batch and weights: loss rtol 1e-5, gradients
    relative L2 1e-4 (chip_smoke.py phase 10's bars)."""
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.resnet import ResNet18_8s, init_weights_
    from pdc_tpu_torch.training.train import create_train_state, make_train_step

    tc = {"training": {"learning_rate": 1e-4, "learning_rate_decay": 0.9,
                       "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}
    cfg = AssemblerConfig(num_matching_attempts=500, masked_pool_size=128,
                          background_pool_size=128, num_blind_samples=200,
                          enable_synthetic_multi_object=True)

    def state():
        return create_train_state(init_weights_(ResNet18_8s(3), torch.Generator().manual_seed(0)),
                                  tc)

    step = make_train_step(tc, LossConfig(), cfg, 64)
    batch = _smo_dataset().make_host_batch(6)
    assert (batch["match_type"] == 4).any()
    s_k, s_p = state(), state()
    assembled = step.assemble(s_k, batch, torch.Generator(device=cuda).manual_seed(0))
    assert not assembled[2].blind_nm_valid[assembled[2].match_type == 4].any()
    f0, b0 = ph.forward_launches, ph.backward_launches
    m_k = step.update(s_k, *assembled)
    assert (ph.forward_launches - f0, ph.backward_launches - b0) == (2, 2)
    m_p = make_train_step(tc, LossConfig(), cfg, 64,
                          hinge=ph.pooled_hinge_reference).update(s_p, *assembled)
    assert abs(float(m_k["loss"]) - float(m_p["loss"])) <= 1e-5 * abs(float(m_p["loss"]))
    num = den = 0.0
    plain = dict(s_p.module.named_parameters())
    for name, p in s_k.module.named_parameters():
        num += float(((p.grad - plain[name].grad) ** 2).sum())
        den += float((plain[name].grad ** 2).sum())
    assert (num / den) ** 0.5 <= 1e-4


def test_per_pair_terms_on_the_card_equal_the_cpu(cuda):
    """The per-pair route on the card: a step launches no K1/K2 and its
    loss is finite; compose_loss on the card equals the CPU's on the same
    predictions and indices (terms rtol 1e-5, gradients relative L2 1e-4:
    index_add's atomics order the sums differently)."""
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.losses.composer import compose_loss
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.resnet import ResNet18_8s, init_weights_
    from pdc_tpu_torch.training.train import create_train_state, make_train_step

    tc = {"training": {"learning_rate": 1e-4, "learning_rate_decay": 0.9,
                       "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}
    cfg = AssemblerConfig(num_matching_attempts=500, num_masked_non_matches_per_match=20,
                          num_background_non_matches_per_match=20, num_blind_samples=200,
                          enable_synthetic_multi_object=True, use_matrix_loss=False)
    state = create_train_state(init_weights_(ResNet18_8s(3), torch.Generator().manual_seed(0)),
                               tc)
    step = make_train_step(tc, LossConfig(), cfg, 64)
    batch = _smo_dataset().make_host_batch(6)
    assert (batch["match_type"] == 4).any()
    g = torch.Generator(device=cuda).manual_seed(1)
    f0, b0 = ph.forward_launches, ph.backward_launches
    assert np.isfinite(float(step(state, batch, g)["loss"]))
    assert (ph.forward_launches - f0, ph.backward_launches - b0) == (0, 0)
    _, _, idx = step.assemble(state, batch, g)
    pred = torch.randn(12, 48 * 64, 3, generator=torch.Generator().manual_seed(2)) * 0.3
    w = torch.linspace(0.5, 1.5, 6)

    def run(pred, indices):
        pa, pb = pred[:6].clone().requires_grad_(), pred[6:].clone().requires_grad_()
        terms = compose_loss(pa, pb, indices, LossConfig(), 64)
        (terms.loss * w.to(pred.device)).sum().backward()
        return terms, pa.grad, pb.grad

    card = run(pred.to(cuda), idx)
    cpu = run(pred, type(idx)(*[x.cpu() for x in idx]))
    for a, b in zip(card[0], cpu[0]):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(card[1:], cpu[1:]):
        assert float((a.cpu() - b).norm() / b.norm()) <= 1e-4


# -- the on-disk slice: the PNG codecs and ``python -m pdc_tpu_torch train`` ---------------


def test_libpng_pool_builds_or_its_absence_is_reported(cuda, tmp_path):
    from pdc_tpu_torch.data import native_loader as nl

    ok, why = nl.probe_libpng()
    print(f"libpng probe: {ok} ({why})")
    if not ok:
        pytest.skip(f"no libpng pool on this machine: {why}")
    path = str(tmp_path / "x.png")
    arr = np.arange(48 * 64 * 3, dtype=np.uint8).reshape(48, 64, 3)
    nl.encode_batch([(path, nl.KIND_ENC_RGB8, arr)], 48, 64, decoder="libpng")
    out = np.zeros_like(arr)
    nl.decode_batch([(path, nl.KIND_RGB8, out)], 48, 64, decoder="libpng")
    np.testing.assert_array_equal(out, arr)


def test_auto_decoder_picks_what_the_probe_says(cuda, monkeypatch):
    from pdc_tpu_torch.data import native_loader as nl

    monkeypatch.setattr(nl, "decoder_chosen", None)
    ok, _ = nl.probe_libpng()
    assert nl.resolve_decoder("auto") == ("libpng" if ok else "zlib") == nl.decoder_chosen


def test_scene_round_trips_bit_for_bit_at_640x480(cuda, tmp_path):
    from pdc_tpu_torch.data import native_loader as nl
    from pdc_tpu_torch.data.dataset import SceneData
    from pdc_tpu_torch.data.scene import SceneStructure
    from pdc_tpu_torch.data.synthetic import SyntheticScene

    sc = SyntheticScene(width=640, height=480, num_frames=3, seed=1,
                        occluder=(0.05, 0.25, -0.1, 0.1, 0.15))
    st = SceneStructure(sc.write_scene(str(tmp_path / "scene")))
    rgb, depth, mask, poses = sc.render_all()
    got = SceneData.from_structure(st, "scene")
    for a, b in ((got.rgb, rgb), (got.depth, depth), (got.mask, mask)):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got.poses - poses).max() <= 1e-9
    for dec in ["zlib"] + (["libpng"] if nl.probe_libpng()[0] else []):
        frames = nl.load_scene_frames(st, [0, 1, 2], 480, 640, decoder=dec)
        for a, b in zip(frames, (rgb, depth, mask)):
            np.testing.assert_array_equal(a, b)


def test_cli_trains_two_iterations_from_disk_on_the_card(cuda, tmp_path):
    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.training.train import DenseCorrespondenceTraining
    from pdc_tpu_torch.utils.yaml_io import load_yaml, save_yaml

    for i in range(2):
        SyntheticScene(width=64, height=48, num_frames=6, seed=i).write_scene(
            str(tmp_path / "logs_proto" / f"scene_{i}"))
    save_yaml({"object_id": "disc", "train": ["scene_0", "scene_1"], "test": ["scene_1"]},
              str(tmp_path / "config" / "disc.yaml"))
    composite = str(tmp_path / "config" / "composite.yaml")
    save_yaml({"logs_root_path": "logs_proto", "single_object_scenes_config_files": ["disc.yaml"]},
              composite)
    cfg = DenseCorrespondenceTraining.load_default_config()
    cfg["training"].update(batch_size=2, num_matching_attempts=500, masked_pool_size=128,
                           background_pool_size=128, num_blind_samples=200,
                           use_tensorboard=False, save_rate=1000)
    net = cfg["dense_correspondence_network"]
    net.update(image_width=64, image_height=48)
    net["backbone"]["resnet_name"] = "Resnet18_8s"
    cfg_file = str(tmp_path / "training.yaml")
    save_yaml(cfg, cfg_file)
    f0, b0 = ph.forward_launches, ph.backward_launches
    assert cli.main(["train", "--config", cfg_file, "--dataset_config", composite, "--data_dir",
                     str(tmp_path), "--name", "card", "--logging_dir", str(tmp_path / "models"),
                     "--num_iterations", "2"]) == 0  # default device: cuda
    assert (ph.forward_launches - f0, ph.backward_launches - b0) == (4, 4)
    history = load_yaml(str(tmp_path / "models" / "card" / "000002_log_history.yaml"))
    assert history["train"]["iteration"] == [1, 2]
    assert np.isfinite(history["train"]["loss"]).all()


# -- evaluation: the sweep's K3 route and ``python -m pdc_tpu_torch evaluate`` -------------


def test_kernel_at_the_sweep_shape_b16_q100(cuda):
    """K3 at the evaluation sweep's shape: 16 pairs' 640x480 images, 100
    queries each, half of them exact matches."""
    g = np.random.default_rng(16)
    B, Q, HW = 16, 100, 307200
    res = torch.as_tensor(g.standard_normal((B, 3, HW), dtype=np.float32), device=cuda)
    q = torch.as_tensor(g.standard_normal((B, Q, 3), dtype=np.float32), device=cuda)
    px = torch.as_tensor(g.integers(0, HW, (B, Q // 2)), device=cuda)
    q[:, : Q // 2] = torch.gather(res, 2, px[:, None, :].expand(-1, 3, -1)).transpose(1, 2)
    before = bm.launches
    idx, dist = bm.best_match(res, q.contiguous())
    torch.cuda.synchronize()
    assert bm.launches == before + 1
    _check(res, q, idx, dist)
    assert float(dist[:, : Q // 2].max()) == 0.0
    assert float((dist - bm.best_match_reference(res, q.contiguous())[1]).abs().max()) <= 1e-4


def _eval_setup(width=160, height=120):
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    ds = SpartanDataset.make_synthetic(num_scenes=2, num_objects=2, width=width, height=height,
                                       num_frames=6, object_radius=0.3)
    dcn = DenseCorrespondenceNetwork.from_config(
        {"descriptor_dimension": 3, "image_width": width, "image_height": height,
         "backbone": {"model_class": "Resnet", "resnet_name": "Resnet34_8s"}},
        generator=torch.Generator().manual_seed(3))
    return ds, dcn


def test_sweep_k3_route_matches_the_plain_route(cuda, monkeypatch):
    """The fused sweep's statistics with K3 against the same with the plain
    best match: equal picks or float64 near-ties (1e-5 in squared
    distance), every other value within 1e-5; and one launch per chunk."""
    from pdc_tpu_torch.evaluation import evaluate as ev

    ds, dcn = _eval_setup()
    pairs = ev.image_pair_list(ds, 20, seed=1)
    images = ev.DenseCorrespondenceEvaluation.compute_descriptor_images_batched(
        dcn, ds, [(s, i) for s, a, b, _ in pairs for i in (a, b)])
    chunk = pairs[:ev.SWEEP_PAIR_CHUNK]
    frames = ev._chunk_frames(ds, chunk, cuda)
    uv_a, uv_b, valid = ev._sweep_correspondences(frames, [p[3] for p in chunk], 100, 2000)
    res_a = torch.stack([images[(s, a)] for s, a, _, _ in chunk])
    res_b = torch.stack([images[(s, b)] for s, _, b, _ in chunk])
    before = bm.launches
    k3 = ev._sweep_statistics(frames, uv_a, uv_b, res_a, res_b)
    assert bm.launches == before + 1
    monkeypatch.setattr(ev, "best_match", bm.best_match_reference)
    plain = ev._sweep_statistics(frames, uv_a, uv_b, res_a, res_b)
    B, Hh, Ww, Dd = res_a.shape
    same = (k3["uv_b_pred"] == plain["uv_b_pred"]).all(-1)
    q = torch.gather(res_a.reshape(B, -1, Dd), 1, (uv_a[..., 1] * Ww + uv_a[..., 0])[..., None]
                     .expand(-1, -1, Dd)).double()
    rb = res_b.reshape(B, -1, Dd).double()

    def d2(uv):
        flat = (uv[..., 1] * Ww + uv[..., 0])[..., None].expand(-1, -1, Dd)
        return ((torch.gather(rb, 1, flat) - q) ** 2).sum(-1)

    assert float((d2(k3["uv_b_pred"]) - d2(plain["uv_b_pred"])).abs().max()) <= 1e-5
    for k in plain:
        m = same if k in ("uv_b_pred", "pixel_match_error_l2", "pixel_match_error_l1",
                          "norm_diff_pred_3d", "is_valid") else torch.ones_like(same)
        x, y = k3[k][m].double(), plain[k][m].double()
        assert torch.equal(torch.isnan(x), torch.isnan(y)), k
        assert float((x - y)[~torch.isnan(x)].abs().max()) <= 1e-5, k
    monkeypatch.undo()
    # the whole sweep: one launch per chunk of 16 pairs
    before = bm.launches
    t = ev.DenseCorrespondenceEvaluation.evaluate_network_quantitative(
        dcn, ds, num_image_pairs=20, num_matches_per_image_pair=100)
    assert bm.launches - before == -(-len(pairs) // ev.SWEEP_PAIR_CHUNK)
    assert len(t) > 0 and np.isfinite(t["norm_diff_descriptor"]).all()


def test_cli_evaluates_a_model_folder_on_the_card(cuda, tmp_path):
    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.evaluation.table import read_csv
    from pdc_tpu_torch.models.checkpoint import write_checkpoint
    from pdc_tpu_torch.models.convert import state_dict_to_flax
    from pdc_tpu_torch.training.train import DenseCorrespondenceTraining
    from pdc_tpu_torch.utils.yaml_io import save_yaml

    ds, dcn = _eval_setup(64, 48)
    folder = tmp_path / "net"
    folder.mkdir()
    cfg = DenseCorrespondenceTraining.load_default_config()
    cfg["dense_correspondence_network"] = dict(dcn.config)
    save_yaml(cfg, str(folder / "training.yaml"))
    save_yaml(ds.config_snapshot(), str(folder / "dataset.yaml"))
    write_checkpoint(state_dict_to_flax(dcn.module.state_dict()), str(folder / "000000.ckpt"))
    before = bm.launches
    assert cli.main(["evaluate", "--model_folder", str(folder), "--num_image_pairs", "6",
                     "--num_matches_per_image_pair", "50", "--no_qualitative"]) == 0
    assert bm.launches - before == 2  # one chunk a split
    for mode in ("train", "test"):
        t = read_csv(str(folder / "analysis" / mode / "data.csv"))
        assert len(t.columns) == 23 and len(t) > 0
    assert (folder / "descriptor_statistics.yaml").exists()
    assert (folder / "analysis" / "across_object" / "data.csv").exists()


def test_trained_tpu_journey_pck_on_the_card(cuda):
    """trained_models/tpu_journey on its test split at 50 pairs x 100
    matches, seed 1, fp32 on the card: PCK@5 and PCK@10 within the band of
    the committed bf16 summary (3 standard deviations of the PCK over the
    pairs, plus 0.05 for the dtype), as the CPU anchor test holds them."""
    import json

    from pdc_tpu_torch.evaluation import evaluate as ev
    from pdc_tpu_torch.evaluation.plotting import cdf_at_threshold
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = os.path.join(root, "trained_models", "tpu_journey")
    summary = os.path.join(root, "trained_models", "quantized_serving", "summary.json")
    if not (os.path.exists(os.path.join(folder, "003500.ckpt")) and os.path.exists(summary)):
        pytest.skip("trained_models/tpu_journey/003500.ckpt is not in this copy of the tree")
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder)
    ds = ev.DenseCorrespondenceEvaluation.load_dataset_from_model_folder(folder)
    ds.set_test_mode()
    t = ev.DenseCorrespondenceEvaluation.evaluate_network_quantitative(
        dcn, ds, num_image_pairs=50, num_matches_per_image_pair=100, seed=1)
    with open(summary) as f:
        bf16 = json.load(f)["results"]["bf16"]
    px = t["pixel_match_error_l2"]
    keys = [f"{s}/{a}/{b}" for s, a, b in zip(t["scene_name"], t["img_a_idx"], t["img_b_idx"])]
    for k in (5, 10):
        per_pair = [float(np.mean(px[[x == key for x in keys]] <= k)) for key in
                    dict.fromkeys(keys)]
        margin = 3 * float(np.std(per_pair, ddof=1)) / np.sqrt(len(per_pair))
        pck = cdf_at_threshold(px, k)
        print(f"tpu_journey on the card: PCK@{k} {pck:.4f} (bf16 summary "
              f"{bf16[f'pck@{k}px']}, margin {margin:.4f} + 0.05)")
        assert abs(pck - bf16[f"pck@{k}px"]) <= margin + 0.05



# the fp32 anchor of trained_models/tpu_journey on the card and the CPU (PR 11):
# PCK@5 and PCK@10 at 50 pairs x 100 matches, seed 1, and their margins (3
# standard deviations of the per-pair PCK over sqrt(pairs))
TPU_JOURNEY_FP32 = {5: (0.3484, 0.072), 10: (0.6364, 0.081)}


def test_trained_tpu_journey_bf16_pck_on_the_card(cuda):
    """trained_models/tpu_journey served in bfloat16
    (``from_model_folder(dtype=torch.bfloat16)``) on its test split at 50
    pairs x 100 matches, seed 1: PCK@5 and PCK@10 within the fp32 anchor's
    margins of its values."""
    from pdc_tpu_torch.evaluation import evaluate as ev
    from pdc_tpu_torch.evaluation.plotting import cdf_at_threshold
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = os.path.join(root, "trained_models", "tpu_journey")
    if not os.path.exists(os.path.join(folder, "003500.ckpt")):
        pytest.skip("trained_models/tpu_journey/003500.ckpt is not in this copy of the tree")
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, dtype=torch.bfloat16)
    assert dcn.forward_on_img(np.zeros((480, 640, 3), np.uint8)).dtype == torch.bfloat16
    ds = ev.DenseCorrespondenceEvaluation.load_dataset_from_model_folder(folder)
    ds.set_test_mode()
    t = ev.DenseCorrespondenceEvaluation.evaluate_network_quantitative(
        dcn, ds, num_image_pairs=50, num_matches_per_image_pair=100, seed=1)
    for k, (anchor, margin) in TPU_JOURNEY_FP32.items():
        pck = cdf_at_threshold(t["pixel_match_error_l2"], k)
        print(f"tpu_journey bf16 on the card: PCK@{k} {pck:.4f} (fp32 anchor {anchor}, "
              f"margin {margin})")
        assert abs(pck - anchor) <= margin

# -- the apps: grasp stream, heatmap engine, export -------------------------------------------

def _apps_setup(width=160, height=120):
    """A ResNet-34-8s on the card, its twin on the CPU (same weights), and
    a synthetic scene."""
    import copy

    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    cfg = {"descriptor_dimension": 3, "image_width": width, "image_height": height,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet34_8s"}}
    dcn = DenseCorrespondenceNetwork.from_config(cfg, generator=torch.Generator().manual_seed(4))
    cpu = DenseCorrespondenceNetwork(copy.deepcopy(dcn.module).cpu(), 3, width, height,
                                     config=cfg, device="cpu")
    scene = SyntheticScene(width=width, height=height, num_frames=4, object_radius=0.3)
    return dcn, cpu, scene.render_all()


def test_grasp_stream_on_the_card_equals_the_cpu(cuda):
    """One K3 launch per frame; picks equal to the CPU stream's or float64
    near-ties (1e-5 in squared distance) on the card's descriptor image,
    distances within 1e-5 of float64."""
    from pdc_tpu_torch.apps.live_heatmap_visualization import GraspPointStream

    dcn, cpu, (rgb, _, mask, _) = _apps_setup()
    res0 = dcn.forward_on_img(rgb[0])
    obj = np.argwhere(mask[0] > 0)[::11][:16]
    q = res0[torch.as_tensor(obj[:, 0]), torch.as_tensor(obj[:, 1])].cpu().numpy()
    stream, cpu_stream = GraspPointStream(dcn, q), GraspPointStream(cpu, q)
    for f in range(len(rgb)):
        before = bm.launches
        uv, dist = stream.process_frame(rgb[f])
        assert bm.launches == before + 1
        cuv, cdist = cpu_stream.process_frame(rgb[f])
        res = dcn.forward_on_img(rgb[f]).permute(2, 0, 1).reshape(1, 3, -1).contiguous()
        qt = torch.as_tensor(q, device=cuda)[None]
        _check(res, qt, torch.as_tensor(uv[:, 1] * 160 + uv[:, 0], device=cuda)[None],
               torch.as_tensor(dist, device=cuda)[None])
        d2 = bm.squared_distances(res.double(), qt.double())[0].cpu().numpy()
        pick, cpick = uv[:, 1] * 160 + uv[:, 0], cuv[:, 1] * 160 + cuv[:, 0]
        rows = np.arange(len(q))
        assert np.all(np.abs(d2[rows, pick] - d2[rows, cpick]) <= 1e-5)
        assert np.abs(dist - np.sqrt(d2.min(1))).max() <= 1e-5
        assert np.abs(dist - cdist).max() <= 1e-4
        if f == 0:
            assert dist.max() <= 1e-5


def test_heatmap_engine_on_the_card_equals_float64(cuda):
    from pdc_tpu_torch.apps.live_heatmap_visualization import HeatmapEngine

    dcn, _, (rgb, _, _, _) = _apps_setup()
    eng = HeatmapEngine([dcn], variance=0.25)
    eng.set_images(rgb[0], rgb[2])
    res_a = dcn.forward_on_img(rgb[0]).double().cpu().numpy()
    res_b = dcn.forward_on_img(rgb[2]).double().cpu().numpy()
    for u, v in ((10, 10), (80, 60), (159, 119)):
        (uv, diff, heat), = eng.find_best_match(u, v)
        nd = np.sqrt(((res_b - res_a[v, u]) ** 2).sum(-1))
        assert heat.shape == (120, 160)
        assert np.abs(heat - np.exp(-nd / 0.25)).max() <= 1e-6
        assert nd[uv[1], uv[0]] ** 2 - nd.min() ** 2 <= 1e-5
        assert abs(diff - nd[uv[1], uv[0]]) <= 1e-5


def test_export_and_load_on_the_card(cuda, tmp_path):
    from pdc_tpu_torch.apps.export_serving import export_inference, load_exported, save_exported

    dcn, _, (rgb, _, _, _) = _apps_setup()
    path = str(tmp_path / "net.pt2")
    assert save_exported(export_inference(dcn, batch_size=4), path) > 1e6
    x = torch.as_tensor(rgb, device=cuda)
    with torch.inference_mode():
        first = load_exported(path).module()(x)
        second = load_exported(path).module()(x)
    assert first.device.type == "cuda" and first.shape == (4, 120, 160, 3)
    live = dcn.forward_on_images(rgb)
    assert float((first - live).abs().max()) <= 1e-4 * float(live.abs().max())
    assert float((second - first).abs().max()) <= 1e-6


# -- int8 serving: the integer product and the trained model's PCK ---------------------------


@pytest.mark.parametrize("B,C,h,w,O,k,s,p,d", [
    (2, 3, 48, 64, 64, 7, 2, 3, 1), (1, 128, 30, 40, 256, 3, 1, 2, 2),
    (2, 64, 30, 40, 128, 1, 2, 0, 1), (1, 512, 30, 40, 3, 1, 1, 0, 1),
    (1, 1024, 8, 10, 512, 3, 1, 1, 1), (1, 5, 3, 4, 7, 3, 1, 1, 1),
    (3, 9, 2, 2, 17, 3, 2, 1, 1), (1, 13, 2, 3, 3, 1, 1, 0, 1)])
def test_int8_conv_int_mm_equals_plain_on_the_card(cuda, B, C, h, w, O, k, s, p, d):
    """The torch._int_mm route against the float64 plain version, int32 bit
    for bit, one counted launch per call (the stem's K=147, a dilated 3x3,
    a strided 1x1, the head's N=3, the UNet's up3 K=9216, M <= 16 and K, N
    not multiples of 8)."""
    from pdc_tpu_torch.ops import int8_conv as ic

    g = torch.Generator(device=cuda).manual_seed(B + C + O + k)
    x = torch.randint(-127, 128, (B, C, h, w), device=cuda, dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, (O, C, k, k), device=cuda, dtype=torch.int8, generator=g)
    before = ic.launches
    got = ic.int8_conv2d(x, wq, s, p, d)
    assert ic.launches == before + 1
    assert torch.equal(got, ic.int8_conv2d_reference(x, wq, s, p, d))
    assert torch.equal(got.cpu(), ic.int8_conv2d_reference(x.cpu(), wq.cpu(), s, p, d))


def test_trained_tpu_journey_int8_pck_on_the_card(cuda):
    """trained_models/tpu_journey on its test split at 50 pairs x 100
    matches, seed 1, with the int8 and int8-static clones on the card
    (static scales from 16 train frames, seed 7, batches of 8): PCK@5 and
    PCK@10 within the band of the committed int8 / int8_static rows of
    trained_models/quantized_serving/summary.json (3 standard deviations of
    the PCK over the pairs, plus 0.05), as
    test_trained_tpu_journey_pck_on_the_card holds the fp32 run."""
    import json

    from pdc_tpu_torch.evaluation import evaluate as ev
    from pdc_tpu_torch.evaluation.plotting import cdf_at_threshold
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = os.path.join(root, "trained_models", "tpu_journey")
    summary = os.path.join(root, "trained_models", "quantized_serving", "summary.json")
    if not (os.path.exists(os.path.join(folder, "003500.ckpt")) and os.path.exists(summary)):
        pytest.skip("trained_models/tpu_journey/003500.ckpt is not in this copy of the tree")
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder)
    train = dcn.load_training_dataset("train")
    train.reset_seed(7)
    calib = [train.get_random_rgbd_mask_pose()[0] for _ in range(16)]
    clones = {"int8": dcn.quantized(), "int8_static": dcn.calibrate_quantization(calib, 8)}
    ds = ev.DenseCorrespondenceEvaluation.load_dataset_from_model_folder(folder)
    ds.set_test_mode()
    with open(summary) as f:
        rows = json.load(f)["results"]
    for label, clone in clones.items():
        t = ev.DenseCorrespondenceEvaluation.evaluate_network_quantitative(
            clone, ds, num_image_pairs=50, num_matches_per_image_pair=100, seed=1)
        px = t["pixel_match_error_l2"]
        keys = [f"{s}/{a}/{b}" for s, a, b in zip(t["scene_name"], t["img_a_idx"],
                                                  t["img_b_idx"])]
        for k in (5, 10):
            per_pair = [float(np.mean(px[[x == key for x in keys]] <= k)) for key in
                        dict.fromkeys(keys)]
            margin = 3 * float(np.std(per_pair, ddof=1)) / np.sqrt(len(per_pair))
            pck = cdf_at_threshold(px, k)
            print(f"tpu_journey {label} on the card: PCK@{k} {pck:.4f} (summary "
                  f"{rows[label][f'pck@{k}px']}, margin {margin:.4f} + 0.05)")
            assert abs(pck - rows[label][f"pck@{k}px"]) <= margin + 0.05


# -- the experiment runner, and bf16 on the card against bf16 on the CPU ---------------------


def test_smoke_experiment_on_the_card_runs_k1_k2_and_k3(cuda, tmp_path):
    """``experiment caterpillar --smoke --run_filter 0.500`` (64x48,
    ResNet-34-8s, 4 steps of B=2) on the card: K1 and K2 launch twice per
    step, K3 once for the network's sweep (one chunk of 2 pairs), and the
    statistics are PCKs in [0, 1] with a finite area."""
    import json
    import math

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.experiments import runner

    f0, b0, k0 = ph.forward_launches, ph.backward_launches, bm.launches
    assert cli.main(["experiment", "caterpillar", "--smoke", "--run_filter", "0.500",
                     "--logging_dir", str(tmp_path)]) == 0  # default device: cuda
    assert (ph.forward_launches - f0, ph.backward_launches - b0, bm.launches - k0) == (8, 8, 1)
    result = json.load(open(tmp_path / "result.json"))
    (info,) = result["networks"].values()
    assert set(info["test"]) == set(runner._STAT_KEYS)
    assert all(0.0 <= info["test"][k] <= 1.0 for k in ("pck_at_5px", "pck_at_10px"))
    assert math.isfinite(info["test"]["norm_diff_3d_area_above_curve"])
    assert os.path.exists(tmp_path / "caterpillar_M_background_0.500_3" / "000004.ckpt")


# The card's bf16 against the CPU port's bf16, on the same weights and batch,
# by the ratio of card-against-CPU to bf16-against-fp32 (the CPU's). Where the
# two still share their roundings the ratio is held at the bars
# tests/test_torch_port_compute_dtype.py uses against flax: one 3x3
# convolution at the single-block bar (read 0.008-0.012 on an H100, 0.02-0.03%
# of its outputs differing), the stem and stage 1 at the whole-network bar
# (read 0.000 and 0.089-0.339). Deeper the two accumulation orders decorrelate:
# stage 3 reads 0.89-1.05 and the whole network 0.83-1.00 over seeds 0-2, and
# native CUDA convolutions (cuDNN off) 0.84-1.01, so there the card is held by
# its distance to fp32, at most 1.25 x the CPU's bf16's (read 0.91-1.00 on the
# forward, 0.95-1.03 on the gradients).
BF16_RATIO_BAR = 0.75
BF16_CONV_BAR = 0.1  # tests/test_torch_port_compute_dtype.py's bar for single blocks
BF16_TO_FP32_BAR = 1.25


def _rel(a, b):
    """Relative RMS difference of two lists of tensors, against ``b``."""
    num = sum(float(((x.double().cpu() - y.double().cpu()) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y.double().cpu() ** 2).sum()) for y in b)
    return (num / den) ** 0.5


def _forward_by_stage(module, x):
    """{stage: output} of a ResNetFCN in eval mode: the stem, each stage's
    last block and the network's output, as float32 on the CPU."""
    outs = {}
    hooks = [module.stem_bn.register_forward_hook(lambda m, i, o: outs.__setitem__("stem", o))]
    for s, names in enumerate(module.stage_blocks):
        hooks.append(getattr(module, names[-1]).register_forward_hook(
            lambda m, i, o, s=s: outs.__setitem__(f"stage{s + 1}", o)))
    module.eval()
    try:
        with torch.no_grad():
            outs["out"] = module(x.to(next(module.parameters()).device))
    finally:
        module.train()
        for h in hooks:
            h.remove()
    return {k: v.float().cpu() for k, v in outs.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_forward_and_step_on_the_card_against_bf16_on_the_cpu(cuda, seed):
    """ResNet-34-8s at 64x48 with ``compute_dtype: bfloat16``, on the same
    weights and batch on the card and on the CPU: the eval-mode forward (B=2)
    and one bf16 train step's gradients (through K1/K2 on the card), held as
    the comment on BF16_RATIO_BAR says; the whole-network ratios are
    printed."""
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.dcn import build_backbone
    from pdc_tpu_torch.models.resnet import init_weights_
    from pdc_tpu_torch.training.train import create_train_state, make_train_step

    W, H = 64, 48

    def module(dtype):
        cfg = {"descriptor_dimension": 3, "compute_dtype": dtype,
               "backbone": {"model_class": "Resnet", "resnet_name": "Resnet34_8s"}}
        return init_weights_(build_backbone(cfg), torch.Generator().manual_seed(seed))

    scene = SyntheticScene(width=W, height=H, num_frames=4)
    rgb, depth, mask, poses = scene.render_all()
    ia, ib = np.array([0, 1]), np.array([2, 3])
    batch = dict(rgb_a=rgb[ia], depth_a=depth[ia], mask_a=mask[ia], pose_a=poses[ia],
                 rgb_b=rgb[ib], depth_b=depth[ib], mask_b=mask[ib], pose_b=poses[ib],
                 K=np.stack([scene.K] * 2), match_type=np.zeros(2, np.int32))
    tc = {"training": {"learning_rate": 1e-4, "learning_rate_decay": 0.9,
                       "steps_between_learning_rate_decay": 250, "weight_decay": 1e-4}}
    step = make_train_step(tc, LossConfig(), AssemblerConfig(
        num_matching_attempts=500, masked_pool_size=128, background_pool_size=128,
        num_blind_samples=200), W)
    states = {"cpu32": create_train_state(module("float32"), tc, device="cpu"),
              "cpu16": create_train_state(module("bfloat16"), tc, device="cpu"),
              "card16": create_train_state(module("bfloat16"), tc, device=cuda)}
    img_a, img_b, s = step.assemble(states["cpu32"], batch, torch.Generator().manual_seed(0))

    # the forward, eval mode, stage by stage
    x = img_a.permute(0, 3, 1, 2).contiguous()
    out = {name: _forward_by_stage(st.module, x) for name, st in states.items()}
    torch.backends.cudnn.enabled = False  # native CUDA convolutions, for the record
    try:
        native = _forward_by_stage(states["card16"].module, x)["out"]
    finally:
        torch.backends.cudnn.enabled = True
    ratio = {k: _rel([out["card16"][k]], [out["cpu16"][k]])
             / _rel([out["cpu16"][k]], [out["cpu32"][k]]) for k in out["cpu32"]}
    native_ratio = _rel([native], [out["cpu16"]["out"]]) / _rel([out["cpu16"]["out"]],
                                                                 [out["cpu32"]["out"]])
    to_fp32 = {k: _rel([out[k]["out"]], [out["cpu32"]["out"]]) for k in ("card16", "cpu16")}
    # one 3x3 convolution of stage 1 (float32 weights, cast to the input's
    # dtype), on the stem's bf16 output
    conv = states["cpu16"].module.stage1_block0.conv1
    feat = out["cpu16"]["stem"].to(torch.bfloat16)
    with torch.no_grad():
        one = {"cpu16": conv(feat).float(), "cpu32": conv(feat.float()),
               "card16": states["card16"].module.stage1_block0.conv1(feat.to(cuda)).float()}
    conv_ratio = _rel([one["card16"]], [one["cpu16"]]) / _rel([one["cpu16"]], [one["cpu32"]])
    conv_differ = float((one["card16"].cpu() != one["cpu16"]).float().mean())
    # one step, same assembled batch
    metrics, grads = {}, {}
    f0, b0 = ph.forward_launches, ph.backward_launches
    for name, st in states.items():
        dev = next(st.module.parameters()).device
        idx = MatrixSampleIndices(*[t.to(dev) for t in s])
        metrics[name] = float(step.update(st, img_a.to(dev), img_b.to(dev), idx)["loss"])
        grads[name] = [p.grad for _, p in st.module.named_parameters()]
        assert all(p.dtype == torch.float32 for p in st.module.parameters())
    assert (ph.forward_launches - f0, ph.backward_launches - b0) == (2, 2)  # the card's step
    g_card, g_bf16 = _rel(grads["card16"], grads["cpu16"]), _rel(grads["cpu16"], grads["cpu32"])
    g_to_fp32 = {k: _rel(grads[k], grads["cpu32"]) for k in ("card16", "cpu16")}
    print(f"bf16 card vs CPU, ResNet-34-8s 64x48, seed {seed}: forward ratio (card-vs-CPU "
          f"bf16 over CPU bf16-vs-fp32) by stage "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items())
          + f"; native convolutions {native_ratio:.3f}; one 3x3 convolution {conv_ratio:.3f} "
          f"({100 * conv_differ:.3f}% of its outputs differ); distance to fp32 card "
          f"{to_fp32['card16']:.4g}, CPU {to_fp32['cpu16']:.4g}; step gradients ratio "
          f"{g_card / g_bf16:.3f} ({g_card:.4g} over {g_bf16:.4g}), distance to fp32 card "
          f"{g_to_fp32['card16']:.4g}, CPU {g_to_fp32['cpu16']:.4g}; losses card bf16 "
          f"{metrics['card16']:.6g}, CPU bf16 {metrics['cpu16']:.6g}, CPU fp32 "
          f"{metrics['cpu32']:.6g}")
    assert np.isfinite(list(metrics.values())).all()
    assert to_fp32["cpu16"] > 1e-3 and g_bf16 > 1e-3  # bf16 moves both, so the ratios read
    assert conv_ratio <= BF16_CONV_BAR
    assert ratio["stem"] <= BF16_RATIO_BAR and ratio["stage1"] <= BF16_RATIO_BAR
    assert to_fp32["card16"] <= BF16_TO_FP32_BAR * to_fp32["cpu16"]
    assert g_to_fp32["card16"] <= BF16_TO_FP32_BAR * g_to_fp32["cpu16"]
    assert abs(metrics["card16"] - metrics["cpu16"]) <= 0.05 * abs(metrics["cpu16"])
