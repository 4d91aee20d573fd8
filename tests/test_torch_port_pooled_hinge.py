"""The port's pooled hinge (pdc_tpu_torch.ops.pooled_hinge: the plain
version the wrapper runs on CPU tensors, behind the same autograd Function
that launches K1/K2 on the card) against the JAX package's Pallas kernel in
interpret mode and its XLA formulation, on every case of
tests/test_pallas_loss.py.

Tolerances: forward loss rtol 1e-5 and the hard count exact (the JAX side
expands ||a||^2 - 2<a,b> + ||b||^2, the port sums (a - b)^2; at these row
scales the two differ by a few ulps of d2, too little to move a pair across
the hinge); gradients atol 1e-5, rtol 1e-4 as tests/test_pallas_loss.py
holds the Pallas kernel against XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.losses.matrix_loss import _pooled_hinge_xla
from pdc_tpu.ops.pallas_loss import pooled_hinge as jax_pooled_hinge
from pdc_tpu_torch.ops import pooled_hinge as ph

torch.set_num_threads(2)

W_IMG = 64


def make_case(rng, Nm=700, P=256, D=3, valid_frac=0.8):
    """The numpy inputs of tests/test_pallas_loss.py's make_case."""
    da = (rng.standard_normal((Nm, D)) * 0.3).astype(np.float32)
    db = (rng.standard_normal((P, D)) * 0.3).astype(np.float32)
    uv_b = np.stack([rng.integers(0, W_IMG, Nm), rng.integers(0, 48, Nm)], 1).astype(np.float32)
    mvalid = rng.random(Nm) < valid_frac
    pool_b = rng.integers(0, W_IMG * 48, P).astype(np.int32)
    pvalid = rng.random(P) < valid_frac
    return da, db, uv_b, mvalid, pool_b, pvalid


def jax_loss(ref, da, db, uv_b, mvalid, pool_b, pvalid, use_pix=False, M_pixel=50.0):
    if ref == "xla":
        loss, hard = _pooled_hinge_xla(da, db, uv_b, mvalid, pool_b, pvalid, W_IMG, M=0.5,
                                       use_l2_pixel_loss=use_pix, M_pixel=M_pixel)
        return loss, hard
    pu = (pool_b % W_IMG).astype(jnp.float32)
    pv = (pool_b // W_IMG).astype(jnp.float32)
    return jax_pooled_hinge(da, db, uv_b[:, 0], uv_b[:, 1], mvalid.astype(jnp.float32),
                            pu, pv, pvalid.astype(jnp.float32), 0.5, use_pix, M_pixel, True)


def port_args(cases):
    """Stack per-pair numpy cases into the port's batched float32 tensors."""
    da, db, uv_b, mvalid, pool_b, pvalid = (np.stack(x) for x in zip(*cases))
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)  # noqa: E731
    return [f(da).requires_grad_(), f(db).requires_grad_(), f(uv_b[..., 0]), f(uv_b[..., 1]),
            f(mvalid), f(pool_b % W_IMG), f(pool_b // W_IMG), f(pvalid)]


def port_loss(cases, use_pix=False, M_pixel=50.0):
    args = port_args(cases)
    loss, hard = ph.pooled_hinge(*args, 0.5, use_pix, M_pixel)
    return loss, hard, args


REFS = ["pallas", "xla"]


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("use_pix", [False, True])
def test_forward_matches_jax(ref, use_pix):
    case = make_case(np.random.default_rng(0))
    l_ref, h_ref = jax_loss(ref, *case, use_pix=use_pix)
    loss, hard, _ = port_loss([case], use_pix=use_pix)
    assert hard.dtype == torch.int64
    np.testing.assert_allclose(float(loss.detach()[0]), float(l_ref), rtol=1e-5)
    assert int(hard[0]) == int(h_ref)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("use_pix,M_pixel,Nm,P,seed", [(False, 50.0, 700, 256, 1),
                                                        (True, 20.0, 300, 128, 2)])
def test_grads_match_jax(ref, use_pix, M_pixel, Nm, P, seed):
    da, db, uv_b, mvalid, pool_b, pvalid = case = make_case(np.random.default_rng(seed), Nm, P)
    g_ref = jax.grad(lambda a, b: jax_loss(ref, a, b, uv_b, mvalid, pool_b, pvalid,
                                           use_pix, M_pixel)[0], argnums=(0, 1))(da, db)
    loss, _, args = port_loss([case], use_pix, M_pixel)
    loss.sum().backward()
    for got, want in zip((args[0].grad[0], args[1].grad[0]), g_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("use_pix", [False, True])
def test_explicit_backward_equals_autodiff_of_plain(use_pix):
    """The CPU backward (the c_ij formula written out, as K2 computes it)
    against autograd through the plain forward: the same terms, multiplied
    and summed in another order, so equal to float rounding (1e-5 of the
    largest gradient)."""
    cases = [make_case(np.random.default_rng(9 + i), 200, 96) for i in range(2)]
    loss, _, args = port_loss(cases, use_pix, 20.0)
    (loss * torch.tensor([0.7, 1.3])).sum().backward()
    ref = port_args(cases)
    rloss, _ = ph.pooled_hinge_reference(*ref, 0.5, use_pix, 20.0)
    (rloss * torch.tensor([0.7, 1.3])).sum().backward()
    for got, want in ((args[0].grad, ref[0].grad), (args[1].grad, ref[1].grad)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("ref", REFS)
def test_collision_exclusion(ref):
    """A pool pixel on a row's true match contributes nothing for that row."""
    da, db, uv_b, mvalid, pool_b, pvalid = make_case(np.random.default_rng(3), 64, 128, 3, 1.0)
    pool_b = pool_b.copy()
    pool_b[0] = int(uv_b[0, 1]) * W_IMG + int(uv_b[0, 0])
    case = (da, db, uv_b, mvalid, pool_b, pvalid)
    l_ref, h_ref = jax_loss(ref, *case)
    loss, hard, _ = port_loss([case])
    np.testing.assert_allclose(float(loss.detach()[0]), float(l_ref), rtol=1e-5)
    assert int(hard[0]) == int(h_ref)
    # and the colliding pair is really excluded: moving it away changes the sum
    far = pool_b.copy()
    far[0] = ((int(uv_b[0, 1]) + 10) % 48) * W_IMG + (int(uv_b[0, 0]) + 10) % W_IMG
    loss_far, _, _ = port_loss([(da, db, uv_b, mvalid, far, pvalid)])
    assert float(loss_far[0]) != float(loss.detach()[0])


def test_all_invalid_is_zero():
    da, db, uv_b, _, pool_b, _ = make_case(np.random.default_rng(4), 64, 128)
    case = (da, db, uv_b, np.zeros(64, bool), pool_b, np.ones(128, bool))
    l_pal, h_pal = jax_loss("pallas", *case)
    loss, hard, args = port_loss([case])
    assert float(loss.detach()[0]) == float(l_pal) == 0.0 and int(hard[0]) == int(h_pal) == 0
    loss.sum().backward()
    assert not args[0].grad.any() and not args[1].grad.any()


def test_batched_matches_loop():
    """One batched call equals one call per pair (the JAX test's vmap)."""
    cases = [make_case(np.random.default_rng(5 + i), 200, 128) for i in range(3)]
    loss, hard, _ = port_loss(cases)
    for i, case in enumerate(cases):
        l1, h1, _ = port_loss([case])
        assert float(loss.detach()[i]) == float(l1[0]) and int(hard[i]) == int(h1[0])
        np.testing.assert_allclose(float(loss.detach()[i]), float(jax_loss("pallas", *case)[0]),
                                   rtol=1e-5)


def test_identical_descriptors_zero_grad():
    """d2 = 0 exactly in the difference form: coincident rows get no gradient
    (as autodiff of the clamped XLA form gives)."""
    case = (np.zeros((8, 3), np.float32), np.zeros((16, 3), np.float32),
            np.full((8, 2), 30.0, np.float32), np.ones(8, bool),
            np.arange(16, dtype=np.int32), np.ones(16, bool))
    loss, hard, args = port_loss([case])
    loss.sum().backward()
    assert torch.isfinite(args[0].grad).all()
    assert not args[0].grad.any() and not args[1].grad.any()
    assert int(hard[0]) == 8 * 16
    g = jax.grad(lambda a: jax_loss("xla", a, *case[1:])[0])(case[0])
    np.testing.assert_allclose(np.asarray(g), 0.0)


def test_wrapper_checks_its_inputs():
    args = port_args([make_case(np.random.default_rng(6), 10, 12)])
    with pytest.raises(TypeError):
        ph.pooled_hinge(args[0].double(), *args[1:], 0.5, False, 50.0)
    with pytest.raises(ValueError):
        ph.pooled_hinge(*args[:4], args[4][:, :5], *args[5:], 0.5, False, 50.0)
    with pytest.raises(ValueError):
        ph.pooled_hinge(torch.zeros(1, 10, 17), torch.zeros(1, 12, 17), *args[2:], 0.5, False,
                        50.0)
    before = (ph.forward_launches, ph.backward_launches)
    loss, _ = ph.pooled_hinge(*args, 0.5, False, 50.0)
    loss.sum().backward()
    assert (ph.forward_launches, ph.backward_launches) == before  # CPU: the plain version


# -- NaN (fault F5): the JAX kernel and the plain version the card is held to --

def _nan_case(where):
    """make_case at Nm=40, P=24, D=3 with one NaN in a valid or an invalid
    match row, or in a valid or an invalid pool entry."""
    da, db, uv_b, mvalid, pool_b, pvalid = make_case(np.random.default_rng(0), 40, 24, 3)
    da, db = da.copy(), db.copy()
    pick = {"valid row": (da, mvalid, True, 1), "invalid row": (da, mvalid, False, 0),
            "valid entry": (db, pvalid, True, 2), "invalid entry": (db, pvalid, False, 0)}
    rows, valid, want, channel = pick[where]
    i = int(np.flatnonzero(valid == want)[0])
    rows[i, channel] = np.nan
    return da, db, uv_b, mvalid, pool_b, pvalid


@pytest.mark.parametrize("use_pix", [False, True])
@pytest.mark.parametrize("where", ["valid row", "invalid row", "valid entry", "invalid entry"])
def test_nan_pattern_of_jax_kernel_and_plain_agree(where, use_pix):
    """A NaN anywhere in da or db, valid or not, makes the loss NaN in both;
    NaN pairs count as hard negatives in neither; the gradients are NaN at
    the same places (the rule the card kernels are held to: gda[i, d] where
    da[i, d] or any db[:, d] is NaN, gdb[j, d] where db[j, d] or any
    da[:, d] is)."""
    da, db, uv_b, mvalid, pool_b, pvalid = case = _nan_case(where)
    l_jax, h_jax = jax_loss("pallas", *case, use_pix=use_pix, M_pixel=20.0)
    g_jax = jax.grad(lambda a, b: jax_loss("pallas", a, b, uv_b, mvalid, pool_b, pvalid,
                                           use_pix, 20.0)[0], argnums=(0, 1))(da, db)
    args = [a.detach() for a in port_args([case])]
    loss, hard = ph.pooled_hinge_reference(*args, 0.5, use_pix, 20.0)
    gda, gdb = ph.pooled_hinge_backward_reference(torch.ones(1), *args, 0.5, use_pix, 20.0)
    assert np.isnan(float(l_jax)) and torch.isnan(loss).all()
    assert int(hard[0]) == int(h_jax)
    nan_da, nan_db = np.isnan(da).any(0), np.isnan(db).any(0)  # NaN channels
    for got, want, own, other in ((gda[0], g_jax[0], da, nan_db), (gdb[0], g_jax[1], db, nan_da)):
        want = np.asarray(want)
        np.testing.assert_array_equal(torch.isnan(got).numpy(), np.isnan(want))
        np.testing.assert_array_equal(np.isnan(want), np.isnan(own) | other[None, :])
        finite = np.isfinite(want)
        np.testing.assert_allclose(got.numpy()[finite], want[finite], atol=1e-5, rtol=1e-4)
