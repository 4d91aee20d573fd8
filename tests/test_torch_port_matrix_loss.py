"""Port compose_loss_matrix (one batched call, K1/K2's plain version on the
CPU) against the JAX package's vmapped compose_loss_matrix: the same
predictions, the same JAX-assembled MatrixSampleIndices, every loss term and
the gradients of the summed loss.

Tolerances: terms rtol 1e-5; gradients atol 1e-6 * max|grad| (the JAX side
expands ||a||^2 - 2<a,b> + ||b||^2 in the pooled hinge; the port sums
(a - b)^2, so d2 differs by a few ulps at these descriptor scales; hard
counts agree, so the normalisations are the same).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pdc_tpu.data.assembler import AssemblerConfig as JaxAssemblerConfig
from pdc_tpu.data.assembler import assemble_batch_matrix as jax_assemble
from pdc_tpu.data.synthetic import SyntheticScene
from pdc_tpu.losses.matrix_loss import compose_loss_matrix as jax_compose
from pdc_tpu.losses.pixelwise_contrastive import LossConfig as JaxLossConfig
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices, compose_loss_matrix
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig

torch.set_num_threads(2)

H, W = 48, 64
# within, within, across-scene, different-object, within, empty
MATCH_TYPES = np.array([0, 3, 1, 2, 4, -1], np.int32)


@pytest.fixture(scope="module")
def assembled():
    scene = SyntheticScene(width=W, height=H, num_frames=6)
    rgb, depth, mask, poses = scene.render_all()
    ia, ib = np.array([0, 1, 2, 3, 4, 5]), np.array([2, 3, 4, 5, 0, 1])
    batch = dict(rgb_a=rgb[ia], depth_a=depth[ia], mask_a=mask[ia],
                 pose_a=poses[ia].astype(np.float32), rgb_b=rgb[ib], depth_b=depth[ib],
                 mask_b=mask[ib], pose_b=poses[ib].astype(np.float32),
                 K=np.stack([scene.K] * 6).astype(np.float32), match_type=MATCH_TYPES)
    cfg = JaxAssemblerConfig(num_matching_attempts=300, masked_pool_size=64,
                             background_pool_size=80, num_blind_samples=120)
    _, _, idx = jax_assemble(jax.random.PRNGKey(0), batch, cfg)
    return jax.tree_util.tree_map(np.asarray, idx)


def _to_port(idx):
    return MatrixSampleIndices(*[torch.as_tensor(np.array(x)) for x in idx])


@pytest.mark.parametrize("overrides", [
    {},
    {"scale_by_hard_negatives": False, "scale_by_hard_negatives_DIFFERENT_OBJECT": False},
    {"use_l2_pixel_loss_on_masked_non_matches": True, "M_pixel": 20.0},
    {"use_l2_pixel_loss_on_background_non_matches": True, "M_background": 0.8},
], ids=["default", "no_hard_scaling", "pixel_masked", "pixel_background"])
def test_terms_and_grads_match_jax(assembled, overrides):
    jcfg = dataclasses.replace(JaxLossConfig(), **overrides)
    cfg = dataclasses.replace(LossConfig(), **overrides)
    rng = np.random.default_rng(len(overrides))
    B = len(MATCH_TYPES)
    pa = (rng.standard_normal((B, H * W, 3)) * 0.3).astype(np.float32)
    pb = (rng.standard_normal((B, H * W, 3)) * 0.3).astype(np.float32)

    def jax_total(pa, pb):
        t = jax.vmap(lambda a, b, s: jax_compose(a, b, s, jcfg, W))(pa, pb, assembled)
        return t.loss.sum(), t

    (_, want), (ga, gb) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(pa, pb)
    ta = torch.tensor(pa, requires_grad=True)
    tb = torch.tensor(pb, requires_grad=True)
    got = compose_loss_matrix(ta, tb, _to_port(assembled), cfg, W)
    got.loss.sum().backward()
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert float(got.loss.detach()[-1]) == 0.0  # the empty sentinel pair
    for g_port, g_jax in ((ta.grad, ga), (tb.grad, gb)):
        g_jax = np.asarray(g_jax)
        np.testing.assert_allclose(g_port.numpy(), g_jax, rtol=0,
                                   atol=1e-6 * float(np.abs(g_jax).max()))


def test_one_kernel_call_per_pool_kind(assembled):
    """The batch goes through the pooled hinge once per pool kind, whatever B."""
    from pdc_tpu_torch.ops.pooled_hinge import pooled_hinge

    shapes = []

    def counting(*args):
        shapes.append(tuple(args[0].shape))
        return pooled_hinge(*args)
    B = len(MATCH_TYPES)
    pred = torch.zeros(B, H * W, 3)
    compose_loss_matrix(pred, pred, _to_port(assembled), LossConfig(), W, hinge=counting)
    assert shapes == [(B, 300, 3), (B, 300, 3)]
