"""Port ResNet FCN (pdc_tpu_torch.models.resnet) against the JAX ResNetFCN:
the same flax variables, converted, give the same descriptor image in eval
mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.models.resnet import ResNetFCN as JaxResNetFCN
from pdc_tpu_torch.models.convert import flax_to_state_dict
from pdc_tpu_torch.models.resnet import ResNetFCN, init_weights_

torch.set_num_threads(2)

D = 3
STAGES = {"Resnet18": (2, 2, 2, 2), "Resnet34": (3, 4, 6, 3)}


def _perturbed_variables(module, h, w, seed):
    """JAX init plus random BN scale/bias/mean/var, so that eval-mode BN is
    not the identity and a mixed-up statistic shows."""
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)), train=False)
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name in ("scale", "var"):
            return (rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, variables)


# (stage sizes, output stride, H, W): both -8s backbones at two sizes (one
# not a multiple of 8), and the stride-16/32 layouts ResNetFCN also offers
CASES = [("Resnet18", 8, 24, 32), ("Resnet34", 8, 24, 32), ("Resnet18", 8, 30, 44),
         ("Resnet18", 16, 32, 48), ("Resnet18", 32, 32, 48)]


@pytest.mark.parametrize("name,stride,h,w", CASES)
def test_forward_matches_jax(name, stride, h, w):
    jmod = JaxResNetFCN(num_classes=D, stage_sizes=STAGES[name], output_stride=stride)
    variables = _perturbed_variables(jmod, h, w, seed=len(CASES) + h + stride)
    x = np.random.RandomState(1).standard_normal((2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x))

    port = ResNetFCN(D, stage_sizes=STAGES[name], output_stride=stride)
    port.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, h, w, D)
    # fp32 convolutions summed in another order, and the bilinear upsample's
    # weights computed differently (jax.image.resize vs F.interpolate, ~2e-5
    # per tests/test_torch_import_numerics.py): 2e-5 relative to the output's
    # scale
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def test_train_mode_raises():
    port = ResNetFCN(D, stage_sizes=STAGES["Resnet18"])
    x = torch.zeros(1, 3, 16, 16)
    with pytest.raises(NotImplementedError, match="training slice"):
        port(x, train=True)
    port.train()
    with pytest.raises(NotImplementedError, match="training slice"):
        port(x)


def test_seeded_init_is_reproducible_and_lecun_scaled():
    a = init_weights_(ResNetFCN(D, STAGES["Resnet18"]), torch.Generator().manual_seed(5))
    b = init_weights_(ResNetFCN(D, STAGES["Resnet18"]), torch.Generator().manual_seed(5))
    c = init_weights_(ResNetFCN(D, STAGES["Resnet18"]), torch.Generator().manual_seed(6))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.stage3_block0.conv1.weight.detach()
    assert not torch.equal(w, c.stage3_block0.conv1.weight)
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    # flax lecun_normal: truncated at 2 sigma, variance 1/fan_in after the
    # truncation correction (sample std within 5% at 294912 samples)
    assert float(w.abs().max()) <= 2.0 * np.sqrt(1.0 / fan_in) / 0.8796256610342398 + 1e-6
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert torch.equal(a.head.bias, torch.zeros(D))


@pytest.mark.parametrize("resnet_name", ["Resnet18_8s", "Resnet34_8s"])
def test_forward_matches_committed_golden(resnet_name):
    """The committed golden input/output pairs of the torchvision-format
    converter (tests/fixtures/*_convert_golden.npz), through the port."""
    import test_torch_import_numerics as tin
    from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
    from pdc_tpu.models.torch_import import convert_reference_dcn

    jdcn = JaxDCN.from_config(tin.net_config(resnet_name))
    sd = tin.make_state_dict(jdcn.variables, prefix=f"fcn.{resnet_name.lower()}.",
                             stage_sizes=tin.MODELS[resnet_name])
    variables = convert_reference_dcn(sd, jdcn.variables)
    port = ResNetFCN(D, stage_sizes=tin.MODELS[resnet_name])
    port.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables)))
    golden = np.load(tin.fixture_path(resnet_name))
    with torch.inference_mode():
        got = port(torch.from_numpy(golden["input"]).permute(0, 3, 1, 2).contiguous())
    got = got.permute(0, 2, 3, 1).numpy()
    # the tolerance of test_converted_forward_matches_golden, relative to the scale
    scale = np.abs(golden["output"]).max()
    np.testing.assert_allclose(got / scale, golden["output"] / scale, atol=1e-4)
