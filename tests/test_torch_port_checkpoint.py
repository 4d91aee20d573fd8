"""Port weight bridge and checkpoint format (pdc_tpu_torch.models.convert,
pdc_tpu_torch.models.checkpoint) against flax: flax variables <-> the port's
state_dict round-trips bit-exactly, and the port's pure-Python msgpack reader
and writer agree with flax.serialization byte for byte."""

import flax
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu.models.resnet import ResNet18_8s as JaxResNet18_8s
from pdc_tpu_torch.models import checkpoint as ckpt
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.resnet import ResNet18_8s

torch.set_num_threads(2)

W, H, D = 32, 24, 3


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def jax_variables():
    """JAX-initialised ResNet-18-8s variables with non-trivial BN stats."""
    module = JaxResNet18_8s(D)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), train=False)
    rng = np.random.RandomState(0)
    variables = _numpy_tree(variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_bridge_round_trip_bit_exact(jax_variables):
    sd = flax_to_state_dict(jax_variables)
    module = ResNet18_8s(D)
    # strict load: every key and shape of the port's module is produced
    module.load_state_dict(sd, strict=True)
    back = state_dict_to_flax(module.state_dict())
    _assert_trees_equal(back, jax_variables)
    # the conv layout change is a transpose, nothing else
    k = jax_variables["params"]["stage2_block0"]["conv1"]["kernel"]
    np.testing.assert_array_equal(sd["stage2_block0.conv1.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))


def test_bridge_rejects_unknown_leaves(jax_variables):
    bad = {"params": {**jax_variables["params"], "extra": {"gamma": np.ones(3)}},
           "batch_stats": jax_variables["batch_stats"]}
    with pytest.raises(ValueError):
        flax_to_state_dict(bad)
    sd = dict(ResNet18_8s(D).state_dict())
    sd["head.scale"] = torch.ones(3)
    with pytest.raises(ValueError):
        state_dict_to_flax(sd)


def test_reader_reads_pdc_tpu_checkpoint(tmp_path, jax_variables):
    cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
    dcn = JaxDCN.from_config(cfg, rng=jax.random.PRNGKey(1))
    dcn.variables = jax_variables
    path = str(tmp_path / "000010.ckpt")
    dcn.save_checkpoint(path)
    _assert_trees_equal(ckpt.read_checkpoint(path), jax_variables)


def test_writer_matches_flax_bytes_and_loads_in_pdc_tpu(tmp_path, jax_variables):
    path = str(tmp_path / "000020.ckpt")
    tree = state_dict_to_flax(flax_to_state_dict(jax_variables))
    ckpt.write_checkpoint(tree, path)
    with open(path, "rb") as f:
        data = f.read()
    # the bytes flax writes for the same tree (key order is the tree's own)
    assert data == flax.serialization.to_bytes(tree)
    cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
    dcn = JaxDCN.from_config(cfg, rng=jax.random.PRNGKey(2))
    dcn.load_checkpoint(path)
    _assert_trees_equal(_numpy_tree(dcn.variables), jax_variables)


_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.0, 1.5, -2.25e300, "", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
    "é" * 40000, b"", b"x" * 255, b"y" * 256, b"z" * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {"a": {"b": [1, "c", None, {"d": b"e"}]}},
]


@pytest.mark.parametrize("value", _VALUES, ids=range(len(_VALUES)))
def test_msgpack_subset_matches_msgpack(value):
    packed = ckpt.packb(value)
    assert packed == msgpack.packb(value, use_bin_type=True)
    assert ckpt.unpackb(packed) == value


@pytest.mark.parametrize("shape,dtype", [((), "float32"), ((1,), "float32"),
                                         ((3, 4), "int32"), ((2, 3, 5), "float64"),
                                         ((0, 4), "uint8")])
def test_ndarray_ext_matches_flax(shape, dtype):
    arr = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    packed = ckpt.packb({"a": arr})
    assert packed == flax.serialization.msgpack_serialize({"a": arr})
    out = ckpt.unpackb(packed)["a"]
    assert out.dtype == arr.dtype and out.shape == arr.shape and out.flags.writeable
    np.testing.assert_array_equal(out, arr)


@pytest.mark.parametrize("data", [
    b"\xc1",                                  # never-used byte
    b"\xd4\x02\x00",                          # ext code 2 (complex): not flax's ndarray
    b"\x92\x01",                              # truncated array
    b"\x01\x02",                              # trailing bytes
])
def test_reader_rejects_outside_subset(data):
    with pytest.raises(ValueError):
        ckpt.unpackb(data)


def test_writer_rejects_unknown_types():
    with pytest.raises(TypeError):
        ckpt.packb({"a": object()})
