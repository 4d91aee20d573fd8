"""The frozen arithmetic: convolution FLOPs against multiply-adds counted
by forward hooks on the plain reference models (run on the meta device,
shapes only), and the K3 bound against chip_smoke.py's figures."""

import pytest
import torch

from portbench.count import flops, k3
from portbench.reference.resnet import ResNetFCN


def hooked_flops(name: str, h: int, w: int, d: int) -> int:
    total = []

    def hook(module, inputs, output):
        k = module.kernel_size[0] * module.kernel_size[1]
        total.append(2 * module.in_channels * module.out_channels * k * output.shape[-2]
                     * output.shape[-1] * output.shape[0])

    with torch.device("meta"):
        model = ResNetFCN(name, d)
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.register_forward_hook(hook)
        model.eval()(torch.empty(1, 3, h, w))
    return sum(total)


@pytest.mark.parametrize("name,gflop", [("Resnet34_8s", 211.9), ("Resnet101_8s", 415.5)])
def test_forward_flops_of_a_640x480_frame(name, gflop):
    counted = flops.forward_flops(name, 480, 640, 3)
    assert counted == hooked_flops(name, 480, 640, 3)
    assert round(counted / 1e9, 1) == gflop


@pytest.mark.parametrize("name", ["Resnet34_8s", "Resnet101_8s"])
def test_train_step_is_three_passes_less_the_stem_input_gradient(name):
    layers = flops.conv_layers(name, 480, 640, 3)
    fwd = flops.forward_flops(name, 480, 640, 3)
    assert flops.train_step_flops(name, 480, 640, 3, 8) == 8 * (3 * fwd - flops.conv_flops(layers[0]))


def test_k3_bound_matches_chip_smoke():
    t, kind = k3.k3_bound_s(1, 16, 3, 640 * 480)
    assert round(t * 1e3, 5) == 0.00110 and kind == "bytes"
    t, kind = k3.k3_bound_s(16, 100, 3, 640 * 480)
    assert round(t * 1e3, 5) == 0.05869 and kind == "operations"
