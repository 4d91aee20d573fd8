"""Convolution FLOPs of the dilated ResNet FCNs (``Resnet34_8s``,
``Resnet101_8s``) from a configuration's layer shapes, two FLOPs a
multiply-add. Only convolutions are counted: BatchNorm, activations, the
max-pool and the bilinear upsample are a few percent of the work and are
left out. The shapes follow the published architecture (He et al. 2016,
stages of 64/128/256/512 features, output stride 8 by dilating stages 3
and 4, a 1x1 head to the descriptor dimension)."""

ARCHS = {
    # name: (blocks per stage, bottleneck)
    "Resnet34_8s": ((3, 4, 6, 3), False),
    "Resnet101_8s": ((3, 4, 23, 3), True),
}
STAGE_FEATURES = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 1, 1)  # output stride 8: stages 3 and 4 dilate instead


def _out(n: int, k: int, stride: int, pad: int, dilation: int = 1) -> int:
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def conv_layers(resnet_name: str, height: int, width: int, descriptor_dimension: int):
    """Every convolution of the network on one ``height x width`` frame, in
    order: ``(name, c_in, c_out, k, h_out, w_out)``."""
    stage_sizes, bottleneck = ARCHS[resnet_name]
    layers = []
    h, w = _out(height, 7, 2, 3), _out(width, 7, 2, 3)
    layers.append(("stem_conv", 3, 64, 7, h, w))
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max-pool 3x3/2
    c = 64
    for s, (blocks, feats) in enumerate(zip(stage_sizes, STAGE_FEATURES)):
        for b in range(blocks):
            stride = STAGE_STRIDES[s] if b == 0 else 1
            ho, wo = _out(h, 1, stride, 0), _out(w, 1, stride, 0)
            name = f"stage{s + 1}_block{b}"
            if bottleneck:
                out = 4 * feats
                layers += [(name + ".conv1", c, feats, 1, h, w),
                           (name + ".conv2", feats, feats, 3, ho, wo),
                           (name + ".conv3", feats, out, 1, ho, wo)]
            else:
                out = feats
                layers += [(name + ".conv1", c, feats, 3, ho, wo),
                           (name + ".conv2", feats, feats, 3, ho, wo)]
            if c != out or stride != 1:
                layers.append((name + ".proj_conv", c, out, 1, ho, wo))
            c, h, w = out, ho, wo
    layers.append(("head", c, descriptor_dimension, 1, h, w))
    return layers


def conv_flops(layer) -> int:
    _, c_in, c_out, k, h, w = layer
    return 2 * c_in * c_out * k * k * h * w


def forward_flops(resnet_name: str, height: int, width: int, descriptor_dimension: int) -> int:
    """Convolution FLOPs of one frame's forward."""
    return sum(conv_flops(l) for l in conv_layers(resnet_name, height, width,
                                                  descriptor_dimension))


def train_step_flops(resnet_name: str, height: int, width: int, descriptor_dimension: int,
                     frames: int) -> int:
    """Convolution FLOPs of one train step over ``frames`` frames: each
    convolution's forward, the gradient of its weights and the gradient of
    its input (each as many FLOPs as the forward), less the stem's input
    gradient, which no one needs. Recomputation is not counted."""
    layers = conv_layers(resnet_name, height, width, descriptor_dimension)
    total = sum(3 * conv_flops(l) for l in layers) - conv_flops(layers[0])
    return frames * total
