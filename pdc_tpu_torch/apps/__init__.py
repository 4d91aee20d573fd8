"""User-facing applications: the descriptor server, descriptor images and
videos, the heatmap explorer and grasp-point stream, mesh descriptors, the
annotation and debug viewers, and the serving export."""


def add_int8_flags(parser):
    """``--int8`` and ``--int8_static``, as the JAX package's CLIs have them."""
    parser.add_argument("--int8", action="store_true",
                        help="int8 post-training-quantized forward (dynamic scales)")
    parser.add_argument("--int8_static", action="store_true",
                        help="int8 with static scales calibrated on the training dataset's "
                             "first frames")


def quantize_arg(args):
    """The ``quantize`` argument of the apps: "static", True or False."""
    return "static" if args.int8_static else bool(args.int8)


def first_frames(dataset, n: int = 16):
    """The first ``n`` frames of the first scene of ``dataset``, the frames
    the JAX package's server calibrates on."""
    first = next(iter(dataset.scenes.values()))
    return list(first.rgb[:n])


def serving_clone(dcn, quantize, frames=None, batch_size: int = 8):
    """The network an app serves for ``quantize``: ``dcn`` itself (False),
    ``dcn.quantized()`` (True), or a clone calibrated on ``frames()``
    ("static"; ``frames`` is called only then)."""
    if quantize == "static":
        return dcn.calibrate_quantization(frames(), batch_size=batch_size)
    return dcn.quantized() if quantize else dcn


def add_unported_flags(parser, flags: dict):
    """Flags of the JAX package's CLI that the port accepts only to refuse:
    ``{flag: why}``."""
    for flag, why in flags.items():
        parser.add_argument(f"--{flag}", action="store_true", help=f"not ported: {why}")


def reject_unported_flags(parser, args, flags: dict):
    """Exit 2 (``parser.error``) naming the first of ``flags`` that is set."""
    for flag, why in flags.items():
        if getattr(args, flag):
            parser.error(f"--{flag} is not ported to pdc_tpu_torch yet: {why}")
