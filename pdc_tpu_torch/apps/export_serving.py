"""Serving export: the descriptor-inference program as a ``torch.export``
artifact.

Port of :mod:`pdc_tpu.apps.export_serving` (:31-120), with ``jax.export``
replaced by ``torch.export``. The exported program is the whole inference
step: uint8 RGB ``[B, H, W, 3]`` -> divide by 255 -> mean/std normalisation
-> the backbone in eval mode (BatchNorm on its running statistics) ->
float32 ``[B, H, W, D]`` descriptor images. The trained weights are part of
the program, so ``torch.export.load(path).module()(rgb_u8)`` serves it with
PyTorch alone: no ``pdc_tpu_torch``, no model code, no checkpoint files.
Like the JAX package's export (and both servers), the program leaves out
the network's ``normalize`` option.

A program runs on the device it was exported for (``--platform cuda`` or
``cpu``; its example input and weights live there), and is read by the
PyTorch release that wrote it: export and load on the same installation.

    python -m pdc_tpu_torch export-serving --model_folder trained_models/net \\
        --batch_size 8 --output net_b8.pt2 [--platform cpu]
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import torch
import torch.nn as nn

from pdc_tpu_torch.apps import add_int8_flags, quantize_arg, serving_clone

PLATFORMS = ("cuda", "cpu")


class ServingProgram(nn.Module):
    """uint8 ``[B, H, W, 3]`` -> float32 ``[B, H, W, D]`` descriptor images,
    the network's mean/std normalisation included."""

    def __init__(self, backbone: nn.Module, mean, std):
        super().__init__()
        self.backbone = backbone
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32))
        self.register_buffer("std", torch.as_tensor(std, dtype=torch.float32))

    def forward(self, rgb_u8):
        x = (rgb_u8.to(torch.float32) / 255.0 - self.mean) / self.std
        out = self.backbone(x.permute(0, 3, 1, 2).contiguous())
        return out.permute(0, 2, 3, 1).contiguous()


def export_inference(dcn, batch_size: int = 1, device=None):
    """:return: a ``torch.export.ExportedProgram`` of the uint8-in inference
    program at ``batch_size`` on ``device`` (default the network's), weights
    included; ``.module()(rgb_u8)`` runs it."""
    from pdc_tpu_torch.utils.device import resolve_device

    device = resolve_device(device if device is not None else dcn.device)
    # a copy in eval mode, frozen, so the caller's module keeps its mode
    backbone = copy.deepcopy(dcn.module).to(device).eval().requires_grad_(False)
    program = ServingProgram(backbone, dcn.image_mean, dcn.image_std_dev).to(device).eval()
    H, W = dcn.image_shape
    example = torch.zeros((batch_size, H, W, 3), dtype=torch.uint8, device=device)
    return torch.export.export(program, (example,))


def save_exported(exported, path: str) -> int:
    """Write the artifact (``torch.export.save``); returns its byte count."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_exported(path: str):
    """Read an artifact (``torch.export.load``); ``.module()(rgb_u8)``
    serves it."""
    return torch.export.load(path)


def export_model_folder(model_folder: str, output: str, batch_size: int = 1,
                        device="cuda", iteration: Optional[int] = None, quantize=False,
                        calibration_frames: int = 16) -> int:
    """Export a model folder's latest checkpoint (or ``iteration``) for
    ``device``; returns the artifact's bytes.

    ``quantize=True`` exports the int8 serving program (``dcn.quantized()``:
    the per-call abs-max, the rounding and the s8 x s8 -> s32 products are
    in the program); ``quantize="static"`` calibrates static scales on
    ``calibration_frames`` random train-split frames of the folder's dataset
    (seed 7, as ``pdc_tpu/apps/export_serving.py:87-92``) and freezes them
    into the program."""
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    dcn = DenseCorrespondenceNetwork.from_model_folder(model_folder, iteration=iteration,
                                                       device=device)

    def random_train_frames():
        dataset = dcn.load_training_dataset("train")
        dataset.reset_seed(7)
        return [dataset.get_random_rgbd_mask_pose()[0] for _ in range(calibration_frames)]

    dcn = serving_clone(dcn, quantize, random_train_frames)
    return save_exported(export_inference(dcn, batch_size=batch_size), output)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch export-serving",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--model_folder", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--platform", "--device", dest="platform", default="cuda",
                   help="device the program runs on: cuda (default) or cpu")
    p.add_argument("--iteration", type=int, default=None)
    add_int8_flags(p)
    args = p.parse_args(argv)
    if args.platform not in PLATFORMS:
        p.error(f"--platform {args.platform!r}: a torch.export program runs on "
                f"{' or '.join(PLATFORMS)} (there is no TPU lowering in pdc_tpu_torch)")

    # the program computes in fp32: no TF32 in cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = export_model_folder(args.model_folder, args.output, batch_size=args.batch_size,
                            device=args.platform, iteration=args.iteration,
                            quantize=quantize_arg(args))
    print(f"wrote {args.output} ({n} bytes, {n / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
