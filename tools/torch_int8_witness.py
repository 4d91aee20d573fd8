"""The int8 witness for ``chip_smoke.py`` phase 13 (d): how close int8 comes
to fp32 on phase 8's trained folder, read by both packages on one set of
weights.

Phase 8 trains a ResNet-34-8s folder for 6 iterations from random weights
at 640x480 on the card, and phase 13 (d) holds the cosine of its int8
descriptors to fp32 to a bar. This script sets the evidence for that bar:

  * on the card (``python tools/torch_int8_witness.py``): it trains the
    folder as phase 8 does, rounds its convolution weights to float16 (so
    they fit the chip tool's output; the rest stays float32), and writes
    under ``--out`` (default ``chiprun_out/int8_witness``):
    ``weights.npz`` (the state_dict), ``frames.npz`` (the first 16 frames
    of scene_000 and their masks) and ``readings.json``: the port's
    readings on the card, for the trained weights and the rounded ones, on
    the full frames and on their 240x320 centre crops, and those of a
    broken quantization (truncation instead of rounding) as a control;
  * on the CPU, ``tests/test_torch_port_int8.py::test_int8_witness_against_jax``
    (``slow``; it skips without these files) reads the same crops with
    ``pdc_tpu``'s quantized clones and the port's on the rounded weights.

Readings (:func:`int8_readings`): the least cosine of int8 to fp32
descriptors over frames 0-3, and of 16 object pixels of frame 0 the best
matches in frame 3 that are the fp32 pick (``exact``) or within 5e-3 of
the squared spread of it under the fp32 distances (``near``), as
``tests/test_quantized.py`` counts them. ``dynamic`` is ``quantized()``,
``static`` ``calibrate_quantization`` on the 16 frames (or crops).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = (slice(120, 360), slice(160, 480))  # the 240x320 centre of a 640x480 frame
N_QUERIES, NEAR_TIE = 16, 5e-3


def crop(frames):
    return np.ascontiguousarray(np.asarray(frames)[(slice(None),) + CROP])


def int8_readings(fp32, int8, mask0):
    """``fp32``, ``int8``: ``[4, H, W, D]`` descriptors of frames 0-3;
    ``mask0`` frame 0's object mask. Returns ``{"cos", "near", "exact"}``."""
    f, q = np.asarray(fp32, np.float64), np.asarray(int8, np.float64)
    cos = min(float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
              for a, b in zip(f, q))
    obj = np.argwhere(np.asarray(mask0) > 0)
    iv, iu = obj[np.linspace(0, len(obj) - 1, N_QUERIES).astype(int)].T
    d = f.shape[-1]
    fb, qb = f[3].reshape(-1, d), q[3].reshape(-1, d)
    spread = float((fb.max(0) - fb.min(0)).max())
    df = ((fb[None] - f[0][iv, iu][:, None]) ** 2).sum(-1)
    dq = ((qb[None] - q[0][iv, iu][:, None]) ** 2).sum(-1)
    bf, bq = df.argmin(1), dq.argmin(1)
    gap = (np.take_along_axis(df, bq[:, None], 1)[:, 0]
           - np.take_along_axis(df, bf[:, None], 1)[:, 0])
    return {"cos": cos, "near": int((gap <= NEAR_TIE * spread ** 2).sum()),
            "exact": int((bf == bq).sum())}


@contextlib.contextmanager
def truncating(torch):
    """The control: every ``torch.round`` (the quantizer's) truncates."""
    rnd = torch.round
    torch.round = torch.trunc
    try:
        yield
    finally:
        torch.round = rnd


def port_readings(torch, dcn, rgb, masks):
    """:func:`int8_readings` of ``dcn``'s int8 clones (and the control) on
    ``rgb`` (16 frames: 0-3 are read, all 16 calibrate) and on their crops."""
    out = {}
    for view, frames, mask0 in (("full", rgb, masks[0]), ("crop", crop(rgb), crop(masks)[0])):
        with torch.inference_mode():
            fp32 = np.stack([dcn.forward_on_img(f).cpu().numpy() for f in frames[:4]])
            clones = {"dynamic": dcn.quantized(),
                      "static": dcn.calibrate_quantization(list(frames))}
            for label, clone in clones.items():
                q = np.stack([clone.forward_on_img(f).cpu().numpy() for f in frames[:4]])
                out[f"{view} {label}"] = int8_readings(fp32, q, mask0)
            with truncating(torch):
                q = np.stack([clones["dynamic"].forward_on_img(f).cpu().numpy()
                              for f in frames[:4]])
            out[f"{view} control"] = int8_readings(fp32, q, mask0)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "int8_witness"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("the witness trains phase 8's folder on the card: CUDA is not available")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pdc_tpu_torch.apps import first_frames
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.ops import _build
    from pdc_tpu_torch.ops import best_match as bm
    from pdc_tpu_torch.ops import pooled_hinge as ph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    _build.build_all()
    t0 = time.perf_counter()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="int8_witness_", dir=build) as tmp:
        on_disk = cs.check_on_disk_training(torch, np, dev, bm, ph, tmp)
        dcn = DenseCorrespondenceNetwork.from_model_folder(on_disk["folder"], device=dev)
        dataset = dcn.load_training_dataset()
        rgb = np.stack(first_frames(dataset, 16))
        masks = next(iter(dataset.scenes.values())).mask[:16]
        readings = {"trained": port_readings(torch, dcn, rgb, masks)}
        with torch.no_grad():
            for name, t in dcn.module.state_dict().items():
                if name.endswith("weight") and t.dim() == 4:
                    t.copy_(t.half().float())
        readings["float16 weights"] = port_readings(torch, dcn, rgb, masks)
        state = {k: (v.half() if k.endswith("weight") and v.dim() == 4 else v).cpu().numpy()
                 for k, v in dcn.module.state_dict().items()}
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "weights.npz"), **state)
    np.savez_compressed(os.path.join(args.out, "frames.npz"), rgb=rgb, mask=masks)
    record = {"card": cs.nvidia_smi_line(), "torch": torch.__version__,
              "config": dcn.config, "readings": readings,
              "seconds": time.perf_counter() - t0}
    with open(os.path.join(args.out, "readings.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps(readings), flush=True)


if __name__ == "__main__":
    main()
