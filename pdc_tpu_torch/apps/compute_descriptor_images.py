"""Batched per-scene descriptor-image export.

Port of :mod:`pdc_tpu.apps.compute_descriptor_images` (:20-90), a rebuild of
the reference's ``scripts/compute_descriptor_images.py:38-96``: run a
trained network over every frame of every scene and save ``[H, W, D]``
float32 descriptor images, ``%06d_descriptor.npy`` named by each frame's
on-disk file index. Frames go through the network in batches: uint8 to the
device, normalised there, one eval-mode forward per batch. The JAX package
pads the last batch to keep one compiled shape; the port runs it as it is,
which gives the same numbers.

    python -m pdc_tpu_torch descriptor-images --model_folder <folder> \\
        --config <composite.yaml> --data_dir <root> [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pdc_tpu_torch.apps import INT8_NOT_PORTED, add_unported_flags, reject_unported_flags


def compute_descriptor_images_for_scene(dcn, scene, out_dir: str, batch_size: int = 8,
                                        timings: dict = None):
    """Write one ``%06d_descriptor.npy`` per frame of ``scene`` (a
    :class:`~pdc_tpu_torch.data.dataset.SceneData`) into ``out_dir``.

    :param timings: optional dict; seconds of the forwards (synchronised,
        the fetch to the host included) and of ``np.save`` are added to its
        ``"forward"`` and ``"save"`` entries
    :return: the number of frames
    """
    os.makedirs(out_dir, exist_ok=True)
    n = scene.num_frames
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        t0 = time.perf_counter()
        res = dcn.forward_on_images(scene.rgb[start:stop]).cpu().numpy()
        t1 = time.perf_counter()
        for j, pos in enumerate(range(start, stop)):
            # named by the frame's on-disk %06d index (reference
            # compute_descriptor_images.py:63 keys files by pose-data index)
            np.save(os.path.join(out_dir, "%06d_descriptor.npy" % scene.frame_id(pos)), res[j])
        if timings is not None:
            timings["forward"] = timings.get("forward", 0.0) + t1 - t0
            timings["save"] = timings.get("save", 0.0) + time.perf_counter() - t1
    return n


def run(model_folder: str, dataset, network_name: str = None, batch_size: int = 8,
        device="cuda"):
    """Descriptor images of every scene of ``dataset`` under
    ``descriptor_images_out/<scene>/descriptor_images/<network>/``;
    ``network`` defaults to the model folder's name. Returns the number of
    frames."""
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    dcn = DenseCorrespondenceNetwork.from_model_folder(model_folder, device=device)
    network_name = network_name or os.path.basename(os.path.normpath(model_folder))
    total = 0
    for name, scene in dataset.scenes.items():
        out_dir = os.path.join("descriptor_images_out", name, "descriptor_images", network_name)
        total += compute_descriptor_images_for_scene(dcn, scene, out_dir, batch_size)
    return total


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch descriptor-images",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--model_folder", required=True)
    p.add_argument("--config", required=True, help="composite dataset yaml")
    p.add_argument("--data_dir", default=os.environ.get("DC_DATA_DIR", "."))
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_unported_flags(p, INT8_NOT_PORTED)
    args = p.parse_args(argv)
    reject_unported_flags(p, args, INT8_NOT_PORTED)

    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.utils.device import resolve_device
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    device = resolve_device(args.device)
    # the descriptors are fp32: no TF32 in cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = SpartanDataset(config=load_yaml(args.config), data_dir=args.data_dir,
                        config_dir=os.path.dirname(os.path.abspath(args.config)))
    n = run(args.model_folder, ds, batch_size=args.batch_size, device=device)
    print(f"wrote descriptor images for {n} frames")


if __name__ == "__main__":
    main()
