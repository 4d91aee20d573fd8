"""Per-channel RGB mean and standard deviation of a dataset's frames, the
normalisation constants of a new dataset.

Port of :mod:`pdc_tpu.data.statistics` (``compute_image_mean_and_std_dev``
:25, ``main`` :50). Frames are drawn as there (a random scene, then a random
frame, from the dataset's host RNG), and each batch is reduced on the device:
integer sums of the uint8 values and of their squares, which are exact, so
the float64 sums on the host differ from the float64 sums over the same
frames only by rounding.

    python -m pdc_tpu_torch statistics --config <composite.yaml> --data_dir <root>
"""

from __future__ import annotations

import numpy as np
import torch

from pdc_tpu_torch.utils.device import resolve_device


def compute_image_mean_and_std_dev(dataset, num_images: int = 100, batch_size: int = 8,
                                   device="cuda"):
    """:return: (mean [3], std [3]) float64 numpy, of the RGB values / 255
    over ``num_images`` frames drawn with replacement."""
    device = resolve_device(device)
    s1 = np.zeros(3)
    s2 = np.zeros(3)
    n = 0
    batch = []
    for drawn in range(1, num_images + 1):
        scene_name = dataset.get_random_scene_name()
        idx = dataset.get_random_image_index(scene_name)
        batch.append(dataset.get_rgbd_mask_pose(scene_name, idx)[0])
        if len(batch) == batch_size or drawn == num_images:
            x = torch.from_numpy(np.stack(batch)).to(device).reshape(-1, 3).to(torch.int64)
            sums = torch.stack([x.sum(0), (x * x).sum(0)]).cpu().numpy()
            s1 += sums[0] / 255.0
            s2 += sums[1] / 255.0**2
            n += x.shape[0]
            batch = []
    mean = s1 / n
    var = np.maximum(s2 / n - mean**2, 0.0)
    return mean, np.sqrt(var)


def main(argv=None):
    """Print a dataset's ``image_normalization`` block (mean and std_dev,
    rounded to 6 digits) as YAML."""
    import argparse
    import os

    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.utils.yaml_io import dump_yaml, load_yaml

    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch statistics")
    p.add_argument("--config", required=True, help="composite dataset yaml")
    p.add_argument("--data_dir", default=os.environ.get("DC_DATA_DIR", "."))
    p.add_argument("--num_images", type=int, default=100)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    ds = SpartanDataset(config=load_yaml(args.config), data_dir=args.data_dir,
                        config_dir=os.path.dirname(args.config))
    mean, std = compute_image_mean_and_std_dev(ds, num_images=args.num_images,
                                               device=args.device)
    print(dump_yaml({"image_normalization": {
        "mean": [round(float(m), 6) for m in mean],
        "std_dev": [round(float(s), 6) for s in std],
    }}))
