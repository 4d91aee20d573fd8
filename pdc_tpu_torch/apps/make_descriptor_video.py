"""Descriptor-video maker: render every frame of a scene through a trained
network and assemble RGB and descriptor videos.

Port of :mod:`pdc_tpu.apps.make_descriptor_video` (:27-159), a rebuild of
the reference's ``evaluation/make_video.ipynb``: each frame's descriptor
image is mapped to RGB with the network's ``descriptor_image_stats`` (so
colours agree across frames) and written as ``%06d_res.png`` (and
``_res_masked.png``), beside ``%06d_rgb.png``; ffmpeg then makes mp4s where
it is installed, and the frame directory is the artifact where it is not.
Frames are numbered by position in the scene, not by file index: ffmpeg's
``%06d`` input needs contiguous numbers. PNGs are written with the port's
own encoder (:func:`~pdc_tpu_torch.data.native_loader.write_png`), which
needs neither PIL nor matplotlib.

    python -m pdc_tpu_torch descriptor-video --model_folder <folder> \\
        --config <composite.yaml> --data_dir <root> [--masked] [--device cpu]
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import torch

from pdc_tpu_torch.data.native_loader import write_png


def descriptor_rgb(res, stats=None):
    """``[H, W, D]`` descriptor image -> ``[H, W, D]`` uint8, per channel
    over the ``mask_image`` min and max of ``stats`` (the folder's
    descriptor statistics), else the image's own; values are truncated."""
    from pdc_tpu_torch.evaluation.plotting import normalize_descriptor

    res_norm = normalize_descriptor(res, stats.get("mask_image") if stats else None)
    return (np.clip(res_norm, 0, 1) * 255).astype(np.uint8)


def make_descriptor_images(dcn, scene, save_images_dir: str, batch_size: int = 8,
                           masked: bool = False):
    """Forward every frame of ``scene`` (a
    :class:`~pdc_tpu_torch.data.dataset.SceneData`) in batches; write
    ``%06d_rgb.png`` and ``%06d_res.png`` (and ``_res_masked.png``, zero off
    the object mask) under ``save_images_dir``.

    :return: number of frames written
    """
    os.makedirs(save_images_dir, exist_ok=True)
    stats = None
    try:
        stats = dcn.descriptor_image_stats
    except (FileNotFoundError, OSError, KeyError):
        pass

    n = scene.num_frames
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        res = dcn.forward_on_images(scene.rgb[start:stop]).to(torch.float32).cpu().numpy()
        for j, idx in enumerate(range(start, stop)):
            write_png(os.path.join(save_images_dir, "%06d_rgb.png" % idx), scene.rgb[idx])
            res_u8 = descriptor_rgb(res[j], stats)
            write_png(os.path.join(save_images_dir, "%06d_res.png" % idx), res_u8)
            if masked and scene.mask is not None:
                m = (np.asarray(scene.mask[idx]) > 0)[..., None]
                write_png(os.path.join(save_images_dir, "%06d_res_masked.png" % idx),
                           (res_u8 * m).astype(np.uint8))
    return n


def make_videos(save_images_dir: str, videos_dir: str, log_name: str, framerate: int = 30,
                masked: bool = False):
    """mp4s of the frame directory with ffmpeg; none (``[]``) where ffmpeg is
    not installed.

    :return: list of video paths written
    """
    if shutil.which("ffmpeg") is None:
        return []
    os.makedirs(videos_dir, exist_ok=True)
    written = []
    suffixes = [("rgb", "_video_rgb.mp4"), ("res", "_video_descriptors.mp4")]
    if masked:
        suffixes.append(("res_masked", "_video_descriptors_masked.mp4"))
    for frame_kind, video_suffix in suffixes:
        out = os.path.join(videos_dir, log_name + video_suffix)
        cmd = ["ffmpeg", "-y", "-framerate", str(framerate),
               "-i", os.path.join(save_images_dir, f"%06d_{frame_kind}.png"),
               "-c:v", "libx264", "-pix_fmt", "yuv420p", "-r", str(framerate), out]
        if subprocess.run(cmd, capture_output=True).returncode == 0:
            written.append(out)
    return written


def run(model_folder: str, dataset, scene_names=None, output_dir: str = None,
        batch_size: int = 8, masked: bool = False, framerate: int = 30, device="cuda"):
    """Frames and videos of each scene under
    ``<output_dir>/<scene>/{video_images,videos}``.

    :return: {scene: {"frames": n, "videos": [paths]}}
    """
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    dcn = DenseCorrespondenceNetwork.from_model_folder(model_folder, device=device)
    output_dir = output_dir or "descriptor_videos_out"
    scene_names = scene_names or sorted(dataset.scenes.keys())
    results = {}
    for name in scene_names:
        save_images_dir = os.path.join(output_dir, name, "video_images")
        n = make_descriptor_images(dcn, dataset.scenes[name], save_images_dir,
                                   batch_size=batch_size, masked=masked)
        videos = make_videos(save_images_dir, os.path.join(output_dir, name, "videos"),
                             name, framerate=framerate, masked=masked)
        results[name] = {"frames": n, "videos": videos}
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch descriptor-video",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--model_folder", required=True)
    p.add_argument("--config", required=True, help="composite dataset yaml")
    p.add_argument("--data_dir", default=os.environ.get("DC_DATA_DIR", "."))
    p.add_argument("--output_dir", default="descriptor_videos_out")
    p.add_argument("--scenes", default=None, help="comma-separated scene names")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--masked", action="store_true")
    p.add_argument("--framerate", type=int, default=30)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.utils.device import resolve_device
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = SpartanDataset(config=load_yaml(args.config), data_dir=args.data_dir,
                        config_dir=os.path.dirname(os.path.abspath(args.config)))
    out = run(args.model_folder, ds, scene_names=args.scenes.split(",") if args.scenes else None,
              output_dir=args.output_dir, batch_size=args.batch_size, masked=args.masked,
              framerate=args.framerate, device=device)
    for name, info in out.items():
        print(name, info["frames"], "frames", len(info["videos"]), "videos")


if __name__ == "__main__":
    main()
