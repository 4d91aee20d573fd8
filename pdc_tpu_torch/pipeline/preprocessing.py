"""Batch preprocessing: the all-logs change-detection driver.

Port of :mod:`pdc_tpu.pipeline.preprocessing`, the rebuild of the
reference's ``run_change_detection_pipeline.py:27-92``: every
``<logs_dir>/<scene>/processed`` folder whose masks and depth are not
rendered yet gets ``image_masks/%06d_mask.png`` and
``rendered_images/%06d_depth.png`` (and ``_depth_cropped.png``) from its
fusion mesh, rendered on the card.

The crop box comes from a station config YAML (the reference's
``config/stations/<robot>/change_detection.yaml`` format), or is fitted to
the scene's geometry (:func:`~pdc_tpu_torch.pipeline.change_detection.fit_crop_box`)
and saved as ``crop_box.yaml`` beside it.

    python -m pdc_tpu_torch preprocess --data_dir <root>/logs_proto [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

from pdc_tpu_torch.pipeline.change_detection import (
    ChangeDetection,
    OrientedCropBox,
    fit_crop_box,
)
from pdc_tpu_torch.utils.yaml_io import load_yaml, save_yaml

logger = logging.getLogger(__name__)


def already_ran_change_detection(processed_dir: str) -> bool:
    """The skip marker (reference run_change_detection_pipeline.py:72-75):
    frame 0's rendered depth and mask both exist."""
    return (os.path.isfile(os.path.join(processed_dir, "rendered_images", "000000_depth.png"))
            and os.path.isfile(os.path.join(processed_dir, "image_masks", "000000_mask.png")))


def discover_processed_scenes(logs_dir: str):
    """Every ``<logs_dir>/<scene>/processed`` folder, sorted; a scene folder
    without ``processed/`` raises (fusion has to run first)."""
    scenes = []
    for name in sorted(os.listdir(logs_dir)):
        full = os.path.join(logs_dir, name)
        if not os.path.isdir(full):
            continue
        processed = os.path.join(full, "processed")
        if not os.path.isdir(processed):
            raise ValueError(f"Need to extract and run fusion on {full}")
        scenes.append(processed)
    return scenes


def _prepare_scene(processed_dir: str, crop_box=None, station_config: Optional[dict] = None,
                   save_fitted_crop_box: bool = True, device="cuda"):
    """The crop box and the geometry of one scene."""
    if crop_box is None and station_config is not None:
        crop_box = OrientedCropBox.from_station_config(station_config)
    cd, structure = ChangeDetection.from_data_folder(processed_dir, device=device)
    if crop_box is None:
        crop_box = fit_crop_box(cd.points)
        logger.info("fitted crop box for %s: dims=%s", processed_dir, crop_box.dimensions)
        if save_fitted_crop_box:
            save_yaml(crop_box.to_station_config(), os.path.join(processed_dir, "crop_box.yaml"))
    cd.set_crop_box(crop_box)
    return cd, structure


def run_change_detection_on_scene(processed_dir: str, crop_box=None,
                                  station_config: Optional[dict] = None,
                                  render_full_depth: bool = True,
                                  save_fitted_crop_box: bool = True, device="cuda"):
    """One scene: crop box, masks and (optionally) the full depth, from one
    device program where the scene allows it. Returns the frames written."""
    cd, structure = _prepare_scene(processed_dir, crop_box, station_config,
                                   save_fitted_crop_box, device)
    return cd.process_scene(structure, render_full_depth=render_full_depth)


def run_change_detection_pipeline(logs_dir: str, station_config_file: Optional[str] = None,
                                  redo: bool = False, render_full_depth: bool = True,
                                  device="cuda") -> dict:
    """The all-logs driver, pipelined one scene deep: scene i's device render
    and its copy to the host overlap scene i+1's host work (geometry, crop
    box, raster prep) and scene i-1's PNG encoding, since
    ``ChangeDetection.process_scene_start`` returns once the device work is
    queued. Returns ``{processed dir: frames written}`` (0 for skipped)."""
    station_config = load_yaml(station_config_file) if station_config_file else None
    results = {}
    pending = None  # (processed_dir, cd, handle) queued but not fetched

    def finish(item):
        processed, cd, handle = item
        results[processed] = cd.process_scene_finish(handle)
        logger.info("processed %s: %d frames", processed, results[processed])

    for processed in discover_processed_scenes(logs_dir):
        if not redo and already_ran_change_detection(processed):
            logger.info("already ran change detection for %s", processed)
            results[processed] = 0
            continue
        cd, structure = _prepare_scene(processed, station_config=station_config, device=device)
        handle = cd.process_scene_start(structure, render_full_depth=render_full_depth)
        if handle is None or handle is cd.OVER_BUDGET:
            # the two-pass flow runs synchronously (not process_scene, which
            # would repeat process_scene_start's host prep)
            if pending is not None:
                finish(pending)
                pending = None
            results[processed] = cd.process_scene_two_pass(
                structure, render_full_depth=render_full_depth)
            logger.info("processed %s: %d frames", processed, results[processed])
            continue
        if pending is not None:
            finish(pending)
        pending = (processed, cd, handle)
    if pending is not None:
        finish(pending)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m pdc_tpu_torch preprocess",
        description="Regenerate object masks and rendered depth for every scene log under a "
                    "dataset root, on the CUDA card (GL-free).")
    parser.add_argument("--data_dir", type=str, default=os.getcwd(),
                        help="logs root (e.g. pdc/logs_proto)")
    parser.add_argument("--config_file", type=str, default=None,
                        help="station change_detection.yaml with the crop box; fitted per "
                             "scene when omitted")
    parser.add_argument("--redo", action="store_true",
                        help="reprocess scenes that already have masks")
    parser.add_argument("--no_depth", action="store_true",
                        help="skip full-scene depth re-rendering")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    results = run_change_detection_pipeline(
        args.data_dir, station_config_file=args.config_file, redo=args.redo,
        render_full_depth=not args.no_depth, device=args.device)
    done = sum(1 for v in results.values() if v > 0)
    print(f"processed {done} scenes ({len(results) - done} already done)")
    return results


if __name__ == "__main__":
    main()
