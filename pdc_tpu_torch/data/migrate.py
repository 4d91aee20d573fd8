"""Data-layout migration: old flat scene logs to the processed/raw layout.

Port of :mod:`pdc_tpu.data.migrate` (``RAW_FILES``,
``migrate_scene_to_new_format``, ``migrate_logs``, :16-62). Early pdc
captures kept every file directly under ``<scene>/``; the current layout is
``<scene>/processed/`` (all that the pipeline reads) and ``<scene>/raw/``
(the ROS bag). A scene already in the new layout (no top-level
``fusion_mesh.ply``) is left as it is.

    python -m pdc_tpu_torch migrate --logs_dir <root>/logs_proto [--dry_run]
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import List

RAW_FILES = ("fusion.bag",)


def migrate_scene_to_new_format(folder: str, dry_run: bool = False) -> bool:
    """Migrate one scene folder in place. :return: True if it was (or, with
    ``dry_run``, would be) migrated."""
    if not os.path.isfile(os.path.join(folder, "fusion_mesh.ply")):
        return False  # already in the new layout, or not a scene folder
    names = [n for n in sorted(os.listdir(folder)) if n not in ("processed", "raw")]
    if dry_run:
        return True
    for sub in ("processed", "raw"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for name in names:
        sub = "raw" if name in RAW_FILES else "processed"
        shutil.move(os.path.join(folder, name), os.path.join(folder, sub, name))
    return True


def migrate_logs(logs_dir: str, dry_run: bool = False) -> List[str]:
    """Migrate every old-layout scene under ``logs_dir``; returns the names
    migrated (or that would be, with ``dry_run``)."""
    return [name for name in sorted(os.listdir(logs_dir))
            if os.path.isdir(os.path.join(logs_dir, name))
            and migrate_scene_to_new_format(os.path.join(logs_dir, name), dry_run)]


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch migrate",
                                description=__doc__.split("\n")[0])
    p.add_argument("--logs_dir", required=True)
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    for name in migrate_logs(args.logs_dir, dry_run=args.dry_run):
        print(("would migrate " if args.dry_run else "migrated ") + name)
