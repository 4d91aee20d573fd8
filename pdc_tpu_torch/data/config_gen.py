"""Scene-list lookup of composite dataset configs.

Port of two functions of :mod:`pdc_tpu.data.config_gen`:
``resolve_scene_list_path`` (:198-225) and ``scene_names_in_composite``
(:228). Writing the published corpus's configs is not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional

from pdc_tpu_torch.utils.yaml_io import load_yaml


def resolve_scene_list_path(scene_cfg_file: str, config_dir: Optional[str]) -> str:
    """The path of a scene-list YAML that a composite config names.

    An absolute name, or no ``config_dir``, is taken as it is. Otherwise the
    candidates are, in order: the ``single_object/`` and ``multi_object/``
    siblings of ``config_dir`` (the published corpus keeps its composites in
    ``composite/`` and names their scene lists bare), the corpus root, and
    ``config_dir`` itself last, since several published composites name a
    scene list with the composite's own file name. Returns the first that
    exists, else the ``config_dir`` join, so the caller's error names it.
    """
    if config_dir is None or os.path.isabs(scene_cfg_file):
        return scene_cfg_file
    root = os.path.dirname(config_dir.rstrip(os.sep))
    candidates = [
        os.path.join(root, "single_object", scene_cfg_file),
        os.path.join(root, "multi_object", scene_cfg_file),
        os.path.join(root, scene_cfg_file),
        os.path.join(config_dir, scene_cfg_file),
    ]
    return next((c for c in candidates if os.path.exists(c)), candidates[-1])


def scene_names_in_composite(composite: dict, config_dir: str) -> List[str]:
    """Every scene name (train and test, single- and multi-object) that a
    composite config names, in first-seen order, without loading a frame."""
    names: List[str] = []
    for key in ("single_object_scenes_config_files", "multi_object_scenes_config_files"):
        for f in composite.get(key, []):
            sc = load_yaml(resolve_scene_list_path(f, config_dir))
            for split in ("train", "test"):
                names.extend(sc.get(split, []))
            names.extend(sc.get("scenes", []))
    return list(dict.fromkeys(names))
