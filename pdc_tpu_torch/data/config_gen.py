"""Dataset-config generator: the scene-list / composite YAML corpus of a pdc
data root, or of the published pdc dataset.

Port of :mod:`pdc_tpu.data.config_gen`: ``discover_scenes`` (:29),
``group_scenes_by_object`` (:50), ``make_scene_list_config`` (:72),
``generate_dataset_configs`` (:94), ``write_published_corpus`` (:145),
``resolve_scene_list_path`` (:198), ``scene_names_in_composite`` (:228),
``copy_dataset_scenes`` (:248) and ``main``. Pointed at a data root laid out
as ``<data_dir>/logs_proto/<scene>/processed/``, it finds the scenes, groups
them into objects, holds out a test split and writes

    <out_dir>/single_object/<object_id>.yaml     (train/test scene lists)
    <out_dir>/multi_object/<object_id>.yaml      (multi-object captures)
    <out_dir>/composite/<name>.yaml              (the composite naming them)

in the schema ``SpartanDataset`` reads. ``--published`` writes the corpus of
the published dataset from :mod:`pdc_tpu_torch.data.published_manifest`.
YAML is written by the port's emitter and read by its reader
(:mod:`pdc_tpu_torch.utils.yaml_io`), so no PyYAML is needed.

    python -m pdc_tpu_torch config-gen --data_dir <root> --out_dir <cfg>
    python -m pdc_tpu_torch config-gen --published --out_dir <cfg>
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Optional

from pdc_tpu_torch.utils.yaml_io import load_yaml, save_yaml


def discover_scenes(data_dir: str, logs_root: str = "logs_proto") -> List[str]:
    """Sorted names of the scenes under ``<data_dir>/<logs_root>`` whose
    ``processed/images`` holds ``pose_data.yaml`` and at least one
    ``*_rgb.png`` (depth and masks may come later, from ``preprocess``)."""
    logs_dir = os.path.join(data_dir, logs_root)
    if not os.path.isdir(logs_dir):
        raise FileNotFoundError(f"no {logs_root} directory under {data_dir}")
    scenes = []
    for name in sorted(os.listdir(logs_dir)):
        images = os.path.join(logs_dir, name, "processed", "images")
        if (os.path.isdir(images) and os.path.exists(os.path.join(images, "pose_data.yaml"))
                and any(f.endswith("_rgb.png") for f in os.listdir(images))):
            scenes.append(name)
    return scenes


def group_scenes_by_object(scene_names: List[str],
                           object_of: Optional[Dict[str, str]] = None,
                           default_object_id: str = "object") -> Dict[str, List[str]]:
    """Scene names grouped by object id. ``object_of`` maps a scene name, or
    else the first matching scene-name prefix, to its object id; the other
    scenes go to ``default_object_id``."""
    groups: Dict[str, List[str]] = {}
    for name in scene_names:
        oid = default_object_id
        if object_of:
            if name in object_of:
                oid = object_of[name]
            else:
                oid = next((o for prefix, o in object_of.items() if name.startswith(prefix)),
                           default_object_id)
        groups.setdefault(oid, []).append(name)
    return groups


def make_scene_list_config(object_id: str, scene_names: List[str],
                           test_fraction: float = 0.2, min_test: int = 1,
                           logs_root: str = "logs_proto",
                           evaluation_labeled_data_path: Optional[list] = None) -> dict:
    """One single-object scene-list config. The last
    ``round(test_fraction * N)`` scenes (at least ``min_test``, and never
    all of them) are the test split: pdc scene names sort by capture time."""
    n = len(scene_names)
    n_test = min(max(min_test, round(test_fraction * n)), max(n - 1, 0))
    cfg = {"logs_root_path": logs_root, "object_id": object_id,
           "train": list(scene_names[: n - n_test]), "test": list(scene_names[n - n_test:])}
    if evaluation_labeled_data_path:
        cfg["evaluation_labeled_data_path"] = list(evaluation_labeled_data_path)
    return cfg


def generate_dataset_configs(data_dir: str, out_dir: str,
                             composite_name: str = "generated_dataset",
                             object_of: Optional[Dict[str, str]] = None,
                             test_fraction: float = 0.2, logs_root: str = "logs_proto",
                             multi_object_ids: Optional[List[str]] = None) -> dict:
    """Find the scenes of ``data_dir`` and write their scene lists and one
    composite under ``out_dir``.

    :param object_of: scene-name (or prefix) -> object id; one object when
        omitted
    :param multi_object_ids: object ids whose scene lists are multi-object
        captures (listed under ``multi_object_scenes_config_files``)
    :return: ``{"composite": path, "single_object": {object_id: path},
        "multi_object": {object_id: path}, "num_scenes": N}``
    """
    scenes = discover_scenes(data_dir, logs_root)
    if not scenes:
        raise ValueError(f"no valid scenes under {data_dir}/{logs_root}")
    multi_ids = set(multi_object_ids or [])
    result = {"single_object": {}, "multi_object": {}, "num_scenes": len(scenes)}
    files = {"single_object": [], "multi_object": []}
    for oid, names in sorted(group_scenes_by_object(scenes, object_of).items()):
        key = "multi_object" if oid in multi_ids else "single_object"
        path = os.path.join(out_dir, key, f"{oid}.yaml")
        save_yaml(make_scene_list_config(oid, names, test_fraction=test_fraction,
                                         logs_root=logs_root), path)
        result[key][oid] = path
        files[key].append(os.path.relpath(path, out_dir))
    composite_path = os.path.join(out_dir, "composite", f"{composite_name}.yaml")
    save_yaml({"logs_root_path": logs_root,
               "single_object_scenes_config_files": files["single_object"],
               "multi_object_scenes_config_files": files["multi_object"]}, composite_path)
    result["composite"] = composite_path
    return result


def write_published_corpus(out_dir: str) -> dict:
    """Write the config corpus of the PUBLISHED pdc dataset from the
    manifest: every single- and multi-object scene list and every composite
    the reference's experiment notebooks load by name, in the schema
    ``SpartanDataset`` reads. A corpus for one's own captures comes from
    :func:`generate_dataset_configs` instead.

    :return: ``{"single_object": N, "multi_object": N, "composite": N,
        "out_dir": out_dir}``
    """
    from pdc_tpu_torch.data.published_manifest import (
        COMPOSITES,
        MULTI_OBJECT_SCENE_LISTS,
        SINGLE_OBJECT_SCENE_LISTS,
    )

    for lists, sub in ((SINGLE_OBJECT_SCENE_LISTS, "single_object"),
                       (MULTI_OBJECT_SCENE_LISTS, "multi_object")):
        for name, spec in lists.items():
            cfg = {k: spec[k] if k in ("logs_root_path", "object_id") else list(spec[k])
                   for k in ("logs_root_path", "object_id", "train", "test")}
            if spec.get("evaluation_labeled_data_path"):
                cfg["evaluation_labeled_data_path"] = list(spec["evaluation_labeled_data_path"])
            save_yaml(cfg, os.path.join(out_dir, sub, f"{name}.yaml"))
    for name, spec in COMPOSITES.items():
        save_yaml({"logs_root_path": spec["logs_root_path"],
                   "single_object_scenes_config_files":
                       [f"{e}.yaml" for e in spec["single_object"]],
                   "multi_object_scenes_config_files":
                       [f"{e}.yaml" for e in spec["multi_object"]]},
                  os.path.join(out_dir, "composite", f"{name}.yaml"))
    return {"single_object": len(SINGLE_OBJECT_SCENE_LISTS),
            "multi_object": len(MULTI_OBJECT_SCENE_LISTS),
            "composite": len(COMPOSITES), "out_dir": out_dir}


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


def copy_dataset_scenes(composite: dict, config_dir: str, data_dir: str, target_dir: str,
                        dry_run: bool = False) -> List[str]:
    """Copy every scene a composite config names from ``data_dir`` into
    ``target_dir`` (a dataset subset in its own tree). Scenes already at the
    target are skipped; returns the names copied (or, with ``dry_run``, that
    would be)."""
    logs_root = composite.get("logs_root_path", "logs_proto")
    copied = []
    for name in scene_names_in_composite(composite, config_dir):
        src = os.path.join(data_dir, logs_root, name)
        dst = os.path.join(target_dir, logs_root, name)
        if not os.path.isdir(src):
            raise FileNotFoundError(src)
        if os.path.exists(dst):
            continue
        if not dry_run:
            shutil.copytree(src, dst)
        copied.append(name)
    return copied


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch config-gen",
                                description=__doc__.split("\n")[0])
    p.add_argument("--published", action="store_true",
                   help="write the corpus of the PUBLISHED pdc dataset from the manifest "
                        "(no data_dir needed)")
    p.add_argument("--data_dir", default=None, help="pdc data root (holds logs_proto/)")
    p.add_argument("--out_dir", required=True,
                   help="where to write single_object/ + composite/ YAMLs")
    p.add_argument("--name", default="generated_dataset", help="composite config name")
    p.add_argument("--objects", default=None,
                   help="YAML file mapping scene-name prefix -> object id")
    p.add_argument("--multi_object_ids", default=None,
                   help="comma-separated object ids that are multi-object captures")
    p.add_argument("--test_fraction", type=float, default=0.2)
    p.add_argument("--logs_root", default="logs_proto")
    args = p.parse_args(argv)

    if args.published:
        res = write_published_corpus(args.out_dir)
        print(f"published corpus -> {res['out_dir']}: {res['single_object']} single-object + "
              f"{res['multi_object']} multi-object scene lists, {res['composite']} composites")
        return
    if args.data_dir is None:
        p.error("--data_dir is required unless --published is given")
    res = generate_dataset_configs(
        args.data_dir, args.out_dir, composite_name=args.name,
        object_of=load_yaml(args.objects) if args.objects else None,
        test_fraction=args.test_fraction, logs_root=args.logs_root,
        multi_object_ids=args.multi_object_ids.split(",") if args.multi_object_ids else None)
    print(f"{res['num_scenes']} scenes -> {res['composite']}")
    for oid, path in {**res["single_object"], **res["multi_object"]}.items():
        print(f"  {oid}: {path}")
