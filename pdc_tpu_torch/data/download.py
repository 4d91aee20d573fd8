"""pdc dataset downloader.

Port of :mod:`pdc_tpu.data.download` (``BASE_URL``,
``scene_urls_from_composite_config``, ``download_pdc_data``, :18-69): from a
composite dataset YAML, fetch each scene's tarball from data.csail.mit.edu
and unpack it into ``<data_dir>/logs_proto``. ``--dry_run`` only lists the
URLs it would fetch, and creates nothing.

    python -m pdc_tpu_torch download --config <composite.yaml> --data_dir <root> --dry_run
"""

from __future__ import annotations

import argparse
import os
import tarfile
import urllib.request
from typing import List, Optional

from pdc_tpu_torch.data.config_gen import resolve_scene_list_path
from pdc_tpu_torch.utils.yaml_io import load_yaml

BASE_URL = "https://data.csail.mit.edu/labelfusion/pdccompressed/"


def scene_urls_from_composite_config(config: dict, config_dir: Optional[str] = None) -> List[str]:
    """The sorted tarball URLs of every train and test scene of a composite
    config."""
    urls = set()
    for key in ("single_object_scenes_config_files", "multi_object_scenes_config_files"):
        for f in config.get(key, []):
            sc = load_yaml(resolve_scene_list_path(f, config_dir))
            for split in ("train", "test"):
                urls.update(BASE_URL + "logs_proto_compressed/" + scene + ".tar.gz"
                            for scene in sc.get(split, []))
    return sorted(urls)


def download_pdc_data(composite_config_file: str, data_dir: str,
                      dry_run: bool = False) -> List[str]:
    """Fetch and unpack every scene of a composite config that is not yet
    under ``<data_dir>/logs_proto``. Returns the scene URLs handled; with
    ``dry_run`` prints the ones it would fetch and creates nothing."""
    urls = scene_urls_from_composite_config(
        load_yaml(composite_config_file), config_dir=os.path.dirname(composite_config_file))
    logs_dir = os.path.join(data_dir, "logs_proto")
    for url in urls:
        scene = os.path.basename(url).replace(".tar.gz", "")
        dest = os.path.join(logs_dir, scene)
        if os.path.isdir(dest):
            continue
        if dry_run:
            print("would fetch", url)
            continue
        os.makedirs(logs_dir, exist_ok=True)
        tar_path = dest + ".tar.gz"
        urllib.request.urlretrieve(url, tar_path)  # noqa: S310 - the public dataset
        with tarfile.open(tar_path) as tf:
            tf.extractall(logs_dir)
        os.remove(tar_path)
    return urls


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch download",
                                description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True, help="composite dataset yaml")
    p.add_argument("--data_dir", default=os.environ.get("DC_DATA_DIR", "."))
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    download_pdc_data(args.config, args.data_dir, dry_run=args.dry_run)
