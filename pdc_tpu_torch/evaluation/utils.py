"""Evaluation utilities: the guarded row builder, the keypoint-annotation
table and descriptor-image export.

Port of :mod:`pdc_tpu.evaluation.utils`. Tables are
:class:`~pdc_tpu_torch.evaluation.table.Table`s, whatever is installed.
"""

from __future__ import annotations

from typing import List

from pdc_tpu_torch.evaluation.table import Table

KEYPOINT_ANNOTATION_COLUMNS = ["scene_name_a", "image_a_idx", "u_a", "v_a", "scene_name_b",
                               "image_b_idx", "u_b", "v_b", "keypoint_name"]


class PandaDataFrameWrapper:
    """Dict-backed row builder that only accepts known columns."""

    def __init__(self, columns: List[str]):
        self._columns = list(columns)
        self._data = {c: None for c in columns}

    def set_value(self, key, value):
        if key not in self._data:
            raise KeyError(f"unknown column {key!r}")
        self._data[key] = value

    def get_value(self, key):
        return self._data[key]

    @property
    def dataframe(self) -> Table:
        """The one-row table (the JAX package returns a DataFrame)."""
        return Table.from_rows([self._data], self._columns)

    def row(self):
        return dict(self._data)


def convert_keypoint_annotations_to_dataframe(annotations: list) -> Table:
    """One row per labelled keypoint of the labeler's annotated pairs (each
    annotation's image_a/image_b hold scene_name, image_idx and a pixels list
    that may name its keypoints)."""
    rows = []
    for ann in annotations:
        ia, ib = ann["image_a"], ann["image_b"]
        for pa, pb in zip(ia["pixels"], ib["pixels"]):
            rows.append({
                "scene_name_a": ia["scene_name"], "image_a_idx": int(ia["image_idx"]),
                "u_a": int(pa["u"]), "v_a": int(pa["v"]),
                "scene_name_b": ib["scene_name"], "image_b_idx": int(ib["image_idx"]),
                "u_b": int(pb["u"]), "v_b": int(pb["v"]),
                "keypoint_name": pa.get("keypoint"),
            })
    return Table.from_rows(rows, KEYPOINT_ANNOTATION_COLUMNS)


def extract_descriptor_images_for_scene(dcn, dataset, scene_name: str, output_dir: str,
                                        batch_size: int = 8):
    """Write a ``%06d_descriptor.npy`` per frame of one scene (reference
    utils.py:109-160) with
    :func:`~pdc_tpu_torch.apps.compute_descriptor_images.compute_descriptor_images_for_scene`;
    returns the number of frames."""
    from pdc_tpu_torch.apps.compute_descriptor_images import (
        compute_descriptor_images_for_scene,
    )

    return compute_descriptor_images_for_scene(dcn, dataset.get_scene(scene_name), output_dir,
                                               batch_size)
