"""SpartanDataset — the host-side scene registry and pair sampler.

Port of :mod:`pdc_tpu.data.dataset`: ``ImageType`` (:39), ``SceneData``
(:58-146), ``SamplePair`` (:147) and ``SpartanDataset`` (:165-774). Sampling
is plain Python and numpy on the host, with the same two RNGs
(``random.Random`` and ``np.random.RandomState``, both seeded with ``seed``)
drawn in the same order as the JAX package, so one seed gives the same
pairs, types, frames and batches bit for bit. The device side (assembly, the
device cache, the on-device sampler) takes the frames from here.

Scenes come from the pdc on-disk layout (:meth:`SceneData.from_structure`,
decoded by :mod:`pdc_tpu_torch.data.native_loader`), named by a composite
dataset config (``logs_root_path`` and per-object scene-list YAMLs with
``train``/``test`` splits), or from the synthetic renderer
(:meth:`SpartanDataset.make_synthetic`). A composite config's split is
decoded when that split is first used. Synthetic-multi-object pairs carry
their second within-scene pair (``SamplePair.second``), which the assembler
composites.
"""

from __future__ import annotations

import dataclasses
import os
import random as pyrandom
from typing import Dict, List, Optional

import numpy as np

from pdc_tpu_torch.data.scene import SceneStructure
from pdc_tpu_torch.geom.transforms import pose_angle, pose_distance
from pdc_tpu_torch.losses.composer import (
    MATCH_TYPE_DIFFERENT_OBJECT,
    MATCH_TYPE_MULTI_OBJECT,
    MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE,
    MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE,
    MATCH_TYPE_SYNTHETIC_MULTI_OBJECT,
)
from pdc_tpu_torch.utils.yaml_io import load_yaml


class ImageType:
    """Image-kind codes of ``get_image_filename``."""

    RGB = 0
    DEPTH = 1
    MASK = 2


DATA_TYPE_NAMES = {
    "SINGLE_OBJECT_WITHIN_SCENE": MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE,
    "SINGLE_OBJECT_ACROSS_SCENE": MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE,
    "DIFFERENT_OBJECT": MATCH_TYPE_DIFFERENT_OBJECT,
    "MULTI_OBJECT": MATCH_TYPE_MULTI_OBJECT,
    "SYNTHETIC_MULTI_OBJECT": MATCH_TYPE_SYNTHETIC_MULTI_OBJECT,
}


@dataclasses.dataclass
class SceneData:
    """In-memory frames of one scene log."""

    name: str
    rgb: np.ndarray    # [N, H, W, 3] uint8
    depth: np.ndarray  # [N, H, W] uint16 (mm)
    mask: np.ndarray   # [N, H, W] uint8
    poses: np.ndarray  # [N, 4, 4] float64 camera-to-world
    K: np.ndarray      # [3, 3]
    object_id: Optional[str] = None
    # on-disk %06d file indices of the frames (pose_data.yaml keys need not
    # start at 0 or be contiguous, and frames with missing files are dropped);
    # None => positions and file indices coincide
    frame_ids: Optional[np.ndarray] = None
    # source layout on disk (None for in-memory scenes)
    structure: Optional[SceneStructure] = None

    @property
    def num_frames(self):
        return self.rgb.shape[0]

    @property
    def file_indices(self) -> np.ndarray:
        """The file index of each frame position."""
        if self.frame_ids is None:
            return np.arange(self.num_frames)
        return self.frame_ids

    def position(self, file_idx: int) -> int:
        """Array position of the frame with file index ``file_idx``."""
        if self.frame_ids is None:
            if not 0 <= file_idx < self.num_frames:
                raise KeyError(f"scene {self.name}: no frame {file_idx}")
            return int(file_idx)
        pos = int(np.searchsorted(self.frame_ids, file_idx))
        if pos >= len(self.frame_ids) or self.frame_ids[pos] != file_idx:
            raise KeyError(f"scene {self.name}: no frame with file index "
                           f"{file_idx} (have {len(self.frame_ids)} frames "
                           f"in [{self.frame_ids[0]}, {self.frame_ids[-1]}])")
        return pos

    def frame_id(self, pos: int) -> int:
        """File index of the frame at array position ``pos``."""
        if self.frame_ids is None:
            return int(pos)
        return int(self.frame_ids[pos])

    @staticmethod
    def from_structure(structure: SceneStructure, name: str, object_id=None):
        """Decode a scene of the pdc on-disk layout: the frames of
        ``pose_data.yaml`` whose RGB and depth files exist, in file-index
        order (:func:`~pdc_tpu_torch.data.native_loader.load_scene_frames`,
        ``decoder="auto"``)."""
        from pdc_tpu_torch.data.native_loader import load_scene_frames

        intr = structure.load_camera_intrinsics()
        pose_map = structure.load_pose_data()
        indices = [i for i in sorted(pose_map)
                   if os.path.exists(structure.rgb_image_filename(i))
                   and os.path.exists(structure.depth_image_filename(i))]
        rgb, depth, mask = load_scene_frames(structure, indices, intr.height, intr.width)
        poses = np.stack([pose_map[i] for i in indices])
        ids = np.asarray(indices, np.int64)
        if ids.size and ids[0] == 0 and ids[-1] == ids.size - 1:
            ids = None  # contiguous from 0: positions == file indices
        return SceneData(name=name, rgb=rgb, depth=depth, mask=mask, poses=poses, K=intr.K,
                         object_id=object_id, frame_ids=ids, structure=structure)

    @staticmethod
    def from_synthetic(scene, name: str = "synthetic", object_id="synthetic_object"):
        rgb, depth, mask, poses = scene.render_all()
        return SceneData(name=name, rgb=rgb, depth=depth, mask=mask,
                         poses=poses, K=scene.K, object_id=object_id)


@dataclasses.dataclass
class SamplePair:
    """One host-sampled training pair (assembled on the device later)."""

    match_type: int
    rgb_a: np.ndarray
    depth_a: np.ndarray
    mask_a: np.ndarray
    pose_a: np.ndarray
    rgb_b: np.ndarray
    depth_b: np.ndarray
    mask_b: np.ndarray
    pose_b: np.ndarray
    K: np.ndarray
    metadata: dict
    # second within-scene pair (synthetic multi-object compositing only)
    second: "SamplePair | None" = None


class SpartanDataset:
    """Scene registry and pair sampler over :class:`SceneData`.

    Built from in-memory scenes (``scenes``, :meth:`add_scene`), or from a
    composite dataset config (``config`` with ``logs_root_path`` and
    ``single_object_scenes_config_files`` / ``multi_object_scenes_config_files``;
    scene lists resolved against ``config_dir``, scenes under
    ``<data_dir>/<logs_root_path>/<scene>/processed``). Each split
    (``"train"``, ``"test"``) has its own registry of scenes, single-object
    scenes by object id, and multi-object scenes; ``mode`` selects the split
    that sampling reads, and a composite config's split is loaded when it is
    first used.
    """

    # pose-difference rejection thresholds
    POSE_DIST_THRESHOLD = 0.2   # metres
    POSE_ANGLE_THRESHOLD = 20.0  # degrees

    def __init__(self, scenes: Optional[List[SceneData]] = None, mode: str = "train",
                 config: Optional[dict] = None, config_expanded: Optional[dict] = None,
                 data_dir: Optional[str] = None, config_dir: Optional[str] = None,
                 seed: int = 0):
        self.mode = mode
        self._rng = pyrandom.Random(seed)
        self._np_rng = np.random.RandomState(seed)
        self._registries: Dict[str, dict] = {}
        self.config = config_expanded or config or {}
        self._composite_config = None
        self._data_dir = data_dir
        self._config_dir = config_dir

        # training-config-injected parameters (defaults of the reference)
        self.num_matching_attempts = 10000
        self.num_non_matches_per_match = 150
        self.fraction_masked_non_matches = 0.5
        self.fraction_background_non_matches = 0.5
        self.cross_scene_num_samples = 10000
        self.sample_matches_only_off_mask = True
        self._use_image_b_mask_inv = True
        self._domain_randomize = True
        self._data_type_probabilities = {MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE: 1.0}

        if scenes is not None:
            for s in scenes:
                self.add_scene(s)
        elif config is not None and "single_object_scenes_config_files" in config:
            self._composite_config = config

    def config_snapshot(self) -> dict:
        """The config dict that a model folder's ``dataset.yaml`` records. A
        composite config also records the absolute ``data_dir`` and
        ``config_dir``, so :meth:`from_dataset_config` rebuilds the dataset
        from the record alone."""
        cfg = dict(self.config or {})
        if self._composite_config is not None:
            cfg["data_dir"] = os.path.abspath(self._data_dir or ".")
            if self._config_dir is not None:
                cfg["config_dir"] = os.path.abspath(self._config_dir)
        return cfg

    def reset_seed(self, seed: int = 1):
        """Re-seed both host RNGs (evaluation entry points do, so that their
        results repeat)."""
        self._rng = pyrandom.Random(seed)
        self._np_rng = np.random.RandomState(seed)

    # -- construction ---------------------------------------------------------

    def _registry(self, mode: str) -> dict:
        """A split's registry; a composite config's split is decoded here, at
        its first use."""
        if mode not in self._registries:
            self._registries[mode] = {"scenes": {}, "single": {}, "multi": []}
            if self._composite_config is not None:
                self._load_from_composite_config(self._composite_config, self._data_dir,
                                                 self._config_dir, mode)
        return self._registries[mode]

    def add_scene(self, scene: SceneData, multi_object: bool = False,
                  modes=("train", "test")):
        """Register a scene in each split of ``modes`` (both by default)."""
        if isinstance(modes, str):
            modes = (modes,)
        for mode in modes:
            reg = self._registry(mode)
            reg["scenes"][scene.name] = scene
            if multi_object:
                reg["multi"].append(scene.name)
            else:
                oid = scene.object_id or scene.name
                reg["single"].setdefault(oid, []).append(scene.name)

    def _load_from_composite_config(self, config, data_dir, config_dir, mode=None):
        """Register the scenes of split ``mode`` of a composite config: each
        scene-list YAML names an object (``object_id``, else its file name)
        and its ``train``/``test`` scenes (``scenes`` for both)."""
        from pdc_tpu_torch.data.config_gen import resolve_scene_list_path

        logs_dir = os.path.join(data_dir or os.environ.get("DC_DATA_DIR", "."),
                                config.get("logs_root_path", "logs_proto"))
        split = mode or self.mode

        def load_scene_list(scene_cfg_file, multi_object):
            path = resolve_scene_list_path(scene_cfg_file, config_dir)
            sc = load_yaml(path)
            object_id = sc.get("object_id", os.path.splitext(os.path.basename(path))[0])
            for scene_name in sc.get(split, sc.get("scenes", [])):
                structure = SceneStructure(os.path.join(logs_dir, scene_name, "processed"))
                self.add_scene(SceneData.from_structure(structure, scene_name, object_id),
                               multi_object=multi_object, modes=(split,))

        for f in config.get("single_object_scenes_config_files", []):
            load_scene_list(f, multi_object=False)
        for f in config.get("multi_object_scenes_config_files", []):
            load_scene_list(f, multi_object=True)

    # -- train/test mode -------------------------------------------------------

    def set_train_mode(self):
        self.mode = "train"

    def set_test_mode(self):
        self.mode = "test"

    # -- parameter injection ----------------------------------------------------

    def set_parameters_from_training_config(self, training_config: dict):
        """Read the sampling parameters and the type mix of a training
        config's ``training`` block."""
        t = training_config["training"]
        self.num_matching_attempts = int(t["num_matching_attempts"])
        self.sample_matches_only_off_mask = bool(t["sample_matches_only_off_mask"])
        self.num_non_matches_per_match = int(t["num_non_matches_per_match"])
        self.fraction_masked_non_matches = float(t["fraction_masked_non_matches"])
        self.fraction_background_non_matches = float(t["fraction_background_non_matches"])
        self._use_image_b_mask_inv = bool(t.get("use_image_b_mask_inv", True))
        self.cross_scene_num_samples = int(t.get("cross_scene_num_samples", 10000))
        self._domain_randomize = bool(t.get("domain_randomize", True))
        probs = t.get("data_type_probabilities", {"SINGLE_OBJECT_WITHIN_SCENE": 1})
        self._data_type_probabilities = {
            DATA_TYPE_NAMES[k]: float(v) for k, v in probs.items() if float(v) > 0
        }

    @property
    def num_masked_non_matches_per_match(self):
        return int(self.num_non_matches_per_match * self.fraction_masked_non_matches)

    @property
    def num_background_non_matches_per_match(self):
        return int(self.num_non_matches_per_match * self.fraction_background_non_matches)

    # -- basic accessors ---------------------------------------------------------

    @property
    def _scenes(self) -> Dict[str, SceneData]:
        return self._registry(self.mode)["scenes"]

    @property
    def _single_object_scene_names(self) -> Dict[str, List[str]]:
        return self._registry(self.mode)["single"]

    @property
    def _multi_object_scene_names(self) -> List[str]:
        return self._registry(self.mode)["multi"]

    @property
    def scenes(self):
        return self._scenes

    @property
    def num_scenes(self):
        return len(self._scenes)

    def get_number_of_unique_single_objects(self):
        return len(self._single_object_scene_names)

    def get_random_object_id_and_int(self):
        ids = sorted(self._single_object_scene_names.keys())
        i = self._rng.randrange(len(ids))
        return ids[i], i

    @property
    def num_images_total(self):
        return sum(s.num_frames for s in self._scenes.values())

    def get_scene(self, name) -> SceneData:
        """Scene lookup: the active split first, then the other one."""
        if name in self._scenes:
            return self._scenes[name]
        for mode in ("train", "test"):
            reg = self._registry(mode)
            if name in reg["scenes"]:
                return reg["scenes"][name]
        raise KeyError(name)

    def get_random_scene_name(self) -> str:
        return self._rng.choice(sorted(self._scenes.keys()))

    def get_random_single_object_scene_name(self, object_id: str) -> str:
        return self._rng.choice(self._single_object_scene_names[object_id])

    def get_random_object_id(self) -> str:
        return self._rng.choice(sorted(self._single_object_scene_names.keys()))

    def get_two_different_object_ids(self):
        ids = sorted(self._single_object_scene_names.keys())
        if len(ids) < 2:
            raise AssertionError("need >= 2 objects for DIFFERENT_OBJECT samples")
        a, b = self._rng.sample(ids, 2)
        return a, b

    def get_different_scene_for_object(self, object_id: str, scene_name: str) -> str:
        others = [s for s in self._single_object_scene_names[object_id] if s != scene_name]
        if not others:
            raise AssertionError(f"object {object_id} has only one scene")
        return self._rng.choice(others)

    def has_multi_object_scenes(self):
        return len(self._multi_object_scene_names) > 0

    def get_random_multi_object_scene_name(self) -> str:
        return self._rng.choice(self._multi_object_scene_names)

    # -- pair sampling -------------------------------------------------------------

    def get_random_image_index(self, scene_name: str) -> int:
        """A random frame's file index."""
        scene = self._scenes[scene_name]
        return scene.frame_id(self._rng.randrange(scene.num_frames))

    def get_img_idx_with_different_pose(self, scene_name: str, pose_a, num_attempts: int = 50):
        """Rejection-sample a frame (its file index) whose pose differs from
        ``pose_a`` by more than 0.2 m or 20 degrees; None after
        ``num_attempts`` failures."""
        scene = self._scenes[scene_name]
        for _ in range(num_attempts):
            idx = self.get_random_image_index(scene_name)
            pose_b = scene.poses[scene.position(idx)]
            if (
                pose_distance(pose_a, pose_b) > self.POSE_DIST_THRESHOLD
                or np.degrees(pose_angle(pose_a, pose_b)) > self.POSE_ANGLE_THRESHOLD
            ):
                return idx
        return None

    def _draw_match_type(self) -> int:
        types = sorted(self._data_type_probabilities.keys())
        weights = [self._data_type_probabilities[t] for t in types]
        return int(self._rng.choices(types, weights=weights, k=1)[0])

    def sample_pair(self, match_type: Optional[int] = None) -> SamplePair:
        """Draw one training pair of the configured type mix (or of
        ``match_type``): within-scene types take two views of one scene that
        differ enough in pose, across-scene and different-object types one
        frame from each of two scenes, synthetic multi-object two
        within-scene pairs of two objects. A within-scene pair whose
        rejection sampler fails is the empty pair, type -1."""
        if match_type is None:
            match_type = self._draw_match_type()

        if match_type == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT:
            try:
                oid_a, oid_b = self.get_two_different_object_ids()
            except AssertionError:
                oid_a = oid_b = self.get_random_object_id()
            scene_a = self.get_random_single_object_scene_name(oid_a)
            scene_b = self.get_random_single_object_scene_name(oid_b)
            p1 = self._within_scene_pair(scene_a, MATCH_TYPE_SYNTHETIC_MULTI_OBJECT)
            p2 = self._within_scene_pair(scene_b, MATCH_TYPE_SYNTHETIC_MULTI_OBJECT)
            if p1.match_type == -1 or p2.match_type == -1:
                return p1 if p1.match_type == -1 else p2
            p1.metadata.update(object_id_a=oid_a, object_id_b=oid_b,
                               scene_name_b=scene_b)
            return dataclasses.replace(p1, second=p2)

        if match_type in (
            MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE,
            MATCH_TYPE_MULTI_OBJECT,
        ):
            if match_type == MATCH_TYPE_MULTI_OBJECT and self.has_multi_object_scenes():
                scene_name = self.get_random_multi_object_scene_name()
            else:
                scene_name = self.get_random_scene_name()
            return self._within_scene_pair(scene_name, match_type)

        if match_type == MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE:
            object_id = self.get_random_object_id()
            scene_name_a = self.get_random_single_object_scene_name(object_id)
            try:
                scene_name_b = self.get_different_scene_for_object(object_id, scene_name_a)
            except AssertionError:
                scene_name_b = scene_name_a
            meta = {"object_id": object_id}
        elif match_type == MATCH_TYPE_DIFFERENT_OBJECT:
            oid_a, oid_b = self.get_two_different_object_ids()
            scene_name_a = self.get_random_single_object_scene_name(oid_a)
            scene_name_b = self.get_random_single_object_scene_name(oid_b)
            meta = {"object_id_a": oid_a, "object_id_b": oid_b}
        else:
            raise ValueError(f"unknown match_type {match_type}")

        scene_a = self._scenes[scene_name_a]
        scene_b = self._scenes[scene_name_b]
        idx_a = self.get_random_image_index(scene_name_a)
        idx_b = self.get_random_image_index(scene_name_b)
        meta.update({"scene_name_a": scene_name_a, "scene_name_b": scene_name_b,
                     "image_a_idx": idx_a, "image_b_idx": idx_b, "type": match_type})
        pa, pb = scene_a.position(idx_a), scene_b.position(idx_b)
        return SamplePair(
            match_type=match_type,
            rgb_a=scene_a.rgb[pa], depth_a=scene_a.depth[pa],
            mask_a=scene_a.mask[pa], pose_a=scene_a.poses[pa],
            rgb_b=scene_b.rgb[pb], depth_b=scene_b.depth[pb],
            mask_b=scene_b.mask[pb], pose_b=scene_b.poses[pb],
            K=scene_a.K,
            metadata=meta,
        )

    def _within_scene_pair(self, scene_name: str, match_type: int) -> SamplePair:
        """Two views of one scene that differ enough in pose, or the empty
        pair when the rejection sampler fails."""
        scene = self._scenes[scene_name]
        idx_a = self.get_random_image_index(scene_name)
        pa = scene.position(idx_a)
        idx_b = self.get_img_idx_with_different_pose(scene_name, scene.poses[pa])
        if idx_b is None:
            return self._empty_pair(scene, pa)
        pb = scene.position(idx_b)
        return SamplePair(
            match_type=match_type,
            rgb_a=scene.rgb[pa], depth_a=scene.depth[pa],
            mask_a=scene.mask[pa], pose_a=scene.poses[pa],
            rgb_b=scene.rgb[pb], depth_b=scene.depth[pb],
            mask_b=scene.mask[pb], pose_b=scene.poses[pb],
            K=scene.K,
            metadata={"scene_name": scene_name, "image_a_idx": idx_a,
                      "image_b_idx": idx_b, "type": match_type},
        )

    def _empty_pair(self, scene, pos_a):
        """The empty pair (type -1): frame a twice; its loss is zeroed."""
        return SamplePair(
            match_type=-1,
            rgb_a=scene.rgb[pos_a], depth_a=scene.depth[pos_a],
            mask_a=scene.mask[pos_a], pose_a=scene.poses[pos_a],
            rgb_b=scene.rgb[pos_a], depth_b=scene.depth[pos_a],
            mask_b=scene.mask[pos_a], pose_b=scene.poses[pos_a],
            K=scene.K,
            metadata={"type": -1},
        )

    def make_host_batch(self, batch_size: int, with_second_pair: bool = None):
        """Stack ``batch_size`` sampled pairs into numpy arrays, the batch
        dict that :func:`~pdc_tpu_torch.data.assembler.assemble_batch_matrix`
        and :func:`~pdc_tpu_torch.data.assembler.assemble_batch` read. With
        synthetic multi-object in the type mix (or ``with_second_pair``),
        ``*_2`` arrays carry each pair's second pair (the pair itself for the
        other types)."""
        pairs = [self.sample_pair() for _ in range(batch_size)]
        if with_second_pair is None:
            with_second_pair = MATCH_TYPE_SYNTHETIC_MULTI_OBJECT in self._data_type_probabilities
        batch = {
            "match_type": np.asarray([p.match_type for p in pairs], np.int32),
            "rgb_a": np.stack([p.rgb_a for p in pairs]),
            "depth_a": np.stack([p.depth_a for p in pairs]),
            "mask_a": np.stack([p.mask_a for p in pairs]),
            "pose_a": np.stack([p.pose_a for p in pairs]).astype(np.float32),
            "rgb_b": np.stack([p.rgb_b for p in pairs]),
            "depth_b": np.stack([p.depth_b for p in pairs]),
            "mask_b": np.stack([p.mask_b for p in pairs]),
            "pose_b": np.stack([p.pose_b for p in pairs]).astype(np.float32),
            "K": np.stack([p.K for p in pairs]).astype(np.float32),
        }
        if with_second_pair:
            seconds = [p.second if p.second is not None else p for p in pairs]
            batch.update({
                "rgb_a_2": np.stack([p.rgb_a for p in seconds]),
                "depth_a_2": np.stack([p.depth_a for p in seconds]),
                "mask_a_2": np.stack([p.mask_a for p in seconds]),
                "pose_a_2": np.stack([p.pose_a for p in seconds]).astype(np.float32),
                "rgb_b_2": np.stack([p.rgb_b for p in seconds]),
                "depth_b_2": np.stack([p.depth_b for p in seconds]),
                "mask_b_2": np.stack([p.mask_b for p in seconds]),
                "pose_b_2": np.stack([p.pose_b for p in seconds]).astype(np.float32),
                "K_2": np.stack([p.K for p in seconds]).astype(np.float32),
            })
        return batch

    # -- accessors of the reference's API -------------------------------------

    def get_rgbd_mask_pose(self, scene_name: str, img_idx: int):
        """(rgb, depth, mask, pose) of the frame with file index ``img_idx``."""
        s = self.get_scene(scene_name)
        p = s.position(img_idx)
        return s.rgb[p], s.depth[p], s.mask[p], s.poses[p]

    def get_camera_intrinsics(self, scene_name: str):
        from pdc_tpu_torch.geom.camera import CameraIntrinsics

        s = self.get_scene(scene_name)
        H, W = s.rgb.shape[1:3]
        K = np.asarray(s.K)
        return CameraIntrinsics(cx=K[0, 2], cy=K[1, 2], fx=K[0, 0], fy=K[1, 1],
                                width=W, height=H)

    def get_pose_from_scene_name_and_idx(self, scene_name: str, img_idx: int):
        s = self.get_scene(scene_name)
        return s.poses[s.position(img_idx)]

    def get_rgb_image_from_scene_name_and_idx(self, scene_name: str, img_idx: int):
        s = self.get_scene(scene_name)
        return s.rgb[s.position(img_idx)]

    def get_mask_image_from_scene_name_and_idx(self, scene_name: str, img_idx: int):
        s = self.get_scene(scene_name)
        return s.mask[s.position(img_idx)]

    def get_depth_image_from_scene_name_and_idx(self, scene_name: str, img_idx: int):
        s = self.get_scene(scene_name)
        return s.depth[s.position(img_idx)]

    def get_image_mean(self):
        from pdc_tpu_torch.utils.constants import DEFAULT_IMAGE_MEAN

        return list(DEFAULT_IMAGE_MEAN)

    def get_image_std_dev(self):
        from pdc_tpu_torch.utils.constants import DEFAULT_IMAGE_STD

        return list(DEFAULT_IMAGE_STD)

    def rgb_image_to_tensor(self, rgb):
        """uint8 [H,W,3] -> normalized float32 [H,W,3] (NHWC)."""
        x = np.asarray(rgb, np.float32) / 255.0
        mean = np.asarray(self.get_image_mean(), np.float32)
        std = np.asarray(self.get_image_std_dev(), np.float32)
        return (x - mean) / std

    def scene_generator(self, mode=None):
        """Every scene name of a split: single-object scenes by object id,
        then multi-object scenes."""
        reg = self._registry(mode or self.mode)
        for object_id in sorted(reg["single"].keys()):
            for scene_name in reg["single"][object_id]:
                yield scene_name
        for scene_name in reg["multi"]:
            yield scene_name

    def get_scene_list(self, mode=None):
        return list(self.scene_generator(mode=mode))

    def get_list_of_objects(self):
        return sorted(self._registry(self.mode)["single"].keys())

    def get_scene_list_for_object(self, object_id: str, mode=None):
        return list(self._registry(mode or self.mode)["single"][object_id])

    def get_full_path_for_scene(self, scene_name: str) -> str:
        """Path to the scene's ``processed/`` folder; in-memory scenes have
        none."""
        s = self.get_scene(scene_name)
        if s.structure is None:
            raise ValueError(
                f"scene {scene_name} is in-memory (synthetic); it has no "
                "on-disk processed folder")
        return s.structure.processed_folder

    def get_image_filename(self, scene_name: str, img_idx: int, image_type: int) -> str:
        """Path of one frame's RGB, depth or mask PNG; in-memory scenes have
        none."""
        s = self.get_scene(scene_name)
        if s.structure is None:
            raise ValueError(f"scene {scene_name} has no on-disk files")
        if image_type == ImageType.RGB:
            return s.structure.rgb_image_filename(img_idx)
        if image_type == ImageType.DEPTH:
            return s.structure.depth_image_filename(img_idx)
        if image_type == ImageType.MASK:
            return s.structure.mask_image_filename(img_idx)
        raise ValueError(f"unknown image_type {image_type}")

    def get_first_image_index(self, scene_name: str) -> int:
        return int(self.get_scene(scene_name).file_indices[0])

    def get_random_rgbd_mask_pose(self):
        """(rgb, depth, mask, pose) of a random frame of a random scene."""
        scene_name = self.get_random_scene_name()
        idx = self.get_random_image_index(scene_name)
        return self.get_rgbd_mask_pose(scene_name, idx)

    def load_all_pose_data(self):
        """No-op: poses are loaded with the scenes."""

    @staticmethod
    def flatten_uv_tensor(uv_tensor, image_width: int):
        """(u, v) -> flat ``v * W + u`` indices."""
        u, v = uv_tensor
        return np.asarray(v) * image_width + np.asarray(u)

    @staticmethod
    def mask_image_from_uv_flat_tensor(uv_flat_tensor, image_width: int,
                                       image_height: int):
        """[W*H] 0/1 vector with ones at the given flat pixel indices."""
        img = np.zeros(image_width * image_height, np.int64)
        img[np.asarray(uv_flat_tensor, np.int64)] = 1
        return img

    @staticmethod
    def make_synthetic(num_scenes: int = 2, num_objects: int = 2,
                       num_test_scenes: int = 0, seed_offset: int = 0,
                       **scene_kwargs):
        """An in-memory dataset of synthetic scenes (tests, the card's smoke
        run). Scenes of one object share its texture, objects differ.
        ``num_test_scenes`` > 0 gives a held-out test split of the same
        objects (other camera orbits), else both splits share the scenes;
        ``seed_offset`` shifts every scene's orbit seed. The arguments are
        recorded in ``self.config``, the ``dataset.yaml`` record from which
        :meth:`from_dataset_config` rebuilds the dataset."""
        from pdc_tpu_torch.data.synthetic import SyntheticScene

        ds = SpartanDataset()
        ds.config = {"synthetic": dict(num_scenes=num_scenes,
                                       num_objects=num_objects,
                                       num_test_scenes=num_test_scenes,
                                       seed_offset=seed_offset,
                                       **scene_kwargs)}
        for i in range(num_scenes):
            obj = i % max(num_objects, 1)
            sc = SyntheticScene(seed=seed_offset + i, texture_seed=obj,
                                **scene_kwargs)
            modes = ("train",) if num_test_scenes > 0 else ("train", "test")
            ds.add_scene(SceneData.from_synthetic(sc, name=f"scene_{i:03d}",
                                                  object_id=f"object_{obj}"),
                         modes=modes)
        for j in range(num_test_scenes):
            obj = j % max(num_objects, 1)
            sc = SyntheticScene(seed=1000 + seed_offset + j,
                                texture_seed=obj, **scene_kwargs)
            ds.add_scene(SceneData.from_synthetic(sc, name=f"test_scene_{j:03d}",
                                                  object_id=f"object_{obj}"),
                         modes=("test",))
        return ds

    @staticmethod
    def from_dataset_config(config: dict, mode: str = "train",
                            data_dir=None, config_dir=None):
        """Rebuild a dataset from a model folder's ``dataset.yaml`` record:
        the synthetic-generator record, or a composite scene-list config with
        the ``data_dir``/``config_dir`` that :meth:`config_snapshot` records
        (the arguments, when given, take precedence)."""
        if config and "synthetic" in config:
            ds = SpartanDataset.make_synthetic(**config["synthetic"])
            ds.mode = mode
            return ds
        config = dict(config or {})
        data_dir = data_dir or config.pop("data_dir", None)
        config_dir = config_dir or config.pop("config_dir", None)
        return SpartanDataset(config=config, mode=mode,
                              data_dir=data_dir, config_dir=config_dir)
