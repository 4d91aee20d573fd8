"""The dataset's frames held on the device.

Port of :mod:`pdc_tpu.data.device_cache`: ``DeviceCache`` (:29-173),
``build_pixel_perms`` (:176-191) and ``make_cached_train_step`` (:356-408).
The frame stacks of every scene go to the device once; a step then sends
only frame indices and poses, and its images are gathered on the device.

    cache = DeviceCache.from_dataset(dataset, device="cuda")
    idx = cache.sample_index_batch(B)     # host arrays, the dataset's sampler
    batch = cache.gather(idx)             # device tensors, the schema of
                                          # SpartanDataset.make_host_batch

The stacks keep the frames' dtypes (rgb and mask uint8, depth uint16); poses
and intrinsics stay on the host, as in the JAX package. ``pixel_perm`` holds
each frame's valid-first pixel permutation (int32, as there), so masked
sampling in the assembler is one draw and one gather.

``partition_scenes`` (:194) and ``ShardedDeviceCache`` (:227-353) split the
scenes over the ranks of a data axis
(:mod:`pdc_tpu_torch.parallel.mesh`): each rank uploads only the frames of
its own scenes, and its pair sampler reads only its own tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from pdc_tpu_torch.losses.composer import MATCH_TYPE_SYNTHETIC_MULTI_OBJECT
from pdc_tpu_torch.training.train import TrainState, TrainStep
from pdc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DeviceCache:
    rgb: torch.Tensor     # [F, H, W, 3] uint8, all scenes concatenated
    depth: torch.Tensor   # [F, H, W] uint16
    mask: torch.Tensor    # [F, H, W] uint8
    poses: np.ndarray     # [F, 4, 4] float32 (host)
    Ks: np.ndarray        # [F, 3, 3] float32 (host)
    scene_offsets: Dict[str, int]
    scene_lengths: Dict[str, int]
    dataset: object
    # pixel_perm[f, :mask_count[f]] are frame f's mask pixels (flat
    # indices), the rest its background
    pixel_perm: torch.Tensor  # [F, H*W] int32
    mask_count: torch.Tensor  # [F] int32

    @staticmethod
    def from_dataset(dataset, max_bytes: int = 8 << 30, device="cuda") -> "DeviceCache":
        """Put every scene of the dataset's active split on ``device``, in
        sorted scene-name order, with each frame's valid-first pixel
        permutation (4 more bytes per pixel). Raises ``MemoryError`` when
        the frames exceed ``max_bytes`` (the caller then streams from the
        host)."""
        dev = resolve_device(device)
        rgbs, depths, masks, poses, Ks = [], [], [], [], []
        offsets, lengths = {}, {}
        off = 0
        total = 0
        for name in sorted(dataset.scenes.keys()):
            s = dataset.scenes[name]
            offsets[name] = off
            lengths[name] = s.num_frames
            off += s.num_frames
            total += s.rgb.nbytes + s.depth.nbytes + s.mask.nbytes
            if total > max_bytes:
                raise MemoryError(
                    f"dataset exceeds device-cache budget ({total} > {max_bytes} B); "
                    "stream from host instead"
                )
            rgbs.append(s.rgb)
            depths.append(s.depth)
            masks.append(s.mask)
            poses.append(s.poses.astype(np.float32))
            Ks.append(np.broadcast_to(s.K.astype(np.float32), (s.num_frames, 3, 3)))

        def put(arrays):
            return torch.from_numpy(np.concatenate(arrays)).to(dev)

        mask_stack = put(masks)
        perm, count = build_pixel_perms(mask_stack)
        return DeviceCache(
            rgb=put(rgbs),
            depth=put(depths),
            mask=mask_stack,
            poses=np.concatenate(poses),
            Ks=np.concatenate(Ks),
            scene_offsets=offsets,
            scene_lengths=lengths,
            dataset=dataset,
            pixel_perm=perm,
            mask_count=count,
        )

    @property
    def device(self) -> torch.device:
        return self.rgb.device

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in (self.rgb, self.depth, self.mask))

    # -- sampling ------------------------------------------------------------

    def sample_index_batch(self, batch_size: int) -> dict:
        """The dataset's host sampler (type mix, pose rejection), returning
        global frame indices, poses and intrinsics only."""
        def global_frames(pair):
            meta = pair.metadata
            if pair.match_type == -1:
                scene = meta.get("scene_name") or sorted(self.scene_offsets)[0]
                return self.scene_offsets[scene], self.scene_offsets[scene]
            if "scene_name" in meta:
                base = self.scene_offsets[meta["scene_name"]]
                return base + meta["image_a_idx"], base + meta["image_b_idx"]
            return (
                self.scene_offsets[meta["scene_name_a"]] + meta["image_a_idx"],
                self.scene_offsets[meta["scene_name_b"]] + meta["image_b_idx"],
            )

        pairs = [self.dataset.sample_pair() for _ in range(batch_size)]
        frames = [global_frames(p) for p in pairs]
        out = {
            "frame_a": np.asarray([f[0] for f in frames], np.int32),
            "frame_b": np.asarray([f[1] for f in frames], np.int32),
            "match_type": np.asarray([p.match_type for p in pairs], np.int32),
            "pose_a": np.stack([p.pose_a.astype(np.float32) for p in pairs]),
            "pose_b": np.stack([p.pose_b.astype(np.float32) for p in pairs]),
            "K": np.stack([p.K.astype(np.float32) for p in pairs]),
        }
        if MATCH_TYPE_SYNTHETIC_MULTI_OBJECT in getattr(
            self.dataset, "_data_type_probabilities", {}
        ):
            seconds = [p.second if p.second is not None else p for p in pairs]
            frames2 = [global_frames(s) for s in seconds]
            out.update({
                "frame_a_2": np.asarray([f[0] for f in frames2], np.int32),
                "frame_b_2": np.asarray([f[1] for f in frames2], np.int32),
                "pose_a_2": np.stack([s.pose_a.astype(np.float32) for s in seconds]),
                "pose_b_2": np.stack([s.pose_b.astype(np.float32) for s in seconds]),
                "K_2": np.stack([s.K.astype(np.float32) for s in seconds]),
            })
        return out

    def gather(self, index_batch: dict) -> dict:
        """Index batch (host arrays or device tensors) -> the full batch as
        device tensors, the frames gathered on the device."""
        dev = self.device

        def on_device(x):
            return torch.as_tensor(x, device=dev)

        out = {"match_type": on_device(index_batch["match_type"])}
        for suffix in ("", "_2"):
            if "frame_a" + suffix not in index_batch:
                continue
            fa = on_device(index_batch["frame_a" + suffix]).to(torch.int64)
            fb = on_device(index_batch["frame_b" + suffix]).to(torch.int64)
            out.update({
                "rgb_a" + suffix: self.rgb.index_select(0, fa),
                "depth_a" + suffix: self.depth.index_select(0, fa),
                "mask_a" + suffix: self.mask.index_select(0, fa),
                "pose_a" + suffix: on_device(index_batch["pose_a" + suffix]),
                "rgb_b" + suffix: self.rgb.index_select(0, fb),
                "depth_b" + suffix: self.depth.index_select(0, fb),
                "mask_b" + suffix: self.mask.index_select(0, fb),
                "pose_b" + suffix: on_device(index_batch["pose_b" + suffix]),
                "K" + suffix: on_device(index_batch["K" + suffix]),
            })
            if suffix == "":
                out.update({
                    "perm_a": self.pixel_perm.index_select(0, fa),
                    "count_a": self.mask_count.index_select(0, fa),
                    "perm_b": self.pixel_perm.index_select(0, fb),
                    "count_b": self.mask_count.index_select(0, fb),
                })
        return out


def build_pixel_perms(mask_stack: torch.Tensor, chunk: int = 64):
    """Valid-first pixel permutations of a ``[F, H, W]`` mask stack, on its
    device, ``chunk`` frames at a time so the sort's working set stays
    bounded: ``(pixel_perm [F, H*W] int32, mask_count [F] int32)``."""
    from pdc_tpu_torch.ops.sampling import build_pixel_perm

    perms, counts = [], []
    for start in range(0, mask_stack.shape[0], chunk):
        p, c = build_pixel_perm(mask_stack[start:start + chunk])
        perms.append(p.to(torch.int32))
        counts.append(c.to(torch.int32))
    return torch.cat(perms), torch.cat(counts)


class CachedTrainStep(TrainStep):
    """``step(state, index_batch, generator) -> metrics``: the frames of an
    index batch (:meth:`DeviceCache.sample_index_batch`) gathered from the
    cache on the device, then :class:`~pdc_tpu_torch.training.train.TrainStep`'s
    assembly and update."""

    def __init__(self, *args, cache: DeviceCache, **kwargs):
        super().__init__(*args, **kwargs)
        self.cache = cache

    def assemble(self, state: TrainState, index_batch: dict, generator: torch.Generator):
        return super().assemble(state, self.cache.gather(index_batch), generator)


def make_cached_train_step(training_config: dict, loss_cfg, assembler_cfg,
                           image_width: int, cache: DeviceCache) -> CachedTrainStep:
    """The train step over index batches of ``cache``; no image crosses the
    host link per step."""
    return CachedTrainStep(training_config, loss_cfg, assembler_cfg, image_width, cache=cache)


def partition_scenes(dataset, num_shards: int, by_object: bool = False):
    """Greedy balanced partition of whole scenes over shards: the largest
    unit first, to the least-loaded shard (the first on ties). Whole
    scenes keep within-scene pairs on one rank; ``by_object`` keeps all the
    scenes of an object together, so across-scene pairs are too. Raises
    ``ValueError`` when a shard gets nothing."""
    if by_object:
        objects = {}
        for name, s in dataset.scenes.items():
            objects.setdefault(s.object_id or name, []).append(name)
        units = [(sorted(names), sum(dataset.scenes[n].num_frames for n in names))
                 for names in objects.values()]
    else:
        units = [([name], dataset.scenes[name].num_frames) for name in dataset.scenes]
    units.sort(key=lambda u: -u[1])
    shards = [[] for _ in range(num_shards)]
    loads = [0] * num_shards
    for names, frames in units:
        i = int(np.argmin(loads))
        shards[i].extend(names)
        loads[i] += frames
    for i, names in enumerate(shards):
        if not names:
            kind = "objects" if by_object else "scenes"
            raise ValueError(f"shard {i} received no scenes: the dataset has too few {kind} "
                             f"for {num_shards} shards")
    return shards


def sharded_tables(dataset, shards) -> dict:
    """The host tables of every shard, padded as the JAX package pads them:
    ``scene_offsets``/``scene_lengths`` ``[n, Smax]`` (offsets local to the
    shard's block, 0 padding), ``num_scenes [n, 1]``, ``scenes_by_object
    [n, Omax, Mmax]`` (local scene slots, -1 padding), ``scenes_per_object
    [n, Omax]`` and ``num_objects [n, 1]``, all int32, and
    ``frames_per_shard`` (the largest shard's frames)."""
    n = len(shards)
    fmax = max(sum(dataset.scenes[nm].num_frames for nm in names) for names in shards)
    smax = max(len(names) for names in shards)
    offsets = np.zeros((n, smax), np.int32)
    lengths = np.zeros((n, smax), np.int32)
    nums = np.zeros((n, 1), np.int32)
    shard_objects = []
    for c, names in enumerate(shards):
        objs, off = {}, 0
        for j, name in enumerate(sorted(names)):
            objs.setdefault(dataset.scenes[name].object_id or name, []).append(j)
            f = dataset.scenes[name].num_frames
            offsets[c, j], lengths[c, j] = off, f
            off += f
        nums[c, 0] = len(names)
        shard_objects.append(objs)
    omax = max(len(o) for o in shard_objects)
    mmax = max(max(len(v) for v in o.values()) for o in shard_objects)
    by_obj = np.full((n, omax, mmax), -1, np.int32)
    per_obj = np.zeros((n, omax), np.int32)
    num_obj = np.zeros((n, 1), np.int32)
    for c, objs in enumerate(shard_objects):
        for oi, oid in enumerate(sorted(objs)):
            by_obj[c, oi, :len(objs[oid])] = objs[oid]
            per_obj[c, oi] = len(objs[oid])
        num_obj[c, 0] = len(objs)
    return {"scene_offsets": offsets, "scene_lengths": lengths, "num_scenes": nums,
            "scenes_by_object": by_obj, "scenes_per_object": per_obj, "num_objects": num_obj,
            "frames_per_shard": fmax}


@dataclasses.dataclass
class ShardedDeviceCache:
    """The frames split over a mesh's data axis: this rank holds only the
    ``frames_per_shard`` rows of its scenes (zero-padded past them), so the
    frames cost ``1/n`` of the dataset per device.

    Port of ``pdc_tpu/data/device_cache.py:227-353``. Where the JAX cache
    is one global array sharded over the mesh (``[n * Fmax, ...]``, tables
    ``[n, ...]``), each rank here keeps its own block (``[Fmax, ...]``) and
    its own row of the tables on its device; ``tables`` keeps every
    shard's host tables, as :func:`sharded_tables` pads them."""

    rgb: torch.Tensor            # [Fmax, H, W, 3] uint8, this rank's block
    depth: torch.Tensor          # [Fmax, H, W] uint16
    mask: torch.Tensor           # [Fmax, H, W] uint8
    poses: torch.Tensor          # [Fmax, 4, 4] float32 (identity padding)
    Ks: torch.Tensor             # [Fmax, 3, 3] float32
    pixel_perm: torch.Tensor     # [Fmax, H*W] int32
    mask_count: torch.Tensor     # [Fmax] int32
    scene_offsets: torch.Tensor  # [Smax] int64, local to the block
    scene_lengths: torch.Tensor  # [Smax] int64 (0 = padding)
    num_scenes: int
    scenes_by_object: torch.Tensor   # [Omax, Mmax] int64 local scene slots, -1 padded
    scenes_per_object: torch.Tensor  # [Omax] int64
    num_objects: int
    frames_per_shard: int
    assignment: dict             # scene name -> shard index
    tables: dict                 # every shard's host tables (sharded_tables)
    mesh: object
    data_axis: str
    dataset: object

    @staticmethod
    def from_dataset(dataset, mesh, data_axis: str = "data",
                     max_bytes_per_device: int = 8 << 30,
                     by_object: bool = False) -> "ShardedDeviceCache":
        """Partition the scenes (:func:`partition_scenes`) and upload this
        rank's. ``by_object`` keeps each object's scenes on one rank, so the
        across-scene and different-object types stay local (different-object
        also needs 2 objects on the rank). Raises ``MemoryError`` when a
        shard's frames exceed ``max_bytes_per_device``."""
        n, c = mesh.shape[data_axis], mesh.index[data_axis]
        shards = partition_scenes(dataset, n, by_object=by_object)
        # every rank checks every shard (from frame counts, decoding only its
        # own scenes), so all raise alike
        sample = dataset.scenes[sorted(shards[c])[0]]
        H, W = sample.rgb.shape[1:3]
        frame_bytes = H * W * (3 + sample.depth.dtype.itemsize + 1)
        for i, names in enumerate(shards):
            per_device = frame_bytes * sum(dataset.scenes[nm].num_frames for nm in names)
            if per_device > max_bytes_per_device:
                raise MemoryError(f"shard {i} exceeds the per-device budget "
                                  f"({per_device} > {max_bytes_per_device} B)")
        tables = sharded_tables(dataset, shards)
        fmax = tables["frames_per_shard"]
        rgb = np.zeros((fmax, H, W, 3), np.uint8)
        depth = np.zeros((fmax, H, W), sample.depth.dtype)
        mask = np.zeros((fmax, H, W), np.uint8)
        poses = np.tile(np.eye(4, dtype=np.float32), (fmax, 1, 1))
        Ks = np.tile(np.eye(3, dtype=np.float32), (fmax, 1, 1))
        off = 0
        for name in sorted(shards[c]):
            s = dataset.scenes[name]
            f = s.num_frames
            rgb[off:off + f], depth[off:off + f], mask[off:off + f] = s.rgb, s.depth, s.mask
            poses[off:off + f] = s.poses.astype(np.float32)
            Ks[off:off + f] = np.broadcast_to(s.K.astype(np.float32), (f, 3, 3))
            off += f
        dev = mesh.device

        def put(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        mask_t = put(mask)
        perm, count = build_pixel_perms(mask_t)
        return ShardedDeviceCache(
            rgb=put(rgb), depth=torch.from_numpy(depth).to(dev), mask=mask_t,
            poses=put(poses), Ks=put(Ks), pixel_perm=perm, mask_count=count,
            scene_offsets=put(tables["scene_offsets"][c], torch.int64),
            scene_lengths=put(tables["scene_lengths"][c], torch.int64),
            num_scenes=int(tables["num_scenes"][c, 0]),
            scenes_by_object=put(tables["scenes_by_object"][c], torch.int64),
            scenes_per_object=put(tables["scenes_per_object"][c], torch.int64),
            num_objects=int(tables["num_objects"][c, 0]), frames_per_shard=fmax,
            assignment={nm: i for i, names in enumerate(shards) for nm in names},
            tables=tables, mesh=mesh, data_axis=data_axis, dataset=dataset)

    @property
    def device(self) -> torch.device:
        return self.rgb.device

    @property
    def nbytes_per_device(self) -> int:
        """Bytes of this rank's frame block (rgb, depth and mask)."""
        return sum(t.numel() * t.element_size() for t in (self.rgb, self.depth, self.mask))

    def gather(self, frame_index: dict) -> dict:
        """Local frame indices (``frame_a``/``frame_b``, and ``_2`` for a
        second pair) and ``match_type`` -> the batch of those frames on the
        device, poses and intrinsics included, in the schema of
        :meth:`DeviceCache.gather`."""
        out = {"match_type": frame_index["match_type"]}
        for suffix in ("", "_2"):
            if "frame_a" + suffix not in frame_index:
                continue
            fa = frame_index["frame_a" + suffix].to(torch.int64)
            fb = frame_index["frame_b" + suffix].to(torch.int64)
            for side, f in (("a", fa), ("b", fb)):
                out.update({f"rgb_{side}{suffix}": self.rgb.index_select(0, f),
                            f"depth_{side}{suffix}": self.depth.index_select(0, f),
                            f"mask_{side}{suffix}": self.mask.index_select(0, f),
                            f"pose_{side}{suffix}": self.poses.index_select(0, f)})
            out["K" + suffix] = self.Ks.index_select(0, fa)
            if suffix == "":
                out.update({"perm_a": self.pixel_perm.index_select(0, fa),
                            "count_a": self.mask_count.index_select(0, fa),
                            "perm_b": self.pixel_perm.index_select(0, fb),
                            "count_b": self.mask_count.index_select(0, fb)})
        return out
