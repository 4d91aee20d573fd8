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

Not ported yet: ``partition_scenes`` and ``ShardedDeviceCache``, which wait
for the parallel slice.
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
