"""Quantitative evaluation: the 23-column match statistics of image pairs,
the dataset sweeps built on them, descriptor statistics, and the pipeline
that writes a model folder's analysis.

Port of :mod:`pdc_tpu.evaluation.evaluate`. What differs from the JAX
package, and why:

  * tables are :class:`~pdc_tpu_torch.evaluation.table.Table`, not pandas
    DataFrames; pandas is never imported on this path;
  * distances use the difference form ``sum_d (r_d - q_d)^2``, as the
    best-match kernel does. The JAX statistics expand ``|r|^2 - 2<r,q> +
    |q|^2``, which cancels by up to 7.8e-3 near exact matches (ROADMAP F1),
    so a JAX row and a port row can pick different pixels only where the
    two distances are that close;
  * the masked distance is ``dist + 1e6 * blocked``, added after the square
    root as ``_match_statistics_device`` does (the masked best match of
    :func:`~pdc_tpu_torch.ops.matching.best_matches_batch`, used across
    objects, adds it to the squared distance, as the JAX function of that
    name does);
  * random draws come from a ``torch.Generator`` per image pair, seeded
    from ``(seed, pair index)`` (:func:`pair_generator`), so that chunking
    a sweep changes no row; the pair list itself comes from the dataset's
    own draws, which equal the JAX package's bit for bit;
  * the ``[pixels, matches]`` statistics run in chunks of pixels, each
    chunk's arrays at most :data:`STATS_CHUNK_BYTES`; the unmasked best
    match of a sweep chunk's pairs is one launch of the best-match kernel
    (:func:`~pdc_tpu_torch.ops.best_match.best_match`) on the card.

Entry points run on the device of the network they are given; a network
built from a model folder defaults to ``device="cuda"`` and raises without
CUDA unless ``"cpu"`` is asked for.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from pdc_tpu_torch.evaluation.table import Table
from pdc_tpu_torch.geom.camera import unproject_to_camera
from pdc_tpu_torch.geom.transforms import transform_points
from pdc_tpu_torch.ops import sampling
from pdc_tpu_torch.ops.best_match import best_match, squared_distances
from pdc_tpu_torch.ops.correspondence import find_pixel_correspondences, reproject_pixels
from pdc_tpu_torch.utils.constants import DEPTH_IM_SCALE
from pdc_tpu_torch.utils.yaml_io import load_yaml, save_yaml

logger = logging.getLogger(__name__)

# the reference's 23-column per-match schema
EVAL_COLUMNS = [
    "scene_name", "scene_name_a", "scene_name_b", "object_id_a", "object_id_b",
    "img_a_idx", "img_b_idx", "is_valid", "is_valid_masked",
    "norm_diff_descriptor_ground_truth", "norm_diff_descriptor",
    "norm_diff_descriptor_masked", "norm_diff_ground_truth_3d",
    "norm_diff_pred_3d", "norm_diff_pred_3d_masked",
    "pixel_match_error_l2", "pixel_match_error_l2_masked",
    "pixel_match_error_l1", "fraction_pixels_closer_than_ground_truth",
    "fraction_pixels_closer_than_ground_truth_masked",
    "average_l2_distance_for_false_positives",
    "average_l2_distance_for_false_positives_masked", "keypoint_name",
]

ACROSS_OBJECT_COLUMNS = [
    "scene_name_a", "scene_name_b", "img_a_idx", "img_b_idx",
    "object_id_a", "object_id_b", "norm_diff_descriptor_best_match",
]

# bytes of one [pairs, matches, pixels] float32 array of the statistics; the
# pixel axis is cut into chunks below it (about six such arrays are alive at
# once). One 640x480 pair at 100 matches needs 123 MB unchunked.
STATS_CHUNK_BYTES = 1 << 28
# pairs of a sweep chunk: one best-match launch, one batch of correspondences
SWEEP_PAIR_CHUNK = 16
_MESH_MSG = ("mesh= is not ported to pdc_tpu_torch yet: sharded evaluation waits for the "
             "parallel slice (ROADMAP queue 1, item 9)")


def pair_generator(pair_seed: int) -> torch.Generator:
    """The CPU generator of one image pair (the same draws on every
    device)."""
    return torch.Generator().manual_seed(int(pair_seed))


def pair_seed(seed: int, index: int) -> int:
    """The generator seed of pair ``index`` of a sweep seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0])


def _tensor(x, device, dtype=None):
    """``x`` as a tensor on ``device``; uint16 depth images become int32
    (torch has few uint16 operations), read-only arrays are copied."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype == np.uint16:
            x = x.astype(np.int32)
        elif not x.flags.writeable:  # torch warns on read-only arrays
            x = x.copy()
    return torch.as_tensor(x, device=device, dtype=dtype)


def _pixel_chunk(B: int, N: int, HW: int) -> int:
    return max(1, min(HW, STATS_CHUNK_BYTES // (4 * max(B * N, 1))))


def _batched_statistics(depth_a, depth_b, mask_b, uv_a, uv_b, pose_a, pose_b,
                        res_a, res_b, K, K_b):
    """The statistics of B pairs at once, all arguments batched over a
    leading B (``uv_*`` ``[B, N, 2]`` int64, ``res_*`` ``[B, H, W, D]``).
    The unmasked best matches of all B pairs are one best-match call (the
    kernel on the card, its plain version on the CPU). Returns the dict of
    :func:`_match_statistics`, each entry ``[B, N]``."""
    B, H, W, D = res_a.shape
    N, HW = uv_a.shape[1], H * W
    dev = res_b.device
    res_b_flat = res_b.reshape(B, HW, D).to(torch.float32)
    flat_a = (uv_a[..., 1] * W + uv_a[..., 0]).to(torch.int64)
    flat_b = (uv_b[..., 1] * W + uv_b[..., 0]).to(torch.int64)
    queries = torch.gather(res_a.reshape(B, HW, D).to(torch.float32), 1,
                           flat_a[..., None].expand(B, N, D)).contiguous()
    des_b_gt = torch.gather(res_b_flat, 1, flat_b[..., None].expand(B, N, D))
    norm_diff_gt = torch.linalg.vector_norm(queries - des_b_gt, dim=-1)  # [B, N]

    planar = res_b_flat.transpose(1, 2).contiguous()  # [B, D, HW]
    flat_best, best_diff = best_match(planar, queries)
    mask_flat = mask_b.reshape(B, HW) != 0
    uv_b_f = uv_b.to(torch.float32)
    n_closer = torch.zeros(B, N, dtype=torch.int64, device=dev)
    n_closer_masked = torch.zeros_like(n_closer)
    fp_sum = torch.zeros(B, N, dtype=torch.float64, device=dev)
    fp_sum_masked = torch.zeros_like(fp_sum)
    best_masked = torch.full((B, N), float("inf"), device=dev)
    flat_best_masked = torch.zeros(B, N, dtype=torch.int64, device=dev)
    gt = norm_diff_gt[..., None]
    step = _pixel_chunk(B, N, HW)
    for s in range(0, HW, step):
        e = min(HW, s + step)
        dist = torch.sqrt(torch.clamp(squared_distances(planar[:, :, s:e], queries), min=0.0))
        blocked = (~mask_flat[:, s:e]).to(torch.float32) * 1e6
        dist_masked = dist + blocked[:, None, :]  # [B, N, P]
        # masked argmin: first index on ties, within the chunk and across
        val, idx = torch.min(dist_masked, dim=-1)
        better = val < best_masked
        best_masked = torch.where(better, val, best_masked)
        flat_best_masked = torch.where(better, idx + s, flat_best_masked)
        # Schmidt et al.'s fraction of pixels closer than the ground truth,
        # and the mean pixel distance of those false positives
        px = torch.arange(s, e, device=dev)
        du = (px % W).to(torch.float32)[None, None, :] - uv_b_f[..., 0:1]
        dv = (px // W).to(torch.float32)[None, None, :] - uv_b_f[..., 1:2]
        d_to_gt = torch.sqrt(du * du + dv * dv)
        closer = dist < gt
        closer_masked = dist_masked < gt
        n_closer += closer.sum(-1)
        n_closer_masked += closer_masked.sum(-1)
        zero = torch.zeros((), device=dev)
        fp_sum += torch.where(closer, d_to_gt, zero).sum(-1, dtype=torch.float64)
        fp_sum_masked += torch.where(closer_masked, d_to_gt, zero).sum(-1, dtype=torch.float64)

    fraction_closer = n_closer.to(torch.float32) / HW
    n_mask_px = torch.clamp(mask_flat.sum(-1), min=1)
    fraction_closer_masked = n_closer_masked.to(torch.float32) / n_mask_px[:, None]
    avg_fp = torch.where(n_closer == 0, 0.0,
                         (fp_sum / torch.clamp(n_closer, min=1)).to(torch.float32))
    avg_fp_masked = torch.where(
        n_closer_masked == 0, 0.0,
        (fp_sum_masked / torch.clamp(n_closer_masked, min=1)).to(torch.float32))

    flat_best = flat_best.to(torch.int64)
    uv_pred = torch.stack([flat_best % W, flat_best // W], dim=-1)
    uv_pred_masked = torch.stack([flat_best_masked % W, flat_best_masked // W], dim=-1)
    err = uv_b_f - uv_pred.to(torch.float32)
    err_masked = uv_b_f - uv_pred_masked.to(torch.float32)

    # 3D positions through the depth images, as the JAX package reads them:
    # the stored value / DEPTH_IM_SCALE
    def depth_at(depth, flat):
        return torch.gather(depth.reshape(B, HW).to(torch.float32), 1, flat) / DEPTH_IM_SCALE

    def pos3d(uv, z, pose, Kside):
        return transform_points(pose, unproject_to_camera(uv.to(torch.float32), z, Kside))

    z_a = depth_at(depth_a, flat_a)
    z_b = depth_at(depth_b, flat_b)
    z_pred = depth_at(depth_b, flat_best)
    z_pred_masked = depth_at(depth_b, flat_best_masked)
    p_a = pos3d(uv_a, z_a, pose_a, K)
    p_b = pos3d(uv_b, z_b, pose_b, K_b)
    p_pred = pos3d(uv_pred, z_pred, pose_b, K_b)
    p_pred_masked = pos3d(uv_pred_masked, z_pred_masked, pose_b, K_b)
    is_valid, is_valid_masked, gt_depth_valid = z_pred > 0, z_pred_masked > 0, z_b > 0
    nan = torch.tensor(float("nan"), device=dev)

    def norm3(x):
        return torch.linalg.vector_norm(x, dim=-1)

    return {
        "is_valid": is_valid,
        "is_valid_masked": is_valid_masked,
        "norm_diff_descriptor_ground_truth": norm_diff_gt,
        "norm_diff_descriptor": best_diff.to(torch.float32),
        "norm_diff_descriptor_masked": best_masked,
        "norm_diff_ground_truth_3d": torch.where(gt_depth_valid, norm3(p_b - p_a), nan),
        "norm_diff_pred_3d": torch.where(gt_depth_valid & is_valid, norm3(p_b - p_pred), nan),
        "norm_diff_pred_3d_masked": torch.where(gt_depth_valid & is_valid_masked,
                                                norm3(p_b - p_pred_masked), nan),
        "pixel_match_error_l2": torch.linalg.vector_norm(err, dim=-1),
        "pixel_match_error_l2_masked": torch.linalg.vector_norm(err_masked, dim=-1),
        "pixel_match_error_l1": err.abs().sum(-1),
        "fraction_pixels_closer_than_ground_truth": fraction_closer,
        "fraction_pixels_closer_than_ground_truth_masked": fraction_closer_masked,
        "average_l2_distance_for_false_positives": avg_fp,
        "average_l2_distance_for_false_positives_masked": avg_fp_masked,
        "uv_b_pred": uv_pred,
        "uv_b_pred_masked": uv_pred_masked,
    }


def _match_statistics(depth_a, depth_b, mask_b, uv_a, uv_b, pose_a, pose_b,
                      res_a, res_b, K, K_b=None):
    """All per-match statistics of one image pair, vectorised over its N
    matches: the counterpart of ``_match_statistics_device``, with the
    masked argmin over ``dist + 1e6 * (1 - mask)`` and Schmidt et al.'s
    fraction of pixels closer than the ground truth.

    :param uv_a, uv_b: [N, 2] integer ground-truth correspondences (u, v)
    :param K: intrinsics of camera a (and of camera b when ``K_b`` is None,
        the same-scene case)
    :return: dict of 17 [N] tensors on ``res_b``'s device
    """
    dev = res_b.device if isinstance(res_b, torch.Tensor) else torch.device("cpu")
    res_a = _tensor(res_a, dev, torch.float32)[None]
    res_b = _tensor(res_b, dev, torch.float32)[None]
    uv_a = _tensor(uv_a, dev).to(torch.int64)[None]
    uv_b = _tensor(uv_b, dev).to(torch.int64)[None]
    K = _tensor(K, dev, torch.float32)[None]
    K_b = K if K_b is None else _tensor(K_b, dev, torch.float32)[None]
    stats = _batched_statistics(
        _tensor(depth_a, dev)[None], _tensor(depth_b, dev)[None], _tensor(mask_b, dev)[None],
        uv_a, uv_b, _tensor(pose_a, dev, torch.float32)[None],
        _tensor(pose_b, dev, torch.float32)[None], res_a, res_b, K, K_b)
    return {k: v[0] for k, v in stats.items()}


def _rows(stats: dict, indices, **fields):
    """Row dicts of the 23-column schema: the matches ``indices`` of numpy
    statistics, with the pair's ``fields``."""
    rows = []
    for i in indices:
        row = {c: None for c in EVAL_COLUMNS}
        row.update(fields, is_valid=bool(stats["is_valid"][i]),
                   is_valid_masked=bool(stats["is_valid_masked"][i]))
        for c in EVAL_COLUMNS:
            if c in stats and row[c] is None:
                row[c] = float(stats[c][i])
        rows.append(row)
    return rows


def _to_numpy(stats: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in stats.items()}


def image_pair_list(dataset, num_image_pairs: int, seed: int = 1):
    """The sweep's pairs ``[(scene, idx_a, idx_b, pair seed), ...]``: the
    dataset reseeded with ``seed``, then for each of ``num_image_pairs``
    draws a random scene, frame a, and a frame b whose pose differs enough
    (a draw that finds none is skipped), in the JAX package's order of
    draws."""
    dataset.reset_seed(seed)
    pairs = []
    for _ in range(num_image_pairs):
        scene_name = dataset.get_random_scene_name()
        scene = dataset.get_scene(scene_name)
        idx_a = dataset.get_random_image_index(scene_name)
        idx_b = dataset.get_img_idx_with_different_pose(
            scene_name, scene.poses[scene.position(idx_a)])
        if idx_b is None:
            continue
        pairs.append((scene_name, idx_a, idx_b, pair_seed(seed, len(pairs))))
    return pairs


def _chunk_frames(dataset, chunk, device) -> dict:
    """Depth, mask and pose of both frames of each pair of ``chunk``
    (``[(scene, idx_a, idx_b, pair seed), ...]``) and the scene's K,
    stacked on ``device``."""
    frames = {k: [] for k in ("depth_a", "mask_a", "pose_a", "depth_b", "mask_b", "pose_b",
                              "K")}
    for scene_name, idx_a, idx_b, _ in chunk:
        for side, idx in (("a", idx_a), ("b", idx_b)):
            _, depth, mask, pose = dataset.get_rgbd_mask_pose(scene_name, idx)
            frames[f"depth_{side}"].append(np.asarray(depth))
            frames[f"mask_{side}"].append(np.asarray(mask))
            frames[f"pose_{side}"].append(np.asarray(pose, np.float32))
        frames["K"].append(np.asarray(dataset.get_scene(scene_name).K, np.float32))
    return {k: _tensor(np.stack(v), device) for k, v in frames.items()}


def _sweep_correspondences(frames: dict, seeds, num_matches: int, padded_num_attempts: int):
    """Correspondences of a chunk of pairs in one batch: each pair's
    ``padded_num_attempts`` mask pixels of image a drawn from its own
    generator (the draws of :func:`find_pixel_correspondences` on that
    generator), reprojected, and the first ``num_matches`` valid ones kept
    in their original order. Returns (uv_a, uv_b rounded, valid), each
    ``[B, num_matches, ...]``."""
    depth_a = frames["depth_a"]
    B, H, W = depth_a.shape
    u = torch.stack([sampling.uniform((padded_num_attempts,), pair_generator(s))
                     for s in seeds]).to(depth_a.device)
    idx, mask_ok = sampling.inverse_cdf(frames["mask_a"].reshape(B, H * W), u)
    uv_a = torch.stack([idx % W, idx // W], dim=-1)
    uv_b, valid = reproject_pixels(uv_a, depth_a, frames["pose_a"], frames["depth_b"],
                                   frames["pose_b"], frames["K"])
    valid = valid & mask_ok[:, None]
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :num_matches]
    gt_valid = torch.gather(valid, 1, order)
    uv_a = torch.gather(uv_a, 1, order[..., None].expand(-1, -1, 2))
    uv_b = torch.gather(uv_b, 1, order[..., None].expand(-1, -1, 2))
    uv_b = torch.stack([torch.clamp(torch.round(uv_b[..., 0]), 0, W - 1),
                        torch.clamp(torch.round(uv_b[..., 1]), 0, H - 1)], dim=-1)
    return uv_a.to(torch.int64), uv_b.to(torch.int64), gt_valid


def _sweep_statistics(frames: dict, uv_a, uv_b, res_a, res_b):
    """The statistics of a chunk of same-scene pairs (frames of
    :func:`_chunk_frames`), with one best-match launch."""
    return _batched_statistics(frames["depth_a"], frames["depth_b"], frames["mask_b"], uv_a,
                               uv_b, frames["pose_a"], frames["pose_b"], res_a, res_b,
                               frames["K"], frames["K"])


def _pair_statistics(dataset, scene_name, img_a_idx, img_b_idx, num_matches, generator,
                     padded_num_attempts, res_a, res_b):
    """The per-pair route's numpy statistics of one pair (None when it has
    no valid correspondence): the candidates drawn from ``generator``, the
    first ``num_matches`` valid ones, then :func:`_match_statistics`."""
    _, depth_a, mask_a, pose_a = dataset.get_rgbd_mask_pose(scene_name, img_a_idx)
    _, depth_b, mask_b, pose_b = dataset.get_rgbd_mask_pose(scene_name, img_b_idx)
    K = dataset.get_scene(scene_name).K
    dev = res_b.device if isinstance(res_b, torch.Tensor) else torch.device("cpu")
    H, W = np.asarray(depth_b).shape
    uv_a, uv_b, valid = find_pixel_correspondences(
        _tensor(depth_a, dev), _tensor(pose_a, dev, torch.float32), _tensor(depth_b, dev),
        _tensor(pose_b, dev, torch.float32), _tensor(K, dev, torch.float32), generator,
        num_attempts=padded_num_attempts, mask_a=_tensor(mask_a, dev))
    keep = torch.nonzero(valid)[:num_matches, 0]
    if keep.numel() == 0:
        return None
    uv_b = torch.round(uv_b[keep])
    uv_b = torch.stack([torch.clamp(uv_b[:, 0], 0, W - 1),
                        torch.clamp(uv_b[:, 1], 0, H - 1)], dim=-1).to(torch.int64)
    return _to_numpy(_match_statistics(depth_a, depth_b, mask_b, uv_a[keep], uv_b,
                                       pose_a, pose_b, res_a, res_b, K))


class DenseCorrespondenceEvaluation:
    """Top-level evaluation orchestrator.

    Instance methods drive the network registry (``configs/evaluation.yaml``
    format: a ``networks`` dict of name -> {path_to_network_params or
    model_folder}, plus ``output_dir`` and ``params``); static methods are
    the per-network building blocks.
    """

    def __init__(self, config: Optional[dict] = None, dataset=None, device="cuda"):
        self._config = config or {}
        self._dataset = dataset
        self.device = device

    @property
    def config(self):
        return self._config

    # -- network registry -----------------------------------------------------

    def network_names(self):
        return sorted(self._config.get("networks", {}).keys())

    def _network_model_folder(self, name: str) -> str:
        if name not in self._config.get("networks", {}):
            raise ValueError(f"Network {name} is not in config file")
        entry = self._config["networks"][name]
        if "model_folder" in entry:
            return entry["model_folder"]
        return os.path.dirname(entry["path_to_network_params"])

    def load_network_from_config(self, name: str):
        """Load a registered network."""
        from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

        model_folder = self._network_model_folder(name)
        param_file = self._config["networks"][name].get("path_to_network_params")
        return DenseCorrespondenceNetwork.from_model_folder(
            model_folder, model_param_file=param_file, device=self.device)

    @staticmethod
    def load_dataset_from_model_folder(model_folder: str, mode: str = "train"):
        """Rebuild the training dataset from the folder's ``dataset.yaml``."""
        from pdc_tpu_torch.data.dataset import SpartanDataset

        dataset_config = load_yaml(os.path.join(model_folder, "dataset.yaml"))
        return SpartanDataset.from_dataset_config(dataset_config, mode=mode)

    def load_dataset_for_network(self, network_name: str):
        return self.load_dataset_from_model_folder(self._network_model_folder(network_name))

    @property
    def dataset(self):
        return self._dataset

    @dataset.setter
    def dataset(self, value):
        self._dataset = value

    def get_output_dir(self):
        return self._config["output_dir"]

    def evaluate_single_network(self, network_name: str, mode: str = "train",
                                save: bool = True):
        """Registry-driven evaluation of one network in one dataset mode;
        writes ``<output_dir>/<network>/<mode>/data.csv`` when ``save``."""
        dcn = self.load_network_from_config(network_name)
        dataset = self._dataset or self.load_dataset_for_network(network_name)
        if mode == "train":
            dataset.set_train_mode()
        elif mode == "test":
            dataset.set_test_mode()
        else:
            raise ValueError(f"mode must be train or test, got {mode}")
        params = self._config.get("params", {})
        table = self.evaluate_network_quantitative(
            dcn, dataset,
            num_image_pairs=int(params.get("num_image_pairs", 100)),
            num_matches_per_image_pair=int(params.get("num_matches_per_image_pair", 100)))
        if save:
            output_dir = os.path.join(self.get_output_dir(), network_name, mode)
            os.makedirs(output_dir, exist_ok=True)
            table.to_csv(os.path.join(output_dir, "data.csv"))
        return table

    def compare_networks(self, network_names=None, mode: str = "test",
                         save: bool = True, tag: str = None):
        """Evaluate each registered network and overlay their CDFs in one
        figure. Returns {name: stats}; with ``save`` writes
        ``comparison_<mode>[_<tag>].yaml`` under output_dir, and the overlay
        ``.png`` beside it when matplotlib imports."""
        from pdc_tpu_torch.evaluation.plotting import DenseCorrespondenceEvaluationPlotter

        if network_names is None:
            network_names = self.network_names()
        fig_axes = None
        all_stats = {}
        for name in network_names:
            table = self.evaluate_single_network(name, mode=mode, save=save)
            stats, fig_axes = DenseCorrespondenceEvaluationPlotter.run_on_single_dataframe(
                None, label=name, dataframe=table, save=False,
                previous_fig_axes=fig_axes, return_fig_axes=True)
            all_stats[name] = stats
        stem = f"comparison_{mode}" + (f"_{tag}" if tag else "")
        if save:
            os.makedirs(self.get_output_dir(), exist_ok=True)
            save_yaml(all_stats, os.path.join(self.get_output_dir(), stem + ".yaml"))
        if fig_axes is not None and fig_axes[0] is not None:
            import matplotlib.pyplot as plt

            if save:
                fig_axes[0].savefig(os.path.join(self.get_output_dir(), stem + ".png"))
            plt.close(fig_axes[0])
        return all_stats

    # -- core: one image pair --------------------------------------------------

    @staticmethod
    def single_same_scene_image_pair_quantitative_analysis(
        dcn, dataset, scene_name: str, img_a_idx: int, img_b_idx: int,
        num_matches: int = 100, generator: Optional[torch.Generator] = None,
        padded_num_attempts: int = 2000, res_a=None, res_b=None,
    ):
        """Evaluate ``num_matches`` ground-truth correspondences of one image
        pair: the first valid ones of ``padded_num_attempts`` mask pixels of
        image a drawn from ``generator`` (default: seed 1). Returns a list of
        row dicts. ``res_a``/``res_b`` take precomputed descriptor images."""
        rgb_a = dataset.get_rgbd_mask_pose(scene_name, img_a_idx)[0]
        rgb_b = dataset.get_rgbd_mask_pose(scene_name, img_b_idx)[0]
        if res_a is None:
            res_a = dcn.forward_on_img(rgb_a)
        if res_b is None:
            res_b = dcn.forward_on_img(rgb_b)
        stats = _pair_statistics(dataset, scene_name, img_a_idx, img_b_idx, num_matches,
                                 generator or pair_generator(1), padded_num_attempts,
                                 res_a, res_b)
        if stats is None:
            logger.info("no matches found for pair (%s, %d, %d)", scene_name, img_a_idx,
                        img_b_idx)
            return []
        return _rows(stats, range(len(stats["is_valid"])), scene_name=scene_name,
                     img_a_idx=img_a_idx, img_b_idx=img_b_idx)

    # -- dataset-level sweeps ----------------------------------------------------

    @staticmethod
    def compute_descriptor_images_batched(dcn, dataset, image_keys, batch_size: int = 16):
        """Forward the unique (scene, idx) images in batches of
        ``batch_size`` -> dict of [H, W, D] descriptor images on the
        network's device."""
        keys = sorted(set(image_keys))
        out = {}
        if not hasattr(dcn, "forward"):  # duck-typed networks
            for s, idx in keys:
                out[(s, idx)] = dcn.forward_on_img(dataset.get_rgbd_mask_pose(s, idx)[0])
            return out
        for i in range(0, len(keys), batch_size):
            chunk = keys[i:i + batch_size]
            imgs = np.stack([dataset.rgb_image_to_tensor(dataset.get_rgbd_mask_pose(s, idx)[0])
                             for s, idx in chunk])
            res = dcn.forward(imgs)
            for j, k in enumerate(chunk):
                out[k] = res[j]
        return out

    @staticmethod
    def evaluate_network_quantitative(
        dcn, dataset, num_image_pairs: int = 100, num_matches_per_image_pair: int = 100,
        seed: int = 1, forward_batch_size: int = 16, fused: bool = True, mesh=None,
    ):
        """Sample image pairs (:func:`image_pair_list`) and build the
        per-match table. Forwards run batched over the sweep's unique
        images; with ``fused`` (default) the pairs run in chunks of
        :data:`SWEEP_PAIR_CHUNK` (one batch of correspondences, one
        best-match launch and one batch of statistics each), else one pair
        at a time through
        :meth:`single_same_scene_image_pair_quantitative_analysis`; both
        give the same rows."""
        if mesh is not None:
            raise NotImplementedError(_MESH_MSG)
        DCE = DenseCorrespondenceEvaluation
        pair_list = image_pair_list(dataset, num_image_pairs, seed)
        images = DCE.compute_descriptor_images_batched(
            dcn, dataset, [(s, i) for s, ia, ib, _ in pair_list for i in (ia, ib)],
            batch_size=forward_batch_size)
        if fused:
            return DCE._quantitative_sweep_fused(dataset, pair_list, images,
                                                 num_matches_per_image_pair)
        rows = []
        for scene_name, idx_a, idx_b, ps in pair_list:
            rows.extend(DCE.single_same_scene_image_pair_quantitative_analysis(
                dcn, dataset, scene_name, idx_a, idx_b,
                num_matches=num_matches_per_image_pair, generator=pair_generator(ps),
                res_a=images[(scene_name, idx_a)], res_b=images[(scene_name, idx_b)]))
        return Table.from_rows(rows, EVAL_COLUMNS)

    @staticmethod
    def _quantitative_sweep_fused(dataset, pair_list, images, num_matches: int,
                                  padded_num_attempts: int = 2000,
                                  pair_chunk: int = SWEEP_PAIR_CHUNK, mesh=None):
        """The sweep's statistics, ``pair_chunk`` pairs at a time on the
        device: the correspondences of a chunk in one batch (each pair from
        its own generator, the first ``num_matches`` valid candidates kept in
        their original order), the unmasked best matches of all its pairs in
        one kernel launch, then the batched statistics. Each pair's draws are
        its own, so the chunking changes no row."""
        if mesh is not None:
            raise NotImplementedError(_MESH_MSG)
        rows = []
        for start in range(0, len(pair_list), pair_chunk):
            chunk = pair_list[start:start + pair_chunk]
            res_a = torch.stack([images[(s, ia)] for s, ia, _, _ in chunk]).to(torch.float32)
            res_b = torch.stack([images[(s, ib)] for s, _, ib, _ in chunk]).to(torch.float32)
            frames = _chunk_frames(dataset, chunk, res_a.device)
            uv_a, uv_b, gt_valid = _sweep_correspondences(
                frames, [ps for _, _, _, ps in chunk], num_matches, padded_num_attempts)
            stats = _to_numpy(_sweep_statistics(frames, uv_a, uv_b, res_a, res_b))
            gt_valid = gt_valid.cpu().numpy()
            for p, (scene_name, idx_a, idx_b, _) in enumerate(chunk):
                keep = np.nonzero(gt_valid[p])[0]
                if keep.size == 0:
                    logger.info("no matches found for pair (%s, %d, %d)", scene_name, idx_a,
                                idx_b)
                rows.extend(_rows({k: v[p] for k, v in stats.items()}, keep,
                                  scene_name=scene_name, img_a_idx=idx_a, img_b_idx=idx_b))
        return Table.from_rows(rows, EVAL_COLUMNS)

    @staticmethod
    def evaluate_network_cross_scene(dcn, dataset, annotations: list):
        """Evaluate on human-labeled cross-scene pixel pairs (the labeler's
        annotation format: a list of dicts whose image_a/image_b entries hold
        scene_name, image_idx and pixels), each side unprojected with its
        own scene's intrinsics."""
        images = DenseCorrespondenceEvaluation.compute_descriptor_images_batched(
            dcn, dataset, [(ann[side]["scene_name"], int(ann[side]["image_idx"]))
                           for ann in annotations for side in ("image_a", "image_b")])
        rows = []
        for ann in annotations:
            ia, ib = ann["image_a"], ann["image_b"]
            scene_a, idx_a = ia["scene_name"], int(ia["image_idx"])
            scene_b, idx_b = ib["scene_name"], int(ib["image_idx"])
            _, depth_a, _, pose_a = dataset.get_rgbd_mask_pose(scene_a, idx_a)
            _, depth_b, mask_b, pose_b = dataset.get_rgbd_mask_pose(scene_b, idx_b)
            uv_a = np.asarray([[p["u"], p["v"]] for p in ia["pixels"]], np.int64)
            uv_b = np.asarray([[p["u"], p["v"]] for p in ib["pixels"]], np.int64)
            stats = _to_numpy(_match_statistics(
                depth_a, depth_b, mask_b, uv_a, uv_b, pose_a, pose_b,
                images[(scene_a, idx_a)], images[(scene_b, idx_b)],
                dataset.get_scene(scene_a).K, dataset.get_scene(scene_b).K))
            for i, row in enumerate(_rows(stats, range(len(uv_a)), scene_name_a=scene_a,
                                          scene_name_b=scene_b, img_a_idx=idx_a,
                                          img_b_idx=idx_b)):
                row["keypoint_name"] = ia["pixels"][i].get("keypoint")
                rows.append(row)
        return Table.from_rows(rows, EVAL_COLUMNS)

    @staticmethod
    def evaluate_network_across_objects(dcn, dataset, num_image_pairs: int = 100,
                                        num_queries: int = 100, seed: int = 1):
        """Best-match descriptor distances between DIFFERENT objects: for
        ``num_queries`` random mask pixels of object A (drawn from the pair's
        own generator), the masked best match in an image of object B,
        ``sqrt(d2 + 1e6 * blocked)``. Forwards run batched over the unique
        images; a pair whose mask a is empty gives no rows."""
        from pdc_tpu_torch.losses.composer import MATCH_TYPE_DIFFERENT_OBJECT
        from pdc_tpu_torch.ops.matching import best_matches_batch

        dataset.reset_seed(seed)
        pairs = [dataset.sample_pair(match_type=MATCH_TYPE_DIFFERENT_OBJECT)
                 for _ in range(num_image_pairs)]
        keys, rgb_of = [], {}
        for pair in pairs:
            for side in ("a", "b"):
                k = (pair.metadata[f"scene_name_{side}"], pair.metadata[f"image_{side}_idx"])
                if k not in rgb_of:
                    rgb_of[k] = getattr(pair, f"rgb_{side}")
                    keys.append(k)
        images = {}
        for start in range(0, len(keys), 16):
            chunk = keys[start:start + 16]
            res = dcn.forward(np.stack([dataset.rgb_image_to_tensor(rgb_of[k]) for k in chunk]))
            images.update(zip(chunk, res))
        rows = []
        for p, pair in enumerate(pairs):
            m = pair.metadata
            res_a = images[(m["scene_name_a"], m["image_a_idx"])]
            res_b = images[(m["scene_name_b"], m["image_b_idx"])]
            mask_a = torch.as_tensor(np.asarray(pair.mask_a), device=res_a.device)
            uv_a, ok = sampling.sample_from_mask(mask_a, num_queries,
                                                 pair_generator(pair_seed(seed, p)))
            if not bool(ok):
                continue
            queries = res_a[uv_a[:, 1], uv_a[:, 0], :]
            _, best = best_matches_batch(queries, res_b, mask=np.asarray(pair.mask_b))
            for b in best.cpu().numpy():
                rows.append({"scene_name_a": m["scene_name_a"], "scene_name_b": m["scene_name_b"],
                             "img_a_idx": m["image_a_idx"], "img_b_idx": m["image_b_idx"],
                             "object_id_a": m.get("object_id_a"),
                             "object_id_b": m.get("object_id_b"),
                             "norm_diff_descriptor_best_match": float(b)})
        return Table.from_rows(rows, ACROSS_OBJECT_COLUMNS)

    # -- descriptor statistics ------------------------------------------------------

    @staticmethod
    def compute_descriptor_statistics_on_dataset(dcn, dataset, num_images: int = 100,
                                                 save_to_file: bool = True,
                                                 filename: Optional[str] = None,
                                                 batch_size: int = 16, mesh=None):
        """Per-channel min/max/mean over whole images and over their masks,
        of ``num_images`` random frames, forwarded ``batch_size`` at a time;
        saved as ``descriptor_statistics.yaml``. An image whose mask is
        empty does not count."""
        if mesh is not None:
            raise NotImplementedError(_MESH_MSG)
        draws = []
        for _ in range(num_images):
            scene_name = dataset.get_random_scene_name()
            draws.append((scene_name, dataset.get_random_image_index(scene_name)))
        acc = {"entire_image": {"min": None, "max": None, "mean": None},
               "mask_image": {"min": None, "max": None, "mean": None}}
        count = 0
        batched = hasattr(dcn, "forward")
        step = batch_size if batched else 1
        for start in range(0, len(draws), step):
            chunk = draws[start:start + step]
            frames = [dataset.get_rgbd_mask_pose(s, i) for s, i in chunk]
            if batched:
                res = dcn.forward(np.stack([dataset.rgb_image_to_tensor(f[0]) for f in frames]))
            else:
                res = torch.stack([torch.as_tensor(dcn.forward_on_img(f[0])) for f in frames])
            B, H, W, D = res.shape
            flat = res.reshape(B, H * W, D).to(torch.float32)
            m = torch.as_tensor(np.stack([np.asarray(f[2]) for f in frames]),
                                device=flat.device).reshape(B, H * W)[..., None] != 0
            n_mask = torch.clamp(m.sum(1), min=1)
            big = torch.tensor(1e9, device=flat.device)
            entire = (flat.min(1).values, flat.max(1).values, flat.mean(1))
            masked = (torch.where(m, flat, big).min(1).values,
                      torch.where(m, flat, -big).max(1).values,
                      torch.where(m, flat, 0.0).sum(1) / n_mask)
            entire = [x.cpu().numpy() for x in entire]
            masked = [x.cpu().numpy() for x in masked]
            mask_ok = (m.sum(1)[:, 0] > 0).cpu().numpy()
            for j in range(B):
                if not mask_ok[j]:
                    continue
                count += 1
                for dst, (mn, mx, mean) in (("entire_image", entire), ("mask_image", masked)):
                    d = acc[dst]
                    d["min"] = mn[j] if d["min"] is None else np.minimum(d["min"], mn[j])
                    d["max"] = mx[j] if d["max"] is None else np.maximum(d["max"], mx[j])
                    d["mean"] = mean[j] if d["mean"] is None else d["mean"] + mean[j]
        if count == 0:
            raise ValueError("no drawn image has a nonempty mask: no descriptor statistics")
        stats = {k: {"min": [float(x) for x in v["min"]], "max": [float(x) for x in v["max"]],
                     "mean": [float(x) for x in v["mean"] / count]}
                 for k, v in acc.items()}
        if save_to_file:
            if filename is None:
                filename = os.path.join(dcn.config["path_to_network_params_folder"],
                                        "descriptor_statistics.yaml")
            save_yaml(stats, filename)
        return stats

    @staticmethod
    def compute_loss_on_dataset(dcn, dataset, loss_config: dict, num_iterations: int = 50,
                                batch_size: int = 1, seed: int = 0):
        """Not ported: the average composed loss needs the per-pair loss
        (``assemble_batch``, ``compose_loss``)."""
        raise NotImplementedError(
            "compute_loss_on_dataset is not ported to pdc_tpu_torch yet: it needs the per-pair "
            "loss (assemble_batch, compose_loss), which waits for ROADMAP queue 1, item 4")

    # -- the full pipeline --------------------------------------------------------------

    @staticmethod
    def run_evaluation_on_network(model_folder: str, dataset=None,
                                  num_image_pairs: int = 100,
                                  num_matches_per_image_pair: int = 100,
                                  output_dir: Optional[str] = None,
                                  cross_scene_annotations: Optional[list] = None,
                                  compute_descriptor_statistics: bool = True,
                                  qualitative: bool = True,
                                  num_qualitative_pairs: int = 5,
                                  iteration: Optional[int] = None, device="cuda"):
        """The analysis of a model folder: ``descriptor_statistics.yaml`` in
        the folder; the train and test sweeps' ``data.csv`` and
        ``stats.yaml`` under ``output_dir`` (default ``<folder>/analysis``)
        and, with matplotlib, their overlaid CDF figure; the cross-scene
        table when annotations are given; the across-object table when the
        dataset has more than one object; the qualitative panels when
        ``qualitative`` (they need matplotlib). When ``dataset`` is None it
        is rebuilt from the folder's ``dataset.yaml``."""
        from pdc_tpu_torch.evaluation.plotting import DenseCorrespondenceEvaluationPlotter
        from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

        DCE = DenseCorrespondenceEvaluation
        DCEP = DenseCorrespondenceEvaluationPlotter
        dcn = DenseCorrespondenceNetwork.from_model_folder(model_folder, iteration=iteration,
                                                           device=device)
        if dataset is None:
            dataset = DCE.load_dataset_from_model_folder(model_folder)
        if output_dir is None:
            output_dir = os.path.join(model_folder, "analysis")
        os.makedirs(output_dir, exist_ok=True)

        if compute_descriptor_statistics:
            DCE.compute_descriptor_statistics_on_dataset(
                dcn, dataset, num_images=min(100, dataset.num_images_total), save_to_file=True,
                filename=os.path.join(model_folder, "descriptor_statistics.yaml"))

        results = {}
        fig_axes = None
        original_mode = dataset.mode
        for mode in ("train", "test"):
            dataset.set_train_mode() if mode == "train" else dataset.set_test_mode()
            mode_dir = os.path.join(output_dir, mode)
            os.makedirs(mode_dir, exist_ok=True)
            table = DCE.evaluate_network_quantitative(
                dcn, dataset, num_image_pairs=num_image_pairs,
                num_matches_per_image_pair=num_matches_per_image_pair)
            csv_path = os.path.join(mode_dir, "data.csv")
            table.to_csv(csv_path)
            results[f"{mode}_csv"] = csv_path
            if len(table):
                results[mode], fig_axes = DCEP.run_on_single_dataframe(
                    csv_path, label=mode, output_dir=mode_dir, save=True,
                    previous_fig_axes=fig_axes, return_fig_axes=True)
                if fig_axes[0] is None:
                    fig_axes = None
        dataset.mode = original_mode

        if cross_scene_annotations:
            cross = DCE.evaluate_network_cross_scene(dcn, dataset, cross_scene_annotations)
            cross_dir = os.path.join(output_dir, "cross_scene")
            os.makedirs(cross_dir, exist_ok=True)
            cross_csv = os.path.join(cross_dir, "data.csv")
            cross.to_csv(cross_csv)
            results["cross_scene_csv"] = cross_csv
            if len(cross):
                results["cross_scene"], fig_axes = DCEP.run_on_single_dataframe(
                    cross_csv, label="cross_scene", output_dir=cross_dir, save=True,
                    previous_fig_axes=fig_axes, return_fig_axes=True)
                if fig_axes[0] is None:
                    fig_axes = None

        if fig_axes is not None:  # the overlay of every curve (matplotlib only)
            import matplotlib.pyplot as plt

            quant_path = os.path.join(output_dir, "quant_plots.png")
            fig_axes[0].savefig(quant_path)
            results["quant_plots"] = quant_path
            plt.close(fig_axes[0])

        if dataset.get_number_of_unique_single_objects() > 1:
            ao_dir = os.path.join(output_dir, "across_object")
            os.makedirs(ao_dir, exist_ok=True)
            ao = DCE.evaluate_network_across_objects(dcn, dataset)
            ao_csv = os.path.join(ao_dir, "data.csv")
            ao.to_csv(ao_csv)
            results["across_object_csv"] = ao_csv
            if len(ao):
                results["across_object"] = DCEP.run_on_single_dataframe_across_objects(
                    ao_csv, output_dir=ao_dir, save=True)

        if qualitative:
            from pdc_tpu_torch.evaluation.qualitative import evaluate_network_qualitative

            results["qualitative"] = evaluate_network_qualitative(
                dcn, dataset, num_image_pairs=num_qualitative_pairs,
                output_dir=os.path.join(output_dir, "qualitative"))
        return results

    # -- SIFT baseline (host-side, cv2) ------------------------------------------

    @staticmethod
    def single_image_pair_sift_analysis(dataset, scene_name: str, img_a_idx: int,
                                        img_b_idx: int, cross_match_threshold: float = 0.75,
                                        output_path: Optional[str] = None,
                                        num_visualize: int = 10, detector: str = "sift"):
        """SIFT (ratio-test knn matching) or ORB (Hamming cross-check)
        keypoints and matches of one image pair, with the 3D error of each
        good match and, given ``output_path``, a match panel PNG (needs
        matplotlib). Needs cv2. Returns a dict with 'good' (list of (uv_a,
        uv_b)), 'num_keypoints_a/b' and 'rows' (3D-error dicts)."""
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("OpenCV not available; SIFT analysis disabled") from e
        rgb_a, depth_a, mask_a, pose_a = dataset.get_rgbd_mask_pose(scene_name, img_a_idx)
        rgb_b, depth_b, mask_b, pose_b = dataset.get_rgbd_mask_pose(scene_name, img_b_idx)
        K = dataset.get_scene(scene_name).K
        if detector == "sift":
            det = cv2.SIFT_create()
        elif detector == "orb":
            det = cv2.ORB_create()
        else:
            raise ValueError(f"detector must be sift or orb, got {detector}")
        kp_a, des_a = det.detectAndCompute(cv2.cvtColor(np.asarray(rgb_a), cv2.COLOR_RGB2GRAY),
                                           np.asarray(mask_a))
        kp_b, des_b = det.detectAndCompute(cv2.cvtColor(np.asarray(rgb_b), cv2.COLOR_RGB2GRAY),
                                           np.asarray(mask_b))
        result = {"num_keypoints_a": len(kp_a), "num_keypoints_b": len(kp_b),
                  "good": [], "rows": []}
        if des_a is None or des_b is None:
            return result
        if detector == "orb":
            matches = sorted(cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True).match(des_a, des_b),
                             key=lambda m: m.distance)
            good = list(matches)
        else:
            matches = cv2.BFMatcher().knnMatch(des_a, des_b, k=2)
            good = [m for m, n in matches if m.distance < cross_match_threshold * n.distance]
        for m in good:
            (ua, va), (ub, vb) = _rounded_uv(kp_a[m.queryIdx].pt), _rounded_uv(kp_b[m.trainIdx].pt)
            result["good"].append(((ua, va), (ub, vb)))
            za = float(depth_a[va, ua]) / DEPTH_IM_SCALE
            zb = float(depth_b[vb, ub]) / DEPTH_IM_SCALE
            err = np.nan
            if za > 0 and zb > 0:
                err = _error_3d((ua, va), za, pose_a, (ub, vb), zb, pose_b, K)
            result["rows"].append({"scene_name": scene_name, "img_a_idx": img_a_idx,
                                   "img_b_idx": img_b_idx, "is_valid": za > 0 and zb > 0,
                                   "norm_diff_pred_3d": err})
        if output_path is not None and result["good"]:
            from pdc_tpu_torch.evaluation.qualitative import _plt, draw_correspondence_panel

            plt = _plt()
            show = result["good"][:num_visualize]
            fig, ax = plt.subplots(figsize=(15, 6))
            draw_correspondence_panel(
                rgb_a, rgb_b, np.asarray([g[0] for g in show]), np.asarray([g[1] for g in show]),
                ax=ax, title=f"{detector.upper()} matches ({len(good)} good / "
                             f"{len(matches)} total)")
            fig.savefig(output_path, bbox_inches="tight")
            plt.close(fig)
        return result

    @staticmethod
    def compare_against_sift(dataset, num_image_pairs: int = 50, seed: int = 1):
        """The SIFT keypoint-match 3D-error baseline over pose-separated
        pairs of the dataset (host-side; needs cv2 with SIFT). Returns a
        table of (scene, frames, validity, 3D error) per good match."""
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("OpenCV not available; SIFT baseline disabled") from e
        sift = cv2.SIFT_create()
        bf = cv2.BFMatcher()
        rows = []
        dataset.reset_seed(seed)
        for _ in range(num_image_pairs):
            scene_name = dataset.get_random_scene_name()
            scene = dataset.get_scene(scene_name)
            idx_a = dataset.get_random_image_index(scene_name)
            idx_b = dataset.get_img_idx_with_different_pose(
                scene_name, scene.poses[scene.position(idx_a)])
            if idx_b is None:
                continue
            pos_a, pos_b = scene.position(idx_a), scene.position(idx_b)
            kp_a, des_a = sift.detectAndCompute(cv2.cvtColor(scene.rgb[pos_a],
                                                             cv2.COLOR_RGB2GRAY), None)
            kp_b, des_b = sift.detectAndCompute(cv2.cvtColor(scene.rgb[pos_b],
                                                             cv2.COLOR_RGB2GRAY), None)
            if des_a is None or des_b is None:
                continue
            good = [m for m, n in bf.knnMatch(des_a, des_b, k=2) if m.distance < 0.75 * n.distance]
            for m in good:
                (ua, va), (ub, vb) = _rounded_uv(kp_a[m.queryIdx].pt), _rounded_uv(
                    kp_b[m.trainIdx].pt)
                za = scene.depth[pos_a][va, ua] / DEPTH_IM_SCALE
                zb = scene.depth[pos_b][vb, ub] / DEPTH_IM_SCALE
                valid = za > 0 and zb > 0
                err = (_error_3d((ua, va), za, scene.poses[pos_a], (ub, vb), zb,
                                 scene.poses[pos_b], scene.K) if valid else np.nan)
                rows.append({"scene_name": scene_name, "img_a_idx": idx_a, "img_b_idx": idx_b,
                             "is_valid": bool(valid), "norm_diff_pred_3d": err})
        return Table.from_rows(rows, SIFT_COLUMNS)


SIFT_COLUMNS = ["scene_name", "img_a_idx", "img_b_idx", "is_valid", "norm_diff_pred_3d"]


def _rounded_uv(pt):
    return tuple(int(x) for x in np.round(pt))


def _error_3d(uv_a, z_a, pose_a, uv_b, z_b, pose_b, K) -> float:
    """Distance between the world points of two pixels at their depths."""
    def world(uv, z, pose):
        cam = unproject_to_camera(np.asarray([uv], np.float32), np.asarray([z], np.float32), K)
        return transform_points(np.asarray(pose, np.float32), cam)[0]

    return float(torch.linalg.vector_norm(world(uv_a, z_a, pose_a) - world(uv_b, z_b, pose_b)))
