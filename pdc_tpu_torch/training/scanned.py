"""Pair sampling on the device, over the frames of a device cache.

Port of the type-mixed sampler of :mod:`pdc_tpu.training.scanned`:
``POSE_*`` and ``NUM_POSE_CANDIDATES`` (:37-39), ``build_sampling_tables``
(:42-70), ``device_sample_pairs_mixed`` (:73-176) and ``_pose_ok``
(:179-186), as tensor functions over the whole batch that draw from a
``torch.Generator`` on the cache's device. Within-scene pairs take frame a
uniformly in a uniform scene and frame b as the first of 16 candidates of
that scene whose pose differs from a's by more than 0.2 m or 20 degrees
(the empty pair, type -1, when none does). The JAX package's within-scene
sampler ``device_sample_pairs`` (:322) is this sampler's type-0 case.

What is not ported: ``make_scanned_train_step`` (:517), the ``lax.scan``
loop of K train steps per dispatch, which exists for the dispatch latency
of a remote TPU runtime. Here :func:`make_device_sampled_train_step` takes
one step per call: sample, gather, assemble, update, all on the device.
The training config's ``steps_per_dispatch`` only selects this route
(:class:`~pdc_tpu_torch.training.train.DenseCorrespondenceTraining`).
The bounded and sharded samplers (:189-356) wait for the parallel slice.
"""

from __future__ import annotations

import numpy as np
import torch

from pdc_tpu_torch.losses.composer import (
    MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE,
    MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE,
    MATCH_TYPE_SYNTHETIC_MULTI_OBJECT,
)
from pdc_tpu_torch.training.train import TrainState, TrainStep

POSE_DIST_THRESHOLD = 0.2     # metres (reference threshold)
POSE_ANGLE_THRESHOLD = 20.0   # degrees
NUM_POSE_CANDIDATES = 16      # rejection-sampling candidates per pair
SAMPLED_TYPES = (0, 1, 2, 4)  # the types this sampler draws


def build_sampling_tables(cache) -> dict:
    """Device tables for type-mixed sampling from a
    :class:`~pdc_tpu_torch.data.device_cache.DeviceCache`, on its device:
    ``scene_offsets [S]``,
    ``scene_lengths [S]`` (scenes in sorted name order),
    ``scenes_by_object [O, Mmax]`` (scene indices, -1 padded, objects in
    sorted id order) and ``scenes_per_object [O]``, all int64."""
    dev = cache.device
    names = sorted(cache.scene_offsets)
    object_scenes = {}
    for si, n in enumerate(names):
        oid = cache.dataset.scenes[n].object_id or n
        object_scenes.setdefault(oid, []).append(si)
    objs = sorted(object_scenes)
    mmax = max(len(v) for v in object_scenes.values())
    table = np.full((len(objs), mmax), -1, np.int64)
    counts = np.zeros((len(objs),), np.int64)
    for oi, o in enumerate(objs):
        table[oi, :len(object_scenes[o])] = object_scenes[o]
        counts[oi] = len(object_scenes[o])

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    return {
        "scene_offsets": t([cache.scene_offsets[n] for n in names]),
        "scene_lengths": t([cache.scene_lengths[n] for n in names]),
        "scenes_by_object": t(table),
        "scenes_per_object": t(counts),
    }


def draw_below(u: torch.Tensor, n) -> torch.Tensor:
    """Integers uniform in ``[0, n)`` from float64 uniforms ``u`` in
    ``[0, 1)``: ``floor(u * n)``, clamped to ``n - 1`` because the product
    can round up to ``n``. ``n`` is an int or a tensor broadcast against
    ``u`` (a bound per row); a bound below 1 is taken as 1."""
    n = torch.clamp(torch.as_tensor(n, device=u.device).to(torch.int64), min=1)
    r = torch.floor(u * n.to(torch.float64)).to(torch.int64)
    return torch.minimum(r, n - 1)


def _pose_ok(pa: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Pose-difference acceptance of candidates: ``pa [..., 4, 4]`` against
    ``pc [..., K, 4, 4]`` -> ``[..., K]`` bool, True where the translation
    differs by more than 0.2 m or the rotation by more than 20 degrees."""
    dist = torch.linalg.vector_norm(pc[..., :3, 3] - pa[..., None, :3, 3], dim=-1)
    # trace(Ra^T Rc) = sum_ij Ra[i, j] Rc[i, j]
    trace = torch.einsum("...ij,...kij->...k", pa[..., :3, :3], pc[..., :3, :3])
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cos))
    return (dist > POSE_DIST_THRESHOLD) | (ang > POSE_ANGLE_THRESHOLD)


def device_sample_pairs_mixed(generator: torch.Generator, tables: dict, poses: torch.Tensor,
                              batch_size: int, type_probs, with_second: bool = False):
    """Type-mixed pair sampling on the device.

    Every draw of a row comes from ``generator`` as a float64 uniform; where
    the JAX sampler reuses one key for two draws, one uniform serves both,
    so the rows have the same joint distribution.

    :param tables: :func:`build_sampling_tables`, on the generator's device
    :param poses: ``[F, 4, 4]`` float32 camera-to-world of every cached frame
    :param type_probs: ``((match_type, probability), ...)`` over {0
        within-scene, 1 across-scene, 2 different-object, 4 synthetic
        multi-object}
    :param with_second: also return a second within-scene pair
        ``(frame_a_2, frame_b_2)``: for synthetic multi-object rows from
        another object's scene (both pairs pose-rejected, else the row is
        the empty pair), for the others the row's own pair. Required when 4
        is in ``type_probs``.
    :return: ``(frame_a [B], frame_b [B], match_type [B])`` int64, with
        ``(frame_a_2, frame_b_2)`` before ``match_type`` when ``with_second``
    """
    offsets = tables["scene_offsets"]
    lengths = tables["scene_lengths"]
    by_obj = tables["scenes_by_object"]
    per_obj = tables["scenes_per_object"]
    dev = offsets.device
    S, O = offsets.shape[0], by_obj.shape[0]
    B, K = batch_size, NUM_POSE_CANDIDATES

    type_probs = tuple((t, p) for t, p in type_probs if p > 0)
    if any(t not in SAMPLED_TYPES for t, _ in type_probs):
        raise ValueError(f"the device sampler draws the types {SAMPLED_TYPES}, got {type_probs}")
    has_smo = any(t == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT for t, _ in type_probs)
    if has_smo and not with_second:
        raise ValueError(
            "SYNTHETIC_MULTI_OBJECT in type_probs requires with_second=True")

    def uniform(*shape):
        return torch.rand((B,) + shape, generator=generator, device=generator.device,
                          dtype=torch.float64).to(dev)

    # one uniform per key of the JAX sampler's row (ks[0..10]); its
    # candidate keys draw K each
    u = {k: uniform() for k in (0, 1, 2, 3, 4, 5, 6, 7, 9)}
    u_cand = {k: uniform(K) for k in (3, 8, 10)}

    types = torch.as_tensor([t for t, _ in type_probs], dtype=torch.int64, device=dev)
    cdf = torch.cumsum(torch.as_tensor([p for _, p in type_probs], dtype=torch.float64,
                                       device=dev), 0)
    pick = torch.searchsorted(cdf, (u[0] * cdf[-1])[:, None], right=True)[:, 0]
    mt = types[torch.clamp(pick, max=len(type_probs) - 1)]

    def frame_in_scene(uf, s):
        return offsets[s] + draw_below(uf, lengths[s])

    def within_pair(uf, uc, s):
        """Frame a in scene ``s`` and the first of K candidates whose pose
        differs enough (else a again); ok is False when none does."""
        fa = frame_in_scene(uf, s)
        cand = offsets[s][:, None] + draw_below(uc, lengths[s][:, None])
        ok = _pose_ok(poses[fa], poses[cand])
        any_ok = ok.any(dim=-1)
        first = torch.argmax(ok.to(torch.uint8), dim=-1)
        fb = torch.where(any_ok, cand.gather(1, first[:, None])[:, 0], fa)
        return fa, fb, any_ok

    # within-scene: pose-difference rejection in a uniform scene
    s_w = draw_below(u[1], S)
    fa_w, fb_w, ok_w = within_pair(u[2], u_cand[3], s_w)
    mt_w = torch.where(ok_w, MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE, -1)

    # across-scene: two scenes of one object (the same scene when the object
    # has only one, as the host sampler does)
    o_x = draw_below(u[4], O)
    n_o = per_obj[o_x]
    i1 = draw_below(u[5], n_o)
    i2 = torch.where(n_o > 1, (i1 + 1 + draw_below(u[6], n_o - 1)) % n_o, i1)
    s_x1, s_x2 = by_obj[o_x, i1], by_obj[o_x, i2]

    # different-object / synthetic multi-object: two distinct objects (the
    # same one when there is only one, as the host sampler does)
    o_d1 = o_x
    o_d2 = (o_x + 1 + draw_below(u[7], max(O - 1, 1))) % O if O > 1 else o_x
    s_d1 = by_obj[o_d1, draw_below(u[5], per_obj[o_d1])]
    s_d2 = by_obj[o_d2, draw_below(u[6], per_obj[o_d2])]

    is_within = mt == MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE
    is_across = mt == MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE
    is_smo = mt == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT
    s_a = torch.where(is_within | is_smo, torch.where(is_smo, s_d1, s_w),
                      torch.where(is_across, s_x1, s_d1))
    s_b = torch.where(is_within | is_smo, s_a, torch.where(is_across, s_x2, s_d2))
    fa = torch.where(is_within, fa_w, frame_in_scene(u[2], s_a))
    fb = torch.where(is_within, fb_w, frame_in_scene(u[3], s_b))
    mt_out = torch.where(is_within, mt_w, mt)
    if has_smo:  # pair 1 of a synthetic multi-object row: within object 1's scene
        fa_m1, fb_m1, ok_m1 = within_pair(u[2], u_cand[8], s_d1)
        fa = torch.where(is_smo, fa_m1, fa)
        fb = torch.where(is_smo, fb_m1, fb)

    if not with_second:
        return fa, fb, mt_out

    # pair 2: within object 2's scene; both pairs must pass pose rejection
    fa2, fb2, ok_2 = within_pair(u[9], u_cand[10], s_d2)
    if has_smo:
        mt_out = torch.where(is_smo & ~(ok_m1 & ok_2), -1, mt_out)
    is_pair2 = mt_out == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT
    return (fa, fb, torch.where(is_pair2, fa2, fa), torch.where(is_pair2, fb2, fb), mt_out)


class DeviceSampledTrainStep(TrainStep):
    """``step(state, generator) -> metrics``: one train step with its pairs
    sampled on the device (:func:`device_sample_pairs_mixed`), its frames
    gathered from the cache, then
    :class:`~pdc_tpu_torch.training.train.TrainStep`'s assembly and update;
    every draw from ``generator``, which lives on the cache's device."""

    def __init__(self, *args, cache, batch_size: int, type_probs, **kwargs):
        super().__init__(*args, **kwargs)
        self.cache = cache
        self.batch_size = batch_size
        self.type_probs = tuple((t, p) for t, p in type_probs if p > 0)
        self.with_second = any(t == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT
                               for t, _ in self.type_probs)
        self.tables = build_sampling_tables(cache)
        self.poses = torch.as_tensor(cache.poses, dtype=torch.float32, device=cache.device)
        self.Ks = torch.as_tensor(cache.Ks, dtype=torch.float32, device=cache.device)

    def sample(self, generator: torch.Generator) -> dict:
        """One batch of pairs: frame indices, poses and intrinsics on the
        device, the index batch that :meth:`DeviceCache.gather` reads."""
        out = device_sample_pairs_mixed(generator, self.tables, self.poses, self.batch_size,
                                        self.type_probs, with_second=self.with_second)
        index = {"frame_a": out[0], "frame_b": out[1], "match_type": out[-1]}
        pairs = [("", out[0], out[1])]
        if self.with_second:
            index.update(frame_a_2=out[2], frame_b_2=out[3])
            pairs.append(("_2", out[2], out[3]))
        for sfx, fa, fb in pairs:
            index.update({"pose_a" + sfx: self.poses[fa], "pose_b" + sfx: self.poses[fb],
                          "K" + sfx: self.Ks[fa]})
        return index

    def __call__(self, state: TrainState, generator: torch.Generator):
        batch = self.cache.gather(self.sample(generator))
        return self.update(state, *self.assemble(state, batch, generator))


def make_device_sampled_train_step(training_config: dict, loss_cfg, assembler_cfg,
                                   image_width: int, cache, batch_size: int,
                                   type_probs) -> DeviceSampledTrainStep:
    """The train step of the on-device sampler route; see
    :class:`DeviceSampledTrainStep`. ``type_probs`` as in
    :func:`device_sample_pairs_mixed`."""
    return DeviceSampledTrainStep(training_config, loss_cfg, assembler_cfg, image_width,
                                  cache=cache, batch_size=batch_size, type_probs=type_probs)
