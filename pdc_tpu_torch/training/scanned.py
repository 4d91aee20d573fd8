"""Pair sampling on the device, over the frames of a device cache, and K
train steps per call.

Port of the type-mixed sampler of :mod:`pdc_tpu.training.scanned`:
``POSE_*`` and ``NUM_POSE_CANDIDATES`` (:37-39), ``build_sampling_tables``
(:42-70), ``device_sample_pairs_mixed`` (:73-176) and ``_pose_ok``
(:179-186), as tensor functions over the whole batch that draw from a
``torch.Generator`` on the cache's device. Within-scene pairs take frame a
uniformly in a uniform scene and frame b as the first of 16 candidates of
that scene whose pose differs from a's by more than 0.2 m or 20 degrees
(the empty pair, type -1, when none does). ``device_sample_pairs`` (:322)
is this sampler's type-0 case.

The bounded samplers ``device_sample_pairs_bounded`` (:189) and
``device_sample_pairs_mixed_bounded`` (:218) draw from one rank's
zero-padded tables of a
:class:`~pdc_tpu_torch.data.device_cache.ShardedDeviceCache`, and
:func:`make_sharded_cache_train_step` (:359) trains over such a cache.

:func:`make_scanned_train_step` (:517) takes ``steps_per_dispatch`` (K)
train steps per call, as the JAX package's ``lax.scan`` does, and returns
their metrics as ``[K]`` tensors (:class:`ScannedTrainStep`). One step is
:class:`DeviceSampledTrainStep`: sample, gather, assemble, forward, the
pooled hinge (K1), backward (K2) and Adam, all on the device with no host
sync. On a card the first call captures that step into one CUDA graph,
after eager warm-up steps whose effects it undoes, and every call replays
the graph K times. Adam is then the capturable one (:func:`to_capturable`),
its LR read from :func:`~pdc_tpu_torch.training.schedule.make_lr_schedule`
of a device count. On the CPU, and with a mesh, a call runs the K steps
eagerly: the collectives of a process group are not captured.

The ``mesh``/``fsdp`` semantics (:570-700) are ported: with a mesh each
rank samples its own ``batch_size`` pairs (from a generator seeded per
rank, :func:`~pdc_tpu_torch.parallel.sharded_train.rank_seed`), runs its
own BatchNorm, and the gradients (reduce-scattered under ``fsdp``), the
running statistics and the metrics are averaged over the ranks before one
Adam step (:func:`~pdc_tpu_torch.parallel.sharded_train.data_parallel_update`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from pdc_tpu_torch.losses.composer import (
    MATCH_TYPE_DIFFERENT_OBJECT,
    MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE,
    MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE,
    MATCH_TYPE_SYNTHETIC_MULTI_OBJECT,
)
from pdc_tpu_torch.ops import launches, pooled_hinge
from pdc_tpu_torch.parallel.sharded_train import data_parallel_update
from pdc_tpu_torch.parallel.tensor_parallel import to_fsdp_state
from pdc_tpu_torch.training.schedule import make_lr_schedule
from pdc_tpu_torch.training.train import TrainState, TrainStep, build_loss_fn, make_optimizer
from pdc_tpu_torch.utils.device import device_constant

logger = logging.getLogger(__name__)

POSE_DIST_THRESHOLD = 0.2     # metres (reference threshold)
POSE_ANGLE_THRESHOLD = 20.0   # degrees
NUM_POSE_CANDIDATES = 16      # rejection-sampling candidates per pair
SAMPLED_TYPES = (0, 1, 2, 4)  # the types this sampler draws
# eager steps before a CUDA graph is captured (cuDNN's and the allocator's
# first calls, Adam's state, the library's preparation); their effects on
# the state and the generator are undone before the capture
WARMUP_STEPS = 1


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
    ``u`` (a bound per row); a bound below 1 is taken as 1. An int bound
    makes no tensor (no copy from host memory, which a CUDA graph cannot
    capture)."""
    if not isinstance(n, torch.Tensor):
        n = max(int(n), 1)
        return torch.clamp(torch.floor(u * float(n)).to(torch.int64), max=n - 1)
    n = torch.clamp(n.to(device=u.device, dtype=torch.int64), min=1)
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

    mt = _draw_types(u[0], type_probs, dev)

    def frame_in_scene(uf, s):
        return _frame_in_scene(offsets, lengths, s, uf)

    def within_pair(uf, uc, s):
        return _within_pair(poses, offsets, lengths, s, uf, uc)

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


def _draw_types(u, type_probs, dev):
    """Each row's match type from its uniform ``u``, by the mix's CDF (its
    tables of types and probabilities made once a device)."""
    types = device_constant([t for t, _ in type_probs], torch.int64, dev)
    cdf = torch.cumsum(device_constant([p for _, p in type_probs], torch.float64, dev), 0)
    pick = torch.searchsorted(cdf, (u * cdf[-1])[:, None], right=True)[:, 0]
    return types[torch.clamp(pick, max=len(type_probs) - 1)]


def device_sample_pairs(generator: torch.Generator, scene_offsets, scene_lengths,
                        poses: torch.Tensor, batch_size: int):
    """Within-scene pairs, the type-0 case of :func:`device_sample_pairs_mixed`
    (the same draws): ``(frame_a [B], frame_b [B], match_type [B])`` int64,
    the type 0, or -1 where no candidate's pose differs enough.

    :param scene_offsets, scene_lengths: ``[S]`` int64 first frame and frame
        count of each scene, on the generator's device
    """
    S = scene_offsets.shape[0]
    dev = scene_offsets.device
    tables = {"scene_offsets": scene_offsets, "scene_lengths": scene_lengths,
              "scenes_by_object": torch.arange(S, device=dev)[None],
              "scenes_per_object": torch.full((1,), S, dtype=torch.int64, device=dev)}
    return device_sample_pairs_mixed(generator, tables, poses, batch_size,
                                     ((MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE, 1.0),))


def _frame_in_scene(offsets, lengths, s, uf):
    """A frame uniform in scene ``s`` of a scene table, from uniforms ``uf``."""
    return offsets[s] + draw_below(uf, lengths[s])


def _within_pair(poses, offsets, lengths, s, uf, uc):
    """Frame a in scene ``s`` and the first of the candidates whose pose
    differs enough (else a again): ``(fa, fb, ok)``, ok False when none
    does."""
    fa = _frame_in_scene(offsets, lengths, s, uf)
    cand = offsets[s][:, None] + draw_below(uc, lengths[s][:, None])
    ok = _pose_ok(poses[fa], poses[cand])
    any_ok = ok.any(dim=-1)
    first = torch.argmax(ok.to(torch.uint8), dim=-1)
    return fa, torch.where(any_ok, cand.gather(1, first[:, None])[:, 0], fa), any_ok


def device_sample_pairs_bounded(generator: torch.Generator, scene_offsets, scene_lengths,
                                num_scenes: int, poses: torch.Tensor, batch_size: int):
    """Within-scene pairs from one rank's zero-padded scene table (entries
    from ``num_scenes`` on are padding): ``(frame_a, frame_b, match_type)``
    int64 ``[B]``, local frame indices of the rank's block; type -1 where
    no candidate's pose differs enough."""
    dev = scene_offsets.device
    B, K = batch_size, NUM_POSE_CANDIDATES

    def uniform(*shape):
        return torch.rand((B,) + shape, generator=generator, device=generator.device,
                          dtype=torch.float64).to(dev)

    s = draw_below(uniform(), max(int(num_scenes), 1))
    fa, fb, ok = _within_pair(poses, scene_offsets, scene_lengths, s, uniform(), uniform(K))
    return fa, fb, torch.where(ok, MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE, -1)


def device_sample_pairs_mixed_bounded(generator: torch.Generator, offsets, lengths,
                                      num_scenes: int, by_obj, per_obj, num_obj: int,
                                      poses: torch.Tensor, batch_size: int, type_probs,
                                      with_second: bool = False):
    """Type-mixed pairs from one rank's zero-padded tables (the bounded
    form of :func:`device_sample_pairs_mixed`, same draws and returns).

    The fallbacks follow the host sampler's: an across-scene draw on an
    object of one scene uses that scene twice; a different-object draw on
    a rank with one object becomes within-scene (type 0); a synthetic
    multi-object draw there composites the same object twice.

    :param offsets, lengths: ``[Smax]`` local scene table; ``num_scenes``
        real entries
    :param by_obj: ``[Omax, Mmax]`` local scene slots (-1 padded),
        ``per_obj [Omax]``, ``num_obj`` real objects
    """
    dev = offsets.device
    B, K = batch_size, NUM_POSE_CANDIDATES
    type_probs = tuple((t, p) for t, p in type_probs if p > 0)
    if any(t not in SAMPLED_TYPES for t, _ in type_probs):
        raise ValueError(f"the device sampler draws the types {SAMPLED_TYPES}, got {type_probs}")
    has_smo = any(t == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT for t, _ in type_probs)
    if has_smo and not with_second:
        raise ValueError("SYNTHETIC_MULTI_OBJECT in type_probs requires with_second=True")
    S, O = max(int(num_scenes), 1), max(int(num_obj), 1)

    def uniform(*shape):
        return torch.rand((B,) + shape, generator=generator, device=generator.device,
                          dtype=torch.float64).to(dev)

    u = {k: uniform() for k in (0, 1, 2, 3, 4, 5, 6, 7, 9)}
    u_cand = {k: uniform(K) for k in (3, 8, 10)}
    mt = _draw_types(u[0], type_probs, dev)
    if int(num_obj) < 2:  # different-object needs two objects on this rank
        mt = torch.where(mt == MATCH_TYPE_DIFFERENT_OBJECT, 0, mt)

    s_w = draw_below(u[1], S)
    fa_w, fb_w, ok_w = _within_pair(poses, offsets, lengths, s_w, u[2], u_cand[3])
    mt_w = torch.where(ok_w, MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE, -1)

    o_x = draw_below(u[4], O)
    n_o = per_obj[o_x]
    i1 = draw_below(u[5], n_o)
    i2 = torch.where(n_o > 1, (i1 + 1 + draw_below(u[6], n_o - 1)) % torch.clamp(n_o, min=1),
                     i1)
    s_x1, s_x2 = by_obj[o_x, i1], by_obj[o_x, i2]
    o_d2 = (o_x + 1 + draw_below(u[7], O - 1)) % O if O > 1 else o_x
    s_d1 = by_obj[o_x, draw_below(u[5], per_obj[o_x])]
    s_d2 = by_obj[o_d2, draw_below(u[6], per_obj[o_d2])]

    is_within = mt == MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE
    is_across = mt == MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE
    is_smo = mt == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT
    s_a = torch.where(is_within | is_smo, torch.where(is_smo, s_d1, s_w),
                      torch.where(is_across, s_x1, s_d1))
    s_b = torch.where(is_within | is_smo, s_a, torch.where(is_across, s_x2, s_d2))
    fa = torch.where(is_within, fa_w, _frame_in_scene(offsets, lengths, s_a, u[2]))
    fb = torch.where(is_within, fb_w, _frame_in_scene(offsets, lengths, s_b, u[3]))
    mt_out = torch.where(is_within, mt_w, mt)
    if has_smo:
        fa_m1, fb_m1, ok_m1 = _within_pair(poses, offsets, lengths, s_d1, u[2], u_cand[8])
        fa = torch.where(is_smo, fa_m1, fa)
        fb = torch.where(is_smo, fb_m1, fb)
    if not with_second:
        return fa, fb, mt_out
    fa2, fb2, ok_2 = _within_pair(poses, offsets, lengths, s_d2, u[9], u_cand[10])
    if has_smo:
        mt_out = torch.where(is_smo & ~(ok_m1 & ok_2), -1, mt_out)
    is_pair2 = mt_out == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT
    return (fa, fb, torch.where(is_pair2, fa2, fa), torch.where(is_pair2, fb2, fb), mt_out)


class _DataParallelStep(TrainStep):
    """A train step whose update, given a mesh, is the data-parallel one
    (:func:`~pdc_tpu_torch.parallel.sharded_train.data_parallel_update`);
    with ``fsdp`` its first call switches the state to ZeRO storage in
    place (:func:`~pdc_tpu_torch.parallel.tensor_parallel.to_fsdp_state`)."""

    def __init__(self, *args, mesh=None, data_axis: str = "data", fsdp: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        if fsdp and mesh is None:
            raise ValueError("fsdp=True requires a mesh")
        self.mesh, self.data_axis, self.fsdp = mesh, data_axis, fsdp

    def update(self, state: TrainState, img_a, img_b, indices):
        if self.mesh is None:
            return super().update(state, img_a, img_b, indices)
        if self.fsdp:
            to_fsdp_state(state, self.training_config, self.mesh, self.data_axis)
        return data_parallel_update(self, state, img_a, img_b, indices, self.mesh,
                                    self.data_axis)


class DeviceSampledTrainStep(_DataParallelStep):
    """``step(state, generator) -> metrics``: one train step with its pairs
    sampled on the device (:func:`device_sample_pairs_mixed`), its frames
    gathered from the cache, then
    :class:`~pdc_tpu_torch.training.train.TrainStep`'s assembly and update
    (the data-parallel update with a mesh); every draw from ``generator``,
    which lives on the cache's device. Synthetic multi-object rows are
    composited in every row and selected (the assembly's
    ``composite_every_row``), so nothing in the step waits on the host.

    With a capturable Adam (:func:`to_capturable`) the update is
    :meth:`device_update`, whose LR is the schedule of a device count; that
    is the form a CUDA graph captures (:class:`ScannedTrainStep`)."""

    def __init__(self, *args, cache, batch_size: int, type_probs, **kwargs):
        super().__init__(*args, **kwargs)
        self.cache = cache
        self.batch_size = batch_size
        self.type_probs = tuple((t, p) for t, p in type_probs if p > 0)
        self.with_second = any(t == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT
                               for t, _ in self.type_probs)
        # synthetic multi-object rows composite exactly when the mix draws
        # them, whatever the config said (as the JAX package's scanned step)
        self.assembler_cfg = dataclasses.replace(
            self.assembler_cfg, enable_synthetic_multi_object=self.with_second)
        self.tables = build_sampling_tables(cache)
        self.poses = torch.as_tensor(cache.poses, dtype=torch.float32, device=cache.device)
        self.Ks = torch.as_tensor(cache.Ks, dtype=torch.float32, device=cache.device)
        self.lr_schedule = make_lr_schedule(self.training_config)
        # the schedule's count on the device, read by device_update
        self.count = torch.zeros((), dtype=torch.int64, device=cache.device)

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

    def update(self, state: TrainState, img_a, img_b, indices):
        if self.mesh is not None or not _is_capturable(state.optimizer):
            return super().update(state, img_a, img_b, indices)
        self.count.fill_(state.step - state.schedule_start)
        metrics = self.device_update(state, img_a, img_b, indices)
        state.step += 1
        return metrics

    def device_update(self, state: TrainState, img_a, img_b, indices):
        """One update with a capturable Adam that reads and writes only the
        device: forward, backward, the LR of :attr:`count` written into
        Adam's LR tensor, Adam's step, and the count advanced. The
        gradients stay allocated (zeroed, not set to None); the host count
        ``state.step`` is the caller's to advance."""
        optimizer = state.optimizer
        loss_fn = build_loss_fn(state.module, self.loss_cfg, self.image_width, self.compose)
        optimizer.zero_grad(set_to_none=False)
        loss, metrics = loss_fn(img_a, img_b, indices)
        loss.backward()
        lr = self.lr_schedule(self.count)
        for group in optimizer.param_groups:
            group["lr"].copy_(lr)
        optimizer.step()
        self.count += 1
        return metrics

    def sampled_update(self, state: TrainState, generator: torch.Generator):
        """Sample, gather, assemble and :meth:`device_update`: the step that
        :class:`ScannedTrainStep` captures."""
        batch = self.cache.gather(self.sample(generator))
        return self.device_update(
            state, *self.assemble(state, batch, generator, composite_every_row=True))

    def __call__(self, state: TrainState, generator: torch.Generator):
        batch = self.cache.gather(self.sample(generator))
        return self.update(state,
                           *self.assemble(state, batch, generator, composite_every_row=True))


def make_device_sampled_train_step(training_config: dict, loss_cfg, assembler_cfg,
                                   image_width: int, cache, batch_size: int,
                                   type_probs, mesh=None, data_axis: str = "data",
                                   fsdp: bool = False) -> DeviceSampledTrainStep:
    """The train step of the on-device sampler route; see
    :class:`DeviceSampledTrainStep`. ``type_probs`` as in
    :func:`device_sample_pairs_mixed`. With ``mesh`` every rank holds the
    whole cache and the step is data-parallel over ``data_axis`` (the
    global batch is ``batch_size`` times the ranks); ``fsdp`` (needs
    ``mesh``) adds ZeRO storage of the state."""
    return DeviceSampledTrainStep(training_config, loss_cfg, assembler_cfg, image_width,
                                  cache=cache, batch_size=batch_size, type_probs=type_probs,
                                  mesh=mesh, data_axis=data_axis, fsdp=fsdp)


def _is_capturable(optimizer) -> bool:
    return bool(optimizer.defaults.get("capturable"))


def to_capturable(state: TrainState, training_config: dict):
    """Switch ``state`` to a capturable Adam (:func:`make_optimizer` with
    ``capturable=True``) holding the same moments, its step counts moved
    to the parameters' device; the parameters are not touched."""
    old = state.optimizer
    if _is_capturable(old):
        return
    params = list(state.module.parameters())
    new = make_optimizer(training_config, params, capturable=True)
    for p in params:
        st = old.state.get(p)
        if st:
            new.state[p] = dict(st, step=torch.tensor(float(st["step"]), dtype=torch.float32,
                                                      device=p.device))
    state.optimizer = new


def _state_tensors(state: TrainState):
    """Every tensor a captured step reads or writes in place: the module's
    parameters, gradients and buffers, Adam's state and its LR tensor."""
    params = list(state.module.parameters())
    out = params + [p.grad for p in params if p.grad is not None]
    out += list(state.module.buffers())
    out += [t for st in state.optimizer.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]
    return out + [g["lr"] for g in state.optimizer.param_groups]


def _binding(state: TrainState, generator: torch.Generator):
    """What a captured graph is bound to: the state's objects and the
    addresses of its tensors."""
    return (id(state.module), id(state.optimizer), id(generator),
            tuple(t.data_ptr() for t in _state_tensors(state)))


class ScannedTrainStep:
    """``step(state, generator) -> metrics``: ``steps_per_dispatch`` (K)
    calls of ``step`` (a :class:`DeviceSampledTrainStep`) per call, as the
    JAX package's scanned step; the metrics as ``[K]`` float32 tensors on
    the device, ``state.step`` advanced by K and ``generator`` as K calls
    leave it.

    Whether a call replays a CUDA graph is decided here, once: on a card
    without a mesh (:attr:`graphed`). The first call then switches the
    state to a capturable Adam (:func:`to_capturable`), runs
    :data:`WARMUP_STEPS` eager steps on a side stream and undoes them
    (state and generator restored in place), and captures one
    :meth:`DeviceSampledTrainStep.sampled_update` into a
    ``torch.cuda.CUDAGraph`` with the generator registered; every call
    replays it K times, each replay writing its metrics into slot k of
    ``[K]`` buffers through a device counter. A call on another state, or
    on a state whose tensors were replaced, captures anew. A capture that
    fails raises. Otherwise (the CPU, a mesh) a call runs the K steps
    eagerly. :attr:`launches_per_dispatch` gives the pooled hinge's
    launches of a call, recorded at the capture (replays count them) or in
    the eager call; each replay adds every kernel's recorded launches to
    its counters (``ops/launches.py``)."""

    def __init__(self, step: DeviceSampledTrainStep, steps_per_dispatch: int):
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be at least 1, got {steps_per_dispatch}")
        self.step = step
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.graphed = step.cache.device.type == "cuda" and step.mesh is None
        self.launches_per_dispatch: Optional[dict] = None
        self._graph = None
        logger.info("%d train steps a call, %s", self.steps_per_dispatch,
                    "one CUDA graph replayed" if self.graphed else
                    "run eagerly (collectives over a process group are not captured)"
                    if step.mesh is not None else "run eagerly on the CPU")

    def __call__(self, state: TrainState, generator: torch.Generator) -> dict:
        if self.graphed:
            return self._replay(state, generator)
        with launches.recording() as recorded:
            metrics = [self.step(state, generator) for _ in range(self.steps_per_dispatch)]
        self.launches_per_dispatch = launches.passes(recorded, pooled_hinge.__name__)
        return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    def _replay(self, state: TrainState, generator: torch.Generator) -> dict:
        step, k = self.step, self.steps_per_dispatch
        if self._graph is None or self._bound != _binding(state, generator):
            self.capture(state, generator)
        step.count.fill_(state.step - state.schedule_start)
        self._slot.zero_()
        for _ in range(k):
            self._graph.replay()
        launches.count_replays(self._recorded, k)
        state.step += k
        return {name: buf.clone() for name, buf in self._metrics.items()}

    def capture(self, state: TrainState, generator: torch.Generator):
        """Capture the graph for ``state`` and ``generator`` (the first call
        does it if nothing was captured for them); leaves both as they
        were, but for the capturable Adam."""
        if not self.graphed:
            raise RuntimeError("this scanned step runs eagerly: nothing to capture")
        step, k = self.step, self.steps_per_dispatch
        dev = step.cache.device
        self._graph = None  # the previous graph, and the generator's registration with it
        to_capturable(state, step.training_config)
        saved_generator = generator.get_state()
        had_state = {id(p) for p in state.optimizer.state}
        saved = [(t, t.detach().clone()) for t in _state_tensors(state)]
        step.count.fill_(state.step - state.schedule_start)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                metrics = step.sampled_update(state, generator)
        torch.cuda.current_stream(dev).wait_stream(side)
        # undo the warm-up: the saved tensors in place; Adam's state that the
        # warm-up created is zeros at step 0, as Adam makes it
        with torch.no_grad():
            for t, value in saved:
                t.copy_(value)
            for p, st in state.optimizer.state.items():
                if id(p) not in had_state:
                    for t in st.values():
                        t.zero_()
        generator.set_state(saved_generator)
        self._metrics = {name: torch.zeros(k, dtype=torch.float32, device=dev)
                         for name in metrics}
        self._slot = torch.zeros(1, dtype=torch.int64, device=dev)
        # the gradients are allocated by the captured backward, in the graph's pool
        state.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with launches.recording() as recorded, torch.cuda.graph(graph):
            metrics = step.sampled_update(state, generator)
            for name, value in metrics.items():
                self._metrics[name].index_copy_(0, self._slot, value.reshape(1).float())
            self._slot += 1
        self._graph, self._recorded = graph, recorded
        self._bound = _binding(state, generator)
        self.launches_per_dispatch = {
            kind: n * k for kind, n in launches.passes(recorded, pooled_hinge.__name__).items()}
        logger.info("captured the train step into a CUDA graph, kernel launches per step: %s",
                    dict(recorded))


def make_scanned_train_step(training_config: dict, loss_cfg, assembler_cfg, image_width: int,
                            cache, batch_size: int, steps_per_dispatch: int, mesh=None,
                            data_axis: str = "data", type_probs=None,
                            fsdp: bool = False) -> ScannedTrainStep:
    """``step(state, generator) -> metrics dict of [K] tensors``: K =
    ``steps_per_dispatch`` device-sampled train steps a call
    (:class:`ScannedTrainStep` over :class:`DeviceSampledTrainStep`), as
    ``pdc_tpu/training/scanned.py:517`` builds them. ``type_probs`` over {0,
    1, 2, 4} (default within-scene only); ``mesh`` and ``fsdp`` as in
    :func:`make_device_sampled_train_step`."""
    step = make_device_sampled_train_step(
        training_config, loss_cfg, assembler_cfg, image_width, cache, batch_size,
        type_probs or ((MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE, 1.0),), mesh=mesh,
        data_axis=data_axis, fsdp=fsdp)
    return ScannedTrainStep(step, steps_per_dispatch)


class ShardedCacheTrainStep(_DataParallelStep):
    """``step(state, generator) -> metrics`` over a
    :class:`~pdc_tpu_torch.data.device_cache.ShardedDeviceCache`: this rank
    samples ``batch_size`` pairs from its own scenes (the bounded samplers),
    gathers them from its block, assembles them and takes the
    data-parallel update over the cache's mesh."""

    def __init__(self, *args, cache, batch_size: int, type_probs=None, **kwargs):
        super().__init__(*args, mesh=cache.mesh, data_axis=cache.data_axis, **kwargs)
        self.cache = cache
        self.batch_size = batch_size
        probs = tuple((t, p) for t, p in (type_probs or ((0, 1.0),)) if p > 0)
        self.mixed = any(t != 0 for t, _ in probs)
        self.type_probs = probs
        self.with_second = any(t == MATCH_TYPE_SYNTHETIC_MULTI_OBJECT for t, _ in probs)
        self.assembler_cfg = dataclasses.replace(
            self.assembler_cfg, enable_synthetic_multi_object=self.with_second)

    def sample(self, generator: torch.Generator) -> dict:
        """One batch of local frame indices and types from this rank's
        tables."""
        c = self.cache
        if self.mixed:
            out = device_sample_pairs_mixed_bounded(
                generator, c.scene_offsets, c.scene_lengths, c.num_scenes, c.scenes_by_object,
                c.scenes_per_object, c.num_objects, c.poses, self.batch_size, self.type_probs,
                with_second=self.with_second)
        else:
            out = device_sample_pairs_bounded(generator, c.scene_offsets, c.scene_lengths,
                                              c.num_scenes, c.poses, self.batch_size)
        index = {"frame_a": out[0], "frame_b": out[1], "match_type": out[-1]}
        if self.with_second:
            index.update(frame_a_2=out[2], frame_b_2=out[3])
        return index

    def __call__(self, state: TrainState, generator: torch.Generator):
        batch = self.cache.gather(self.sample(generator))
        return self.update(state,
                           *self.assemble(state, batch, generator, composite_every_row=True))


def make_sharded_cache_train_step(training_config: dict, loss_cfg, assembler_cfg,
                                  image_width: int, cache, batch_size: int,
                                  type_probs=None, fsdp: bool = False,
                                  steps_per_dispatch: Optional[int] = None):
    """Data-parallel training over a sharded cache; see
    :class:`ShardedCacheTrainStep`. ``type_probs`` over {0, 1, 2, 4}
    (default within-scene only; build the cache ``by_object`` for the other
    types); ``fsdp`` adds ZeRO storage of the state, so each rank holds 1/n
    of the frames and 1/n of the state. With ``steps_per_dispatch`` K, a
    call takes K steps and returns ``[K]`` metrics, as
    ``pdc_tpu/training/scanned.py:359`` does (:class:`ScannedTrainStep`;
    eagerly, since its collectives are not captured); without it, one
    step."""
    step = ShardedCacheTrainStep(training_config, loss_cfg, assembler_cfg, image_width,
                                 cache=cache, batch_size=batch_size, type_probs=type_probs,
                                 fsdp=fsdp)
    return step if steps_per_dispatch is None else ScannedTrainStep(step, steps_per_dispatch)
