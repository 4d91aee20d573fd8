"""Data-parallel training, inference and best match over the data axis.

Port of :mod:`pdc_tpu.parallel.sharded_train` (:27-156). The JAX step is
one jitted program over the global batch of pairs, sharded over the mesh;
GSPMD makes it equal to the single-device step on the whole batch. Here
each rank runs the step on its block of the pairs, and the cross-rank
terms of that global program are collectives:

  * BatchNorm's train-mode statistics span every rank's images: each
    rank's per-channel ``E[x]`` and ``E[x^2]``, computed as the port's
    BatchNorm computes them on one device, are averaged over the ranks in
    one all-reduce per BatchNorm, whose backward all-reduces their
    gradient (:func:`cross_rank_batchnorm`); the variance is flax's
    ``E[x^2] - E[x]^2`` over the global batch (ROADMAP F8). The ranks'
    blocks are of one size (:func:`shard_host_batch` splits evenly), so the
    mean of their moments is the global batch's, and on one rank the
    step's numbers are the single-device step's;
  * the loss is a mean over the global batch's non-empty pairs: the loss
    composer's terms are per pair, so only the count of non-empty pairs
    (and of valid matches, for the metric) is all-reduced before dividing;
    each rank's loss is its share of the global loss, and the gradients are
    summed over ranks;
  * the metrics are summed over ranks, so every rank holds the global
    ones; the state stays replicated, or in ZeRO storage
    (:func:`~pdc_tpu_torch.parallel.tensor_parallel.make_fsdp_train_step`).

:func:`data_parallel_update` is the other reduction, that of the JAX
package's scanned DP step (``pdc_tpu/training/scanned.py:630-656``): each
rank's own loss with its own BatchNorm, then the gradients, the running
statistics and the metrics averaged over ranks.

:func:`make_pixel_sharded_best_match` splits the pixels of one descriptor
image over the ranks, each running the best-match kernel on its block.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models.resnet import FlaxBatchNorm2d
from pdc_tpu_torch.ops.best_match import best_match
from pdc_tpu_torch.ops.pooled_hinge import pooled_hinge
from pdc_tpu_torch.parallel.mesh import Mesh, block_range, shard_leading
from pdc_tpu_torch.training.schedule import host_lr
from pdc_tpu_torch.training.train import TrainState, TrainStep, build_loss_fn

METRIC_KEYS = ("loss", "match_loss", "masked_non_match_loss", "background_non_match_loss",
               "blind_non_match_loss")


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of ``rank`` in a data-parallel run seeded
    ``seed``: the seed folded with the rank, so ranks draw different pairs;
    rank 0 keeps ``seed``, so a world of one draws what one device does."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1, np.uint64)[0]
               >> 1)


def shard_host_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's block of a host batch's pair axis, on its device; every
    entry's leading axis must split evenly over the ranks."""
    return {k: shard_leading(np.asarray(v), mesh, axis) for k, v in batch.items()}


@contextlib.contextmanager
def cross_rank_batchnorm(module: torch.nn.Module, mesh: Mesh, axis: str = "data"):
    """Within the block, the module's train-mode BatchNorms take their
    statistics over every rank's batch of ``axis``: this rank's ``[E[x],
    E[x^2]]`` averaged over the ranks in one differentiable all-reduce per
    BatchNorm (the backward all-reduces its gradient), so the running
    statistics are updated with the global mean and biased variance on
    every rank alike. Every rank's batch must hold as many images. Not
    ``torch.nn.SyncBatchNorm``, which refuses CPU tensors."""
    def moments(xf):
        C = xf.shape[1]
        local = torch.cat([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        both = mesh.all_reduce(local, axis, differentiable=True) / mesh.shape[axis]
        return both[:C], both[C:]

    bns = [m for m in module.modules() if isinstance(m, FlaxBatchNorm2d)]
    for m in bns:
        m.moments = moments
    try:
        yield
    finally:
        for m in bns:
            m.moments = None


def build_sharded_loss_fn(module: torch.nn.Module, loss_cfg: LossConfig, image_width: int,
                          compose, mesh: Mesh, axis: str = "data"):
    """This rank's share of the global batch's train-mode loss: the forward
    of its ``[2b]`` images (under :func:`cross_rank_batchnorm`), the per-pair
    terms, and their sum over its non-empty pairs divided by the global
    count of non-empty pairs. ``loss_fn(img_a, img_b, indices) -> (loss,
    shares, num_valid_matches)``: ``shares`` are this rank's parts of the
    metrics (the global metric is their sum over ranks);
    ``num_valid_matches`` is the global batch's already."""

    def loss_fn(img_a, img_b, indices):
        B, H, W, _ = img_a.shape
        imgs = torch.cat([img_a, img_b], dim=0).permute(0, 3, 1, 2).contiguous()
        module.train()
        out = module(imgs)
        pred = out.permute(0, 2, 3, 1).reshape(2 * B, H * W, out.shape[1])
        terms = compose(pred[:B], pred[B:], indices, loss_cfg, image_width)
        non_empty = (indices.match_type >= 0).to(torch.float32)
        counts = mesh.all_reduce(torch.stack([non_empty.sum(),
                                              indices.matches_valid.sum().to(torch.float32)]),
                                 axis)
        denom = torch.clamp(counts[0], min=1.0)

        def share(x):
            return (x * non_empty).sum() / denom

        loss = share(terms.loss)
        shares = {k: share(getattr(terms, k)).detach() for k in METRIC_KEYS}
        return loss, shares, counts[1] / denom

    return loss_fn


def _sync_gradients(module: torch.nn.Module, mesh: Mesh, axis: str, mean: bool):
    """Sum (or mean) every parameter's gradient over ``axis`` in one
    all-reduce of a flat buffer."""
    params = [p for p in module.parameters() if p.grad is not None]
    flat = mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), axis, mean=mean)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def _sync_running_stats(module: torch.nn.Module, mesh: Mesh, axis: str):
    """Average the BatchNorms' running statistics over ``axis`` (pmean)."""
    bufs = [b for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d)
            for b in (m.running_mean, m.running_var)]
    if not bufs:
        return
    flat = mesh.all_reduce(torch.cat([b.reshape(-1) for b in bufs]), axis, mean=True)
    offset = 0
    for b in bufs:
        b.copy_(flat[offset:offset + b.numel()].view_as(b))
        offset += b.numel()


def _apply_update(training_config: dict, state: TrainState, mesh: Mesh, axis: str, mean: bool):
    """Reduce the gradients over ``axis`` (all-reduce, or reduce-scatter to
    the blocks under ZeRO, or under channel sharding the layout's
    reduction), take Adam's step at the step's LR, and under ZeRO
    all-gather the updated parameters into the module."""
    fsdp = getattr(state, "fsdp", None)
    if fsdp is not None:
        fsdp.reduce_scatter_grads(mean)
    elif getattr(state, "tp", None) is not None:
        state.tp.sync_gradients(state.module, mean)
    else:
        _sync_gradients(state.module, mesh, axis, mean)
    lr = host_lr(training_config, state.step - state.schedule_start)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    if fsdp is not None:
        fsdp.gather_params()
    state.step += 1


def _zero_grads(state: TrainState):
    state.optimizer.zero_grad(set_to_none=True)
    for p in state.module.parameters():
        p.grad = None


def data_parallel_update(step: TrainStep, state: TrainState, img_a, img_b, indices, mesh: Mesh,
                         axis: str = "data"):
    """The JAX scanned step's DP reduction: this rank's loss on its own
    batch with its own BatchNorm statistics, then the gradients (reduce-
    scattered under ZeRO), the running statistics and the metrics averaged
    over ``axis``, and one Adam step. Returns the averaged metrics."""
    loss_fn = build_loss_fn(state.module, step.loss_cfg, step.image_width, step.compose)
    _zero_grads(state)
    loss, metrics = loss_fn(img_a, img_b, indices)
    loss.backward()
    _apply_update(step.training_config, state, mesh, axis, mean=True)
    _sync_running_stats(state.module, mesh, axis)
    keys = list(metrics)
    values = mesh.all_reduce(torch.stack([metrics[k] for k in keys]), axis, mean=True)
    return dict(zip(keys, values))


class ShardedTrainStep(TrainStep):
    """``step(state, batch, generator) -> metrics`` on this rank's block of
    a global batch (:func:`shard_host_batch`): the block assembled with
    draws from ``generator`` (seed it per rank; on a world of one it is the
    single-device step's), then :meth:`update`, the global-batch step.
    Metrics are the global batch's, on every rank."""

    def __init__(self, training_config: dict, loss_cfg: LossConfig,
                 assembler_cfg: AssemblerConfig, image_width: int, mesh: Mesh,
                 data_axis: str = "data", hinge=pooled_hinge):
        super().__init__(training_config, loss_cfg, assembler_cfg, image_width, hinge)
        self.mesh, self.data_axis = mesh, data_axis

    def update(self, state: TrainState, img_a, img_b, indices):
        """One step on this rank's block of an assembled global batch."""
        loss_fn = build_sharded_loss_fn(state.module, self.loss_cfg, self.image_width,
                                        self.compose, self.mesh, self.data_axis)
        _zero_grads(state)
        with cross_rank_batchnorm(state.module, self.mesh, self.data_axis):
            loss, shares, num_valid = loss_fn(img_a, img_b, indices)
            loss.backward()
        _apply_update(self.training_config, state, self.mesh, self.data_axis, mean=False)
        values = self.mesh.all_reduce(torch.stack([shares[k] for k in METRIC_KEYS]),
                                      self.data_axis)
        metrics = dict(zip(METRIC_KEYS, values))
        metrics["num_valid_matches"] = num_valid
        return metrics


def make_sharded_train_step(training_config: dict, loss_cfg: LossConfig,
                            assembler_cfg: AssemblerConfig, image_width: int, mesh: Mesh,
                            data_axis: str = "data", hinge=pooled_hinge) -> ShardedTrainStep:
    """The data-parallel step with the JAX step's global-batch semantics;
    see :class:`ShardedTrainStep`. The state is replicated, or in ZeRO
    storage when it went through
    :func:`~pdc_tpu_torch.parallel.tensor_parallel.to_fsdp_state`."""
    return ShardedTrainStep(training_config, loss_cfg, assembler_cfg, image_width, mesh,
                            data_axis, hinge)


def make_sharded_inference(module: torch.nn.Module, mesh: Mesh, normalize: bool = False,
                           axis: str = "data"):
    """``fwd(imgs [B, 3, H, W]) -> [B, D, H, W]`` on every rank: each rank
    forwards its block of the image batch (eval mode) and the blocks are
    all-gathered in order. A batch that does not split evenly is padded
    with copies of its last image, dropped again after the gather."""

    def fwd(imgs: torch.Tensor) -> torch.Tensor:
        B, n = imgs.shape[0], mesh.shape[axis]
        pad = (-B) % n
        if pad:
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
        block = shard_leading(imgs, mesh, axis)
        was_training = module.training
        module.eval()
        try:
            with torch.no_grad():
                out = module(block).to(torch.float32)
        finally:
            module.train(was_training)
        if normalize:
            out = out / torch.clamp(torch.linalg.vector_norm(out, dim=1, keepdim=True),
                                    min=1e-12)
        return mesh.all_gather(out, axis)[:B]

    return fwd


def make_pixel_sharded_best_match(mesh: Mesh, axis: str = "data"):
    """Best match with the flattened pixel axis split over the ranks.

    Each rank runs the best-match kernel (:func:`~pdc_tpu_torch.ops.
    best_match.best_match`; its plain version on CPU tensors) on its
    contiguous block of ``ceil(HW / n)`` pixels, offsets the block's index
    by the block's start, and all-gathers every block's ``(dist, idx)``;
    the least distance wins, ties to the first block (the lowest index), as
    JAX's ``argmin`` over the gathered axis. Where ``n`` does not divide
    ``HW`` the last blocks are shorter (the JAX function requires it to
    divide); a block with no pixel reports an infinite distance, which never
    wins.

    :return: ``fn(res_flat [HW, D], queries [Q, D]) -> (flat_idx [Q]
        int32, dist [Q] float32)``, the same on every rank; ``res_flat`` is
        the whole image on every rank, of which each reads its block
    """

    def run(res_flat: torch.Tensor, queries: torch.Tensor):
        HW = res_flat.shape[0]
        Q = queries.shape[0]
        start, stop = block_range(HW, mesh, axis)
        q = queries.to(torch.float32).contiguous()[None]
        if stop > start:
            block = res_flat[start:stop].to(torch.float32).t().contiguous()[None]  # [1, D, b]
            idx, dist = best_match(block, q)
            idx, dist = idx[0].to(torch.int64) + start, dist[0]
        else:
            idx = torch.zeros(Q, dtype=torch.int64, device=queries.device)
            dist = torch.full((Q,), float("inf"), device=queries.device)
        n = mesh.shape[axis]
        all_dist = mesh.all_gather(dist[None], axis).reshape(n, Q)
        all_idx = mesh.all_gather(idx[None], axis).reshape(n, Q)
        best = torch.argmin(all_dist, dim=0)  # first block on ties
        return (all_idx.gather(0, best[None])[0].to(torch.int32),
                all_dist.gather(0, best[None])[0])

    return run
