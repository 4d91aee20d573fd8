"""The train step: assembly, one ``[2B]`` forward, the pooled loss, backward
and the Adam update.

Port of :mod:`pdc_tpu.training.train`: ``make_optimizer`` (:56-66),
``create_train_state`` (:69-88), ``build_loss_fn`` (:107-141) and
``make_train_step`` (:144-170), for the matrix (pooled) loss. The JAX step is
one jitted program that returns a new state; here the step runs eagerly and
updates the state in place (the module's parameters and BatchNorm
statistics, the optimizer's moments, the step count).

The optimizer is Adam with additive weight decay: ``torch.optim.Adam``'s
``weight_decay`` adds ``wd * param`` to the gradient before the moments, as
optax's ``add_decayed_weights`` before ``scale_by_adam`` does. The LR of
step ``i`` is :func:`~pdc_tpu_torch.training.schedule.host_lr` of ``i``.

Not ported yet: ``make_eval_loss_step`` and the ``DenseCorrespondenceTraining``
loop (datasets, device cache, model folder), the per-pair loss
(``use_matrix_loss: false``) and ImageNet-pretrained initialisation.
"""

from __future__ import annotations

import dataclasses

import torch

from pdc_tpu_torch.data.assembler import AssemblerConfig, assemble_batch_matrix
from pdc_tpu_torch.losses.matrix_loss import MatrixSampleIndices, compose_loss_matrix
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.ops.pooled_hinge import pooled_hinge
from pdc_tpu_torch.training.schedule import host_lr
from pdc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates: the backbone (parameters and
    BatchNorm statistics), its optimizer, and the number of steps taken."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(training_config: dict, params) -> torch.optim.Adam:
    """Adam (betas 0.9/0.999, eps 1e-8) with additive weight decay, at the
    LR of step 0."""
    t = training_config["training"]
    return torch.optim.Adam(params, lr=host_lr(training_config, 0), betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=float(t["weight_decay"]))


def create_train_state(module: torch.nn.Module, training_config: dict,
                       device="cuda") -> TrainState:
    """Move an initialised backbone to ``device`` and pair it with its
    optimizer. ``backbone.pretrained`` raises: ImageNet initialisation is
    not ported yet."""
    net_cfg = training_config.get("dense_correspondence_network", {})
    if (net_cfg.get("backbone") or {}).get("pretrained"):
        raise NotImplementedError(
            "ImageNet-pretrained initialisation is not ported yet (it waits for the "
            "DenseCorrespondenceTraining slice)")
    module = module.to(resolve_device(device))
    return TrainState(module=module, optimizer=make_optimizer(training_config,
                                                              module.parameters()))


def build_loss_fn(module: torch.nn.Module, loss_cfg: LossConfig, image_width: int,
                  hinge=pooled_hinge):
    """The train-mode loss of a batch: one forward of the ``[2B]`` images
    (a then b, so BatchNorm takes its statistics over both), the per-pair
    terms of :func:`compose_loss_matrix`, and their mean over non-empty
    pairs. ``loss_fn(img_a, img_b, indices) -> (loss, metrics)``; ``hinge``
    as in :func:`compose_loss_matrix`."""

    def loss_fn(img_a, img_b, indices: MatrixSampleIndices):
        B, H, W, _ = img_a.shape
        imgs = torch.cat([img_a, img_b], dim=0).permute(0, 3, 1, 2).contiguous()
        module.train()
        out = module(imgs)  # [2B, D, H, W]
        pred = out.permute(0, 2, 3, 1).reshape(2 * B, H * W, out.shape[1])
        terms = compose_loss_matrix(pred[:B], pred[B:], indices, loss_cfg, image_width,
                                    hinge=hinge)
        non_empty = (indices.match_type >= 0).to(torch.float32)
        denom = torch.clamp(non_empty.sum(), min=1.0)

        def mean(x):
            return (x * non_empty).sum() / denom

        loss = mean(terms.loss)
        metrics = {
            "loss": loss,
            "match_loss": mean(terms.match_loss),
            "masked_non_match_loss": mean(terms.masked_non_match_loss),
            "background_non_match_loss": mean(terms.background_non_match_loss),
            "blind_non_match_loss": mean(terms.blind_non_match_loss),
            "num_valid_matches": indices.matches_valid.sum() / denom,
        }
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


class TrainStep:
    """``step(state, batch, generator) -> metrics``: assemble the batch (any
    host or device dict that
    :func:`~pdc_tpu_torch.data.assembler.assemble_batch_matrix` reads) on
    the state's device with draws from ``generator``, then :meth:`update`.
    Metrics are 0-dim tensors on the device, named as in the JAX step."""

    def __init__(self, training_config: dict, loss_cfg: LossConfig,
                 assembler_cfg: AssemblerConfig, image_width: int, hinge=pooled_hinge):
        if not assembler_cfg.use_matrix_loss:
            raise NotImplementedError(
                "the per-pair loss (use_matrix_loss: false) is not ported yet")
        self.training_config = training_config
        self.loss_cfg = loss_cfg
        self.assembler_cfg = assembler_cfg
        self.image_width = image_width
        self.hinge = hinge

    def assemble(self, state: TrainState, batch: dict, generator: torch.Generator):
        device = next(state.module.parameters()).device
        return assemble_batch_matrix(batch, self.assembler_cfg, generator, device=device)

    def update(self, state: TrainState, img_a, img_b, indices: MatrixSampleIndices):
        """One step on an assembled batch: forward, backward, Adam."""
        loss_fn = build_loss_fn(state.module, self.loss_cfg, self.image_width, self.hinge)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(img_a, img_b, indices)
        loss.backward()
        lr = host_lr(self.training_config, state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return metrics

    def __call__(self, state: TrainState, batch: dict, generator: torch.Generator):
        return self.update(state, *self.assemble(state, batch, generator))


def make_train_step(training_config: dict, loss_cfg: LossConfig,
                    assembler_cfg: AssemblerConfig, image_width: int,
                    hinge=pooled_hinge) -> TrainStep:
    """The train step of a training config; see :class:`TrainStep`."""
    return TrainStep(training_config, loss_cfg, assembler_cfg, image_width, hinge)
