"""GPipe pipeline parallelism over a ``pipe`` axis, with frozen BatchNorm.

Port of :mod:`pdc_tpu.parallel.pipeline` (:85-586). A stride-8
:class:`~pdc_tpu_torch.models.resnet.ResNetFCN` is cut into 4 base
segments (:func:`_segment_names`)::

    seg0: stem conv + BN + ReLU + max-pool + stage1   [B, 64e, H/4, W/4]
    seg1: stage2                                      [B, 128e, H/8, W/8]
    seg2: stage3 (dilation 2)                         [B, 256e, H/8, W/8]
    seg3: stage4 (dilation 4) + head + upsample       [B, D, H, W]

(``e`` the blocks' expansion), and a pipe axis of 1, 2 or 4 stages groups
them contiguously (:func:`_group`). Microbatches flow through the GPipe
schedule (Huang et al., 2019): stage ``s`` runs microbatch ``t`` after
stage ``s - 1`` has sent it.

JAX's pipeline is one SPMD program: each stage's parameters flat-packed
into a padded ``[S, Pmax]`` buffer, the activations in a padded ``[mb,
Amax]`` buffer that ``ppermute`` moves, ``lax.switch`` on the axis index
picking the stage, and autodiff of the schedule giving the reverse
pipeline. Here each rank runs its own code, so:

  * each rank builds only its stage's layers (:class:`PipelineStage`,
    copies of the network's own modules under their names) and holds only
    their parameters and their optimizer state, the memory property the
    pipeline exists for; :func:`pack_pipeline_variables` keeps its name and
    returns the stages asked for, :func:`unpack_pipeline_variables` gathers
    them back into the standard variables, in flax names and layout, for
    checkpoints;
  * activations go to the next stage at their exact shapes with
    ``torch.distributed`` point-to-point sends (no padding); the shapes are
    known in advance from a pass over the architecture on the meta device;
  * the backward is explicit: after the loss, in reverse microbatch order,
    each stage gets the gradient of each of its outputs from the next
    stage, back-propagates it through the microbatch's graph (kept from the
    forward) and sends its input's gradient back; parameter gradients add
    up over the microbatches into the whole batch's.

BatchNorm runs on its running statistics with gradients on (eval mode):
JAX's frozen-BN semantics, so the pipelined step equals a single-device
frozen-BN step (:func:`make_frozen_bn_train_step`) to float reassociation.
The loss is computed on the last stage, which alone launches the pooled
hinge kernels (K1 twice and K2 twice a step); the metrics are then
summed over the pipe axis from zeros elsewhere, so every rank holds them,
as JAX's psum-broadcast of the output does.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from pdc_tpu_torch.data.assembler import AssemblerConfig
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models.convert import state_dict_to_flax
from pdc_tpu_torch.models.resnet import ResNetFCN, resize_bilinear
from pdc_tpu_torch.ops.pooled_hinge import pooled_hinge
from pdc_tpu_torch.parallel.mesh import Mesh, shard_leading
from pdc_tpu_torch.training.schedule import host_lr
from pdc_tpu_torch.training.train import TrainState, _BatchStep, make_optimizer

METRIC_KEYS = ("loss", "match_loss", "masked_non_match_loss", "background_non_match_loss",
               "blind_non_match_loss")
N_SEGMENTS = 4


def _check_model(module) -> None:
    if not isinstance(module, ResNetFCN):
        raise ValueError(f"pipeline parallelism supports ResNetFCN backbones, not "
                         f"{type(module).__name__}")
    if module.output_stride != 8:
        raise ValueError("pipeline parallelism: only output_stride=8")
    if module.use_s2b or module.quant_int8:
        raise ValueError("pipeline parallelism composes with neither dilated_s2b nor the "
                         "int8 serving path")


def _segment_names(module: ResNetFCN) -> List[List[str]]:
    """The network's top-level module names that each base segment owns."""
    stages = module.stage_blocks
    return [["stem_conv", "stem_bn"] + list(stages[0]), list(stages[1]), list(stages[2]),
            list(stages[3]) + ["head"]]


def _group(items: list, n_groups: int) -> List[list]:
    """Split the 4 base segments into ``n_groups`` contiguous groups."""
    if len(items) % n_groups:
        raise ValueError(f"pipe axis size {n_groups} must divide the {len(items)} base "
                         "segments (use 1, 2, or 4)")
    k = len(items) // n_groups
    return [items[i * k:(i + 1) * k] for i in range(n_groups)]


class PipelineStage(nn.Module):
    """The layers of some base segments of a :class:`ResNetFCN`, copied under
    the network's own names (so its ``state_dict`` keys are the network's),
    and their slice of ``ResNetFCN.forward``, op for op: the cast to the
    compute dtype, stem, BatchNorm, ReLU, max-pool, the blocks, the head and
    the bilinear upsample to ``out_hw``, the input image's size."""

    def __init__(self, module: ResNetFCN, segments):
        super().__init__()
        self.segments = tuple(segments)
        self.dtype = module.dtype
        self.stage_blocks = [list(names) for names in module.stage_blocks]
        names = _segment_names(module)
        for j in self.segments:
            for name in names[j]:
                self.add_module(name, copy.deepcopy(getattr(module, name)))
        self.eval()

    def forward(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        for j in self.segments:
            if j == 0:
                x = x.to(self.dtype)
                x = F.relu(self.stem_bn(self.stem_conv(x)))
                x = F.max_pool2d(x, 3, stride=2, padding=1)
            for name in self.stage_blocks[j]:
                x = getattr(self, name)(x)
            if j == N_SEGMENTS - 1:
                x = resize_bilinear(self.head(x), *out_hw)
        return x


@dataclasses.dataclass
class PipelineMeta:
    """What every rank knows of every stage: the network's names each holds,
    its base segments, and the architecture (``ResNetFCN(**arch)``) for the
    boundary shapes."""

    groups: List[List[str]]
    segments: List[list]
    arch: dict


@dataclasses.dataclass
class PipelinePack:
    """The stages a process holds: ``{stage index: PipelineStage}`` (its own
    stage on a pipe axis, or all of them)."""

    stages: Dict[int, PipelineStage]


def pack_pipeline_variables(module: ResNetFCN, n_stages: int, stage: Optional[int] = None):
    """Cut ``module`` into ``n_stages`` stages.

    :param stage: the one stage to build (a rank's), or None for all
    :return: ``(pack, meta)``; ``meta`` is needed by
        :func:`unpack_pipeline_variables` and by the forward functions
    """
    _check_model(module)
    segments = _group(list(range(N_SEGMENTS)), n_stages)
    names = _segment_names(module)
    meta = PipelineMeta(groups=[[n for j in g for n in names[j]] for g in segments],
                        segments=segments,
                        arch=dict(num_classes=module.head.out_channels,
                                  stage_sizes=tuple(len(b) for b in module.stage_blocks),
                                  bottleneck=module.bottleneck, dtype=module.dtype))
    which = range(n_stages) if stage is None else (stage,)
    return PipelinePack({s: PipelineStage(module, segments[s]) for s in which}), meta


def unpack_pipeline_variables(pack: PipelinePack, meta: PipelineMeta, mesh: Optional[Mesh] = None,
                              pipe_axis: str = "pipe"):
    """The standard ``{'params', 'batch_stats'}`` of the whole network, in
    flax names and layout (what a ``.ckpt`` holds), from every stage. A pack
    of this rank's stage alone gathers the others over ``mesh``'s pipe axis
    (every rank of it calls this)."""
    sd = {}
    for s in sorted(pack.stages):
        sd.update({k: v.detach().cpu() for k, v in pack.stages[s].state_dict().items()})
    if len(pack.stages) < len(meta.groups):
        if mesh is None:
            raise ValueError("a pack of some stages needs the mesh to gather the others")
        parts = [None] * mesh.shape[pipe_axis]
        dist.all_gather_object(parts, sd, group=mesh.group(pipe_axis))
        sd = {k: v for part in parts for k, v in part.items()}
    held = {k.split(".", 1)[0] for k in sd}
    missing = [n for g in meta.groups for n in g if n not in held]
    if missing:
        raise ValueError(f"the stages lack {missing}")
    return state_dict_to_flax(sd)


def _boundary_shapes(meta: PipelineMeta, microbatch: int, image_hw):
    """``[(shape, dtype)]`` of each stage's output for one microbatch, from a
    pass over the architecture on the meta device (no memory, no
    arithmetic)."""
    with torch.device("meta"):
        stages = [PipelineStage(ResNetFCN(**meta.arch), g) for g in meta.segments]
    x = torch.empty((microbatch, 3) + tuple(image_hw), device="meta")
    out = []
    for st in stages:
        x = st(x, image_hw)
        out.append((tuple(x.shape), x.dtype))
    return out


class _Schedule:
    """The GPipe schedule of one rank: its stage index, its neighbours'
    global ranks on the pipe axis, and the shapes that cross each
    boundary."""

    def __init__(self, meta: PipelineMeta, mesh: Mesh, image_hw, microbatch: int,
                 pipe_axis: str):
        self.mesh, self.hw, self.mb = mesh, tuple(image_hw), int(microbatch)
        self.S, self.s = mesh.shape[pipe_axis], mesh.index[pipe_axis]
        self.prev = mesh.peer(pipe_axis, self.s - 1) if self.s > 0 else None
        self.next = mesh.peer(pipe_axis, self.s + 1) if self.s < self.S - 1 else None
        self.last = self.next is None
        self.shapes = _boundary_shapes(meta, self.mb, self.hw)

    def check(self, n_images: int):
        """Raised on every rank before any collective or send."""
        if self.mb < 1 or n_images % self.mb:
            raise ValueError(f"the {n_images} images of a data shard do not split into "
                             f"microbatches of {self.mb}")

    def forward(self, stage: PipelineStage, imgs: torch.Tensor, grad: bool):
        """Run every microbatch through this stage in order: the first stage
        reads its block of ``imgs``, the others receive it from the previous
        stage. Returns ``[(input, output)]`` a microbatch (the graph kept
        when ``grad``)."""
        kept, sends = [], []
        for t in range(imgs.shape[0] // self.mb):
            if self.prev is None:
                x = imgs[t * self.mb:(t + 1) * self.mb]
            else:
                shape, dtype = self.shapes[self.s - 1]
                x = torch.empty(shape, dtype=dtype, device=self.mesh.device)
                dist.recv(x, src=self.prev)
                x.requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                y = stage(x, self.hw)
            if self.next is not None:
                buf = y.detach().contiguous()
                sends.append((dist.isend(buf, dst=self.next), buf))
            kept.append((x, y))
        for work, _ in sends:
            work.wait()
        return kept

    def backward(self, kept):
        """The reverse pipeline, after the last stage's ``loss.backward()``:
        in reverse microbatch order each earlier stage receives its output's
        gradient and back-propagates it, and every stage but the first sends
        its input's gradient back."""
        sends = []
        for x, y in reversed(kept):
            if self.next is not None:
                g = torch.empty_like(y)
                dist.recv(g, src=self.next)
                torch.autograd.backward(y, g)
            if self.prev is not None:
                buf = x.grad.contiguous()
                sends.append((dist.isend(buf, dst=self.prev), buf))
        for work, _ in sends:
            work.wait()


def _split_images(imgs: torch.Tensor, mesh: Mesh, data_axis: Optional[str], mb: int):
    n = 1 if data_axis is None else mesh.shape[data_axis]
    if imgs.shape[0] % n or (imgs.shape[0] // n) % mb:
        raise ValueError(f"{imgs.shape[0]} images do not split over {n} data shards into "
                         f"microbatches of {mb}")
    return imgs if data_axis is None else shard_leading(imgs, mesh, data_axis)


def make_pp_inference(module: ResNetFCN, mesh: Mesh, image_hw, microbatch: int = 1,
                      pipe_axis: str = "pipe", data_axis: Optional[str] = None,
                      normalize: bool = False):
    """Pipelined descriptor inference.

    :return: ``build(state_dict=None) -> (fwd, pack)``: ``build`` copies this
        rank's stage of ``module`` (``state_dict``'s weights loaded into it,
        when given) to its device once; then ``fwd(pack, imgs [N, 3, H, W])
        -> [N, D, H, W]`` float32, the whole batch on every rank. ``N``
        must be a multiple of ``microbatch`` (times the data axis, over
        which the images are split when ``data_axis`` is given)
    """
    def build(state_dict=None):
        s = mesh.index[pipe_axis]
        pack, meta = pack_pipeline_variables(module, mesh.shape[pipe_axis], stage=s)
        stage = pack.stages[s].to(mesh.device)
        if state_dict is not None:
            keys = set(stage.state_dict())
            stage.load_state_dict({k: v for k, v in state_dict.items() if k in keys})
        sched = _Schedule(meta, mesh, image_hw, microbatch, pipe_axis)
        D = meta.arch["num_classes"]

        def fwd(pack: PipelinePack, imgs: torch.Tensor) -> torch.Tensor:
            B = imgs.shape[0]
            local = _split_images(imgs, mesh, data_axis, sched.mb).to(mesh.device)
            with torch.no_grad():
                kept = sched.forward(pack.stages[s].eval(), local, grad=False)
            if sched.last:
                out = torch.cat([y for _, y in kept]).to(torch.float32)
            else:
                out = torch.zeros((local.shape[0], D) + tuple(image_hw), device=mesh.device)
            out = mesh.all_reduce(out, pipe_axis)  # the last stage's, on every stage
            if normalize:
                out = out / torch.clamp(torch.linalg.vector_norm(out, dim=1, keepdim=True),
                                        min=1e-12)
            return out if data_axis is None else mesh.all_gather(out, data_axis)[:B]

        return fwd, pack

    return build


@dataclasses.dataclass
class PPTrainState:
    """A rank's pipelined train state: its stage (in ``pack``), an optimizer
    over the stage's parameters alone, the steps taken, and the step at
    which the LR schedule started (the optimizer is built anew on packing,
    as JAX's ``tx.init`` on the packed buffer restarts its schedule)."""

    step: int
    pack: PipelinePack
    optimizer: torch.optim.Optimizer
    schedule_start: int = 0

    @property
    def stage(self) -> PipelineStage:
        (stage,) = self.pack.stages.values()
        return stage


class PPTrainStep(_BatchStep):
    """``step(state, batch, generator) -> metrics`` on this data rank's block
    of a global batch of pairs: assembled on every stage with the same
    draws (the first stage reads the images, the last the indices), the
    ``[2b]`` images (a then b) pipelined in microbatches of ``microbatch``,
    the loss on the last stage with the global batch's denominators, the
    reverse pipeline, the gradients summed over the data axis and Adam on
    the stage's parameters. Metrics are the global batch's, on every
    rank."""

    def __init__(self, training_config: dict, loss_cfg: LossConfig,
                 assembler_cfg: AssemblerConfig, image_width: int, mesh: Mesh,
                 meta: PipelineMeta, image_hw, microbatch: int = 1, pipe_axis: str = "pipe",
                 data_axis: str = "data", hinge=pooled_hinge):
        super().__init__(loss_cfg, assembler_cfg, image_width, hinge)
        self.training_config = training_config
        self.mesh, self.pipe_axis, self.data_axis = mesh, pipe_axis, data_axis
        self.sched = _Schedule(meta, mesh, image_hw, microbatch, pipe_axis)

    def assemble(self, state: PPTrainState, batch: dict, generator: torch.Generator):
        return self.assemble_fn(batch, self.assembler_cfg, generator, device=self.mesh.device)

    def update(self, state: PPTrainState, img_a, img_b, indices):
        from pdc_tpu_torch.parallel.sharded_train import _sync_gradients

        mesh, sched = self.mesh, self.sched
        B, H, W, _ = img_a.shape
        sched.check(2 * B)
        stage = state.stage.eval()  # frozen BatchNorm: running statistics, gradients on
        state.optimizer.zero_grad(set_to_none=True)
        imgs = torch.cat([img_a, img_b], dim=0).permute(0, 3, 1, 2).contiguous()
        kept = sched.forward(stage, imgs, grad=True)
        values = torch.zeros(len(METRIC_KEYS) + 1, device=mesh.device)
        if sched.last:
            out = torch.cat([y for _, y in kept])
            pred = out.permute(0, 2, 3, 1).reshape(2 * B, H * W, out.shape[1])
            terms = self.compose(pred[:B], pred[B:], indices, self.loss_cfg, self.image_width)
            non_empty = (indices.match_type >= 0).to(torch.float32)
            counts = mesh.all_reduce(torch.stack([non_empty.sum(),
                                                  indices.matches_valid.sum().to(torch.float32)]),
                                     self.data_axis)
            denom = torch.clamp(counts[0], min=1.0)
            shares = [(getattr(terms, k) * non_empty).sum() / denom for k in METRIC_KEYS]
            shares[0].backward()
            values = torch.cat([mesh.all_reduce(torch.stack(shares).detach(), self.data_axis),
                                (counts[1] / denom)[None]])
        sched.backward(kept)
        values = mesh.all_reduce(values, self.pipe_axis)  # the last stage's, on every stage
        _sync_gradients(stage, mesh, self.data_axis, mean=False)
        lr = host_lr(self.training_config, state.step - state.schedule_start)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics = dict(zip(METRIC_KEYS, values[:-1]))
        metrics["num_valid_matches"] = values[-1]
        return metrics

    def __call__(self, state: PPTrainState, batch: dict, generator: torch.Generator):
        return self.update(state, *self.assemble(state, batch, generator))


def make_pp_train_step(training_config: dict, loss_cfg: LossConfig,
                       assembler_cfg: AssemblerConfig, image_width: int, mesh: Mesh,
                       state: TrainState, image_hw, microbatch: int = 1,
                       pipe_axis: str = "pipe", data_axis: str = "data", hinge=pooled_hinge):
    """The DP x PP step on a ``(data, pipe)`` mesh; see :class:`PPTrainStep`.

    :param state: a whole-network :class:`~pdc_tpu_torch.training.train.TrainState`;
        this rank's stage of its module is copied out, and a new Adam built
        over the stage's parameters (its moments are not carried, as JAX
        re-initialises the optimizer on the packed buffer)
    :return: ``(step, pp_state, meta)``; recover the standard variables
        with :func:`unpack_pipeline_variables` ``(pp_state.pack, meta,
        mesh)``
    """
    s = mesh.index[pipe_axis]
    pack, meta = pack_pipeline_variables(state.module, mesh.shape[pipe_axis], stage=s)
    stage = pack.stages[s].to(mesh.device)
    pp_state = PPTrainState(step=state.step, pack=pack,
                            optimizer=make_optimizer(training_config, stage.parameters()),
                            schedule_start=state.step)
    step = PPTrainStep(training_config, loss_cfg, assembler_cfg, image_width, mesh, meta,
                       image_hw, microbatch, pipe_axis, data_axis, hinge)
    return step, pp_state, meta


class FrozenBNTrainStep(_BatchStep):
    """The single-device oracle of the pipelined step: the same math
    (frozen-BN forward of the ``[2B]`` images, the same assembly and loss
    composition, Adam) with no mesh and no stages. The loss and metrics are
    written out here, not taken from
    :func:`~pdc_tpu_torch.training.train.build_loss_fn`: an oracle that
    shares the machinery of the step it checks cannot catch that
    machinery's faults. The BatchNorm statistics are left as they were."""

    def __init__(self, training_config: dict, loss_cfg: LossConfig,
                 assembler_cfg: AssemblerConfig, image_width: int, image_hw,
                 hinge=pooled_hinge):
        super().__init__(loss_cfg, assembler_cfg, image_width, hinge)
        self.training_config, self.image_hw = training_config, tuple(image_hw)

    def update(self, state: TrainState, img_a, img_b, indices):
        module = state.module.eval()
        state.optimizer.zero_grad(set_to_none=True)
        B = img_a.shape[0]
        H, W = self.image_hw
        out = module(torch.cat([img_a, img_b], dim=0).permute(0, 3, 1, 2).contiguous())
        pred = out.permute(0, 2, 3, 1).reshape(2 * B, H * W, out.shape[1])
        terms = self.compose(pred[:B], pred[B:], indices, self.loss_cfg, self.image_width)
        non_empty = (indices.match_type >= 0).to(torch.float32)
        denom = torch.clamp(non_empty.sum(), min=1.0)
        metrics = {k: (getattr(terms, k) * non_empty).sum() / denom for k in METRIC_KEYS}
        metrics["loss"].backward()
        lr = host_lr(self.training_config, state.step - state.schedule_start)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["num_valid_matches"] = indices.matches_valid.sum() / denom
        return metrics

    def __call__(self, state: TrainState, batch: dict, generator: torch.Generator):
        return self.update(state, *self.assemble(state, batch, generator))


def make_frozen_bn_train_step(training_config: dict, loss_cfg: LossConfig,
                              assembler_cfg: AssemblerConfig, image_width: int, image_hw,
                              hinge=pooled_hinge) -> FrozenBNTrainStep:
    """The single-device frozen-BN oracle; see :class:`FrozenBNTrainStep`."""
    return FrozenBNTrainStep(training_config, loss_cfg, assembler_cfg, image_width, image_hw,
                             hinge)
