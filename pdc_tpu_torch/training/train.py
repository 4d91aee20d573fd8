"""The train step, the test-loss step and the training driver.

Port of :mod:`pdc_tpu.training.train`: ``make_optimizer`` (:56-66),
``create_train_state`` (:69-88), ``pick_assembly`` (:90-104),
``build_loss_fn`` (:107-141), ``make_train_step`` (:144-170),
``make_eval_loss_step`` (:173-203) and ``DenseCorrespondenceTraining``
(:206-771), for the matrix (pooled) loss and the per-pair loss
(``use_matrix_loss: false``).
The JAX step is one jitted program that returns a new state; here the step
runs eagerly and updates the state in place (the module's parameters and
BatchNorm statistics, where the backbone has BatchNorm, the optimizer's
moments, the step count).

The optimizer is Adam with additive weight decay: ``torch.optim.Adam``'s
``weight_decay`` adds ``wd * param`` to the gradient before the moments, as
optax's ``add_decayed_weights`` before ``scale_by_adam`` does. The LR of
step ``i`` is :func:`~pdc_tpu_torch.training.schedule.host_lr` of the
steps since the schedule started (``i`` unless a resume set a new LR).

The driver keeps the JAX package's model folder (``training.yaml``,
``dataset.yaml``, ``identifier.yaml``, ``%06d.ckpt`` with its
``.ckpt.opt``, ``%06d_log_history.yaml``, ``loss.yaml``), written in the
same formats, so a folder moves between the two packages in both
directions, and its three routes (:meth:`DenseCorrespondenceTraining.run`).

``training.data_parallel`` (and ``fsdp``) over several processes
(``torchrun``) takes the device-sampler route data-parallel over
:mod:`pdc_tpu_torch.parallel`; rank 0 alone writes the model folder.
``training.tensor_parallel: k`` and ``training.pipeline: S`` (with
``pipeline_microbatch``) take the model-parallel route over a ``(data,
model)`` or ``(data, pipe)`` mesh of the processes, the rest of them on the
data axis (``pdc_tpu/training/train.py:418-480``): host batches streamed,
``batch_size`` the global batch (a multiple of the data axis), a
channel-sharded checkpoint gathered whole, a pipelined one unpacked to the
standard layout without ``.ckpt.opt``.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import functools
import logging
import os
import signal
import threading
import time
import uuid
from typing import Optional

import numpy as np
import torch

from pdc_tpu_torch.data.assembler import AssemblerConfig, assemble_batch, assemble_batch_matrix
from pdc_tpu_torch.data.native_loader import PrefetchLoader
from pdc_tpu_torch.losses.composer import compose_loss
from pdc_tpu_torch.losses.matrix_loss import compose_loss_matrix
from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
from pdc_tpu_torch.models.checkpoint import packb, read_checkpoint
from pdc_tpu_torch.models.convert import (
    adam_state_to_flax,
    flax_to_state_dict,
    load_adam_state_from_flax,
    state_dict_to_flax,
)
from pdc_tpu_torch.models.dcn import (
    DenseCorrespondenceNetwork,
    build_backbone,
    find_latest_checkpoint,
    init_weights_,
)
from pdc_tpu_torch.ops.pooled_hinge import pooled_hinge
from pdc_tpu_torch.training.schedule import host_lr
from pdc_tpu_torch.utils.device import resolve_device
from pdc_tpu_torch.utils.yaml_io import load_yaml, save_yaml

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates: the backbone (parameters and, for
    the convolutional backbones, BatchNorm statistics), its optimizer, and
    the number of steps taken."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the step at which the LR schedule (re)started: 0, or the iteration of
    # a resume with a new learning rate (optax's schedule count restarts)
    schedule_start: int = 0
    # ZeRO storage (pdc_tpu_torch.parallel.tensor_parallel.FsdpLayout): the
    # optimizer then steps this rank's blocks of the parameters
    fsdp: Optional[object] = None
    # channel sharding (pdc_tpu_torch.parallel.tensor_parallel.TensorParallelLayout):
    # the module's convolutions hold this rank's blocks of output channels
    tp: Optional[object] = None


def make_optimizer(training_config: dict, params, capturable: bool = False) -> torch.optim.Adam:
    """Adam (betas 0.9/0.999, eps 1e-8) with additive weight decay, at the
    LR of step 0. With ``capturable`` (the scanned route on a card,
    :func:`~pdc_tpu_torch.training.scanned.to_capturable`) Adam keeps its
    step counts on the parameters' device and reads its LR from a 0-dim
    float32 tensor there, so a CUDA graph can capture its step."""
    t = training_config["training"]
    lr = host_lr(training_config, 0)
    if capturable:
        params = list(params)
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=float(t["weight_decay"]), capturable=capturable)


def create_train_state(module: torch.nn.Module, training_config: dict,
                       device="cuda") -> TrainState:
    """Move an initialised backbone to ``device`` and pair it with its
    optimizer. With ``backbone.pretrained`` set, the backbone first gets the
    ImageNet weights (:mod:`pdc_tpu_torch.models.torch_import`)."""
    device = resolve_device(device)
    net_cfg = training_config.get("dense_correspondence_network", {})
    if (net_cfg.get("backbone") or {}).get("pretrained"):
        from pdc_tpu_torch.models.torch_import import maybe_load_pretrained_backbone

        maybe_load_pretrained_backbone(module, net_cfg)
    module = module.to(device)
    return TrainState(module=module, optimizer=make_optimizer(training_config,
                                                              module.parameters()))


def pick_assembly(assembler_cfg: AssemblerConfig, hinge=pooled_hinge):
    """``(assemble, compose)`` of the configured loss: the matrix (pooled)
    loss, its non-matches shared pools scored by the pooled hinge
    (``hinge``, by default the K1/K2 wrapper), or the per-pair loss
    (``use_matrix_loss: false``), the reference's replicated index lists
    and no kernel. Both composite synthetic multi-object rows.
    ``assemble(batch, cfg, generator, device)``, ``compose(pred_a, pred_b,
    indices, loss_cfg, image_width)``."""
    if assembler_cfg.use_matrix_loss:
        return assemble_batch_matrix, functools.partial(compose_loss_matrix, hinge=hinge)
    return assemble_batch, compose_loss


def build_loss_fn(module: torch.nn.Module, loss_cfg: LossConfig, image_width: int, compose):
    """The train-mode loss of a batch: one forward of the ``[2B]`` images
    (a then b, so a BatchNorm takes its statistics over both), the per-pair
    terms of ``compose`` (:func:`pick_assembly`'s), and their mean over
    non-empty pairs. ``loss_fn(img_a, img_b, indices) -> (loss,
    metrics)``."""

    def loss_fn(img_a, img_b, indices):
        B, H, W, _ = img_a.shape
        imgs = torch.cat([img_a, img_b], dim=0).permute(0, 3, 1, 2).contiguous()
        module.train()
        out = module(imgs)  # [2B, D, H, W]
        pred = out.permute(0, 2, 3, 1).reshape(2 * B, H * W, out.shape[1])
        terms = compose(pred[:B], pred[B:], indices, loss_cfg, image_width)
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


class _BatchStep:
    """What the train and test-loss steps share: the loss's settings, the
    assembly and composer the config picks (:func:`pick_assembly`), and a
    batch (any host or device dict that the assembly reads) assembled on
    the state's device with draws from ``generator``."""

    def __init__(self, loss_cfg: LossConfig, assembler_cfg: AssemblerConfig,
                 image_width: int, hinge=pooled_hinge):
        self.loss_cfg = loss_cfg
        self.assembler_cfg = assembler_cfg
        self.image_width = image_width
        self.assemble_fn, self.compose = pick_assembly(assembler_cfg, hinge)

    def assemble(self, state: TrainState, batch: dict, generator: torch.Generator, **options):
        """``options`` go to the assembly function (``composite_every_row``)."""
        device = next(state.module.parameters()).device
        return self.assemble_fn(batch, self.assembler_cfg, generator, device=device, **options)


class TrainStep(_BatchStep):
    """``step(state, batch, generator) -> metrics``: :meth:`assemble`, then
    :meth:`update`. Metrics are 0-dim tensors on the device, named as in the
    JAX step."""

    def __init__(self, training_config: dict, loss_cfg: LossConfig,
                 assembler_cfg: AssemblerConfig, image_width: int, hinge=pooled_hinge):
        super().__init__(loss_cfg, assembler_cfg, image_width, hinge)
        self.training_config = training_config

    def update(self, state: TrainState, img_a, img_b, indices):
        """One step on an assembled batch: forward, backward, Adam."""
        loss_fn = build_loss_fn(state.module, self.loss_cfg, self.image_width, self.compose)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(img_a, img_b, indices)
        loss.backward()
        lr = host_lr(self.training_config, state.step - state.schedule_start)
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


class EvalLossStep(_BatchStep):
    """``step(state, batch, generator) -> metrics``: the test loss of a
    batch, assembled as the train step's, with eval-mode BatchNorm and no
    gradient or update; ``loss``, ``match_loss`` and ``non_match_loss``
    (masked plus background) as 0-dim tensors on the device, means over the
    non-empty pairs."""

    def evaluate(self, state: TrainState, img_a, img_b, indices):
        module = state.module
        modes = [(m, m.training) for m in module.modules()]
        module.eval()
        try:
            with torch.no_grad():
                B, H, W, _ = img_a.shape
                imgs = torch.cat([img_a, img_b], dim=0).permute(0, 3, 1, 2).contiguous()
                out = module(imgs)
                pred = out.permute(0, 2, 3, 1).reshape(2 * B, H * W, out.shape[1])
                terms = self.compose(pred[:B], pred[B:], indices, self.loss_cfg,
                                     self.image_width)
                non_empty = (indices.match_type >= 0).to(torch.float32)
                denom = torch.clamp(non_empty.sum(), min=1.0)
                return {
                    "loss": (terms.loss * non_empty).sum() / denom,
                    "match_loss": (terms.match_loss * non_empty).sum() / denom,
                    "non_match_loss": ((terms.masked_non_match_loss
                                        + terms.background_non_match_loss)
                                       * non_empty).sum() / denom,
                }
        finally:
            for m, training in modes:
                m.training = training

    def __call__(self, state: TrainState, batch: dict, generator: torch.Generator):
        return self.evaluate(state, *self.assemble(state, batch, generator))


def make_eval_loss_step(loss_cfg: LossConfig, assembler_cfg: AssemblerConfig,
                        image_width: int, hinge=pooled_hinge) -> EvalLossStep:
    """The test-loss step; see :class:`EvalLossStep`."""
    return EvalLossStep(loss_cfg, assembler_cfg, image_width, hinge)


# the driver's routes (DenseCorrespondenceTraining.route)
ROUTE_DEVICE_SAMPLER = "device sampler"
ROUTE_CACHED_HOST_SAMPLER = "cached host sampler"
ROUTE_HOST_STREAMING = "host streaming"
ROUTE_MODEL_PARALLEL = "model-parallel host streaming"
TRAIN_METRICS = ("loss", "match_loss", "masked_non_match_loss",
                 "background_non_match_loss", "blind_non_match_loss")
TEST_METRICS = ("loss", "match_loss", "non_match_loss")


def model_parallel_layout(training: dict, n_devices: int, batch_size: int):
    """``(key, k, data)`` of ``training.tensor_parallel: k`` or
    ``training.pipeline: k`` over ``n_devices`` (one a process), ``data =
    n_devices // k`` the data axis; None when neither is above 1. Raises the
    JAX trainer's three errors (``pdc_tpu/training/train.py:437-455``)."""
    tp = int(training.get("tensor_parallel", 0) or 0)
    pp = int(training.get("pipeline", 0) or 0)
    if tp <= 1 and pp <= 1:
        return None
    if tp > 1 and pp > 1:
        raise ValueError(
            "training.tensor_parallel and training.pipeline are separate mesh layouts — set "
            "one (compose either with data_parallel; a combined TP x PP trainer mesh is not "
            "supported)")
    key, k = ("tensor_parallel", tp) if tp > 1 else ("pipeline", pp)
    if n_devices % k:
        raise ValueError(f"{key}={k} does not divide the {n_devices} visible devices (one a "
                         f"process)")
    if batch_size % (n_devices // k):
        raise ValueError(
            f"training.batch_size={batch_size} must be a multiple of the data axis "
            f"({n_devices // k} = {n_devices} devices / {key}={k}) — each step's batch is "
            f"sharded over it")
    return key, k, n_devices // k


def _write_atomic(path: str, tree: dict):
    """Write a flax msgpack file through a temporary file and a rename, so
    a crash never leaves a partial checkpoint under the final name."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(tree))
    os.replace(tmp, path)


class DenseCorrespondenceTraining:
    """Training run with the reference's model-folder contract.

    ``run`` trains on one device (``device``, default ``"cuda"``) along one
    of three routes, chosen as the JAX package chooses them:

      * device sampler: the frames cached on the device
        (:class:`~pdc_tpu_torch.data.device_cache.DeviceCache`) and pairs
        sampled there (:mod:`pdc_tpu_torch.training.scanned`), when the type
        mix is within {0, 1, 2, 4}, the loss is the matrix loss and
        ``steps_per_dispatch`` leaves ``k_eff > 1`` (the largest divisor of
        ``num_iterations`` not above it). Each call takes ``k_eff`` steps,
        as the JAX package's dispatch does
        (:func:`~pdc_tpu_torch.training.scanned.make_scanned_train_step`:
        one CUDA graph replayed ``k_eff`` times on a card, eager steps on
        the CPU and with a mesh);
      * cached host sampler: the frames cached, pairs sampled on the host
        (:meth:`DeviceCache.sample_index_batch` in a prefetch thread),
        frames gathered on the device;
      * host streaming: whole batches made on the host
        (``make_host_batch``) and copied by the prefetch thread, when
        ``cache_dataset_on_device`` is false or the frames exceed
        ``device_cache_max_bytes``.

    With ``training.tensor_parallel`` or ``training.pipeline`` above 1 it
    takes the model-parallel route instead (:meth:`_parallel_mesh`,
    :meth:`_setup_model_parallel_step`): global host batches streamed on
    every rank, each data rank stepping on its block.

    Metrics stay on the device (a call's ``[K]`` tensors queued whole) and
    are fetched in one copy at logging, saving and test-loss boundaries.
    The iteration advances by the steps of a call (``k_eff`` on the
    device-sampler route, else 1), and everything else happens between
    calls, as in the JAX package: ``progress_callback(it, metrics)`` once a
    call, logging, saving and the test loss where ``it`` is a multiple of
    their rates, and SIGTERM ending the run at the call's end with a
    checkpoint (``self.preempted``; ``run_from_pretrained`` resumes it).
    ``step_seconds`` holds the host seconds of each call.
    """

    def __init__(self, config: Optional[dict] = None, dataset=None,
                 dataset_test=None, batch_size: Optional[int] = None, device="cuda"):
        if config is None:
            config = DenseCorrespondenceTraining.load_default_config()
        self._config = config
        self._dataset = dataset
        self._dataset_test = dataset_test
        self._batch_size = batch_size or int(config["training"].get("batch_size", 1))
        self.device = resolve_device(device)
        self._logging_dict = {
            "train": {k: [] for k in ("iteration",) + TRAIN_METRICS + ("learning_rate",)},
            "test": {k: [] for k in ("iteration",) + TEST_METRICS}}
        self._state: Optional[TrainState] = None
        self._start_iteration = 0
        self._pending_metrics = []
        self._tb_writer = None
        self.route = None
        # the mesh of a data- or model-parallel run (None on one process), and
        # the model-parallel layout (model_parallel_layout) when there is one
        self._mesh = None
        self._model_parallel = None
        self._pp_meta = None
        self.preempted = False
        # host seconds of each train-step call (k_eff steps on the
        # device-sampler route) and of each save_network
        self.step_seconds = []
        self.save_seconds = []

    @property
    def dataset(self):
        return self._dataset

    @dataset.setter
    def dataset(self, value):
        self._dataset = value

    @property
    def state(self) -> Optional[TrainState]:
        return self._state

    @staticmethod
    def load_default_config():
        here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        return load_yaml(os.path.join(here, "configs", "training.yaml"))

    # -- setup -------------------------------------------------------------------

    @property
    def writes(self) -> bool:
        """Whether this process writes the model folder: rank 0 of a
        data- or model-parallel run, or the only process."""
        return self._mesh is None or self._mesh.rank == 0

    def setup_logging_dir(self):
        """Create the model folder, wiping a previous run of the same name
        (the path alone on a rank that does not write)."""
        t = self._config["training"]
        if "logging_dir_name" in t:
            dir_name = t["logging_dir_name"]
        else:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            d = self._config["dense_correspondence_network"]["descriptor_dimension"]
            dir_name = f"{stamp}_{d}d"
        base = t.get("logging_dir", "trained_models")
        self._logging_dir = os.path.join(base, dir_name)
        if not self.writes:
            return self._logging_dir
        if os.path.isdir(self._logging_dir):
            import shutil

            shutil.rmtree(self._logging_dir)
        os.makedirs(self._logging_dir, exist_ok=True)
        self._setup_tensorboard()
        return self._logging_dir

    def _setup_tensorboard(self):
        """TensorBoard scalars under ``<folder>/tensorboard``; off with
        ``training.use_tensorboard: false`` or without tensorboard."""
        self._tb_writer = None
        self._tb_flushed = 0
        if not self._config["training"].get("use_tensorboard", True):
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.info("tensorboard is not installed: no TensorBoard scalars")
            return
        tb_dir = os.path.join(self._logging_dir, "tensorboard")
        os.makedirs(tb_dir, exist_ok=True)
        self._tb_writer = SummaryWriter(log_dir=tb_dir)

    def _flush_tensorboard(self):
        """Write the fetched scalars, with the reference's tags."""
        if self._tb_writer is None:
            return
        tl = self._logging_dict["train"]
        tags = {
            "loss": "train loss",
            "match_loss": "train match loss",
            "masked_non_match_loss": "train masked non match loss",
            "background_non_match_loss": "train background non match loss",
            "blind_non_match_loss": "train blind non match loss",
            "learning_rate": "learning rate",
        }
        for i in range(self._tb_flushed, len(tl["iteration"])):
            for k, tag in tags.items():
                self._tb_writer.add_scalar(tag, tl[k][i], tl["iteration"][i])
        self._tb_flushed = len(tl["iteration"])
        self._tb_writer.flush()

    @property
    def logging_dir(self):
        return self._logging_dir

    def save_configs(self):
        """The training config, the dataset's record and a unique run id."""
        if not self.writes:
            return
        save_yaml(self._config, os.path.join(self._logging_dir, "training.yaml"))
        if hasattr(self._dataset, "config_snapshot"):
            dataset_cfg = self._dataset.config_snapshot()
        else:
            dataset_cfg = getattr(self._dataset, "config", {}) or {}
        save_yaml(dataset_cfg, os.path.join(self._logging_dir, "dataset.yaml"))
        save_yaml({"id": uuid.uuid4().hex}, os.path.join(self._logging_dir, "identifier.yaml"))

    def build_network(self):
        """The backbone of the config, initialised from seed 0. It follows
        the config's ``compute_dtype`` and ``remat``; its parameters are
        float32 either way, so the Adam state and the checkpoints keep the
        JAX package's float32 layout."""
        cfg = self._config["dense_correspondence_network"]
        return init_weights_(build_backbone(cfg), torch.Generator().manual_seed(0)), cfg

    # -- checkpointing --------------------------------------------------------------

    def _current_variables(self):
        """``(variables, module, optimizer)``: the live network as the
        standard flax ``{params, batch_stats}``, and the whole module and an
        optimizer-like object of its Adam state, for ``.ckpt.opt`` (None
        for a pipelined run, whose optimizer is per stage, as in JAX). A
        collective in a sharded run: channel-sharded parameters and moments
        are gathered whole, pipeline stages unpacked, ZeRO moments
        gathered; every rank calls it."""
        from pdc_tpu_torch.parallel.pipeline import PPTrainState, unpack_pipeline_variables

        state = self._state
        if isinstance(state, PPTrainState):
            return unpack_pipeline_variables(state.pack, self._pp_meta, self._mesh), None, None
        module, optimizer = state.module, state.optimizer
        if state.tp is not None:
            module, optimizer = state.tp.gathered(module, optimizer)
        elif state.fsdp is not None:
            optimizer = state.fsdp.gathered_optimizer(optimizer)
        return state_dict_to_flax(module.state_dict()), module, optimizer

    def save_network(self, iteration: int):
        """``%06d.ckpt`` (weights and BatchNorm statistics), ``.ckpt.opt``
        (the Adam state as optax's; none for a pipelined run),
        ``%06d_log_history.yaml`` and the rolling ``loss.yaml``; the two
        checkpoint files are written atomically. In a sharded run every rank
        takes part in gathering the state (:meth:`_current_variables`); only
        the writing rank writes."""
        t0 = time.perf_counter()
        tag = "%06d" % iteration
        state = self._state
        variables, module, optimizer = self._current_variables()
        if not self.writes:
            return
        _write_atomic(os.path.join(self._logging_dir, tag + ".ckpt"), variables)
        if module is not None:
            _write_atomic(os.path.join(self._logging_dir, tag + ".ckpt.opt"),
                          adam_state_to_flax(module, optimizer,
                                             state.step - state.schedule_start))
        save_yaml(self._logging_dict,
                  os.path.join(self._logging_dir, tag + "_log_history.yaml"))
        current = {
            split: {k: (v[-1] if len(v) else -1) for k, v in d.items()}
            for split, d in self._logging_dict.items()
        }
        save_yaml(current, os.path.join(self._logging_dir, "loss.yaml"))
        self.save_seconds.append(time.perf_counter() - t0)

    def load_pretrained(self, model_folder: str, iteration: Optional[int] = None):
        """Resume weights, BatchNorm statistics and the Adam state from a
        model folder of either package; returns the iteration."""
        ckpt = find_latest_checkpoint(model_folder, iteration)
        iteration = int(os.path.basename(ckpt).split(".")[0])
        self._ensure_state()
        if not isinstance(self._state, TrainState) or self._state.tp is not None:
            self._state = None  # a pipelined or channel-sharded run: run() lays it out again
            self._ensure_state()
        state = self._state
        if state.fsdp is not None:  # back to replicated storage; run() shards again
            state.fsdp = None
            state.optimizer = make_optimizer(self._config, state.module.parameters())
        state.module.load_state_dict(flax_to_state_dict(read_checkpoint(ckpt)), strict=True)
        state.step = iteration
        state.schedule_start = 0
        opt_path = ckpt + ".opt"
        if os.path.exists(opt_path):
            _, schedule_count = load_adam_state_from_flax(
                state.module, state.optimizer, read_checkpoint(opt_path))
            state.schedule_start = iteration - schedule_count
        self._start_iteration = iteration
        return iteration

    def run_from_pretrained(self, model_folder: str, iteration: Optional[int] = None,
                            learning_rate: Optional[float] = None):
        """Resume from a model folder and train ``num_iterations`` more. A
        new ``learning_rate`` starts a fresh Adam state and LR schedule, as
        the JAX package's fresh optimizer does."""
        it = self.load_pretrained(model_folder, iteration)
        if learning_rate is not None:
            self._config["training"]["learning_rate"] = learning_rate
            state = self._state
            state.optimizer = make_optimizer(self._config, state.module.parameters())
            state.schedule_start = it
        return self.run(loss_current_iteration=it, use_pretrained=True)

    # -- the loop ---------------------------------------------------------------------

    def _ensure_state(self):
        if self._state is not None:
            return
        self._parallel_mesh()
        module, _ = self.build_network()
        self._state = create_train_state(module, self._config, device=self.device)

    def _parallel_mesh(self):
        """With ``training.tensor_parallel`` or ``pipeline`` above 1, or
        ``training.data_parallel``: initialise the process group
        (:func:`~pdc_tpu_torch.parallel.distributed.ensure_initialized`;
        torchrun's variables, or the group a launcher set up) and build the
        mesh over it, binding this trainer to the rank's device: the
        model-parallel layout's ``(data, model)`` or ``(data, pipe)`` mesh
        (:func:`model_parallel_layout`'s checks first, on one process too),
        or, when there is more than one process, the data axis."""
        t = self._config["training"]
        if self._mesh is not None:
            return self._mesh
        wanted = max(int(t.get(k, 0) or 0) for k in ("tensor_parallel", "pipeline")) > 1
        if not wanted and not t.get("data_parallel"):
            return None
        import torch.distributed as dist

        from pdc_tpu_torch.parallel.distributed import ensure_initialized
        from pdc_tpu_torch.parallel.mesh import make_mesh

        several = ensure_initialized(device=self.device.type)
        device = None if self.device.type == "cuda" else self.device
        if wanted:
            n = dist.get_world_size() if dist.is_initialized() else 1
            self._model_parallel = model_parallel_layout(t, n, self._batch_size)
            key, k, data = self._model_parallel
            self._mesh = make_mesh(("data", "model" if key == "tensor_parallel" else "pipe"),
                                   shape=(data, k), device=device)
        elif several:
            self._mesh = make_mesh(("data",), device=device)
        if self._mesh is not None:
            self.device = self._mesh.device
        return self._mesh

    def _setup_model_parallel_step(self, loss_cfg, assembler_cfg, W):
        """The step of ``training.tensor_parallel`` or ``training.pipeline``,
        with ``self._state`` laid out on the mesh (channel-sharded, or this
        rank's pipeline stage), as ``pdc_tpu/training/train.py:418-480``
        routes them."""
        from pdc_tpu_torch.parallel.pipeline import make_pp_train_step
        from pdc_tpu_torch.parallel.tensor_parallel import make_tp_train_step

        key, k, data = self._model_parallel
        net_cfg = self._config["dense_correspondence_network"]
        if key == "tensor_parallel":
            logger.info("tensor-parallel training: %dx%d DP x TP mesh", data, k)
            step, self._state = make_tp_train_step(self._config, loss_cfg, assembler_cfg, W,
                                                   self._mesh, self._state)
            return step
        logger.info("pipeline-parallel training: %dx%d DP x PP mesh (GPipe, frozen BN — see "
                    "parallel/pipeline.py)", data, k)
        step, self._state, self._pp_meta = make_pp_train_step(
            self._config, loss_cfg, assembler_cfg, W, self._mesh, self._state,
            (net_cfg["image_height"], W),
            microbatch=int(self._config["training"].get("pipeline_microbatch", 1)))
        return step

    def _choose_route(self, loss_cfg, assembler_cfg, W):
        """(route, step, cache) as the JAX package chooses its route."""
        # imported here: both modules build on this one's TrainStep
        from pdc_tpu_torch.data.device_cache import DeviceCache, make_cached_train_step
        from pdc_tpu_torch.training.scanned import SAMPLED_TYPES, make_scanned_train_step

        t = self._config["training"]
        if t.get("cache_dataset_on_device", True):
            try:
                cache = DeviceCache.from_dataset(
                    self._dataset, max_bytes=int(t.get("device_cache_max_bytes", 8 << 30)),
                    device=self.device)
            except MemoryError as e:
                logger.warning("device cache disabled: %s", e)
            else:
                logger.info("device cache: %.0f MB", cache.nbytes / 1e6)
                type_probs = getattr(self._dataset, "_data_type_probabilities", {0: 1.0})
                n_iter = int(t["num_iterations"])
                steps_per_dispatch = int(t.get("steps_per_dispatch", 10))
                k_eff = next((k for k in range(min(steps_per_dispatch, n_iter), 0, -1)
                              if n_iter % k == 0), 1)
                if (k_eff > 1 and set(type_probs) <= set(SAMPLED_TYPES)
                        and assembler_cfg.use_matrix_loss):
                    mesh = self._mesh
                    fsdp = bool(t.get("fsdp")) and mesh is not None
                    if mesh is not None:
                        logger.info("data-parallel training over %d processes (global batch "
                                    "%d)%s", mesh.shape["data"],
                                    self._batch_size * mesh.shape["data"],
                                    " + fsdp state sharding" if fsdp else "")
                    step = make_scanned_train_step(
                        self._config, loss_cfg, assembler_cfg, W, cache, self._batch_size,
                        k_eff, mesh=mesh, type_probs=tuple(sorted(type_probs.items())),
                        fsdp=fsdp)
                    return ROUTE_DEVICE_SAMPLER, step, cache
                step = make_cached_train_step(self._config, loss_cfg, assembler_cfg, W, cache)
                return ROUTE_CACHED_HOST_SAMPLER, step, cache
        step = make_train_step(self._config, loss_cfg, assembler_cfg, W)
        return ROUTE_HOST_STREAMING, step, None

    def run(self, loss_current_iteration: int = 0, use_pretrained: bool = False,
            progress_callback=None):
        """Train ``num_iterations`` steps from ``loss_current_iteration``.
        Returns the model folder."""
        if self._dataset is None:
            raise ValueError("set a dataset first")
        t = self._config["training"]
        net_cfg = self._config["dense_correspondence_network"]
        W = net_cfg["image_width"]
        self._parallel_mesh()
        if (self._model_parallel is not None and self._model_parallel[0] == "pipeline"
                and t.get("compute_test_loss", False) and self._dataset_test is not None):
            raise ValueError("training.compute_test_loss needs the whole network; a pipelined "
                             "run holds one stage a process")
        if t.get("compilation_cache_dir"):
            logger.info("training.compilation_cache_dir ignored: it holds XLA programs, "
                        "and the port runs none")

        self.setup_logging_dir()
        self.save_configs()
        self._dataset.set_parameters_from_training_config(self._config)
        self._ensure_state()

        loss_cfg = LossConfig.from_dict(self._config["loss_function"])
        assembler_cfg = AssemblerConfig.from_training_config(self._config)
        if self._model_parallel is not None:
            # host batches streamed: the device cache assumes a replicated state
            self.route, cache = ROUTE_MODEL_PARALLEL, None
            train_step = self._setup_model_parallel_step(loss_cfg, assembler_cfg, W)
        else:
            self.route, train_step, cache = self._choose_route(loss_cfg, assembler_cfg, W)
        logger.info("training route: %s", self.route)
        if self._mesh is not None and self.route not in (ROUTE_DEVICE_SAMPLER,
                                                         ROUTE_MODEL_PARALLEL):
            raise ValueError(
                "training.data_parallel over several processes needs the device-cache "
                "sampler route (matrix loss, steps_per_dispatch divisor > 1, sample types "
                f"within {{0, 1, 2, 4}}); this config takes the {self.route} route")
        # (a model-parallel mesh carries a data axis: that run is not single-device)
        if (self.route not in (ROUTE_DEVICE_SAMPLER, ROUTE_MODEL_PARALLEL)
                and (t.get("data_parallel") or t.get("fsdp"))):
            logger.warning(
                "training.data_parallel/fsdp IGNORED: multi-chip training "
                "needs the device-cache scanned path (>1 device, matrix "
                "loss, steps_per_dispatch divisor > 1, scannable sample "
                "types) — this run is single-chip")
        elif t.get("fsdp") and not t.get("data_parallel"):
            logger.warning("training.fsdp IGNORED: requires training.data_parallel")
        elif t.get("data_parallel") and self._mesh is None:
            logger.info("training.data_parallel on one process: training on one device "
                        "(launch with torchrun for several)")

        eval_step = None
        if t.get("compute_test_loss", False) and self._dataset_test is not None:
            self._dataset_test.set_parameters_from_training_config(self._config)
            eval_step = make_eval_loss_step(loss_cfg, assembler_cfg, W)

        max_iterations = int(t["num_iterations"]) + loss_current_iteration
        save_rate = int(t.get("save_rate", 1000))
        logging_rate = int(t.get("logging_rate", 100))
        test_rate = int(t.get("compute_test_loss_rate", 500))

        if not use_pretrained:
            self.save_network(0)

        profile_dir = t.get("profile_dir")
        profile_steps = int(t.get("profile_num_steps", 10))
        profiler = None

        seed = int(t.get("seed", 1))
        if self._mesh is not None:
            from pdc_tpu_torch.parallel.sharded_train import rank_seed, shard_host_batch

            # each data rank draws its own pairs; the ranks of a model or pipe
            # axis must draw the same ones
            seed = rank_seed(seed, self._mesh.rank if self._model_parallel is None
                             else self._mesh.index["data"])
        generator = torch.Generator(device=self.device).manual_seed(seed)
        prefetch = None
        if self.route == ROUTE_MODEL_PARALLEL:
            # the global batch on every rank (one stream a run), each data rank its block
            prefetch = PrefetchLoader(lambda: self._dataset.make_host_batch(self._batch_size),
                                      depth=2)
        elif self.route == ROUTE_CACHED_HOST_SAMPLER:
            prefetch = PrefetchLoader(lambda: cache.sample_index_batch(self._batch_size),
                                      depth=2)
        elif self.route == ROUTE_HOST_STREAMING:
            prefetch = PrefetchLoader(lambda: self._dataset.make_host_batch(self._batch_size),
                                      depth=2, device=self.device)

        # SIGTERM (a preempted machine) only sets a flag; the loop writes a
        # checkpoint at the next step boundary and returns. Installed from
        # the main thread only, and restored on exit.
        self.preempted = False
        self._preempt_requested = False
        old_sigterm = None
        if (bool(t.get("handle_preemption", True))
                and threading.current_thread() is threading.main_thread()):
            def request_preempt(signum, frame):
                self._preempt_requested = True
            old_sigterm = signal.signal(signal.SIGTERM, request_preempt)

        tl = self._logging_dict["train"]
        it = loss_current_iteration
        profile_from = None  # the iteration the trace started at
        try:
            while it < max_iterations:
                # the trace starts after the first call (its set-up and, on
                # the scanned route, the graph's capture)
                if profile_dir and profile_from is None and it > loss_current_iteration:
                    profiler, profile_from = self._start_profiler(), it
                if profiler is not None and it >= profile_from + profile_steps:
                    self._stop_profiler(profiler, profile_dir)
                    profiler = None
                t0 = time.perf_counter()
                if self.route == ROUTE_DEVICE_SAMPLER:
                    # K steps a call; the [K] metrics are queued whole
                    metrics = train_step(self._state, generator)
                    k_steps = int(metrics["loss"].shape[0])
                elif self.route == ROUTE_MODEL_PARALLEL:
                    metrics = train_step(self._state, shard_host_batch(prefetch.next(),
                                                                       self._mesh), generator)
                    k_steps = 1
                else:
                    metrics = train_step(self._state, prefetch.next(), generator)
                    k_steps = 1
                elapsed = time.perf_counter() - t0
                self.step_seconds.append(elapsed)
                self._pending_metrics.append(metrics)
                for _ in range(k_steps):
                    it += 1
                    tl["iteration"].append(it)
                    tl["learning_rate"].append(host_lr(self._config, it))

                if progress_callback is not None:
                    progress_callback(it, metrics)

                if self._preempt_requested and it < max_iterations:
                    logger.warning(
                        "SIGTERM received: writing preemption checkpoint at "
                        "iteration %d and exiting cleanly (resume with "
                        "run_from_pretrained)", it)
                    self.preempted = True
                    break

                if it % logging_rate == 0:
                    self._materialize_metrics()
                    self._flush_tensorboard()
                    logger.info("iter %d/%d loss=%.4f match=%.4f (%.3fs/iter)",
                                it, max_iterations, tl["loss"][-1], tl["match_loss"][-1],
                                elapsed)

                if it % save_rate == 0:
                    self._materialize_metrics()
                    self.save_network(it)

                if (eval_step is not None and test_rate > 0
                        and it % test_rate == 0 and it > 5):
                    self._test_loss(eval_step, it, int(t.get("test_loss_num_iterations", 50)),
                                    generator)
        finally:
            if old_sigterm is not None:
                signal.signal(signal.SIGTERM, old_sigterm)
            if profiler is not None:
                self._stop_profiler(profiler, profile_dir)
            if prefetch is not None:
                prefetch.stop()

        self._materialize_metrics()
        self._flush_tensorboard()
        if self._tb_writer is not None:
            self._tb_writer.close()
        self.save_network(it)
        return self._logging_dir

    def _test_loss(self, eval_step: EvalLossStep, it: int, num_samples: int,
                   generator: torch.Generator):
        """Mean test-loss metrics over ``num_samples // batch_size`` batches
        of the test dataset, fetched once at the end."""
        results = []
        for _ in range(num_samples // max(self._batch_size, 1) or 1):
            batch = self._dataset_test.make_host_batch(self._batch_size)
            m = eval_step(self._state, batch, generator)
            results.append(torch.stack([m[k] for k in TEST_METRICS]))
        values = torch.stack(results).cpu().numpy()  # [batches, 3] float32
        te = self._logging_dict["test"]
        te["iteration"].append(it)
        for j, k in enumerate(TEST_METRICS):
            te[k].append(float(np.mean(values[:, j])))

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profiler(self, profiler, profile_dir: str):
        """End the trace and write it as ``<profile_dir>/trace.json``
        (Chrome trace format)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    def _materialize_metrics(self):
        """Fetch the queued metrics, one step's or a call's ``[K]``, in one
        device-to-host copy."""
        if not self._pending_metrics:
            return
        values = torch.cat([torch.stack([m[k].reshape(-1) for k in TRAIN_METRICS], dim=1)
                            for m in self._pending_metrics]).cpu().numpy()
        tl = self._logging_dict["train"]
        for j, k in enumerate(TRAIN_METRICS):
            tl[k].extend(float(x) for x in values[:, j])
        self._pending_metrics = []

    # -- conveniences ------------------------------------------------------------------

    def get_dcn(self) -> DenseCorrespondenceNetwork:
        """The current network as an inference
        :class:`~pdc_tpu_torch.models.dcn.DenseCorrespondenceNetwork`, on a
        copy of the weights (later training does not change it); whole in a
        sharded run, where every rank must call this."""
        from pdc_tpu_torch.parallel.pipeline import PPTrainState
        from pdc_tpu_torch.parallel.tensor_parallel import unshard_channels

        net_cfg = self._config["dense_correspondence_network"]
        state = self._state
        if isinstance(state, PPTrainState):
            module = self.build_network()[0]
            module.load_state_dict(flax_to_state_dict(self._current_variables()[0]))
        elif state.tp is not None:
            module = unshard_channels(state.module)
        else:
            module = copy.deepcopy(state.module)
        return DenseCorrespondenceNetwork(
            module,
            descriptor_dimension=net_cfg["descriptor_dimension"],
            image_width=net_cfg["image_width"],
            image_height=net_cfg["image_height"],
            normalize=net_cfg.get("normalize", False),
            config=net_cfg,
            device=self.device,
        )
