"""FSDP (ZeRO) storage of the training state over the data axis.

Port of the FSDP half of :mod:`pdc_tpu.parallel.tensor_parallel`
(:72-182, :212-267): ``fsdp_shardings``, ``best_shard_axis``,
``tree_shard_axes``, ``tree_shard_specs``, ``tree_all_gather``,
``tree_reduce_scatter_mean``, ``scan_fsdp_setup``, ``sharded_size_bytes``
and ``make_fsdp_train_step``. Each rank stores the block of every
parameter along its shard axis, and Adam's moments of that block, so the
state per rank is 1/n of the replicated layout; a step all-gathers the
parameters for its forward and reduce-scatters the gradients back to the
blocks, and Adam then runs on each rank's blocks. BatchNorm's running
statistics stay replicated.

The shard axis of a leaf is JAX's: the largest axis divisible by ``n``,
ties to the lower index. For the port's parameters it is taken on the
flax layout of the leaf (a convolution's HWIO kernel, where the port holds
OIHW) and mapped to the port's axis, so each rank holds the same elements
as the JAX chip of its index.

Tensor parallelism (``channel_shardings``, ``make_tp_inference``,
``make_tp_train_step``) is ROADMAP queue 1 item 9b; those names raise.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Mapping, Optional

import torch

from pdc_tpu_torch.parallel.mesh import Mesh

TP_MSG = ("tensor parallelism is not ported to pdc_tpu_torch yet: it is ROADMAP queue 1 "
          "item 9b")
# a flax HWIO kernel's axis -> the port's OIHW weight axis
_HWIO_TO_OIHW = (2, 3, 1, 0)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def best_shard_axis(shape, n: int) -> Optional[int]:
    """The largest axis of ``shape`` divisible by ``n`` (ties to the lower
    index), None when none is."""
    for i in sorted(range(len(shape)), key=lambda j: -shape[j]):
        if shape[i] % n == 0 and shape[i] >= n:
            return i
    return None


def tree_shard_axes(tree: Any, n: int):
    """:func:`best_shard_axis` of every leaf (a nested dict of arrays or
    tensors, such as a flax ``params`` tree), by the leaf's own shape."""
    return _tree_map(lambda leaf: best_shard_axis(tuple(leaf.shape), n), tree)


def tree_shard_specs(tree: Any, n: int, axis_name: str):
    """Per leaf, the tuple naming ``axis_name`` at its shard axis and None
    elsewhere (``()`` for a replicated leaf): the port's PartitionSpec."""
    def spec(leaf):
        ax = best_shard_axis(tuple(leaf.shape), n)
        if ax is None:
            return ()
        parts = [None] * len(leaf.shape)
        parts[ax] = axis_name
        return tuple(parts)

    return _tree_map(spec, tree)


def tree_all_gather(tree: Any, axes: Any, mesh: Mesh, axis_name: str = "data"):
    """Full leaves from each rank's blocks: the tiled all-gather on each
    leaf's shard axis; replicated leaves (axis None) pass through."""
    return _tree_map(lambda leaf, ax: leaf if ax is None
                     else mesh.all_gather(leaf, axis_name, dim=ax), tree, axes)


def tree_reduce_scatter_mean(tree: Any, axes: Any, mesh: Mesh, axis_name: str = "data",
                             mean: bool = True):
    """The mean over ranks of every leaf, scattered back to this rank's
    block (the ZeRO reduce-scatter, then ``/ n``); replicated leaves get
    the plain mean. ``mean=False`` keeps the sum."""
    return _tree_map(lambda leaf, ax: mesh.all_reduce(leaf, axis_name, mean=mean) if ax is None
                     else mesh.reduce_scatter(leaf, axis_name, dim=ax, mean=mean), tree, axes)


def param_shard_axis(shape, n: int) -> Optional[int]:
    """The port's shard axis of a parameter of ``shape``: JAX's choice on
    the flax layout (a 4-D OIHW weight is an HWIO kernel there), mapped to
    the port's axis."""
    shape = tuple(shape)
    if len(shape) == 4:
        ax = best_shard_axis((shape[2], shape[3], shape[1], shape[0]), n)
        return None if ax is None else _HWIO_TO_OIHW[ax]
    return best_shard_axis(shape, n)


def fsdp_shardings(named: Mapping[str, torch.Tensor], mesh: Mesh, axis: str = "data"):
    """``{name: spec}`` of a module's parameters under ZeRO storage: each
    sharded on :func:`param_shard_axis` (``()`` when no axis divides)."""
    n = mesh.shape[axis]

    def spec(t):
        ax = param_shard_axis(t.shape, n)
        if ax is None:
            return ()
        parts = [None] * t.dim()
        parts[ax] = axis
        return tuple(parts)

    return {k: spec(v) for k, v in named.items()}


def sharded_size_bytes(tree: Any, specs: Any, mesh: Mesh) -> int:
    """Bytes per rank of ``tree`` with each leaf laid out by its spec."""
    total = 0
    for leaf, spec in zip(_leaves(tree), _leaves(specs)):
        n = 1
        for name in spec or ():
            if name is not None:
                n *= mesh.shape[name]
        total += leaf.numel() * leaf.element_size() // n
    return total


def scan_fsdp_setup(module: torch.nn.Module, mesh: Mesh, data_axis: str = "data"):
    """Shard axes and specs of the ZeRO steps: ``(p_axes, state_specs)``,
    ``p_axes`` the :func:`param_shard_axis` of each parameter, and
    ``state_specs`` the layout of the state (parameters and Adam's moments
    sharded, BatchNorm statistics and the step replicated)."""
    n = mesh.shape[data_axis]
    named = dict(module.named_parameters())
    p_axes = {k: param_shard_axis(v.shape, n) for k, v in named.items()}
    p_specs = fsdp_shardings(named, mesh, data_axis)
    buffers = {k: () for k, _ in module.named_buffers()}
    return p_axes, {"step": (), "params": p_specs, "batch_stats": buffers,
                    "opt_state": {"exp_avg": p_specs, "exp_avg_sq": p_specs}}


class FsdpLayout:
    """A module's parameters stored as this rank's blocks (``shards``, the
    tensors the optimizer steps) along :func:`param_shard_axis`; the module
    keeps the full parameters, all-gathered after every update, for the
    forward and for whoever reads the module."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh, axis: str = "data"):
        self.mesh, self.axis = mesh, axis
        self.names = [k for k, _ in module.named_parameters()]
        self.full = [p for _, p in module.named_parameters()]
        self.axes = scan_fsdp_setup(module, mesh, axis)[0]
        self.shards = [torch.nn.Parameter(self._block(p.detach(), self.axes[k]).clone())
                       for k, p in zip(self.names, self.full)]

    def _block(self, t: torch.Tensor, ax):
        if ax is None:
            return t
        n, i = self.mesh.shape[self.axis], self.mesh.index[self.axis]
        b = t.shape[ax] // n
        return t.narrow(ax, i * b, b)

    # The step's collectives are coalesced: every leaf's block, moved to put
    # its shard axis first and flattened, goes into one buffer, so a step
    # makes one all-gather and one reduce-scatter (and one all-reduce of the
    # replicated leaves) where the per-leaf tree functions make one a leaf.

    def _leaves(self, sharded: bool):
        return [(k, p, s, self.axes[k]) for k, p, s in zip(self.names, self.full, self.shards)
                if (self.axes[k] is not None) == sharded]

    def gather_params(self):
        """Write the all-gathered blocks into the module's parameters."""
        n = self.mesh.shape[self.axis]
        sharded = self._leaves(True)
        with torch.no_grad():
            if sharded:
                flat = torch.cat([s.detach().movedim(ax, 0).reshape(-1)
                                  for _, _, s, ax in sharded])
                ranks = self.mesh.all_gather(flat, self.axis).view(n, -1)
                offset = 0
                for _, p, s, ax in sharded:
                    moved = s.detach().movedim(ax, 0)
                    blocks = ranks[:, offset:offset + s.numel()]
                    p.copy_(blocks.reshape((n * moved.shape[0],) + moved.shape[1:])
                            .movedim(0, ax))
                    offset += s.numel()
            for _, p, s, _ in self._leaves(False):
                p.copy_(s)

    def reduce_scatter_grads(self, mean: bool):
        """Each block's gradient: the sum (or mean) over ranks of the full
        gradients, scattered; a replicated parameter gets the whole sum."""
        n = self.mesh.shape[self.axis]

        def grad(p):
            return p.grad if p.grad is not None else torch.zeros_like(p)

        sharded = self._leaves(True)
        if sharded:
            by_rank = torch.cat([grad(p).movedim(ax, 0).reshape(n, -1)
                                 for _, p, _, ax in sharded], dim=1)  # [n, blocks]
            mine = self.mesh.reduce_scatter(by_rank.reshape(-1), self.axis, mean=mean)
            offset = 0
            for _, _, s, ax in sharded:
                moved = s.detach().movedim(ax, 0)
                s.grad = mine[offset:offset + s.numel()].reshape(moved.shape).movedim(0, ax)
                offset += s.numel()
        replicated = self._leaves(False)
        if replicated:
            summed = self.mesh.all_reduce(torch.cat([grad(p).reshape(-1)
                                                     for _, p, _, _ in replicated]),
                                          self.axis, mean=mean)
            offset = 0
            for _, p, s, _ in replicated:
                s.grad = summed[offset:offset + s.numel()].view_as(s).clone()
                offset += s.numel()

    def shard_optimizer_state(self, full_optimizer, shard_optimizer):
        """Give ``shard_optimizer`` this rank's blocks of the moments that
        ``full_optimizer`` holds for the module's parameters (none yet: no
        state)."""
        for k, p, s in zip(self.names, self.full, self.shards):
            st = full_optimizer.state.get(p, {})
            if "exp_avg" in st:
                ax = self.axes[k]
                shard_optimizer.state[s] = {
                    "step": st["step"].clone(),
                    "exp_avg": self._block(st["exp_avg"], ax).clone(),
                    "exp_avg_sq": self._block(st["exp_avg_sq"], ax).clone()}

    def gathered_optimizer(self, shard_optimizer):
        """An object with the ``state`` of a full Adam over the module's
        parameters, the moments all-gathered (what a checkpoint writes)."""
        held = {k: shard_optimizer.state[s] for k, s in zip(self.names, self.shards)
                if "exp_avg" in shard_optimizer.state.get(s, {})}
        axes = {k: self.axes[k] for k in held}
        moments = {key: tree_all_gather({k: st[key] for k, st in held.items()}, axes,
                                        self.mesh, self.axis)
                   for key in ("exp_avg", "exp_avg_sq")}
        full = dict(zip(self.names, self.full))
        return SimpleNamespace(state={
            full[k]: {"step": st["step"], "exp_avg": moments["exp_avg"][k],
                      "exp_avg_sq": moments["exp_avg_sq"][k]} for k, st in held.items()})

    def state_bytes(self, shard_optimizer) -> int:
        """Bytes this rank stores of the parameters and Adam's moments."""
        total = 0
        for s in self.shards:
            total += s.numel() * s.element_size()
            st = shard_optimizer.state.get(s, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    total += st[key].numel() * st[key].element_size()
        return total


def to_fsdp_state(state, training_config: dict, mesh: Mesh, data_axis: str = "data"):
    """Switch a replicated :class:`~pdc_tpu_torch.training.train.TrainState`
    to ZeRO storage in place: ``state.fsdp`` becomes its
    :class:`FsdpLayout`, ``state.optimizer`` an Adam over the blocks, with
    the blocks of any moments it had. Returns ``state``."""
    from pdc_tpu_torch.training.train import make_optimizer

    if getattr(state, "fsdp", None) is not None:
        return state
    layout = FsdpLayout(state.module, mesh, data_axis)
    optimizer = make_optimizer(training_config, layout.shards)
    layout.shard_optimizer_state(state.optimizer, optimizer)
    state.optimizer, state.fsdp = optimizer, layout
    return state


def make_fsdp_train_step(training_config: dict, loss_cfg, assembler_cfg, image_width: int,
                         mesh: Mesh, state, data_axis: str = "data"):
    """The global-batch step of
    :func:`~pdc_tpu_torch.parallel.sharded_train.make_sharded_train_step`
    with the state in ZeRO storage (:func:`to_fsdp_state`): the same
    numbers, 1/n of the state per rank. Returns ``(step, state)``; the
    state is switched in place."""
    from pdc_tpu_torch.parallel.sharded_train import make_sharded_train_step

    state = to_fsdp_state(state, training_config, mesh, data_axis)
    return make_sharded_train_step(training_config, loss_cfg, assembler_cfg, image_width, mesh,
                                   data_axis=data_axis), state


def channel_shardings(*args, **kwargs):
    """Tensor-parallel channel shardings: ROADMAP queue 1 item 9b."""
    raise NotImplementedError(TP_MSG)


def make_tp_inference(*args, **kwargs):
    """Tensor-parallel inference: ROADMAP queue 1 item 9b."""
    raise NotImplementedError(TP_MSG)


def make_tp_train_step(*args, **kwargs):
    """Tensor-parallel training: ROADMAP queue 1 item 9b."""
    raise NotImplementedError(TP_MSG)
