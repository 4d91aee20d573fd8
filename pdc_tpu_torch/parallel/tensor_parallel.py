"""FSDP (ZeRO) storage of the training state over the data axis, and tensor
(channel) parallelism over a model axis.

Port of :mod:`pdc_tpu.parallel.tensor_parallel`. The FSDP half (:72-182,
:212-267): ``fsdp_shardings``, ``best_shard_axis``,
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

Tensor parallelism, the other half (``channel_shardings`` :50-69,
``make_tp_inference`` :185-209, ``make_tp_train_step`` :212-248): every convolution whose
output channels divide over a ``model`` axis becomes a
:class:`ColumnParallelConv`, Megatron's column-parallel layer with a
gathered output. It holds its block of output channels (weight and bias);
its forward takes the input whole (the backward sums the input's gradient
over the model axis), convolves with its block and all-gathers the blocks
along the channel axis in rank order (the backward takes this rank's block
of the gradient). JAX lets GSPMD insert these collectives; here they are
stated. BatchNorm, ReLU, the residual adds and the head (D=3 output
channels) stay replicated over the model axis: they read the gathered
activations. So every sharded kernel and its Adam moments are stored at
1/n a rank; JAX also shards the BatchNorm vectors, the port keeps them
replicated (ROADMAP §3), while :func:`channel_shardings` still returns
JAX's rule.

The gather has two implementations behind one interface: over the model
axis of a :class:`~pdc_tpu_torch.parallel.mesh.Mesh`, across processes and
differentiable (:class:`MeshChannels`: inference, the train step, the
trainer), and in one process over a list of local devices
(:class:`LocalChannels`: the server's ``model_parallel``), where each
device holds its block, takes its own copy of the input and the blocks are
concatenated on the first device.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from pdc_tpu_torch.models.dinov2 import Dinov2FCN
from pdc_tpu_torch.models.resnet import Int8Conv
from pdc_tpu_torch.parallel.mesh import Mesh, shard_leading

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


# -- tensor parallelism -------------------------------------------------------------


def channel_shardings(tree: Any, mesh: Mesh, axis: str = "model"):
    """JAX's per-leaf channel shardings of a tree in the flax layout (such as
    :func:`~pdc_tpu_torch.models.convert.state_dict_to_flax`'s): a 4-D
    kernel ``[kh, kw, Cin, Cout]`` on Cout, a 1-D per-channel vector on its
    axis, when that axis divides over ``axis``; every other leaf replicated
    (``()``), such as the D=3 head. The port stores its BatchNorm vectors
    replicated all the same (:func:`tp_shardings` is its layout)."""
    n = mesh.shape[axis]

    def rule(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 4 and shape[3] % n == 0 and shape[3] >= n:
            return (None, None, None, axis)
        if len(shape) == 1 and shape[0] % n == 0 and shape[0] >= n:
            return (axis,)
        return ()

    return _tree_map(rule, tree)


def _shardable(conv, n: int) -> bool:
    return (type(conv) is Int8Conv and conv.groups == 1 and conv.out_channels % n == 0
            and conv.out_channels >= n)


class _CopyToModel(torch.autograd.Function):
    """The input of a column-parallel layer: the identity, whose backward
    sums the gradient over the model group (each rank's block of output
    channels contributes its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """Every rank's block of channels (dim 1) concatenated in rank order;
    the backward is this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, y, group, n, index):
        ctx.index, ctx.width = index, y.shape[1]
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.index * ctx.width, ctx.width).contiguous(), None, None, None


class MeshChannels:
    """The model axis of a mesh: this rank holds block ``index`` of ``n`` of
    every sharded convolution; its forward's collectives are differentiable
    and run over the axis's process group (none when the axis is of size 1
    beside larger ones; a world of one initialised process keeps its group,
    so they run)."""

    def __init__(self, mesh: Mesh, axis: str = "model"):
        self.n, self.index, self.group = mesh.shape[axis], mesh.index[axis], mesh.group(axis)
        self.blocks = (self.index,)  # the blocks this process holds, in order
        self.devices = (mesh.device,)

    def forward(self, conv: "ColumnParallelConv", x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return Int8Conv.forward(conv, x)
        y = Int8Conv.forward(conv, _CopyToModel.apply(x, self.group))
        return _GatherChannels.apply(y, self.group, self.n, self.index)

    def gather(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's block along dim 0."""
        (block,) = blocks
        if self.group is None:
            return block.detach().clone()
        block = block.detach().contiguous()
        parts = [torch.empty_like(block) for _ in range(self.n)]
        dist.all_gather(parts, block, group=self.group)
        return torch.cat(parts)


class LocalChannels:
    """A model axis over devices of this process (inference only): block
    ``i`` of every sharded convolution lives on ``devices[i]``, which takes
    its own copy of the input; the blocks' outputs are concatenated on the
    first device, where the replicated layers run."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.n, self.index = len(self.devices), 0
        self.blocks = tuple(range(self.n))

    def forward(self, conv: "ColumnParallelConv", x: torch.Tensor) -> torch.Tensor:
        # every block's work is queued before any output is copied back
        ys = [Int8Conv.forward(conv, x)] + [Int8Conv.forward(r, x.to(d)) for r, d in
                                            zip(conv.replicas, self.devices[1:])]
        return torch.cat([y.to(x.device) for y in ys], dim=1)

    def gather(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([b.detach().to(self.devices[0]) for b in blocks])


def _block_conv(conv: Int8Conv, block: int, n: int, device, out: Optional[Int8Conv] = None):
    """``out`` (by default a new :class:`Int8Conv`) holding output channels
    ``[block * c, (block + 1) * c)`` of ``conv`` (``c = out_channels / n``)
    on ``device``, with its quantization settings and static activation
    scale."""
    c = conv.out_channels // n
    if out is None:
        out = Int8Conv(conv.in_channels, c, conv.kernel_size, stride=conv.stride,
                       padding=conv.padding, dilation=conv.dilation,
                       bias=conv.bias is not None, device="meta")
    out.to_empty(device=device)
    with torch.no_grad():
        out.weight.copy_(conv.weight.narrow(0, block * c, c))
        if conv.bias is not None:
            out.bias.copy_(conv.bias.narrow(0, block * c, c))
        out.act_scale.copy_(conv.act_scale)
    out.set_quantization(conv.quant_int8, conv.quant_static)
    out.calibrating = conv.calibrating
    out.train(conv.training)
    return out


class ColumnParallelConv(Int8Conv):
    """An :class:`Int8Conv` holding block ``channels.blocks[0]`` of the
    output channels of the convolution it replaces (weight and bias; the
    int8 settings and the static activation scale too, which are per tensor
    or per output channel, so the int8 path gives the unsharded layer's
    channels); under :class:`LocalChannels` the other blocks are
    ``replicas`` on the other devices. ``forward`` runs the blocks through
    ``channels`` and returns every output channel."""

    def __init__(self, conv: Int8Conv, channels):
        super().__init__(conv.in_channels, conv.out_channels // channels.n, conv.kernel_size,
                         stride=conv.stride, padding=conv.padding, dilation=conv.dilation,
                         bias=conv.bias is not None, device="meta")
        first, *rest = channels.blocks
        _block_conv(conv, first, channels.n, channels.devices[0], out=self)
        self.full_out_channels = conv.out_channels
        self.channels = channels
        self.replicas = torch.nn.ModuleList(
            _block_conv(conv, b, channels.n, d) for b, d in zip(rest, channels.devices[1:]))

    def set_quantization(self, quant_int8: bool, quant_static: bool):
        super().set_quantization(quant_int8, quant_static)
        for r in getattr(self, "replicas", ()):
            r.set_quantization(quant_int8, quant_static)

    def forward(self, x):
        return self.channels.forward(self, x)

    def gathered(self) -> Int8Conv:
        """The whole convolution (every rank of a mesh's model axis must
        call this, in the same order)."""
        conv = Int8Conv(self.in_channels, self.full_out_channels, self.kernel_size,
                        stride=self.stride, padding=self.padding, dilation=self.dilation,
                        bias=self.bias is not None, device="meta")
        conv.to_empty(device=self.weight.device)
        with torch.no_grad():
            conv.weight.copy_(self.channels.gather(
                [self.weight] + [r.weight for r in self.replicas]))
            if self.bias is not None:
                conv.bias.copy_(self.channels.gather([self.bias] + [r.bias for r in self.replicas]))
            conv.act_scale.copy_(self.act_scale)
        conv.set_quantization(self.quant_int8, self.quant_static)
        conv.train(self.training)
        return conv


def _swap(module: torch.nn.Module, fn, select):
    """Replace every submodule ``m`` for which ``select(m)`` by ``fn(m)``, in
    place, in registration order (an order every rank shares)."""
    for name, m in list(module.named_modules()):
        if name and select(m):
            parent, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(parent) if parent else module, leaf, fn(m))
    return module


def shard_channels(module: torch.nn.Module, channels) -> torch.nn.Module:
    """Swap, in place, every float or int8 :class:`Int8Conv` of ``module``
    whose output channels divide over ``channels.n`` for a
    :class:`ColumnParallelConv` holding this process's block(s); the other
    layers are left replicated. ``channels`` is a :class:`MeshChannels` or
    a :class:`LocalChannels`; the module's replicated layers must be on
    ``channels.devices[0]``. Returns ``module``. The Dinov2 backbone, whose
    work is in its linear layers and attention, is refused."""
    if isinstance(module, Dinov2FCN):
        raise ValueError("tensor parallelism shards the output channels of convolutions: "
                         "the Dinov2 backbone is not supported")
    return _swap(module, lambda c: ColumnParallelConv(c, channels),
                 lambda m: _shardable(m, channels.n))


def unshard_channels(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of a channel-sharded module with every
    :class:`ColumnParallelConv` back to a whole :class:`Int8Conv` (a
    collective over a mesh's model axis: every rank of it calls this).
    The copy shares nothing with ``module``."""
    memo = {id(m.channels): m.channels for m in module.modules()
            if isinstance(m, ColumnParallelConv)}
    plain = copy.deepcopy(module, memo)
    return _swap(plain, lambda c: c.gathered(), lambda m: isinstance(m, ColumnParallelConv))


def _is_block(name: str, module: torch.nn.Module) -> bool:
    owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
    return isinstance(owner, ColumnParallelConv)


def tp_shardings(module: torch.nn.Module, axis: str = "model"):
    """``{name: spec}`` of a channel-sharded module's parameters as the port
    stores them: a :class:`ColumnParallelConv`'s weight and bias sharded on
    their output-channel axis 0 over ``axis`` (their full shape is ``n``
    times the block's), everything else replicated (``()``)."""
    return {k: ((axis,) + (None,) * (p.dim() - 1) if _is_block(k, module) else ())
            for k, p in module.named_parameters()}


class TensorParallelLayout:
    """A train state's module channel-sharded over a mesh's ``model_axis``
    (:func:`shard_channels` with :class:`MeshChannels`), and what a step
    and a checkpoint need of it."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh, model_axis: str = "model",
                 data_axis: str = "data"):
        self.mesh, self.model_axis, self.data_axis = mesh, model_axis, data_axis
        self.channels = MeshChannels(mesh, model_axis)
        shard_channels(module, self.channels)
        self.sharded = {k for k in dict(module.named_parameters()) if _is_block(k, module)}

    def block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor of parameter ``name`` (the
        tensor itself where the parameter is replicated)."""
        if name not in self.sharded or t.dim() == 0:
            return t.clone()
        c = t.shape[0] // self.channels.n
        return t.narrow(0, self.channels.index * c, c).clone()

    def sync_gradients(self, module: torch.nn.Module, mean: bool):
        """Every gradient summed (or averaged) over the data axis in one
        all-reduce; then the replicated parameters' gradients averaged over
        the model axis in one more, so that rounding-level differences
        between the model ranks' backward (the card's atomics, ROADMAP F4)
        cannot split the replicated state."""
        from pdc_tpu_torch.parallel.sharded_train import _sync_gradients

        _sync_gradients(module, self.mesh, self.data_axis, mean)
        replicated = [p for k, p in module.named_parameters()
                      if k not in self.sharded and p.grad is not None]
        if not replicated or self.mesh.group(self.model_axis) is None:
            return
        flat = self.mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in replicated]),
                                    self.model_axis, mean=True)
        offset = 0
        for p in replicated:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()

    def gathered(self, module: torch.nn.Module, optimizer):
        """``(plain module, optimizer-like)``: the whole network
        (:func:`unshard_channels`) and an object with the ``state`` of an
        optimizer over its parameters, every sharded moment all-gathered
        (what a checkpoint writes). A collective over the model axis."""
        plain = unshard_channels(module)
        full = dict(plain.named_parameters())
        state = {}
        for name, p in module.named_parameters():
            st = optimizer.state.get(p, {})
            if not st:
                continue
            state[full[name]] = {
                k: (self.channels.gather([v]) if name in self.sharded and torch.is_tensor(v)
                    and v.dim() > 0 else v) for k, v in st.items()}
        return plain, SimpleNamespace(state=state)

    def state_bytes(self, module: torch.nn.Module, optimizer) -> int:
        """Bytes this rank stores of the parameters and the optimizer's
        tensors of the same shape (Adam's moments)."""
        total = 0
        for p in module.parameters():
            total += p.numel() * p.element_size()
            for v in optimizer.state.get(p, {}).values():
                if torch.is_tensor(v) and v.shape == p.shape:
                    total += v.numel() * v.element_size()
        return total


def to_tp_state(state, mesh: Mesh, model_axis: str = "model", data_axis: str = "data"):
    """Switch a replicated :class:`~pdc_tpu_torch.training.train.TrainState`
    to the channel-sharded layout in place: ``state.tp`` becomes its
    :class:`TensorParallelLayout` (the module's convolutions swapped), and
    ``state.optimizer`` an optimizer of the same class and settings over the
    sharded module, with this rank's blocks of any moments it had. Returns
    ``state``."""
    if getattr(state, "tp", None) is not None:
        return state
    held = {k: state.optimizer.state.get(p, {}) for k, p in state.module.named_parameters()}
    layout = TensorParallelLayout(state.module, mesh, model_axis, data_axis)
    optimizer = type(state.optimizer)(state.module.parameters(), **state.optimizer.defaults)
    for name, p in state.module.named_parameters():
        if held[name]:
            optimizer.state[p] = {k: layout.block(name, v) if torch.is_tensor(v) else v
                                  for k, v in held[name].items()}
    state.optimizer, state.tp = optimizer, layout
    return state


def make_tp_inference(module: torch.nn.Module, mesh: Mesh, model_axis: str = "model",
                      data_axis: Optional[str] = None, normalize: bool = False):
    """Descriptor inference with the convolutions' output channels sharded
    over ``model_axis`` (and, given ``data_axis``, the image batch split over
    it).

    :return: ``build(state_dict=None) -> (fwd, sharded_module)``: ``build``
        shards a copy of ``module`` (with ``state_dict`` loaded, when given)
        once, on this rank's device; ``fwd(sharded_module, imgs [B, 3, H,
        W]) -> [B, D, H, W]`` float32 in eval mode, the whole batch on
        every rank (with a data axis each rank forwards its block, the
        batch padded with copies of its last image to split evenly, and the
        blocks are all-gathered)
    """

    def build(state_dict=None):
        sharded = copy.deepcopy(module)
        if state_dict is not None:
            sharded.load_state_dict(state_dict)
        sharded = shard_channels(sharded.to(mesh.device), MeshChannels(mesh, model_axis)).eval()

        def fwd(m: torch.nn.Module, imgs: torch.Tensor) -> torch.Tensor:
            B = imgs.shape[0]
            if data_axis is not None:
                pad = (-B) % mesh.shape[data_axis]
                if pad:
                    imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
                imgs = shard_leading(imgs, mesh, data_axis)
            with torch.no_grad():
                out = m(imgs.to(mesh.device)).to(torch.float32)
            if normalize:
                out = out / torch.clamp(torch.linalg.vector_norm(out, dim=1, keepdim=True),
                                        min=1e-12)
            return out if data_axis is None else mesh.all_gather(out, data_axis)[:B]

        return fwd, sharded

    return build


def make_tp_train_step(training_config: dict, loss_cfg, assembler_cfg, image_width: int,
                       mesh: Mesh, state, data_axis: str = "data", model_axis: str = "model"):
    """The DP x TP step on a ``(data, model)`` mesh: the global-batch step
    of :func:`~pdc_tpu_torch.parallel.sharded_train.make_sharded_train_step`
    (pairs split over ``data``: BatchNorm's statistics, the loss's
    denominators and the gradients reduced over it) with the state
    channel-sharded over ``model`` (:func:`to_tp_state`): each rank owns
    1/n of every sharded convolution's output channels and their moments;
    the replicated parameters' gradients are also averaged over ``model``.
    Returns ``(step, state)``; the state is switched in place."""
    from pdc_tpu_torch.parallel.sharded_train import make_sharded_train_step

    state = to_tp_state(state, mesh, model_axis, data_axis)
    return make_sharded_train_step(training_config, loss_cfg, assembler_cfg, image_width, mesh,
                                   data_axis=data_axis), state
