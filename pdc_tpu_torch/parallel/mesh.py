"""The port's device mesh over ``torch.distributed``.

Port of :mod:`pdc_tpu.parallel.mesh` (:19-57). The JAX package runs one
program over a ``jax.sharding.Mesh`` of devices; the port runs one process
per device, the same code on every rank, and a :class:`Mesh` names that
world's axes: the size of each axis, this rank's index on it, its device
and the process group of the ranks that differ from it only on that axis.
Collectives over an axis go through the mesh (:meth:`Mesh.all_reduce`,
:meth:`Mesh.all_gather`, :meth:`Mesh.reduce_scatter`); without a process
group they return their input, so single-process code runs unchanged,
while a world of one initialised process runs them (NCCL on a card).

``data_sharding`` and ``replicated`` become :func:`shard_leading` (this
rank's block of a tensor's leading axis) and :func:`replicated` (the tensor
on this rank's device, whole). ``get_shard_map`` has no counterpart: a
rank's code is already the per-shard program that ``shard_map`` traces.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pdc_tpu_torch.utils.device import resolve_device


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the gradient over the group:
    each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class Mesh:
    """Axes over the ranks of the process group (row-major: the last axis
    varies fastest with the rank, as ``np.reshape`` lays out a JAX mesh's
    devices)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int,
                 device: torch.device, groups: Dict[str, object]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = int(rank)
        self.index = dict(zip(self.axis_names,
                              (int(i) for i in np.unravel_index(rank, tuple(shape)))))
        self.device = device
        self._groups = groups

    def peer(self, axis: str, index: int) -> int:
        """The global rank that differs from this one only on ``axis``,
        where it is at ``index`` (the source or destination of a
        point-to-point send along the axis)."""
        coords = [index if a == axis else self.index[a] for a in self.axis_names]
        return int(np.ravel_multi_index(coords, tuple(self.shape.values())))

    def group(self, axis: str = "data"):
        """The process group of ``axis``: None where no collective is needed
        (an axis of size 1 beside larger ones, or no process group at all);
        a world of one initialised process keeps its group, so its
        collectives run (through NCCL on a card)."""
        return self._groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: str = "data", mean: bool = False,
                   differentiable: bool = False) -> torch.Tensor:
        """The sum (or mean) of ``t`` over ``axis``, as a new tensor; with
        ``differentiable`` the backward sums the gradient over the axis."""
        n, g = self.shape[axis], self._groups[axis]
        if g is None:
            return t.clone()
        if differentiable:
            out = _AllReduceSum.apply(t, g)
        else:
            out = t.detach().clone()
            dist.all_reduce(out, group=g)
        return out / n if mean else out

    def all_gather(self, t: torch.Tensor, axis: str = "data", dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (all of one shape) concatenated along ``dim``
        in rank order: the tiled all-gather."""
        n, g = self.shape[axis], self._groups[axis]
        if g is None:
            return t.clone()
        src = t.detach().contiguous()
        cast = src.dtype in (torch.bool, torch.int16, torch.uint16)  # not every backend has these
        if cast:
            src = src.to(torch.int32)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=g)
        out = torch.cat(parts, dim=dim)
        return out.to(t.dtype) if cast else out

    def reduce_scatter(self, t: torch.Tensor, axis: str = "data", dim: int = 0,
                       mean: bool = False) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum (or mean) of ``t``
        over ``axis``; ``t.shape[dim]`` must be divisible by the axis
        size."""
        n, g = self.shape[axis], self._groups[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split into {n}")
        if g is None:
            out = t.detach().clone()
        else:
            src = t.detach().movedim(dim, 0).contiguous()
            out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                              device=src.device)
            # reduce_scatter_single is the newer name of reduce_scatter_tensor
            getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, src, group=g)
            out = out.movedim(0, dim)
        return out / n if mean else out

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank} at {self.index}, "
                f"device {self.device})")


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """The mesh of the initialised process group (a world of one process
    when none is initialised).

    With the default single axis every rank goes to data parallelism; pass
    ``shape`` (its product the world size) for several axes. ``device`` is
    this rank's device, by default the one
    :func:`~pdc_tpu_torch.parallel.distributed.ensure_initialized` bound it
    to (``cuda:LOCAL_RANK``, or ``"cpu"`` on a gloo group). Every rank must
    call this in the same order: it creates the axes' process groups.
    """
    from pdc_tpu_torch.parallel import distributed

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("give an explicit shape for multi-axis meshes")
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} does not cover "
                         f"the {world} ranks")
    if device is None:
        device = distributed.bound_device()
    device = resolve_device(device)
    ranks = np.arange(world).reshape(shape)
    groups = {}
    for a, name in enumerate(axis_names):
        if world == 1:
            groups[name] = dist.group.WORLD if dist.is_initialized() else None
            continue
        if shape[a] == 1:
            groups[name] = None
            continue
        if len(shape) == 1:
            groups[name] = dist.group.WORLD
            continue
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for coords in itertools.product(*others):
            idx = list(coords)
            idx.insert(a, slice(None))
            members = [int(r) for r in ranks[tuple(idx)]]
            g = dist.new_group(members)  # every rank creates every group
            if rank in members:
                groups[name] = g
    return Mesh(axis_names, shape, rank, device, groups)


def shard_leading(x, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis, on its device
    (the port's ``data_sharding``); the axis must divide evenly, as a JAX
    ``P("data")`` placement requires."""
    t = torch.as_tensor(x)
    n, i = mesh.shape[axis], mesh.index[axis]
    if t.shape[0] % n:
        raise ValueError(f"leading axis {t.shape[0]} does not split over {n} ranks")
    b = t.shape[0] // n
    return t[i * b:(i + 1) * b].to(mesh.device)


def replicated(x, mesh: Mesh) -> torch.Tensor:
    """``x`` whole on this rank's device (the port's ``replicated``)."""
    return torch.as_tensor(x).to(mesh.device)


def block_range(total: int, mesh: Mesh, axis: str = "data"):
    """``(start, stop)`` of this rank's contiguous block when ``total``
    items are split over ``axis`` in blocks of ``ceil(total / n)``: the last
    blocks are shorter, or empty, where ``n`` does not divide ``total``."""
    n, i = mesh.shape[axis], mesh.index[axis]
    chunk = -(-total // n)
    return min(i * chunk, total), min((i + 1) * chunk, total)


def padded_block(items: list, mesh: Mesh, axis: str = "data") -> list:
    """This rank's contiguous block of ``items`` padded to a multiple of the
    ranks with copies of its last item, as the JAX package pads a sharded
    axis (drop the padding after gathering the blocks)."""
    padded = items + items[-1:] * ((-len(items)) % mesh.shape[axis])
    return padded[slice(*block_range(len(padded), mesh, axis))]
