"""Descriptor-row gather with a float32-accumulating backward.

Port of :func:`pdc_tpu.ops.scatter_free.take_rows` (:37-90). The losses
gather tens of thousands of descriptor rows per image pair from the
flattened ``[HW, D]`` prediction. In the JAX package the backward of that
gather is a one-hot matmul on the MXU (a scatter-add is slow on a TPU) whose
numerics are part of the contract:

  * under a bfloat16 prediction the cotangent is rounded to bfloat16, the
    rows that land on one pixel are summed in float32, and the dense
    cotangent is returned in bfloat16;
  * under float32 it is the gather's own backward, a float32 sum.

Here the backward is ``index_add_`` of the rows into a float32 table, which
computes the same sums on any device (their order differs, so a sum may
differ in its last float32 bit). A plain ``index_select`` of a bfloat16
prediction followed by ``.float()`` would accumulate repeated pixels in
bfloat16 instead. The JAX package runs this outside any Pallas kernel, so
it is torch operations here, not a kernel.
"""

from __future__ import annotations

import torch


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image_pred, idx):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = image_pred.shape, image_pred.dtype
        return image_pred.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows = g.to(ctx.dtype).to(torch.float32)  # the cotangent rounded to the prediction's dtype
        dense = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        dense.index_add_(0, idx, rows)
        return dense.to(ctx.dtype), None


def take_rows(image_pred: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``image_pred.index_select(0, idx)`` with the backward of the module
    docstring.

    :param image_pred: ``[HW, D]``, any float dtype
    :param idx: ``[N]`` int64, in range (callers send invalid entries to 0
        and mask their terms)
    :return: ``[N, D]`` rows in ``image_pred``'s dtype
    """
    return _TakeRows.apply(image_pred, idx)
