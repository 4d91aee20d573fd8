"""Device selection shared by the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``, refusing CUDA where there is none.

    Entry points default to ``"cuda"``; on a host without a CUDA card the
    caller must ask for ``"cpu"`` explicitly — the port never falls back to
    the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # usable by autograd, whatever mode made it first
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant tensor of ``values`` on ``device``, made once and then
    reused: a CUDA graph cannot capture the copy from host memory that
    making it anew would take. Callers must not write into it."""
    return _constant(tuple(values), dtype, torch.device(device))
