"""Launch counts of the port's hand-written kernels, CUDA graphs included.

Each kernel family keeps its counts as plain integers on its own module
(``pooled_hinge.forward_launches``, ``flash_attention.backward_launches``,
...), so that a run can show that its main path went through the kernels.
A family counts a pass with :func:`count` (a kernel launch) or
:func:`record` (a plain pass on CPU tensors, recorded but not a launch).

A CUDA graph launches nothing at its capture and everything at each replay.
So inside :func:`recording` every pass is recorded, and a launch made while
a stream captures is recorded only; whoever replays the graph adds what was
recorded to the counters, once per replay (:func:`count_replays`). A kernel
captured outside :func:`recording` raises: its replays would go uncounted.
"""

from __future__ import annotations

import collections
import contextlib
import sys

import torch

# the passes recorded by recording(), or None outside it
_recorded = None


@contextlib.contextmanager
def recording():
    """Yields a ``Counter`` of ``(module name, kind)``: the passes that the
    kernel families made in the block (``kind`` is a family's pass, e.g.
    ``"forward"``)."""
    global _recorded
    outer, _recorded = _recorded, collections.Counter()
    try:
        yield _recorded
    finally:
        _recorded = outer


def record(module: str, kind: str):
    """Record one pass of ``kind`` of the family in ``module`` (inside
    :func:`recording`; a no-op outside)."""
    if _recorded is not None:
        _recorded[(module, kind)] += 1


def count(module: str, kind: str):
    """Count one kernel launch: ``<kind>_launches`` of ``module`` grows by
    one, or, while a stream captures, the launch is only recorded."""
    record(module, kind)
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        if _recorded is None:
            raise RuntimeError(f"{module} was captured into a CUDA graph outside "
                               "launches.recording(): its replays would go uncounted")
    else:
        _add(module, kind, 1)


def count_replays(recorded, replays: int = 1):
    """Add the passes that :func:`recording` recorded at a graph's capture,
    ``replays`` times, to the families' counters."""
    for (module, kind), n in recorded.items():
        _add(module, kind, n * replays)


def passes(recorded, module: str, kinds=("forward", "backward")) -> dict:
    """``{kind: passes}`` of one family in what :func:`recording` yielded,
    0 for a kind it did not make."""
    return {kind: recorded[(module, kind)] for kind in kinds}


def _add(module: str, kind: str, n: int):
    owner = sys.modules[module]
    name = f"{kind}_launches"
    setattr(owner, name, getattr(owner, name) + n)
