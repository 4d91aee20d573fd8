"""Sample-type codes and the per-sample loss terms.

Port of the constants and ``LossTerms`` of :mod:`pdc_tpu.losses.composer`
(:36-71). The codes match the reference's ``SpartanDatasetDataType``:

    0 SINGLE_OBJECT_WITHIN_SCENE   matches + masked + background + blind
    1 SINGLE_OBJECT_ACROSS_SCENE   inverted blind hinge (same-object pull)
    2 DIFFERENT_OBJECT             blind repulsion only
    3 MULTI_OBJECT                 same as 0
    4 SYNTHETIC_MULTI_OBJECT       same as 0
   -1 EMPTY                        contributes zero loss

``compose_loss`` (the per-pair path behind ``use_matrix_loss: false``)
waits for the per-pair loss slice; the matrix form is
:func:`pdc_tpu_torch.losses.matrix_loss.compose_loss_matrix`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE = 0
MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE = 1
MATCH_TYPE_DIFFERENT_OBJECT = 2
MATCH_TYPE_MULTI_OBJECT = 3
MATCH_TYPE_SYNTHETIC_MULTI_OBJECT = 4
MATCH_TYPE_EMPTY = -1


class LossTerms(NamedTuple):
    """Per-sample loss terms, each ``[B]``."""

    loss: torch.Tensor
    match_loss: torch.Tensor
    masked_non_match_loss: torch.Tensor
    background_non_match_loss: torch.Tensor
    blind_non_match_loss: torch.Tensor
