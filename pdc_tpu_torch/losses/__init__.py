"""Contrastive losses (port of :mod:`pdc_tpu.losses`)."""

from pdc_tpu_torch.losses.composer import (  # noqa: F401
    MATCH_TYPE_DIFFERENT_OBJECT,
    MATCH_TYPE_EMPTY,
    MATCH_TYPE_MULTI_OBJECT,
    MATCH_TYPE_SINGLE_OBJECT_ACROSS_SCENE,
    MATCH_TYPE_SINGLE_OBJECT_WITHIN_SCENE,
    MATCH_TYPE_SYNTHETIC_MULTI_OBJECT,
    compose_loss,
)
from pdc_tpu_torch.losses.pixelwise_contrastive import (  # noqa: F401
    LossConfig,
    match_loss,
    non_match_descriptor_loss,
    non_match_loss_descriptor_only,
    non_match_loss_with_l2_pixel_norm,
    triplet_loss,
)
