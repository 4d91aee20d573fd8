"""ImageNet initialisation from torchvision ResNet weights.

Port of :mod:`pdc_tpu.models.torch_import`: ``convert_torchvision_resnet``
(:31-100), ``resolve_pretrained_weights`` (:112-155) and
``maybe_load_pretrained_backbone`` (:158-174). A torchvision-layout state
dict (``conv1.weight``, ``bn1.*``, ``layer{L}.{B}.{conv,bn}{N}.*``,
``layer{L}.{B}.downsample.{0,1}.*``) maps onto the port's
:class:`~pdc_tpu_torch.models.resnet.ResNetFCN` names (``stem_conv``,
``stem_bn``, ``stage{L}_block{B}.{conv,bn}{N}``, ``proj_conv``/``proj_bn``);
the descriptor head has no torchvision counterpart and keeps its
initialisation. Nothing is ever downloaded: the weights are a local
``.pth`` file.

Not ported yet: ``convert_reference_dcn`` and ``load_reference_checkpoint``
(:177-240), the import of checkpoints trained by the reference framework.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Mapping, Optional

import torch

logger = logging.getLogger(__name__)


def _torchvision_to_port(key: str) -> Optional[str]:
    """The port's name for a torchvision backbone entry, or None for one
    outside the backbone (``fc.*``)."""
    m = re.fullmatch(r"(conv1|bn1)\.(\w+)", key)
    if m:
        return {"conv1": "stem_conv", "bn1": "stem_bn"}[m.group(1)] + "." + m.group(2)
    m = re.fullmatch(r"layer(\d+)\.(\d+)\.(.+)", key)
    if not m:
        return None
    rest = m.group(3)
    rest = re.sub(r"^downsample\.0\.", "proj_conv.", rest)
    rest = re.sub(r"^downsample\.1\.", "proj_bn.", rest)
    return f"stage{m.group(1)}_block{m.group(2)}.{rest}"


def convert_torchvision_resnet(state_dict: Mapping, target: Mapping) -> Dict[str, torch.Tensor]:
    """A new ``state_dict`` for the port's module: ``target`` (the module's
    own ``state_dict``) with every backbone entry replaced by the
    torchvision one, copied unchanged (the port keeps torch's OIHW layout).
    BatchNorm's ``num_batches_tracked`` keeps the target's value; entries
    outside the backbone (``fc.*``) are not used.

    :raises ValueError: a backbone entry that the module lacks, or of
        another shape
    """
    out = {k: v.detach().clone() for k, v in target.items()}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        name = _torchvision_to_port(key)
        if name is None:
            continue
        if name not in out:
            raise ValueError(f"torchvision entry {key} has no counterpart {name} in the module")
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(out[name].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, module's {name} "
                             f"{tuple(out[name].shape)}")
        out[name] = value.detach().to(dtype=out[name].dtype, device=out[name].device).clone()
    return out


def resolve_pretrained_weights(net_config: Mapping) -> Optional[str]:
    """The ImageNet-pretrained backbone weights of a
    ``dense_correspondence_network`` config block, looked up in order:

      * ``backbone.pretrained`` a path string -> that file
      * true -> ``$PDC_PRETRAINED_WEIGHTS``, else
        ``~/.cache/pdc_tpu/pretrained/<resnetN>.pth``

    :return: the path, or None when pretraining is not asked for
    :raises FileNotFoundError: pretraining asked for and no file there
    """
    bb = dict(net_config.get("backbone", {}) or {})
    spec = bb.get("pretrained", False)
    if not spec:
        return None
    if isinstance(spec, str):
        if os.path.exists(spec):
            return spec
        raise FileNotFoundError(f"backbone.pretrained points at missing file: {spec}")
    env = os.environ.get("PDC_PRETRAINED_WEIGHTS")
    if env:
        if os.path.exists(env):
            return env
        raise FileNotFoundError(f"$PDC_PRETRAINED_WEIGHTS points at missing file: {env}")
    name = bb.get("resnet_name", "Resnet34_8s").lower()
    m = re.match(r"resnet(\d+)", name)
    base = m.group(0) if m else name
    cand = os.path.join(os.path.expanduser("~"), ".cache", "pdc_tpu", "pretrained",
                        base + ".pth")
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(
        f"backbone.pretrained requested but no weights at {cand}: put the torchvision "
        "ImageNet checkpoint there, or set $PDC_PRETRAINED_WEIGHTS")


def maybe_load_pretrained_backbone(module: torch.nn.Module,
                                   net_config: Mapping) -> torch.nn.Module:
    """Load the ImageNet backbone weights into ``module`` when the config
    asks for them (a no-op otherwise); returns ``module``."""
    path = resolve_pretrained_weights(net_config)
    if path is None:
        return module
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    logger.info("initializing backbone from pretrained weights: %s", path)
    module.load_state_dict(convert_torchvision_resnet(sd, module.state_dict()), strict=True)
    return module
