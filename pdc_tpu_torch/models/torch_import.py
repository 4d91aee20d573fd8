"""ImageNet initialisation from torchvision ResNet weights, and the import of
networks trained by the reference framework.

Port of :mod:`pdc_tpu.models.torch_import`: ``convert_torchvision_resnet``
(:31-100), ``resolve_pretrained_weights`` (:112-155),
``maybe_load_pretrained_backbone`` (:158-174), ``convert_reference_dcn`` and
``load_reference_checkpoint`` (:177-240). A torchvision-layout state
dict (``conv1.weight``, ``bn1.*``, ``layer{L}.{B}.{conv,bn}{N}.*``,
``layer{L}.{B}.downsample.{0,1}.*``) maps onto the port's
:class:`~pdc_tpu_torch.models.resnet.ResNetFCN` names (``stem_conv``,
``stem_bn``, ``stage{L}_block{B}.{conv,bn}{N}``, ``proj_conv``/``proj_bn``);
the descriptor head has no torchvision counterpart and keeps its
initialisation, except in a reference-trained checkpoint, whose ``fc`` 1x1
convolution is the head. Nothing is ever downloaded: the weights are a local
``.pth`` file.
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


def convert_reference_dcn(state_dict: Mapping, target: Mapping) -> Dict[str, torch.Tensor]:
    """A new ``state_dict`` for the port's module from a checkpoint trained by
    the reference framework (its ``%06d.pth``, ``torch.save(dcn.state_dict())``).

    Key layouts: new style ``fcn.resnet34_8s.<torchvision name>``, old style
    ``resnet34_8s.<torchvision name>`` (any ``resnet<N>_<k>s`` wrapper), each
    with or without a ``module.`` (DataParallel) prefix. The ``fc`` 1x1
    convolution becomes the descriptor head (``head``, OIHW as torch keeps
    it); the rest goes through :func:`convert_torchvision_resnet`.

    :raises ValueError: keys that are not a reference DCN's, or a head of
        another shape than the module's
    """
    sd = dict(state_dict)

    def strip(prefix):
        nonlocal sd
        if all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}

    strip("module.")
    strip("fcn.")
    heads = {k.split(".", 1)[0] for k in sd}
    if len(heads) == 1 and re.fullmatch(r"resnet\d+_\d+s", next(iter(heads))):
        strip(next(iter(heads)) + ".")
    if "conv1.weight" not in sd:
        raise ValueError("state dict does not look like a reference DCN checkpoint (keys start "
                         f"with {sorted({k.split('.', 1)[0] for k in sd})[:5]})")
    fc = {leaf: sd.pop(f"fc.{leaf}") for leaf in ("weight", "bias") if f"fc.{leaf}" in sd}
    out = convert_torchvision_resnet(sd, target)
    for leaf, value in fc.items():
        value = torch.as_tensor(value)
        name = f"head.{leaf}"
        if tuple(value.shape) != tuple(out[name].shape):
            raise ValueError(f"fc.{leaf}: shape {tuple(value.shape)}, module's {name} "
                             f"{tuple(out[name].shape)}")
        out[name] = value.detach().to(dtype=out[name].dtype, device=out[name].device).clone()
    return out


def load_reference_checkpoint(dcn, pth_path: str):
    """Load a reference-trained ``%06d.pth`` into ``dcn``
    (:class:`~pdc_tpu_torch.models.dcn.DenseCorrespondenceNetwork`) in
    place; returns ``dcn``."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    dcn.module.load_state_dict(convert_reference_dcn(sd, dcn.module.state_dict()), strict=True)
    return dcn
