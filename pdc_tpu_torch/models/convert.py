"""Weight and optimizer-state bridge between the JAX package's flax trees and
the port's ``state_dict`` and ``torch.optim.Adam``.

The port's modules carry the flax module names (the ResNets' ``stem_conv``,
``stem_bn``, ``stage{s}_block{b}/{conv1,bn1,conv2,bn2,conv3,bn3,proj_conv,
proj_bn}``, ``head``; the UNet's ``down{l}``, ``bottleneck``, ``up_proj{l}``,
``up{l}`` with ``conv{i}``/``bn{i}``, ``head``), so the mapping is per leaf
only:

  * conv ``kernel`` HWIO <-> ``weight`` OIHW, conv ``bias`` <-> ``bias``
  * BatchNorm params ``scale``/``bias`` <-> ``weight``/``bias`` and
    ``batch_stats`` ``mean``/``var`` <-> ``running_mean``/``running_var``
    (torch's ``num_batches_tracked`` has no flax counterpart: 0 on the way
    in, dropped on the way out)
  * the ``quant_scales`` collection's ``act_scale`` (a static int8 clone's
    calibrated activation scales) <-> the convolutions' ``act_scale``
    buffers
  * the ViT's (:mod:`pdc_tpu_torch.models.dinov2`, which the JAX package
    lacks, so the layout is the port's): a linear ``kernel`` ``[in, out]``
    <-> ``weight`` ``[out, in]``, a LayerNorm's ``scale``/``bias`` <->
    ``weight``/``bias`` (no ``batch_stats``), and its parameters of no
    layer (``cls_token``, ``register_tokens``, ``pos_embed``,
    ``blocks.{i}.ls{1,2}.gamma``) under their own names

The optimizer state of a ``%06d.ckpt.opt`` file is optax's chain state for
``add_decayed_weights``, ``scale_by_adam`` and ``scale_by_learning_rate``
(``pdc_tpu/training/train.py:56-66``), as flax writes it:
``{'0': {}, '1': {'count', 'mu', 'nu'}, '2': {'count'}}``, where ``mu`` and
``nu`` are trees of the parameters' layout and the counts int32 scalars.
``mu``/``nu`` map to Adam's per-parameter ``exp_avg``/``exp_avg_sq`` by the
parameters' own mapping, Adam's ``count`` to its ``step``; the schedule's
count is the number of steps taken since the LR schedule last started.

Every direction copies values unchanged (transposes only), so a round trip
is bit-exact. ``pdc_tpu/models/torch_import.py:26-100`` is the same mapping
for torchvision names (:mod:`pdc_tpu_torch.models.torch_import`).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

# the ViT's parameters that belong to no layer (pdc_tpu_torch.models.dinov2)
_FREE_LEAF = re.compile(r"cls_token|register_tokens|pos_embed|blocks\.\d+\.ls[12]\.gamma")


def _hwio_to_oihw(k):
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _oihw_to_hwio(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _tensor(a):
    return torch.from_numpy(np.array(a, copy=True))


def _numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def flax_params_to_torch(params: Mapping) -> Tuple[Dict[str, torch.Tensor], set]:
    """A flax ``params`` tree (or a tree of its layout, such as Adam's
    ``mu``) -> ``({parameter name: CPU tensor}, names of the BatchNorm and
    LayerNorm modules)``, named as the port module's ``named_parameters``."""
    out: Dict[str, torch.Tensor] = {}
    bn: set = set()

    def walk(prefix, node):
        if "kernel" in node:  # convolution, or linear layer
            kernel = np.asarray(node["kernel"])
            out[prefix + "weight"] = (_tensor(kernel.T) if kernel.ndim == 2
                                      else torch.from_numpy(_hwio_to_oihw(kernel)))
            if "bias" in node:
                out[prefix + "bias"] = _tensor(node["bias"])
            extra = set(node) - {"kernel", "bias"}
        elif "scale" in node:  # batch norm, or layer norm
            out[prefix + "weight"] = _tensor(node["scale"])
            out[prefix + "bias"] = _tensor(node["bias"])
            bn.add(prefix[:-1])
            extra = set(node) - {"scale", "bias"}
        else:
            for name, child in node.items():
                if isinstance(child, Mapping):
                    walk(prefix + name + ".", child)
                elif _FREE_LEAF.fullmatch(prefix + name):
                    out[prefix + name] = _tensor(child)
                else:
                    raise ValueError(f"unexpected flax leaf {prefix + name}")
            return
        if extra:
            raise ValueError(f"unexpected flax leaves under {prefix}: {sorted(extra)}")

    walk("", params)
    return out, bn


def torch_params_to_flax(named: Mapping, bn_modules: Iterable[str]) -> dict:
    """``{parameter name: tensor}`` -> a flax ``params`` tree of numpy
    arrays; ``bn_modules`` names the BatchNorm modules, whose ``weight`` is
    flax's ``scale``."""
    bn_modules = set(bn_modules)
    params: dict = {}
    for key, value in named.items():
        module, _, leaf = key.rpartition(".")
        node = params
        for name in module.split(".") if module else ():
            node = node.setdefault(name, {})
        arr = _numpy(value)
        if module in bn_modules and leaf in ("weight", "bias"):
            node["scale" if leaf == "weight" else "bias"] = np.array(arr, copy=True)
        elif leaf == "weight" and arr.ndim == 4:
            node["kernel"] = _oihw_to_hwio(arr)
        elif leaf == "weight" and arr.ndim == 2:  # linear
            node["kernel"] = np.ascontiguousarray(arr.T)
        elif leaf == "weight" and arr.ndim == 1:  # layer norm
            node["scale"] = np.array(arr, copy=True)
        elif leaf == "bias":
            node["bias"] = np.array(arr, copy=True)
        elif _FREE_LEAF.fullmatch(key):
            node[leaf] = np.array(arr, copy=True)
        else:
            raise ValueError(f"unexpected parameter {key}")
    return params


def quant_scales_to_torch(scales: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``quant_scales`` tree -> ``{'<conv>.act_scale': 0-d tensor}``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(prefix + name + ".", child)
            elif name == "act_scale":
                out[prefix + name] = _tensor(child)
            else:
                raise ValueError(f"unexpected quant_scales leaf {prefix + name}")

    walk("", scales)
    return out


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ..., ['quant_scales': ...]}`` (numpy
    or array-like leaves) -> ``state_dict`` of CPU tensors for the port's
    module."""
    unknown = set(variables) - {"params", "batch_stats", "quant_scales"}
    if unknown:
        raise ValueError(f"unexpected flax collections {sorted(unknown)}")
    sd, bn = flax_params_to_torch(variables["params"])
    stats = variables.get("batch_stats", {})
    for module in sorted(bn):
        node = stats
        for name in module.split("."):
            node = node.get(name, {})
        if not node:  # a layer norm, which has no statistics
            continue
        sd[module + ".running_mean"] = _tensor(node["mean"])
        sd[module + ".running_var"] = _tensor(node["var"])
        sd[module + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    sd.update(quant_scales_to_torch(variables.get("quant_scales", {})))
    return sd


def state_dict_to_flax(state_dict: Mapping) -> Dict[str, dict]:
    """The port's ``state_dict`` -> ``{'params': ..., 'batch_stats': ...}``
    of numpy arrays, nested and ordered as flax's ``module.init`` builds it,
    plus ``quant_scales`` where the module holds calibrated scales."""
    is_bn = {k.rsplit(".", 1)[0] for k in state_dict if k.endswith(".running_mean")}
    named, stats, scales = {}, {}, {}
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if leaf == "act_scale":
            node = scales
            for name in module.split("."):
                node = node.setdefault(name, {})
            node[leaf] = np.array(_numpy(value), copy=True)
        elif module in is_bn and leaf in ("running_mean", "running_var"):
            node = stats
            for name in module.split("."):
                node = node.setdefault(name, {})
            node["mean" if leaf == "running_mean" else "var"] = np.array(_numpy(value), copy=True)
        elif module in is_bn and leaf not in ("weight", "bias", "num_batches_tracked"):
            raise ValueError(f"unexpected batch-norm entry {key}")
        elif leaf != "num_batches_tracked":
            named[key] = value
    out = {"params": torch_params_to_flax(named, is_bn), "batch_stats": stats}
    if scales:
        out["quant_scales"] = scales
    return out


# -- Adam state ---------------------------------------------------------------


def _bn_modules(module: torch.nn.Module) -> set:
    return {name for name, m in module.named_modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}


def adam_state_to_flax(module: torch.nn.Module, optimizer: torch.optim.Adam,
                       schedule_count: int) -> dict:
    """The live Adam state of ``module``'s parameters as optax's chain state
    (the tree a ``.ckpt.opt`` holds). A parameter that has no state yet
    (no step taken) gets zero moments. All parameters with state must have
    taken the same number of steps, optax's single ``count``."""
    named = dict(module.named_parameters())
    mu, nu, steps = {}, {}, set()
    for name, p in named.items():
        st = optimizer.state.get(p, {})
        if "exp_avg" in st:
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
            steps.add(int(st["step"]))
        else:
            mu[name] = nu[name] = torch.zeros_like(p)
    if len(steps) > 1:
        raise ValueError(f"parameters have taken different numbers of Adam steps: {steps}")
    count = steps.pop() if steps else 0
    bn = _bn_modules(module)
    return {"0": {},
            "1": {"count": np.array(count, np.int32), "mu": torch_params_to_flax(mu, bn),
                  "nu": torch_params_to_flax(nu, bn)},
            "2": {"count": np.array(schedule_count, np.int32)}}


def load_adam_state_from_flax(module: torch.nn.Module, optimizer: torch.optim.Adam,
                              tree: Mapping) -> Tuple[int, int]:
    """Set ``optimizer``'s state for ``module``'s parameters from optax's
    chain state (as :func:`adam_state_to_flax` writes it, or ``pdc_tpu``).
    Returns ``(Adam's count, the schedule's count)``."""
    adam = tree["1"]
    count = int(np.asarray(adam["count"]))
    mu, _ = flax_params_to_torch(adam["mu"])
    nu, _ = flax_params_to_torch(adam["nu"])
    named = dict(module.named_parameters())
    if set(mu) != set(named) or set(nu) != set(named):
        raise ValueError("optimizer state does not match the module's parameters: "
                         f"{sorted(set(mu) ^ set(named))[:5]}")
    # a capturable Adam keeps its counts on the parameters' device
    on_device = bool(optimizer.defaults.get("capturable"))
    for name, p in named.items():
        if mu[name].shape != p.shape:
            raise ValueError(f"{name}: moment of shape {tuple(mu[name].shape)}, "
                             f"parameter {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if on_device else None),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype),
        }
    return count, int(np.asarray(tree["2"]["count"]))
