"""Weight bridge between the JAX package's flax variables and the port's
``state_dict``.

The port's modules carry the flax module names (``stem_conv``, ``stem_bn``,
``stage{s}_block{b}/{conv1,bn1,conv2,bn2,proj_conv,proj_bn}``, ``head``), so
the mapping is per leaf only:

  * conv ``kernel`` HWIO <-> ``weight`` OIHW, conv ``bias`` <-> ``bias``
  * BatchNorm params ``scale``/``bias`` <-> ``weight``/``bias`` and
    ``batch_stats`` ``mean``/``var`` <-> ``running_mean``/``running_var``
    (torch's ``num_batches_tracked`` has no flax counterpart: 0 on the way
    in, dropped on the way out)

Both directions copy values unchanged (transposes only), so a round trip
is bit-exact. ``pdc_tpu/models/torch_import.py:26-100`` is the same mapping
for torchvision names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _hwio_to_oihw(k):
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _oihw_to_hwio(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` (numpy or array-like leaves)
    -> ``state_dict`` of CPU tensors for the port's module."""
    sd: Dict[str, torch.Tensor] = {}

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True))

    def walk(prefix, params, stats):
        if "kernel" in params:  # convolution
            sd[prefix + "weight"] = torch.from_numpy(_hwio_to_oihw(params["kernel"]))
            if "bias" in params:
                sd[prefix + "bias"] = tensor(params["bias"])
            extra = set(params) - {"kernel", "bias"}
        elif "scale" in params:  # batch norm
            sd[prefix + "weight"] = tensor(params["scale"])
            sd[prefix + "bias"] = tensor(params["bias"])
            sd[prefix + "running_mean"] = tensor(stats["mean"])
            sd[prefix + "running_var"] = tensor(stats["var"])
            sd[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
            extra = set(params) - {"scale", "bias"}
        else:
            for name, child in params.items():
                if not isinstance(child, Mapping):
                    raise ValueError(f"unexpected flax leaf {prefix + name}")
                walk(prefix + name + ".", child, stats.get(name, {}))
            return
        if extra:
            raise ValueError(f"unexpected flax leaves under {prefix}: {sorted(extra)}")

    walk("", variables["params"], variables.get("batch_stats", {}))
    return sd


def state_dict_to_flax(state_dict: Mapping) -> Dict[str, dict]:
    """The port's ``state_dict`` -> ``{'params': ..., 'batch_stats': ...}``
    of numpy arrays, nested and ordered as flax's ``module.init`` builds it."""
    params: dict = {}
    stats: dict = {}

    def node(tree, path):
        for name in path:
            tree = tree.setdefault(name, {})
        return tree

    is_bn = {k.rsplit(".", 1)[0] for k in state_dict if k.endswith(".running_mean")}
    for key, value in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        path = module.split(".")
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if module in is_bn:
            if leaf == "weight":
                node(params, path)["scale"] = np.array(arr, copy=True)
            elif leaf == "bias":
                node(params, path)["bias"] = np.array(arr, copy=True)
            elif leaf == "running_mean":
                node(stats, path)["mean"] = np.array(arr, copy=True)
            elif leaf == "running_var":
                node(stats, path)["var"] = np.array(arr, copy=True)
            elif leaf != "num_batches_tracked":
                raise ValueError(f"unexpected batch-norm entry {key}")
        elif leaf == "weight" and arr.ndim == 4:
            node(params, path)["kernel"] = _oihw_to_hwio(arr)
        elif leaf == "bias":
            node(params, path)["bias"] = np.array(arr, copy=True)
        else:
            raise ValueError(f"unexpected state_dict entry {key}")
    return {"params": params, "batch_stats": stats}
