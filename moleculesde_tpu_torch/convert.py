"""Carry weights between the JAX package and the port, and the port's own
checkpoint format.

:func:`load_flax_variables` loads a flax variable tree — ``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays — into a port module.
The port keeps the flax names and shapes (kernels ``[in, out]``), so the
path ``params/GINConv_0/Dense_0/kernel`` is the state-dict key
``GINConv_0.Dense_0.kernel`` and ``batch_stats/.../mean`` a buffer.
The JAX package's ``.msgpack`` checkpoints are read without flax by
:mod:`moleculesde_tpu_torch.utils.checkpoints`, whose trees go through
:func:`load_flax_pretrain`.  The pretraining CLI writes the same
four-component tree as a ``.pt`` (:func:`save_checkpoint`), whose
components the sampler CLIs load; they take either file.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``{"params": tree, "batch_stats": tree}`` -> {dotted key: array}."""
    flat: Dict[str, Any] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        else:   # a torch tensor where numpy has no dtype (bfloat16)
            flat[prefix] = node if torch.is_tensor(node) else np.asarray(node)

    for collection in ("params", "batch_stats"):
        walk("", variables.get(collection, {}))
    return flat


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy a flax variable tree into ``module`` in place; every key and
    shape must match."""
    flat = flatten_flax(variables)
    state = module.state_dict()
    missing, unexpected = sorted(set(state) - set(flat)), sorted(set(flat) - set(state))
    if missing or unexpected:
        raise KeyError(f"flax tree does not match {type(module).__name__}: "
                       f"missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for key, value in flat.items():
            target = state[key]
            if tuple(target.shape) != tuple(value.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(target.shape)}")
            value = value if torch.is_tensor(value) else torch.as_tensor(np.array(value))
            target.copy_(value.to(target.dtype))
    return module


def load_flax_pretrain(models: Mapping[str, nn.Module], params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> Mapping[str, nn.Module]:
    """Copy the JAX package's four-component pretraining tree (``params``
    and ``batch_stats`` keyed by ``model_2D``, ``model_3D``,
    ``SDE_2Dto3D_model``, ``SDE_3Dto2D_model``) into the port's modules."""
    for name, module in models.items():
        load_flax_variables(module, {"params": params[name],
                                     "batch_stats": batch_stats.get(name, {})})
    return models


def save_checkpoint(path: str, components: Mapping[str, nn.Module],
                    config: Mapping[str, Any]) -> None:
    """Write the port's ``.pt``: each component's state dict (on the CPU)
    under its name (``model_2D``, ``model_3D``, ``SDE_2Dto3D_model``,
    ``SDE_3Dto2D_model``, as the pretraining checkpoint names them) and the
    ``config`` they were built with."""
    payload = {"config": dict(config)}
    for name, module in components.items():
        payload[name] = {k: v.cpu() for k, v in module.state_dict().items()}
    torch.save(payload, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a ``.pt`` written by :func:`save_checkpoint` (tensors and plain
    values only)."""
    return torch.load(path, map_location="cpu", weights_only=True)
