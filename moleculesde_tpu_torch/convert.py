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
components the sampler CLIs load; they take either file.  The finetunes
load one component's parameters into their encoder
(:func:`load_pretrained_component`) from either file; a flax
``GNNGraphPred`` or ``RegressionModel`` tree loads into the port's with
:func:`load_flax_variables` as any other.
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


def load_pretrained_component(module: nn.Module, path: str, component: str) -> nn.Module:
    """Copy the parameters of one component of a pretraining checkpoint
    (``model_2D`` into a finetune's ``gnn``, ``model_3D`` into its
    ``encoder``) into ``module`` in place, from the port's ``.pt`` or a JAX
    ``.msgpack`` (by suffix).  Only parameters move: running statistics
    keep their initial values, as the JAX finetunes replace only the
    component's ``params`` (``create_classification_state`` and the
    like).  Every parameter name and shape must match."""
    if path.endswith(".msgpack"):
        from moleculesde_tpu_torch.utils.checkpoints import load_pretrain_checkpoint

        params, _ = load_pretrain_checkpoint(path, component)
        if params is None:
            raise KeyError(f"{path} has no component {component}")
        values = flatten_flax({"params": params})
    else:
        ckpt = load_checkpoint(path)
        if component not in ckpt:
            raise KeyError(f"{path} has no component {component}")
        values = ckpt[component]
    named = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    values = {k: v for k, v in values.items() if k not in buffers}
    missing, unexpected = sorted(set(named) - set(values)), sorted(set(values) - set(named))
    if missing or unexpected:
        raise KeyError(f"{component} of {path} does not match {type(module).__name__}: "
                       f"missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for key, p in named.items():
            value = values[key]
            value = value if torch.is_tensor(value) else torch.as_tensor(np.array(value))
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(p.shape)}")
            p.copy_(value.to(p.dtype))
    return module
