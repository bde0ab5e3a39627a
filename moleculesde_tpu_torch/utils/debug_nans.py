"""Stop at the first NaN of a training run: the pretraining CLI's
``--debug_nans``.

Counterpart of ``jax.config.update("jax_debug_nans", True)`` in the JAX
package's pretraining CLI (``examples/pretrain.py:78-79``), which raises
``FloatingPointError`` at the first operation whose output holds a NaN (an
inf is no fault).  Inside :class:`NanGuard` the same error is raised, naming
where the NaN arose:

- the forward output of any module (a global forward hook), named by its
  path in the models given (``model_2D.GINConv_0.Dense_0``), innermost
  first;
- the output of any autograd node in a backward (autograd's anomaly mode
  with ``check_nan``), named by the node (``MmBackward0``; a kernel's
  ``_GinMessagesBackward``);
- every parameter and buffer after the optimizer's update, and whatever
  the caller hands to :meth:`NanGuard.check` (a step's metrics).

The guard reads values and changes none: with no NaN, every loss, metric
and parameter is bit for bit what it is without it.  Each check reads a
flag on the host, so a guarded step waits on the device many times.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, Mapping, Optional

import torch
from torch import nn


def _tensors(value: Any) -> Iterator[torch.Tensor]:
    """The floating-point tensors of a (nested) module output."""
    if torch.is_tensor(value):
        if value.is_floating_point():
            yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, Mapping):
        for v in value.values():
            yield from _tensors(v)


def _has_nan(value: Any) -> bool:
    return any(bool(torch.isnan(t).any()) for t in _tensors(value))


class NanGuard:
    """``with NanGuard(models, optimizer):`` raises ``FloatingPointError``
    at the first NaN of the block (module docstring).  ``models`` maps
    component names to modules; ``optimizer``, when given, has its
    parameters and the models' buffers checked after each update."""

    def __init__(self, models: Mapping[str, nn.Module],
                 optimizer: Optional[torch.optim.Optimizer] = None):
        self.models = models
        self.optimizer = optimizer
        self._names = {id(mod): f"{comp}.{name}" if name else comp
                       for comp, model in models.items()
                       for name, mod in model.named_modules()}
        self._handles = []
        self._anomaly = None

    def check(self, what: str, values: Any) -> None:
        """Raise if a floating-point tensor of ``values`` (a tensor, or a
        tuple, list or mapping of them) holds a NaN."""
        if isinstance(values, Mapping):
            for key, v in values.items():
                if _has_nan(v):
                    raise FloatingPointError(f"NaN in {what}: {key}")
        elif _has_nan(values):
            raise FloatingPointError(f"NaN in {what}")

    def check_state(self, what: str = "the state after the optimizer's update") -> None:
        """Every parameter and buffer of the models."""
        for comp, model in self.models.items():
            for name, t in list(model.named_parameters()) + list(model.named_buffers()):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"NaN in {what}: {comp}.{name}")

    def _forward_hook(self, module: nn.Module, inputs, output) -> None:
        if _has_nan(output):
            name = self._names.get(id(module), type(module).__name__)
            raise FloatingPointError(f"NaN in the forward output of {name} "
                                     f"({type(module).__name__})")

    def __enter__(self) -> "NanGuard":
        self._handles.append(nn.modules.module.register_module_forward_hook(
            self._forward_hook))
        if self.optimizer is not None:
            self._handles.append(self.optimizer.register_step_post_hook(
                lambda *_: self.check_state()))
        self._anomaly = torch.autograd.set_detect_anomaly(True, check_nan=True)
        self._anomaly.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._anomaly.__exit__(None, None, None)
        for handle in self._handles:
            handle.remove()
        self._handles = []
        # anomaly mode reports a NaN gradient as a RuntimeError naming the
        # node: raise it as the FloatingPointError JAX raises
        if exc_type is RuntimeError:
            found = re.search(r"Function '(\w+)' returned nan values in its (\d+)th output",
                              str(exc))
            if found:
                raise FloatingPointError(
                    f"NaN in the backward: output {found.group(2)} of the autograd node "
                    f"{found.group(1)}") from exc
        return False
