"""What the three finetunes share: the loss helper, the optimizer, the
learning rate per step and the best epoch.

Counterpart of ``moleculesde_tpu/finetune/common.py``.  JAX's finetune Adam
folds the L2 decay into the gradient, takes Adam's direction and applies
``p - lr * u`` with the step's learning rate; ``torch.optim.Adam`` with
``weight_decay`` and the learning rate set per step in its param group is
the same update (:func:`make_optimizer`, :func:`set_lr`).  The JAX package
picks the best epoch on the device to keep device-to-host reads out of the
epoch loop; here :class:`BestTracker` reads one scalar per epoch, at epoch
end, and copies the weights when the epoch is better.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy of ``logits`` against 0 / 1
    ``labels``, in the JAX package's stable form."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def make_optimizer(model: nn.Module, lr: float, weight_decay: float = 0.0
                   ) -> torch.optim.Adam:
    """Adam over every parameter, L2 ``weight_decay`` added to the gradient
    (optax ``add_decayed_weights`` then ``scale_by_adam``: b1 0.9, b2 0.999,
    eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of the next step."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def snapshot(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the model's state (parameters and statistics), on its
    device."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class BestTracker:
    """The best epoch by a metric read at each epoch's end, JAX's
    ``make_best_tracker``: ``mode`` "max" or "min"; an epoch is better when
    its metric is strictly better (a NaN never is).  ``payload`` is what
    the tracker holds before any epoch is better (JAX's ``init``); with
    None the first epoch's payload is taken whatever its metric, as the
    JAX regression CLIs seed their tracker.  ``best`` is the best metric
    (-inf / +inf before any), ``best_epoch`` its epoch (0 before any)."""

    def __init__(self, mode: str = "max", payload: Optional[Any] = None):
        if mode not in ("max", "min"):
            raise ValueError(f"unknown mode {mode}")
        self.sign = 1.0 if mode == "max" else -1.0
        self.best = -self.sign * float("inf")
        self.payload = payload
        self.best_epoch = 0
        self.epoch = 1

    def update(self, metric: float, payload: Callable[[], Any]) -> bool:
        """Record epoch ``self.epoch``'s ``metric``; ``payload()`` is taken
        only when it is kept.  Returns whether the epoch is the best."""
        better = self.sign * metric > self.sign * self.best
        if better:
            self.best, self.best_epoch = metric, self.epoch
        if better or self.payload is None:
            self.payload = payload()
        self.epoch += 1
        return better
