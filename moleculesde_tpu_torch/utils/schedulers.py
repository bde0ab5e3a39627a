"""Learning-rate schedules of the finetunes.

Counterpart of ``moleculesde_tpu/utils/schedulers.py``, the reference's
five torch schedulers (reference examples/finetune_QM9.py:324-346,
config.py:52-57): :func:`make_lr_schedule` gives a step -> learning rate
function, evaluated on the host each step, and :class:`PlateauController`
is ReduceLROnPlateau at epoch granularity.  JAX evaluates the cosine
schedules with ``jnp.cos`` in float32; these are Python floats (float64),
which differ from JAX's by float32 rounding only.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence


def make_lr_schedule(name: str, lr: float, epochs: int, steps_per_epoch: int,
                     lr_decay_factor: float = 0.5, lr_decay_step_size: int = 100,
                     min_lr: float = 1e-6, custom_steps: Sequence[int] = (150,)
                     ) -> Callable[[int], float]:
    """step -> lr with torch's epoch-granularity semantics counted in steps.
    "ReduceLROnPlateau" (driven by :class:`PlateauController`) and "none"
    are the constant ``lr``."""
    if name == "CosineAnnealingLR":
        t_max = max(epochs * steps_per_epoch, 1)
        return lambda step: min_lr + 0.5 * (lr - min_lr) * (
            1 + math.cos(math.pi * min(step, t_max) / t_max))
    if name == "CosineAnnealingWarmRestarts":
        t0 = max(epochs * steps_per_epoch // 4, 1)
        return lambda step: min_lr + 0.5 * (lr - min_lr) * (
            1 + math.cos(math.pi * (step % t0) / t0))
    if name == "StepLR":
        decay_steps = max(lr_decay_step_size * steps_per_epoch, 1)
        return lambda step: lr * lr_decay_factor ** (step // decay_steps)
    if name == "StepLRCustomized":
        boundaries = [s * steps_per_epoch for s in custom_steps]
        return lambda step: lr * lr_decay_factor ** sum(step >= b for b in boundaries)
    if name in ("none", "None", "ReduceLROnPlateau"):
        return lambda step: lr
    raise ValueError(f"unknown lr scheduler {name}")


class PlateauController:
    """ReduceLROnPlateau on the host (reference finetune_QM9.py:334-339):
    after more than ``patience`` epochs without a lower validation metric,
    multiply the learning rate by ``factor`` (not below ``min_lr``)."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 50,
                 min_lr: float = 1e-6):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def update(self, val_metric: float) -> float:
        """Record an epoch's metric; returns the learning rate to use next."""
        if self.best is None or val_metric < self.best:
            self.best = val_metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
