"""MoleculeNet 2D classification finetuning.

Counterpart of ``moleculesde_tpu/finetune/classification.py`` (reference
examples/finetune_MoleculeNet.py:129-144): :class:`GNNGraphPred` logits
against labels in {-1, 0, +1}, where 0 marks a missing label, by the
binary cross-entropy averaged over the valid entries (label not 0, graph
real).  Training takes batch statistics and dropout from the caller's
generator; evaluation takes the running statistics and no dropout.
Under a data-parallel group (``parallel/``) the batch is the rank's block:
the loss's mean is over every rank's valid entries and the step averages
the gradients over the ranks before the update.
"""

from __future__ import annotations

import torch

from moleculesde_tpu_torch.core.batch import GraphBatch
from moleculesde_tpu_torch.finetune.common import bce_with_logits, set_lr
from moleculesde_tpu_torch.models.gnn2d import GNNGraphPred
from moleculesde_tpu_torch.parallel import collectives as dp


def classification_loss(model: GNNGraphPred, batch: GraphBatch, graph_mask: torch.Tensor,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """The masked BCE of one training-mode forward (batch statistics,
    running averages updated, dropout from ``generator``)."""
    pred = model(batch, use_running_average=False, deterministic=False, generator=generator)
    y = batch.y
    is_valid = (y != 0) & graph_mask[:, None]
    loss_mat = bce_with_logits(pred, (y + 1) / 2)
    return (dp.global_sum(torch.where(is_valid, loss_mat, 0.0).sum())
            / dp.global_sum(is_valid.sum()).clamp(min=1))


def classification_step(model: GNNGraphPred, optimizer: torch.optim.Optimizer,
                        batch: GraphBatch, graph_mask: torch.Tensor, lr: float,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """One Adam step at learning rate ``lr``; returns the loss (a device
    scalar, not read)."""
    set_lr(optimizer, lr)
    optimizer.zero_grad(set_to_none=True)
    loss = classification_loss(model, batch, graph_mask, generator)
    loss.backward()
    dp.average_grads(model.parameters())
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def classification_eval(model: GNNGraphPred, batch: GraphBatch) -> torch.Tensor:
    """Logits [B, T] with the running statistics and no dropout."""
    return model(batch, use_running_average=True, deterministic=True)
