"""QM9 3D regression finetuning.

Counterpart of ``moleculesde_tpu/finetune/regression.py`` (reference
examples/finetune_QM9.py): the 3D encoder's pooled output through a
``linear`` head (``graph_pred_linear``; SchNet) or an ``mlp`` head
(``Dense_0``, SiLU, ``Dense_1``; PaiNN, reference painn.py:205-213), one
value per graph.  Targets are z-scored by the caller; the loss is the L1
("mae") or L2 ("mse") error over the real graphs, of every rank under a
data-parallel group (``parallel/``), whose step averages the gradients over
the ranks before the update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moleculesde_tpu_torch.core.batch import GraphBatch
from moleculesde_tpu_torch.finetune.common import set_lr
from moleculesde_tpu_torch.models.layers import Dense, init_parameters
from moleculesde_tpu_torch.parallel import collectives as dp

HEADS = ("linear", "mlp")


class RegressionModel(nn.Module):
    """``encoder`` (SchNet or PaiNN: ``(pooled [B, H], latent)``) and a
    head; the forward returns [B].  Parameter names are flax's (``encoder``,
    ``graph_pred_linear`` or ``Dense_0`` / ``Dense_1``).  The head is
    initialized xavier-uniform with zero biases, from ``generator``
    (default: seed 0), on the encoder's device."""

    def __init__(self, encoder: nn.Module, head: str = "linear",
                 generator: torch.Generator | None = None):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head}")
        self.encoder = encoder
        self.head = head
        h = getattr(encoder, "hidden_channels", None) or encoder.f   # SchNet / PaiNN
        if head == "linear":
            self.graph_pred_linear = Dense(h, 1)
        else:
            self.Dense_0 = Dense(h, h // 2)
            self.Dense_1 = Dense(h // 2, 1)
        dev = next(encoder.parameters()).device
        for name, module in self.named_children():
            if name != "encoder":
                init_parameters(module, generator or torch.Generator().manual_seed(0))
                module.to(dev)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        pooled, _ = self.encoder(batch.atomic_numbers, batch.positions, batch.node_mask,
                                 batch.num_graphs, batch.n_max)
        if self.head == "linear":
            out = self.graph_pred_linear(pooled)
        else:
            out = self.Dense_1(F.silu(self.Dense_0(pooled)))
        return out[:, 0]


def regression_loss(model: RegressionModel, batch: GraphBatch, y_norm: torch.Tensor,
                    graph_mask: torch.Tensor, loss_type: str = "mae") -> torch.Tensor:
    err = model(batch) - y_norm
    per = err.abs() if loss_type == "mae" else err ** 2
    return dp.masked_mean(per, graph_mask)


def regression_step(model: RegressionModel, optimizer: torch.optim.Optimizer,
                    batch: GraphBatch, y_norm: torch.Tensor, graph_mask: torch.Tensor,
                    lr: float, loss_type: str = "mae") -> torch.Tensor:
    """One Adam step at learning rate ``lr`` on z-scored targets; returns
    the loss (a device scalar, not read)."""
    set_lr(optimizer, lr)
    optimizer.zero_grad(set_to_none=True)
    loss = regression_loss(model, batch, y_norm, graph_mask, loss_type)
    loss.backward()
    dp.average_grads(model.parameters())
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def regression_eval(model: RegressionModel, batch: GraphBatch) -> torch.Tensor:
    """Per-graph predictions [B], on the z-scored scale."""
    return model(batch)
