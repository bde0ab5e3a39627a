"""MD17 energy and force finetuning.

Counterpart of ``moleculesde_tpu/finetune/md17.py`` (reference
examples/finetune_MD17.py): the energy of each frame from
:class:`RegressionModel`, the forces ``-dE/dpos`` (reference l.68,
``autograd.grad(E, positions, create_graph=True)``) zeroed on padded atoms,
and the loss ``energy_coeff * L1(E) + force_coeff * L1(F)`` (l.74) on
targets the caller normalizes (energy shift and scale).

Training differentiates the forces again (a double backward), so the
encoder must give positions a gradient: SchNet with ``cfconv="xla"`` or
PaiNN.  The CFConv kernels give geometry no gradient and refuse to be
asked for one, as the JAX package's do.  Padded atoms sit at the origin;
SchNet's distance guard keeps sqrt's derivatives finite there, and the
boolean pair mask multiplies them by an exact 0.  Evaluation needs the
gradient too: it runs under ``torch.enable_grad()`` on a leaf copy of the
positions and builds no second-order graph.  Under a data-parallel group
(``parallel/``) the forces stay the rank's own (no model here couples
molecules), the two L1 means are over every rank's graphs and atoms, and
the step averages the gradients over the ranks before the update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from moleculesde_tpu_torch.core.batch import GraphBatch
from moleculesde_tpu_torch.finetune.common import set_lr
from moleculesde_tpu_torch.finetune.regression import RegressionModel
from moleculesde_tpu_torch.parallel import collectives as dp


def energy_and_forces(model: RegressionModel, batch: GraphBatch, create_graph: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(energy [B], forces [B * n_max, 3]) with ``forces = -dE/dpos`` on
    real atoms and 0 on padded ones.  ``create_graph`` keeps the forces
    differentiable (training)."""
    pos = batch.positions.detach().requires_grad_(True)
    energy = model(dataclasses.replace(batch, positions=pos))
    (grad,) = torch.autograd.grad(energy.sum(), pos, create_graph=create_graph)
    return energy, -grad * batch.node_mask[:, None].to(grad.dtype)


def md17_loss(model: RegressionModel, batch: GraphBatch, y_e: torch.Tensor,
              y_f: torch.Tensor, graph_mask: torch.Tensor, energy_coeff: float = 0.05,
              force_coeff: float = 0.95) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"energy_mae", "force_mae"}): the L1 errors of the energies
    over real graphs and of the force components over real atoms."""
    pred_e, pred_f = energy_and_forces(model, batch)
    e_loss = dp.masked_mean((pred_e - y_e).abs(), graph_mask)
    nm = batch.node_mask.to(pred_e.dtype)[:, None]
    f_loss = (dp.global_sum(((pred_f - y_f).abs() * nm).sum())
              / (dp.global_sum(nm.sum()) * 3).clamp(min=1.0))
    return energy_coeff * e_loss + force_coeff * f_loss, {"energy_mae": e_loss,
                                                          "force_mae": f_loss}


def md17_step(model: RegressionModel, optimizer: torch.optim.Optimizer, batch: GraphBatch,
              y_e: torch.Tensor, y_f: torch.Tensor, graph_mask: torch.Tensor, lr: float,
              energy_coeff: float = 0.05, force_coeff: float = 0.95
              ) -> Dict[str, torch.Tensor]:
    """One Adam step at learning rate ``lr`` through the double backward;
    returns {"loss", "energy_mae", "force_mae"} as device scalars."""
    set_lr(optimizer, lr)
    optimizer.zero_grad(set_to_none=True)
    loss, parts = md17_loss(model, batch, y_e, y_f, graph_mask, energy_coeff, force_coeff)
    loss.backward()
    dp.average_grads(model.parameters())
    optimizer.step()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}


def md17_eval(model: RegressionModel, batch: GraphBatch, energy_scale: float = 1.0,
              energy_shift: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(energies, forces) on the raw scale, ``E * scale + shift`` and
    ``F * scale``, detached."""
    with torch.enable_grad():
        pred_e, pred_f = energy_and_forces(model, batch, create_graph=False)
    return (pred_e.detach() * energy_scale + energy_shift, pred_f.detach() * energy_scale)
