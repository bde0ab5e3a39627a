"""One step of the joint pretraining objective.

Counterpart of ``moleculesde_tpu/pretrain/train_step.py`` (the
single-batch branch of ``make_pretrain_step``, l.455-468, and
``make_pretrain_loss``; reference examples/pretrain_MoleculeSDE.py:106-156):
GIN and SchNet forward, the dual contrastive loss, the 2D->3D and 3D->2D
score-matching losses, one Adam update.  BatchNorm running statistics of
``model_2D`` and ``SDE_2Dto3D_model`` update in place as the forward runs.

Randomness: dropout masks and every loss draw come from one
``torch.Generator`` in execution order, or the draws are passed explicitly
(``draws``, as :func:`draw_losses` makes them) so a test can hand both
frameworks the same noise.  The microbatch scopes are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from moleculesde_tpu_torch.core.batch import GraphBatch
from moleculesde_tpu_torch.pretrain.contrastive import draw_shift, dual_cl
from moleculesde_tpu_torch.pretrain.train_state import PretrainConfig

METRICS = ("CL_loss", "CL_acc", "SDE_loss_2Dto3D", "SDE_loss_3Dto2D", "loss")


def draw_losses(models: Dict[str, nn.Module], cfg: PretrainConfig, batch: GraphBatch,
                generator: Optional[torch.Generator]) -> Dict[str, object]:
    """Every loss draw of one step: the two contrastive shifts
    (``EBM_node_dot_prod`` only) and each score model's noise and
    timesteps."""
    dev = batch.positions.device
    cl = None
    if cfg.cl_similarity_metric == "EBM_node_dot_prod":
        cl = tuple(draw_shift(batch.num_nodes, generator, dev) for _ in range(2))
    return {"cl": cl,
            "sde_2dto3d": models["SDE_2Dto3D_model"].draw(batch, generator),
            "sde_3dto2d": models["SDE_3Dto2D_model"].draw(batch, generator)}


def pretrain_loss(models: Dict[str, nn.Module], cfg: PretrainConfig, batch: GraphBatch,
                  generator: Optional[torch.Generator] = None,
                  coeff_contrastive: Optional[float] = None, deterministic: bool = False,
                  draws: Optional[Dict[str, object]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The joint loss and its metrics (``CL_loss, CL_acc, SDE_loss_2Dto3D,
    SDE_loss_3Dto2D, loss``).  ``deterministic`` turns dropout off;
    ``coeff_contrastive`` defaults to the config's."""
    coeff = cfg.coeff_contrastive if coeff_contrastive is None else coeff_contrastive
    d = draws if draws is not None else draw_losses(models, cfg, batch, generator)
    node_2d = models["model_2D"](batch, use_running_average=False,
                                 deterministic=deterministic, generator=generator)
    _, node_3d = models["model_3D"].encode_batch(batch)
    cl_loss, cl_acc = dual_cl(node_2d, node_3d, cfg.cl_similarity_metric, cfg.T,
                              cfg.cl_neg_samples, batch.node_mask, cfg.normalize,
                              shifts=d["cl"])
    total = coeff * cl_loss
    zero = torch.zeros((), device=node_2d.device)
    loss_23 = loss_32 = zero
    if cfg.coeff_generative_2dto3d > 0:
        loss_23 = models["SDE_2Dto3D_model"].loss(
            node_2d, batch, generator, cfg.anneal_power, deterministic,
            use_running_average=False, draws=d["sde_2dto3d"])
        total = total + cfg.coeff_generative_2dto3d * loss_23
    if cfg.coeff_generative_3dto2d > 0:
        loss_x, loss_adj = models["SDE_3Dto2D_model"].loss(
            node_3d, batch, generator, cfg.anneal_power, cfg.reduce_mean,
            draws=d["sde_3dto2d"])
        loss_32 = 0.5 * (loss_x + loss_adj)
        total = total + cfg.coeff_generative_3dto2d * loss_32
    return total, {"CL_loss": cl_loss, "CL_acc": cl_acc, "SDE_loss_2Dto3D": loss_23,
                   "SDE_loss_3Dto2D": loss_32, "loss": total}


def pretrain_step(models: Dict[str, nn.Module], optimizer: torch.optim.Optimizer,
                  cfg: PretrainConfig, batch: GraphBatch,
                  generator: Optional[torch.Generator] = None,
                  coeff_contrastive: Optional[float] = None,
                  deterministic: bool = False,
                  draws: Optional[Dict[str, object]] = None) -> Dict[str, torch.Tensor]:
    """Loss, gradients and one optimizer update; returns the metrics as
    detached device scalars (reading them is the caller's sync)."""
    optimizer.zero_grad(set_to_none=True)
    total, metrics = pretrain_loss(models, cfg, batch, generator, coeff_contrastive,
                                   deterministic, draws)
    total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}
