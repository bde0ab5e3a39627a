"""2D <-> 3D contrastive alignment losses over masked node rows.

Counterpart of ``moleculesde_tpu/pretrain/contrastive.py`` (reference
examples/util.py:22-79): InfoNCE with dot-product logits, EBM with
cycle-shift negatives, and EBM with one random cyclic shift as the
negative partner (``EBM_node_dot_prod``).  Invalid rows contribute zero
loss and accuracy; invalid columns are kept out of the InfoNCE softmax;
negatives whose partner is invalid get weight zero.

Under a data-parallel group (:mod:`~moleculesde_tpu_torch.parallel.collectives`)
x and y are the rank's node rows of the global batch and every quantity is
the global batch's: InfoNCE takes the rank's rows against every rank's
columns and mask (the label offset by the rank's first global row), the
``EBM_dot_prod`` rolls and the ``EBM_node_dot_prod`` shift run over the
global rows (the shift drawn from U{1 .. global rows - 1}), and the masked
means and the accuracy are global.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from moleculesde_tpu_torch.parallel import collectives as dp

METRICS = ("InfoNCE_dot_prod", "EBM_dot_prod", "EBM_node_dot_prod")


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def draw_shift(n: int, generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """The ``EBM_node_dot_prod`` negative shift r ~ U{1 .. N-1} for ``n``
    node rows a rank (N = n times the number of ranks), as a 0-d int64
    tensor on ``device``."""
    return torch.randint(1, n * dp.world_size(), (), generator=generator, device=device)


def do_cl(x: torch.Tensor, y: torch.Tensor, metric: str = "InfoNCE_dot_prod",
          T: float = 0.1, neg_samples: int = 1, mask: Optional[torch.Tensor] = None,
          normalize: bool = False, shift: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction of the contrastive loss: (loss, accuracy).  ``mask``
    flags the valid rows of x / y; ``shift`` is the ``EBM_node_dot_prod``
    draw (:func:`draw_shift`)."""
    if normalize:
        x = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        y = y / y.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    n = x.shape[0]
    lo = dp.row_offset(n)                 # the rank's first global row
    y_all = dp.all_gather_rows(y)         # y of every rank (y itself in one process)
    m_all = None if mask is None else dp.all_gather_rows(mask)
    rows = torch.arange(n, device=x.device)

    if metric == "InfoNCE_dot_prod":
        logits = (x @ y_all.t()) / T
        if mask is not None:
            logits = torch.where(m_all[None, :], logits,
                                 torch.full((), -1e9, dtype=logits.dtype, device=x.device))
        labels = rows + lo
        per_row = -torch.log_softmax(logits, dim=-1)[rows, labels]
        acc = (logits.argmax(dim=-1) == labels).float()
        return dp.masked_mean(per_row, mask), dp.masked_mean(acc, mask)

    if metric == "EBM_dot_prod":
        pred_pos = (x * y).sum(dim=1) / T
        loss_pos = dp.masked_mean(_bce_with_logits(pred_pos, torch.ones_like(pred_pos)), mask)
        loss_neg = 0.0
        acc_num = dp.masked_mean((pred_pos > 0).float(), mask)
        for i in range(neg_samples):
            neg_y = torch.roll(y_all, -(i + 1), dims=0)[lo:lo + n]
            neg_mask = (None if mask is None
                        else mask & torch.roll(m_all, -(i + 1), dims=0)[lo:lo + n])
            pred_neg = (x * neg_y).sum(dim=1) / T
            loss_neg = loss_neg + dp.masked_mean(
                _bce_with_logits(pred_neg, torch.zeros_like(pred_neg)), neg_mask)
            acc_num = acc_num + dp.masked_mean((pred_neg < 0).float(), neg_mask)
        return loss_pos + neg_samples * (loss_neg / neg_samples), acc_num / (1 + neg_samples)

    if metric == "EBM_node_dot_prod":
        if shift is None:
            raise ValueError("EBM_node_dot_prod needs its shift draw")
        # roll by -r with a traced r: global row i meets row (i + r) % N
        idx = (rows + lo + shift) % y_all.shape[0]
        neg_y = y_all[idx]
        neg_mask = None if mask is None else mask & m_all[idx]
        pred_pos = (x * y).sum(dim=1) / T
        pred_neg = (x * neg_y).sum(dim=1) / T
        loss = (dp.masked_mean(_bce_with_logits(pred_pos, torch.ones_like(pred_pos)), mask)
                + dp.masked_mean(_bce_with_logits(pred_neg, torch.zeros_like(pred_neg)),
                               neg_mask))
        acc = 0.5 * (dp.masked_mean((pred_pos > 0).float(), mask)
                     + dp.masked_mean((pred_neg < 0).float(), neg_mask))
        return loss, acc

    raise ValueError(f"unknown CL metric {metric}")


def dual_cl(x: torch.Tensor, y: torch.Tensor, metric: str = "InfoNCE_dot_prod",
            T: float = 0.1, neg_samples: int = 1, mask: Optional[torch.Tensor] = None,
            normalize: bool = False, generator: Optional[torch.Generator] = None,
            shifts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetrized X->Y and Y->X contrastive loss: (loss, accuracy).
    ``EBM_node_dot_prod`` draws one shift per direction from ``generator``
    unless ``shifts`` gives them."""
    if metric == "EBM_node_dot_prod" and shifts is None:
        shifts = tuple(draw_shift(x.shape[0], generator, x.device) for _ in range(2))
    s1, s2 = shifts if shifts is not None else (None, None)
    l1, a1 = do_cl(x, y, metric, T, neg_samples, mask, normalize, s1)
    l2, a2 = do_cl(y, x, metric, T, neg_samples, mask, normalize, s2)
    return (l1 + l2) / 2.0, (a1 + a2) / 2.0
