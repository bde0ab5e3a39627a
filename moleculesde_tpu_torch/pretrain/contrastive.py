"""2D <-> 3D contrastive alignment losses over masked node rows.

Counterpart of ``moleculesde_tpu/pretrain/contrastive.py`` (reference
examples/util.py:22-79): InfoNCE with dot-product logits, EBM with
cycle-shift negatives, and EBM with one random cyclic shift as the
negative partner (``EBM_node_dot_prod``).  Invalid rows contribute zero
loss and accuracy; invalid columns are kept out of the InfoNCE softmax;
negatives whose partner is invalid get weight zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

METRICS = ("InfoNCE_dot_prod", "EBM_dot_prod", "EBM_node_dot_prod")


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def draw_shift(n: int, generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """The ``EBM_node_dot_prod`` negative shift r ~ U{1 .. n-1}, as a
    0-d int64 tensor on ``device``."""
    return torch.randint(1, n, (), generator=generator, device=device)


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

    if metric == "InfoNCE_dot_prod":
        logits = (x @ y.t()) / T
        if mask is not None:
            logits = torch.where(mask[None, :], logits,
                                 torch.full((), -1e9, dtype=logits.dtype, device=x.device))
        labels = torch.arange(n, device=x.device)
        per_row = -torch.log_softmax(logits, dim=-1)[labels, labels]
        acc = (logits.argmax(dim=-1) == labels).float()
        return _masked_mean(per_row, mask), _masked_mean(acc, mask)

    if metric == "EBM_dot_prod":
        pred_pos = (x * y).sum(dim=1) / T
        loss_pos = _masked_mean(_bce_with_logits(pred_pos, torch.ones_like(pred_pos)), mask)
        loss_neg = 0.0
        acc_num = _masked_mean((pred_pos > 0).float(), mask)
        for i in range(neg_samples):
            neg_y = torch.roll(y, -(i + 1), dims=0)
            neg_mask = None if mask is None else mask & torch.roll(mask, -(i + 1), dims=0)
            pred_neg = (x * neg_y).sum(dim=1) / T
            loss_neg = loss_neg + _masked_mean(
                _bce_with_logits(pred_neg, torch.zeros_like(pred_neg)), neg_mask)
            acc_num = acc_num + _masked_mean((pred_neg < 0).float(), neg_mask)
        return loss_pos + neg_samples * (loss_neg / neg_samples), acc_num / (1 + neg_samples)

    if metric == "EBM_node_dot_prod":
        if shift is None:
            raise ValueError("EBM_node_dot_prod needs its shift draw")
        # roll by -r with a traced r: row i meets row (i + r) % n
        idx = (torch.arange(n, device=x.device) + shift) % n
        neg_y = y[idx]
        neg_mask = None if mask is None else mask & mask[idx]
        pred_pos = (x * y).sum(dim=1) / T
        pred_neg = (x * neg_y).sum(dim=1) / T
        loss = (_masked_mean(_bce_with_logits(pred_pos, torch.ones_like(pred_pos)), mask)
                + _masked_mean(_bce_with_logits(pred_neg, torch.zeros_like(pred_neg)),
                               neg_mask))
        acc = 0.5 * (_masked_mean((pred_pos > 0).float(), mask)
                     + _masked_mean((pred_neg < 0).float(), neg_mask))
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
