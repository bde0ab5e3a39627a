"""Masked segment operations on padded batches (``index_add_`` / gather).

Counterpart of ``moleculesde_tpu/core/segment.py`` for what the GIN plain
message path and the samplers need.  Where the JAX package writes these as
one-hot matmuls (scatter-free on a TPU), the natural GPU form is a gather and
an ``index_add_``.  Every op takes a validity mask so padded rows contribute
exactly zero.
"""

from __future__ import annotations

from typing import Optional

import torch


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.reshape(tuple(mask.shape) + (1,) * (data.ndim - mask.ndim))
    return torch.where(m, data, torch.zeros((), dtype=data.dtype, device=data.device))


def masked_segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum of ``data`` rows per segment; masked rows contribute zero."""
    total = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                        dtype=data.dtype, device=data.device)
    return total.index_add_(0, segment_ids.long(), _apply_mask(data, mask))


def masked_segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean of ``data`` rows per segment over valid rows only (empty -> 0)."""
    ids = segment_ids.long()
    total = masked_segment_sum(data, ids, num_segments, mask)
    ones = (torch.ones(ids.shape, dtype=data.dtype, device=data.device)
            if mask is None else mask.to(data.dtype))
    count = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    count.index_add_(0, ids, ones)
    count = count.clamp(min=1.0)
    return total / count.reshape(tuple(count.shape) + (1,) * (total.ndim - 1))


def edge_gather(
    x: torch.Tensor,
    edge_idx: torch.Tensor,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-edge rows ``x[edge_idx]``; masked edges give zero rows.

    ``x``: [B*n_max, F]; ``edge_idx``: [E] flat node indices (masked entries
    may hold any value)."""
    idx = edge_idx.long()
    if edge_mask is not None:
        idx = torch.where(edge_mask, idx, torch.zeros_like(idx))
    return _apply_mask(x.index_select(0, idx), edge_mask)


def edge_aggregate(
    msg: torch.Tensor,
    edge_dst: torch.Tensor,
    num_nodes: int,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum of edge rows at their destination node: [E, F] -> [num_nodes, F]."""
    idx = edge_dst.long()
    if edge_mask is not None:
        idx = torch.where(edge_mask, idx, torch.zeros_like(idx))
    out = torch.zeros((num_nodes,) + tuple(msg.shape[1:]), dtype=msg.dtype,
                      device=msg.device)
    return out.index_add_(0, idx, _apply_mask(msg, edge_mask))
