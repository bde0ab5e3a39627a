"""Masked segment operations on padded batches (``index_add_`` / gather).

Counterpart of ``moleculesde_tpu/core/segment.py``: the sums, means and
gathers of the GIN plain message path and the samplers, and the max,
degree, mean and softmax that the GCN, GAT and GraphSAGE layers read.
Where the JAX package writes these as one-hot matmuls (scatter-free on a
TPU), the natural GPU form is a gather, an ``index_add_`` or a
``scatter_reduce_``.  Every op
takes a validity mask so padded rows contribute exactly zero.
"""

from __future__ import annotations

from typing import Optional

import torch


def _expand(t: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``t`` [rows] with singleton axes to ``data``'s rank."""
    return t.reshape(tuple(t.shape) + (1,) * (data.ndim - t.ndim))


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return data
    return torch.where(_expand(mask, data), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


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


def masked_segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    initial: float = -float("inf"),
) -> torch.Tensor:
    """Per-segment max over valid rows; masked rows read as ``initial``, so
    a segment of masked rows only gives ``initial`` and a segment with no
    row at all -inf (``jax.ops.segment_max``'s identity), as in JAX."""
    if mask is not None:
        data = torch.where(_expand(mask, data), data,
                           torch.full((), initial, dtype=data.dtype, device=data.device))
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -float("inf"),
                     dtype=data.dtype, device=data.device)
    ids = _expand(segment_ids.long(), data).expand_as(data)
    return out.scatter_reduce_(0, ids, data, reduce="amax", include_self=True)


def node_degree(
    edge_index: torch.Tensor,
    num_graphs: int,
    n_max: int,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Valid-edge count per node, flat ``[B * n_max]`` float32.  As in JAX,
    the edges of graph ``b`` are its ``e_max`` slots and count at their
    endpoint's local index ``edge_index % n_max`` in that graph."""
    e_max = edge_index.shape[0] // num_graphs
    slot = torch.arange(num_graphs, device=edge_index.device).repeat_interleave(e_max)
    flat = slot * n_max + edge_index.long() % n_max
    weight = None if edge_mask is None else edge_mask.to(torch.float32)
    return torch.bincount(flat, weight, minlength=num_graphs * n_max).to(torch.float32)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax over the rows that share a segment id, shifted by the
    segment's max; masked rows get 0 and a segment of masked rows only all
    zeros (JAX's ``segment_softmax``, PyG's per-destination ``softmax``)."""
    ids = segment_ids.long()
    seg_max = masked_segment_max(logits, ids, num_segments, mask)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    ex = _apply_mask(torch.exp(logits - seg_max[ids]), mask)
    denom = masked_segment_sum(ex, ids, num_segments).clamp(min=1e-16)
    return ex / denom[ids]


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
    reduce: str = "sum",
) -> torch.Tensor:
    """Edge rows gathered at their destination node: [E, F] -> [num_nodes, F].

    ``reduce`` "sum", or "mean": the sum over a node's valid edges divided
    by their count, at least 1 (JAX's ``edge_aggregate``, torch_scatter's
    ``scatter_mean``).  ``edge_dst`` holds flat node ids.  JAX groups the
    edges of graph ``b`` in its ``e_max`` slots and reads the destination as
    ``edge_dst % n_max`` in that graph; on every batch the collators build,
    a valid edge in slot ``b`` has ``edge_dst // n_max == b``, so the two
    forms agree (``tests/test_torch_port_gnn_types.py`` checks it)."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce {reduce}")
    idx = edge_dst.long()
    if edge_mask is not None:
        idx = torch.where(edge_mask, idx, torch.zeros_like(idx))
    out = torch.zeros((num_nodes,) + tuple(msg.shape[1:]), dtype=msg.dtype,
                      device=msg.device)
    out.index_add_(0, idx, _apply_mask(msg, edge_mask))
    if reduce == "mean":
        ones = (torch.ones(idx.shape, dtype=msg.dtype, device=msg.device)
                if edge_mask is None else edge_mask.to(msg.dtype))
        count = torch.zeros(num_nodes, dtype=msg.dtype, device=msg.device)
        count.index_add_(0, idx, ones)
        out = out / _expand(count.clamp(min=1.0), out)
    return out
