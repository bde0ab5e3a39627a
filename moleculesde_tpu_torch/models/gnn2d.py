"""2D molecular-graph encoder: GIN over padded batches.

Counterpart of the GIN path of ``moleculesde_tpu/models/gnn2d.py``
(reference Geom3D/models/molecule_gnn_model.py:13-32, 132-197):
OGB atom / bond encoders as sums of per-feature embeddings; GINConv
``mlp((1 + eps) * x + sum_j relu(x_j + bond_emb))`` whose message block is
:func:`~moleculesde_tpu_torch.ops.gin_messages.gin_messages`; per layer conv
-> masked BatchNorm -> ReLU (not after the last) -> dropout; JK ``last``.
Padded rows of the output are exactly zero.  ``compute_dtype="bfloat16"``
rounds where the JAX package's ``GINConv(dtype=bfloat16)`` does: the
message block in its bf16 mode and the two Dense layers in bf16, while the
residual, the BatchNorm statistics and the parameters stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moleculesde_tpu_torch.core.batch import (
    ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS, GraphBatch)
from moleculesde_tpu_torch.models.layers import (
    Dense, Embed, MaskedBatchNorm, dropout, init_parameters)
from moleculesde_tpu_torch.ops.gin_messages import gin_messages
from moleculesde_tpu_torch.utils.device import resolve_device


def _clipped(feats: torch.Tensor, i: int, dim: int) -> torch.Tensor:
    return feats[:, i].long().clamp(0, dim - 1)


class AtomEncoder(nn.Module):
    """Sum of embeddings of the 9 OGB categorical atom features, as one
    matmul of the concatenated one-hots against the row-stacked tables
    (the JAX package's form; its backward is a matmul too, where a gather's
    is an indexed scatter)."""

    def __init__(self, emb_dim: int):
        super().__init__()
        for i, dim in enumerate(ATOM_FEATURE_DIMS):
            setattr(self, f"atom_embedding_{i}", Embed(dim, emb_dim))

    def forward(self, atom_feats: torch.Tensor) -> torch.Tensor:
        table = torch.cat([getattr(self, f"atom_embedding_{i}").embedding
                           for i in range(len(ATOM_FEATURE_DIMS))], dim=0)
        onehots = torch.cat([F.one_hot(_clipped(atom_feats, i, dim), dim)
                             for i, dim in enumerate(ATOM_FEATURE_DIMS)], dim=-1)
        return onehots.to(table.dtype) @ table


class BondEncoder(nn.Module):
    """Sum of embeddings of the 3 OGB categorical bond features."""

    def __init__(self, emb_dim: int):
        super().__init__()
        for i, dim in enumerate(BOND_FEATURE_DIMS):
            setattr(self, f"bond_embedding_{i}", Embed(dim, emb_dim))

    def onehot_table(self, edge_feats: torch.Tensor):
        """(concatenated one-hots [E, 13] f32, row-stacked tables [13, F]):
        the form the message kernel applies the embedding in."""
        onehots = [F.one_hot(_clipped(edge_feats, i, dim), dim)
                   for i, dim in enumerate(BOND_FEATURE_DIMS)]
        table = torch.cat([getattr(self, f"bond_embedding_{i}").embedding
                           for i in range(len(BOND_FEATURE_DIMS))], dim=0)
        return torch.cat(onehots, dim=-1).to(table.dtype), table


class GINConv(nn.Module):
    """GIN convolution with bond features; ``msg_impl`` selects the message
    block: "auto" (kernel on a CUDA tensor, plain on a CPU tensor),
    "kernel" or "plain".  ``dtype`` is the compute dtype (None: f32)."""

    def __init__(self, emb_dim: int, msg_impl: str = "auto",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.msg_impl = msg_impl
        self.bf16 = dtype == torch.bfloat16
        self.BondEncoder_0 = BondEncoder(emb_dim)
        self.eps = nn.Parameter(torch.zeros(1))
        self.Dense_0 = Dense(emb_dim, 2 * emb_dim, dtype=dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(2 * emb_dim)
        self.Dense_1 = Dense(2 * emb_dim, emb_dim, dtype=dtype)

    def message_inputs(self, x, batch: GraphBatch):
        """The message block's operands: x [B, N, F], local src / dst
        [B, E] int32 (masked edges get the sentinel N), bond one-hots
        [B, E, 13] and the stacked table [13, F]."""
        b, n = batch.num_graphs, batch.n_max
        e_max = batch.edge_src.shape[0] // b
        boh, table = self.BondEncoder_0.onehot_table(batch.edge_feats)
        em = batch.edge_mask.reshape(b, e_max)
        sentinel = torch.full((), n, dtype=torch.int32, device=x.device)
        src = torch.where(em, (batch.edge_src % n).reshape(b, e_max).int(), sentinel)
        dst = torch.where(em, (batch.edge_dst % n).reshape(b, e_max).int(), sentinel)
        return (x.reshape(b, n, -1).contiguous(), src.contiguous(), dst.contiguous(),
                boh.reshape(b, e_max, -1).contiguous(), table.contiguous())

    def forward(self, x, batch: GraphBatch, use_running_average: bool = False):
        agg = gin_messages(*self.message_inputs(x, batch), bf16=self.bf16,
                           impl=self.msg_impl).reshape(x.shape[0], -1)
        h = (1.0 + self.eps) * x + agg
        h = self.Dense_0(h)
        h = F.relu(self.MaskedBatchNorm_0(h, batch.node_mask, use_running_average))
        return self.Dense_1(h).float()


class GNN2D(nn.Module):
    """Stacked GIN with JK ``last`` (reference molecule_gnn_model.py:132-197).

    ``drop_ratio`` is the dropout after each layer; ``compute_dtype``
    "bfloat16" runs the convolutions in bf16 (module docstring).  Built on
    the CPU, initialized from ``generator`` (default: seed 0), then moved to
    ``device``, which defaults to "cuda" and raises without a GPU unless
    "cpu" is asked for."""

    def __init__(self, num_layers: int = 5, emb_dim: int = 300,
                 drop_ratio: float = 0.0, compute_dtype: str | None = None,
                 msg_impl: str = "auto", device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if num_layers < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        dev = resolve_device(device)
        self.num_layers = num_layers
        self.emb_dim = emb_dim
        self.drop_ratio = drop_ratio
        dt = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.AtomEncoder_0 = AtomEncoder(emb_dim)
        for layer in range(num_layers):
            setattr(self, f"GINConv_{layer}", GINConv(emb_dim, msg_impl, dt))
            setattr(self, f"MaskedBatchNorm_{layer}", MaskedBatchNorm(emb_dim))
        init_parameters(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    def forward(self, batch: GraphBatch, use_running_average: bool = False,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Node representations [B * n_max, emb_dim] f32.  Training mode is
        ``use_running_average=False`` (batch statistics, updated running
        averages) with ``deterministic=False`` (dropout from
        ``generator``)."""
        h = self.AtomEncoder_0(batch.atom_feats)
        for layer in range(self.num_layers):
            h = getattr(self, f"GINConv_{layer}")(h, batch, use_running_average)
            h = getattr(self, f"MaskedBatchNorm_{layer}")(
                h, batch.node_mask, use_running_average)
            if layer < self.num_layers - 1:
                h = F.relu(h)
            h = dropout(h, self.drop_ratio, generator, deterministic)
        return h * batch.node_mask[:, None]
