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

:func:`graph_pool` and :class:`GNNGraphPred` (reference
molecule_gnn_model.py:200-281) put the MoleculeNet finetune's head on it:
masked sum / mean / max pooling, then a linear layer per task.
"""

from __future__ import annotations

import math

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


def graph_pool(node_rep: torch.Tensor, batch: GraphBatch, pooling: str = "mean") -> torch.Tensor:
    """Masked pooling of node rows [B * n_max, F] into [B, F]: "sum",
    "mean" (over the real atoms, at least one) or "max" (0 for a graph
    with no atom), as the JAX package's ``graph_pool``."""
    b, n = batch.num_graphs, batch.n_max
    x = node_rep.reshape((b, n) + tuple(node_rep.shape[1:]))
    m = batch.node_mask.reshape(b, n, 1).to(node_rep.dtype)
    if pooling == "sum":
        return (x * m).sum(dim=1)
    if pooling == "mean":
        return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    if pooling == "max":
        out = torch.where(m > 0, x, float("-inf")).amax(dim=1)
        return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype,
                                                                 device=out.device))
    raise ValueError(f"Invalid graph pooling type {pooling}.")


def check_gnn(gnn_type: str, jk: str) -> None:
    """Raise on the 2D encoders the port does not run yet (it runs GIN
    with JK 'last')."""
    if gnn_type != "GIN" or jk != "last":
        raise NotImplementedError(f"only GIN with JK 'last' is ported (got --gnn_type "
                                  f"{gnn_type}, --JK {jk})")


def lecun_normal_(kernel: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``nn.Dense``'s default kernel init: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / kernel.shape[0]) / 0.87962566103423978
    nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class GNNGraphPred(nn.Module):
    """GIN (JK "last") + :func:`graph_pool` + a linear head of
    ``num_tasks`` logits (JAX ``GNNGraphPred``).  Submodules keep flax's
    names, ``gnn`` and ``graph_pred_linear``, so a flax tree loads with
    ``load_flax_variables``.  The head starts as flax's ``nn.Dense``
    (lecun-normal kernel, zero bias); the GIN as :class:`GNN2D`, from
    ``generator`` (default: seed 0).  ``msg_impl`` picks K1 as in
    :class:`GINConv`; built on ``device`` ("cuda" by default; raises
    without a GPU unless "cpu")."""

    def __init__(self, num_tasks: int, num_layers: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0, gnn_type: str = "GIN",
                 graph_pooling: str = "mean", msg_impl: str = "auto",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_gnn(gnn_type, jk)
        if graph_pooling not in ("sum", "mean", "max"):
            raise ValueError(f"Invalid graph pooling type {graph_pooling}.")
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.graph_pooling = graph_pooling
        self.gnn = GNN2D(num_layers, emb_dim, drop_ratio, msg_impl=msg_impl, device="cpu",
                         generator=gen)
        self.graph_pred_linear = Dense(emb_dim, num_tasks)
        with torch.no_grad():
            lecun_normal_(self.graph_pred_linear.kernel, gen)
        self.to(dev)

    def forward(self, batch: GraphBatch, use_running_average: bool = False,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [B, num_tasks]; the modes as :meth:`GNN2D.forward`."""
        node_rep = self.gnn(batch, use_running_average, deterministic, generator)
        return self.graph_pred_linear(graph_pool(node_rep, batch, self.graph_pooling))
