"""2D molecular-graph encoders: GIN, GCN, GAT and GraphSAGE over padded
batches, with every jumping-knowledge mode.

Counterpart of ``moleculesde_tpu/models/gnn2d.py`` (reference
Geom3D/models/molecule_gnn_model.py:13-197): OGB atom / bond encoders as
sums of per-feature embeddings; per layer conv -> masked BatchNorm -> ReLU
(not after the last) -> dropout; JK "last", "concat", "max" or "sum" over
the atom embedding and the layers' outputs.  Padded rows of the output are
exactly zero.

- GINConv ``mlp((1 + eps) * x + sum_j relu(x_j + bond_emb))``, whose
  message block is :func:`~moleculesde_tpu_torch.ops.gin_messages.gin_messages`
  (K1).  ``compute_dtype="bfloat16"`` rounds where the JAX package's
  ``GINConv(dtype=bfloat16)`` does: the message block in its bf16 mode and
  the two Dense layers in bf16, while the residual, the BatchNorm
  statistics and the parameters stay f32.
- GCNConv, GATConv (2 heads, attention softmax grouped by the SOURCE node,
  the reference's own choice) and GraphSAGEConv (mean aggregate, L2
  normalized) are plain PyTorch on the segment helpers of
  ``core/segment.py``, as the JAX package writes them on its one-hot
  einsums.  Like JAX they take neither ``compute_dtype`` nor ``msg_impl``:
  they run f32 and launch no kernel.

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
from moleculesde_tpu_torch.core.segment import (
    edge_aggregate, edge_gather, node_degree, segment_softmax)
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

    def forward(self, edge_feats: torch.Tensor) -> torch.Tensor:
        onehots, table = self.onehot_table(edge_feats)
        return onehots @ table


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


def _valid_ids(ids: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """Flat node ids [E] as int64 with masked edges at node 0 (their values
    are read and then masked, as JAX reads its padded edges at node 0)."""
    ids = ids.long()
    return torch.where(edge_mask, ids, torch.zeros_like(ids))


class GCNConv(nn.Module):
    """GCN convolution (reference molecule_gnn_model.py:35-62; JAX
    ``GCNConv``): ``x = Dense(x)``, messages ``norm_sd * relu(x_s + bond)``
    with ``norm_sd = deg_s^-1/2 deg_d^-1/2`` summed at d, plus
    ``relu(x + root_emb) / deg``; deg counts a node's valid edges as
    source, plus one (the self loop)."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.Dense_0 = Dense(emb_dim, emb_dim)
        self.BondEncoder_0 = BondEncoder(emb_dim)
        self.root_emb = nn.Parameter(torch.empty(1, emb_dim))

    def forward(self, x, batch: GraphBatch, use_running_average: bool = False):
        x = self.Dense_0(x)
        em = batch.edge_mask
        deg = node_degree(batch.edge_src, batch.num_graphs, batch.n_max, em) + 1.0
        dinv = deg ** -0.5
        norm = dinv[_valid_ids(batch.edge_src, em)] * dinv[_valid_ids(batch.edge_dst, em)]
        msg = norm[:, None] * F.relu(edge_gather(x, batch.edge_src, em)
                                     + self.BondEncoder_0(batch.edge_feats))
        agg = edge_aggregate(msg, batch.edge_dst, x.shape[0], em)
        return agg + F.relu(x + self.root_emb) / deg[:, None]


class GATConv(nn.Module):
    """GAT convolution (reference molecule_gnn_model.py:65-106; JAX
    ``GATConv``): ``heads`` heads of width ``emb_dim``, logits
    ``leaky_relu(att . [x_d, x_s + bond], 0.2)``, softmax over the edges
    that share a SOURCE node (the reference groups by ``edge_index[0]``),
    messages ``alpha * (x_s + bond)`` summed at d, the mean over heads plus
    ``bias``."""

    def __init__(self, emb_dim: int, heads: int = 2, negative_slope: float = 0.2):
        super().__init__()
        self.emb_dim = emb_dim
        self.heads = heads
        self.negative_slope = negative_slope
        self.Dense_0 = Dense(emb_dim, heads * emb_dim)
        self.BondEncoder_0 = BondEncoder(heads * emb_dim)
        self.att = nn.Parameter(torch.empty(1, heads, 2 * emb_dim))
        self.bias = nn.Parameter(torch.zeros(emb_dim))

    def forward(self, x, batch: GraphBatch, use_running_average: bool = False):
        hd, f = self.heads, self.emb_dim
        em = batch.edge_mask
        h = self.Dense_0(x)
        x_i = edge_gather(h, batch.edge_dst, em).reshape(-1, hd, f)
        x_j = (edge_gather(h, batch.edge_src, em)
               + self.BondEncoder_0(batch.edge_feats)).reshape(-1, hd, f)
        alpha = F.leaky_relu((torch.cat([x_i, x_j], dim=-1) * self.att).sum(dim=-1),
                             self.negative_slope)
        alpha = segment_softmax(alpha, _valid_ids(batch.edge_src, em), x.shape[0], em)
        msg = (x_j * alpha[:, :, None]).reshape(-1, hd * f)
        agg = edge_aggregate(msg, batch.edge_dst, x.shape[0], em)
        return agg.reshape(-1, hd, f).mean(dim=1) + self.bias


class GraphSAGEConv(nn.Module):
    """GraphSAGE convolution (reference molecule_gnn_model.py:109-129; JAX
    ``GraphSAGEConv``): Dense -> masked BatchNorm -> relu -> Dense, then the
    mean over a node's valid in-edges of ``h_s + bond``, divided by
    ``max(sqrt(|agg|^2 + 1e-24), 1e-12)``."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.Dense_0 = Dense(emb_dim, emb_dim)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(emb_dim)
        self.Dense_1 = Dense(emb_dim, emb_dim)
        self.BondEncoder_0 = BondEncoder(emb_dim)

    def forward(self, x, batch: GraphBatch, use_running_average: bool = False):
        h = F.relu(self.MaskedBatchNorm_0(self.Dense_0(x), batch.node_mask,
                                          use_running_average))
        h = self.Dense_1(h)
        msg = edge_gather(h, batch.edge_src, batch.edge_mask) \
            + self.BondEncoder_0(batch.edge_feats)
        agg = edge_aggregate(msg, batch.edge_dst, x.shape[0], batch.edge_mask,
                             reduce="mean")
        denom = torch.sqrt((agg ** 2).sum(dim=-1, keepdim=True) + 1e-24)
        return agg / denom.clamp(min=1e-12)


GNN_TYPES = ("GIN", "GCN", "GAT", "GraphSAGE")
JK_MODES = ("last", "concat", "max", "sum")


class GNN2D(nn.Module):
    """Stacked 2D GNN with JK aggregation (reference
    molecule_gnn_model.py:132-197; JAX ``GNN2D``).

    ``gnn_type`` is "GIN", "GCN", "GAT" or "GraphSAGE"; ``jk`` "last",
    "concat", "max" or "sum" over ``[x, h_1 .. h_L]`` (anything else raises
    ``ValueError``).  :attr:`out_dim` is the output width: ``emb_dim *
    (num_layers + 1)`` under "concat", else ``emb_dim``.  ``drop_ratio`` is
    the dropout after each layer; ``compute_dtype`` "bfloat16" and
    ``msg_impl`` reach GIN only (module docstring).  Built on the CPU,
    initialized from ``generator`` (default: seed 0), then moved to
    ``device``, which defaults to "cuda" and raises without a GPU unless
    "cpu" is asked for."""

    def __init__(self, num_layers: int = 5, emb_dim: int = 300, jk: str = "last",
                 drop_ratio: float = 0.0, gnn_type: str = "GIN",
                 compute_dtype: str | None = None, msg_impl: str = "auto",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if num_layers < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        if gnn_type not in GNN_TYPES:
            raise ValueError(f"unknown gnn_type {gnn_type} (one of {', '.join(GNN_TYPES)})")
        if jk not in JK_MODES:
            raise ValueError(f"unknown JK mode {jk} (one of {', '.join(JK_MODES)})")
        dev = resolve_device(device)
        self.num_layers = num_layers
        self.emb_dim = emb_dim
        self.jk = jk
        self.gnn_type = gnn_type
        self.drop_ratio = drop_ratio
        self.out_dim = emb_dim * (num_layers + 1) if jk == "concat" else emb_dim
        dt = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.AtomEncoder_0 = AtomEncoder(emb_dim)
        for layer in range(num_layers):
            if gnn_type == "GIN":
                conv = GINConv(emb_dim, msg_impl, dt)
            else:
                conv = {"GCN": GCNConv, "GAT": GATConv, "GraphSAGE": GraphSAGEConv}[
                    gnn_type](emb_dim)
            setattr(self, f"{gnn_type}Conv_{layer}", conv)
            setattr(self, f"MaskedBatchNorm_{layer}", MaskedBatchNorm(emb_dim))
        init_parameters(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    def forward(self, batch: GraphBatch, use_running_average: bool = False,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Node representations [B * n_max, :attr:`out_dim`] f32.  Training
        mode is ``use_running_average=False`` (batch statistics, updated
        running averages) with ``deterministic=False`` (dropout from
        ``generator``)."""
        h_list = [self.AtomEncoder_0(batch.atom_feats)]
        for layer in range(self.num_layers):
            h = getattr(self, f"{self.gnn_type}Conv_{layer}")(h_list[-1], batch,
                                                              use_running_average)
            h = getattr(self, f"MaskedBatchNorm_{layer}")(
                h, batch.node_mask, use_running_average)
            if layer < self.num_layers - 1:
                h = F.relu(h)
            h_list.append(dropout(h, self.drop_ratio, generator, deterministic))
        if self.jk == "concat":
            rep = torch.cat(h_list, dim=1)
        elif self.jk == "last":
            rep = h_list[-1]
        elif self.jk == "max":
            rep = torch.stack(h_list).amax(dim=0)
        else:
            rep = torch.stack(h_list).sum(dim=0)
        return rep * batch.node_mask[:, None]


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


def lecun_normal_(kernel: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``nn.Dense``'s default kernel init: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / kernel.shape[0]) / 0.87962566103423978
    nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class GNNGraphPred(nn.Module):
    """:class:`GNN2D` (any ``gnn_type`` and ``jk``) + :func:`graph_pool` + a
    linear head of ``num_tasks`` logits (JAX ``GNNGraphPred``), sized from
    the encoder's :attr:`~GNN2D.out_dim` where flax infers it.  Submodules
    keep flax's names, ``gnn`` and ``graph_pred_linear``, so a flax tree
    loads with ``load_flax_variables``.  The head starts as flax's
    ``nn.Dense`` (lecun-normal kernel, zero bias); the encoder as
    :class:`GNN2D`, from ``generator`` (default: seed 0).  ``msg_impl``
    picks K1 as in :class:`GINConv`; built on ``device`` ("cuda" by
    default; raises without a GPU unless "cpu")."""

    def __init__(self, num_tasks: int, num_layers: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0, gnn_type: str = "GIN",
                 graph_pooling: str = "mean", msg_impl: str = "auto",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if graph_pooling not in ("sum", "mean", "max"):
            raise ValueError(f"Invalid graph pooling type {graph_pooling}.")
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.graph_pooling = graph_pooling
        self.gnn = GNN2D(num_layers, emb_dim, jk=jk, drop_ratio=drop_ratio,
                         gnn_type=gnn_type, msg_impl=msg_impl, device="cpu", generator=gen)
        self.graph_pred_linear = Dense(self.gnn.out_dim, num_tasks)
        with torch.no_grad():
            lecun_normal_(self.graph_pred_linear.kernel, gen)
        self.to(dev)

    def forward(self, batch: GraphBatch, use_running_average: bool = False,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [B, num_tasks]; the modes as :meth:`GNN2D.forward`."""
        node_rep = self.gnn(batch, use_running_average, deterministic, generator)
        return self.graph_pred_linear(graph_pool(node_rep, batch, self.graph_pooling))
