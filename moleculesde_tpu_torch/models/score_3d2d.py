"""3D->2D dense node / adjacency score model, variants 1-3.

Counterpart of ``moleculesde_tpu/models/score_3d2d.py`` (reference
Geom3D/models/MoleculeSDE/SDE_model_3D_to_2D_node_adj_dense.py,
invariant_scorenetwork_dense.py, layers/edge_network_dense.py and
layers/node_network_dense.py): the conditioned diffusion over (atom-type
one-hots, dense bond adjacency).  Its node state is conditioned on the 3D
latent as ``embedding_3D(repr) + embedding_X(x)`` (variant 1), as their
concatenation (variant 2, networks twice as wide), or as the concatenation
with ``embedding_3D(repr)`` also joined to every layer's input (variant 3,
the reference's "_03" networks).  Everything runs on dense ``[B, N, N]``
tensors of the fixed bucket ``N``.  Parameter names and shapes are the JAX
module's (channel-stacked q/k/v kernels ``[C, in, out]``), so a converted
flax tree loads with ``load_state_dict``.

``bf16_attn`` runs the edge networks (q/k MLPs, attention maps, value
aggregation, the channel MLPs) in bf16 as the JAX package's pretraining
does; the node network, the losses and the parameters stay f32.
``attn_impl`` picks the attention bank, with the JAX module's values:
"auto" / "xla" and "wide" (eager, ``ops/attn_maps.py``), "pallas" (the map
kernel K7, ``ops/attn_bank.py``) or "fused" (the q/k nets and the map in
one kernel, K8, ``ops/attn_qk_bank.py``); ``kernel_impl`` ("auto",
"kernel" or "plain") the implementation of K7 and K8 behind it, as the
other kernel wrappers' ``impl``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from moleculesde_tpu_torch.core.batch import NUM_ATOM_CLASSES, GraphBatch
from moleculesde_tpu_torch.core.masks import mask_adjs, mask_x, node_flags
from moleculesde_tpu_torch.models.layers import MLP, Dense, init_parameters
from moleculesde_tpu_torch.ops.attn_maps import attn_map_bank
from moleculesde_tpu_torch.ops.attn_qk_bank import attn_qk_bank
from moleculesde_tpu_torch.ops.common import EPSILON
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.sde.base import SDE, make_sde
from moleculesde_tpu_torch.utils.device import resolve_device


ATTN_IMPLS = ("auto", "xla", "wide", "pallas", "fused")


def pow_tensor(adj: torch.Tensor, cnum: int) -> torch.Tensor:
    """Adjacency powers ``[B, N, N]`` -> ``[B, cnum, N, N]`` (A, A^2, ...)."""
    xs = [adj]
    for _ in range(cnum - 1):
        xs.append(torch.bmm(xs[-1], adj))
    return torch.stack(xs, dim=1)


def _norm_adj(adj: torch.Tensor) -> torch.Tensor:
    """D^-1/2 (A + I) D^-1/2 with the self loops set to 1 and degrees
    clipped at 1, over the last two axes."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    adj = adj * (1 - eye) + eye
    d = adj.sum(dim=-1).clamp(min=1.0) ** -0.5
    return d[..., :, None] * adj * d[..., None, :]


class NodeNetworkDense(nn.Module):
    """Dense normalized-adjacency GCN layer ``D^-1/2 (A+I) D^-1/2 X W + b``
    (ref node_network_dense.py:46-85)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.Dense_0 = Dense(in_channels, out_channels)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return torch.bmm(_norm_adj(adj), self.Dense_0(x))


class StackedEdgeLayers(nn.Module):
    """The C adjacency channels' attention layers with channel-stacked
    parameters (ref edge_network_dense.py:33-82): per channel a two-layer
    tanh MLP for q and for k, multi-head symmetric tanh attention maps, and
    a dense-GCN value ``D^-1/2 (A_c + I) D^-1/2 X W_c + b_c``.  With
    ``node_3d`` given (variant 3, ref l.131-180) it is concatenated to the
    node features before the q/k nets and the value; ``in_dim`` counts it."""

    def __init__(self, channels: int, in_dim: int, attn_dim: int, out_dim: int,
                 num_heads: int = 4, dtype: Optional[torch.dtype] = None,
                 attn_impl: str = "auto", kernel_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl} (one of {ATTN_IMPLS})")
        self.ds = attn_dim // num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.kernel_impl = kernel_impl
        a2 = 2 * attn_dim
        for p in ("q", "k"):
            setattr(self, f"{p}_kernel_0", nn.Parameter(torch.empty(channels, in_dim, a2)))
            setattr(self, f"{p}_bias_0", nn.Parameter(torch.zeros(channels, a2)))
            setattr(self, f"{p}_kernel_1", nn.Parameter(torch.empty(channels, a2, a2)))
            setattr(self, f"{p}_bias_1", nn.Parameter(torch.zeros(channels, a2)))
        self.v_kernel = nn.Parameter(torch.empty(channels, in_dim, out_dim))
        self.v_bias = nn.Parameter(torch.zeros(channels, out_dim))

    def qk_params(self) -> Tuple[torch.Tensor, ...]:
        """(Wq1, bq1, Wq2, bq2, Wk1, bk1, Wk2, bk2), the raw parameters."""
        return tuple(getattr(self, f"{p}_{kind}_{i}") for p in ("q", "k")
                     for i in (0, 1) for kind in ("kernel", "bias"))

    def qk(self, x: torch.Tensor, p: str, dt: torch.dtype) -> torch.Tensor:
        """q (``p="q"``) or k [B, C, N, A] of the node features ``x`` in ``dt``."""
        h = torch.tanh(torch.einsum("bnf,cfa->bcna", x, getattr(self, f"{p}_kernel_0").to(dt))
                       + getattr(self, f"{p}_bias_0").to(dt)[None, :, None])
        return (torch.einsum("bcna,cao->bcno", h, getattr(self, f"{p}_kernel_1").to(dt))
                + getattr(self, f"{p}_bias_1").to(dt)[None, :, None])

    def forward(self, x: torch.Tensor, adjc: torch.Tensor,
                node_3d: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, N, F]; adjc [B, C, N, N] -> (v [B, C, N, out], a [B, C, N, N])
        in the compute dtype."""
        qk_in = x if node_3d is None else torch.cat([x, node_3d], dim=-1)
        dt = self.dtype or qk_in.dtype
        bf16 = dt == torch.bfloat16
        if self.attn_impl == "fused":
            a = attn_qk_bank(qk_in, *self.qk_params(), self.ds, bf16=bf16,
                             impl=self.kernel_impl)
        else:
            xd = qk_in.to(dt)
            a = attn_map_bank(self.qk(xd, "q", dt), self.qk(xd, "k", dt), self.ds,
                              bf16=bf16, impl=self.attn_impl, kernel_impl=self.kernel_impl)
        a = a.to(dt)
        a = (a + a.transpose(-1, -2)) / 2.0
        hv = torch.einsum("bnf,cfo->bcno", qk_in.to(dt), self.v_kernel.to(dt))
        v = (torch.einsum("bcij,bcjo->bcio", _norm_adj(adjc).to(dt), hv)
             + self.v_bias.to(dt)[None, :, None])
        return v, a


class EdgeNetworkDense(nn.Module):
    """Attention bank plus the node and channel-fusion MLPs (ref
    edge_network_dense.py:85-128).  Returns (x_out [B, N, out] f32,
    adj_out [B, C_out, N, N] f32, symmetric and masked)."""

    def __init__(self, num_linears: int, in_dim: int, attn_dim: int,
                 conv_output_dim: int, input_dim: int, output_dim: int,
                 num_heads: int = 4, dtype: Optional[torch.dtype] = None,
                 attn_impl: str = "auto", kernel_impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.output_dim = output_dim
        hidden = 2 * max(input_dim, output_dim)
        self.attn = StackedEdgeLayers(input_dim, in_dim, attn_dim, conv_output_dim,
                                      num_heads, dtype, attn_impl, kernel_impl)
        self.multi_channel = MLP(input_dim * conv_output_dim, [hidden, conv_output_dim],
                                 activation="elu", dtype=dtype)
        self.mlp = MLP(2 * input_dim, [hidden] * (num_linears - 1) + [output_dim],
                       activation="elu", dtype=dtype)

    def forward(self, x, adjc, flags, node_3d=None):
        v, attn_maps = self.attn(x, adjc, node_3d)
        b, c, n, out = v.shape
        x_out = self.multi_channel(v.permute(0, 2, 1, 3).reshape(b, n, c * out))
        x_out = torch.tanh(mask_x(x_out, flags))
        adjc_c = adjc.to(self.dtype) if self.dtype else adjc
        mlp_in = torch.cat([attn_maps, adjc_c], dim=1).reshape(b, 2 * c, n * n)
        adj_out = self.mlp(mlp_in, channel_major=True).reshape(b, self.output_dim, n, n)
        adj_out = (adj_out + adj_out.transpose(-1, -2)).float()
        return x_out, mask_adjs(adj_out, flags)


class EdgeScoreNetworkDense(nn.Module):
    """Adjacency score network over stacks of adjacency powers (ref
    invariant_scorenetwork_dense.py:40-93; with ``node_3d_dim`` > 0 the
    "_03" network of l.134-187, whose layers also read the 3D embedding)."""

    def __init__(self, in_dim: int, nhid: int = 16, num_layers: int = 4,
                 num_linears: int = 3, c_init: int = 2, c_hid: int = 8,
                 c_final: int = 4, adim: int = 16, num_heads: int = 4,
                 dtype: Optional[torch.dtype] = None, node_3d_dim: int = 0,
                 attn_impl: str = "auto", kernel_impl: str = "auto"):
        super().__init__()
        self.c_init = c_init
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_{i}", EdgeNetworkDense(
                num_linears, (in_dim if i == 0 else nhid) + node_3d_dim,
                nhid if i == 0 else adim, nhid, c_init if i == 0 else c_hid,
                c_final if i == num_layers - 1 else c_hid, num_heads, dtype, attn_impl,
                kernel_impl))
        fdim = c_hid * (num_layers - 1) + c_final + c_init
        self.final = MLP(fdim, [2 * fdim, 2 * fdim, 1], activation="silu", dtype=dtype)

    def forward(self, x, adj, flags, node_3d=None):
        adjc = pow_tensor(adj, self.c_init)
        adj_list = [adjc]
        for i in range(self.num_layers):
            x, adjc = getattr(self, f"layer_{i}")(x, adjc, flags, node_3d)
            adj_list.append(adjc)
        adjs = torch.cat(adj_list, dim=1)
        b, _, n, _ = adjs.shape
        score = self.final(adjs.reshape(b, -1, n * n), channel_major=True)
        score = score.float().reshape(b, n, n)
        score = score * (1.0 - torch.eye(n, device=score.device))[None]
        return mask_adjs(score, flags)


class NodeScoreNetworkDense(nn.Module):
    """Node score network: dense-GCN stack with tanh, JK concatenation, MLP
    head (ref invariant_scorenetwork_dense.py:96-131; with ``node_3d_dim``
    > 0 the "_03" network of l.190-225, which joins the 3D embedding to
    every layer's input but not to the JK concatenation)."""

    def __init__(self, in_dim: int, nhid: int = 16, depth: int = 4,
                 nout: int = NUM_ATOM_CLASSES, node_3d_dim: int = 0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"layer_{i}",
                    NodeNetworkDense((in_dim if i == 0 else nhid) + node_3d_dim, nhid))
        fdim = in_dim + depth * nhid
        self.final = MLP(fdim, [2 * fdim, 2 * fdim, nout], activation="silu")

    def forward(self, x, adj, flags, node_3d=None):
        xs = [x]
        for i in range(self.depth):
            h = xs[-1] if node_3d is None else torch.cat([xs[-1], node_3d], dim=-1)
            xs.append(torch.tanh(getattr(self, f"layer_{i}")(h, adj)))
        return mask_x(self.final(torch.cat(xs, dim=-1)), flags)


class SDEModel3Dto2D(nn.Module):
    """Conditioned 3D->2D diffusion over (x, adj) (ref
    SDE_model_3D_to_2D_node_adj_dense.py): ``variant`` 1 conditions both
    score networks on ``embedding_3D(repr) + embedding_X(x)`` (l.13-179),
    2 on their concatenation with networks twice as wide (l.182-349), 3
    like 2 with ``embedding_3D(repr)`` joined to every layer's input
    (l.352-520).  ``attn_impl`` and ``kernel_impl`` as in
    :class:`StackedEdgeLayers`.  Built on
    the CPU, initialized from ``generator`` (default: seed 0), then moved
    to ``device`` ("cuda" by default; raises without a GPU unless "cpu")."""

    def __init__(self, dim3d: int, nhid: int = 16, num_layers: int = 4,
                 num_linears: int = 3, c_init: int = 2, c_hid: int = 8,
                 c_final: int = 4, adim: int = 16, num_heads: int = 4,
                 variant: int = 1, bf16_attn: bool = True, attn_impl: str = "auto",
                 kernel_impl: str = "auto", sde_type: str = "VE", beta_min: float = 0.1,
                 beta_max: float = 1.0,
                 num_diffusion_timesteps: int = 1000,
                 num_class_x: int = NUM_ATOM_CLASSES, noise_on_one_hot: bool = True,
                 device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in (1, 2, 3):
            raise ValueError(f"SDEModel3Dto2D variant {variant}: one of 1, 2, 3")
        dev = resolve_device(device)
        self.variant = variant
        self.num_class_x = num_class_x
        self.noise_on_one_hot = noise_on_one_hot
        self.sde: SDE = make_sde(sde_type, beta_min, beta_max, num_diffusion_timesteps)
        dt = torch.bfloat16 if bf16_attn else None
        x_channels = num_class_x if noise_on_one_hot else 1
        cond_dim = dim3d if variant == 1 else 2 * dim3d
        inject = dim3d if variant == 3 else 0
        self.embedding_3D = Dense(dim3d, dim3d)
        self.embedding_X = Dense(x_channels, dim3d)
        self.edge_score_network = EdgeScoreNetworkDense(
            cond_dim, nhid, num_layers, num_linears, c_init, c_hid, c_final, adim,
            num_heads, dt, inject, attn_impl, kernel_impl)
        self.node_score_network = NodeScoreNetworkDense(cond_dim, nhid, num_layers,
                                                        x_channels, inject)
        init_parameters(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    def apply_networks(self, node_3d_dense, x, adj, flags, which: str = "both"):
        """Raw (net_x, net_adj) at the node state (x, adj), before the
        ``-1 / std`` scaling.  ``which`` ("both", "x" or "adj") skips the
        network whose output is not needed and returns None in its place,
        as the sampler's adjacency-only corrector steps want."""
        if which not in ("both", "x", "adj"):
            raise ValueError(f"which={which}: one of 'both', 'x', 'adj'")
        emb3d = self.embedding_3D(node_3d_dense)
        embx = self.embedding_X(x)
        if self.variant == 1:
            cond, node_3d = emb3d + embx, None
        else:
            cond = torch.cat([emb3d, embx], dim=-1)
            node_3d = emb3d if self.variant == 3 else None
        net_adj = (self.edge_score_network(cond, adj, flags, node_3d)
                   if which in ("both", "adj") else None)
        net_x = (self.node_score_network(cond, adj, flags, node_3d)
                 if which in ("both", "x") else None)
        return net_x, net_adj

    def _std(self, t: torch.Tensor) -> torch.Tensor:
        return self.sde.marginal_prob(torch.zeros_like(t), t)[1][:, None, None]

    def score_x(self, node_3d_dense, x, adj, flags, t):
        """Node score ``-net_x / std(t)`` at the sampler state (x, adj); t [B]
        (ref inference 3D->2D l.227-237)."""
        return -self.apply_networks(node_3d_dense, x, adj, flags, which="x")[0] / self._std(t)

    def score_adj(self, node_3d_dense, x, adj, flags, t):
        """Adjacency score at the sampler state (ref ibid. l.239-249)."""
        return -self.apply_networks(node_3d_dense, x, adj, flags, which="adj")[1] / self._std(t)

    def scores(self, node_3d_dense, x, adj, flags, t):
        """(score_x, score_adj) from one evaluation of both networks: the
        sampler's corrector and predictor phases each read one state for
        both updates."""
        net_x, net_adj = self.apply_networks(node_3d_dense, x, adj, flags)
        std = self._std(t)
        return -net_x / std, -net_adj / std

    def draw(self, batch: GraphBatch, generator: Optional[torch.Generator]
             ) -> Dict[str, torch.Tensor]:
        """The loss's random draws: the antithetic timestep half ``half``
        [B // 2 + 1], the adjacency noise ``z_adj`` [B, N, N] (symmetrized
        by the loss) and the node noise ``z_x`` [B, N, X], all N(0, 1) but
        ``half`` ~ U{0 .. steps-1}.  Under a data-parallel group each is
        drawn at the global batch's shape; the noises are the rank's block,
        ``half`` the global batch's."""
        b, n = dp.global_shape((batch.num_graphs,))[0], batch.n_max
        dev = batch.positions.device
        xc = self.num_class_x if self.noise_on_one_hot else 1
        return {"half": torch.randint(0, self.sde.N, (b // 2 + 1,), generator=generator,
                                      device=dev),
                "z_adj": dp.block(torch.randn((b, n, n), generator=generator, device=dev)),
                "z_x": dp.block(torch.randn((b, n, xc), generator=generator, device=dev))}

    def loss(self, node_3d_repr: torch.Tensor, batch: GraphBatch,
             generator: Optional[torch.Generator] = None, anneal_power: float = 0.0,
             reduce_mean: bool = True,
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Joint denoising loss on (x, adj): returns (loss_x, loss_adj) (ref
        SDE_model_3D_to_2D_node_adj_dense.py:101-179; JAX
        ``SDEModel3Dto2D.loss``).  Draws come from ``generator`` unless
        ``draws`` (as :meth:`draw` makes them) is given."""
        sde = self.sde
        d = draws if draws is not None else self.draw(batch, generator)
        b = batch.num_graphs
        t = dp.block(torch.cat([d["half"], sde.N - d["half"] - 1])[:dp.global_shape((b,))[0]])
        t = t / sde.N * (1 - EPSILON) + EPSILON

        edge_attr = torch.where(batch.edge_mask, batch.edge_feats[:, 0].float() + 1.0,
                                torch.zeros((), device=batch.edge_mask.device))
        adj = batch.dense_adjacency(edge_attr)
        node_3d = batch.dense_nodes(node_3d_repr)
        z_idx = batch.dense_nodes(batch.atomic_numbers)
        flags = node_flags(adj)

        z_adj = mask_adjs(sde.prior_sampling_sym(adj.shape, z=d["z_adj"]), flags)
        mean_adj, std_adj = sde.marginal_prob(adj, t)
        perturbed_adj = mask_adjs(mean_adj + std_adj[:, None, None] * z_adj, flags)

        if self.noise_on_one_hot:
            classes = torch.arange(self.num_class_x, device=z_idx.device)
            x0 = (z_idx[..., None] == classes).float()
        else:
            x0 = z_idx.float()[..., None]
        z_x = mask_x(d["z_x"], flags)
        mean_x, std_x = sde.marginal_prob(x0, t)
        perturbed_x = mask_x(mean_x + std_x[:, None, None] * z_x, flags)

        net_x, net_adj = self.apply_networks(node_3d, perturbed_x, perturbed_adj, flags)
        losses_x = (-net_x / std_x[:, None, None] + z_x) ** 2
        losses_adj = (-net_adj / std_adj[:, None, None] + z_adj) ** 2
        if anneal_power != 0.0:
            losses_x = losses_x * (std_x ** anneal_power)[:, None, None]
            losses_adj = losses_adj * (std_adj ** anneal_power)[:, None, None]

        def reduce(v):
            v = v.reshape(b, -1)
            return v.mean(dim=-1) if reduce_mean else 0.5 * v.sum(dim=-1)

        return dp.global_mean(reduce(losses_x)), dp.global_mean(reduce(losses_adj))
