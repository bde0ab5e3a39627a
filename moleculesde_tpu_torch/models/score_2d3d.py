"""2D->3D frame-based SE(3)-equivariant score model, channel-major sampling
path (variants 1 and 2).

Counterpart of ``moleculesde_tpu/models/score_2d3d.py`` (reference
Geom3D/models/MoleculeSDE/SDE_model_2D_to_3D.py, SDEModel2Dto3D_01/02, and
equivariant_scorenetwork.py).  Per-pair quantities live on dense tensors
indexed ``[batch, source, dest]`` and masked by the extended adjacency;
pair tensors of the score evaluation are channel-major ``[B, C, N*N]`` with
the flat pair index ``p = s * N + d``.  The conditioning (2D edge
embedding, node embedding, pair mask) depends on the graph only and is
computed once per chain (:meth:`SDEModel2Dto3D.precompute_conditioning`);
:meth:`SDEModel2Dto3D.score_from_cond_cm` evaluates the score at given
positions.  :meth:`SDEModel2Dto3D.loss` is the denoising score-matching
training loss, which runs the same channel-major path (the JAX package's
``loss_layout="channel"``) with dropout in the attention layers.

``score_dtype="bfloat16"`` runs the invariant-feature and score-network
pipeline in bf16 (frame geometry, softmax and the equivariant mixing stay
f32), as the JAX package's sampler does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from moleculesde_tpu_torch.core.batch import GraphBatch, dense_scatter
from moleculesde_tpu_torch.core.segment import masked_segment_mean
from moleculesde_tpu_torch.models.layers import (
    MLP, Dense, LayerNorm, PairMaskedBatchNorm, dropout, init_parameters)
from moleculesde_tpu_torch.ops.common import EPSILON, SQRT_GUARD
from moleculesde_tpu_torch.ops.fourier import gaussian_fourier_projection_cm
from moleculesde_tpu_torch.ops.pair_block import pair_relu_project
from moleculesde_tpu_torch.sde.base import SDE, make_sde
from moleculesde_tpu_torch.utils.device import resolve_device


class PairDense(nn.Module):
    """Linear over concat(h_s, h_d) without building the concatenation: the
    ``[2F, out]`` kernel splits into source and dest halves applied per
    node; the pair value is ``src[:, :, None] + dst[:, None, :]``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(2 * in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, h: torch.Tensor):
        f = h.shape[-1]
        return h @ self.kernel[:f], h @ self.kernel[f:] + self.bias


def dense_frames_flat(pos: torch.Tensor):
    """All-pairs frame basis and invariant coefficients, every plane
    pair-flattened to ``[B, N*N]`` (``p = s*N + d``).

    Returns ``(basis, (c0, c2), (pseudo_sin, pseudo_cos))``: ``basis`` is
    the (diff, cross, vertical) triple of component triples, ``(c0, c2)``
    the two source-frame coefficients the Fourier features embed."""
    n = pos.shape[1]
    comps = [pos[..., k] for k in range(3)]             # [B, N]
    ps = [c.repeat_interleave(n, dim=1) for c in comps]  # source: p // N
    pd = [c.repeat(1, n) for c in comps]                 # dest:   p % N

    diff = [s - d for s, d in zip(ps, pd)]
    cross = [ps[1] * pd[2] - ps[2] * pd[1],
             ps[2] * pd[0] - ps[0] * pd[2],
             ps[0] * pd[1] - ps[1] * pd[0]]

    def norm3(v):
        return torch.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2 + SQRT_GUARD)

    dn = norm3(diff) + EPSILON
    diff = [v / dn for v in diff]
    cn = norm3(cross) + EPSILON
    cross = [v / cn for v in cross]
    vert = [diff[1] * cross[2] - diff[2] * cross[1],
            diff[2] * cross[0] - diff[0] * cross[2],
            diff[0] * cross[1] - diff[1] * cross[0]]

    def proj(r):  # project r onto the frame (component 1 is |.|-folded)
        return (diff[0] * r[0] + diff[1] * r[1] + diff[2] * r[2],
                torch.abs(cross[0] * r[0] + cross[1] * r[1] + cross[2] * r[2]),
                vert[0] * r[0] + vert[1] * r[1] + vert[2] * r[2])

    coff_s = proj(ps)
    coff_d = proj(pd)
    dot = sum(a * b for a, b in zip(coff_s, coff_d))
    pseudo_cos = dot / (norm3(coff_s) + EPSILON) / (norm3(coff_d) + EPSILON)
    pseudo_sin = torch.sqrt(torch.clamp(1.0 - pseudo_cos ** 2, min=1e-12))
    return (diff, cross, vert), (coff_s[0], coff_s[2]), (pseudo_sin, pseudo_cos)


class DenseGATLayer(nn.Module):
    """TransformerConv + FFN with post-norm residuals as masked dense
    attention, channel-major pair input ``[B, H, N*N]``.

    logits = q_d . (k_s + e_sd) / sqrt(c), softmax over sources s per
    destination d (f32, ``finfo.min`` masking, then ``alpha * mask`` so an
    isolated destination gets zero weights), messages (v_s + e_sd) * alpha
    summed at d, plus a root-skip linear.  In training (``deterministic``
    False) dropout at ``dropout`` hits the attention weights and the FFN's
    hidden layer, as in the JAX module."""

    def __init__(self, hidden_dim: int, n_head: int, edge_dim: int,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        super().__init__()
        self.n_head = n_head
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        self.dropout = dropout
        hd = hidden_dim  # n_head * (hidden_dim // n_head)
        self.lin_query = Dense(hidden_dim, hd)
        self.lin_key = Dense(hidden_dim, hd)
        self.lin_value = Dense(hidden_dim, hd)
        self.lin_edge = Dense(edge_dim, hd)
        self.lin_skip = Dense(hidden_dim, hd, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(hd, dtype=dtype)
        self.Dense_0 = Dense(hd, hidden_dim, dtype=dtype)
        self.Dense_1 = Dense(hidden_dim, hidden_dim, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(hidden_dim, dtype=dtype)

    def _attend_cm(self, x, edge_cm, pair_mask, deterministic, generator):
        h = self.n_head
        c = self.hidden_dim // h
        hd = h * c
        b, n, _ = x.shape
        dt = self.dtype or x.dtype
        xd = x.to(dt)
        wqkv = torch.cat([self.lin_query.kernel, self.lin_key.kernel,
                          self.lin_value.kernel], dim=1).to(dt)
        bqkv = torch.cat([self.lin_query.bias, self.lin_key.bias,
                          self.lin_value.bias]).to(dt)
        qkv = torch.einsum("bnf,fo->bon", xd, wqkv) + bqkv[None, :, None]
        q_t, k_t, v_t = qkv[:, :hd], qkv[:, hd:2 * hd], qkv[:, 2 * hd:]
        e_cm = (torch.einsum("bcp,co->bop", edge_cm.to(dt), self.lin_edge.kernel.to(dt))
                + self.lin_edge.bias.to(dt)[None, :, None])
        e4 = e_cm.reshape(b, hd, n, n)                        # [b, C, s, d]
        ke = (k_t[:, :, :, None] + e4) * q_t[:, :, None, :]
        logits = ke.reshape(b, h, c, n, n).sum(dim=2).float() / math.sqrt(float(c))
        neg = torch.finfo(torch.float32).min
        mask4 = pair_mask[:, None, :, :]
        alpha = torch.softmax(torch.where(mask4, logits, neg), dim=2)
        alpha = dropout(alpha * mask4, self.dropout, generator, deterministic)
        alpha_full = alpha.to(dt)[:, :, None].expand(b, h, c, n, n).reshape(b, hd, n, n)
        return torch.einsum("bcsd->bdc", alpha_full * (v_t[:, :, :, None] + e4))

    def forward(self, x, edge_cm, pair_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        mha = (self._attend_cm(x, edge_cm, pair_mask, deterministic, generator)
               + self.lin_skip(x))
        x = x + self.LayerNorm_0(mha)
        ffn = dropout(F.silu(self.Dense_0(x)), self.dropout, generator, deterministic)
        return x + self.LayerNorm_1(self.Dense_1(ffn))


class EquivariantScoreNetwork(nn.Module):
    """Stacked GAT modules emitting a per-node equivariant 3-vector score
    (ref equivariant_scorenetwork.py:84-169), channel-major pair input.

    After each module of ``num_convs`` GAT layers, a basis MLP on
    ``[h_s + h_d, e_sd]`` emits 3 coefficients per pair that mix the frame
    basis; their mean over valid sources at each destination accumulates
    into the score.  ``short_cut`` and ``concat_hidden`` (off in every
    configuration the samplers run) are not ported."""

    def __init__(self, hidden_dim: int, hidden_coff_dim: int = 128,
                 num_layers: int = 2, num_convs: int = 2, n_head: int = 8,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.num_convs = num_convs
        self.dtype = dtype
        for i in range(num_layers * num_convs):
            setattr(self, f"DenseGATLayer_{i}",
                    DenseGATLayer(hidden_dim, n_head, hidden_dim, dtype, dropout))
        for m in range(num_layers):
            setattr(self, f"basis_node_{m}",
                    Dense(hidden_dim, hidden_coff_dim, use_bias=False))
            setattr(self, f"basis_edge_{m}", Dense(hidden_dim, hidden_coff_dim))
            setattr(self, f"basis_out_{m}", Dense(hidden_coff_dim, 3))

    def _coff_mix_cm(self, m, node_f, edge_cm, basis, maskf):
        wh = getattr(self, f"basis_node_{m}").kernel
        be_mod = getattr(self, f"basis_edge_{m}")
        wo_mod = getattr(self, f"basis_out_{m}")
        dt = self.dtype or node_f.dtype
        b, n, _ = node_f.shape
        cd = wh.shape[1]
        h_part = node_f.to(dt) @ wh.to(dt)                            # [B, N, cd]
        e_part = (torch.einsum("bcp,co->bpo", edge_cm.to(dt), be_mod.kernel.to(dt))
                  + be_mod.bias.to(dt))                               # [B, NN, cd]
        coff = F.silu(h_part[:, :, None, :] + h_part[:, None, :, :]
                      + e_part.reshape(b, n, n, cd))
        c = (torch.einsum("bpf,fc->cbp", coff.reshape(b, n * n, cd), wo_mod.kernel.to(dt))
             .float() + wo_mod.bias[:, None, None])                  # [3, B, NN]
        # mix the basis per component, then sum over sources s (p // N)
        return [((c[0] * bx[0] + c[1] * bx[1] + c[2] * bx[2]) * maskf
                 ).reshape(b, n, n).sum(dim=1)
                for bx in zip(*basis)]

    def forward(self, node_attr, edge_cm, pair_mask, basis, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """node_attr [B, N, H]; edge_cm [B, H, N*N]; pair_mask [B, N, N] bool;
        ``basis`` from :func:`dense_frames_flat`.  Returns [B, N, 3] f32.
        ``deterministic=False`` turns dropout on (masks from ``generator``)."""
        b, n, _ = node_attr.shape
        count = pair_mask.sum(dim=1).clamp(min=1)          # valid sources per dest
        maskf = pair_mask.reshape(b, n * n).to(node_attr.dtype)
        grad = [torch.zeros((b, n), dtype=node_attr.dtype, device=node_attr.device)
                for _ in range(3)]
        conv_input = node_attr
        for m in range(self.num_layers):
            for conv in range(self.num_convs):
                layer = getattr(self, f"DenseGATLayer_{m * self.num_convs + conv}")
                hidden = layer(conv_input, edge_cm, pair_mask, deterministic, generator)
                if conv < self.num_convs - 1:
                    hidden = F.silu(hidden)
                conv_input = hidden
            mixed = self._coff_mix_cm(m, conv_input, edge_cm, basis, maskf)
            grad = [g + mx / count for g, mx in zip(grad, mixed)]
        return torch.stack(grad, dim=-1)


class SDEModel2Dto3D(nn.Module):
    """SDEModel2Dto3D variants 1 and 2 (reference SDE_model_2D_to_3D.py):
      1: edge_attr = edge_2D_emb + frame_invariant                  (l.69-249)
      2: edge_attr = dist_inv * edge_2D_emb + frame_invariant       (l.252-445)

    Parameter names and shapes are the JAX module's.  Built on the CPU,
    initialized from ``generator`` (default: seed 0), then moved to
    ``device`` ("cuda" by default; raises without a GPU unless "cpu").
    ``pair_impl`` selects the pair block: "auto" (kernel on a CUDA tensor,
    plain on a CPU tensor), "kernel" or "plain"; ``bf16_pairs`` runs it in
    its bf16 mode (pretraining's choice; the samplers keep f32)."""

    def __init__(self, emb_dim: int, hidden_dim: int = 32, variant: int = 2,
                 beta_min: float = 0.2, beta_max: float = 1.0,
                 num_diffusion_timesteps: int = 1000, sde_type: str = "VE",
                 use_extend_graph: bool = True, score_dtype: str = "float32",
                 bf16_pairs: bool = False, pair_impl: str = "auto",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if variant not in (1, 2):
            raise NotImplementedError(
                f"SDEModel2Dto3D variant {variant} is not ported yet (1, 2 are)")
        dev = resolve_device(device)
        h = hidden_dim
        self.emb_dim = emb_dim
        self.hidden_dim = h
        self.variant = variant
        self.sde_pos: SDE = make_sde(sde_type, beta_min, beta_max,
                                     num_diffusion_timesteps)
        self.use_extend_graph = use_extend_graph
        self.score_dtype = score_dtype
        self.bf16_pairs = bf16_pairs
        self.pair_impl = pair_impl
        dt = torch.bfloat16 if score_dtype == "bfloat16" else None
        self.cdt = dt or torch.float32
        self.edge_2D_emb_0 = PairDense(emb_dim, emb_dim)
        self.edge_2D_emb_bn = PairMaskedBatchNorm(emb_dim)
        self.edge_2D_emb_1 = Dense(emb_dim, h)
        self.coff_fourier_W = nn.Parameter(torch.empty(h), requires_grad=False)
        self.coff_mlp = Dense(4 * h, h)
        self.project = MLP(2 + 2 * h, [h, h], activation="silu", dtype=dt)
        if variant == 2:
            self.dist_fourier_W = nn.Parameter(torch.empty(h), requires_grad=False)
            self.input_mlp = MLP(2 * h, [h], activation="silu", dtype=dt)
        self.node_emb = MLP(emb_dim, [h], activation="silu", dtype=dt)
        self.score_network = EquivariantScoreNetwork(hidden_dim=h, dtype=dt)
        init_parameters(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    def _pair_mask_attr(self, batch: GraphBatch):
        """Dense [B, N, N] extended-adjacency mask and edge labels, indexed
        [b, s, d].  Masked edges are dropped by the scatter."""
        if self.use_extend_graph:
            src, dst, emask, eattr = (batch.ext_src, batch.ext_dst,
                                      batch.ext_mask, batch.ext_attr)
        else:
            src, dst, emask = batch.edge_src, batch.edge_dst, batch.edge_mask
            eattr = batch.edge_feats[:, 0] + 1
        b, n = batch.num_graphs, batch.n_max
        mask = dense_scatter(src, dst, emask, torch.ones_like(emask), b, n)
        return mask, dense_scatter(src, dst, emask, eattr.int(), b, n)

    def pair_block_inputs(self, node_2d_repr: torch.Tensor, batch: GraphBatch,
                          pair_mask: torch.Tensor, use_running_average: bool = True):
        """The pair block's operands (a, c [B, N, emb] f32, W [emb, H],
        bias [H]): the 2D edge embedding Linear over concat(h_s, h_d) and
        its masked BatchNorm, folded into the node halves (reference
        SDE_model_2D_to_3D.py:344-352)."""
        h2d = node_2d_repr.reshape(batch.num_graphs, batch.n_max, -1)
        src_p, dst_p = self.edge_2D_emb_0(h2d)
        a, c = self.edge_2D_emb_bn(src_p, dst_p, pair_mask, use_running_average)
        return (a.contiguous(), c.contiguous(),
                self.edge_2D_emb_1.kernel.float().contiguous(),
                self.edge_2D_emb_1.bias.float().contiguous())

    def precompute_conditioning(self, node_2d_repr: torch.Tensor,
                                batch: GraphBatch,
                                use_running_average: bool = True
                                ) -> Dict[str, torch.Tensor]:
        """Position-independent conditioning, channel-major layout:
        ``edge_attr_2d`` [B, H, N*N] (score dtype), ``node_attr`` [B, N, H],
        ``pair_mask`` [B, N, N].  One pair-block launch."""
        b, n = batch.num_graphs, batch.n_max
        pair_mask, _ = self._pair_mask_attr(batch)
        edge_attr_2d = pair_relu_project(
            *self.pair_block_inputs(node_2d_repr, batch, pair_mask, use_running_average),
            bf16=self.bf16_pairs, impl=self.pair_impl)
        node_attr = self.node_emb(node_2d_repr.reshape(b, n, -1))
        edge_attr_2d = edge_attr_2d.to(self.cdt).reshape(b, n * n, -1
                                                         ).transpose(1, 2).contiguous()
        return {"edge_attr_2d": edge_attr_2d, "node_attr": node_attr,
                "pair_mask": pair_mask}

    def score_from_cond_cm(self, cond: Dict[str, torch.Tensor], pos: torch.Tensor,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Raw network output at positions ``pos`` [B*N, 3] -> [B*N, 3] f32,
        from conditioning precomputed by :meth:`precompute_conditioning`
        (dropout on when ``deterministic`` is False)."""
        h = self.hidden_dim
        pair_mask = cond["pair_mask"]
        b, n = pair_mask.shape[0], pair_mask.shape[1]
        nn_ = n * n
        edge2d_cm = cond["edge_attr_2d"]
        cdt = self.cdt
        pos3 = pos.reshape(b, n, 3)
        basis, (c0, c2), (pseudo_sin, pseudo_cos) = dense_frames_flat(pos3)

        # Fourier features of the source-frame coefficients only: under the
        # s<->d swap coff_d is the pair transpose of coff_s with component 0
        # negated, so embed_d is the same sin/cos slab through coff_mlp with
        # the sin(c0) weight block negated, pair-transposed.
        w_coff = self.coff_fourier_W
        full = torch.cat([gaussian_fourier_projection_cm(c0, w_coff),
                          gaussian_fourier_projection_cm(c2, w_coff)], dim=1).to(cdt)
        wm_c = self.coff_mlp.kernel.to(cdt)      # rows: [sin0 | cos0 | sin2 | cos2]
        wm_neg = torch.cat([-wm_c[:h], wm_c[h:]], dim=0)
        bm_c = self.coff_mlp.bias.to(cdt)[None, :, None]
        embed_s = torch.einsum("bcp,co->bop", full, wm_c) + bm_c
        embed_d = (torch.einsum("bcp,co->bop", full, wm_neg)
                   .reshape(b, h, n, n).transpose(2, 3).reshape(b, h, nn_)) + bm_c
        edge_embed = torch.cat([pseudo_sin[:, None, :].to(cdt),
                                pseudo_cos[:, None, :].to(cdt), embed_s, embed_d], dim=1)
        frame_inv = self.project(edge_embed, channel_major=True)

        if self.variant == 2:
            sq = sum((pos3[..., k].repeat_interleave(n, dim=1)
                      - pos3[..., k].repeat(1, n)) ** 2 for k in range(3))
            dist = torch.sqrt(sq + SQRT_GUARD)
            dist_emb = gaussian_fourier_projection_cm(dist, self.dist_fourier_W)
            edge_attr = self.input_mlp(dist_emb, channel_major=True) * edge2d_cm + frame_inv
        else:
            edge_attr = edge2d_cm + frame_inv
        edge_attr = edge_attr * pair_mask.reshape(b, 1, nn_)

        out = self.score_network(cond["node_attr"], edge_attr, pair_mask, basis,
                                 deterministic, generator)
        return out.reshape(b * n, 3)

    def draw(self, batch: GraphBatch, generator: Optional[torch.Generator]
             ) -> Dict[str, torch.Tensor]:
        """The loss's random draws: ``pos_noise`` [B*N, 3] ~ N(0, 1) and the
        antithetic timestep half ``half`` [B // 2 + 1] ~ U{0 .. steps-1}."""
        dev = batch.positions.device
        return {"pos_noise": torch.randn(batch.positions.shape, generator=generator,
                                         device=dev),
                "half": torch.randint(0, self.sde_pos.N, (batch.num_graphs // 2 + 1,),
                                      generator=generator, device=dev)}

    def loss(self, node_2d_repr: torch.Tensor, batch: GraphBatch,
             generator: Optional[torch.Generator] = None, anneal_power: float = 0.0,
             deterministic: bool = False, use_running_average: bool = False,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Denoising score-matching loss (ref SDE_model_2D_to_3D.py:306-391;
        JAX ``SDEModel2Dto3D.loss``): antithetic discrete timesteps per graph,
        positions perturbed by the SDE's marginal, the squared error of the
        score against the noise averaged over each graph's atoms, then over
        graphs.  Draws come from ``generator`` unless ``draws`` (as
        :meth:`draw` makes them) is given; in training mode the pair
        BatchNorm updates its running statistics."""
        sde = self.sde_pos
        b = batch.num_graphs
        node2graph = batch.node2graph()
        d = draws if draws is not None else self.draw(batch, generator)
        pos_noise, half = d["pos_noise"], d["half"]
        time_step = torch.cat([half, sde.N - half - 1])[:b]
        time_step = time_step / sde.N * (1 - EPSILON) + EPSILON
        t_pos = time_step[node2graph]
        mean_pos, std_pos = sde.marginal_prob(batch.positions, t_pos)
        pos_perturbed = mean_pos + std_pos[:, None] * pos_noise
        cond = self.precompute_conditioning(node_2d_repr, batch, use_running_average)
        scores = self.score_from_cond_cm(cond, pos_perturbed, deterministic, generator)
        loss_pos = ((scores - pos_noise) ** 2).sum(dim=-1)
        if anneal_power != 0.0:
            loss_pos = loss_pos * std_pos ** anneal_power
        return masked_segment_mean(loss_pos, node2graph, b, batch.node_mask).mean()
