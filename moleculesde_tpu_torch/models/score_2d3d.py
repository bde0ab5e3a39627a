"""2D->3D frame-based SE(3)-equivariant score models (variants 1 to 4).

Counterpart of ``moleculesde_tpu/models/score_2d3d.py`` (reference
Geom3D/models/MoleculeSDE/SDE_model_2D_to_3D.py, SDEModel2Dto3D_01..04, and
equivariant_scorenetwork.py).  Per-pair quantities live on dense tensors
indexed ``[batch, source, dest]`` and masked by the extended adjacency.
The conditioning (2D edge embedding, node embedding, pair mask) depends on
the graph only and is computed once per chain
(:meth:`SDEModel2Dto3D.precompute_conditioning`); the score at given
positions comes from one of three methods with the same math:
- :meth:`SDEModel2Dto3D.score_from_cond_cm`: pair tensors channel-major
  ``[B, C, N*N]``, flat pair index ``p = s * N + d``;
- :meth:`SDEModel2Dto3D.score_from_cond`: feature-minor ``[B, N, N, C]``;
- :meth:`SDEModel2Dto3D.score_from_cond_fused`: one fused kernel (K6) on
  the feature-layout conditioning, forward only.
:meth:`SDEModel2Dto3D.loss` is the denoising score-matching training loss
in ``loss_layout`` (channel-major by default, as in JAX) with dropout in
the attention layers.

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
    MLP, Dense, Embed, LayerNorm, PairMaskedBatchNorm, dropout, init_parameters)
from moleculesde_tpu_torch.ops.common import EPSILON, SQRT_GUARD
from moleculesde_tpu_torch.ops.fourier import (
    gaussian_fourier_projection, gaussian_fourier_projection_cm)
from moleculesde_tpu_torch.ops.pair_block import pair_relu_project, pair_relu_project_cm
from moleculesde_tpu_torch.parallel import collectives as dp
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


def dense_frames(pos: torch.Tensor):
    """All-pairs frame basis and invariant coefficients on ``[B, N, N]``
    planes indexed ``[b, s, d]`` (JAX ``dense_frames``; reference
    coord2basis, SDE_model_2D_to_3D.py:35-47).

    Returns ``(basis, coff_s, coff_d, (pseudo_sin, pseudo_cos))``: ``basis``
    is the (diff, cross, vertical) triple of component triples, ``coff_s`` /
    ``coff_d`` the frame coefficients of the source and dest positions."""
    comps = [pos[..., k] for k in range(3)]             # [B, N]
    return _frames([c[:, :, None] for c in comps], [c[:, None, :] for c in comps])


def dense_frames_flat(pos: torch.Tensor):
    """All-pairs frame basis and invariant coefficients, every plane
    pair-flattened to ``[B, N*N]`` (``p = s*N + d``).

    Returns ``(basis, (c0, c2), (pseudo_sin, pseudo_cos))``: ``basis`` is
    the (diff, cross, vertical) triple of component triples, ``(c0, c2)``
    the two source-frame coefficients the Fourier features embed."""
    n = pos.shape[1]
    comps = [pos[..., k] for k in range(3)]             # [B, N]
    basis, coff_s, _, angle = _frames([c.repeat_interleave(n, dim=1) for c in comps],
                                      [c.repeat(1, n) for c in comps])
    return basis, (coff_s[0], coff_s[2]), angle


def _frames(ps, pd):
    """Frame math on source / dest component planes that broadcast
    together (``ps``, ``pd``: the x, y, z planes)."""
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
    return (diff, cross, vert), coff_s, coff_d, (pseudo_sin, pseudo_cos)


class DenseGATLayer(nn.Module):
    """TransformerConv + FFN with post-norm residuals as masked dense
    attention; the pair input is channel-major ``[B, H, N*N]`` or
    feature-minor ``[B, N, N, H]`` (``channel_major``), same parameters and
    math.

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

    def _attend(self, x, edge_attr, pair_mask, deterministic, generator):
        """Feature-minor form (JAX ``DenseGATLayer``, l.242-267): q, k, v and
        e in the layer's dtype, logits and softmax in f32."""
        h = self.n_head
        c = self.hidden_dim // h
        b, n, _ = x.shape
        dt = self.dtype or x.dtype
        xd = x.to(dt)

        def lin(inp, mod):
            return inp @ mod.kernel.to(dt) + mod.bias.to(dt)

        q4 = lin(xd, self.lin_query).reshape(b, n, h, c)
        k4 = lin(xd, self.lin_key).reshape(b, n, h, c)
        v4 = lin(xd, self.lin_value).reshape(b, n, h, c)
        e5 = lin(edge_attr.to(dt), self.lin_edge).reshape(b, n, n, h, c)
        logits = (torch.einsum("bdhc,bshc->bhsd", q4, k4).float()
                  + torch.einsum("bdhc,bsdhc->bhsd", q4, e5).float()) / math.sqrt(float(c))
        mask4 = pair_mask[:, None, :, :]
        alpha = torch.softmax(torch.where(mask4, logits, torch.finfo(torch.float32).min),
                              dim=2)
        alpha = dropout(alpha * mask4, self.dropout, generator, deterministic).to(v4.dtype)
        out = (torch.einsum("bhsd,bshc->bdhc", alpha, v4)
               + torch.einsum("bhsd,bsdhc->bdhc", alpha, e5))
        return out.reshape(b, n, h * c)

    def forward(self, x, edge_attr, pair_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, channel_major: bool = True):
        attend = self._attend_cm if channel_major else self._attend
        mha = attend(x, edge_attr, pair_mask, deterministic, generator) + self.lin_skip(x)
        x = x + self.LayerNorm_0(mha)
        ffn = dropout(F.silu(self.Dense_0(x)), self.dropout, generator, deterministic)
        return x + self.LayerNorm_1(self.Dense_1(ffn))


class EquivariantScoreNetwork(nn.Module):
    """Stacked GAT modules emitting a per-node equivariant 3-vector score
    (ref equivariant_scorenetwork.py:84-169), channel-major pair input.

    After each module of ``num_convs`` GAT layers, a basis MLP on
    ``[h_s + h_d, e_sd]`` emits 3 coefficients per pair that mix the frame
    basis; their mean over valid sources at each destination accumulates
    into the score.  ``short_cut`` adds each GAT layer's input to its output
    (after the silu); ``concat_hidden`` feeds the basis MLP of module m the
    concatenation of every GAT output so far, so ``basis_node_m`` takes
    ``hidden_dim * num_convs * (m + 1)`` features (JAX l.397-414)."""

    def __init__(self, hidden_dim: int, hidden_coff_dim: int = 128,
                 num_layers: int = 2, num_convs: int = 2, n_head: int = 8,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1,
                 short_cut: bool = False, concat_hidden: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.num_convs = num_convs
        self.n_head = n_head
        self.dtype = dtype
        self.short_cut = short_cut
        self.concat_hidden = concat_hidden
        for i in range(num_layers * num_convs):
            setattr(self, f"DenseGATLayer_{i}",
                    DenseGATLayer(hidden_dim, n_head, hidden_dim, dtype, dropout))
        for m in range(num_layers):
            node_width = hidden_dim * num_convs * (m + 1) if concat_hidden else hidden_dim
            setattr(self, f"basis_node_{m}",
                    Dense(node_width, hidden_coff_dim, use_bias=False))
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

    def _coff_mix(self, m, node_f, edge_attr, basis, maskf):
        """Feature-minor form (JAX ``coff_mix``, l.422-438): ``edge_attr``
        [B, N, N, H], basis planes [B, N, N]."""
        wh = getattr(self, f"basis_node_{m}").kernel
        be_mod = getattr(self, f"basis_edge_{m}")
        wo_mod = getattr(self, f"basis_out_{m}")
        dt = self.dtype or node_f.dtype
        h_part = node_f.to(dt) @ wh.to(dt)                            # [B, N, cd]
        e_part = edge_attr.to(dt) @ be_mod.kernel.to(dt) + be_mod.bias.to(dt)
        coff = F.silu(h_part[:, :, None, :] + h_part[:, None, :, :] + e_part)
        c = (torch.einsum("bsdf,fc->cbsd", coff, wo_mod.kernel.to(dt)).float()
             + wo_mod.bias[:, None, None, None])                     # [3, B, N, N]
        return [((c[0] * bx[0] + c[1] * bx[1] + c[2] * bx[2]) * maskf).sum(dim=1)
                for bx in zip(*basis)]

    def forward(self, node_attr, edge_attr, pair_mask, basis, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                channel_major: bool = True) -> torch.Tensor:
        """node_attr [B, N, H]; ``edge_attr`` [B, H, N*N] with ``basis`` from
        :func:`dense_frames_flat` (``channel_major``), or [B, N, N, H] with
        ``basis`` from :func:`dense_frames`; pair_mask [B, N, N] bool.
        Returns [B, N, 3] f32.  ``deterministic=False`` turns dropout on
        (masks from ``generator``)."""
        b, n, _ = node_attr.shape
        count = pair_mask.sum(dim=1).clamp(min=1)          # valid sources per dest
        if channel_major:
            maskf = pair_mask.reshape(b, n * n).to(node_attr.dtype)
            mix = self._coff_mix_cm
        else:
            maskf = pair_mask.to(node_attr.dtype)
            mix = self._coff_mix
        grad = [torch.zeros((b, n), dtype=node_attr.dtype, device=node_attr.device)
                for _ in range(3)]
        conv_input = node_attr
        hiddens = []
        for m in range(self.num_layers):
            for conv in range(self.num_convs):
                layer = getattr(self, f"DenseGATLayer_{m * self.num_convs + conv}")
                hidden = layer(conv_input, edge_attr, pair_mask, deterministic, generator,
                               channel_major)
                if conv < self.num_convs - 1:
                    hidden = F.silu(hidden)
                if self.short_cut and hidden.shape == conv_input.shape:
                    hidden = hidden + conv_input
                hiddens.append(hidden)
                conv_input = hidden
            node_feature = torch.cat(hiddens, dim=-1) if self.concat_hidden else conv_input
            mixed = mix(m, node_feature, edge_attr, basis, maskf)
            grad = [g + mx / count for g, mx in zip(grad, mixed)]
        return torch.stack(grad, dim=-1)


class SDEModel2Dto3D(nn.Module):
    """SDEModel2Dto3D, the reference's four variants (SDE_model_2D_to_3D.py),
    which differ in the 2D edge features ``edge_attr_2d``:
      1: relu(BN(Linear[h_s, h_d])) -> Linear; + frame_invariant  (l.69-249)
      2: as 1, gated by the perturbed-distance Fourier features:
         dist_inv * edge_2D_emb + frame_invariant                   (l.252-445)
      3: Linear[h_s, h_d] + a bond-type embedding                   (l.448-632)
      4: [h_s * h_d, h_s + h_d] @ W + b + the bond-type embedding   (l.635-819)
    Any other value runs as variant 4 (JAX builds variant 4's parameters
    for it but no bond-type embedding, and fails in its conditioning).

    Parameter names and shapes are the JAX module's, for node
    representations ``emb_dim`` wide.  ``short_cut`` and ``concat_hidden``
    go to the score network.  Built on the CPU,
    initialized from ``generator`` (default: seed 0), then moved to
    ``device`` ("cuda" by default; raises without a GPU unless "cpu").
    ``pair_impl`` selects the pair block of variants 1 and 2: "auto"
    (kernel on a CUDA tensor, plain on a CPU tensor), "kernel" or "plain";
    ``bf16_pairs`` runs it in its bf16 mode (pretraining's choice; the
    samplers keep f32).  Variants 3 and 4 run no pair block.
    ``loss_layout`` is the pair layout of :meth:`loss` and :meth:`get_score`
    ("channel" ``[B, C, N*N]`` or "feature" ``[B, N, N, C]``, same math);
    ``pair_cm_direct`` makes the channel-layout conditioning of variants 1
    and 2 take the channel-major pair kernel (K4) instead of K3 and a
    transpose."""

    def __init__(self, emb_dim: int, hidden_dim: int = 32, variant: int = 2,
                 beta_min: float = 0.2, beta_max: float = 1.0,
                 num_diffusion_timesteps: int = 1000, sde_type: str = "VE",
                 use_extend_graph: bool = True, score_dtype: str = "float32",
                 bf16_pairs: bool = False, pair_impl: str = "auto",
                 loss_layout: str = "channel", pair_cm_direct: bool = False,
                 short_cut: bool = False, concat_hidden: bool = False,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if loss_layout not in ("channel", "feature"):
            raise ValueError(f"unknown loss_layout {loss_layout}")
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
        self.loss_layout = loss_layout
        self.pair_cm_direct = pair_cm_direct
        dt = torch.bfloat16 if score_dtype == "bfloat16" else None
        self.cdt = dt or torch.float32
        if variant in (1, 2):
            self.edge_2D_emb_0 = PairDense(emb_dim, emb_dim)
            self.edge_2D_emb_bn = PairMaskedBatchNorm(emb_dim)
            self.edge_2D_emb_1 = Dense(emb_dim, h)
        elif variant == 3:
            self.edge_2D_emb = PairDense(emb_dim, h)
        else:
            self.edge_2D_emb_kernel = nn.Parameter(torch.empty(2 * emb_dim, h))
            self.edge_2D_emb_bias = nn.Parameter(torch.zeros(h))
        if variant not in (1, 2):
            self.edge_emb = Embed(100, h)
        self.coff_fourier_W = nn.Parameter(torch.empty(h), requires_grad=False)
        self.coff_mlp = Dense(4 * h, h)
        self.project = MLP(2 + 2 * h, [h, h], activation="silu", dtype=dt)
        if variant == 2:
            self.dist_fourier_W = nn.Parameter(torch.empty(h), requires_grad=False)
            self.input_mlp = MLP(2 * h, [h], activation="silu", dtype=dt)
        self.node_emb = MLP(emb_dim, [h], activation="silu", dtype=dt)
        self.score_network = EquivariantScoreNetwork(
            hidden_dim=h, dtype=dt, short_cut=short_cut, concat_hidden=concat_hidden)
        init_parameters(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    @property
    def kernel_variant(self) -> int:
        """The fused score kernel's variant: 2 for variant 2, else 1 (the
        2D edge features of variants 3 and 4 enter as variant 1's do; JAX
        l.826)."""
        return 2 if self.variant == 2 else 1

    def _pair_mask_attr(self, batch: GraphBatch):
        """Dense [B, N, N] extended-adjacency mask and edge labels, indexed
        [b, s, d].  Masked edges are dropped by the scatter.  A batch from
        the compact ingest path carries the dense form already (built on
        the device, with or without the extension as the batch was
        collated): it is used as it is, as in JAX."""
        if batch.ext_dense_mask is not None:
            return batch.ext_dense_mask, batch.ext_dense_attr
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

    def edge_features_2d(self, node_2d_repr: torch.Tensor, batch: GraphBatch,
                         pair_attr: torch.Tensor) -> torch.Tensor:
        """Variants 3 and 4: the 2D edge features [B, N, N, H] f32 for every
        pair (JAX l.638-653), plus the embedding of the pair's edge label
        clipped to 0..99 (label 0 where there is no edge)."""
        h2d = node_2d_repr.reshape(batch.num_graphs, batch.n_max, -1)
        if self.variant == 3:
            src_p, dst_p = self.edge_2D_emb(h2d)
            edge = src_p[:, :, None, :] + dst_p[:, None, :, :]
        else:
            w_mul = self.edge_2D_emb_kernel[:self.emb_dim]
            add = h2d @ self.edge_2D_emb_kernel[self.emb_dim:]
            edge = (torch.einsum("bsf,bdf,fo->bsdo", h2d, h2d, w_mul)
                    + add[:, :, None, :] + add[:, None, :, :] + self.edge_2D_emb_bias)
        return edge + self.edge_emb.embedding[pair_attr.long().clamp(0, 99)]

    def precompute_conditioning(self, node_2d_repr: torch.Tensor,
                                batch: GraphBatch,
                                use_running_average: bool = True,
                                layout: str = "feature") -> Dict[str, torch.Tensor]:
        """Position-independent conditioning: ``edge_attr_2d``, ``node_attr``
        [B, N, H] and ``pair_mask`` [B, N, N], as JAX's method gives them.

        ``layout="feature"``: ``edge_attr_2d`` [B, N, N, H] f32, from the
        pair block (K3) in variants 1 and 2, from :meth:`edge_features_2d`
        in 3 and 4.  ``layout="channel"``: [B, H, N*N], the same cast to
        the score dtype and transposed, or in variants 1 and 2 with
        ``pair_cm_direct`` straight from the channel-major pair block (K4),
        f32 with its bias.  Variants 1 and 2 launch the pair block once
        either way; 3 and 4 launch nothing."""
        if layout not in ("feature", "channel"):
            raise ValueError(f"unknown layout {layout}")
        b, n = batch.num_graphs, batch.n_max
        pair_mask, pair_attr = self._pair_mask_attr(batch)
        node_attr = self.node_emb(node_2d_repr.reshape(b, n, -1))
        if self.variant not in (1, 2):
            edge_attr_2d = self.edge_features_2d(node_2d_repr, batch, pair_attr)
        else:
            inputs = self.pair_block_inputs(node_2d_repr, batch, pair_mask,
                                            use_running_average)
            if layout == "channel" and self.pair_cm_direct:
                edge_attr_2d = pair_relu_project_cm(*inputs, bf16=self.bf16_pairs,
                                                    impl=self.pair_impl)
                return {"edge_attr_2d": edge_attr_2d, "node_attr": node_attr,
                        "pair_mask": pair_mask}
            edge_attr_2d = pair_relu_project(*inputs, bf16=self.bf16_pairs,
                                             impl=self.pair_impl)
        if layout == "channel":
            edge_attr_2d = edge_attr_2d.to(self.cdt).reshape(
                b, n * n, -1).transpose(1, 2).contiguous()
        return {"edge_attr_2d": edge_attr_2d, "node_attr": node_attr,
                "pair_mask": pair_mask}

    def score_from_cond(self, cond: Dict[str, torch.Tensor], pos: torch.Tensor,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Feature-layout twin of :meth:`score_from_cond_cm` (JAX
        ``score_from_cond``, l.672-729): every pair tensor is [B, N, N, C].
        ``cond`` comes from ``precompute_conditioning(layout="feature")``,
        whose f32 ``edge_attr_2d`` keeps the edge features f32 in bf16 score
        mode, as in JAX."""
        h = self.hidden_dim
        pair_mask = cond["pair_mask"]
        b, n = pair_mask.shape[0], pair_mask.shape[1]
        edge_attr_2d = cond["edge_attr_2d"]
        if edge_attr_2d.ndim != 4:
            raise ValueError("cond must be precomputed with layout='feature'")
        cdt = self.cdt
        pos3 = pos.reshape(b, n, 3)
        basis, coff_s, _, (pseudo_sin, pseudo_cos) = dense_frames(pos3)

        # Fourier features of the source-frame coefficients only (the s<->d
        # symmetry of score_from_cond_cm, pair-transposed over axes 1, 2)
        w_coff = self.coff_fourier_W
        full = torch.cat([gaussian_fourier_projection(coff_s[0][..., None], w_coff),
                          gaussian_fourier_projection(coff_s[2][..., None], w_coff)],
                         dim=-1).to(cdt)                               # [B, N, N, 4h]
        wm_c = self.coff_mlp.kernel.to(cdt)
        wm_neg = torch.cat([-wm_c[:h], wm_c[h:]], dim=0)
        bm_c = self.coff_mlp.bias.to(cdt)
        embed_s = full @ wm_c + bm_c
        embed_d = (full @ wm_neg).transpose(1, 2) + bm_c
        # the concatenation promotes to f32, as jnp.concatenate does
        edge_embed = torch.cat([pseudo_sin[..., None], pseudo_cos[..., None],
                                embed_s.float(), embed_d.float()], dim=-1)
        frame_inv = self.project(edge_embed)

        if self.variant == 2:
            sq = sum((pos3[..., k][:, :, None] - pos3[..., k][:, None, :]) ** 2
                     for k in range(3))
            dist = torch.sqrt(sq + SQRT_GUARD)[..., None]
            dist_inv = self.input_mlp(gaussian_fourier_projection(dist, self.dist_fourier_W))
            edge_attr = dist_inv * edge_attr_2d + frame_inv
        else:
            edge_attr = edge_attr_2d + frame_inv
        edge_attr = edge_attr * pair_mask[..., None]

        out = self.score_network(cond["node_attr"], edge_attr, pair_mask, basis,
                                 deterministic, generator, channel_major=False)
        return out.reshape(b * n, 3)

    def packed_score_params(self) -> torch.Tensor:
        """The weights the fused score kernel reads, packed once
        (``ops/score_kernel.py::pack_score_params``)."""
        from moleculesde_tpu_torch.ops.score_kernel import pack_score_params

        return pack_score_params(self, self.kernel_variant)

    def score_from_cond_fused(self, cond: Dict[str, torch.Tensor], pos: torch.Tensor,
                              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The position-dependent half as one fused kernel launch (K6,
        ``ops/score_kernel.py``; JAX ``score_from_cond_fused``, l.809-834):
        forward only, for samplers, at the network's widths (the kernel
        takes any hidden width the heads divide).  ``cond`` from
        ``precompute_conditioning(layout="feature")``; ``packed`` from
        :meth:`packed_score_params` (packed here when None).  Variants 3
        and 4 run the kernel as variant 1 (:attr:`kernel_variant`).  A
        network with ``short_cut`` or ``concat_hidden`` has layers the
        kernel lacks: it goes through :meth:`score_from_cond`, as JAX's
        does (l.823-824)."""
        from moleculesde_tpu_torch.ops.score_kernel import score_eval_fused

        net = self.score_network
        if net.short_cut or net.concat_hidden:
            return self.score_from_cond(cond, pos, True)
        pair_mask = cond["pair_mask"]
        b, n = pair_mask.shape[0], pair_mask.shape[1]
        out = score_eval_fused(
            pos.reshape(b, n, 3), cond["node_attr"], cond["edge_attr_2d"], pair_mask,
            self.packed_score_params() if packed is None else packed,
            variant=self.kernel_variant, bf16=self.score_dtype == "bfloat16",
            num_layers=net.num_layers, num_convs=net.num_convs,
            n_head=net.n_head)
        return out.reshape(b * n, 3)

    def score_from_cond_cm(self, cond: Dict[str, torch.Tensor], pos: torch.Tensor,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Raw network output at positions ``pos`` [B*N, 3] -> [B*N, 3] f32,
        from conditioning precomputed by ``precompute_conditioning(...,
        layout="channel")`` (dropout on when ``deterministic`` is False).
        With ``pair_cm_direct`` the 2D edge features arrive f32, and the
        edge features stay f32 in bf16 score mode, as in JAX."""
        h = self.hidden_dim
        pair_mask = cond["pair_mask"]
        b, n = pair_mask.shape[0], pair_mask.shape[1]
        nn_ = n * n
        edge2d_cm = cond["edge_attr_2d"]
        if edge2d_cm.ndim != 3:
            raise ValueError("cond must be precomputed with layout='channel'")
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
        antithetic timestep half ``half`` [B // 2 + 1] ~ U{0 .. steps-1}.
        Under a data-parallel group both are drawn at the global batch's
        shape: ``pos_noise`` is the rank's block, ``half`` the global
        batch's, of which :meth:`loss` takes the rank's block of mirrored
        timesteps."""
        dev = batch.positions.device
        return {"pos_noise": dp.block(torch.randn(dp.global_shape((batch.num_nodes, 3)),
                                                  generator=generator, device=dev)),
                "half": torch.randint(0, self.sde_pos.N,
                                      (dp.global_shape((batch.num_graphs,))[0] // 2 + 1,),
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
        time_step = dp.block(torch.cat([half, sde.N - half - 1])[:dp.global_shape((b,))[0]])
        time_step = time_step / sde.N * (1 - EPSILON) + EPSILON
        t_pos = time_step[node2graph]
        mean_pos, std_pos = sde.marginal_prob(batch.positions, t_pos)
        pos_perturbed = mean_pos + std_pos[:, None] * pos_noise
        scores = self._score_output(node_2d_repr, batch, pos_perturbed, deterministic,
                                    use_running_average, generator)
        loss_pos = ((scores - pos_noise) ** 2).sum(dim=-1)
        if anneal_power != 0.0:
            loss_pos = loss_pos * std_pos ** anneal_power
        return dp.global_mean(masked_segment_mean(loss_pos, node2graph, b, batch.node_mask))

    def _score_output(self, node_2d_repr, batch, pos, deterministic: bool,
                      use_running_average: bool,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Conditioning and score network in ``loss_layout`` -> [N_nodes, 3]."""
        cond = self.precompute_conditioning(node_2d_repr, batch, use_running_average,
                                            layout=self.loss_layout)
        score = self.score_from_cond_cm if self.loss_layout == "channel" else self.score_from_cond
        return score(cond, pos, deterministic, generator)

    def get_score(self, node_2d_repr: torch.Tensor, batch: GraphBatch,
                  pos_perturbed: torch.Tensor, t_pos: torch.Tensor) -> torch.Tensor:
        """Score for reverse-SDE sampling, ``-net(x_t) / std(t)`` (ref
        SDE_model_2D_to_3D.py:393-445; JAX ``get_score``), in eval mode: no
        dropout, running BatchNorm statistics."""
        out = self._score_output(node_2d_repr, batch, pos_perturbed, True, True)
        _, std_pos = self.sde_pos.marginal_prob(pos_perturbed, t_pos)
        return -out / std_pos[:, None]
