"""SchNet over padded batches with a dense radius graph.

Counterpart of ``moleculesde_tpu/models/schnet.py`` (reference
Geom3D/models/schnet.py).  The neighbourhood is the masked dense
``[B, N, N]`` distance matrix (every pair within the cutoff, no 32-neighbour
cap), and each interaction block is

    h_i <- h_i + lin2(ssp(lin( sum_j W(d_ij) * lin1(h)_j )))
    W(d) = mlp(gaussian_smearing(d)) * 0.5 (cos(pi d / cutoff) + 1) * mask

The continuous-filter convolution runs fused
(:func:`~moleculesde_tpu_torch.ops.cfconv.fused_cfconv`: the K2 kernel on a
CUDA tensor, its plain version on a CPU tensor; no gradient to positions,
pretraining's choice), fused with the Gaussian smearing built in the
kernel from the raw distances (``cfconv="pallas_rbf"``:
:func:`~moleculesde_tpu_torch.ops.cfconv.fused_cfconv_rbf`, K5; no
``[B, N, N, G]`` slab at all), or as eager PyTorch (``cfconv="xla"``, the
JAX package's ``agg="reduce"`` form; it differentiates positions).
``compute_dtype="bfloat16"`` runs the interaction blocks' products in bf16
as the JAX package does; parameters and the geometry stay f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moleculesde_tpu_torch.core.batch import NUM_ATOM_CLASSES, GraphBatch
from moleculesde_tpu_torch.models.layers import Dense, Embed, init_parameters
from moleculesde_tpu_torch.ops.cfconv import fused_cfconv, fused_cfconv_rbf
from moleculesde_tpu_torch.ops.fourier import gaussian_smearing, shifted_softplus
from moleculesde_tpu_torch.utils.device import resolve_device

_DIST_GUARD = 1e-24
_ATOMREF_ROWS = 100        # the reference's atomref table: Embedding(100, 1)


def pairwise_distances(pos: torch.Tensor) -> torch.Tensor:
    """Dense pairwise distances ``[B, N, 3]`` -> ``[B, N, N]``, finite on the
    diagonal and on padded rows."""
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    return torch.sqrt((diff ** 2).sum(dim=-1) + _DIST_GUARD)


def radius_pair_mask(dist: torch.Tensor, node_mask: torch.Tensor,
                     cutoff: float) -> torch.Tensor:
    """[B, N, N] bool: both atoms real, i != j, d < cutoff."""
    b, n, _ = dist.shape
    m = node_mask.reshape(b, n)
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)[None]
    return m[:, :, None] & m[:, None, :] & ~eye & (dist < cutoff)


CFCONV_FORMS = ("auto", "pallas", "pallas_rbf", "xla")


class SchNetInteraction(nn.Module):
    """One interaction block (ref schnet.py:138-195).  ``Dense_0`` /
    ``Dense_1`` are the filter net (raw weights for the fused forms),
    ``Dense_2`` lin1 (no bias), ``Dense_3`` / ``Dense_4`` the output MLP.
    ``cfconv`` names the form, as the JAX package does: "auto" / "pallas"
    (K2 through :func:`fused_cfconv`), "pallas_rbf" (K5 through
    :func:`fused_cfconv_rbf`, which takes the distances) or "xla" (eager).
    ``impl`` is the fused forms' kernel wrapper ``impl``: "auto" (the kernel
    on a CUDA tensor, the plain version on a CPU tensor), "kernel" or
    "plain"."""

    def __init__(self, hidden_channels: int, num_filters: int, num_gaussians: int,
                 dtype: Optional[torch.dtype] = None, cfconv: str = "auto",
                 cutoff: float = 10.0, impl: str = "auto"):
        super().__init__()
        if cfconv not in CFCONV_FORMS:
            raise ValueError(f"unknown SchNet cfconv {cfconv}")
        self.dtype = dtype
        self.cfconv = cfconv
        self.impl = impl
        self.num_gaussians = num_gaussians
        self.cutoff = cutoff
        self.Dense_0 = Dense(num_gaussians, num_filters)
        self.Dense_1 = Dense(num_filters, num_filters)
        self.Dense_2 = Dense(hidden_channels, num_filters, use_bias=False, dtype=dtype)
        self.Dense_3 = Dense(num_filters, hidden_channels, dtype=dtype)
        self.Dense_4 = Dense(hidden_channels, hidden_channels, dtype=dtype)

    def forward(self, h, edge_attr, cos_env, pair_mask, dist=None) -> torch.Tensor:
        """``edge_attr`` [B, N, N, G] for the eager form and K2; K5 takes the
        distances ``dist`` [B, N, N] instead.  The output is in the residual
        stream's dtype (f32; f64 for a model in double, eager form)."""
        acc = torch.promote_types(h.dtype, torch.float32)
        w1, b1 = self.Dense_0.kernel, self.Dense_0.bias
        w2, b2 = self.Dense_1.kernel, self.Dense_1.bias
        x = self.Dense_2(h)
        envm = cos_env * pair_mask.to(cos_env.dtype)
        bf16 = self.dtype == torch.bfloat16
        if self.cfconv == "pallas_rbf":
            x = fused_cfconv_rbf(dist.contiguous(), envm.contiguous(), x.float().contiguous(),
                                 w1, b1, w2, b2, start=0.0, stop=self.cutoff,
                                 num_gaussians=self.num_gaussians, bf16=bf16,
                                 impl=self.impl)
        elif self.cfconv == "xla":
            dt = self.dtype or h.dtype
            w = edge_attr.to(dt) @ w1.to(dt) + b1.to(dt)
            w = shifted_softplus(w.to(acc))
            w = w.to(dt) @ w2.to(dt) + b2.to(dt)
            w = w * envm[..., None].to(w.dtype)
            x = (w * x[:, None, :, :].to(w.dtype)).sum(dim=2)
        else:
            x = fused_cfconv(edge_attr.contiguous(), envm.contiguous(),
                             x.float().contiguous(), w1, b1, w2, b2,
                             bf16=bf16, impl=self.impl)
        x = shifted_softplus(self.Dense_3(x).to(acc))
        return self.Dense_4(x).to(acc)


class SchNet(nn.Module):
    """SchNet encoder (ref schnet.py:16-135); ``forward`` returns
    ``(pooled [B, H], latent [B * n_max, H])``, the latent being the
    per-node representation the SDE models take.  Padded rows of the latent
    are exactly zero.  ``cfconv`` and ``impl`` as in
    :class:`SchNetInteraction`.  Built on the CPU, initialized from
    ``generator`` (default: seed 0), then moved to ``device`` ("cuda" by
    default; raises without a GPU unless "cpu").  ``use_atomref`` adds the
    reference's per-atom scalar offset (``atomref``, Embedding(100, 1),
    zero at init; reference schnet.py:66-70, 112-113) to every feature of
    a node's latent before the readout, as the JAX package's SchNet does;
    an imported reference checkpoint may carry one
    (:func:`~moleculesde_tpu_torch.utils.torch_import.import_schnet`)."""

    def __init__(self, hidden_channels: int = 128, num_filters: int = 128,
                 num_interactions: int = 6, num_gaussians: int = 51,
                 cutoff: float = 10.0, readout: str = "mean",
                 compute_dtype: Optional[str] = None, cfconv: str = "auto",
                 impl: str = "auto", use_atomref: bool = False,
                 device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if readout not in ("mean", "add", "sum"):
            raise ValueError(f"unknown readout {readout}")
        dev = resolve_device(device)
        self.hidden_channels = hidden_channels
        self.num_interactions = num_interactions
        self.num_gaussians = num_gaussians
        self.cutoff = cutoff
        self.readout = readout
        self.cfconv = cfconv
        dt = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.dtype = dt
        self.Embed_0 = Embed(NUM_ATOM_CLASSES, hidden_channels)
        for i in range(num_interactions):
            setattr(self, f"SchNetInteraction_{i}", SchNetInteraction(
                hidden_channels, num_filters, num_gaussians, dt, cfconv, cutoff, impl))
        self.Dense_0 = Dense(hidden_channels, hidden_channels)
        self.Dense_1 = Dense(hidden_channels, hidden_channels)
        init_parameters(self, generator or torch.Generator().manual_seed(0))
        self.atomref = None
        if use_atomref:   # after the initializer: JAX's table starts at zero
            self.atomref = Embed(_ATOMREF_ROWS, 1)
            nn.init.zeros_(self.atomref.embedding)
        self.to(dev)

    def forward(self, z: torch.Tensor, pos: torch.Tensor, node_mask: torch.Tensor,
                num_graphs: int, n_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
        # embedding as a one-hot matmul: its backward is a matmul, where a
        # gather's is an indexed scatter
        table = self.Embed_0.embedding
        h = F.one_hot(z.long().clamp(0, NUM_ATOM_CLASSES - 1), NUM_ATOM_CLASSES
                      ).to(table.dtype) @ table
        edge_attr, cos_env, pair_mask, dist = self.geometry(pos, node_mask, num_graphs, n_max)
        h = h.reshape(num_graphs, n_max, self.hidden_channels)
        for i in range(self.num_interactions):
            h = h + getattr(self, f"SchNetInteraction_{i}")(h, edge_attr, cos_env, pair_mask,
                                                             dist)
        h = self.Dense_1(shifted_softplus(self.Dense_0(h)))
        if self.atomref is not None:
            offset = self.atomref.embedding[z.long().clamp(0, _ATOMREF_ROWS - 1)]
            h = h + offset.reshape(num_graphs, n_max, 1)
        m = node_mask.reshape(num_graphs, n_max, 1).to(h.dtype)
        h = h * m
        pooled = h.sum(dim=1)
        if self.readout == "mean":
            pooled = pooled / m.sum(dim=1).clamp(min=1.0)
        return pooled, h.reshape(num_graphs * n_max, self.hidden_channels)

    def geometry(self, pos: torch.Tensor, node_mask: torch.Tensor, num_graphs: int,
                 n_max: int) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """The dense radius graph every interaction reads: (edge_attr
        [B, N, N, G], cos_env [B, N, N], pair_mask [B, N, N], dist
        [B, N, N]).  edge_attr is cast once to the interactions' compute
        dtype: in bf16 that halves K2's largest read, and the eager form
        casts to it anyway.  Under ``cfconv="pallas_rbf"`` it is None: K5
        smears inside the kernel, as the JAX package skips the slab there."""
        dist = pairwise_distances(pos.reshape(num_graphs, n_max, 3))
        pair_mask = radius_pair_mask(dist, node_mask, self.cutoff)
        edge_attr = None
        if self.cfconv != "pallas_rbf":
            edge_attr = gaussian_smearing(dist, 0.0, self.cutoff, self.num_gaussians)
            if self.dtype is not None:
                edge_attr = edge_attr.to(self.dtype)
        cos_env = 0.5 * (torch.cos(dist * math.pi / self.cutoff) + 1.0)
        return edge_attr, cos_env, pair_mask, dist

    def encode_batch(self, batch: GraphBatch):
        return self(batch.atomic_numbers, batch.positions, batch.node_mask,
                    batch.num_graphs, batch.n_max)
