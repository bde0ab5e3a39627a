"""PaiNN equivariant encoder over padded batches with a dense radius graph.

Counterpart of ``moleculesde_tpu/models/painn.py`` (reference
Geom3D/models/painn.py, painn_utils.py).  The neighbourhood is SchNet's
masked dense ``[B, N, N]`` distance matrix.  Scalar channel ``q`` [B, N, F],
vector channel ``mu`` [B, N, 3, F].

Interaction (ref painn.py:14-66)::

    x = Dense(silu(Dense(q)))                            # [B, N, 3F]
    q_i  += sum_j W_q,ij * x_q,j
    mu_i += sum_j (W_r,ij * x_r,j) dir_ij + W_m,ij * (x_m,j * mu_j)

Mixing (ref painn.py:69-114): intra-atomic channel mixing with the norm of
``mu_V``.  Two reference quirks are kept: the atom embedding's
``padding_idx=0`` (row 0, hydrogen, is zero at lookup), and the one
``filter_net`` tensor whose kernel columns are sliced per interaction, so
only one interaction's ``[B, N, N, 3F]`` filters exist at a time.

Parameter names are flax's (``Embed_0``, ``filter_net``,
``PaiNNInteraction_i/Dense_*``, ``PaiNNMixing_i/Dense_*``), so a JAX
variable tree loads with :func:`~moleculesde_tpu_torch.convert.
load_flax_variables`.  ``compute_dtype="bfloat16"`` runs the pair-filter
products in bf16 with f32 sums, as the JAX package does; parameters, the
residual streams and the mixing stay f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moleculesde_tpu_torch.core.batch import NUM_ATOM_CLASSES, GraphBatch
from moleculesde_tpu_torch.models.layers import Dense, Embed, init_parameters
from moleculesde_tpu_torch.models.schnet import pairwise_distances, radius_pair_mask
from moleculesde_tpu_torch.ops.fourier import cosine_cutoff, gaussian_rbf
from moleculesde_tpu_torch.utils.device import resolve_device


class PaiNNInteraction(nn.Module):
    """Message passing of ``q`` and ``mu`` through one interaction's
    filters ``w`` [B, N, N, 3F] (masked, in the compute dtype)."""

    def __init__(self, f: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.f = f
        self.dtype = dtype
        self.Dense_0 = Dense(f, f)
        self.Dense_1 = Dense(f, 3 * f)

    def forward(self, q, mu, w, dir_ij):
        f = self.f
        dt = self.dtype or q.dtype
        x = self.Dense_1(F.silu(self.Dense_0(q))).to(dt)        # [B, N, 3F]
        w_q, w_r, w_m = w[..., :f], w[..., f:2 * f], w[..., 2 * f:]
        x_q, x_r, x_m = x[..., :f], x[..., f:2 * f], x[..., 2 * f:]
        # each product rounded to the compute dtype, every sum in f32 (f64
        # for a model in double), as JAX's sum(dtype=f32) and
        # einsum(preferred_element_type=f32)
        acc = torch.promote_types(q.dtype, torch.float32)
        dq = (w_q * x_q[:, None]).sum(dim=2, dtype=acc)
        dmu_r = torch.einsum("bijf,bijv->bivf", (w_r * x_r[:, None]).to(acc),
                             dir_ij.to(dt).to(acc))
        xm_mu = (mu * x_m[:, :, None, :].to(mu.dtype)).to(dt)
        dmu_m = torch.einsum("bijf,bjvf->bivf", w_m.to(acc), xm_mu.to(acc))
        return q + dq, mu + dmu_r + dmu_m


class PaiNNMixing(nn.Module):
    """Intra-atomic mixing of ``q`` and ``mu``."""

    def __init__(self, f: int, epsilon: float = 1e-8):
        super().__init__()
        self.f = f
        self.epsilon = epsilon
        self.Dense_0 = Dense(f, 2 * f, use_bias=False)
        self.Dense_1 = Dense(2 * f, f)
        self.Dense_2 = Dense(f, 3 * f)

    def forward(self, q, mu):
        f = self.f
        mu_v, mu_w = self.Dense_0(mu).split(f, dim=-1)          # [B, N, 3, F] each
        mu_vn = torch.sqrt((mu_v ** 2).sum(dim=-2) + self.epsilon)
        x = self.Dense_2(F.silu(self.Dense_1(torch.cat([q, mu_vn], dim=-1))))
        dq_intra, dmu_intra, dqmu_intra = x.split(f, dim=-1)
        dmu = dmu_intra[:, :, None, :] * mu_w
        dqmu = dqmu_intra * (mu_v * mu_w).sum(dim=-2)
        return q + dq_intra + dqmu, mu + dmu


class PaiNN(nn.Module):
    """PaiNN encoder (ref painn.py:117-269); ``forward`` returns ``(pooled
    [B, F], latent [B * n_max, F])`` with padded rows of the latent zero.
    Built on the CPU, initialized from ``generator`` (default: seed 0),
    then moved to ``device`` ("cuda" by default; raises without a GPU
    unless "cpu")."""

    def __init__(self, n_atom_basis: int = 300, n_interactions: int = 3, n_rbf: int = 20,
                 cutoff: float = 5.0, readout: str = "add", shared_filters: bool = False,
                 epsilon: float = 1e-8, compute_dtype: Optional[str] = None,
                 device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if readout not in ("mean", "add", "sum"):
            raise ValueError(f"unknown readout {readout}")
        dev = resolve_device(device)
        self.f = n_atom_basis
        self.n_interactions = n_interactions
        self.n_rbf = n_rbf
        self.cutoff = cutoff
        self.readout = readout
        self.shared_filters = shared_filters
        self.dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        groups = 1 if shared_filters else n_interactions
        self.filter_net = Dense(n_rbf, groups * 3 * n_atom_basis)
        self.Embed_0 = Embed(NUM_ATOM_CLASSES, n_atom_basis)
        for i in range(n_interactions):
            setattr(self, f"PaiNNInteraction_{i}", PaiNNInteraction(n_atom_basis, self.dtype))
            setattr(self, f"PaiNNMixing_{i}", PaiNNMixing(n_atom_basis, epsilon))
        init_parameters(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    def _filters(self, i: int, phi: torch.Tensor, fcut: torch.Tensor) -> torch.Tensor:
        """Interaction ``i``'s filters [B, N, N, 3F]: its slice of
        ``filter_net``'s kernel columns applied to the radial basis."""
        g = 0 if self.shared_filters else i
        sl = slice(g * 3 * self.f, (g + 1) * 3 * self.f)
        dt = self.dtype or phi.dtype
        w = self.filter_net.kernel[:, sl].to(dt)
        return (phi.to(dt) @ w + self.filter_net.bias[sl].to(dt)) * fcut[..., None].to(dt)

    def forward(self, z: torch.Tensor, pos: torch.Tensor, node_mask: torch.Tensor,
                num_graphs: int, n_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, f = num_graphs, n_max, self.f
        pos3 = pos.reshape(b, n, 3)
        dist = pairwise_distances(pos3)
        pair_mask = radius_pair_mask(dist, node_mask, self.cutoff)
        dir_ij = (pos3[:, :, None, :] - pos3[:, None, :, :]) / dist[..., None]
        dir_ij = dir_ij * pair_mask[..., None]
        phi = gaussian_rbf(dist, self.n_rbf, self.cutoff)
        fcut = cosine_cutoff(dist, self.cutoff) * pair_mask

        # the embedding as a one-hot matmul (its backward is a matmul); row 0
        # is zero at lookup, the reference's padding_idx=0
        zc = z.long().clamp(0, NUM_ATOM_CLASSES - 1)
        table = self.Embed_0.embedding
        q = F.one_hot(zc, NUM_ATOM_CLASSES).to(table.dtype) @ table
        q = (q * (zc > 0)[:, None].to(q.dtype)).reshape(b, n, f)
        mu = torch.zeros((b, n, 3, f), dtype=q.dtype, device=q.device)
        for i in range(self.n_interactions):
            q, mu = getattr(self, f"PaiNNInteraction_{i}")(q, mu, self._filters(i, phi, fcut),
                                                           dir_ij)
            q, mu = getattr(self, f"PaiNNMixing_{i}")(q, mu)

        m = node_mask.reshape(b, n, 1).to(q.dtype)
        q = q * m
        pooled = q.sum(dim=1)
        if self.readout == "mean":
            pooled = pooled / m.sum(dim=1).clamp(min=1.0)
        return pooled, q.reshape(b * n, f)

    def encode_batch(self, batch: GraphBatch):
        return self(batch.atomic_numbers, batch.positions, batch.node_mask,
                    batch.num_graphs, batch.n_max)
