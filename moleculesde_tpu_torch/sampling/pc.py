"""Reverse-SDE predictor-corrector samplers for both generation directions.

Counterpart of ``moleculesde_tpu/sampling/pc.py``:
- :func:`sample_positions_pc`, 2D->3D conformer generation (reference
  examples/pretrain_MoleculeSDE_inference_2D_to_3D_VE_VP.py:92-212): a
  Langevin corrector then a reverse-diffusion predictor per step over
  ``linspace(T, eps, n_steps)``, with the conditioning computed once per
  chain.  The corrector's step size uses the batch-global SNR rule (mean
  row norms over the whole batch, also when the score is evaluated in
  chunks).
- :func:`sample_graph_pc`, 3D->2D joint (x, adj) generation (reference
  examples/pretrain_MoleculeSDE_inference_3D_to_2D_VE_VP.py:95-252):
  corrector then predictor updates of the adjacency and the node state per
  step, with oracle node flags from the true bond graph.

Random draws come from an explicit ``torch.Generator`` and may be passed in
instead (the tests feed the JAX package's draws).  Chain noise is drawn for
the whole chain up front only while it stays under 128 MiB, and per step
otherwise, as in the JAX package.

Under a data-parallel group (``parallel/``) the batch is the rank's block
of the global batch and the generator is seeded alike on every rank: the
priors and the chain noise are drawn at the global batch's shape (the
128 MiB rule on the global sizes) and the rank keeps its block, and the
corrector's batch means of row norms are global, so the ranks together
return what one process returns for the global batch.  Injected priors and
the 2D->3D chain's noises are the rank's blocks; the 3D->2D chain's noise
slabs are the global batch's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from moleculesde_tpu_torch.core.batch import GraphBatch, pad_graphs
from moleculesde_tpu_torch.core.masks import mask_adjs, mask_x, node_flags
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.sde.base import linspace_f32

_HOIST_LIMIT_BYTES = 128 * 1024 * 1024


def repeat_graph_batch(graph: dict, num_repeat: int, n_max: int, e_max: int,
                       ext_e_max: Optional[int] = None) -> GraphBatch:
    """One molecule cloned ``num_repeat`` times into a padded batch (the
    reference's ``repeat_data``, inference 2D->3D l.29-39)."""
    return pad_graphs([graph] * num_repeat, n_max=n_max, e_max=e_max,
                      ext_e_max=ext_e_max)


def _masked_mean_rownorm(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over valid rows of ||row|| (the corrector's global SNR
    statistic), over every rank's rows."""
    norms = torch.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(dim=-1) + 1e-24)
    return dp.masked_mean(norms, mask)


@torch.no_grad()
def sample_positions_pc(
    model: SDEModel2Dto3D,
    node_2d_repr: torch.Tensor,
    batch: GraphBatch,
    generator: Optional[torch.Generator] = None,
    *,
    n_steps: Optional[int] = None,
    snr: float = 0.2,
    scale_eps: float = 0.9,
    corrector_steps: int = 1,
    eps: float = 1e-4,
    denoise: bool = True,
    probability_flow: bool = False,
    fused: bool = False,
    layout: str = "channel",
    score_chunk: Optional[int] = None,
    prior: Optional[torch.Tensor] = None,
    noise_p: Optional[torch.Tensor] = None,
    noise_c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generate conformers for the graphs of ``batch``; returns positions
    ``[N_nodes, 3]`` (the final predictor mean when ``denoise``).

    ``layout`` is the score's pair layout: "channel" (``[B, C, N*N]``,
    :meth:`SDEModel2Dto3D.score_from_cond_cm`) or "feature"
    (``[B, N, N, C]``, :meth:`SDEModel2Dto3D.score_from_cond`).  ``fused``
    evaluates the score as one kernel launch (K6,
    :meth:`SDEModel2Dto3D.score_from_cond_fused`) on the feature-layout
    conditioning, and so forces ``layout="feature"``.  ``score_chunk``
    evaluates the score over batch chunks of that size (``None``, or a size
    that does not divide B into several chunks, disables it); the result is
    the same.  Injected draws: ``prior``
    [N_nodes, 3], ``noise_p`` [n_steps, N_nodes, 3], ``noise_c`` [n_steps,
    corrector_steps, N_nodes, 3]; they are masked here."""
    sde = model.sde_pos
    diff_steps = n_steps if n_steps is not None else sde.N
    dev = node_2d_repr.device
    shape = tuple(batch.positions.shape)
    mask = batch.node_mask
    m3 = mask[:, None]
    timesteps = linspace_f32(sde.T, eps, diff_steps, dev)

    if prior is None:
        prior = dp.block(sde.prior_sampling(dp.global_shape(shape), generator, dev))
    pos = prior * m3

    if fused:
        layout = "feature"
    cond = model.precompute_conditioning(node_2d_repr, batch, True, layout=layout)
    if fused:
        packed = model.packed_score_params()   # once per chain

        def score_fn(c, p):
            return model.score_from_cond_fused(c, p, packed)
    else:
        score_fn = model.score_from_cond_cm if layout == "channel" else model.score_from_cond
    b, n = batch.num_graphs, batch.n_max
    chunk = score_chunk if score_chunk and 0 < score_chunk < b and b % score_chunk == 0 else b

    def raw_score(p: torch.Tensor) -> torch.Tensor:
        if chunk == b:
            return score_fn(cond, p)
        return torch.cat([
            score_fn({k: v[i:i + chunk] for k, v in cond.items()}, p[i * n:(i + chunk) * n])
            for i in range(0, b, chunk)])

    stds = sde.marginal_prob(torch.zeros_like(timesteps), timesteps)[1]
    alphas = sde.corrector_alpha(timesteps)
    if noise_p is None:
        noise_p = dp.block(torch.randn((diff_steps,) + dp.global_shape(shape),
                                       generator=generator, device=dev), dim=1)
    noise_p = noise_p * m3
    hoist = diff_steps * corrector_steps * pos.numel() * dp.world_size() * 4 \
        <= _HOIST_LIMIT_BYTES
    if noise_c is None and hoist:
        noise_c = dp.block(torch.randn((diff_steps, corrector_steps) + dp.global_shape(shape),
                                       generator=generator, device=dev), dim=2)
    if noise_c is not None:
        noise_c = noise_c * m3

    pos_mean = pos
    for i in range(diff_steps):
        std, alpha = stds[i], alphas[i]
        for j in range(corrector_steps):  # Langevin corrector
            grad = -raw_score(pos) / std
            noise = (noise_c[i, j] if noise_c is not None
                     else dp.block(torch.randn(dp.global_shape(shape), generator=generator,
                                               device=dev)) * m3)
            grad_norm = _masked_mean_rownorm(grad, mask)
            noise_norm = _masked_mean_rownorm(noise, mask)
            step = (snr * noise_norm / grad_norm.clamp(min=1e-12)) ** 2 * 2 * alpha
            pos = pos + step * grad + torch.sqrt(step * 2) * noise * scale_eps
        # reverse-diffusion predictor
        score = -raw_score(pos) / std
        f, g = sde.reverse_discretize(pos, timesteps[i].expand(pos.shape[0]),
                                      score, probability_flow)
        x_mean = pos - f
        pos = (x_mean + g[:, None] * noise_p[i]) * m3
        pos_mean = x_mean * m3
    return pos_mean if denoise else pos


@torch.no_grad()
def sample_graph_pc(
    model: SDEModel3Dto2D,
    node_3d_repr: torch.Tensor,
    batch: GraphBatch,
    generator: Optional[torch.Generator] = None,
    *,
    n_steps: Optional[int] = None,
    snr: float = 0.2,
    scale_eps: float = 0.9,
    corrector_steps: int = 1,
    eps: float = 1e-4,
    probability_flow: bool = False,
    x_prior: Optional[torch.Tensor] = None,
    adj_prior: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint (x, adj) generation conditioned on the 3D latent
    ``node_3d_repr`` [N_nodes, D]; returns (x, adj, x_mean, adj_mean),
    [B, N, X] / [B, N, N].

    The JAX sampler's order and quirks are kept: node flags come from the
    true bond adjacency (the atom count is given); the adjacency prior is
    drawn asymmetric, then masked (ref l.121); each phase runs ONE
    evaluation of both networks, so both corrector updates read the
    pre-phase state and the x-corrector reuses its entry gradient for every
    inner step; the adjacency corrector's inner steps after the first
    re-evaluate the adjacency score alone at the stale phase-entry ``x``;
    adjacency noise is ``triu(z, 1) + triu(z, 1)^T``, masked.

    Draws, in this order from ``generator`` unless given: ``x_prior``
    [B, N, X], ``adj_prior`` [B, N, N], then the chain's noise as flat
    per-step slabs ``noise`` [n_steps, (1 + corrector_steps) (B N X + B N N)],
    each sliced as the JAX sampler slices it (the corrector's adjacency
    noises, its node noises, the predictor's adjacency noise, its node
    noise).  The slabs are drawn for the whole chain at once only while
    they stay under 128 MiB, else one per step."""
    sde = model.sde
    diff_steps = n_steps if n_steps is not None else sde.N
    dev = node_3d_repr.device
    timesteps = linspace_f32(sde.T, eps, diff_steps, dev)
    b, n = batch.num_graphs, batch.n_max
    c = model.num_class_x if model.noise_on_one_hot else 1

    edge_attr = torch.where(batch.edge_mask, batch.edge_feats[:, 0].float() + 1.0,
                            torch.zeros((), device=batch.edge_mask.device))
    flags = node_flags(batch.dense_adjacency(edge_attr))
    node_3d = batch.dense_nodes(node_3d_repr)

    bg = dp.global_shape((b,))[0]   # the global batch's graphs
    if x_prior is None:
        x_prior = dp.block(sde.prior_sampling((bg, n, c), generator, dev))
    if adj_prior is None:
        adj_prior = dp.block(sde.prior_sampling((bg, n, n), generator, dev))
    x = mask_x(x_prior, flags)
    adj = mask_adjs(adj_prior, flags)

    alphas = sde.corrector_alpha(timesteps)
    flat_x, flat_adj = bg * n * c, bg * n * n
    per_step = (1 + corrector_steps) * (flat_x + flat_adj)
    if noise is None and diff_steps * per_step * 4 <= _HOIST_LIMIT_BYTES:
        noise = torch.randn((diff_steps, per_step), generator=generator, device=dev)

    def noise_x(z):
        return mask_x(dp.block(z.reshape(bg, n, c)), flags)

    def noise_adj(z):
        z = torch.triu(dp.block(z.reshape(bg, n, n)), diagonal=1)
        return mask_adjs(z + z.transpose(-1, -2), flags)

    def step_size(grad, z, alpha):
        # batch means of per-graph norms, as the 2D->3D corrector's unmasked rule
        ratio = _masked_mean_rownorm(z, None) / _masked_mean_rownorm(grad, None).clamp(min=1e-12)
        return (snr * ratio) ** 2 * 2 * alpha

    x_mean, adj_mean = x, adj
    for i in range(diff_steps):
        slab = (noise[i] if noise is not None
                else torch.randn((per_step,), generator=generator, device=dev))
        parts = torch.split(slab, [flat_adj] * corrector_steps + [flat_x] * corrector_steps
                            + [flat_adj, flat_x])
        tv = timesteps[i].expand(b)
        alpha = alphas[i]

        # corrector: one dual evaluation at the phase-entry state
        grad_x, grad_adj = model.scores(node_3d, x, adj, flags, tv)
        aa, g = adj, grad_adj
        for j in range(corrector_steps):
            if j > 0:
                g = model.score_adj(node_3d, x, aa, flags, tv)
            z = noise_adj(parts[j])
            step = step_size(g, z, alpha)
            adj_mean = aa + step * g
            aa = adj_mean + torch.sqrt(step * 2) * z * scale_eps
        xx = x
        for j in range(corrector_steps):
            z = noise_x(parts[corrector_steps + j])
            step = step_size(grad_x, z, alpha)
            x_mean = xx + step * grad_x
            xx = x_mean + torch.sqrt(step * 2) * z * scale_eps
        x, adj = xx, aa

        # reverse-diffusion predictor: one dual evaluation
        grad_x, grad_adj = model.scores(node_3d, x, adj, flags, tv)
        f_a, g_a = sde.reverse_discretize(adj, tv, grad_adj, probability_flow)
        adj_mean = adj - f_a
        adj = adj_mean + g_a[:, None, None] * noise_adj(parts[-2])
        f_x, g_x = sde.reverse_discretize(x, tv, grad_x, probability_flow)
        x_mean = x - f_x
        x = x_mean + g_x[:, None, None] * noise_x(parts[-1])
    return x, adj, x_mean, adj_mean
