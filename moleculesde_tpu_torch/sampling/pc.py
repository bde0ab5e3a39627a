"""Reverse-SDE predictor-corrector sampler for 2D->3D conformer generation.

Counterpart of ``moleculesde_tpu/sampling/pc.py::sample_positions_pc``
(reference examples/pretrain_MoleculeSDE_inference_2D_to_3D_VE_VP.py:
92-212): a Langevin corrector then a reverse-diffusion predictor per step
over ``linspace(T, eps, n_steps)``, with the conditioning computed once per
chain.  The corrector's step size uses the batch-global SNR rule (mean row
norms over the whole batch, also when the score is evaluated in chunks).

Random draws come from an explicit ``torch.Generator``, in the order prior,
predictor noise, corrector noise; ``prior`` / ``noise_p`` / ``noise_c``
may be passed in instead (the tests feed the JAX package's draws).  The
corrector noise is drawn for the whole chain up front only while it stays
under 128 MiB, and per step otherwise, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from moleculesde_tpu_torch.core.batch import GraphBatch, pad_graphs
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.sde.base import linspace_f32

_HOIST_LIMIT_BYTES = 128 * 1024 * 1024


def repeat_graph_batch(graph: dict, num_repeat: int, n_max: int, e_max: int,
                       ext_e_max: Optional[int] = None) -> GraphBatch:
    """One molecule cloned ``num_repeat`` times into a padded batch (the
    reference's ``repeat_data``, inference 2D->3D l.29-39)."""
    return pad_graphs([graph] * num_repeat, n_max=n_max, e_max=e_max,
                      ext_e_max=ext_e_max)


def _masked_mean_rownorm(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over valid rows of ||row|| (the corrector's global SNR statistic)."""
    norms = torch.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(dim=-1) + 1e-24)
    if mask is None:
        return norms.mean()
    m = mask.to(norms.dtype)
    return (norms * m).sum() / m.sum().clamp(min=1.0)


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
        prior = sde.prior_sampling(shape, generator, dev)
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
        noise_p = torch.randn((diff_steps,) + shape, generator=generator, device=dev)
    noise_p = noise_p * m3
    hoist = diff_steps * corrector_steps * pos.numel() * 4 <= _HOIST_LIMIT_BYTES
    if noise_c is None and hoist:
        noise_c = torch.randn((diff_steps, corrector_steps) + shape,
                              generator=generator, device=dev)
    if noise_c is not None:
        noise_c = noise_c * m3

    pos_mean = pos
    for i in range(diff_steps):
        std, alpha = stds[i], alphas[i]
        for j in range(corrector_steps):  # Langevin corrector
            grad = -raw_score(pos) / std
            noise = (noise_c[i, j] if noise_c is not None
                     else torch.randn(shape, generator=generator, device=dev) * m3)
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
