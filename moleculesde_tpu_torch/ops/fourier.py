"""Distance and noise-level embeddings: Gaussian Fourier projection
(reference SDE_model_2D_to_3D.py:57-66), SchNet's Gaussian smearing and
shifted softplus (reference schnet.py:198-216), PaiNN's Gaussian radial
basis and cosine cutoff (reference painn_utils.py:99-155).

Counterpart of ``moleculesde_tpu/ops/fourier.py``.
"""

from __future__ import annotations

import math

import torch

from moleculesde_tpu_torch.sde.base import linspace_f32

_TWO_PI = 2.0 * math.pi
_LOG2 = math.log(2.0)


def gaussian_smearing(dist: torch.Tensor, start: float, stop: float,
                      num_gaussians: int) -> torch.Tensor:
    """SchNet's equally spaced Gaussian expansion: ``dist`` [...] ->
    [..., num_gaussians].  The offsets are ``jnp.linspace``'s f32 grid,
    cached on the device."""
    offset = linspace_f32(start, stop, num_gaussians, dist.device)
    coeff = -0.5 / float((stop - start) / (num_gaussians - 1)) ** 2
    diff = dist[..., None] - offset
    return torch.exp(coeff * diff ** 2)


def gaussian_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float,
                 start: float = 0.0) -> torch.Tensor:
    """PaiNN's Gaussian radial basis: ``dist`` [...] -> [..., n_rbf], on
    ``jnp.linspace``'s f32 grid."""
    offsets = linspace_f32(start, cutoff, n_rbf, dist.device)
    coeff = -0.5 / abs((cutoff - start) / (n_rbf - 1)) ** 2
    diff = dist[..., None] - offsets
    return torch.exp(coeff * diff ** 2)


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Behler's cosine cutoff envelope, zero from ``cutoff`` on."""
    val = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    return val * (dist < cutoff).to(val.dtype)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log 2, as ``jnp.logaddexp(x, 0) - log 2``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)) - _LOG2


def gaussian_fourier_projection(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [..., 1], fixed weights ``w`` [C] -> [sin(2 pi w x), cos(2 pi w x)]
    [..., 2C]."""
    proj = x * w * _TWO_PI
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def gaussian_fourier_projection_cm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Channel-major form: scalar plane ``x`` [B, P] -> [B, 2C, P]."""
    proj = x[:, None, :] * w[None, :, None] * _TWO_PI
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=1)
