"""Forward / reverse SDE math for score-based diffusion (VE / VP / sub-VP).

Counterpart of ``moleculesde_tpu/sde/base.py``: every method returns
time-shaped coefficients broadcast to the rank of ``x``; with the reverse
SDE, the prior's log-density, the transition kernels of VP and VE and
:func:`get_beta_schedule`.  Discrete schedules
are built in float32 the way ``jnp.linspace`` builds them
(:func:`linspace_f32`), so integer timestep lookups land on the same table
entries as in the JAX package.  The sub-VP ``marginal_prob`` keeps the
reference's std without a square root, and the VE prior is N(0, I), not
sigma_max-scaled, both as the JAX package has them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


def linspace_f32(start: float, stop: float, num: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)``'s formula in float32:
    ``start * (1 - i/div) + stop * (i/div)`` with every op rounded to
    float32 (IEEE division, computed on the host), endpoint appended exactly.
    Cached per device, so a sampler step copies nothing to the device."""
    return _linspace_f32(float(start), float(stop), int(num), str(torch.device(device or "cpu")))


@functools.lru_cache(maxsize=64)
def _linspace_f32(start: float, stop: float, num: int, device: str) -> torch.Tensor:
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        out = np.array([start32], dtype=np.float32)
    else:
        step = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
        out = np.concatenate([start32 * (np.float32(1) - step) + stop32 * step,
                              np.array([stop32], dtype=np.float32)])
    return torch.from_numpy(out.astype(np.float32)).to(device)


def get_beta_schedule(beta_schedule: str, *, beta_min: float, beta_max: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """Discrete beta schedules in float32 (reference SDE_model_2D_to_3D.py:
    13-32): "quad", "linear", "const", "jsd" or "sigmoid", built in
    float64 as the JAX package builds them."""
    n = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_min ** 0.5, beta_max ** 0.5, n, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_min, beta_max, n, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_max * np.ones(n, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(n, 1, n, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        betas = (1.0 / (np.exp(-np.linspace(-6, 6, n)) + 1.0)) * (beta_max - beta_min) + beta_min
    else:
        raise NotImplementedError(beta_schedule)
    return betas.astype(np.float32)


def _std_normal_logp(z: torch.Tensor, var: float = 1.0) -> torch.Tensor:
    """log N(z; 0, var I) of each row of ``z`` (all axes past the first)."""
    n = math.prod(z.shape[1:])
    return (-n / 2.0 * math.log(2 * math.pi * var)
            - torch.sum(z ** 2, dim=tuple(range(1, z.ndim))) / (2 * var))


def _bcast(coeff: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Append singleton axes so a time-shaped coefficient broadcasts to x."""
    extra = x.ndim - coeff.ndim
    return coeff if extra <= 0 else coeff.reshape(tuple(coeff.shape) + (1,) * extra)


@dataclasses.dataclass(frozen=True)
class SDE:
    """Base SDE: ``N`` discretization steps, terminal time ``T = 1``."""

    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def marginal_prob(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean (shape of ``x``) and std (shape of ``t``) of p_t(x_t | x_0)."""
        raise NotImplementedError

    def prior_sampling(self, shape, generator: Optional[torch.Generator] = None,
                       device: Optional[torch.device] = None) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device)

    def prior_sampling_sym(self, shape, generator: Optional[torch.Generator] = None,
                           device: Optional[torch.device] = None,
                           z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Symmetric prior noise for adjacency matrices: the strict upper
        triangle of a normal draw mirrored (ref SDE_dense.py:148-150).  ``z``
        is that draw when the caller makes it."""
        if z is None:
            z = torch.randn(shape, generator=generator, device=device)
        z = torch.triu(z, diagonal=1)
        return z + z.transpose(-1, -2)

    def prior_logp(self, z) -> torch.Tensor:
        raise NotImplementedError

    def reverse_sde(self, x, t, score, probability_flow: bool = False):
        """Drift and diffusion of the reverse-time SDE for a score estimate
        (ref SDE_sparse.py:85-92)."""
        drift, diffusion = self.sde(x, t)
        drift = drift - _bcast(diffusion, x) ** 2 * score * (0.5 if probability_flow else 1.0)
        return drift, torch.zeros_like(diffusion) if probability_flow else diffusion

    def discretize(self, x, t):
        """Euler-Maruyama: x_{i+1} = x_i + f + G z."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse_discretize(self, x, t, score, probability_flow: bool = False):
        """Discretized reverse-diffusion rule (predictor update)."""
        f, G = self.discretize(x, t)
        rev_f = f - _bcast(G, x) ** 2 * score * (0.5 if probability_flow else 1.0)
        rev_G = torch.zeros_like(G) if probability_flow else G
        return rev_f, rev_G

    def timestep_of(self, t: torch.Tensor) -> torch.Tensor:
        """Discrete schedule index of continuous time ``t`` (truncation)."""
        return (t * (self.N - 1) / self.T).to(torch.int32)

    def corrector_alpha(self, t: torch.Tensor) -> torch.Tensor:
        """alpha_i of the Langevin corrector step size; 1 for VE."""
        return torch.ones_like(t)


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
    """Variance-preserving SDE with a linear beta schedule."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def discrete_betas(self, device=None) -> torch.Tensor:
        return linspace_f32(self.beta_min / self.N, self.beta_max / self.N,
                            self.N, device)

    def alphas(self, device=None) -> torch.Tensor:
        return 1.0 - self.discrete_betas(device)

    def sde(self, x, t):
        beta_t = self.beta_min + t * (self.beta_max - self.beta_min)
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t)

    def marginal_prob(self, x, t):
        lmc = -0.25 * t ** 2 * (self.beta_max - self.beta_min) - 0.5 * t * self.beta_min
        return _bcast(torch.exp(lmc), x) * x, torch.sqrt(1.0 - torch.exp(2.0 * lmc))

    def prior_logp(self, z):
        return _std_normal_logp(z)

    def transition(self, x, t, dt):
        """Mean and std of the transition kernel over a (negative) ``dt``
        (ref SDE_sparse.py:164-169)."""
        lmc = 0.25 * dt * (2 * self.beta_min + (2 * t + dt) * (self.beta_max - self.beta_min))
        return _bcast(torch.exp(-lmc), x) * x, torch.sqrt(1.0 - torch.exp(2.0 * lmc))

    def discretize(self, x, t):
        """DDPM discretization."""
        ts = self.timestep_of(t).long()
        beta = self.discrete_betas(x.device)[ts]
        alpha = self.alphas(x.device)[ts]
        return _bcast(torch.sqrt(alpha), x) * x - x, torch.sqrt(beta)

    def corrector_alpha(self, t):
        return self.alphas(t.device)[self.timestep_of(t).long()]


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
    """Variance-exploding SDE with a geometric sigma schedule."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0

    def discrete_sigmas(self, device=None) -> torch.Tensor:
        return torch.exp(linspace_f32(math.log(self.sigma_min),
                                      math.log(self.sigma_max), self.N, device))

    def sde(self, x, t):
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        diffusion = sigma * math.sqrt(
            2 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def prior_logp(self, z):
        """Under N(0, sigma_max^2 I), though the prior is drawn from N(0, I),
        as the reference and the JAX package have it."""
        return _std_normal_logp(z, self.sigma_max ** 2)

    def transition(self, x, t, dt):
        sigma = lambda s: self.sigma_min * (self.sigma_max / self.sigma_min) ** s  # noqa: E731
        return x, torch.sqrt(sigma(t) ** 2 - sigma(t + dt) ** 2)

    def discretize(self, x, t):
        """SMLD (NCSN) discretization."""
        ts = self.timestep_of(t).long()
        sigmas = self.discrete_sigmas(x.device)
        sigma = sigmas[ts]
        adjacent = torch.where(ts == 0, torch.zeros_like(sigma), sigmas[ts - 1])
        return torch.zeros_like(x), torch.sqrt(sigma ** 2 - adjacent ** 2)


@dataclasses.dataclass(frozen=True)
class SubVPSDE(SDE):
    """Sub-VP SDE."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def discrete_betas(self, device=None) -> torch.Tensor:
        return linspace_f32(self.beta_min / self.N, self.beta_max / self.N, self.N, device)

    def alphas(self, device=None) -> torch.Tensor:
        return 1.0 - self.discrete_betas(device)

    def sde(self, x, t):
        beta_t = self.beta_min + t * (self.beta_max - self.beta_min)
        discount = 1.0 - torch.exp(
            -2 * self.beta_min * t - (self.beta_max - self.beta_min) * t ** 2)
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        lmc = -0.25 * t ** 2 * (self.beta_max - self.beta_min) - 0.5 * t * self.beta_min
        # no sqrt: the reference's sub-VP std, kept as the JAX package keeps it
        return _bcast(torch.exp(lmc), x) * x, 1.0 - torch.exp(2.0 * lmc)

    def prior_logp(self, z):
        return _std_normal_logp(z)

    def corrector_alpha(self, t):
        return self.alphas(t.device)[self.timestep_of(t).long()]


def make_sde(sde_type: str, beta_min: float, beta_max: float, N: int) -> SDE:
    """SDE by name; ``beta_min/beta_max`` double as the VE sigma bounds."""
    kind = sde_type.split("_")[0]  # "VE_test" -> "VE"
    if kind == "VE":
        return VESDE(sigma_min=beta_min, sigma_max=beta_max, N=N)
    if kind == "VP":
        return VPSDE(beta_min=beta_min, beta_max=beta_max, N=N)
    if kind in ("subVP", "SUBVP", "sub"):
        return SubVPSDE(beta_min=beta_min, beta_max=beta_max, N=N)
    raise ValueError(f"unknown SDE type: {sde_type}")


# (resolved type, beta_min, beta_max, N) of each --SDE_type_2Dto3D preset,
# as the JAX package resolves them (pretrain/train_state.py)
SDE_PRESETS_2DTO3D = {
    "VE": ("VE", 0.2, 1.0, 1000),
    "VP": ("VP", 0.2, 1.0, 1000),
    "VE02": ("VE", 0.1, 10.0, 1000),
    "VP02": ("VP", 0.2, 30.0, 1000),
    "VE03": ("VE", 0.1, 1000.0, 1000),
    "VP03": ("VP", 0.2, 1000.0, 1000),
}
# the same for --SDE_type_3Dto2D
SDE_PRESETS_3DTO2D = {
    "VE": ("VE", 0.1, 1.0, 1000),
    "VP": ("VP", 0.2, 1.0, 1000),
    "VE02": ("VE", 0.1, 10.0, 1000),
    "VP02": ("VP", 0.1, 30.0, 1000),
    "VE03": ("VE", 0.1, 1000.0, 1000),
    "VP03": ("VP", 0.1, 1000.0, 1000),
}
