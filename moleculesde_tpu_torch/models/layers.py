"""Building blocks with flax's parameter layout and numerics.

Counterpart of ``moleculesde_tpu/models/layers.py``.  Parameters keep the
JAX package's names and shapes (``kernel`` is ``[in, out]``, as flax
stores it), so a converted flax tree loads with ``load_state_dict``
(``convert.py``).

- :class:`Dense` is ``nn.Dense`` and ``DenseParams`` at once: callers either
  apply it or read its raw ``kernel`` / ``bias``.
- :class:`MaskedBatchNorm` takes statistics over valid rows only (biased
  variance, eps 1e-5) and updates its running statistics as
  ``0.9 * old + 0.1 * new``; under a data-parallel group
  (:mod:`~moleculesde_tpu_torch.parallel.collectives`) from the sums and
  counts of all ranks, the mean first, then the variance about it, so the
  running statistics end the same on every rank.
- :class:`PairMaskedBatchNorm` does the same over an implicit pair tensor
  and returns the normalization folded into the two node halves.
- :class:`LayerNorm` is flax's: eps 1e-6, statistics in f32 even under a
  bf16 dtype (E[x^2] - E[x]^2, clipped at 0).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from moleculesde_tpu_torch.ops.pair_block import pair_mean_var
from moleculesde_tpu_torch.parallel import collectives as dp

ACTIVATIONS = {"relu": F.relu, "silu": F.silu, "elu": F.elu, "tanh": torch.tanh}


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each entry with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)`` (in x's dtype); the keep
    mask is drawn from ``generator`` (the global generator when None).
    Under a data-parallel group ``x`` is the rank's block (axis 0) of the
    global batch's tensor: the mask is drawn at the global shape and the
    rank keeps its block."""
    if deterministic or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = dp.block(torch.rand(dp.global_shape(x.shape), generator=generator,
                               device=x.device)) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every parameter and statistic of ``module`` the way the
    JAX package initializes it: kernels and embeddings xavier-uniform (a
    channel-stacked ``[C, in, out]`` kernel and GAT's ``att`` [1, heads,
    2F] with flax's fans, the last two axes), biases and
    ``eps`` zero, norm scales one, frozen Fourier weights N(0, 1), running
    means zero and running variances one."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("kernel", "embedding", "root_emb") or (
                    leaf.endswith("_kernel") and p.ndim == 2):
                nn.init.xavier_uniform_(p, generator=generator)
            elif ("kernel" in leaf or leaf == "att") and p.ndim == 3:
                bound = math.sqrt(6.0 / (p.shape[1] + p.shape[2]))
                nn.init.uniform_(p, -bound, bound, generator=generator)
            elif leaf in ("eps",) or "bias" in leaf:
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf.endswith("fourier_W"):
                nn.init.normal_(p, 0.0, 1.0, generator=generator)
            else:
                raise ValueError(f"no initializer for parameter {name}")
        for name, buf in module.named_buffers():
            buf.fill_(1.0 if name.endswith("var") else 0.0)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with a flax-layout ``[in, out]`` kernel.

    ``dtype`` is the compute dtype (flax ``promote_dtype``): inputs and
    params are cast to it; ``None`` promotes to the wider of the two."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class Embed(nn.Module):
    """An embedding table ``[num, features]`` (flax ``nn.Embed``)."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))


class MLP(nn.Module):
    """Dense stack with an activation between layers but not after the last.

    ``channel_major=True`` applies each layer over axis 1 of a ``[B, C, P]``
    input (``einsum("bcp,co->bop")``), with the same parameters."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 activation: str = "relu", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.dtype = dtype
        self.num_layers = len(hidden_dims)
        dims = [in_dim] + list(hidden_dims)
        for i in range(self.num_layers):
            setattr(self, f"Dense_{i}", Dense(dims[i], dims[i + 1], dtype=dtype))

    def forward(self, x: torch.Tensor, channel_major: bool = False) -> torch.Tensor:
        for i in range(self.num_layers):
            layer = getattr(self, f"Dense_{i}")
            if channel_major:
                dt = self.dtype or x.dtype
                x = (torch.einsum("bcp,co->bop", x.to(dt), layer.kernel.to(dt))
                     + layer.bias.to(dt)[None, :, None])
            else:
                x = layer(x)
            if i < self.num_layers - 1:
                x = self.act(x)
        return x


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded ``[N, F]`` array; output f32."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                use_running_average: bool = False) -> torch.Tensor:
        x = x.float()
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            if mask is None and dp.active() is None:
                mean = x.mean(dim=0)
                var = x.var(dim=0, unbiased=False)
            else:   # under a data-parallel group: sums and counts over all ranks
                m = (torch.ones_like(x[:, :1]) if mask is None else mask.float()[:, None])
                count = dp.global_sum(m.sum()).clamp(min=1.0)
                mean = dp.global_sum((x * m).sum(dim=0)) / count
                var = dp.global_sum((((x - mean) ** 2) * m).sum(dim=0)) / count
            self._update(mean, var)
        return (x - mean) / torch.sqrt(var + self.epsilon) * self.scale + self.bias


class PairMaskedBatchNorm(MaskedBatchNorm):
    """Masked BatchNorm of ``x[b,s,d] = src[b,s] + dst[b,d]`` over valid
    pairs, folded into the halves: returns ``(a, c)`` with
    ``BN(x)[b,s,d] = a[b,s] + c[b,d]``, ``a = src * g``,
    ``c = dst * g + (beta - mean * g)``, ``g = gamma / sqrt(var + eps)``."""

    def forward(self, src: torch.Tensor, dst: torch.Tensor,
                pair_mask: torch.Tensor, use_running_average: bool = False):
        src = src.float()
        dst = dst.float()
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, var = pair_mean_var(src, dst, pair_mask)
            self._update(mean, var)
        g = self.scale / torch.sqrt(var + self.epsilon)
        return src * g, dst * g + (self.bias - mean * g)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, f32 statistics, output in ``dtype``
    (``None``: f32 for f32 or bf16 inputs, as flax promotes with its f32
    params)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 epsilon: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp(min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(self.dtype or torch.float32)
