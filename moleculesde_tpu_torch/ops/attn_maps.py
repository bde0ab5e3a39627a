"""Multi-head tanh attention-map bank of the 3D->2D score networks.

    a[b, c, n, m] = (1/H) * sum_h tanh( (q_h . k_h) / sqrt(ds) )

with ``q``/``k`` [B, C, N, A] and heads taken as contiguous ``ds``-wide
chunks of the feature axis (``H = A // ds``; reference
Geom3D/models/MoleculeSDE/layers/edge_network_dense.py:66-79).

Counterpart of ``moleculesde_tpu/ops/attn_maps.py::attn_map_bank``
(l.86-124) and its dispatch: "auto" and "xla" are the eager form (l.27-44,
what the JAX package's "auto" computes off the TPU) and "pallas" the fused
kernel K7 (``ops/attn_bank.py``).  "wide" is accepted as an alias of the
eager form: in JAX it is a TPU lane layout (l.47-83) of the same function,
whose bf16 head mean differs only in summation order (1/H is exact for H a
power of two), and that layout buys nothing on the GPU.
"""

from __future__ import annotations

import math

import torch

from moleculesde_tpu_torch.ops.attn_bank import attn_map_bank_kernel

IMPLS = ("auto", "xla", "wide", "pallas")


def _bank_xla(q: torch.Tensor, k: torch.Tensor, ds: int) -> torch.Tensor:
    """Per-head logits materialized, tanh in the operand dtype, head mean
    accumulated in f32."""
    b, c, n, a = q.shape
    h = a // ds
    qh = q.reshape(b, c, n, h, ds)
    kh = k.reshape(b, c, n, h, ds)
    u = torch.einsum("bcnhd,bcmhd->bchnm", qh, kh) / math.sqrt(ds)
    return torch.tanh(u).mean(dim=2, dtype=torch.float32)


def attn_map_bank(q: torch.Tensor, k: torch.Tensor, ds: int, *,
                  bf16: bool = False, impl: str = "auto",
                  kernel_impl: str = "auto") -> torch.Tensor:
    """Head-mean tanh maps ``[B, C, N, N]`` f32 from ``q``/``k``
    ``[B, C, N, A]``.  ``impl``: "auto" / "xla" (the eager form: in bf16
    the logits and the tanh run in bf16, the head mean accumulates in f32),
    "wide" (an alias of the eager form; a TPU layout in JAX) or "pallas"
    (K7, which keeps the logits and the tanh in f32 in bf16 mode, as the
    TPU kernel does; ``kernel_impl`` as the kernel wrappers' ``impl``: its
    kernel on a CUDA tensor, its plain version on a CPU one by default)."""
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k = q.to(dt), k.to(dt)
    if impl in ("auto", "xla", "wide"):
        return _bank_xla(q, k, ds)
    if impl == "pallas":
        return attn_map_bank_kernel(q.contiguous(), k.contiguous(), ds, bf16=bf16,
                                    impl=kernel_impl)
    raise ValueError(f"unknown attn_map_bank impl: {impl} (one of {IMPLS})")
