"""Multi-head tanh attention-map bank of the 3D->2D score networks.

    a[b, c, n, m] = (1/H) * sum_h tanh( (q_h . k_h) / sqrt(ds) )

with ``q``/``k`` [B, C, N, A] and heads taken as contiguous ``ds``-wide
chunks of the feature axis (``H = A // ds``; reference
Geom3D/models/MoleculeSDE/layers/edge_network_dense.py:66-79).

Counterpart of the ``xla`` form of ``moleculesde_tpu/ops/attn_maps.py``
(l.27-44), the form the JAX package's pretraining step runs off the TPU and
the form its ``attn_impl="auto"`` default computes.  The opt-in Pallas
banks (K7 / K8) are not ported yet.
"""

from __future__ import annotations

import math

import torch


def attn_map_bank(q: torch.Tensor, k: torch.Tensor, ds: int, *,
                  bf16: bool = False) -> torch.Tensor:
    """Head-mean tanh maps ``[B, C, N, N]`` f32 from ``q``/``k``
    ``[B, C, N, A]``.  ``bf16`` runs the logits and the tanh in bf16; the
    head mean accumulates in f32."""
    dt = torch.bfloat16 if bf16 else torch.float32
    b, c, n, a = q.shape
    h = a // ds
    qh = q.to(dt).reshape(b, c, n, h, ds)
    kh = k.to(dt).reshape(b, c, n, h, ds)
    u = torch.einsum("bcnhd,bcmhd->bchnm", qh, kh) / math.sqrt(ds)
    return torch.tanh(u).mean(dim=2, dtype=torch.float32)
