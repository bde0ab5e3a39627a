"""Dense masking helpers of the 3D->2D diffusion path.

Counterpart of ``moleculesde_tpu/core/masks.py`` (reference
SDE_model_3D_to_2D_node_adj_dense.py:523-562).
"""

from __future__ import annotations

from typing import Optional

import torch


def node_flags(adj: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-node 0/1 flags (f32) from a dense adjacency ``[B, N, N]`` or
    ``[B, C, N, N]``: a node is on iff its row has mass, so isolated atoms
    are off, as in the reference."""
    flags = (adj.abs().sum(dim=-1) > eps).float()
    return flags[:, 0, :] if flags.ndim == 3 else flags


def mask_x(x: torch.Tensor, flags: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the padded node rows of ``[B, N, F]`` features."""
    return x if flags is None else x * flags[:, :, None]


def mask_adjs(adjs: torch.Tensor, flags: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the padded rows and columns of ``[B, N, N]`` or ``[B, C, N, N]``."""
    if flags is None:
        return adjs
    f = flags[:, None, :] if adjs.ndim == 4 else flags
    return adjs * f[..., :, None] * f[..., None, :]
