"""Shared numeric guards for frame / score math, and what the kernel
wrappers of ``ops/`` share.

``EPSILON`` is the reference's frame-normalization guard
(SDE_model_2D_to_3D.py:32).  ``SQRT_GUARD`` goes inside square roots so
padded all-zero rows stay finite; it changes values by < 1e-12.

The kernel wrappers share the bf16 rounding of their plain versions, the
choice between a kernel and its plain version, the stream a kernel
launches on, and the shared memory a Hopper block may use.
"""

from __future__ import annotations

import torch

EPSILON = 1e-6
SQRT_GUARD = 1e-24
SMEM_LIMIT = 232448        # dynamic shared memory a block may use on Hopper


def round_bf16(t: torch.Tensor, enabled: bool = True) -> torch.Tensor:
    """``t`` rounded to bf16 and back to f32 (``t`` as f32 if not
    ``enabled``): where a kernel's bf16 mode rounds an operand."""
    return t.to(torch.bfloat16).to(torch.float32) if enabled else t.float()


def resolve_impl(impl: str, t: torch.Tensor, what: str) -> str:
    """"kernel" or "plain": "auto" takes the kernel for a CUDA tensor and
    the plain version for a CPU tensor, and nothing else."""
    if impl == "auto":
        return "kernel" if t.is_cuda else "plain"
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown {what} impl: {impl}")
    return impl


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a handle for a C entry."""
    return torch.cuda.current_stream(t.device).cuda_stream
