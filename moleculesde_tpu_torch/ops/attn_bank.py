"""Fused multi-head tanh attention-map bank of the 3D->2D edge layers (K7):

    a[b, c, n, m] = (1/H) * sum_h tanh( (q_h[n] . k_h[m]) / sqrt(ds) )

with ``q``/``k`` [B, C, N, A] and heads the contiguous ``ds``-wide chunks of
the feature axis (``H = A // ds``).  Counterpart of
``moleculesde_tpu/ops/rejected/attn_bank.py::attn_map_bank_pallas``,
forward and backward.  On a CUDA tensor the wrappers launch the
hand-written kernels of ``csrc/attn_bank.cu``, which replace the TPU
kernels ``_fwd_kernel`` (``pallas_call`` at ``ops/rejected/attn_bank.py:138``)
and ``_bwd_kernel`` (l.157): both run persistent blocks over units of one
map, the forward (graph, channel, 32 x 32 tile), the backward (graph,
channel, 32 rows) for dq and, past one tile, (graph, channel, 32 columns)
for dk, walking the map in 32-wide chunks, so neither's shared memory
depends on N (:func:`plan`); the per-head logits never leave the block
(the source's header says more).  On a CPU tensor they take
:func:`attn_map_bank_plain` and :func:`attn_map_bank_bwd_plain`.

Numerics, as the TPU kernel's (and not as the eager bank of
``ops/attn_maps.py``): ``bf16`` rounds q and k to bf16, forms each head's
logits with f32 accumulation and takes ``tanh(u / sqrt(ds))`` and the head
mean in f32.  The backward recomputes the logits, rounds
``du_h = g * (1 - t_h^2) * (1 / (H sqrt(ds)))`` to bf16 in bf16 mode before
both products, accumulates dq and dk in f32 and returns them in q's dtype
(the gradient contract of the TPU kernel's custom VJP).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT, resolve_impl, round_bf16, stream
from moleculesde_tpu_torch.utils.flops import report_flops

_DTYPES = (torch.float32, torch.bfloat16)


def _heads(q: torch.Tensor, ds: int) -> int:
    a = q.shape[-1]
    if ds <= 0 or a % ds:
        raise ValueError(f"attn_map_bank: A={a} is not a multiple of ds={ds}")
    return a // ds


def _logits(qr: torch.Tensor, kr: torch.Tensor, ds: int) -> torch.Tensor:
    """Per-head logits ``[B, C, H, N, N]`` (f32) of f32 q / k."""
    b, c, n, a = qr.shape
    h = a // ds
    return torch.einsum("bcnhd,bcmhd->bchnm", qr.reshape(b, c, n, h, ds),
                        kr.reshape(b, c, -1, h, ds))


def attn_map_bank_plain(q: torch.Tensor, k: torch.Tensor, ds: int, *,
                        bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: [B, C, N, N] float32.
    ``bf16`` rounds q and k to bf16; the logits, tanh and head mean stay
    f32, as in the TPU kernel."""
    h = _heads(q, ds)
    u = _logits(round_bf16(q, bf16), round_bf16(k, bf16), ds)
    return torch.tanh(u * (1.0 / math.sqrt(ds))).sum(dim=2) / h


def map_bank_bwd_f32(qr: torch.Tensor, kr: torch.Tensor, g: torch.Tensor, ds: int,
                     bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq, dk) [B, C, N, A] in f32 for the cotangent ``g`` [B, C, N, N], from
    q / k already rounded as the forward rounds them.  ``bf16`` rounds
    ``du`` to bf16 before the two products.  K8's backward shares it."""
    b, c, n, a = qr.shape
    h = a // ds
    inv = 1.0 / math.sqrt(ds)
    t = torch.tanh(_logits(qr, kr, ds) * inv)
    du = round_bf16(g.float()[:, :, None] * (1.0 - t * t) * (inv / h), bf16)
    dq = torch.einsum("bchnm,bcmhd->bcnhd", du, kr.reshape(b, c, -1, h, ds))
    dk = torch.einsum("bchnm,bcnhd->bcmhd", du, qr.reshape(b, c, n, h, ds))
    return dq.reshape(b, c, n, a), dk.reshape(b, c, -1, a)


def attn_map_bank_bwd_plain(q: torch.Tensor, k: torch.Tensor, g: torch.Tensor, ds: int, *,
                            bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dq, dk) [B, C, N, A]
    in q's dtype for the cotangent ``g`` [B, C, N, N]."""
    _heads(q, ds)
    dq, dk = map_bank_bwd_f32(round_bf16(q, bf16), round_bf16(k, bf16), g, ds, bf16)
    return dq.to(q.dtype), dk.to(q.dtype)


FWD_TILE = 32       # csrc/attn_bank.cu::kTile: rows (and columns) of a unit, both directions


def flops(b: int, c: int, n: int, a: int, bwd: bool = False) -> int:
    """Matrix-product FLOPs of the plain version (what ``matmul_flops``
    counts there), which the kernels report: the per-head logits ``q k^T``
    [B*C*H, N, ds] x [ds, N]; the backward recomputes them and adds ``du
    k`` and ``du^T q``."""
    return (6 if bwd else 2) * b * c * n * n * a


def tile_rows(n: int, h: int, budget: int) -> int:
    """Rows of the map K8's backward takes at once before shared memory
    forces fewer (``attn_map.cuh::tile_rows``): as many as keep every
    head's du within ``budget`` words (``attn_qk_bank.BWD_DU_WORDS``), 1
    to N."""
    return min(n, max(1, budget // (h * n)))


def du_words(n: int, rows: int, h: int) -> int:
    """Words of a row tile's du in K8's backward, every head padded by one
    word."""
    return h * (rows * n + 1)


def row_stride(a: int) -> int:
    """Words between the f32 q / k rows a block reads (``attn_map.cuh::
    row_stride``): 16-byte aligned, 4 past a multiple of 4 words."""
    return -(-a // 4) * 4 + 4


def plan(n: int, a: int, h: int, bwd: bool) -> Tuple[int, int]:
    """The launch plan of a forward (``bwd`` False) or backward block of
    csrc/attn_bank.cu: (rows, shared-memory bytes), neither depending on N.
    The forward's unit is a :data:`FWD_TILE` x :data:`FWD_TILE` tile of one
    map: the staged q and k rows, room for f32, and their f32 copies
    :func:`row_stride` words apart.  The backward's unit is :data:`FWD_TILE`
    rows of one map (or, past one tile, as many columns), walked in chunks
    of as many columns: the forward's staged and f32 rows, every head's
    32 x 32 du (4 words apart) and the output's chains [32, A].
    Raises where a block's shared memory does not fit (A, H too wide)."""
    rows = FWD_TILE
    if bwd:
        smem = 4 * (3 * rows * a + 2 * rows * row_stride(a) + h * (rows * rows + 4))
    else:
        smem = 4 * 2 * rows * (a + row_stride(a))
    if smem > SMEM_LIMIT:
        raise ValueError(f"attn_map_bank {'backward' if bwd else 'forward'} kernel: N={n}, "
                         f"A={a}, H={h} need {smem} B of shared memory per block "
                         f"(> {SMEM_LIMIT})")
    return rows, smem


def _check_kernel_inputs(q, k, ds, g=None):
    tensors = {"q": q, "k": k} if g is None else {"q": q, "k": k, "g": g}
    for name, t in tensors.items():
        if t.device != q.device or not t.is_cuda:
            raise ValueError(f"attn_map_bank kernel: {name} must be on {q.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"attn_map_bank kernel: {name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError("attn_map_bank kernel: q and k must share one dtype, float32 "
                        f"or bfloat16 (got {q.dtype}, {k.dtype})")
    if g is not None and g.dtype != torch.float32:
        raise TypeError("attn_map_bank kernel: g must be float32")
    if q.ndim != 4 or tuple(k.shape) != tuple(q.shape):
        raise ValueError(f"attn_map_bank kernel: expected q, k [B,C,N,A] of one shape "
                         f"(q{tuple(q.shape)} k{tuple(k.shape)})")
    b, c, n, a = q.shape
    h = _heads(q, ds)
    if g is not None and tuple(g.shape) != (b, c, n, n):
        raise ValueError(f"attn_map_bank kernel: g{tuple(g.shape)} != {(b, c, n, n)}")
    return plan(n, a, h, g is not None)


def _launch(q, k, ds: int, bf16: bool) -> torch.Tensor:
    _, smem = _check_kernel_inputs(q, k, ds)
    b, c, n, a = q.shape
    out = torch.empty((b, c, n, n), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    fn = build.load("attn_bank").attn_map_bank_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), out.data_ptr(), b * c, n, a, ds,
            int(q.dtype == torch.bfloat16), int(bf16), smem, stream(q))
    build.check_launch(rc, "attn_map_bank_fwd")
    attn_map_bank_kernel.launches += 1
    report_flops(flops(b, c, n, a))
    return out


def _launch_bwd(q, k, g, ds: int, bf16: bool):
    rows, smem = _check_kernel_inputs(q, k, ds, g)
    b, c, n, a = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    if q.numel() == 0:
        return dq.zero_(), dk.zero_()
    fn = build.load("attn_bank").attn_map_bank_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            b * c, n, a, ds, int(q.dtype == torch.bfloat16), int(bf16), rows, smem, stream(q))
    build.check_launch(rc, "attn_map_bank_bwd")
    attn_map_bank_kernel_bwd.launches += 1
    report_flops(flops(b, c, n, a, bwd=True))
    return dq, dk


def attn_map_bank_kernel_bwd(q, k, g, ds: int, *, bf16: bool = False, impl: str = "auto"):
    """Backward of :func:`attn_map_bank_kernel` for the cotangent ``g``
    [B, C, N, N]: (dq, dk) in q's dtype.  ``impl`` as there."""
    if resolve_impl(impl, q, "attn_map_bank") == "plain":
        return attn_map_bank_bwd_plain(q, k, g, ds, bf16=bf16)
    return _launch_bwd(q, k, g, ds, bf16)


class _AttnMapBank(torch.autograd.Function):
    """The kernel pair (or the plain pair) under autograd."""

    @staticmethod
    def forward(ctx, q, k, ds, bf16, impl):
        ctx.save_for_backward(q, k)
        ctx.ds, ctx.bf16, ctx.impl = ds, bf16, impl
        if impl == "plain":
            return attn_map_bank_plain(q, k, ds, bf16=bf16)
        return _launch(q, k, ds, bf16)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        dq, dk = attn_map_bank_kernel_bwd(q, k, g.float().contiguous(), ctx.ds,
                                          bf16=ctx.bf16, impl=ctx.impl)
        return dq, dk, None, None, None


def attn_map_bank_kernel(q: torch.Tensor, k: torch.Tensor, ds: int, *, bf16: bool = False,
                         impl: str = "auto") -> torch.Tensor:
    """Head-mean tanh maps [B, C, N, N] float32 from q, k [B, C, N, A]
    (float32 or bfloat16, one dtype), differentiable in q and k.  ``impl``:
    "auto" (the kernels for a CUDA tensor, the plain versions for a CPU
    tensor), "kernel" or "plain".  Both kernels take any N (:func:`plan`);
    they raise on shapes they are not built for."""
    return _AttnMapBank.apply(q, k, ds, bf16, resolve_impl(impl, q, "attn_map_bank"))


attn_map_bank_kernel.launches = 0
attn_map_bank_kernel_bwd.launches = 0
