"""Fused SchNet CFConv: filter MLP + cutoff envelope + neighbour aggregation
without writing the ``[B, N, N, F]`` filter tensors to device memory.

    out[b, i, f] = sum_j env[b, i, j]
                   * ((softplus(ea[b, i, j] @ W1 + b1) - log 2) @ W2 + b2)[f]
                   * x[b, j, f]

Counterpart of ``moleculesde_tpu/ops/cfconv.py::fused_cfconv``, forward
and backward.  On a CUDA tensor the wrappers launch the hand-written
kernels of ``csrc/cfconv.cu``, which replace the TPU kernels
``_fwd_kernel`` (``pallas_call`` at ``ops/cfconv.py:212``) and
``_bwd_kernel`` (l.228): both are arithmetic-bound; the backward
recomputes the filter instead of reading it (the source's header says
more).  On a CPU tensor they take :func:`fused_cfconv_plain` and
:func:`fused_cfconv_bwd_plain`, which round to bf16 where the TPU kernel
rounds.

GRADIENT CONTRACT, as in the JAX package: ``ea`` and ``env`` get no
gradient.  The kernel serves paths where positions carry none
(pretraining); :func:`fused_cfconv` raises if either needs one, so a force
path (F = -dE/dpos) can never get zero forces without notice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT, resolve_impl, round_bf16, stream

_LOG2 = math.log(2.0)


def _filter(ea, w1, b1, w2, b2, bf16: bool):
    """(ea, pre, s, wf) of the filter net in the kernel's roundings."""
    ea = round_bf16(ea, bf16)
    pre = ea @ round_bf16(w1, bf16) + b1.float()
    s = torch.logaddexp(pre, torch.zeros((), device=pre.device)) - _LOG2
    wf = round_bf16(s, bf16) @ round_bf16(w2, bf16) + b2.float()
    return ea, pre, s, wf


def fused_cfconv_plain(ea, env, x, w1, b1, w2, b2, *, bf16: bool = False):
    """Plain PyTorch version of the forward kernel: [B, N, F] f32.

    ``bf16`` rounds ea, x, W1, W2 and the softplus output to bf16 before the
    products (f32 accumulation); biases, softplus, envelope and the sum
    stay f32, as in the TPU kernel."""
    _, _, _, wf = _filter(ea, w1, b1, w2, b2, bf16)
    x = round_bf16(x, bf16)
    return (wf * env.float()[..., None] * x[:, None, :, :]).sum(dim=2)


def fused_cfconv_bwd_plain(ea, env, x, w1, b1, w2, b2, g, *, bf16: bool = False):
    """Plain PyTorch version of the backward kernel: (dx [B, N, F], dw1,
    db1, dw2, db2), f32, for the output cotangent ``g`` [B, N, F].

    ``dwf = (g_i * x_j) * env_ij`` and ``dpre = (dwf @ W2^T) * softplus'``
    are rounded to bf16 for the weight products in bf16 mode, dx is
    returned rounded to bf16 (x's dtype in the TPU kernel), and the bias
    gradients sum unrounded f32."""
    ea, pre, s, wf = _filter(ea, w1, b1, w2, b2, bf16)
    env4 = env.float()[..., None]
    x = round_bf16(x, bf16)
    gout = g.float()
    dx = round_bf16((wf * env4 * gout[:, :, None, :]).sum(dim=1), bf16)
    dwf = gout[:, :, None, :] * x[:, None, :, :] * env4
    f = w2.shape[1]
    dwfl = round_bf16(dwf, bf16).reshape(-1, f)
    dw2 = round_bf16(s, bf16).reshape(-1, f).t() @ dwfl
    dpre = ((dwfl @ round_bf16(w2, bf16).t()).reshape(pre.shape)
            * torch.exp(pre - s - _LOG2))
    dw1 = ea.reshape(-1, ea.shape[-1]).t() @ round_bf16(dpre, bf16).reshape(-1, f)
    return dx, dw1, dpre.sum(dim=(0, 1, 2)), dw2, dwf.sum(dim=(0, 1, 2))


def _check_kernel_inputs(ea, env, x, w1, b1, w2, b2, g=None):
    tensors = {"ea": ea, "env": env, "x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    if g is not None:
        tensors["g"] = g
    for name, t in tensors.items():
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"fused_cfconv kernel: {name} must be on {x.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"fused_cfconv kernel: {name} must be contiguous")
        if t.dtype != torch.float32 and not (name == "ea" and t.dtype == torch.bfloat16):
            raise TypeError(f"fused_cfconv kernel: {name} must be float32"
                            + (" or bfloat16" if name == "ea" else ""))
    if ea.ndim != 4 or x.ndim != 3:
        raise ValueError("fused_cfconv kernel: expected ea [B,N,N,G], x [B,N,F]")
    b, n, _, gdim = ea.shape
    f = x.shape[2]
    if (tuple(env.shape) != (b, n, n) or tuple(x.shape) != (b, n, f)
            or tuple(w1.shape) != (gdim, f) or tuple(b1.shape) != (f,)
            or tuple(w2.shape) != (f, f) or tuple(b2.shape) != (f,)
            or (g is not None and tuple(g.shape) != (b, n, f))):
        raise ValueError("fused_cfconv kernel: inconsistent shapes "
                         f"ea{tuple(ea.shape)} env{tuple(env.shape)} x{tuple(x.shape)} "
                         f"w1{tuple(w1.shape)} w2{tuple(w2.shape)}")
    if f % 4 or f > 1024:
        raise ValueError(f"fused_cfconv kernel: needs F % 4 == 0 and F <= 1024 (F={f})")


def _smem(fn_name: str, *args) -> int:
    fn = getattr(build.load("cfconv"), fn_name)
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * len(args)
    return int(fn(*args))


def _row_groups(n: int, gdim: int, f: int) -> int:
    """Rows per forward block: the most (4, 2, 1) that fit 1024 threads and
    the shared memory."""
    for rg in (4, 2, 1):
        if rg * f <= 1024 and _smem("cfconv_fwd_smem", n, gdim, f, rg) <= SMEM_LIMIT:
            return rg
    raise ValueError(f"fused_cfconv kernel: N={n}, G={gdim}, F={f} do not fit "
                     f"{SMEM_LIMIT} B of shared memory")


def _launch(ea, env, x, w1, b1, w2, b2, bf16: bool) -> torch.Tensor:
    _check_kernel_inputs(ea, env, x, w1, b1, w2, b2)
    b, n, _, gdim = ea.shape
    f = x.shape[2]
    out = torch.empty((b, n, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.load("cfconv").cfconv_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rc = fn(ea.data_ptr(), env.data_ptr(), x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            b, n, gdim, f, _row_groups(n, gdim, f), int(ea.dtype == torch.bfloat16),
            int(bf16), stream(x))
    build.check_launch(rc, "cfconv_fwd")
    fused_cfconv.launches += 1
    return out


def _launch_bwd(ea, env, x, w1, b1, w2, b2, g, bf16: bool):
    _check_kernel_inputs(ea, env, x, w1, b1, w2, b2, g)
    b, n, _, gdim = ea.shape
    f = x.shape[2]
    if _smem("cfconv_bwd_smem", n, gdim, f) > SMEM_LIMIT:
        raise ValueError(f"fused_cfconv backward kernel: N={n}, G={gdim}, F={f} "
                         f"do not fit {SMEM_LIMIT} B of shared memory")
    dev = x.device
    dx = torch.empty((b, n, f), dtype=torch.float32, device=dev)
    dw1 = torch.empty((gdim, f), dtype=torch.float32, device=dev)
    db1 = torch.empty((f,), dtype=torch.float32, device=dev)
    dw2 = torch.empty((f, f), dtype=torch.float32, device=dev)
    db2 = torch.empty((f,), dtype=torch.float32, device=dev)
    if dx.numel() == 0:
        return dx, dw1.zero_(), db1.zero_(), dw2.zero_(), db2.zero_()
    part = torch.empty((b * (gdim * f + f * f + 2 * f),), dtype=torch.float32,
                       device=dev)
    fn = build.load("cfconv").cfconv_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(ea.data_ptr(), env.data_ptr(), x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), part.data_ptr(), b, n, gdim, f,
            int(ea.dtype == torch.bfloat16), int(bf16), stream(x))
    build.check_launch(rc, "cfconv_bwd")
    fused_cfconv_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


def fused_cfconv_bwd(ea, env, x, w1, b1, w2, b2, g, *, bf16: bool = False,
                     impl: str = "auto"):
    """Backward of :func:`fused_cfconv` for the output cotangent ``g``
    [B, N, F]: returns (dx, dw1, db1, dw2, db2), f32.  ``impl`` as in
    :func:`fused_cfconv`."""
    if resolve_impl(impl, x, "fused_cfconv") == "plain":
        return fused_cfconv_bwd_plain(ea, env, x, w1, b1, w2, b2, g, bf16=bf16)
    return _launch_bwd(ea, env, x, w1, b1, w2, b2, g, bf16)


class _FusedCFConv(torch.autograd.Function):
    """The kernel pair (or the plain pair) under autograd; no gradient for
    ``ea`` or ``env`` (the wrapper refuses them if they need one)."""

    @staticmethod
    def forward(ctx, ea, env, x, w1, b1, w2, b2, bf16, impl):
        ctx.save_for_backward(ea, env, x, w1, b1, w2, b2)
        ctx.bf16, ctx.impl = bf16, impl
        if impl == "plain":
            return fused_cfconv_plain(ea, env, x, w1, b1, w2, b2, bf16=bf16)
        return _launch(ea, env, x, w1, b1, w2, b2, bf16)

    @staticmethod
    def backward(ctx, g):
        ea, env, x, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_cfconv_bwd(
            ea, env, x, w1, b1, w2, b2, g.contiguous(), bf16=ctx.bf16, impl=ctx.impl)
        return None, None, dx, dw1, db1, dw2, db2, None, None


def fused_cfconv(ea, env, x, w1, b1, w2, b2, *, bf16: bool = False,
                 impl: str = "auto") -> torch.Tensor:
    """Fused CFConv (module docstring): returns [B, N, F] float32,
    differentiable in x and the four filter-net weights.

    ``ea``: [B, N, N, G] smeared distances, f32 or bf16 (the kernel reads
    it as given, so bf16 halves its largest read); ``env``: [B, N, N] cutoff
    envelope times the pair mask; ``x``: [B, N, F] lin1 features (f32);
    ``w1`` [G, F], ``b1`` [F], ``w2`` [F, F], ``b2`` [F].  ``bf16`` runs the
    products in bf16 as the TPU kernel does.  ``impl``: "auto" (the kernels
    for a CUDA tensor, the plain versions for a CPU tensor), "kernel" or
    "plain".  Raises if ``ea`` or ``env`` requires a gradient."""
    if torch.is_grad_enabled() and (ea.requires_grad or env.requires_grad):
        raise RuntimeError("fused_cfconv gives no gradient to ea or env (the "
                           "TPU kernel's contract): positions must not require "
                           "grad through it")
    return _FusedCFConv.apply(ea, env, x, w1, b1, w2, b2, bf16,
                               resolve_impl(impl, x, "fused_cfconv"))


fused_cfconv.launches = 0
fused_cfconv_bwd.launches = 0
