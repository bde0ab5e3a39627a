"""Fused pair-feature block: ``relu(a_s + c_d) @ W + bias`` without writing
``[B, N, N, C]`` to device memory, and the analytic masked BatchNorm
statistics of an implicit pair tensor.

Counterpart of ``moleculesde_tpu/ops/pair_block.py`` (``pair_mean_var``,
``pair_relu_project`` and ``pair_relu_project_cm``, forward and backward).
On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/pair_block.cu``, which replace the TPU kernels ``_fwd_kernel``
(``pallas_call`` at ``ops/pair_block.py:170``), ``_bwd_kernel`` (l.193),
``_fwd_kernel_cm`` (l.337) and ``_bwd_kernel_cm`` (l.361): all form each
pair value in registers, so the pair tensor never reaches device memory,
and all run their products on the tensor cores in bf16 mode.  The forward
walks (graph, 16 dests, TS sources) units in persistent blocks whose
shared memory does not depend on N (:func:`fwd_plan`): it takes any N whose
output the int32 index reaches.  The backward runs in blocks of (graph, 64
or 32 channels) chosen by N (:func:`bwd_plan`), so it takes any N up to 748
(the source's header says more).  On a CPU tensor they take the
``*_plain`` versions.
:func:`pair_relu_project` (K3, ``[B, N, N, H]``) and
:func:`pair_relu_project_cm` (K4, ``[B, H, N*N]``) are differentiable
through ``torch.autograd.Function``s: a, c, w and the bias get gradients,
as from the TPU kernels' custom VJPs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT, resolve_impl, round_bf16, stream
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.utils.flops import report_flops

_CHAN_TILE = 32            # the backward's output channels, H <= 32 (csrc/pair_block.cu)


def pair_mean_var(src: torch.Tensor, dst: torch.Tensor, pair_mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-channel mean and biased variance of the implicit pair
    tensor ``x[b,s,d,:] = src[b,s,:] + dst[b,d,:]`` over pairs where
    ``pair_mask`` [B, N, N] is True, from degree-weighted node sums and one
    bilinear cross term — the pair tensor is never built.  Under a
    data-parallel group the sums and the count are over all ranks' graphs."""
    src = src.float()
    dst = dst.float()
    m = pair_mask.float()
    outdeg = m.sum(dim=2)  # [B, N] valid dests per source
    indeg = m.sum(dim=1)   # [B, N] valid sources per dest
    count = dp.global_sum(m.sum()).clamp(min=1.0)
    mean = dp.global_sum(torch.einsum("bs,bsc->c", outdeg, src)
                         + torch.einsum("bd,bdc->c", indeg, dst)) / count
    # centre each half by mean/2 so x - mean = u_s + v_d
    u = src - 0.5 * mean
    v = dst - 0.5 * mean
    cross = torch.einsum("bsc,bsc->c", u, torch.bmm(m, v))
    var = dp.global_sum(torch.einsum("bs,bsc->c", outdeg, u * u)
                        + torch.einsum("bd,bdc->c", indeg, v * v) + 2.0 * cross) / count
    return mean, var.clamp(min=0.0)


def flops(b: int, n: int, cdim: int, h: int, bwd: bool = False) -> int:
    """Matrix-product FLOPs of the plain version (K3's and K4's, what
    ``matmul_flops`` counts there), which the kernels report: ``relu(pair)
    @ W`` [B*N*N, C] x [C, H]; the backward ``g @ W^T`` and ``relu(pair)^T
    @ g``."""
    return (4 if bwd else 2) * b * n * n * cdim * h


def pair_relu_project_plain(a, c, w, bias: Optional[torch.Tensor] = None, *,
                            bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function (materializes the pair
    tensor): [B, N, N, H] float32.  ``bf16`` rounds the relu'd pair and ``w``
    to bf16 with f32 accumulation, as the kernel does."""
    pair = torch.relu(a.float()[:, :, None, :] + c.float()[:, None, :, :])
    out = round_bf16(pair, bf16) @ round_bf16(w, bf16)
    return out if bias is None else out + bias.float()


def pair_relu_project_bwd_plain(a, c, w, g, *, bf16: bool = False):
    """Plain PyTorch version of the backward kernel: (da, dc [B, N, C],
    dw [C, H], db [H]), f32, for the output cotangent ``g`` [B, N, N, H].

    The relu mask comes from the f32 pair; ``bf16`` rounds g, w and the
    relu'd pair to bf16 for the two products (f32 accumulation) and keeps
    db unrounded, as the TPU kernel does."""
    pair = a.float()[:, :, None, :] + c.float()[:, None, :, :]
    relu, gg, ww = (round_bf16(t, bf16) for t in (torch.relu(pair), g, w))
    dpair = torch.where(pair > 0, gg @ ww.t(), torch.zeros((), device=g.device))
    cdim, h = w.shape
    dw = relu.reshape(-1, cdim).t() @ gg.reshape(-1, h)
    return dpair.sum(dim=2), dpair.sum(dim=1), dw, g.float().reshape(-1, h).sum(dim=0)


def pair_relu_project_cm_plain(a, c, w, *, bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the channel-major kernel (K4):
    ``out[b, h, s*N + d] = relu(a[b, s] + c[b, d]) @ w[:, h]`` -> [B, H, N*N]
    float32, no bias.  ``bf16`` rounds a and c before the add, the relu'd
    pair and ``w`` to bf16 (f32 accumulation), as the TPU kernel does."""
    b, n, _ = a.shape
    pair = torch.relu(round_bf16(a, bf16)[:, :, None, :] + round_bf16(c, bf16)[:, None, :, :])
    out = round_bf16(pair, bf16) @ round_bf16(w, bf16)          # [B, N, N, H]
    return out.reshape(b, n * n, -1).transpose(1, 2).contiguous()


def pair_relu_project_cm_bwd_plain(a, c, w, g, *, bf16: bool = False):
    """Plain PyTorch version of the channel-major backward kernel: (da, dc
    [B, N, C], dw [C, H]), f32, for the cotangent ``g`` [B, H, N*N]; no db
    (the bias is added outside the kernel).  ``bf16`` rounds a and c, g, w
    and the relu'd pair to bf16, masks the f32 ``dpair`` by ``pair > 0`` and
    rounds it to bf16 before the two sums, as the TPU kernel does."""
    b, n, cdim = a.shape
    h = w.shape[1]
    pair = round_bf16(a, bf16)[:, :, None, :] + round_bf16(c, bf16)[:, None, :, :]
    relu = round_bf16(torch.relu(pair), bf16)
    gg = round_bf16(g, bf16).transpose(1, 2).reshape(b, n, n, h)
    dpair = torch.where(pair > 0, gg @ round_bf16(w, bf16).t(),
                        torch.zeros((), device=g.device))
    dpair = round_bf16(dpair, bf16)
    dw = relu.reshape(-1, cdim).t() @ gg.reshape(-1, h)
    return dpair.sum(dim=2), dpair.sum(dim=1), dw


_BWD_STAGE_BYTES = 36864   # the backward's stage area (csrc/pair_block.cu)


def bwd_plan(n: int, cdim: int) -> dict:
    """Launch plan of the backward kernels (K3 and K4), mirrored from
    ``csrc/pair_block.cu::bwd_chunk``: one block per (graph, chunk of
    ``chunk`` = 64 or 32 channels), the larger whose shared memory fits
    ``SMEM_LIMIT``: a's chunk columns and the da sums (``N * chunk`` words
    each), the dc exchange (``32 * chunk`` words) and a 36 KB stage area of
    g.  64 channels up to N = 366, 32 up to 748; raises past that, naming
    the limit."""
    for chunk in (64, 32):
        smem = 4 * (2 * n * chunk + 32 * chunk) + _BWD_STAGE_BYTES
        if smem <= SMEM_LIMIT:
            return {"chunk": chunk, "chunks": -(-cdim // chunk), "smem": smem}
    raise ValueError(f"pair_relu_project backward kernel: N={n} needs {smem} B of shared "
                     f"memory even in 32-channel chunks (> SMEM_LIMIT = {SMEM_LIMIT})")


def bwd_plan_kernel(n: int) -> int:
    """The backward kernels' channels per block as their C entry computes
    it (0 where none fits); builds the library on first use."""
    fn = build.load("pair_block").pair_relu_project_bwd_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(n)


_FWD_TS = 32               # the forward's source rows a unit where they fit (kFwdTS)
_INT32_MAX = 2 ** 31 - 1


def _fwd_smem(cdim: int, h: int, bf16: bool, ts: int) -> int:
    cpad = -(-cdim // 16) * 16
    stride = cpad if cpad % 32 else cpad + 16
    hp = -(-h // 32) * 32
    w = cpad * (hp + 8) * 2 if bf16 else cpad * hp * 4
    return w + 2 * (ts + 16) * stride * 4


def fwd_plan(n: int, cdim: int, h: int, bf16: bool, b: int = 1) -> dict:
    """Launch plan of the forward kernels (K3 and K4), mirrored from
    ``csrc/pair_block.cu::fwd_ts`` / ``fwd_smem``: units of (graph, 16
    dests, ``ts`` sources) in persistent blocks of ``16 * ts`` threads; a
    block's shared memory holds W (bf16 mode in bf16 with rows padded by 8
    halves, f32 in f32; C padded to a multiple of 16, H to one of 32) and
    two stages of ``ts + 16`` rows of a and c, and does not depend on N.
    ``ts`` is 32, or 16 where 32 does not fit ``SMEM_LIMIT``.  Raises,
    naming the limit, where the output ``b * n * n * h`` or the input
    ``b * n * cdim`` passes the kernel's int32 index, or (at a C or H far
    past the models') no plan fits."""
    if b * n * n * h > _INT32_MAX or b * n * cdim > _INT32_MAX:
        raise ValueError(f"pair_relu_project forward kernel: B*N*N*H = {b * n * n * h} or "
                         f"B*N*C = {b * n * cdim} past the int32 index ({_INT32_MAX})")
    for ts in (_FWD_TS, 16):
        smem = _fwd_smem(cdim, h, bf16, ts)
        if smem <= SMEM_LIMIT:
            return {"ts": ts, "threads": 16 * ts, "smem": smem}
    raise ValueError(f"pair_relu_project forward kernel: C={cdim}, H={h} need {smem} B of "
                     f"shared memory even at 16 source rows a unit (> SMEM_LIMIT = {SMEM_LIMIT})")


def fwd_plan_kernel(n: int, cdim: int, h: int, bf16: bool, cm: bool = False,
                    device=None) -> Optional[dict]:
    """The forward's plan as its C entry computes it at one graph of ``n``
    nodes (None where no plan fits), with its resident blocks on
    ``device``'s SMs; builds the library on first use."""
    fn = build.load("pair_block").pair_relu_project_fwd_plan
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(device or 0).multi_processor_count
    out = (ctypes.c_int * 3)()
    smem = fn(n, cdim, h, int(bf16), int(cm), sms, ctypes.addressof(out))
    if smem < -1:
        raise RuntimeError(f"pair_relu_project_fwd_plan: CUDA error {-1000 - smem}")
    if smem == -1:
        return None
    return {"ts": out[0], "threads": out[1], "smem": smem, "resident": out[2]}


def _check_kernel_inputs(a, c, w, bias=None, g=None, cm: bool = False, bf16: bool = False):
    tensors = {"a": a, "c": c, "w": w}
    for name, t in (("bias", bias), ("g", g)):
        if t is not None:
            tensors[name] = t
    for name, t in tensors.items():
        if t.device != a.device or not t.is_cuda:
            raise ValueError(f"pair_relu_project kernel: {name} must be on {a.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"pair_relu_project kernel: {name} must be contiguous")
        if t.dtype != torch.float32:
            raise TypeError(f"pair_relu_project kernel: {name} must be float32")
    if a.ndim != 3 or w.ndim != 2:
        raise ValueError("pair_relu_project kernel: expected a, c [B,N,C], w [C,H]")
    b, n, cdim = a.shape
    h = w.shape[1]
    g_shape = (b, h, n * n) if cm else (b, n, n, h)
    if (tuple(c.shape) != (b, n, cdim) or tuple(w.shape) != (cdim, h)
            or (bias is not None and tuple(bias.shape) != (h,))
            or (g is not None and tuple(g.shape) != g_shape)):
        raise ValueError("pair_relu_project kernel: inconsistent shapes "
                         f"a{tuple(a.shape)} c{tuple(c.shape)} w{tuple(w.shape)} "
                         f"g{None if g is None else tuple(g.shape)}")
    if g is not None:
        if h > _CHAN_TILE:
            raise ValueError(f"pair_relu_project backward kernel: needs H <= "
                             f"{_CHAN_TILE} (H={h})")
        bwd_plan(n, cdim)
        return
    fwd_plan(n, cdim, h, bf16, b)


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _launch(a, c, w, bias, bf16: bool) -> torch.Tensor:
    _check_kernel_inputs(a, c, w, bias, bf16=bf16)
    b, n, cdim = a.shape
    h = w.shape[1]
    out = torch.empty((b, n, n, h), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    fn = build.load("pair_block").pair_relu_project_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(a.data_ptr(), c.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, n, cdim, h, int(bf16), _sms(a), stream(a))
    build.check_launch(rc, "pair_relu_project_fwd")
    pair_relu_project.launches += 1
    report_flops(flops(b, n, cdim, h))
    return out


def _launch_bwd(a, c, w, g, bf16: bool):
    _check_kernel_inputs(a, c, w, g=g)
    b, n, cdim = a.shape
    h = w.shape[1]
    da = torch.empty_like(a)
    dc = torch.empty_like(a)
    dw = torch.empty((cdim, h), dtype=torch.float32, device=a.device)
    db = torch.empty((h,), dtype=torch.float32, device=a.device)
    if a.numel() == 0:
        return da, dc, dw.zero_(), db.zero_()
    dw_part = torch.empty((b, cdim, h), dtype=torch.float32, device=a.device)
    db_part = torch.empty((b, h), dtype=torch.float32, device=a.device)
    fn = build.load("pair_block").pair_relu_project_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(a.data_ptr(), c.data_ptr(), w.data_ptr(), g.data_ptr(), da.data_ptr(),
            dc.data_ptr(), dw.data_ptr(), db.data_ptr(), dw_part.data_ptr(),
            db_part.data_ptr(), b, n, cdim, h, int(bf16), stream(a))
    build.check_launch(rc, "pair_relu_project_bwd")
    pair_relu_project_bwd.launches += 1
    report_flops(flops(b, n, cdim, h, bwd=True))
    return da, dc, dw, db


def _launch_cm(a, c, w, bf16: bool) -> torch.Tensor:
    _check_kernel_inputs(a, c, w, cm=True, bf16=bf16)
    b, n, cdim = a.shape
    h = w.shape[1]
    out = torch.empty((b, h, n * n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    fn = build.load("pair_block").pair_relu_project_cm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(a.data_ptr(), c.data_ptr(), w.data_ptr(), out.data_ptr(), b, n, cdim, h,
            int(bf16), _sms(a), stream(a))
    build.check_launch(rc, "pair_relu_project_cm_fwd")
    pair_relu_project_cm.launches += 1
    report_flops(flops(b, n, cdim, h))
    return out


def _launch_cm_bwd(a, c, w, g, bf16: bool):
    _check_kernel_inputs(a, c, w, g=g, cm=True)
    b, n, cdim = a.shape
    h = w.shape[1]
    da = torch.empty_like(a)
    dc = torch.empty_like(a)
    dw = torch.empty((cdim, h), dtype=torch.float32, device=a.device)
    if a.numel() == 0:
        return da, dc, dw.zero_()
    dw_part = torch.empty((b, cdim, h), dtype=torch.float32, device=a.device)
    fn = build.load("pair_block").pair_relu_project_cm_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(a.data_ptr(), c.data_ptr(), w.data_ptr(), g.data_ptr(), da.data_ptr(),
            dc.data_ptr(), dw.data_ptr(), dw_part.data_ptr(), b, n, cdim, h, int(bf16),
            stream(a))
    build.check_launch(rc, "pair_relu_project_cm_bwd")
    pair_relu_project_cm_bwd.launches += 1
    report_flops(flops(b, n, cdim, h, bwd=True))
    return da, dc, dw


def pair_relu_project_cm_bwd(a, c, w, g, *, bf16: bool = False, impl: str = "auto"):
    """Backward of :func:`pair_relu_project_cm` for the cotangent ``g``
    [B, H, N*N]: returns (da, dc, dw), f32.  ``impl`` as in
    :func:`pair_relu_project`."""
    if resolve_impl(impl, a, "pair_relu_project_cm") == "plain":
        return pair_relu_project_cm_bwd_plain(a, c, w, g, bf16=bf16)
    return _launch_cm_bwd(a, c, w, g, bf16)


class _PairReluProjectCm(torch.autograd.Function):
    """The channel-major kernel pair (or the plain pair) under autograd."""

    @staticmethod
    def forward(ctx, a, c, w, bf16, impl):
        ctx.save_for_backward(a, c, w)
        ctx.bf16, ctx.impl = bf16, impl
        if impl == "plain":
            return pair_relu_project_cm_plain(a, c, w, bf16=bf16)
        return _launch_cm(a, c, w, bf16)

    @staticmethod
    def backward(ctx, g):
        a, c, w = ctx.saved_tensors
        da, dc, dw = pair_relu_project_cm_bwd(a, c, w, g.contiguous(), bf16=ctx.bf16,
                                              impl=ctx.impl)
        return da, dc, dw, None, None


def pair_relu_project_cm(a, c, w, bias: Optional[torch.Tensor] = None, *,
                         bf16: bool = False, impl: str = "auto") -> torch.Tensor:
    """``out[b, h, s*N + d] = relu(a[b, s, :] + c[b, d, :]) @ w[:, h] + bias[h]``
    -> [B, H, N*N] float32, the channel-major layout the score pipeline
    consumes; differentiable in a, c, w and bias.  The kernel (K4) has no
    bias: it is added here, so autograd gives its gradient.  a and c stay
    [B, N, C] (the TPU wrapper transposes them only for its lanes)."""
    out = _PairReluProjectCm.apply(a, c, w, bf16,
                                   resolve_impl(impl, a, "pair_relu_project_cm"))
    return out if bias is None else out + bias.float()[None, :, None]


def pair_relu_project_bwd(a, c, w, g, *, bf16: bool = False, impl: str = "auto"):
    """Backward of :func:`pair_relu_project` for the output cotangent ``g``
    [B, N, N, H]: returns (da, dc, dw, db), f32.  ``impl`` as in
    :func:`pair_relu_project`."""
    if resolve_impl(impl, a, "pair_relu_project") == "plain":
        return pair_relu_project_bwd_plain(a, c, w, g, bf16=bf16)
    return _launch_bwd(a, c, w, g, bf16)


class _PairReluProject(torch.autograd.Function):
    """The kernel pair (or the plain pair) under autograd."""

    @staticmethod
    def forward(ctx, a, c, w, bias, bf16, impl):
        ctx.save_for_backward(a, c, w)
        ctx.bf16, ctx.impl = bf16, impl
        if impl == "plain":
            return pair_relu_project_plain(a, c, w, bias, bf16=bf16)
        return _launch(a, c, w, bias, bf16)

    @staticmethod
    def backward(ctx, g):
        a, c, w = ctx.saved_tensors
        da, dc, dw, db = pair_relu_project_bwd(a, c, w, g.contiguous(),
                                               bf16=ctx.bf16, impl=ctx.impl)
        return da, dc, dw, db, None, None


def pair_relu_project(a, c, w, bias: Optional[torch.Tensor] = None, *,
                      bf16: bool = False, impl: str = "auto") -> torch.Tensor:
    """``out[b, s, d, :] = relu(a[b, s, :] + c[b, d, :]) @ w + bias`` ->
    [B, N, N, H] float32, bias fused; differentiable in a, c, w and bias.
    ``impl``: "auto" (the kernels for a CUDA tensor, the plain versions for
    a CPU tensor), "kernel" or "plain"."""
    if bias is None:
        bias = torch.zeros(w.shape[-1], dtype=torch.float32, device=a.device)
    return _PairReluProject.apply(a, c, w, bias, bf16,
                                   resolve_impl(impl, a, "pair_relu_project"))


pair_relu_project.launches = 0
pair_relu_project_bwd.launches = 0
pair_relu_project_cm.launches = 0
pair_relu_project_cm_bwd.launches = 0
