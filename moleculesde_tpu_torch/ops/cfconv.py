"""Fused SchNet CFConv: filter MLP + cutoff envelope + neighbour aggregation
without writing the ``[B, N, N, F]`` filter tensors to device memory.

    out[b, i, f] = sum_j env[b, i, j]
                   * ((softplus(ea[b, i, j] @ W1 + b1) - log 2) @ W2 + b2)[f]
                   * x[b, j, f]

Counterpart of ``moleculesde_tpu/ops/cfconv.py::fused_cfconv``, forward
and backward.  On a CUDA tensor the wrappers launch the hand-written
kernels of ``csrc/cfconv.cu``, which replace the TPU kernels
``_fwd_kernel`` (``pallas_call`` at ``ops/cfconv.py:212``) and
``_bwd_kernel`` (l.228).  Both recompute the filter instead of reading
it, on the tensor cores in bf16 mode, in persistent blocks that stage the
weights once: the forward over (graph, row tile) units, each summing its
output rows over all columns j in chunks and skipping tiles with no pair
inside the cutoff (plan: :func:`fwd_plan`); the backward over (graph,
column tile) units (plan: :func:`bwd_plan`).  The source's header says
more.  Neither puts a cap on N.  On a CPU tensor they take
:func:`fused_cfconv_plain` and :func:`fused_cfconv_bwd_plain`, which round
to bf16 where the TPU kernel rounds.

K5, :func:`fused_cfconv_rbf`, is the same convolution from the raw
distances ``dist`` [B, N, N]: counterpart of ``fused_cfconv_rbf``
(``ops/cfconv.py:337``, the ``smear=`` form of both ``pallas_call``s),
whose kernels build the Gaussian smearing in shared memory as the TPU
kernel's ``_smear`` does (l.66-89), so the ``[B, N, N, G]`` slab never
reaches device memory.  Its plain versions smear with :func:`smear` and
then run K2's.

GRADIENT CONTRACT, as in the JAX package: ``ea`` (``dist``) and ``env`` get
no gradient.  The kernels serve paths where positions carry none
(pretraining); the wrappers raise if either needs one, so a force path
(F = -dE/dpos) can never get zero forces without notice.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT, resolve_impl, round_bf16, stream
from moleculesde_tpu_torch.utils.flops import report_flops

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


def flops(b: int, n: int, gdim: int, f: int, bwd: bool = False) -> int:
    """Matrix-product FLOPs of the plain version (K2's and K5's, what
    ``matmul_flops`` counts there), which the kernels report: the filter
    net's ``ea @ W1`` [B*N*N, G] x [G, F] and ``s @ W2`` [B*N*N, F] x [F, F]
    over every pair; the backward recomputes both and adds ``dW2``, ``dwf @
    W2^T`` and ``dW1``."""
    pairs = b * n * n
    return 2 * pairs * f * ((2 * gdim + 3 * f) if bwd else (gdim + f))


def smear_constants(start: float, stop: float, num_gaussians: int):
    """(start, step, coeff) of the in-kernel smearing, each rounded to f32
    as the JAX package's weak-typed Python constants are."""
    step = (stop - start) / (num_gaussians - 1)
    return tuple(float(np.float32(v)) for v in (start, step, -0.5 / float(step) ** 2))


def smear(dist, start: float, stop: float, num_gaussians: int, *, bf16: bool = False):
    """The Gaussian smearing as K5 builds it (the TPU kernel's ``_smear``):
    ``dist`` [B, N, N] -> ea [B, N, N, G] f32, rounded to bf16 in bf16 mode.
    Offsets ``float(g) * step + start`` from an iota and ``exp((coeff *
    diff) * diff)``, all in f32; :func:`~moleculesde_tpu_torch.ops.fourier.
    gaussian_smearing` takes ``linspace``'s grid and ``coeff * diff**2``."""
    start32, step32, coeff32 = smear_constants(start, stop, num_gaussians)
    offset = (torch.arange(num_gaussians, device=dist.device, dtype=torch.float32)
              * step32 + start32)
    diff = dist.float()[..., None] - offset
    return round_bf16(torch.exp((coeff32 * diff) * diff), bf16)


def fused_cfconv_rbf_plain(dist, env, x, w1, b1, w2, b2, *, start: float, stop: float,
                           num_gaussians: int, bf16: bool = False):
    """Plain PyTorch version of K5's forward: :func:`fused_cfconv_plain` on
    :func:`smear` of ``dist``."""
    ea = smear(dist, start, stop, num_gaussians, bf16=bf16)
    return fused_cfconv_plain(ea, env, x, w1, b1, w2, b2, bf16=bf16)


def fused_cfconv_rbf_bwd_plain(dist, env, x, w1, b1, w2, b2, g, *, start: float,
                               stop: float, num_gaussians: int, bf16: bool = False):
    """Plain PyTorch version of K5's backward: :func:`fused_cfconv_bwd_plain`
    on :func:`smear` of ``dist``."""
    ea = smear(dist, start, stop, num_gaussians, bf16=bf16)
    return fused_cfconv_bwd_plain(ea, env, x, w1, b1, w2, b2, g, bf16=bf16)


def _check_kernel_inputs(ea, env, x, w1, b1, w2, b2, g=None, rbf: bool = False):
    """Device, type, contiguity and shapes; ``ea`` is ``dist`` [B, N, N] for
    K5 (``rbf``).  Returns (B, N, G, F)."""
    first = "dist" if rbf else "ea"
    tensors = {first: ea, "env": env, "x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    if g is not None:
        tensors["g"] = g
    # the kernels copy ea / dist, x and g in 16-byte pieces and env in 4-byte
    # ones; they read the weights and biases element by element
    align = {first: 16, "x": 16, "g": 16, "env": 4}
    for name, t in tensors.items():
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"fused_cfconv kernel: {name} must be on {x.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"fused_cfconv kernel: {name} must be contiguous")
        if t.data_ptr() % align.get(name, 1):
            raise ValueError(f"fused_cfconv kernel: {name} must be {align[name]}-byte "
                             f"aligned (address {t.data_ptr():#x})")
        if t.dtype != torch.float32 and not (name == "ea" and t.dtype == torch.bfloat16):
            raise TypeError(f"fused_cfconv kernel: {name} must be float32"
                            + (" or bfloat16" if name == "ea" else ""))
    if ea.ndim != (3 if rbf else 4) or x.ndim != 3:
        raise ValueError(f"fused_cfconv kernel: expected {first} "
                         f"{'[B,N,N]' if rbf else '[B,N,N,G]'}, x [B,N,F]")
    b, n = ea.shape[:2]
    gdim = w1.shape[0] if rbf else ea.shape[3]
    f = x.shape[2]
    if (tuple(ea.shape[:3]) != (b, n, n) or tuple(env.shape) != (b, n, n)
            or tuple(x.shape) != (b, n, f)
            or tuple(w1.shape) != (gdim, f) or tuple(b1.shape) != (f,)
            or tuple(w2.shape) != (f, f) or tuple(b2.shape) != (f,)
            or (g is not None and tuple(g.shape) != (b, n, f))):
        raise ValueError("fused_cfconv kernel: inconsistent shapes "
                         f"{first}{tuple(ea.shape)} env{tuple(env.shape)} x{tuple(x.shape)} "
                         f"w1{tuple(w1.shape)} w2{tuple(w2.shape)}")
    if f % 4 or f > 1024:
        raise ValueError(f"fused_cfconv kernel: needs F % 4 == 0 and F <= 1024 (F={f})")
    return b, n, gdim, f


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _copy_row_words(cols: int, pair_bytes: int, piece: int) -> int:
    """4-byte words of a row of the ea copy in pieces of ``piece`` bytes (the
    backward 4, the forward 16): the pieces from the one that holds the
    row's first byte, and one more."""
    return ((cols * pair_bytes + piece - 1) // piece + 1) * (piece // 4)


def bwd_plan(n: int, gdim: int, f: int, bf16: bool, pair_bytes: int) -> dict:
    """The backward kernel's tiling (``csrc/cfconv.cu::bwd_plan``, which the
    C query ``cfconv_bwd_plan`` returns) for ``pair_bytes`` bytes of ea
    source per pair (2 G or 4 G: K2's bf16 or f32 ea; 4: K5's distance): F
    padded to ``fp`` (64, 128 or 256), ``m`` = 128 / (fp / 64) pair rows
    per tile, ``ic`` rows i per chunk (the power of two >= max(N, 16), at
    most ``m``), ``j`` = m / ic columns per work unit, ``chunks`` row chunks
    per unit, ``tiles`` units per graph (B * tiles in all), G padded to
    ``g16``, and the shared memory in bytes (``smem``).  None where F >
    256."""
    if f > 256:
        return None
    fp = 64 if f <= 64 else 128 if f <= 128 else 256
    m = 128 // (fp // 64)
    ic = 16
    while ic < n and ic < m:
        ic *= 2
    j = m // ic
    g16 = -(-gdim // 16) * 16
    esz, pad = (2, 8) if bf16 else (4, 4)
    gs, fs = g16 + pad, fp + pad
    copy_words = _copy_row_words(j, pair_bytes, 4)     # a row of the ea copy
    staged_gx = (ic, j) if fp <= 128 and bf16 else ()   # g and x rows, f32
    smem = sum(_align16(v) for v in (
        g16 * fs * esz, fp * fs * esz, m * gs * esz, m * fs * esz, m * fs * esz,
        m * 4, fp * 4, fp * 4, (m // 16) * fp * 4, j * fp * 4, ic * copy_words * 4,
        *(rows * (fp + 8) * 4 for rows in staged_gx)))
    return dict(fp=fp, m=m, ic=ic, j=j, chunks=-(-n // ic), tiles=-(-n // j), g16=g16,
                smem=smem)


def bwd_plan_kernel(n: int, gdim: int, f: int, bf16: bool, pair_bytes: int) -> dict:
    """:func:`bwd_plan` as the CUDA source computes it (``cfconv_bwd_plan``),
    for the card-side check that the two agree.  Builds the library."""
    fn = build.load("cfconv").cfconv_bwd_plan
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = (ctypes.c_int * 7)()
    smem = int(fn(n, gdim, f, int(bf16), pair_bytes, ctypes.addressof(out)))
    if smem < 0:
        return None
    return dict(zip(("fp", "m", "ic", "j", "chunks", "tiles", "g16"), out), smem=smem)


def fwd_plan(n: int, gdim: int, f: int, bf16: bool, pair_bytes: int) -> dict:
    """The forward kernel's tiling (``csrc/cfconv.cu::fwd_plan``, which the
    C query ``cfconv_fwd_plan`` returns), ``pair_bytes`` as in
    :func:`bwd_plan`: F padded to ``fp`` (64, 128 or 256), ``m`` = 128 /
    (fp / 64) pair rows per tile, ``c`` columns j per chunk (16 where N <=
    16, else 32), ``r`` = m / c rows i per work unit, ``chunks`` column
    chunks per unit, ``tiles`` units (row tiles) per graph (B * tiles in
    all), G padded to ``g16``, ``gk`` entries of G staged at a time,
    ``w_res`` (W1 and W2 in shared memory), ``copy`` (each tile's ea source
    copied one tile ahead, ea staged whole) and the shared memory in bytes
    (``smem``): the first of four plans that fits ``SMEM_LIMIT`` -- weights
    resident with the copy (the main path), resident with ea in chunks of
    64, in device memory with the copy, in device memory with chunks (which
    fits at every G and F <= 256).  None where F > 256.

    Schedule: persistent blocks take units k, k + grid, ..., numbered row
    tile major (u = row tile * B + b), so every block walks row tiles spread
    over the rows of many graphs; the tiles a block skips (env zero on every
    pair: rows past a graph's atoms) are spread over the blocks alike, and
    no block is left with a run of full tiles."""
    if f > 256:
        return None
    fp = 64 if f <= 64 else 128 if f <= 128 else 256
    m = 128 // (fp // 64)
    c = 16 if n <= 16 else 32
    r = m // c
    g16 = -(-gdim // 16) * 16
    esz, pad = (2, 8) if bf16 else (4, 4)
    for w_res, copy in ((True, True), (True, False), (False, True), (False, False)):
        gk = g16 if copy or g16 < 64 else 64
        weights = (g16 * (fp + pad) * esz, fp * (fp + pad) * esz) if w_res else ()
        copy_bytes = (r * _copy_row_words(c, pair_bytes, 16) * 4,) if copy else ()
        smem = sum(_align16(v) for v in (
            *weights, m * (gk + pad) * esz, m * (fp + pad) * esz, c * (fp + 8) * 4, m * 4,
            fp * 4, fp * 4, (m // 16) * fp * 4, r * fp * 4, *copy_bytes))
        if smem <= SMEM_LIMIT:
            break
    return dict(fp=fp, m=m, c=c, r=r, chunks=-(-n // c), tiles=-(-n // r), g16=g16, gk=gk,
                w_res=w_res, copy=copy, smem=smem)


def fwd_plan_kernel(n: int, gdim: int, f: int, bf16: bool, pair_bytes: int) -> dict:
    """:func:`fwd_plan` as the CUDA source computes it (``cfconv_fwd_plan``),
    for the card-side check that the two agree.  Builds the library."""
    fn = build.load("cfconv").cfconv_fwd_plan
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = (ctypes.c_int * 10)()
    smem = int(fn(n, gdim, f, int(bf16), pair_bytes, ctypes.addressof(out)))
    if smem < 0:
        return None
    plan = dict(zip(("fp", "m", "c", "r", "chunks", "tiles", "g16", "gk", "w_res", "copy"),
                    out), smem=smem)
    plan["w_res"], plan["copy"] = bool(plan["w_res"]), bool(plan["copy"])
    return plan


def _launch(ea, env, x, w1, b1, w2, b2, bf16: bool, smear_args=None) -> torch.Tensor:
    """K2's forward, or K5's with ``smear_args`` = (start, stop, G) and
    ``ea`` the distances."""
    b, n, gdim, f = _check_kernel_inputs(ea, env, x, w1, b1, w2, b2,
                                         rbf=smear_args is not None)
    pair_bytes = 4 if smear_args is not None else gdim * ea.element_size()
    if fwd_plan(n, gdim, f, bf16, pair_bytes) is None:
        raise ValueError(f"fused_cfconv forward kernel: F={f} > 256 cannot be staged in "
                         f"{SMEM_LIMIT} B of shared memory (G={gdim})")
    out = torch.empty((b, n, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    ptrs = (ea.data_ptr(), env.data_ptr(), x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = build.load("cfconv")
    if smear_args is None:
        fn = lib.cfconv_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        tail = (int(ea.dtype == torch.bfloat16), int(bf16), sms, stream(x))
    else:
        fn = lib.cfconv_rbf_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        tail = (*smear_constants(*smear_args), int(bf16), sms, stream(x))
    fn.restype = ctypes.c_int
    rc = fn(*ptrs, b, n, gdim, f, *tail)
    build.check_launch(rc, fn.__name__)
    if smear_args is None:
        fused_cfconv.launches += 1
    else:
        fused_cfconv_rbf.launches += 1
    report_flops(flops(b, n, gdim, f))
    return out


def _launch_bwd(ea, env, x, w1, b1, w2, b2, g, bf16: bool, smear_args=None):
    """K2's backward, or K5's (``smear_args`` as in :func:`_launch`)."""
    b, n, gdim, f = _check_kernel_inputs(ea, env, x, w1, b1, w2, b2, g,
                                         rbf=smear_args is not None)
    pair_bytes = 4 if smear_args is not None else gdim * ea.element_size()
    plan = bwd_plan(n, gdim, f, bf16, pair_bytes)
    if plan is None or plan["smem"] > SMEM_LIMIT:
        raise ValueError(f"fused_cfconv backward kernel: the weights of G={gdim}, F={f} "
                         f"({'bf16' if bf16 else 'f32'} mode) cannot be staged in "
                         f"{SMEM_LIMIT} B of shared memory"
                         + (" (F > 256)" if plan is None else f" (plan {plan['smem']} B)"))
    dev = x.device
    dx = torch.empty((b, n, f), dtype=torch.float32, device=dev)
    dw1 = torch.empty((gdim, f), dtype=torch.float32, device=dev)
    db1 = torch.empty((f,), dtype=torch.float32, device=dev)
    dw2 = torch.empty((f, f), dtype=torch.float32, device=dev)
    db2 = torch.empty((f,), dtype=torch.float32, device=dev)
    if dx.numel() == 0:
        return dx, dw1.zero_(), db1.zero_(), dw2.zero_(), db2.zero_()
    # persistent blocks: one per SM, at most one per unit
    blocks = min(torch.cuda.get_device_properties(dev).multi_processor_count,
                 b * plan["tiles"])
    part = torch.empty((blocks * (gdim * f + f * f + 2 * f),), dtype=torch.float32,
                       device=dev)
    ptrs = (ea.data_ptr(), env.data_ptr(), x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), part.data_ptr())
    lib = build.load("cfconv")
    if smear_args is None:
        fn = lib.cfconv_bwd
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        tail = (int(ea.dtype == torch.bfloat16), int(bf16), blocks, stream(x))
    else:
        fn = lib.cfconv_rbf_bwd
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        tail = (*smear_constants(*smear_args), int(bf16), blocks, stream(x))
    fn.restype = ctypes.c_int
    rc = fn(*ptrs, b, n, gdim, f, *tail)
    build.check_launch(rc, fn.__name__)
    if smear_args is None:
        fused_cfconv_bwd.launches += 1
    else:
        fused_cfconv_rbf_bwd.launches += 1
    report_flops(flops(b, n, gdim, f, bwd=True))
    return dx, dw1, db1, dw2, db2


def fused_cfconv_bwd(ea, env, x, w1, b1, w2, b2, g, *, bf16: bool = False,
                     impl: str = "auto"):
    """Backward of :func:`fused_cfconv` for the output cotangent ``g``
    [B, N, F]: returns (dx, dw1, db1, dw2, db2), f32.  ``impl`` as in
    :func:`fused_cfconv`."""
    if resolve_impl(impl, x, "fused_cfconv") == "plain":
        return fused_cfconv_bwd_plain(ea, env, x, w1, b1, w2, b2, g, bf16=bf16)
    return _launch_bwd(ea, env, x, w1, b1, w2, b2, g, bf16)


def fused_cfconv_rbf_bwd(dist, env, x, w1, b1, w2, b2, g, *, start: float, stop: float,
                         num_gaussians: int, bf16: bool = False, impl: str = "auto"):
    """Backward of :func:`fused_cfconv_rbf` for the output cotangent ``g``
    [B, N, F]: returns (dx, dw1, db1, dw2, db2), f32."""
    if resolve_impl(impl, x, "fused_cfconv_rbf") == "plain":
        return fused_cfconv_rbf_bwd_plain(dist, env, x, w1, b1, w2, b2, g, start=start,
                                          stop=stop, num_gaussians=num_gaussians, bf16=bf16)
    return _launch_bwd(dist, env, x, w1, b1, w2, b2, g, bf16, (start, stop, num_gaussians))


class _FusedCFConv(torch.autograd.Function):
    """A kernel pair (or its plain pair) under autograd: K2, or K5 when
    ``smear_args`` = (start, stop, G) and ``ea`` holds the distances; no
    gradient for ``ea`` or ``env`` (the wrappers refuse them if they need
    one)."""

    @staticmethod
    def forward(ctx, ea, env, x, w1, b1, w2, b2, bf16, impl, smear_args):
        ctx.save_for_backward(ea, env, x, w1, b1, w2, b2)
        ctx.bf16, ctx.impl, ctx.smear_args = bf16, impl, smear_args
        if impl == "kernel":
            return _launch(ea, env, x, w1, b1, w2, b2, bf16, smear_args)
        if smear_args is not None:
            ea = smear(ea, *smear_args, bf16=bf16)
        return fused_cfconv_plain(ea, env, x, w1, b1, w2, b2, bf16=bf16)

    @staticmethod
    def backward(ctx, g):
        ea, env, x, w1, b1, w2, b2 = ctx.saved_tensors
        g = g.contiguous()
        if ctx.impl == "kernel":
            grads = _launch_bwd(ea, env, x, w1, b1, w2, b2, g, ctx.bf16, ctx.smear_args)
        else:
            if ctx.smear_args is not None:
                ea = smear(ea, *ctx.smear_args, bf16=ctx.bf16)
            grads = fused_cfconv_bwd_plain(ea, env, x, w1, b1, w2, b2, g, bf16=ctx.bf16)
        return (None, None, *grads, None, None, None)


def _refuse_geometry_grads(ea, env, first: str) -> None:
    if torch.is_grad_enabled() and (ea.requires_grad or env.requires_grad):
        raise RuntimeError(f"fused_cfconv gives no gradient to {first} or env (the "
                           "TPU kernel's contract): positions must not require "
                           "grad through it")


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
    _refuse_geometry_grads(ea, env, "ea")
    return _FusedCFConv.apply(ea, env, x, w1, b1, w2, b2, bf16,
                               resolve_impl(impl, x, "fused_cfconv"), None)


def fused_cfconv_rbf(dist, env, x, w1, b1, w2, b2, *, start: float, stop: float,
                     num_gaussians: int, bf16: bool = False,
                     impl: str = "auto") -> torch.Tensor:
    """K5: :func:`fused_cfconv` on the Gaussian smearing of ``dist``
    [B, N, N] f32 over ``num_gaussians`` centres from ``start`` to ``stop``,
    built inside the kernels (:func:`smear` gives the same values).  Same
    arguments, ``impl`` and gradient contract as :func:`fused_cfconv`; raises
    if ``dist`` or ``env`` requires a gradient."""
    _refuse_geometry_grads(dist, env, "dist")
    if w1.shape[0] != num_gaussians:
        raise ValueError(f"fused_cfconv_rbf: w1 has {w1.shape[0]} rows for "
                         f"{num_gaussians} Gaussians")
    return _FusedCFConv.apply(dist, env, x, w1, b1, w2, b2, bf16,
                               resolve_impl(impl, x, "fused_cfconv_rbf"),
                               (float(start), float(stop), int(num_gaussians)))


fused_cfconv.launches = 0
fused_cfconv_bwd.launches = 0
fused_cfconv_rbf.launches = 0
fused_cfconv_rbf_bwd.launches = 0
