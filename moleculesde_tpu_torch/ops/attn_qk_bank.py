"""Fused per-channel q/k nets and head-mean tanh attention maps of the 3D->2D
edge layers (K8):

    q_c = tanh(qk @ Wq1[c] + bq1[c]) @ Wq2[c] + bq2[c]            # [B, N, A]
    k_c = tanh(qk @ Wk1[c] + bk1[c]) @ Wk2[c] + bk2[c]
    a[b, c, n, m] = (1/H) sum_h tanh( (q_c,h[n] . k_c,h[m]) / sqrt(ds) )

Counterpart of ``moleculesde_tpu/ops/rejected/attn_qk_bank.py::attn_qk_bank``
(its Pallas impls), forward and backward.  On a CUDA tensor the wrappers
launch the hand-written kernels of ``csrc/attn_qk_bank.cu``, which replace
the TPU kernels ``_fwd_kernel`` (``pallas_call`` at
``ops/rejected/attn_qk_bank.py:209``) and ``_bwd_kernel`` (l.232): one
block per (graph, channel) wherever its plan fits (:func:`fwd_plan`,
:func:`bwd_plan`; the backward walks the map in tiles of rows and qk in
chunks of features), where only the node features, the weights, ``a`` and,
in the backward, per-(graph, channel) partial sums touch device memory;
past that (N > 334 forward, N > 266 backward at A = 32), the tiled plan
(:func:`tiled_plan`): the nets' outputs written once to device memory,
then (graph, channel, row tile) units over them, for any N (the source's
header says more).  On a CPU tensor they take
:func:`attn_qk_bank_plain` and :func:`attn_qk_bank_bwd_plain`, which round
to bf16 where the TPU kernel rounds: qk cast by the wrapper, each weight as
it enters its product, t1 only as the second product's operand, q and k
before the logits; biases and tanh stay f32.

GRADIENT CONTRACT, as the TPU kernel's custom VJP: the node features get
``dqk`` in their (compute) dtype, all eight weights f32 gradients.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.ops.attn_bank import (
    attn_map_bank_plain, du_words, map_bank_bwd_f32, row_stride, tile_rows)
from moleculesde_tpu_torch.ops.attn_bank import flops as attn_bank_flops
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT, resolve_impl, round_bf16, stream
from moleculesde_tpu_torch.utils.flops import report_flops

WEIGHTS = ("wq1", "bq1", "wq2", "bq2", "wk1", "bk1", "wk2", "bk2")


def _net(x, w1, b1, w2, b2, bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t1, out) [B, C, N, A] f32 of one q or k net on every channel."""
    pre = torch.einsum("bnf,cfa->bcna", x, round_bf16(w1, bf16)) + b1.float()[None, :, None]
    t1 = torch.tanh(pre)
    out = (torch.einsum("bcna,cao->bcno", round_bf16(t1, bf16), round_bf16(w2, bf16))
           + b2.float()[None, :, None])
    return t1, out


def attn_qk_bank_plain(qk, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, ds: int, *,
                       bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: [B, C, N, N] float32."""
    x = round_bf16(qk, bf16)
    _, q = _net(x, wq1, bq1, wq2, bq2, bf16)
    _, k = _net(x, wk1, bk1, wk2, bk2, bf16)
    return attn_map_bank_plain(round_bf16(q, bf16), round_bf16(k, bf16), ds)


def attn_qk_bank_bwd_plain(qk, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, g, ds: int, *,
                           bf16: bool = False):
    """Plain PyTorch version of the backward kernel for the cotangent ``g``
    [B, C, N, N]: (dqk in qk's dtype, then the eight weight gradients in f32,
    in the order of :data:`WEIGHTS`).  The bias gradients sum the unrounded
    f32 ``dout`` and ``dpre``; dqk adds each channel's q then k term in f32
    and is cast once at the end, as the TPU kernel does."""
    x = round_bf16(qk, bf16)
    nets = ((wq1, bq1, wq2, bq2), (wk1, bk1, wk2, bk2))
    t1s, outs = zip(*(_net(x, *w, bf16) for w in nets))
    d3s = map_bank_bwd_f32(round_bf16(outs[0], bf16), round_bf16(outs[1], bf16), g, ds, bf16)
    grads, terms = [], []
    for (w1, _, w2, _), t1, dout in zip(nets, t1s, d3s):
        doutl = round_bf16(dout, bf16)
        dw2 = torch.einsum("bcnj,bcno->cjo", round_bf16(t1, bf16), doutl)
        dpre = torch.einsum("bcno,cjo->bcnj", doutl, round_bf16(w2, bf16)) * (1.0 - t1 * t1)
        dprel = round_bf16(dpre, bf16)
        dw1 = torch.einsum("bnf,bcnj->cfj", x, dprel)
        grads += [dw1, dpre.sum(dim=(0, 2)), dw2, dout.sum(dim=(0, 2))]
        terms.append(torch.einsum("bcnj,cfj->bcnf", dprel, round_bf16(w1, bf16)))
    dqk = torch.zeros_like(x)
    for c in range(g.shape[1]):
        dqk = dqk + terms[0][:, c]
        dqk = dqk + terms[1][:, c]
    return (dqk.to(qk.dtype), *grads)


def flops(b: int, n: int, f: int, c: int, a: int, bwd: bool = False) -> int:
    """Matrix-product FLOPs of the plain version (what ``matmul_flops``
    counts there), which the kernels report: per channel the q and k nets
    ([B*N, F] x [F, A] and [B*N, A] x [A, A] each) and the maps' logits
    (:func:`~moleculesde_tpu_torch.ops.attn_bank.flops`); the backward
    recomputes all of them, runs the maps' backward and, per net, ``dW2``,
    ``dout W2^T``, ``dW1`` and ``dpre W1^T``."""
    nets = 4 * b * n * c * a * (f + a)
    return 3 * nets + attn_bank_flops(b, c, n, a, True) if bwd else (
        nets + attn_bank_flops(b, c, n, a))


def _shapes(qk, ws):
    b, n, f = qk.shape
    c, _, a = ws[0].shape
    return b, n, f, c, a


FWD_MAX_CHUNK = 128         # csrc/attn_qk_bank.cu: W1 / qk features staged at once
BWD_MAX_CHUNK = 64          # the same in the backward
BWD_DU_WORDS = 16384        # the backward's du of a row tile (csrc kBwdDuBudget)


def _fwd_stride(width: int) -> int:
    """Row stride of the forward's staged rows (csrc/attn_qk_bank.cu::
    fwd_stride): 16-byte aligned, 4 words past a multiple of 32."""
    return -(-width // 4) * 4 + 4


def fwd_plan(n: int, f: int, a: int) -> Tuple[int, int]:
    """The forward kernel's plan for one (graph, channel) block: (features
    staged per chunk, shared-memory bytes).  Rows are paired (n, n + ceil(N
    / 2)), so 2 ceil(N / 2) rows are staged: a qk chunk [rows, FC], the
    chunk's W1 rows and W2 of both nets, the biases, the nets' t1 and q / k
    [rows, A] each, every region 16-byte aligned (csrc/attn_qk_bank.cu)."""
    fc = min(f, FWD_MAX_CHUNK)
    rows = 2 * -(-n // 2)
    fp, as_ = _fwd_stride(fc), _fwd_stride(a)

    def al4(v):
        return -(-v // 4) * 4

    return fc, 4 * (rows * fp + al4(2 * fc * a) + al4(2 * a * a) + al4(4 * a) + 4 * rows * as_)


def bwd_plan(n: int, f: int, a: int, h: int) -> Tuple[int, int, int]:
    """The backward kernel's plan for one (graph, channel) block: (rows of
    the map's tile, features staged per chunk, shared-memory bytes).  The
    block holds W2 and the biases of both nets, t1, q / k (later dpre) and
    dq / dk [N, A] each (rows padded to A + 1 words, q / k's to
    :func:`row_stride` from a 16-byte boundary, dq / dk's not), and a
    scratch region that holds a qk chunk [N, FC] with the chunk's W1 rows
    while the nets run and the du tile between (csrc/attn_qk_bank.cu::
    bwd_layout).  R starts at :func:`tile_rows` of :data:`BWD_DU_WORDS`, FC
    at min(F, 64); the larger of the two scratch uses is halved (R last)
    until the block fits, and the bytes are past the limit where nothing
    does."""
    ap = a + 1
    qo = -(-(2 * a * ap + 4 * a + 2 * n * ap) // 4) * 4    # 16-byte aligned
    fixed = qo + 2 * n * row_stride(a) + 2 * n * a
    rows, fc = tile_rows(n, h, BWD_DU_WORDS), min(f, BWD_MAX_CHUNK)
    while True:
        chunk, du = n * fc + 2 * fc * ap, du_words(n, rows, h)
        smem = 4 * (fixed + max(chunk, du))
        if smem <= SMEM_LIMIT or (rows == 1 and fc == 1):
            return rows, fc, smem
        if fc > 1 and (chunk >= du or rows == 1):
            fc //= 2
        else:
            rows //= 2


def _check_kernel_inputs(qk, ws, ds, g=None, plan=None) -> str:
    tensors = dict(zip(WEIGHTS, ws), qk=qk)
    if g is not None:
        tensors["g"] = g
    for name, t in tensors.items():
        if t.device != qk.device or not t.is_cuda:
            raise ValueError(f"attn_qk_bank kernel: {name} must be on {qk.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"attn_qk_bank kernel: {name} must be contiguous")
        if name != "qk" and t.dtype != torch.float32:
            raise TypeError(f"attn_qk_bank kernel: {name} must be float32")
    if qk.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn_qk_bank kernel: qk must be float32 or bfloat16 ({qk.dtype})")
    if qk.ndim != 3 or ws[0].ndim != 3:
        raise ValueError("attn_qk_bank kernel: expected qk [B,N,F], W1 [C,F,A]")
    b, n, f, c, a = _shapes(qk, ws)
    want = [(c, f, a), (c, a), (c, a, a), (c, a)] * 2
    if ([tuple(w.shape) for w in ws] != want
            or (g is not None and tuple(g.shape) != (b, c, n, n))):
        raise ValueError("attn_qk_bank kernel: inconsistent shapes "
                         f"qk{tuple(qk.shape)} weights {[tuple(w.shape) for w in ws]} "
                         f"g{None if g is None else tuple(g.shape)}")
    if ds <= 0 or a % ds:
        raise ValueError(f"attn_qk_bank kernel: A={a} is not a multiple of ds={ds}")
    return plan_of(n, f, c, a, a // ds, g is not None, b, plan)


TILED_SMEM = 4 * 4 * 32 * 33   # the tiled plan's largest static shared memory (map_dqk_kernel)
_MAP_TILE = 32                 # csrc kMapTile
_TILE_THREADS = 256            # csrc kTileThreads
_INT32_MAX = 2 ** 31 - 1


def tiled_plan(b: int, n: int, f: int, c: int, a: int, h: int, bwd: bool) -> dict:
    """The tiled plan (csrc/attn_qk_bank.cu, "the tiled plan"): shared memory
    independent of N, F and A (``TILED_SMEM`` at most), the map in
    ``tiles`` x ``tiles`` tiles of 32 rows, the backward's map units (graph,
    channel, row tile, head, 32-feature slice of the head), and the
    device-memory scratch (t1 and q / k, plus d3 and dpre in the backward,
    ``b * c * 2 * n * a`` floats each).  Raises only where a launch's blocks
    pass the int32 grid index."""
    tiles = -(-n // _MAP_TILE)
    ds = a // h
    units = b * c * tiles * h * -(-ds // 32)
    elems = b * c * 2 * n * max(a, f) if not bwd else max(
        b * c * 2 * n * max(a, f), b * 2 * c * (f * a + a + a * a + a))
    blocks = max(-(-elems // _TILE_THREADS), b * c * tiles * tiles if not bwd else units)
    if blocks > _INT32_MAX:
        raise ValueError(f"attn_qk_bank {'backward' if bwd else 'forward'} kernel: B={b}, "
                         f"N={n}, F={f}, C={c}, A={a} need {blocks} blocks in the tiled plan, "
                         f"past the int32 grid index ({_INT32_MAX})")
    return {"plan": "tiled", "smem": TILED_SMEM, "tiles": tiles, "map_units": units,
            "scratch": (4 if bwd else 2) * b * c * 2 * n * a}


def check_plan(n: int, f: int, c: int, a: int, h: int, bwd: bool, b: int = 1,
               plan: str = None) -> int:
    """Shared-memory bytes of a block of the forward (``bwd`` False) or the
    backward kernel at these widths: the (graph, channel) block plan's
    wherever it fits ``SMEM_LIMIT``, else the tiled plan's (:func:`tiled_plan`),
    which raises only past the int32 grid index.  ``plan`` forces one
    ("block" raises where it does not fit, naming the limit)."""
    smem = bwd_plan(n, f, a, h)[2] if bwd else fwd_plan(n, f, a)[1]
    if plan == "tiled" or (plan is None and smem > SMEM_LIMIT):
        return tiled_plan(b, n, f, c, a, h, bwd)["smem"]
    if smem > SMEM_LIMIT:
        raise ValueError(f"attn_qk_bank {'backward' if bwd else 'forward'} kernel: N={n}, "
                         f"F={f}, C={c}, A={a} need {smem} B of shared memory per block "
                         f"(> {SMEM_LIMIT})")
    return smem


def plan_of(n: int, f: int, c: int, a: int, h: int, bwd: bool, b: int = 1,
            plan: str = None) -> str:
    """"block" or "tiled": the plan the wrappers launch at these widths
    (:func:`check_plan`), or ``plan`` where a caller forces one."""
    block = (bwd_plan(n, f, a, h)[2] if bwd else fwd_plan(n, f, a)[1]) <= SMEM_LIMIT
    which = plan or ("block" if block else "tiled")
    check_plan(n, f, c, a, h, bwd, b, which)
    return which


def _weight_ptrs(ws):
    return (ctypes.c_void_p * 8)(*(w.data_ptr() for w in ws))


def _tiled_scratch(which: str, b: int, n: int, c: int, a: int, bwd: bool, device):
    if which != "tiled":
        return None
    return torch.empty((4 if bwd else 2) * b * c * 2 * n * a, dtype=torch.float32,
                       device=device)


def _launch(qk, ws, ds: int, bf16: bool, plan: str = None) -> torch.Tensor:
    """The forward in the plan :func:`plan_of` chooses, or in ``plan``
    ("block" / "tiled") where a test or a comparison forces one."""
    which = _check_kernel_inputs(qk, ws, ds, plan=plan)
    b, n, f, c, a = _shapes(qk, ws)
    out = torch.empty((b, c, n, n), dtype=torch.float32, device=qk.device)
    if out.numel() == 0:
        return out
    fn = build.load("attn_qk_bank").attn_qk_bank_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2
    ptrs = _weight_ptrs(ws)
    fc, smem = fwd_plan(n, f, a)
    scratch = _tiled_scratch(which, b, n, c, a, False, qk.device)
    rc = fn(qk.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(), b, n, f, c, a, ds,
            int(qk.dtype == torch.bfloat16), int(bf16), fc, smem,
            None if scratch is None else scratch.data_ptr(), stream(qk))
    build.check_launch(rc, "attn_qk_bank_fwd")
    attn_qk_bank.launches += 1
    report_flops(flops(b, n, f, c, a))
    return out


def _launch_bwd(qk, ws, g, ds: int, bf16: bool, plan: str = None):
    """The backward in the plan :func:`plan_of` chooses, or in ``plan`` as
    in :func:`_launch`."""
    which = _check_kernel_inputs(qk, ws, ds, g, plan=plan)
    b, n, f, c, a = _shapes(qk, ws)
    dev = qk.device
    sizes = [w.numel() for w in ws]
    wgrad = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    dqk = torch.empty_like(qk)
    if qk.numel() == 0:
        wgrad.zero_()
        dqk.zero_()
    else:
        # per-graph rows of the weight gradients, then each unit's q and k
        # terms of dqk
        part = torch.empty(b * sum(sizes) + 2 * b * c * n * f, dtype=torch.float32,
                           device=dev)
        fn = build.load("attn_qk_bank").attn_qk_bank_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2
        ptrs = _weight_ptrs(ws)
        rows, fc, smem = bwd_plan(n, f, a, a // ds)
        scratch = _tiled_scratch(which, b, n, c, a, True, dev)
        rc = fn(qk.data_ptr(), ctypes.addressof(ptrs), g.data_ptr(), dqk.data_ptr(),
                wgrad.data_ptr(), part.data_ptr(), b, n, f, c, a, ds,
                int(qk.dtype == torch.bfloat16), int(bf16), rows, fc, smem,
                None if scratch is None else scratch.data_ptr(), stream(qk))
        build.check_launch(rc, "attn_qk_bank_bwd")
        attn_qk_bank_bwd.launches += 1
        report_flops(flops(b, n, f, c, a, bwd=True))
    grads = [t.view(w.shape) for t, w in zip(torch.split(wgrad, sizes), ws)]
    return (dqk, *grads)


def attn_qk_bank_bwd(qk, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, g, ds: int, *,
                     bf16: bool = False, impl: str = "auto"):
    """Backward of :func:`attn_qk_bank` for the cotangent ``g`` [B, C, N, N]
    on operands as the wrapper hands them to the kernel (qk in the compute
    dtype, the weights f32): (dqk, then the eight weight gradients).
    ``impl`` as in :func:`attn_qk_bank`."""
    ws = (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2)
    if resolve_impl(impl, qk, "attn_qk_bank") == "plain":
        return attn_qk_bank_bwd_plain(qk, *ws, g, ds, bf16=bf16)
    return _launch_bwd(qk, ws, g, ds, bf16)


class _AttnQkBank(torch.autograd.Function):
    """The kernel pair (or the plain pair) under autograd."""

    @staticmethod
    def forward(ctx, qk, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, ds, bf16, impl):
        ws = (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2)
        ctx.save_for_backward(qk, *ws)
        ctx.ds, ctx.bf16, ctx.impl = ds, bf16, impl
        if impl == "plain":
            return attn_qk_bank_plain(qk, *ws, ds, bf16=bf16)
        return _launch(qk, ws, ds, bf16)

    @staticmethod
    def backward(ctx, g):
        qk, *ws = ctx.saved_tensors
        grads = attn_qk_bank_bwd(qk, *ws, g.float().contiguous(), ctx.ds, bf16=ctx.bf16,
                                 impl=ctx.impl)
        return (*grads, None, None, None)


def attn_qk_bank(qk, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, ds: int, *,
                 bf16: bool = False, impl: str = "auto") -> torch.Tensor:
    """Per-channel q/k nets and head-mean tanh maps [B, C, N, N] float32
    from node features ``qk`` [B, N, F], differentiable in qk and the eight
    weights (``W1`` [C, F, A], ``b1`` [C, A], ``W2`` [C, A, A], ``b2``
    [C, A] for q, then for k).  Casts as the TPU wrapper does: qk to bf16 in
    ``bf16`` mode (else f32), the weights to f32.  ``impl``: "auto" (the
    kernels for a CUDA tensor, the plain versions for a CPU tensor),
    "kernel" or "plain"."""
    dt = torch.bfloat16 if bf16 else torch.float32
    ws = [w.float().contiguous() for w in (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2)]
    return _AttnQkBank.apply(qk.to(dt).contiguous(), *ws, ds, bf16,
                             resolve_impl(impl, qk, "attn_qk_bank"))


attn_qk_bank.launches = 0
attn_qk_bank_bwd.launches = 0
