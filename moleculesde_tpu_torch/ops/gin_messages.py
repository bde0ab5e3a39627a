"""GIN message block: edge gather + bond embedding + relu + aggregate.

    agg[b, n, :] = sum_{e: dst_e = n} relu(x[b, src_e, :] + bond_onehot[b, e, :] @ table)

Counterpart of ``moleculesde_tpu/ops/gin_messages.py::gin_messages``,
forward and backward.  On a CUDA tensor the wrappers launch the
hand-written kernels of ``csrc/gin_messages.cu``, which replace the TPU
kernels ``_fwd_kernel`` (``pallas_call`` at ``ops/gin_messages.py:128``)
and ``_bwd_kernel`` (l.144): both are bound by device memory.  Both sort
each graph's edges (the forward by destination, the backward by source
node) and gather x (and g) straight from device memory: in shared memory
where a graph's edge data fits a block (the block plan), else in a
device-memory pre-pass whose sorted edges blocks of node ranges walk (the
ranges plan, also for D > 32 bond columns).  So they take any N and D
(:func:`fwd_plan`, :func:`bwd_plan`; the source's header says more).  On
a CPU tensor they take :func:`gin_messages_plain` and
:func:`gin_messages_bwd_plain`.  :func:`gin_messages` is differentiable
through a ``torch.autograd.Function`` with the TPU kernel's gradient
contract: x and the table get gradients, the indices and one-hots none.

Masked edges carry ``src = dst = N`` (out of range): a message from an
out-of-range source gathers zeros, one to an out-of-range destination adds
nothing — the one-hot semantics of the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from moleculesde_tpu_torch.core.segment import edge_aggregate, edge_gather
from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT, resolve_impl, round_bf16, stream
from moleculesde_tpu_torch.utils.flops import report_flops

_FEAT = 64                 # features per block (csrc/gin_messages.cu)
_SLOTS = 4                 # node ranges (warps per 32 features) per block


def _operands(x, src, dst, bond_onehot, table, bf16: bool):
    """f32 operands rounded as the kernel rounds them, flat edge indices
    and their validity masks."""
    b, n, _ = x.shape
    x, boh, tbl = (round_bf16(t, bf16) for t in (x, bond_onehot, table))
    offs = (torch.arange(b, device=x.device) * n)[:, None]
    src_ok = ((src >= 0) & (src < n)).reshape(-1)
    dst_ok = ((dst >= 0) & (dst < n)).reshape(-1)
    return (x, boh, tbl, (src.long() + offs).reshape(-1), src_ok,
            (dst.long() + offs).reshape(-1), dst_ok)


def _pre(x, boh, tbl, src_i, src_ok):
    """Per-edge pre-activation ``x[src] + boh @ table`` -> [B*E, F] f32."""
    b, n, f = x.shape
    xs = edge_gather(x.reshape(b * n, f), src_i, src_ok)
    return xs + (boh @ tbl).reshape(-1, f)


def gin_messages_plain(x, src, dst, bond_onehot, table, *, bf16: bool = False):
    """Plain PyTorch version of the forward kernel; returns [B, N, F] f32.

    ``bf16`` rounds x, the one-hots and the table to bf16 and each message
    to bf16 before the f32 sum, as the kernel does."""
    b, n, f = x.shape
    x, boh, tbl, src_i, src_ok, dst_i, dst_ok = _operands(
        x, src, dst, bond_onehot, table, bf16)
    msg = round_bf16(torch.relu(_pre(x, boh, tbl, src_i, src_ok)), bf16)
    return edge_aggregate(msg, dst_i, b * n, dst_ok).reshape(b, n, f)


def gin_messages_bwd_plain(x, src, dst, bond_onehot, table, g, *,
                           bf16: bool = False):
    """Plain PyTorch version of the backward kernel: (dx [B, N, F],
    dtable [D, F]), both f32.

    ``dmsg = 1[pre > 0] * g[dst]``; ``dx`` sums dmsg onto the valid sources,
    ``dtable = boh^T @ dmsg`` over the whole batch.  ``bf16`` rounds g and
    dx to bf16 (dx is returned in x's bf16 dtype by the TPU kernel)."""
    b, n, f = x.shape
    x, boh, tbl, src_i, src_ok, dst_i, dst_ok = _operands(
        x, src, dst, bond_onehot, table, bf16)
    g = round_bf16(g, bf16)
    pre = _pre(x, boh, tbl, src_i, src_ok)
    g_msg = edge_gather(g.reshape(b * n, f), dst_i, dst_ok)
    dmsg = torch.where(pre > 0, g_msg, torch.zeros((), device=g.device))
    dx = edge_aggregate(dmsg, src_i, b * n, src_ok).reshape(b, n, f)
    dtable = boh.reshape(-1, boh.shape[-1]).t() @ dmsg
    return round_bf16(dx, bf16), dtable


def flops(b: int, e: int, d: int, f: int, bwd: bool = False) -> int:
    """Matrix-product FLOPs of the plain version (what ``matmul_flops``
    counts there), which the kernels report: the bond embedding ``boh @
    table`` [B*E, D] x [D, F]; the backward recomputes it and adds
    ``boh^T @ dmsg``."""
    return (4 if bwd else 2) * b * e * d * f


_RANGE_EDGES = 256         # ranges plan: edges a block walks, about (kRangeEdges)
_SORT_SMEM_WORDS = 16384   # ranges plan: the sort's cursors in shared memory up to
_INT32_MAX = 2 ** 31 - 1


def _edge_plan(n: int, e: int, d: int, f: int, bwd: bool, b: int = 1,
               plan: Optional[str] = None) -> dict:
    """The launch plan both kernels share, mirrored from
    ``csrc/gin_messages.cu`` (``edge_smem``, ``ranges_of``, ``sort_smem``,
    ``walk_smem``).

    The block plan (``"block"``): one block of 8 warps per (graph,
    64-feature chunk), 2 warp columns of 32 features by 4 node ranges.
    Shared memory holds the graph's bond one-hot rows (zero padded to
    ``maxd`` = 16 or 32 columns), the edges' bins, src, dst and sorted
    order and the bins' starts, and in the backward the warps' dtable
    columns.  It is chosen wherever it fits: D <= 32 and ``SMEM_LIMIT``
    (N ~ 717 forward, ~ 660 backward at E = 4 N, D = 13).

    The ranges plan (``"ranges"``) everywhere else: a pre-pass sorts each
    graph's edges in device memory (its cursors in shared memory where N + 2
    words fit 64 KB), then blocks of (graph, node range of ``ranges`` =
    ceil(E / 256), 64-feature chunk, and in the backward ``slices`` 32-column
    slices of D > 32) walk them; no shared memory grows with N or E.
    Raises only where its blocks ``b * ranges * slices * chunks`` pass the
    int32 grid index.  ``plan`` forces one ("block" raises where it does not
    fit)."""
    what = "backward" if bwd else "forward"
    maxd = 16 if d <= 16 else 32 if d <= 32 else 0
    chunks = -(-f // _FEAT)
    smem = 4 * (e * maxd + (_SLOTS * maxd * _FEAT if bwd else 0) + 4 * e + n + 2)
    fits = maxd > 0 and smem <= SMEM_LIMIT
    if plan == "block" or (plan is None and fits):
        if maxd == 0:
            raise ValueError(f"gin_messages {what} kernel: block plan needs D <= 32 (D={d})")
        if not fits:
            raise ValueError(f"gin_messages {what} kernel: N={n}, E={e}, D={d} need {smem} B "
                             f"of shared memory in the block plan (> SMEM_LIMIT = {SMEM_LIMIT})")
        return {"plan": "block", "maxd": maxd, "smem": smem, "chunks": chunks, "ranges": 1,
                "slices": 1}
    ranges = max(1, -(-e // _RANGE_EDGES))
    slices = -(-d // 32) if bwd and d > 32 else 1
    blocks = b * ranges * slices * chunks
    if blocks > _INT32_MAX:
        raise ValueError(f"gin_messages {what} kernel: B={b}, E={e}, F={f} need {blocks} "
                         f"blocks, past the int32 grid index ({_INT32_MAX})")
    sort = 4 * (n + 2) if n + 2 <= _SORT_SMEM_WORDS else 0
    walk = 4 * _SLOTS * (16 if d <= 16 else 32) * _FEAT if bwd else 0
    return {"plan": "ranges", "maxd": maxd, "smem": max(sort, walk), "sort_smem": sort,
            "walk_smem": walk, "chunks": chunks, "ranges": ranges, "slices": slices}


def fwd_plan(n: int, e: int, d: int, f: int, b: int = 1) -> dict:
    """Launch plan of the forward kernel (:func:`_edge_plan`): the block
    plan up to N ~ 717 at E = 4 N, D = 13, the ranges plan past it."""
    return _edge_plan(n, e, d, f, bwd=False, b=b)


def bwd_plan(n: int, e: int, d: int, f: int, b: int = 1) -> dict:
    """Launch plan of the backward kernel (:func:`_edge_plan`, plus the
    warps' dtable columns): the block plan up to N ~ 660 at E = 4 N, D = 13,
    the ranges plan past it."""
    return _edge_plan(n, e, d, f, bwd=True, b=b)


def sort_words(b: int, n: int, e: int) -> int:
    """Int words of the ranges plan's sort scratch: bins and order [B][E],
    starts and cursors [B][N + 2]."""
    return 2 * b * e + 2 * b * (n + 2)


def _plan_kernel(entry: str, n: int, e: int, d: int) -> int:
    fn = getattr(build.load("gin_messages"), entry)
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    return fn(n, e, d)


def fwd_plan_kernel(n: int, e: int, d: int) -> int:
    """The forward's shared memory as its C entry computes it (0 where it
    has no plan); builds the library on first use."""
    return _plan_kernel("gin_messages_fwd_smem", n, e, d)


def bwd_plan_kernel(n: int, e: int, d: int) -> int:
    """The backward's shared memory as its C entry computes it (0 where it
    has no plan); builds the library on first use."""
    return _plan_kernel("gin_messages_bwd_smem", n, e, d)


def ranges_plan_kernel(n: int, e: int, d: int) -> dict:
    """The ranges plan as its C entry computes it: node ranges a graph, the
    sort's and the backward walk's shared memory; builds the library on
    first use."""
    fn = build.load("gin_messages").gin_messages_ranges_plan
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 3)()
    fn(n, e, d, ctypes.addressof(out))
    return {"ranges": out[0], "sort_smem": out[1], "walk_smem": out[2]}


def _check_kernel_inputs(x, src, dst, boh, table, g=None, plan=None) -> dict:
    tensors = {"x": x, "src": src, "dst": dst, "bond_onehot": boh, "table": table}
    if g is not None:
        tensors["g"] = g
    for name, t in tensors.items():
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"gin_messages kernel: {name} must be on {x.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"gin_messages kernel: {name} must be contiguous")
    for name in ("x", "bond_onehot", "table", "g"):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f"gin_messages kernel: {name} must be float32")
    for name in ("src", "dst"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"gin_messages kernel: {name} must be int32")
    if x.ndim != 3 or src.ndim != 2 or boh.ndim != 3 or table.ndim != 2:
        raise ValueError("gin_messages kernel: expected x [B,N,F], src/dst "
                         "[B,E], bond_onehot [B,E,D], table [D,F]")
    b, n, f = x.shape
    e = src.shape[1]
    d = table.shape[0]
    if (tuple(src.shape) != (b, e) or tuple(dst.shape) != (b, e)
            or tuple(boh.shape) != (b, e, d) or tuple(table.shape) != (d, f)
            or (g is not None and tuple(g.shape) != (b, n, f))):
        raise ValueError("gin_messages kernel: inconsistent shapes "
                         f"x{tuple(x.shape)} src{tuple(src.shape)} "
                         f"dst{tuple(dst.shape)} boh{tuple(boh.shape)} "
                         f"table{tuple(table.shape)}")
    return _edge_plan(n, e, d, f, bwd=g is not None, b=b, plan=plan)


def _sort_scratch(p: dict, b: int, n: int, e: int, device) -> Optional[torch.Tensor]:
    if p["plan"] == "block":
        return None
    return torch.empty(sort_words(b, n, e), dtype=torch.int32, device=device)


def _launch(x, src, dst, boh, table, bf16: bool, plan: Optional[str] = None) -> torch.Tensor:
    """The forward kernel in the plan :func:`fwd_plan` chooses, or in
    ``plan`` ("block" / "ranges") where a test or a comparison forces one."""
    p = _check_kernel_inputs(x, src, dst, boh, table, plan=plan)
    b, n, f = x.shape
    e = src.shape[1]
    out = torch.empty((b, n, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    sort = _sort_scratch(p, b, n, e, x.device)
    fn = build.load("gin_messages").gin_messages_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    rc = fn(x.data_ptr(), src.data_ptr(), dst.data_ptr(), boh.data_ptr(),
            table.data_ptr(), out.data_ptr(), b, n, e, table.shape[0], f, int(bf16),
            p["ranges"] if p["plan"] == "ranges" else 0,
            None if sort is None else sort.data_ptr(), stream(x))
    build.check_launch(rc, "gin_messages_fwd")
    gin_messages.launches += 1
    report_flops(flops(b, e, table.shape[0], f))
    return out


def _launch_bwd(x, src, dst, boh, table, g, bf16: bool, plan: Optional[str] = None):
    """The backward kernel in the plan :func:`bwd_plan` chooses, or in
    ``plan`` as in :func:`_launch`."""
    p = _check_kernel_inputs(x, src, dst, boh, table, g, plan=plan)
    b, n, f = x.shape
    e = src.shape[1]
    d = table.shape[0]
    dx = torch.empty((b, n, f), dtype=torch.float32, device=x.device)
    dtable = torch.empty((d, f), dtype=torch.float32, device=x.device)
    if dx.numel() == 0:
        return dx, dtable.zero_()
    rows = b * (p["ranges"] if p["plan"] == "ranges" else 1)
    part = torch.empty((rows, d, f), dtype=torch.float32, device=x.device)
    sort = _sort_scratch(p, b, n, e, x.device)
    fn = build.load("gin_messages").gin_messages_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    rc = fn(x.data_ptr(), src.data_ptr(), dst.data_ptr(), boh.data_ptr(),
            table.data_ptr(), g.data_ptr(), dx.data_ptr(), dtable.data_ptr(),
            part.data_ptr(), b, n, e, d, f, int(bf16),
            p["ranges"] if p["plan"] == "ranges" else 0,
            None if sort is None else sort.data_ptr(), stream(x))
    build.check_launch(rc, "gin_messages_bwd")
    gin_messages_bwd.launches += 1
    report_flops(flops(b, e, d, f, bwd=True))
    return dx, dtable


def gin_messages_bwd(x, src, dst, bond_onehot, table, g, *, bf16: bool = False,
                     impl: str = "auto"):
    """Backward of :func:`gin_messages` for the output cotangent ``g``
    [B, N, F]: returns (dx [B, N, F], dtable [D, F]), f32.  ``impl`` as in
    :func:`gin_messages`."""
    if resolve_impl(impl, x, "gin_messages") == "plain":
        return gin_messages_bwd_plain(x, src, dst, bond_onehot, table, g, bf16=bf16)
    return _launch_bwd(x, src, dst, bond_onehot, table, g, bf16)


class _GinMessages(torch.autograd.Function):
    """The kernel pair (or the plain pair) under autograd: gradients for x
    and the table; the indices and one-hots get none, as in the TPU
    kernel's custom VJP."""

    @staticmethod
    def forward(ctx, x, src, dst, boh, table, bf16, impl):
        ctx.save_for_backward(x, src, dst, boh, table)
        ctx.bf16, ctx.impl = bf16, impl
        if impl == "plain":
            return gin_messages_plain(x, src, dst, boh, table, bf16=bf16)
        return _launch(x, src, dst, boh, table, bf16)

    @staticmethod
    def backward(ctx, g):
        x, src, dst, boh, table = ctx.saved_tensors
        dx, dtable = gin_messages_bwd(x, src, dst, boh, table, g.contiguous(),
                                      bf16=ctx.bf16, impl=ctx.impl)
        return dx, None, None, None, dtable, None, None


def gin_messages(x, src, dst, bond_onehot, table, *, bf16: bool = False,
                 impl: str = "auto") -> torch.Tensor:
    """Fused GIN message block; returns [B, N, F] float32, differentiable
    in ``x`` and ``table``.

    ``x``: [B, N, F] node features (f32); ``src``/``dst``: [B, E] int32
    local edge endpoints, masked edges set to N; ``bond_onehot``: [B, E, D]
    concatenated bond-feature one-hots; ``table``: [D, F] row-stacked bond
    embedding tables.  ``impl``: "auto" (the kernels for a CUDA tensor, the
    plain versions for a CPU tensor), "kernel" or "plain".
    """
    return _GinMessages.apply(x, src, dst, bond_onehot, table, bf16,
                              resolve_impl(impl, x, "gin_messages"))


gin_messages.launches = 0
gin_messages_bwd.launches = 0
