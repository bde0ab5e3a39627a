"""GIN message block: edge gather + bond embedding + relu + aggregate.

    agg[b, n, :] = sum_{e: dst_e = n} relu(x[b, src_e, :] + bond_onehot[b, e, :] @ table)

Counterpart of ``moleculesde_tpu/ops/gin_messages.py::gin_messages``,
forward and backward.  On a CUDA tensor the wrappers launch the
hand-written kernels of ``csrc/gin_messages.cu``, which replace the TPU
kernels ``_fwd_kernel`` (``pallas_call`` at ``ops/gin_messages.py:128``)
and ``_bwd_kernel`` (l.144): both are bound by device memory.  Both stage
only each graph's edge data, sort its edges (the forward by destination,
the backward by source node) and gather x (and g) straight from device
memory, so they take any N whose edge data fits a block
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

import torch

from moleculesde_tpu_torch.core.segment import edge_aggregate, edge_gather
from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT, resolve_impl, round_bf16, stream

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


def _edge_plan(n: int, e: int, d: int, f: int, bwd: bool) -> dict:
    """The launch plan both kernels share, mirrored from
    ``csrc/gin_messages.cu::edge_smem``: one block of 8 warps per (graph,
    64-feature chunk), 2 warp columns of 32 features by 4 node ranges.
    Shared memory holds the graph's bond one-hot rows (zero padded to
    ``maxd`` = 16 or 32 columns), the edges' bins, src, dst and sorted
    order and the bins' starts, and in the backward the warps' dtable
    columns: nothing grows with F, and N only by a word a node.  Raises
    past D = 32 or past ``SMEM_LIMIT``, naming the limit."""
    what = "backward" if bwd else "forward"
    if d > 32:
        raise ValueError(f"gin_messages {what} kernel: D={d} bond one-hot columns "
                         "(> 32, the columns a thread holds)")
    maxd = 16 if d <= 16 else 32
    smem = 4 * (e * maxd + (_SLOTS * maxd * _FEAT if bwd else 0) + 4 * e + n + 2)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gin_messages {what} kernel: N={n}, E={e}, D={d} need {smem} B "
                         f"of shared memory (> SMEM_LIMIT = {SMEM_LIMIT})")
    return {"maxd": maxd, "smem": smem, "chunks": -(-f // _FEAT)}


def fwd_plan(n: int, e: int, d: int, f: int) -> dict:
    """Launch plan of the forward kernel (:func:`_edge_plan`): N ~ 717 at
    E = 4 N, D = 13."""
    return _edge_plan(n, e, d, f, bwd=False)


def bwd_plan(n: int, e: int, d: int, f: int) -> dict:
    """Launch plan of the backward kernel (:func:`_edge_plan`, plus the
    warps' dtable columns): N ~ 660 at E = 4 N, D = 13."""
    return _edge_plan(n, e, d, f, bwd=True)


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


def _check_kernel_inputs(x, src, dst, boh, table, g=None):
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
    _edge_plan(n, e, d, f, bwd=g is not None)


def _launch(x, src, dst, boh, table, bf16: bool) -> torch.Tensor:
    _check_kernel_inputs(x, src, dst, boh, table)
    b, n, f = x.shape
    out = torch.empty((b, n, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.load("gin_messages").gin_messages_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(x.data_ptr(), src.data_ptr(), dst.data_ptr(), boh.data_ptr(),
            table.data_ptr(), out.data_ptr(), b, n, src.shape[1],
            table.shape[0], f, int(bf16), stream(x))
    build.check_launch(rc, "gin_messages_fwd")
    gin_messages.launches += 1
    return out


def _launch_bwd(x, src, dst, boh, table, g, bf16: bool):
    _check_kernel_inputs(x, src, dst, boh, table, g)
    b, n, f = x.shape
    d = table.shape[0]
    dx = torch.empty((b, n, f), dtype=torch.float32, device=x.device)
    dtable = torch.empty((d, f), dtype=torch.float32, device=x.device)
    if dx.numel() == 0:
        return dx, dtable.zero_()
    part = torch.empty((b, d, f), dtype=torch.float32, device=x.device)
    fn = build.load("gin_messages").gin_messages_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(x.data_ptr(), src.data_ptr(), dst.data_ptr(), boh.data_ptr(),
            table.data_ptr(), g.data_ptr(), dx.data_ptr(), dtable.data_ptr(),
            part.data_ptr(), b, n, src.shape[1], d, f, int(bf16), stream(x))
    build.check_launch(rc, "gin_messages_bwd")
    gin_messages_bwd.launches += 1
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
