"""The collectives of the port's data parallelism, with their gradients.

The JAX package gets data parallelism by placing shardings on one global
program (``moleculesde_tpu/parallel/mesh.py``): every reduction across
molecules is global because the trace is.  PyTorch runs one process per
device, each holding its block of the global batch (rank r holds graphs
``r * B / W .. (r + 1) * B / W - 1`` of a global batch of B graphs over W
ranks), so each such reduction is an explicit collective here:

- :func:`global_sum` (and :func:`global_mean`, :func:`masked_mean` on it):
  the sum of a tensor over ranks;
- :func:`all_gather_rows`: every rank's rows, in rank order;
- :func:`block` / :func:`global_shape`: a random draw made at the global
  batch's shape from a generator that every rank seeds alike, of which the
  rank keeps its block, so the ranks together draw what one process draws
  for the global batch;
- :func:`average_grads` and :func:`broadcast_`.

**Gradient convention.**  Every rank computes the same global loss.  The
backward of each collective sums the incoming gradient over ranks (the
backward of :func:`all_gather_rows` sums the gathered gradient over ranks
and keeps the rank's rows), so every gradient a rank holds is W times the
global loss's partial derivative through that rank's molecules;
:func:`average_grads` then averages the parameter gradients over ranks,
and every rank applies exactly the gradient of the global-batch loss.  A
term of the loss that reaches no collective would be counted once instead
of W times: every reduction over molecules goes through one here.

The active group is set by :func:`data_parallel` (``with
data_parallel(group): ...``); the models, losses and samplers read it with
:func:`active`.  Without one (a single process) every function here is the
identity, or the plain reduction it replaces, so the one-process code and
its random stream are unchanged.

Only ``all_reduce`` (sum), ``all_gather`` of equal sizes and ``broadcast``
are used, which gloo runs on the CPU, so the CPU tests run the same code as
the card.  On a gloo group every collective stages its tensor through host
memory (a copy to the CPU, the collective, a copy back): gloo's
``all_gather`` takes host tensors only, and this is how two ranks share one
card, which NCCL refuses.  On an NCCL group the tensors stay on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the data-parallel process group (torch's default
    group): its ``rank``, the ``world`` size and the ``backend`` ("gloo"
    or "nccl")."""

    rank: int
    world: int
    backend: str

    @property
    def staged(self) -> bool:
        """Whether collectives stage their tensors through host memory."""
        return self.backend == "gloo"


_ACTIVE: Optional[DataGroup] = None


def active() -> Optional[DataGroup]:
    """The group set by :func:`data_parallel`, or None in a single process."""
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(group: Optional[DataGroup]) -> Iterator[Optional[DataGroup]]:
    """Run the block with ``group`` active (None: as a single process)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, group
    try:
        yield group
    finally:
        _ACTIVE = saved


def world_size() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.world


def rank() -> int:
    return 0 if _ACTIVE is None else _ACTIVE.rank


def _reduce(x: torch.Tensor, g: DataGroup) -> torch.Tensor:
    """A new tensor: ``x`` summed over the ranks of ``g``."""
    y = x.detach().to("cpu", copy=True) if g.staged else x.detach().clone()
    dist.all_reduce(y)
    return y.to(x.device)


def _gather(x: torch.Tensor, g: DataGroup) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated on axis 0 in rank
    order.  Bool tensors travel as bytes."""
    src = x.detach()
    if src.dtype == torch.bool:
        return _gather(src.to(torch.uint8), g).bool()
    src = src.to("cpu", copy=True) if g.staged else src.contiguous()
    out = [torch.empty_like(src) for _ in range(g.world)]
    dist.all_gather(out, src)
    return torch.cat(out).to(x.device)


class _GlobalSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the gradient over ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows; the backward sums the gathered gradient over ranks
    and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.group.rank * ctx.rows
        return _reduce(grad, ctx.group)[lo:lo + ctx.rows], None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (elementwise), differentiable; ``x``
    itself in a single process."""
    g = _ACTIVE
    return x if g is None else _GlobalSum.apply(x, g)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every entry of ``x`` over all ranks (``x.mean()`` of the
    global batch; equal local sizes)."""
    g = _ACTIVE
    if g is None:
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * g.world)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``x`` over the entries where ``mask`` is True, on all
    ranks (denominator clamped at 1); :func:`global_mean` without a mask."""
    if mask is None:
        return global_mean(x)
    m = mask.to(x.dtype)
    return global_sum((x * m).sum()) / global_sum(m.sum()).clamp(min=1.0)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated on axis 0 in rank
    order, differentiable; ``x`` itself in a single process."""
    g = _ACTIVE
    if g is None:
        return x
    if not x.requires_grad:
        return _gather(x, g)
    return _GatherRows.apply(x, g)


def row_offset(rows: int) -> int:
    """The global index of this rank's first row, for ``rows`` rows a rank."""
    return rank() * rows


def global_shape(shape: Sequence[int], dim: int = 0) -> Tuple[int, ...]:
    """``shape`` with axis ``dim`` taken over all ranks (times the world size)."""
    shape = list(shape)
    shape[dim] *= world_size()
    return tuple(shape)


def block(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` (drawn or built at :func:`global_shape`)
    along ``dim``; ``x`` itself in a single process."""
    g = _ACTIVE
    if g is None:
        return x
    n = x.shape[dim] // g.world
    return x.narrow(dim, g.rank * n, n)


def average_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the ``.grad`` of ``params`` over the ranks, in place, with
    one all-reduce per dtype.  Every rank holds the same set of gradients
    (the same graph on equal shapes); a no-op in a single process."""
    g = _ACTIVE
    if g is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for dtype in sorted({x.dtype for x in grads}, key=str):
        same = [x for x in grads if x.dtype == dtype]
        flat = _reduce(torch.cat([x.reshape(-1) for x in same]), g) / g.world
        for x, v in zip(same, flat.split([x.numel() for x in same])):
            x.copy_(v.view_as(x))


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place (one broadcast
    per dtype); a no-op in a single process."""
    g = _ACTIVE
    if g is None:
        return
    tensors = list(tensors)
    for dtype in sorted({x.dtype for x in tensors}, key=str):
        same = [x for x in tensors if x.dtype == dtype]
        flat = torch.cat([x.detach().reshape(-1) for x in same])
        if g.staged:
            flat = flat.cpu()
        dist.broadcast(flat, src)
        with torch.no_grad():
            for x, v in zip(same, flat.split([x.numel() for x in same])):
                x.copy_(v.view_as(x).to(x.device))
