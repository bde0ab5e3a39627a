"""Data parallelism over torch.distributed process groups.

Counterpart of ``moleculesde_tpu/parallel/mesh.py``.  The JAX package puts
shardings on one global program over a device mesh; here each device is a
process (a rank) that holds its block of the global batch, with the
reductions across molecules made explicit as collectives
(:mod:`~moleculesde_tpu_torch.parallel.collectives`, whose docstring fixes
the gradient convention).  The JAX names map as follows:

- ``make_mesh`` has no counterpart: a process group stands in its place,
  formed by :func:`initialize_distributed` (one rank a process, started by
  the user or a launcher) or by :func:`spawn` (``--num_devices N``: N
  ranks on this host), and made the active group with
  :func:`~moleculesde_tpu_torch.parallel.collectives.data_parallel`.
- ``shard_for_process``: :func:`shard_for_process`, the same strided,
  disjoint and equalised shard.
- ``shard_batch`` / ``global_batch_putter`` go the other way round: a
  process holds only its block of the global batch, :func:`rank_block`
  (or a loader built with ``block=(rank, world)``, which collates only the
  block).
- ``replicate``: :func:`replicate`, rank 0's parameters and buffers
  broadcast to every rank.
- ``sharded_jit``: no wrapper is needed; the samplers and the finetune
  steps run under the active group as they are.
- ``make_sharded_pretrain_step``: :func:`pretrain_step`.

Every process group is formed with a timeout (:data:`TIMEOUT`), so a
collective that a rank never joins fails in bounded time, and every rank
that :func:`spawn` starts is joined with a deadline.  Nothing falls back:
a group that does not form raises.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import socket
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from moleculesde_tpu_torch.parallel.collectives import DataGroup, broadcast_, data_parallel
from moleculesde_tpu_torch.utils.device import resolve_device

TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device: str | torch.device) -> str:
    """The process group's backend for ``device``: NCCL on CUDA, gloo on
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """The rank's device: ``cuda:local_rank`` for a CUDA device (made the
    current device), the CPU for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", local_rank)
    torch.cuda.set_device(dev)
    return dev


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: str | torch.device = "cuda",
                           backend: Optional[str] = None,
                           timeout: Optional[datetime.timedelta] = None) -> int:
    """Form the default process group; returns the number of processes.

    A no-op that returns 1 when ``num_processes <= 1``, as in JAX.  With all
    three arguments the group meets at ``tcp://<coordinator_address>``
    (``host:port``); otherwise at ``env://`` (a launcher's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``; the arguments given
    override the last two), JAX's auto-detection.  The backend follows
    ``device`` (:func:`backend_for`) unless ``backend`` names one: gloo
    with CUDA tensors is how two ranks share one card.  ``timeout`` bounds
    every collective (default :data:`TIMEOUT`)."""
    if num_processes is not None and num_processes <= 1:
        return 1
    kwargs = dict(backend=backend or backend_for(device), timeout=timeout or TIMEOUT)
    if coordinator_address and num_processes and process_id is not None:
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    else:
        kwargs["init_method"] = "env://"
        if num_processes:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)
    return dist.get_world_size()


def current_group() -> Optional[DataGroup]:
    """The default process group as a :class:`DataGroup`, or None when none
    is formed."""
    if not dist.is_initialized():
        return None
    return DataGroup(dist.get_rank(), dist.get_world_size(), dist.get_backend())


def local_rank() -> int:
    """The rank's index among the ranks of its host: a launcher's
    ``LOCAL_RANK``, else the rank modulo the visible cards (the rank on the
    CPU)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    r = dist.get_rank() if dist.is_initialized() else 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return r % n if n else r


def shard_for_process(graphs, process_index: Optional[int] = None,
                      process_count: Optional[int] = None, equalize: bool = True):
    """This process's shard of a dataset: strided (molecule i goes to
    process i mod P), disjoint, and with ``equalize`` cut to the smallest
    shard's size so every process runs the same number of steps (a rank
    that runs out of batches early would leave the others waiting in a
    collective).  Lists and packed datasets (by ``.subset``, no dict is
    built) alike."""
    group = current_group()
    if process_count is None:
        process_count = group.world if group else 1
    if process_index is None:
        process_index = group.rank if group else 0
    n = len(graphs)
    take = n // process_count if equalize else None
    idx = np.arange(process_index, n, process_count)[:take]
    if hasattr(graphs, "subset"):
        return graphs.subset(idx)
    return [graphs[int(i)] for i in idx]


def rank_block(batch, rank: int, world: int):
    """Rank ``rank``'s block of a global batch of ``world`` equal blocks: a
    padded batch's graphs ``rank * B / world ..`` with node numbering and
    edge endpoints made rank-local (padded edges at the block's node 0), a
    compact batch sliced as it is."""
    from moleculesde_tpu_torch.pretrain.train_step import split_microbatches

    return split_microbatches(batch, world)[rank]


def replicate(modules: Iterable[nn.Module]) -> None:
    """Make every rank's parameters and buffers rank 0's (the active
    group's), in place."""
    broadcast_([t for m in modules for t in list(m.parameters()) + list(m.buffers())], src=0)


def check_microbatch(microbatch: int, world: int) -> None:
    """``--microbatch`` must spread every chunk over all ranks (JAX
    ``examples/pretrain.py:174-178``)."""
    if microbatch and microbatch % world:
        raise ValueError(f"--microbatch={microbatch} must be a multiple of the number of "
                         f"ranks ({world}) so every accumulation chunk spreads over all "
                         f"ranks")


def pretrain_step(models: Dict[str, nn.Module], optimizer: torch.optim.Optimizer, cfg,
                  batch, group: DataGroup, generator: Optional[torch.Generator] = None,
                  coeff_contrastive: Optional[float] = None, deterministic: bool = False,
                  draws=None) -> Dict[str, torch.Tensor]:
    """The data-parallel pretraining step (JAX ``make_sharded_pretrain_step``):
    ``batch`` is this rank's block of the global batch, ``generator`` seeded
    alike on every rank.  Returns the global batch's metrics, the same on
    every rank, after every rank applied the global batch's gradient.  With
    ``cfg.microbatch`` (the global chunk size) each rank splits its block
    into B / microbatch chunks, so chunk j is JAX's shard-aligned chunk."""
    from moleculesde_tpu_torch.pretrain import train_step

    check_microbatch(cfg.microbatch, group.world)
    with data_parallel(group):
        return train_step.pretrain_step(models, optimizer, cfg, batch, generator,
                                        coeff_contrastive, deterministic, draws)


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(index: int, fn: Callable, world: int, port: int, device: str,
               backend: Optional[str], same_card: bool, timeout: datetime.timedelta,
               threads: int, results, args: Sequence[Any]) -> None:
    torch.set_num_threads(threads)
    initialize_distributed(f"localhost:{port}", world, index, device=device,
                           backend=backend, timeout=timeout)
    try:
        group = current_group()
        dev = rank_device(device, 0 if same_card else index)
        with data_parallel(group):
            out = fn(group, dev, *args)
        if index == 0:   # as bytes: a tensor would travel as a handle to this process
            buf = io.BytesIO()
            torch.save(out, buf)
            results.put(buf.getvalue())
    finally:
        dist.destroy_process_group()


def check_devices(world: int, device: str | torch.device) -> None:
    """Raise when ``world`` ranks would need more cards than are visible."""
    if torch.device(device).type != "cuda":
        return
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world > visible:
        raise ValueError(f"{world} ranks need {world} CUDA devices, but {visible} "
                         f"{'is' if visible == 1 else 'are'} visible")


def spawn(fn: Callable, world: int, device: str | torch.device, *args,
          backend: Optional[str] = None, same_card: bool = False,
          deadline_s: Optional[float] = None) -> Any:
    """Run ``fn(group, device, *args)`` in ``world`` new processes, one rank
    each, in a group that meets on a free localhost port; rank r runs on
    ``cuda:r`` for a CUDA ``device`` (one card a rank: more ranks than
    visible cards raise) or on the CPU over gloo.  ``same_card`` puts every
    rank on ``cuda:0`` over gloo (``backend="gloo"``, whose collectives
    stage through host memory; NCCL refuses two ranks on one device).
    Returns rank 0's result.  A rank that fails ends the others and raises;
    ``deadline_s`` bounds the whole run (None: only each collective's
    :data:`TIMEOUT`, as this process holds it, bounds it)."""
    if world < 2:
        raise ValueError(f"spawn runs 2 or more ranks, not {world}")
    if same_card:
        if backend != "gloo":
            raise ValueError("ranks that share a card need backend='gloo'")
    else:
        check_devices(world, device)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    threads = max(1, torch.get_num_threads() // world)
    procs = mp.start_processes(
        _rank_main, args=(fn, world, free_port(), str(device), backend, same_card, TIMEOUT,
                          threads, results, args),
        nprocs=world, join=False, start_method="spawn")
    end = None if deadline_s is None else time.monotonic() + deadline_s
    out = None
    try:
        while True:
            if not results.empty():   # read as it comes: a large result fills the pipe
                out = torch.load(io.BytesIO(results.get()), weights_only=False)
            if procs.join(timeout=1):
                break
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"{world} ranks did not finish in {deadline_s} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    if not results.empty():
        out = torch.load(io.BytesIO(results.get()), weights_only=False)
    return out


@contextlib.contextmanager
def _quiet_unless(first: bool):
    """Only rank 0 prints: the block's standard output goes nowhere
    elsewhere."""
    if first:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def _cli_rank(group: DataGroup, device: torch.device, run: Callable, args) -> Any:
    with _quiet_unless(group.rank == 0):
        return run(args, device)


def run_cli(run: Callable, args, num_devices: int = 0, distributed: bool = False) -> Any:
    """Run a CLI's ``run(args, device)`` as its flags ask: in this process;
    as ``num_devices`` > 1 ranks spawned here (``--num_devices``: one a
    card, or gloo ranks for ``--device cpu``); or as this process's rank of
    the group :func:`initialize_distributed` forms from ``--dist_*`` (or
    ``env://``) with ``distributed``.  ``run`` runs under the group, on the
    rank's device; ranks other than 0 print nothing.  Returns rank 0's
    result (this process's in a distributed run)."""
    device = resolve_device(args.device)
    if distributed:
        initialize_distributed(args.dist_coordinator or None, args.dist_num_processes or None,
                               args.dist_process_id if args.dist_process_id >= 0 else None,
                               device=device)
        if not dist.is_initialized():   # one process forms no group, as in JAX
            return run(args, device)
        try:
            group = current_group()
            with data_parallel(group):
                return _cli_rank(group, rank_device(device, local_rank()), run, args)
        finally:
            dist.destroy_process_group()
    if num_devices > 1:
        return spawn(_cli_rank, num_devices, device, run, args)
    return run(args, device)
