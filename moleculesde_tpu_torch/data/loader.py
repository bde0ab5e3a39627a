"""Host batching: shuffle, fixed-shape collation, worker threads and
prefetch to the device.

Counterpart of ``moleculesde_tpu/data/loader.py``: :class:`GraphLoader`
with the padded (``--ingest padded``; in C++ by default,
:mod:`~moleculesde_tpu_torch.data.native_collate`) and the compact
(``--ingest compact``, :mod:`~moleculesde_tpu_torch.data.compact`)
collations over a list of graph dicts or a packed dataset
(:class:`~moleculesde_tpu_torch.data.packed.PackedGraphs`, kept as it is,
compact batches gathered off its flat arrays), the size buckets of
:class:`BucketedGraphLoader` (``--buckets``) with :func:`max_atoms` and
:func:`suggest_buckets` (``--n_max 0``), :class:`ThreadedLoader`
(``--num_workers``) and :func:`device_prefetch`.  Every batch of a loader (of a bucket) has the same
shapes; with ``drop_last`` only full batches are produced, otherwise the
tail batch is padded with empty graphs.  Every shuffle draws from
``numpy.random.default_rng(seed)``, so the same seed visits molecules, and
buckets, in the JAX package's order.  The finetunes' labels ride along
(``num_tasks``: ``y`` [B, T]; ``with_forces``: ``forces``), and
``rotation_transform`` turns each training molecule by a random rotation
drawn from the same generator, as JAX's ``GraphLoader._rotate`` does.

A loader built with ``block=(rank, world)`` is one rank's view of a
data-parallel run (``parallel/``): it visits the global batches of
``batch_size`` molecules in the same order as every other rank's, and
collates only the rank's block of each (``batch_size / world`` graphs,
the block of a padded tail included), drawing the rotations of the whole
global batch, so the ranks together see what one loader sees.
"""

from __future__ import annotations

import collections
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from moleculesde_tpu_torch.core.batch import GraphBatch, pad_graphs
from moleculesde_tpu_torch.data.compact import (
    CompactBatch, collate_compact, collate_compact_packed)
from moleculesde_tpu_torch.data.native_collate import native_pad_graphs

Batch = Union[GraphBatch, CompactBatch]


def _indexable(graphs):
    """``graphs`` itself when it is an indexable, sized dataset (a list, or
    a memory-mapped ``PackedGraphs`` that must not become millions of
    dicts), else its items as a list."""
    return (graphs if hasattr(graphs, "__getitem__") and hasattr(graphs, "__len__")
            else list(graphs))


def _atom_counts(graphs) -> np.ndarray:
    """Each molecule's atom count: a packed dataset's ``num_atoms`` (read
    off its offsets), else counted dict by dict."""
    if hasattr(graphs, "num_atoms"):
        return np.asarray(graphs.num_atoms)
    return np.array([np.asarray(g["atom_feats"]).shape[0] for g in graphs])


class GraphLoader:
    """Iterate ``(batch on the CPU, n_real_graphs)`` over graph dicts (any
    indexable, sized dataset of them, kept as it is): a
    :class:`GraphBatch` with ``collate="padded"``, a :class:`CompactBatch`
    with ``collate="compact"`` (``use_extend`` then tells the device
    whether to build the extended graph; a dataset with ``num_atoms``, a
    packed one, is gathered by :func:`collate_compact_packed`).
    ``collate_impl`` picks the padded collation: "native" (C++, the
    default) or "numpy"; both give the same bits.  ``quiet_drops`` leaves
    the drop message to a parent loader (:class:`BucketedGraphLoader`).  ``num_tasks`` / ``with_forces`` carry
    the labels; ``rotation_transform`` (padded batches only) rotates each
    molecule's positions by a random SO(3) matrix from the loader's
    generator, drawn as each batch is collated."""

    def __init__(self, graphs: Sequence[Dict], batch_size: int, n_max: int,
                 e_max: Optional[int] = None, ext_e_max: Optional[int] = None,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 collate: str = "padded", use_extend: bool = True,
                 collate_impl: str = "native", quiet_drops: bool = False,
                 num_tasks: Optional[int] = None, with_forces: bool = False,
                 rotation_transform: bool = False, block: Optional[Tuple[int, int]] = None):
        if block is not None and batch_size % block[1]:
            raise ValueError(f"--batch_size {batch_size} does not split into {block[1]} "
                             f"equal rank blocks")
        if collate not in ("padded", "compact"):
            raise ValueError(f"unknown collate {collate}")
        if collate_impl not in ("native", "numpy"):
            raise ValueError(f"unknown collate_impl {collate_impl}")
        if collate == "compact" and rotation_transform:
            raise NotImplementedError("rotation_transform is a padded-path option")
        self.collate_mode = collate
        self.collate_impl = collate_impl
        self.quiet_drops = quiet_drops
        self.use_extend = use_extend
        self.graphs = _indexable(graphs)
        self.batch_size = batch_size
        self.n_max = n_max
        self.e_max = e_max if e_max is not None else 4 * n_max
        self.ext_e_max = ext_e_max if ext_e_max is not None else n_max * n_max
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_tasks = num_tasks
        self.with_forces = with_forces
        self.rotation_transform = rotation_transform
        self.block = block
        self._rng = np.random.default_rng(seed)
        self._warned_truncate = False

    def __len__(self) -> int:
        n = len(self.graphs)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_indices(self) -> List[np.ndarray]:
        """One epoch's per-batch molecule indices (advances the shuffle)."""
        order = np.arange(len(self.graphs))
        if self.shuffle:
            order = self._rng.permutation(order)
        bs = self.batch_size
        dropped = len(self.graphs) - len(self) * bs if self.drop_last else 0
        if dropped > 0 and not self.quiet_drops:
            print(f"GraphLoader(n_max={self.n_max}): drop_last discards "
                  f"{dropped}/{len(self.graphs)} molecules this epoch")
        return [order[b * bs:(b + 1) * bs] for b in range(len(self))]

    def collate_indices(self, idx: np.ndarray) -> Tuple[Batch, int]:
        """One batch of dataset indices.  No loader state changes, so worker
        threads may call it, unless ``rotation_transform`` draws from the
        loader's generator.  With ``block`` the rank's block of the batch."""
        labels = dict(num_tasks=self.num_tasks, with_forces=self.with_forces)
        nb, chunk = self.batch_size, None
        if self.rotation_transform:   # every molecule's draw, the other ranks' too
            chunk = [self._rotate(self.graphs[i]) for i in idx]
        if self.block is not None:
            rank, world = self.block
            nb //= world
            idx = idx[rank * nb:(rank + 1) * nb]
            chunk = None if chunk is None else chunk[rank * nb:(rank + 1) * nb]
        if self.collate_mode == "compact":
            if hasattr(self.graphs, "num_atoms"):   # packed: gathers off the flat arrays
                return collate_compact_packed(
                    self.graphs, idx, n_max=self.n_max, e_max=self.e_max,
                    num_graphs=nb, use_extend=self.use_extend, **labels), len(idx)
            return collate_compact([self.graphs[i] for i in idx], n_max=self.n_max,
                                   e_max=self.e_max, num_graphs=nb,
                                   use_extend=self.use_extend, **labels), len(idx)
        if chunk is None:
            chunk = [self.graphs[i] for i in idx]
        self._check_budgets(chunk)
        pad = native_pad_graphs if self.collate_impl == "native" else pad_graphs
        return pad(chunk, n_max=self.n_max, e_max=self.e_max, ext_e_max=self.ext_e_max,
                   num_graphs=nb, **labels), len(chunk)

    def _rotate(self, g: Dict) -> Dict:
        """``g`` with its positions turned by a random rotation: the Q of a
        QR of a normal draw, signs fixed by R's diagonal and det +1 (the
        reference's ``use_rotation_transform``, dataset_QM9.py:138-139)."""
        if g.get("positions") is None:
            return g
        q, r = np.linalg.qr(self._rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        return {**g, "positions": np.asarray(g["positions"], np.float32)
                @ q.T.astype(np.float32)}

    def __iter__(self) -> Iterator[Tuple[Batch, int]]:
        for idx in self.epoch_indices():
            yield self.collate_indices(idx)

    def _check_budgets(self, chunk) -> None:
        """Warn once when molecules exceed the padding budgets and will be
        cut by the collation."""
        if self._warned_truncate:
            return
        n_over = sum(np.asarray(g["atom_feats"]).shape[0] > self.n_max for g in chunk)
        e_over = sum(np.asarray(g.get("edge_index", np.zeros((2, 0)))).shape[-1] > self.e_max
                     for g in chunk)
        x_over = sum(g.get("ext_edge_index") is not None
                     and np.asarray(g["ext_edge_index"]).shape[-1] > self.ext_e_max
                     for g in chunk)
        if n_over or e_over or x_over:
            warnings.warn(f"GraphLoader: truncating molecules to the padding budget "
                          f"(atoms>{self.n_max}: {n_over}, bonds>{self.e_max}: {e_over}, "
                          f"ext-edges>{self.ext_e_max}: {x_over}); raise --n_max, "
                          f"--e_max_factor or --ext_e_max")
            self._warned_truncate = True


class BucketedGraphLoader:
    """Size buckets (JAX's ``BucketedGraphLoader``): each molecule goes to
    the smallest bucket that holds its atoms (larger ones to the largest,
    cut to it), each bucket is a padded :class:`GraphLoader` at n_max = the
    bucket, ``e_max = e_max_factor * b`` and ``ext_e_max = b * b``, and
    each epoch visits every bucket's batches in an order shuffled by
    ``default_rng(seed)``.  A packed dataset is bucketed on its
    ``num_atoms`` and each bucket holds a ``subset`` view of it.  Yields
    ``(GraphBatch, n_real)``; a step sees one shape per bucket.

    The buckets collate padded batches whatever ``--ingest`` says, as in
    JAX: molecules built without the extended graph (the compact ingest's
    host graphs) carry their bond graph in the extended-edge slots."""

    def __init__(self, graphs: Sequence[Dict], batch_size: int,
                 buckets: Sequence[int] = (16, 32, 64), e_max_factor: int = 4,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 num_tasks: Optional[int] = None, with_forces: bool = False,
                 block: Optional[Tuple[int, int]] = None):
        self.buckets = sorted(buckets)
        graphs = _indexable(graphs)
        slot = np.minimum(np.searchsorted(np.asarray(self.buckets), _atom_counts(graphs),
                                          side="left"), len(self.buckets) - 1)
        self.loaders: List[Optional[GraphLoader]] = []
        for i, b in enumerate(self.buckets):
            idx = np.flatnonzero(slot == i)
            gs = (graphs.subset(idx) if hasattr(graphs, "subset")
                  else [graphs[j] for j in idx])
            self.loaders.append(GraphLoader(
                gs, batch_size=batch_size, n_max=b, e_max=e_max_factor * b, ext_e_max=b * b,
                shuffle=shuffle, drop_last=drop_last, seed=seed, quiet_drops=True,
                num_tasks=num_tasks, with_forces=with_forces, block=block)
                if len(gs) else None)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return sum(len(ld) for ld in self.loaders if ld is not None)

    def __iter__(self) -> Iterator[Tuple[GraphBatch, int]]:
        schedule, iters, dropped = [], [], []
        for i, ld in enumerate(self.loaders):
            iters.append(None if ld is None else iter(ld))
            if ld is None:
                continue
            schedule.extend([i] * len(ld))
            d = len(ld.graphs) - len(ld) * ld.batch_size if ld.drop_last else 0
            if d:
                dropped.append(f"bucket {ld.n_max}: {d}")
        if dropped:
            print("BucketedGraphLoader: drop_last discards " + ", ".join(dropped)
                  + " molecules this epoch")
        if self.shuffle:
            self._rng.shuffle(schedule)
        for i in schedule:
            yield next(iters[i])


class ThreadedLoader:
    """Collate ``loader``'s batches in ``num_workers`` threads, in the
    loader's order, with up to ``prefetch`` batches in flight (the JAX
    package's ``ThreadedLoader``; the reference's DataLoader workers).
    numpy's gathers release the GIL, so collation overlaps the training
    loop's launches."""

    def __init__(self, loader: GraphLoader, num_workers: int = 2,
                 prefetch: Optional[int] = None):
        if getattr(loader, "rotation_transform", False):
            raise NotImplementedError(
                "rotation_transform draws from the loader's generator; use num_workers=0")
        self.loader = loader
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch if prefetch is not None else 2 * self.num_workers

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Tuple[Batch, int]]:
        batches = iter(self.loader.epoch_indices())
        with ThreadPoolExecutor(self.num_workers) as ex:
            # range first: zip stops on it without drawing another batch
            futs = collections.deque(ex.submit(self.loader.collate_indices, idx)
                                     for _, idx in zip(range(self.prefetch), batches))
            while futs:
                yield futs.popleft().result()
                nxt = next(batches, None)
                if nxt is not None:
                    futs.append(ex.submit(self.loader.collate_indices, nxt))


def device_prefetch(iterator: Iterable[Tuple[Batch, int]], device: str | torch.device,
                    size: int = 2) -> Iterator[Tuple[Batch, int]]:
    """Move each ``(batch, n_real)`` to ``device`` up to ``size`` batches
    ahead of the consumer.  On a CUDA device the host batch is pinned and
    copied with ``non_blocking`` on the current stream: the copy overlaps
    the host's work, and the step that reads it is queued behind it on the
    same stream, so no synchronisation is needed."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    queue = collections.deque()
    for batch, n_real in iterator:
        if cuda:
            batch = batch.pin_memory().to(device, non_blocking=True)
        else:
            batch = batch.to(device)
        queue.append((batch, n_real))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def max_atoms(graphs: Sequence[Dict]) -> int:
    """The largest molecule's atom count (a packed dataset's read off its
    offsets)."""
    return int(_atom_counts(graphs).max())


def suggest_buckets(graphs: Sequence[Dict], candidates=(16, 32, 64, 128)) -> int:
    """The smallest of ``candidates`` that holds every molecule (else the
    largest molecule's size): ``--n_max 0``'s padding."""
    m = max_atoms(graphs)
    return next((c for c in candidates if m <= c), m)
