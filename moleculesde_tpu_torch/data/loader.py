"""Host batching: shuffle and fixed-shape padded collation.

Counterpart of ``moleculesde_tpu/data/loader.py::GraphLoader`` with the
padded collation only (``--ingest padded``).  Every batch has the same
shapes; with ``drop_last`` only full batches are produced, otherwise the
tail batch is padded with empty graphs.  The shuffle draws from
``numpy.random.default_rng(seed)``, so the same seed visits molecules in
the JAX package's order.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from moleculesde_tpu_torch.core.batch import GraphBatch, pad_graphs


class GraphLoader:
    """Iterate ``(GraphBatch on the CPU, n_real_graphs)`` over graph dicts."""

    def __init__(self, graphs: Sequence[Dict], batch_size: int, n_max: int,
                 e_max: Optional[int] = None, ext_e_max: Optional[int] = None,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.n_max = n_max
        self.e_max = e_max if e_max is not None else 4 * n_max
        self.ext_e_max = ext_e_max if ext_e_max is not None else n_max * n_max
        self.shuffle = shuffle
        self.drop_last = drop_last
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
        if dropped > 0:
            print(f"GraphLoader(n_max={self.n_max}): drop_last discards "
                  f"{dropped}/{len(self.graphs)} molecules this epoch")
        return [order[b * bs:(b + 1) * bs] for b in range(len(self))]

    def collate_indices(self, idx: np.ndarray) -> Tuple[GraphBatch, int]:
        chunk = [self.graphs[i] for i in idx]
        self._check_budgets(chunk)
        return pad_graphs(chunk, n_max=self.n_max, e_max=self.e_max,
                          ext_e_max=self.ext_e_max, num_graphs=self.batch_size), len(chunk)

    def __iter__(self) -> Iterator[Tuple[GraphBatch, int]]:
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
