"""Synthetic molecules for tests, smoke runs and benchmarks (host numpy).

A copy of the generator in ``moleculesde_tpu/data/synthetic.py``: from the
same ``numpy.random.Generator`` state it draws the same molecules (OGB
categorical features, bonds in both directions, centred conformers, 1-4 hop
extended edges), padded (:func:`synthetic_batch`) or compact
(:func:`synthetic_compact_batch`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from moleculesde_tpu_torch.core.batch import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    GraphBatch,
    pad_graphs,
)
from moleculesde_tpu_torch.data.extend import extend_graph


def relax_positions(
    pos: np.ndarray,
    edge_index: np.ndarray,
    n_iter: int = 120,
    bond_len: float = 1.5,
    lr: float = 0.05,
    rep_dist: float = 2.0,
) -> np.ndarray:
    """Spring-relax a conformer against its full bond topology: bonded pairs
    pull toward ``bond_len``, non-bonded pairs closer than ``rep_dist`` push
    apart, so geometry carries the graph."""
    n = pos.shape[0]
    if n < 2:
        return pos
    bonded = np.zeros((n, n), dtype=bool)
    bonded[edge_index[0], edge_index[1]] = True
    nonbonded = ~bonded & ~np.eye(n, dtype=bool)
    for _ in range(n_iter):
        d = pos[:, None] - pos[None, :]
        r = np.sqrt((d * d).sum(-1)) + 1e-9
        coef = np.where(bonded, (bond_len - r) / r, 0.0)
        coef += np.where(nonbonded & (r < rep_dist),
                         0.5 * (rep_dist - r) / r, 0.0)
        pos = pos + lr * (coef[..., None] * d).sum(axis=1)
    return (pos - pos.mean(axis=0, keepdims=True)).astype(np.float32)


def random_molecule(
    rng: np.random.Generator,
    n_atoms: int,
    extend: bool = True,
    with_positions: bool = True,
    geometric: bool = False,
) -> dict:
    """A random chain-plus-chords molecule dict (both-direction bond lists).

    ``geometric=True`` seeds the chain as a random walk of ~1.5-length steps
    and spring-relaxes it (:func:`relax_positions`)."""
    atom_feats = np.stack(
        [rng.integers(0, d, size=n_atoms) for d in ATOM_FEATURE_DIMS], axis=1
    ).astype(np.int32)
    pairs = {(i, i + 1) for i in range(n_atoms - 1)}
    for _ in range(max(0, n_atoms // 3)):
        i, j = rng.integers(0, n_atoms, 2)
        if i != j:
            pairs.add((min(i, j), max(i, j)))
    src, dst = [], []
    for i, j in sorted(pairs):
        src += [i, j]
        dst += [j, i]
    edge_index = np.array([src, dst], dtype=np.int32)
    n_edges = edge_index.shape[1]
    edge_feats = np.stack(
        [rng.integers(0, d, size=n_edges // 2) for d in BOND_FEATURE_DIMS], axis=1
    ).astype(np.int32)
    edge_feats = np.repeat(edge_feats, 2, axis=0)  # same feature both directions

    g = {"atom_feats": atom_feats, "edge_index": edge_index, "edge_feats": edge_feats}
    if with_positions:
        if geometric:
            steps = rng.normal(size=(n_atoms, 3))
            steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
            pos = np.cumsum(1.5 * steps, axis=0).astype(np.float32)
            pos = relax_positions(pos, edge_index)
        else:
            pos = rng.normal(size=(n_atoms, 3)).astype(np.float32) * 1.5
        g["positions"] = pos - pos.mean(axis=0, keepdims=True)
    if extend:
        ext_index, ext_attr = extend_graph(n_atoms, edge_index, edge_feats)
        g["ext_edge_index"] = ext_index
        g["ext_edge_attr"] = ext_attr
    return g


def synthetic_batch(
    num_graphs: int = 8,
    n_max: int = 16,
    e_max: Optional[int] = None,
    ext_e_max: Optional[int] = None,
    min_atoms: int = 4,
    seed: int = 0,
    extend: bool = True,
) -> GraphBatch:
    """``num_graphs`` random molecules of ``min_atoms..n_max`` atoms, padded."""
    rng = np.random.default_rng(seed)
    graphs: List[dict] = []
    for _ in range(num_graphs):
        n = int(rng.integers(min_atoms, n_max + 1))
        graphs.append(random_molecule(rng, n, extend=extend))
    return pad_graphs(
        graphs, n_max=n_max,
        e_max=e_max if e_max is not None else 4 * n_max,
        ext_e_max=ext_e_max if ext_e_max is not None else n_max * n_max)


def synthetic_compact_batch(num_graphs: int = 8, n_max: int = 16, e_max: Optional[int] = None,
                            min_atoms: int = 4, seed: int = 0,
                            num_tasks: Optional[int] = None, with_forces: bool = False):
    """The molecules of :func:`synthetic_batch` (with ``y`` [num_tasks] and
    ``forces`` drawn after each when asked), collated compact, as the
    pretraining CLI feeds its step: a
    :class:`~moleculesde_tpu_torch.data.compact.CompactBatch` on the CPU."""
    from moleculesde_tpu_torch.data.compact import collate_compact

    rng = np.random.default_rng(seed)
    graphs: List[dict] = []
    for _ in range(num_graphs):
        n = int(rng.integers(min_atoms, n_max + 1))
        g = random_molecule(rng, n, extend=False)
        if num_tasks is not None:
            g["y"] = rng.normal(size=(num_tasks,)).astype(np.float32)
        if with_forces:
            g["forces"] = rng.normal(size=(n, 3)).astype(np.float32)
        graphs.append(g)
    return collate_compact(graphs, n_max=n_max,
                           e_max=e_max if e_max is not None else 4 * n_max,
                           num_tasks=num_tasks, with_forces=with_forces)
