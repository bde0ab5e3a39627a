"""BFS subgraph masking for SSL (host side, numpy only).

A copy of ``moleculesde_tpu/data/masking.py``, the reference's
``Molecule3DDataset.subgraph`` masking (reference
Geom3D/datasets/dataset_3D.py:53-104): grow a BFS region from a random
seed atom until ``1 - mask_ratio`` of the atoms are covered, and mark the
rest as masked atoms.  The reference exposes it through ``mask_ratio`` /
``SSL_masking_ratio`` (config.py:95) for its masking objectives; here it
returns explicit index arrays, from the same generator draws as JAX's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def bfs_subgraph_mask(
    n_atoms: int,
    edge_index: np.ndarray,
    mask_ratio: float,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (kept_indices, masked_indices).

    ``kept`` is a BFS-grown connected region of ~``(1 - mask_ratio) * n``
    atoms starting from a random seed; when the frontier empties before the
    quota is filled, a new random unvisited seed is drawn (matching the
    reference's restart behavior, dataset_3D.py:66-77).
    """
    sub_num = int(n_atoms * (1 - mask_ratio))
    adj = [[] for _ in range(n_atoms)]
    if edge_index.size:
        for s, d in zip(edge_index[0], edge_index[1]):
            adj[int(s)].append(int(d))

    visited = np.zeros(n_atoms, dtype=bool)
    order = []
    frontier = [int(rng.integers(n_atoms))]
    while len(order) < sub_num:
        if not frontier:
            remaining = np.flatnonzero(~visited)
            if remaining.size == 0:
                break
            frontier = [int(rng.choice(remaining))]
        node = frontier.pop(0)
        if visited[node]:
            continue
        visited[node] = True
        order.append(node)
        frontier.extend(n for n in adj[node] if not visited[n])

    kept = np.array(sorted(order), dtype=np.int32)
    masked = np.setdiff1d(np.arange(n_atoms, dtype=np.int32), kept)
    return kept, masked


def apply_subgraph_mask(graph: Dict, mask_ratio: float, seed: int = 0) -> Dict:
    """Attach ``masked_atom_indices`` (padded consumers read it with the node
    mask) without mutating the input graph dict."""
    rng = np.random.default_rng(seed)
    n = int(np.asarray(graph["atom_feats"]).shape[0])
    kept, masked = bfs_subgraph_mask(
        n, np.asarray(graph.get("edge_index", np.zeros((2, 0)))), mask_ratio, rng)
    out = dict(graph)
    out["masked_atom_indices"] = masked
    return out
