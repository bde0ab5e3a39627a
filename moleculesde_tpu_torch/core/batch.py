"""Padded, statically shaped molecular graph batches as torch tensors.

Counterpart of ``moleculesde_tpu/core/batch.py``.  Every molecule is padded
to ``n_max`` atoms and fixed edge budgets; node ``i`` of graph ``b`` lives at
flat index ``b * n_max + i`` (node-major by graph), so a dense ``[B, n_max,
...]`` view is a free reshape.  Padded bond edges point at node 0 with their
mask False, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

# OGB categorical atom / bond feature cardinalities
# (ogb/utils/features.py get_atom_feature_dims / get_bond_feature_dims).
NUM_ATOM_FEATURES = 9
NUM_BOND_FEATURES = 3
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)
NUM_ATOM_CLASSES = 119


@dataclasses.dataclass
class GraphBatch:
    """A batch of ``num_graphs`` molecules padded to ``n_max`` atoms.

    Tensor fields (``N = num_graphs * n_max``): ``atom_feats`` [N, 9] int32,
    ``node_mask`` [N] bool, ``positions`` [N, 3] float32, ``edge_src`` /
    ``edge_dst`` [E] int32 flat node indices (padded edges point at node 0),
    ``edge_feats`` [E, 3] int32, ``edge_mask`` [E] bool, and the extended
    (1-4 hop) graph ``ext_src`` / ``ext_dst`` / ``ext_attr`` / ``ext_mask``.
    The compact ingest path (``data/compact.py::expand_on_device``) also
    sets the extended graph in dense form, ``ext_dense_mask`` [B, N, N]
    bool and ``ext_dense_attr`` [B, N, N] int32, which the 2D->3D model
    then reads instead of scattering the ``ext_*`` lists.  The finetunes'
    labels ride along: ``y`` [B, T] float32 graph labels and ``forces``
    [N, 3] float32 per-atom forces (MD17), None where a batch has none.
    """

    atom_feats: torch.Tensor
    node_mask: torch.Tensor
    positions: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_feats: torch.Tensor
    edge_mask: torch.Tensor
    ext_src: torch.Tensor
    ext_dst: torch.Tensor
    ext_attr: torch.Tensor
    ext_mask: torch.Tensor
    ext_dense_mask: Optional[torch.Tensor] = None
    ext_dense_attr: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None
    forces: Optional[torch.Tensor] = None
    num_graphs: int = 1
    n_max: int = 32

    @property
    def num_nodes(self) -> int:
        return self.num_graphs * self.n_max

    @property
    def device(self) -> torch.device:
        return self.node_mask.device

    def to(self, device: str | torch.device, non_blocking: bool = False) -> "GraphBatch":
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return GraphBatch(**{k: v.to(device, non_blocking=non_blocking)
                             if torch.is_tensor(v) else v for k, v in fields.items()})

    def pin_memory(self) -> "GraphBatch":
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return GraphBatch(**{k: v.pin_memory() if torch.is_tensor(v) else v
                             for k, v in fields.items()})

    def node2graph(self) -> torch.Tensor:
        """Graph id of every flat node slot, ``[N]`` int64."""
        return node2graph_ids(self.num_graphs, self.n_max, self.device, torch.long)

    @property
    def atomic_numbers(self) -> torch.Tensor:
        """119-class atomic-number index (atomic number - 1), ``[N]``."""
        return self.atom_feats[:, 0]

    def nodes_per_graph(self) -> torch.Tensor:
        """Number of real atoms per graph, ``[num_graphs]``."""
        return self.node_mask.reshape(self.num_graphs, self.n_max).sum(dim=1)

    def dense_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """Flat per-node data ``[N, ...]`` as dense ``[B, n_max, ...]``."""
        return x.reshape((self.num_graphs, self.n_max) + tuple(x.shape[1:]))

    def dense_adjacency(self, edge_values: torch.Tensor) -> torch.Tensor:
        """Per-bond values scattered into a dense ``[B, n_max, n_max]``
        adjacency (PyG ``to_dense_adj`` with scalar edge attributes); padded
        edges are dropped."""
        return dense_scatter(self.edge_src, self.edge_dst, self.edge_mask, edge_values,
                             self.num_graphs, self.n_max)


def node2graph_ids(num_graphs: int, n_max: int, device: str | torch.device | None = None,
                   dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Graph id of every flat node slot of a batch of ``num_graphs``
    molecules padded to ``n_max``, ``[num_graphs * n_max]`` (int32, as
    JAX's)."""
    return torch.arange(num_graphs, dtype=dtype, device=device).repeat_interleave(n_max)


def dense_scatter(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                  values: torch.Tensor, num_graphs: int, n_max: int) -> torch.Tensor:
    """``out[b, s, d] = value`` of each edge whose mask is set, from flat
    endpoints ``b * n_max + s`` / ``b * n_max + d``; zero elsewhere.  Masked
    edges land in a spare slot that is cut off, so no device-to-host sync
    (a boolean index would need one)."""
    n = n_max
    src, dst = src.long(), dst.long()
    cells = num_graphs * n * n
    flat = torch.where(mask, (src // n) * (n * n) + (src % n) * n + dst % n,
                       torch.full((), cells, dtype=torch.long, device=src.device))
    out = torch.zeros(cells + 1, dtype=values.dtype, device=values.device)
    out[flat] = values
    return out[:cells].reshape(num_graphs, n, n)


def pad_graphs(
    graphs: Sequence[Mapping[str, Any]],
    n_max: int,
    e_max: int,
    ext_e_max: Optional[int] = None,
    num_graphs: Optional[int] = None,
    num_tasks: Optional[int] = None,
    with_forces: bool = False,
) -> GraphBatch:
    """Collate numpy graph dicts into one padded ``GraphBatch`` (host side).

    Each dict holds ``atom_feats [n, 9]``, ``edge_index [2, e]``,
    ``edge_feats [e, 3]`` and optionally ``positions [n, 3]``,
    ``ext_edge_index [2, ee]``, ``ext_edge_attr [ee]``, ``y [T]`` and
    ``forces [n, 3]``.  Atoms beyond ``n_max`` and edges beyond the budgets
    are dropped.  Without an extended graph the ext fields alias the bond
    graph with label ``bond type + 1``.  With ``num_tasks`` the batch
    carries ``y`` [B, num_tasks] (each graph's first ``num_tasks`` labels;
    padded graphs and graphs without labels 0 on every task), with
    ``with_forces`` ``forces`` [B * n_max, 3] (zero on padded atoms).
    Returns CPU tensors; move the batch with ``.to(device)``.
    """
    b = num_graphs if num_graphs is not None else len(graphs)
    if len(graphs) > b:
        raise ValueError(f"{len(graphs)} graphs do not fit num_graphs={b}")
    if ext_e_max is None:
        ext_e_max = e_max

    atom_feats = np.zeros((b * n_max, NUM_ATOM_FEATURES), dtype=np.int32)
    node_mask = np.zeros((b * n_max,), dtype=bool)
    positions = np.zeros((b * n_max, 3), dtype=np.float32)
    edge_src = np.zeros((b * e_max,), dtype=np.int32)
    edge_dst = np.zeros((b * e_max,), dtype=np.int32)
    edge_feats = np.zeros((b * e_max, NUM_BOND_FEATURES), dtype=np.int32)
    edge_mask = np.zeros((b * e_max,), dtype=bool)
    ext_src = np.zeros((b * ext_e_max,), dtype=np.int32)
    ext_dst = np.zeros((b * ext_e_max,), dtype=np.int32)
    ext_attr = np.zeros((b * ext_e_max,), dtype=np.int32)
    ext_mask = np.zeros((b * ext_e_max,), dtype=bool)
    y = np.zeros((b, num_tasks), dtype=np.float32) if num_tasks is not None else None
    forces = np.zeros((b * n_max, 3), dtype=np.float32) if with_forces else None

    for g_idx, g in enumerate(graphs):
        af = np.asarray(g["atom_feats"], dtype=np.int32)
        if af.ndim == 1:  # atomic-number-only graphs
            full = np.zeros((af.shape[0], NUM_ATOM_FEATURES), dtype=np.int32)
            full[:, 0] = af
            af = full
        n = min(af.shape[0], n_max)
        base = g_idx * n_max
        atom_feats[base : base + n] = af[:n]
        node_mask[base : base + n] = True
        if g.get("positions") is not None:
            positions[base : base + n] = np.asarray(g["positions"], np.float32)[:n]
        if forces is not None and g.get("forces") is not None:
            forces[base : base + n] = np.asarray(g["forces"], np.float32)[:n]
        if y is not None and g.get("y") is not None:
            y[g_idx] = np.asarray(g["y"], np.float32).reshape(-1)[:num_tasks]

        def fill(src_arr, dst_arr, attr_arr, mask_arr, eidx, eattr, budget):
            ei = np.asarray(eidx, dtype=np.int32)
            if not ei.size:
                return
            keep = np.flatnonzero((ei[0] < n) & (ei[1] < n))[:budget]
            e = len(keep)
            ebase = g_idx * budget
            src_arr[ebase : ebase + e] = ei[0, keep] + base
            dst_arr[ebase : ebase + e] = ei[1, keep] + base
            mask_arr[ebase : ebase + e] = True
            if eattr is not None:
                attr_arr[ebase : ebase + e] = np.asarray(eattr)[keep]

        edge_index = g.get("edge_index", np.zeros((2, 0)))
        fill(edge_src, edge_dst, edge_feats, edge_mask, edge_index,
             g.get("edge_feats"), e_max)
        if g.get("ext_edge_index") is not None:
            fill(ext_src, ext_dst, ext_attr, ext_mask, g["ext_edge_index"],
                 g.get("ext_edge_attr"), ext_e_max)
        else:
            ea = np.asarray(g.get("edge_feats", np.zeros((0, 3))), dtype=np.int32)
            fill(ext_src, ext_dst, ext_attr, ext_mask, edge_index,
                 ea[:, 0] + 1 if ea.size else None, ext_e_max)

    t = torch.from_numpy
    return GraphBatch(
        atom_feats=t(atom_feats), node_mask=t(node_mask),
        positions=t(positions), edge_src=t(edge_src), edge_dst=t(edge_dst),
        edge_feats=t(edge_feats), edge_mask=t(edge_mask),
        ext_src=t(ext_src), ext_dst=t(ext_dst), ext_attr=t(ext_attr),
        ext_mask=t(ext_mask), y=None if y is None else t(y),
        forces=None if forces is None else t(forces), num_graphs=b, n_max=n_max)
