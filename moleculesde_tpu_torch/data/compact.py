"""Compact host batches, expanded into full batches on the device.

Counterpart of ``moleculesde_tpu/data/compact.py`` (``--ingest compact``,
the JAX CLI's default).  The host collates only the facts of each molecule:
int16 atom features, f32 positions, int16 graph-local bond endpoints and
features, padded per graph to static shapes.  The device then rebuilds what
the models read (:func:`expand_on_device`): the flat global bond lists for
GIN, the dense bond adjacency with its bond-type labels, and the 4-hop
extended graph as dense ``[B, N, N]`` boolean matrix powers
(:func:`dense_extend`; reference Geom3D/datasets/dataset_3D.py:11-34, the
host form in ``data/extend.py``).  The host never builds the extended
graph, and the batch it copies to the device is about a tenth of the
padded one.  :func:`collate_compact` collates graph dicts;
:func:`collate_compact_packed` gathers the same batch straight off the flat
arrays of :class:`~moleculesde_tpu_torch.data.packed.PackedGraphs`, a few
vectorized numpy gathers per batch and no per-molecule Python object.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from moleculesde_tpu_torch.core.batch import NUM_ATOM_FEATURES, NUM_BOND_FEATURES, GraphBatch


@dataclasses.dataclass
class CompactBatch:
    """A statically shaped compact batch (``B = num_graphs``):

    - ``atom_feats`` [B, n_max, 9] int16 (zero rows past each molecule);
    - ``positions`` [B, n_max, 3] float32;
    - ``n_atoms`` [B] int32 (a molecule's atoms are rows ``0 .. n - 1``);
    - ``edge_index`` [B, e_max, 2] int16 graph-local bond endpoints;
    - ``edge_feats`` [B, e_max, 3] int16 OGB bond features;
    - ``edge_valid`` [B, e_max] bool; valid bonds need not be contiguous
      (:func:`collate_compact_packed` drops bonds in place), and
      :func:`expand_on_device` takes the mask per bond;
    - ``y`` [B, T] float32 graph labels and ``forces`` [B, n_max, 3]
      float32, or None.
    """

    atom_feats: torch.Tensor
    positions: torch.Tensor
    n_atoms: torch.Tensor
    edge_index: torch.Tensor
    edge_feats: torch.Tensor
    edge_valid: torch.Tensor
    y: Optional[torch.Tensor] = None
    forces: Optional[torch.Tensor] = None
    num_graphs: int = 1
    n_max: int = 32
    e_max: int = 128
    use_extend: bool = True

    @property
    def num_nodes(self) -> int:
        """Node slots of the expanded batch, ``num_graphs * n_max``."""
        return self.num_graphs * self.n_max

    def _map(self, fn) -> "CompactBatch":
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    def to(self, device: str | torch.device, non_blocking: bool = False) -> "CompactBatch":
        return self._map(lambda v: v.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "CompactBatch":
        return self._map(lambda v: v.pin_memory())


def dense_extend(adj: torch.Tensor, bond_type: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 4-hop extension of dense bond graphs ``adj`` [B, N, N] bool with
    labels ``bond_type`` [B, N, N] int32 (OGB bond type + 1 on bonds):
    two rounds of boolean squaring minus self-loops give the mask; labels
    are the bond label on bonds and ``10 + hop`` (BFS hops 2-4) on shortcut
    edges, 0 elsewhere.  The boolean powers are f32 ``bmm``s, exact for
    these counts (at most N^3 walks)."""
    n = adj.shape[-1]
    off = ~torch.eye(n, dtype=torch.bool, device=adj.device)[None]
    a = adj & off
    af = a.float()
    b1 = (a | (torch.matmul(af, af) > 0)) & off
    b1f = b1.float()
    b2 = (b1 | (torch.matmul(b1f, b1f) > 0)) & off
    hop = a.int()
    reach, cur = a, af
    for k in range(2, 5):
        cur = torch.matmul(cur, af)
        new = (cur > 0) & ~reach & off
        hop = torch.where(new & b2, k, hop)
        reach = reach | new
    attr = torch.where(hop == 1, bond_type.int(), 10 + hop)
    return b2, torch.where(b2, attr, 0).int()


def expand_on_device(cb: CompactBatch) -> GraphBatch:
    """A :class:`GraphBatch` from a compact batch, as torch operations on
    the batch's device.  The bond lists become flat global lists (invalid
    bonds point at node 0, masked); the dense adjacency and its labels come
    from one-hot products over the per-graph bond lists (a bond listed
    twice takes the mean of its labels, as a scatter-set of equal values
    would), and from them the extended graph in dense form
    (``ext_dense_mask`` / ``ext_dense_attr``; only the bond graph without
    ``use_extend``).  The list-form ``ext_*`` fields alias the bond graph."""
    b, n, e = cb.num_graphs, cb.n_max, cb.e_max
    dev = cb.positions.device
    node_mask = (torch.arange(n, device=dev) < cb.n_atoms[:, None]).reshape(b * n)
    atom_feats = cb.atom_feats.int().reshape(b * n, NUM_ATOM_FEATURES)
    positions = cb.positions.reshape(b * n, 3)

    valid = cb.edge_valid
    # invalid bonds hold index 0 from the collation; where() keeps one_hot's
    # indices in range whatever they hold, the multiply drops them
    s_l = torch.where(valid, cb.edge_index[..., 0].int(), 0)
    d_l = torch.where(valid, cb.edge_index[..., 1].int(), 0)
    base = (torch.arange(b, dtype=torch.int32, device=dev) * n)[:, None]
    edge_src = torch.where(valid, s_l + base, 0).reshape(b * e)
    edge_dst = torch.where(valid, d_l + base, 0).reshape(b * e)
    edge_feats = torch.where(valid[..., None], cb.edge_feats.int(), 0
                             ).reshape(b * e, NUM_BOND_FEATURES)
    edge_mask = valid.reshape(b * e)

    s_oh = F.one_hot(s_l.long(), n).float() * valid.float()[..., None]   # [B, e, n]
    d_oh = F.one_hot(d_l.long(), n).float()
    count = torch.bmm(s_oh.transpose(1, 2), d_oh)
    adj = count > 0
    val = cb.edge_feats[..., 0].float() + 1.0
    vsum = torch.bmm((s_oh * val[..., None]).transpose(1, 2), d_oh)
    btype = torch.where(adj, vsum / count.clamp(min=1.0) + 0.5, 0.0).int()
    if cb.use_extend:
        ext_dense_mask, ext_dense_attr = dense_extend(adj, btype)
    else:
        ext_dense_mask, ext_dense_attr = adj, torch.where(adj, btype, 0)

    return GraphBatch(
        atom_feats=atom_feats, node_mask=node_mask, positions=positions,
        edge_src=edge_src, edge_dst=edge_dst, edge_feats=edge_feats, edge_mask=edge_mask,
        ext_src=edge_src, ext_dst=edge_dst,
        ext_attr=torch.where(edge_mask, edge_feats[:, 0] + 1, 0), ext_mask=edge_mask,
        ext_dense_mask=ext_dense_mask, ext_dense_attr=ext_dense_attr, y=cb.y,
        forces=None if cb.forces is None else cb.forces.reshape(b * n, 3),
        num_graphs=b, n_max=n)


def collate_compact(graphs: Sequence[Mapping[str, Any]], n_max: int, e_max: int,
                    num_graphs: Optional[int] = None, use_extend: bool = True,
                    num_tasks: Optional[int] = None, with_forces: bool = False
                    ) -> CompactBatch:
    """Collate graph dicts into a compact batch on the host (CPU tensors),
    truncating as ``core.batch.pad_graphs`` does: atoms past ``n_max`` are
    dropped, and so are bonds that touch them and bonds past ``e_max``; the
    kept bonds fill each graph's first slots.  ``num_tasks`` (when not 0)
    and ``with_forces`` carry the labels as JAX's ``collate_compact`` does:
    a graph's labels fill the first entries of its row of ``y``."""
    b = num_graphs if num_graphs is not None else len(graphs)
    if len(graphs) > b:
        raise ValueError(f"{len(graphs)} graphs do not fit num_graphs={b}")
    atom = np.zeros((b, n_max, NUM_ATOM_FEATURES), dtype=np.int16)
    pos = np.zeros((b, n_max, 3), dtype=np.float32)
    cnt = np.zeros((b,), dtype=np.int32)
    ei = np.zeros((b, e_max, 2), dtype=np.int16)
    ef = np.zeros((b, e_max, NUM_BOND_FEATURES), dtype=np.int16)
    ev = np.zeros((b, e_max), dtype=bool)
    y = np.zeros((b, num_tasks), dtype=np.float32) if num_tasks else None
    forces = np.zeros((b, n_max, 3), dtype=np.float32) if with_forces else None
    for gi, g in enumerate(graphs):
        af = np.asarray(g["atom_feats"])
        if af.ndim == 1:   # atomic-number-only graphs
            full = np.zeros((af.shape[0], NUM_ATOM_FEATURES), np.int16)
            full[:, 0] = af
            af = full
        n = min(af.shape[0], n_max)
        cnt[gi] = n
        atom[gi, :n] = af[:n]
        if g.get("positions") is not None:
            pos[gi, :n] = np.asarray(g["positions"], np.float32)[:n]
        if forces is not None and g.get("forces") is not None:
            forces[gi, :n] = np.asarray(g["forces"], np.float32)[:n]
        if y is not None and g.get("y") is not None:
            yr = np.asarray(g["y"], np.float32).reshape(-1)
            y[gi, :yr.shape[0]] = yr[:num_tasks]
        e_idx = np.asarray(g.get("edge_index", np.zeros((2, 0))), np.int64)
        ne = e_idx.shape[1] if e_idx.size else 0
        if ne:
            keep = np.flatnonzero((e_idx[0] < n) & (e_idx[1] < n))[:e_max]
            k = len(keep)
            ei[gi, :k, 0] = e_idx[0, keep]
            ei[gi, :k, 1] = e_idx[1, keep]
            fe = np.asarray(g.get("edge_feats", np.zeros((ne, 3))), np.int16)
            ef[gi, :k] = fe.reshape(-1, NUM_BOND_FEATURES)[keep]
            ev[gi, :k] = True
    tt = torch.from_numpy
    return CompactBatch(atom_feats=tt(atom), positions=tt(pos), n_atoms=tt(cnt),
                        edge_index=tt(ei), edge_feats=tt(ef), edge_valid=tt(ev),
                        y=None if y is None else tt(y),
                        forces=None if forces is None else tt(forces), num_graphs=b,
                        n_max=n_max, e_max=e_max, use_extend=use_extend)


def collate_compact_packed(dataset, idx: np.ndarray, n_max: int, e_max: int,
                           num_graphs: Optional[int] = None, use_extend: bool = True,
                           num_tasks: Optional[int] = None, with_forces: bool = False
                           ) -> CompactBatch:
    """The compact batch of molecules ``idx`` of a ``PackedGraphs`` (or of
    a ``PackedSubset``, ``idx`` then indexing the subset), gathered off the
    flat arrays as JAX's ``collate_compact_packed`` does: atoms clipped at
    ``n_max``, each graph's first ``e_max`` bonds kept in their slots, and
    the bonds among them that touch a clipped atom dropped in place (their
    slots zero, ``edge_valid`` False), so the valid bonds need not be
    contiguous.  A graph's labels fill the first entries of its row of
    ``y``."""
    from moleculesde_tpu_torch.data.packed import PackedSubset

    if isinstance(dataset, PackedSubset):
        idx = dataset.indices[np.asarray(idx)]
        packed = dataset.packed
    else:
        idx = np.asarray(idx)
        packed = dataset
    a = packed.arrays
    b = num_graphs if num_graphs is not None else len(idx)
    nb = len(idx)
    if nb > b:
        raise ValueError(f"{nb} graphs do not fit num_graphs={b}")

    def ragged_gather(starts, counts):
        """(row, column, flat source) of every entry of a left-packed
        [nb, cap] layout holding ``counts`` entries a row."""
        rows = np.repeat(np.arange(nb), counts)
        cum = np.zeros(nb + 1, np.int64)
        np.cumsum(counts, out=cum[1:])
        cols = np.arange(int(cum[-1])) - np.repeat(cum[:-1], counts)
        return rows, cols, np.repeat(starts, counts) + cols

    no = np.asarray(a["node_offsets"])
    cnt = np.minimum(no[idx + 1] - no[idx], n_max).astype(np.int64)
    atom = np.zeros((b, n_max, NUM_ATOM_FEATURES), dtype=np.int16)
    pos = np.zeros((b, n_max, 3), dtype=np.float32)
    n_atoms = np.zeros((b,), dtype=np.int32)
    n_atoms[:nb] = cnt
    r, c, s = ragged_gather(no[idx], cnt)
    atom[r, c] = a["atom_feats"][s]
    if "positions" in a:
        pos[r, c] = a["positions"][s]
    forces = None
    if with_forces and "forces" in a:
        forces = np.zeros((b, n_max, 3), dtype=np.float32)
        forces[r, c] = a["forces"][s]

    eo = np.asarray(a["edge_offsets"])
    ecnt = np.minimum(eo[idx + 1] - eo[idx], e_max).astype(np.int64)
    ei = np.zeros((b, e_max, 2), dtype=np.int16)
    ef = np.zeros((b, e_max, NUM_BOND_FEATURES), dtype=np.int16)
    ev = np.zeros((b, e_max), dtype=bool)
    r, c, s = ragged_gather(eo[idx], ecnt)
    pair = a["edge_index"][s]   # [E, 2] graph-local endpoints
    ok = (pair[:, 0] < cnt[r]) & (pair[:, 1] < cnt[r])
    ei[r, c] = np.where(ok[:, None], pair, 0)
    ef[r, c] = np.where(ok[:, None], a["edge_feats"][s], 0)
    ev[r, c] = ok

    y = None
    if num_tasks:
        y = np.zeros((b, num_tasks), dtype=np.float32)
        if "y" in a:
            yv = np.asarray(a["y"][idx], np.float32)
            y[:nb, :yv.shape[1]] = yv[:, :num_tasks]
    tt = torch.from_numpy
    return CompactBatch(atom_feats=tt(atom), positions=tt(pos), n_atoms=tt(n_atoms),
                        edge_index=tt(ei), edge_feats=tt(ef), edge_valid=tt(ev),
                        y=None if y is None else tt(y),
                        forces=None if forces is None else tt(forces), num_graphs=b,
                        n_max=n_max, e_max=e_max, use_extend=use_extend)
