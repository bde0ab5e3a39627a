"""Packed flat-array molecule storage for pretraining-scale datasets.

A copy of ``moleculesde_tpu/data/packed.py`` with the same on-disk format,
so a cache written by either package loads in the other.  A whole dataset
is a handful of flat numpy arrays with per-molecule offsets (the layout the
reference reaches by collating everything into one InMemoryDataset blob,
reference Geom3D/datasets/dataset_PCQM4Mv2.py:45-77), stored as plain
``.npy`` files plus ``meta.json``, so a reload is an
``np.load(mmap_mode="r")`` away: seconds, no RAM spike, shared between
processes.  At PCQM4Mv2's 3.4M molecules a list of per-molecule dicts
would not fit in memory.

Dtypes are sized to molecular data: OGB categorical features, local bond
endpoints and extended-edge labels fit int16; offsets are int64.
``__getitem__`` returns the graph-dict view (zero-copy numpy slices) that
``core.batch.pad_graphs`` and the native collator read;
``data.compact.collate_compact_packed`` gathers compact batches straight
off the flat arrays.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

_META = "meta.json"
# array name -> (per-what, dtype, trailing shape)
_NODE_FIELDS = {
    "atom_feats": (np.int16, (9,)),
    "positions": (np.float32, (3,)),
    "forces": (np.float32, (3,)),
}
_EDGE_FIELDS = {
    "edge_index": (np.int16, (2,)),   # stored [E, 2] local endpoints
    "edge_feats": (np.int16, (3,)),
}
_EXT_FIELDS = {
    "ext_edge_index": (np.int16, (2,)),
    "ext_edge_attr": (np.int16, ()),
}


class PackedGraphs:
    """Flat-array dataset with per-molecule offsets.

    Indexing returns a graph dict of numpy views (no copies); ``subset``
    returns a lazy index view for bucketing/splitting without materializing
    per-molecule dicts.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], meta: Dict):
        self.arrays = arrays
        self.meta = meta
        self._n = int(meta["num_graphs"])

    # ------------------------------------------------------------------ build
    @classmethod
    def from_graphs(cls, graphs: Iterable[Dict]) -> "PackedGraphs":
        """Pack an iterable of graph dicts (streaming; holds only the packed
        arrays, never the dict list)."""
        chunks: Dict[str, List[np.ndarray]] = {}
        node_counts: List[int] = []
        edge_counts: List[int] = []
        ext_counts: List[int] = []
        ys: List[np.ndarray] = []
        fields_seen = set()
        n = 0

        def put(name, arr):
            chunks.setdefault(name, []).append(arr)

        for g in graphs:
            n += 1
            af = np.asarray(g["atom_feats"])
            if af.ndim == 1:  # atomic-number-only graphs (MD17)
                full = np.zeros((af.shape[0], 9), dtype=np.int16)
                full[:, 0] = af
                af = full
            node_counts.append(af.shape[0])
            put("atom_feats", af.astype(np.int16))
            for name in ("positions", "forces"):
                if g.get(name) is not None:
                    fields_seen.add(name)
                    put(name, np.asarray(g[name], np.float32))
            ei = np.asarray(g.get("edge_index", np.zeros((2, 0))), np.int16)
            edge_counts.append(ei.shape[1])
            put("edge_index", ei.T.copy())
            ef = np.asarray(g.get("edge_feats", np.zeros((0, 3))), np.int16)
            put("edge_feats", ef.reshape(-1, 3))
            if g.get("ext_edge_index") is not None:
                fields_seen.add("ext_edge_index")
                xi = np.asarray(g["ext_edge_index"], np.int16)
                ext_counts.append(xi.shape[1])
                put("ext_edge_index", xi.T.copy())
                xa = g.get("ext_edge_attr")
                xa = (np.asarray(xa, np.int16) if xa is not None
                      else np.zeros((xi.shape[1],), np.int16))
                put("ext_edge_attr", xa)
            else:
                ext_counts.append(0)
            if g.get("y") is not None:
                fields_seen.add("y")
                ys.append(np.asarray(g["y"], np.float32).reshape(-1))

        # positions/forces are sliced with the GLOBAL node offsets and y is
        # indexed by graph position in __getitem__; a field present on only a
        # subset of graphs would silently misalign every later molecule.
        # (ext_edge_index keeps its own per-graph offsets — absent graphs
        # record a 0 count — so mixed presence is safe there.)
        for name in ("positions", "forces"):
            if name in fields_seen and len(chunks.get(name, ())) != n:
                raise ValueError(
                    f"PackedGraphs.from_graphs: field '{name}' present on "
                    f"{len(chunks.get(name, ()))}/{n} graphs; packed storage "
                    f"requires all-or-none per field")
        if "y" in fields_seen and len(ys) != n:
            raise ValueError(
                f"PackedGraphs.from_graphs: field 'y' present on "
                f"{len(ys)}/{n} graphs; packed storage requires all-or-none "
                f"per field")
        arrays = {
            "node_offsets": _offsets(node_counts),
            "edge_offsets": _offsets(edge_counts),
            "ext_offsets": _offsets(ext_counts),
        }
        for name, parts in chunks.items():
            arrays[name] = (np.concatenate(parts, axis=0) if parts
                            else np.zeros((0,), np.int16))
        if ys:
            arrays["y"] = np.stack(ys)
        meta = {"num_graphs": n, "fields": sorted(fields_seen)}
        return cls(arrays, meta)

    # --------------------------------------------------------------------- io
    def save(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        for name, arr in self.arrays.items():
            np.save(os.path.join(dirpath, name + ".npy"), arr)
        with open(os.path.join(dirpath, _META), "w") as f:
            json.dump(self.meta, f)

    @classmethod
    def load(cls, dirpath: str, mmap: bool = True) -> "PackedGraphs":
        with open(os.path.join(dirpath, _META)) as f:
            meta = json.load(f)
        arrays = {}
        for fn in os.listdir(dirpath):
            if fn.endswith(".npy"):
                arrays[fn[:-4]] = np.load(
                    os.path.join(dirpath, fn),
                    mmap_mode="r" if mmap else None)
        return cls(arrays, meta)

    @staticmethod
    def exists(dirpath: str) -> bool:
        return os.path.exists(os.path.join(dirpath, _META))

    # ------------------------------------------------------------------ views
    def __len__(self) -> int:
        return self._n

    @property
    def num_atoms(self) -> np.ndarray:
        off = self.arrays["node_offsets"]
        return np.asarray(off[1:] - off[:-1])

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self.subset(np.arange(self._n)[i])
        if not 0 <= i < self._n:
            raise IndexError(i)
        a = self.arrays
        n0, n1 = a["node_offsets"][i], a["node_offsets"][i + 1]
        e0, e1 = a["edge_offsets"][i], a["edge_offsets"][i + 1]
        g: Dict[str, np.ndarray] = {
            "atom_feats": a["atom_feats"][n0:n1],
            "edge_index": a["edge_index"][e0:e1].T,
            "edge_feats": a["edge_feats"][e0:e1],
        }
        for name in ("positions", "forces"):
            if name in a:
                g[name] = a[name][n0:n1]
        if "ext_edge_index" in a:
            x0, x1 = a["ext_offsets"][i], a["ext_offsets"][i + 1]
            g["ext_edge_index"] = a["ext_edge_index"][x0:x1].T
            g["ext_edge_attr"] = a["ext_edge_attr"][x0:x1]
        if "y" in a:
            g["y"] = a["y"][i]
        return g

    def subset(self, indices: Sequence[int]) -> "PackedSubset":
        return PackedSubset(self, np.asarray(indices, np.int64))


class PackedSubset:
    """Lazy index view over a PackedGraphs (for splits/buckets)."""

    def __init__(self, packed: PackedGraphs, indices: np.ndarray):
        self.packed = packed
        self.indices = indices

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PackedSubset(self.packed, self.indices[i])
        return self.packed[int(self.indices[i])]

    @property
    def num_atoms(self) -> np.ndarray:
        return self.packed.num_atoms[self.indices]


def _offsets(counts: List[int]) -> np.ndarray:
    out = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=out[1:])
    return out


def pack_or_load(cache_dir: Optional[str], build_fn) -> PackedGraphs:
    """Load the packed cache if present, else build from ``build_fn()``
    (an iterable of graph dicts) and save it."""
    if cache_dir and PackedGraphs.exists(cache_dir):
        return PackedGraphs.load(cache_dir)
    packed = PackedGraphs.from_graphs(build_fn())
    if cache_dir:
        packed.save(cache_dir)
        return PackedGraphs.load(cache_dir)  # reopen memory-mapped
    return packed
