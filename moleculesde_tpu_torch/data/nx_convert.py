"""Graph-dict <-> networkx converters (host utilities, numpy only).

A copy of ``moleculesde_tpu/data/nx_convert.py``, the reference's
nx <-> PyG converters (reference Geom3D/datasets/dataset_utils.py:214-296):
node attribute ``atom_features`` carries the 9 OGB atom features, edge
attribute ``bond_features`` the 3 bond features, node attribute
``position`` the conformer.  networkx is imported inside the functions;
they serve inspection and interchange, not the training path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def graph_to_nx(graph: Dict):
    """An undirected ``networkx.Graph`` of a graph dict (each bond once)."""
    import networkx as nx

    g = nx.Graph()
    atom_feats = np.asarray(graph["atom_feats"])
    if atom_feats.ndim == 1:
        atom_feats = atom_feats[:, None]
    for i in range(atom_feats.shape[0]):
        g.add_node(i, atom_features=atom_feats[i].tolist())
    ei = np.asarray(graph.get("edge_index", np.zeros((2, 0), np.int32)))
    ef = np.asarray(graph.get("edge_feats", np.zeros((ei.shape[1], 3), np.int32)))
    for k in range(ei.shape[1]):
        s, d = int(ei[0, k]), int(ei[1, k])
        if not g.has_edge(s, d):
            g.add_edge(s, d, bond_features=ef[k].tolist())
    if "positions" in graph and graph["positions"] is not None:
        pos = np.asarray(graph["positions"])
        for i in range(pos.shape[0]):
            g.nodes[i]["position"] = pos[i].tolist()
    return g


def nx_to_graph(g) -> Dict:
    """A graph dict of a ``networkx.Graph`` (both directions of each
    edge)."""
    n = g.number_of_nodes()
    atom_feats = np.zeros((n, 9), dtype=np.int32)
    positions = None
    for i, data in g.nodes(data=True):
        feats = np.asarray(data.get("atom_features", [0] * 9), dtype=np.int32)
        atom_feats[i, : len(feats)] = feats[:9]
        if "position" in data:
            if positions is None:
                positions = np.zeros((n, 3), dtype=np.float32)
            positions[i] = data["position"]
    src, dst, ef = [], [], []
    for s, d, data in g.edges(data=True):
        f = np.asarray(data.get("bond_features", [0, 0, 0]), dtype=np.int32)[:3]
        src += [s, d]
        dst += [d, s]
        ef += [f, f]
    out = {
        "atom_feats": atom_feats,
        "edge_index": np.array([src, dst], dtype=np.int32).reshape(2, -1),
        "edge_feats": np.asarray(ef, dtype=np.int32).reshape(-1, 3),
    }
    if positions is not None:
        out["positions"] = positions
    return out
