"""Port parity: the numpy-only data modules of the data tail against the JAX
package, on the same seeded inputs.  All exact.

- ``bfs_subgraph_mask`` / ``apply_subgraph_mask`` give JAX's indices for a
  seed (a connected molecule, one in two pieces that forces a restart,
  ratios 0 to 1), and leave the input dict as it was.
- ``graph_to_nx`` / ``nx_to_graph`` give JAX's networkx graphs and dicts,
  and round-trip a molecule as JAX's do.
- ``synthetic_compact_batch`` equals JAX's array for array (labels and
  forces too); ``node2graph_ids`` equals JAX's, int32.
- ``smiles_to_graph_3d_mmff`` keeps the conformer JAX keeps (the lowest
  MMFF94s energy, the first of a tie) and falls back to ``Compute2DCoords``
  as JAX does, under a test-local fake ``rdkit`` set with ``monkeypatch``
  (chains of one-letter elements, seeded conformers, given energies).
"""

import sys
import types

import numpy as np
import pytest

import rdkit_stub

from moleculesde_tpu.core.batch import node2graph_ids as jax_node2graph_ids
from moleculesde_tpu.data import featurize as jax_featurize
from moleculesde_tpu.data import masking as jax_masking
from moleculesde_tpu.data import nx_convert as jax_nx
from moleculesde_tpu.data.synthetic import synthetic_compact_batch as jax_synthetic_compact
from moleculesde_tpu_torch.core.batch import node2graph_ids
from moleculesde_tpu_torch.data import featurize, masking, nx_convert
from moleculesde_tpu_torch.data.synthetic import random_molecule, synthetic_compact_batch

COMPACT_FIELDS = ("atom_feats", "positions", "n_atoms", "edge_index", "edge_feats",
                  "edge_valid", "y", "forces")


def _molecule(seed: int, n: int = 9, pieces: bool = False, atomic_only: bool = False):
    g = random_molecule(np.random.default_rng(seed), n, extend=False)
    if pieces:   # cut every bond between the first and the second half
        s, d = g["edge_index"]
        keep = (s < n // 2) == (d < n // 2)
        g["edge_index"], g["edge_feats"] = g["edge_index"][:, keep], g["edge_feats"][keep]
    if atomic_only:
        g["atom_feats"] = g["atom_feats"][:, 0]
    return g


@pytest.mark.parametrize("pieces", [False, True], ids=["connected", "two_pieces"])
@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.6, 1.0])
def test_bfs_subgraph_mask_matches_jax(pieces, ratio):
    for seed in range(3):
        g = _molecule(seed, n=11, pieces=pieces)
        mine = masking.bfs_subgraph_mask(11, g["edge_index"], ratio,
                                         np.random.default_rng(seed))
        theirs = jax_masking.bfs_subgraph_mask(11, g["edge_index"], ratio,
                                               np.random.default_rng(seed))
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert len(mine[0]) == int(11 * (1 - ratio))
        before = {k: v.copy() for k, v in g.items()}
        out = masking.apply_subgraph_mask(g, ratio, seed=seed)
        np.testing.assert_array_equal(out["masked_atom_indices"], jax_masking.apply_subgraph_mask(
            g, ratio, seed=seed)["masked_atom_indices"])
        assert "masked_atom_indices" not in g
        assert all(np.array_equal(g[k], before[k]) for k in before)


def _nx_data(g):
    return (sorted(g.nodes(data=True)), sorted((min(s, d), max(s, d), e["bond_features"])
                                              for s, d, e in g.edges(data=True)))


@pytest.mark.parametrize("kind", ["conformer", "no_positions", "atomic_numbers"])
def test_nx_conversion_round_trips_as_jax(kind):
    g = _molecule(4, atomic_only=kind == "atomic_numbers")
    if kind == "no_positions":
        del g["positions"]
    mine, theirs = nx_convert.graph_to_nx(g), jax_nx.graph_to_nx(g)
    assert _nx_data(mine) == _nx_data(theirs)
    back, jback = nx_convert.nx_to_graph(mine), jax_nx.nx_to_graph(theirs)
    assert sorted(back) == sorted(jback)
    for k in jback:
        assert back[k].dtype == jback[k].dtype, k
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
    if kind == "conformer":   # the round trip keeps the molecule
        np.testing.assert_array_equal(back["atom_feats"], g["atom_feats"])
        np.testing.assert_array_equal(back["positions"], g["positions"])
        assert {tuple(p) for p in back["edge_index"].T} == {tuple(p) for p in g["edge_index"].T}


@pytest.mark.parametrize("kw", [dict(), dict(num_graphs=5, n_max=8, e_max=12, min_atoms=6,
                                             seed=3, num_tasks=2, with_forces=True)],
                         ids=["defaults", "labels_clipped"])
def test_synthetic_compact_batch_matches_jax(kw):
    mine, theirs = synthetic_compact_batch(**kw), jax_synthetic_compact(**kw)
    for f in COMPACT_FIELDS:
        a, b = getattr(mine, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert (mine.num_graphs, mine.n_max, mine.e_max) == (
        theirs.num_graphs, theirs.n_max, theirs.e_max)


@pytest.mark.parametrize("shape", [(3, 4), (1, 1), (0, 5), (2, 0)])
def test_node2graph_ids_matches_jax(shape):
    mine, theirs = node2graph_ids(*shape), np.asarray(jax_node2graph_ids(*shape))
    assert mine.numpy().dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(mine.numpy(), theirs)


def _fake_rdkit(monkeypatch, energies, embed_fails=False):
    """``rdkit`` / ``rdkit.Chem`` / ``rdkit.Chem.AllChem`` stand-ins: chains
    of one-letter elements (tests/rdkit_stub.py's SMILES), ``AddHs`` a
    no-op, ``EmbedMultipleConfs`` one seeded conformer a request (or a
    ``RuntimeError``), ``MMFFOptimizeMoleculeConfs`` (0, energy) pairs of
    ``energies``, ``Compute2DCoords`` one flat conformer."""
    calls = []

    def embed(mol, n):
        calls.append(("embed", n))
        if embed_fails:
            raise RuntimeError("embedding failed")
        rng = np.random.default_rng(len(mol.GetAtoms()))
        mol._confs = [rdkit_stub.Conformer(rng.normal(size=(len(mol.GetAtoms()), 3)))
                      for _ in range(n)]
        return list(range(n))

    def optimize(mol, mmffVariant):
        calls.append(("mmff", mmffVariant))
        return [(0, e) for e in energies]

    def coords_2d(mol):
        calls.append(("2d",))
        n = len(mol.GetAtoms())
        mol._confs = [rdkit_stub.Conformer(np.c_[np.arange(n), np.ones(n), np.zeros(n)])]

    all_chem = types.ModuleType("rdkit.Chem.AllChem")
    all_chem.EmbedMultipleConfs = embed
    all_chem.MMFFOptimizeMoleculeConfs = optimize
    all_chem.Compute2DCoords = coords_2d
    chem = types.ModuleType("rdkit.Chem")
    chem.MolFromSmiles = rdkit_stub.MolFromSmiles
    chem.AddHs = lambda mol: mol
    chem.AllChem = all_chem
    root = types.ModuleType("rdkit")
    root.Chem = chem
    for name, mod in (("rdkit", root), ("rdkit.Chem", chem), ("rdkit.Chem.AllChem", all_chem)):
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


@pytest.mark.parametrize("case,energies,embed_fails,best", [
    ("lowest", [3.0, 1.5, 2.0, 0.5, 4.0], False, 3),
    ("first_of_tie", [2.0, 0.25, 0.25, 1.0, 0.25], False, 1),
    ("fallback_2d", [], True, 0)], ids=lambda v: v if isinstance(v, str) else None)
def test_smiles_to_graph_3d_mmff_matches_jax(monkeypatch, case, energies, embed_fails, best):
    calls = _fake_rdkit(monkeypatch, energies, embed_fails)
    for extend in (True, False):
        mine = featurize.smiles_to_graph_3d_mmff("CCNOC", extend=extend)
        theirs = jax_featurize.smiles_to_graph_3d_mmff("CCNOC", extend=extend)
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    mol = sys.modules["rdkit.Chem"].MolFromSmiles("CCNOC")
    if embed_fails:
        assert calls[:2] == [("embed", 5), ("2d",)]
        sys.modules["rdkit.Chem.AllChem"].Compute2DCoords(mol)
    else:
        assert calls[:2] == [("embed", 5), ("mmff", "MMFF94s")]
        sys.modules["rdkit.Chem.AllChem"].EmbedMultipleConfs(mol, 5)
    pos = np.asarray(mol.GetConformer(best).GetPositions(), dtype=np.float32)
    np.testing.assert_array_equal(mine["positions"], pos - pos.mean(axis=0, keepdims=True))
    assert featurize.smiles_to_graph_3d_mmff("C=C") is None
    assert jax_featurize.smiles_to_graph_3d_mmff("C=C") is None
