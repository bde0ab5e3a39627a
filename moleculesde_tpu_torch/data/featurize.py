"""RDKit molecule -> graph dict featurization (host side).

A copy of the part of ``moleculesde_tpu/data/featurize.py`` that the
dataset loaders read (reference Geom3D/datasets/dataset_utils.py:73-169):
OGB's atom and bond vocabularies as static tables (ogb/utils/features.py),
so nothing here needs OGB, over the port's :func:`extend_graph`, and
SMILES with MMFF94s conformers (:func:`smiles_to_graph_3d_mmff`).  RDKit is
imported only inside the functions that parse SMILES; the mol functions
take any object with RDKit's atom / bond / conformer methods.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from moleculesde_tpu_torch.data.extend import extend_graph


def _require_rdkit():
    try:
        from rdkit import Chem
    except ImportError as e:
        raise ImportError("RDKit is required to parse molecules but is not installed; "
                          "use the synthetic data instead") from e
    return Chem


# OGB categorical vocabularies (ogb/utils/features.py)
CHIRALITY = ["CHI_UNSPECIFIED", "CHI_TETRAHEDRAL_CW", "CHI_TETRAHEDRAL_CCW", "CHI_OTHER"]
DEGREE = list(range(11)) + ["misc"]
FORMAL_CHARGE = list(range(-5, 6)) + ["misc"]
NUM_H = list(range(9)) + ["misc"]
NUM_RADICAL_E = list(range(5)) + ["misc"]
HYBRIDIZATION = ["SP", "SP2", "SP3", "SP3D", "SP3D2", "misc"]
BOND_TYPE = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC", "misc"]
BOND_STEREO = ["STEREONONE", "STEREOZ", "STEREOE", "STEREOCIS", "STEREOTRANS", "STEREOANY"]


def _safe_index(table, value) -> int:
    try:
        return table.index(value)
    except ValueError:
        return len(table) - 1


def atom_to_feature_vector(atom) -> List[int]:
    """The 9 OGB atom features; feature 0 is atomic number - 1."""
    return [
        atom.GetAtomicNum() - 1,
        _safe_index(CHIRALITY, str(atom.GetChiralTag())),
        _safe_index(DEGREE, atom.GetTotalDegree()),
        _safe_index(FORMAL_CHARGE, atom.GetFormalCharge()),
        _safe_index(NUM_H, atom.GetTotalNumHs()),
        _safe_index(NUM_RADICAL_E, atom.GetNumRadicalElectrons()),
        _safe_index(HYBRIDIZATION, str(atom.GetHybridization())),
        int(atom.GetIsAromatic()),
        int(atom.IsInRing()),
    ]


def bond_to_feature_vector(bond) -> List[int]:
    """The 3 OGB bond features."""
    return [
        _safe_index(BOND_TYPE, str(bond.GetBondType())),
        _safe_index(BOND_STEREO, str(bond.GetStereo())),
        int(bond.GetIsConjugated()),
    ]


def mol_to_graph_2d(mol, extend: bool = False) -> Dict[str, np.ndarray]:
    """A mol as a graph dict with both directions of every bond (and the
    extended graph with ``extend``)."""
    atom_feats = np.array([atom_to_feature_vector(a) for a in mol.GetAtoms()],
                          dtype=np.int32).reshape(-1, 9)
    src, dst, efeat = [], [], []
    for bond in mol.GetBonds():
        i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        f = bond_to_feature_vector(bond)
        src += [i, j]
        dst += [j, i]
        efeat += [f, f]
    edge_index = np.array([src, dst], dtype=np.int32).reshape(2, -1)
    edge_feats = np.array(efeat, dtype=np.int32).reshape(-1, 3)
    g = {"atom_feats": atom_feats, "edge_index": edge_index, "edge_feats": edge_feats}
    if extend:
        g["ext_edge_index"], g["ext_edge_attr"] = extend_graph(len(atom_feats), edge_index,
                                                               edge_feats)
    return g


def mol_to_graph_3d(mol, conformer_idx: int = 0, remove_center: bool = True,
                    extend: bool = True) -> Dict[str, np.ndarray]:
    """:func:`mol_to_graph_2d` plus the conformer's positions, centred with
    ``remove_center`` (reference dataset_3D.py:120-122)."""
    g = mol_to_graph_2d(mol, extend=extend)
    pos = np.asarray(mol.GetConformer(conformer_idx).GetPositions(), dtype=np.float32)
    if remove_center:
        pos = pos - pos.mean(axis=0, keepdims=True)
    g["positions"] = pos
    return g


def smiles_to_graph_2d(smiles: str, extend: bool = False) -> Optional[Dict[str, np.ndarray]]:
    """A SMILES string as a 2D graph dict; None where RDKit cannot parse it."""
    mol = _require_rdkit().MolFromSmiles(smiles)
    if mol is None:
        return None
    return mol_to_graph_2d(mol, extend=extend)


def smiles_to_graph_3d_mmff(smiles: str, num_conformers: int = 5, remove_center: bool = True,
                            extend: bool = True) -> Optional[Dict[str, np.ndarray]]:
    """A SMILES string as a 3D graph dict (reference dataset_utils.py:35-65):
    hydrogens added, ``num_conformers`` conformers embedded and optimized
    with MMFF94s, the one of lowest energy kept (the first of equal
    lowest); if embedding or optimization raises, 2D coordinates from
    ``Compute2DCoords`` and conformer 0 instead.  None where RDKit cannot
    parse the SMILES."""
    Chem = _require_rdkit()
    from rdkit.Chem import AllChem

    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return None
    mol = Chem.AddHs(mol)
    try:
        AllChem.EmbedMultipleConfs(mol, num_conformers)
        results = AllChem.MMFFOptimizeMoleculeConfs(mol, mmffVariant="MMFF94s")
        best = int(np.argmin([r[1] for r in results]))
    except Exception:
        AllChem.Compute2DCoords(mol)
        best = 0
    return mol_to_graph_3d(mol, conformer_idx=best, remove_center=remove_center,
                           extend=extend)
