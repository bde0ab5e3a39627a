"""Dataset loaders: MD17, QM9, PCQM4Mv2 and MoleculeNet (2D).

A copy of the loaders of ``moleculesde_tpu/data/datasets.py`` (reference
Geom3D/datasets/): each gives plain graph dicts for
:class:`~moleculesde_tpu_torch.data.loader.GraphLoader`, PCQM4Mv2 a
memory-mapped :class:`~moleculesde_tpu_torch.data.packed.PackedGraphs`
cache.  The CSVs are read
with ``csv`` (and ``gzip``), with pandas' semantics where the JAX package
reads them with pandas: a cell that pandas reads as missing ("", "NA",
"nan", ...) is NaN, every other cell a float64.  MoleculeNet's
classification labels become {1 -> 1, 0 -> -1, missing -> 0}; QM9's
targets stay float64 until the last cast.  SMILES and SDF parsing need
RDKit, imported inside the loaders (PCQM4Mv2's only when its cache is
built); MD17 is numpy only.  Nothing here downloads: the loaders read
files already on disk.
"""

from __future__ import annotations

import csv
import gzip
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# CODATA hartree -> eV (scipy.constants, as the reference, dataset_QM9.py:94-96)
HARTREE2EV = 27.211386245988

QM9_TARGET_FIELD = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
                    "u0", "u298", "h298", "g298", "cv", "gap_02"]
# per-target unit conversion (reference dataset_QM9.py:96-110)
QM9_CONVERSION = {
    "mu": 1.0, "alpha": 1.0, "homo": HARTREE2EV, "lumo": HARTREE2EV,
    "gap": HARTREE2EV, "gap_02": HARTREE2EV, "r2": 1.0, "zpve": HARTREE2EV,
    "u0": HARTREE2EV, "u298": HARTREE2EV, "h298": HARTREE2EV,
    "g298": HARTREE2EV, "cv": 1.0,
}
# targets with per-atom thermochemical reference energies (dataset_QM9.py:171-173)
QM9_THERMO_TARGETS = ["zpve", "u0", "u298", "h298", "g298", "cv"]
QM9_ATOM_DICT = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}
# the columns of gdb9.sdf.csv the targets come from, in their order
QM9_CSV_FIELDS = QM9_TARGET_FIELD[:12]

# MoleculeNet task counts (reference examples/util.py:183-199)
MOLECULENET_NUM_TASKS = {
    "tox21": 12, "hiv": 1, "bace": 1, "bbbp": 1, "clintox": 2, "sider": 27,
    "toxcast": 617, "muv": 17, "esol": 1, "freesolv": 1, "lipophilicity": 1,
    "malaria": 1, "cep": 1, "pcba": 92, "donor": 1,
}

# (SMILES column, task columns; None: chosen by rule) per CSV
# (reference dataset_MoleculeNet_2D.py loaders)
_MOLECULENET_COLUMNS = {
    "tox21": ("smiles", ["NR-AR", "NR-AR-LBD", "NR-AhR", "NR-Aromatase", "NR-ER",
                         "NR-ER-LBD", "NR-PPAR-gamma", "SR-ARE", "SR-ATAD5", "SR-HSE",
                         "SR-MMP", "SR-p53"]),
    "hiv": ("smiles", ["HIV_active"]),
    "bace": ("mol", ["Class"]),
    "bbbp": ("smiles", ["p_np"]),
    "clintox": ("smiles", ["FDA_APPROVED", "CT_TOX"]),
    "sider": ("smiles", None),     # every column but smiles
    "toxcast": ("smiles", None),
    "muv": ("smiles", None),       # the MUV-* columns
    "esol": ("smiles", ["measured log solubility in mols per litre"]),
    "freesolv": ("smiles", ["expt"]),
    "lipophilicity": ("smiles", ["exp"]),
    "malaria": ("smiles", ["activity"]),
    "cep": ("smiles", ["PCE"]),
}
_REGRESSION_DATASETS = {"esol", "freesolv", "lipophilicity", "malaria", "cep"}

# the cells pandas.read_csv reads as missing by default
_NA_CELLS = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
             "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
             "nan", "null"}


def _read_csv(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a CSV or gzipped CSV; blank lines are skipped and
    short rows padded with empty cells, as pandas reads them."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header = rows[0]
    return header, [r + [""] * (len(header) - len(r)) for r in rows[1:]]


def _column(header: Sequence[str], rows: Sequence[Sequence[str]], name: str,
            numeric: bool = True):
    i = header.index(name)
    if not numeric:
        return [r[i] for r in rows]
    return np.array([np.nan if r[i] in _NA_CELLS else float(r[i]) for r in rows],
                    dtype=np.float64)


# --------------------------------------------------------------------- MD17
def load_md17(npz_path: str) -> Tuple[List[Dict], Dict[str, np.ndarray]]:
    """An MD17 trajectory npz (keys E, F, R, z) as per-frame graph dicts
    ``{atom_feats (z - 1), positions, y = E, forces = F}`` with no bonds,
    and its statistics (reference Geom3D/datasets/dataset_MD17.py:38-72)."""
    raw = np.load(npz_path)
    energies = np.asarray(raw["E"]).reshape(-1)
    forces = np.asarray(raw["F"])
    positions = np.asarray(raw["R"])
    z = np.asarray(raw["z"]).astype(np.int32)
    graphs = [{
        "atom_feats": (z - 1).astype(np.int32),
        "positions": positions[i].astype(np.float32),
        "y": np.array([energies[i]], dtype=np.float32),
        "forces": forces[i].astype(np.float32),
        "edge_index": np.zeros((2, 0), dtype=np.int32),
        "edge_feats": np.zeros((0, 3), dtype=np.int32),
    } for i in range(len(energies))]
    stats = {"energy_mean": energies.mean(), "energy_std": energies.std(),
             "force_mean": np.abs(forces).mean()}
    return graphs, stats


# ---------------------------------------------------------------------- QM9
def parse_qm9_thermo_file(path: str) -> Dict[str, Dict[int, float]]:
    """Per-atom thermochemical energies of ``atomref.txt`` (reference
    dataset_QM9.py:170-200): {target: {atomic number: value}}."""
    therm = {t: {} for t in QM9_THERMO_TARGETS}
    with open(path) as f:
        for line in f:
            split = line.split()
            if not split or split[0] not in QM9_ATOM_DICT:
                continue
            charge = QM9_ATOM_DICT[split[0]]
            for target, value in zip(QM9_THERMO_TARGETS, split[1:]):
                therm[target][charge] = float(value)
    return therm


def qm9_targets_from_table(raw_targets: np.ndarray, atom_counts: Sequence[Dict[int, int]],
                           therm: Optional[Dict[str, Dict[int, float]]] = None,
                           calculate_thermo: bool = True) -> np.ndarray:
    """The 13 QM9 targets [n, 13] float32 from the 12 raw columns (mu .. cv)
    and each molecule's {atomic number: count}: gap_02 = lumo - homo, the
    per-atom thermochemical energies subtracted, Hartree -> eV applied, all
    in float64 (reference dataset_QM9.py:202-260)."""
    n = raw_targets.shape[0]
    out = np.zeros((n, 13), dtype=np.float64)
    out[:, :12] = raw_targets
    out[:, 12] = raw_targets[:, 3] - raw_targets[:, 2]
    for t_idx, name in enumerate(QM9_TARGET_FIELD):
        if calculate_thermo and therm is not None and name in QM9_THERMO_TARGETS:
            for mol_idx in range(n):
                for charge, count in atom_counts[mol_idx].items():
                    out[mol_idx, t_idx] -= therm[name].get(charge, 0.0) * count
        out[:, t_idx] *= QM9_CONVERSION[name]
    return out.astype(np.float32)


def load_qm9(root: str, calculate_thermo: bool = True, extend: bool = True,
             remove_center: bool = True) -> Tuple[List[Dict], List[str]]:
    """QM9 from the raw gdb9 files under ``root/raw/`` (gdb9.sdf,
    gdb9.sdf.csv, uncharacterized.txt, atomref.txt; reference
    dataset_QM9.py:202-295): (graph dicts with the 13 targets as ``y``,
    SMILES).  Uncharacterized molecules, and records RDKit cannot read or
    featurize, are skipped.  Needs RDKit."""
    from rdkit import Chem

    from moleculesde_tpu_torch.data.featurize import mol_to_graph_3d

    raw = os.path.join(root, "raw")
    header, rows = _read_csv(os.path.join(raw, "gdb9.sdf.csv"))
    raw_targets = np.stack([_column(header, rows, f) for f in QM9_CSV_FIELDS], axis=1)

    # molecules flagged uncharacterized (3,054; reference dataset_QM9.py:213-215)
    with open(os.path.join(raw, "uncharacterized.txt")) as f:
        skip = {int(x.split()[0]) - 1 for x in f.read().split("\n")[9:-2]}

    therm = None
    atomref_path = os.path.join(raw, "atomref.txt")
    if calculate_thermo and os.path.exists(atomref_path):
        therm = parse_qm9_thermo_file(atomref_path)

    suppl = Chem.SDMolSupplier(os.path.join(raw, "gdb9.sdf"), removeHs=False,
                               sanitize=False)
    graphs: List[Dict] = []
    smiles_list: List[str] = []
    kept_counts: List[Dict[int, int]] = []
    kept_rows: List[int] = []
    for i, mol in enumerate(suppl):
        if i in skip or mol is None:
            continue
        try:
            g = mol_to_graph_3d(mol, remove_center=remove_center, extend=extend)
        except Exception:   # a record RDKit parsed but cannot featurize: skipped
            continue
        counts: Dict[int, int] = {}
        for a in mol.GetAtoms():
            counts[a.GetAtomicNum()] = counts.get(a.GetAtomicNum(), 0) + 1
        graphs.append(g)
        kept_counts.append(counts)
        kept_rows.append(i)
        smiles_list.append(Chem.MolToSmiles(mol))

    targets = qm9_targets_from_table(raw_targets[kept_rows], kept_counts, therm,
                                     calculate_thermo)
    for g, y in zip(graphs, targets):
        g["y"] = y
    return graphs, smiles_list


# ---------------------------------------------------------------- PCQM4Mv2
def load_pcqm4mv2(root: str, max_molecules: Optional[int] = None, extend: bool = True,
                  remove_center: bool = True, packed: bool = True):
    """PCQM4Mv2 from ``root/raw/data.csv.gz`` and
    ``root/raw/pcqm4m-v2-train.sdf`` (reference dataset_PCQM4Mv2.py:45-77),
    each graph with its HOMO-LUMO gap as ``y`` [1] float32; SDF records
    RDKit cannot read or featurize are skipped, and ``max_molecules`` caps
    the molecules kept.  With ``packed`` (the default) the featurization
    streams once into a :class:`PackedGraphs` cache under
    ``root/packed_ext{0,1}[_n{max_molecules}]`` (JAX's name and format, so
    either package's cache serves the other) and the cache is returned
    memory-mapped; a cache already there is loaded without RDKit.
    ``packed=False`` returns the list of graph dicts."""

    def build():
        from rdkit import Chem

        from moleculesde_tpu_torch.data.featurize import mol_to_graph_3d

        raw = os.path.join(root, "raw")
        header, rows = _read_csv(os.path.join(raw, "data.csv.gz"))
        gaps = _column(header, rows, "homolumogap")
        suppl = Chem.SDMolSupplier(os.path.join(raw, "pcqm4m-v2-train.sdf"),
                                   removeHs=False, sanitize=True)
        count = 0
        for i, mol in enumerate(suppl):
            if max_molecules is not None and count >= max_molecules:
                break
            if mol is None:
                continue
            try:
                g = mol_to_graph_3d(mol, remove_center=remove_center, extend=extend)
            except Exception:   # a record RDKit parsed but cannot featurize: skipped
                continue
            g["y"] = np.array([gaps[i]], dtype=np.float32)
            count += 1
            yield g

    if not packed:
        return list(build())
    from moleculesde_tpu_torch.data.packed import pack_or_load

    tag = f"packed_ext{int(extend)}" + (f"_n{max_molecules}" if max_molecules else "")
    return pack_or_load(os.path.join(root, tag), build)


# -------------------------------------------------------------- MoleculeNet
def load_moleculenet_labels(dataset: str, csv_path: str) -> Tuple[List[str], np.ndarray]:
    """(SMILES, labels [n, T] float32) of a MoleculeNet CSV (or .csv.gz).
    Classification labels follow the reference's masked-BCE convention {1 ->
    1, 0 -> -1, missing -> 0} (reference dataset_MoleculeNet_2D.py, e.g.
    _load_tox21_dataset l.146-160); regression labels are the raw floats
    (NaN where missing).  muv takes the MUV-* columns, sider and toxcast
    every column but the SMILES."""
    header, rows = _read_csv(csv_path)
    smiles_col, task_cols = _MOLECULENET_COLUMNS[dataset]
    if task_cols is None:
        if dataset == "muv":
            task_cols = [c for c in header if c.startswith("MUV-")]
        else:
            task_cols = [c for c in header if c != smiles_col]
    smiles = _column(header, rows, smiles_col, numeric=False)
    labels = np.stack([_column(header, rows, c) for c in task_cols], axis=1)
    if dataset not in _REGRESSION_DATASETS:
        labels = np.where(labels == 0, -1.0, labels)
        labels = np.where(np.isnan(labels), 0.0, labels)
    return smiles, labels.astype(np.float32).reshape(len(smiles), -1)


def load_moleculenet(dataset: str, csv_path: str, extend: bool = False
                     ) -> Tuple[List[Dict], List[str]]:
    """MoleculeNet SMILES as 2D graph dicts with their labels as ``y``, and
    the SMILES kept; molecules RDKit cannot parse (or with no atom) are
    dropped, as in the reference.  Needs RDKit."""
    from moleculesde_tpu_torch.data.featurize import smiles_to_graph_2d

    smiles, labels = load_moleculenet_labels(dataset, csv_path)
    graphs: List[Dict] = []
    kept_smiles: List[str] = []
    for s, y in zip(smiles, labels):
        g = smiles_to_graph_2d(s, extend=extend)
        if g is None or g["atom_feats"].shape[0] == 0:
            continue
        g["y"] = y
        graphs.append(g)
        kept_smiles.append(s)
    return graphs, kept_smiles
