"""Dataset splitters: Bemis-Murcko scaffold, random scaffold, random, and
the fixed QM9 and MD17 splits.

A copy of ``moleculesde_tpu/data/splitters.py`` (reference
examples/splitters.py) over index lists: the same sort orders, cutoffs and
random draws, so the same inputs give the JAX package's index arrays.
:func:`random_split` shuffles with its own ``random.Random(seed)``, which
draws what the JAX package's ``random.seed(seed); random.shuffle`` draws,
without touching the global generator.  RDKit is imported only by
:func:`generate_scaffold`.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _check_fractions(frac_train: float, frac_valid: float, frac_test: float) -> None:
    if abs(frac_train + frac_valid + frac_test - 1.0) >= 1.5e-7:
        raise ValueError(f"split fractions {frac_train} + {frac_valid} + {frac_test} "
                         f"do not add up to 1")


def generate_scaffold(smiles: str, include_chirality: bool = True) -> str:
    """Bemis-Murcko scaffold SMILES (ref splitters.py:12-18)."""
    from rdkit.Chem.Scaffolds import MurckoScaffold

    return MurckoScaffold.MurckoScaffoldSmiles(smiles=smiles,
                                               includeChirality=include_chirality)


def scaffold_split(smiles_list: Sequence[str], frac_train: float = 0.8,
                   frac_valid: float = 0.1, frac_test: float = 0.1,
                   task_labels: Optional[np.ndarray] = None, null_value: float = 0) -> Split:
    """Deterministic scaffold split (ref splitters.py:21-108): molecules
    grouped by scaffold, groups ordered by (size, first index) descending,
    then train, valid and test filled greedily up to the fractions."""
    _check_fractions(frac_train, frac_valid, frac_test)
    if task_labels is not None:
        keep = [i for i, y in enumerate(task_labels) if y != null_value]
    else:
        keep = list(range(len(smiles_list)))
    groups = {}
    for i in keep:
        groups.setdefault(generate_scaffold(smiles_list[i], include_chirality=True),
                          []).append(i)
    scaffold_sets = sorted((sorted(v) for v in groups.values()),
                           key=lambda v: (len(v), v[0]), reverse=True)
    train_cutoff = frac_train * len(keep)
    valid_cutoff = (frac_train + frac_valid) * len(keep)
    train_idx: List[int] = []
    valid_idx: List[int] = []
    test_idx: List[int] = []
    for s in scaffold_sets:
        if len(train_idx) + len(s) > train_cutoff:
            if len(train_idx) + len(valid_idx) + len(s) > valid_cutoff:
                test_idx.extend(s)
            else:
                valid_idx.extend(s)
        else:
            train_idx.extend(s)
    return np.array(train_idx), np.array(valid_idx), np.array(test_idx)


def random_scaffold_split(smiles_list: Sequence[str], frac_train: float = 0.8,
                          frac_valid: float = 0.1, frac_test: float = 0.1,
                          seed: int = 0) -> Split:
    """Scaffold groups in a ``RandomState(seed)`` permutation, filled
    greedily into valid, then test, the rest train (ref
    splitters.py:111-178)."""
    rng = np.random.RandomState(seed)
    groups = {}
    for i, smiles in enumerate(smiles_list):
        groups.setdefault(generate_scaffold(smiles, include_chirality=True), []).append(i)
    scaffold_sets = rng.permutation(np.array(list(groups.values()), dtype=object))
    n_total_valid = int(np.floor(frac_valid * len(smiles_list)))
    n_total_test = int(np.floor(frac_test * len(smiles_list)))
    train_idx: List[int] = []
    valid_idx: List[int] = []
    test_idx: List[int] = []
    for s in scaffold_sets:
        if len(valid_idx) + len(s) <= n_total_valid:
            valid_idx.extend(s)
        elif len(test_idx) + len(s) <= n_total_test:
            test_idx.extend(s)
        else:
            train_idx.extend(s)
    return np.array(train_idx), np.array(valid_idx), np.array(test_idx)


def random_split(num_mols: int, frac_train: float = 0.8, frac_valid: float = 0.1,
                 frac_test: float = 0.1, seed: int = 42,
                 task_labels: Optional[np.ndarray] = None, null_value: float = 0) -> Split:
    """Random split (ref splitters.py:181-243), shuffled by Python's
    ``random`` seeded with ``seed``."""
    _check_fractions(frac_train, frac_valid, frac_test)
    if task_labels is not None:
        all_idx = [i for i, y in enumerate(task_labels) if y != null_value]
    else:
        all_idx = list(range(num_mols))
    random.Random(seed).shuffle(all_idx)
    n = len(all_idx)
    n_train = int(frac_train * n)
    n_valid = int(frac_valid * n)
    return (np.array(all_idx[:n_train]), np.array(all_idx[n_train:n_train + n_valid]),
            np.array(all_idx[n_train + n_valid:]))


def qm9_random_customized_01(num_mols: int, seed: int = 0) -> Split:
    """110k / 10k / rest of a ``RandomState(seed)`` permutation (ref
    splitters.py:246-299); smaller sets keep the proportions."""
    all_idx = np.random.RandomState(seed).permutation(num_mols)
    n_train, n_valid = 110000, 10000
    if num_mols < n_train + n_valid:
        n_train = int(num_mols * 110000 / 130831)
        n_valid = int(num_mols * 10000 / 130831)
    return all_idx[:n_train], all_idx[n_train:n_train + n_valid], all_idx[n_train + n_valid:]


def qm9_random_customized_02(num_mols: int, seed: int = 0) -> Split:
    """100k / rest / 10% of a ``RandomState(seed)`` permutation (ref
    splitters.py:302-351); smaller sets keep the proportions."""
    all_idx = np.random.RandomState(seed).permutation(num_mols)
    n_train = 100000
    n_test = int(0.1 * num_mols)
    if num_mols < n_train + n_test:
        n_train = int(num_mols * 100000 / 130831)
    n_valid = num_mols - n_train - n_test
    return all_idx[:n_train], all_idx[n_train:n_train + n_valid], all_idx[n_train + n_valid:]


def md17_split(num_frames: int, n_train: int = 1000, n_valid: int = 1000,
               seed: int = 42) -> Split:
    """1000 / 1000 / rest of a ``RandomState(seed)`` permutation of the
    frames (ref dataset_MD17.py:74-78); 60 / 20 / 20 for smaller sets."""
    idx = np.random.RandomState(seed).permutation(num_frames)
    if num_frames <= n_train + n_valid:
        n_train = int(num_frames * 0.6)
        n_valid = int(num_frames * 0.2)
    return idx[:n_train], idx[n_train:n_train + n_valid], idx[n_train + n_valid:]
