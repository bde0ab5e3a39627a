"""Port parity: what the finetunes read, against the JAX package.

- Batches with labels: ``y`` and ``forces`` from the numpy and the C++
  padded collations and from the compact one (expanded on the device), and
  the loaders' ``rotation_transform`` and ``num_tasks`` / ``with_forces``
  through ``GraphLoader`` and ``BucketedGraphLoader``, equal to JAX's bit
  for bit over two epochs.
- Datasets: ``load_moleculenet`` (the bbbp fixture, under
  ``tests/rdkit_stub.py``), ``load_moleculenet_labels`` on generated CSVs
  with missing cells in every spelling pandas reads as missing (tox21,
  muv, sider, and a regression set), ``load_qm9`` (the qm9 fixture) and
  ``load_md17`` (a generated npz): the same graph dicts, bit for bit.
- The six splitters: the same index arrays.
- The five schedules at steps 0 .. 3 x steps_per_epoch: 1e-6 of lr (JAX
  evaluates the cosines in float32); the plateau controller on a fixed
  sequence, exactly.
- ROC-AUC with ties, an all-missing task and a one-class task: the numpy
  per-task AUCs against JAX's (sklearn) to 1e-12, the device mean against
  JAX's ``roc_auc_mean_device`` to 1e-6 (float32 there) and the valid-task
  count exactly.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdkit_stub

from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu.data import compact as jax_compact
from moleculesde_tpu.data import datasets as jax_datasets
from moleculesde_tpu.data import loader as jax_loader
from moleculesde_tpu.data import splitters as jax_splitters
from moleculesde_tpu.utils import metrics as jax_metrics
from moleculesde_tpu.utils import schedulers as jax_schedulers
from moleculesde_tpu_torch.core.batch import pad_graphs
from moleculesde_tpu_torch.data import datasets, splitters
from moleculesde_tpu_torch.data.compact import collate_compact, expand_on_device
from moleculesde_tpu_torch.data.loader import BucketedGraphLoader, GraphLoader
from moleculesde_tpu_torch.data.native_collate import native_pad_graphs
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.utils import metrics, schedulers

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
FIELDS = ("atom_feats", "node_mask", "positions", "edge_src", "edge_dst", "edge_feats",
          "edge_mask", "ext_src", "ext_dst", "ext_attr", "ext_mask", "y", "forces")


@pytest.fixture
def rdkit():
    """The RDKit stand-in as ``rdkit`` for one test."""
    installed = rdkit_stub.install()
    yield
    if installed:
        rdkit_stub.uninstall()


def _labelled(seed: int, count: int, lo: int = 3, hi: int = 10, tasks: int = 3):
    """Molecules with ``tasks`` labels in {-1, 0, 1} and random forces; the
    last one has neither."""
    rng = np.random.default_rng(seed)
    gs = []
    for _ in range(count):
        g = random_molecule(rng, int(rng.integers(lo, hi + 1)), extend=False)
        g["y"] = rng.integers(-1, 2, size=tasks).astype(np.float64)
        g["forces"] = rng.normal(size=g["positions"].shape)
        gs.append(g)
    del gs[-1]["y"], gs[-1]["forces"]
    return gs


def _assert_same(port, ref, what=""):
    assert (port.num_graphs, port.n_max) == (ref.num_graphs, ref.n_max), what
    for f in FIELDS:
        mine, theirs = getattr(port, f), getattr(ref, f)
        if theirs is None:
            assert mine is None, (what, f)
            continue
        theirs = np.asarray(theirs)
        assert mine.numpy().dtype == theirs.dtype, (what, f)
        np.testing.assert_array_equal(mine.numpy(), theirs, err_msg=f"{what} {f}")


@pytest.mark.parametrize("collate", ["numpy", "native"])
@pytest.mark.parametrize("labels", [dict(num_tasks=3, with_forces=True),
                                    dict(num_tasks=2), dict(with_forces=True), {}],
                         ids=["y_forces", "y_cut", "forces", "none"])
def test_padded_labels_match_jax(collate, labels):
    """Six molecules in eight slots at n_max 8 (atoms and forces cut past
    it); y cut to the first two tasks in "y_cut"."""
    gs = _labelled(3, 6)
    kw = dict(n_max=8, e_max=24, ext_e_max=64, num_graphs=8, **labels)
    pad = native_pad_graphs if collate == "native" else pad_graphs
    _assert_same(pad(gs, **kw), jax_pad_graphs(gs, **kw))


def test_compact_labels_match_jax():
    gs = _labelled(4, 5)
    kw = dict(n_max=8, e_max=24, num_graphs=6, num_tasks=3, with_forces=True)
    mine, ref = collate_compact(gs, **kw), jax_compact.collate_compact(gs, **kw)
    for f in ("y", "forces"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(), getattr(ref, f))
    mine_e, ref_e = expand_on_device(mine), jax_compact.expand_on_device(ref)
    for f in ("y", "forces"):
        np.testing.assert_array_equal(getattr(mine_e, f).numpy(), np.asarray(getattr(ref_e, f)))
    assert collate_compact(gs, n_max=8, e_max=24, num_tasks=0).y is None   # JAX: `if num_tasks`


@pytest.mark.parametrize("kind", ["rotation", "forces", "eval"])
def test_graph_loader_matches_jax(kind):
    """Two epochs at one seed: the shuffle, each batch's rotation draws
    (positions), labels and forces, and the padded tail of an evaluation
    loader."""
    gs = _labelled(6, 11)[:-1]
    kw = dict(batch_size=4, n_max=8, e_max=32, seed=5, num_tasks=3)
    kw.update({"rotation": dict(rotation_transform=True), "forces": dict(with_forces=True),
               "eval": dict(shuffle=False, drop_last=False)}[kind])
    mine, ref = GraphLoader(gs, **kw), jax_loader.GraphLoader(gs, **kw)
    for epoch in range(2):
        pairs = list(zip(mine, ref, strict=True))
        assert len(pairs) == (3 if kind == "eval" else 2)
        for (bm, nm), (br, nr) in pairs:
            assert nm == nr
            _assert_same(bm, br, f"{kind} epoch {epoch}")


def test_rotation_is_a_rotation_and_refused_where_jax_refuses():
    gs = _labelled(7, 5)
    loader = GraphLoader(gs, batch_size=4, n_max=10, rotation_transform=True, seed=1)
    batch, _ = next(iter(loader))
    ref, _ = next(iter(GraphLoader(gs, batch_size=4, n_max=10, seed=1)))
    for b in range(4):
        p = batch.positions[b * 10:(b + 1) * 10].double()
        q = ref.positions[b * 10:(b + 1) * 10].double()
        np.testing.assert_allclose(torch.cdist(p, p).numpy(), torch.cdist(q, q).numpy(),
                                   atol=1e-5)
    with pytest.raises(NotImplementedError, match="rotation_transform"):
        GraphLoader(gs, batch_size=4, n_max=10, rotation_transform=True, collate="compact")


def test_bucketed_loader_labels_match_jax():
    gs = _labelled(8, 25, lo=3, hi=20)[:-1]
    kw = dict(batch_size=4, buckets=(8, 16, 32), seed=2, num_tasks=3, with_forces=True)
    mine, ref = BucketedGraphLoader(gs, **kw), jax_loader.BucketedGraphLoader(gs, **kw)
    for _ in range(2):
        for (bm, nm), (br, nr) in zip(mine, ref, strict=True):
            assert nm == nr
            _assert_same(bm, br)


def _same_graphs(mine, ref):
    assert len(mine) == len(ref)
    for gm, gr in zip(mine, ref):
        assert sorted(gm) == sorted(gr)
        for k in gr:
            a, b = np.asarray(gm[k]), np.asarray(gr[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_load_moleculenet_bbbp_fixture_matches_jax(rdkit):
    path = os.path.join(FIXTURES, "moleculenet", "bbbp", "raw", "bbbp.csv.gz")
    mine, ref = datasets.load_moleculenet("bbbp", path), jax_datasets.load_moleculenet(
        "bbbp", path)
    assert mine[1] == ref[1] and len(mine[0]) == 5
    _same_graphs(mine[0], ref[0])


# the cells pandas reads as missing by default, one per row
_MISSING = ["", "nan", "NA", "NaN", "N/A", "null", "NULL", "#N/A", "None", "n/a", "<NA>",
            "-nan", "1.#QNAN"]


@pytest.mark.parametrize("dataset", ["tox21", "muv", "sider", "esol"])
def test_moleculenet_labels_match_pandas(tmp_path, dataset):
    """A CSV with labels 0 / 1 / 0.0 / 1.5 and every missing spelling, the
    task columns picked by the dataset's rule, quoted cells and a blank
    line; written gzipped for esol."""
    rng = np.random.default_rng(len(dataset))
    if dataset == "tox21":
        cols = jax_datasets._MOLECULENET_COLUMNS["tox21"][1]
    elif dataset == "muv":
        cols = ["MUV-466", "other", "MUV-548"]
    elif dataset == "sider":
        cols = ["Hepatobiliary disorders", "Metabolism, nutrition"]
    else:
        cols = ["measured log solubility in mols per litre", "Compound ID"]
    lines = [",".join(['"' + c + '"' if "," in c else c for c in ["smiles"] + cols])]
    for i in range(len(_MISSING) + 4):
        cells = [_MISSING[(i + j) % len(_MISSING)] if rng.random() < 0.4
                 else str(rng.choice(["0", "1", "0.0", "1.5", "-2.25"]))
                 for j in range(len(cols))]
        lines.append(",".join(["C" * (1 + i % 4)] + cells))
        if i == 3:
            lines.append("")
    text = "\n".join(lines) + "\n"
    path = tmp_path / f"{dataset}.csv"
    if dataset == "esol":
        import gzip

        path = tmp_path / f"{dataset}.csv.gz"
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    smiles, labels = datasets.load_moleculenet_labels(dataset, str(path))
    ref_smiles, ref_labels = jax_datasets.load_moleculenet_labels(dataset, str(path))
    assert smiles == ref_smiles
    assert labels.dtype == ref_labels.dtype == np.float32
    np.testing.assert_array_equal(labels, ref_labels)


@pytest.mark.parametrize("extend", [False, True])
def test_load_qm9_fixture_matches_jax(rdkit, extend):
    root = os.path.join(FIXTURES, "qm9")
    mine, ref = datasets.load_qm9(root, extend=extend), jax_datasets.load_qm9(root,
                                                                             extend=extend)
    assert mine[1] == ref[1] and len(mine[0]) == 4
    _same_graphs(mine[0], ref[0])


def test_load_md17_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "aspirin_dft.npz"
    np.savez(path, z=np.array([6, 6, 8, 1, 1, 1], dtype=np.int64),
             R=rng.normal(scale=1.5, size=(7, 6, 3)), E=rng.normal(loc=-400.0, size=(7, 1)),
             F=rng.normal(size=(7, 6, 3)))
    (mine, stats), (ref, ref_stats) = datasets.load_md17(str(path)), jax_datasets.load_md17(
        str(path))
    _same_graphs(mine, ref)
    assert stats == ref_stats


def test_splitters_match_jax(rdkit):
    smiles = ["".join(np.random.default_rng(i).choice(list("CNOF"), size=1 + i % 5))
              for i in range(40)]
    labels = np.random.default_rng(0).integers(-1, 2, size=40).astype(np.float32)
    state = random.getstate()
    cases = [
        (splitters.scaffold_split(smiles), jax_splitters.scaffold_split(smiles)),
        (splitters.scaffold_split(smiles, task_labels=labels),
         jax_splitters.scaffold_split(smiles, task_labels=labels)),
        (splitters.random_scaffold_split(smiles, seed=3),
         jax_splitters.random_scaffold_split(smiles, seed=3)),
        (splitters.random_split(40, seed=7), jax_splitters.random_split(40, seed=7)),
        (splitters.random_split(40, seed=7, task_labels=labels),
         jax_splitters.random_split(40, seed=7, task_labels=labels))]
    assert random.getstate() != state   # JAX's random_split seeded the global generator
    random.setstate(state)
    splitters.random_split(40, seed=1)
    assert random.getstate() == state   # the port's leaves it alone
    for n in (50, 130831 + 5):
        cases += [(splitters.qm9_random_customized_01(n, seed=4),
                   jax_splitters.qm9_random_customized_01(n, seed=4)),
                  (splitters.qm9_random_customized_02(n, seed=4),
                   jax_splitters.qm9_random_customized_02(n, seed=4))]
    for n in (30, 2500):
        cases.append((splitters.md17_split(n, seed=42), jax_splitters.md17_split(n, seed=42)))
    for mine, ref in cases:
        for a, b in zip(mine, ref, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="add up to 1"):
        splitters.random_split(10, frac_train=0.5)


SCHEDULES = ("CosineAnnealingLR", "CosineAnnealingWarmRestarts", "StepLR",
             "StepLRCustomized", "ReduceLROnPlateau")


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_jax(name):
    kw = dict(name=name, lr=1e-3, epochs=3, steps_per_epoch=5, lr_decay_factor=0.3,
              lr_decay_step_size=1, min_lr=1e-5, custom_steps=(1, 2))
    mine, ref = schedulers.make_lr_schedule(**kw), jax_schedulers.make_lr_schedule(**kw)
    for step in range(3 * 5 + 1):
        assert abs(mine(step) - float(ref(jnp.int32(step)))) <= 1e-6 * kw["lr"], (name, step)


def test_plateau_controller_matches_jax():
    seq = [1.0, 0.9, 0.95, 0.95, 0.91, 0.92, 0.8, 0.85, 0.86, 0.87, 0.88, 0.89]
    mine = schedulers.PlateauController(1e-3, factor=0.5, patience=2, min_lr=2e-4)
    ref = jax_schedulers.PlateauController(1e-3, factor=0.5, patience=2, min_lr=2e-4)
    assert [mine.update(v) for v in seq] == [ref.update(v) for v in seq]
    assert mine.lr == ref.lr < 1e-3


def test_roc_auc_matches_jax_and_sklearn():
    rng = np.random.default_rng(9)
    m, t = 41, 6
    y = rng.choice([-1.0, 0.0, 1.0], size=(m, t))
    y[:, 3] = 0.0                                    # all missing
    y[:, 4] = np.where(y[:, 4] != 0, 1.0, 0.0)       # one class
    s = rng.normal(size=(m, t)).astype(np.float32)
    s[:, 1] = np.round(s[:, 1])                      # ties
    s[::3, 5] = 0.5
    ref = jax_metrics.roc_auc_per_task(y, s)
    mine = metrics.roc_auc_per_task(y, s)
    assert len(mine) == len(ref) == 4
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-12)
    auc, n_ok = metrics.roc_auc_mean(torch.from_numpy(y).float(), torch.from_numpy(s))
    ref_auc, ref_ok = jax_metrics.roc_auc_mean_device(jnp.asarray(y), jnp.asarray(s))
    assert int(n_ok) == int(ref_ok) == 4
    assert abs(float(auc) - float(ref_auc)) <= 1e-6
    assert abs(float(auc) - np.mean(ref)) <= 1e-6
    empty, none_ok = metrics.roc_auc_mean(torch.zeros(5, 2), torch.randn(5, 2))
    assert float(empty) == 0.0 and int(none_ok) == 0
