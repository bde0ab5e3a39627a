"""Port parity: packed storage (moleculesde_tpu_torch.data.packed), its
compact collation and the loaders over it, against the JAX package.  All
exact.

- ``PackedGraphs.from_graphs`` on the same molecules gives JAX's arrays
  (dtypes included) and ``meta``, in memory and reloaded memory-mapped; a
  cache saved by either package loads in the other, views included; a
  field on some molecules only raises in both.
- ``collate_compact_packed`` off a ``PackedGraphs`` and off a
  ``PackedSubset`` equals JAX's array for array, with molecules past
  ``n_max`` (bonds dropped in place, so ``edge_valid`` has gaps) and past
  ``e_max``, labels and forces carried; the port's ``expand_on_device`` of
  it equals JAX's.
- ``GraphLoader`` (compact and padded) and ``BucketedGraphLoader`` over a
  packed dataset give JAX's batches in JAX's order for the same seed, two
  epochs each, and keep the dataset as it is (no list of dicts);
  ``max_atoms`` / ``suggest_buckets`` read ``num_atoms`` as JAX does.
"""

import os

import numpy as np
import pytest

from moleculesde_tpu.data import compact as jax_compact
from moleculesde_tpu.data import loader as jax_loader
from moleculesde_tpu.data import packed as jax_packed
from moleculesde_tpu_torch.data import loader, packed
from moleculesde_tpu_torch.data.compact import collate_compact_packed, expand_on_device
from moleculesde_tpu_torch.data.synthetic import random_molecule

from test_torch_port_compact import GRAPH_FIELDS, _to_jax_compact

COMPACT_FIELDS = ("atom_feats", "positions", "n_atoms", "edge_index", "edge_feats",
                  "edge_valid", "y", "forces")
PADDED_FIELDS = ("atom_feats", "node_mask", "positions", "edge_src", "edge_dst", "edge_feats",
                 "edge_mask", "ext_src", "ext_dst", "ext_attr", "ext_mask", "y")


def _molecules(seed=0, count=12, lo=3, hi=14, extend=True, y=True, forces=False,
               atomic_only=False):
    """Synthetic molecules of ``lo``..``hi`` atoms with a 2-entry ``y`` and
    random forces when asked; ``atomic_only`` keeps the atomic-number
    column only (MD17's layout, which packing widens to 9 features)."""
    rng = np.random.default_rng(seed)
    gs = []
    for _ in range(count):
        g = random_molecule(rng, int(rng.integers(lo, hi + 1)), extend=extend)
        if y:
            g["y"] = rng.normal(size=2)
        if forces:
            g["forces"] = rng.normal(size=g["positions"].shape)
        if atomic_only:
            g["atom_feats"] = g["atom_feats"][:, 0]
        gs.append(g)
    return gs


def _assert_arrays_equal(mine, theirs):
    assert sorted(mine.arrays) == sorted(theirs.arrays)
    for k in theirs.arrays:
        a, b = np.asarray(mine.arrays[k]), np.asarray(theirs.arrays[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert mine.meta == theirs.meta


def _assert_dict_equal(mine, theirs):
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        assert np.asarray(mine[k]).dtype == np.asarray(theirs[k]).dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


KINDS = {"ext_y": {}, "bonds_forces": dict(extend=False, y=False, forces=True),
         "atomic_numbers": dict(extend=False, atomic_only=True)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_from_graphs_matches_jax_and_reloads_mmap(kind, tmp_path):
    gs = _molecules(seed=1, **KINDS[kind])
    mine, theirs = packed.PackedGraphs.from_graphs(gs), jax_packed.PackedGraphs.from_graphs(gs)
    _assert_arrays_equal(mine, theirs)
    mine.save(str(tmp_path))
    assert packed.PackedGraphs.exists(str(tmp_path))
    again = packed.PackedGraphs.load(str(tmp_path))
    assert all(isinstance(a, np.memmap) for a in again.arrays.values())
    _assert_arrays_equal(again, theirs)
    assert again.nbytes() == theirs.nbytes() and len(again) == len(theirs) == len(gs)
    np.testing.assert_array_equal(again.num_atoms, theirs.num_atoms)
    for i in (0, 5, len(gs) - 1):
        _assert_dict_equal(again[i], theirs[i])
    with pytest.raises(IndexError):
        again[len(gs)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_written_by_either_package_loads_in_the_other(writer, tmp_path):
    gs = _molecules(seed=2)
    src = packed if writer == "port" else jax_packed
    dst = jax_packed if writer == "port" else packed
    src.PackedGraphs.from_graphs(gs).save(str(tmp_path / "cache"))
    built = []
    loaded = dst.pack_or_load(str(tmp_path / "cache"), lambda: built.append(1) or gs)
    assert not built   # the cache was there: nothing rebuilt
    ref = src.PackedGraphs.load(str(tmp_path / "cache"), mmap=False)
    _assert_arrays_equal(loaded, ref)
    sub, ref_sub = loaded[2:9:3], ref[2:9:3]
    assert type(sub).__name__ == "PackedSubset" and len(sub) == len(ref_sub) == 3
    np.testing.assert_array_equal(sub.num_atoms, ref_sub.num_atoms)
    for a, b in zip(list(sub), list(ref_sub)):
        _assert_dict_equal(a, b)


def test_pack_or_load_builds_saves_and_reopens_mmap(tmp_path):
    gs = _molecules(seed=3, count=5)
    out = packed.pack_or_load(str(tmp_path / "c"), lambda: iter(gs))
    assert isinstance(out.arrays["atom_feats"], np.memmap)
    _assert_arrays_equal(out, jax_packed.PackedGraphs.from_graphs(gs))
    _assert_arrays_equal(packed.pack_or_load(None, lambda: iter(gs)), out)


@pytest.mark.parametrize("field", ["positions", "forces", "y"])
def test_mixed_presence_raises_in_both(field):
    gs = _molecules(seed=4, count=4, forces=True)
    del gs[2][field]
    for mod in (packed, jax_packed):
        with pytest.raises(ValueError, match=f"field '{field}' present on 3/4 graphs"):
            mod.PackedGraphs.from_graphs(gs)


def _packed_pair(seed=5, **kw):
    gs = _molecules(seed=seed, count=16, lo=4, hi=16, extend=False, forces=True, **kw)
    return packed.PackedGraphs.from_graphs(gs), jax_packed.PackedGraphs.from_graphs(gs)


def _assert_compact_equal(mine, theirs):
    for f in COMPACT_FIELDS:
        a, b = getattr(mine, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert (mine.num_graphs, mine.n_max, mine.e_max, mine.use_extend) == (
        theirs.num_graphs, theirs.n_max, theirs.e_max, theirs.use_extend)


@pytest.mark.parametrize("view", ["packed", "subset"])
@pytest.mark.parametrize("budgets", [dict(n_max=16, e_max=64),
                                     dict(n_max=8, e_max=20, num_tasks=3, with_forces=True,
                                          num_graphs=8)],
                         ids=["fits", "clipped_labels"])
def test_collate_compact_packed_matches_jax(view, budgets):
    """Seven molecules of 4-16 atoms; "clipped_labels" cuts atoms past 8
    (their bonds dropped in place), bonds past 20 and pads the batch to 8
    graphs, with 3 label columns for 2-entry labels and the forces."""
    mine, theirs = _packed_pair()
    idx = np.array([3, 0, 15, 7, 7, 11, 2])
    if view == "subset":
        keep = np.arange(1, 16, 2)
        mine, theirs = mine.subset(keep), theirs.subset(keep)
        idx = np.array([0, 6, 2, 7, 3, 1, 5])
    cb = collate_compact_packed(mine, idx, **budgets)
    jb = jax_compact.collate_compact_packed(theirs, idx, **budgets)
    _assert_compact_equal(cb, jb)
    valid = cb.edge_valid.numpy()
    if budgets["n_max"] == 8:   # a clipped molecule's kept bonds are not contiguous
        assert any(v.any() and not v[:v.sum()].all() for v in valid)
    eb = expand_on_device(cb)
    ej = jax_compact.expand_on_device(_to_jax_compact(cb))
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(eb, f).numpy(), np.asarray(getattr(ej, f)),
                                      err_msg=f)


@pytest.mark.parametrize("collate", ["compact", "padded"])
def test_graph_loader_over_packed_matches_jax(collate):
    mine, theirs = _packed_pair(seed=6)
    kw = dict(batch_size=4, n_max=12, seed=7, collate=collate, num_tasks=2)
    port_loader, jax_loader_ = loader.GraphLoader(mine, **kw), jax_loader.GraphLoader(theirs, **kw)
    assert port_loader.graphs is mine   # kept as it is, no list of dicts
    fields = COMPACT_FIELDS[:-1] if collate == "compact" else PADDED_FIELDS
    for _ in range(2):   # two epochs: the shuffle advances alike
        got = 0
        for (bt, nt), (bj, nj) in zip(port_loader, jax_loader_):
            assert nt == nj == 4
            for f in fields:
                np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                              np.asarray(getattr(bj, f)), err_msg=f)
            got += 1
        assert got == len(port_loader) == 4


def test_bucketed_loader_over_packed_matches_jax(capsys):
    mine, theirs = _packed_pair(seed=8)
    kw = dict(batch_size=2, buckets=(8, 12, 16), seed=9)
    port_b, jax_b = loader.BucketedGraphLoader(mine, **kw), jax_loader.BucketedGraphLoader(
        theirs, **kw)
    assert all(type(ld.graphs).__name__ == "PackedSubset" for ld in port_b.loaders if ld)
    assert len(port_b) == len(jax_b) >= 5
    for _ in range(2):
        shapes = []
        for (bt, nt), (bj, nj) in zip(port_b, jax_b):
            assert nt == nj == 2
            for f in PADDED_FIELDS[:-1]:
                np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                              np.asarray(getattr(bj, f)), err_msg=f)
            shapes.append(bt.n_max)
        assert len(shapes) == len(port_b) and set(shapes) == {8, 12, 16}
    capsys.readouterr()


@pytest.mark.parametrize("hi", [9, 16, 40, 140])
def test_max_atoms_and_suggest_buckets_read_num_atoms(hi, tmp_path):
    gs = _molecules(seed=hi, count=5, lo=4, hi=hi, extend=False, y=False)
    gs.append(random_molecule(np.random.default_rng(0), hi, extend=False))
    packed.PackedGraphs.from_graphs(gs).save(str(tmp_path))
    mine = packed.PackedGraphs.load(str(tmp_path))
    theirs = jax_packed.PackedGraphs.load(str(tmp_path))
    assert loader.max_atoms(mine) == jax_loader.max_atoms(theirs) == hi
    assert loader.suggest_buckets(mine) == jax_loader.suggest_buckets(theirs)
    sub, jsub = mine.subset([0, 1]), theirs.subset([0, 1])
    assert loader.max_atoms(sub) == jax_loader.max_atoms(jsub)
    assert loader.suggest_buckets(sub) == jax_loader.suggest_buckets(jsub)
    assert os.path.exists(tmp_path / "meta.json")
