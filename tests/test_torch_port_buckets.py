"""Port parity: native collation, size buckets, and the segment and SDE
helpers against the JAX package.

- The port's C++ collator (``data/native_collate.py``, its own copy of
  ``native/collate.cpp``) against JAX's ``native_pad_graphs`` and against
  the port's numpy ``pad_graphs``, bit for bit, with and without
  truncation and extended edges.
- ``BucketedGraphLoader`` against JAX's over two epochs at one seed: the
  same schedule of buckets and every field of every batch equal, on the
  graphs of ``--ingest compact`` (no extended graph: the bond graph fills
  the extended-edge slots, as in JAX) and of ``--ingest padded``.
- ``max_atoms`` / ``suggest_buckets``, the segment helpers and the SDE
  helpers against JAX at 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.core import segment as jax_segment
from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu.data import loader as jax_loader
from moleculesde_tpu.data.native_collate import native_pad_graphs as jax_native_pad_graphs
from moleculesde_tpu.sde import base as jax_sde
from moleculesde_tpu_torch.core import segment
from moleculesde_tpu_torch.core.batch import pad_graphs
from moleculesde_tpu_torch.data import loader
from moleculesde_tpu_torch.data.native_collate import native_pad_graphs
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.sde import base as sde

from torch_port_common import t

FIELDS = ("atom_feats", "node_mask", "positions", "edge_src", "edge_dst", "edge_feats",
          "edge_mask", "ext_src", "ext_dst", "ext_attr", "ext_mask")


def _molecules(seed: int, count: int, lo: int, hi: int, extend: bool):
    rng = np.random.default_rng(seed)
    return [random_molecule(rng, int(rng.integers(lo, hi + 1)), extend=extend)
            for _ in range(count)]


def _assert_same(port, ref, what: str = ""):
    assert (port.num_graphs, port.n_max) == (ref.num_graphs, ref.n_max), what
    for f in FIELDS:
        mine, theirs = getattr(port, f), np.asarray(getattr(ref, f))
        assert mine.numpy().dtype == theirs.dtype, (what, f)
        np.testing.assert_array_equal(mine.numpy(), theirs, err_msg=f"{what} {f}")


@pytest.mark.parametrize("extend", [True, False], ids=["ext_graph", "bond_graph"])
@pytest.mark.parametrize("budgets", [dict(n_max=16, e_max=64, ext_e_max=256, num_graphs=8),
                                     dict(n_max=6, e_max=10, ext_e_max=14)],
                         ids=["fits", "truncated"])
def test_native_collation_matches_jax_and_numpy(extend, budgets):
    """Seven molecules of 3-14 atoms (one empty trailing graph where
    num_graphs is 8); "truncated" cuts atoms, bonds and extended edges."""
    gs = _molecules(5, 7, 3, 14, extend)
    mine = native_pad_graphs(gs, **budgets)
    _assert_same(mine, jax_native_pad_graphs(gs, **budgets), "JAX native")
    _assert_same(mine, jax_pad_graphs(gs, **budgets), "JAX numpy")
    port_numpy = pad_graphs(gs, **budgets)
    for f in FIELDS:
        assert torch.equal(getattr(mine, f), getattr(port_numpy, f)), f


def test_graph_loader_collates_natively_by_default():
    gs = _molecules(6, 8, 3, 8, False)
    native = loader.GraphLoader(gs, batch_size=4, n_max=8, seed=2)
    numpy_ = loader.GraphLoader(gs, batch_size=4, n_max=8, seed=2, collate_impl="numpy")
    assert native.collate_impl == "native"
    for (a, _), (b, _) in zip(native, numpy_):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="collate_impl"):
        loader.GraphLoader(gs, batch_size=4, n_max=8, collate_impl="cpp")


@pytest.mark.parametrize("ingest", ["compact", "padded"])
def test_bucketed_loader_matches_jax(ingest, capsys):
    """Two epochs: the same buckets in the same order, every batch equal,
    the drop message once per epoch.  The compact ingest's molecules have
    no extended graph, so the bond graph fills the extended-edge slots."""
    gs = _molecules(9, 40, 4, 16, extend=ingest == "padded")
    kw = dict(batch_size=4, buckets=(8, 12, 16), e_max_factor=4, seed=3)
    mine, theirs = loader.BucketedGraphLoader(gs, **kw), jax_loader.BucketedGraphLoader(gs, **kw)
    assert len(mine) == len(theirs) >= 6
    for epoch in range(2):
        schedule = []
        for (bm, nm), (bj, nj) in zip(mine, theirs):
            assert nm == nj == 4
            _assert_same(bm, bj, f"epoch {epoch}")
            schedule.append(bm.n_max)
        assert len(schedule) == len(mine) and len(set(schedule)) == 3
    out = capsys.readouterr().out
    assert out.count("BucketedGraphLoader: drop_last discards") == 4   # each side, per epoch
    assert "GraphLoader(n_max" not in out   # the buckets report their drops only through it


def test_bucketed_loader_routes_and_clips_like_jax():
    """Molecules past the largest bucket go into it (cut to it); an empty
    bucket yields nothing."""
    gs = _molecules(11, 12, 4, 20, extend=True)
    kw = dict(batch_size=2, buckets=(4, 30, 16), seed=0)
    mine, theirs = loader.BucketedGraphLoader(gs, **kw), jax_loader.BucketedGraphLoader(gs, **kw)
    assert mine.buckets == [4, 16, 30]
    assert [ld is None for ld in mine.loaders] == [ld is None for ld in theirs.loaders]
    for (bm, _), (bj, _) in zip(mine, theirs):
        _assert_same(bm, bj)
    clipped = loader.BucketedGraphLoader(gs, batch_size=1, buckets=(8,), seed=0)
    assert len(clipped) == 12 and {b.n_max for b, _ in clipped} == {8}


def test_suggest_buckets_and_max_atoms_match_jax():
    for hi in (9, 16, 17, 64, 100, 140):
        gs = _molecules(hi, 6, 4, hi, extend=False) + [random_molecule(
            np.random.default_rng(0), hi, extend=False)]
        assert loader.max_atoms(gs) == jax_loader.max_atoms(gs) == hi
        assert loader.suggest_buckets(gs) == jax_loader.suggest_buckets(gs)
    assert loader.suggest_buckets(gs) == 140
    assert loader.suggest_buckets(gs, candidates=(8, 200)) == 200


def _segment_operands(seed: int = 0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(13, 5)).astype(np.float32) * 3
    ids = np.sort(rng.integers(0, 6, size=13)).astype(np.int32)
    ids[ids == 4] = 3          # segment 4 has no row at all
    mask = rng.random(13) < 0.7
    mask[ids == 5] = False     # segment 5 has masked rows only
    return data, ids, mask


@pytest.mark.parametrize("masked", [True, False])
def test_masked_segment_max_matches_jax(masked):
    data, ids, mask = _segment_operands()
    m = mask if masked else None
    ref = jax_segment.masked_segment_max(jnp.asarray(data), jnp.asarray(ids), 7,
                                         None if m is None else jnp.asarray(m))
    mine = segment.masked_segment_max(t(data), t(ids), 7, None if m is None else t(m))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    ref0 = jax_segment.masked_segment_max(jnp.asarray(data), jnp.asarray(ids), 7,
                                          jnp.asarray(mask), initial=0.0)
    mine0 = segment.masked_segment_max(t(data), t(ids), 7, t(mask), initial=0.0)
    np.testing.assert_array_equal(mine0.numpy(), np.asarray(ref0))


@pytest.mark.parametrize("masked", [True, False])
def test_segment_softmax_matches_jax(masked):
    data, ids, mask = _segment_operands(1)
    m = mask if masked else None
    ref = jax_segment.segment_softmax(jnp.asarray(data), jnp.asarray(ids), 7,
                                      None if m is None else jnp.asarray(m))
    mine = segment.segment_softmax(t(data), t(ids), 7, None if m is None else t(m))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_node_degree_matches_jax():
    gs = _molecules(4, 3, 3, 8, extend=False)
    jb = jax_pad_graphs(gs, n_max=8, e_max=16, ext_e_max=64, num_graphs=4)
    tb = pad_graphs(gs, n_max=8, e_max=16, ext_e_max=64, num_graphs=4)
    for idx in ("edge_src", "edge_dst"):
        for masked in (True, False):
            ref = jax_segment.node_degree(getattr(jb, idx), 4, 8,
                                          jb.edge_mask if masked else None)
            mine = segment.node_degree(getattr(tb, idx), 4, 8,
                                       tb.edge_mask if masked else None)
            assert mine.dtype == torch.float32
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("schedule", ["quad", "linear", "const", "jsd", "sigmoid"])
def test_beta_schedule_matches_jax(schedule):
    kw = dict(beta_min=1e-4, beta_max=0.02, num_diffusion_timesteps=50)
    mine, ref = sde.get_beta_schedule(schedule, **kw), jax_sde.get_beta_schedule(schedule, **kw)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine, ref)


SDES = [("VE", 0.1, 10.0), ("VP", 0.2, 30.0), ("subVP", 0.1, 20.0)]


@pytest.mark.parametrize("kind,lo,hi", SDES, ids=[k for k, _, _ in SDES])
def test_sde_helpers_match_jax(kind, lo, hi):
    """prior_logp, reverse_sde (both flows) and, for VP and VE, transition;
    SubVP's and VP's discrete_betas.  1e-6 relative to each output's
    largest value."""
    mine, ref = sde.make_sde(kind, lo, hi, 100), jax_sde.make_sde(kind, lo, hi, 100)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 5, 3)).astype(np.float32)
    score = rng.normal(size=(4, 5, 3)).astype(np.float32)
    tt = rng.uniform(0.05, 0.95, size=4).astype(np.float32)

    def close(a, b):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(b).max())))

    close(mine.prior_logp(t(x)), ref.prior_logp(jnp.asarray(x)))
    for flow in (False, True):
        for a, b in zip(mine.reverse_sde(t(x), t(tt), t(score), flow),
                        ref.reverse_sde(jnp.asarray(x), jnp.asarray(tt), jnp.asarray(score),
                                        flow)):
            close(a, b)
    if kind != "subVP":
        for a, b in zip(mine.transition(t(x), t(tt), -0.01),
                        ref.transition(jnp.asarray(x), jnp.asarray(tt), -0.01)):
            close(a, b)
    if kind != "VE":   # jnp.linspace may round an entry one ulp off IEEE division
        close(mine.discrete_betas(), ref.discrete_betas)
    with pytest.raises(NotImplementedError):
        sde.SDE().prior_logp(t(x))
