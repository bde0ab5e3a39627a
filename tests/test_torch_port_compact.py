"""Port parity: compact ingest (moleculesde_tpu_torch.data.compact and the
loaders) against the JAX package.

- ``collate_compact`` equals JAX's array by array, truncation included.
- ``expand_on_device`` equals JAX's exactly, every field, with and without
  the extension; the dense extended graph equals the scatter of the padded
  path's host-built lists; a bond list with gaps in ``edge_valid`` (as the
  packed collation leaves them) expands as in JAX.
- ``GraphLoader(collate="compact")`` and ``ThreadedLoader`` give JAX's
  batches in JAX's order.
- One f32 step on a compact batch equals one on the padded batch of the
  same molecules: same weights and draws, losses and every gradient to
  1e-6 of the leaf's largest value (the expanded batch holds the same
  lists, so the two steps differ only where a dense scatter and a dense
  product order the same values differently).
"""

import dataclasses

import numpy as np
import pytest
import torch

from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu.data.compact import collate_compact as jax_collate_compact
from moleculesde_tpu.data.compact import expand_on_device as jax_expand_on_device
from moleculesde_tpu.data.loader import GraphLoader as JaxGraphLoader
from moleculesde_tpu.data.loader import ThreadedLoader as JaxThreadedLoader
from moleculesde_tpu_torch.core.batch import dense_scatter, pad_graphs
from moleculesde_tpu_torch.data.compact import CompactBatch, collate_compact, expand_on_device
from moleculesde_tpu_torch.data.loader import GraphLoader, ThreadedLoader
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.pretrain.train_state import PretrainConfig, build_models
from moleculesde_tpu_torch.pretrain.train_step import METRICS, draw_losses, pretrain_grads

from torch_port_common import CPU, ieee_f32  # noqa: F401 (ieee_f32: autouse)

COMPACT_FIELDS = ("atom_feats", "positions", "n_atoms", "edge_index", "edge_feats",
                  "edge_valid")
GRAPH_FIELDS = ("atom_feats", "node_mask", "positions", "edge_src", "edge_dst", "edge_feats",
                "edge_mask", "ext_src", "ext_dst", "ext_attr", "ext_mask", "ext_dense_mask",
                "ext_dense_attr")


def _mols(n=6, seed=0, extend=True, hi=12):
    rng = np.random.default_rng(seed)
    return [random_molecule(rng, int(rng.integers(3, hi)), extend=extend) for _ in range(n)]


def _to_jax_compact(cb: CompactBatch):
    """The port's compact batch as the JAX package's (numpy arrays)."""
    from moleculesde_tpu.data.compact import CompactBatch as JaxCompactBatch

    return JaxCompactBatch(**{f: getattr(cb, f).numpy() for f in COMPACT_FIELDS},
                           num_graphs=cb.num_graphs, n_max=cb.n_max, e_max=cb.e_max,
                           use_extend=cb.use_extend)


def _assert_compact_equal(mine: CompactBatch, theirs):
    for f in COMPACT_FIELDS:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (mine.num_graphs, mine.n_max, mine.e_max, mine.use_extend) == (
        theirs.num_graphs, theirs.n_max, theirs.e_max, theirs.use_extend)


def _assert_expanded_equal(mine, theirs):
    for f in GRAPH_FIELDS:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("n_max", [16, 8], ids=["fits", "truncates"])
def test_collate_compact_matches_jax(n_max):
    mols = _mols(n=5, seed=1, hi=14)
    mine = collate_compact(mols, n_max=n_max, e_max=4 * n_max, num_graphs=6)
    theirs = jax_collate_compact(mols, n_max=n_max, e_max=4 * n_max, num_graphs=6)
    _assert_compact_equal(mine, theirs)
    ei, ev = mine.edge_index.numpy(), mine.edge_valid.numpy()
    assert (ei[ev] < n_max).all()   # bonds of clipped atoms are gone


@pytest.mark.parametrize("use_extend", [True, False], ids=["extend", "bonds_only"])
def test_expand_on_device_matches_jax_and_the_padded_collation(use_extend):
    mols = _mols(seed=2, extend=use_extend)
    n_max, e_max = 16, 64
    cb = collate_compact(mols, n_max=n_max, e_max=e_max, use_extend=use_extend)
    eb = expand_on_device(cb)
    _assert_expanded_equal(eb, jax_expand_on_device(_to_jax_compact(cb)))
    # the dense extended graph is the scatter of the host-built lists
    gb = pad_graphs(mols, n_max=n_max, e_max=e_max, ext_e_max=n_max * n_max)
    ref_mask = dense_scatter(gb.ext_src, gb.ext_dst, gb.ext_mask,
                             torch.ones_like(gb.ext_mask), gb.num_graphs, n_max)
    ref_attr = dense_scatter(gb.ext_src, gb.ext_dst, gb.ext_mask, gb.ext_attr,
                             gb.num_graphs, n_max)
    assert torch.equal(eb.ext_dense_mask, ref_mask)
    assert torch.equal(eb.ext_dense_attr, ref_attr)
    for f in ("atom_feats", "node_mask", "positions", "edge_src", "edge_dst", "edge_feats",
              "edge_mask"):
        assert torch.equal(getattr(eb, f), getattr(gb, f)), f
    jb = jax_pad_graphs(mols, n_max=n_max, e_max=e_max, ext_e_max=n_max * n_max)
    np.testing.assert_array_equal(gb.ext_mask.numpy(), np.asarray(jb.ext_mask))


def test_expand_with_gaps_in_edge_valid_matches_jax():
    """Bonds dropped in place (a truncated molecule in the packed
    collation): valid edges are not contiguous, and the invalid slots keep
    stale endpoints.  GIN's kernel takes the mask per edge."""
    mols = _mols(n=4, seed=3, extend=False)
    cb = collate_compact(mols, n_max=12, e_max=48)
    valid = cb.edge_valid.clone()
    valid[:, 1::3] = False
    cb = dataclasses.replace(cb, edge_valid=valid)
    eb = expand_on_device(cb)
    _assert_expanded_equal(eb, jax_expand_on_device(_to_jax_compact(cb)))
    kept = valid.reshape(-1)
    assert not eb.edge_mask[~kept].any() and (eb.edge_src[~kept] == 0).all()


def test_compact_loaders_match_jax_order():
    mols = _mols(n=10, seed=4, extend=False)
    kw = dict(batch_size=4, n_max=12, seed=5)
    mine = GraphLoader(mols, collate="compact", **kw)
    theirs = JaxGraphLoader(mols, collate="compact", **kw)
    for _ in range(2):   # two epochs: the shuffle advances alike
        for (bt, nt), (bj, nj) in zip(mine, theirs):
            assert nt == nj == 4
            _assert_compact_equal(bt, bj)
    threaded = ThreadedLoader(GraphLoader(mols, collate="compact", **kw), num_workers=2,
                              prefetch=1)
    jthreaded = JaxThreadedLoader(JaxGraphLoader(mols, collate="compact", **kw),
                                  num_workers=2)
    got = list(threaded)
    assert len(got) == len(threaded) == 2
    for (bt, _), (bj, _) in zip(got, jthreaded):
        _assert_compact_equal(bt, bj)


def test_one_step_on_compact_equals_padded():
    mols = _mols(n=4, seed=6, extend=True)
    n_max = 12
    gb = pad_graphs(mols, n_max=n_max, e_max=48, ext_e_max=n_max * n_max)
    cb = collate_compact(mols, n_max=n_max, e_max=48)
    cfg = PretrainConfig(emb_dim=16, num_layer=2, schnet_num_filters=8,
                         schnet_num_interactions=2, schnet_num_gaussians=11,
                         hidden_dim_2dto3d=16, train_precision="float32")
    out = {}
    for label, batch in (("padded", gb), ("compact", cb)):
        models = build_models(cfg, CPU, torch.Generator().manual_seed(3))
        draws = draw_losses(models, cfg, gb, torch.Generator().manual_seed(4))
        metrics = pretrain_grads(models, cfg, batch, deterministic=True, draws=draws)
        out[label] = (metrics, {f"{c}.{n}": p.grad.clone() for c, m in models.items()
                                for n, p in m.named_parameters() if p.grad is not None},
                      {f"{c}.{n}": b.clone() for c, m in models.items()
                       for n, b in m.named_buffers()})
    (mp, gp, bp), (mc, gc, bc) = out["padded"], out["compact"]
    for k in METRICS:
        assert abs(mc[k].item() - mp[k].item()) <= 1e-6 * max(1.0, abs(mp[k].item())), k
    assert sorted(gc) == sorted(gp) and len(gp) > 50
    for k in gp:
        scale = max(gp[k].abs().max().item(), 1e-2)
        assert (gc[k] - gp[k]).abs().max().item() <= 1e-6 * scale, k
    for k in bp:
        torch.testing.assert_close(bc[k], bp[k], rtol=1e-6, atol=1e-6)
