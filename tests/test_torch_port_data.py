"""Port parity: host data layer and segment ops (moleculesde_tpu_torch.core,
.data) against the JAX package: identical arrays from identical seeds."""

import numpy as np
import pytest
import torch

from moleculesde_tpu.core import segment as jseg
from moleculesde_tpu.data.extend import extend_graph as jax_extend_graph
from moleculesde_tpu.data.synthetic import random_molecule as jax_random_molecule
from moleculesde_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from moleculesde_tpu_torch.core import segment as tseg
from moleculesde_tpu_torch.data.extend import extend_graph
from moleculesde_tpu_torch.data.synthetic import random_molecule, synthetic_batch
from moleculesde_tpu_torch.sampling.pc import repeat_graph_batch

from torch_port_common import both_batches, graphs, ieee_f32  # noqa: F401 (ieee_f32: autouse)

BATCH_FIELDS = ("atom_feats", "node_mask", "positions", "edge_src", "edge_dst",
                "edge_feats", "edge_mask", "ext_src", "ext_dst", "ext_attr",
                "ext_mask")


def _assert_batches_equal(jb, tb):
    assert (jb.num_graphs, jb.n_max) == (tb.num_graphs, tb.n_max)
    for name in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)


@pytest.mark.parametrize("geometric", [False, True])
def test_random_molecule_same_draws(geometric):
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    for n in (2, 5, 9):
        gj = jax_random_molecule(rng_j, n, geometric=geometric)
        gt = random_molecule(rng_t, n, geometric=geometric)
        assert gj.keys() == gt.keys()
        for k in gj:
            np.testing.assert_array_equal(gt[k], gj[k], err_msg=k)


def test_extend_graph_matches():
    rng = np.random.default_rng(1)
    for n in (1, 4, 11):
        g = jax_random_molecule(rng, n, extend=False)
        ej = jax_extend_graph(n, g["edge_index"], g["edge_feats"])
        et = extend_graph(n, g["edge_index"], g["edge_feats"])
        for a, b in zip(et, ej):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("budgets", [(None, None), (12, 20)])
def test_pad_graphs_matches(budgets):
    gs = graphs(seed=5, count=3, n_max=7)
    gs.append({k: v for k, v in gs[0].items()
               if k not in ("ext_edge_index", "ext_edge_attr")})  # no ext graph
    jb, tb = both_batches(gs, n_max=6, e_max=budgets[0], ext_e_max=budgets[1])
    _assert_batches_equal(jb, tb)
    # padded bond edges point at node 0 with the mask False
    em = tb.edge_mask.numpy()
    assert (tb.edge_src.numpy()[~em] == 0).all() and (~em).any()


def test_synthetic_and_repeat_batches_match():
    from moleculesde_tpu.sampling.pc import repeat_graph_batch as jax_repeat

    _assert_batches_equal(jax_synthetic_batch(num_graphs=3, n_max=6, seed=2),
                          synthetic_batch(num_graphs=3, n_max=6, seed=2))
    g = graphs(seed=0, count=1, n_max=6)[0]
    _assert_batches_equal(jax_repeat(g, 3, 6, 24, 36), repeat_graph_batch(g, 3, 6, 24, 36))


def test_batch_helpers():
    tb = synthetic_batch(num_graphs=2, n_max=4, seed=0)
    np.testing.assert_array_equal(tb.node2graph().numpy(), [0, 0, 0, 0, 1, 1, 1, 1])
    x = torch.arange(8 * 3).reshape(8, 3)
    assert torch.equal(tb.dense_nodes(x)[1, 2], x[6])
    assert tb.to("cpu").atom_feats.dtype == torch.int32


def test_segment_ops_match_jax():
    rng = np.random.default_rng(0)
    b, n, e, f = 3, 5, 7, 4
    x = rng.normal(size=(b * n, f)).astype(np.float32)
    msg = rng.normal(size=(b * e, f)).astype(np.float32)
    idx = (rng.integers(0, n, size=(b, e)) + np.arange(b)[:, None] * n).reshape(-1)
    mask = rng.random(b * e) < 0.7
    gj = np.asarray(jseg.edge_gather(x, idx, b, n, mask))
    gt = tseg.edge_gather(torch.from_numpy(x), torch.from_numpy(idx),
                          torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(gt, gj, atol=1e-6)
    aj = np.asarray(jseg.edge_aggregate(msg, idx, b, n, mask))
    at = tseg.edge_aggregate(torch.from_numpy(msg), torch.from_numpy(idx), b * n,
                             torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(at, aj, atol=1e-5)
    seg = np.repeat(np.arange(b), e)
    mj = np.asarray(jseg.masked_segment_mean(msg, seg, b, mask))
    mt = tseg.masked_segment_mean(torch.from_numpy(msg), torch.from_numpy(seg), b,
                                  torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(mt, mj, atol=1e-6)
