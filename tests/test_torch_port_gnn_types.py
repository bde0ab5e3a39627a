"""Port parity: the 2D encoders GCN, GAT and GraphSAGE, every JK mode, and
``GNNGraphPred`` on them (moleculesde_tpu_torch.models.gnn2d) against the
JAX package, plus the segment helpers they read.

Bars (f32, full-f32 products on both sides): outputs and updated running
statistics 1e-5 relative to the largest value; every parameter's gradient
1e-5 relative to that leaf's largest gradient.  A bias that sits just in
front of a training-mode BatchNorm (GAT's ``bias``, GraphSAGE's and GIN's
``Dense_0.bias``, GIN's ``Dense_1.bias``) has a zero gradient in exact
arithmetic: both sides hold rounding noise there, held to 1e-6 of the
largest gradient of the model instead.
"""

import copy
import re

import jax
import numpy as np
import pytest
import torch

from moleculesde_tpu.core import segment as jax_segment
from moleculesde_tpu.models.gnn2d import GNN2D as JaxGNN2D
from moleculesde_tpu.models.gnn2d import GNNGraphPred as JaxGNNGraphPred
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.core import segment
from moleculesde_tpu_torch.core.batch import pad_graphs
from moleculesde_tpu_torch.data.compact import collate_compact, expand_on_device
from moleculesde_tpu_torch.data.loader import BucketedGraphLoader
from moleculesde_tpu_torch.models.gnn2d import GNN2D, GNNGraphPred

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, flat_tree, graphs, ieee_f32, np_tree, rel_err, t)

TYPES = ("GIN", "GCN", "GAT", "GraphSAGE")
JKS = ("last", "concat", "max", "sum")
# the biases in front of a training-mode BatchNorm (module docstring)
ZERO_GRAD = re.compile(r"(GATConv_\d+\.bias|Conv_\d+\.Dense_0\.bias|GINConv_\d+\.Dense_1\.bias)$")


@pytest.fixture(scope="module")
def batches():
    return both_batches(graphs(seed=11, count=4, n_max=8), n_max=8)


def _check_grads(grads_j, tm, train: bool):
    flat_j = flat_tree(np_tree({"params": grads_j})["params"])
    named = dict(tm.named_parameters())
    assert named.keys() == flat_j.keys()
    scale = max(float(np.abs(r).max()) for r in flat_j.values())
    for name, p in named.items():
        diff = float(np.abs(p.grad.numpy() - flat_j[name]).max())
        if train and ZERO_GRAD.search(name):
            assert diff <= 1e-6 * scale, (name, diff)
        else:
            assert diff <= 1e-5 * max(float(np.abs(flat_j[name]).max()), 1e-12), (name, diff)


@pytest.fixture(scope="module")
def jax_variables(batches):
    """One JAX initialization per encoder type, shared by its JK modes (JK
    has no parameters)."""
    jb, _ = batches
    cache = {}

    def get(gnn_type):
        if gnn_type not in cache:
            key = jax.random.PRNGKey(3)
            cache[gnn_type] = JaxGNN2D(num_layers=2, emb_dim=16, gnn_type=gnn_type).init(
                {"params": key, "dropout": key}, jb)
        return cache[gnn_type]

    return get


@pytest.mark.parametrize("jk", JKS)
@pytest.mark.parametrize("gnn_type", TYPES)
def test_gnn2d_matches_jax(batches, jax_variables, gnn_type, jk):
    """Training mode (batch statistics; the updated running statistics)
    and eval mode (those statistics): outputs and every parameter's
    gradient of ``sum(out * g)`` against ``jax.grad``; padded rows 0."""
    jb, tb = batches
    jm = JaxGNN2D(num_layers=2, emb_dim=16, jk=jk, gnn_type=gnn_type)
    v = jax_variables(gnn_type)
    tm = load_flax_variables(GNN2D(num_layers=2, emb_dim=16, jk=jk, gnn_type=gnn_type,
                                   device=CPU), np_tree(v))
    width = 16 * 3 if jk == "concat" else 16
    assert tm.out_dim == width
    g = np.random.default_rng(8).normal(size=(jb.num_nodes, width)).astype(np.float32)

    for train in (True, False):
        def jax_loss(params, stats):
            out, upd = jm.apply({"params": params, "batch_stats": stats}, jb,
                                deterministic=True, use_running_average=not train,
                                mutable=["batch_stats"])
            return (out * g).sum(), (out, upd)

        (_, (out_j, upd)), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(
            v["params"], v["batch_stats"])
        tm.zero_grad()
        out_t = tm(tb, use_running_average=not train)
        (out_t * t(g)).sum().backward()
        assert out_t.shape == (jb.num_nodes, width)
        assert rel_err(out_t.detach().numpy(), np.asarray(out_j)) < 1e-5, train
        assert (out_t.detach().numpy()[~tb.node_mask.numpy()] == 0).all()
        _check_grads(grads_j, tm, train)
        if train:   # the statistics that eval mode reads next
            v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
            stats = flat_tree(np_tree({"batch_stats": upd["batch_stats"]})["batch_stats"])
            mine = {k: b.numpy() for k, b in tm.named_buffers()}
            assert mine.keys() == stats.keys()
            for k in mine:
                assert rel_err(mine[k], stats[k]) < 1e-5, k


@pytest.mark.parametrize("gnn_type", TYPES)
def test_graph_pred_concat_matches_jax(batches, gnn_type):
    """``GNNGraphPred`` with JK ``concat``: the head is sized from the
    encoder's width (flax infers it); eval-mode logits and training-mode
    gradients against JAX."""
    jb, tb = batches
    jm = JaxGNNGraphPred(num_tasks=3, num_layers=2, emb_dim=16, jk="concat",
                         gnn_type=gnn_type)
    key = jax.random.PRNGKey(4)
    v = jm.init({"params": key, "dropout": key}, jb)
    tm = load_flax_variables(GNNGraphPred(3, num_layers=2, emb_dim=16, jk="concat",
                                          gnn_type=gnn_type, device=CPU), np_tree(v))
    assert tuple(tm.graph_pred_linear.kernel.shape) == (48, 3)
    with torch.no_grad():
        out = tm(tb, use_running_average=True).numpy()
    ref = np.asarray(jm.apply(v, jb, deterministic=True, use_running_average=True))
    assert out.shape == (4, 3) and rel_err(out, ref) < 1e-5

    def jax_loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb,
                          deterministic=True, use_running_average=False,
                          mutable=["batch_stats"])
        return (out ** 2).sum()

    grads_j = jax.grad(jax_loss)(v["params"])
    (tm(copy.deepcopy(tb), use_running_average=False) ** 2).sum().backward()
    _check_grads(grads_j, tm, train=True)


def test_unknown_gnn_type_or_jk_raises():
    with pytest.raises(ValueError, match="gnn_type"):
        GNN2D(num_layers=2, emb_dim=8, gnn_type="GINE", device=CPU)
    with pytest.raises(ValueError, match="JK"):
        GNN2D(num_layers=2, emb_dim=8, jk="lstm", device=CPU)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_edge_aggregate_matches_jax(batches, reduce):
    """``edge_aggregate`` (flat destination ids) against JAX's (slot and
    ``edge_dst % n_max``) on a collated batch, both reduces."""
    jb, tb = batches
    rng = np.random.default_rng(1)
    msg = rng.normal(size=(tb.edge_src.shape[0], 5)).astype(np.float32)
    ref = jax_segment.edge_aggregate(msg, jb.edge_dst, jb.num_graphs, jb.n_max,
                                     jb.edge_mask, reduce=reduce)
    mine = segment.edge_aggregate(t(msg), tb.edge_dst, tb.num_nodes, tb.edge_mask,
                                  reduce=reduce)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        segment.edge_aggregate(t(msg), tb.edge_dst, tb.num_nodes, reduce="max")


def _collated():
    gs = graphs(seed=2, count=12, n_max=12)
    yield "padded", pad_graphs(gs, n_max=12, e_max=48, ext_e_max=144)
    for extend in (True, False):
        cb = collate_compact(gs, n_max=12, e_max=48, use_extend=extend)
        yield f"compact extend={extend}", expand_on_device(cb)
    loader = BucketedGraphLoader(gs, batch_size=3, buckets=[8, 12], e_max_factor=4,
                                 shuffle=True, drop_last=False, seed=0)
    for i, (batch, _) in enumerate(loader):
        yield f"bucket batch {i}", batch


def test_flat_ids_are_jax_slots_on_every_collation():
    """The port's segment helpers index flat node ids where JAX groups the
    edges of graph b in slot b at ``id % n_max``: on every collation (the
    padded one, the compact one expanded with and without the extension,
    size buckets) each valid edge of slot b has both endpoints in graph b,
    so the two forms agree."""
    seen = 0
    for name, b in _collated():
        slots = torch.arange(b.num_graphs).repeat_interleave(b.edge_src.shape[0] // b.num_graphs)
        for ids in (b.edge_src, b.edge_dst):
            ok = b.edge_mask
            assert ok.any(), name
            assert torch.equal(ids.long()[ok] // b.n_max, slots[ok]), name
        seen += 1
    assert seen >= 4
