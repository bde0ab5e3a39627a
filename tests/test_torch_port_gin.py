"""Port parity: GIN message block and GNN2D (moleculesde_tpu_torch.ops
.gin_messages, .models.gnn2d) against the JAX package.

Tolerances: f32 1e-5 (the same sums in another order); bf16 against the
Pallas kernel's own bf16 semantics 1e-5 (same roundings, f32 sums), against
the JAX one-hot einsum form 3e-2 relative (it rounds the embedding and the
output to bf16 as well)."""

import copy

import jax
import numpy as np
import pytest
import torch

from moleculesde_tpu.models.gnn2d import GNN2D as JaxGNN2D
from moleculesde_tpu.models.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from moleculesde_tpu.ops.gin_messages import gin_messages as jax_gin_messages
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.gnn2d import GNN2D
from moleculesde_tpu_torch.models.layers import MaskedBatchNorm
from moleculesde_tpu_torch.ops.gin_messages import gin_messages, gin_messages_plain

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(5)
    b, n, e, d, f = 3, 8, 16, 13, 12
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    src = rng.integers(0, n + 1, size=(b, e)).astype(np.int32)  # n == masked
    dst = rng.integers(0, n + 1, size=(b, e)).astype(np.int32)
    boh = np.zeros((b, e, d), np.float32)
    for lo, hi in ((0, 5), (5, 11), (11, 13)):  # one hot per bond feature
        boh[np.arange(b)[:, None], np.arange(e)[None], rng.integers(lo, hi, (b, e))] = 1
    tbl = (rng.normal(size=(d, f)) * 0.5).astype(np.float32)
    return x, src, dst, boh, tbl


@pytest.mark.parametrize("bf16", [False, True])
def test_gin_messages_plain_matches_pallas_kernel(operands, bf16):
    ref = np.asarray(jax_gin_messages(*operands, bf16=bf16, impl="pallas_interpret"))
    out = gin_messages_plain(*map(t, operands), bf16=bf16).numpy()
    assert out.shape == ref.shape == (3, 8, 12)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_gin_messages_plain_matches_xla_form(operands, bf16):
    ref = np.asarray(jax_gin_messages(*operands, bf16=bf16, impl="xla"))
    out = gin_messages(*map(t, operands), bf16=bf16).numpy()  # auto on CPU: plain
    assert rel_err(out, ref) < (3e-2 if bf16 else 1e-5)


def test_gin_messages_masked_edges_add_nothing(operands):
    x, src, dst, boh, tbl = operands
    n = x.shape[1]
    out = gin_messages_plain(t(x), t(np.full_like(src, n)), t(np.full_like(dst, n)),
                             t(boh), t(tbl))
    assert float(out.abs().max()) == 0.0


@pytest.fixture(scope="module")
def gnn_pair():
    """JAX GNN2D (2 layers x 16) with batch statistics from one train-mode
    pass, the port's GNN2D carrying the same variables, and both batches."""
    jb, tb = both_batches(graphs(seed=4, count=3, n_max=8), n_max=8)
    jm = JaxGNN2D(num_layers=2, emb_dim=16)
    key = jax.random.PRNGKey(0)
    v = jm.init({"params": key, "dropout": key}, jb)
    _, upd = jm.apply(v, jb, deterministic=True, use_running_average=False,
                      mutable=["batch_stats"])
    v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    tm = load_flax_variables(GNN2D(num_layers=2, emb_dim=16, device=CPU), np_tree(v))
    return jm, v, tm, jb, tb


def test_gnn2d_running_average_matches_jax(gnn_pair):
    jm, v, tm, jb, tb = gnn_pair
    ref = np.asarray(jm.apply(v, jb, deterministic=True, use_running_average=True))
    with torch.no_grad():
        out = tm(tb, use_running_average=True).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)
    assert (out[~tb.node_mask.numpy()] == 0).all()


def test_gnn2d_train_statistics_match_jax(gnn_pair):
    jm, v, tm, jb, tb = gnn_pair
    ref, upd = jm.apply(v, jb, deterministic=True, use_running_average=False,
                        mutable=["batch_stats"])
    tm2 = copy.deepcopy(tm)
    with torch.no_grad():
        out = tm2(tb, use_running_average=False).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-4)
    mine = {k: v_.numpy() for k, v_ in tm2.state_dict().items()
            if k.endswith(("mean", "var"))}
    theirs = _flat(np_tree({"batch_stats": upd["batch_stats"]})["batch_stats"])
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_allclose(mine[k], theirs[k], atol=1e-5, rtol=1e-5, err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_masked_batchnorm_train_stats_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(10, 6)) * 2 + 1).astype(np.float32)
    mask = rng.random(10) < 0.6
    jm = JaxMaskedBatchNorm()
    v = jm.init(jax.random.PRNGKey(0), x, mask)
    v = jax.tree_util.tree_map(lambda a: a + 0.3, v)  # non-trivial scale/bias/stats
    ref, upd = jm.apply(v, x, mask, mutable=["batch_stats"])
    tm = MaskedBatchNorm(6)
    load_flax_variables(tm, np_tree(v))
    out = tm(t(x), t(mask), use_running_average=False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(tm.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_gnn2d_training_forward_and_grads_match_jax(gnn_pair, compute_dtype):
    """Training mode (batch statistics) with dropout off, and the gradients
    of every parameter.  The JAX side runs its message block as the Pallas
    kernel in interpret mode, whose roundings the port's plain version
    follows.  Output: f32 1e-5, bf16 2e-2 relative.  Gradients relative to
    each leaf's largest value: f32 1e-4, bf16 1e-2 (the same roundings in
    the same places; most leaves agree exactly).  The two Dense biases of a
    GINConv sit in front of a training-mode BatchNorm, so their gradient is
    zero in exact arithmetic and rounding noise in practice: they are held
    to 1e-6 (f32) or 5e-3 (bf16) of the largest gradient instead."""
    _, v, _, jb, tb = gnn_pair
    jm = JaxGNN2D(num_layers=2, emb_dim=16, compute_dtype=compute_dtype,
                  msg_impl="pallas_interpret")
    g = np.random.default_rng(8).normal(size=(jb.num_nodes, 16)).astype(np.float32)

    def jax_loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb,
                          deterministic=True, use_running_average=False,
                          mutable=["batch_stats"])
        return (out * g).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(v["params"])
    tm = load_flax_variables(GNN2D(num_layers=2, emb_dim=16, compute_dtype=compute_dtype,
                                   device=CPU), np_tree(v))
    out_t = tm(tb, use_running_average=False)
    (out_t * t(g)).sum().backward()
    f32 = compute_dtype is None
    assert rel_err(out_t.detach().numpy(), np.asarray(out_j)) < (1e-5 if f32 else 2e-2)
    flat_j = _flat(np_tree({"params": grads_j})["params"])
    scale = max(float(np.abs(r).max()) for r in flat_j.values())
    for name, p in tm.named_parameters():
        diff = float(np.abs(p.grad.numpy() - flat_j[name]).max())
        if name.startswith("GINConv_") and name.endswith(("Dense_0.bias", "Dense_1.bias")):
            assert diff <= (1e-6 if f32 else 5e-3) * scale, (name, diff)
        else:
            err = diff / max(float(np.abs(flat_j[name]).max()), 1e-12)
            assert err < (1e-4 if f32 else 1e-2), (name, err)
