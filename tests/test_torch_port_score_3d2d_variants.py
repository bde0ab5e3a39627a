"""Port parity: ``SDEModel3Dto2D`` variants 2-3 and the sampler's score
entry points against the JAX package on the same weights and draws (the
banks K7 / K8 inside the model: ``test_torch_port_score_3d2d_banks.py``).

Tolerances relative to the largest value, f32: 1e-5 for losses and scores,
1e-4 for gradients (sums in another order through the layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.core.masks import node_flags as jax_node_flags
from moleculesde_tpu.models import SDEModel3Dto2D as JaxSDEModel3Dto2D
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D

from test_torch_port_score_losses import _check_grads
from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)

EMB = 16


@pytest.fixture(scope="module")
def batches():
    return both_batches(graphs(seed=41, count=4, n_max=8), n_max=8)


def _loss_pair(batches, jax_kw, port_kw):
    """JAX loss terms and gradients, the port's, on converted weights and
    the JAX loss's own draws."""
    jb, tb = batches
    node_3d = np.random.default_rng(8).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    jm = JaxSDEModel3Dto2D(dim3d=EMB, **jax_kw)
    v = jax.jit(lambda n3d: jm.init(jax.random.PRNGKey(4), n3d, jb, jax.random.PRNGKey(5),
                                    method=JaxSDEModel3Dto2D.loss))(jnp.asarray(node_3d))
    k_loss = jax.random.PRNGKey(29)

    def jax_loss(params, n3d):
        lx, ladj = jm.apply({"params": params}, n3d, jb, k_loss, 0.0, True,
                            method=JaxSDEModel3Dto2D.loss)
        return 0.5 * (lx + ladj), (lx, ladj)

    (_, losses_j), (g_params, g_node) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(node_3d))
    k_t, k_adj, k_x = jax.random.split(k_loss, 3)
    b, n = jb.num_graphs, jb.n_max
    draws = {"half": t(jax.random.randint(k_t, (b // 2 + 1,), 0, 1000)).long(),
             "z_adj": t(jax.random.normal(k_adj, (b, n, n))),
             "z_x": t(jax.random.normal(k_x, (b, n, 119)))}
    tm = load_flax_variables(SDEModel3Dto2D(dim3d=EMB, **port_kw, device=CPU), np_tree(v))
    n3d = t(node_3d).requires_grad_(True)
    losses_t = tm.loss(n3d, tb, draws=draws)
    (0.5 * (losses_t[0] + losses_t[1])).backward()
    return losses_j, (g_params, g_node), tm, losses_t, n3d.grad


def _check(pair, tol_loss, tol_grad):
    losses_j, (g_params, g_node), tm, losses_t, g_node_t = pair
    for a, b_ in zip(losses_t, losses_j):
        assert abs(a.item() - float(b_)) <= tol_loss * abs(float(b_))
    assert rel_err(g_node_t.numpy(), g_node) < tol_grad
    _check_grads(tm, g_params, tol_grad)


@pytest.mark.parametrize("variant", [2, 3])
def test_variant_loss_matches_jax(batches, variant):
    """Concatenated (2) and per-layer injected (3) 3D conditioning: the loss
    terms and every gradient leaf, f32."""
    kw = dict(variant=variant, bf16_attn=False, nhid=8, num_layers=2)
    _check(_loss_pair(batches, kw, kw), 1e-5, 1e-4)


@pytest.mark.parametrize("method", ["score_x", "score_adj", "scores"])
def test_sampler_scores_match_jax(batches, method):
    """The sampler's entry points at a noisy state, variant 3 (every network
    and the injection), f32; ``scores`` gives both from one evaluation and
    the single-score methods skip the other network."""
    jb, tb = batches
    rng = np.random.default_rng(12)
    b, n = jb.num_graphs, jb.n_max
    node_3d = rng.normal(size=(b, n, EMB)).astype(np.float32)
    x = rng.normal(size=(b, n, 119)).astype(np.float32)
    adj = rng.normal(size=(b, n, n)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    tt = rng.uniform(0.1, 1.0, size=(b,)).astype(np.float32)
    edge = np.where(np.asarray(jb.edge_mask), np.asarray(jb.edge_feats[:, 0]) + 1.0, 0.0)
    flags = np.asarray(jax_node_flags(jb.dense_adjacency(jnp.asarray(edge, jnp.float32))))
    x, adj = x * flags[:, :, None], adj * flags[:, :, None] * flags[:, None, :]

    kw = dict(dim3d=EMB, variant=3, bf16_attn=False, nhid=8, num_layers=2)
    jm = JaxSDEModel3Dto2D(**kw)
    v = jax.jit(lambda z: jm.init(jax.random.PRNGKey(6), z, jb, jax.random.PRNGKey(7),
                                  method=JaxSDEModel3Dto2D.loss))(jnp.zeros((jb.num_nodes, EMB)))
    args = [jnp.asarray(a) for a in (node_3d, x, adj, flags, tt)]
    ref = jax.jit(lambda *a: jm.apply(v, *a, method=getattr(JaxSDEModel3Dto2D, method)))(*args)
    tm = load_flax_variables(SDEModel3Dto2D(**kw, device=CPU), np_tree(v))
    with torch.no_grad():
        out = getattr(tm, method)(*(t(a) for a in (node_3d, x, adj, flags, tt)))
    for mine, theirs in zip(out if method == "scores" else (out,),
                            ref if method == "scores" else (ref,)):
        assert rel_err(mine.numpy(), theirs) < 1e-5
    which = {"score_x": "x", "score_adj": "adj", "scores": "both"}[method]
    with torch.no_grad():
        net_x, net_adj = tm.apply_networks(*(t(a) for a in (node_3d, x, adj, flags)),
                                           which=which)
    assert (net_x is None) == (which == "adj") and (net_adj is None) == (which == "x")


def test_unknown_variant_or_bank_is_refused():
    with pytest.raises(ValueError, match="variant 4"):
        SDEModel3Dto2D(dim3d=EMB, variant=4, device=CPU)
    with pytest.raises(ValueError, match="attn_impl"):
        SDEModel3Dto2D(dim3d=EMB, attn_impl="fused_interpret", device=CPU)
    with pytest.raises(ValueError, match="which"):
        SDEModel3Dto2D(dim3d=EMB, device=CPU).apply_networks(None, None, None, None, "both x")
