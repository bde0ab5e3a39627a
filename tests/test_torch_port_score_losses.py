"""Port parity: the two score-matching training losses against the JAX
package, with the same weights and the same draws.

The draws replay the JAX losses' own key splits (``SDEModel2Dto3D.loss``:
noise and antithetic timesteps; ``SDEModel3Dto2D.loss``: timesteps,
adjacency and node noise) and are handed to the port as arrays.  Dropout is
off on both sides (``deterministic=True``); the 2D->3D model runs in
training mode, so its pair BatchNorm statistics update and are compared.
The JAX 2D->3D model runs its pair block as the Pallas kernel in interpret
mode, whose roundings the port's plain version follows.

Tolerances relative to the largest value: f32 1e-5 for losses, 1e-4 for
gradients (sums in another order through ~10 dependent layers).  bf16:
5e-2 for losses and 0.15 for gradients.  Both frameworks run the backward
of the bf16 layers in bf16 and round after different ops; the spread is
the size of JAX's own bf16 rounding noise (the port's f32 gradients differ
from JAX's bf16 ones by ~4% of a leaf's largest value, the port's bf16
ones by 4-10%)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.models import SDEModel3Dto2D as JaxSDEModel3Dto2D
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)

EMB = 16


def _flat(tree):
    return {".".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaf_err(mine, ref) -> float:
    """Largest difference relative to the leaf's largest value, floored at
    1e-2 for leaves that are zero in exact arithmetic (a bias that a
    training-mode BatchNorm removes gets rounding noise only)."""
    return float(np.abs(mine - ref).max() / max(np.abs(ref).max(), 1e-2))


def _check_grads(module, grads_j, tol):
    flat_j = _flat(grads_j)
    for name, p in module.named_parameters():
        if p.requires_grad:   # a leaf the loss never reaches has no grad
            mine = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))
            err = _leaf_err(mine, flat_j[name])
            assert err < tol, (name, err)
        else:  # frozen Fourier weights: stop_gradient in JAX
            assert float(np.abs(flat_j[name]).max()) == 0.0


@pytest.fixture(scope="module")
def batches():
    return both_batches(graphs(seed=31, count=4, n_max=8), n_max=8)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_sde_2dto3d_loss_matches_jax(batches, precision):
    jb, tb = batches
    bf16 = precision == "bfloat16"
    node_2d = np.random.default_rng(5).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    jm = JaxSDEModel2Dto3D(emb_dim=EMB, hidden_dim=16, variant=1, bf16_pairs=bf16,
                           score_dtype=precision, pair_impl="pallas_interpret")
    key = jax.random.PRNGKey(9)
    v = jax.jit(lambda k, n2d: jm.init({"params": k, "dropout": k}, n2d, jb, k,
                                       method=JaxSDEModel2Dto3D.loss))(key, jnp.asarray(node_2d))
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(lambda a: a * 1.2 + 0.1, v["batch_stats"])}
    k_loss = jax.random.PRNGKey(17)

    def jax_loss(params, n2d):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, n2d, jb,
                            k_loss, 0.0, deterministic=True, use_running_average=False,
                            mutable=["batch_stats"], method=JaxSDEModel2Dto3D.loss)
        return out["position"], upd["batch_stats"]

    (loss_j, stats_j), (g_params, g_node) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(node_2d))
    # replay the loss's own draws (score_2d3d.py:874-879)
    k_noise, k_t = jax.random.split(k_loss)
    draws = {"pos_noise": t(jax.random.normal(k_noise, jb.positions.shape)),
             "half": t(jax.random.randint(k_t, (jb.num_graphs // 2 + 1,), 0, 1000)).long()}

    tm = load_flax_variables(SDEModel2Dto3D(emb_dim=EMB, hidden_dim=16, variant=1,
                                            bf16_pairs=bf16, score_dtype=precision,
                                            device=CPU), np_tree(v))
    n2d = t(node_2d).requires_grad_(True)
    loss_t = tm.loss(n2d, tb, deterministic=True, use_running_average=False, draws=draws)
    loss_t.backward()
    tol_loss, tol_grad = (5e-2, 0.15) if bf16 else (1e-5, 1e-4)
    assert abs(loss_t.item() - float(loss_j)) <= tol_loss * abs(float(loss_j))
    assert rel_err(n2d.grad.numpy(), g_node) < tol_grad
    _check_grads(tm, g_params, tol_grad)
    stats_t = {k: b.numpy() for k, b in tm.named_buffers()}
    for name, s in _flat(stats_j).items():
        np.testing.assert_allclose(stats_t[name], s, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("bf16_attn", [False, True], ids=["f32", "bf16"])
def test_sde_3dto2d_loss_matches_jax(batches, bf16_attn):
    jb, tb = batches
    node_3d = np.random.default_rng(6).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    kw = dict(dim3d=EMB, variant=1, bf16_attn=bf16_attn)
    jm = JaxSDEModel3Dto2D(**kw)
    v = jax.jit(lambda n3d: jm.init(jax.random.PRNGKey(2), n3d, jb, jax.random.PRNGKey(3),
                                    method=JaxSDEModel3Dto2D.loss))(jnp.asarray(node_3d))
    k_loss = jax.random.PRNGKey(23)

    def jax_loss(params, n3d):
        lx, ladj = jm.apply({"params": params}, n3d, jb, k_loss, 0.0, True,
                            method=JaxSDEModel3Dto2D.loss)
        return 0.5 * (lx + ladj), (lx, ladj)

    (_, (lx_j, ladj_j)), (g_params, g_node) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(node_3d))
    # replay the loss's own draws (score_3d2d.py:401-433)
    k_t, k_adj, k_x = jax.random.split(k_loss, 3)
    b, n = jb.num_graphs, jb.n_max
    draws = {"half": t(jax.random.randint(k_t, (b // 2 + 1,), 0, 1000)).long(),
             "z_adj": t(jax.random.normal(k_adj, (b, n, n))),
             "z_x": t(jax.random.normal(k_x, (b, n, 119)))}

    tm = load_flax_variables(SDEModel3Dto2D(**kw, device=CPU), np_tree(v))
    n3d = t(node_3d).requires_grad_(True)
    lx_t, ladj_t = tm.loss(n3d, tb, draws=draws)
    (0.5 * (lx_t + ladj_t)).backward()
    tol_loss, tol_grad = (5e-2, 0.15) if bf16_attn else (1e-5, 1e-4)
    for a, b_ in ((lx_t, lx_j), (ladj_t, ladj_j)):
        assert abs(a.item() - float(b_)) <= tol_loss * abs(float(b_))
    assert rel_err(n3d.grad.numpy(), g_node) < tol_grad
    _check_grads(tm, g_params, tol_grad)


def test_sde_losses_draw_from_the_generator(batches):
    """Without explicit draws the losses take them from the generator: the
    same seed gives the same loss, another seed another one."""
    _, tb = batches
    m23 = SDEModel2Dto3D(emb_dim=EMB, hidden_dim=16, variant=1, device=CPU)
    m32 = SDEModel3Dto2D(dim3d=EMB, device=CPU)
    node = torch.randn(tb.num_nodes, EMB, generator=torch.Generator().manual_seed(0))

    def losses(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return (m23.loss(node, tb, g, use_running_average=True).item(),
                    *(x.item() for x in m32.loss(node, tb, g)))

    assert losses(1) == losses(1)
    assert losses(1) != losses(2)
