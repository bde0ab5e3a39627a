"""Port parity: the channel-major pair block K4 (``pair_relu_project_cm``)
and the 2D->3D loss that takes it (``pair_cm_direct=True``) against the JAX
package.

- The port's plain K4, forward and gradients through its
  ``torch.autograd.Function`` (a, c, w, and the bias added outside the
  kernel), against the Pallas kernel in interpret mode under ``jax.vjp``.
  f32: 1e-5 relative (the same sums in another order).  bf16: 2^-8, as for
  K3: both sides round a and c before the add, the relu'd pair, g, w and
  dpair at the same places, so they differ by at most one bf16 ulp where
  an f32 sum taken in another order lands on the other side of a rounding
  boundary.
- The SDE 2D->3D loss with ``pair_cm_direct=True`` on the JAX loss's own
  draws, f32 with the pair block as the interpreted kernel on the JAX side:
  loss 1e-5, every gradient leaf 1e-4 of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.ops.pair_block import pair_relu_project_cm as jax_pair_relu_project_cm
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.ops.pair_block import (
    pair_relu_project, pair_relu_project_cm, pair_relu_project_cm_plain)

from test_torch_port_score_losses import _check_grads
from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)

EMB = 16


def _operands():
    rng = np.random.default_rng(21)
    b, n, c, h = 2, 6, 12, 5
    a = (rng.normal(size=(b, n, c)) * 1.3 + 0.2).astype(np.float32)
    cc = rng.normal(size=(b, n, c)).astype(np.float32)
    w = (rng.normal(size=(c, h)) / np.sqrt(c)).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, h).astype(np.float32)
    g = rng.normal(size=(b, h, n * n)).astype(np.float32)
    return a, cc, w, bias, g


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pair_relu_project_cm_matches_pallas_kernel(bf16):
    a, cc, w, bias, g = _operands()
    out_j, vjp = jax.vjp(lambda *d: jax_pair_relu_project_cm(
        *d, bf16=bf16, impl="pallas_interpret"), a, cc, w, bias)
    grads_j = vjp(jnp.asarray(g))
    leaves = [t(x).requires_grad_(True) for x in (a, cc, w, bias)]
    out_t = pair_relu_project_cm(*leaves, bf16=bf16)
    grads_t = torch.autograd.grad(out_t, leaves, t(g))
    tol = 2 ** -8 if bf16 else 1e-5
    assert out_t.shape == out_j.shape == (2, 5, 36)
    assert rel_err(out_t.detach().numpy(), out_j) <= tol
    for i, (gt, gj) in enumerate(zip(grads_t, grads_j)):
        gj = np.asarray(gj, np.float32)
        assert gt.shape == gj.shape, i
        assert rel_err(gt.numpy(), gj) <= tol, (i, rel_err(gt.numpy(), gj))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pair_relu_project_cm_is_the_transposed_pair_block(bf16):
    """K4 is K3's function stored channel-major: exactly so in f32; in bf16
    K4 also rounds a and c before the add, as the TPU kernel does."""
    a, cc, w, bias, _ = (t(x) for x in _operands())
    b, n, _ = a.shape
    k3 = pair_relu_project(a, cc, w, bias).reshape(b, n * n, -1).transpose(1, 2)
    k4 = pair_relu_project_cm(a, cc, w, bias)
    np.testing.assert_allclose(k4.detach().numpy(), k3.detach().numpy(), atol=1e-6)
    rounded = [x.to(torch.bfloat16).float() for x in (a, cc)]
    np.testing.assert_array_equal(
        pair_relu_project_cm_plain(a, cc, w, bf16=True).numpy(),
        pair_relu_project_cm_plain(*rounded, w, bf16=True).numpy())


def test_sde_2dto3d_loss_pair_cm_direct_matches_jax():
    jb, tb = both_batches(graphs(seed=33, count=4, n_max=8), n_max=8)
    node_2d = np.random.default_rng(8).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    jm = JaxSDEModel2Dto3D(emb_dim=EMB, hidden_dim=16, variant=1, pair_cm_direct=True,
                           pair_impl="pallas_interpret")
    key = jax.random.PRNGKey(4)
    v = jax.jit(lambda k, n2d: jm.init({"params": k, "dropout": k}, n2d, jb, k,
                                       method=JaxSDEModel2Dto3D.loss))(key, jnp.asarray(node_2d))
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(lambda x: x * 1.2 + 0.1, v["batch_stats"])}
    k_loss = jax.random.PRNGKey(19)

    def jax_loss(params, n2d):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, n2d, jb,
                          k_loss, 0.0, deterministic=True, use_running_average=False,
                          mutable=["batch_stats"], method=JaxSDEModel2Dto3D.loss)
        return out["position"]

    loss_j, (g_params, g_node) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        v["params"], jnp.asarray(node_2d))
    k_noise, k_t = jax.random.split(k_loss)
    draws = {"pos_noise": t(jax.random.normal(k_noise, jb.positions.shape)),
             "half": t(jax.random.randint(k_t, (jb.num_graphs // 2 + 1,), 0, 1000)).long()}
    tm = load_flax_variables(SDEModel2Dto3D(emb_dim=EMB, hidden_dim=16, variant=1,
                                            pair_cm_direct=True, device=CPU), np_tree(v))
    n2d = t(node_2d).requires_grad_(True)
    loss_t = tm.loss(n2d, tb, deterministic=True, use_running_average=False, draws=draws)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert rel_err(n2d.grad.numpy(), g_node) < 1e-4
    _check_grads(tm, g_params, 1e-4)
