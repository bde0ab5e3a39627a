"""Port parity: K5 (``fused_cfconv_rbf``, the CFConv fed from raw
distances) and SchNet's ``cfconv="pallas_rbf"`` against the JAX package.

- K5's plain forward against JAX's ``fused_cfconv_rbf`` with the Pallas
  kernel in interpret mode: f32 1e-5 of the largest output (the same
  smearing, ``_smear``'s, and sums in another order); bf16 1e-2 (both
  sides round ea, x, the weights and the softplus output to bf16, so an f32
  sum taken in another order can move a rounded value by one bf16 ulp).
- K5's plain gradients (x and the four weights) against ``jax.vjp`` of the
  same call, f32, 2e-4 as the JAX package's own test.
- The rbf form against K2's on ``gaussian_smearing(dist)``: 1e-5 (the two
  smearings differ in their last bits only).
- The wrapper refuses a ``dist`` or ``env`` that requires a gradient.
- SchNet ``cfconv="pallas_rbf"`` against JAX SchNet
  ``"pallas_rbf_interpret"`` on converted weights: latent 1e-5, gradients
  1e-4 (two interactions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models.schnet import SchNet as JaxSchNet
from moleculesde_tpu.ops.cfconv import fused_cfconv_rbf as jax_fused_cfconv_rbf
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.schnet import SchNet
from moleculesde_tpu_torch.ops.cfconv import (
    fused_cfconv, fused_cfconv_rbf, fused_cfconv_rbf_bwd, fused_cfconv_rbf_plain, smear)
from moleculesde_tpu_torch.ops.fourier import gaussian_smearing

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)

CUTOFF = 10.0


def _operands(b=3, n=8, gdim=7, f=16, seed=0):
    rng = np.random.default_rng(seed)
    dist = (np.abs(rng.normal(size=(b, n, n))) * 4.0).astype(np.float32)
    env = (rng.random((b, n, n)) * (rng.random((b, n, n)) < 0.8)).astype(np.float32)
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    w1 = (rng.normal(size=(gdim, f)) / np.sqrt(gdim)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    w2 = (rng.normal(size=(f, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    g = rng.normal(size=(b, n, f)).astype(np.float32)
    return (dist, env, x, w1, b1, w2, b2), g


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_rbf_plain_forward_matches_pallas_interpret(bf16):
    ops, _ = _operands()
    gdim = ops[3].shape[0]
    ref = jax_fused_cfconv_rbf(*ops, start=0.0, stop=CUTOFF, num_gaussians=gdim,
                               bf16=bf16, impl="pallas_interpret")
    out = fused_cfconv_rbf_plain(*(t(a) for a in ops), start=0.0, stop=CUTOFF,
                                 num_gaussians=gdim, bf16=bf16)
    assert rel_err(out.numpy(), ref) < (1e-2 if bf16 else 1e-5)


def test_rbf_plain_grads_match_jax_vjp():
    ops, g = _operands(seed=1)
    dist, env = ops[0], ops[1]
    gdim = ops[3].shape[0]

    def f(*params):
        return jax_fused_cfconv_rbf(dist, env, *params, start=0.0, stop=CUTOFF,
                                    num_gaussians=gdim, bf16=False, impl="pallas_interpret")

    _, vjp = jax.vjp(f, *ops[2:])
    ref = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_(True) for a in ops[2:]]
    out = fused_cfconv_rbf(t(dist), t(env), *leaves, start=0.0, stop=CUTOFF,
                           num_gaussians=gdim)
    mine = torch.autograd.grad(out, leaves, t(g))
    direct = fused_cfconv_rbf_bwd(*(t(a) for a in ops), t(g), start=0.0, stop=CUTOFF,
                                  num_gaussians=gdim)
    for m, d, r in zip(mine, direct, ref):
        r = np.asarray(r).reshape(tuple(m.shape))
        np.testing.assert_allclose(m.numpy(), r, atol=2e-4, rtol=2e-4)
        assert torch.equal(m, d)


def test_rbf_form_matches_k2_on_gaussian_smearing():
    ops, _ = _operands(seed=2)
    dist, env, x, w1, b1, w2, b2 = (t(a) for a in ops)
    gdim = w1.shape[0]
    ref = fused_cfconv(gaussian_smearing(dist, 0.0, CUTOFF, gdim), env, x, w1, b1, w2, b2)
    out = fused_cfconv_rbf(dist, env, x, w1, b1, w2, b2, start=0.0, stop=CUTOFF,
                           num_gaussians=gdim)
    assert rel_err(out.numpy(), ref.numpy()) < 1e-5
    ea = smear(dist, 0.0, CUTOFF, gdim)
    np.testing.assert_allclose(ea.numpy(), gaussian_smearing(dist, 0.0, CUTOFF, gdim).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["dist", "env"])
def test_rbf_refuses_geometry_gradients(which):
    ops = dict(zip(("dist", "env", "x", "w1", "b1", "w2", "b2"),
                   (t(a) for a in _operands()[0])))
    ops[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient to dist or env"):
        fused_cfconv_rbf(*ops.values(), start=0.0, stop=CUTOFF, num_gaussians=7)
    with torch.no_grad():   # no gradient asked for: runs
        fused_cfconv_rbf(*ops.values(), start=0.0, stop=CUTOFF, num_gaussians=7)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_schnet_pallas_rbf_matches_jax(dtype):
    width = dict(hidden_channels=16, num_filters=16, num_interactions=2, num_gaussians=11,
                 cutoff=5.0)
    jb, tb = both_batches(graphs(seed=23, count=3, n_max=9), n_max=9)
    jm = JaxSchNet(**width, compute_dtype=dtype, cfconv="pallas_rbf_interpret")
    v = jm.init(jax.random.PRNGKey(5), jb.atomic_numbers, jb.positions, jb.node_mask,
                jb.num_graphs, jb.n_max)
    tm = load_flax_variables(SchNet(**width, compute_dtype=dtype, cfconv="pallas_rbf",
                                    device=CPU), np_tree(v))
    assert tm.geometry(tb.positions, tb.node_mask, tb.num_graphs, tb.n_max)[0] is None
    g_lat = np.random.default_rng(6).normal(
        size=(jb.num_nodes, width["hidden_channels"])).astype(np.float32)

    def jax_loss(params):
        pooled, latent = jm.apply({"params": params}, jb.atomic_numbers, jb.positions,
                                  jb.node_mask, jb.num_graphs, jb.n_max)
        return jnp.sum(latent * g_lat) + jnp.sum(pooled), latent

    (_, latent_j), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(v["params"])
    pooled_t, latent_t = tm.encode_batch(tb)
    ((latent_t * t(g_lat)).sum() + pooled_t.sum()).backward()
    f32 = dtype is None
    # bf16: both sides round at the kernel's points; the eager rest of the
    # block rounds its products at slightly different places (as K2's test)
    assert rel_err(latent_t.detach().numpy(), latent_j) < (1e-5 if f32 else 3e-2)
    flat_j = {".".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf in
              jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    for name, p in tm.named_parameters():
        assert rel_err(p.grad.numpy(), flat_j[name]) < (1e-4 if f32 else 3e-2), name
