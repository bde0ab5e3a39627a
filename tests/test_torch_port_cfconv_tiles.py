"""Port parity: the CFConv backward (K2 ``fused_cfconv_bwd``, K5
``fused_cfconv_rbf_bwd``) past n_max 32, and the launch plan of its kernel.

- The plain backward of K2 and K5 against ``jax.vjp`` of the JAX package's
  ``fused_cfconv`` / ``fused_cfconv_rbf`` with the Pallas kernels in
  interpret mode, at N = 40 and N = 64 (the JAX wrappers put no cap on N):
  f32 2e-4 (atol and rtol, as ``test_torch_port_cfconv_rbf.py``'s gradient
  bar: the same sums in another order); bf16 1e-2 of the largest value (its
  bf16 bar: both sides round ea, x, the weights, s, dwf and dpre to bf16 at
  the same points, so an f32 sum taken in another order moves a rounded
  value by at most one bf16 ulp).
- The kernel's launch plan (``ops/cfconv.py::bwd_plan``, which the CUDA
  source's ``cfconv_bwd_plan`` mirrors; the card test holds the two
  together): the tile sizes at the sizes users run and shared memory within
  ``SMEM_LIMIT`` for every N, bf16 and f32.
- The plan's schedule replayed in float64 (units of J columns, rows in
  chunks of IC, zero-filled padding of N, G and F, dx summed over the row
  groups and chunks in the kernel's order) gives the plain backward's
  gradients (f32): 2e-5 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.ops.cfconv import fused_cfconv as jax_fused_cfconv
from moleculesde_tpu.ops.cfconv import fused_cfconv_rbf as jax_fused_cfconv_rbf
from moleculesde_tpu_torch.ops.cfconv import (
    bwd_plan, fused_cfconv, fused_cfconv_bwd_plain, fused_cfconv_rbf, smear)
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT

from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)

CUTOFF = 10.0


def _operands(b, n, gdim, f, seed):
    rng = np.random.default_rng(seed)
    dist = (np.abs(rng.normal(size=(b, n, n))) * 4.0).astype(np.float32)
    env = (rng.random((b, n, n)) * (rng.random((b, n, n)) < 0.8)).astype(np.float32)
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    w1 = (rng.normal(size=(gdim, f)) / np.sqrt(gdim)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    w2 = (rng.normal(size=(f, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    g = rng.normal(size=(b, n, f)).astype(np.float32)
    return dist, env, (x, w1, b1, w2, b2), g


def _check_grads(mine, ref, bf16):
    for m, r in zip(mine, ref):
        r = np.asarray(r, np.float32).reshape(tuple(m.shape))
        if bf16:
            assert rel_err(m.numpy(), r) < 1e-2
        else:
            np.testing.assert_allclose(m.numpy(), r, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("n", [40, 64])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k2_backward_past_n32_matches_pallas_interpret(n, bf16):
    dist, env, params, g = _operands(2, n, 5, 16, seed=n)
    ea = np.asarray(smear(t(dist), 0.0, CUTOFF, 5))

    def f(*p):
        return jax_fused_cfconv(ea, env, *p, bf16=bf16, impl="pallas_interpret")

    _, vjp = jax.vjp(f, *params)
    leaves = [t(a).requires_grad_(True) for a in params]
    out = fused_cfconv(t(ea), t(env), *leaves, bf16=bf16)
    _check_grads(torch.autograd.grad(out, leaves, t(g)), vjp(jnp.asarray(g)), bf16)


@pytest.mark.parametrize("n", [40, 64])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k5_backward_past_n32_matches_pallas_interpret(n, bf16):
    dist, env, params, g = _operands(2, n, 5, 16, seed=n + 1)
    kw = dict(start=0.0, stop=CUTOFF, num_gaussians=5, bf16=bf16)

    def f(*p):
        return jax_fused_cfconv_rbf(dist, env, *p, impl="pallas_interpret", **kw)

    _, vjp = jax.vjp(f, *params)
    leaves = [t(a).requires_grad_(True) for a in params]
    out = fused_cfconv_rbf(t(dist), t(env), *leaves, **kw)
    _check_grads(torch.autograd.grad(out, leaves, t(g)), vjp(jnp.asarray(g)), bf16)


# bytes of ea source per pair: K2's ea in bf16 or f32, K5's distance
SOURCES = {"bf16_ea": lambda gdim: 2 * gdim, "f32_ea": lambda gdim: 4 * gdim,
           "dist": lambda gdim: 4}


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("gdim,f", [(51, 128), (5, 16)])
@pytest.mark.parametrize("n", [7, 16, 32, 64, 128, 200])
def test_bwd_plan_fits_shared_memory_at_every_n(n, gdim, f, bf16, source):
    """No cap on N: the tiles do not grow with it.  At the main path's
    widths (G=51, F=128) a tile holds 64 pairs: J=2 columns of 32 rows at
    N=32, one column at N=64, in 64-row chunks past that."""
    pair_bytes = SOURCES[source](gdim)
    plan = bwd_plan(n, gdim, f, bf16, pair_bytes)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["m"] * plan["fp"] == 8192 and plan["fp"] >= f
    assert plan["ic"] * plan["j"] == plan["m"] and plan["ic"] >= 16
    assert plan["chunks"] * plan["ic"] >= n > (plan["chunks"] - 1) * plan["ic"]
    assert plan["tiles"] * plan["j"] >= n > (plan["tiles"] - 1) * plan["j"]
    assert plan["g16"] % 16 == 0 and plan["g16"] - 16 < gdim <= plan["g16"]
    assert plan["smem"] == bwd_plan(2 * n, gdim, f, bf16, pair_bytes)["smem"] or n < plan["m"]
    if (gdim, f) == (51, 128):
        assert (plan["m"], plan["ic"], plan["j"]) == {
            7: (64, 16, 4), 16: (64, 16, 4), 32: (64, 32, 2)}.get(n, (64, 64, 1))
        assert plan["smem"] <= (148768 if bf16 else 204864)


def test_bwd_plan_refuses_only_weights_that_cannot_be_staged():
    """bf16 stages F up to 256 (F padded to 256: M = 32 pairs per tile); f32
    doubles every tile, and W2 [256, 256] f32 alone passes the limit."""
    assert bwd_plan(64, 64, 256, True, 128)["smem"] <= SMEM_LIMIT
    assert bwd_plan(64, 51, 256, False, 4)["smem"] > SMEM_LIMIT
    assert bwd_plan(64, 51, 300, True, 102) is None


def _replay_plan(ea, env, x, w1, b1, w2, b2, g):
    """The kernel's schedule in float64: every unit (graph, J columns), its
    row chunks in order; each tile's products on zero-padded operands; dx
    summed over each column's 16-row groups in order, then the chunks; dW
    and db summed over the tiles."""
    b, n, _, gdim = ea.shape
    f = x.shape[2]
    p = bwd_plan(n, gdim, f, False, 4 * gdim)
    fp, m, ic, jn, g16 = p["fp"], p["m"], p["ic"], p["j"], p["g16"]
    w1p = np.zeros((g16, fp))
    w1p[:gdim, :f] = w1
    w2p = np.zeros((fp, fp))
    w2p[:f, :f] = w2
    b1p, b2p = np.zeros(fp), np.zeros(fp)
    b1p[:f], b2p[:f] = b1, b2
    dx = np.zeros((b, n, f))
    dw1, dw2, db1, db2 = np.zeros((g16, fp)), np.zeros((fp, fp)), np.zeros(fp), np.zeros(fp)
    for u in range(b * p["tiles"]):
        bb, j0 = divmod(u, p["tiles"])
        j0 *= jn
        dx_acc = np.zeros((jn, fp))
        for ch in range(p["chunks"]):
            i0 = ch * ic
            eat, envt = np.zeros((m, g16)), np.zeros(m)
            gt, xt = np.zeros((m, fp)), np.zeros((m, fp))
            for row in range(m):
                jj, ii = divmod(row, ic)
                i, j = i0 + ii, j0 + jj
                if i < n and j < n:
                    eat[row, :gdim], envt[row] = ea[bb, i, j], env[bb, i, j]
                if i < n:
                    gt[row, :f] = g[bb, i]
                if j < n:
                    xt[row, :f] = x[bb, j]
            pre = eat @ w1p + b1p
            s = np.logaddexp(pre, 0.0) - np.log(2.0)
            wf = s @ w2p + b2p
            v = (wf * envt[:, None]) * gt
            groups = v.reshape(m // 16, 16, fp).sum(axis=1)          # per 16-row group
            dx_acc += groups.reshape(jn, ic // 16, fp).sum(axis=1)
            dwf = (gt * xt) * envt[:, None]
            dpre = (dwf @ w2p.T) * np.exp(pre - s - np.log(2.0))
            dw2 += s.T @ dwf
            dw1 += eat.T @ dpre
            db1 += dpre.sum(axis=0)
            db2 += dwf.sum(axis=0)
        for jj in range(jn):
            if j0 + jj < n:
                dx[bb, j0 + jj] = dx_acc[jj, :f]
    return dx, dw1[:gdim, :f], db1[:f], dw2[:f, :f], db2[:f]


@pytest.mark.parametrize("b,n,gdim,f", [(2, 40, 5, 16), (1, 70, 20, 100), (3, 7, 5, 16)])
def test_plan_schedule_replays_the_plain_backward(b, n, gdim, f):
    """Units, chunks and padding cover every pair once: the replay in
    float64 agrees with the plain backward in f32 to f32 rounding."""
    dist, env, params, g = _operands(b, n, gdim, f, seed=3)
    ea = smear(t(dist), 0.0, CUTOFF, gdim)
    ref = fused_cfconv_bwd_plain(ea, t(env), *(t(a) for a in params), t(g))
    args = [ea.numpy(), env, *params, g]
    for mine, r in zip(_replay_plan(*(np.asarray(a, np.float64) for a in args)), ref):
        assert rel_err(mine, r.numpy()) < 2e-5
