"""Port parity: the plain versions of the slice-2 kernels against the
Pallas kernels in interpret mode, forward and ``jax.vjp``.

K1 ``gin_messages`` backward, K2 ``fused_cfconv`` forward and backward, K3
``pair_relu_project`` backward, each in f32 and bf16 mode, through the
port's ``torch.autograd.Function`` (plain on the CPU).  Tolerances, relative
to each output's largest value: f32 1e-5 (the same sums in another order);
bf16 as stated per kernel: the two sides round at the same places, so they
differ by at most one bf16 ulp (2^-8) where an f32 sum taken in another
order lands on the other side of a rounding boundary, plus what that ulp
feeds downstream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.ops.cfconv import fused_cfconv as jax_fused_cfconv
from moleculesde_tpu.ops.gin_messages import gin_messages as jax_gin_messages
from moleculesde_tpu.ops.pair_block import pair_relu_project as jax_pair_relu_project
from moleculesde_tpu_torch.ops.cfconv import fused_cfconv
from moleculesde_tpu_torch.ops.gin_messages import gin_messages
from moleculesde_tpu_torch.ops.pair_block import pair_relu_project

from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)


def _gin_operands():
    rng = np.random.default_rng(11)
    b, n, e, d, f = 3, 8, 16, 13, 12
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    src = rng.integers(0, n + 1, size=(b, e)).astype(np.int32)   # n == masked
    dst = rng.integers(0, n + 1, size=(b, e)).astype(np.int32)
    boh = np.zeros((b, e, d), np.float32)
    for lo, hi in ((0, 5), (5, 11), (11, 13)):
        boh[np.arange(b)[:, None], np.arange(e)[None], rng.integers(lo, hi, (b, e))] = 1
    tbl = (rng.normal(size=(d, f)) * 0.5).astype(np.float32)
    g = rng.normal(size=(b, n, f)).astype(np.float32)
    return (x, tbl), (src, dst, boh), g


def _cfconv_operands():
    rng = np.random.default_rng(12)
    b, n, gdim, f = 2, 6, 5, 8
    ea = rng.random((b, n, n, gdim)).astype(np.float32)
    env = (rng.random((b, n, n)) * (rng.random((b, n, n)) < 0.8)).astype(np.float32)
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    w1 = (rng.normal(size=(gdim, f)) / np.sqrt(gdim)).astype(np.float32)
    b1 = (rng.normal(size=f) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(f, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (rng.normal(size=f) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, n, f)).astype(np.float32)
    return (x, w1, b1, w2, b2), (ea, env), g


def _pair_operands():
    rng = np.random.default_rng(13)
    b, n, c, h = 2, 5, 12, 6
    a = (rng.normal(size=(b, n, c)) * 1.3 + 0.2).astype(np.float32)
    cc = rng.normal(size=(b, n, c)).astype(np.float32)
    w = (rng.normal(size=(c, h)) / np.sqrt(c)).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, h).astype(np.float32)
    g = rng.normal(size=(b, n, n, h)).astype(np.float32)
    return (a, cc, w, bias), (), g


def _jax_fns(kernel, bf16):
    if kernel == "gin_messages":
        return lambda x, tbl, src, dst, boh: jax_gin_messages(
            x, src, dst, boh, tbl, bf16=bf16, impl="pallas_interpret")
    if kernel == "fused_cfconv":
        return lambda x, w1, b1, w2, b2, ea, env: jax_fused_cfconv(
            ea, env, x, w1, b1, w2, b2, bf16=bf16, impl="pallas_interpret")
    return lambda a, c, w, bias: jax_pair_relu_project(
        a, c, w, bias, bf16=bf16, impl="pallas_interpret")


def _torch_fns(kernel, bf16):
    if kernel == "gin_messages":
        return lambda x, tbl, src, dst, boh: gin_messages(x, src, dst, boh, tbl, bf16=bf16)
    if kernel == "fused_cfconv":
        return lambda x, w1, b1, w2, b2, ea, env: fused_cfconv(
            ea, env, x, w1, b1, w2, b2, bf16=bf16)
    return lambda a, c, w, bias: pair_relu_project(a, c, w, bias, bf16=bf16)


OPERANDS = {"gin_messages": _gin_operands, "fused_cfconv": _cfconv_operands,
            "pair_relu_project": _pair_operands}
# bf16 tolerances: K1 and K3 round their inputs exactly alike and sum in
# f32, so only dx's final bf16 rounding can differ by one ulp; K2 also
# rounds the softplus output and the backward's dwf / dpre, so one flipped
# ulp there moves the weight gradients downstream
BF16_TOL = {"gin_messages": 2 ** -8, "fused_cfconv": 1e-2, "pair_relu_project": 2 ** -8}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", sorted(OPERANDS))
def test_plain_forward_and_vjp_match_pallas_kernel(kernel, bf16):
    diff, const, g = OPERANDS[kernel]()
    out_j, vjp = jax.vjp(lambda *d: _jax_fns(kernel, bf16)(*d, *const), *diff)
    grads_j = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_(True) for a in diff]
    out_t = _torch_fns(kernel, bf16)(*leaves, *map(t, const))
    grads_t = torch.autograd.grad(out_t, leaves, t(g))
    tol = BF16_TOL[kernel] if bf16 else 1e-5
    assert out_t.shape == out_j.shape
    assert rel_err(out_t.detach().numpy(), out_j) <= (1e-5 if bf16 else tol)
    assert len(grads_t) == len(grads_j)
    for i, (gt, gj) in enumerate(zip(grads_t, grads_j)):
        gj = np.asarray(gj, np.float32)
        assert gt.shape == gj.shape, i
        assert rel_err(gt.numpy(), gj) <= tol, (i, rel_err(gt.numpy(), gj))


def test_gin_messages_bwd_sentinel_edges():
    """An edge whose src is the sentinel N adds nothing to dx but its
    relu(emb) still reaches dtable; an edge whose dst is N passes nothing
    back -- as in the Pallas kernel."""
    (x, tbl), (src, dst, boh), g = _gin_operands()
    n = x.shape[1]
    for s_all, d_all in ((True, False), (False, True)):
        s = np.full_like(src, n) if s_all else src
        d = np.full_like(dst, n) if d_all else dst
        _, vjp = jax.vjp(lambda x_, t_: jax_gin_messages(
            x_, s, d, boh, t_, bf16=False, impl="pallas_interpret"), x, tbl)
        dx_j, dt_j = vjp(jnp.asarray(g))
        xl, tl = t(x).requires_grad_(True), t(tbl).requires_grad_(True)
        dx_t, dt_t = torch.autograd.grad(gin_messages(xl, t(s), t(d), t(boh), tl), [xl, tl],
                                         t(g))
        assert float(dx_t.abs().max()) == 0.0 == float(np.abs(dx_j).max())
        if s_all:
            assert float(dt_t.abs().max()) > 0.0
        np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), atol=1e-5, rtol=1e-5)
