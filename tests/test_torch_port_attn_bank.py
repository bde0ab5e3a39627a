"""Port parity: the attention-bank kernels' plain versions (K7
``ops/attn_bank.py``, K8 ``ops/attn_qk_bank.py``) against the JAX package's
Pallas kernels in interpret mode, forward and every gradient, on the same
numpy-seeded operands and cotangent; and the eager bank's "xla" / "wide"
forms against JAX's.

Tolerances, relative to the largest reference value: f32 1e-5 forward and
1e-4 for gradients (the same sums in another order).  bf16 1e-2: both
sides round at the same points, so they differ only where an f32 value
summed in another order lands on the other side of a bf16 rounding
boundary (one bf16 ulp, 2^-8, of an intermediate)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.ops.attn_maps import attn_map_bank as jax_attn_map_bank
from moleculesde_tpu.ops.rejected.attn_qk_bank import attn_qk_bank as jax_attn_qk_bank
from moleculesde_tpu_torch.ops.attn_bank import (
    attn_map_bank_kernel, attn_map_bank_kernel_bwd)
from moleculesde_tpu_torch.ops.attn_maps import attn_map_bank
from moleculesde_tpu_torch.ops.attn_qk_bank import attn_qk_bank, attn_qk_bank_bwd

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    ieee_f32, numeric_state, rel_err, t)


def _tols(bf16):
    return (1e-2, 1e-2) if bf16 else (1e-5, 1e-4)


def _map_operands(seed, b=2, c=3, n=8, a=16):
    rng = np.random.default_rng(seed)
    q = (0.8 * rng.normal(size=(b, c, n, a))).astype(np.float32)
    k = (0.8 * rng.normal(size=(b, c, n, a))).astype(np.float32)
    g = rng.normal(size=(b, c, n, n)).astype(np.float32)
    return q, k, g


def _map_oracle(q, k, g, ds, bf16):
    """float64 numpy oracle of K7: the maps and (dq, dk) for the cotangent
    ``g``, from q / k rounded to bf16 first in bf16 mode."""
    if bf16:
        q, k = (torch.from_numpy(v).bfloat16().double().numpy() for v in (q, k))
    b, c, n, a = q.shape
    h, inv = a // ds, 1.0 / math.sqrt(ds)
    qh = q.astype(np.float64).reshape(b, c, n, h, ds)
    kh = k.astype(np.float64).reshape(b, c, n, h, ds)
    th = np.tanh(np.einsum("bcnhd,bcmhd->bchnm", qh, kh) * inv)
    du = g.astype(np.float64)[:, :, None] * (1.0 - th * th) * (inv / h)
    return (th.sum(axis=2) / h,
            np.einsum("bchnm,bcmhd->bcnhd", du, kh).reshape(b, c, n, a),
            np.einsum("bchnm,bcnhd->bcmhd", du, qh).reshape(b, c, n, a))


def _where(mine, ref):
    """(rel_err, argmax index, mine there, ref there) of ``mine`` against
    ``ref``: the error relative to max |ref| and where it is largest."""
    mine = np.asarray(mine, np.float64)
    ref = np.asarray(ref, np.float64)
    diff = np.abs(mine - ref)
    at = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape))
    return float(diff.max() / (np.abs(ref).max() + 1e-12)), at, float(mine[at]), float(ref[at])


def _check_side(side, name, mine, ref, tol):
    rel, at, got, want = _where(mine, ref)
    assert rel < tol, (f"{side}: {name} rel_err {rel:.3e} >= {tol:g} at {at}: "
                       f"{got!r} against {want!r}; {numeric_state()}")


@pytest.mark.parametrize("ds", [2, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_map_bank_plain_matches_pallas_kernel(ds, bf16):
    """K7 through JAX's dispatcher (``impl="pallas_interpret"``) and the
    port's (``impl="pallas"``, the plain version on the CPU): maps, dq, dk,
    the port against JAX, the port against a float64 oracle and JAX against
    the oracle, each at the same bars.  A failure names the side, the
    output, the relative error and where it is largest.

    Runs with IEEE f32 products pinned in both frameworks (the autouse
    ``ieee_f32`` fixture); a failure also prints the process's numeric
    settings (``torch_port_common.numeric_state``)."""
    q, k, g = _map_operands(1)
    out_j, vjp = jax.vjp(lambda q_, k_: jax_attn_map_bank(
        q_, k_, ds, bf16=bf16, impl="pallas_interpret"), jnp.asarray(q), jnp.asarray(k))
    dq_j, dk_j = vjp(jnp.asarray(g))
    qt, kt = t(q).requires_grad_(True), t(k).requires_grad_(True)
    out_t = attn_map_bank(qt, kt, ds, bf16=bf16, impl="pallas")
    out_t.backward(t(g))
    tol_f, tol_g = _tols(bf16)
    assert out_t.dtype == torch.float32 and out_t.shape == (2, 3, 8, 8)
    port = (out_t.detach().numpy(), qt.grad.numpy(), kt.grad.numpy())
    jax_side = tuple(np.asarray(x) for x in (out_j, dq_j, dk_j))
    oracle = _map_oracle(q, k, g, ds, bf16)
    for side, mine, ref in (("port vs JAX", port, jax_side),
                            ("port vs float64 oracle", port, oracle),
                            ("JAX vs float64 oracle", jax_side, oracle)):
        for name, m, r, tol in zip(("map", "dq", "dk"), mine, ref, (tol_f, tol_g, tol_g)):
            _check_side(side, name, m, r, tol)


@pytest.mark.parametrize("impl", ["xla", "wide"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_eager_bank_forms_match_jax(impl, bf16):
    q, k, g = _map_operands(2)
    out_j, vjp = jax.vjp(lambda q_, k_: jax_attn_map_bank(q_, k_, 4, bf16=bf16, impl=impl),
                         jnp.asarray(q), jnp.asarray(k))
    qt, kt = t(q).requires_grad_(True), t(k).requires_grad_(True)
    out_t = attn_map_bank(qt, kt, 4, bf16=bf16, impl=impl)
    out_t.backward(t(g))
    tol_f, tol_g = _tols(bf16)
    assert rel_err(out_t.detach().numpy(), out_j) < tol_f
    for mine, ref in zip((qt.grad, kt.grad), vjp(jnp.asarray(g))):
        assert rel_err(mine.numpy(), ref) < tol_g


def _qk_operands(seed, b=3, n=8, f=12, c=3, a=8):
    rng = np.random.default_rng(seed)
    shapes = [(b, n, f), (c, f, a), (c, a), (c, a, a), (c, a),
              (c, f, a), (c, a), (c, a, a), (c, a)]
    ops = [rng.normal(size=s).astype(np.float32) * (1.0 if i == 0 else 0.4)
           for i, s in enumerate(shapes)]
    return ops, rng.normal(size=(b, c, n, n)).astype(np.float32)


@pytest.mark.parametrize("ds", [2, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_qk_bank_plain_matches_pallas_kernel(ds, bf16):
    """K8: the maps, dqk and the eight weight gradients against
    ``attn_qk_bank(..., impl="pallas_interpret")`` of the JAX package."""
    ops, g = _qk_operands(3)
    out_j, vjp = jax.vjp(lambda *a: jax_attn_qk_bank(*a, ds, bf16=bf16,
                                                     impl="pallas_interpret"),
                         *(jnp.asarray(o) for o in ops))
    grads_j = vjp(jnp.asarray(g))
    leaves = [t(o).requires_grad_(True) for o in ops]
    out_t = attn_qk_bank(*leaves, ds, bf16=bf16)
    out_t.backward(t(g))
    tol_f, tol_g = _tols(bf16)
    assert out_t.dtype == torch.float32 and out_t.shape == (3, 3, 8, 8)
    assert rel_err(out_t.detach().numpy(), out_j) < tol_f
    for i, (leaf, ref) in enumerate(zip(leaves, grads_j)):
        assert leaf.grad.dtype == torch.float32
        assert rel_err(leaf.grad.numpy(), ref) < tol_g, i


def test_bank_wrappers_take_plain_on_cpu_and_count_no_launch():
    q, k, g = (t(x) for x in _map_operands(4))
    ops, gq = _qk_operands(5)
    ops = [t(o) for o in ops]
    wrappers = (attn_map_bank_kernel, attn_map_bank_kernel_bwd, attn_qk_bank,
                attn_qk_bank_bwd)
    counts = [f.launches for f in wrappers]
    assert attn_map_bank_kernel(q, k, 4).shape == (2, 3, 8, 8)
    assert [x.shape for x in attn_map_bank_kernel_bwd(q, k, g, 4)] == [q.shape, k.shape]
    assert attn_qk_bank(*ops, 4).shape == (3, 3, 8, 8)
    grads = attn_qk_bank_bwd(*ops, t(gq), 4)
    assert [x.shape for x in grads] == [o.shape for o in ops]
    with pytest.raises(ValueError, match="CUDA"):
        attn_map_bank_kernel(q, k, 4, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        attn_map_bank_kernel_bwd(q, k, g, 4, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        attn_qk_bank(*ops, 4, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        attn_qk_bank_bwd(*ops, t(gq), 4, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        attn_map_bank(q, k, 4, impl="pallas_interpret")
    assert [f.launches for f in wrappers] == counts


def test_bank_bf16_mode_keeps_logits_in_f32():
    """K7's bf16 mode rounds only q and k: its maps equal the f32 maps of
    the rounded operands, which the eager bf16 form (logits and tanh in
    bf16) does not."""
    q, k, _ = (t(x) for x in _map_operands(6))
    rq, rk = q.bfloat16().float(), k.bfloat16().float()
    assert torch.equal(attn_map_bank(q, k, 4, bf16=True, impl="pallas"),
                       attn_map_bank(rq, rk, 4, impl="pallas"))
    assert not torch.equal(attn_map_bank(q, k, 4, bf16=True, impl="xla"),
                           attn_map_bank(rq, rk, 4, impl="xla"))
