"""Port parity: pair block (moleculesde_tpu_torch.ops.pair_block) and the
pair BatchNorm against the JAX package.

Tolerances: f32 1e-5 (sums in another order); bf16 against the Pallas
kernel's own bf16 semantics 1e-5 (same roundings), against the JAX XLA form
3e-2 relative (it rounds the halves before the add)."""

import jax
import numpy as np
import pytest
import torch

from moleculesde_tpu.models.layers import PairMaskedBatchNorm as JaxPairBN
from moleculesde_tpu.ops.pair_block import pair_mean_var as jax_pair_mean_var
from moleculesde_tpu.ops.pair_block import pair_relu_project as jax_pair_relu_project
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.layers import PairMaskedBatchNorm
from moleculesde_tpu_torch.ops.pair_block import (
    pair_mean_var, pair_relu_project, pair_relu_project_plain)

from torch_port_common import ieee_f32, np_tree, rel_err, t  # noqa: F401 (ieee_f32: autouse)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    b, n, c, h = 3, 7, 24, 6
    src = (rng.normal(size=(b, n, c)) * 1.7 + 0.4).astype(np.float32)
    dst = (rng.normal(size=(b, n, c)) - 0.2).astype(np.float32)
    mask = rng.random((b, n, n)) < 0.4
    w = (rng.normal(size=(c, h)) / np.sqrt(c)).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, h).astype(np.float32)
    return src, dst, mask, w, bias


@pytest.mark.parametrize("bf16", [False, True])
def test_pair_relu_project_plain_matches_pallas_kernel(data, bf16):
    src, dst, _, w, bias = data
    ref = np.asarray(jax_pair_relu_project(src, dst, w, bias, bf16=bf16,
                                           impl="pallas_interpret"))
    out = pair_relu_project_plain(t(src), t(dst), t(w), t(bias), bf16=bf16).numpy()
    assert out.shape == ref.shape == (3, 7, 7, 6)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_pair_relu_project_matches_xla_form(data, bf16):
    src, dst, _, w, bias = data
    ref = np.asarray(jax_pair_relu_project(src, dst, w, bias, bf16=bf16, impl="xla"))
    out = pair_relu_project(t(src), t(dst), t(w), t(bias), bf16=bf16).numpy()
    assert rel_err(out, ref) < (3e-2 if bf16 else 1e-5)
    # the fused bias is a plain output offset
    no_bias = pair_relu_project(t(src), t(dst), t(w), bf16=bf16).numpy()
    np.testing.assert_allclose(out - no_bias, np.broadcast_to(bias, out.shape),
                               atol=1e-5)


def test_pair_mean_var_matches_jax(data):
    src, dst, mask, _, _ = data
    mj, vj = jax_pair_mean_var(src, dst, mask)
    mt, vt = pair_mean_var(t(src), t(dst), t(mask))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_running_average", [False, True])
def test_pair_masked_batchnorm_matches_jax(data, use_running_average):
    src, dst, mask, _, _ = data
    jm = JaxPairBN()
    v = jm.init(jax.random.PRNGKey(0), src, dst, mask)
    v = jax.tree_util.tree_map(lambda a: a * 1.5 + 0.2, v)
    (aj, cj), upd = jm.apply(v, src, dst, mask, use_running_average,
                             mutable=["batch_stats"])
    tm = load_flax_variables(PairMaskedBatchNorm(src.shape[-1]), np_tree(v))
    with torch.no_grad():
        at, ct = tm(t(src), t(dst), t(mask), use_running_average)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-5)
    np.testing.assert_allclose(tm.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-5, rtol=1e-5)
