"""Port parity: the fused score evaluation of ``SDEModel2Dto3D`` variants 3
and 4, and the score network's ``short_cut`` / ``concat_hidden``
(moleculesde_tpu_torch.models.score_2d3d) against the JAX package.

Bars, relative to the largest value: the fused evaluation (K6's plain
version) against JAX's ``score_from_cond_fused``, whose Pallas kernel runs
in interpret mode on the CPU, f32 2e-5 (tests/test_torch_port_score_kernel
.py's bar; K6's bf16 mode on these chains is held to its plain version on
the card by ``chip_smoke.py``); the score paths 2e-5 (sums in another
order through ~8 dependent layers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu_torch.ops import score_kernel

from test_torch_port_score_variants import _cond_jax, make_pair
from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)


@pytest.mark.parametrize("variant", [3, 4])
def test_score_from_cond_fused_matches_jax(variant):
    """Variants 3 / 4 pack and run the fused score evaluation as kernel
    variant 1 (K6's plain version here) on their own conditioning, against
    JAX's ``score_from_cond_fused`` (its Pallas kernel in interpret mode),
    at the kernel's widths (hidden 32, 8 heads, basis 128)."""
    jm, v, tm, jb, tb, node_2d = make_pair(variant, hid=32)
    pos = (1.5 * np.random.default_rng(3).normal(size=(jb.num_nodes, 3))).astype(np.float32)
    ref = np.asarray(jm.apply(v, _cond_jax(jm, v, node_2d, jb, "feature"), jb,
                              jnp.asarray(pos), method=JaxSDEModel2Dto3D.score_from_cond_fused))
    launches = score_kernel.score_eval_fused.launches
    with torch.no_grad():
        cond = tm.precompute_conditioning(t(node_2d), tb, layout="feature")
        packed = tm.packed_score_params()
        out = tm.score_from_cond_fused(cond, t(pos), packed)
    assert score_kernel.score_eval_fused.launches == launches   # plain on the CPU
    np.testing.assert_array_equal(packed.numpy(),
                                  score_kernel.pack_score_params(tm, 1).numpy())
    assert rel_err(out.numpy(), ref) < 2e-5


@pytest.mark.parametrize("flags", [{"short_cut": True}, {"concat_hidden": True},
                                   {"short_cut": True, "concat_hidden": True}],
                         ids=["short_cut", "concat_hidden", "both"])
def test_short_cut_concat_hidden_match_jax(flags):
    """``short_cut`` / ``concat_hidden`` (variant 3's network; the flags are
    the score network's, the same in every variant) on both score paths
    against JAX
    (``basis_node_m`` takes the width of every hidden so far under
    ``concat_hidden``), and the fused call routed to ``score_from_cond``
    as JAX routes it: the same numbers, no fused evaluation."""
    jm, v, tm, jb, tb, node_2d = make_pair(3, **flags)
    if flags.get("concat_hidden"):
        assert tuple(tm.score_network.basis_node_1.kernel.shape) == (16 * 4, 128)
    pos = np.random.default_rng(5).normal(size=(jb.num_nodes, 3)).astype(np.float32)
    for layout, method, ours in (
            ("feature", JaxSDEModel2Dto3D.score_from_cond, tm.score_from_cond),
            ("channel", JaxSDEModel2Dto3D.score_from_cond_cm, tm.score_from_cond_cm),
            ("feature", JaxSDEModel2Dto3D.score_from_cond_fused, tm.score_from_cond_fused)):
        ref = np.asarray(jm.apply(v, _cond_jax(jm, v, node_2d, jb, layout), jb,
                                  jnp.asarray(pos), method=method))
        with torch.no_grad():
            out = ours(tm.precompute_conditioning(t(node_2d), tb, layout=layout), t(pos))
        assert rel_err(out.numpy(), ref) < 2e-5, method.__name__
    with torch.no_grad():
        cond = tm.precompute_conditioning(t(node_2d), tb)
        assert torch.equal(tm.score_from_cond_fused(cond, t(pos)),
                           tm.score_from_cond(cond, t(pos)))
