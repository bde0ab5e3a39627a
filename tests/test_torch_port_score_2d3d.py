"""Port parity: 2D->3D score model, channel-major sampling path
(moleculesde_tpu_torch.models.score_2d3d) against the JAX package, variants
1 and 2, with weights carried across by convert.py.

Tolerances: f32 2e-5 relative to the largest score entry (sums in another
order through ~8 dependent layers; ~1e-6 seen); bf16 5e-2 relative (~2e-2
seen: the two frameworks round to bf16 after different ops)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.models.score_2d3d import dense_frames_flat as jax_frames_flat
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D, dense_frames_flat

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)

EMB, HID = 16, 16


def make_pair(variant: int, score_dtype: str = "float32", seed: int = 0):
    """JAX SDEModel2Dto3D with perturbed batch statistics, the port's model
    carrying the same variables, both batches and node embeddings."""
    jb, tb = both_batches(graphs(seed=seed, count=3, n_max=7), n_max=7)
    node_2d = np.random.default_rng(seed).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    jm = JaxSDEModel2Dto3D(emb_dim=EMB, hidden_dim=HID, variant=variant,
                           score_dtype=score_dtype)
    key = jax.random.PRNGKey(seed)
    v = jm.init({"params": key, "dropout": key}, jnp.asarray(node_2d), jb, key,
                method=JaxSDEModel2Dto3D.loss)
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(lambda a: a * 1.3 + 0.1, v["batch_stats"])}
    tm = load_flax_variables(
        SDEModel2Dto3D(emb_dim=EMB, hidden_dim=HID, variant=variant,
                       score_dtype=score_dtype, device=CPU), np_tree(v))
    return jm, v, tm, jb, tb, node_2d


@pytest.fixture(scope="module", params=[(1, "float32"), (2, "float32"),
                                        (1, "bfloat16"), (2, "bfloat16")],
                ids=lambda p: f"v{p[0]}-{p[1]}")
def pair(request):
    return make_pair(*request.param)


def test_dense_frames_flat_matches_jax():
    pos = np.random.default_rng(1).normal(size=(2, 6, 3)).astype(np.float32)
    (bj, cj, aj), (bt, ct, at) = jax_frames_flat(pos), dense_frames_flat(t(pos))
    for x, y in zip(jax.tree_util.tree_leaves((bj, cj, aj)),
                    jax.tree_util.tree_leaves((bt, ct, at))):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=2e-5, rtol=1e-4)


def test_precompute_conditioning_matches_jax(pair):
    jm, v, tm, jb, tb, node_2d = pair
    cj = jm.apply(v, jnp.asarray(node_2d), jb, True, layout="channel",
                  method=JaxSDEModel2Dto3D.precompute_conditioning)
    ct = tm.precompute_conditioning(t(node_2d), tb, True, layout="channel")
    np.testing.assert_array_equal(ct["pair_mask"].numpy(), np.asarray(cj["pair_mask"]))
    tol = 1e-5 if tm.score_dtype == "float32" else 1e-2
    for k in ("edge_attr_2d", "node_attr"):
        assert ct[k].dtype == torch.float32 or tm.score_dtype == "bfloat16"
        assert tuple(ct[k].shape) == cj[k].shape, k
        assert rel_err(ct[k].float().detach().numpy(),
                       np.asarray(cj[k].astype(jnp.float32))) < tol, k


def test_score_from_cond_cm_matches_jax(pair):
    jm, v, tm, jb, tb, node_2d = pair
    pos = np.random.default_rng(7).normal(size=(jb.num_nodes, 3)).astype(np.float32)
    cj = jm.apply(v, jnp.asarray(node_2d), jb, True, layout="channel",
                  method=JaxSDEModel2Dto3D.precompute_conditioning)
    ref = np.asarray(jm.apply(v, cj, jb, jnp.asarray(pos),
                              method=JaxSDEModel2Dto3D.score_from_cond_cm))
    with torch.no_grad():
        out = tm.score_from_cond_cm(tm.precompute_conditioning(t(node_2d), tb,
                                                          layout="channel"), t(pos))
    assert out.dtype == torch.float32 and tuple(out.shape) == (jb.num_nodes, 3)
    assert rel_err(out.numpy(), ref) < (2e-5 if tm.score_dtype == "float32" else 5e-2)


def test_unported_variant_raises():
    """Named for the refusal it once checked: variants 3 and 4 now build,
    with their own 2D edge parameters, no pair block and no batch
    statistics, and run the fused kernel as its variant 1 (their parity
    with JAX: tests/test_torch_port_score_variants.py)."""
    for variant, edge in ((3, ("edge_2D_emb.kernel", "edge_2D_emb.bias")),
                          (4, ("edge_2D_emb_kernel", "edge_2D_emb_bias"))):
        m = SDEModel2Dto3D(emb_dim=8, hidden_dim=8, variant=variant, device=CPU)
        names = dict(m.named_parameters())
        assert set(edge) | {"edge_emb.embedding"} <= set(names)
        assert not any(k.startswith("edge_2D_emb_0") for k in names)
        assert not list(m.buffers()) and m.kernel_variant == 1
