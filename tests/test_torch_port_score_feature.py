"""Port parity: the feature-layout score path of SDEModel2Dto3D
(``[B, N, N, C]`` pair tensors) against the JAX package, with weights
carried across by convert.py.

- ``dense_frames``; the feature-minor ``DenseGATLayer``;
- ``precompute_conditioning(layout="feature")``, and
  ``(layout="channel")`` with ``pair_cm_direct=True`` (the K4 branch);
- ``score_from_cond``; ``loss`` with ``loss_layout="feature"`` on the JAX
  loss's own draws; ``get_score``.

Tolerances: f32 2e-5 relative for the score (sums in another order through
~8 dependent layers), 1e-5 for modules and the loss, 1e-4 for gradients;
bf16 5e-2 relative (the two frameworks round to bf16 after different ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.models.score_2d3d import DenseGATLayer as JaxDenseGATLayer
from moleculesde_tpu.models.score_2d3d import dense_frames as jax_dense_frames
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.score_2d3d import (
    DenseGATLayer, SDEModel2Dto3D, dense_frames)

from test_torch_port_score_2d3d import make_pair
from test_torch_port_score_losses import _check_grads
from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)

EMB = 16


@pytest.fixture(scope="module", params=[(1, "float32"), (2, "float32"), (2, "bfloat16")],
                ids=lambda p: f"v{p[0]}-{p[1]}")
def pair(request):
    return make_pair(*request.param)


def test_dense_frames_matches_jax():
    pos = np.random.default_rng(2).normal(size=(2, 6, 3)).astype(np.float32)
    ref, mine = jax_dense_frames(pos), dense_frames(t(pos))
    leaves_j, leaves_t = jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(mine)
    assert len(leaves_j) == len(leaves_t) == 9 + 3 + 3 + 2
    for x, y in zip(leaves_j, leaves_t):
        assert tuple(y.shape) == x.shape == (2, 6, 6)
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_gat_layer_feature_matches_jax(dtype):
    rng = np.random.default_rng(3)
    b, n, h = 2, 6, 16
    x = rng.normal(size=(b, n, h)).astype(np.float32)
    edge = rng.normal(size=(b, n, n, h)).astype(np.float32)
    mask = rng.random((b, n, n)) < 0.6
    mask[0, :, 1] = False                          # a destination with no source
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jl = JaxDenseGATLayer(hidden_dim=h, n_head=8, dtype=jdt)
    v = jl.init(jax.random.PRNGKey(1), x, edge, mask)
    v = jax.tree_util.tree_map(lambda a: a + 0.05, v)  # non-zero biases, LN offsets
    ref = np.asarray(jl.apply(v, x, edge, mask).astype(jnp.float32))
    tl = load_flax_variables(DenseGATLayer(h, 8, h, torch.bfloat16 if jdt else None), np_tree(v))
    with torch.no_grad():
        out = tl(t(x), t(edge), t(mask), channel_major=False).float().numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) < (5e-2 if jdt else 1e-5)


def _cond_jax(jm, v, node_2d, jb, layout):
    return jm.apply(v, jnp.asarray(node_2d), jb, True, layout=layout,
                    method=JaxSDEModel2Dto3D.precompute_conditioning)


def test_precompute_conditioning_feature_matches_jax(pair):
    jm, v, tm, jb, tb, node_2d = pair
    cj = _cond_jax(jm, v, node_2d, jb, "feature")
    with torch.no_grad():
        ct = tm.precompute_conditioning(t(node_2d), tb, True)   # JAX's default layout
    np.testing.assert_array_equal(ct["pair_mask"].numpy(), np.asarray(cj["pair_mask"]))
    assert ct["edge_attr_2d"].dtype == torch.float32           # f32 in either score dtype
    for k in ("edge_attr_2d", "node_attr"):
        assert tuple(ct[k].shape) == cj[k].shape, k
        assert rel_err(ct[k].float().numpy(), np.asarray(cj[k].astype(jnp.float32))) < (
            1e-5 if tm.score_dtype == "float32" else 1e-2), k


@pytest.mark.parametrize("bf16_pairs", [False, True], ids=["f32-pairs", "bf16-pairs"])
def test_precompute_conditioning_pair_cm_direct_matches_jax(bf16_pairs):
    jb, tb = both_batches(graphs(seed=5, count=3, n_max=7), n_max=7)
    node_2d = np.random.default_rng(5).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    kw = dict(emb_dim=EMB, hidden_dim=16, variant=1, pair_cm_direct=True,
              bf16_pairs=bf16_pairs, score_dtype="bfloat16")
    jm = JaxSDEModel2Dto3D(**kw, pair_impl="pallas_interpret")
    key = jax.random.PRNGKey(5)
    v = jm.init({"params": key, "dropout": key}, jnp.asarray(node_2d), jb, key,
                method=JaxSDEModel2Dto3D.loss)
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(lambda a: a * 1.3 + 0.1, v["batch_stats"])}
    tm = load_flax_variables(SDEModel2Dto3D(**kw, device=CPU), np_tree(v))
    cj = _cond_jax(jm, v, node_2d, jb, "channel")
    with torch.no_grad():
        ct = tm.precompute_conditioning(t(node_2d), tb, True, layout="channel")
    # K4's output stays f32 (no cast to the bf16 score dtype), as in JAX
    assert ct["edge_attr_2d"].dtype == torch.float32
    assert cj["edge_attr_2d"].dtype == jnp.float32
    assert tuple(ct["edge_attr_2d"].shape) == cj["edge_attr_2d"].shape == (3, 16, 49)
    assert rel_err(ct["edge_attr_2d"].numpy(), np.asarray(cj["edge_attr_2d"])) < (
        2 ** -8 if bf16_pairs else 1e-5)
    # and the bf16 channel-major score on that f32 edge slab
    pos = np.random.default_rng(6).normal(size=(jb.num_nodes, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(v, cj, jb, jnp.asarray(pos),
                              method=JaxSDEModel2Dto3D.score_from_cond_cm))
    with torch.no_grad():
        out = tm.score_from_cond_cm(ct, t(pos))
    assert rel_err(out.numpy(), ref) < 5e-2


def test_score_from_cond_matches_jax(pair):
    jm, v, tm, jb, tb, node_2d = pair
    pos = np.random.default_rng(7).normal(size=(jb.num_nodes, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(v, _cond_jax(jm, v, node_2d, jb, "feature"), jb,
                              jnp.asarray(pos), method=JaxSDEModel2Dto3D.score_from_cond))
    with torch.no_grad():
        out = tm.score_from_cond(tm.precompute_conditioning(t(node_2d), tb), t(pos))
    assert out.dtype == torch.float32 and tuple(out.shape) == (jb.num_nodes, 3)
    assert rel_err(out.numpy(), ref) < (2e-5 if tm.score_dtype == "float32" else 5e-2)


@pytest.mark.parametrize("variant", [1, 2])
def test_loss_feature_layout_matches_jax(variant):
    jb, tb = both_batches(graphs(seed=35, count=4, n_max=8), n_max=8)
    node_2d = np.random.default_rng(9).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    kw = dict(emb_dim=EMB, hidden_dim=16, variant=variant, loss_layout="feature")
    jm = JaxSDEModel2Dto3D(**kw, pair_impl="pallas_interpret")
    key = jax.random.PRNGKey(6)
    v = jax.jit(lambda k, n2d: jm.init({"params": k, "dropout": k}, n2d, jb, k,
                                       method=JaxSDEModel2Dto3D.loss))(key, jnp.asarray(node_2d))
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(lambda a: a * 1.2 + 0.1, v["batch_stats"])}
    k_loss = jax.random.PRNGKey(29)

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
    tm = load_flax_variables(SDEModel2Dto3D(**kw, device=CPU), np_tree(v))
    n2d = t(node_2d).requires_grad_(True)
    loss_t = tm.loss(n2d, tb, deterministic=True, use_running_average=False, draws=draws)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert rel_err(n2d.grad.numpy(), g_node) < 1e-4
    _check_grads(tm, g_params, 1e-4)


@pytest.mark.parametrize("loss_layout", ["channel", "feature"])
def test_get_score_matches_jax(loss_layout):
    jm, v, tm, jb, tb, node_2d = make_pair(2, "float32", seed=2)
    jm = jm.clone(loss_layout=loss_layout)
    tm.loss_layout = loss_layout
    rng = np.random.default_rng(12)
    pos = rng.normal(size=(jb.num_nodes, 3)).astype(np.float32)
    t_pos = rng.uniform(0.1, 0.9, size=jb.num_nodes).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(node_2d), jb, jnp.asarray(pos), jnp.asarray(t_pos),
                              method=JaxSDEModel2Dto3D.get_score))
    with torch.no_grad():
        out = tm.get_score(t(node_2d), tb, t(pos), t(t_pos))
    assert rel_err(out.numpy(), ref) < 2e-5
