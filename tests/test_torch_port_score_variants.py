"""Port parity: ``SDEModel2Dto3D`` variants 3 and 4
(moleculesde_tpu_torch.models.score_2d3d) against the JAX package, weights
carried across by convert.py: the parameter tree, the conditioning and the
score in both layouts, the training loss and ``get_score``.  The fused
evaluation and ``short_cut`` / ``concat_hidden`` are in
tests/test_torch_port_score_variants_fused.py.

Bars, relative to the largest value: f32 conditioning 1e-5, scores 2e-5
(sums in another order through ~8 dependent layers), losses 1e-5 and
gradients 1e-4 (as tests/test_torch_port_score_losses.py).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, flat_tree, graphs, ieee_f32, np_tree, rel_err, t)

EMB = 16
# leaves whose gradient is zero in exact arithmetic (the attention key bias:
# the softmax over keys drops a shift), held to 1e-6 of the largest gradient
ZERO_GRAD = re.compile(r"lin_key\.bias$")


@functools.lru_cache(maxsize=None)
def make_pair(variant: int, hid: int = 16, score_dtype: str = "float32", seed: int = 0,
              short_cut: bool = False, concat_hidden: bool = False):
    """JAX and port SDEModel2Dto3D on the same weights (every parameter
    perturbed, so no bias starts at zero), both batches (n_max 7, every
    bond label of the extended graph present) and node embeddings; made
    once per argument tuple and shared."""
    jb, tb = both_batches(graphs(seed=seed, count=3, n_max=7), n_max=7)
    node_2d = np.random.default_rng(seed).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    args = dict(emb_dim=EMB, hidden_dim=hid, variant=variant, score_dtype=score_dtype,
                short_cut=short_cut, concat_hidden=concat_hidden)
    jm = JaxSDEModel2Dto3D(**args)
    key = jax.random.PRNGKey(seed)
    # compiled as one program: run eagerly, JAX compiles each op of the loss on its own
    v = jax.jit(lambda k, n: jm.init({"params": k, "dropout": k}, n, jb, k,
                                     method=JaxSDEModel2Dto3D.loss))(key, jnp.asarray(node_2d))
    rng = np.random.default_rng(seed + 1)
    v = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        v["params"]), "batch_stats": v.get("batch_stats", {})}
    tm = load_flax_variables(SDEModel2Dto3D(**args, device=CPU), np_tree(v))
    return jm, v, tm, jb, tb, node_2d


@pytest.mark.parametrize("variant", [3, 4])
def test_variant_param_tree_matches_jax(variant):
    """Variants 3 and 4 build JAX's parameters, names and shapes, with no
    batch statistics and no pair block."""
    jm, v, tm, *_ = make_pair(variant)
    ref = {k: a.shape for k, a in flat_tree(np_tree(v)["params"]).items()}
    mine = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert mine == ref
    assert not list(tm.buffers())
    assert ("edge_2D_emb.kernel" in mine) == (variant == 3)
    assert tm.kernel_variant == 1


@pytest.mark.parametrize("variant", [1, 2, 3, 4])
def test_node_representation_width_is_emb_dim(variant):
    """What reads the 2D node representations is sized from ``emb_dim``
    (emb 12, hidden 8), as the JAX module declares it: the pair Linear or
    variant 4's kernel takes ``2 * emb_dim`` rows, ``node_emb`` ``emb_dim``."""
    m = SDEModel2Dto3D(emb_dim=12, hidden_dim=8, variant=variant, device=CPU)
    pair = {1: "edge_2D_emb_0.kernel", 2: "edge_2D_emb_0.kernel",
            3: "edge_2D_emb.kernel", 4: "edge_2D_emb_kernel"}[variant]
    names = dict(m.named_parameters())
    assert tuple(names[pair].shape) == (24, 12 if variant in (1, 2) else 8)
    assert tuple(m.node_emb.Dense_0.kernel.shape) == (12, 8)


def _cond_jax(jm, v, node_2d, jb, layout):
    return jm.apply(v, jnp.asarray(node_2d), jb, True, layout=layout,
                    method=JaxSDEModel2Dto3D.precompute_conditioning)


@pytest.mark.parametrize("layout", ["feature", "channel"])
@pytest.mark.parametrize("variant", [3, 4])
def test_conditioning_and_score_match_jax(variant, layout):
    """``precompute_conditioning`` and the score at given positions in both
    layouts (``score_from_cond`` / ``score_from_cond_cm``), f32.  The bf16
    score mode casts these conditioning tensors as variants 1 and 2 do
    (tests/test_torch_port_score_2d3d.py); ``chip_smoke.py`` holds the v3 /
    v4 fused chains' bf16 evaluations to their plain versions."""
    jm, v, tm, jb, tb, node_2d = make_pair(variant)
    pos = np.random.default_rng(7).normal(size=(jb.num_nodes, 3)).astype(np.float32)
    cj = _cond_jax(jm, v, node_2d, jb, layout)
    with torch.no_grad():
        ct = tm.precompute_conditioning(t(node_2d), tb, layout=layout)
        np.testing.assert_array_equal(ct["pair_mask"].numpy(), np.asarray(cj["pair_mask"]))
        for k in ("edge_attr_2d", "node_attr"):
            assert tuple(ct[k].shape) == cj[k].shape, k
            assert str(ct[k].dtype).split(".")[-1] == str(cj[k].dtype), k
            assert rel_err(ct[k].float().numpy(),
                           np.asarray(cj[k].astype(jnp.float32))) < 1e-5, k
        score_t = tm.score_from_cond_cm if layout == "channel" else tm.score_from_cond
        out = score_t(ct, t(pos))
    method = (JaxSDEModel2Dto3D.score_from_cond_cm if layout == "channel"
              else JaxSDEModel2Dto3D.score_from_cond)
    ref = np.asarray(jm.apply(v, cj, jb, jnp.asarray(pos), method=method))
    assert out.dtype == torch.float32 and tuple(out.shape) == (jb.num_nodes, 3)
    assert rel_err(out.numpy(), ref) < 2e-5


@pytest.mark.parametrize("loss_layout", ["channel", "feature"])
@pytest.mark.parametrize("variant", [3, 4])
def test_loss_and_get_score_match_jax(variant, loss_layout):
    """The training loss in ``loss_layout`` (the JAX loss's own draws
    replayed), the gradient of every parameter and of the node embeddings,
    and ``get_score``."""
    jm, v, tm, jb, tb, node_2d = make_pair(variant)
    jm = jm.clone(loss_layout=loss_layout)
    tm.loss_layout = loss_layout
    tm.zero_grad()
    k_loss = jax.random.PRNGKey(29)

    def jax_loss(params, n2d):
        out = jm.apply({"params": params}, n2d, jb, k_loss, 0.0, deterministic=True,
                       use_running_average=False, method=JaxSDEModel2Dto3D.loss)
        return out["position"]

    loss_j, (g_params, g_node) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        v["params"], jnp.asarray(node_2d))
    k_noise, k_t = jax.random.split(k_loss)
    draws = {"pos_noise": t(jax.random.normal(k_noise, jb.positions.shape)),
             "half": t(jax.random.randint(k_t, (jb.num_graphs // 2 + 1,), 0, 1000)).long()}
    n2d = t(node_2d).requires_grad_(True)
    loss_t = tm.loss(n2d, tb, deterministic=True, use_running_average=False, draws=draws)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert rel_err(n2d.grad.numpy(), g_node) < 1e-4
    flat_j = flat_tree(g_params)
    scale = max(float(np.abs(g).max()) for g in flat_j.values())
    for name, p in tm.named_parameters():
        if ZERO_GRAD.search(name):
            assert float(np.abs(p.grad.numpy() - flat_j[name]).max()) <= 1e-6 * scale
        elif p.requires_grad:
            assert rel_err(p.grad.numpy(), flat_j[name]) < 1e-4, name
        else:   # the frozen Fourier weights (stop_gradient in JAX)
            assert float(np.abs(flat_j[name]).max()) == 0.0

    rng = np.random.default_rng(12)
    pos = rng.normal(size=(jb.num_nodes, 3)).astype(np.float32)
    t_pos = rng.uniform(0.1, 0.9, size=jb.num_nodes).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(node_2d), jb, jnp.asarray(pos),
                              jnp.asarray(t_pos), method=JaxSDEModel2Dto3D.get_score))
    with torch.no_grad():
        out = tm.get_score(t(node_2d), tb, t(pos), t(t_pos))
    assert rel_err(out.numpy(), ref) < 2e-5
