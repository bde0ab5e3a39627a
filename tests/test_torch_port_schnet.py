"""Port parity: SchNet (moleculesde_tpu_torch.models.schnet) against the
JAX package, with the same weights, forward and gradients.

The port's fused CFConv (K2's plain version on the CPU) and its eager form
are both held against the JAX SchNet's eager form.  Tolerances relative to
each output's largest value: f32 1e-5 for the latent and 1e-4 for the
gradients (sums in another order over 2 interactions); bf16 3e-2 (the two
frameworks round the eager form's products at slightly different places,
and the fused form rounds as the TPU kernel does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moleculesde_tpu.models.schnet import SchNet as JaxSchNet
from moleculesde_tpu.models.schnet import pairwise_distances as jax_pairwise_distances
from moleculesde_tpu.models.schnet import radius_pair_mask as jax_radius_pair_mask
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.schnet import SchNet, pairwise_distances, radius_pair_mask

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)

WIDTH = dict(hidden_channels=16, num_filters=16, num_interactions=2, num_gaussians=11,
             cutoff=5.0)


@pytest.fixture(scope="module")
def setup():
    jb, tb = both_batches(graphs(seed=21, count=3, n_max=9), n_max=9)
    jm = JaxSchNet(**WIDTH)
    v = jm.init(jax.random.PRNGKey(3), jb.atomic_numbers, jb.positions, jb.node_mask,
                jb.num_graphs, jb.n_max)
    return jb, tb, v


def test_pairwise_distances_and_radius_mask_match_jax():
    rng = np.random.default_rng(0)
    pos = (rng.normal(size=(2, 6, 3)) * 3).astype(np.float32)
    mask = rng.random(12) < 0.8
    dj, dt = jax_pairwise_distances(pos), pairwise_distances(t(pos))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(radius_pair_mask(dt, t(mask), 4.0).numpy(),
                                  np.asarray(jax_radius_pair_mask(dj, mask, 4.0)))


@pytest.mark.parametrize("dtype,cfconv", [(None, "auto"), (None, "xla"),
                                          ("bfloat16", "auto"), ("bfloat16", "xla")])
def test_schnet_forward_and_grads_match_jax(setup, dtype, cfconv):
    jb, tb, v = setup
    jm = JaxSchNet(**WIDTH, compute_dtype=dtype, agg="reduce")
    tm = load_flax_variables(SchNet(**WIDTH, compute_dtype=dtype, cfconv=cfconv, device=CPU),
                             np_tree(v))
    rng = np.random.default_rng(4)
    g_lat = rng.normal(size=(jb.num_nodes, WIDTH["hidden_channels"])).astype(np.float32)

    def jax_loss(params):
        pooled, latent = jm.apply({"params": params}, jb.atomic_numbers, jb.positions,
                                  jb.node_mask, jb.num_graphs, jb.n_max)
        return jnp.sum(latent * g_lat) + jnp.sum(pooled), (pooled, latent)

    (_, (pooled_j, latent_j)), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(
        v["params"])
    pooled_t, latent_t = tm.encode_batch(tb)
    ((latent_t * t(g_lat)).sum() + pooled_t.sum()).backward()
    f32 = dtype is None
    assert rel_err(latent_t.detach().numpy(), latent_j) < (1e-5 if f32 else 3e-2)
    assert rel_err(pooled_t.detach().numpy(), pooled_j) < (1e-5 if f32 else 3e-2)
    assert (latent_t.detach().numpy()[~tb.node_mask.numpy()] == 0).all()
    flat_j = {".".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf in
              jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    for name, p in tm.named_parameters():
        assert rel_err(p.grad.numpy(), flat_j[name]) < (1e-4 if f32 else 3e-2), name
