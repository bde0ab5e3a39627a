"""Port parity: PaiNN (moleculesde_tpu_torch.models.painn) against the JAX
package, and one pretraining step with ``model_3d="PaiNN"``.

- The encoder on converted weights (flax names unchanged): pooled and
  latent output and every gradient, f32 to 1e-5 (outputs) and 1e-4
  (gradients: sums in another order over two interactions), bf16 to 3e-2
  (both round the pair-filter products to bf16; the sums in f32 run in
  another order, which can move a rounded value by one bf16 ulp).
- Padded rows of the latent are zero, and row 0 of the embedding (read as
  zero, the reference's ``padding_idx=0``) gets no gradient.
- One f32 step of JAX's ``make_pretrain_step`` with PaiNN against the
  port's, on the same weights and draws, dropout off on both sides:
  metrics to 1e-5 relative, parameters after Adam as in
  ``assert_params_after_step`` (torch_port_common.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moleculesde_tpu.models.painn import PaiNN as JaxPaiNN
from moleculesde_tpu.pretrain.train_state import PretrainConfig as JaxPretrainConfig
from moleculesde_tpu.pretrain.train_state import build_models as jax_build_models
from moleculesde_tpu.pretrain.train_state import create_pretrain_state
from moleculesde_tpu.pretrain.train_step import make_pretrain_step
from moleculesde_tpu_torch.convert import load_flax_pretrain, load_flax_variables
from moleculesde_tpu_torch.models.painn import PaiNN
from moleculesde_tpu_torch.pretrain.train_state import (
    PretrainConfig, build_models, make_optimizer)
from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_step

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    assert_params_after_step, both_batches, CPU, graphs, ieee_f32, jax_score_dropout_off,
    np_tree, rel_err, replay_score_draws, t)

WIDTH = dict(n_atom_basis=16, n_interactions=2, n_rbf=8, cutoff=5.0)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_painn_forward_and_grads_match_jax(dtype):
    jb, tb = both_batches(graphs(seed=31, count=3, n_max=9), n_max=9)
    jm = JaxPaiNN(**WIDTH, compute_dtype=dtype)
    v = jm.init(jax.random.PRNGKey(2), jb.atomic_numbers, jb.positions, jb.node_mask,
                jb.num_graphs, jb.n_max)
    tm = load_flax_variables(PaiNN(**WIDTH, compute_dtype=dtype, device=CPU), np_tree(v))
    g_lat = np.random.default_rng(3).normal(size=(jb.num_nodes, 16)).astype(np.float32)

    def jax_loss(params):
        pooled, latent = jm.apply({"params": params}, jb.atomic_numbers, jb.positions,
                                  jb.node_mask, jb.num_graphs, jb.n_max)
        return jnp.sum(latent * g_lat) + jnp.sum(pooled), (pooled, latent)

    (_, (pooled_j, latent_j)), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        v["params"])
    pooled_t, latent_t = tm.encode_batch(tb)
    ((latent_t * t(g_lat)).sum() + pooled_t.sum()).backward()
    f32 = dtype is None
    assert rel_err(latent_t.detach().numpy(), latent_j) < (1e-5 if f32 else 3e-2)
    assert rel_err(pooled_t.detach().numpy(), pooled_j) < (1e-5 if f32 else 3e-2)
    assert (latent_t.detach().numpy()[~tb.node_mask.numpy()] == 0).all()
    flat_j = {".".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf in
              jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    assert sorted(flat_j) == sorted(n for n, _ in tm.named_parameters())
    for name, p in tm.named_parameters():
        assert rel_err(p.grad.numpy(), flat_j[name]) < (1e-4 if f32 else 3e-2), name
    # padding_idx=0: hydrogen's row gets no gradient through the lookup
    assert float(tm.Embed_0.embedding.grad[0].abs().max()) == 0.0


def test_pretrain_step_with_painn_matches_jax():
    gs = graphs(seed=33, count=4, n_max=8)
    jb, tb = both_batches(gs, n_max=8, e_max=32, ext_e_max=64)
    over = dict(emb_dim=16, num_layer=2, hidden_dim_2dto3d=16, dropout_ratio=0.0,
                cl_similarity_metric="InfoNCE_dot_prod", model_3d="PaiNN",
                painn_n_interactions=2, painn_n_rbf=8)
    key = jax.random.PRNGKey(11)
    with jax_score_dropout_off():
        jcfg = JaxPretrainConfig(**over, bf16_pairs=False, score_dtype_2dto3d="float32",
                                 schnet_bf16=False, gnn2d_bf16=False, bf16_attn_3dto2d=False)
        models = jax_build_models(jcfg)
        state = jax.jit(lambda k: create_pretrain_state(jcfg, jb, k)[1])(jax.random.PRNGKey(0))
        params, stats = jax.device_get((state.params, state.batch_stats))
        new, metrics_j = make_pretrain_step(models, jcfg)(state, jb, key, jnp.asarray(1.0))
        metrics_j, params_j = jax.device_get((metrics_j, new.params))
    cfg = PretrainConfig(**over, train_precision="float32")
    tmodels = load_flax_pretrain(build_models(cfg, CPU), params, stats)
    assert isinstance(tmodels["model_3D"], PaiNN)
    _, _, k_23, k_32 = jax.random.split(jax.random.fold_in(key, 0), 4)
    draws = {"cl": None, **replay_score_draws(k_23, k_32, 4, 8)}
    metrics = pretrain_step(tmodels, make_optimizer(tmodels, cfg), cfg, tb,
                            deterministic=True, draws=draws)
    for k in METRICS:
        ref = float(metrics_j[k])
        assert abs(metrics[k].item() - ref) <= 1e-5 * max(abs(ref), 1.0), (k, ref)
    assert_params_after_step(tmodels, params_j, cfg.lr)
