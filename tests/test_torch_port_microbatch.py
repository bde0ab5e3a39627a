"""Port parity: the microbatch scopes of the pretraining step
(moleculesde_tpu_torch.pretrain.train_step) against the JAX package's
``make_pretrain_step``.

- ``split_microbatches`` on a padded batch: every chunk equals JAX's,
  edge shift and clamp included.
- One f32 step per scope ("step" on a padded and on a compact batch,
  "score", "splice"), B=4 in chunks of 2, against JAX's own step for that
  scope on the same weights (JAX's "step" on the padded batch, which its
  own tests hold equal to the compact one; JAX's "score" for "splice",
  which its own tests hold equal to its "splice"), dropout off on both
  sides (GIN's rate 0 in
  the config; the 2D->3D score network's fixed 0.1 is set to 0 on the JAX
  side by building it through a partial, the port runs it
  deterministic).  Each chunk's draws are replayed from JAX's keys
  (``fold_in(key, i)`` per chunk under "step", ``fold_in(k_23, i)`` /
  ``fold_in(k_32, i)`` under "score" / "splice").  Metrics agree to 1e-5
  relative, BatchNorm statistics (updated chunk by chunk) to 1e-5, and
  every parameter after the Adam update to 1e-4 of its leaf's largest
  value (floored at 1e-2), but for the leaves whose gradient is zero in
  exact arithmetic (``ZERO_GRAD`` in torch_port_common.py): Adam turns the
  rounding noise both sides hold there into steps of up to lr, so those
  agree to 2 lr.
- The port's "score" and "splice" (one spliced backward) equal the chunked
  loss built as one graph with one backward, JAX's "score" form without the
  recompute, to 1e-6, with dropout on and the draws from one generator seed
  (the leaves of ``ZERO_GRAD``, rounding noise of about 1e-7 on both sides,
  to 1e-5).
- B <= microbatch, B % microbatch != 0, and "score" without both
  generative terms fall back to the plain step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.pretrain.train_state import PretrainConfig as JaxPretrainConfig
from moleculesde_tpu.pretrain.train_state import build_models as jax_build_models
from moleculesde_tpu.pretrain.train_state import create_pretrain_state
from moleculesde_tpu.pretrain.train_step import make_pretrain_step
from moleculesde_tpu.pretrain.train_step import split_microbatches as jax_split_microbatches
from moleculesde_tpu_torch.convert import load_flax_pretrain
from moleculesde_tpu_torch.data.compact import collate_compact
from moleculesde_tpu_torch.pretrain.train_state import (
    PretrainConfig, build_models, make_optimizer)
from moleculesde_tpu_torch.pretrain.contrastive import dual_cl
from moleculesde_tpu_torch.pretrain.train_step import (
    METRICS, _score_losses, draw_chunked, microbatch_chunks, pretrain_grads, pretrain_step,
    split_microbatches)

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    assert_params_after_step, both_batches, CPU, flat_tree, graphs, ieee_f32,
    jax_score_dropout_off, replay_score_draws, ZERO_GRAD)

TINY = dict(emb_dim=16, num_layer=2, schnet_num_filters=8, schnet_num_interactions=2,
            schnet_num_gaussians=11, hidden_dim_2dto3d=16, dropout_ratio=0.0,
            cl_similarity_metric="InfoNCE_dot_prod")
F32 = dict(bf16_pairs=False, score_dtype_2dto3d="float32", schnet_bf16=False,
           gnn2d_bf16=False, bf16_attn_3dto2d=False)
N_MAX, E_MAX = 8, 32


def _port_draws(scope, key, k, mb):
    """The port's ``draws`` for JAX's step 0 under ``scope`` (InfoNCE: no
    contrastive draws)."""
    key = jax.random.fold_in(key, 0)
    if scope == "step":
        return [{"cl": None, **replay_score_draws(
            *jax.random.split(jax.random.fold_in(key, i), 4)[2:], mb, N_MAX)}
                for i in range(k)]
    _, _, k_23, k_32 = jax.random.split(key, 4)
    return {"cl": None, "chunks": [replay_score_draws(jax.random.fold_in(k_23, i),
                                                      jax.random.fold_in(k_32, i), mb, N_MAX)
                                   for i in range(k)]}


@pytest.fixture(scope="module")
def batches():
    gs = graphs(seed=51, count=4, n_max=N_MAX)
    jb, tb = both_batches(gs, n_max=N_MAX, e_max=E_MAX, ext_e_max=N_MAX * N_MAX)
    return gs, jb, tb


@pytest.fixture(scope="module")
def jax_steps(batches):
    """JAX's one step under "step" and under "score": (initial params and
    batch stats, (metrics, new params, new batch stats))."""
    _, jb, _ = batches
    key = jax.random.PRNGKey(9)
    out = {}
    with jax_score_dropout_off():
        jcfg = JaxPretrainConfig(**TINY, **F32)
        models = jax_build_models(jcfg)
        state = jax.jit(lambda k: create_pretrain_state(jcfg, jb, k)[1])(jax.random.PRNGKey(0))
        init = jax.device_get((state.params, state.batch_stats))
        for scope in ("step", "score"):
            jcfg = dataclasses.replace(jcfg, microbatch=2, microbatch_scope=scope)
            # the step donates its state: each scope steps a copy
            new, metrics = make_pretrain_step(models, jcfg)(
                jax.tree_util.tree_map(jnp.copy, state), jb, key, jnp.asarray(1.0))
            out[scope] = jax.device_get((metrics, new.params, new.batch_stats))
    return key, init, out


@pytest.mark.parametrize("scope,compact,jax_scope", [("step", False, "step"),
                                                     ("step", True, "step"),
                                                     ("score", False, "score"),
                                                     ("splice", False, "score")],
                         ids=["step", "step_compact", "score", "splice"])
def test_microbatch_step_matches_jax(batches, jax_steps, scope, compact, jax_scope):
    gs, _, tb = batches
    key, (params, stats), out = jax_steps
    metrics_j, params_j, stats_j = out[jax_scope]
    cfg = PretrainConfig(**TINY, train_precision="float32", microbatch=2,
                         microbatch_scope=scope)
    models = load_flax_pretrain(build_models(cfg, CPU), params, stats)
    batch = collate_compact(gs, n_max=N_MAX, e_max=E_MAX) if compact else tb
    assert microbatch_chunks(cfg, batch.num_graphs) == 2
    metrics = pretrain_step(models, make_optimizer(models, cfg), cfg, batch,
                            deterministic=True, draws=_port_draws(scope, key, 2, 2))
    for k in METRICS:
        ref = float(metrics_j[k])
        assert abs(metrics[k].item() - ref) <= 1e-5 * max(abs(ref), 1.0), (k, ref)
    assert_params_after_step(models, params_j, cfg.lr)
    flat_s = flat_tree(stats_j)
    for comp, module in models.items():
        for name, buf in module.named_buffers():
            np.testing.assert_allclose(buf.numpy(), flat_s[f"{comp}.{name}"], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{comp}.{name}")


def test_split_microbatches_shifts_edges_as_jax(batches):
    _, jb, tb = batches
    mine, theirs = split_microbatches(tb, 2), jax_split_microbatches(jb, 2)
    assert [c.num_graphs for c in mine] == [2, 2] and theirs.num_graphs == 2
    for i, chunk in enumerate(mine):
        for f in dataclasses.fields(chunk):
            v = getattr(chunk, f.name)
            if torch.is_tensor(v):
                np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(theirs, f.name)[i]),
                                              err_msg=f"{f.name}[{i}]")
        assert chunk.edge_src.max() < 2 * N_MAX and chunk.edge_src.min() >= 0


def _grads(cfg, batch, seed, **kw):
    models = build_models(cfg, CPU, torch.Generator().manual_seed(1))
    metrics = pretrain_grads(models, cfg, batch, torch.Generator().manual_seed(seed), **kw)
    return metrics, {f"{c}.{n}": p.grad.clone() for c, m in models.items()
                     for n, p in m.named_parameters() if p.grad is not None}


def _one_backward_grads(cfg, batch, seed, k=2):
    """The chunked "score" loss as one graph and one backward, drawing from
    the generator in the step's order: the chunked draws, GIN's dropout,
    then each chunk's score-network dropout."""
    models = build_models(cfg, CPU, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(seed)
    d = draw_chunked(models, cfg, batch, k, gen)
    node_2d = models["model_2D"](batch, use_running_average=False, deterministic=False,
                                 generator=gen)
    _, node_3d = models["model_3D"].encode_batch(batch)
    cl_loss, cl_acc = dual_cl(node_2d, node_3d, cfg.cl_similarity_metric, cfg.T,
                              cfg.cl_neg_samples, batch.node_mask, cfg.normalize,
                              shifts=d["cl"])
    n2, n3 = node_2d.reshape(k, -1, cfg.emb_dim), node_3d.reshape(k, -1, cfg.emb_dim)
    l23 = l32 = 0.0
    for i, (chunk, dc) in enumerate(zip(split_microbatches(batch, k), d["chunks"])):
        a, b = _score_losses(models, cfg, n2[i], n3[i], chunk, gen, False, dc)
        l23, l32 = l23 + a / k, l32 + b / k
    total = (cfg.coeff_contrastive * cl_loss + cfg.coeff_generative_2dto3d * l23
             + cfg.coeff_generative_3dto2d * l32)
    total.backward()
    metrics = {"CL_loss": cl_loss, "CL_acc": cl_acc, "SDE_loss_2Dto3D": l23,
               "SDE_loss_3Dto2D": l32, "loss": total}
    return metrics, {f"{c}.{n}": p.grad.clone() for c, m in models.items()
                     for n, p in m.named_parameters() if p.grad is not None}


def test_splice_equals_score_with_dropout(batches):
    _, _, tb = batches
    base = PretrainConfig(**{**TINY, "dropout_ratio": 0.5,
                             "cl_similarity_metric": "EBM_node_dot_prod"},
                          train_precision="float32", microbatch=2)
    ms, gs_ = _one_backward_grads(base, tb, 7)
    for scope in ("score", "splice"):
        mp, gp = _grads(dataclasses.replace(base, microbatch_scope=scope), tb, 7)
        for k in METRICS:
            assert abs(mp[k].item() - ms[k].item()) <= 1e-6 * max(1.0, abs(ms[k].item())), \
                (scope, k)
        assert sorted(gp) == sorted(gs_) and len(gp) > 50
        for k in gs_:
            diff = (gp[k] - gs_[k]).abs().max().item()
            if ZERO_GRAD.search(k):   # rounding noise on both sides (about 1e-7)
                assert diff <= 1e-5, (scope, k)
            else:
                assert diff <= 1e-6 * max(gs_[k].abs().max().item(), 1e-2), (scope, k)
    # the draws of one generator seed are the chunked draws
    models = build_models(base, CPU, torch.Generator().manual_seed(1))
    d = draw_chunked(models, base, tb, 2, torch.Generator().manual_seed(7))
    assert len(d["chunks"]) == 2 and d["cl"][0].ndim == 0


@pytest.mark.parametrize("over", [dict(microbatch=4), dict(microbatch=3),
                                  dict(microbatch=2, microbatch_scope="score",
                                       coeff_generative_3dto2d=0.0)],
                         ids=["mb_eq_B", "mb_not_divisor", "score_one_generative"])
def test_microbatch_falls_back_to_the_plain_step(batches, over):
    _, _, tb = batches
    cfg = PretrainConfig(**TINY, train_precision="float32",
                         **{"microbatch_scope": "step", **over})
    assert microbatch_chunks(cfg, tb.num_graphs) == 1
    mine = _grads(cfg, tb, 3, deterministic=True)
    plain = _grads(dataclasses.replace(cfg, microbatch=0), tb, 3, deterministic=True)
    for k in METRICS:
        assert mine[0][k].item() == plain[0][k].item(), k
    for k in plain[1]:
        assert torch.equal(mine[1][k], plain[1][k]), k
