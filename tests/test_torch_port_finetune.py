"""Port parity: the MoleculeNet finetune against the JAX package, weights
carried over by ``convert.py``.

- ``GNNGraphPred`` (sum / mean / max pooling; a batch with an empty graph
  slot) in training mode (batch statistics, updated running averages) and
  in evaluation mode (running averages): logits and statistics to 1e-5 of
  their largest value (floored at 1).
- The finetune Adam (``torch.optim.Adam`` with L2 decay and the lr set per
  step) against optax's ``add_decayed_weights`` + ``scale_by_adam`` and
  ``p - lr * u`` over three steps of a cosine schedule: 1e-6 of the
  largest weight.
- One and two classification steps against JAX's, with a cosine schedule
  and weight decay: the loss to 1e-5, every parameter after each step to
  1e-4 of the leaf's largest value (floored at 1e-2; the GIN Dense biases
  in front of a training-mode BatchNorm, whose gradient is zero in exact
  arithmetic, to 2 lr), running statistics (of the stepped weights) to
  1e-4, and the evaluation of JAX's stepped state loaded into the port to
  1e-5.  Dropout is 0 on both sides: the two frameworks draw their own
  masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moleculesde_tpu.finetune import create_classification_state, make_classification_steps
from moleculesde_tpu.models import GNNGraphPred as JaxGNNGraphPred
from moleculesde_tpu.utils.schedulers import make_lr_schedule as jax_make_lr_schedule
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.finetune.classification import (
    classification_eval, classification_step)
from moleculesde_tpu_torch.finetune.common import make_optimizer, set_lr
from moleculesde_tpu_torch.models.gnn2d import GNNGraphPred, graph_pool
from moleculesde_tpu_torch.models.layers import Dense
from moleculesde_tpu_torch.utils.schedulers import make_lr_schedule

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    CPU, flat_tree, ieee_f32, np_tree, t)
from torch_port_finetune_common import DECAY, LR, SCHED, assert_params, batches, close, stats


@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
def test_gnn_graph_pred_matches_jax(pool):
    jb, tb = batches(1, 5, 6)   # slot 6 is empty
    jm = JaxGNNGraphPred(num_tasks=3, num_layers=2, emb_dim=16, drop_ratio=0.0,
                         graph_pooling=pool)
    key = jax.random.PRNGKey(0)
    variables = jm.init({"params": key, "dropout": key}, jb)
    model = load_flax_variables(GNNGraphPred(3, 2, 16, graph_pooling=pool, device=CPU),
                                np_tree(variables))
    ref, mut = jm.apply(variables, jb, use_running_average=False, mutable=["batch_stats"])
    out = model(tb, use_running_average=False)
    close(out, ref, 1e-5, "training logits")
    flat = flat_tree(jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
    leaves = stats(model)
    assert sorted(leaves) == sorted(flat)
    for k, v in leaves.items():
        close(v, flat[k], 1e-5, k)
    ref_eval = jm.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                        jb, use_running_average=True)
    close(model(tb, use_running_average=True), ref_eval, 1e-5, "evaluation logits")
    if pool == "max":
        assert torch.equal(graph_pool(torch.randn(tb.num_nodes, 4), tb, "max")[5],
                           torch.zeros(4))


def test_finetune_adam_matches_optax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    grads = [rng.normal(size=(6, 4)).astype(np.float32) for _ in range(3)]
    sched, jsched = make_lr_schedule(**SCHED), jax_make_lr_schedule(**SCHED)
    tx = optax.chain(optax.add_decayed_weights(DECAY), optax.scale_by_adam())
    params = {"w": jnp.asarray(w)}
    opt_state = tx.init(params)
    layer = Dense(6, 4)
    with torch.no_grad():
        layer.kernel.copy_(t(w))
    opt = make_optimizer(layer, LR, DECAY)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p - jsched(step) * u, params, updates)
        set_lr(opt, sched(step))
        layer.kernel.grad, layer.bias.grad = t(g), torch.zeros(4)
        opt.step()
        close(layer.kernel, params["w"], 1e-6, f"step {step}")


def test_classification_steps_match_jax():
    jb, tb = batches(4, 6, 6)
    jm = JaxGNNGraphPred(num_tasks=3, num_layers=2, emb_dim=16, drop_ratio=0.0)
    jsched, sched = jax_make_lr_schedule(**SCHED), make_lr_schedule(**SCHED)
    key = jax.random.PRNGKey(2)
    state, tx = create_classification_state(jm, jb, key, lr=LR, schedule=jsched,
                                            weight_decay=DECAY)
    train_step, eval_step = make_classification_steps(jm, tx, jsched)
    model = load_flax_variables(GNNGraphPred(3, 2, 16, device=CPU), np_tree(
        {"params": state.params, "batch_stats": state.batch_stats}))
    opt = make_optimizer(model, LR, DECAY)
    gm = np.ones(6, bool)
    for step in range(2):
        state, loss = train_step(state, jb, key, jnp.asarray(gm), jnp.asarray(LR))
        mine = classification_step(model, opt, tb, torch.from_numpy(gm), sched(step))
        close(mine, loss, 1e-5, f"loss {step}")
        assert_params(model, state.params, f"step {step}")
        flat = flat_tree(jax.tree_util.tree_map(np.asarray, state.batch_stats))
        for k, v in stats(model).items():   # statistics of the stepped weights
            close(v, flat[k], 1e-4, k)
    # evaluation on JAX's stepped state (running statistics), loaded
    stepped = load_flax_variables(GNNGraphPred(3, 2, 16, device=CPU), np_tree(
        {"params": state.params, "batch_stats": state.batch_stats}))
    close(classification_eval(stepped, tb), eval_step(state, jb), 1e-5, "evaluation")
