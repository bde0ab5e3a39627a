"""Port parity: the QM9 regression finetune against the JAX package,
weights carried over by ``convert.py``.

- ``RegressionModel``: SchNet with the linear head (the CFConv's plain
  version, as "auto" takes on the CPU) and PaiNN with the MLP head, the
  predictions to 1e-5 of their largest value (floored at 1), with flax's
  parameter names.
- One and two regression steps (SchNet L1, PaiNN L2) against JAX's, with a
  cosine schedule and weight decay: the loss to 1e-5, every parameter after
  each step to 1e-4 of the leaf's largest value (floored at 1e-2), and the
  evaluation of JAX's stepped weights loaded into the port to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.finetune import create_regression_state, make_regression_steps
from moleculesde_tpu.utils.schedulers import make_lr_schedule as jax_make_lr_schedule
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.finetune.common import make_optimizer
from moleculesde_tpu_torch.finetune.regression import regression_eval, regression_step
from moleculesde_tpu_torch.utils.schedulers import make_lr_schedule

from torch_port_common import flat_tree, ieee_f32, np_tree, t  # noqa: F401 (ieee_f32: autouse)
from torch_port_finetune_common import (
    DECAY, LR, SCHED, assert_params, batches, close, jax_regression, port_regression)


@pytest.mark.parametrize("kind,loss_type", [("schnet", "mae"), ("painn", "mse")])
def test_regression_model_and_steps_match_jax(kind, loss_type):
    jb, tb = batches(5, 5, 6)
    jm = jax_regression(kind)
    jsched, sched = jax_make_lr_schedule(**SCHED), make_lr_schedule(**SCHED)
    state, tx = create_regression_state(jm, jb, jax.random.PRNGKey(1), lr=LR,
                                        schedule=jsched, weight_decay=DECAY)
    train_step, eval_step = make_regression_steps(jm, tx, loss_type, jsched)
    model = port_regression(kind, state.params)
    assert sorted(model.state_dict()) == sorted(flat_tree(np_tree({"params": state.params})[
        "params"]))
    out = regression_eval(model, tb)
    assert out.shape == (6,)
    close(out, eval_step(state, jb), 1e-5, "forward")
    opt = make_optimizer(model, LR, DECAY)
    gm = np.arange(6) < 5
    y = np.asarray(jb.y[:, 0])
    for step in range(2):
        state, loss = train_step(state, jb, jnp.asarray(y), jnp.asarray(gm), jnp.asarray(LR))
        mine = regression_step(model, opt, tb, t(y), torch.from_numpy(gm), sched(step),
                               loss_type)
        close(mine, loss, 1e-5, f"loss {step}")
        assert_params(model, state.params, f"{kind} step {step}")
    load_flax_variables(model, np_tree({"params": state.params}))
    close(regression_eval(model, tb), eval_step(state, jb), 1e-5, "evaluation")
