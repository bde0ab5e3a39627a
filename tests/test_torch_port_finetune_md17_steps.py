"""Port parity: one and two MD17 training steps (energy and forces through
the double backward) against the JAX package's, for SchNet (eager CFConv)
and PaiNN, with a cosine schedule and weight decay: the loss terms to 1e-5
and every parameter after each step to 1e-4 of the leaf's largest value
(floored at 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.finetune import create_md17_state, make_md17_steps
from moleculesde_tpu.utils.schedulers import make_lr_schedule as jax_make_lr_schedule
from moleculesde_tpu_torch.finetune.common import make_optimizer
from moleculesde_tpu_torch.finetune.md17 import md17_step
from moleculesde_tpu_torch.utils.schedulers import make_lr_schedule

from torch_port_common import ieee_f32, t  # noqa: F401 (ieee_f32: autouse)
from torch_port_finetune_common import (
    DECAY, LR, SCHED, assert_params, batches, close, jax_regression, port_regression)


@pytest.mark.parametrize("kind", ["schnet", "painn"])
def test_md17_steps_match_jax(kind):
    jb, tb = batches(7, 4, 4)
    jm = jax_regression(kind)
    jsched, sched = jax_make_lr_schedule(**SCHED), make_lr_schedule(**SCHED)
    state, tx = create_md17_state(jm, jb, jax.random.PRNGKey(1), lr=LR, schedule=jsched,
                                  weight_decay=DECAY)
    model = port_regression(kind, state.params, cfconv="xla")
    train_step, _ = make_md17_steps(jm, tx, schedule=jsched)
    opt = make_optimizer(model, LR, DECAY)
    gm = np.ones(4, bool)
    y_e, y_f = np.asarray(jb.y[:, 0]), np.asarray(jb.forces)
    for step in range(2):
        state, metrics = train_step(state, jb, jnp.asarray(y_e), jnp.asarray(y_f),
                                    jnp.asarray(gm), jnp.asarray(LR))
        mine = md17_step(model, opt, tb, t(y_e), t(y_f), torch.from_numpy(gm), sched(step))
        for k in ("loss", "energy_mae", "force_mae"):
            close(mine[k], metrics[k], 1e-5, f"{k} {step}")
        assert_params(model, state.params, f"{kind} step {step}")
