"""Port parity: the MD17 energy and force finetune against the JAX
package, weights carried over by ``convert.py``, for SchNet (eager CFConv)
and PaiNN (the training steps: ``test_torch_port_finetune_md17_steps.py``).

- Energies to 1e-5 and forces to 1e-4 of their largest value (floored at
  1), on a batch with a padded graph slot and padded atoms (the distance
  guard's case); padded atoms' forces exactly 0.
- The parameter gradients of the loss, through the double backward,
  against JAX's grad-of-grad: 1e-4 of each leaf's largest value (floored
  at 1e-6); the loss and force MAE to 1e-5.
- The forces against central differences of the energy in float64 (h
  1e-4): 1e-6 of max(|F|, 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.finetune import create_md17_state, make_md17_steps
from moleculesde_tpu_torch.finetune.md17 import energy_and_forces, md17_eval, md17_loss

from torch_port_common import flat_tree, ieee_f32, t  # noqa: F401 (ieee_f32: autouse)
from torch_port_finetune_common import (
    LR, batches, close, grab_grads, jax_regression, port_regression)


@pytest.mark.parametrize("kind", ["schnet", "painn"])
def test_md17_forces_and_grad_of_grad_match_jax(kind):
    jb, tb = batches(6, 3, 4)   # a padded slot and padded atoms: the distance guard
    jm = jax_regression(kind)
    scale, shift = 0.5, -3.0
    grab = grab_grads()
    train_step, eval_step = make_md17_steps(jm, grab, energy_scale=scale, energy_shift=shift)
    state = create_md17_state(jm, jb, jax.random.PRNGKey(1))[0]
    state = state.replace(opt_state=grab.init(state.params))
    model = port_regression(kind, state.params, cfconv="xla")

    ref_e, ref_f = eval_step(state, jb)
    pred_e, pred_f = md17_eval(model, tb, scale, shift)
    close(pred_e, ref_e, 1e-5, "energies")
    close(pred_f, ref_f, 1e-4, "forces")
    assert not pred_f[~tb.node_mask].any()

    gm = np.arange(4) < 3
    y_e, y_f = np.asarray(jb.y[:, 0]), np.asarray(jb.forces)
    state, metrics = train_step(state, jb, jnp.asarray(y_e), jnp.asarray(y_f),
                                jnp.asarray(gm), jnp.asarray(LR))
    loss, parts = md17_loss(model, tb, t(y_e), t(y_f), torch.from_numpy(gm))
    close(loss, metrics["loss"], 1e-5, "loss")
    close(parts["force_mae"], metrics["force_mae"], 1e-5, "force MAE")
    loss.backward()
    ref_grads = flat_tree(jax.tree_util.tree_map(np.asarray, state.opt_state))
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(ref_grads)
    for k, p in named.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
        err = np.abs(p.grad.numpy() - ref_grads[k]).max()
        assert err <= 1e-4 * max(np.abs(ref_grads[k]).max(), 1e-6), (k, err)


@pytest.mark.parametrize("kind", ["schnet", "painn"])
def test_md17_forces_are_minus_the_energy_gradient(kind):
    """-dE/dpos against central differences of E in float64 on three
    coordinates of real atoms (h 1e-4)."""
    _, tb = batches(8, 2, 3)
    model = port_regression(kind, cfconv="xla").double()
    batch = tb.__class__(**{**tb.__dict__, "positions": tb.positions.double()})
    _, forces = energy_and_forces(model, batch, create_graph=False)
    h = 1e-4
    for atom, axis in ((0, 0), (2, 1), (9, 2)):
        assert bool(batch.node_mask[atom])
        plus, minus = batch.positions.clone(), batch.positions.clone()
        plus[atom, axis] += h
        minus[atom, axis] -= h
        with torch.no_grad():
            e_p = model(batch.__class__(**{**batch.__dict__, "positions": plus})).sum()
            e_m = model(batch.__class__(**{**batch.__dict__, "positions": minus})).sum()
        fd = -(e_p - e_m).item() / (2 * h)
        assert abs(forces[atom, axis].item() - fd) <= 1e-6 * max(1e-3, abs(fd)), (atom, axis)

