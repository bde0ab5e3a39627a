"""Shared helpers of the finetune parity tests
(tests/test_torch_port_finetune*.py): batches with labels and forces
collated by both packages, the encoders at test widths, a JAX model and the
port's on the same weights, and the comparisons."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu.finetune.regression import RegressionModel as JaxRegressionModel
from moleculesde_tpu.models import PaiNN as JaxPaiNN
from moleculesde_tpu.models import SchNet as JaxSchNet
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.core.batch import pad_graphs
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.finetune.regression import RegressionModel
from moleculesde_tpu_torch.models.painn import PaiNN
from moleculesde_tpu_torch.models.schnet import SchNet

from torch_port_common import CPU, assert_params_after_step, np_tree

LR, DECAY = 1e-3, 1e-2
SCHED = dict(name="CosineAnnealingLR", lr=LR, epochs=2, steps_per_epoch=2, min_lr=1e-5)


def batches(seed: int, count: int, slots: int, n_max: int = 8, tasks: int = 3,
             lo: int = 3, hi: int = 7):
    """JAX's and the port's padded batch of ``count`` molecules in
    ``slots`` slots, labels in {-1, 0, 1} and random forces."""
    rng = np.random.default_rng(seed)
    gs = []
    for _ in range(count):
        g = random_molecule(rng, int(rng.integers(lo, hi + 1)), extend=False)
        g["y"] = rng.integers(-1, 2, size=tasks).astype(np.float32)
        g["forces"] = rng.normal(size=g["positions"].shape).astype(np.float32)
        gs.append(g)
    kw = dict(n_max=n_max, e_max=4 * n_max, num_graphs=slots, num_tasks=tasks,
              with_forces=True)
    return jax_pad_graphs(gs, **kw), pad_graphs(gs, **kw)


def close(mine, ref, tol, what=""):
    mine = mine.detach().numpy() if torch.is_tensor(mine) else np.asarray(mine)
    ref = np.asarray(ref)
    assert mine.shape == ref.shape, what
    err = np.abs(mine - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), (what, err)


def stats(module):
    return {k: v for k, v in module.state_dict().items() if k.endswith(("mean", "var"))}


WIDTHS = {"schnet": dict(hidden_channels=16, num_filters=8, num_interactions=2,
                        num_gaussians=11, cutoff=5.0),
          "painn": dict(n_atom_basis=16, n_interactions=2, n_rbf=8, cutoff=5.0)}
HEADS = {"schnet": "linear", "painn": "mlp"}


def jax_regression(kind):
    """The JAX package's RegressionModel at the test widths."""
    encoder = (JaxSchNet if kind == "schnet" else JaxPaiNN)(**WIDTHS[kind])
    return JaxRegressionModel(encoder=encoder, head=HEADS[kind])


def port_regression(kind, params=None, cfconv="auto"):
    """The port's RegressionModel at the test widths (SchNet's CFConv form
    ``cfconv``), with a flax ``params`` tree loaded when given."""
    if kind == "schnet":
        encoder = SchNet(**WIDTHS[kind], cfconv=cfconv, device=CPU)
    else:
        encoder = PaiNN(**WIDTHS[kind], device=CPU)
    model = RegressionModel(encoder, HEADS[kind])
    if params is not None:
        load_flax_variables(model, np_tree({"params": params}))
    return model


def assert_params(model, params, what):
    try:
        assert_params_after_step({"model": model}, {"model": jax.tree_util.tree_map(
            np.asarray, params)}, LR)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def grab_grads():
    """An optax transformation whose state becomes the gradients and whose
    updates are zero: JAX's step then returns its gradients."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))
