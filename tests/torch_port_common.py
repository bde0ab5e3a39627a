"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to the JAX package and to
the port as arrays; weights move JAX -> port through
``moleculesde_tpu_torch.convert``.
"""

from __future__ import annotations

import contextlib
import functools
import re

import jax
import numpy as np
import pytest
import torch

from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu_torch.core.batch import pad_graphs as torch_pad_graphs
from moleculesde_tpu_torch.data.synthetic import random_molecule

CPU = "cpu"

# One intra-op thread for torch in every process that runs the port's
# tests: their tensors are tiny, and under pytest-xdist each worker's
# OpenMP team would otherwise spin on the cores that the other workers use
# (six concurrent runs of test_torch_port_model_surface.py's CLI drives on
# an 8-core host: 174 s each with the default threads, 12 s with one)
torch.set_num_threads(1)


def numeric_state() -> str:
    """The process-wide settings that the two frameworks' f32 products
    read, as one line for a failure message: torch's float32 matmul
    precision (legacy and per-backend), its intra-op threads, JAX's
    default matmul precision and x64 flag."""
    def read(get):
        try:
            return get()
        except RuntimeError as e:   # torch's legacy getter after a mix of the two APIs
            return f"unreadable ({str(e)[:40]})"

    return (f"torch matmul precision {read(torch.get_float32_matmul_precision)!r}, "
            f"mkldnn matmul {read(lambda: torch.backends.mkldnn.matmul.fp32_precision)!r}, "
            f"mkldnn {read(lambda: torch.backends.mkldnn.fp32_precision)!r}, "
            f"threads {torch.get_num_threads()}; jax matmul precision "
            f"{jax.config.jax_default_matmul_precision!r}, x64 {jax.config.jax_enable_x64}")


@contextlib.contextmanager
def ieee_f32_products():
    """Full-f32 products in both frameworks for the block: torch's float32
    matmul precision "highest" (which also sets the oneDNN and CUDA matmul
    backends' fp32 precision to IEEE), JAX's default matmul precision
    "highest" and 32-bit JAX types; torch's process-wide setting is
    restored afterwards.  A reduced mode ("high" / "medium") left in the
    process lets torch's CPU products of f32 operands run at less than f32
    precision, far past the 1e-5 parity bars: once, in a 6-worker run of
    the suite, K7's 2-term per-head dots read 1e-5 off the float64 oracle
    on the port's side (test_torch_port_attn_bank.py).  That failure and a
    later one have not been reproduced since (two 6-worker runs and the K7
    test after each other test file in one process); the K7 test's
    messages name the side, the place and :func:`numeric_state`."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"), jax.enable_x64(False):
            yield
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.fixture(autouse=True)
def ieee_f32():
    """Every test of a module that imports this fixture runs under
    :func:`ieee_f32_products`."""
    with ieee_f32_products():
        yield


def graphs(seed: int, count: int, n_max: int, min_atoms: int = 3):
    rng = np.random.default_rng(seed)
    return [random_molecule(rng, int(rng.integers(min_atoms, n_max + 1)))
            for _ in range(count)]


def both_batches(gs, n_max: int, e_max: int | None = None,
                 ext_e_max: int | None = None):
    """The same graph dicts collated by the JAX package and by the port."""
    e_max = e_max or 4 * n_max
    ext_e_max = ext_e_max or n_max * n_max
    return (jax_pad_graphs(gs, n_max=n_max, e_max=e_max, ext_e_max=ext_e_max),
            torch_pad_graphs(gs, n_max=n_max, e_max=e_max, ext_e_max=ext_e_max))


def np_tree(variables):
    """A flax variable tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray,
                                  {k: variables[k] for k in ("params", "batch_stats")
                                   if k in variables})


def t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# leaves whose gradient is zero in exact arithmetic: the biases in front of a
# training-mode BatchNorm (GIN's two Dense layers, the 2D->3D pair Linear)
# and the attention key bias (the softmax over keys drops a shift).  Both
# frameworks hold rounding noise there, which a first Adam step turns into
# steps of up to lr either way.
ZERO_GRAD = re.compile(r"GINConv_\d+\.Dense_\d\.bias|edge_2D_emb_0\.bias|lin_key\.bias")


def flat_tree(tree, prefix=""):
    """A nested dict of arrays as {dotted key: f32 numpy array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        out.update(flat_tree(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v, np.float32)})
    return out


def replay_score_draws(k_23, k_32, b: int, n: int):
    """The two score losses' draws of a batch of ``b`` graphs of ``n_max =
    n``, replayed from the JAX keys each loss splits (``SDEModel2Dto3D.loss``
    and ``SDEModel3Dto2D.loss``)."""
    k_noise, k_t = jax.random.split(k_23)
    k_t3, k_adj, k_x = jax.random.split(k_32, 3)
    return {"sde_2dto3d": {"pos_noise": t(jax.random.normal(k_noise, (b * n, 3))),
                           "half": t(jax.random.randint(k_t, (b // 2 + 1,), 0, 1000)).long()},
            "sde_3dto2d": {"half": t(jax.random.randint(k_t3, (b // 2 + 1,), 0, 1000)).long(),
                           "z_adj": t(jax.random.normal(k_adj, (b, n, n))),
                           "z_x": t(jax.random.normal(k_x, (b, n, 119)))}}


@contextlib.contextmanager
def jax_score_dropout_off():
    """JAX's 2D->3D score network built with dropout 0 (its 0.1 is fixed,
    and the JAX training step runs it in training mode), so that the JAX
    package's own step can be held against the port's deterministic one."""
    import moleculesde_tpu.models.score_2d3d as jax_score_2d3d

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_score_2d3d, "EquivariantScoreNetwork", functools.partial(
            jax_score_2d3d.EquivariantScoreNetwork, dropout=0.0))
        yield


def assert_params_after_step(models, params_ref, lr: float) -> None:
    """Every port parameter against the JAX package's after one Adam step:
    1e-4 of the leaf's largest value (floored at 1e-2); the ``ZERO_GRAD``
    leaves to 2 lr."""
    flat = flat_tree(params_ref)
    checked = 0
    for comp, module in models.items():
        for name, p in module.named_parameters():
            key = f"{comp}.{name}"
            ref = flat[key]
            diff = np.abs(p.detach().numpy() - ref).max()
            if ZERO_GRAD.search(key):
                assert diff <= 2 * lr, (key, diff)
            else:
                assert diff / max(np.abs(ref).max(), 1e-2) < 1e-4, (key, diff)
            checked += 1
    assert checked == len(flat)
