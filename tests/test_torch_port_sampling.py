"""Port parity: the PC sampler (moleculesde_tpu_torch.sampling.pc), the
GNN2D -> sampler slice and the RMSD metrics against the JAX package.

The JAX sampler's draws are rebuilt here on its own key path (split ->
k_init / k_scan, k_scan -> k_pred / k_corr) and injected into the port.
Tolerance f32 1e-4 relative to the largest coordinate: a few ulp per score
evaluation, carried through 3 PC steps (the corrector step size divides by
the score norm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import GNN2D as JaxGNN2D
from moleculesde_tpu.sampling import sample_positions_pc as jax_sample
from moleculesde_tpu.utils import rmsd as jax_rmsd
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.gnn2d import GNN2D
from moleculesde_tpu_torch.sampling.pc import sample_positions_pc
from moleculesde_tpu_torch.utils import rmsd

from test_torch_port_score_2d3d import make_pair
from torch_port_common import CPU, ieee_f32, np_tree, rel_err, t  # noqa: F401 (ieee_f32: autouse)

N_STEPS = 3


def jax_draws(key, shape, corrector_steps):
    """The draws of moleculesde_tpu.sampling.pc.sample_positions_pc."""
    k_init, k_scan = jax.random.split(key)
    k_pred, k_corr = jax.random.split(k_scan)
    return {"prior": t(jax.random.normal(k_init, shape)),
            "noise_p": t(jax.random.normal(k_pred, (N_STEPS,) + shape)),
            "noise_c": t(jax.random.normal(k_corr, (N_STEPS, corrector_steps) + shape))}


@pytest.fixture(scope="module")
def pair_v2():
    return make_pair(2, "float32", seed=3)


@pytest.mark.parametrize("corrector_steps", [1, 2])
def test_sample_positions_pc_matches_jax(pair_v2, corrector_steps):
    jm, v, tm, jb, tb, node_2d = pair_v2
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax_sample(jm, v, jnp.asarray(node_2d), jb, key, n_steps=N_STEPS,
                                corrector_steps=corrector_steps))
    out = sample_positions_pc(tm, t(node_2d), tb, n_steps=N_STEPS,
                              corrector_steps=corrector_steps,
                              **jax_draws(key, tuple(jb.positions.shape), corrector_steps))
    assert np.isfinite(out.numpy()).all()
    assert (out.numpy()[~tb.node_mask.numpy()] == 0).all()
    assert rel_err(out.numpy(), ref) < 1e-4


def test_score_chunk_gives_the_same_chain(pair_v2):
    _, _, tm, _, tb, node_2d = pair_v2
    outs = [sample_positions_pc(tm, t(node_2d), tb, torch.Generator().manual_seed(5),
                                n_steps=N_STEPS, score_chunk=chunk)
            for chunk in (None, 1)]
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-5, rtol=1e-5)


def test_gnn2d_to_sampler_slice_matches_jax():
    """The 2D->3D path end to end (GIN encoder, conditioning, PC chain) on
    converted weights and the JAX draws: variant 1, the CLI's default."""
    jm, v23, tm, jb, tb, _ = make_pair(1, "float32", seed=4)
    jg = JaxGNN2D(num_layers=2, emb_dim=16)
    key = jax.random.PRNGKey(2)
    v2d = jg.init({"params": key, "dropout": key}, jb)
    tg = load_flax_variables(GNN2D(num_layers=2, emb_dim=16, device=CPU), np_tree(v2d))
    node_j = jg.apply(v2d, jb, deterministic=True, use_running_average=True)
    ref = np.asarray(jax_sample(jm, v23, node_j, jb, key, n_steps=N_STEPS))
    with torch.no_grad():
        node_t = tg(tb, use_running_average=True)
    np.testing.assert_allclose(node_t.numpy(), np.asarray(node_j), atol=1e-5, rtol=1e-4)
    out = sample_positions_pc(tm, node_t, tb, n_steps=N_STEPS,
                              **jax_draws(key, tuple(jb.positions.shape), 1))
    assert rel_err(out.numpy(), ref) < 1e-4


def test_rmsd_metrics_match_jax():
    rng = np.random.default_rng(0)
    gen = rng.normal(size=(4, 6, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    ref = (gen[:2] @ rot.T + 0.01 * rng.normal(size=(2, 6, 3))).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    np.testing.assert_allclose(
        rmsd.pairwise_rmsd(t(gen), t(ref), t(mask)).numpy(),
        np.asarray(jax_rmsd.pairwise_rmsd(gen, ref, mask)), atol=1e-5)
    np.testing.assert_allclose(float(rmsd.kabsch_align(t(gen[0]), t(gen[0] @ rot.T))),
                               0.0, atol=1e-3)
    assert rmsd.coverage_matching(gen, ref, threshold=0.5) == pytest.approx(
        jax_rmsd.coverage_matching(gen, ref, threshold=0.5), abs=1e-5)
