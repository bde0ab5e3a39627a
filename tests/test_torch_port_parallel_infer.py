"""Port parity: data parallelism (moleculesde_tpu_torch.parallel) in both PC
samplers and the three finetune steps, against the port's one-process run
and the JAX package's sharded functions.

Two gloo ranks on the CPU (``torch_port_parallel_worker.py``) run each case
on the blocks of a global batch of 8 graphs; this process runs the same
case on the whole batch (the JAX comparisons first, which compile while
the ranks run).

- Against the one-process run, f32: the 2D->3D and 3D->2D chains (4 PC
  steps, 2 corrector steps each) with their draws from a generator and
  with JAX's draws, stitched from the two ranks' blocks, to 1e-5 of the
  largest value; each finetune's loss to 1e-5 relative and every gradient
  leaf before Adam as in ``test_torch_port_parallel.py`` (1e-5 of the
  leaf's largest value or 1e-6 of the step's largest gradient), the
  MoleculeNet step with dropout 0.5 and with none, the evaluation outputs
  (logits, predictions, energies and forces) to 1e-5 and the running
  statistics to 1e-5.
- Against JAX's ``sharded_jit`` of ``sample_positions_pc`` /
  ``sample_graph_pc`` on a 2-device mesh with the draws replayed, atol and
  rtol 2e-4 (JAX's own bars, tests/test_parallel_inference.py), and
  against JAX's finetune steps built with ``mesh=``: the loss (and MD17's
  two MAEs) rtol 1e-5 and the evaluation outputs atol / rtol 1e-4, JAX's
  bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu.finetune import make_classification_steps, make_md17_steps
from moleculesde_tpu.finetune import make_regression_steps
from moleculesde_tpu.finetune.common import FinetuneState, adam_with_schedule
from moleculesde_tpu.finetune.regression import RegressionModel as JaxRegressionModel
from moleculesde_tpu.models import GNNGraphPred as JaxGNNGraphPred
from moleculesde_tpu.models import SchNet as JaxSchNet
from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.models import SDEModel3Dto2D as JaxSDEModel3Dto2D
from moleculesde_tpu.parallel import make_mesh, replicate, shard_batch, sharded_jit
from moleculesde_tpu.sampling import sample_graph_pc, sample_positions_pc

import torch_port_parallel_worker as w
from test_torch_port_parallel import check_one_process, flax_tree, module_ranks, stitched
from torch_port_common import ieee_f32  # noqa: F401 (ieee_f32: autouse)

CASES = ["sample_positions", "sample_graph", "finetune_classification",
         "finetune_regression", "finetune_md17"]
SAMPLER_KEY = 11
LR = 1e-3


def variables(module):
    """A port module's weights and statistics as a flax variable tree."""
    tree = {"params": flax_tree({"m": module})["m"]}
    stats = flax_tree({"m": module}, buffers=True)
    if stats:
        tree["batch_stats"] = stats["m"]
    return tree


@jax.jit
def jax_draws():
    """JAX's sampler draws, on its key paths (moleculesde_tpu/sampling/pc.py),
    in one program."""
    key = jax.random.PRNGKey(SAMPLER_KEY)
    shape = (w.B * w.N_MAX, 3)
    k_init, k_scan = jax.random.split(key)
    k_pred, k_corr = jax.random.split(k_scan)
    positions = dict(prior=jax.random.normal(k_init, shape),
                     noise_p=jax.random.normal(k_pred, (w.SAMPLER_STEPS,) + shape),
                     noise_c=jax.random.normal(k_corr, (w.SAMPLER_STEPS, w.CORRECTOR) + shape))
    b, n, c = w.B, w.N_MAX, 119
    k_x, k_adj, k_scan = jax.random.split(key, 3)
    per_step = (1 + w.CORRECTOR) * (b * n * c + b * n * n)
    graph = dict(x_prior=jax.random.normal(k_x, (b, n, c)),
                 adj_prior=jax.random.normal(k_adj, (b, n, n)),
                 noise=jax.random.normal(k_scan, (w.SAMPLER_STEPS, per_step)))
    return positions, graph


def write_draws(out):
    positions, graph = jax.device_get(jax_draws())
    np.savez(out / "draws_sample_positions.npz", **positions)
    np.savez(out / "draws_sample_graph.npz", **graph)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    yield from module_ranks(tmp_path_factory, "parallel_infer", CASES, write_draws)


def jax_batch(gs, **labels):
    return jax_pad_graphs(gs, n_max=w.N_MAX, e_max=4 * w.N_MAX, ext_e_max=w.N_MAX ** 2,
                          **labels)


def test_position_sampler_matches_jax_sharded(ranks):
    _, get = ranks
    model, _, node_2d = w.sampler_2d3d()
    jm = JaxSDEModel2Dto3D(emb_dim=w.EMB, hidden_dim=8, variant=1, sde_type="VE",
                           beta_min=0.2, beta_max=1.0, num_diffusion_timesteps=6)
    v = variables(model)
    jb = jax_batch(w.graphs(71))

    def generate(b, k):
        return sample_positions_pc(jm, v, jnp.asarray(node_2d), b, k, n_steps=w.SAMPLER_STEPS,
                                   corrector_steps=w.CORRECTOR)

    m2 = make_mesh(2)
    ref = sharded_jit(generate, m2, ("data", "repl"), "data")(
        shard_batch(jb, m2), jax.random.PRNGKey(SAMPLER_KEY))
    np.testing.assert_allclose(stitched(get("sample_positions"), "pos_jax"), np.asarray(ref),
                               atol=2e-4, rtol=2e-4)


def test_graph_sampler_matches_jax_sharded(ranks):
    _, get = ranks
    model, _, node_3d = w.sampler_3d2d()
    jm = JaxSDEModel3Dto2D(dim3d=w.EMB, nhid=8, num_layers=2, num_linears=2, c_init=2,
                           c_hid=4, c_final=3, adim=8, variant=1, sde_type="VE",
                           beta_min=0.1, beta_max=1.0, num_diffusion_timesteps=6,
                           bf16_attn=False)
    v = variables(model)
    jb = jax_batch(w.graphs(73))

    def generate(b, k):
        return sample_graph_pc(jm, v, jnp.asarray(node_3d), b, k, n_steps=w.SAMPLER_STEPS,
                               corrector_steps=w.CORRECTOR)

    m2 = make_mesh(2)
    ref = sharded_jit(generate, m2, ("data", "repl"), "data")(
        shard_batch(jb, m2), jax.random.PRNGKey(SAMPLER_KEY))
    per_rank = get("sample_graph")
    for name, r in zip(("x", "adj", "x_mean", "adj_mean"), ref):
        np.testing.assert_allclose(stitched(per_rank, f"{name}_jax"), np.asarray(r),
                                   atol=2e-4, rtol=2e-4, err_msg=name)


def finetune_inputs():
    gs = w.graphs(81, count=w.B - 1, tasks=w.TASKS)
    jb = jax_batch(gs, num_graphs=w.B, num_tasks=w.TASKS, with_forces=True)
    gm = np.arange(w.B) < len(gs)
    y_e, y_f = w.regression_targets()
    return jb, gm, y_e, y_f


def jax_state(model, tx):
    v = variables(model)
    return FinetuneState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                         opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))


def test_classification_step_matches_jax_sharded(ranks):
    _, get = ranks
    jb, gm, _, _ = finetune_inputs()
    jm = JaxGNNGraphPred(num_tasks=w.TASKS, num_layers=2, emb_dim=16, drop_ratio=0.0)
    tx = adam_with_schedule(LR, None, 0.0)
    m2 = make_mesh(2)
    train_m, eval_m = make_classification_steps(jm, tx, mesh=m2)
    state = replicate(jax_state(w.classification_model(0.0), tx), m2)
    sb = shard_batch(jb, m2)
    pred = eval_m(state, sb)
    _, loss = train_m(state, sb, replicate(jax.random.PRNGKey(0), m2), gm, jnp.asarray(LR))
    per_rank = get("finetune_classification")
    np.testing.assert_allclose(per_rank[0]["loss0.0"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(stitched(per_rank, "pred"), np.asarray(pred), atol=1e-4,
                               rtol=1e-4)


def jax_regression():
    enc = JaxSchNet(hidden_channels=16, num_filters=8, num_interactions=2, num_gaussians=10)
    return JaxRegressionModel(encoder=enc, head="linear")


def test_regression_step_matches_jax_sharded(ranks):
    _, get = ranks
    jb, gm, y, _ = finetune_inputs()
    tx = adam_with_schedule(LR, None, 0.0)
    m2 = make_mesh(2)
    train_m, eval_m = make_regression_steps(jax_regression(), tx, mesh=m2)
    state = replicate(jax_state(w.regression_model(), tx), m2)
    sb = shard_batch(jb, m2)
    pred = eval_m(state, sb)
    _, loss = train_m(state, sb, jnp.asarray(y), gm.astype(np.float32), jnp.asarray(LR))
    per_rank = get("finetune_regression")
    np.testing.assert_allclose(per_rank[0]["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(stitched(per_rank, "pred"), np.asarray(pred), atol=1e-4,
                               rtol=1e-4)


def test_md17_step_matches_jax_sharded(ranks):
    _, get = ranks
    jb, gm, y_e, y_f = finetune_inputs()
    tx = adam_with_schedule(LR, None, 0.0)
    m2 = make_mesh(2)
    train_m, eval_m = make_md17_steps(jax_regression(), tx, mesh=m2)
    state = replicate(jax_state(w.regression_model(), tx), m2)
    sb = shard_batch(jb, m2)
    energy, forces = eval_m(state, sb)
    _, metrics = train_m(state, sb, jnp.asarray(y_e), jnp.asarray(y_f),
                         gm.astype(np.float32), jnp.asarray(LR))
    per_rank = get("finetune_md17")
    for k in ("loss", "energy_mae", "force_mae"):
        np.testing.assert_allclose(per_rank[0][k], float(metrics[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(stitched(per_rank, "energy"), np.asarray(energy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(stitched(per_rank, "forces"), np.asarray(forces), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_one_process(ranks, case):
    out, get = ranks
    check_one_process(w.CASES[case](str(out)), get(case))
