"""Port parity: the 3D->2D graph sampler (``sampling.pc.sample_graph_pc``)
against the JAX package, its CLI, and the pretraining config's attention
bank switch.

The JAX sampler's draws are rebuilt on its own key path (split into k_x,
k_adj, k_scan; the chain's noise one [steps, per_step] slab from k_scan)
and injected into the port.  Tolerance: atol 2e-4 + rtol 1e-3 on x, adj,
x_mean and adj_mean after 3 f32 steps with 2 corrector steps each: the SNR
step size divides two batch-mean norms of the score, so a few ulp in a
score evaluation are amplified along the chain."""

import datetime
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import SDEModel3Dto2D as JaxSDEModel3Dto2D
from moleculesde_tpu.sampling import sample_graph_pc as jax_sample_graph
from moleculesde_tpu_torch.convert import load_flax_variables, save_checkpoint
from moleculesde_tpu_torch.examples import pretrain as pretrain_cli
from moleculesde_tpu_torch.examples import sample_3d_to_2d as cli
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D, StackedEdgeLayers
from moleculesde_tpu_torch.parallel import mesh
from moleculesde_tpu_torch.pretrain.train_state import PretrainConfig, build_models
from moleculesde_tpu_torch.pretrain.train_step import draw_losses, pretrain_loss
from moleculesde_tpu_torch.sampling import pc

from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, t)

EMB, STEPS, CORRECTOR = 16, 3, 2
TINY = ["--device", "cpu", "--dataset", "synthetic", "--batch_size", "2", "--end", "3",
        "--n_max", "8", "--emb_dim", "16", "--SchNet_num_interactions", "2",
        "--SchNet_num_filters", "16",
        "--num_diffusion_timesteps_3Dto2D_inference", "2", "--steps_pos", "2"]


@pytest.fixture(scope="module")
def pair():
    jb, tb = both_batches(graphs(seed=17, count=4, n_max=8), n_max=8)
    kw = dict(dim3d=EMB, variant=2, bf16_attn=False, nhid=8, num_layers=2)
    jm = JaxSDEModel3Dto2D(**kw)
    v = jax.jit(lambda z: jm.init(jax.random.PRNGKey(3), z, jb, jax.random.PRNGKey(4),
                                  method=JaxSDEModel3Dto2D.loss))(jnp.zeros((jb.num_nodes, EMB)))
    tm = load_flax_variables(SDEModel3Dto2D(**kw, device=CPU), np_tree(v))
    node_3d = np.random.default_rng(9).normal(size=(jb.num_nodes, EMB)).astype(np.float32)
    return jm, v, tm, jb, tb, node_3d


def test_sample_graph_pc_matches_jax(pair):
    jm, v, tm, jb, tb, node_3d = pair
    key = jax.random.PRNGKey(13)
    ref = jax.jit(lambda n3d, k: jax_sample_graph(jm, v, n3d, jb, k, n_steps=STEPS,
                                                   corrector_steps=CORRECTOR))(
        jnp.asarray(node_3d), key)
    b, n, c = jb.num_graphs, jb.n_max, 119
    k_x, k_adj, k_scan = jax.random.split(key, 3)
    per_step = (1 + CORRECTOR) * (b * n * c + b * n * n)
    draws = {"x_prior": t(jax.random.normal(k_x, (b, n, c))),
             "adj_prior": t(jax.random.normal(k_adj, (b, n, n))),
             "noise": t(jax.random.normal(k_scan, (STEPS, per_step)))}
    out = pc.sample_graph_pc(tm, t(node_3d), tb, n_steps=STEPS, corrector_steps=CORRECTOR,
                             **draws)
    for name, mine, theirs in zip(("x", "adj", "x_mean", "adj_mean"), out, ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    flags = tb.node_mask.reshape(b, n).numpy()
    assert (out[1].numpy()[~flags] == 0).all()


@pytest.mark.parametrize("hoist", [True, False], ids=["slab", "per_step"])
def test_drawn_noise_paths(pair, monkeypatch, hoist):
    """Without injected draws the chain takes them from the generator: the
    whole chain's noise in one slab under the 128 MiB limit, one slab per
    step above it; either way the same seed gives the same graphs."""
    _, _, tm, _, tb, node_3d = pair
    if not hoist:
        monkeypatch.setattr(pc, "_HOIST_LIMIT_BYTES", 0)
    calls = []
    randn = torch.randn
    monkeypatch.setattr(torch, "randn", lambda *a, **k: calls.append(a[0]) or randn(*a, **k))

    def run(seed):
        return pc.sample_graph_pc(tm, t(node_3d), tb, torch.Generator().manual_seed(seed),
                                  n_steps=STEPS, corrector_steps=CORRECTOR)

    first = run(1)
    slabs = [s for s in calls if len(s) <= 2 and s[-1] > 2000]
    assert len(slabs) == (1 if hoist else STEPS)
    assert all(torch.isfinite(x).all() for x in first)
    for a, b_ in zip(first, run(1)):
        assert torch.equal(a, b_)
    assert not torch.equal(first[3], run(2)[3])


def test_cli_writes_graphs_on_cpu(tmp_path, capsys):
    res = cli.main(TINY + ["--output_model_dir", str(tmp_path)])
    assert [r["x_gen"].shape for r in res] == [(2, 8, 119), (1, 8, 119)]
    for r in res:
        assert r["adj_gen"].shape == (r["x_gen"].shape[0], 8, 8)
        assert r["atom_feats_true"].shape == (r["x_gen"].shape[0], 8, 9)
        assert np.isfinite(r["x_gen"]).all() and np.isfinite(r["adj_gen"]).all()
    with open(tmp_path / "3D_to_2D_PC_0_3.pkl", "rb") as fh:
        assert len(pickle.load(fh)) == 2
    assert "generated 2 graphs" in capsys.readouterr().out


def test_cli_needs_a_gpu_unless_asked_and_refuses_what_is_not_ported(monkeypatch):
    """Without ``--device cpu`` the CLI raises (also with ``--num_devices
    2``, before any rank starts); ``--num_devices 2 --device cpu`` runs two
    gloo ranks and gives the one-process run's graphs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mesh, "TIMEOUT", datetime.timedelta(seconds=60))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TINY[2:])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TINY[2:] + ["--num_devices", "2"])
    one, two = cli.main(TINY), cli.main(TINY + ["--num_devices", "2"])
    assert len(one) == len(two) == 2
    for a, b in zip(two, one):
        for k in ("x_gen", "adj_gen"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_pretrain_checkpoint_drives_the_cli(tmp_path, capsys):
    """The pretraining CLI's four-component .pt -> the sampler's
    ``--input_model_file``: model_3D and SDE_3Dto2D_model load, variant 3."""
    argv = TINY + ["--SDE_3Dto2D_model", "SDEModel3Dto2D_node_adj_dense_03"]
    args = cli.get_parser().parse_args(argv)
    encoder, sde_model = cli.build_models(args, "cpu")
    with torch.no_grad():
        for p in list(encoder.parameters()) + list(sde_model.parameters()):
            p.add_(0.01)
    path = str(tmp_path / "pre.pt")
    save_checkpoint(path, {"model_3D": encoder, "SDE_3Dto2D_model": sde_model}, vars(args))
    loaded = cli.build_models(cli.get_parser().parse_args(argv + ["--input_model_file", path]),
                              "cpu")
    for mine, theirs in zip((encoder, sde_model), loaded):
        for (k, a), (k2, b) in zip(mine.state_dict().items(), theirs.state_dict().items()):
            assert k == k2 and torch.equal(a, b), k
    assert "loaded checkpoint" in capsys.readouterr().out


def test_pretrain_config_attn_impl_reaches_every_edge_layer():
    """``PretrainConfig.attn_impl_3dto2d`` sets the bank of every edge layer,
    and in f32 the K7 / K8 plain versions give the eager bank's loss."""
    args = pretrain_cli.get_parser().parse_args(
        ["--device", "cpu", "--dataset", "synthetic", "--batch_size", "2", "--n_max", "8",
         "--emb_dim", "16", "--num_layer", "2", "--SchNet_num_interactions", "2",
         "--SchNet_num_filters", "16",
         "--train_precision", "float32",
         "--SDE_3Dto2D_model", "SDEModel3Dto2D_node_adj_dense_02"])
    base = pretrain_cli.config_from_args(args)
    assert base.sde_3dto2d_variant == 2
    batch = pretrain_cli.make_loader(pretrain_cli.load_graphs(args), args).collate_indices(
        np.arange(2))[0]
    losses = {}
    for impl in ("auto", "pallas", "fused"):
        cfg = PretrainConfig(**{**base.__dict__, "attn_impl_3dto2d": impl})
        models = build_models(cfg, "cpu", torch.Generator().manual_seed(0))
        layers = [m for m in models["SDE_3Dto2D_model"].modules()
                  if isinstance(m, StackedEdgeLayers)]
        assert len(layers) == 4 and all(m.attn_impl == impl for m in layers)
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            _, mets = pretrain_loss(models, cfg, batch, g,
                                    draws=draw_losses(models, cfg, batch, g))
        losses[impl] = mets["SDE_loss_3Dto2D"].item()
    for impl in ("pallas", "fused"):
        assert losses[impl] == pytest.approx(losses["auto"], rel=1e-5)
