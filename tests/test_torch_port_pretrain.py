"""Port parity: the pretraining step (moleculesde_tpu_torch.pretrain) against
the JAX package, plus the pretraining CLI on the CPU.

- ``dual_cl``, all three metrics, with the shifts replayed from the JAX
  key: loss, accuracy and gradients, f32 1e-5.
- One whole step at ``train_precision float32`` with dropout off on both
  sides: the JAX side is a test-local loss that composes the same module
  calls as ``make_pretrain_loss`` with ``deterministic=True``, the port's is
  ``pretrain_loss`` with the replayed draws.  Loss terms agree to 1e-5
  relative, every gradient leaf to 1e-4 of its largest value (floored at
  1e-2 for leaves that are zero in exact arithmetic), and the updated
  BatchNorm statistics to 1e-5.
- Adam: both optimizers get the same gradients for two steps (the first
  Adam step turns near-zero gradients into +-lr, so gradients from two
  frameworks would not do), with L2 decay and unequal LR groups; the
  two-step updates agree to 1e-4 relative (floor: 1% of one lr step).
"""

import datetime
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu.data.loader import GraphLoader as JaxGraphLoader
from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.models import SDEModel3Dto2D as JaxSDEModel3Dto2D
from moleculesde_tpu.pretrain.contrastive import dual_cl as jax_dual_cl
from moleculesde_tpu.pretrain.train_state import PretrainConfig as JaxPretrainConfig
from moleculesde_tpu.pretrain.train_state import build_models as jax_build_models
from moleculesde_tpu.pretrain.train_state import create_pretrain_state
from moleculesde_tpu.pretrain.train_state import make_optimizer as jax_make_optimizer
from moleculesde_tpu_torch.convert import load_checkpoint, load_flax_pretrain
from moleculesde_tpu_torch.data.loader import GraphLoader
from moleculesde_tpu_torch.examples import pretrain as cli
from moleculesde_tpu_torch.examples import sample_2d_to_3d as sample_cli
from moleculesde_tpu_torch.examples import sample_3d_to_2d as sample_3d2d_cli
from moleculesde_tpu_torch.models.gnn2d import GNN2D
from moleculesde_tpu_torch.models.layers import dropout
from moleculesde_tpu_torch.parallel import mesh
from moleculesde_tpu_torch.pretrain.contrastive import dual_cl
from moleculesde_tpu_torch.pretrain.train_state import (
    PretrainConfig, build_models, make_optimizer)
from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_loss

from torch_port_common import CPU, graphs, ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)

TINY = dict(emb_dim=16, num_layer=2, schnet_num_filters=8, schnet_num_interactions=2,
            schnet_num_gaussians=11, hidden_dim_2dto3d=16,
            cl_similarity_metric="InfoNCE_dot_prod")


def _configs(precision="float32", **over):
    """(JAX config, port config) for one --train_precision: the port's one
    field, the JAX config's five, set as the JAX CLI sets them."""
    bf16 = precision == "bfloat16"
    jcfg = JaxPretrainConfig(**TINY, **over, bf16_pairs=bf16, score_dtype_2dto3d=precision,
                             schnet_bf16=bf16, gnn2d_bf16=bf16, bf16_attn_3dto2d=bf16)
    return jcfg, PretrainConfig(**TINY, **over, train_precision=precision)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v, np.float32)})
    return out


def _leaf_err(mine, ref) -> float:
    return float(np.abs(mine - ref).max() / max(np.abs(ref).max(), 1e-2))


@pytest.mark.parametrize("metric", ["InfoNCE_dot_prod", "EBM_dot_prod", "EBM_node_dot_prod"])
def test_dual_cl_matches_jax(metric):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(10, 6)).astype(np.float32)
    y = rng.normal(size=(10, 6)).astype(np.float32)
    mask = rng.random(10) < 0.7
    key = jax.random.PRNGKey(4)

    def jl(x_, y_):
        loss, acc = jax_dual_cl(x_, y_, key, metric=metric, T=0.1, mask=mask)
        return loss, acc

    (loss_j, acc_j), (gx_j, gy_j) = jax.value_and_grad(jl, argnums=(0, 1), has_aux=True)(x, y)
    # replay the shift draws (contrastive.py:92 under dual_cl's split)
    shifts = tuple(t(jax.random.randint(k, (), 1, 10)).long()
                   for k in jax.random.split(key))
    xt, yt = t(x).requires_grad_(True), t(y).requires_grad_(True)
    loss_t, acc_t = dual_cl(xt, yt, metric, 0.1, mask=t(mask), shifts=shifts)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert acc_t.item() == pytest.approx(float(acc_j), abs=1e-6)
    assert rel_err(xt.grad.numpy(), gx_j) < 1e-5
    assert rel_err(yt.grad.numpy(), gy_j) < 1e-5


@pytest.fixture(scope="module")
def step_pair():
    return make_step_pair()


def make_step_pair(**over):
    """JAX models, state, one step's loss terms, gradients and updated
    statistics; the port's models carrying the same variables; the draws.
    ``over``: config fields other than the tiny defaults."""
    gs = graphs(seed=41, count=4, n_max=8)
    jb = jax_pad_graphs(gs, n_max=8, e_max=32, ext_e_max=64)
    tb = GraphLoader(gs, batch_size=4, n_max=8, e_max=32, ext_e_max=64, shuffle=False
                     ).collate_indices(np.arange(4))[0]
    jcfg, tcfg = _configs(**over)
    models = jax_build_models(jcfg)
    state = jax.jit(lambda k: create_pretrain_state(jcfg, jb, k)[1])(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(77)

    def loss_fn(params, batch_stats):
        # make_pretrain_loss's module calls (train_step.py:102-175) with
        # dropout off
        _, k_cl, k_23, k_32 = jax.random.split(key, 4)
        node_2d, mut2d = models["model_2D"].apply(
            {"params": params["model_2D"], "batch_stats": batch_stats["model_2D"]}, jb,
            deterministic=True, use_running_average=False, mutable=["batch_stats"])
        _, node_3d = models["model_3D"].apply(
            {"params": params["model_3D"]}, jb.atomic_numbers, jb.positions, jb.node_mask,
            jb.num_graphs, jb.n_max)
        cl_loss, cl_acc = jax_dual_cl(node_2d, node_3d, k_cl, metric=jcfg.cl_similarity_metric,
                                      T=jcfg.T, mask=jb.node_mask)
        out23, mut23 = models["SDE_2Dto3D_model"].apply(
            {"params": params["SDE_2Dto3D_model"],
             "batch_stats": batch_stats["SDE_2Dto3D_model"]}, node_2d, jb, k_23, 0.0,
            deterministic=True, use_running_average=False, mutable=["batch_stats"],
            method=JaxSDEModel2Dto3D.loss)
        loss_x, loss_adj = models["SDE_3Dto2D_model"].apply(
            {"params": params["SDE_3Dto2D_model"]}, node_3d, jb, k_32, 0.0, True,
            method=JaxSDEModel3Dto2D.loss)
        loss_32 = 0.5 * (loss_x + loss_adj)
        total = cl_loss + out23["position"] + loss_32
        metrics = {"CL_loss": cl_loss, "CL_acc": cl_acc, "SDE_loss_2Dto3D": out23["position"],
                   "SDE_loss_3Dto2D": loss_32, "loss": total}
        return total, (metrics, {"model_2D": mut2d["batch_stats"],
                                 "SDE_2Dto3D_model": mut23["batch_stats"]})

    (_, (metrics_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params, state.batch_stats)
    # replay the draws: train_step.py:104, then each loss's own split
    _, _, k_23, k_32 = jax.random.split(key, 4)
    k_noise, k_t = jax.random.split(k_23)
    k_t3, k_adj, k_x = jax.random.split(k_32, 3)
    b, n = jb.num_graphs, jb.n_max
    draws = {"cl": None,
             "sde_2dto3d": {"pos_noise": t(jax.random.normal(k_noise, jb.positions.shape)),
                            "half": t(jax.random.randint(k_t, (b // 2 + 1,), 0, 1000)).long()},
             "sde_3dto2d": {"half": t(jax.random.randint(k_t3, (b // 2 + 1,), 0, 1000)).long(),
                            "z_adj": t(jax.random.normal(k_adj, (b, n, n))),
                            "z_x": t(jax.random.normal(k_x, (b, n, 119)))}}
    tmodels = load_flax_pretrain(build_models(tcfg, CPU), jax.device_get(state.params),
                                 jax.device_get(state.batch_stats))
    return dict(jcfg=jcfg, state=state, metrics=metrics_j, stats=stats_j, grads=grads_j,
                tcfg=tcfg, tmodels=tmodels, tb=tb, draws=draws)


def test_whole_step_matches_jax(step_pair):
    check_whole_step(step_pair)


def check_whole_step(p, zero_grad=None):
    """The port's loss terms, every gradient leaf and the updated BatchNorm
    statistics against the JAX step of :func:`make_step_pair` (the bars of
    the module docstring).  Leaves matching ``zero_grad`` (a regex on
    "component.name") have a zero gradient in exact arithmetic and are held
    to 1e-6 of the step's largest gradient instead."""
    models = p["tmodels"]
    total, metrics = pretrain_loss(models, p["tcfg"], p["tb"], deterministic=True,
                                   draws=p["draws"])
    total.backward()
    for k in METRICS:
        ref = float(p["metrics"][k])
        assert abs(metrics[k].item() - ref) <= 1e-5 * max(abs(ref), 1.0), k
    grads_j = _flat(jax.device_get(p["grads"]))
    scale = max(float(np.abs(g).max()) for g in grads_j.values())
    checked = 0
    for comp, module in models.items():
        for name, param in module.named_parameters():
            ref = grads_j[f"{comp}.{name}"]
            mine = (param.grad.numpy() if param.grad is not None
                    else np.zeros(tuple(param.shape), np.float32))
            if zero_grad is not None and re.search(zero_grad, f"{comp}.{name}"):
                assert float(np.abs(mine - ref).max()) <= 1e-6 * scale, (comp, name)
            else:
                assert _leaf_err(mine, ref) < 1e-4, (comp, name, _leaf_err(mine, ref))
            checked += 1
    assert checked == len(grads_j)
    stats_j = _flat(jax.device_get(p["stats"]))
    for comp in ("model_2D", "SDE_2Dto3D_model"):
        for name, buf in models[comp].named_buffers():
            np.testing.assert_allclose(buf.numpy(), stats_j[f"{comp}.{name}"], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{comp}.{name}")


def test_adam_matches_jax_on_the_same_gradients(step_pair):
    p = step_pair
    jcfg, tcfg = _configs(decay=0.01, gnn_2d_lr_scale=0.5, gnn_3d_lr_scale=2.0, lr=3e-3)
    tx = jax_make_optimizer(jcfg)
    params = p["state"].params
    opt_state = tx.init(params)
    grads = p["grads"]
    models = {k: m for k, m in build_models(tcfg, CPU).items()}
    load_flax_pretrain(models, jax.device_get(params), jax.device_get(p["state"].batch_stats))
    opt = make_optimizer(models, tcfg)
    for scale in (1.0, -0.5):       # two steps: bias correction and moments
        g_step = jax.tree_util.tree_map(lambda g: g * scale, grads)
        updates, opt_state = tx.update(g_step, opt_state, params)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
        flat_g = _flat(jax.device_get(g_step))
        for comp, module in models.items():
            for name, param in module.named_parameters():
                param.grad = torch.from_numpy(flat_g[f"{comp}.{name}"].copy())
        opt.step()
    flat_p = _flat(jax.device_get(params))
    flat_0 = _flat(jax.device_get(p["state"].params))
    for comp, module in models.items():
        for name, param in module.named_parameters():
            key_ = f"{comp}.{name}"
            moved = param.detach().numpy() - flat_0[key_]
            # the two-step update itself, the frozen Fourier weights included
            # (the L2 decay moves them in both): the same f32 formula
            # evaluated in another order.  Where the decayed gradient
            # g + decay * p nearly cancels, or |g| ~ eps, m / (sqrt(v) + eps)
            # is sensitive to the last bit of its inputs, hence the floor of
            # 1% of one lr step
            np.testing.assert_allclose(moved, flat_p[key_] - flat_0[key_], rtol=1e-4,
                                       atol=1e-2 * tcfg.lr, err_msg=key_)


def test_weight_decay_moves_frozen_weights_as_jax(step_pair):
    """Two steps at decay 0.01 and the default lr: the frozen Fourier weights
    get no gradient from autograd (``.grad`` None, JAX's stop_gradient), the
    rest get the JAX step's gradients; every parameter lands where the JAX
    package's flattened Adam puts it, to 1e-6 of the leaf's largest value."""
    p = step_pair
    jcfg, tcfg = _configs(decay=0.01)
    tx = jax_make_optimizer(jcfg)
    params = p["state"].params
    opt_state = tx.init(params)
    models = load_flax_pretrain(build_models(tcfg, CPU), jax.device_get(params),
                                jax.device_get(p["state"].batch_stats))
    opt = make_optimizer(models, tcfg)
    flat_g = _flat(jax.device_get(p["grads"]))
    for _ in range(2):
        updates, opt_state = tx.update(p["grads"], opt_state, params)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
        opt.zero_grad(set_to_none=True)
        for comp, module in models.items():
            for name, param in module.named_parameters():
                if param.requires_grad:
                    param.grad = torch.from_numpy(flat_g[f"{comp}.{name}"].copy())
        opt.step()
    flat_p, flat_0 = _flat(jax.device_get(params)), _flat(jax.device_get(p["state"].params))
    frozen = 0
    for comp, module in models.items():
        for name, param in module.named_parameters():
            key_ = f"{comp}.{name}"
            ref = flat_p[key_]
            if not param.requires_grad:
                frozen += 1
                assert float(np.abs(ref - flat_0[key_]).max()) > 0.0, key_
            assert _leaf_err(param.detach().numpy(), ref) <= 1e-6, (key_, _leaf_err(
                param.detach().numpy(), ref))
    assert frozen == 1   # SDE_2Dto3D_model.coff_fourier_W (variant 1)


def test_dropout_keep_rate_scaling_and_seed():
    x = torch.ones(200_000)
    rate = 0.3

    def draw(seed):
        return dropout(x, rate, torch.Generator().manual_seed(seed))

    out = draw(5)
    kept = out != 0
    keep = kept.float().mean().item()
    # binomial keep-rate: 5 standard deviations of 2e5 draws
    assert abs(keep - (1 - rate)) < 5 * ((rate * (1 - rate)) / x.numel()) ** 0.5
    assert torch.equal(out[kept], torch.full((int(kept.sum()),), 1 / (1 - rate)))
    assert torch.equal(draw(5), out) and not torch.equal(draw(6), out)
    assert torch.equal(dropout(x, rate, None, deterministic=True), x)
    gs = graphs(seed=3, count=3, n_max=7)
    tb = GraphLoader(gs, batch_size=3, n_max=7, shuffle=False).collate_indices(np.arange(3))[0]
    m = GNN2D(num_layers=2, emb_dim=8, drop_ratio=0.5, device=CPU)

    def encode(seed):
        with torch.no_grad():
            return m(tb, use_running_average=True, deterministic=False,
                     generator=torch.Generator().manual_seed(seed))

    assert torch.equal(encode(1), encode(1)) and not torch.equal(encode(1), encode(2))


def test_loader_matches_jax_order_and_collation():
    gs = graphs(seed=8, count=10, n_max=7)
    mine = GraphLoader(gs, batch_size=4, n_max=7, seed=3)
    theirs = JaxGraphLoader(gs, batch_size=4, n_max=7, seed=3, collate="padded")
    for _ in range(2):   # two epochs: the shuffle state advances alike
        for (bt, nt), (bj, nj) in zip(mine, theirs):
            assert nt == nj == 4
            for field in ("atom_feats", "node_mask", "edge_src", "ext_src", "positions"):
                np.testing.assert_array_equal(getattr(bt, field).numpy(),
                                              np.asarray(getattr(bj, field)), err_msg=field)
    assert len(mine) == len(theirs) == 2


TINY_FLAGS = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_molecules", "12",
              "--batch_size", "4",
              "--n_max", "8", "--emb_dim", "16", "--num_layer", "2",
              "--SchNet_num_interactions", "2", "--SchNet_num_filters", "8"]


def test_pretrain_cli_trains_on_cpu_and_hands_off_to_the_sampler(tmp_path, capsys):
    history = cli.main(TINY_FLAGS + ["--epochs", "2", "--output_model_dir", str(tmp_path)])
    assert len(history) == 2
    assert all(np.isfinite(list(h.values())).all() for h in history)
    out = capsys.readouterr().out
    assert "CL Loss:" in out and "SDE 3Dto2D Loss:" in out
    ckpt = load_checkpoint(str(tmp_path / "model_complete_final.pt"))
    assert {"model_2D", "model_3D", "SDE_2Dto3D_model", "SDE_3Dto2D_model"} <= set(ckpt)
    assert (tmp_path / "model_complete.pt").exists()
    res = sample_cli.main(["--device", "cpu", "--dataset", "synthetic", "--end", "1",
                           "--num_repeat_SDE_inference", "2",
                           "--n_max", "8", "--emb_dim", "16", "--num_layer", "2",
                           "--num_diffusion_timesteps_2Dto3D_inference", "2",
                           "--steps_pos", "1",
                           "--input_model_file", str(tmp_path / "model_complete_final.pt")])
    assert "loaded checkpoint" in capsys.readouterr().out
    assert np.isfinite(res[0]["pos_gen"]).all()


@pytest.mark.parametrize("flags", [
    ["--ingest", "compact"],
    ["--microbatch", "2", "--microbatch_scope", "step"],
    ["--microbatch", "2", "--microbatch_scope", "score"],
    ["--microbatch", "2", "--microbatch_scope", "splice"],
    ["--model_3d", "PaiNN", "--PaiNN_n_interactions", "2", "--PaiNN_n_rbf", "8"],
    ["--schnet_cfconv", "pallas_rbf"],
    ["--num_devices", "1", "--input_data_dir", "data", "--max_molecules", "4"],
    ["--n_max", "16", "--buckets", "8", "16"],
    ["--dataset", "QM9"]],
    ids=["compact", "microbatch_step", "microbatch_score", "microbatch_splice", "painn",
         "pallas_rbf", "jax_only_flags", "buckets", "qm9_synthetic"])
def test_pretrain_cli_trains_with(flags):
    """Two tiny CPU epochs under each option the JAX CLI has and the port
    once refused: every epoch's losses finite.  ``--dataset QM9`` with
    ``--synthetic_molecules`` trains on synthetic molecules, as in JAX."""
    history = cli.main(TINY_FLAGS + ["--epochs", "2"] + flags)
    assert len(history) == 2
    assert all(np.isfinite(list(h.values())).all() for h in history)


def _jax_cli_parser():
    """The JAX CLIs' one parser, ``examples/config.py`` (argparse only)."""
    path = Path(__file__).resolve().parents[1] / "examples" / "config.py"
    spec = importlib.util.spec_from_file_location("jax_cli_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_parser()


PORT_CLIS = {"pretrain": cli, "sample_2d_to_3d": sample_cli,
             "sample_3d_to_2d": sample_3d2d_cli}
# each CLI at tiny widths, for the data-parallel flags' runs
RUN_FLAGS = {
    "pretrain": TINY_FLAGS + ["--epochs", "1"],
    "sample_2d_to_3d": ["--device", "cpu", "--dataset", "synthetic", "--end", "2",
                        "--num_repeat_SDE_inference", "2", "--n_max", "8", "--emb_dim", "16",
                        "--num_layer", "2", "--num_diffusion_timesteps_2Dto3D_inference", "2",
                        "--steps_pos", "1"],
    "sample_3d_to_2d": ["--device", "cpu", "--dataset", "synthetic", "--end", "2",
                        "--batch_size", "2", "--n_max", "8", "--emb_dim", "16",
                        "--SchNet_num_interactions", "1", "--SchNet_num_filters", "8",
                        "--num_diffusion_timesteps_3Dto2D_inference", "2", "--steps_pos", "1"]}
# the flags each JAX CLI reads that the port's parser once rejected (exit 2)
JAX_ONLY_FLAGS = {
    "pretrain": ("resume_from", "num_devices", "input_data_dir", "max_molecules",
                 "profile_dir", "debug_nans", "distributed", "dist_coordinator",
                 "dist_num_processes", "dist_process_id"),
    "sample_2d_to_3d": ("gnn_type", "JK", "dropout_ratio", "num_devices", "input_data_dir"),
    "sample_3d_to_2d": ("PaiNN_radius_cutoff", "PaiNN_n_interactions", "PaiNN_n_rbf",
                        "PaiNN_readout", "use_extend_graph")}


@pytest.mark.parametrize("name", sorted(PORT_CLIS))
def test_cli_parses_the_jax_flags_with_jax_defaults(name):
    """Every flag a port CLI shares with the JAX CLIs has JAX's default
    (``--dataset`` QM9 included), except ``--device`` (a CUDA device, not a
    TPU index); the flags it once lacked are among them."""
    port = vars(PORT_CLIS[name].get_parser().parse_args([]))
    ref = vars(_jax_cli_parser().parse_args([]))
    assert set(JAX_ONLY_FLAGS[name]) <= set(port)
    assert port["dataset"] == ref["dataset"] == "QM9"
    for flag in sorted(set(port) & set(ref) - {"device"}):
        assert port[flag] == ref[flag], flag


@pytest.mark.parametrize("name,flags", [
    ("pretrain", ["--num_devices", "2"]),
    ("pretrain", ["--distributed"]),
    pytest.param("pretrain", ["--distributed", "--dist_num_processes", "1"],
                 id="pretrain-distributed_one_process"),
    ("pretrain", ["--dist_coordinator", "localhost:1234"]),
    ("pretrain", ["--dist_num_processes", "2"]),
    ("pretrain", ["--dist_process_id", "0"]),
    ("pretrain", ["--profile_dir", "prof"]),
    ("pretrain", ["--debug_nans"]),
    ("sample_2d_to_3d", ["--num_devices", "2"]),
    ("sample_3d_to_2d", ["--num_devices", "2"])],
    ids=lambda v: v if isinstance(v, str) else v[0].lstrip("-"))
def test_cli_refuses_unported_flag_by_name(name, flags, monkeypatch):
    """A flag the port does not run (``--profile_dir``, ``--debug_nans``)
    raises NotImplementedError naming it (never argparse's exit 2), before
    any work.  The data-parallel flags run, here at tiny
    widths: ``--num_devices 2`` as two gloo ranks; ``--distributed`` as the
    one rank of a launcher's ``env://`` world of one, and with
    ``--dist_num_processes 1`` as one process with no group (JAX's no-op);
    ``--dist_coordinator``
    or ``--dist_process_id`` alone as one process (JAX reads them only with
    ``--distributed``); ``--dist_num_processes 2`` forms a group of two at
    ``env://`` and, with no launcher's address, raises instead of falling
    back to one process."""
    if flags[0] in ("--profile_dir", "--debug_nans"):
        with pytest.raises(NotImplementedError, match=re.escape(flags[0]) + " is not ported"):
            PORT_CLIS[name].main(["--device", "cpu"] + flags)
        return
    monkeypatch.setattr(mesh, "TIMEOUT", datetime.timedelta(seconds=60))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    if flags[0] == "--dist_num_processes":
        with pytest.raises(ValueError, match="env:// rendezvous"):
            PORT_CLIS[name].main(RUN_FLAGS[name] + flags)
        return
    if flags[0] == "--distributed":
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", str(mesh.free_port()))
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
    out = PORT_CLIS[name].main(RUN_FLAGS[name] + flags)
    assert out and not torch.distributed.is_initialized()


def test_3d2d_cli_runs_painn(tmp_path):
    """``--model_3d PaiNN`` (the JAX CLI builds it): graphs of the expected
    shapes, finite, from a tiny PaiNN encoder."""
    res = sample_3d2d_cli.main([
        "--device", "cpu", "--dataset", "synthetic", "--batch_size", "2", "--end", "2", "--n_max", "8",
        "--emb_dim", "16", "--model_3d", "PaiNN", "--PaiNN_n_interactions", "2",
        "--PaiNN_n_rbf", "8", "--num_diffusion_timesteps_3Dto2D_inference", "2",
        "--steps_pos", "1", "--output_model_dir", str(tmp_path)])
    assert [r["x_gen"].shape for r in res] == [(2, 8, 119)]
    assert res[0]["adj_gen"].shape == (2, 8, 8)
    assert np.isfinite(res[0]["x_gen"]).all() and np.isfinite(res[0]["adj_gen"]).all()


def test_pretrain_cli_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([a for a in TINY_FLAGS if a not in ("--device", "cpu")])
