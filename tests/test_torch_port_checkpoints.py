"""Port parity: checkpoints and resume.

- The jax-free msgpack reader (``utils/checkpoints.py::msgpack_restore``)
  against ``flax.serialization.msgpack_restore`` on flax's own output:
  f32, int32, bf16 and 0-d leaves, numpy scalars, and msgpack's str, bin,
  int, map and array widths; complex scalars and flax's chunked arrays are
  refused by name.
- A JAX ``model_complete.msgpack`` (``save_pretrain_checkpoint``) read
  with ``load_pretrain_checkpoint`` and loaded into the port's sampler
  CLIs' models.
- Resume from a JAX ``train_state.msgpack``: ``create_pretrain_state``
  plus one JAX Adam update, saved by ``save_train_state``.  The port's
  weights, batch statistics, Adam moments, step and group learning rates
  equal JAX's per leaf, and one more Adam update on the same gradients
  lands where ``make_optimizer(cfg).update`` puts it, to 1e-6 of the
  weights (lr 1e-3: 0.1% of one step).
- The port's own ``train_state.pt``: a resumed step is bit-identical to the
  uninterrupted run's on the CPU, and the CLI resumes from either file.
- GAT with SDEModel2Dto3D_03: a JAX ``model_complete.msgpack`` into the
  port's sampler CLI, the port's ``.pt`` into the MoleculeNet CLI.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from moleculesde_tpu.pretrain.train_state import PretrainConfig as JaxPretrainConfig
from moleculesde_tpu.pretrain.train_state import create_pretrain_state as jax_create_state
from moleculesde_tpu.pretrain.train_state import make_optimizer as jax_make_optimizer
from moleculesde_tpu.utils.checkpoints import load_pretrain_checkpoint as jax_load_pretrain
from moleculesde_tpu.utils.checkpoints import save_pretrain_checkpoint, save_train_state
from moleculesde_tpu_torch.core.batch import pad_graphs
from moleculesde_tpu_torch.examples import pretrain as cli
from moleculesde_tpu_torch.examples import sample_2d_to_3d as sample_cli
from moleculesde_tpu_torch.examples import sample_3d_to_2d as sample_3d2d_cli
from moleculesde_tpu_torch.pretrain.train_state import PretrainConfig, create_pretrain_state
from moleculesde_tpu_torch.pretrain.train_step import pretrain_step
from moleculesde_tpu_torch.utils import checkpoints

from torch_port_common import CPU, flat_tree, graphs, jax_pad_graphs

# the widths of the CLIs' tiny flags below (the 2D->3D hidden width is the
# sampler's fixed 32)
WIDTHS = dict(emb_dim=16, num_layer=2, schnet_num_filters=8, schnet_num_interactions=2,
              schnet_num_gaussians=11)
WIDTHS_2D = ["--emb_dim", "16", "--num_layer", "2"]
WIDTHS_3D = ["--SchNet_num_filters", "8", "--SchNet_num_interactions", "2",
             "--SchNet_num_gaussians", "11"]
CLI_WIDTHS = WIDTHS_2D + WIDTHS_3D
TRAIN = dict(lr=1e-3, decay=0.01, gnn_2d_lr_scale=2.0, gnn_3d_lr_scale=0.5)


def _same_leaf(mine, ref, what):
    if torch.is_tensor(mine):   # bfloat16
        assert mine.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16", what
        np.testing.assert_array_equal(mine.float().numpy(), np.asarray(ref, np.float32),
                                      err_msg=what)
        return
    assert type(mine) is type(ref), (what, type(mine), type(ref))
    if isinstance(ref, (np.ndarray, np.generic)):
        assert mine.dtype == ref.dtype and np.shape(mine) == np.shape(ref), what
        np.testing.assert_array_equal(mine, ref, err_msg=what)
    else:
        assert mine == ref, what


def _same_tree(mine, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(mine, dict) and list(mine) == list(ref), path
        for k in ref:
            _same_tree(mine[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(mine) is type(ref) and len(mine) == len(ref), path
        for i, (a, b) in enumerate(zip(mine, ref)):
            _same_tree(a, b, f"{path}/{i}")
    else:
        _same_leaf(mine, ref, path)


def test_msgpack_reader_matches_flax():
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "i32": rng.integers(-9, 9, size=(5,)).astype(np.int32),
        "bf16": np.asarray(rng.normal(size=(2, 3)), dtype=jnp.bfloat16),
        "zero_d": np.asarray(7, np.int32),
        "zero_d_f32": np.asarray(0.5, np.float32),
        "big": rng.normal(size=(70_000,)).astype(np.float32),     # ext 32
        "u8": np.arange(17, dtype=np.uint8),
        "scalar_f32": np.float32(1.25), "scalar_i64": np.int64(-3),
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -129,
                 -32769, -2 ** 31 - 1, 2 ** 63],
        "floats": [0.1, -2.5e300], "flags": [True, False, None],
        "strs": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70_000, "ü"],
        "bins": [b"", b"\x00" * 300, b"\x01" * 70_000],
        "many": {f"k{i}": i for i in range(20)},                  # map 16
        "long": list(range(20)),                                  # array 16
        "nested": {"empty": {}, "deeper": {"x": np.zeros((0, 2), np.float32)}},
    }
    data = serialization.msgpack_serialize(tree)
    _same_tree(checkpoints.msgpack_restore(data), serialization.msgpack_restore(data))


def test_msgpack_reader_refuses_complex_and_chunked(monkeypatch):
    with pytest.raises(ValueError, match="complex"):
        checkpoints.msgpack_restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize({"w": {"kernel": np.ones((8, 8), np.float32)}})
    assert b"__msgpack_chunked_array__" in data
    with pytest.raises(ValueError, match="/w/kernel is a __msgpack_chunked_array__"):
        checkpoints.msgpack_restore(data)
    with pytest.raises(ValueError, match="bytes after the value"):
        checkpoints.msgpack_restore(serialization.msgpack_serialize({"a": 1}) + b"\x00")


@pytest.fixture(scope="module")
def jax_state():
    """A JAX pretraining state at WIDTHS and TRAIN after one Adam update on
    seeded gradients (zero for the frozen Fourier weights, as
    stop_gradient gives them), those gradients, and a second set."""
    gs = graphs(seed=3, count=4, n_max=8)
    jb = jax_pad_graphs(gs, n_max=8, e_max=32, ext_e_max=64)
    jcfg = JaxPretrainConfig(**WIDTHS, **TRAIN)
    state = jax.jit(lambda k: jax_create_state(jcfg, jb, k)[1])(jax.random.PRNGKey(1))
    tx = jax_make_optimizer(jcfg)
    frozen = {f"{c}.{n}" for c, m in create_pretrain_state(
        PretrainConfig(**WIDTHS), CPU).models.items()
              for n, p in m.named_parameters() if not p.requires_grad}
    rng = np.random.default_rng(5)
    leaves = flat_tree(jax.device_get(state.params))

    def grads():
        flat = {k: np.zeros_like(v) if k in frozen else rng.normal(size=v.shape).astype(
            np.float32) for k, v in leaves.items()}
        nested = {}
        for key, g in flat.items():
            *path, last = key.split(".")
            node = nested
            for part in path:
                node = node.setdefault(part, {})
            node[last] = g
        return nested, flat

    g1, _ = grads()
    updates, opt_state = tx.update(g1, state.opt_state, state.params)
    params = jax.tree_util.tree_map(lambda a, u: a + u, state.params, updates)
    state = state.replace(params=params, opt_state=opt_state, step=state.step + 1)
    g2, g2_flat = grads()
    return dict(state=state, tx=tx, g2=g2, g2_flat=g2_flat, frozen=frozen)


def test_resume_from_jax_train_state(jax_state, tmp_path):
    s = jax_state["state"]
    path = save_train_state(str(tmp_path / "train_state.msgpack"), jax.device_get(s),
                            extra={"epoch": 3})
    cfg = PretrainConfig(**WIDTHS, lr=TRAIN["lr"], decay=TRAIN["decay"])   # flag scales 1, 1
    port = create_pretrain_state(cfg, CPU, seed=9)
    port, extra = checkpoints.load_train_state(path, port)
    assert int(extra["epoch"]) == 3 and port.step == 1
    assert [g["lr"] for g in port.optimizer.param_groups] == pytest.approx(
        [TRAIN["lr"] * TRAIN["gnn_2d_lr_scale"], TRAIN["lr"] * TRAIN["gnn_3d_lr_scale"]],
        rel=1e-7)
    _, unravel = jax.flatten_util.ravel_pytree(s.params)
    mu = flat_tree(jax.device_get(unravel(s.opt_state["mu"])))
    nu = flat_tree(jax.device_get(unravel(s.opt_state["nu"])))
    params = flat_tree(jax.device_get(s.params))
    stats = flat_tree(jax.device_get(s.batch_stats))
    n_leaves = 0
    for comp, module in port.models.items():
        for name, p in module.named_parameters():
            key = f"{comp}.{name}"
            st = port.optimizer.state[p]
            np.testing.assert_array_equal(p.detach().numpy(), params[key], err_msg=key)
            np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[key], err_msg=key)
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[key], err_msg=key)
            assert float(st["step"]) == int(s.opt_state["count"]) == 1
            n_leaves += 1
        for name, buf in module.named_buffers():
            np.testing.assert_array_equal(buf.numpy(), stats[f"{comp}.{name}"])
    assert n_leaves == len(params)

    # one more update on the same gradients in both packages
    updates, _ = jax_state["tx"].update(jax_state["g2"], s.opt_state, s.params)
    after = flat_tree(jax.device_get(jax.tree_util.tree_map(lambda a, u: a + u, s.params,
                                                            updates)))
    for comp, module in port.models.items():
        for name, p in module.named_parameters():
            if p.requires_grad:   # the frozen ones get zeros from PretrainAdam
                p.grad = torch.from_numpy(jax_state["g2_flat"][f"{comp}.{name}"].copy())
    port.optimizer.step()
    moved = 0
    for comp, module in port.models.items():
        for name, p in module.named_parameters():
            key = f"{comp}.{name}"
            np.testing.assert_allclose(p.detach().numpy(), after[key], rtol=0, atol=1e-6,
                                       err_msg=key)
            moved += bool(np.any(after[key] != params[key]))
    assert moved == n_leaves   # every leaf moves, the frozen ones by the L2 term


def test_jax_train_state_mismatch_raises(jax_state, tmp_path):
    path = save_train_state(str(tmp_path / "ts.msgpack"), jax.device_get(jax_state["state"]))
    wider = create_pretrain_state(PretrainConfig(**{**WIDTHS, "emb_dim": 24}), CPU)
    with pytest.raises(ValueError, match="shape"):
        checkpoints.load_train_state(path, wider)
    payload = checkpoints.msgpack_restore(open(path, "rb").read())["state"]
    payload["opt_state"]["lr_scale"] = np.arange(payload["opt_state"]["lr_scale"].size,
                                                 dtype=np.float32)
    with pytest.raises(ValueError, match="lr_scale is not constant"):
        checkpoints.load_jax_train_state(create_pretrain_state(PretrainConfig(**WIDTHS), CPU),
                                         payload)


@pytest.fixture(scope="module")
def jax_checkpoint(jax_state, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ckpt")
    s = jax.device_get(jax_state["state"])
    save_pretrain_checkpoint(str(out), s.params, s.batch_stats, best=False)
    save_train_state(str(out / "train_state.msgpack"), s, extra={"epoch": 1})
    return out


def test_pretrain_checkpoint_reader_matches_jax(jax_checkpoint):
    path = str(jax_checkpoint / "model_complete_final.msgpack")
    for component in (None, "model_2D", "model_3D"):
        _same_tree(checkpoints.load_pretrain_checkpoint(path, component),
                   jax_load_pretrain(path, component))


@pytest.mark.parametrize("name", ["sample_2d_to_3d", "sample_3d_to_2d"])
def test_sampler_cli_loads_jax_msgpack(jax_checkpoint, name, capsys):
    """Both sampler CLIs take a JAX ``model_complete*.msgpack`` as
    ``--input_model_file``: their two components hold the checkpoint's
    values, and a tiny chain runs on them."""
    path = str(jax_checkpoint / "model_complete_final.msgpack")
    params, stats = jax_load_pretrain(path)
    ref = {**flat_tree(params), **flat_tree(stats)}
    if name == "sample_2d_to_3d":
        mod, comps = sample_cli, ("model_2D", "SDE_2Dto3D_model")
        argv = ["--device", "cpu", "--dataset", "synthetic", "--end", "1",
                "--num_repeat_SDE_inference", "2", "--n_max", "8",
                "--num_diffusion_timesteps_2Dto3D_inference", "2", "--steps_pos", "1"] + WIDTHS_2D
    else:
        mod, comps = sample_3d2d_cli, ("model_3D", "SDE_3Dto2D_model")
        argv = ["--device", "cpu", "--dataset", "synthetic", "--end", "2", "--batch_size", "2",
                "--n_max", "8", "--num_diffusion_timesteps_3Dto2D_inference", "2",
                "--steps_pos", "1", "--emb_dim", "16"] + WIDTHS_3D
    argv += ["--input_model_file", path]
    models = mod.build_models(mod.get_parser().parse_args(argv), CPU)
    for comp, module in zip(comps, models):
        for key, value in module.state_dict().items():
            np.testing.assert_array_equal(value.numpy(), ref[f"{comp}.{key}"], err_msg=key)
    res = mod.main(argv)
    assert "loaded checkpoint" in capsys.readouterr().out
    out = res[0]["pos_gen"] if name == "sample_2d_to_3d" else res[0]["x_gen"]
    assert np.isfinite(out).all()


def _tiny_batches(count: int):
    gs = graphs(seed=12, count=4 * count, n_max=8)
    return [pad_graphs(gs[4 * i:4 * i + 4], n_max=8, e_max=32, ext_e_max=64)
            for i in range(count)]


def test_port_resume_is_bit_identical(tmp_path):
    """Two steps, save, load into a state built from another seed, one more
    step on each: every weight, buffer and Adam moment equal bit for bit."""
    cfg = PretrainConfig(**WIDTHS, cl_similarity_metric="InfoNCE_dot_prod", **TRAIN)
    b1, b2, b3 = _tiny_batches(3)
    run = create_pretrain_state(cfg, CPU, seed=4)
    for b in (b1, b2):
        pretrain_step(run.models, run.optimizer, cfg, b, run.generator)
        run.step += 1
    path = checkpoints.save_train_state(str(tmp_path / "train_state.pt"), run, {"epoch": 1})
    resumed, extra = checkpoints.load_train_state(path, create_pretrain_state(cfg, CPU, seed=5))
    assert extra == {"epoch": 1} and resumed.step == 2
    for st in (run, resumed):
        pretrain_step(st.models, st.optimizer, cfg, b3, st.generator)
    for comp in run.models:
        for (k, a), (k2, b) in zip(run.models[comp].state_dict().items(),
                                   resumed.models[comp].state_dict().items()):
            assert k == k2 and torch.equal(a, b), f"{comp}.{k}"
    sa, sb = run.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    assert torch.equal(run.generator.get_state(), resumed.generator.get_state())


TINY = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_molecules", "12",
        "--batch_size", "4",
        "--n_max", "8", "--epochs", "1", "--SchNet_num_gaussians", "11"] + CLI_WIDTHS


def test_cli_resumes_from_port_and_jax_train_states(jax_checkpoint, tmp_path, capsys):
    """The CLI's ``train_state.pt`` and a JAX ``train_state.msgpack`` both
    resume, with JAX's message; the CLI's ``metrics.csv`` has JAX's columns
    and one row per printed epoch."""
    out = tmp_path / "run"
    cli.main(TINY + ["--epochs", "2", "--output_model_dir", str(out)])
    rows = (out / "metrics.csv").read_text().splitlines()
    assert rows[0] == "step,wall_time,CL_loss,CL_acc,SDE_loss_2Dto3D,SDE_loss_3Dto2D"
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2"]
    capsys.readouterr()
    cli.main(TINY + ["--resume_from", str(out / "train_state.pt")])
    assert (f"resumed from {out / 'train_state.pt'} at step 6 (extra: {{'epoch': 2}})"
            in capsys.readouterr().out)
    jax_path = str(jax_checkpoint / "train_state.msgpack")
    history = cli.main(TINY + ["--resume_from", jax_path])
    assert f"resumed from {jax_path} at step 1 (extra: {{'epoch': " in capsys.readouterr().out
    assert np.isfinite(list(history[0].values())).all()


def test_gat_v3_checkpoints_reach_the_sampler_and_moleculenet(tmp_path, capsys):
    """``--gnn_type GAT --SDE_2Dto3D_model SDEModel2Dto3D_03``: a JAX
    ``model_complete.msgpack`` (``save_pretrain_checkpoint`` on the state
    ``create_pretrain_state`` builds for those flags, the JAX pretraining
    CLI's two calls) loads into the port's sampler CLI with every parameter
    and statistic equal, and a chain runs on it; the port's pretraining
    ``.pt`` of the same flags loads into the MoleculeNet CLI, its
    ``model_2D`` parameters equal the checkpoint's."""
    flags = ["--gnn_type", "GAT", "--SDE_2Dto3D_model", "SDEModel2Dto3D_03"]
    jb = jax_pad_graphs(graphs(seed=6, count=4, n_max=8), n_max=8, e_max=32, ext_e_max=64)
    jcfg = JaxPretrainConfig(**WIDTHS, gnn_type="GAT", sde_2dto3d_variant=3)
    s = jax.device_get(jax.jit(lambda k: jax_create_state(jcfg, jb, k)[1])(
        jax.random.PRNGKey(2)))
    path = save_pretrain_checkpoint(str(tmp_path / "jax"), s.params, s.batch_stats)
    params, stats = jax_load_pretrain(path)
    ref = {**flat_tree(params), **flat_tree(stats)}
    argv = ["--device", "cpu", "--dataset", "synthetic", "--end", "1",
            "--num_repeat_SDE_inference", "2", "--n_max", "8",
            "--num_diffusion_timesteps_2Dto3D_inference", "2", "--steps_pos", "1",
            "--input_model_file", path] + WIDTHS_2D + flags
    models = sample_cli.build_models(sample_cli.get_parser().parse_args(argv), CPU)
    checked = 0
    for comp, module in zip(("model_2D", "SDE_2Dto3D_model"), models):
        for key, value in module.state_dict().items():
            np.testing.assert_array_equal(value.numpy(), ref[f"{comp}.{key}"], err_msg=key)
            checked += 1
    assert checked == sum(k.startswith(("model_2D.", "SDE_2Dto3D_model.")) for k in ref)
    assert np.isfinite(sample_cli.main(argv)[0]["pos_gen"]).all()

    from moleculesde_tpu_torch.convert import load_checkpoint
    from moleculesde_tpu_torch.examples import finetune_moleculenet as mnet_cli

    out = tmp_path / "port"
    cli.main(TINY + flags + ["--output_model_dir", str(out)])
    pt = str(out / "model_complete_final.pt")
    mnet = ["--device", "cpu", "--n_max", "8", "--batch_size", "8", "--epochs", "1",
            "--dataset", "synthetic", "--synthetic_molecules", "40", "--input_model_file",
            pt] + WIDTHS_2D + flags[:2]
    gnn = mnet_cli.build_model(mnet_cli.parse_args(mnet), 3, CPU).gnn
    saved = load_checkpoint(pt)["model_2D"]
    for name, p in gnn.named_parameters():
        assert torch.equal(p.detach(), saved[name]), name
    mnet_cli.main(mnet)
    assert f"loaded pretrained model_2D from {pt}" in capsys.readouterr().out
