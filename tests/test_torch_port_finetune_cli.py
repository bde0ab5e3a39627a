"""The port's three finetune CLIs, driven in-process on the CPU at tiny
sizes: synthetic data and the real-data branches (the committed fixtures or
generated files, under ``tests/rdkit_stub.py``), their outputs
(``metrics.csv`` in JAX's columns, the best and final ``.pt``,
``evaluation_best.npz``), their console lines, the pretraining handoff
(``--input_model_file`` from the port's ``.pt`` and from a ``.msgpack``
written by the JAX package's ``save_pretrain_checkpoint``: the encoder's
parameters equal the checkpoint's, its running statistics stay fresh, as
in JAX) and the flags refused by name.
"""

import csv
import datetime
import gzip
import os

import jax
import numpy as np
import pytest
import torch

import rdkit_stub

from moleculesde_tpu.utils.checkpoints import save_pretrain_checkpoint
from moleculesde_tpu_torch.convert import load_checkpoint, save_checkpoint
from moleculesde_tpu_torch.examples import finetune_md17 as md17_cli
from moleculesde_tpu_torch.examples import finetune_moleculenet as mnet_cli
from moleculesde_tpu_torch.examples import finetune_qm9 as qm9_cli
from moleculesde_tpu_torch.parallel import mesh
from moleculesde_tpu_torch.pretrain.train_state import PretrainConfig, create_pretrain_state

from torch_port_common import CPU

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TINY = ["--device", "cpu", "--n_max", "8", "--emb_dim", "16", "--num_layer", "2",
        "--SchNet_num_filters", "8", "--SchNet_num_interactions", "2",
        "--SchNet_num_gaussians", "11", "--PaiNN_n_interactions", "2", "--PaiNN_n_rbf", "8",
        "--batch_size", "8", "--epochs", "2"]
SYNTHETIC = ["--dataset", "synthetic", "--synthetic_molecules", "40"]


@pytest.fixture
def rdkit():
    installed = rdkit_stub.install()
    yield
    if installed:
        rdkit_stub.uninstall()


def _metrics(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_moleculenet_cli_synthetic(tmp_path, capsys):
    out = tmp_path / "mnet"
    best_val, best_test = mnet_cli.main(TINY + SYNTHETIC + ["--eval_train",
                                                           "--output_model_dir", str(out)])
    text = capsys.readouterr().out
    assert "best train:" in text and "\tval: " in text and "Took\t" in text
    assert 0.0 <= best_val <= 1.0 and 0.0 <= best_test <= 1.0
    rows = _metrics(out / "metrics.csv")
    assert [r["step"] for r in rows] == ["1", "2"]
    assert list(rows[0]) == ["step", "wall_time", "loss", "train_auc", "val_auc", "test_auc"]
    ev = np.load(out / "evaluation_best.npz")
    assert ev["test_true"].shape == ev["test_scores"].shape == (4, 3)   # 40 -> 32 / 4 / 4
    assert set(np.unique(ev["test_true"])) <= {-1.0, 1.0}
    for name in ("model_complete.pt", "model_complete_final.pt"):
        ckpt = load_checkpoint(str(out / name))
        assert ckpt["config"]["emb_dim"] == 16
        assert "graph_pred_linear.kernel" in ckpt["model"]


def test_moleculenet_cli_real_branch(tmp_path, rdkit, capsys):
    """A generated bbbp CSV (24 linear chains, one missing label, one
    unparseable SMILES dropped before --max_molecules), scaffold split."""
    raw = tmp_path / "bbbp" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(11)
    with gzip.open(raw / "bbbp.csv.gz", "wt") as f:
        f.write("num,name,p_np,smiles\n")
        for i in range(24):
            smiles = "XX(=" if i == 9 else "".join(rng.choice(list("CNOF"),
                                                               size=int(rng.integers(3, 9))))
            label = "" if i == 5 else str(int(rng.integers(0, 2)))
            f.write(f"{i},m{i},{label},{smiles}\n")
    mnet_cli.main(TINY + ["--dataset", "bbbp", "--input_data_dir", str(tmp_path),
                          "--batch_size", "4", "--max_molecules", "20"])
    assert "best train:" in capsys.readouterr().out


def test_moleculenet_cli_fixture(rdkit, capsys):
    """The committed bbbp fixture: 5 molecules kept of 6, whose scaffold
    split leaves the validation set empty (no valid task)."""
    best_val, _ = mnet_cli.main(TINY + ["--dataset", "bbbp", "--input_data_dir",
                                        os.path.join(FIXTURES, "moleculenet"),
                                        "--batch_size", "2"])
    text = capsys.readouterr().out
    assert "Missing ratio: 1.0" in text and "best train:" in text
    assert best_val == 0.0


@pytest.mark.parametrize("flags", [
    ["--model_3d", "SchNet", "--split", "random", "--use_rotation_transform",
     "--lr_scheduler", "ReduceLROnPlateau", "--lr_decay_patience", "0"],
    ["--model_3d", "PaiNN", "--split", "customized_02", "--loss", "mse",
     "--lr_scheduler", "StepLR", "--lr_decay_step_size", "1"]], ids=["schnet", "painn"])
def test_qm9_cli_synthetic(tmp_path, capsys, flags):
    out = tmp_path / "qm9"
    best_val, best_test = qm9_cli.main(TINY + SYNTHETIC + flags + ["--output_model_dir",
                                                                  str(out)])
    text = capsys.readouterr().out
    assert "Train mean:" in text and "best val:" in text
    assert np.isfinite(best_val) and np.isfinite(best_test)
    rows = _metrics(out / "metrics.csv")
    assert list(rows[0]) == ["step", "wall_time", "loss", "val_mae", "test_mae"]
    ev = np.load(out / "evaluation_best.npz")
    assert ev["test_pred"].shape == ev["test_true"].shape and np.isfinite(ev["test_pred"]).all()
    head = "graph_pred_linear.kernel" if "SchNet" in flags else "Dense_1.kernel"
    assert head in load_checkpoint(str(out / "model_complete.pt"))["model"]


def test_qm9_cli_fixture(rdkit, capsys):
    """The committed QM9 fixture (4 molecules kept of 6), target gap."""
    qm9_cli.main(TINY + ["--dataset", "qm9", "--input_data_dir", FIXTURES, "--task", "gap",
                         "--split", "random", "--batch_size", "2"])
    assert "best val:" in capsys.readouterr().out


@pytest.mark.parametrize("model", ["SchNet", "PaiNN"])
def test_md17_cli_synthetic(tmp_path, capsys, model):
    out = tmp_path / "md17"
    e_mae, f_mae = md17_cli.main(TINY + SYNTHETIC + ["--model_3d", model,
                                                     "--energy_force_with_normalization",
                                                     "--output_model_dir", str(out)])
    text = capsys.readouterr().out
    assert "val F MAE:" in text and "best test E MAE:" in text
    assert np.isfinite(e_mae) and np.isfinite(f_mae)
    assert list(_metrics(out / "metrics.csv")[0]) == [
        "step", "wall_time", "loss", "val_energy_mae", "val_force_mae", "test_energy_mae",
        "test_force_mae"]
    assert (out / "model_complete.pt").exists() and (out / "model_complete_final.pt").exists()


def test_md17_cli_npz(tmp_path, capsys):
    raw = tmp_path / "MD17" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(3)
    np.savez(raw / "aspirin_dft.npz", z=np.array([6, 6, 8, 1, 1, 1]),
             R=rng.normal(scale=1.5, size=(20, 6, 3)), E=rng.normal(loc=-400.0, size=(20,)),
             F=rng.normal(size=(20, 6, 3)))
    md17_cli.main(TINY + ["--dataset", "MD17", "--task", "aspirin", "--input_data_dir",
                          str(tmp_path), "--MD17_train_batch_size", "4",
                          "--max_molecules", "16"])
    assert "F MAE" in capsys.readouterr().out


WIDTHS = dict(emb_dim=16, num_layer=2, schnet_num_filters=8, schnet_num_interactions=2,
              schnet_num_gaussians=11)


@pytest.fixture(scope="module")
def pretrain_checkpoints(tmp_path_factory):
    """A pretraining state at the CLIs' tiny widths, its weights moved off
    the seed's, written as the port's .pt and, through the JAX package's
    writer, as a .msgpack of the same trees."""
    out = tmp_path_factory.mktemp("pretrain")
    models = create_pretrain_state(PretrainConfig(**WIDTHS), CPU).models
    with torch.no_grad():
        for m in models.values():
            for p in m.parameters():
                p.add_(0.01)
            for b in m.buffers():
                b.add_(0.5)
    pt = str(out / "model_complete.pt")
    save_checkpoint(pt, models, {})
    params, stats = {}, {}
    for comp, m in models.items():
        buffers = dict(m.named_buffers())
        for key, v in m.state_dict().items():
            node = (stats if key in buffers else params).setdefault(comp, {})
            *path, leaf = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v.numpy()
    save_pretrain_checkpoint(str(out), params, stats, best=True)
    return {"pt": pt, "msgpack": str(out / "model_complete.msgpack"), "models": models}


@pytest.mark.parametrize("kind", ["pt", "msgpack"])
@pytest.mark.parametrize("cli", ["moleculenet", "qm9", "md17"])
def test_cli_loads_pretraining_checkpoint(pretrain_checkpoints, kind, cli, capsys):
    path = pretrain_checkpoints[kind]
    argv = TINY + SYNTHETIC + ["--input_model_file", path, "--epochs", "1"]
    mod = {"moleculenet": mnet_cli, "qm9": qm9_cli, "md17": md17_cli}[cli]
    args = mod.parse_args(argv)
    if cli == "moleculenet":
        part, component = mnet_cli.build_model(args, 3, CPU).gnn, "model_2D"
    else:
        part, component = mod.build_model(args, CPU).encoder, "model_3D"
    source = pretrain_checkpoints["models"][component]
    ref = dict(source.named_parameters())
    for name, p in part.named_parameters():
        assert torch.equal(p, ref[name]), name
    for name, b in part.named_buffers():   # fresh statistics, as JAX's finetunes
        assert not torch.equal(b, dict(source.named_buffers())[name]), name
    mod.main(argv)
    assert f"loaded pretrained {component} from {path}" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--num_devices", "2"], "--num_devices"), (["--distributed"], "--distributed"),
    (["--profile_dir", "p"], "--profile_dir")])
def test_unported_flags_are_refused(flags, match, monkeypatch):
    """``--distributed`` and ``--profile_dir`` are refused by name;
    ``--num_devices 2`` runs two gloo ranks, with the
    one-process run's best epoch."""
    monkeypatch.setattr(mesh, "TIMEOUT", datetime.timedelta(seconds=60))
    if flags[0] == "--num_devices":
        for mod in (mnet_cli, qm9_cli):
            one, two = mod.main(TINY + SYNTHETIC), mod.main(TINY + SYNTHETIC + flags)
            np.testing.assert_allclose(two, one, rtol=1e-5, err_msg=mod.__name__)
        return
    with pytest.raises(NotImplementedError, match=match):
        mnet_cli.main(TINY + SYNTHETIC + flags)
    with pytest.raises(NotImplementedError, match=match):
        qm9_cli.main(TINY + SYNTHETIC + flags)


def test_moleculenet_cli_refuses_unknown_dataset():
    with pytest.raises(ValueError, match="not a MoleculeNet dataset"):
        mnet_cli.main(TINY + ["--dataset", "QM9"])
