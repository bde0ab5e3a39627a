"""The PyTorch port stands alone and never falls back silently.

- No module of ``moleculesde_tpu_torch/`` and not ``chip_smoke.py`` imports
  jax, flax, optax, msgpack, pandas, sklearn or the JAX package; rdkit is
  imported only inside functions.
- Entry points raise without a GPU unless the caller asks for the CPU.
- A kernel wrapper given a CPU tensor takes the plain version and counts no
  launch; asked for the kernel on a CPU tensor, it raises.
"""

import ast
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from moleculesde_tpu_torch.convert import load_checkpoint, save_checkpoint
from moleculesde_tpu_torch.data.compact import CompactBatch, expand_on_device
from moleculesde_tpu_torch.data.loader import GraphLoader, ThreadedLoader, device_prefetch
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.examples import finetune_md17, finetune_moleculenet, finetune_qm9
from moleculesde_tpu_torch.examples import pretrain as pretrain_cli
from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli
from moleculesde_tpu_torch.examples import sample_3d_to_2d as cli_3d2d
from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.models.gnn2d import GNN2D, GNNGraphPred
from moleculesde_tpu_torch.models.painn import PaiNN
from moleculesde_tpu_torch.models.schnet import SchNet
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D
from moleculesde_tpu_torch.ops.cfconv import (
    fused_cfconv, fused_cfconv_bwd, fused_cfconv_rbf, fused_cfconv_rbf_bwd)
from moleculesde_tpu_torch.pretrain.train_step import split_microbatches
from moleculesde_tpu_torch.ops.gin_messages import gin_messages, gin_messages_bwd
from moleculesde_tpu_torch.ops.pair_block import (
    pair_relu_project, pair_relu_project_bwd, pair_relu_project_cm, pair_relu_project_cm_bwd)
from moleculesde_tpu_torch.ops.score_kernel import score_eval_fused

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "moleculesde_tpu", "pandas",
             "sklearn")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "moleculesde_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    utils = ROOT / "moleculesde_tpu_torch" / "utils"
    # the utilities' counterparts, whose JAX modules import JAX (flops.py)
    # or torch (torch_import.py), and the NaN guard
    assert {utils / "torch_import.py", utils / "flops.py", utils / "debug_nans.py"} <= set(files)
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_rdkit_only_inside_functions():
    files = sorted((ROOT / "moleculesde_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    top = []
    for f in files:
        for node in ast.parse(f.read_text()).body:   # module level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                top += [(str(f.relative_to(ROOT)), n) for n in names
                        if n.split(".")[0] == "rdkit"]
    assert not top, top
    lazy = [f for f in files if "from rdkit" in f.read_text()]
    assert {f.name for f in lazy} >= {"featurize.py", "datasets.py", "splitters.py"}


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNN2D(num_layers=2, emb_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDEModel2Dto3D(emb_dim=8, hidden_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchNet(hidden_channels=8, num_filters=8, num_interactions=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDEModel3Dto2D(dim3d=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PaiNN(n_atom_basis=8, n_interactions=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--end", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_cli.main(["--synthetic_molecules", "4", "--batch_size", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_3d2d.main(["--end", "1", "--batch_size", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNNGraphPred(2, num_layers=2, emb_dim=8)
    for finetune in (finetune_moleculenet, finetune_qm9, finetune_md17):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            finetune.main(["--dataset", "synthetic", "--synthetic_molecules", "8",
                           "--batch_size", "4", "--n_max", "6"])
    assert chip_smoke.main() == 2   # no result printed, non-zero exit
    GNN2D(num_layers=2, emb_dim=8, device="cpu")


def test_cli_runs_on_cpu_when_asked(tmp_path, capsys):
    res = cli.main(["--device", "cpu", "--dataset", "synthetic", "--end", "2",
                    "--num_repeat_SDE_inference", "2",
                    "--sample_mols_per_batch", "2", "--n_max", "6", "--emb_dim", "8",
                    "--num_layer", "2", "--num_diffusion_timesteps_2Dto3D_inference", "2",
                    "--steps_pos", "1", "--output_model_dir", str(tmp_path)])
    assert len(res) == 2
    for r in res:
        assert r["pos_gen"].shape == (2, r["atom_feats"].shape[0], 3)
        assert np.isfinite(r["pos_gen"]).all() and 0.0 <= r["cov"] <= 1.0
    with open(next(tmp_path.glob("2D_to_3D_PC_*.pkl")), "rb") as fh:
        assert len(pickle.load(fh)) == 2
    assert "COV=" in capsys.readouterr().out


def test_port_checkpoint_roundtrip_through_cli(tmp_path, capsys):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--end", "1",
            "--num_repeat_SDE_inference", "2", "--n_max", "6", "--emb_dim", "8", "--num_layer", "2",
            "--num_diffusion_timesteps_2Dto3D_inference", "2", "--steps_pos", "1"]
    args = cli.get_parser().parse_args(argv)
    model_2d, sde_model = cli.build_models(args, "cpu")
    with torch.no_grad():
        for p in list(model_2d.parameters()) + list(sde_model.parameters()):
            p.add_(0.01)  # weights the seed alone would not give
    path = str(tmp_path / "port.pt")
    save_checkpoint(path, {"model_2D": model_2d, "SDE_2Dto3D_model": sde_model}, vars(args))
    assert load_checkpoint(path)["config"]["emb_dim"] == 8
    loaded = cli.build_models(cli.get_parser().parse_args(argv + ["--input_model_file", path]),
                              "cpu")
    for mine, theirs in zip((model_2d, sde_model), loaded):
        for (k, a), (k2, b) in zip(mine.state_dict().items(), theirs.state_dict().items()):
            assert k == k2 and torch.equal(a, b), k
    res = cli.main(argv + ["--input_model_file", path])
    assert "loaded checkpoint" in capsys.readouterr().out
    assert np.isfinite(res[0]["pos_gen"]).all()


def test_kernel_wrappers_take_plain_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 5, size=(2, 6)).astype(np.int32))
    boh = torch.zeros(2, 6, 3)
    boh[..., 0] = 1
    tbl = torch.ones(3, 5)
    w, bias = torch.ones(5, 2), torch.zeros(2)
    ea, env = torch.rand(2, 4, 4, 3), torch.rand(2, 4, 4)
    x4 = torch.randn(2, 4, 4)
    cf_w = (torch.ones(3, 4), torch.zeros(4), torch.eye(4), torch.zeros(4))
    dist = torch.rand(2, 4, 4) * 5
    rbf = dict(start=0.0, stop=5.0, num_gaussians=3)
    wrappers = (gin_messages, gin_messages_bwd, fused_cfconv, fused_cfconv_bwd,
                fused_cfconv_rbf, fused_cfconv_rbf_bwd, pair_relu_project,
                pair_relu_project_bwd, pair_relu_project_cm, pair_relu_project_cm_bwd,
                score_eval_fused)
    counts = [f.launches for f in wrappers]
    assert gin_messages(x, idx, idx, boh, tbl).shape == (2, 4, 5)
    assert gin_messages_bwd(x, idx, idx, boh, tbl, x)[1].shape == (3, 5)
    assert fused_cfconv(ea, env, x4, *cf_w).shape == (2, 4, 4)
    assert len(fused_cfconv_bwd(ea, env, x4, *cf_w, x4)) == 5
    assert fused_cfconv_rbf(dist, env, x4, *cf_w, **rbf).shape == (2, 4, 4)
    assert len(fused_cfconv_rbf_bwd(dist, env, x4, *cf_w, x4, **rbf)) == 5
    assert pair_relu_project(x, x, w, bias).shape == (2, 4, 4, 2)
    assert pair_relu_project_bwd(x, x, w, torch.ones(2, 4, 4, 2))[2].shape == (5, 2)
    assert pair_relu_project_cm(x, x, w, bias).shape == (2, 2, 16)
    assert pair_relu_project_cm_bwd(x, x, w, torch.ones(2, 2, 16))[2].shape == (5, 2)
    with pytest.raises(ValueError, match="CUDA"):
        gin_messages(x, idx, idx, boh, tbl, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        gin_messages_bwd(x, idx, idx, boh, tbl, x, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fused_cfconv(ea, env, x4, *cf_w, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fused_cfconv_rbf(dist, env, x4, *cf_w, impl="kernel", **rbf)
    with pytest.raises(ValueError, match="CUDA"):
        fused_cfconv_rbf_bwd(dist, env, x4, *cf_w, x4, impl="kernel", **rbf)
    with pytest.raises(ValueError, match="CUDA"):
        pair_relu_project(x, x, w, bias, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        pair_relu_project_bwd(x, x, w, torch.ones(2, 4, 4, 2), impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        pair_relu_project_cm(x, x, w, bias, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        pair_relu_project_cm_bwd(x, x, w, torch.ones(2, 2, 16), impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        pair_relu_project(x, x, w, bias, impl="xla")
    assert [f.launches for f in wrappers] == counts


def test_cfconv_refuses_gradients_for_positions():
    """K2's contract: no gradient to ea or env, so asking for one raises
    rather than returning zero forces."""
    ea = torch.rand(2, 4, 4, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient to ea or env"):
        fused_cfconv(ea, torch.rand(2, 4, 4), torch.randn(2, 4, 4), torch.ones(3, 4),
                     torch.zeros(4), torch.eye(4), torch.zeros(4))


def test_every_kernel_source_is_built_by_name():
    assert build.kernel_names() == ["attn_bank", "attn_qk_bank", "cfconv", "gin_messages",
                                    "pair_block", "score_eval"]
    for name in build.kernel_names():
        lib = build._library_path(name)
        assert lib.parent == build.BUILD_DIR and name in lib.name
    assert build.build([]) == {}   # nothing to build: no compiler needed


def test_compact_ingest_stays_on_the_cpu_when_asked():
    """The compact path on the CPU: worker threads, the prefetch (no pinned
    memory without a card), the expansion and the chunk split all run
    there."""
    rng = np.random.default_rng(2)
    gs = [random_molecule(rng, int(rng.integers(3, 7)), extend=False) for _ in range(8)]
    loader = ThreadedLoader(GraphLoader(gs, batch_size=4, n_max=6, collate="compact"), 2)
    seen = 0
    for batch, n_real in device_prefetch(loader, "cpu"):
        assert isinstance(batch, CompactBatch) and n_real == 4
        assert not batch.atom_feats.is_pinned()
        expanded = expand_on_device(batch)
        assert expanded.ext_dense_mask.device.type == "cpu"
        assert [c.num_graphs for c in split_microbatches(batch, 2)] == [2, 2]
        seen += 1
    assert seen == 2
