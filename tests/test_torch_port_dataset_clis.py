"""The real-dataset branches of the port's pretraining and sampler CLIs and
``load_pcqm4mv2``, on copies of the committed PCQM4Mv2 and QM9 fixtures,
against the JAX package; ``tests/rdkit_stub.py`` stands in for RDKit for
the whole module.

Every test reads its own copy of ``tests/fixtures/{pcqm4mv2,qm9}/raw`` in a
temporary directory and writes no cache under ``tests/fixtures/``, where
the JAX package's tests build theirs.

- ``load_pcqm4mv2`` equals JAX's array for array (packed, also cut to
  ``max_molecules`` and without the extended graph) and dict for dict
  (``packed=False``); a second call loads the cache without RDKit.
- JAX's ``examples/pretrain.py::load_graphs`` and the port's give the same
  molecules for ``--dataset PCQM4Mv2`` and ``--dataset QM9 --max_molecules
  3``.
- The pretraining CLI trains a tiny epoch on each dataset (also with
  ``--buckets`` and ``--n_max 0`` on the packed cache) and writes its
  checkpoint; both sampler CLIs run on the PCQM4Mv2 copy, the 2D->3D one
  printing finite COV / MAT and refusing a molecule past ``--n_max``
  before any sampling.
- ``generate_pcqm4mv2`` writes the cache and prints JAX's line.
"""

import contextlib
import importlib.util
import io
import os
import shutil
import sys

import numpy as np
import pytest

import rdkit_stub

from moleculesde_tpu.data import datasets as jax_datasets
from moleculesde_tpu_torch.convert import load_checkpoint
from moleculesde_tpu_torch.data import datasets
from moleculesde_tpu_torch.data.packed import PackedGraphs
from moleculesde_tpu_torch.examples import generate_pcqm4mv2
from moleculesde_tpu_torch.examples import pretrain as cli
from moleculesde_tpu_torch.examples import sample_2d_to_3d as sample_cli
from moleculesde_tpu_torch.examples import sample_3d_to_2d as sample_3d2d_cli

from torch_port_common import CPU  # noqa: F401 (one torch thread)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
EXAMPLES = os.path.join(os.path.dirname(HERE), "examples")
TINY = ["--device", "cpu", "--batch_size", "2", "--epochs", "1", "--n_max", "8",
        "--emb_dim", "16", "--num_layer", "2", "--SchNet_num_interactions", "2",
        "--SchNet_num_filters", "8", "--SchNet_num_gaussians", "11"]


@pytest.fixture(scope="module", autouse=True)
def rdkit():
    """The RDKit stand-in as ``rdkit`` for the module."""
    installed = rdkit_stub.install()
    yield
    if installed:
        rdkit_stub.uninstall()


def _data_dir(base, *names):
    """``base`` holding, under each ``--dataset`` name of ``names``, a copy
    of its fixture's ``raw`` directory (QM9's, else PCQM4Mv2's)."""
    for name in names:
        fixture = "qm9" if name == "QM9" else "pcqm4mv2"
        shutil.copytree(os.path.join(FIXTURES, fixture, "raw"),
                        os.path.join(base, name, "raw"))
    return str(base)


def _jax_example(name):
    """A JAX CLI module of ``examples/`` (it imports its parser as
    ``config`` from its own directory)."""
    saved = sys.modules.pop("config", None)
    sys.path.insert(0, EXAMPLES)
    try:
        spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                      os.path.join(EXAMPLES, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(EXAMPLES)
        sys.modules.pop("config", None)
        if saved is not None:
            sys.modules["config"] = saved
    return mod


def _same_packed(mine, theirs):
    assert sorted(mine.arrays) == sorted(theirs.arrays) and mine.meta == theirs.meta
    for k in theirs.arrays:
        a, b = np.asarray(mine.arrays[k]), np.asarray(theirs.arrays[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _same_dicts(mine, theirs):
    assert len(mine) == len(theirs)
    for g, h in zip(mine, theirs):
        assert sorted(g) == sorted(h)
        for k in h:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(h[k]), err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(max_molecules=2), dict(extend=False),
                                dict(packed=False)],
                         ids=["packed", "max_2", "no_extend", "dicts"])
def test_load_pcqm4mv2_matches_jax_and_hits_the_cache(kw, tmp_path, monkeypatch):
    mine_root = os.path.join(_data_dir(tmp_path / "port", "PCQM4Mv2"), "PCQM4Mv2")
    ref_root = os.path.join(_data_dir(tmp_path / "jax", "PCQM4Mv2"), "PCQM4Mv2")
    mine = datasets.load_pcqm4mv2(mine_root, **kw)
    theirs = jax_datasets.load_pcqm4mv2(ref_root, **kw)
    if kw.get("packed", True) is False:
        _same_dicts(mine, theirs)
        assert not any(f.startswith("packed") for f in os.listdir(mine_root))
        return
    _same_packed(mine, theirs)
    tag = f"packed_ext{int(kw.get('extend', True))}" + (
        f"_n{kw['max_molecules']}" if "max_molecules" in kw else "")
    assert sorted(os.listdir(mine_root)) == sorted(["raw", tag])
    assert len(mine) == kw.get("max_molecules", 4)
    assert isinstance(mine.arrays["atom_feats"], np.memmap)
    monkeypatch.delitem(sys.modules, "rdkit")   # the cache needs no RDKit
    monkeypatch.delitem(sys.modules, "rdkit.Chem")
    _same_packed(datasets.load_pcqm4mv2(mine_root, **kw), theirs)


@pytest.mark.parametrize("flags", [["--dataset", "PCQM4Mv2"],
                                   ["--dataset", "QM9", "--max_molecules", "3"]],
                         ids=["pcqm4mv2", "qm9_max_3"])
def test_load_graphs_matches_the_jax_cli(flags, tmp_path):
    jax_cli = _jax_example("pretrain")
    mine = cli.load_graphs(cli.get_parser().parse_args(
        flags + ["--input_data_dir", _data_dir(tmp_path / "port", "PCQM4Mv2", "QM9")]))
    theirs = jax_cli.load_graphs(jax_cli.parse_args(
        flags + ["--input_data_dir", _data_dir(tmp_path / "jax", "PCQM4Mv2", "QM9")]))
    if flags[1] == "PCQM4Mv2":
        assert isinstance(mine, PackedGraphs)
        _same_packed(mine, theirs)
    else:
        assert len(mine) == 3
        _same_dicts(mine, theirs)


@pytest.mark.parametrize("flags", [
    ["--dataset", "PCQM4Mv2", "--output_model_dir", "OUT"],
    ["--dataset", "pcqm4m-v2", "--buckets", "4", "8"],
    ["--dataset", "PCQM4Mv2", "--n_max", "0"],
    ["--dataset", "QM9", "--max_molecules", "3", "--output_model_dir", "OUT"]],
    ids=["pcqm4mv2", "pcqm4mv2_buckets", "pcqm4mv2_n_max_0", "qm9"])
def test_pretrain_cli_trains_on_dataset(flags, tmp_path, capsys):
    """One tiny epoch on each dataset's fixture copy: finite losses, the
    packed cache (memory-mapped) in the loader, the checkpoint written."""
    data = _data_dir(tmp_path, flags[1])
    out = str(tmp_path / "out")
    flags = [out if f == "OUT" else f for f in flags]
    args = cli.get_parser().parse_args(TINY + flags + ["--input_data_dir", data])
    graphs = cli.load_graphs(args)
    assert isinstance(graphs, PackedGraphs) == (args.dataset != "QM9")
    if "--n_max" in flags:   # the suggested bucket of the fixture's molecules
        assert cli.make_loader(graphs, args).n_max == 16
    history = cli.main(TINY + flags + ["--input_data_dir", data])
    assert len(history) == 1 and np.isfinite(list(history[0].values())).all()
    assert "CL Loss:" in capsys.readouterr().out
    if out in flags:
        ckpt = load_checkpoint(os.path.join(out, "model_complete_final.pt"))
        assert {"model_2D", "model_3D", "SDE_2Dto3D_model", "SDE_3Dto2D_model"} <= set(ckpt)


def test_pretrain_cli_refuses_an_unknown_dataset(tmp_path):
    with pytest.raises(ValueError, match="unknown pretrain dataset ZINC"):
        cli.main(TINY + ["--dataset", "ZINC", "--input_data_dir", str(tmp_path)])


SAMPLE_2D3D = ["--device", "cpu", "--dataset", "PCQM4Mv2", "--end", "3",
               "--num_repeat_SDE_inference", "2", "--sample_mols_per_batch", "2", "--n_max", "8",
               "--emb_dim", "16", "--num_layer", "2",
               "--num_diffusion_timesteps_2Dto3D_inference", "2", "--steps_pos", "1"]
SAMPLE_3D2D = ["--device", "cpu", "--dataset", "PCQM4Mv2", "--batch_size", "2", "--end", "4",
               "--n_max", "8", "--emb_dim", "16", "--SchNet_num_interactions", "2",
               "--SchNet_num_filters", "16", "--num_diffusion_timesteps_3Dto2D_inference", "2",
               "--steps_pos", "1"]


def test_sample_2d_to_3d_cli_on_packed_molecules(tmp_path, capsys):
    """The first three molecules of the cache (``--end 3``, one
    PackedSubset slice a batch): finite conformers of each molecule's atom
    count, COV in [0, 1] and a finite MAT printed for each."""
    data = _data_dir(tmp_path, "PCQM4Mv2")
    res = sample_cli.main(SAMPLE_2D3D + ["--input_data_dir", data])
    cache = PackedGraphs.load(os.path.join(data, "PCQM4Mv2", "packed_ext1_n3"))
    assert [r["pos_gen"].shape for r in res] == [(2, n, 3) for n in cache.num_atoms]
    for r, i in zip(res, range(3)):
        np.testing.assert_array_equal(r["positions_true"], cache[i]["positions"])
        assert np.isfinite(r["pos_gen"]).all() and 0.0 <= r["cov"] <= 1.0
        assert np.isfinite(r["mat"])
    assert capsys.readouterr().out.count("COV=") == 3
    with pytest.raises(ValueError, match="has 4 atoms, more than --n_max 3"):
        sample_cli.main(SAMPLE_2D3D + ["--input_data_dir", data, "--end", "4", "--n_max", "3"])


def test_sample_3d_to_2d_cli_on_packed_molecules(tmp_path, capsys):
    data = _data_dir(tmp_path, "PCQM4Mv2")
    res = sample_3d2d_cli.main(SAMPLE_3D2D + ["--input_data_dir", data,
                                              "--output_model_dir", str(tmp_path / "gen")])
    assert [r["x_gen"].shape for r in res] == [(2, 8, 119), (2, 8, 119)]
    assert all(np.isfinite(r["adj_gen"]).all() for r in res)
    assert capsys.readouterr().out.count("generated 2 graphs") == 2


def test_generate_pcqm4mv2_writes_the_cache_and_prints_jax_line(tmp_path):
    """The last line of each package's output (JAX's parser prints the
    parsed flags before it), the data directory aside."""
    jax_gen = _jax_example("generate_pcqm4mv2")
    lines = []
    for name, main in (("port", generate_pcqm4mv2.main), ("jax", jax_gen.main)):
        data = _data_dir(tmp_path / name, "PCQM4Mv2")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--input_data_dir", data, "--dataset", "PCQM4Mv2", "--max_molecules", "3"])
        lines.append(buf.getvalue().splitlines()[-1].replace(data, "DATA"))
        assert PackedGraphs.exists(os.path.join(data, "PCQM4Mv2", "packed_ext1_n3"))
    assert lines[0] == lines[1] and lines[0].startswith("processed 3 molecules")
