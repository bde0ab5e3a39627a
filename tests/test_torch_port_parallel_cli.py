"""The port's six CLIs as data-parallel runs on the CPU: each CLI's ``run``
on two gloo ranks, spawned as ``--num_devices 2 --device cpu`` spawns them
(one group runs the six in turn; ``main`` with ``--num_devices 2`` runs in
test_torch_port_pretrain.py, _sample_3d2d.py and _finetune_cli.py),
against the CLI's ``main`` in one process; pretraining's ``--distributed``
as two processes; and the flags that stay refused.

- Pretraining: the printed epochs' metrics agree to 1e-5 relative and the
  final weights (``model_complete_final.pt``) to 1e-5 of each leaf's
  largest value, but for the leaves whose gradient is zero in exact
  arithmetic (``ZERO_GRAD``), which Adam moves by up to lr a step either
  way on rounding noise, and the running means, which follow the biases
  in front of their BatchNorm: those to 2 lr a step.  Only rank 0 writes.
- The samplers: every conformer / graph to 1e-5 of the largest value, and
  COV / MAT.
- The finetunes: the best epoch's metrics to 1e-5 relative and the final
  weights as pretraining's.
- ``--distributed``: two processes meeting at ``--dist_coordinator``, each
  on its ``shard_for_process`` share, against one process stepping the
  global batches those shares make (the two shards' batches side by side)
  with the CLI's generator: the epoch's metrics (rank 0's
  ``metrics.csv``) and the final weights, as above.
- Refusals: more ranks than visible cards (none here) with ``--device
  cuda`` name both counts; ``--buckets``, ``--n_max 0`` and
  ``--num_devices`` under ``--distributed``, a batch that does not split,
  the finetunes' ``--distributed``, ``--profile_dir`` and
  ``--debug_nans``.
"""

import concurrent.futures
import csv
import datetime
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from moleculesde_tpu_torch.convert import load_checkpoint
from moleculesde_tpu_torch.data.compact import collate_compact
from moleculesde_tpu_torch.examples import finetune_md17, finetune_moleculenet, finetune_qm9
from moleculesde_tpu_torch.examples import pretrain, sample_2d_to_3d, sample_3d_to_2d
from moleculesde_tpu_torch.parallel import mesh
from moleculesde_tpu_torch.pretrain.train_state import create_pretrain_state
from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_step

import torch_port_parallel_worker as w
from torch_port_common import ZERO_GRAD

ROOT = Path(__file__).resolve().parents[1]
PRE = ["--device", "cpu", "--synthetic_molecules", "12", "--batch_size", "4", "--epochs", "1",
       "--n_max", "8", "--emb_dim", "16", "--num_layer", "2", "--SchNet_num_interactions", "1",
       "--SchNet_num_filters", "8", "--train_precision", "float32"]
FT = ["--device", "cpu", "--n_max", "8", "--emb_dim", "16", "--num_layer", "2",
      "--SchNet_num_filters", "8", "--SchNet_num_interactions", "1",
      "--SchNet_num_gaussians", "11", "--epochs", "2", "--batch_size", "4",
      "--dataset", "synthetic", "--synthetic_molecules", "24"]
LR = 1e-4


SAMPLE_2D3D = ["--device", "cpu", "--dataset", "synthetic", "--end", "3",
               "--num_repeat_SDE_inference", "2", "--sample_mols_per_batch", "2",
               "--n_max", "8", "--emb_dim", "16", "--num_layer", "2",
               "--sampler_precision", "float32",
               "--num_diffusion_timesteps_2Dto3D_inference", "3", "--steps_pos", "2"]
SAMPLE_3D2D = ["--device", "cpu", "--dataset", "synthetic", "--end", "6", "--batch_size", "4",
               "--n_max", "8", "--emb_dim", "16", "--SchNet_num_interactions", "1",
               "--SchNet_num_filters", "8", "--num_diffusion_timesteps_3Dto2D_inference", "2",
               "--steps_pos", "2"]
# (module, flags) of each CLI's run: the finetunes' extras pick options
# beside the data-parallel path (mse: under the L1 loss a batch with as
# many errors above as below gives the head's bias a zero gradient, where
# Adam steps on rounding)
CLIS = {"pretrain": (pretrain, PRE), "sample_2d_to_3d": (sample_2d_to_3d, SAMPLE_2D3D),
        "sample_3d_to_2d": (sample_3d_to_2d, SAMPLE_3D2D),
        "moleculenet": (finetune_moleculenet, FT + ["--dropout_ratio", "0.5"]),
        "qm9": (finetune_qm9, FT + ["--split", "random", "--use_rotation_transform",
                                    "--loss", "mse", "--lr_scheduler", "ReduceLROnPlateau"]),
        "md17": (finetune_md17, FT + ["--energy_force_with_normalization"])}


@pytest.fixture(autouse=True)
def short_group_timeout(monkeypatch):
    """The ranks' collectives give up after 60 s: a deadlock fails the test
    in bounded time."""
    monkeypatch.setattr(mesh, "TIMEOUT", datetime.timedelta(seconds=60))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(output root, {CLI: rank 0's result}): every CLI's ``run`` on the same
    two gloo ranks (``mesh.spawn``, as ``--num_devices 2`` spawns them;
    one group for the six, started with the module and awaited by the first
    test that reads it), writing under ``<root>/two/<CLI>``.  Pretraining
    runs under ``--debug_nans`` (each rank's guard) and ``--profile_dir
    <root>/trace`` (a trace a rank), which change none of its numbers."""
    root = tmp_path_factory.mktemp("cli")
    extra = {"pretrain": ["--debug_nans", "--profile_dir", str(root / "trace")]}
    jobs = [(name, mod.__name__, flags + extra.get(name, []) + [
        "--num_devices", "2", "--output_model_dir", str(root / "two" / name)])
            for name, (mod, flags) in CLIS.items()]
    saved, mesh.TIMEOUT = mesh.TIMEOUT, datetime.timedelta(seconds=60)
    ex = concurrent.futures.ThreadPoolExecutor(1)
    future = ex.submit(mesh.spawn, w.cli_runs, 2, "cpu", jobs, deadline_s=240)
    yield root, lambda: future.result(timeout=300)
    ex.shutdown(wait=True)
    mesh.TIMEOUT = saved


def run_both(name, two_ranks):
    """(one-process result, two-rank result) of CLI ``name``; the one-process
    run writes under ``<root>/one/<CLI>``."""
    root, results = two_ranks
    mod, flags = CLIS[name]
    one = mod.main(flags + ["--output_model_dir", str(root / "one" / name)])
    return one, results()[name]


def same_outputs(root, name, steps):
    """The two runs wrote the same files, and the same final weights."""
    one, two = root / "one" / name, root / "two" / name
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())
    assert_weights(one / "model_complete_final.pt", two / "model_complete_final.pt", LR, steps)


def assert_weights(a_path, b_path, lr, steps):
    a, b = load_checkpoint(str(a_path)), load_checkpoint(str(b_path))
    comps = [c for c in a if c != "config"]
    assert comps and comps == [c for c in b if c != "config"]
    for comp in comps:
        for key, ref in a[comp].items():
            err = float((b[comp][key] - ref).abs().max())
            if ZERO_GRAD.search(f"{comp}.{key}") or key.endswith(".mean"):
                assert err <= 2 * lr * steps, (comp, key, err)
            else:
                assert err <= 1e-5 * max(float(ref.abs().max()), 1e-2), (comp, key, err)


def close(a, b, tol=1e-5):
    assert abs(a - b) <= tol * max(abs(b), 1.0), (a, b)


def test_pretrain_two_ranks_match_one_process(two_ranks):
    one, two = run_both("pretrain", two_ranks)
    assert len(one) == len(two) == 1
    for k in METRICS:
        close(two[0][k], one[0][k])
    same_outputs(two_ranks[0], "pretrain", 3)


def test_sample_2d_to_3d_two_ranks_match_one_process(two_ranks):
    one, two = run_both("sample_2d_to_3d", two_ranks)
    assert len(one) == len(two) == 3
    for a, b in zip(two, one):
        scale = max(np.abs(b["pos_gen"]).max(), 1.0)
        assert np.abs(a["pos_gen"] - b["pos_gen"]).max() <= 1e-5 * scale
        close(a["cov"], b["cov"])
        close(a["mat"], b["mat"])
    assert len(list((two_ranks[0] / "two" / "sample_2d_to_3d").glob("*.pkl"))) == 1


def test_sample_3d_to_2d_two_ranks_match_one_process(two_ranks):
    one, two = run_both("sample_3d_to_2d", two_ranks)
    assert [len(r["x_gen"]) for r in two] == [len(r["x_gen"]) for r in one] == [4, 2]
    for a, b in zip(two, one):
        for k in ("x_gen", "adj_gen"):
            assert np.abs(a[k] - b[k]).max() <= 1e-5 * max(np.abs(b[k]).max(), 1.0), k
        np.testing.assert_array_equal(a["atom_feats_true"], b["atom_feats_true"])
    with open(next((two_ranks[0] / "two" / "sample_3d_to_2d").glob("*.pkl")), "rb") as f:
        assert len(pickle.load(f)) == 2


@pytest.mark.parametrize("name", ["moleculenet", "qm9", "md17"])
def test_finetune_two_ranks_match_one_process(two_ranks, name):
    one, two = run_both(name, two_ranks)
    for a, b in zip(two, one):
        close(a, b)
    same_outputs(two_ranks[0], name, 10)


def distributed_reference(args):
    """One process stepping the global batches of two ``--distributed``
    processes: each shard's loader batches, side by side, and the CLI's
    state and generator."""
    graphs = pretrain.load_graphs(args)
    loaders = [pretrain.make_loader(mesh.shard_for_process(graphs, r, 2), args,
                                    batch_size=args.batch_size // 2) for r in range(2)]
    cfg = pretrain.config_from_args(args)
    state = create_pretrain_state(cfg, "cpu", args.seed)
    sums, n = None, 0
    for idx0, idx1 in zip(loaders[0].epoch_indices(), loaders[1].epoch_indices()):
        mols = [loaders[0].graphs[i] for i in idx0] + [loaders[1].graphs[i] for i in idx1]
        batch = collate_compact(mols, n_max=args.n_max, e_max=args.e_max_factor * args.n_max,
                                use_extend=args.use_extend_graph)
        metrics = pretrain_step(state.models, state.optimizer, cfg, batch, state.generator)
        vals = np.array([metrics[k].item() for k in METRICS])
        sums, n = (vals if sums is None else sums + vals), n + 1
    return dict(zip(METRICS, sums / n)), state.models, n


def test_pretrain_distributed_two_processes(tmp_path):
    port = mesh.free_port()
    out = tmp_path / "dist"
    flags = PRE + ["--distributed", "--dist_coordinator", f"localhost:{port}",
                   "--dist_num_processes", "2", "--output_model_dir", str(out)]
    procs = [subprocess.Popen([sys.executable, "-m", "moleculesde_tpu_torch.examples.pretrain",
                               *flags, "--dist_process_id", str(r)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    ref, models, steps = distributed_reference(pretrain.get_parser().parse_args(flags))
    t0 = time.time()
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(1, 120 - (time.time() - t0))))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, outs[-1][1][-3000:]
    assert "CL Loss" in outs[0][0] and "CL Loss" not in outs[1][0]   # rank 0 alone prints
    with open(out / "metrics.csv") as f:
        row = next(csv.DictReader(f))
    for k in ("CL_loss", "CL_acc", "SDE_loss_2Dto3D", "SDE_loss_3Dto2D"):
        close(float(row[k]), ref[k])
    ckpt = tmp_path / "ref.pt"
    from moleculesde_tpu_torch.convert import save_checkpoint
    save_checkpoint(str(ckpt), models, {})
    assert_weights(ckpt, out / "model_complete_final.pt", LR, steps)


def test_refusals(two_ranks, capsys):
    with pytest.raises(ValueError, match="2 ranks need 2 CUDA devices, but 0 are visible"):
        mesh.check_devices(2, "cuda")
    mesh.check_devices(3, "cpu")
    dist = ["--distributed", "--dist_coordinator", "localhost:1", "--dist_num_processes", "2",
            "--dist_process_id", "0"]
    for flags, match in ((["--buckets", "8"], "--buckets is refused under --distributed"),
                         (["--n_max", "0"], "--n_max 0 is refused under --distributed"),
                         (["--num_devices", "2"], "--num_devices is refused under")):
        with pytest.raises(ValueError, match=match):
            pretrain.main(PRE + dist + flags)
    with pytest.raises(ValueError, match="--batch_size 4 must be divisible by --num_devices=3"):
        pretrain.main(PRE + ["--num_devices", "3"])
    with pytest.raises(ValueError, match="multiple of the number of ranks"):
        pretrain.main(PRE + ["--num_devices", "2", "--microbatch", "3"])
    # --profile_dir and --debug_nans run under --num_devices 2 (the
    # two_ranks fixture's pretraining, whose numbers equal one process's in
    # test_pretrain_two_ranks_match_one_process): a trace of epoch 1 a rank
    root, results = two_ranks
    results()
    for rank in (0, 1):
        with open(root / "trace" / f"trace_rank{rank}.json") as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert {"aten::mm", "MmBackward0"} <= names, rank
    # the finetunes parse --distributed / --dist_* / --profile_dir /
    # --debug_nans as the JAX finetunes do and note each one, refusing
    # none of them (their runs equal the runs without such flags:
    # test_torch_port_finetune_cli.py::test_unported_flags_are_refused)
    inert = ["--distributed", "--dist_num_processes", "2", "--profile_dir", "x", "--debug_nans"]
    for mod in (finetune_moleculenet, finetune_qm9, finetune_md17):
        capsys.readouterr()
        with pytest.raises(ValueError, match="divisible by --num_devices=3"):
            mod.main(FT + inert + ["--num_devices", "3"])
        out = capsys.readouterr().out
        for flag in ("--distributed", "--dist_num_processes", "--profile_dir", "--debug_nans"):
            assert f"{flag} has no effect in this CLI" in out, (mod.__name__, flag)
        assert not (ROOT / "x").exists()
    with pytest.raises(ValueError, match="divisible by --num_devices=3"):
        sample_2d_to_3d.main(["--device", "cpu", "--num_devices", "3",
                              "--num_repeat_SDE_inference", "2"])
    with pytest.raises(ValueError, match="divisible by --num_devices=3"):
        sample_3d_to_2d.main(["--device", "cpu", "--num_devices", "3", "--batch_size", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(PRE[2:] + ["--num_devices", "2"])
