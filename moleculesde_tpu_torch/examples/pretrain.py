"""Joint MoleculeSDE pretraining CLI.

Counterpart of ``examples/pretrain.py`` of the JAX package (reference
examples/pretrain_MoleculeSDE.py): the JAX CLI's flag names and defaults
for everything the port runs, the same per-epoch console metrics and
``metrics.csv`` rows, the four-component checkpoint (``model_complete.pt``
at the best epoch loss, ``model_complete_final.pt`` at the end), whose
components the port's sampler CLIs load with ``--input_model_file``, and
the full train state at the end (``train_state.pt``: weights, batch
statistics, Adam's moments and step, the step generator, ``extra={"epoch":
epochs}``).  As in JAX, ``--ingest compact`` (the default) collates compact
batches and builds the extended graph on the device, ``--buckets`` trains
on size buckets (padded batches, whatever ``--ingest`` says), ``--n_max 0``
pads to :func:`suggest_buckets`, ``--microbatch`` / ``--microbatch_scope``
chunk the step, ``--model_3d PaiNN`` swaps the 3D encoder,
``--schnet_cfconv pallas_rbf`` runs K5, ``--gnn_type`` picks GIN, GCN, GAT
or GraphSAGE, ``--JK`` last, max or sum (``concat`` raises a ``ValueError``
before any step, where the JAX step fails) and ``--SDE_2Dto3D_model`` any of
the four 2D->3D score models.  The data follow JAX's ``load_graphs``:
synthetic molecules with ``--dataset synthetic`` or
``--synthetic_molecules N > 0`` (whatever ``--dataset`` says),
PCQM4Mv2 (``--dataset PCQM4Mv2`` or ``pcqm4m-v2``, in any case) from its
packed cache under ``<--input_data_dir>/<--dataset>``, built there on first
use from the raw files (RDKit needed only then) and memory-mapped, and
QM9 (``--dataset QM9``, the default) from its raw files; ``--max_molecules``
caps either, and any other name raises a ``ValueError``.

``--resume_from`` restores a full train state before the first epoch: the
port's ``train_state.pt`` (everything, the step generator included, so the
next step is the uninterrupted run's) or the JAX package's
``train_state.msgpack``, read without JAX (weights, batch statistics,
Adam's moments, step and LR scales).  JAX draws from ``--seed``'s key
folded with the step, a stream the port does not reproduce: after a JAX
checkpoint the port's dropout masks and loss draws come from its own
generator seeded with ``--seed``.  Like JAX, the run then trains
``--epochs`` epochs from epoch 1.  ``--n_max 0`` needs a dataset: synthetic
molecules are drawn with 4 to ``--n_max`` atoms, so it raises there, as
numpy raises in JAX.

Runs on the GPU (``--device cuda``, the default) and raises without one;
``--device cpu`` runs the plain PyTorch path.  Every flag the JAX CLI reads
is parsed with its name and default.  ``--input_data_dir`` and
``--max_molecules`` are read only with the QM9 / PCQM4Mv2 datasets, as in
JAX, so with synthetic molecules they change nothing.

``--debug_nans`` raises ``FloatingPointError`` at the first NaN, naming
where it arose (:class:`~moleculesde_tpu_torch.utils.debug_nans.NanGuard`:
module outputs, backward nodes, the state after each update, each step's
metrics), as JAX's ``jax_debug_nans``; with no NaN the run is bit for bit
the one without it.  ``--profile_dir DIR`` traces the JAX CLI's window,
from before the first epoch to the end of epoch 1 (its metric sync
included), with ``torch.profiler`` (CPU activity, and CUDA activity on
the card), and writes ``DIR/trace_rank<r>.json`` (a Chrome trace, one a
rank); on the card a trace with no CUDA kernel event raises.

Data parallelism (``parallel/``), ``--batch_size`` being the global batch
in both forms, as in JAX:

- ``--num_devices N`` > 1 spawns N ranks here, one a visible card (more
  ranks than cards raise), or N gloo ranks on the CPU with ``--device
  cpu``.  Every rank builds the same loader and collates only its block of
  each global batch, so ``--buckets`` take the same bucket on every rank.
- ``--distributed`` (or ``--dist_num_processes`` > 1) makes this process
  one rank of a group that meets at ``--dist_coordinator host:port`` with
  ``--dist_num_processes`` and ``--dist_process_id``, or at a launcher's
  ``env://``.  Each process trains on its ``shard_for_process`` share of
  the molecules in batches of ``--batch_size`` / processes.  ``--buckets``
  and ``--n_max 0`` would put different shapes on different ranks (JAX's
  global assembly fails there) and are refused by name, and so is
  ``--num_devices`` beside it (one rank a process).

Each step is the global batch's step (the same loss terms and gradient on
every rank, the same random stream as one process on the global batch
with ``--num_devices``); rank 0 alone prints and writes ``metrics.csv`` and
the checkpoints, and every rank reads ``--resume_from``.

Example:
  python -m moleculesde_tpu_torch.examples.pretrain --dataset=synthetic \\
      --synthetic_molecules=1024 --epochs=2 --output_model_dir=out/pretrain
  python -m moleculesde_tpu_torch.examples.pretrain --dataset=PCQM4Mv2 \\
      --input_data_dir=data --epochs=50 --output_model_dir=out/pretrain
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from moleculesde_tpu_torch.convert import save_checkpoint
from moleculesde_tpu_torch.data.datasets import load_pcqm4mv2, load_qm9
from moleculesde_tpu_torch.data.loader import (
    BucketedGraphLoader, GraphLoader, ThreadedLoader, device_prefetch, suggest_buckets)
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.parallel import mesh
from moleculesde_tpu_torch.pretrain.contrastive import METRICS as CL_METRICS
from moleculesde_tpu_torch.pretrain.train_state import PretrainConfig, create_pretrain_state
from moleculesde_tpu_torch.pretrain.train_step import METRICS, SCOPES, pretrain_step
from moleculesde_tpu_torch.sde.base import SDE_PRESETS_2DTO3D, SDE_PRESETS_3DTO2D
from moleculesde_tpu_torch.utils.checkpoints import load_train_state, save_train_state
from moleculesde_tpu_torch.utils.debug_nans import NanGuard
from moleculesde_tpu_torch.utils.metrics import MetricsLogger

MODEL_2DTO3D_VARIANTS = {"SDEModel2Dto3D_01": 1, "SDEModel2Dto3D_02": 2,
                         "SDEModel2Dto3D_03": 3, "SDEModel2Dto3D_04": 4}
MODEL_3DTO2D_VARIANTS = {"SDEModel3Dto2D_node_adj_dense": 1,
                         "SDEModel3Dto2D_node_adj_dense_02": 2,
                         "SDEModel3Dto2D_node_adj_dense_03": 3}


def get_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags (examples/config.py) that pretraining reads, with
    the same names and defaults, plus ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dataset", type=str, default="QM9",
                   help="QM9, PCQM4Mv2 (or pcqm4m-v2) under --input_data_dir, or "
                        "synthetic")
    p.add_argument("--synthetic_molecules", type=int, default=0,
                   help="number of synthetic molecules (0 -> 1024)")
    p.add_argument("--num_workers", type=int, default=0,
                   help="host collation threads (0: collate in the training loop)")
    p.add_argument("--ingest", type=str, default="compact", choices=["compact", "padded"],
                   help="'compact': minimal host batches, expanded (extended graph "
                        "included) on the device; 'padded': full batches collated "
                        "on the host")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--decay", type=float, default=0)
    p.add_argument("--print_every_epoch", type=int, default=1)
    p.add_argument("--model_3d", type=str, default="SchNet", choices=["SchNet", "PaiNN"])
    p.add_argument("--SchNet_num_filters", type=int, default=128)
    p.add_argument("--SchNet_num_interactions", type=int, default=6)
    p.add_argument("--SchNet_num_gaussians", type=int, default=51)
    p.add_argument("--SchNet_cutoff", type=float, default=10)
    p.add_argument("--SchNet_readout", type=str, default="mean", choices=["mean", "add"])
    p.add_argument("--PaiNN_radius_cutoff", type=float, default=5.0)
    p.add_argument("--PaiNN_n_interactions", type=int, default=3)
    p.add_argument("--PaiNN_n_rbf", type=int, default=20)
    p.add_argument("--PaiNN_readout", type=str, default="add", choices=["mean", "add"])
    p.add_argument("--gnn_type", type=str, default="GIN")
    p.add_argument("--num_layer", type=int, default=5)
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--dropout_ratio", type=float, default=0.5)
    p.add_argument("--JK", type=str, default="last")
    p.add_argument("--gnn_2d_lr_scale", type=float, default=1)
    p.add_argument("--gnn_3d_lr_scale", type=float, default=1)
    p.add_argument("--CL_neg_samples", type=int, default=1)
    p.add_argument("--CL_similarity_metric", type=str, default="InfoNCE_dot_prod",
                   choices=list(CL_METRICS))
    p.add_argument("--T", type=float, default=0.1)
    p.add_argument("--normalize", dest="normalize", action="store_true")
    p.add_argument("--no_normalize", dest="normalize", action="store_false")
    p.set_defaults(normalize=False)
    p.add_argument("--SDE_type_2Dto3D", type=str, default="VE", choices=sorted(SDE_PRESETS_2DTO3D))
    p.add_argument("--SDE_type_3Dto2D", type=str, default="VE", choices=sorted(SDE_PRESETS_3DTO2D))
    p.add_argument("--SDE_2Dto3D_model", type=str, default="SDEModel2Dto3D_01",
                   choices=sorted(MODEL_2DTO3D_VARIANTS))
    p.add_argument("--SDE_3Dto2D_model", type=str, default="SDEModel3Dto2D_node_adj_dense",
                   choices=sorted(MODEL_3DTO2D_VARIANTS))
    p.add_argument("--SDE_coeff_contrastive", type=float, default=1)
    p.add_argument("--SDE_coeff_contrastive_skip_epochs", type=int, default=0)
    p.add_argument("--SDE_coeff_generative_2Dto3D", type=float, default=1)
    p.add_argument("--SDE_coeff_generative_3Dto2D", type=float, default=1)
    p.add_argument("--use_extend_graph", dest="use_extend_graph", action="store_true")
    p.add_argument("--no_extend_graph", dest="use_extend_graph", action="store_false")
    p.set_defaults(use_extend_graph=True)
    p.add_argument("--noise_on_one_hot", dest="noise_on_one_hot", action="store_true")
    p.add_argument("--no_noise_on_one_hot", dest="noise_on_one_hot", action="store_false")
    p.set_defaults(noise_on_one_hot=True)
    p.add_argument("--SDE_anneal_power", type=float, default=0)
    p.add_argument("--train_precision", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--microbatch", type=int, default=0,
                   help="chunk size: batches larger than this run in batch / "
                        "microbatch chunks under --microbatch_scope; 0 disables")
    p.add_argument("--microbatch_scope", type=str, default="step", choices=list(SCOPES),
                   help="'step' = gradient accumulation over the whole loss; "
                        "'score' / 'splice' = only the two score losses chunked "
                        "(encoders and contrastive at full batch); both run the "
                        "same spliced backward here, nothing recomputed")
    p.add_argument("--microbatch_unroll", type=int, default=1,
                   help="accepted for the JAX CLI's sake (it unrolls its "
                        "accumulation scan); eager PyTorch has no scan, so it "
                        "changes nothing")
    p.add_argument("--schnet_cfconv", type=str, default="auto",
                   choices=["auto", "xla", "pallas", "pallas_rbf"],
                   help="'auto' / 'pallas' = the fused CFConv kernel K2; "
                        "'pallas_rbf' = K5, the Gaussian smearing built in the "
                        "kernel; 'xla' = eager PyTorch")
    p.add_argument("--n_max", type=int, default=32,
                   help="padding (0 -> the smallest of 16 / 32 / 64 / 128 that holds "
                        "every molecule)")
    p.add_argument("--buckets", type=int, nargs="+", default=[],
                   help="size buckets: padded batches at n_max = each bucket")
    p.add_argument("--e_max_factor", type=int, default=4)
    p.add_argument("--ext_e_max", type=int, default=0,
                   help="extended-edge budget (0 -> n_max^2)")
    p.add_argument("--input_data_dir", type=str, default="")
    p.add_argument("--max_molecules", type=int, default=0,
                   help="cap on the dataset's size (0 -> all); read with QM9 / "
                        "PCQM4Mv2 only, as in JAX")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks spawned here, one a card (0 -> one "
                        "process); --device cpu: gloo ranks on the CPU")
    p.add_argument("--distributed", action="store_true",
                   help="this process is one rank of a group: --dist_* (or env://)")
    p.add_argument("--dist_coordinator", type=str, default="")
    p.add_argument("--dist_num_processes", type=int, default=0)
    p.add_argument("--dist_process_id", type=int, default=-1)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the first epoch here")
    p.add_argument("--debug_nans", dest="debug_nans", action="store_true",
                   help="raise FloatingPointError at the first NaN")
    p.set_defaults(debug_nans=False)
    p.add_argument("--resume_from", type=str, default="",
                   help="full train state to resume from: the port's train_state.pt "
                        "or the JAX package's train_state.msgpack")
    p.add_argument("--output_model_dir", type=str, default="")
    return p


def distributed(args) -> bool:
    """Whether this process is one rank of a group (JAX's condition,
    examples/pretrain.py:82)."""
    return args.distributed or args.dist_num_processes > 1


def check_supported(args) -> None:
    """Raise on the flag values the data-parallel forms refuse."""
    if distributed(args):
        for flag, asked in (("--num_devices", args.num_devices > 1),
                            ("--buckets", bool(args.buckets)),
                            ("--n_max 0", args.n_max == 0)):
            if asked:
                raise ValueError(f"{flag} is refused under --distributed: "
                                 + ("one process is one rank" if flag == "--num_devices" else
                                    "each process's molecules would set its own batch shapes"))
    world = args.num_devices if args.num_devices > 1 else 1
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} must be divisible by "
                         f"--num_devices={args.num_devices}")
    mesh.check_microbatch(args.microbatch, world)


def load_graphs(args):
    """The training molecules, as JAX's ``load_graphs`` picks them
    (examples/pretrain.py:48-70): ``--synthetic_molecules`` (0 -> 1024)
    molecules of 4 to ``--n_max`` atoms drawn from ``--seed`` with
    ``--dataset synthetic`` or ``--synthetic_molecules N``; else PCQM4Mv2's
    memory-mapped packed cache or QM9's graph dicts from
    ``<--input_data_dir>/<--dataset>``, cut to ``--max_molecules``."""
    # JAX's condition for synthetic molecules (examples/pretrain.py:49)
    if args.dataset == "synthetic" or args.synthetic_molecules > 0:
        if args.n_max < 4:
            raise ValueError(f"synthetic molecules have 4 to --n_max atoms: --n_max "
                             f"{args.n_max} leaves no size to draw (--n_max 0, the "
                             f"suggested bucket, needs a dataset)")
        rng = np.random.default_rng(args.seed)
        # compact ingest builds the extended graph on the device: the host
        # skips it
        extend = args.use_extend_graph and args.ingest != "compact"
        return [random_molecule(rng, int(rng.integers(4, args.n_max + 1)), extend=extend)
                for _ in range(args.synthetic_molecules or 1024)]
    root = os.path.join(args.input_data_dir, args.dataset)
    if args.dataset.lower() in ("pcqm4mv2", "pcqm4m-v2"):
        return load_pcqm4mv2(root, max_molecules=args.max_molecules or None,
                             extend=args.use_extend_graph)
    if args.dataset == "QM9":
        graphs, _ = load_qm9(root, extend=args.use_extend_graph)
        return graphs[:args.max_molecules] if args.max_molecules else graphs
    raise ValueError(f"unknown pretrain dataset {args.dataset}")


def make_loader(graphs, args, block=None, batch_size=None):
    """The host loader: size buckets with ``--buckets`` (padded batches, no
    worker threads, as in JAX), else ``--ingest``'s loader at ``--n_max``
    (or the suggested bucket at 0) in ``--num_workers`` threads; ``block``
    ((rank, ranks)) collates the rank's block of each batch, ``batch_size``
    overrides ``--batch_size``."""
    batch_size = batch_size or args.batch_size
    if args.buckets:
        return BucketedGraphLoader(graphs, batch_size=batch_size, buckets=args.buckets,
                                   e_max_factor=args.e_max_factor, shuffle=True,
                                   drop_last=True, seed=args.seed, block=block)
    n_max = args.n_max or suggest_buckets(graphs)
    loader = GraphLoader(graphs, batch_size=batch_size, n_max=n_max,
                         e_max=args.e_max_factor * n_max,
                         ext_e_max=args.ext_e_max or n_max * n_max,
                         shuffle=True, drop_last=True, seed=args.seed,
                         collate=args.ingest, use_extend=args.use_extend_graph, block=block)
    return ThreadedLoader(loader, args.num_workers) if args.num_workers > 0 else loader


def config_from_args(args) -> PretrainConfig:
    return PretrainConfig(
        emb_dim=args.emb_dim, num_layer=args.num_layer, jk=args.JK,
        dropout_ratio=args.dropout_ratio, gnn_type=args.gnn_type, model_3d=args.model_3d,
        schnet_num_filters=args.SchNet_num_filters,
        schnet_num_interactions=args.SchNet_num_interactions,
        schnet_num_gaussians=args.SchNet_num_gaussians, schnet_cutoff=args.SchNet_cutoff,
        schnet_readout=args.SchNet_readout,
        painn_radius_cutoff=args.PaiNN_radius_cutoff,
        painn_n_interactions=args.PaiNN_n_interactions, painn_n_rbf=args.PaiNN_n_rbf,
        painn_readout=args.PaiNN_readout,
        sde_type_2dto3d=args.SDE_type_2Dto3D, sde_type_3dto2d=args.SDE_type_3Dto2D,
        sde_2dto3d_variant=MODEL_2DTO3D_VARIANTS[args.SDE_2Dto3D_model],
        sde_3dto2d_variant=MODEL_3DTO2D_VARIANTS[args.SDE_3Dto2D_model],
        coeff_contrastive=args.SDE_coeff_contrastive,
        coeff_generative_2dto3d=args.SDE_coeff_generative_2Dto3D,
        coeff_generative_3dto2d=args.SDE_coeff_generative_3Dto2D,
        anneal_power=args.SDE_anneal_power, use_extend_graph=args.use_extend_graph,
        noise_on_one_hot=args.noise_on_one_hot, train_precision=args.train_precision,
        schnet_cfconv=args.schnet_cfconv, microbatch=args.microbatch,
        microbatch_scope=args.microbatch_scope,
        cl_similarity_metric=args.CL_similarity_metric, T=args.T,
        cl_neg_samples=args.CL_neg_samples, normalize=args.normalize,
        lr=args.lr, decay=args.decay, gnn_2d_lr_scale=args.gnn_2d_lr_scale,
        gnn_3d_lr_scale=args.gnn_3d_lr_scale)


def setup(args, device):
    """(config, models, optimizer, step generator) for the parsed flags:
    :func:`create_pretrain_state`'s, weights drawn from ``--seed``."""
    cfg = config_from_args(args)
    state = create_pretrain_state(cfg, device, args.seed)
    return cfg, state.models, state.optimizer, state.generator


LOGGED = ("CL_loss", "CL_acc", "SDE_loss_2Dto3D", "SDE_loss_3Dto2D")


def main(argv=None):
    args = get_parser().parse_args(argv)
    check_supported(args)
    return mesh.run_cli(run, args, args.num_devices, distributed(args))


def run(args, device):
    """Train as the flags say, on ``device``, as one rank of the active
    data-parallel group or as the only process; returns the printed
    epochs' metrics."""
    group = dp.active()
    graphs = load_graphs(args)
    if group is None:
        loader = make_loader(graphs, args)
    elif args.num_devices > 1:      # spawned ranks: one loader, each rank its block
        loader = make_loader(graphs, args, block=(group.rank, group.world))
    else:                           # a process of a group: its molecules, its share
        if args.batch_size % group.world:
            raise ValueError(f"--batch_size {args.batch_size} must be divisible by the "
                             f"{group.world} processes")
        mesh.check_microbatch(args.microbatch, group.world)
        loader = make_loader(mesh.shard_for_process(graphs), args,
                             batch_size=args.batch_size // group.world)
    cfg = config_from_args(args)
    state = create_pretrain_state(cfg, device, args.seed)
    if group is not None:
        mesh.replicate(state.models.values())
    if args.resume_from:
        state, extra = load_train_state(args.resume_from, state)
        print(f"resumed from {args.resume_from} at step {state.step} (extra: {extra})")
    writes = args.output_model_dir if dp.rank() == 0 else ""
    logger = MetricsLogger(writes or None)
    optimal_loss = float("inf")
    history = []
    guard = NanGuard(state.models, state.optimizer) if args.debug_nans else None
    # the JAX CLI's trace window: from before epoch 1 to its end, metric sync included
    profiler = _profiler(device) if args.profile_dir else None
    with guard or contextlib.nullcontext():
        if profiler is not None:
            profiler.start()
        for epoch in range(1, args.epochs + 1):
            coeff_cl = (args.SDE_coeff_contrastive
                        if epoch > args.SDE_coeff_contrastive_skip_epochs else 0.0)
            t0 = time.time()
            print(f"epoch: {epoch}")
            sums, n_batches = None, 0
            for batch, _ in device_prefetch(loader, device):
                metrics = pretrain_step(state.models, state.optimizer, cfg, batch,
                                        state.generator, coeff_cl)
                state.step += 1
                if guard is not None:
                    guard.check(f"the metrics of step {state.step}", metrics)
                vals = torch.stack([metrics[k] for k in METRICS])
                sums = vals if sums is None else sums + vals
                n_batches += 1
            if n_batches == 0:
                raise ValueError(f"no full batch of {args.batch_size} molecules to train on")
            if epoch % max(args.print_every_epoch, 1) == 0 or epoch == args.epochs:
                accum = dict(zip(METRICS, (sums / n_batches).tolist()))
                history.append(accum)
                temp_loss = (coeff_cl * accum["CL_loss"]
                             + args.SDE_coeff_generative_2Dto3D * accum["SDE_loss_2Dto3D"]
                             + args.SDE_coeff_generative_3Dto2D * accum["SDE_loss_3Dto2D"])
                if temp_loss < optimal_loss and writes:
                    optimal_loss = temp_loss
                    print(f"save model with loss: {optimal_loss:.5f}")
                    _save(args, state.models, "model_complete.pt")
                logger.log(epoch, {k: accum[k] for k in LOGGED},
                           echo="CL Loss: {:.5f}\tCL Acc: {:.5f}\t\tSDE 2Dto3D Loss: {:.5f}\t"
                                "SDE 3Dto2D Loss: {:.5f}".format(*(accum[k] for k in LOGGED)))
            print(f"Time: {time.time() - t0:.5f}\n")
            if epoch == 1 and profiler is not None:
                profiler.stop()
                _write_trace(profiler, args.profile_dir, device)
    if writes:
        _save(args, state.models, "model_complete_final.pt")
        save_train_state(os.path.join(args.output_model_dir, "train_state.pt"), state,
                         extra={"epoch": args.epochs})
    return history


def _profiler(device):
    """A ``torch.profiler`` of CPU activity, and CUDA activity on a card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _write_trace(profiler, out_dir: str, device) -> None:
    """Write a stopped ``profiler``'s Chrome trace as
    ``<out_dir>/trace_rank<r>.json``; on a card, raise if it holds no CUDA
    kernel event."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_rank{dp.rank()}.json")
    profiler.export_chrome_trace(path)
    if device.type == "cuda":
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        if not any(e.get("cat") == "kernel" for e in events):
            raise RuntimeError(f"the profiler trace {path} holds no CUDA kernel event")
    print(f"profiler trace written to {out_dir}")


def _save(args, models, name: str) -> None:
    os.makedirs(args.output_model_dir, exist_ok=True)
    save_checkpoint(os.path.join(args.output_model_dir, name), models, vars(args))


if __name__ == "__main__":
    main()
