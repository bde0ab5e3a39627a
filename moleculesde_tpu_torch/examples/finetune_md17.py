"""MD17 energy and force finetuning CLI.

Counterpart of ``examples/finetune_md17.py`` of the JAX package (reference
examples/finetune_MD17.py): the energy from SchNet (eager CFConv: the force
path needs the gradient to positions, which the CFConv kernels do not
give) or PaiNN with a head, the forces ``-dE/dpos``, the loss
``MD17_energy_coeff * L1(E) + MD17_force_coeff * L1(F)``, a shuffled 1000 /
1000 / rest frame split (60 / 20 / 20 below 2000 frames), and optionally
energies and forces normalized by the training frames
(``--energy_force_with_normalization``).  The best epoch is the one with
the lowest ``MD17_energy_coeff * val E MAE + MD17_force_coeff * val F MAE``.
``--dataset synthetic`` trains on synthetic 8-atom frames with random
forces; otherwise the CLI reads ``<input_data_dir>/MD17/raw/<task>_dft.npz``
and trains at ``--MD17_train_batch_size``.  ``--input_model_file`` starts
the encoder from a pretraining checkpoint's ``model_3D``.  Like the JAX CLI
it draws one training batch before the first epoch, so epoch 1 sees the
shuffle's second order, as in JAX.

Prints the JAX CLI's lines (per epoch "Epoch .. Loss .. val E MAE .. val F
MAE .. test E MAE .. test F MAE", then "best test E MAE: .. F MAE: .."),
and with ``--output_model_dir`` writes ``metrics.csv``,
``model_complete.pt`` and ``model_complete_final.pt``.  No kernel runs on
this path.  ``--num_devices N`` > 1 trains on N data-parallel ranks (the
training and evaluation batch sizes divisible by N, as in JAX; see
``finetune_flags.py``).

Example:
  python -m moleculesde_tpu_torch.examples.finetune_md17 --dataset synthetic \\
      --epochs 2 --batch_size 16 --output_model_dir out/md17
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from moleculesde_tpu_torch.convert import save_checkpoint
from moleculesde_tpu_torch.data.datasets import load_md17
from moleculesde_tpu_torch.data.loader import device_prefetch, suggest_buckets
from moleculesde_tpu_torch.data.splitters import md17_split
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.examples.finetune_flags import (
    check_supported, flush_metrics, graph_mask, make_loader, parse_args, writes)
from moleculesde_tpu_torch.examples.finetune_qm9 import build_model as build_qm9_model
from moleculesde_tpu_torch.finetune.common import BestTracker, make_optimizer, snapshot
from moleculesde_tpu_torch.finetune.md17 import md17_eval, md17_step
from moleculesde_tpu_torch.finetune.regression import RegressionModel
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.parallel.mesh import run_cli
from moleculesde_tpu_torch.utils.metrics import MetricsLogger
from moleculesde_tpu_torch.utils.schedulers import make_lr_schedule


def load_data(args):
    """Frames as graph dicts with ``y`` (energy) and ``forces``."""
    if args.dataset == "synthetic":
        rng = np.random.default_rng(args.seed)
        graphs = []
        for _ in range(args.synthetic_molecules or 128):
            g = random_molecule(rng, 8, extend=False)
            g["y"] = np.array([np.abs(g["positions"]).sum()], dtype=np.float32)
            g["forces"] = rng.normal(size=g["positions"].shape).astype(np.float32)
            graphs.append(g)
        return graphs
    graphs, _ = load_md17(os.path.join(args.input_data_dir, "MD17", "raw",
                                       f"{args.task}_dft.npz"))
    return graphs[:args.max_molecules] if args.max_molecules else graphs


def build_model(args, device) -> RegressionModel:
    """QM9's model with SchNet's eager CFConv (the forces differentiate
    positions)."""
    return build_qm9_model(args, device, cfconv="xla")


def train_epoch(model, optimizer, loader, device, schedule, step: int, e_shift: float,
                e_scale: float, args):
    """One epoch of steps; returns (mean loss, a device scalar; the next
    step's index)."""
    total, n = torch.zeros((), device=device), 0
    for batch, n_real in device_prefetch(loader, device):
        gm = graph_mask(batch.num_graphs, n_real, device)
        y_e = (batch.y[:, 0] - e_shift) / e_scale
        y_f = batch.forces / e_scale
        metrics = md17_step(model, optimizer, batch, y_e, y_f, gm, schedule(step),
                            args.MD17_energy_coeff, args.MD17_force_coeff)
        total = total + metrics["loss"]
        step, n = step + 1, n + 1
    return total / max(n, 1), step


def evaluate(model, loader, device, e_shift: float, e_scale: float):
    """(energy MAE, force MAE) on the raw scale over the real frames and
    atoms (device scalars), every rank's under a data-parallel group; NaN
    force labels count as no error (reference finetune_MD17.py:127-130)."""
    acc = [torch.zeros((), device=device) for _ in range(4)]
    for batch, n_real in device_prefetch(loader, device):
        gm = graph_mask(batch.num_graphs, n_real, device).float()
        pred_e, pred_f = md17_eval(model, batch, e_scale, e_shift)
        b, n = batch.num_graphs, batch.n_max
        nm = batch.node_mask.reshape(b, n).float() * gm[:, None]
        ferr = torch.nan_to_num((pred_f - batch.forces).abs().reshape(b, n, 3), nan=0.0)
        vals = ((pred_e - batch.y[:, 0]).abs() * gm).sum(), gm.sum(), \
            (ferr * nm[..., None]).sum(), nm.sum() * 3
        acc = [a + v for a, v in zip(acc, vals)]
    acc = [dp.global_sum(a) for a in acc]
    return acc[0] / acc[1].clamp(min=1.0), acc[2] / acc[3].clamp(min=1.0)


def train_batch_size(args) -> int:
    """``--MD17_train_batch_size`` on the real data, ``--batch_size`` on
    synthetic frames."""
    return max(args.MD17_train_batch_size if args.dataset != "synthetic" else args.batch_size,
               1)


def main(argv=None):
    args = parse_args(argv)
    check_supported(args, train_batch_size(args))
    return run_cli(run, args, args.num_devices)


def run(args, device):
    """Finetune as the flags say on ``device``, as one rank of the active
    data-parallel group or as the only process; returns the best epoch's
    test (E MAE, F MAE)."""
    graphs = load_data(args)
    train_idx, valid_idx, test_idx = md17_split(len(graphs), seed=args.seed)
    n_max = args.n_max or suggest_buckets(graphs)
    bs = train_batch_size(args)
    train_loader = make_loader(graphs, train_idx, args, n_max, True, batch_size=bs,
                               num_tasks=1, with_forces=True)
    val_loader = make_loader(graphs, valid_idx, args, n_max, False, num_tasks=1,
                             with_forces=True)
    test_loader = make_loader(graphs, test_idx, args, n_max, False, num_tasks=1,
                              with_forces=True)

    # optional normalization by the training frames (ref finetune_MD17.py:218-232)
    e_shift, e_scale = 0.0, 1.0
    if args.energy_force_with_normalization:
        e_shift = float(np.array([graphs[i]["y"][0] for i in train_idx]).mean())
        e_scale = float(np.abs(np.concatenate([graphs[i]["forces"] for i in train_idx])).mean()
                        + 1e-12)

    model = build_model(args, device)
    next(iter(train_loader))   # JAX's init batch: advances the shuffle as JAX does
    schedule = make_lr_schedule(
        args.lr_scheduler, args.lr, args.epochs, max(len(train_loader), 1),
        args.lr_decay_factor, args.lr_decay_step_size, args.min_lr,
        args.StepLRCustomized_scheduler)
    optimizer = make_optimizer(model, args.lr, args.decay)
    out_dir = writes(args)
    logger = MetricsLogger(out_dir or None)
    zero = torch.zeros((), device=device)
    tracker = BestTracker("min")
    pending, step = [], 0
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        train_loss, step = train_epoch(model, optimizer, train_loader, device, schedule, step,
                                       e_shift, e_scale, args)
        val_e, val_f = evaluate(model, val_loader, device, e_shift, e_scale)
        test_e, test_f = evaluate(model, test_loader, device, e_shift, e_scale) \
            if args.eval_test else (zero, zero)
        score = args.MD17_energy_coeff * val_e + args.MD17_force_coeff * val_f
        tracker.update(score.item(), lambda: (snapshot(model), test_e, test_f))
        pending.append((epoch, {"loss": train_loss, "val_energy_mae": val_e,
                                "val_force_mae": val_f, "test_energy_mae": test_e,
                                "test_force_mae": test_f}))
        if epoch % max(args.print_every_epoch, 1) == 0 or epoch == args.epochs:
            flush_metrics(logger, pending, lambda ep, m: (
                f"Epoch: {ep}\tLoss: {m['loss']:.5f}\t"
                f"val E MAE: {m['val_energy_mae']:.5f}\tval F MAE: {m['val_force_mae']:.5f}\t"
                f"test E MAE: {m['test_energy_mae']:.5f}\t"
                f"test F MAE: {m['test_force_mae']:.5f}"))
            pending = []
        print(f"Took\t{time.time() - t0}\n")

    if tracker.payload is None:
        raise ValueError("no epoch was run (--epochs 0): there is no best model")
    best_state, best_e, best_f = tracker.payload
    best = (float(best_e), float(best_f))
    print(f"best test E MAE: {best[0]:.6f}\tF MAE: {best[1]:.6f} (epoch {tracker.best_epoch})")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        save_checkpoint(os.path.join(out_dir, "model_complete_final.pt"),
                        {"model": model}, vars(args))
        model.load_state_dict(best_state)
        save_checkpoint(os.path.join(out_dir, "model_complete.pt"),
                        {"model": model}, vars(args))
    return best


if __name__ == "__main__":
    main()
