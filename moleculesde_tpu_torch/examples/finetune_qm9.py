"""QM9 3D regression finetuning CLI.

Counterpart of ``examples/finetune_qm9.py`` of the JAX package (reference
examples/finetune_QM9.py): SchNet (linear head) or PaiNN (MLP head) on one
target, z-scored by the training set's mean and standard deviation, L1 or
L2 loss, the validation MAE (after the z-score is undone) picks the best
epoch.  ``--dataset synthetic`` regresses a geometric statistic of
synthetic molecules; ``--dataset QM9`` reads the raw gdb9 files under
``<input_data_dir>/QM9/raw/`` (RDKit needed) and takes target ``--task``.
Splits: ``--split customized_01`` / ``customized_02`` (the fixed QM9
permutation splits) or ``random`` 80 / 10 / 10.  ``--use_rotation_transform``
rotates training molecules at random; ``--lr_scheduler ReduceLROnPlateau``
lowers the learning rate per epoch on the validation MAE.
``--input_model_file`` starts the encoder from a pretraining checkpoint's
``model_3D`` (the port's ``.pt`` or a JAX ``.msgpack``).  Like the JAX CLI
it draws one training batch before the first epoch, so epoch 1 sees the
shuffle's second order, as in JAX.

Prints the JAX CLI's lines ("Train mean / std", "Epoch / Loss / val ..
test .." per epoch, "best val: .. test: .."), and with
``--output_model_dir`` writes ``metrics.csv``, ``model_complete.pt`` (the
best epoch's model), ``model_complete_final.pt`` and
``evaluation_best.npz``.  On the GPU (the default) SchNet's CFConv runs the
K2 kernel; PaiNN runs eager; ``--device cpu`` runs the plain PyTorch path.
``--num_devices N`` > 1 trains on N data-parallel ranks (``--batch_size``
divisible by N, as in JAX; see ``finetune_flags.py``).

Example:
  python -m moleculesde_tpu_torch.examples.finetune_qm9 --dataset synthetic \\
      --split random --epochs 2 --output_model_dir out/qm9
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from moleculesde_tpu_torch.convert import load_pretrained_component, save_checkpoint
from moleculesde_tpu_torch.data.datasets import QM9_TARGET_FIELD, load_qm9
from moleculesde_tpu_torch.data.loader import device_prefetch, suggest_buckets
from moleculesde_tpu_torch.data.splitters import (
    qm9_random_customized_01, qm9_random_customized_02, random_split)
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.examples.finetune_flags import (
    check_supported, flush_metrics, gathered, graph_mask, make_loader, parse_args, writes)
from moleculesde_tpu_torch.finetune.common import BestTracker, make_optimizer, snapshot
from moleculesde_tpu_torch.finetune.regression import (
    RegressionModel, regression_eval, regression_step)
from moleculesde_tpu_torch.models.painn import PaiNN
from moleculesde_tpu_torch.models.schnet import SchNet
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.parallel.mesh import run_cli
from moleculesde_tpu_torch.utils.metrics import MetricsLogger
from moleculesde_tpu_torch.utils.schedulers import PlateauController, make_lr_schedule


def build_model(args, device, cfconv: str = "auto", impl: str = "auto") -> RegressionModel:
    """SchNet + linear head or PaiNN + MLP head at the flags' widths
    (hidden ``--emb_dim``), weights from ``--seed`` (then ``model_3D`` of
    ``--input_model_file`` into the encoder).  ``cfconv`` / ``impl`` are
    SchNet's (``models/schnet.py``)."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.model_3d == "SchNet":
        encoder, head = SchNet(
            hidden_channels=args.emb_dim, num_filters=args.SchNet_num_filters,
            num_interactions=args.SchNet_num_interactions,
            num_gaussians=args.SchNet_num_gaussians, cutoff=args.SchNet_cutoff,
            readout=args.SchNet_readout, cfconv=cfconv, impl=impl, device=device,
            generator=gen), "linear"
    else:
        encoder, head = PaiNN(
            n_atom_basis=args.emb_dim, n_interactions=args.PaiNN_n_interactions,
            n_rbf=args.PaiNN_n_rbf, cutoff=args.PaiNN_radius_cutoff,
            readout=args.PaiNN_readout, device=device, generator=gen), "mlp"
    model = RegressionModel(encoder, head, generator=gen)
    if args.input_model_file:
        load_pretrained_component(model.encoder, args.input_model_file, "model_3D")
        print(f"loaded pretrained model_3D from {args.input_model_file}")
    return model


def load_data(args):
    """Graph dicts with one target each as ``y``."""
    if args.dataset == "synthetic":
        rng = np.random.default_rng(args.seed)
        graphs = []
        for _ in range(args.synthetic_molecules or 256):
            g = random_molecule(rng, int(rng.integers(4, args.n_max + 1)), extend=False)
            g["y"] = np.array([np.abs(g["positions"]).sum()], dtype=np.float32)
            graphs.append(g)
    else:
        graphs, _ = load_qm9(os.path.join(args.input_data_dir, args.dataset), extend=False)
        task_idx = QM9_TARGET_FIELD.index(args.task)
        for g in graphs:
            g["y"] = g["y"][task_idx:task_idx + 1]
    if args.max_molecules:
        graphs = graphs[:args.max_molecules]
    return graphs


def split(args, n: int):
    if args.split == "customized_01":
        return qm9_random_customized_01(n, seed=args.seed)
    if args.split == "customized_02":
        return qm9_random_customized_02(n, seed=args.seed)
    return random_split(n, seed=args.seed)


def train_epoch(model, optimizer, loader, device, lr_of_step, step: int, y_mean: float,
                y_std: float, loss_type: str):
    """One epoch of steps on z-scored targets; returns (mean loss, a device
    scalar; the next step's index)."""
    total, n = torch.zeros((), device=device), 0
    for batch, n_real in device_prefetch(loader, device):
        gm = graph_mask(batch.num_graphs, n_real, device)
        y_norm = (batch.y[:, 0] - y_mean) / y_std
        total = total + regression_step(model, optimizer, batch, y_norm, gm, lr_of_step(step),
                                        loss_type)
        step, n = step + 1, n + 1
    return total / max(n, 1), step


def evaluate(model, loader, device, y_mean: float, y_std: float) -> torch.Tensor:
    """The MAE on the raw scale over the loader's real graphs (device
    scalar), every rank's under a data-parallel group."""
    err, count = torch.zeros((), device=device), torch.zeros((), device=device)
    for batch, n_real in device_prefetch(loader, device):
        gm = graph_mask(batch.num_graphs, n_real, device).float()
        pred = regression_eval(model, batch) * y_std + y_mean
        err = err + ((pred - batch.y[:, 0]).abs() * gm).sum()
        count = count + gm.sum()
    return dp.global_sum(err) / dp.global_sum(count).clamp(min=1.0)


def main(argv=None):
    args = parse_args(argv)
    check_supported(args)
    return run_cli(run, args, args.num_devices)


def run(args, device):
    """Finetune as the flags say on ``device``, as one rank of the active
    data-parallel group or as the only process; returns (best val MAE, its
    test MAE)."""
    graphs = load_data(args)
    train_idx, valid_idx, test_idx = split(args, len(graphs))
    n_max = args.n_max or suggest_buckets(graphs)
    train_loader = make_loader(graphs, train_idx, args, n_max, True, num_tasks=1,
                               rotation_transform=args.use_rotation_transform)
    val_loader = make_loader(graphs, valid_idx, args, n_max, False, num_tasks=1)
    test_loader = make_loader(graphs, test_idx, args, n_max, False, num_tasks=1)

    # z-score by the training set (reference finetune_QM9.py:160-166)
    train_y = np.array([graphs[i]["y"][0] for i in train_idx], dtype=np.float64)
    y_mean, y_std = float(train_y.mean()), float(train_y.std() + 1e-12)
    print(f"Train mean: {y_mean}\tTrain std: {y_std}")

    model = build_model(args, device)
    next(iter(train_loader))   # JAX's init batch: advances the shuffle as JAX does
    plateau = None
    if args.lr_scheduler == "ReduceLROnPlateau":
        plateau = PlateauController(args.lr, args.lr_decay_factor, args.lr_decay_patience,
                                    args.min_lr)
        lr_of_step = lambda step: plateau.lr  # noqa: E731
    else:
        lr_of_step = make_lr_schedule(
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
        train_loss, step = train_epoch(model, optimizer, train_loader, device, lr_of_step, step,
                                       y_mean, y_std, args.loss)
        val_mae = evaluate(model, val_loader, device, y_mean, y_std)
        test_mae = evaluate(model, test_loader, device, y_mean, y_std) if args.eval_test \
            else zero
        val = val_mae.item()
        if plateau is not None:
            plateau.update(val)
        tracker.update(val, lambda: (snapshot(model), test_mae))
        pending.append((epoch, {"loss": train_loss, "val_mae": val_mae, "test_mae": test_mae}))
        if epoch % max(args.print_every_epoch, 1) == 0 or epoch == args.epochs:
            flush_metrics(logger, pending, lambda ep, m: f"Epoch: {ep}\nLoss: {m['loss']}\n"
                          f"val: {m['val_mae']:.6f}\ttest: {m['test_mae']:.6f}")
            pending = []
        print(f"Took\t{time.time() - t0}\n")

    if tracker.payload is None:
        raise ValueError("no epoch was run (--epochs 0): there is no best model")
    best_state, best_test = tracker.payload
    print(f"best val: {tracker.best:.6f}\ttest: {float(best_test):.6f} "
          f"(epoch {tracker.best_epoch})")
    if args.output_model_dir:   # every rank: the predictions are gathered
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            save_checkpoint(os.path.join(out_dir, "model_complete_final.pt"),
                            {"model": model}, vars(args))
        model.load_state_dict(best_state)
        # the best epoch's test predictions (the reference's evaluation_best.pth)
        preds, trues = [], []
        for batch, n_real in device_prefetch(test_loader, device):
            pred, n = gathered(regression_eval(model, batch) * y_std + y_mean, n_real)
            preds.append(pred[:n].cpu())
            trues.append(gathered(batch.y[:, 0], n_real)[0][:n].cpu())
        if out_dir:
            save_checkpoint(os.path.join(out_dir, "model_complete.pt"), {"model": model},
                            vars(args))
            if preds:
                np.savez(os.path.join(out_dir, "evaluation_best.npz"),
                         test_pred=torch.cat(preds).numpy(),
                         test_true=torch.cat(trues).numpy())
    return tracker.best, float(best_test)


if __name__ == "__main__":
    main()
