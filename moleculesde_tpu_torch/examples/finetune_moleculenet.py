"""MoleculeNet 2D classification finetuning CLI.

Counterpart of ``examples/finetune_moleculenet.py`` of the JAX package
(reference examples/finetune_MoleculeNet.py): a 2D encoder (``--gnn_type``
GIN, GCN, GAT or GraphSAGE, ``--JK`` any mode) + pooling + a linear head
per task, trained with the masked BCE over {-1, 0, +1} labels; the mean
per-task ROC-AUC (tasks lacking a class skipped) on the validation set
picks the best epoch.  ``--dataset synthetic`` trains on 3-task synthetic
molecules with a random 80 / 10 / 10 split; a MoleculeNet name reads
``<input_data_dir>/<dataset>/raw/<dataset>.csv[.gz]`` (RDKit needed),
drops the SMILES RDKit cannot parse, caps the set at ``--max_molecules``
and splits it by scaffold 80 / 10 / 10.  ``--input_model_file`` starts the
encoder from a pretraining checkpoint's ``model_2D`` (the port's ``.pt`` or a
JAX ``.msgpack``; parameters only, as JAX).  Like the JAX CLI it draws one
training batch before the first epoch (JAX initializes its state from it),
so epoch 1 sees the shuffle's second order, as in JAX.

Prints the JAX CLI's lines ("train: .. val: .. test: .." per epoch, "best
train: .. val: .. test: .."), and with ``--output_model_dir`` writes
``metrics.csv``, ``model_complete.pt`` (the best epoch's model, component
"model"), ``model_complete_final.pt`` and ``evaluation_best.npz`` (the best
model's test labels and scores).  On the GPU (the default) GIN's message
blocks run the K1 kernel (the other encoders launch none); ``--device cpu`` runs the plain PyTorch path.
``--num_devices N`` > 1 trains on N data-parallel ranks (``--batch_size``
divisible by N, as in JAX; see ``finetune_flags.py``).

Example:
  python -m moleculesde_tpu_torch.examples.finetune_moleculenet \\
      --dataset synthetic --epochs 2 --output_model_dir out/mnet
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from moleculesde_tpu_torch.convert import load_pretrained_component, save_checkpoint
from moleculesde_tpu_torch.data.datasets import MOLECULENET_NUM_TASKS, load_moleculenet
from moleculesde_tpu_torch.data.loader import device_prefetch, suggest_buckets
from moleculesde_tpu_torch.data.splitters import random_split, scaffold_split
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.examples.finetune_flags import (
    check_supported, flush_metrics, gathered, graph_mask, make_loader, parse_args, writes)
from moleculesde_tpu_torch.finetune.classification import (
    classification_eval, classification_step)
from moleculesde_tpu_torch.finetune.common import BestTracker, make_optimizer, snapshot
from moleculesde_tpu_torch.models.gnn2d import GNNGraphPred
from moleculesde_tpu_torch.parallel.mesh import run_cli
from moleculesde_tpu_torch.utils.metrics import MetricsLogger, roc_auc_mean
from moleculesde_tpu_torch.utils.schedulers import make_lr_schedule

SYNTHETIC_TASKS = 3


def load_data(args):
    """(graphs with labels, number of tasks, (train, valid, test) indices)."""
    if args.dataset == "synthetic":
        rng = np.random.default_rng(args.seed)
        graphs = []
        for _ in range(args.synthetic_molecules or 256):
            g = random_molecule(rng, int(rng.integers(4, args.n_max + 1)), extend=False)
            g["y"] = rng.choice([-1.0, 1.0], size=(SYNTHETIC_TASKS,))
            graphs.append(g)
        return graphs, SYNTHETIC_TASKS, random_split(len(graphs), seed=args.seed)
    if args.dataset not in MOLECULENET_NUM_TASKS:
        raise ValueError(f"--dataset={args.dataset} is not a MoleculeNet dataset "
                         f"({sorted(MOLECULENET_NUM_TASKS)}) or synthetic")
    csv_path = os.path.join(args.input_data_dir, args.dataset, "raw", f"{args.dataset}.csv")
    if not os.path.exists(csv_path):
        csv_path += ".gz"
    graphs, smiles = load_moleculenet(args.dataset, csv_path)
    if args.max_molecules:   # before the split, so the scaffolds are the subset's
        graphs, smiles = graphs[:args.max_molecules], smiles[:args.max_molecules]
    return graphs, MOLECULENET_NUM_TASKS[args.dataset], scaffold_split(smiles)


def build_model(args, num_tasks: int, device, msg_impl: str = "auto") -> GNNGraphPred:
    """The finetune model, weights from ``--seed`` (then ``model_2D`` of
    ``--input_model_file`` into its encoder)."""
    model = GNNGraphPred(num_tasks, args.num_layer, args.emb_dim, args.JK, args.dropout_ratio,
                         args.gnn_type, args.graph_pooling, msg_impl=msg_impl, device=device,
                         generator=torch.Generator().manual_seed(args.seed))
    if args.input_model_file:
        load_pretrained_component(model.gnn, args.input_model_file, "model_2D")
        print(f"loaded pretrained model_2D from {args.input_model_file}")
    return model


def train_epoch(model, optimizer, loader, device, schedule, step: int, generator):
    """One epoch of steps; returns (mean loss, a device scalar; the next
    step's index)."""
    total, n = torch.zeros((), device=device), 0
    for batch, n_real in device_prefetch(loader, device):
        gm = graph_mask(batch.num_graphs, n_real, device)
        total = total + classification_step(model, optimizer, batch, gm, schedule(step),
                                            generator)
        step, n = step + 1, n + 1
    return total / max(n, 1), step


def evaluate(model, loader, device, collect: bool = False):
    """(mean ROC-AUC, valid tasks) on the device; with ``collect`` also the
    labels [M, T] (padded graphs' rows 0), the logits and the real-row mask.
    An empty set has no valid task (AUC 0), where the JAX CLI fails on it."""
    ys = [torch.zeros((0, loader.num_tasks), device=device)]
    scores, gms = list(ys), [torch.zeros(0, dtype=torch.bool, device=device)]
    for batch, n_real in device_prefetch(loader, device):
        gm = graph_mask(batch.num_graphs, n_real, device)
        scores.append(gathered(classification_eval(model, batch), n_real)[0])
        ys.append(gathered(torch.where(gm[:, None], batch.y, 0.0), n_real)[0])
        gms.append(gathered(gm, n_real)[0])
    y, s = torch.cat(ys), torch.cat(scores)
    auc, n_ok = roc_auc_mean(y, s)
    return (auc, n_ok, y, s, torch.cat(gms)) if collect else (auc, n_ok)


def main(argv=None):
    args = parse_args(argv)
    check_supported(args)
    return run_cli(run, args, args.num_devices)


def run(args, device):
    """Finetune as the flags say on ``device``, as one rank of the active
    data-parallel group or as the only process; returns (best val AUC, its
    test AUC)."""
    graphs, num_tasks, (train_idx, valid_idx, test_idx) = load_data(args)
    n_max = args.n_max or suggest_buckets(graphs)
    train_loader = make_loader(graphs, train_idx, args, n_max, True, num_tasks=num_tasks)
    val_loader = make_loader(graphs, valid_idx, args, n_max, False, num_tasks=num_tasks)
    test_loader = make_loader(graphs, test_idx, args, n_max, False, num_tasks=num_tasks)

    model = build_model(args, num_tasks, device)
    next(iter(train_loader))   # JAX's init batch: advances the shuffle as JAX does
    schedule = make_lr_schedule(
        args.lr_scheduler, args.lr, args.epochs, max(len(train_loader), 1),
        args.lr_decay_factor, args.lr_decay_step_size, args.min_lr,
        args.StepLRCustomized_scheduler)
    optimizer = make_optimizer(model, args.lr, args.decay)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    out_dir = writes(args)
    logger = MetricsLogger(out_dir or None)
    zero = torch.zeros((), device=device)
    # JAX's tracker starts from the initial state, so --epochs 0 still reports
    tracker = BestTracker("max", payload=(snapshot(model), zero, zero))
    val_ok, pending, step = num_tasks, [], 0
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        train_loss, step = train_epoch(model, optimizer, train_loader, device, schedule, step,
                                       generator)
        train_auc = evaluate(model, make_loader(graphs, train_idx, args, n_max, False,
                                                num_tasks=num_tasks), device)[0] \
            if args.eval_train else zero
        val_auc, val_ok = evaluate(model, val_loader, device)
        test_auc = evaluate(model, test_loader, device)[0] if args.eval_test else zero
        tracker.update(val_auc.item(), lambda: (snapshot(model), train_auc, test_auc))
        pending.append((epoch, {"loss": train_loss, "train_auc": train_auc,
                                "val_auc": val_auc, "test_auc": test_auc}))
        if epoch % max(args.print_every_epoch, 1) == 0 or epoch == args.epochs:
            flush_metrics(logger, pending, lambda ep, m: f"train: {m['train_auc']:.6f}\t"
                          f"val: {m['val_auc']:.6f}\ttest: {m['test_auc']:.6f}")
            pending = []
        print(f"Took\t{time.time() - t0}\n")

    best_state, best_train, best_test = tracker.payload
    val_ok = int(val_ok)
    if val_ok < num_tasks:
        print(f"Some target is missing! Missing ratio: {1 - val_ok / num_tasks}")
    print(f"best train: {float(best_train):.6f}\tval: {tracker.best:.6f}\t"
          f"test: {float(best_test):.6f} (epoch {tracker.best_epoch})")
    if args.output_model_dir:   # every rank: the evaluation gathers
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            save_checkpoint(os.path.join(out_dir, "model_complete_final.pt"),
                            {"model": model}, vars(args))
        model.load_state_dict(best_state)
        # the best epoch's predictions (the reference's evaluation_best.pth)
        _, _, y, s, real = evaluate(model, test_loader, device, collect=True)
        if out_dir:
            save_checkpoint(os.path.join(out_dir, "model_complete.pt"), {"model": model},
                            vars(args))
            np.savez(os.path.join(out_dir, "evaluation_best.npz"),
                     test_true=y[real].cpu().numpy(), test_scores=s[real].cpu().numpy())
    return tracker.best, float(best_test)


if __name__ == "__main__":
    main()
