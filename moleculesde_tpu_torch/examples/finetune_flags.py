"""The flags of the three finetune CLIs and what they share.

The JAX package's finetune CLIs parse one flag surface
(``examples/config.py``); :func:`get_parser` holds the flags that any of
them reads, with the same names and defaults, plus ``--device`` ("cuda":
the CLIs raise without a GPU unless ``--device cpu``).  ``--distributed``,
``--dist_*``, ``--profile_dir`` and ``--debug_nans`` are parsed, as the JAX
finetunes parse them and do nothing with them; each one set prints a line
saying so (:func:`check_supported`).

``--num_devices N`` > 1 runs N data-parallel ranks (``parallel/``, spawned
by :func:`~moleculesde_tpu_torch.parallel.mesh.run_cli`): :func:`make_loader`
then collates the rank's block of every batch (rotations drawn for the
whole batch), the steps average their gradients over the ranks, the
evaluations gather every rank's outputs (:func:`gathered`), so the metrics,
the plateau controller and the best epoch are the whole set's on every
rank, and :func:`writes` gives rank 0 alone the output directory.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from moleculesde_tpu_torch.data.loader import GraphLoader
from moleculesde_tpu_torch.examples import note_inert_flags
from moleculesde_tpu_torch.parallel import collectives as dp


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dataset", type=str, default="QM9",
                   help="'synthetic', or the dataset's directory under --input_data_dir")
    p.add_argument("--task", type=str, default="alpha",
                   help="QM9 target or MD17 molecule")
    p.add_argument("--synthetic_molecules", type=int, default=0,
                   help="number of synthetic molecules (0 -> 256; MD17 128)")
    p.add_argument("--max_molecules", type=int, default=0, help="cap on a dataset (0 -> all)")
    p.add_argument("--input_data_dir", type=str, default="")
    p.add_argument("--input_model_file", type=str, default="",
                   help="pretraining checkpoint whose model_2D / model_3D starts the "
                        "encoder: the port's .pt or the JAX package's .msgpack")
    p.add_argument("--output_model_dir", type=str, default="")
    p.add_argument("--n_max", type=int, default=32,
                   help="padding (0 -> the smallest of 16 / 32 / 64 / 128 that holds "
                        "every molecule)")
    p.add_argument("--e_max_factor", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--MD17_train_batch_size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--decay", type=float, default=0)
    p.add_argument("--print_every_epoch", type=int, default=1)
    p.add_argument("--loss", type=str, default="mae", choices=["mse", "mae"])
    p.add_argument("--lr_scheduler", type=str, default="CosineAnnealingLR")
    p.add_argument("--lr_decay_factor", type=float, default=0.5)
    p.add_argument("--lr_decay_step_size", type=int, default=100)
    p.add_argument("--lr_decay_patience", type=int, default=50)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--StepLRCustomized_scheduler", type=int, nargs="+", default=[150])
    p.add_argument("--split", type=str, default="customized_01",
                   choices=["customized_01", "customized_02", "random"])
    p.add_argument("--use_rotation_transform", dest="use_rotation_transform",
                   action="store_true")
    p.add_argument("--no_rotation_transform", dest="use_rotation_transform",
                   action="store_false")
    p.set_defaults(use_rotation_transform=False)
    p.add_argument("--eval_train", dest="eval_train", action="store_true")
    p.add_argument("--no_eval_train", dest="eval_train", action="store_false")
    p.set_defaults(eval_train=False)
    p.add_argument("--eval_test", dest="eval_test", action="store_true")
    p.add_argument("--no_eval_test", dest="eval_test", action="store_false")
    p.set_defaults(eval_test=True)
    p.add_argument("--MD17_energy_coeff", type=float, default=0.05)
    p.add_argument("--MD17_force_coeff", type=float, default=0.95)
    p.add_argument("--energy_force_with_normalization",
                   dest="energy_force_with_normalization", action="store_true")
    p.add_argument("--energy_force_no_normalization",
                   dest="energy_force_with_normalization", action="store_false")
    p.set_defaults(energy_force_with_normalization=False)
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
    p.add_argument("--graph_pooling", type=str, default="mean")
    p.add_argument("--JK", type=str, default="last")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks spawned here, one a card (0 -> one "
                        "process); --device cpu: gloo ranks on the CPU")
    p.add_argument("--distributed", action="store_true",
                   help="parsed, as the JAX finetunes parse it; no effect")
    p.add_argument("--dist_coordinator", type=str, default="")
    p.add_argument("--dist_num_processes", type=int, default=0)
    p.add_argument("--dist_process_id", type=int, default=-1)
    p.add_argument("--profile_dir", type=str, default="",
                   help="parsed, as the JAX finetunes parse it; no effect")
    p.add_argument("--debug_nans", dest="debug_nans", action="store_true",
                   help="parsed, as the JAX finetunes parse it; no effect")
    p.set_defaults(debug_nans=False)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The parsed flags, printed as the JAX CLIs print them."""
    args = get_parser().parse_args(argv)
    print("arguments\t", args)
    return args


def check_supported(args, *batch_sizes: int) -> None:
    """Note the flags the finetunes parse and ignore, as the JAX finetunes do,
    and refuse batches (``--batch_size`` and ``batch_sizes``) that do not
    split over ``--num_devices`` ranks."""
    note_inert_flags({
        "--distributed": args.distributed,
        "--dist_coordinator": bool(args.dist_coordinator),
        "--dist_num_processes": args.dist_num_processes != 0,
        "--dist_process_id": args.dist_process_id != -1,
        "--profile_dir": bool(args.profile_dir),
        "--debug_nans": args.debug_nans})
    sizes = (args.batch_size,) + batch_sizes
    if args.num_devices > 1 and any(b % args.num_devices for b in sizes):
        raise ValueError(f"the batch sizes {' / '.join(map(str, sizes))} must be divisible by "
                         f"--num_devices={args.num_devices}")


def make_loader(graphs: Sequence[Dict], idx: np.ndarray, args, n_max: int, shuffle: bool,
                batch_size: Optional[int] = None, **labels) -> GraphLoader:
    """The finetune loader over ``graphs[idx]``: shuffled with drop_last for
    training, in order with a padded tail for evaluation, seeded by
    ``--seed``; ``labels`` are :class:`GraphLoader`'s ``num_tasks`` /
    ``with_forces`` / ``rotation_transform``.  Under a data-parallel group
    it collates the rank's block of each batch."""
    group = dp.active()
    return GraphLoader([graphs[i] for i in idx], batch_size=batch_size or args.batch_size,
                       n_max=n_max, e_max=args.e_max_factor * n_max, shuffle=shuffle,
                       drop_last=shuffle, seed=args.seed,
                       block=None if group is None else (group.rank, group.world), **labels)


def gathered(x: torch.Tensor, n_real: int) -> Tuple[torch.Tensor, int]:
    """A per-graph output of one evaluation batch as the whole batch's
    (every rank's block, in order) and the batch's real graphs."""
    return dp.all_gather_rows(x), int(dp.global_sum(torch.tensor(n_real, device=x.device)))


def writes(args) -> str:
    """The output directory on rank 0 ("" on the other ranks)."""
    return args.output_model_dir if dp.rank() == 0 else ""


def graph_mask(num_graphs: int, n_real: int, device) -> torch.Tensor:
    """[B] bool: the batch's real graphs (the first ``n_real``)."""
    return torch.arange(num_graphs, device=device) < n_real


def flush_metrics(logger, pending, echo) -> None:
    """Log each (epoch, {name: scalar tensor on one device}) of ``pending``
    with one device-to-host read for all of them; ``echo(epoch, values)``
    is the console line."""
    names = list(pending[0][1])
    values = torch.stack([torch.stack([m[k].float() for k in names])
                          for _, m in pending]).tolist()
    for (epoch, _), row in zip(pending, values):
        m = dict(zip(names, row))
        logger.log(epoch, m, echo=echo(epoch, m))

