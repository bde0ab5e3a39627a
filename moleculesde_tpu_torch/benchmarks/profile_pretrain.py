"""Where the time of one pretraining step goes, on the GPU.

Runs the step of ``chip_smoke.py``'s training phase (the pretraining CLI's
models at full width: GIN 5 x 300, SchNet 6 x 128 filters, SDEModel2Dto3D
variant 1 and SDEModel3Dto2D variant 1 with VE, InfoNCE, bf16 training
precision; B=128 synthetic molecules of 4-32 atoms, n_max 32, padded
ingest; random weights from seed 42).  Any pretraining-CLI flags given
after the script's name override those, for example the JAX CLI's
defaults with K5 (``--ingest compact --schnet_cfconv pallas_rbf``), a
microbatched step (``--batch_size 256 --microbatch 128 --microbatch_scope
score``) or PaiNN (``--model_3d PaiNN``).

First the host's share: the collation time per batch of the padded and of
the compact ingest (the same molecules, median over the epoch's batches)
and the host-side graph extension per molecule, which only the padded path
needs; the compact batch's expansion on the device (CUDA events).  Then
two steps warm up, three are timed without the profiler and one runs under
``torch.profiler`` (CPU and CUDA activities).  Prints the step wall time,
the device-busy time (sum of kernel times, one stream), the device's idle
share, the kernel launches per step and the operators that take the most
device time; writes the full table to ``chiprun_out/profile_pretrain.txt``.

    python -m moleculesde_tpu_torch.benchmarks.profile_pretrain [CLI flags]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from moleculesde_tpu_torch.data.compact import expand_on_device
from moleculesde_tpu_torch.data.extend import extend_graph
from moleculesde_tpu_torch.examples import pretrain as cli
from moleculesde_tpu_torch.pretrain.train_step import pretrain_step

# the measured path (also chip_smoke.py's): the CLI's defaults at B=128,
# n_max 32, padded ingest; enough molecules for WARMUP + TIMED + 1 full
# batches at any --batch_size
BATCH, WARMUP, TIMED = 128, 2, 3
COMMON_ARGS = ["--dataset", "synthetic", "--seed", "42", "--batch_size", str(BATCH),
               "--n_max", "32", "--epochs", "1"]
PATH_ARGS = COMMON_ARGS + ["--ingest", "padded"]
# the JAX CLI's defaults (compact ingest) with K5
COMPACT_ARGS = COMMON_ARGS + ["--schnet_cfconv", "pallas_rbf"]


def parse_path(argv, batches: int = WARMUP + TIMED + 1):
    """The CLI's arguments for ``argv`` (one of the lists above, flags
    appended), with molecules for ``batches`` full batches."""
    args = cli.get_parser().parse_args(argv)
    cli.check_supported(args)
    args.synthetic_molecules = max(args.synthetic_molecules, args.batch_size * batches)
    return args


def path_batches(args, device):
    """The path's batches (padded or compact, as ``--ingest`` says),
    collated on the host and moved to ``device``."""
    return [b.to(device) for b, _ in cli.make_loader(cli.load_graphs(args), args)]


def host_ingest(args) -> dict:
    """Host milliseconds per batch to collate the same molecules padded and
    compact (median over one epoch's batches), and per molecule to build
    the extended graph on the host (the padded path's load-time work)."""
    out = {}
    for ingest in ("padded", "compact"):
        a = argparse.Namespace(**{**vars(args), "ingest": ingest, "num_workers": 0})
        loader = cli.make_loader(cli.load_graphs(a), a)
        times = []
        for idx in loader.epoch_indices():
            t0 = time.perf_counter()
            loader.collate_indices(idx)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"collate_ms_per_batch_{ingest}"] = statistics.median(times)
    graphs = cli.load_graphs(args)[:256]
    t0 = time.perf_counter()
    for g in graphs:
        extend_graph(g["atom_feats"].shape[0], g["edge_index"], g["edge_feats"])
    out["host_extend_ms_per_molecule"] = (time.perf_counter() - t0) * 1e3 / len(graphs)
    return out


def expand_ms(batch) -> float:
    """Device milliseconds of one ``expand_on_device`` (CUDA-event median of
    20 after 3)."""
    for _ in range(3):
        expand_on_device(batch)
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        expand_on_device(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None, out_dir: str = "chiprun_out") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_pretrain: needs a CUDA device")
    dev = torch.device("cuda")
    args = parse_path(PATH_ARGS + list(sys.argv[1:] if argv is None else argv))
    host = host_ingest(args)
    print(json.dumps({"host_ingest": host}), flush=True)
    batches = path_batches(args, dev)
    if args.ingest == "compact":
        host["expand_on_device_ms"] = expand_ms(batches[0])
    cfg, models, optimizer, gen = cli.setup(args, dev)

    def step(batch):
        metrics = pretrain_step(models, optimizer, cfg, batch, gen)
        torch.cuda.synchronize()
        return metrics

    for batch in batches[:WARMUP]:   # kernel builds, cuBLAS handles, allocator
        step(batch)
    wall = []
    for batch in batches[WARMUP:WARMUP + TIMED]:
        t0 = time.perf_counter()
        step(batch)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step(batches[WARMUP + TIMED])
        wall_prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=50)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_pretrain.txt"), "w") as fh:
        fh.write(table)
    top = sorted(prof.key_averages(), key=lambda a: a.self_device_time_total,
                 reverse=True)[:15]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "flags": sys.argv[1:] if argv is None else list(argv),
        "batch": args.batch_size,
        "ingest": args.ingest,
        "host_ingest": host,
        "step_wall_ms": wall,
        "step_wall_ms_median": statistics.median(wall),
        "molecules_per_s": args.batch_size / statistics.median(wall) * 1e3,
        "step_wall_ms_profiled": wall_prof_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_prof_ms if kernels else None,
        "device_events": len(kernels),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "top_ops_by_device_ms": [
            {"op": a.key, "device_ms": a.self_device_time_total / 1e3,
             "calls": a.count} for a in top],
    }
    print(table)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
