"""Where the time of one pretraining step goes, on the GPU.

Runs the step of ``chip_smoke.py``'s training phase (the pretraining CLI's
models at full width: GIN 5 x 300, SchNet 6 x 128 filters, SDEModel2Dto3D
variant 1 and SDEModel3Dto2D variant 1 with VE, InfoNCE, bf16 training
precision; B=128 synthetic molecules of 4-32 atoms, n_max 32, padded
ingest; random weights from seed 42).  Two steps warm up, then three are
timed without the profiler and one runs under ``torch.profiler`` (CPU and
CUDA activities).  Prints the step wall time, the device-busy time (sum of
kernel times, one stream), the device's idle share, the kernel launches
per step and the operators that take the most device time; writes the full
table to ``chiprun_out/profile_pretrain.txt``.

    python -m moleculesde_tpu_torch.benchmarks.profile_pretrain
"""

from __future__ import annotations

import json
import os
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from moleculesde_tpu_torch.examples import pretrain as cli
from moleculesde_tpu_torch.pretrain.train_step import pretrain_step

# the measured path (also chip_smoke.py's): the CLI's defaults at B=128,
# n_max 32; enough molecules for WARMUP + TIMED + 1 full batches
BATCH, WARMUP, TIMED = 128, 2, 3
PATH_ARGS = ["--dataset", "synthetic", "--seed", "42", "--ingest", "padded",
             "--synthetic_molecules", str(BATCH * (WARMUP + TIMED + 1)),
             "--batch_size", str(BATCH), "--n_max", "32", "--epochs", "1"]


def path_batches(args, device):
    """The path's batches, collated on the host and moved to ``device``."""
    return [b.to(device) for b, _ in cli.make_loader(cli.load_graphs(args), args)]


def main(out_dir: str = "chiprun_out") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_pretrain: needs a CUDA device")
    dev = torch.device("cuda")
    args = cli.get_parser().parse_args(PATH_ARGS)
    cli.check_supported(args)
    batches = path_batches(args, dev)
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
        "batch": BATCH,
        "step_wall_ms": wall,
        "step_wall_ms_median": statistics.median(wall),
        "molecules_per_s": BATCH / statistics.median(wall) * 1e3,
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
