"""Where the time of one 2D->3D conformer-generation chain goes, on the GPU.

Runs the chain of ``chip_smoke.py``'s path phase (the sampler CLI's models at
full width: GIN 5 x 300, SDEModel2Dto3D variant 1, VE, hidden 32, bf16 score;
8 synthetic molecules x 8 repeats, n_max 32; 20 PC steps x 1 corrector step,
random weights from seed 42) in two configurations: the channel-major
score path (the CLI's) and the fused one (``fused=True``: each score
evaluation is one launch of the K6 kernel on the feature-layout
conditioning), as the JAX package's ``benchmarks/profile_sampler.py``
measures both.  Each chain runs once to warm up, once timed without the
profiler and once under ``torch.profiler`` (CPU and CUDA activities).
Prints, per chain, the wall time, the device-busy time (sum of kernel
times, one stream), the device's idle share, the device operations per
score evaluation and the operators that take the most device time; writes
each chain's full table to ``profile_sampler_<chain>.txt`` in ``out_dir``.

    python -m moleculesde_tpu_torch.benchmarks.profile_sampler            # both
    python -m moleculesde_tpu_torch.benchmarks.profile_sampler --fused    # fused only
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from moleculesde_tpu_torch.examples import sample_2d_to_3d as cli

# the measured path (also chip_smoke.py's): full width, one batch of
# 8 molecules x 8 repeats, depth cut to 20 PC steps x 1 corrector step
N_STEPS, CORRECTOR_STEPS = 20, 1
PATH_ARGS = ["--dataset", "synthetic", "--seed", "42", "--end", "8",
             "--sample_mols_per_batch", "8", "--num_repeat_SDE_inference", "8",
             "--n_max", "32", "--emb_dim", "300", "--num_layer", "5",
             "--SDE_type_2Dto3D", "VE", "--SDE_2Dto3D_model", "SDEModel2Dto3D_01",
             "--sampler_precision", "bfloat16",
             "--num_diffusion_timesteps_2Dto3D_inference", str(N_STEPS),
             "--steps_pos", str(CORRECTOR_STEPS)]
CHAINS = {"channel": False, "fused": True}


def main(out_dir: str = "chiprun_out") -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--fused", action="store_true", help="profile the fused chain only")
    opts = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampler: needs a CUDA device")
    names = ["fused"] if opts.fused else list(CHAINS)
    dev = torch.device("cuda")
    args = cli.get_parser().parse_args(PATH_ARGS)
    batch = cli.make_batch(cli.load_graphs(args), args, dev)
    model_2d, sde_model = cli.build_models(args, dev)
    os.makedirs(out_dir, exist_ok=True)
    summary = {"device": torch.cuda.get_device_name(0),
               "chains": [profile_chain(model_2d, sde_model, batch, args, CHAINS[n], n,
                                        out_dir) for n in names]}
    print(json.dumps(summary))
    return summary


def profile_chain(model_2d, sde_model, batch, args, fused: bool, name: str,
                  out_dir: str) -> dict:
    dev = batch.positions.device

    def chain():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        cli.generate(model_2d, sde_model, batch, gen, args, fused=fused)
        torch.cuda.synchronize()

    chain()  # warm-up: kernel builds, cuBLAS handles, allocator
    t0 = time.perf_counter()
    chain()
    wall_plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain()
        wall_prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(out_dir, f"profile_sampler_{name}.txt"), "w") as fh:
        fh.write(table)
    top = sorted(prof.key_averages(), key=lambda a: a.self_device_time_total,
                 reverse=True)[:12]
    evals = N_STEPS * (CORRECTOR_STEPS + 1)
    print(table)
    return {
        "chain": name,
        "chain_wall_ms": wall_plain_ms,
        "chain_wall_ms_profiled": wall_prof_ms,
        "conformers_per_s": batch.num_graphs / wall_plain_ms * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_prof_ms if kernels else None,
        "device_events": len(kernels),
        "score_evaluations": evals,
        "device_events_per_evaluation": len(kernels) / evals,
        "top_ops_by_device_ms": [
            {"op": a.key, "device_ms": a.self_device_time_total / 1e3,
             "calls": a.count} for a in top],
    }


if __name__ == "__main__":
    main()
