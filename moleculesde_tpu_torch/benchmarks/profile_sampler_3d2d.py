"""Where the time of one 3D->2D graph-generation chain goes, on the GPU.

Counterpart of the JAX package's ``benchmarks/profile_sampler_3d2d.py``.
Runs the chain of ``chip_smoke.py``'s 3D->2D phase: the sampler CLI's
models at full width (SchNet 6 x 128 filters x 51 Gaussians, emb_dim 300,
eager CFConv; SDEModel3Dto2D variant 1 with the CLI's widths, VE 0.1-1.0,
bf16 attention bank), B = 128 synthetic molecules of 4-32 atoms (n_max 32),
20 PC steps x 2 corrector steps (the CLI's default is 100 corrector steps:
depth cut), random weights from seed 42.  Three forms of the same chain,
the model's ``attn_impl``: "auto" (the eager bank, the CLI's), "pallas"
(the map kernel K7) and "fused" (the q/k-net and map kernel K8).  Each
form runs once to warm up; then the chains are timed in turns (auto,
pallas, fused, fused, pallas, auto) without the profiler, then each runs
once under ``torch.profiler`` (CPU and CUDA activities).  Prints, per
form, the wall times, graphs/s and PC steps/s, the device-busy time (sum
of kernel times, one stream), the device's idle share, the device
operations per edge-network evaluation (every device operation of the
chain, SchNet and the node network included, over the chain's 60 edge
evaluations) and the operators that take the most device time; writes
each form's table to ``profile_sampler_3d2d_<form>.txt`` in ``out_dir``.

    python -m moleculesde_tpu_torch.benchmarks.profile_sampler_3d2d
"""

from __future__ import annotations

import json
import os
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from moleculesde_tpu_torch.examples import sample_3d_to_2d as cli

# the measured path (also chip_smoke.py's): full width, one batch of 128
# molecules, depth cut to 20 PC steps x 2 corrector steps
N_STEPS, CORRECTOR_STEPS, BATCH = 20, 2, 128
PATH_ARGS = ["--dataset", "synthetic", "--seed", "42", "--batch_size", str(BATCH),
             "--end", str(BATCH), "--n_max", "32", "--emb_dim", "300",
             "--SchNet_num_filters", "128", "--SchNet_num_interactions", "6",
             "--SchNet_num_gaussians", "51", "--SchNet_cutoff", "10",
             "--SDE_type_3Dto2D", "VE", "--SDE_3Dto2D_model", "SDEModel3Dto2D_node_adj_dense",
             "--num_diffusion_timesteps_3Dto2D_inference", str(N_STEPS),
             "--steps_pos", str(CORRECTOR_STEPS)]
FORMS = ("auto", "pallas", "fused")
# edge-network evaluations per chain: per step the corrector's dual
# evaluation, corrector_steps - 1 adjacency-only ones and the predictor's
EDGE_EVALS = N_STEPS * (CORRECTOR_STEPS + 1)


def path_batch(args, device):
    """The chain's batch: the CLI loader's first batch, on ``device``."""
    return next(iter(cli.make_loader(cli.load_graphs(args), args)))[0].to(device)


def bank_operands(encoder, model, batch, dev):
    """What the 3D->2D chain hands the attention bank in edge layers 0
    (C = 2, F = emb_dim) and 1 (C = 8, F = nhid) at its first evaluation,
    from the prior state: per layer the node features qk (f32), q and k in
    the bank's dtype, q32 and k32 from the q / k nets run in f32 (true f32
    operands, not bf16 values upcast), the raw q / k parameters and ds."""
    from moleculesde_tpu_torch.core.masks import mask_adjs, mask_x, node_flags
    from moleculesde_tpu_torch.models.score_3d2d import pow_tensor

    b, n = batch.num_graphs, batch.n_max
    gen = torch.Generator(device=dev).manual_seed(5)
    layers = []
    with torch.no_grad():
        _, node_3d = encoder.encode_batch(batch)
        edge_attr = torch.where(batch.edge_mask, batch.edge_feats[:, 0].float() + 1.0,
                                torch.zeros((), device=dev))
        flags = node_flags(batch.dense_adjacency(edge_attr))
        x = mask_x(torch.randn((b, n, model.num_class_x), generator=gen, device=dev), flags)
        adj = mask_adjs(torch.randn((b, n, n), generator=gen, device=dev), flags)
        h = model.embedding_3D(batch.dense_nodes(node_3d)) + model.embedding_X(x)
        edge = model.edge_score_network
        adjc = pow_tensor(adj, edge.c_init)
        for i in range(2):
            layer = getattr(edge, f"layer_{i}")
            attn, dt = layer.attn, layer.attn.dtype or torch.float32
            layers.append({"qk": h.float().contiguous(),
                           "q": attn.qk(h.to(dt), "q", dt).contiguous(),
                           "k": attn.qk(h.to(dt), "k", dt).contiguous(),
                           "q32": attn.qk(h.float(), "q", torch.float32).contiguous(),
                           "k32": attn.qk(h.float(), "k", torch.float32).contiguous(),
                           "ws": [w.detach().float().contiguous() for w in attn.qk_params()],
                           "ds": attn.ds})
            h, adjc = layer(h, adjc, flags)
    return layers


def chain_bank_operands(dev, n_max: int = 32, batch_size: int = BATCH):
    """:func:`bank_operands` of the chain's "auto" models (the same weights,
    from the seed) at ``--n_max n_max``, B=``batch_size``."""
    args = cli.get_parser().parse_args(PATH_ARGS + [
        "--n_max", str(n_max), "--batch_size", str(batch_size), "--end", str(batch_size)])
    return bank_operands(*cli.build_models(args, dev, attn_impl="auto"), path_batch(args, dev),
                         dev)


def main(out_dir: str = "chiprun_out") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampler_3d2d: needs a CUDA device")
    dev = torch.device("cuda")
    args = cli.get_parser().parse_args(PATH_ARGS)
    batch = path_batch(args, dev)
    models = {form: cli.build_models(args, dev, attn_impl=form) for form in FORMS}

    def chain(form):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        cli.generate(*models[form], batch, gen, args)
        torch.cuda.synchronize()

    for form in FORMS:      # warm-up: kernel builds, cuBLAS handles, allocator
        chain(form)
    walls = {form: [] for form in FORMS}
    for form in FORMS + FORMS[::-1]:
        t0 = time.perf_counter()
        chain(form)
        walls[form].append((time.perf_counter() - t0) * 1e3)
    os.makedirs(out_dir, exist_ok=True)
    summary = {"device": torch.cuda.get_device_name(0),
               "forms": [profile_form(chain, form, walls[form], out_dir)
                         for form in FORMS]}
    print(json.dumps(summary))
    return summary


def profile_form(chain, form: str, walls: list, out_dir: str) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain(form)
        wall_prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(out_dir, f"profile_sampler_3d2d_{form}.txt"), "w") as fh:
        fh.write(table)
    top = sorted(prof.key_averages(), key=lambda a: a.self_device_time_total,
                 reverse=True)[:12]
    wall = statistics.median(walls)
    print(f"== form {form} ==\n{table}", flush=True)
    return {
        "form": form,
        "chain_wall_ms": walls,
        "graphs_per_s": BATCH / wall * 1e3,
        "pc_steps_per_s": N_STEPS / wall * 1e3,
        "chain_wall_ms_profiled": wall_prof_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_prof_ms if kernels else None,
        "device_events": len(kernels),
        "edge_evaluations": EDGE_EVALS,
        "device_events_per_edge_evaluation": len(kernels) / EDGE_EVALS,
        "top_ops_by_device_ms": [
            {"op": a.key, "device_ms": a.self_device_time_total / 1e3, "calls": a.count}
            for a in top],
    }


if __name__ == "__main__":
    main()
