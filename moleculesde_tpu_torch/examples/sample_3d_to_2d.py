"""3D->2D graph generation CLI (joint (x, adj) reverse-SDE PC sampling).

Counterpart of ``examples/sample_3d_to_2d.py`` of the JAX package
(reference examples/pretrain_MoleculeSDE_inference_3D_to_2D_VE_VP.py):
conditioned on the 3D latent of each molecule, jointly denoise node
one-hots and the dense adjacency with corrector / predictor updates, using
oracle node flags from the true bond graph.  Batches of ``--batch_size``
molecules; results are pickled per batch as {x_gen, adj_gen,
atom_feats_true} to ``3D_to_2D_{generator}_{start}_{end}.pkl``.

Runs on the GPU (``--device cuda``, the default) and raises without one;
``--device cpu`` runs the plain PyTorch path.  The 3D encoder is SchNet
with its eager CFConv (``cfconv="xla"``), as the JAX CLI builds it, or
PaiNN (``--model_3d PaiNN``, f32).  Weights come from a port checkpoint
(``--input_model_file``: ``model_3D`` and ``SDE_3Dto2D_model`` of a ``.pt``
written by ``moleculesde_tpu_torch.convert.save_checkpoint`` or the port's
pretraining CLI, or of the JAX package's ``model_complete*.msgpack``, read
without JAX) or are drawn from ``--seed``.  The molecules are JAX's:
``--dataset synthetic`` draws ``max(--end, --batch_size)`` of them from
``--seed``; any other ``--dataset`` (the default QM9 included, as in JAX)
reads the PCQM4Mv2 packed cache under ``<--input_data_dir>/<--dataset>``
(built there from the raw files on first use, RDKit needed only then; its
extended graph with ``--use_extend_graph``), cut to ``--end`` molecules.
Every flag the JAX CLI reads is parsed with its name and default;
``--profile_dir`` and ``--debug_nans``, which the JAX CLI's shared parser
gives it and it ignores, print a line saying they have no effect.
``--num_devices N`` > 1 spawns N data-parallel ranks (``parallel/``; one a
card, or gloo ranks with ``--device cpu``; ``--batch_size`` divisible by N,
as in JAX): each rank runs the chain on its block of every batch, with the
draws of the whole batch, and rank 0 gathers the graphs, prints and
writes.

Example:
  python -m moleculesde_tpu_torch.examples.sample_3d_to_2d --dataset=synthetic \\
      --batch_size=4 --end=4 --output_model_dir=out/gen_3d2d
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from moleculesde_tpu_torch.data.datasets import load_pcqm4mv2
from moleculesde_tpu_torch.data.loader import GraphLoader
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.examples import note_inert_flags
from moleculesde_tpu_torch.examples.pretrain import MODEL_3DTO2D_VARIANTS
from moleculesde_tpu_torch.models.painn import PaiNN
from moleculesde_tpu_torch.models.schnet import SchNet
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.parallel import mesh
from moleculesde_tpu_torch.sampling.pc import sample_graph_pc
from moleculesde_tpu_torch.sde.base import SDE_PRESETS_3DTO2D
from moleculesde_tpu_torch.utils.checkpoints import load_components


def get_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags (examples/config.py) that this sampler reads,
    with the same names and defaults, plus ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dataset", type=str, default="QM9",
                   help="synthetic, or the name of the PCQM4Mv2 directory under "
                        "--input_data_dir")
    p.add_argument("--input_data_dir", type=str, default="")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--model_3d", type=str, default="SchNet", choices=["SchNet", "PaiNN"])
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--SchNet_num_filters", type=int, default=128)
    p.add_argument("--SchNet_num_interactions", type=int, default=6)
    p.add_argument("--SchNet_num_gaussians", type=int, default=51)
    p.add_argument("--SchNet_cutoff", type=float, default=10)
    p.add_argument("--SchNet_readout", type=str, default="mean", choices=["mean", "add"])
    p.add_argument("--PaiNN_radius_cutoff", type=float, default=5.0)
    p.add_argument("--PaiNN_n_interactions", type=int, default=3)
    p.add_argument("--PaiNN_n_rbf", type=int, default=20)
    p.add_argument("--PaiNN_readout", type=str, default="add", choices=["mean", "add"])
    p.add_argument("--use_extend_graph", dest="use_extend_graph", action="store_true")
    p.add_argument("--no_extend_graph", dest="use_extend_graph", action="store_false")
    p.set_defaults(use_extend_graph=True)
    p.add_argument("--SDE_type_3Dto2D", type=str, default="VE", choices=sorted(SDE_PRESETS_3DTO2D))
    p.add_argument("--SDE_3Dto2D_model", type=str, default="SDEModel3Dto2D_node_adj_dense",
                   choices=sorted(MODEL_3DTO2D_VARIANTS))
    p.add_argument("--noise_on_one_hot", dest="noise_on_one_hot", action="store_true")
    p.add_argument("--no_noise_on_one_hot", dest="noise_on_one_hot", action="store_false")
    p.set_defaults(noise_on_one_hot=True)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=100)
    # corrector inner steps (reference inference 3D->2D l.83: n_steps=steps_pos)
    p.add_argument("--steps_pos", type=int, default=100)
    p.add_argument("--corrector_steps", type=int, default=None,
                   help="override for the corrector inner-step count; "
                        "defaults to --steps_pos")
    p.add_argument("--num_diffusion_timesteps_3Dto2D_inference", type=int, default=20)
    p.add_argument("--n_max", type=int, default=32)
    p.add_argument("--e_max_factor", type=int, default=4)
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks spawned here, one a card (0 -> one "
                        "process); --device cpu: gloo ranks on the CPU")
    p.add_argument("--generator", type=str, default="PC")
    p.add_argument("--input_model_file", type=str, default="")
    p.add_argument("--profile_dir", type=str, default="",
                   help="parsed, as the JAX sampler parses it; no effect")
    p.add_argument("--debug_nans", dest="debug_nans", action="store_true",
                   help="parsed, as the JAX sampler parses it; no effect")
    p.set_defaults(debug_nans=False)
    p.add_argument("--output_model_dir", type=str, default="")
    return p


def check_supported(args) -> None:
    """Note the flags the sampler parses and ignores, as the JAX sampler
    does; raise on a batch that does not split over ``--num_devices``
    ranks."""
    note_inert_flags({"--profile_dir": bool(args.profile_dir),
                      "--debug_nans": args.debug_nans})
    if args.num_devices > 1 and args.batch_size % args.num_devices:
        raise ValueError(f"--batch_size must be divisible by --num_devices={args.num_devices}")


def load_graphs(args):
    """JAX's molecules (examples/sample_3d_to_2d.py:41-52): ``max(--end,
    --batch_size)`` synthetic ones of 4 to ``--n_max`` atoms drawn from
    ``--seed``, or the PCQM4Mv2 packed cache under
    ``<--input_data_dir>/<--dataset>`` cut to ``--end`` molecules (all at
    ``--end 0``)."""
    if args.dataset == "synthetic":
        rng = np.random.default_rng(args.seed)
        return [random_molecule(rng, int(rng.integers(4, args.n_max + 1)))
                for _ in range(max(args.end, args.batch_size))]
    return load_pcqm4mv2(os.path.join(args.input_data_dir, args.dataset),
                         max_molecules=args.end or None, extend=args.use_extend_graph)


def make_loader(graphs, args, block=None) -> GraphLoader:
    return GraphLoader(graphs, batch_size=args.batch_size, n_max=args.n_max,
                       e_max=args.e_max_factor * args.n_max, shuffle=False,
                       drop_last=False, seed=args.seed, block=block)


def build_models(args, device, attn_impl: str = "auto", bf16_attn: bool = True):
    """(SchNet or PaiNN, SDEModel3Dto2D) at the flags' widths, weights from
    ``--input_model_file`` or drawn from ``--seed``.  ``attn_impl`` picks
    the attention bank ("auto", "pallas": K7, "fused": K8) and
    ``bf16_attn`` its precision; neither is a CLI flag, as in the JAX CLI
    (the benchmarks and ``chip_smoke.py`` set them)."""
    t32, bmin, bmax, n_steps = SDE_PRESETS_3DTO2D[args.SDE_type_3Dto2D]
    gen = torch.Generator().manual_seed(args.seed)
    if args.model_3d == "SchNet":
        encoder = SchNet(hidden_channels=args.emb_dim, num_filters=args.SchNet_num_filters,
                         num_interactions=args.SchNet_num_interactions,
                         num_gaussians=args.SchNet_num_gaussians, cutoff=args.SchNet_cutoff,
                         readout=args.SchNet_readout, cfconv="xla", device=device,
                         generator=gen)
    else:
        encoder = PaiNN(n_atom_basis=args.emb_dim, n_interactions=args.PaiNN_n_interactions,
                        n_rbf=args.PaiNN_n_rbf, cutoff=args.PaiNN_radius_cutoff,
                        readout=args.PaiNN_readout, device=device, generator=gen)
    # dense-net widths hard-coded by the reference (pretrain_MoleculeSDE.py:309-315)
    sde_model = SDEModel3Dto2D(
        dim3d=args.emb_dim, c_init=2, c_hid=8, c_final=4, num_heads=4, adim=16, nhid=16,
        num_layers=4, num_linears=3, variant=MODEL_3DTO2D_VARIANTS[args.SDE_3Dto2D_model],
        bf16_attn=bf16_attn, attn_impl=attn_impl, sde_type=t32, beta_min=bmin,
        beta_max=bmax, num_diffusion_timesteps=n_steps,
        noise_on_one_hot=args.noise_on_one_hot, device=device, generator=gen)
    if args.input_model_file:
        load_components(args.input_model_file, {"model_3D": encoder, "SDE_3Dto2D_model": sde_model})
        print(f"loaded checkpoint {args.input_model_file}")
    return encoder, sde_model


def corrector_steps_of(args) -> int:
    return args.corrector_steps if args.corrector_steps is not None else args.steps_pos


def generate(encoder, sde_model, batch, generator, args):
    """(x, adj, x_mean, adj_mean) for one padded batch on its device: the
    3D encoder's latent, then the PC chain."""
    with torch.no_grad():
        _, node_3d = encoder.encode_batch(batch)
        return sample_graph_pc(
            sde_model, node_3d, batch, generator,
            n_steps=args.num_diffusion_timesteps_3Dto2D_inference or None,
            corrector_steps=corrector_steps_of(args))


def main(argv=None):
    args = get_parser().parse_args(argv)
    check_supported(args)
    return mesh.run_cli(run, args, args.num_devices)


def run(args, device):
    """Generate as the flags say on ``device``, as one rank of the active
    data-parallel group or as the only process; returns the results (on
    every rank)."""
    group = dp.active()
    loader = make_loader(load_graphs(args), args,
                         block=None if group is None else (group.rank, group.world))
    encoder, sde_model = build_models(args, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    results = []
    for batch, n_real in loader:
        batch = batch.to(device)
        t0 = time.perf_counter()
        _, _, x_mean, adj_mean = generate(encoder, sde_model, batch, gen, args)
        feats = batch.atom_feats.reshape(batch.num_graphs, batch.n_max, -1)
        # every rank's block, and the batch's real graphs (the first ones)
        x_mean, adj_mean, feats = (dp.all_gather_rows(v) for v in (x_mean, adj_mean, feats))
        n_real = int(dp.global_sum(torch.tensor(n_real, device=device)))
        results.append({"x_gen": x_mean[:n_real].cpu().numpy(),
                        "adj_gen": adj_mean[:n_real].cpu().numpy(),
                        "atom_feats_true": feats[:n_real].cpu().numpy()})
        print(f"generated {n_real} graphs in {time.perf_counter() - t0:.2f}s")
        if len(results) * args.batch_size >= args.end > 0:
            break

    if args.output_model_dir and dp.rank() == 0:
        os.makedirs(args.output_model_dir, exist_ok=True)
        out = os.path.join(args.output_model_dir,
                           f"3D_to_2D_{args.generator}_{args.start}_{args.end}.pkl")
        with open(out, "wb") as f:
            pickle.dump(results, f)
        print(f"save generated {args.generator} samples to {out} done!")
    return results


if __name__ == "__main__":
    main()
