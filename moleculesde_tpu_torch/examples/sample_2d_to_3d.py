"""2D->3D conformer generation CLI (reverse-SDE predictor-corrector).

Counterpart of ``examples/sample_2d_to_3d.py`` of the JAX package
(reference examples/pretrain_MoleculeSDE_inference_2D_to_3D_VE_VP.py): each
test molecule is cloned ``--num_repeat_SDE_inference`` times,
``--sample_mols_per_batch`` molecules share one padded batch, the 2D
encoder (``--gnn_type`` GIN, GCN, GAT or GraphSAGE, ``--JK`` last, max or
sum) and the 2D conditioning of ``--SDE_2Dto3D_model`` (any of the four)
run once per batch, then the whole PC chain.
Results are pickled as {atom_feats, positions_true, pos_gen [repeat, n, 3]}.

Runs on the GPU (``--device cuda``, the default) and raises without one;
``--device cpu`` runs the plain PyTorch path.  Weights come from a
checkpoint (``--input_model_file``: ``model_2D`` and ``SDE_2Dto3D_model``
of a ``.pt`` written by ``moleculesde_tpu_torch.convert.save_checkpoint`` or
the port's pretraining CLI, or of the JAX package's
``model_complete*.msgpack``, read without JAX) or are drawn from
``--seed``.  The molecules are JAX's: ``--dataset synthetic`` draws them
from ``--seed``; any other ``--dataset`` (the default QM9 included, as in
JAX) reads the PCQM4Mv2 packed cache under
``<--input_data_dir>/<--dataset>`` (built there from the raw files on
first use, RDKit needed only then), cut to ``--end`` molecules.  Every flag
the JAX CLI reads is parsed with its name and default; ``--profile_dir``
and ``--debug_nans``, which the JAX CLI's shared parser gives it and it
ignores, print a line saying they have no effect.  ``--num_devices N``
> 1 spawns N data-parallel ranks (``parallel/``; one a card, or gloo ranks
with ``--device cpu``; ``--sample_mols_per_batch *
--num_repeat_SDE_inference`` divisible by N, as in JAX): each rank runs the
chain on its block of every batch of clones, with the draws of the whole
batch and the score unchunked, and rank 0 gathers the conformers for COV /
MAT, prints and writes.  ``--JK concat`` raises a ``ValueError``: the JAX CLI
builds the 2D->3D model at ``--emb_dim`` and fails on the wider node
representations.  So does a molecule of more than ``--n_max`` atoms among
``--start`` .. ``--end``, before any sampling: the padded batch would cut
it, and JAX's CLI fails on its COV / MAT after the chain.

Example:
  python -m moleculesde_tpu_torch.examples.sample_2d_to_3d --dataset=synthetic \\
      --end=4 --num_repeat_SDE_inference=4 --output_model_dir=out/gen
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from moleculesde_tpu_torch.core.batch import GraphBatch, pad_graphs
from moleculesde_tpu_torch.data.datasets import load_pcqm4mv2
from moleculesde_tpu_torch.data.loader import max_atoms
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.examples import note_inert_flags
from moleculesde_tpu_torch.examples.pretrain import MODEL_2DTO3D_VARIANTS
from moleculesde_tpu_torch.models.gnn2d import GNN2D
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.parallel import mesh
from moleculesde_tpu_torch.sampling.pc import sample_positions_pc
from moleculesde_tpu_torch.sde.base import SDE_PRESETS_2DTO3D
from moleculesde_tpu_torch.utils.checkpoints import load_components
from moleculesde_tpu_torch.utils.rmsd import coverage_matching



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
    p.add_argument("--gnn_type", type=str, default="GIN")
    p.add_argument("--num_layer", type=int, default=5)
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--dropout_ratio", type=float, default=0.5,
                   help="the 2D encoder's dropout (off while sampling)")
    p.add_argument("--JK", type=str, default="last")
    p.add_argument("--SDE_type_2Dto3D", type=str, default="VE",
                   choices=sorted(SDE_PRESETS_2DTO3D))
    p.add_argument("--SDE_2Dto3D_model", type=str, default="SDEModel2Dto3D_01",
                   choices=sorted(MODEL_2DTO3D_VARIANTS))
    p.add_argument("--use_extend_graph", dest="use_extend_graph", action="store_true")
    p.add_argument("--no_extend_graph", dest="use_extend_graph", action="store_false")
    p.set_defaults(use_extend_graph=True)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=100)
    p.add_argument("--num_repeat_SDE_inference", type=int, default=10)
    # Langevin corrector inner steps (reference inference 2D->3D l.66)
    p.add_argument("--steps_pos", type=int, default=100)
    p.add_argument("--corrector_steps", type=int, default=None,
                   help="override for the corrector inner-step count; "
                        "defaults to --steps_pos")
    p.add_argument("--num_diffusion_timesteps_2Dto3D_inference", type=int, default=20)
    p.add_argument("--sample_mols_per_batch", type=int, default=1)
    p.add_argument("--sampler_precision", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--sampler_score_chunk", type=int, default=128,
                   help="evaluate the score over batch chunks of this size "
                        "(same result); 0 disables")
    p.add_argument("--n_max", type=int, default=32)
    p.add_argument("--e_max_factor", type=int, default=4)
    p.add_argument("--ext_e_max", type=int, default=0,
                   help="extended-edge budget (0 -> n_max^2)")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks spawned here, one a card (0 -> one "
                        "process); --device cpu: gloo ranks on the CPU")
    p.add_argument("--threshold", type=float, default=0)
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
    does; raise on the flag values the port does not run."""
    note_inert_flags({"--profile_dir": bool(args.profile_dir),
                      "--debug_nans": args.debug_nans})
    if args.JK == "concat":
        raise ValueError(f"--JK concat gives {args.emb_dim * (args.num_layer + 1)}-wide node "
                         f"representations; the 2D->3D model reads --emb_dim {args.emb_dim} "
                         f"(the JAX CLI builds it at that width and fails on them too)")
    if args.num_devices > 1 and (args.sample_mols_per_batch * args.num_repeat_SDE_inference
                                 % args.num_devices):
        raise ValueError("--sample_mols_per_batch * --num_repeat_SDE_inference must be "
                         f"divisible by --num_devices={args.num_devices}")


def load_graphs(args):
    """JAX's molecules (examples/sample_2d_to_3d.py:42-52): ``max(--end, 1)``
    synthetic ones of 4 to ``--n_max`` atoms drawn from ``--seed``, or the
    PCQM4Mv2 packed cache under ``<--input_data_dir>/<--dataset>`` cut to
    ``--end`` molecules (all at ``--end 0``)."""
    if args.dataset == "synthetic":
        rng = np.random.default_rng(args.seed)
        return [random_molecule(rng, int(rng.integers(4, args.n_max + 1)))
                for _ in range(max(args.end, 1))]
    return load_pcqm4mv2(os.path.join(args.input_data_dir, args.dataset),
                         max_molecules=args.end or None, extend=args.use_extend_graph)


def check_sizes(mols, n_max: int) -> None:
    """Raise before any sampling when a molecule of ``mols`` has more than
    ``n_max`` atoms: its padded batch would hold only its first ``n_max``
    atoms, and no conformer of the whole molecule could be scored."""
    largest = max_atoms(mols) if len(mols) else 0
    if largest > n_max:
        raise ValueError(f"a molecule of --start .. --end has {largest} atoms, more than "
                         f"--n_max {n_max}: raise --n_max")


def make_batch(mols: list, args, device) -> GraphBatch:
    """One padded batch on ``device``: each molecule of ``mols`` cloned
    ``--num_repeat_SDE_inference`` times (under a data-parallel group the
    rank's block of it)."""
    n_max = args.n_max
    batch = pad_graphs([g for g in mols for _ in range(args.num_repeat_SDE_inference)],
                       n_max=n_max, e_max=args.e_max_factor * n_max,
                       ext_e_max=args.ext_e_max or n_max * n_max)
    group = dp.active()
    if group is not None:
        batch = mesh.rank_block(batch, group.rank, group.world)
    return batch.to(device)


def build_models(args, device, msg_impl: str = "auto", pair_impl: str = "auto",
                 pair_cm_direct: bool = False, hidden_dim: int = 32):
    """(GNN2D, SDEModel2Dto3D) at the flags' widths, weights from
    ``--input_model_file`` or drawn from ``--seed``.  ``pair_cm_direct``
    builds the 2D->3D model with the channel-major pair kernel and
    ``hidden_dim`` sets its hidden width (neither has a CLI flag, as in the
    JAX CLI, whose model is 32 wide)."""
    t23, bmin, bmax, n_steps = SDE_PRESETS_2DTO3D[args.SDE_type_2Dto3D]
    gen = torch.Generator().manual_seed(args.seed)
    model_2d = GNN2D(num_layers=args.num_layer, emb_dim=args.emb_dim, jk=args.JK,
                     drop_ratio=args.dropout_ratio, gnn_type=args.gnn_type,
                     msg_impl=msg_impl, device=device, generator=gen)
    sde_model = SDEModel2Dto3D(
        emb_dim=args.emb_dim, hidden_dim=hidden_dim,
        variant=MODEL_2DTO3D_VARIANTS[args.SDE_2Dto3D_model], sde_type=t23,
        beta_min=bmin, beta_max=bmax, num_diffusion_timesteps=n_steps,
        use_extend_graph=args.use_extend_graph,
        score_dtype=args.sampler_precision, pair_impl=pair_impl,
        pair_cm_direct=pair_cm_direct, device=device, generator=gen)
    if args.input_model_file:
        load_components(args.input_model_file, {"model_2D": model_2d, "SDE_2Dto3D_model": sde_model})
        print(f"loaded checkpoint {args.input_model_file}")
    return model_2d, sde_model


def generate(model_2d, sde_model, batch, generator, args, fused: bool = False
             ) -> torch.Tensor:
    """Conformers for one padded batch: the 2D encoding then the PC chain;
    returns positions [B * n_max, 3] on the batch's device.  ``fused`` runs
    the chain's score evaluations as the fused kernel (no CLI flag, as in
    the JAX CLI; the benchmarks and ``chip_smoke.py`` set it)."""
    corrector_steps = (args.corrector_steps if args.corrector_steps is not None
                       else args.steps_pos)
    with torch.no_grad():
        node_2d = model_2d(batch, use_running_average=True)
        return sample_positions_pc(
            sde_model, node_2d, batch, generator,
            n_steps=args.num_diffusion_timesteps_2Dto3D_inference or None,
            corrector_steps=corrector_steps, fused=fused,
            score_chunk=None if dp.active() else args.sampler_score_chunk or None)


def main(argv=None):
    args = get_parser().parse_args(argv)
    check_supported(args)
    return mesh.run_cli(run, args, args.num_devices)


def run(args, device):
    """Sample as the flags say on ``device``, as one rank of the active
    data-parallel group or as the only process; returns the results (none
    on ranks other than 0)."""
    mols = load_graphs(args)[args.start : args.end]
    check_sizes(mols, args.n_max)
    model_2d, sde_model = build_models(args, device)
    sample_gen = torch.Generator(device=device).manual_seed(args.seed)

    rep = args.num_repeat_SDE_inference
    k_mols = max(1, args.sample_mols_per_batch)
    results = []
    for c0 in range(0, len(mols), k_mols):
        # list(): a packed dataset's slice is a PackedSubset view
        chunk = list(mols[c0 : c0 + k_mols])
        # pad the last chunk with clones of its last molecule (one batch
        # shape for every chain); the extras are discarded below
        padded = chunk + [chunk[-1]] * (k_mols - len(chunk))
        batch = make_batch(padded, args, device)
        t0 = time.perf_counter()
        pos = dp.all_gather_rows(generate(model_2d, sde_model, batch, sample_gen, args))
        if dp.rank() != 0:      # rank 0 scores and keeps the conformers
            continue
        pos_all = pos.cpu().numpy().reshape(k_mols, rep, args.n_max, 3)
        chunk_dt = time.perf_counter() - t0
        for j, g in enumerate(chunk):
            n_atoms = g["atom_feats"].shape[0]
            pos_gen = pos_all[j, :, :n_atoms]
            entry = {"atom_feats": g["atom_feats"],
                     "positions_true": g.get("positions"),
                     "pos_gen": pos_gen, "num_pos_gen": rep}
            msg = (f"molecule {c0 + j}: {n_atoms} atoms, {rep} conformers in "
                   f"{chunk_dt / len(chunk):.2f}s")
            if g.get("positions") is not None:
                # a copy: a packed molecule's positions are a read-only memmap view
                cov, mat = coverage_matching(pos_gen, np.array(g["positions"])[None],
                                             threshold=args.threshold or 0.5)
                entry["cov"], entry["mat"] = cov, mat
                msg += f"  COV={cov:.3f} MAT={mat:.3f}"
            results.append(entry)
            print(msg)

    if args.output_model_dir and dp.rank() == 0:
        os.makedirs(args.output_model_dir, exist_ok=True)
        out = os.path.join(
            args.output_model_dir,
            f"2D_to_3D_{args.generator}_{args.start}_{args.end}"
            f"_repeat_{args.num_repeat_SDE_inference}.pkl")
        with open(out, "wb") as f:
            pickle.dump(results, f)
        print(f"save generated {args.generator} samples to {out} done!")
    return results


if __name__ == "__main__":
    main()
