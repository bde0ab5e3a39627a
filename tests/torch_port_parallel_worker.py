"""The data-parallel cases of the port's parallel tests, and the worker
that runs them as one rank of a gloo group on the CPU.

Each case is a function of no argument that runs one path of the port on a
global batch made from a seed: under a data-parallel group
(``parallel.collectives.data_parallel``) on the rank's block, in one
process on the whole batch.  It returns {name: numpy array}: the rank's
block of per-molecule outputs, the loss terms, the gradients before the
optimizer (averaged over the ranks) and the running statistics.  The
parent test runs the same function in its own process for the one-process
result and holds the two ranks' results to it and to the JAX package's
sharded functions.

Cases that the JAX package is compared on read their random draws (the
global batch's, from JAX's keys) from ``<out_dir>/draws_<case>.npz``,
which the parent writes before it starts the workers.  The worker imports
no JAX.

    python tests/torch_port_parallel_worker.py RANK WORLD PORT OUT_DIR CASE...

writes ``<OUT_DIR>/<CASE>.r<RANK>.npz`` for each case, in order.
"""

from __future__ import annotations

import datetime
import importlib
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from moleculesde_tpu_torch.core.batch import pad_graphs  # noqa: E402
from moleculesde_tpu_torch.data.compact import collate_compact  # noqa: E402
from moleculesde_tpu_torch.data.synthetic import random_molecule  # noqa: E402
from moleculesde_tpu_torch.finetune.classification import (  # noqa: E402
    classification_eval, classification_loss)
from moleculesde_tpu_torch.finetune.md17 import md17_eval, md17_loss  # noqa: E402
from moleculesde_tpu_torch.finetune.regression import (  # noqa: E402
    RegressionModel, regression_eval, regression_loss)
from moleculesde_tpu_torch.models.gnn2d import GNNGraphPred  # noqa: E402
from moleculesde_tpu_torch.models.layers import (  # noqa: E402
    MaskedBatchNorm, PairMaskedBatchNorm, dropout)
from moleculesde_tpu_torch.models.schnet import SchNet  # noqa: E402
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D  # noqa: E402
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D  # noqa: E402
from moleculesde_tpu_torch.parallel import collectives as dp  # noqa: E402
from moleculesde_tpu_torch.parallel import mesh  # noqa: E402
from moleculesde_tpu_torch.pretrain.contrastive import dual_cl  # noqa: E402
from moleculesde_tpu_torch.pretrain.train_state import (  # noqa: E402
    PretrainConfig, create_pretrain_state)
from moleculesde_tpu_torch.pretrain.train_step import METRICS, pretrain_grads  # noqa: E402
from moleculesde_tpu_torch.sampling.pc import sample_graph_pc, sample_positions_pc  # noqa: E402

WORLD = 2
N_MAX = 8
B = 8                     # graphs in a global batch
TINY = dict(emb_dim=16, num_layer=2, schnet_num_filters=8, schnet_num_interactions=1,
            schnet_num_gaussians=11, hidden_dim_2dto3d=16)
SEED = 3                  # weights
STEP_SEED = 7             # the step / chain generator
SAMPLER_STEPS = 4
CORRECTOR = 2
EMB = 8


def graphs(seed: int, count: int = B, n_max: int = N_MAX, tasks: int = 0):
    """``count`` random molecules of 3 to ``n_max`` atoms (with ``tasks``
    labels in {-1, 0, 1} and random forces when ``tasks``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        g = random_molecule(rng, int(rng.integers(3, n_max + 1)))
        if tasks:
            g["y"] = rng.integers(-1, 2, size=tasks).astype(np.float32)
            g["forces"] = rng.normal(size=g["positions"].shape).astype(np.float32)
        out.append(g)
    return out


def padded(gs, **labels):
    return pad_graphs(gs, n_max=N_MAX, e_max=4 * N_MAX, ext_e_max=N_MAX * N_MAX, **labels)


def local(batch):
    """The rank's block of a global batch (the batch in one process)."""
    g = dp.active()
    return batch if g is None else mesh.rank_block(batch, g.rank, g.world)


def rows(x: np.ndarray | torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The rank's block of a global array."""
    return dp.block(torch.as_tensor(np.asarray(x)), dim)


def draws_of(case: str, out_dir: str):
    return dict(np.load(os.path.join(out_dir, f"draws_{case}.npz")))


def score_draws(d, prefix: str = ""):
    """The pretraining step's score draws from flat global arrays: the
    rank's block of each noise, the global ``half``."""
    return {"sde_2dto3d": {"pos_noise": rows(d[prefix + "pos_noise"]),
                           "half": torch.as_tensor(d[prefix + "half_23"]).long()},
            "sde_3dto2d": {"half": torch.as_tensor(d[prefix + "half_32"]).long(),
                           "z_adj": rows(d[prefix + "z_adj"]),
                           "z_x": rows(d[prefix + "z_x"])}}


def named(prefix: str, module_map) -> dict:
    """{prefix + "comp.name": array} of every gradient (zeros where None)
    and, with prefix "g:", the running statistics under "b:"."""
    out = {}
    for comp, module in module_map.items():
        for name, p in module.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out[f"{prefix}{comp}.{name}"] = g.detach().numpy().copy()
        for name, buf in module.named_buffers():
            out[f"b:{comp}.{name}"] = buf.detach().numpy().copy()
    return out


def params(module_map) -> dict:
    return {f"p:{comp}.{name}": p.detach().numpy().copy()
            for comp, module in module_map.items() for name, p in module.named_parameters()}


def _average(modules) -> None:
    dp.average_grads(p for m in modules for p in m.parameters())


# ------------------------------------------------------------ pretraining

def pretrain_config(metric="InfoNCE_dot_prod", microbatch=0, scope="step", dropout_ratio=0.5):
    return PretrainConfig(**TINY, dropout_ratio=dropout_ratio, cl_similarity_metric=metric,
                          train_precision="float32", microbatch=microbatch,
                          microbatch_scope=scope)


def pretrain_batch(compact: bool):
    gs = graphs(61)
    return (collate_compact(gs, n_max=N_MAX, e_max=4 * N_MAX) if compact else padded(gs))


def _pretrain_grads(metric, compact, microbatch=0, scope="step"):
    """One step's loss terms, gradients before Adam (averaged over ranks)
    and running statistics, dropout on; the one-process run takes the
    shard-aligned chunks of two ranks."""
    cfg = pretrain_config(metric, microbatch, scope)
    state = create_pretrain_state(cfg, "cpu", SEED)
    batch = local(pretrain_batch(compact))
    shards = WORLD if dp.active() is None else 1
    metrics = pretrain_grads(state.models, cfg, batch,
                             torch.Generator().manual_seed(STEP_SEED), shards=shards)
    _average(state.models.values())
    out = named("g:", state.models)
    out.update({f"m:{k}": metrics[k].detach().numpy() for k in METRICS})
    return out


def case_pre_padded_infonce(out_dir):
    return _pretrain_grads("InfoNCE_dot_prod", False)


def case_pre_compact_ebm(out_dir):
    return _pretrain_grads("EBM_dot_prod", True)


def case_pre_padded_ebm_node(out_dir):
    return _pretrain_grads("EBM_node_dot_prod", False)


def case_pre_microbatch_step(out_dir):
    return _pretrain_grads("InfoNCE_dot_prod", True, 4, "step")


def case_pre_microbatch_splice(out_dir):
    return _pretrain_grads("EBM_node_dot_prod", False, 4, "splice")


def _pretrain_jax(case, out_dir, microbatch=0, scope="step"):
    """One data-parallel step (``parallel.pretrain_step``, Adam included)
    on JAX's replayed draws, dropout off: loss terms, the parameters after
    the update and the running statistics."""
    cfg = pretrain_config(microbatch=microbatch, scope=scope, dropout_ratio=0.0)
    state = create_pretrain_state(cfg, "cpu", SEED)
    d = draws_of(case, out_dir)
    if microbatch:
        k = B // microbatch
        draws = {"cl": None, "chunks": [score_draws(d, f"c{i}.") for i in range(k)]}
    else:
        draws = {"cl": None, **score_draws(d)}
    batch = local(pretrain_batch(False))
    g = dp.active()
    if g is None:
        raise ValueError("the JAX cases run under a group")
    metrics = mesh.pretrain_step(state.models, state.optimizer, cfg, batch, g,
                                 deterministic=True, draws=draws)
    out = params(state.models)
    out.update({f"b:{c}.{n}": v.numpy().copy() for c, m in state.models.items()
                for n, v in m.named_buffers()})
    out.update({f"m:{k}": metrics[k].numpy() for k in METRICS})
    return out


def case_pre_jax(out_dir):
    return _pretrain_jax("pre_jax", out_dir)


def case_pre_jax_microbatch(out_dir):
    return _pretrain_jax("pre_jax_microbatch", out_dir, 4, "splice")


def cl_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = rng.normal(size=(16, 6)).astype(np.float32)
    mask = rng.random(16) < 0.7
    return x, y, mask


def case_contrastive(out_dir):
    """``dual_cl`` of each metric: loss, accuracy, and the input gradients
    divided by the world size (the collectives' convention), with the
    EBM_node_dot_prod shifts drawn from a generator and from JAX's key."""
    x, y, mask = cl_inputs()
    shifts = draws_of("contrastive", out_dir)["shifts"]
    out = {}
    for metric in ("InfoNCE_dot_prod", "EBM_dot_prod", "EBM_node_dot_prod"):
        for how in ("generator", "jax"):
            xt, yt = rows(x).requires_grad_(True), rows(y).requires_grad_(True)
            kw = (dict(generator=torch.Generator().manual_seed(STEP_SEED)) if how == "generator"
                  else dict(shifts=tuple(torch.as_tensor(s) for s in shifts)))
            loss, acc = dual_cl(xt, yt, metric, 0.1, mask=rows(mask), **kw)
            loss.backward()
            key = f"{metric}.{how}"
            out[f"loss:{key}"], out[f"acc:{key}"] = loss.detach().numpy(), acc.numpy()
            out[f"gx:{key}"] = (xt.grad / dp.world_size()).numpy()
            out[f"gy:{key}"] = (yt.grad / dp.world_size()).numpy()
    return out


def case_collectives(out_dir):
    """The collectives' values and gradients: a sum over ranks and a
    gathered square, each the same global loss on every rank."""
    x = (torch.arange(6.0).reshape(3, 2) + 10 * dp.rank()).requires_grad_(True)
    s = dp.global_sum(x.sum() * 2.0)
    s.backward()
    g_sum = x.grad.clone()
    x.grad = None
    gathered = dp.all_gather_rows(x)
    (gathered ** 2).sum().backward()
    return {"sum": s.detach().numpy(), "g_sum": g_sum.numpy(), "gathered": gathered.detach().numpy(),
            "g_gather": x.grad.numpy(), "mean": dp.global_mean(x.detach()).numpy(),
            "masked": dp.masked_mean(x.detach(), x.detach() > 3).numpy()}


def case_batchnorm(out_dir):
    """MaskedBatchNorm and PairMaskedBatchNorm in training mode on a global
    batch's blocks, and dropout's masks: outputs, input and parameter
    gradients (averaged), running statistics."""
    rng = np.random.default_rng(8)
    x = rows(rng.normal(size=(16, 4)).astype(np.float32)).requires_grad_(True)
    mask = rows(rng.random(16) < 0.8)
    src = rows(rng.normal(size=(4, 5, 3)).astype(np.float32)).requires_grad_(True)
    dst = rows(rng.normal(size=(4, 5, 3)).astype(np.float32)).requires_grad_(True)
    pair_mask = rows(rng.random((4, 5, 5)) < 0.7)
    bn, pbn = MaskedBatchNorm(4), PairMaskedBatchNorm(3)
    with torch.no_grad():
        for m in (bn, pbn):
            m.scale.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    y = bn(x, mask)
    a, c = pbn(src, dst, pair_mask)
    drop = dropout(rows(np.ones((16, 4), np.float32)), 0.5, torch.Generator().manual_seed(2))
    loss = dp.global_sum((y * y.detach().cos()).sum() + (a * a.detach().sin()).sum()
                         + (c * c.detach().cos()).sum() + (drop * x).sum())
    loss.backward()
    _average([bn, pbn])
    w = dp.world_size()
    out = named("g:", {"bn": bn, "pbn": pbn})
    out.update({"y": y.detach().numpy(), "a": a.detach().numpy(), "c": c.detach().numpy(),
                "drop": drop.numpy(), "gx": (x.grad / w).numpy(),
                "gsrc": (src.grad / w).numpy(), "gdst": (dst.grad / w).numpy()})
    return out


def case_replicate(out_dir):
    """Two differently seeded models made rank 0's."""
    model = GNNGraphPred(num_tasks=2, num_layers=2, emb_dim=8, device="cpu",
                         generator=torch.Generator().manual_seed(100 + dp.rank()))
    before = params({"m": model})
    mesh.replicate([model])
    return {**{f"before.{k}": v for k, v in before.items()}, **params({"m": model}),
            **{f"b:{n}": v.numpy() for n, v in model.named_buffers()}}


# ---------------------------------------------------------------- samplers

def sampler_2d3d():
    model = SDEModel2Dto3D(emb_dim=EMB, hidden_dim=8, variant=1, sde_type="VE", beta_min=0.2,
                           beta_max=1.0, num_diffusion_timesteps=6, device="cpu",
                           generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():   # running statistics away from their initial values
        for name, buf in model.named_buffers():
            buf.mul_(1.3).add_(0.1)
    batch = padded(graphs(71))
    node_2d = np.random.default_rng(72).normal(size=(batch.num_nodes, EMB)).astype(np.float32)
    return model, batch, node_2d


def sampler_3d2d():
    model = SDEModel3Dto2D(dim3d=EMB, nhid=8, num_layers=2, num_linears=2, c_init=2, c_hid=4,
                           c_final=3, adim=8, variant=1, sde_type="VE", beta_min=0.1,
                           beta_max=1.0, num_diffusion_timesteps=6, bf16_attn=False,
                           device="cpu", generator=torch.Generator().manual_seed(SEED))
    batch = padded(graphs(73))
    node_3d = np.random.default_rng(74).normal(size=(batch.num_nodes, EMB)).astype(np.float32)
    return model, batch, node_3d


def case_sample_positions(out_dir):
    model, batch, node_2d = sampler_2d3d()
    kw = dict(n_steps=SAMPLER_STEPS, corrector_steps=CORRECTOR)
    pos = sample_positions_pc(model, rows(node_2d), local(batch),
                              torch.Generator().manual_seed(STEP_SEED), **kw)
    d = draws_of("sample_positions", out_dir)
    pos_jax = sample_positions_pc(model, rows(node_2d), local(batch), prior=rows(d["prior"]),
                                  noise_p=rows(d["noise_p"], 1), noise_c=rows(d["noise_c"], 2),
                                  **kw)
    return {"pos": pos.numpy(), "pos_jax": pos_jax.numpy()}


def case_sample_graph(out_dir):
    model, batch, node_3d = sampler_3d2d()
    kw = dict(n_steps=SAMPLER_STEPS, corrector_steps=CORRECTOR)
    out = sample_graph_pc(model, rows(node_3d), local(batch),
                          torch.Generator().manual_seed(STEP_SEED), **kw)
    d = draws_of("sample_graph", out_dir)
    out_jax = sample_graph_pc(model, rows(node_3d), local(batch), x_prior=rows(d["x_prior"]),
                              adj_prior=rows(d["adj_prior"]),
                              noise=torch.as_tensor(d["noise"]), **kw)
    names = ("x", "adj", "x_mean", "adj_mean")
    return {**{n: v.numpy() for n, v in zip(names, out)},
            **{f"{n}_jax": v.numpy() for n, v in zip(names, out_jax)}}


# ---------------------------------------------------------------- finetunes

TASKS = 3


def finetune_batch():
    gs = graphs(81, count=B - 1, tasks=TASKS)    # one empty graph slot, masked
    batch = padded(gs, num_graphs=B, num_tasks=TASKS, with_forces=True)
    return batch, torch.arange(B) < len(gs)


def classification_model(drop_ratio: float):
    return GNNGraphPred(num_tasks=TASKS, num_layers=2, emb_dim=16, drop_ratio=drop_ratio,
                        device="cpu", generator=torch.Generator().manual_seed(SEED))


def regression_model():
    enc = SchNet(hidden_channels=16, num_filters=8, num_interactions=2, num_gaussians=10,
                 cutoff=10.0, cfconv="xla", device="cpu",
                 generator=torch.Generator().manual_seed(SEED))
    return RegressionModel(enc, head="linear", generator=torch.Generator().manual_seed(SEED))


def regression_targets():
    rng = np.random.default_rng(82)
    return (rng.normal(size=B).astype(np.float32),
            rng.normal(size=(B * N_MAX, 3)).astype(np.float32))


def case_finetune_classification(out_dir):
    """The evaluation logits and one step's loss and gradients before Adam,
    with dropout 0.5 (generator) and with none (JAX's test)."""
    batch, gm = finetune_batch()
    out = {}
    for drop in (0.5, 0.0):
        model = classification_model(drop)
        if drop == 0.0:
            out["pred"] = classification_eval(model, local(batch)).numpy()
        loss = classification_loss(model, local(batch), rows(gm),
                                   torch.Generator().manual_seed(STEP_SEED))
        loss.backward()
        _average([model])
        out.update(named(f"g{drop}:", {"model": model}))
        out[f"loss{drop}"] = loss.detach().numpy()
    return out


def case_finetune_regression(out_dir):
    batch, gm = finetune_batch()
    y, _ = regression_targets()
    model = regression_model()
    pred = regression_eval(model, local(batch))
    loss = regression_loss(model, local(batch), rows(y), rows(gm))
    loss.backward()
    _average([model])
    return {"pred": pred.numpy(), "loss": loss.detach().numpy(), **named("g:", {"model": model})}


def case_finetune_md17(out_dir):
    batch, gm = finetune_batch()
    y_e, y_f = regression_targets()
    model = regression_model()
    energy, forces = md17_eval(model, local(batch))
    loss, parts = md17_loss(model, local(batch), rows(y_e), rows(y_f), rows(gm))
    loss.backward()
    _average([model])
    return {"energy": energy.numpy(), "forces": forces.numpy(), "loss": loss.detach().numpy(),
            **{k: v.detach().numpy() for k, v in parts.items()}, **named("g:", {"model": model})}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def cli_runs(group, device, jobs):
    """Each job's CLI (``(name, module, argv)``) as this rank of a group
    spawned by ``parallel.mesh.spawn``: {name: what the CLI's ``run``
    returns}, in order, as ``--num_devices`` would run it."""
    from moleculesde_tpu_torch.examples import finetune_flags

    out = {}
    for name, module, argv in jobs:
        mod = importlib.import_module(module)
        parser = getattr(mod, "get_parser", finetune_flags.get_parser)
        out[name] = mod.run(parser().parse_args(argv), device)
    return out


def main(argv):
    rank, world, port, out_dir, *cases = argv
    torch.set_num_threads(1)
    mesh.initialize_distributed(f"localhost:{port}", int(world), int(rank), device="cpu",
                                timeout=datetime.timedelta(seconds=90))
    try:
        with dp.data_parallel(mesh.current_group()):
            for case in cases:
                np.savez(os.path.join(out_dir, f"{case}.r{rank}.npz"), **CASES[case](out_dir))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
