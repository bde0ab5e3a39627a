"""One step of the joint pretraining objective.

Counterpart of ``moleculesde_tpu/pretrain/train_step.py`` (reference
examples/pretrain_MoleculeSDE.py:106-156): GIN and the 3D encoder forward,
the dual contrastive loss, the 2D->3D and 3D->2D score-matching losses, one
Adam update.  BatchNorm running statistics of ``model_2D`` and
``SDE_2Dto3D_model`` update in place as the forward runs.

A step takes a padded :class:`GraphBatch` or a :class:`CompactBatch`, which
it expands on the device (``data/compact.py``).  With ``cfg.microbatch = m``
and a batch of B > m molecules, B % m == 0, the step runs in k = B / m
chunks (JAX's ``make_pretrain_step`` gating, l.128-131 and 443-449) under
``cfg.microbatch_scope``:

- ``"step"``: gradient accumulation over the whole loss, each chunk's loss
  (its own contrastive negatives) scaled by 1/k, metrics averaged; a
  compact batch is expanded chunk by chunk;
- ``"score"`` / ``"splice"``: the encoders and the contrastive loss at the
  full batch, the two score losses chunk by chunk (their mean over chunks).
  Both run one code path: each chunk's score losses run their backward into
  leaf copies of the encoder outputs and the score models' weights, then one
  backward takes the encoders the summed cotangents (JAX's ``"splice"``).
  JAX's ``"score"`` gets the same numbers by recomputing each chunk in its
  backward, a memory choice for the TPU; here nothing is recomputed.

``"score"`` and ``"splice"`` need both generative coefficients > 0;
otherwise, and when B <= m or m does not divide B, the step is the plain
single-batch step.  Under every scope the 2D->3D model's BatchNorm
statistics update chunk by chunk, in order.

Randomness: dropout masks and every loss draw come from one
``torch.Generator`` in execution order, or the draws are passed explicitly
(``draws``, as :func:`draw_losses` / :func:`draw_chunked` make them) so a
test can hand both frameworks the same noise.

Under a data-parallel group (``parallel/``) the batch is the rank's block
of the global batch and the generator is seeded alike on every rank: every
draw and dropout mask is made at the global batch's shape and the rank
keeps its block, every reduction across molecules is global, and the
parameter gradients are averaged over the ranks, so W ranks with a seed
take the step one process takes on the global batch with that seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from moleculesde_tpu_torch.core.batch import GraphBatch
from moleculesde_tpu_torch.data.compact import CompactBatch, expand_on_device
from moleculesde_tpu_torch.parallel import collectives as dp
from moleculesde_tpu_torch.pretrain.contrastive import draw_shift, dual_cl
from moleculesde_tpu_torch.pretrain.train_state import PretrainConfig

METRICS = ("CL_loss", "CL_acc", "SDE_loss_2Dto3D", "SDE_loss_3Dto2D", "loss")
SCOPES = ("step", "score", "splice")

Batch = Union[GraphBatch, CompactBatch]


def _expanded(batch: Batch) -> GraphBatch:
    return expand_on_device(batch) if isinstance(batch, CompactBatch) else batch


def _split_rows(x: torch.Tensor, k: int, shards: int = 1) -> torch.Tensor:
    """Flat per-graph rows [B * per, ...] as k chunks [k, B / k * per, ...]:
    contiguous, or with ``shards`` > 1 chunk j made of the j-th block of
    each of ``shards`` equal shards (JAX's ``_split_rows``)."""
    rest = tuple(x.shape[1:])
    if shards == 1:
        return x.reshape((k, x.shape[0] // k) + rest)
    y = x.reshape((shards, k, x.shape[0] // (shards * k)) + rest)
    return y.transpose(0, 1).reshape((k, x.shape[0] // k) + rest)


def split_microbatches(batch: Batch, k: int, shards: int = 1) -> List[Batch]:
    """``batch`` as k equal chunks of B / k graphs, in order.  A compact
    batch holds graph-local indices, so its chunks are slices.  A padded
    batch numbers nodes ``b * n_max + i``: the four edge endpoint lists are
    shifted to chunk-local numbering, and padded edges, which point at
    global node 0, are clamped back to node 0 of their chunk (masked
    anyway), as JAX's ``split_microbatches`` does.  ``shards`` > 1 gives
    JAX's shard-aligned chunks: chunk j holds the j-th block of each of
    ``shards`` equal shards of the batch, the chunk a data-parallel run of
    ``shards`` ranks runs as its j-th."""
    nb = batch.num_graphs
    if nb % k or (nb // k) % shards:
        raise ValueError(f"{nb} graphs do not split into {k} chunks over {shards} shards")
    mb = nb // k
    shifted = ("edge_src", "edge_dst", "ext_src", "ext_dst")
    tensors = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
               if torch.is_tensor(getattr(batch, f.name))}
    chunks = []
    for i in range(k):
        fields = {name: _split_rows(v, k, shards)[i] for name, v in tensors.items()}
        if isinstance(batch, GraphBatch):
            # each graph's place in the batch minus its place in the chunk
            graph = torch.arange(nb, device=batch.node_mask.device)
            first = _split_rows(graph, k, shards)[i] - torch.arange(mb, device=graph.device)
            for name in shifted:
                per = tensors[name].shape[0] // nb
                shift = first.repeat_interleave(per) * batch.n_max
                fields[name] = (fields[name] - shift.to(fields[name].dtype)).clamp(min=0)
        chunks.append(dataclasses.replace(batch, **fields, num_graphs=mb))
    return chunks


def microbatch_chunks(cfg: PretrainConfig, num_graphs: int) -> int:
    """The number of chunks the step runs in: B / microbatch where JAX's
    gating holds for ``cfg.microbatch_scope``, else 1 (``num_graphs`` is
    the global batch's under a data-parallel group)."""
    if cfg.microbatch_scope not in SCOPES:
        raise ValueError(f"unknown microbatch_scope {cfg.microbatch_scope}")
    mb = cfg.microbatch
    if not mb or num_graphs <= mb or num_graphs % mb:
        return 1
    if cfg.microbatch_scope != "step" and not (cfg.coeff_generative_2dto3d > 0
                                               and cfg.coeff_generative_3dto2d > 0):
        return 1
    return num_graphs // mb


def draw_losses(models: Dict[str, nn.Module], cfg: PretrainConfig, batch: Batch,
                generator: Optional[torch.Generator]) -> Dict[str, object]:
    """Every loss draw of one step: the two contrastive shifts
    (``EBM_node_dot_prod`` only) and each score model's noise and
    timesteps (the same for a padded batch and the compact batch of the
    same molecules)."""
    return {"cl": _draw_cl(cfg, batch, generator), **_draw_sde(models, batch, generator)}


def _draw_cl(cfg, batch, generator):
    if cfg.cl_similarity_metric != "EBM_node_dot_prod":
        return None
    return tuple(draw_shift(batch.num_nodes, generator, batch.positions.device)
                 for _ in range(2))


def _draw_sde(models, batch, generator):
    return {"sde_2dto3d": models["SDE_2Dto3D_model"].draw(batch, generator),
            "sde_3dto2d": models["SDE_3Dto2D_model"].draw(batch, generator)}


def draw_chunked(models: Dict[str, nn.Module], cfg: PretrainConfig, batch: Batch,
                 k: int, generator: Optional[torch.Generator]) -> Dict[str, object]:
    """The draws of a ``"score"`` / ``"splice"`` step: the contrastive
    shifts at the full batch, then each chunk's score-model draws
    (``{"cl": ..., "chunks": [{"sde_2dto3d": ..., "sde_3dto2d": ...}]}``)."""
    return {"cl": _draw_cl(cfg, batch, generator),
            "chunks": [_draw_sde(models, c, generator)
                       for c in split_microbatches(batch, k)]}


def _score_losses(models, cfg, node_2d, node_3d, batch, generator, deterministic, d):
    """(2D->3D loss, 3D->2D loss) of one batch or chunk."""
    loss_23 = models["SDE_2Dto3D_model"].loss(
        node_2d, batch, generator, cfg.anneal_power, deterministic,
        use_running_average=False, draws=d["sde_2dto3d"])
    loss_x, loss_adj = models["SDE_3Dto2D_model"].loss(
        node_3d, batch, generator, cfg.anneal_power, cfg.reduce_mean,
        draws=d["sde_3dto2d"])
    return loss_23, 0.5 * (loss_x + loss_adj)


def pretrain_loss(models: Dict[str, nn.Module], cfg: PretrainConfig, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  coeff_contrastive: Optional[float] = None, deterministic: bool = False,
                  draws: Optional[Dict[str, object]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The joint loss of one unchunked batch (padded, or compact and then
    expanded) and its metrics (``CL_loss, CL_acc, SDE_loss_2Dto3D,
    SDE_loss_3Dto2D, loss``).  ``deterministic`` turns dropout off;
    ``coeff_contrastive`` defaults to the config's."""
    batch = _expanded(batch)
    coeff = cfg.coeff_contrastive if coeff_contrastive is None else coeff_contrastive
    d = draws if draws is not None else draw_losses(models, cfg, batch, generator)
    node_2d = models["model_2D"](batch, use_running_average=False,
                                 deterministic=deterministic, generator=generator)
    _, node_3d = models["model_3D"].encode_batch(batch)
    cl_loss, cl_acc = dual_cl(node_2d, node_3d, cfg.cl_similarity_metric, cfg.T,
                              cfg.cl_neg_samples, batch.node_mask, cfg.normalize,
                              shifts=d["cl"])
    total = coeff * cl_loss
    zero = torch.zeros((), device=node_2d.device)
    loss_23 = loss_32 = zero
    if cfg.coeff_generative_2dto3d > 0:
        loss_23 = models["SDE_2Dto3D_model"].loss(
            node_2d, batch, generator, cfg.anneal_power, deterministic,
            use_running_average=False, draws=d["sde_2dto3d"])
        total = total + cfg.coeff_generative_2dto3d * loss_23
    if cfg.coeff_generative_3dto2d > 0:
        loss_x, loss_adj = models["SDE_3Dto2D_model"].loss(
            node_3d, batch, generator, cfg.anneal_power, cfg.reduce_mean,
            draws=d["sde_3dto2d"])
        loss_32 = 0.5 * (loss_x + loss_adj)
        total = total + cfg.coeff_generative_3dto2d * loss_32
    return total, {"CL_loss": cl_loss, "CL_acc": cl_acc, "SDE_loss_2Dto3D": loss_23,
                   "SDE_loss_3Dto2D": loss_32, "loss": total}


def _splice_scope_grads(models, cfg, batch, k, generator, coeff, deterministic, d,
                        shards=1):
    """The ``"score"`` / ``"splice"`` scopes (JAX ``make_pretrain_grads_spliced``):
    fills every ``.grad`` and returns the metrics.  The contrastive loss and
    the chunks' score losses run their backward into leaf copies of the
    encoder outputs (a chunk's row slice accumulates into the leaves'
    ``.grad``) and the score models' weights; the encoders' backward then
    runs once, on the summed cotangents."""
    node_2d = models["model_2D"](batch, use_running_average=False,
                                 deterministic=deterministic, generator=generator)
    _, node_3d = models["model_3D"].encode_batch(batch)
    leaf_2d = node_2d.detach().requires_grad_(True)
    leaf_3d = node_3d.detach().requires_grad_(True)
    cl_loss, cl_acc = dual_cl(leaf_2d, leaf_3d, cfg.cl_similarity_metric, cfg.T,
                              cfg.cl_neg_samples, batch.node_mask, cfg.normalize,
                              shifts=d["cl"])
    (coeff * cl_loss).backward()
    l23 = l32 = 0.0
    chunks = split_microbatches(batch, k, shards)
    for i, (chunk, dc) in enumerate(zip(chunks, d["chunks"])):
        a, b = _score_losses(models, cfg, _split_rows(leaf_2d, k, shards)[i],
                             _split_rows(leaf_3d, k, shards)[i], chunk, generator,
                             deterministic, dc)
        ((cfg.coeff_generative_2dto3d * a + cfg.coeff_generative_3dto2d * b) / k).backward()
        l23, l32 = l23 + a.detach(), l32 + b.detach()
    torch.autograd.backward((node_2d, node_3d), (leaf_2d.grad, leaf_3d.grad))
    cl_loss = cl_loss.detach()
    loss_23, loss_32 = l23 / k, l32 / k
    total = (coeff * cl_loss + cfg.coeff_generative_2dto3d * loss_23
             + cfg.coeff_generative_3dto2d * loss_32)
    return {"CL_loss": cl_loss, "CL_acc": cl_acc.detach(), "SDE_loss_2Dto3D": loss_23,
            "SDE_loss_3Dto2D": loss_32, "loss": total}


def pretrain_grads(models: Dict[str, nn.Module], cfg: PretrainConfig, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   coeff_contrastive: Optional[float] = None, deterministic: bool = False,
                   draws=None, shards: int = 1) -> Dict[str, torch.Tensor]:
    """The step's gradients, into every parameter's ``.grad`` (added to what
    is there), under the microbatch scope that applies (module docstring);
    returns the metrics.  ``draws``: :func:`draw_losses`' dict for an
    unchunked step, a list of them (one per chunk) under ``"step"``,
    :func:`draw_chunked`'s dict under ``"score"`` / ``"splice"``.
    ``shards``: the chunks of :func:`split_microbatches` (shards > 1 is the
    one-process run of what that many data-parallel ranks run).  Under a
    data-parallel group ``batch`` is the rank's block and the chunk count
    is the global batch's; every rank splits its block."""
    coeff = cfg.coeff_contrastive if coeff_contrastive is None else coeff_contrastive
    k = microbatch_chunks(cfg, dp.global_shape((batch.num_graphs,))[0])
    if k > 1 and cfg.microbatch_scope == "step":
        sums = None
        for i, chunk in enumerate(split_microbatches(batch, k, shards)):
            total, metrics = pretrain_loss(models, cfg, _expanded(chunk), generator, coeff,
                                           deterministic, draws[i] if draws else None)
            (total / k).backward()
            vals = {m: v.detach() for m, v in metrics.items()}
            sums = vals if sums is None else {m: sums[m] + vals[m] for m in METRICS}
        return {m: v / k for m, v in sums.items()}
    batch = _expanded(batch)
    if k > 1:
        d = draws if draws is not None else draw_chunked(models, cfg, batch, k, generator)
        return _splice_scope_grads(models, cfg, batch, k, generator, coeff, deterministic, d,
                                   shards)
    total, metrics = pretrain_loss(models, cfg, batch, generator, coeff, deterministic, draws)
    total.backward()
    return metrics


def pretrain_step(models: Dict[str, nn.Module], optimizer: torch.optim.Optimizer,
                  cfg: PretrainConfig, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  coeff_contrastive: Optional[float] = None,
                  deterministic: bool = False, draws=None) -> Dict[str, torch.Tensor]:
    """Gradients (:func:`pretrain_grads`) and one optimizer update; returns
    the metrics as detached device scalars (reading them is the caller's
    sync).  Under a data-parallel group the gradients are averaged over the
    ranks before the update (``parallel.pretrain_step``)."""
    optimizer.zero_grad(set_to_none=True)
    metrics = pretrain_grads(models, cfg, batch, generator, coeff_contrastive,
                             deterministic, draws)
    dp.average_grads(p for m in models.values() for p in m.parameters())
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}
