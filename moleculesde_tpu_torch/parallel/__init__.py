"""Data parallelism: process groups, per-rank batches and reductions over
the global batch (counterpart of ``moleculesde_tpu/parallel``)."""

from moleculesde_tpu_torch.parallel.collectives import (
    DataGroup,
    active,
    all_gather_rows,
    average_grads,
    block,
    data_parallel,
    global_mean,
    global_sum,
    masked_mean,
)
from moleculesde_tpu_torch.parallel.mesh import (
    current_group,
    initialize_distributed,
    pretrain_step,
    rank_block,
    replicate,
    shard_for_process,
    spawn,
)

__all__ = [
    "DataGroup", "active", "all_gather_rows", "average_grads", "block", "current_group",
    "data_parallel", "global_mean", "global_sum", "initialize_distributed", "masked_mean",
    "pretrain_step", "rank_block", "replicate", "shard_for_process", "spawn",
]
