"""Port parity: data parallelism (moleculesde_tpu_torch.parallel) in the
microbatched pretraining step, against the port's one-process run and the
JAX package's sharded step (the unchunked step:
test_torch_port_parallel.py, whose helpers and bars this file shares).

Two gloo ranks on the CPU run each case on the blocks of a global batch of
8 graphs, in chunks of 4 graphs (2 a rank).

- Against the one-process run on the shard-aligned chunks of two ranks
  (``pretrain_grads(shards=2)``), f32, dropout on: the "step" scope on a
  compact batch (InfoNCE) and the "splice" scope on a padded batch
  (EBM_node_dot_prod); loss terms and running statistics to 1e-5, every
  gradient leaf before Adam to 1e-5 of its largest value or 1e-6 of the
  step's largest gradient, whichever is larger.
- Against JAX's ``make_sharded_pretrain_step`` with ``microbatch=4``,
  ``microbatch_scope="score"`` (the port's "splice" runs it) on a 2-device
  mesh, dropout off and each chunk's draws replayed from JAX's keys: loss
  terms rtol 1e-3, the parameters after Adam and the statistics as the
  unchunked step's.
"""

import pytest

from test_torch_port_parallel import (
    check_jax_step, check_one_process, module_ranks, write_draws)
import torch_port_parallel_worker as w
from torch_port_common import ieee_f32  # noqa: F401 (ieee_f32: autouse)

ONE_PROCESS = ["pre_microbatch_step", "pre_microbatch_splice"]
CASES = ONE_PROCESS + ["pre_jax_microbatch"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    yield from module_ranks(tmp_path_factory, "parallel_microbatch", CASES, write_draws)


def test_two_ranks_match_jax_sharded_microbatched_step(ranks):
    check_jax_step(ranks, "pre_jax_microbatch", 4, "score")


@pytest.mark.parametrize("case", ONE_PROCESS)
def test_two_ranks_match_one_process(ranks, case):
    out, get = ranks
    check_one_process(w.CASES[case](str(out)), get(case))
