"""Port parity past n_max 32: K6's plain version
(``moleculesde_tpu_torch.ops.score_kernel.score_eval_fused_plain``) at N = 40
against the JAX package's Pallas kernel in interpret mode (variants 1 and
2, f32 and bf16, at the bars of ``test_torch_port_score_kernel.py``: f32
2e-5 of the largest value, sums in another order; bf16 1e-2, both sides
rounding at the same points); at N = 100 (four chunks of 32 sources in
the kernel, the last ragged) f32 at 2e-5 and bf16 held to JAX's own f32
result, no further from it than JAX's bf16 result is (1.5 x + 1e-3); and
K6's launch plan ``score_plan``: a cluster of 2 blocks per molecule up to
n_max 32, 4 up to 64 and 8 up to 128, the shared memory of each plan, and
past 128 the layered plan (the cluster plan, forced there, refuses).  The
kernel itself runs only on the card (``test_torch_port_kernels.py``)."""

import functools

import numpy as np
import pytest
import torch

from moleculesde_tpu.ops.score_kernel import pack_score_params as jax_pack
from moleculesde_tpu.ops.score_kernel import score_eval_fused as jax_score_eval_fused
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT
from moleculesde_tpu_torch.ops.score_kernel import (
    KERNEL_N_MAX, layered_smem, pack_score_params, score_eval_fused, score_eval_fused_plain,
    score_layout_bytes, score_plan, score_scratch_bytes, score_slab_bytes)

from test_torch_port_score_kernel import _models, _operands
from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [1, 2])
def test_score_eval_fused_plain_matches_pallas_kernel_past_32(variant, bf16):
    """N = 40: two chunks of 32 sources in the kernel, the second ragged."""
    v, tm = _models(variant)
    pos, node, edge, mask = _operands(10 + variant, b=1, n=40)
    ref = np.asarray(jax_score_eval_fused(pos, node, edge, mask, jax_pack(v["params"], variant),
                                          variant=variant, bf16=bf16, interpret=True))
    out = score_eval_fused_plain(t(pos), t(node), t(edge), t(mask),
                                 pack_score_params(tm, variant), variant=variant, bf16=bf16)
    assert out.shape == ref.shape == (1, 40, 3)
    assert rel_err(out.numpy(), ref) <= (1e-2 if bf16 else 2e-5)


@functools.lru_cache(maxsize=None)
def _n100(variant: int, bf16: bool):
    """(port, JAX) score at N = 100, B = 1 in one mode, on one set of weights
    and operands per variant (the f32 JAX result is the bf16 case's oracle)."""
    v, tm = _models(variant)
    pos, node, edge, mask = _operands(30 + variant, b=1, n=100)
    ref = np.asarray(jax_score_eval_fused(pos, node, edge, mask, jax_pack(v["params"], variant),
                                          variant=variant, bf16=bf16, interpret=True))
    out = score_eval_fused_plain(t(pos), t(node), t(edge), t(mask),
                                 pack_score_params(tm, variant), variant=variant, bf16=bf16)
    return out.numpy(), ref


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [1, 2])
def test_score_eval_fused_plain_matches_pallas_kernel_at_100(variant, bf16):
    """N = 100: four chunks of 32 sources in the kernel, the last ragged.
    f32: 2e-5 of the largest value (read 3.4e-7 / 5.7e-7 for variants 1 /
    2).  bf16: both bf16 results against JAX's f32 one, the port's no
    further than 1.5 x JAX's own + 1e-3 (read: the port 7.4e-3 / 6.1e-3,
    JAX 5.2e-3 / 6.5e-3).  The N = 40 bar of 1e-2 between the two bf16
    results is not used here: they round the same values but sum them in
    another order, and over 100 sources and four GAT layers their distance
    from each other (6.3e-3 / 6.5e-3 here; 1.06e-2 for variant 1 on
    another seed) is that of either from the f32 result."""
    out, ref = _n100(variant, bf16)
    assert out.shape == ref.shape == (1, 100, 3)
    if not bf16:
        assert rel_err(out, ref) <= 2e-5
        return
    oracle = _n100(variant, False)[1]
    port, jax_own = rel_err(out, oracle), rel_err(ref, oracle)
    assert port <= 1.5 * jax_own + 1e-3, (port, jax_own)


# (n_max, blocks per molecule, destinations per block, threads per block)
PLANS = [(1, 2, 1, 512), (11, 2, 6, 512), (32, 2, 16, 512), (33, 4, 9, 256),
         (40, 4, 10, 256), (64, 4, 16, 256), (65, 8, 9, 256), (96, 8, 12, 256),
         (128, 8, 16, 256)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n, cluster, dests, threads", PLANS)
def test_score_plan_clusters(n, cluster, dests, threads, bf16):
    plan = score_plan(n, bf16)
    assert (plan["cluster"], plan["dests"], plan["threads"]) == (cluster, dests, threads)
    assert dests == -(-n // cluster)   # the last block may own fewer, or none
    assert plan["smem"] == score_layout_bytes(n, dests, bf16) <= SMEM_LIMIT


def test_score_plan_fits_every_n_max_it_takes():
    for n in range(1, KERNEL_N_MAX + 1):
        for bf16 in (False, True):
            assert score_plan(n, bf16)["smem"] <= SMEM_LIMIT


def test_score_plan_shared_memory_at_the_main_shapes():
    """The bytes csrc/score_eval.cu's layout gives (the card test
    test_score_eval_plan_matches_kernel holds the kernel's own count to
    them): the slab, 37 KB of weights, the double-buffered node state, q /
    k / v / skip, the warps' tiles in bf16 mode and the small rows.  Past
    n_max 64 the slab lives in device memory (``score_slab_bytes``)."""
    assert score_plan(32, True)["smem"] == 182464
    assert score_plan(32, False)["smem"] == 133312
    assert score_plan(64, True)["smem"] == 213056
    assert score_plan(64, False)["smem"] == 225344
    assert score_plan(128, True)["smem"] == 186176
    assert score_plan(128, False)["smem"] == 149312
    # a bf16 slab row is 80 bytes, an f32 one 128: 16 destinations x 64
    # sources differ by 48 B a row
    assert (score_layout_bytes(64, 16, False) - score_layout_bytes(64, 16, True)
            == 16 * 64 * 48 - 8 * 4608)
    # past 64 only the warps' tiles (bf16 mode) tell the modes apart
    assert score_layout_bytes(128, 16, True) - score_layout_bytes(128, 16, False) == 8 * 4608
    assert score_slab_bytes(64, 128, True) == 64 << 20
    assert score_slab_bytes(64, 128, False) == 128 << 20
    assert score_slab_bytes(64, 64, True) == 0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [65, 128])
def test_score_plan_past_64(n, bf16):
    """Past n_max 64, where the plan refused before: clusters of 8 blocks,
    four source chunks a lane, 256 threads, the slab in device memory."""
    plan = score_plan(n, bf16)
    assert (plan["cluster"], plan["threads"]) == (8, 256)
    assert plan["smem"] == score_layout_bytes(n, plan["dests"], bf16) <= SMEM_LIMIT
    assert score_slab_bytes(1, n, bf16) == n * 128 * 32 * (2 if bf16 else 4)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [129, 256])
def test_score_plan_refuses_past_128(n, bf16):
    """Past n_max 128, where the cluster plan stops (the plan refused there
    before): the layered plan; the cluster plan, forced, still refuses,
    naming its limit."""
    mode = "bf16" if bf16 else "f32"
    assert KERNEL_N_MAX == 128
    assert score_plan(n, bf16) == {"plan": "layered", "dests": 8, "threads": 256,
                                   "smem": layered_smem(bf16),
                                   "scratch": score_scratch_bytes(1, n, bf16)}
    with pytest.raises(ValueError, match=f"n_max {n} is past the cluster plan .*"
                                         f"n_max <= {KERNEL_N_MAX} in {mode} mode"):
        score_plan(n, bf16, plan="cluster")


def test_kernel_wrapper_checks_the_plan_before_the_device():
    """On CPU tensors ``impl="kernel"`` raises for want of a CUDA tensor, in
    the layered plan (n_max 129) as in the cluster plan (40), and forcing
    the cluster plan past 128 raises with the plan's message; no launch is
    counted."""
    _, tm = _models(1)
    packed = pack_score_params(tm, 1)
    launches = score_eval_fused.launches
    pos, node, edge, mask = (t(x) for x in _operands(7, b=1, n=129))
    with pytest.raises(ValueError, match="past the cluster plan"):
        score_eval_fused(pos, node, edge, mask, packed, variant=1, impl="kernel",
                         plan="cluster")
    for n, match in ((129, "CUDA"), (40, "CUDA")):
        pos, node, edge, mask = (t(x) for x in _operands(7, b=1, n=n))
        with pytest.raises(ValueError, match=match):
            score_eval_fused(pos, node, edge, mask, packed, variant=1, impl="kernel")
    assert score_eval_fused.launches == launches
    out = score_eval_fused(pos, node, edge, mask, packed, variant=1)   # plain on the CPU
    assert out.shape == (1, 40, 3) and bool(torch.isfinite(out).all())
