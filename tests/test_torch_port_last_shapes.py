"""Port parity at the last shapes the kernels refused: K6 past n_max 128
(the layered plan) and K7 at q / k widths past a block's shared memory (the
grouped plan).

- K6's plain version (``score_eval_fused_plain``, what the wrapper takes on
  the CPU) at N = 136, B = 1, variant 1, against the JAX package's Pallas
  kernel in interpret mode, at the bars of
  ``test_torch_port_score_kernel_large.py``'s N = 100: f32 2e-5 of the
  largest value; bf16 held to JAX's own f32 result, no further from it than
  JAX's bf16 result is (1.5 x + 1e-3).
- K6's plan (``score_plan``): the layered plan past 128 with shared memory
  that does not change with N (the passes' rows, no weights), its device
  scratch by formula, the cluster
  plans unchanged up to 128, forcing "cluster" past 128 raising, and the
  int32 grid refusal naming its index.
- K7's plain versions at A = 320 (ds = 40) and 512 (ds = 64), B = 1, C = 2,
  N = 40, forward and backward, against ``jax.vjp`` of the Pallas kernels in
  interpret mode (f32 1e-5 / 1e-4, bf16 1e-2, as
  ``test_torch_port_bank_bwd_large.py``).
- K7's plan's group counts from A = 312 to 1024 at H = 8 and at H = 35.
The kernels themselves run only on the card (``test_torch_port_kernels.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moleculesde_tpu.ops.rejected.attn_bank import attn_map_bank_pallas
from moleculesde_tpu.ops.score_kernel import pack_score_params as jax_pack
from moleculesde_tpu.ops.score_kernel import score_eval_fused as jax_score_eval_fused
from moleculesde_tpu_torch.ops.attn_bank import (
    GROUPED_BWD_SMEM, SLICE_MAX, attn_map_bank_bwd_plain, attn_map_bank_plain, plan,
    row_stride, slice_width)
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT
from moleculesde_tpu_torch.ops.score_kernel import (
    KERNEL_N_MAX, layered_smem, pack_score_params, score_eval_fused_plain, score_plan,
    score_scratch_bytes)

from test_torch_port_attn_bank import _map_operands
from test_torch_port_score_kernel import _models, _operands
from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)


@functools.lru_cache(maxsize=None)
def _n136(bf16: bool):
    """(port, JAX) score at N = 136, B = 1, variant 1, in one mode (five
    chunks of 32 sources in the layered plan, the last ragged)."""
    v, tm = _models(1)
    pos, node, edge, mask = _operands(50, b=1, n=136)
    ref = np.asarray(jax_score_eval_fused(pos, node, edge, mask, jax_pack(v["params"], 1),
                                          variant=1, bf16=bf16, interpret=True))
    out = score_eval_fused_plain(t(pos), t(node), t(edge), t(mask), pack_score_params(tm, 1),
                                 variant=1, bf16=bf16)
    return out.numpy(), ref


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_score_eval_fused_plain_matches_pallas_kernel_at_136(bf16):
    out, ref = _n136(bf16)
    assert out.shape == ref.shape == (1, 136, 3)
    if not bf16:
        assert rel_err(out, ref) <= 2e-5
        return
    oracle = _n136(False)[1]
    port, jax_own = rel_err(out, oracle), rel_err(ref, oracle)
    assert port <= 1.5 * jax_own + 1e-3, (port, jax_own)


def _al(v: int) -> int:
    return -(-v // 256) * 256


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [129, 256, 1024, 2048])
def test_score_plan_layered(n, bf16):
    """Blocks of 8 destinations (a warp each), shared memory for the rows
    each pass keeps on the chip (the same at any N: the front
    pass's three [32][32] rows a warp, as bf16 fragments or f32; the GAT
    pass's tile of the logits' terms, softmax weights and FFN rows a warp,
    its kept rows in device scratch; the basis pass's [32][36] tile a
    warp), and device scratch: the slab (32 values a pair in the mode's
    type, sources padded to 32), the mask as [b][d][s], the counts, the
    node rows (128 floats a node), two node states, the weight image
    (vectors padded to 32 columns, basis_out's to 4, the per-pair kernels
    as bf16 fragment tiles or f32 tiles) and each warp's kept rows (v + e2
    of every pair, 32 floats a channel, and a logit a source chunk, head
    and lane), each region 256-byte aligned."""
    b = 2 if n < 2048 else 1
    p = score_plan(n, bf16, b=b)
    assert p == {"plan": "layered", "dests": 8, "threads": 256, "smem": layered_smem(bf16),
                 "scratch": score_scratch_bytes(b, n, bf16)}
    # the front pass's rows are the most: 8 warps x 3 x 32 channels x 32 pairs
    assert layered_smem(bf16) == 8 * 3 * 32 * 32 * (2 if bf16 else 4) <= SMEM_LIMIT
    assert layered_smem(bf16) == {True: 49152, False: 98304}[bf16]
    assert score_plan(n, bf16, b=b, variant=2)["smem"] == layered_smem(bf16)
    chunks = -(-n // 32)
    slab = _al(b * n * chunks * 32 * 32 * (2 if bf16 else 4))
    pair = 2 if bf16 else 1          # per-pair kernels: two bf16 values a float
    front = 32 + 4 * 32 * 32 // pair + 32 + 2 * 32 + 2 * 32 * 32 // pair + 32 + 32 * 32 // pair + 32
    gat = 6 * 32 * 32 + 32 * 32 // pair + 7 * 32 + 4 * 32
    basis = 32 * 128 + 32 * 128 // pair + 128 + 4 * 128 + 4
    image = 4 * (front + 4 * gat + 2 * basis)
    assert image == 4 * {True: 45384, False: 55112}[bf16]
    warps = b * -(-n // 8) * 8
    assert p["scratch"] == (slab + _al(4 * b * n * n) + _al(4 * b * n) + _al(4 * b * n * 128)
                            + 2 * _al(4 * b * n * 32) + _al(image)
                            + _al(warps * chunks * (32 * 32 + 8 * 32) * 4))
    if n == 1024 and bf16:
        # 128 MiB of slab, 8 MiB of mask, the counts, node rows, two node
        # states, 177 KiB of weights, 2048 warps' kept rows
        assert p["scratch"] == (134217728 + 8388608 + 8192 + 1048576 + 2 * 262144
                                + 181760 + 335544320) == 479913472


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_score_plan_cluster_up_to_128_and_forced_plans(bf16):
    """Up to n_max 128 the cluster plan, as before; forcing "layered" there
    gives the layered plan; forcing "cluster" past 128 raises, naming the
    cluster plan's limit; an unknown plan raises."""
    for n in range(1, KERNEL_N_MAX + 1):
        p = score_plan(n, bf16)
        assert p["plan"] == "cluster" and p["smem"] <= SMEM_LIMIT
        assert score_plan(n, bf16, plan="cluster") == p
    assert score_plan(32, bf16, plan="layered")["smem"] == layered_smem(bf16)
    for n in (129, 2048):
        with pytest.raises(ValueError, match=rf"n_max {n} is past the cluster plan "
                                             rf"\(n_max <= {KERNEL_N_MAX}"):
            score_plan(n, bf16, plan="cluster")
    with pytest.raises(ValueError, match="unknown plan"):
        score_plan(64, bf16, plan="tiled")


def test_score_plan_refuses_only_past_the_int32_grid():
    """The layered plan's only refusal at the sampler's widths: a launch
    whose blocks pass the int32 grid index (here the node passes' B N 128 /
    256 blocks)."""
    assert score_plan(2048, True, b=2 ** 20)["plan"] == "layered"
    with pytest.raises(ValueError, match=r"B=16777216, n_max 2048 need 17179869184 blocks in "
                                         r"the layered plan, past the int32 grid index "
                                         r"\(2147483647\)"):
        score_plan(2048, True, b=2 ** 24)


@pytest.mark.parametrize("a, ds", [(320, 40), (512, 64)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_map_bank_plain_matches_pallas_kernel_wide(a, ds, bf16):
    """K7 at q / k widths past both block plans (the forward's A <= 448, the
    backward's A <= 304 at H = 8): the maps, dq and dk of the plain versions
    against ``jax.vjp`` of the Pallas kernels in interpret mode."""
    q, k, g = _map_operands(60 + a, b=1, c=2, n=40, a=a)
    out_j, vjp = jax.vjp(lambda q_, k_: attn_map_bank_pallas(q_, k_, ds, bf16, True),
                         jnp.asarray(q), jnp.asarray(k))
    dq_j, dk_j = vjp(jnp.asarray(g))
    out = attn_map_bank_plain(t(q), t(k), ds, bf16=bf16)
    dq, dk = attn_map_bank_bwd_plain(t(q), t(k), t(g), ds, bf16=bf16)
    tol_f, tol_g = (1e-2, 1e-2) if bf16 else (1e-5, 1e-4)
    assert out.shape == (1, 2, 40, 40) and dq.shape == dk.shape == (1, 2, 40, a)
    assert rel_err(out.numpy(), jax.device_get(out_j)) < tol_f
    assert rel_err(dq.numpy(), jax.device_get(dq_j)) < tol_g
    assert rel_err(dk.numpy(), jax.device_get(dk_j)) < tol_g


# (A, H) -> (forward slices, slice width, backward units a row tile): the
# forward keeps the whole row up to A = 448 and past it walks slices of at
# most 128; the backward keeps every head at once up to A = 304 (H = 8) and
# past it takes units of one head's 32-feature slice
K7_GROUPS = [((312, 8), (1, 312, 8 * 2)), ((448, 8), (1, 448, 8 * 2)),
             ((456, 8), (4, 116, 8 * 2)), ((512, 8), (4, 128, 8 * 2)),
             ((1024, 8), (8, 128, 8 * 4)), ((140, 35), (1, 140, 35))]


@pytest.mark.parametrize("shape, want", K7_GROUPS)
def test_attn_map_bank_plan_groups(shape, want):
    a, h = shape
    slices, width, units = want
    fwd, bwd = plan(1000, a, h, bwd=False), plan(1000, a, h, bwd=True)
    assert fwd == (32, 4 * 64 * (width + row_stride(width)), slices)
    assert width == slice_width(a, slices) and width <= (a if slices == 1 else SLICE_MAX)
    assert bwd == (32, GROUPED_BWD_SMEM, units) == (32, 16896, units)
    assert fwd[1] <= SMEM_LIMIT and plan(7, a, h, bwd=False) == fwd
    # the block backward, forced, does not fit at any of these widths
    with pytest.raises(ValueError, match=r"backward kernel: .* in 1 group\(s\) need"):
        plan(1000, a, h, bwd=True, groups=1)


def test_attn_map_bank_plan_forced_groups_at_32():
    """Groups forced at the chain's A = 32, H = 8 (the card test holds their
    bits to the block plans'): 2, 4 and 8 forward slices of 16, 8 and 4
    columns; any count but 1 gives the grouped backward's 8 head units."""
    for groups, width in ((2, 16), (4, 8), (8, 4)):
        assert plan(64, 32, 8, bwd=False, groups=groups) == (
            32, 4 * 64 * (width + row_stride(width)), groups)
        assert plan(64, 32, 8, bwd=True, groups=groups) == (32, GROUPED_BWD_SMEM, 8)
    assert plan(64, 32, 8, bwd=False, groups=1) == plan(64, 32, 8, bwd=False)
    assert plan(64, 32, 8, bwd=True, groups=1) == plan(64, 32, 8, bwd=True) == (32, 54400, 1)
    with pytest.raises(ValueError, match=r"backward kernel: 2147483647 maps, N=64, A=32, H=8 "
                                         r"need 34359738352 blocks in the grouped plan, past "
                                         r"the int32 grid index"):
        plan(64, 32, 8, bwd=True, groups=2, bc=2 ** 31 - 1)
