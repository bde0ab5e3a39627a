"""Port parity past N = 32 for the attention-bank backward kernels: the
plain versions (what the wrappers take on the CPU) of K7
(``attn_map_bank_plain`` / ``attn_map_bank_bwd_plain``) and of K8's
backward (``attn_qk_bank_bwd_plain``) at N = 40 against the JAX package's
Pallas kernels in interpret mode through ``jax.vjp``, on the same
numpy-seeded operands and cotangent (f32 1e-5 of the largest value for
the maps and 1e-4 for the gradients, the same sums in another order; bf16
1e-2, both sides rounding at the same points); and the launch plans that
replaced the N <= 32 caps: K7's ``plan`` (the backward's 32-row unit,
whose bytes do not depend on N) and K8's ``bwd_plan`` (row tile and
feature chunk) at the 3D->2D chain's widths, under the shared memory of a
block, and their messages past it.
The kernels themselves run only on the card (``test_torch_port_kernels.py``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.ops.rejected.attn_bank import attn_map_bank_pallas
from moleculesde_tpu.ops.rejected.attn_qk_bank import attn_qk_bank as jax_attn_qk_bank
from moleculesde_tpu_torch.ops.attn_bank import (
    GROUPED_BWD_SMEM, attn_map_bank_bwd_plain, attn_map_bank_plain, plan, row_stride, tile_rows)
from moleculesde_tpu_torch.ops.attn_qk_bank import (
    BWD_DU_WORDS, BWD_MAX_CHUNK, TILED_SMEM, attn_qk_bank_bwd_plain, bwd_plan, check_plan,
    fwd_plan, plan_of, tiled_plan)
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT

from test_torch_port_attn_bank import _map_operands, _qk_operands
from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)


def _tols(bf16):
    return (1e-2, 1e-2) if bf16 else (1e-5, 1e-4)


@pytest.mark.parametrize("ds", [2, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_map_bank_plain_matches_pallas_kernel_past_32(ds, bf16):
    """K7 at N = 40: the maps, dq and dk of the plain versions against
    ``jax.vjp`` of the Pallas kernels in interpret mode."""
    q, k, g = _map_operands(11, b=2, c=2, n=40, a=16)
    out_j, vjp = jax.vjp(lambda q_, k_: attn_map_bank_pallas(q_, k_, ds, bf16, True),
                         jnp.asarray(q), jnp.asarray(k))
    dq_j, dk_j = vjp(jnp.asarray(g))
    out = attn_map_bank_plain(t(q), t(k), ds, bf16=bf16)
    dq, dk = attn_map_bank_bwd_plain(t(q), t(k), t(g), ds, bf16=bf16)
    tol_f, tol_g = _tols(bf16)
    assert out.shape == (2, 2, 40, 40) and dq.dtype == torch.float32
    assert rel_err(out.numpy(), jax.device_get(out_j)) < tol_f
    assert rel_err(dq.numpy(), jax.device_get(dq_j)) < tol_g
    assert rel_err(dk.numpy(), jax.device_get(dk_j)) < tol_g


@pytest.mark.parametrize("ds", [2, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_qk_bank_bwd_plain_matches_pallas_kernel_past_32(ds, bf16):
    """K8's backward at N = 40: dqk and the eight weight gradients of the
    plain version against ``jax.vjp`` of the Pallas kernel in interpret
    mode (on qk as the wrapper hands it over: rounded to bf16 in bf16 mode)."""
    ops, g = _qk_operands(12, b=2, n=40)
    _, vjp = jax.vjp(lambda *a: jax_attn_qk_bank(*a, ds, bf16=bf16, impl="pallas_interpret"),
                     *(jnp.asarray(o) for o in ops))
    grads_j = vjp(jnp.asarray(g))
    qk = t(ops[0]).to(torch.bfloat16 if bf16 else torch.float32)
    grads = attn_qk_bank_bwd_plain(qk, *(t(o) for o in ops[1:]), t(g), ds, bf16=bf16)
    assert grads[0].dtype == qk.dtype and grads[0].shape == (2, 40, 12)
    _, tol_g = _tols(bf16)
    for i, (mine, ref) in enumerate(zip(grads, grads_j)):
        assert rel_err(mine.float().numpy(), np.asarray(ref, np.float32)) < tol_g, i


# (N, A, H) -> K7's backward plan (rows of a unit, shared bytes): the same
# 32-row unit and 54,400 B whatever N (the unit's rows and a 32-row chunk,
# every head's du, the output's chains), where the old plan's
# row tile shrank and its bytes grew with N (32 rows and 42,016 B at N =
# 32, one row and 232,096 B at 518); the forward (its 32 x 32 tile, 2 x 32
# (A + row_stride(A)) words whatever N) beside each
K7_PLANS = [((32, 32, 8), (32, 54400, 1)), ((33, 32, 8), (32, 54400, 1)),
            ((64, 32, 8), (32, 54400, 1)), ((128, 32, 8), (32, 54400, 1)),
            ((256, 32, 8), (32, 54400, 1)), ((518, 32, 8), (32, 54400, 1))]


@pytest.mark.parametrize("shape, want", K7_PLANS)
def test_attn_map_bank_plan(shape, want):
    n, a, h = shape
    assert plan(n, a, h, bwd=True) == want
    rows, smem, _ = want
    assert smem <= SMEM_LIMIT and smem == 4 * (
        3 * rows * a + 2 * rows * row_stride(a) + h * (rows * rows + 4))
    assert plan(n, a, h, bwd=False) == (32, 4 * 64 * (a + row_stride(a)), 1) == (32, 17408, 1)


def test_attn_map_bank_plan_refuses_past_shared_memory():
    """K7 takes any N and, past a block's shared memory, any A in the
    grouped plan: the forward, whose tile does not grow with N, takes N =
    881 (past its old plan) and A = 1024 (H = 256) in eight column slices
    of 128, where the whole row needs 525,312 B; the backward takes N = 519
    (past its old plan) in the bytes of N = 32, and A = 140, H = 35 (every
    head's du needs 234,544 B) in units of one head's 32-feature slice.  A
    forced plan that does not fit still raises, naming its bytes."""
    assert plan(881, 32, 8, bwd=False) == plan(32, 32, 8, bwd=False)
    assert plan(881, 1024, 256, bwd=False) == (32, 4 * 64 * (128 + row_stride(128)), 8)
    with pytest.raises(ValueError, match=r"forward kernel: N=881, A=1024, H=256 in 1 group\(s\) "
                                         r"need 525312 B of shared memory per block \(> 232448\)"):
        plan(881, 1024, 256, bwd=False, groups=1)
    assert plan(519, 32, 8, bwd=True) == plan(32, 32, 8, bwd=True)
    assert plan(519, 140, 35, bwd=True) == (32, GROUPED_BWD_SMEM, 35)
    with pytest.raises(ValueError, match=r"backward kernel: N=519, A=140, H=35 in 1 group\(s\) "
                                         r"need 234544 B of shared memory per block \(> 232448\)"):
        plan(519, 140, 35, bwd=True, groups=1)


@pytest.mark.parametrize("n", [16, 32, 33, 64, 128, 256, 519, 1024])
def test_attn_map_bank_bwd_plan_takes_any_n(n):
    """K7's backward from below one tile to past its old limit (518): the
    same 32-row unit and shared bytes at every N, up to A = 136, H = 34, and
    past it (A = 140, H = 35) the grouped plan, 35 head units a row tile in
    16,896 B whatever N."""
    assert plan(n, 32, 8, bwd=True) == (32, 54400, 1) and 4 * 54400 <= SMEM_LIMIT
    assert plan(n, 136, 34, bwd=True) == (32, 227872, 1) and 227872 <= SMEM_LIMIT
    assert plan(n, 140, 35, bwd=True) == (32, 16896, 35) == (32, GROUPED_BWD_SMEM, 35)


# (N, F) -> K8's backward plan (row tile, feature chunk, shared bytes) at the
# 3D->2D chain's A = 32, H = 8: edge layers 1-3 (F = 16), 0 (F = 300) and
# variant 3's F = 900; the whole map a tile up to N = 32 (64: 32 rows), 16
# rows at 128, 2 rows and 8-feature chunks at 256
K8_BWD_PLANS = [((32, 16), (32, 16, 67616)), ((64, 16), (32, 16, 126240)),
                ((128, 16), (16, 16, 177952)), ((256, 16), (2, 8, 232224)),
                ((32, 300), (32, 64, 67616)), ((64, 300), (32, 64, 126240)),
                ((128, 300), (16, 64, 177952)), ((256, 300), (2, 8, 232224)),
                ((32, 900), (32, 64, 67616)), ((128, 900), (16, 64, 177952)),
                ((256, 900), (2, 8, 232224))]


@pytest.mark.parametrize("shape, want", K8_BWD_PLANS)
def test_attn_qk_bank_bwd_plan(shape, want):
    n, f = shape
    rows, fc, smem = bwd_plan(n, f, 32, 8)
    assert (rows, fc, smem) == want
    assert smem <= SMEM_LIMIT and rows <= tile_rows(n, 8, BWD_DU_WORDS)
    assert fc <= min(f, BWD_MAX_CHUNK)
    for c in (2, 8):   # one channel a block: C does not enter the plan
        assert check_plan(n, f, c, 32, 8, bwd=True) == smem


def test_attn_qk_bank_bwd_plan_refuses_past_shared_memory():
    """K8's backward keeps its block plan up to N = 266 at A = 32, H = 8
    whatever F; past it, where that plan ran out of shared memory and the
    wrapper used to raise, the tiled plan takes the shape (the block plan
    forced there still raises, naming the limit)."""
    assert bwd_plan(266, 900, 32, 8)[2] <= SMEM_LIMIT
    assert bwd_plan(267, 16, 32, 8)[:2] == (1, 1)
    assert plan_of(267, 16, 8, 32, 8, bwd=True) == "tiled"
    assert check_plan(267, 16, 8, 32, 8, bwd=True) == TILED_SMEM <= SMEM_LIMIT
    with pytest.raises(ValueError, match=r"backward kernel: N=267, F=16, C=8, A=32 need \d+ B "
                                         r"of shared memory per block \(> 232448\)"):
        check_plan(267, 16, 8, 32, 8, bwd=True, plan="block")


# N past the block plans (the forward's 334 at F = 16, the backward's 266)
# up to 8192
K8_LARGE_N = [267, 335, 512, 1024, 2048, 4096, 8192]


@pytest.mark.parametrize("n", K8_LARGE_N)
def test_attn_qk_bank_plans_fit_up_to_n8192(n):
    """K8's forward and backward have a plan within ``SMEM_LIMIT`` at every
    N up to 8192 at the 3D->2D chain's edge layers (F = 16, C = 8 and F =
    300, C = 2; A = 32, H = 8), B = 2: the tiled plan past the block plan,
    its shared memory the same at every N."""
    for f, c in ((16, 8), (300, 2)):
        for bwd in (False, True):
            smem = check_plan(n, f, c, 32, 8, bwd=bwd, b=2)
            assert smem <= SMEM_LIMIT
            if plan_of(n, f, c, 32, 8, bwd=bwd, b=2) == "tiled":
                assert smem == TILED_SMEM
                p = tiled_plan(2, n, f, c, 32, 8, bwd)
                assert p["scratch"] == (4 if bwd else 2) * 2 * c * 2 * n * 32


def test_attn_qk_bank_block_plan_kept_where_it_fits():
    """Wherever the (graph, channel) block plan fits, the wrappers choose
    it; the tiled plan only past it."""
    for n in list(range(1, 400, 7)) + [266, 267, 334, 335]:
        for f in (16, 300):
            for bwd in (False, True):
                block = (bwd_plan(n, f, 32, 8)[2] if bwd else fwd_plan(n, f, 32)[1])
                want = "block" if block <= SMEM_LIMIT else "tiled"
                assert plan_of(n, f, 8, 32, 8, bwd=bwd) == want, (n, f, bwd)


@pytest.mark.parametrize("n, a, ds", [(1, 8, 2), (33, 32, 4), (300, 32, 4), (70, 96, 48)])
def test_attn_qk_bank_tiled_units_cover_the_map_once(n, a, ds):
    """The tiled plan's map tiles cover every (n, m) once, and its backward
    units (row tile, head, 32-feature slice of the head) every (row,
    feature) once, at a ragged N and a head wider than one slice."""
    p = tiled_plan(1, n, 16, 1, a, a // ds, True)
    tiles = p["tiles"]
    assert tiles * 32 >= n > (tiles - 1) * 32
    seen = np.zeros((n, a), np.int64)
    slices = -(-ds // 32)
    assert p["map_units"] == tiles * (a // ds) * slices
    for unit in range(p["map_units"]):   # the kernel's order: (tile, head, slice)
        sl, h, t0 = unit % slices, unit // slices % (a // ds), unit // slices // (a // ds)
        a0 = h * ds + sl * 32
        seen[t0 * 32:t0 * 32 + 32, a0:min(a0 + 32, (h + 1) * ds)] += 1
    assert np.all(seen == 1)


def test_attn_qk_bank_tiled_refusal_names_the_int32_grid_index():
    """The tiled plan refuses only past the int32 grid index, naming it:
    the forward's 2^31 map tiles at B = 4096, C = 8, N = 8192."""
    assert tiled_plan(2, 8192, 300, 8, 32, 8, True)["tiles"] == 256
    assert tiled_plan(2 ** 12, 8192, 300, 8, 32, 8, True)["tiles"] == 256
    with pytest.raises(ValueError, match="past the int32 grid index"):
        tiled_plan(2 ** 12, 8192, 300, 8, 32, 8, False)


def _map_tiled_mirror(q, k, g, ds, tile=32):
    """K8's map in the tiled plan's split, in f32 on the CPU: the forward
    tile by tile, dq of each row tile carried across the column tiles in
    order and dk of each column tile across the row tiles."""
    b, c, n, a = q.shape
    h = a // ds
    inv = 1.0 / math.sqrt(ds)

    def logits(qt, kt):   # [B, C, H, rows, cols]
        return torch.einsum("bcnhd,bcmhd->bchnm", qt.reshape(b, c, -1, h, ds),
                            kt.reshape(b, c, -1, h, ds)) * inv

    out = torch.zeros(b, c, n, n)
    dq, dk = torch.zeros(b, c, n, a), torch.zeros(b, c, n, a)
    for n0 in range(0, n, tile):
        for m0 in range(0, n, tile):
            t_ = torch.tanh(logits(q[:, :, n0:n0 + tile], k[:, :, m0:m0 + tile]))
            out[:, :, n0:n0 + tile, m0:m0 + tile] = t_.sum(dim=2) / h
            du = g[:, :, None, n0:n0 + tile, m0:m0 + tile] * (1.0 - t_ * t_) * (inv / h)
            km = k[:, :, m0:m0 + tile].reshape(b, c, -1, h, ds)
            qn = q[:, :, n0:n0 + tile].reshape(b, c, -1, h, ds)
            dq[:, :, n0:n0 + tile] += torch.einsum("bchnm,bcmhd->bcnhd", du, km).flatten(3)
            dk[:, :, m0:m0 + tile] += torch.einsum("bchnm,bcnhd->bcmhd", du, qn).flatten(3)
    return out, dq, dk


def test_attn_qk_bank_tiled_mirror_matches_plain_past_the_block_plans():
    """The tiled plan's split of the map, replayed in f32 on the CPU at N =
    300 (past both block plans at A = 32), against the plain map and its
    backward, at 1e-5."""
    from moleculesde_tpu_torch.ops.attn_bank import map_bank_bwd_f32

    rng = np.random.default_rng(8)
    q, k = (t((0.6 * rng.normal(size=(1, 2, 300, 32))).astype(np.float32)) for _ in range(2))
    g = t(rng.normal(size=(1, 2, 300, 300)).astype(np.float32))
    assert plan_of(300, 16, 2, 32, 8, bwd=True) == "tiled"
    out, dq, dk = _map_tiled_mirror(q, k, g, 4)
    assert rel_err(out.numpy(), attn_map_bank_plain(q, k, 4).numpy()) <= 1e-5
    dq_p, dk_p = map_bank_bwd_f32(q, k, g, 4, False)
    assert rel_err(dq.numpy(), dq_p.numpy()) <= 1e-5
    assert rel_err(dk.numpy(), dk_p.numpy()) <= 1e-5
