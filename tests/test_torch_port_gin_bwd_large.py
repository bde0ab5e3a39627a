"""Port parity past n_max 64 for the backward kernels whose caps on N were
lifted: K1 (``gin_messages``) and K3 / K4 (``pair_relu_project`` /
``pair_relu_project_cm``).

- The plain backward versions against the Pallas kernels in interpret mode
  under ``jax.vjp`` at n_max 128 (K1 with e_max = 4 n_max = 512 and
  sentinel and out-of-range edges; K3 / K4 at a narrow C), f32 1e-5 of
  each output's largest value (the same sums in another order), bf16 as
  ``test_torch_port_kernel_grads.py`` states it (2^-8: the two sides round
  at the same places).
- The launch plans: K1's forward and backward (``ops/gin_messages.py::
  fwd_plan`` / ``bwd_plan``) and the K3 / K4 backward's channel chunks
  (``ops/pair_block.py::bwd_plan``) fit ``SMEM_LIMIT`` for every n_max the
  loader's buckets give and N = 256 (E = 4 N, D = 13, F = C = 300), the
  chunk plan is 64-channel blocks there and its chunks cover the channels;
  each plan raises past its limit, naming it.
- K1's plain backward against the Pallas kernel at the corners of the
  card kernel's schedule (fewer nodes than its node ranges, a graph with no
  kept edge, a graph whose sources are all masked), at the same bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.ops.gin_messages import gin_messages as jax_gin_messages
from moleculesde_tpu.ops.pair_block import pair_relu_project as jax_pair_relu_project
from moleculesde_tpu.ops.pair_block import pair_relu_project_cm as jax_pair_relu_project_cm
from moleculesde_tpu_torch.ops import gin_messages as gin_ops
from moleculesde_tpu_torch.ops import pair_block as pair_ops
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT

from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)

BF16_TOL = 2 ** -8


def _gin_operands(b=2, n=128, e=512, d=13, f=16, seed=31):
    """Edges of molecule-like graphs (atoms in the low node indices), the
    rest masked to the sentinel N, plus a few out-of-range src / dst
    (negative and past N) and edges whose src alone is masked."""
    rng = np.random.default_rng(seed)
    src = np.full((b, e), n, np.int32)
    dst = np.full((b, e), n, np.int32)
    for i in range(b):
        atoms = int(rng.integers(n // 2, n + 1))
        live = int(rng.integers(e // 2, e))
        src[i, :live] = rng.integers(0, atoms, live)
        dst[i, :live] = rng.integers(0, atoms, live)
    src[:, 5::37] = -3
    dst[:, 9::41] = n + 7
    src[:, 13::29] = n
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    boh = np.zeros((b, e, d), np.float32)
    for lo, hi in ((0, 5), (5, 11), (11, 13)):
        boh[np.arange(b)[:, None], np.arange(e)[None], rng.integers(lo, hi, (b, e))] = 1
    tbl = (rng.normal(size=(d, f)) * 0.5).astype(np.float32)
    g = rng.normal(size=(b, n, f)).astype(np.float32)
    return x, src, dst, boh, tbl, g


def _check_gin_bwd_plain(operands, bf16):
    x, src, dst, boh, tbl, g = operands
    _, vjp = jax.vjp(lambda x_, t_: jax_gin_messages(
        x_, src, dst, boh, t_, bf16=bf16, impl="pallas_interpret"), x, tbl)
    dx_j, dt_j = vjp(jnp.asarray(g))
    dx_t, dt_t = gin_ops.gin_messages_bwd_plain(t(x), t(src), t(dst), t(boh), t(tbl), t(g),
                                                bf16=bf16)
    tol = BF16_TOL if bf16 else 1e-5
    assert rel_err(dx_t.numpy(), np.asarray(dx_j, np.float32)) <= tol
    assert rel_err(dt_t.numpy(), np.asarray(dt_j, np.float32)) <= tol
    assert float(np.abs(np.asarray(dt_j)).max()) > 0.0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gin_messages_bwd_plain_matches_pallas_kernel_at_n128(bf16):
    _check_gin_bwd_plain(_gin_operands(), bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["no_kept_edge", "fewer_nodes_than_ranges",
                                  "all_sources_masked"])
def test_gin_messages_bwd_plain_matches_pallas_kernel_at_schedule_corners(case, bf16):
    """Graph 2 has no edge with a valid dst; N = 3 is below the card
    kernel's 4 node ranges per block; graph 1's sources are all masked, so
    its edges reach dtable alone."""
    if case == "no_kept_edge":
        ops = _gin_operands(b=3, n=7, e=11, f=8, seed=47)
        ops[2][2] = 7
    else:
        ops = _gin_operands(b=2, n=3, e=40, f=8, seed=43)
        if case == "all_sources_masked":
            ops[1][1] = 3
    _check_gin_bwd_plain(ops, bf16)


def _pair_operands(b=2, n=128, c=8, h=4, seed=33):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(b, n, c)) * 1.3 + 0.2).astype(np.float32)
    cc = rng.normal(size=(b, n, c)).astype(np.float32)
    w = (rng.normal(size=(c, h)) / np.sqrt(c)).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, h).astype(np.float32)
    return a, cc, w, bias, rng.normal(size=(b, n * n, h)).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("cm", [False, True], ids=["K3", "K4"])
def test_pair_relu_project_bwd_plain_matches_pallas_kernel_at_n128(cm, bf16):
    a, cc, w, bias, g = _pair_operands()
    b, n, _ = a.shape
    h = w.shape[1]
    if cm:
        g = np.ascontiguousarray(g.transpose(0, 2, 1))            # [B, H, N*N]
        fn, plain = jax_pair_relu_project_cm, pair_ops.pair_relu_project_cm_bwd_plain
    else:
        g = g.reshape(b, n, n, h)
        fn, plain = jax_pair_relu_project, pair_ops.pair_relu_project_bwd_plain
    _, vjp = jax.vjp(lambda *d: fn(*d, bf16=bf16, impl="pallas_interpret"), a, cc, w, bias)
    grads_j = vjp(jnp.asarray(g))
    grads_t = plain(t(a), t(cc), t(w), t(g), bf16=bf16)
    if cm:   # the bias is added outside K4: its gradient is the sum of g
        grads_t = grads_t + (t(g).sum(dim=(0, 2)),)
    tol = BF16_TOL if bf16 else 1e-5
    assert len(grads_t) == len(grads_j) == 4
    for i, (gt, gj) in enumerate(zip(grads_t, grads_j)):
        gj = np.asarray(gj, np.float32)
        assert gt.shape == gj.shape, i
        assert rel_err(gt.numpy(), gj) <= tol, (i, rel_err(gt.numpy(), gj))


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_bwd_plans_fit_every_bucket(n):
    k1 = gin_ops.bwd_plan(n, 4 * n, 13, 300)
    assert k1["smem"] <= SMEM_LIMIT and k1["maxd"] == 16 and k1["chunks"] == 5
    pair = pair_ops.bwd_plan(n, 300)
    assert pair["smem"] <= SMEM_LIMIT
    assert pair["chunk"] * pair["chunks"] >= 300 > pair["chunk"] * (pair["chunks"] - 1)
    # 64-channel blocks at every bucket: 5 blocks a graph
    assert pair["chunk"] == 64 and pair["chunks"] == 5
    assert pair["smem"] == 4 * (2 * n * 64 + 32 * 64) + 36864


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_fwd_plan_fits_every_bucket(n):
    """K1's forward at E = 4 N takes every bucket, N = 256 too (past the
    first forward's ~178), and needs less than the backward."""
    k1 = gin_ops.fwd_plan(n, 4 * n, 13, 300)
    assert k1["smem"] <= SMEM_LIMIT and k1["maxd"] == 16 and k1["chunks"] == 5
    assert k1["smem"] < gin_ops.bwd_plan(n, 4 * n, 13, 300)["smem"]
    assert k1["smem"] == 4 * (4 * n * 16 + 4 * 4 * n + n + 2)


@pytest.mark.parametrize("case", ["k1_smem", "k1_d", "pair_smem", "k1_fwd_smem", "k1_fwd_d"])
def test_bwd_plans_raise_past_their_limits(case):
    with pytest.raises(ValueError, match="> 32" if case.endswith("_d") else "SMEM_LIMIT"):
        if case == "k1_smem":
            gin_ops.bwd_plan(1024, 4096, 13, 300)
        elif case == "k1_d":
            gin_ops.bwd_plan(32, 128, 33, 300)
        elif case == "k1_fwd_smem":
            gin_ops.fwd_plan(718, 4 * 718, 13, 300)
        elif case == "k1_fwd_d":
            gin_ops.fwd_plan(32, 128, 33, 300)
        else:
            pair_ops.bwd_plan(749, 300)
    if case == "pair_smem":   # the last plans of each chunk size
        assert pair_ops.bwd_plan(366, 300)["chunk"] == 64
        assert pair_ops.bwd_plan(367, 300)["chunk"] == 32
        assert pair_ops.bwd_plan(605, 300)["chunk"] == 32
        assert pair_ops.bwd_plan(748, 300)["chunk"] == 32
    if case == "k1_fwd_smem":   # the last forward plan at E = 4 N
        assert gin_ops.fwd_plan(717, 4 * 717, 13, 300)["smem"] <= SMEM_LIMIT
