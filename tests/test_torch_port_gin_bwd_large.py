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
    """The shapes past the block plans' limits (K1 past its shared memory at
    E = 4 N or past D = 32, K3 / K4's backward past N = 748), where the
    plans used to raise: each now takes the large-N plan, which fits
    ``SMEM_LIMIT``, and the last shapes of the old plans keep them."""
    if case == "pair_smem":
        p = pair_ops.bwd_plan(749, 300)
        assert (p["chunk"], p["chunks"], p["rows"], p["tiles"], p["passes"]) == (
            64, 5, 128, 6, 1)
        assert p["smem"] == 4 * (2 * 128 * 64 + 32 * 64) + 36864 <= SMEM_LIMIT
        assert pair_ops.bwd_plan(366, 300)["chunk"] == 64
        assert pair_ops.bwd_plan(367, 300)["chunk"] == 32
        assert pair_ops.bwd_plan(605, 300)["chunk"] == 32
        assert pair_ops.bwd_plan(748, 300)["chunk"] == 32
        assert pair_ops.bwd_plan(748, 300)["tiles"] == 1
        return
    n, d = (32, 33) if case.endswith("_d") else ((718, 13) if "fwd" in case else (1024, 13))
    plan = gin_ops.fwd_plan if "fwd" in case else gin_ops.bwd_plan
    p = plan(n, 4 * n, d, 300)
    assert p["plan"] == "ranges" and p["smem"] <= SMEM_LIMIT and p["chunks"] == 5
    assert p["ranges"] == max(1, -(-4 * n // 256))
    assert p["slices"] == (2 if case == "k1_d" else 1)
    if case == "k1_fwd_smem":   # the last block plan of the forward at E = 4 N
        assert gin_ops.fwd_plan(717, 4 * 717, 13, 300)["plan"] == "block"


# N from the last block plans to 8192 at E = 4 N
LARGE_N = [660, 661, 717, 718, 748, 749, 1024, 2048, 4096, 8192]


@pytest.mark.parametrize("n", LARGE_N)
def test_large_n_plans_fit_shared_memory(n):
    """K1's forward and backward (D = 13 and 40) and K3 / K4's backward (H =
    32 and 64) have a plan that fits ``SMEM_LIMIT`` at every N up to 8192,
    and none grows with N past its block plan: the ranges plan's sort
    cursors leave shared memory for device memory past 16382 nodes."""
    for d in (13, 40):
        for plan in (gin_ops.fwd_plan, gin_ops.bwd_plan):
            p = plan(n, 4 * n, d, 300)
            assert p["smem"] <= SMEM_LIMIT, (n, d, p)
            if p["plan"] == "ranges":
                assert p["walk_smem"] <= 32768 and p["sort_smem"] <= 4 * 16384
    for h in (32, 64):
        p = pair_ops.bwd_plan(n, 300, h)
        assert p["smem"] <= SMEM_LIMIT, (n, h, p)
        if n > 748 or h > 32:
            assert p["smem"] == pair_ops.bwd_plan(8192, 300, h)["smem"]


@pytest.mark.parametrize("d", [13, 16, 32])
def test_block_plans_kept_where_they_fit(d):
    """Wherever the old block plans fit, the wrappers still choose them:
    K1's (its shared-memory formula at D <= 32) and K3 / K4's whole-graph
    backward (H <= 32, N <= 748); the large-N plans only past them."""
    maxd = 16 if d <= 16 else 32
    for n in list(range(1, 760, 9)) + [660, 717, 718, 748, 749]:
        for e in (4 * n, 2 * n + 3):
            for bwd, plan in ((False, gin_ops.fwd_plan), (True, gin_ops.bwd_plan)):
                old = 4 * (e * maxd + (4 * maxd * 64 if bwd else 0) + 4 * e + n + 2)
                p = plan(n, e, d, 300)
                assert (p["plan"] == "block") == (old <= SMEM_LIMIT), (n, e, d, bwd)
                if p["plan"] == "block":
                    assert p["smem"] == old
        p = pair_ops.bwd_plan(n, 300, 32)
        assert (p["tiles"] == 1) == (n <= 748) and p["passes"] == 1


def _node_at(start, n, kept, r, slots):
    """csrc/gin_messages.cu::node_at: the first node whose edges start at or
    past share r of the kept edges."""
    return int(np.searchsorted(start[:n], r * kept // slots, side="left"))


def _k1_slots(bins, n, ranges, bwd):
    """The ranges plan's split of one graph: the kept edges sorted stably by
    bin, the bins' starts, and each of the 4 R warp slots' (nodes, edges)."""
    kept = np.flatnonzero(bins >= 0)
    order = kept[np.argsort(bins[kept], kind="stable")]
    start = np.zeros(n + 2, np.int64)
    np.add.at(start, bins[kept] + 1, 1)
    start = np.cumsum(start)
    total = int(start[n + 1] if bwd else start[n])
    slots = 4 * ranges
    out = []
    for r in range(slots):
        n0 = _node_at(start, n, total, r, slots)
        n1 = n if r == slots - 1 else _node_at(start, n, total, r + 1, slots)
        p1 = total if (r == slots - 1 and bwd) else int(start[n1])
        out.append(((n0, n1), order[int(start[n0]):p1]))
    return out, order[:total]


@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("n, e", [(1024, 4096), (2048, 8192), (7, 11), (3, 40), (718, 300)])
def test_k1_ranges_cover_every_node_and_edge_once(n, e, bwd):
    """The ranges plan's warp slots (node ranges cut at equal shares of the
    kept edges) cover every node once and every kept edge once, each slot
    a contiguous run of the sorted edges, on molecule-like graphs with
    masked and out-of-range edges."""
    x, src, dst, _, _, _ = _gin_operands(b=2, n=n, e=e, f=2, seed=n + e)
    ranges = max(1, -(-e // 256))
    p = gin_ops.bwd_plan(n, e, 13, 64)
    assert p["plan"] == "block" or p["ranges"] == ranges
    for i in range(2):
        ok_d = (dst[i] >= 0) & (dst[i] < n)
        ok_s = (src[i] >= 0) & (src[i] < n)
        bins = np.where(ok_d, dst[i] if not bwd else np.where(ok_s, src[i], n), -1)
        slots, every = _k1_slots(bins, n, ranges, bwd)
        nodes = np.concatenate([np.arange(a, b) for (a, b), _ in slots])
        assert np.array_equal(nodes, np.arange(n))
        edges = np.concatenate([es for _, es in slots])
        assert np.array_equal(edges, every) and len(set(edges.tolist())) == len(edges)
        for (a, b), es in slots:   # a slot's edges are its nodes' (and bin N's, last)
            assert np.all((bins[es] >= a) & ((bins[es] < b) | (bins[es] == n)))


def _k1_ranges_mirror(x, src, dst, boh, tbl, g):
    """K1 forward and backward through the ranges plan's split, in f32 on
    the CPU: each warp slot sums its nodes' messages (dmsg) over its run of
    the sorted edges, dtable is summed per node range and the ranges' rows
    added in order."""
    b, n, f = x.shape
    e, d = src.shape[1], tbl.shape[0]
    xt, bo, tb = t(x), t(boh), t(tbl)
    ranges = gin_ops.bwd_plan(n, e, d, f)["ranges"]
    out, dx = torch.zeros(b, n, f), torch.zeros(b, n, f)
    rows = []
    for i in range(b):
        ok_s = (src[i] >= 0) & (src[i] < n)
        ok_d = (dst[i] >= 0) & (dst[i] < n)
        xs = torch.where(t(ok_s)[:, None], xt[i][t(np.where(ok_s, src[i], 0)).long()], 0.0)
        pre = xs + bo[i] @ tb
        gd = torch.where(t(ok_d)[:, None], t(g)[i][t(np.where(ok_d, dst[i], 0)).long()], 0.0)
        dmsg = torch.where(pre > 0, gd, 0.0)
        fwd_bins = np.where(ok_d, dst[i], -1)
        for (a, _), es in _k1_slots(fwd_bins, n, ranges, False)[0]:
            for j in es:
                out[i, fwd_bins[j]] += torch.relu(pre[j])
        bwd_bins = np.where(ok_d, np.where(ok_s, src[i], n), -1)
        slots = _k1_slots(bwd_bins, n, ranges, True)[0]
        for r in range(ranges):
            part = torch.zeros(d, f)
            for (a, _), es in slots[4 * r:4 * r + 4]:
                es_t = torch.as_tensor(es, dtype=torch.long)
                part += bo[i][es_t].t() @ dmsg[es_t]
                for j in es:
                    if bwd_bins[j] < n:
                        dx[i, bwd_bins[j]] += dmsg[j]
            rows.append(part)
    return out, dx, torch.stack(rows).sum(dim=0)


def test_k1_ranges_mirror_matches_plain_past_the_block_plan():
    """The ranges plan's split, replayed in f32 on the CPU at N = 800 (past
    the block plans' ~ 717 / 660 at E = 4 N), D = 13, against the plain
    forward and backward: every node's sum, dx and dtable at 1e-5."""
    x, src, dst, boh, tbl, g = _gin_operands(b=2, n=800, e=3200, f=8, seed=5)
    assert gin_ops.bwd_plan(800, 3200, 13, 8)["plan"] == "ranges"
    out, dx, dtable = _k1_ranges_mirror(x, src, dst, boh, tbl, g)
    args = (t(x), t(src), t(dst), t(boh), t(tbl))
    assert rel_err(out.numpy(), gin_ops.gin_messages_plain(*args).numpy()) <= 1e-5
    dx_p, dt_p = gin_ops.gin_messages_bwd_plain(*args, t(g))
    assert rel_err(dx.numpy(), dx_p.numpy()) <= 1e-5
    assert rel_err(dtable.numpy(), dt_p.numpy()) <= 1e-5


def _pair_bwd_tiled_mirror(a, c, w, g, rows, cm):
    """K3 / K4's backward through the tiled plan's split, in f32 on the
    CPU: row tiles of ``rows`` sources; in each, dpair summed over the
    passes of 32 h in order before the relu mask; da of the tile's rows,
    its dc and dW partials; the tiles' partials added in order."""
    b, n, cdim = a.shape
    h = w.shape[1]
    gg = g.transpose(1, 2).reshape(b, n, n, h) if cm else g
    da = torch.zeros(b, n, cdim)
    dc = torch.zeros(b, n, cdim)
    dw = torch.zeros(cdim, h)
    tiles = []
    for s0 in range(0, n, rows):
        pair = a[:, s0:s0 + rows, None, :] + c[:, None, :, :]
        dpair = torch.zeros(pair.shape)
        for h0 in range(0, h, 32):
            dpair = dpair + gg[:, s0:s0 + rows, :, h0:h0 + 32] @ w[:, h0:h0 + 32].t()
        dpair = torch.where(pair > 0, dpair, 0.0)
        da[:, s0:s0 + rows] = dpair.sum(dim=2)
        tiles.append((dpair.sum(dim=1),
                      torch.relu(pair).reshape(-1, cdim).t()
                      @ gg[:, s0:s0 + rows].reshape(-1, h)))
    for dc_t, dw_t in tiles:
        dc += dc_t
        dw += dw_t
    return da, dc, dw


@pytest.mark.parametrize("cm", [False, True], ids=["K3", "K4"])
def test_pair_bwd_tiled_mirror_matches_plain_past_n748(cm):
    """The tiled plan's split (128-row tiles past N = 748; 64-row tiles and
    two passes of 32 h at H = 40), replayed in f32 on the CPU at N = 760,
    against the plain backward: da, dc and dW at 1e-5."""
    n = 760
    for h in (8, 40):
        a, cc, w, _, g = _pair_operands(b=1, n=n, c=4, h=h, seed=h)
        p = pair_ops.bwd_plan(n, 4, h)
        assert (p["rows"], p["tiles"], p["passes"]) == ((128, 6, 1) if h == 8 else (64, 12, 2))
        g = (np.ascontiguousarray(g.transpose(0, 2, 1)) if cm
             else g.reshape(1, n, n, h))
        plain = (pair_ops.pair_relu_project_cm_bwd_plain if cm
                 else pair_ops.pair_relu_project_bwd_plain)
        ref = plain(t(a), t(cc), t(w), t(g))
        mine = _pair_bwd_tiled_mirror(t(a), t(cc), t(w), t(g), p["rows"], cm)
        for x_, r_ in zip(mine, ref):
            assert rel_err(x_.numpy(), r_.numpy()) <= 1e-5


def test_pair_bwd_tiles_cover_rows_passes_and_channels_once():
    """The tiled plan's row tiles cover every source row once, its passes
    every h once and its chunks every channel once, at N = 749 .. 8192 and
    H past 32."""
    for n in (8, 13, 37, 749, 1000, 1024, 2048, 8192):
        for h in (32, 33, 64, 100):
            for cdim in (40, 300):
                p = pair_ops.bwd_plan(n, cdim, h)
                if p["tiles"] == 1 and p["passes"] == 1:
                    continue
                assert p["rows"] % 8 == 0 and p["tiles"] * p["rows"] >= n
                assert (p["tiles"] - 1) * p["rows"] < n
                assert p["passes"] * 32 >= h > (p["passes"] - 1) * 32
                assert p["chunk"] * p["chunks"] >= cdim > p["chunk"] * (p["chunks"] - 1)


@pytest.mark.parametrize("kernel", ["k1_fwd", "k1_bwd", "pair_bwd"])
def test_only_int32_refusals_are_left(kernel):
    """The only shapes the large-N plans refuse pass an int32 index, and
    the message names it: K1's blocks past the int32 grid index, K3 / K4's
    g past the int32 element index (as their forward: 2^31 elements at N =
    8192, H = 32)."""
    if kernel == "pair_bwd":
        assert pair_ops.bwd_plan(8191, 300, 32, b=1)["tiles"] == 64
        with pytest.raises(ValueError, match="int32 index"):
            pair_ops.bwd_plan(8192, 300, 32, b=1)
        return
    plan = gin_ops.fwd_plan if kernel == "k1_fwd" else gin_ops.bwd_plan
    assert plan(8192, 4 * 8192, 40, 300, b=256)["plan"] == "ranges"
    with pytest.raises(ValueError, match="int32 grid index"):
        plan(8192, 4 * 8192, 40, 300 * 2 ** 12, b=2 ** 12)
