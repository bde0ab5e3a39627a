"""Port parity: the CFConv forward (K2 ``fused_cfconv``, K5
``fused_cfconv_rbf``) past n_max 32, and the launch plan of its kernel.

- The plain forward of K2 and K5 against the JAX package's
  ``fused_cfconv`` / ``fused_cfconv_rbf`` with the Pallas kernels in
  interpret mode, at N = 40 and N = 64: f32 2e-4 (atol and rtol: the same
  sums in another order); bf16 1e-2 of the largest value (both sides round
  ea, x, the weights and s to bf16 at the same points, so an f32 sum taken
  in another order moves a rounded value by at most one bf16 ulp).
- The kernel's launch plan (``ops/cfconv.py::fwd_plan``, which the CUDA
  source's ``cfconv_fwd_plan`` mirrors; the card test holds the two
  together): shared memory within ``SMEM_LIMIT`` at every N, both modes and
  every ea source, and a plan for every (G, F) the forward it replaced
  took.
- The plan's schedule replayed in float64 (row tiles, column chunks,
  zero-filled padding of N, G and F, tiles and warps with no pair inside
  the cutoff skipped, the sum over j by warp, row and chunk in the
  kernel's order) gives the plain forward (f32): 2e-5 of the largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from moleculesde_tpu.ops.cfconv import fused_cfconv as jax_fused_cfconv
from moleculesde_tpu.ops.cfconv import fused_cfconv_rbf as jax_fused_cfconv_rbf
from moleculesde_tpu_torch.ops.cfconv import (
    fused_cfconv, fused_cfconv_plain, fused_cfconv_rbf, fwd_plan, smear)
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT

from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)

CUTOFF = 10.0


def _operands(b, n, gdim, f, seed, atoms=None):
    """Seeded operands; ``atoms`` [B] zeroes env past each graph's atoms
    (whole rows and columns with no pair inside the cutoff)."""
    rng = np.random.default_rng(seed)
    dist = (np.abs(rng.normal(size=(b, n, n))) * 4.0).astype(np.float32)
    env = (rng.random((b, n, n)) * (rng.random((b, n, n)) < 0.8)).astype(np.float32)
    if atoms is not None:
        live = np.arange(n)[None, :] < np.asarray(atoms)[:, None]
        env *= live[:, :, None] & live[:, None, :]
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    w1 = (rng.normal(size=(gdim, f)) / np.sqrt(gdim)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    w2 = (rng.normal(size=(f, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    return dist, env, (x, w1, b1, w2, b2)


def _check(mine, ref, bf16):
    ref = np.asarray(ref, np.float32)
    if bf16:
        assert rel_err(mine.numpy(), ref) < 1e-2
    else:
        np.testing.assert_allclose(mine.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("n", [40, 64])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k2_forward_past_n32_matches_pallas_interpret(n, bf16):
    dist, env, params = _operands(2, n, 5, 16, seed=n)
    ea = np.asarray(smear(t(dist), 0.0, CUTOFF, 5))
    ref = jax_fused_cfconv(jnp.asarray(ea), jnp.asarray(env), *map(jnp.asarray, params),
                           bf16=bf16, impl="pallas_interpret")
    _check(fused_cfconv(t(ea), t(env), *map(t, params), bf16=bf16), ref, bf16)


@pytest.mark.parametrize("n", [40, 64])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k5_forward_past_n32_matches_pallas_interpret(n, bf16):
    dist, env, params = _operands(2, n, 5, 16, seed=n + 1)
    kw = dict(start=0.0, stop=CUTOFF, num_gaussians=5, bf16=bf16)
    ref = jax_fused_cfconv_rbf(jnp.asarray(dist), jnp.asarray(env),
                               *map(jnp.asarray, params), impl="pallas_interpret", **kw)
    _check(fused_cfconv_rbf(t(dist), t(env), *map(t, params), **kw), ref, bf16)


def _old_forward_admits(n, gdim, f):
    """The forward this plan replaced (``fwd_smem`` / ``_row_groups``): a
    row group of F threads per block (F <= 1024), W1 and W2 staged whole in
    f32, columns in chunks of at most 32, each with its x rows and the
    group's ea, env and s; needed F % 4 == 0 and one group to fit."""
    ch = min(n, 32)
    a4 = lambda v: (v + 3) // 4 * 4  # noqa: E731
    smem = 4 * (gdim * f + f * f + ch * f + a4(ch * gdim) + a4(ch) + ch * f)
    return f % 4 == 0 and f <= 1024 and smem <= SMEM_LIMIT


# bytes of ea source per pair: K2's ea in bf16 or f32, K5's distance
SOURCES = {"bf16_ea": lambda gdim: 2 * gdim, "f32_ea": lambda gdim: 4 * gdim,
           "dist": lambda gdim: 4}
N_VALUES = [7, 16, 32, 64, 128, 200]
G_VALUES = [1, 2, 5, 16, 17, 20, 33, 51, 64, 65, 100, 128, 129, 200, 256, 257, 300, 500,
            1000, 2000, 4000, 5300]


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", N_VALUES)
def test_fwd_plan_fits_and_covers_the_old_forward(n, bf16, source):
    """Every (G, F) the old forward took has a plan within the shared
    memory a block may use, at every N (F <= 256: the old forward's own
    limit stopped below that), and the tiles cover N, G and F."""
    admitted = 0
    for gdim in G_VALUES:
        for f in range(4, 264, 4):
            plan = fwd_plan(n, gdim, f, bf16, SOURCES[source](gdim))
            if not _old_forward_admits(n, gdim, f):
                continue
            admitted += 1
            assert plan is not None and plan["smem"] <= SMEM_LIMIT, (gdim, f)
            assert plan["m"] * plan["fp"] == 8192 and plan["fp"] >= f
            assert plan["c"] * plan["r"] == plan["m"] and plan["c"] in (16, 32)
            assert plan["chunks"] * plan["c"] >= n > (plan["chunks"] - 1) * plan["c"]
            assert plan["tiles"] * plan["r"] >= n > (plan["tiles"] - 1) * plan["r"]
            assert plan["g16"] % 16 == 0 and plan["g16"] - 16 < gdim <= plan["g16"]
            assert plan["gk"] == plan["g16"] or (not plan["copy"] and plan["gk"] == 64)
    assert admitted > 500


@pytest.mark.parametrize("source", ["bf16_ea", "dist"])
@pytest.mark.parametrize("n", N_VALUES)
def test_fwd_plan_main_path_fits_two_blocks_per_sm(n, source):
    """At the main path's widths (G=51, F=128, bf16) the weights stay in
    shared memory, the ea source is copied one tile ahead, and a block
    leaves room for a second on the SM (228 KB, 1 KB reserved per block).
    Tiles of 64 pairs: 2 rows of 32 columns past N = 16, 4 rows of 16 up to
    it."""
    plan = fwd_plan(n, 51, 128, True, SOURCES[source](51))
    assert plan["w_res"] and plan["copy"] and plan["gk"] == 64
    assert (plan["m"], plan["c"], plan["r"]) == ((64, 16, 4) if n <= 16 else (64, 32, 2))
    assert 2 * (plan["smem"] + 1024) <= 228 * 1024


def _replay_fwd_plan(ea, env, x, w1, b1, w2, b2):
    """The kernel's schedule in float64: every unit (row tile, graph), its
    column chunks in order; a tile with env == 0 on every pair skipped, and
    a warp's 16 pairs likewise; each warp's products on zero-padded
    operands (ea staged as zero where env == 0, in chunks of ``gk``
    entries); the out rows summed over each row's warps in order, then the
    chunks.  Returns (out, tiles skipped)."""
    b, n, _, gdim = ea.shape
    f = x.shape[2]
    p = fwd_plan(n, gdim, f, False, 4 * gdim)
    fp, m, c, r, g16, gk = p["fp"], p["m"], p["c"], p["r"], p["g16"], p["gk"]
    w1p = np.zeros((g16, fp))
    w1p[:gdim, :f] = w1
    w2p = np.zeros((fp, fp))
    w2p[:f, :f] = w2
    b1p, b2p = np.zeros(fp), np.zeros(fp)
    b1p[:f], b2p[:f] = b1, b2
    out = np.full((b, n, f), np.nan)
    skipped = 0
    for u in range(b * p["tiles"]):
        rt, bb = divmod(u, b)
        i0 = rt * r
        acc = np.zeros((r, fp))
        for ch in range(p["chunks"]):
            j0 = ch * c
            envt, eat, xt = np.zeros(m), np.zeros((m, g16)), np.zeros((c, fp))
            for pair in range(m):
                row, jj = divmod(pair, c)
                i, j = i0 + row, j0 + jj
                if i < n and j < n:
                    envt[pair] = env[bb, i, j]
                    if envt[pair] != 0:
                        eat[pair, :gdim] = ea[bb, i, j]
            for jj in range(min(c, n - j0)):
                xt[jj, :f] = x[bb, j0 + jj]
            if not envt.any():
                skipped += 1
                continue
            red = np.zeros((m // 16, fp))
            for w in range(m // 16):
                rows = slice(16 * w, 16 * w + 16)
                if not envt[rows].any():
                    continue
                pre = b1p + sum(eat[rows, g0:g0 + gk] @ w1p[g0:g0 + gk]
                                for g0 in range(0, g16, gk))
                s = np.logaddexp(pre, 0.0) - np.log(2.0)
                wf = s @ w2p + b2p
                jw = (16 * w) % c
                v = (wf * envt[rows, None]) * xt[jw:jw + 16]
                red[w] = (v[:8] + v[8:]).sum(axis=0)
            for row in range(r):
                for w in range(row * (c // 16), (row + 1) * (c // 16)):
                    acc[row] += red[w]
        for row in range(r):
            if i0 + row < n:
                out[bb, i0 + row] = acc[row, :f]
    return out, skipped


@pytest.mark.parametrize("b,n,gdim,f,atoms", [
    (2, 40, 5, 16, [40, 23]), (1, 70, 20, 100, [61]), (3, 7, 5, 16, [7, 0, 4]),
    (2, 9, 300, 64, [9, 5])])
def test_fwd_plan_schedule_replays_the_plain_forward(b, n, gdim, f, atoms):
    """Tiles, chunks, padding and skips cover every pair inside the cutoff
    once: the replay in float64 agrees with the plain forward in f32 to f32
    rounding; rows with no pair inside the cutoff (past a graph's atoms, a
    graph with none) are skipped whole and come out as zeros."""
    dist, env, params = _operands(b, n, gdim, f, seed=3, atoms=atoms)
    ea = smear(t(dist), 0.0, CUTOFF, gdim)
    ref = fused_cfconv_plain(ea, t(env), *(t(a) for a in params)).numpy()
    args = [ea.numpy(), env, *params]
    mine, skipped = _replay_fwd_plan(*(np.asarray(a, np.float64) for a in args))
    assert rel_err(mine, ref) < 2e-5
    empty = np.arange(n)[None, :] >= np.asarray(atoms)[:, None]
    assert (mine[empty] == 0).all() and (ref[empty] == 0).all()
    assert skipped > 0 or empty.sum() < fwd_plan(n, gdim, f, False, 4 * gdim)["r"]
