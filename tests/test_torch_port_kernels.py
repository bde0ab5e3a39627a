"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip without a CUDA device (the kernels have no CPU
mode).  Run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_port_kernels.py -q``.
Forward tolerance 1e-5 of the largest output in f32 (the same sums in
another order); gradients 1e-4 in f32 (batch-wide weight sums of up to
1.3e5 terms in another order).  bf16 tolerances are stated per test: the
two sides round at the same places, so they differ only where an f32 sum
taken in another order lands on the other side of a bf16 rounding boundary.
"""

import pytest
import torch

from moleculesde_tpu_torch.benchmarks.k6_widths import TOL as K6_TOL
from moleculesde_tpu_torch.benchmarks.k6_widths import WIDTH_GRID, width_operands
from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.ops.attn_bank import attn_map_bank_kernel, attn_map_bank_kernel_bwd
from moleculesde_tpu_torch.ops.attn_qk_bank import (
    attn_qk_bank, attn_qk_bank_bwd, attn_qk_bank_plain)
from moleculesde_tpu_torch.ops.cfconv import (
    bwd_plan, bwd_plan_kernel, fused_cfconv, fused_cfconv_bwd, fused_cfconv_plain,
    fused_cfconv_rbf, fused_cfconv_rbf_bwd, fwd_plan, fwd_plan_kernel, smear)
from moleculesde_tpu_torch.ops.fourier import gaussian_smearing
from moleculesde_tpu_torch.ops import gin_messages as gin_ops
from moleculesde_tpu_torch.ops import pair_block as pair_ops
from moleculesde_tpu_torch.ops.gin_messages import gin_messages, gin_messages_bwd
from moleculesde_tpu_torch.ops.gin_messages import gin_messages_plain
from moleculesde_tpu_torch.ops.pair_block import (
    pair_relu_project, pair_relu_project_bwd, pair_relu_project_cm,
    pair_relu_project_cm_bwd, pair_relu_project_cm_plain, pair_relu_project_plain)
from moleculesde_tpu_torch.ops.score_kernel import (
    score_eval_fused, score_eval_fused_plain, score_layout_bytes, score_plan)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _close(out, ref, tol):
    assert (out - ref).abs().max().item() <= tol * max(1.0, ref.abs().max().item())


def _grads(fn, inputs, g):
    """Output and gradients of ``fn`` for the cotangent ``g``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return (out.detach(),) + torch.autograd.grad(out, leaves, g)


def _gin_operands(cuda, b, n, e, d, f):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, n, f, device=cuda, generator=g)
    src = torch.randint(0, n + 1, (b, e), device=cuda, generator=g, dtype=torch.int32)
    dst = torch.randint(0, n + 1, (b, e), device=cuda, generator=g, dtype=torch.int32)
    boh = (torch.rand(b, e, d, device=cuda, generator=g) < 0.25).float()
    tbl = torch.randn(d, f, device=cuda, generator=g)
    return x, src, dst, boh, tbl, torch.randn(b, n, f, device=cuda, generator=g)


# the forward's shapes: the sampler's (B=64), the pretraining step's at
# n_max 32, 64 (B=128), 128 (B=32) and N = 256, E = 4 n_max; small ragged
# ones, D = 20 (the 32-column instantiation) and E = 0
GIN_FWD_SHAPES = [(64, 32, 128, 13, 300), (3, 7, 11, 13, 130), (128, 32, 128, 13, 300),
                  (128, 64, 256, 13, 300), (32, 128, 512, 13, 300), (4, 256, 1024, 13, 300),
                  (2, 9, 40, 20, 70), (2, 5, 0, 13, 70)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", GIN_FWD_SHAPES)
def test_gin_messages_kernel_matches_plain(cuda, shape, bf16):
    x, src, dst, boh, tbl, _ = _gin_operands(cuda, *shape)
    launches = gin_messages.launches
    out = gin_messages(x, src, dst, boh, tbl, bf16=bf16)
    assert gin_messages.launches == launches + 1
    _close(out, gin_messages_plain(x, src, dst, boh, tbl, bf16=bf16), 1e-2 if bf16 else 1e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape, case", [
    ((128, 32, 128, 13, 300), None), ((32, 128, 512, 13, 300), None),
    ((4, 256, 1024, 13, 300), None), ((3, 7, 11, 13, 130), "graph 2 keeps no edge"),
    ((2, 3, 40, 13, 70), "fewer nodes than node ranges"),
    ((2, 3, 40, 13, 70), "every source of graph 1 masked")])
def test_gin_messages_fwd_kernel_is_deterministic(cuda, shape, case, bf16):
    """Two forward runs give the same bits (one owner per output word, each
    node's messages summed in edge order), out-of-range src (negative) and
    dst (past N) edges besides the sentinel N, every node without a kept
    edge an exact zero; the schedule's corners as in the backward's test."""
    x, src, dst, boh, tbl, _ = _gin_operands(cuda, *shape)
    n = shape[1]
    src[:, ::3] = n
    src[:, 5::37] = -3
    dst[:, 9::41] = n + 7
    if case == "graph 2 keeps no edge":
        dst[2] = n
    elif case == "every source of graph 1 masked":
        src[1] = n
    first = gin_messages(x, src, dst, boh, tbl, bf16=bf16, impl="kernel")
    second = gin_messages(x, src, dst, boh, tbl, bf16=bf16, impl="kernel")
    assert torch.equal(first, second)
    _close(first, gin_messages_plain(x, src, dst, boh, tbl, bf16=bf16), 1e-2 if bf16 else 1e-5)
    has_edge = torch.zeros(shape[0], n + 1, dtype=torch.bool, device=cuda)
    valid = (dst >= 0) & (dst < n)
    has_edge.scatter_(1, torch.where(valid, dst.long(), n), valid)
    assert float(first[~has_edge[:, :n]].abs().sum()) == 0.0


def _k1_plans_match(plan, plan_kernel, ns):
    """Each shape's plan as the wrapper computes it is the CUDA source's:
    the block plan's shared bytes where it is chosen (0 from the C entry
    where there is no block plan), the ranges plan's node ranges and
    shared bytes past it."""
    for n in ns:
        for e in (0, 4 * n, 11):
            for d in (1, 13, 16, 17, 32, 33, 40):
                p = plan(n, e, d, 300)
                if p["plan"] == "block":
                    assert p["smem"] == plan_kernel(n, e, d), (n, e, d)
                else:
                    r = gin_ops.ranges_plan_kernel(n, e, d)
                    assert (p["ranges"], p["sort_smem"]) == (r["ranges"], r["sort_smem"])
                    assert p["walk_smem"] in (0, r["walk_smem"]), (n, e, d)


def test_gin_messages_fwd_plan_matches_kernel(cuda):
    """The wrapper's forward plan (ops/gin_messages.py::fwd_plan) is the
    CUDA source's, and the launch past the block plan takes the ranges
    plan."""
    _k1_plans_match(gin_ops.fwd_plan, gin_ops.fwd_plan_kernel,
                    (1, 7, 16, 32, 64, 128, 256, 700, 717, 718, 1024))
    x, src, dst, boh, tbl, _ = _gin_operands(cuda, 1, 1024, 4096, 13, 32)
    _close(gin_messages(x, src, dst, boh, tbl, impl="kernel"),
           gin_messages_plain(x, src, dst, boh, tbl), 1e-5)


# the pretraining step's shapes at n_max 32, 64 (B=128) and 128 (B=32), E =
# 4 n_max; a small ragged one; D = 20 (the 32-column instantiation)
GIN_BWD_SHAPES = [(128, 32, 128, 13, 300), (3, 7, 11, 13, 130), (128, 64, 256, 13, 300),
                  (32, 128, 512, 13, 300), (2, 9, 40, 20, 70)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", GIN_BWD_SHAPES)
def test_gin_messages_bwd_kernel_matches_plain(cuda, shape, bf16):
    """dx and dtable through autograd; sentinel edges (src or dst = N) on
    both sides.  bf16 tolerance 1e-2: dx is returned rounded to bf16."""
    x, src, dst, boh, tbl, g = _gin_operands(cuda, *shape)
    launches = gin_messages_bwd.launches

    def run(impl):
        return _grads(lambda x_, t_: gin_messages(x_, src, dst, boh, t_, bf16=bf16,
                                                  impl=impl), (x, tbl), g)

    kern, plain = run("kernel"), run("plain")
    assert gin_messages_bwd.launches == launches + 1
    for k, p in zip(kern, plain):
        _close(k, p, 1e-2 if bf16 else 1e-4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape, case", [
    ((128, 32, 128, 13, 300), None), ((128, 64, 256, 13, 300), None),
    ((32, 128, 512, 13, 300), None), ((4, 256, 1024, 13, 300), None),
    ((3, 7, 11, 13, 130), None),
    ((3, 7, 11, 13, 130), "graph 2 keeps no edge"),
    ((2, 3, 40, 13, 70), "fewer nodes than node ranges"),
    ((2, 3, 40, 13, 70), "every source of graph 1 masked")])
def test_gin_messages_bwd_kernel_is_deterministic(cuda, shape, case, bf16):
    """Two backward runs give the same bits (one owner per dx word, dtable
    summed in fixed orders), and every node without a valid edge gets an
    exact zero; N = 256 runs (no tile grows with N), and so do the
    schedule's corners: a graph whose edges all have a masked dst, N = 3
    below the block's 4 node ranges, a graph whose sources are all masked
    (its edges still reach dtable)."""
    x, src, dst, boh, tbl, g = _gin_operands(cuda, *shape)
    n = shape[1]
    src[:, ::3] = n                        # more sentinel sources
    if case == "graph 2 keeps no edge":
        dst[2] = n
    elif case == "every source of graph 1 masked":
        src[1] = n
    first = gin_messages_bwd(x, src, dst, boh, tbl, g, bf16=bf16, impl="kernel")
    second = gin_messages_bwd(x, src, dst, boh, tbl, g, bf16=bf16, impl="kernel")
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    plain = gin_messages_bwd(x, src, dst, boh, tbl, g, bf16=bf16, impl="plain")
    for k, p in zip(first, plain):
        _close(k, p, 1e-2 if bf16 else 1e-4)
    has_edge = torch.zeros(shape[0], n + 1, dtype=torch.bool, device=cuda)
    valid = (dst >= 0) & (dst < n)
    has_edge.scatter_(1, torch.where(valid, src.long(), n), valid)
    assert float(first[0][~has_edge[:, :n]].abs().sum()) == 0.0


def test_gin_messages_bwd_plan_matches_kernel(cuda):
    """The wrapper's plan (ops/gin_messages.py::bwd_plan) is the CUDA
    source's, and the launch past the block plan takes the ranges plan."""
    _k1_plans_match(gin_ops.bwd_plan, gin_ops.bwd_plan_kernel,
                    (1, 7, 16, 32, 64, 128, 256, 650, 660, 1024))
    x, src, dst, boh, tbl, g = _gin_operands(cuda, 1, 1024, 4096, 13, 32)
    kern = gin_messages_bwd(x, src, dst, boh, tbl, g, impl="kernel")
    for k, p in zip(kern, gin_messages_bwd(x, src, dst, boh, tbl, g, impl="plain")):
        _close(k, p, 1e-4)


# the ranges plan forced where the block plan fits: (B, N, E, D, F) and the
# corner cases of the block plan's tests
GIN_RANGES_SAME_BITS = [((128, 32, 128, 13, 300), None), ((32, 128, 512, 13, 300), None),
                        ((4, 256, 1024, 13, 300), None), ((2, 9, 40, 20, 70), None),
                        ((3, 7, 11, 14, 130), "graph 2 keeps no edge"),
                        ((2, 3, 40, 13, 70), "every source of graph 1 masked")]


def _gin_corner(ops, shape, case):
    x, src, dst, boh, tbl, g = ops
    n = shape[1]
    src[:, ::3] = n
    src[:, 5::37] = -3
    dst[:, 9::41] = n + 7
    if case == "graph 2 keeps no edge":
        dst[2] = n
    elif case == "every source of graph 1 masked":
        src[1] = n
    return x, src, dst, boh, tbl, g


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape, case", GIN_RANGES_SAME_BITS)
def test_gin_messages_ranges_plan_gives_the_block_plans_bits(cuda, shape, case, bf16):
    """Where both plans take a shape, the ranges plan (the device-memory
    sort, blocks of node ranges) gives the block plan's bits: the forward's
    outputs and dx (each node's sum one chain in edge order), and dtable
    where it has one node range (E <= 256, the same partial rows)."""
    x, src, dst, boh, tbl, g = _gin_corner(_gin_operands(cuda, *shape), shape, case)
    assert gin_ops.fwd_plan(shape[1], shape[2], shape[3], shape[4])["plan"] == "block"
    for plan in ("block", "ranges"):
        assert gin_ops._check_kernel_inputs(x, src, dst, boh, tbl, plan=plan)["plan"] == plan
    assert torch.equal(gin_ops._launch(x, src, dst, boh, tbl, bf16, plan="block"),
                       gin_ops._launch(x, src, dst, boh, tbl, bf16, plan="ranges"))
    dx_b, dt_b = gin_ops._launch_bwd(x, src, dst, boh, tbl, g, bf16, plan="block")
    dx_r, dt_r = gin_ops._launch_bwd(x, src, dst, boh, tbl, g, bf16, plan="ranges")
    assert torch.equal(dx_b, dx_r)
    if shape[2] <= 256:
        assert torch.equal(dt_b, dt_r)
    _close(dt_r, dt_b, 1e-2 if bf16 else 1e-4)


# past the block plan: N = 1024 / 2048 at E = 4 N (the pretraining step's
# D = 13, F = 300), D = 40 (two slices of 32 columns) at N = 128, and a
# small D = 40 shape with the corner cases' edges
GIN_LARGE = [(2, 1024, 4096, 13, 300), (2, 2048, 8192, 13, 300), (8, 128, 512, 40, 300),
             (3, 7, 11, 40, 70)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", GIN_LARGE)
def test_gin_messages_ranges_plan_matches_plain(cuda, shape, bf16):
    """The ranges plan past the block plan, forward and backward through
    autograd against the plain versions at the block plan's bars, each
    launch counted once, and two runs of each direction bit for bit."""
    x, src, dst, boh, tbl, g = _gin_corner(_gin_operands(cuda, *shape), shape, None)
    b, n, e, d, f = shape
    assert gin_ops.fwd_plan(n, e, d, f)["plan"] == gin_ops.bwd_plan(n, e, d, f)["plan"] \
        == "ranges"
    launches = (gin_messages.launches, gin_messages_bwd.launches)

    def run(impl):
        return _grads(lambda x_, t_: gin_messages(x_, src, dst, boh, t_, bf16=bf16,
                                                  impl=impl), (x, tbl), g)

    kern, plain = run("kernel"), run("plain")
    assert (gin_messages.launches, gin_messages_bwd.launches) == (launches[0] + 1,
                                                                  launches[1] + 1)
    for i, (k, p) in enumerate(zip(kern, plain)):
        _close(k, p, 1e-2 if bf16 else (1e-5 if i == 0 else 1e-4))
    assert torch.equal(kern[0], gin_messages(x, src, dst, boh, tbl, bf16=bf16, impl="kernel"))
    first = gin_messages_bwd(x, src, dst, boh, tbl, g, bf16=bf16, impl="kernel")
    second = gin_messages_bwd(x, src, dst, boh, tbl, g, bf16=bf16, impl="kernel")
    assert all(torch.equal(u, v) for u, v in zip(first, second))


# the backward's shapes: the pretraining step's at n_max 32 (B=128) and 128
# (B=32), N = 8 .. 64 at C = 300 (no multiple of the 64-channel blocks), N
# not a multiple of the 16-node tiles, narrow C and H
PAIR_BWD_SHAPES = [(128, 32, 300, 32), (3, 9, 17, 20), (32, 128, 300, 32), (4, 8, 300, 32),
                   (3, 13, 300, 32), (2, 37, 300, 32), (8, 64, 300, 32), (2, 13, 40, 5)]


# the forward's: the backward's, the 2D->3D sampler's (B=64, also with the
# 2D->3D model 64 and 128 wide: f32 at H = 128 runs the 8-source units), N
# past the first forward's cap of 160 (200, 256), H = 40 (two passes of 32
# h) at ragged C
PAIR_FWD_SHAPES = PAIR_BWD_SHAPES + [(64, 32, 300, 32), (3, 9, 17, 40), (2, 200, 300, 32),
                                     (2, 256, 300, 32), (2, 40, 64, 40), (64, 32, 300, 64),
                                     (64, 32, 300, 128)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", PAIR_FWD_SHAPES)
def test_pair_relu_project_kernel_matches_plain(cuda, shape, bf16):
    b, n, c, h = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(b, n, c, device=cuda, generator=g)
    cc = torch.randn(b, n, c, device=cuda, generator=g)
    w = torch.randn(c, h, device=cuda, generator=g) / c ** 0.5
    bias = torch.randn(h, device=cuda, generator=g)
    launches = pair_relu_project.launches
    out = pair_relu_project(a, cc, w, bias, bf16=bf16)
    assert pair_relu_project.launches == launches + 1
    _close(out, pair_relu_project_plain(a, cc, w, bias, bf16=bf16), 1e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", PAIR_BWD_SHAPES)
def test_pair_relu_project_bwd_kernel_matches_plain(cuda, shape, bf16):
    """da, dc, dw, db through autograd.  bf16 tolerance 1e-3: both sides
    round g, w and the relu'd pair identically and sum in f32."""
    b, n, c, h = shape
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn(b, n, c, device=cuda, generator=gen)
    cc = torch.randn(b, n, c, device=cuda, generator=gen)
    w = torch.randn(c, h, device=cuda, generator=gen) / c ** 0.5
    bias = torch.randn(h, device=cuda, generator=gen)
    g = torch.randn(b, n, n, h, device=cuda, generator=gen)
    launches = pair_relu_project_bwd.launches

    def run(impl):
        return _grads(lambda *t: pair_relu_project(*t, bf16=bf16, impl=impl),
                      (a, cc, w, bias), g)

    kern, plain = run("kernel"), run("plain")
    assert pair_relu_project_bwd.launches == launches + 1
    for k, p in zip(kern, plain):
        _close(k, p, 1e-3 if bf16 else 1e-4)


def _pair_operands(device, shape, seed):
    b, n, c, h = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(b, n, c, device=device, generator=gen)
    cc = torch.randn(b, n, c, device=device, generator=gen)
    w = torch.randn(c, h, device=device, generator=gen) / c ** 0.5
    bias = torch.randn(h, device=device, generator=gen)
    g = torch.randn(b, h, n * n, device=device, generator=gen)
    return a, cc, w, bias, g


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", PAIR_FWD_SHAPES)
def test_pair_relu_project_cm_kernel_matches_plain(cuda, shape, bf16):
    """K4 forward: [B, H, N*N], no bias inside the kernel.  bf16 tolerance
    1e-3: both sides round a, c, w and the relu'd pair identically."""
    a, cc, w, bias, _ = _pair_operands(cuda, shape, 5)
    launches = pair_relu_project_cm.launches
    out = pair_relu_project_cm(a, cc, w, bias, bf16=bf16)
    assert pair_relu_project_cm.launches == launches + 1
    ref = pair_relu_project_cm_plain(a, cc, w, bf16=bf16) + bias[None, :, None]
    _close(out, ref, 1e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", PAIR_BWD_SHAPES)
def test_pair_relu_project_cm_bwd_kernel_matches_plain(cuda, shape, bf16):
    """K4 da, dc, dw (and the bias gradient, outside the kernel) through
    autograd.  bf16 tolerance 1e-3: dpair is rounded to bf16 on both sides
    before the sums."""
    a, cc, w, bias, g = _pair_operands(cuda, shape, 6)
    launches = pair_relu_project_cm_bwd.launches

    def run(impl):
        return _grads(lambda *t: pair_relu_project_cm(*t, bf16=bf16, impl=impl),
                      (a, cc, w, bias), g)

    kern, plain = run("kernel"), run("plain")
    assert pair_relu_project_cm_bwd.launches == launches + 1
    for k, p in zip(kern, plain):
        _close(k, p, 1e-3 if bf16 else 1e-4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cm", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("shape", PAIR_FWD_SHAPES + [(2, 64, 500, 32)])
def test_pair_relu_project_fwd_kernel_is_deterministic(cuda, shape, cm, bf16):
    """Two forward runs give the same bits: each output written once, its
    k order fixed (C = 500 runs the 16-source units)."""
    a, cc, w, bias, _ = _pair_operands(cuda, shape, 11)
    if cm:
        run = lambda: pair_relu_project_cm(a, cc, w, bf16=bf16, impl="kernel")  # noqa: E731
    else:
        run = lambda: pair_relu_project(a, cc, w, bias, bf16=bf16, impl="kernel")  # noqa: E731
    first, second = run(), run()
    assert torch.equal(first, second)
    if shape[2] == 500:   # and the 16-source plan against the plain version
        assert pair_ops.fwd_plan(shape[1], 500, 32, bf16)["ts"] == 16
        ref = (pair_relu_project_cm_plain(a, cc, w, bf16=bf16) if cm
               else pair_relu_project_plain(a, cc, w, bias, bf16=bf16))
        _close(first, ref, 1e-3 if bf16 else 1e-5)


def test_pair_relu_project_fwd_plan_matches_kernel(cuda):
    """The wrapper's forward plan (ops/pair_block.py::fwd_plan) is the CUDA
    source's at every N, width and mode: 32-source units, 16 at C = 500, 8
    at C = 300, H = 128 in f32, none at C = 1000 or past the int32 index;
    its blocks are resident.  A
    launch past the int32 index raises, naming it."""
    for n in (1, 9, 32, 128, 160, 161, 256, 1024, 8191, 8192):
        for c, h in ((300, 32), (17, 40), (40, 5), (500, 32), (1000, 32), (300, 128)):
            for bf16 in (False, True):
                for cm in (False, True):
                    try:
                        plan = pair_ops.fwd_plan(n, c, h, bf16)
                    except ValueError:
                        plan = None
                    kern = pair_ops.fwd_plan_kernel(n, c, h, bf16, cm=cm, device=cuda)
                    if plan is None:
                        assert kern is None, (n, c, h, bf16, cm)
                        continue
                    assert kern.pop("resident") >= 1
                    assert kern == plan, (n, c, h, bf16, cm)
    a = torch.zeros(1, 8192, 16, device=cuda)   # the output would be 2^31 floats
    w, bias = torch.zeros(16, 32, device=cuda), torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="int32 index"):
        pair_relu_project(a, a, w, bias, impl="kernel")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cm", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("shape", PAIR_BWD_SHAPES + [(4, 40, 1100, 8)])
def test_pair_relu_project_bwd_kernel_is_deterministic(cuda, shape, cm, bf16):
    """Two backward runs give the same bits: fixed reduction orders, no
    float atomics."""
    a, cc, w, _, g = _pair_operands(cuda, shape, 7)
    b, n, c, h = shape
    if not cm:
        g = g.reshape(b, h, n, n).permute(0, 2, 3, 1).contiguous()
    bwd = pair_relu_project_cm_bwd if cm else pair_relu_project_bwd
    first = bwd(a, cc, w, g, bf16=bf16, impl="kernel")
    second = bwd(a, cc, w, g, bf16=bf16, impl="kernel")
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cm", [False, True], ids=["K3", "K4"])
def test_pair_relu_project_bwd_kernel_chunks(cuda, cm, bf16):
    """Plans with different chunk sizes agree within the bar: one graph of
    300 nodes run as it is (64-channel blocks) and zero padded to N = 400
    and 700 (32-channel blocks), each against the plain version of the
    unpadded graph.  Zero rows of a, c and g add nothing to any sum."""
    a, cc, w, _, g = _pair_operands(cuda, (1, 300, 300, 32), 9)
    if not cm:
        g = g.reshape(1, 32, 300, 300).permute(0, 2, 3, 1).contiguous()
    bwd = pair_relu_project_cm_bwd if cm else pair_relu_project_bwd
    plain = pair_ops.pair_relu_project_cm_bwd_plain if cm else pair_ops.pair_relu_project_bwd_plain
    ref = plain(a, cc, w, g, bf16=bf16)
    for npad, chunk in ((300, 64), (400, 32), (700, 32)):
        assert pair_ops.bwd_plan(npad, 300)["chunk"] == chunk
        pad = npad - 300
        ap, ccp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (a, cc))
        if cm:
            gp = torch.nn.functional.pad(g.reshape(1, 32, 300, 300), (0, pad, 0, pad))
            gp = gp.reshape(1, 32, npad * npad)
        else:
            gp = torch.nn.functional.pad(g, (0, 0, 0, pad, 0, pad))
        out = bwd(ap, ccp, w, gp.contiguous(), bf16=bf16, impl="kernel")
        for i, (k, p) in enumerate(zip(out, ref)):
            _close(k[:, :300] if i < 2 else k, p, 1e-3 if bf16 else 1e-4)


def test_pair_relu_project_bwd_plan_matches_kernel(cuda):
    """The wrapper's plan (ops/pair_block.py::bwd_plan) is the CUDA
    source's: whole-graph blocks of 64 channels at N <= 366, 32 to 748 (H
    <= 32), row tiles past that and passes of h past H = 32; and the launch
    past the whole-graph plan takes the tiled plan."""
    chunk_of = build.load("pair_block").pair_relu_project_bwd_chunk
    for n in (1, 7, 16, 32, 64, 65, 128, 200, 256, 366, 367, 512, 605, 748, 749, 1024, 2048):
        for h in (5, 32, 33, 64, 100):
            p = pair_ops.bwd_plan(n, 300, h)
            k = pair_ops.bwd_plan_kernel(n, h)
            assert k == {key: p[key] for key in k}, (n, h)
        assert (pair_ops.bwd_plan(n, 300)["chunk"] if n <= 748 else 0) == chunk_of(n), n
    assert all(pair_ops.bwd_plan(n, 300)["chunk"] == 64 for n in (16, 32, 64, 128, 256))
    a, cc, w, _, g = _pair_operands(cuda, (1, 749, 16, 8), 8)
    kern = pair_relu_project_cm_bwd(a, cc, w, g, impl="kernel")
    for k, p in zip(kern, pair_relu_project_cm_bwd(a, cc, w, g, impl="plain")):
        _close(k, p, 1e-4)


# the tiled backward: N = 1024 / 2048 at H = 32 (row tiles), N = 1024 at H =
# 64 (row tiles and two passes of h), and passes at small N: ragged H = 40,
# C = 300 with N not a multiple of the 16-node tiles, H = 100 (four passes)
PAIR_BWD_TILED = [(2, 1024, 300, 32), (1, 2048, 300, 32), (2, 1024, 300, 64),
                  (2, 37, 300, 40), (3, 13, 40, 100)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cm", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("shape", PAIR_BWD_TILED)
def test_pair_relu_project_bwd_tiled_matches_plain(cuda, shape, cm, bf16):
    """K3 / K4's backward in the tiled plan against the plain version at
    the whole-graph plan's bars (dpair one f32 sum over every pass of h,
    rounded once in K4's bf16 mode), one launch counted, two runs bit for
    bit (the dc, dW and db partials added in fixed orders)."""
    a, cc, w, _, g = _pair_operands(cuda, shape, 9)
    b, n, c, h = shape
    p = pair_ops.bwd_plan(n, c, h)
    assert p["tiles"] > 1 or p["passes"] > 1
    if not cm:
        g = g.reshape(b, h, n, n).permute(0, 2, 3, 1).contiguous()
    bwd = pair_relu_project_cm_bwd if cm else pair_relu_project_bwd
    launches = bwd.launches
    first = bwd(a, cc, w, g, bf16=bf16, impl="kernel")
    assert bwd.launches == launches + 1
    plain = bwd(a, cc, w, g, bf16=bf16, impl="plain")
    for k, q in zip(first, plain):
        _close(k, q, 1e-3 if bf16 else 1e-4)
    second = bwd(a, cc, w, g, bf16=bf16, impl="kernel")
    assert all(torch.equal(u, v) for u, v in zip(first, second))


def _score_operands(cuda, b, n, variant):
    model = SDEModel2Dto3D(emb_dim=8, hidden_dim=32, variant=variant, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(10 + variant)
    packed = model.packed_score_params()
    packed = packed + 0.05 * torch.randn(packed.shape, device=cuda, generator=gen)
    pos = 1.5 * torch.randn(b, n, 3, device=cuda, generator=gen)
    node = torch.randn(b, n, 32, device=cuda, generator=gen)
    edge = torch.randn(b, n, n, 32, device=cuda, generator=gen)
    mask = torch.rand(b, n, n, device=cuda, generator=gen) < 0.6
    # no self-pairs, as in the extended graph: at s == d the frame's cross
    # product p x p is zero only where a*b - c*d is not fused into an FMA
    mask[:, torch.arange(n), torch.arange(n)] = False
    mask[0, :, 0] = False                  # a destination with no valid source
    return pos, node, edge, mask, packed


# the fused chain's shape, n_max 64 (cluster of 4), 40 (two source chunks,
# the second ragged) and small ones; past 64 (clusters of 8, four source
# chunks, the slab in device memory): 65 (one pair of sources past 64),
# 96 (the last chunk empty) and 128
SCORE_SHAPES = [(64, 32), (3, 11), (64, 64), (2, 40), (1, 33), (2, 65), (2, 96), (8, 128)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("shape", SCORE_SHAPES)
def test_score_eval_fused_kernel_matches_plain(cuda, shape, variant, bf16):
    """K6 against its plain version on random operands and perturbed
    weights (every bias and LayerNorm parameter non-trivial), relative to
    the largest plain value: f32 1e-4 (sums in another order, warp-shuffle
    softmax); bf16 2e-2 (both sides round at the same points, so they
    differ where an f32 value taken in another order lands on the other side
    of a bf16 rounding boundary)."""
    b, n = shape
    pos, node, edge, mask, packed = _score_operands(cuda, b, n, variant)
    launches = score_eval_fused.launches
    out = score_eval_fused(pos, node, edge, mask, packed, variant=variant, bf16=bf16)
    assert score_eval_fused.launches == launches + 1
    ref = score_eval_fused_plain(pos, node, edge, mask, packed, variant=variant, bf16=bf16)
    assert out.shape == (b, n, 3) and bool(torch.isfinite(out).all())
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert err <= (2e-2 if bf16 else 1e-4), err


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 32), (8, 64), (4, 96), (8, 128)])
def test_score_eval_fused_kernel_is_deterministic(cuda, shape, bf16):
    """Two launches give the same bits: every score row is summed in its
    owning block in a fixed order."""
    pos, node, edge, mask, packed = _score_operands(cuda, *shape, 1)
    first = score_eval_fused(pos, node, edge, mask, packed, bf16=bf16)
    assert torch.equal(first, score_eval_fused(pos, node, edge, mask, packed, bf16=bf16))


def test_score_eval_plan_matches_kernel(cuda):
    """The wrapper's shared-memory count is the kernel's own layout."""
    import ctypes

    from moleculesde_tpu_torch.kernels import build

    fn = build.load("score_eval").score_eval_smem_bytes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    for n in (1, 11, 32, 33, 40, 64, 65, 96, 100, 128):
        for bf16 in (False, True):
            plan = score_plan(n, bf16)
            assert plan["smem"] == fn(n, plan["dests"], int(bf16))
            assert plan["smem"] == score_layout_bytes(n, plan["dests"], bf16)


def test_score_eval_fused_kernel_refuses_shapes(cuda):
    """Shapes the kernel does not take raise, never fall back: the cluster
    plan forced past n_max 128 in either mode (n_max 129 itself runs in the
    layered plan) or at another width.  Hidden 16 runs (the layered plan)
    and matches the plain version at K6's bars; what the JAX kernel cannot
    compute raises by name before dispatch: 16 heads, hidden 30 with 8
    heads, basis width 100."""
    model = SDEModel2Dto3D(emb_dim=8, hidden_dim=32, variant=1, device=cuda)
    packed = model.packed_score_params()
    pos, node = torch.zeros(2, 129, 3, device=cuda), torch.zeros(2, 129, 32, device=cuda)
    edge, mask = torch.zeros(2, 129, 129, 32, device=cuda), torch.ones(2, 129, 129, device=cuda)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="past the cluster plan"):
            score_eval_fused(pos, node, edge, mask, packed, variant=1, bf16=bf16,
                             plan="cluster")
        out = score_eval_fused(pos, node, edge, mask, packed, variant=1, bf16=bf16)
        assert out.shape == (2, 129, 3) and bool(torch.isfinite(out).all())
    ops16 = width_operands(cuda, 2, 8, 16, 128, 2, 2, 1)
    with pytest.raises(ValueError, match="the cluster plan takes hidden 32"):
        score_eval_fused(*ops16, plan="cluster")
    for bf16 in (False, True):
        assert score_plan(8, bf16, b=2, h=16)["plan"] == "layered"
        out = score_eval_fused(*ops16, bf16=bf16)
        ref = score_eval_fused_plain(*ops16, bf16=bf16, coff_dim=128)
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        assert err <= K6_TOL[bf16], (bf16, err)
    launches = score_eval_fused.launches
    for (h, heads, cd), what in (((64, 16, 128), "16 heads"), ((30, 8, 128), "hidden 30"),
                                 ((32, 8, 100), "basis width 100")):
        ops = width_operands(cuda, 2, 8, h, cd, 2, 2, 1)
        with pytest.raises(ValueError, match=what):
            score_eval_fused(*ops, n_head=heads)
    assert score_eval_fused.launches == launches


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("case", WIDTH_GRID,
                         ids=lambda c: "h{}-heads{}-cd{}-L{}xC{}-n{}-b{}".format(*c))
def test_score_eval_widths_match_plain(cuda, case, variant, bf16):
    """K6 at the widths the JAX kernel takes past the sampler's
    (``benchmarks/k6_widths.py``'s grid: hidden 8-128, 1-8 heads, basis
    widths 32-256, (L, C) = (2, 2), (1, 3), (3, 2), n_max 8-1024), all in
    the layered plan, against the plain version: f32 1e-5 and bf16 2e-2 of
    the largest plain value, one launch counted, two launches bit for
    bit."""
    h, heads, cd, layers, convs, n, b = case
    ops = width_operands(cuda, b, n, h, cd, layers, convs, variant, seed=h + n + variant)
    kw = dict(variant=variant, bf16=bf16, num_layers=layers, num_convs=convs, n_head=heads)
    assert score_plan(n, bf16, b=b, h=h, n_head=heads, coff_dim=cd, num_layers=layers,
                      num_convs=convs, variant=variant)["plan"] == "layered"
    launches = score_eval_fused.launches
    out = score_eval_fused(*ops, **kw)
    assert score_eval_fused.launches == launches + 1
    ref = score_eval_fused_plain(*ops, coff_dim=cd, **kw)
    assert out.shape == (b, n, 3) and bool(torch.isfinite(out).all())
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert err <= K6_TOL[bf16], err
    assert torch.equal(out, score_eval_fused(*ops, **kw))


# the layered plan past n_max 128: one source past the cluster plan (129,
# five chunks, the last holding one source), 256, 300 (ragged chunks and
# destination tiles), 1024 at B = 2
LAYERED_SHAPES = [(2, 129), (2, 256), (1, 300), (2, 1024)]


def _masked_molecules(mask, sizes):
    """Pairs past each molecule's atom count masked, as the chain's ragged
    batches hold them."""
    for i, size in enumerate(sizes):
        mask[i, size:] = False
        mask[i, :, size:] = False
    return mask


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("shape", LAYERED_SHAPES)
def test_score_eval_layered_matches_plain(cuda, shape, variant, bf16):
    """K6's layered plan against the plain version at the cluster plan's
    bars (f32 1e-4, bf16 2e-2 of the largest plain value), one launch
    counted, two launches bit for bit, and the rows of atoms past a
    molecule's size exactly 0."""
    b, n = shape
    pos, node, edge, mask, packed = _score_operands(cuda, b, n, variant)
    mask = _masked_molecules(mask, [n - 7 * i for i in range(b)])
    assert score_plan(n, bf16, b=b)["plan"] == "layered"
    launches = score_eval_fused.launches
    out = score_eval_fused(pos, node, edge, mask, packed, variant=variant, bf16=bf16)
    assert score_eval_fused.launches == launches + 1
    ref = score_eval_fused_plain(pos, node, edge, mask, packed, variant=variant, bf16=bf16)
    assert out.shape == (b, n, 3) and bool(torch.isfinite(out).all())
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert err <= (2e-2 if bf16 else 1e-4), err
    for i in range(1, b):
        assert not out[i, n - 7 * i:].any()
    assert torch.equal(out, score_eval_fused(pos, node, edge, mask, packed, variant=variant,
                                             bf16=bf16))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 32), (4, 40), (4, 64), (2, 128)])
def test_score_eval_layered_forced_inside_the_cluster_plan(cuda, shape, bf16):
    """The layered plan forced where the cluster plan runs: both against
    the plain version at the same bars."""
    b, n = shape
    pos, node, edge, mask, packed = _score_operands(cuda, b, n, 1)
    ref = score_eval_fused_plain(pos, node, edge, mask, packed, bf16=bf16)
    for which in ("cluster", "layered"):
        out = score_eval_fused(pos, node, edge, mask, packed, bf16=bf16, plan=which)
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        assert err <= (2e-2 if bf16 else 1e-4), (which, err)


def test_score_eval_layered_plan_matches_kernel(cuda):
    """The wrapper's layered plan is the kernel's own: the shared memory of
    the passes' rows and the device scratch at the sampler's and other
    widths; the C entries refuse the widths the wrapper refuses."""
    import ctypes

    from moleculesde_tpu_torch.kernels import build

    lib = build.load("score_layered")
    lib.score_eval_layered_scratch_bytes.restype = ctypes.c_longlong
    lib.score_eval_layered_scratch_bytes.argtypes = [ctypes.c_int] * 9
    lib.score_eval_layered_smem_bytes.restype = ctypes.c_int
    lib.score_eval_layered_smem_bytes.argtypes = [ctypes.c_int] * 7
    for b, n in ((1, 129), (2, 256), (2, 1024), (1, 2048), (64, 33)):
        for bf16 in (False, True):
            for h, heads, cd, layers, convs, variant in ((32, 8, 128, 2, 2, 1),
                                                         (64, 4, 256, 3, 2, 2),
                                                         (24, 8, 192, 1, 3, 1)):
                p = score_plan(n, bf16, plan="layered", b=b, h=h, n_head=heads, coff_dim=cd,
                               num_layers=layers, num_convs=convs, variant=variant)
                assert p["smem"] == lib.score_eval_layered_smem_bytes(
                    int(bf16), variant, layers, convs, h, heads, cd)
                assert p["scratch"] == lib.score_eval_layered_scratch_bytes(
                    b, n, int(bf16), variant, layers, convs, h, heads, cd)
    for h, heads, cd in ((64, 16, 128), (30, 8, 128), (32, 8, 100)):
        assert lib.score_eval_layered_scratch_bytes(1, 8, 0, 1, 2, 2, h, heads, cd) == -1
        assert lib.score_eval_layered_smem_bytes(0, 1, 2, 2, h, heads, cd) == -1


# the main path's shape, n_max 64 and 128 (no cap on N), and a small one
CFCONV_SHAPES = [(128, 32, 51, 128), (128, 64, 51, 128), (32, 128, 51, 128), (3, 7, 5, 16)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", CFCONV_SHAPES)
def test_fused_cfconv_kernel_matches_plain(cuda, shape, bf16):
    """Output and dx, dw1, db1, dw2, db2 through autograd.  bf16 tolerance
    2e-2: the softplus output and the backward's dwf / dpre are rounded to
    bf16 on both sides, so a one-ulp difference in an f32 intermediate can
    move a rounded value by one bf16 ulp.  In bf16 mode ea comes in bf16, as
    SchNet hands it over; the kernel then agrees bit for bit with itself on
    the same values in f32."""
    b, n, gdim, f = shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    ea = torch.rand(b, n, n, gdim, device=cuda, generator=gen)
    if bf16:
        ea = ea.to(torch.bfloat16)
    env = torch.rand(b, n, n, device=cuda, generator=gen) * (
        torch.rand(b, n, n, device=cuda, generator=gen) < 0.8)
    x = torch.randn(b, n, f, device=cuda, generator=gen)
    w1 = torch.randn(gdim, f, device=cuda, generator=gen) / gdim ** 0.5
    b1 = torch.randn(f, device=cuda, generator=gen) * 0.1
    w2 = torch.randn(f, f, device=cuda, generator=gen) / f ** 0.5
    b2 = torch.randn(f, device=cuda, generator=gen) * 0.1
    g = torch.randn(b, n, f, device=cuda, generator=gen)
    launches = (fused_cfconv.launches, fused_cfconv_bwd.launches)

    def run(impl):
        return _grads(lambda *t: fused_cfconv(ea, env, *t, bf16=bf16, impl=impl),
                      (x, w1, b1, w2, b2), g)

    kern, plain = run("kernel"), run("plain")
    assert (fused_cfconv.launches, fused_cfconv_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    _close(kern[0], plain[0], 2e-2 if bf16 else 1e-5)
    for k, p in zip(kern[1:], plain[1:]):
        _close(k, p, 2e-2 if bf16 else 1e-4)
    if bf16:
        ea32 = _grads(lambda *t: fused_cfconv(ea.float(), env, *t, bf16=True,
                                              impl="kernel"), (x, w1, b1, w2, b2), g)
        for k, k32 in zip(kern, ea32):
            assert torch.equal(k, k32)


def _cfconv_operands(cuda, b, n, gdim, f, seed=3):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ea = torch.rand(b, n, n, gdim, device=cuda, generator=gen).to(torch.bfloat16)
    env = torch.rand(b, n, n, device=cuda, generator=gen) * (
        torch.rand(b, n, n, device=cuda, generator=gen) < 0.8)
    x = torch.randn(b, n, f, device=cuda, generator=gen)
    w1 = torch.randn(gdim, f, device=cuda, generator=gen) / gdim ** 0.5
    b1 = torch.randn(f, device=cuda, generator=gen) * 0.1
    w2 = torch.randn(f, f, device=cuda, generator=gen) / f ** 0.5
    b2 = torch.randn(f, device=cuda, generator=gen) * 0.1
    return ea, env, (x, w1, b1, w2, b2), torch.randn(b, n, f, device=cuda, generator=gen)


@pytest.mark.parametrize("shape", [(4, 40, 51, 256), (6, 33, 100, 128), (5, 200, 51, 100)])
def test_fused_cfconv_bwd_kernel_other_plans(cuda, shape):
    """bf16 backward on the plans the main path does not take: F padded to
    256 (dW1 and dW2 added into the block partials per tile), G16 > 64 (dW1
    so), and N = 200 in four row chunks with F padded to 128; bar as K2's."""
    b, n, gdim, f = shape
    ea, env, params, g = _cfconv_operands(cuda, *shape)
    for k, p in zip(fused_cfconv_bwd(ea, env, *params, g, bf16=True, impl="kernel"),
                    fused_cfconv_bwd(ea, env, *params, g, bf16=True, impl="plain")):
        _close(k, p, 2e-2)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_cfconv_bwd_kernel_is_deterministic(cuda, bf16):
    """Two backward runs give the same bits: fixed unit assignment, fixed
    orders within and across blocks, no atomics."""
    ea, env, params, g = _cfconv_operands(cuda, 64, 64, 51, 128)
    ea = ea if bf16 else ea.float()
    first = fused_cfconv_bwd(ea, env, *params, g, bf16=bf16)
    second = fused_cfconv_bwd(ea, env, *params, g, bf16=bf16)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fused_cfconv_bwd_plan_matches_kernel(cuda):
    """The wrapper's plan (ops/cfconv.py::bwd_plan) is the CUDA source's."""
    for n in (1, 7, 16, 32, 33, 64, 128, 200):
        for gdim, f in ((51, 128), (5, 16), (100, 64), (51, 256), (64, 300)):
            for bf16 in (False, True):
                for pair_bytes in (2 * gdim, 4 * gdim, 4):
                    assert (bwd_plan(n, gdim, f, bf16, pair_bytes)
                            == bwd_plan_kernel(n, gdim, f, bf16, pair_bytes))


# (B, N, G, F): F padded to 64 and 128 with 16 / 100 real features, G = 5
# and 20, N = 200 in seven column chunks; F = 200 (bf16: weights resident,
# ea in chunks; f32: weights in device memory), G = 300 (ea in chunks) and
# G = 700 (f32: weights in device memory, ea in chunks)
FWD_OTHER_PLANS = [(4, 40, 5, 16), (6, 33, 20, 100), (3, 200, 51, 100), (2, 24, 51, 200),
                   (2, 9, 300, 64), (2, 40, 700, 16)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FWD_OTHER_PLANS)
def test_fused_cfconv_fwd_kernel_other_plans(cuda, shape, bf16):
    """The forward on the plans the main path does not take, against the
    plain version (bars of ``test_fused_cfconv_kernel_matches_plain``)."""
    ea, env, params, _ = _cfconv_operands(cuda, *shape)
    ea = ea if bf16 else ea.float()
    launches = fused_cfconv.launches
    out = fused_cfconv(ea, env, *params, bf16=bf16, impl="kernel")
    assert fused_cfconv.launches == launches + 1
    _close(out, fused_cfconv_plain(ea, env, *params, bf16=bf16), 2e-2 if bf16 else 1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_cfconv_fwd_kernel_is_deterministic(cuda, bf16):
    """Two forward runs give the same bits (each output row is summed in one
    unit, in a fixed order), for K2 and K5."""
    ea, env, params, _ = _cfconv_operands(cuda, 64, 64, 51, 128)
    ea = ea if bf16 else ea.float()
    assert torch.equal(fused_cfconv(ea, env, *params, bf16=bf16),
                       fused_cfconv(ea, env, *params, bf16=bf16))
    dist, env, params, _ = _rbf_operands(cuda, 64, 64, 51, 128)
    kw = dict(start=0.0, stop=10.0, num_gaussians=51, bf16=bf16)
    assert torch.equal(fused_cfconv_rbf(dist, env, *params, **kw),
                       fused_cfconv_rbf(dist, env, *params, **kw))


def test_fused_cfconv_fwd_plan_matches_kernel(cuda):
    """The wrapper's plan (ops/cfconv.py::fwd_plan) is the CUDA source's."""
    for n in (1, 7, 16, 17, 32, 33, 64, 128, 200):
        for gdim, f in ((51, 128), (5, 16), (100, 64), (51, 200), (300, 64), (700, 16),
                        (64, 300)):
            for bf16 in (False, True):
                for pair_bytes in (2 * gdim, 4 * gdim, 4):
                    assert (fwd_plan(n, gdim, f, bf16, pair_bytes)
                            == fwd_plan_kernel(n, gdim, f, bf16, pair_bytes))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_cfconv_fwd_kernel_zero_env_rows_are_zero(cuda, bf16):
    """Rows whose env is zero on every pair (past each graph's atoms; one
    graph empty) come out as exact zeros -- the kernel skips their tiles --
    and the other rows agree with the plain version."""
    b, n = 8, 64
    ea, env, params, _ = _cfconv_operands(cuda, b, n, 51, 128)
    ea = ea if bf16 else ea.float()
    atoms = torch.tensor([0, 3, 17, 31, 32, 33, 50, 64], device=cuda)
    live = torch.arange(n, device=cuda)[None, :] < atoms[:, None]       # [B, N]
    env = (env * (live[:, :, None] & live[:, None, :])).contiguous()
    out = fused_cfconv(ea, env, *params, bf16=bf16, impl="kernel")
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    _close(out, fused_cfconv_plain(ea, env, *params, bf16=bf16), 2e-2 if bf16 else 1e-5)


def _offset_copy(t, elements: int = 1):
    """A contiguous copy of ``t`` starting ``elements`` past an allocation's
    start, so not 16-byte aligned."""
    store = torch.empty(elements + t.numel(), dtype=t.dtype, device=t.device)
    return store[elements:].view_as(t).copy_(t)


def test_fused_cfconv_kernel_alignment(cuda):
    """The kernels read the weights and biases element by element and copy
    env in 4-byte pieces, so views of them at any offset run, forward and
    backward; ea, copied in 16-byte pieces, raises by name where it is not
    16-byte aligned."""
    ea, env, (x, w1, b1, w2, b2), g = _cfconv_operands(cuda, 2, 24, 51, 128)
    env_o, w1_o, b1_o, w2_o = (_offset_copy(t) for t in (env, w1, b1, w2))
    assert all(t.data_ptr() % 16 for t in (env_o, w1_o, b1_o, w2_o))
    _close(fused_cfconv(ea, env_o, x, w1_o, b1_o, w2_o, b2, bf16=True, impl="kernel"),
           fused_cfconv_plain(ea, env, x, w1, b1, w2, b2, bf16=True), 2e-2)
    for k, p in zip(fused_cfconv_bwd(ea, env_o, x, w1_o, b1_o, w2_o, b2, g, bf16=True,
                                     impl="kernel"),
                    fused_cfconv_bwd(ea, env, x, w1, b1, w2, b2, g, bf16=True, impl="plain")):
        _close(k, p, 2e-2)
    with pytest.raises(ValueError, match="ea must be 16-byte aligned"):
        fused_cfconv(_offset_copy(ea), env, x, w1, b1, w2, b2, bf16=True, impl="kernel")
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        fused_cfconv(ea, env, _offset_copy(x), w1, b1, w2, b2, bf16=True, impl="kernel")


def test_kernels_refuse_autograd_inputs(cuda):
    """K2 gives no gradient to ea or env: asking for one raises."""
    ea = torch.rand(2, 4, 4, 3, device=cuda, requires_grad=True)
    x = torch.randn(2, 4, 8, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient to ea or env"):
        fused_cfconv(ea, torch.ones(2, 4, 4, device=cuda), x, torch.ones(3, 8, device=cuda),
                     torch.zeros(8, device=cuda), torch.ones(8, 8, device=cuda),
                     torch.zeros(8, device=cuda))


def _rbf_operands(cuda, b, n, gdim, f):
    gen = torch.Generator(device=cuda).manual_seed(5)
    dist = torch.rand(b, n, n, device=cuda, generator=gen) * 12.0
    env = torch.rand(b, n, n, device=cuda, generator=gen) * (
        torch.rand(b, n, n, device=cuda, generator=gen) < 0.8)
    x = torch.randn(b, n, f, device=cuda, generator=gen)
    w1 = torch.randn(gdim, f, device=cuda, generator=gen) / gdim ** 0.5
    b1 = torch.randn(f, device=cuda, generator=gen) * 0.1
    w2 = torch.randn(f, f, device=cuda, generator=gen) / f ** 0.5
    b2 = torch.randn(f, device=cuda, generator=gen) * 0.1
    return dist, env, (x, w1, b1, w2, b2), torch.randn(b, n, f, device=cuda, generator=gen)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", CFCONV_SHAPES)
def test_fused_cfconv_rbf_kernel_matches_plain(cuda, shape, bf16):
    """K5: output and dx, dw1, db1, dw2, db2 through autograd against its
    plain version (tolerances as K2's); then against K2 fed the same
    smearing, which stages the same values: equal bit for bit."""
    b, n, gdim, f = shape
    dist, env, params, g = _rbf_operands(cuda, *shape)
    kw = dict(start=0.0, stop=10.0, num_gaussians=gdim, bf16=bf16)
    launches = (fused_cfconv_rbf.launches, fused_cfconv_rbf_bwd.launches)

    def run(impl):
        return _grads(lambda *t: fused_cfconv_rbf(dist, env, *t, impl=impl, **kw), params, g)

    kern, plain = run("kernel"), run("plain")
    assert (fused_cfconv_rbf.launches, fused_cfconv_rbf_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    _close(kern[0], plain[0], 2e-2 if bf16 else 1e-5)
    for k, p in zip(kern[1:], plain[1:]):
        _close(k, p, 2e-2 if bf16 else 1e-4)
    ea = smear(dist, 0.0, 10.0, gdim, bf16=bf16)
    k2 = _grads(lambda *t: fused_cfconv(ea, env, *t, bf16=bf16, impl="kernel"), params, g)
    for k, k2_ in zip(kern, k2):
        assert torch.equal(k, k2_)


def test_fused_cfconv_rbf_kernel_matches_k2_on_gaussian_smearing(cuda):
    """K5 against K2 on ``gaussian_smearing(dist)``, f32: the two smearings
    differ in their last bits only (iota * step against linspace)."""
    dist, env, params, g = _rbf_operands(cuda, 16, 32, 51, 128)
    ea = gaussian_smearing(dist, 0.0, 10.0, 51)
    _close(fused_cfconv_rbf(dist, env, *params, start=0.0, stop=10.0, num_gaussians=51),
           fused_cfconv(ea, env, *params), 1e-5)
    for k5, k2 in zip(fused_cfconv_rbf_bwd(dist, env, *params, g, start=0.0, stop=10.0,
                                           num_gaussians=51),
                      fused_cfconv_bwd(ea, env, *params, g)):
        _close(k5, k2, 1e-4)


def test_fused_cfconv_rbf_kernel_refuses(cuda):
    """K5 refuses gradients for dist / env, a bf16 dist, and an f32
    backward whose weights cannot be staged in shared memory (F = 256),
    naming the sizes.  N = 64 is no longer refused."""
    dist, env, params, g = _rbf_operands(cuda, 2, 64, 51, 128)
    kw = dict(start=0.0, stop=10.0, num_gaussians=51)
    with pytest.raises(RuntimeError, match="no gradient to dist or env"):
        fused_cfconv_rbf(dist.clone().requires_grad_(True), env, *params, **kw)
    with pytest.raises(TypeError, match="dist must be float32"):
        fused_cfconv_rbf(dist.bfloat16(), env, *params, **kw)
    fused_cfconv_rbf_bwd(dist, env, *params, g, **kw)
    dist, env, params, g = _rbf_operands(cuda, 2, 8, 51, 256)
    with pytest.raises(ValueError, match="G=51, F=256 .f32 mode. cannot be staged"):
        fused_cfconv_rbf_bwd(dist, env, *params, g, **kw)


def _bank_operands(device, b, c, n, a, seed, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = (0.8 * torch.randn(b, c, n, a, device=device, generator=gen)).to(dtype)
    k = (0.8 * torch.randn(b, c, n, a, device=device, generator=gen)).to(dtype)
    g = torch.randn(b, c, n, n, device=device, generator=gen)
    return q, k, g


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(128, 8, 32, 32, 4), (3, 2, 9, 12, 2)])
def test_attn_map_bank_kernel_matches_plain(cuda, shape, bf16):
    """K7 forward and backward (dq, dk in q's dtype) through autograd,
    relative to the largest plain value: f32 1e-5 forward, 1e-4 backward
    (sums in another order); bf16 1e-2 (du is rounded to bf16 on both
    sides; dq and dk are bf16 outputs)."""
    b, c, n, a, ds = shape
    q, k, g = _bank_operands(cuda, b, c, n, a, 20,
                             torch.bfloat16 if bf16 else torch.float32)
    launches = (attn_map_bank_kernel.launches, attn_map_bank_kernel_bwd.launches)

    def run(impl):
        return _grads(lambda q_, k_: attn_map_bank_kernel(q_, k_, ds, bf16=bf16, impl=impl),
                      (q, k), g)

    kern, plain = run("kernel"), run("plain")
    assert (attn_map_bank_kernel.launches, attn_map_bank_kernel_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert kern[1].dtype == q.dtype
    for i, (x, y) in enumerate(zip(kern, plain)):
        tol = 1e-2 if bf16 else (1e-5 if i == 0 else 1e-4)
        err = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert err <= tol, (i, err)


def _qk_bank_operands(device, b, n, f, c, a, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = [(c, f, a), (c, a), (c, a, a), (c, a)] * 2
    ws = [torch.randn(s, device=device, generator=gen) / (s[-2] ** 0.5 if len(s) == 3 else 4.0)
          for s in shapes]
    qk = torch.randn(b, n, f, device=device, generator=gen)
    return qk, ws, torch.randn(b, c, n, n, device=device, generator=gen)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(128, 32, 300, 2, 32, 4), (128, 32, 16, 8, 32, 4),
                                   (16, 32, 900, 2, 32, 4), (3, 9, 13, 3, 8, 2)])
def test_attn_qk_bank_kernel_matches_plain(cuda, shape, bf16):
    """K8 forward and backward (dqk and the eight weight gradients) through
    autograd, relative to the largest plain value: f32 1e-5 forward, 1e-4
    backward (weight sums over up to 4096 rows in another order); bf16
    1e-2 (both sides round at the same points)."""
    b, n, f, c, a, ds = shape
    qk, ws, g = _qk_bank_operands(cuda, b, n, f, c, a, 21)
    launches = (attn_qk_bank.launches, attn_qk_bank_bwd.launches)

    def run(impl):
        return _grads(lambda *t: attn_qk_bank(*t, ds, bf16=bf16, impl=impl), [qk] + ws, g)

    kern, plain = run("kernel"), run("plain")
    assert (attn_qk_bank.launches, attn_qk_bank_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    for i, (x, y) in enumerate(zip(kern, plain)):
        tol = 1e-2 if bf16 else (1e-5 if i == 0 else 1e-4)
        err = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert err <= tol, (i, err)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(128, 64, 16, 8, 32, 4), (128, 64, 300, 2, 32, 4),
                                   (4, 100, 13, 3, 8, 2), (2, 33, 260, 2, 32, 8),
                                   (2, 256, 16, 8, 32, 4)])
def test_attn_qk_bank_fwd_kernel_past_n32(cuda, shape, bf16):
    """K8's forward past N = 32: the maps against
    the plain version at the bars of the test above, and two runs bit for
    bit (every sum in a fixed order).  (2, 33, 260, ...) stages W1 in three
    chunks and pairs rows past N."""
    b, n, f, c, a, ds = shape
    qk, ws, _ = _qk_bank_operands(cuda, b, n, f, c, a, 22)
    qk = qk.to(torch.bfloat16 if bf16 else torch.float32)
    out = attn_qk_bank(qk, *ws, ds, bf16=bf16, impl="kernel")
    ref = attn_qk_bank_plain(qk, *ws, ds, bf16=bf16)
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert err <= (1e-2 if bf16 else 1e-5), err
    assert torch.equal(out, attn_qk_bank(qk, *ws, ds, bf16=bf16, impl="kernel"))


def test_attn_qk_bank_fwd_plan_matches_kernel(cuda):
    """The wrapper's shared-memory count is the forward kernel's own layout."""
    import ctypes

    from moleculesde_tpu_torch.kernels import build
    from moleculesde_tpu_torch.ops.attn_qk_bank import fwd_plan

    fn = build.load("attn_qk_bank").attn_qk_bank_fwd_smem_bytes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    for n, f, a in ((32, 16, 32), (32, 300, 32), (64, 16, 32), (9, 13, 8), (33, 260, 32),
                    (334, 16, 32)):
        fc, smem = fwd_plan(n, f, a)
        assert smem == fn(n, fc, a)


# (B, C, N, A, ds) past N = 32: the backward's 32-row units and 32-column
# chunks with a ragged second tile (N = 33), 2 / 4 / 8 tiles a side (N = 64
# / 128 / 256), 19 past the old backward's N <= 518 (N = 600), and the
# scalar path (ds = 2, A = 12)
MAP_LARGE_N = [(4, 8, 33, 32, 4), (16, 8, 64, 32, 4), (8, 8, 128, 32, 4), (2, 8, 256, 32, 4),
               (3, 2, 40, 12, 2), (1, 2, 600, 32, 4)]

# (B, N) of K7's forward in (graph, channel, 32 x 32 tile) units: one
# ragged tile (1, 7), one whole tile (32), a ragged second tile (33),
# 2 x 2 to 8 x 8 tiles (64, 128, 256)
MAP_FWD_SHAPES = [(3, 1), (5, 7), (16, 32), (4, 33), (8, 64), (4, 128), (2, 256)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [2, 8])
@pytest.mark.parametrize("shape", MAP_FWD_SHAPES)
def test_attn_map_bank_fwd_kernel_tiles(cuda, shape, c, bf16):
    """K7's forward against its plain version at the chain's A = 32, ds = 4
    and C = 2 / 8 (edge layers 0 / 1-3), q and k in the mode's dtype:
    1e-5 of the largest plain value in f32 (its tanh is ~5e-7 absolute
    off tanhf, the logits' sums run in another order) and, with nothing
    rounded after the bf16 operands, in bf16 mode too; two launches bit
    for bit; f32 operands in bf16 mode are rounded as the plain version
    rounds them."""
    b, n = shape
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, _ = _bank_operands(cuda, b, c, n, 32, 25, dt)
    out = attn_map_bank_kernel(q, k, 4, bf16=bf16, impl="kernel")
    ref = attn_map_bank_kernel(q, k, 4, bf16=bf16, impl="plain")
    assert out.shape == (b, c, n, n) and out.dtype == torch.float32
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    assert torch.equal(out, attn_map_bank_kernel(q, k, 4, bf16=bf16, impl="kernel"))
    if bf16:
        q32, k32 = q.float() + 1e-3, k.float()   # off the bf16 grid: the kernel rounds
        ref = attn_map_bank_kernel(q32, k32, 4, bf16=True, impl="plain")
        out = attn_map_bank_kernel(q32, k32, 4, bf16=True, impl="kernel")
        assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MAP_LARGE_N)
def test_attn_map_bank_kernel_past_n32(cuda, shape, bf16):
    """K7 forward and backward past N = 32 (the backward's dq in row units,
    dk in column units) against the plain versions at the bars of the N =
    32 test, and two runs of each kernel bit for bit."""
    b, c, n, a, ds = shape
    q, k, g = _bank_operands(cuda, b, c, n, a, 23, torch.bfloat16 if bf16 else torch.float32)

    def run(impl):
        return _grads(lambda q_, k_: attn_map_bank_kernel(q_, k_, ds, bf16=bf16, impl=impl),
                      (q, k), g)

    for i, (x, y) in enumerate(zip(run("kernel"), run("plain"))):
        tol = 1e-2 if bf16 else (1e-5 if i == 0 else 1e-4)
        err = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert err <= tol, (i, err)
    with torch.no_grad():
        assert torch.equal(attn_map_bank_kernel(q, k, ds, bf16=bf16),
                           attn_map_bank_kernel(q, k, ds, bf16=bf16))
        first = attn_map_bank_kernel_bwd(q, k, g, ds, bf16=bf16)
        assert all(torch.equal(u, v)
                   for u, v in zip(first, attn_map_bank_kernel_bwd(q, k, g, ds, bf16=bf16)))


# (B, N, F, C, A, ds) past N = 32: the 3D->2D chain's edge layers 1-3
# (F = 16, C = 8) and 0 (F = 300, C = 2), variant 3's F = 900, a ragged
# small shape; 2 rows a tile and 16-feature chunks at N = 256
QK_BWD_LARGE_N = [(4, 33, 16, 8, 32, 4), (16, 64, 300, 2, 32, 4), (8, 128, 16, 8, 32, 4),
                  (2, 128, 900, 2, 32, 4), (2, 256, 16, 8, 32, 4), (2, 256, 300, 2, 32, 4),
                  (3, 40, 13, 3, 8, 2)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", QK_BWD_LARGE_N)
def test_attn_qk_bank_bwd_kernel_past_n32(cuda, shape, bf16):
    """K8's backward past N = 32 (dqk and the eight weight gradients)
    against the plain version on the operands as the wrapper hands them
    over, at the bars of the N = 32 test, and two runs bit for bit (every
    sum in a fixed order, no atomics).  On its own, not through autograd:
    the forward takes N = 256 only at F = 16 (its own test)."""
    b, n, f, c, a, ds = shape
    qk, ws, g = _qk_bank_operands(cuda, b, n, f, c, a, 24)
    qd = qk.to(torch.bfloat16 if bf16 else torch.float32)
    first = attn_qk_bank_bwd(qd, *ws, g, ds, bf16=bf16, impl="kernel")
    plain = attn_qk_bank_bwd(qd, *ws, g, ds, bf16=bf16, impl="plain")
    assert first[0].dtype == qd.dtype
    for i, (x, y) in enumerate(zip(first, plain)):
        err = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert err <= (1e-2 if bf16 else 1e-4), (i, err)
    second = attn_qk_bank_bwd(qd, *ws, g, ds, bf16=bf16, impl="kernel")
    assert all(torch.equal(u, v) for u, v in zip(first, second))


def test_attn_bank_plans_match_kernels(cuda):
    """The wrappers' plans are the kernels' own: K7's (rows, shared bytes)
    forward and backward, K8's backward (row tile, feature chunk, shared
    bytes)."""
    import ctypes

    from moleculesde_tpu_torch.kernels import build
    from moleculesde_tpu_torch.ops.attn_bank import plan
    from moleculesde_tpu_torch.ops.attn_qk_bank import bwd_plan

    k7 = build.load("attn_bank").attn_bank_plan
    k7.restype = None
    k7.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    k7g = build.load("attn_bank").attn_bank_group_plan
    k7g.restype = None
    k7g.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    k8 = build.load("attn_qk_bank").attn_qk_bank_bwd_plan
    k8.restype = None
    k8.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    for n, a, h in ((32, 32, 8), (33, 32, 8), (64, 32, 8), (128, 32, 8), (256, 32, 8),
                    (518, 32, 8), (600, 32, 8), (1024, 32, 8), (40, 12, 6), (9, 8, 4)):
        for bwd in (False, True):
            k7(n, a, h, int(bwd), ctypes.addressof(out))
            assert (out[0], out[1]) == plan(n, a, h, bwd)[:2], (n, a, h, bwd)
    # the grouped plan, by default past the block plans and forced at A = 32
    for n, a, h, groups in ((32, 320, 8, 0), (600, 512, 8, 0), (32, 1024, 8, 0),
                            (64, 140, 35, 0), (64, 456, 8, 0), (64, 312, 8, 0),
                            (64, 32, 8, 2), (64, 32, 8, 4), (64, 32, 8, 8), (64, 32, 8, 1)):
        for bwd in (False, True):
            k7g(n, a, h, int(bwd), groups, ctypes.addressof(out))
            assert tuple(out) == plan(n, a, h, bwd, groups or None), (n, a, h, groups, bwd)
    for n, f, a, h in ((32, 16, 32, 8), (64, 300, 32, 8), (128, 16, 32, 8), (128, 900, 32, 8),
                       (256, 16, 32, 8), (256, 300, 32, 8), (266, 900, 32, 8), (267, 16, 32, 8),
                       (40, 13, 8, 4), (3, 5, 8, 4)):
        k8(n, f, a, h, ctypes.addressof(out))
        assert tuple(out) == bwd_plan(n, f, a, h), (n, f, a, h)


def test_attn_bank_kernels_refuse_shapes(cuda):
    """Shapes the bank kernels are not built for raise, never fall back:
    A not a multiple of ds, K7's block plans forced past their shared
    memory (A = 1024 forward, A = 140, H = 35 backward), which run in the
    grouped plans by default (and N = 881 / 519, past the old plans, in
    the block plans), K8 at a ds that does not divide A; K8's forward past
    N = 334 at F = 16 and its backward past N = 266 run in the tiled plan."""
    q = torch.zeros(2, 2, 8, 30, device=cuda)
    with pytest.raises(ValueError, match="multiple of ds"):
        attn_map_bank_kernel(q, q, 4)
    q = torch.zeros(1, 1, 881, 32, device=cuda)
    assert attn_map_bank_kernel(q, q, 4).shape == (1, 1, 881, 881)
    q = torch.zeros(1, 1, 8, 1024, device=cuda)
    with pytest.raises(ValueError, match=r"forward kernel: N=8, A=1024, H=256 in 1 group\(s\) "
                                         r"need .* shared"):
        attn_map_bank_kernel(q, q, 4, groups=1)
    assert attn_map_bank_kernel(q, q, 4).shape == (1, 1, 8, 8)
    q = torch.zeros(1, 1, 519, 32, device=cuda)
    g = torch.zeros(1, 1, 519, 519, device=cuda)
    dq, dk = attn_map_bank_kernel_bwd(q, q, g, 4, impl="kernel")
    assert dq.shape == dk.shape == (1, 1, 519, 32) and not dq.any() and not dk.any()
    q = torch.zeros(1, 1, 8, 140, device=cuda)
    g = torch.zeros(1, 1, 8, 8, device=cuda)
    with pytest.raises(ValueError, match=r"backward kernel: N=8, A=140, H=35 in 1 group\(s\) "
                                         r"need .* shared"):
        attn_map_bank_kernel_bwd(q, q, g, 4, impl="kernel", groups=1)
    dq, dk = attn_map_bank_kernel_bwd(q, q, g, 4, impl="kernel")
    assert dq.shape == dk.shape == (1, 1, 8, 140) and not dq.any() and not dk.any()
    qk, ws, _ = _qk_bank_operands(cuda, 2, 600, 16, 2, 32, 0)
    assert attn_qk_bank(qk, *ws, 4).shape == (2, 2, 600, 600)   # the tiled plan
    qk, ws, g = _qk_bank_operands(cuda, 1, 267, 16, 2, 32, 0)
    assert attn_qk_bank_bwd(qk, *ws, g, 4, impl="kernel")[0].shape == qk.shape
    with pytest.raises(ValueError, match="multiple of ds"):
        attn_qk_bank(qk, *ws, 5)


# (A, ds) of K7's grouped plans: the 3D->2D model at adim 160 / 256 / 512
# (ds = A / 8, H = 8; the forward's slices and the backward's head units)
# and 35 heads of 4 (A = 140: the forward's whole row, the grouped backward)
GROUPED_A = [(320, 40), (512, 64), (1024, 128), (140, 4)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [32, 600])
@pytest.mark.parametrize("a, ds", GROUPED_A)
def test_attn_map_bank_grouped_matches_plain(cuda, a, ds, n, bf16):
    """K7 forward and backward through autograd at widths past the block
    plans (B C = 16), at the bars of test_attn_map_bank_kernel_matches_plain
    (f32 1e-5 forward, 1e-4 backward; bf16 1e-2), q / k in the mode's dtype,
    one launch each counted; two runs bit for bit."""
    b, c = (2, 8) if n == 32 else (1, 16)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, g = _bank_operands(cuda, b, c, n, a, 26, dt)
    from moleculesde_tpu_torch.ops.attn_bank import plan
    assert plan(n, a, a // ds, False)[2] > 1 or plan(n, a, a // ds, True)[2] > 1
    launches = (attn_map_bank_kernel.launches, attn_map_bank_kernel_bwd.launches)

    def run(impl):
        return _grads(lambda q_, k_: attn_map_bank_kernel(q_, k_, ds, bf16=bf16, impl=impl),
                      (q, k), g)

    kern, plain = run("kernel"), run("plain")
    assert (attn_map_bank_kernel.launches, attn_map_bank_kernel_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    for i, (x, y) in enumerate(zip(kern, plain)):
        tol = 1e-2 if bf16 else (1e-5 if i == 0 else 1e-4)
        err = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert err <= tol, (i, err)
    again = run("kernel")
    assert all(torch.equal(u, v) for u, v in zip(kern, again))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 8, 32), (4, 8, 64), (1, 2, 600), (3, 2, 9)])
def test_attn_map_bank_forced_groups_keep_the_bits(cuda, shape, bf16):
    """At the chain's A = 32, ds = 4: the forward in 2, 4 and 8 column
    slices and the grouped backward give the block plans' bits (each head's
    logits one FMA chain in index order, the heads' tanh added in order;
    dq / dk each one chain over the map in index order)."""
    b, c, n = shape
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, g = _bank_operands(cuda, b, c, n, 32, 27, dt)
    fwd = attn_map_bank_kernel(q, k, 4, bf16=bf16, impl="kernel", groups=1)
    bwd = attn_map_bank_kernel_bwd(q, k, g, 4, bf16=bf16, impl="kernel", groups=1)
    for groups in (2, 4, 8):
        assert torch.equal(fwd, attn_map_bank_kernel(q, k, 4, bf16=bf16, impl="kernel",
                                                     groups=groups)), groups
        other = attn_map_bank_kernel_bwd(q, k, g, 4, bf16=bf16, impl="kernel", groups=groups)
        assert all(torch.equal(u, v) for u, v in zip(bwd, other)), groups


# the 16-atom size bucket (``--buckets 16 ...`` at --batch_size 32): K1 at
# E = 4 n_max, K3 / K4 at C = 300, H = 32, K2 at 51 Gaussians x 128 filters
N16_GIN, N16_PAIR, N16_CFCONV = (32, 16, 64, 13, 300), (32, 16, 300, 32), (32, 16, 51, 128)


@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_at_n_max_16_match_plain(cuda, bf16):
    """K1, K2, K3 and K4, forward and backward, at the 16-atom bucket's
    shapes, where one molecule fills only part of K3 / K4's (16 dests, 32
    sources) unit and K2 / K5 take their 16-row forward: against their plain
    versions at the tolerances above, and two runs of each bit for bit."""
    x, src, dst, boh, tbl, g1 = _gin_operands(cuda, *N16_GIN)
    ea, env, params, g2 = _cfconv_operands(cuda, *N16_CFCONV)
    ea = ea if bf16 else ea.float()
    a, cc, w, bias, g4 = _pair_operands(cuda, N16_PAIR, 7)
    b, n, _, h = N16_PAIR
    g3 = torch.randn(b, n, n, h, device=cuda, generator=torch.Generator(cuda).manual_seed(8))
    cases = [
        (lambda x_, t_, impl: gin_messages(x_, src, dst, boh, t_, bf16=bf16, impl=impl),
         (x, tbl), g1, 1e-2 if bf16 else 1e-5, 1e-2 if bf16 else 1e-4),
        (lambda *t, impl: fused_cfconv(ea, env, *t, bf16=bf16, impl=impl), params, g2,
         2e-2 if bf16 else 1e-5, 2e-2 if bf16 else 1e-4),
        (lambda *t, impl: pair_relu_project(*t, bf16=bf16, impl=impl), (a, cc, w, bias), g3,
         1e-3 if bf16 else 1e-5, 1e-3 if bf16 else 1e-4),
        (lambda *t, impl: pair_relu_project_cm(*t, bf16=bf16, impl=impl), (a, cc, w, bias), g4,
         1e-3 if bf16 else 1e-5, 1e-3 if bf16 else 1e-4)]
    for fn, inputs, g, fwd_tol, bwd_tol in cases:
        kern = _grads(lambda *t: fn(*t, impl="kernel"), inputs, g)
        plain = _grads(lambda *t: fn(*t, impl="plain"), inputs, g)
        _close(kern[0], plain[0], fwd_tol)
        for k, p in zip(kern[1:], plain[1:]):
            _close(k, p, bwd_tol)
        again = _grads(lambda *t: fn(*t, impl="kernel"), inputs, g)
        assert all(torch.equal(u, v) for u, v in zip(kern, again))


def test_native_collation_on_the_card_host(cuda):
    """The C++ collator built on the GPU machine's host (``-march=native``
    there) gives the numpy collation's bits on a B=128, n_max 32 batch,
    and the batch moves to the card whole."""
    import numpy as np

    from moleculesde_tpu_torch.core.batch import pad_graphs
    from moleculesde_tpu_torch.data.native_collate import native_pad_graphs
    from moleculesde_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(0)
    gs = [random_molecule(rng, int(rng.integers(4, 33)), extend=False) for _ in range(128)]
    kw = dict(n_max=32, e_max=128, ext_e_max=1024)
    mine, ref = native_pad_graphs(gs, **kw), pad_graphs(gs, **kw)
    on_card = mine.pin_memory().to(cuda, non_blocking=True)
    for f in ("atom_feats", "node_mask", "positions", "edge_src", "edge_dst", "edge_feats",
              "edge_mask", "ext_src", "ext_dst", "ext_attr", "ext_mask"):
        assert torch.equal(getattr(mine, f), getattr(ref, f)), f
        assert torch.equal(getattr(on_card, f).cpu(), getattr(ref, f)), f


# K8's tiled plan forced where the block plan fits: (B, N, F, C, A, ds) of
# the chain's edge layers 1-3 and 0, a ragged second map tile, ds = 2 and A
# = 8 (the scalar paths)
QK_TILED_SAME_BITS = [(16, 32, 16, 8, 32, 4), (4, 64, 300, 2, 32, 4), (2, 33, 16, 8, 32, 4),
                      (3, 40, 13, 3, 8, 2)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", QK_TILED_SAME_BITS)
def test_attn_qk_bank_tiled_plan_gives_the_block_plans_bits(cuda, shape, bf16):
    """Where both plans take a shape, the tiled plan gives the block plan's
    bits: the maps (the same chains for t1, q / k and each head's logit),
    and in the backward dqk and the bias gradients (every chain in index
    order as in the block plan); the weight matrices' gradients too in f32
    (FMA chains over n in both), within the bar in bf16 (the block plan's
    dW1 / dW2 run on mma.sync)."""
    from moleculesde_tpu_torch.ops import attn_qk_bank as k8

    b, n, f, c, a, ds = shape
    qk, ws, g = _qk_bank_operands(cuda, b, n, f, c, a, 26)
    qd = qk.to(torch.bfloat16 if bf16 else torch.float32)
    h = a // ds
    assert k8.plan_of(n, f, c, a, h, False, b) == k8.plan_of(n, f, c, a, h, True, b) == "block"
    assert torch.equal(k8._launch(qd, ws, ds, bf16, plan="block"),
                       k8._launch(qd, ws, ds, bf16, plan="tiled"))
    blk = k8._launch_bwd(qd, ws, g, ds, bf16, plan="block")
    til = k8._launch_bwd(qd, ws, g, ds, bf16, plan="tiled")
    for i, (x, y) in enumerate(zip(blk, til)):
        if i in (0, 2, 4, 6, 8) or not bf16:
            assert torch.equal(x, y), i
        err = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert err <= 1e-2, (i, err)


# past the block plan: the chain's edge layers 1-3 (F = 16, C = 8) and 0
# (F = 300, C = 2) at N = 512 and 1024, B = 2, and N = 300 at F = 16 (the
# backward tiled, the forward still a block)
QK_TILED = [(2, 512, 16, 8, 32, 4), (2, 512, 300, 2, 32, 4), (2, 1024, 16, 8, 32, 4),
            (2, 1024, 300, 2, 32, 4), (2, 300, 16, 8, 32, 4)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", QK_TILED)
def test_attn_qk_bank_tiled_plan_matches_plain(cuda, shape, bf16):
    """K8 in the tiled plan, forward and backward through autograd, against
    the plain version at the N = 32 test's bars; each launch counted once;
    two runs of each direction bit for bit."""
    b, n, f, c, a, ds = shape
    qk, ws, g = _qk_bank_operands(cuda, b, n, f, c, a, 27)
    launches = (attn_qk_bank.launches, attn_qk_bank_bwd.launches)

    def run(impl):
        return _grads(lambda *t: attn_qk_bank(*t, ds, bf16=bf16, impl=impl), [qk] + ws, g)

    kern, plain = run("kernel"), run("plain")
    assert (attn_qk_bank.launches, attn_qk_bank_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    for i, (x, y) in enumerate(zip(kern, plain)):
        tol = 1e-2 if bf16 else (1e-5 if i == 0 else 1e-4)
        err = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert err <= tol, (i, err)
    qd = qk.to(torch.bfloat16 if bf16 else torch.float32)
    with torch.no_grad():
        assert torch.equal(attn_qk_bank(qd, *ws, ds, bf16=bf16, impl="kernel"),
                           attn_qk_bank(qd, *ws, ds, bf16=bf16, impl="kernel"))
        first = attn_qk_bank_bwd(qd, *ws, g, ds, bf16=bf16, impl="kernel")
        second = attn_qk_bank_bwd(qd, *ws, g, ds, bf16=bf16, impl="kernel")
    assert all(torch.equal(u, v) for u, v in zip(first, second))
