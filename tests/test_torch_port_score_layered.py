"""K6's layered plan (``csrc/score_layered.cu``) at the edges of its tiles,
on the card: warp tiles of 32 pairs x 32 channels (``mma.sync`` k-steps of
16 in bf16 mode, 4 pairs x 8 channels of FMAs a lane in f32 mode), the
front rows in shared memory or in device scratch, the GAT pass's kept rows
in device scratch, head ranges resolved per slice.

Cases (``LAYERED_EDGES``): N not a multiple of 16 or 32 (129, 300, 40,
16), hidden widths that are not multiples of 16 (8, 24, 48) or need
several slices (128, 160, 640), 1 and 8 heads, basis widths 32, 48 (padded to
64), 192 and 256, more than 128 packed segments (three modules of two GAT
layers at hidden 32: 130), the front rows in device memory (f32 at hidden 128,
bf16 at hidden 160), the GAT pass's FFN rows too (hidden 640: no width
caps shared memory); ``width_operands`` leaves one destination with no
valid source.  Variants 1 and 2, both modes: f32 1e-5 and bf16 2e-2 of
max |plain| (``benchmarks/k6_widths.py``'s bars), one launch counted, two
launches bit for bit.  The wrapper's plan against the C entries' shared
memory and scratch at the same widths.

Marked ``gpu``: they skip without a CUDA device.  On a GPU machine:
``python -m pytest --noconftest tests/test_torch_port_score_layered.py -q``.
"""

import ctypes

import pytest
import torch

from moleculesde_tpu_torch.benchmarks.k6_widths import TOL, width_operands
from moleculesde_tpu_torch.ops.score_kernel import (
    score_eval_fused, score_eval_fused_plain, score_param_layout, score_plan)

pytestmark = pytest.mark.gpu

# (hidden, heads, basis width, modules, GAT layers a module, n_max, B)
LAYERED_EDGES = [
    (8, 8, 32, 2, 2, 129, 2),      # one channel a head; one source past 128
    (24, 1, 192, 1, 3, 300, 1),    # one head of 24 channels; ragged chunks
    (48, 8, 256, 2, 2, 129, 1),    # 6 channels a head across a slice edge
    (32, 8, 128, 3, 2, 300, 1),    # 130 packed segments
    (128, 1, 64, 1, 2, 40, 4),     # four slices, one head; f32 front rows in device memory
    (16, 8, 48, 2, 1, 16, 8),      # one ragged chunk
    (160, 8, 64, 1, 1, 8, 2),      # five slices; bf16 front rows in device memory
    (640, 8, 64, 1, 1, 8, 1),      # twenty slices; the GAT pass's FFN rows in device memory
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("case", LAYERED_EDGES,
                         ids=lambda c: "h{}-heads{}-cd{}-L{}xC{}-n{}-b{}".format(*c))
def test_score_layered_at_tile_edges(cuda, case, variant, bf16):
    h, heads, cd, layers, convs, n, b = case
    ops = width_operands(cuda, b, n, h, cd, layers, convs, variant, seed=3 * h + n + variant)
    kw = dict(variant=variant, bf16=bf16, num_layers=layers, num_convs=convs, n_head=heads)
    assert score_plan(n, bf16, b=b, h=h, n_head=heads, coff_dim=cd, num_layers=layers,
                      num_convs=convs, variant=variant)["plan"] == "layered"
    launches = score_eval_fused.launches
    with torch.no_grad():
        out = score_eval_fused(*ops, **kw)
        assert score_eval_fused.launches == launches + 1
        ref = score_eval_fused_plain(*ops, coff_dim=cd, **kw)
        assert out.shape == (b, n, 3) and bool(torch.isfinite(out).all())
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        assert err <= TOL[bf16], err
        assert torch.equal(out, score_eval_fused(*ops, **kw))


def test_score_layered_plan_matches_kernel_at_tile_edges(cuda):
    """The wrapper's shared memory and scratch are the C entries' own at
    every edge case, in both modes, at n_max 8 to 300."""
    from moleculesde_tpu_torch.kernels import build

    lib = build.load("score_layered")
    lib.score_eval_layered_smem_bytes.restype = ctypes.c_int
    lib.score_eval_layered_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.score_eval_layered_scratch_bytes.restype = ctypes.c_longlong
    lib.score_eval_layered_scratch_bytes.argtypes = [ctypes.c_int] * 9
    for h, heads, cd, layers, convs, n, b in LAYERED_EDGES:
        assert len(score_param_layout(1, h, cd, layers, convs)[0]) > 0
        for variant in (1, 2):
            for bf16 in (False, True):
                p = score_plan(n, bf16, plan="layered", b=b, h=h, n_head=heads, coff_dim=cd,
                               num_layers=layers, num_convs=convs, variant=variant)
                assert p["smem"] == lib.score_eval_layered_smem_bytes(
                    int(bf16), variant, layers, convs, h, heads, cd)
                assert p["scratch"] == lib.score_eval_layered_scratch_bytes(
                    b, n, int(bf16), variant, layers, convs, h, heads, cd)
