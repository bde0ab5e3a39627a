"""Port parity for the pair-block forward (K3 ``pair_relu_project``, K4
``pair_relu_project_cm``) past the first card kernel's caps on N (160 at C =
300, 1024 threads a block), and the new forward's launch plan.

- The plain forwards against the Pallas kernels in interpret mode at N =
  128 (B = 2, C = 300, H = 32): f32 1e-5 of the largest output (the same
  sums in another order), bf16 2^-8 (the two sides round a, c, the relu'd
  pair and w at the same places, as ``test_torch_port_gin_bwd_large.py``
  states it).  Two graphs, not one: at B = 1 XLA's CPU runtime folds K4's
  batched product into a plain dot, which it cannot run in bf16 x bf16 ->
  f32.
- ``ops/pair_block.py::fwd_plan``: persistent units of (graph, 16 dests, 32
  sources) at the models' C = 300, H = 32 for every bucket the loader gives
  (N = 16 .. 256) and N = 1024, in both modes; its shared bytes do not
  depend on N; it falls back to 16 sources where 32 do not fit and raises,
  naming the limit, only past the int32 index (or, at a C far past the
  models', past ``SMEM_LIMIT``).
"""

import numpy as np
import pytest

from moleculesde_tpu.ops.pair_block import pair_relu_project as jax_pair_relu_project
from moleculesde_tpu.ops.pair_block import pair_relu_project_cm as jax_pair_relu_project_cm
from moleculesde_tpu_torch.ops import pair_block as pair_ops
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT

from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)

BF16_TOL = 2 ** -8


def _operands(b=2, n=128, c=300, h=32, seed=35):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(b, n, c)) * 1.3 + 0.2).astype(np.float32)
    cc = rng.normal(size=(b, n, c)).astype(np.float32)
    w = (rng.normal(size=(c, h)) / np.sqrt(c)).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, h).astype(np.float32)
    return a, cc, w, bias


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("cm", [False, True], ids=["K3", "K4"])
def test_pair_relu_project_plain_matches_pallas_kernel_at_n128(cm, bf16):
    a, cc, w, bias = _operands()
    if cm:   # K4 has no bias inside the kernel: both sides add it outside
        ref = jax_pair_relu_project_cm(a, cc, w, bias, bf16=bf16, impl="pallas_interpret")
        out = pair_ops.pair_relu_project_cm_plain(t(a), t(cc), t(w), bf16=bf16)
        out = out + t(bias)[None, :, None]
        assert out.shape == (2, 32, 128 * 128)
    else:
        ref = jax_pair_relu_project(a, cc, w, bias, bf16=bf16, impl="pallas_interpret")
        out = pair_ops.pair_relu_project_plain(t(a), t(cc), t(w), t(bias), bf16=bf16)
        assert out.shape == (2, 128, 128, 32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert rel_err(out.numpy(), ref) <= (BF16_TOL if bf16 else 1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 1024])
def test_fwd_plan_fits_every_bucket(n, bf16):
    """32-source units of 512 threads at every N; the shared bytes are W
    (bf16 304 x 40 halves, f32 304 x 32 floats) and two stages of 48 rows
    of 304 floats, whatever N."""
    plan = pair_ops.fwd_plan(n, 300, 32, bf16)
    w_bytes = 304 * 40 * 2 if bf16 else 304 * 32 * 4
    assert plan == {"ts": 32, "threads": 512, "smem": w_bytes + 2 * 48 * 304 * 4}
    assert plan["smem"] <= SMEM_LIMIT
    assert plan == pair_ops.fwd_plan(16, 300, 32, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fwd_plan_raises_only_past_the_int32_index(bf16):
    """B N^2 H and B N C index the kernel's arrays in int32: N = 8191 at B =
    1, H = 32 is the last N, B = 4095 at N = 128 the last batch."""
    assert pair_ops.fwd_plan(8191, 300, 32, bf16)["ts"] == 32
    assert pair_ops.fwd_plan(128, 300, 32, bf16, b=4095)["ts"] == 32
    for n, b in ((8192, 1), (128, 4096)):
        with pytest.raises(ValueError, match="int32 index"):
            pair_ops.fwd_plan(n, 300, 32, bf16, b=b)


@pytest.mark.parametrize("case", ["ragged_c", "wide_c", "wide_h", "too_wide_c"])
def test_fwd_plan_shared_memory_by_width(case):
    """C pads to a multiple of 16 and a staged row to C' + 16 where C' is a
    multiple of 32; where 32 sources do not fit, 16; where 16 do not, 8;
    past that the plan raises, naming SMEM_LIMIT."""
    if case == "ragged_c":   # C = 17 -> C' = 32, rows of 48 floats; H = 40 -> two passes
        plan = pair_ops.fwd_plan(9, 17, 40, True)
        assert plan == {"ts": 32, "threads": 512, "smem": 32 * 72 * 2 + 2 * 48 * 48 * 4}
    elif case == "wide_c":   # C = 500: 32 sources need 238 KB (bf16), 262 KB (f32)
        for bf16 in (False, True):
            plan = pair_ops.fwd_plan(64, 500, 32, bf16)
            assert plan["ts"] == 16 and plan["threads"] == 256
            assert plan["smem"] <= SMEM_LIMIT
    elif case == "wide_h":   # the sampler's C = 300 with the 2D->3D model 128 wide
        # f32: W is 304 x 128 floats (152 KB), so only 8 sources fit; bf16 32
        assert pair_ops.fwd_plan(32, 300, 128, False) == {
            "ts": 8, "threads": 128, "smem": 304 * 128 * 4 + 2 * 24 * 304 * 4}
        assert pair_ops.fwd_plan(32, 300, 128, True)["ts"] == 32
        assert pair_ops.fwd_plan(32, 300, 64, False)["ts"] == 32
    else:
        with pytest.raises(ValueError, match="SMEM_LIMIT"):
            pair_ops.fwd_plan(64, 1000, 32, True)
