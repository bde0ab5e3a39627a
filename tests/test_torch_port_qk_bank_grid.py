"""Port parity past N = 32 for K8's forward: the plain version
(``moleculesde_tpu_torch.ops.attn_qk_bank``, what the wrapper takes on the
CPU) at N = 40 against the JAX package's Pallas kernel in interpret mode
(f32 1e-5 of the largest value, the same sums in another order; bf16 1e-2,
both sides rounding at the same points), and the forward kernel's launch
plan ``fwd_plan`` -- one block per (graph, channel), W1 and qk staged in
chunks of at most 128 features, rows paired -- with the messages past each
kernel's shared memory (the backward's plan: test_torch_port_bank_bwd_large.py).
The kernels themselves run only on the card (``test_torch_port_kernels.py``)."""

import jax
import jax.numpy as jnp
import pytest
import torch

from moleculesde_tpu.ops.rejected.attn_qk_bank import attn_qk_bank as jax_attn_qk_bank
from moleculesde_tpu_torch.ops.attn_qk_bank import (
    FWD_MAX_CHUNK, TILED_SMEM, attn_qk_bank, attn_qk_bank_bwd, bwd_plan, check_plan, fwd_plan,
    plan_of)
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT

from test_torch_port_attn_bank import _qk_operands
from torch_port_common import ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)


@pytest.mark.parametrize("ds", [2, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_qk_bank_forward_matches_pallas_kernel_past_32(ds, bf16):
    ops, _ = _qk_operands(7, b=2, n=40)
    ref = jax_attn_qk_bank(*(jnp.asarray(o) for o in ops), ds, bf16=bf16,
                           impl="pallas_interpret")
    out = attn_qk_bank(*(t(o) for o in ops), ds, bf16=bf16)
    assert out.dtype == torch.float32 and out.shape == (2, 3, 40, 40)
    assert rel_err(out.numpy(), jax.device_get(ref)) < (1e-2 if bf16 else 1e-5)


# (N, F, A) -> (features per chunk, shared-memory bytes): the 3D->2D chain's
# edge layers 1-3 (F = 16) and 0 (F = emb_dim 300) at n_max 32 and 64, and
# small ragged shapes
PLANS = [((32, 16, 32), (16, 33792)), ((32, 300, 32), (128, 76800)),
         ((64, 16, 32), (16, 54784)), ((64, 300, 32), (128, 112128)),
         ((9, 13, 8), (13, 4192)), ((33, 260, 32), (128, 79008))]


@pytest.mark.parametrize("shape, plan", PLANS)
def test_fwd_plan(shape, plan):
    n, f, a = shape
    fc, smem = fwd_plan(n, f, a)
    assert (fc, smem) == plan
    assert fc == min(f, FWD_MAX_CHUNK) and smem <= SMEM_LIMIT
    # the plan grows with N only through the staged rows, paired to an even count
    assert fwd_plan(n + n % 2, f, a) == (fc, smem)


@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_fwd_plan_takes_any_n_that_fits(bwd):
    """Either kernel keeps its (graph, channel) block plan wherever that
    fits -- the forward up to N = 334 at A = 32, F = 16, the backward up to
    N = 266 -- and past it takes the tiled plan, whose shared memory does
    not depend on N (where the block plan used to raise, naming its
    limit); forcing the block plan there still raises so."""
    if not bwd:
        assert check_plan(64, 16, 8, 32, 4, bwd=False) == fwd_plan(64, 16, 32)[1]
        assert check_plan(334, 16, 8, 32, 4, bwd=False) <= SMEM_LIMIT
        assert plan_of(334, 16, 8, 32, 4, bwd=False) == "block"
        assert plan_of(335, 16, 8, 32, 4, bwd=False) == "tiled"
        assert check_plan(335, 16, 8, 32, 4, bwd=False) == TILED_SMEM
        with pytest.raises(ValueError, match="forward kernel: N=335, F=16, C=8, A=32 need "
                                             r"\d+ B of shared memory per block"):
            check_plan(335, 16, 8, 32, 4, bwd=False, plan="block")
        return
    for n in (33, 64, 128, 256, 266):
        assert check_plan(n, 16, 8, 32, 8, bwd=True) == bwd_plan(n, 16, 32, 8)[2] <= SMEM_LIMIT
        assert plan_of(n, 16, 8, 32, 8, bwd=True) == "block"
    assert check_plan(128, 900, 8, 32, 8, bwd=True) <= SMEM_LIMIT
    assert plan_of(267, 900, 8, 32, 8, bwd=True) == "tiled"
    assert check_plan(267, 900, 8, 32, 8, bwd=True) == TILED_SMEM
    with pytest.raises(ValueError, match="backward kernel: N=267, F=900, C=8, A=32 need "
                                         r"\d+ B of shared memory per block"):
        check_plan(267, 900, 8, 32, 8, bwd=True, plan="block")


def test_kernel_wrappers_check_the_device():
    """On CPU tensors ``impl="kernel"`` raises for want of a CUDA tensor at
    N = 40, forward and backward, and counts no launch."""
    ops, g = _qk_operands(8, b=2, n=40)
    ops = [t(o) for o in ops]
    launches = (attn_qk_bank.launches, attn_qk_bank_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        attn_qk_bank(*ops, 4, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        attn_qk_bank_bwd(*ops, t(g), 4, impl="kernel")
    assert (attn_qk_bank.launches, attn_qk_bank_bwd.launches) == launches
