"""K7's forward launch plan (``moleculesde_tpu_torch.ops.attn_bank.plan``
with ``bwd=False``) and its wrapper on the CPU.  The forward runs
persistent blocks over (graph, channel, 32 x 32 tile) units
(``csrc/attn_bank.cu``), so its shared memory depends on A alone: the same
17,408 B at the 3D->2D chain's A = 32, H = 8 for every N, where the
forward before tiles needed 8 N (A + 1) B and took N <= 880.  Past A = 452
the unit walks A in column slices (the grouped plan).  On a CPU tensor the
wrappers take the plain versions and count no launch.  The kernel itself
runs only on the card (``test_torch_port_kernels.py``)."""

import numpy as np
import pytest
import torch

from moleculesde_tpu_torch.ops.attn_bank import (
    FWD_TILE, attn_map_bank_bwd_plain, attn_map_bank_kernel, attn_map_bank_kernel_bwd,
    attn_map_bank_plain, plan, row_stride)
from moleculesde_tpu_torch.ops.common import SMEM_LIMIT


@pytest.mark.parametrize("n", [1, 32, 33, 128, 256, 880, 881, 1 << 20])
def test_attn_map_bank_fwd_plan_takes_any_n(n):
    """N = 1 to past the old limit (880) and on to 2^20, the largest N a
    test names (the plan itself has none): one tile, the same bytes."""
    rows, smem, groups = plan(n, 32, 8, bwd=False)
    assert (rows, smem) == (FWD_TILE, 4 * 2 * FWD_TILE * (32 + row_stride(32))) == (32, 17408)
    assert smem <= SMEM_LIMIT and groups == 1


@pytest.mark.parametrize("a, h", [(8, 4), (12, 6), (32, 8), (64, 16), (452, 113)])
def test_attn_map_bank_fwd_plan_grows_with_a_only(a, h):
    """The tile's staged rows and f32 copies: 2 x 32 (A + row_stride(A))
    words; A = 452 is the widest whole row that fits, and 454 takes the
    grouped plan: four column slices of 116 (60,416 B)."""
    assert plan(7, a, h, bwd=False) == plan(700, a, h, bwd=False)
    assert plan(7, a, h, bwd=False)[1:] == (256 * (a + row_stride(a)), 1)
    assert plan(7, a, h, bwd=False)[1] <= SMEM_LIMIT
    assert 256 * (454 + row_stride(454)) > SMEM_LIMIT
    assert plan(7, 454, 227, bwd=False) == (32, 256 * (116 + row_stride(116)), 4) == (32, 60416, 4)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_map_bank_wrappers_on_cpu_take_plain(bf16):
    """On CPU tensors the forward (through autograd, at N = 40, two tiles a
    side on the card) and the backward take the plain versions, exactly,
    and neither counts a launch."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(0.8 * rng.normal(size=(2, 2, 40, 32)).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(2, 2, 40, 40)).astype(np.float32))
    launches = (attn_map_bank_kernel.launches, attn_map_bank_kernel_bwd.launches)
    ql, kl = q.clone().requires_grad_(True), k.clone().requires_grad_(True)
    out = attn_map_bank_kernel(ql, kl, 4, bf16=bf16)
    dq, dk = torch.autograd.grad(out, (ql, kl), g)
    assert torch.equal(out.detach(), attn_map_bank_plain(q, k, 4, bf16=bf16))
    ref = attn_map_bank_bwd_plain(q, k, g, 4, bf16=bf16)
    assert torch.equal(dq, ref[0]) and torch.equal(dk, ref[1])
    assert all(torch.equal(u, v) for u, v in
               zip(attn_map_bank_kernel_bwd(q, k, g, 4, bf16=bf16), ref))
    assert (attn_map_bank_kernel.launches, attn_map_bank_kernel_bwd.launches) == launches
