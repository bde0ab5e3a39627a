"""Port parity: the attention banks K7 (``attn_impl="pallas"``) and K8
(``"fused"``) inside ``SDEModel3Dto2D``'s loss against the JAX package,
whose model runs them as the Pallas kernels in interpret mode
("pallas_interpret", "fused_interpret"); the port's plain versions follow
their roundings.

Tolerances relative to the largest value: f32 1e-5 for losses, 1e-4 for
gradients; bf16 5e-2 for losses and 0.15 for gradients, the bars of
``test_torch_port_score_losses.py`` (the two frameworks round the bf16
MLPs around the bank after different ops)."""

import pytest

from test_torch_port_score_3d2d_variants import _check, _loss_pair, batches  # noqa: F401
from torch_port_common import ieee_f32  # noqa: F401 (autouse)


@pytest.mark.parametrize("impl, bf16_attn, adim", [
    ("pallas", False, 16), ("pallas", True, 16), ("fused", False, 16), ("fused", True, 16),
    ("pallas", False, 256)],
    ids=["pallas-f32", "pallas-bf16", "fused-f32", "fused-bf16", "pallas-f32-adim256"])
def test_bank_kernels_in_loss_match_jax(batches, impl, bf16_attn, adim):
    """Variant 1 with K7 / K8 as the bank: the port's plain versions inside
    the loss against JAX's interpret-mode kernels, losses and gradients;
    also K7 at ``adim=256`` (q / k 512 wide at layer 1, past the block
    plans of K7's kernels: their grouped plans on the card)."""
    # few channels and heads: the interpret-mode kernels unroll both
    small = dict(variant=1, bf16_attn=bf16_attn, nhid=8, num_layers=2, c_hid=4,
                 c_final=2, num_heads=2, adim=adim)
    pair = _loss_pair(batches, dict(small, attn_impl=impl + "_interpret"),
                      dict(small, attn_impl=impl))
    _check(pair, *((5e-2, 0.15) if bf16_attn else (1e-5, 1e-4)))
