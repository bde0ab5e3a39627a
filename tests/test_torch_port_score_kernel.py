"""Port parity: the fused score evaluation K6 (moleculesde_tpu_torch.ops.
score_kernel) and the fused PC chain against the JAX package.

- ``pack_score_params``: every segment of the port's buffer equals the JAX
  package's packed array on the same (converted) weights.
- ``score_eval_fused_plain`` against the Pallas kernel in interpret mode,
  variants 1 and 2, at the kernel's widths (hidden 32, 8 heads, basis 128):
  f32 2e-5 relative to the largest value (sums in another order); bf16
  1e-2 (both sides round at the same points; an f32 value summed in
  another order can land on the other side of a bf16 rounding boundary).
  The masks hold no self-pair (s == d), as the extended graph holds none:
  there the frame's cross product p x p is zero only if ``a*b - c*d`` is
  not fused into an FMA, so its guarded direction differs between
  compilers (the JAX kernel itself moves by 4% between eager and jit).
- ``score_from_cond_fused`` against the port's own ``score_from_cond``
  (1e-4, the JAX package's bar for its kernel against XLA).
- ``sample_positions_pc(fused=True)`` against the JAX package's on its own
  draws, 5 steps, ``atol 2e-4, rtol 1e-3`` (the JAX package's bar).
- The wrapper is forward only, and on the CPU takes the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.ops.score_kernel import pack_score_params as jax_pack
from moleculesde_tpu.ops.score_kernel import score_eval_fused as jax_score_eval_fused
from moleculesde_tpu.sampling import sample_positions_pc as jax_sample
from moleculesde_tpu_torch.convert import load_flax_variables
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.ops.score_kernel import (
    pack_score_params, score_eval_fused, score_eval_fused_plain, score_param_layout,
    score_segments)
from moleculesde_tpu_torch.sampling.pc import sample_positions_pc

from test_torch_port_score_2d3d import make_pair
from torch_port_common import (  # noqa: F401 (ieee_f32: autouse)
    both_batches, CPU, graphs, ieee_f32, np_tree, rel_err, t)

EMB, HID = 16, 32
N_STEPS = 5


def _models(variant: int):
    """JAX and port SDEModel2Dto3D at the kernel's widths on the same
    weights, every parameter perturbed so no bias or norm offset is zero."""
    jb, _ = both_batches(graphs(seed=40 + variant, count=2, n_max=6), n_max=6)
    node_2d = np.zeros((jb.num_nodes, EMB), np.float32)
    jm = JaxSDEModel2Dto3D(emb_dim=EMB, hidden_dim=HID, variant=variant)
    key = jax.random.PRNGKey(variant)
    v = jm.init({"params": key, "dropout": key}, jnp.asarray(node_2d), jb, key,
                method=JaxSDEModel2Dto3D.loss)
    rng = np.random.default_rng(variant)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        v["params"])
    v = {"params": params, "batch_stats": v["batch_stats"]}
    tm = load_flax_variables(SDEModel2Dto3D(emb_dim=EMB, hidden_dim=HID, variant=variant,
                                            device=CPU), np_tree(v))
    return v, tm


def _operands(seed: int, b: int = 2, n: int = 8):
    rng = np.random.default_rng(seed)
    pos = (1.5 * rng.normal(size=(b, n, 3))).astype(np.float32)
    node = rng.normal(size=(b, n, HID)).astype(np.float32)
    edge = rng.normal(size=(b, n, n, HID)).astype(np.float32)
    mask = rng.random((b, n, n)) < 0.6
    mask[:, np.arange(n), np.arange(n)] = False   # no self-pairs, as in the extended graph
    mask[0, :, 2] = False                  # a destination with no valid source
    return pos, node, edge, mask


@pytest.mark.parametrize("variant", [1, 2])
def test_pack_score_params_matches_jax(variant):
    v, tm = _models(variant)
    ref = jax_pack(v["params"], variant)
    packed = pack_score_params(tm, variant)
    layout, total = score_param_layout(variant)
    assert packed.shape == (total,) and not packed.requires_grad
    assert all(off % 4 == 0 for _, _, off in layout)
    segs = score_segments(packed, variant)
    assert list(segs) == [name for name, _, _ in layout]
    # JAX appends the TPU's selector constants after the weights
    assert len(ref) == len(layout) + 6
    for (name, seg), r in zip(segs.items(), ref):
        r = np.asarray(r)
        if name.endswith(".wo"):
            r = r[:, :3]                   # the TPU's zero padding to 8 columns
        elif name.endswith(".bo"):
            r = r.reshape(-1)[:3]
        np.testing.assert_array_equal(seg.numpy().reshape(-1), r.reshape(-1), err_msg=name)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [1, 2])
def test_score_eval_fused_plain_matches_pallas_kernel(variant, bf16):
    v, tm = _models(variant)
    pos, node, edge, mask = _operands(variant)
    ref = np.asarray(jax_score_eval_fused(pos, node, edge, mask, jax_pack(v["params"], variant),
                                          variant=variant, bf16=bf16, interpret=True))
    out = score_eval_fused_plain(t(pos), t(node), t(edge), t(mask),
                                 pack_score_params(tm, variant), variant=variant, bf16=bf16)
    assert out.shape == ref.shape == (2, 8, 3)
    assert rel_err(out.numpy(), ref) <= (1e-2 if bf16 else 2e-5)


@pytest.mark.parametrize("variant", [1, 2])
def test_score_from_cond_fused_matches_score_from_cond(variant):
    _, _, tm, jb, tb, node_2d = make_pair(variant, "float32", seed=variant)
    pos = t(np.random.default_rng(3).normal(size=(jb.num_nodes, 3)).astype(np.float32))
    with torch.no_grad():
        cond = tm.precompute_conditioning(t(node_2d), tb, layout="feature")
        ref = tm.score_from_cond(cond, pos)
        out = tm.score_from_cond_fused(cond, pos)
        packed = tm.score_from_cond_fused(cond, pos, tm.packed_score_params())
    assert rel_err(out.numpy(), ref.numpy()) < 1e-4
    assert torch.equal(out, packed)


def test_sample_positions_pc_fused_matches_jax():
    jm, v, tm, jb, tb, node_2d = make_pair(1, "float32", seed=6)
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jax_sample(jm, v, jnp.asarray(node_2d), jb, key, n_steps=N_STEPS,
                                fused=True))
    # the JAX sampler's draws (sampling/pc.py: split -> k_init / k_scan,
    # k_scan -> k_pred / k_corr)
    shape = tuple(jb.positions.shape)
    k_init, k_scan = jax.random.split(key)
    k_pred, k_corr = jax.random.split(k_scan)
    draws = {"prior": t(jax.random.normal(k_init, shape)),
             "noise_p": t(jax.random.normal(k_pred, (N_STEPS,) + shape)),
             "noise_c": t(jax.random.normal(k_corr, (N_STEPS, 1) + shape))}
    out = sample_positions_pc(tm, t(node_2d), tb, n_steps=N_STEPS, fused=True, **draws)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-3)
    # the fused chain is the feature-layout chain, one launch per evaluation
    feature = sample_positions_pc(tm, t(node_2d), tb, n_steps=N_STEPS, layout="feature",
                                  **draws)
    np.testing.assert_allclose(out.numpy(), feature.numpy(), atol=2e-4, rtol=1e-3)


def test_score_eval_fused_is_forward_only_and_plain_on_cpu():
    _, tm = _models(1)
    pos, node, edge, mask = (t(x) for x in _operands(5, b=1, n=5))
    packed = pack_score_params(tm, 1)
    launches = score_eval_fused.launches
    out = score_eval_fused(pos, node, edge, mask, packed, variant=1)
    assert out.shape == (1, 5, 3) and score_eval_fused.launches == launches
    with pytest.raises(RuntimeError, match="forward only"):
        score_eval_fused(pos.requires_grad_(True), node, edge, mask, packed, variant=1)
    with pytest.raises(ValueError, match="CUDA"):
        score_eval_fused(pos.detach(), node, edge, mask, packed, variant=1, impl="kernel")
    assert score_eval_fused.launches == launches
