"""K6 at other widths than the sampler's (hidden 32, 8 heads, basis 128):
the port's ``score_eval_fused`` (its plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode, its launch plan at those
widths, and the widths it refuses by name.

- Parity at hidden 16 and 64, 4 heads, basis widths 64 and 256, three
  modules of two GAT layers ((L, C) = (3, 2)), variants 1 and 2.  f32: 2e-5
  of the largest value, the bar of ``tests/test_torch_port_score_kernel.py``
  (sums in another order; read 2.3e-7 to 1.3e-6).  bf16: both packages'
  bf16 results against the JAX kernel's f32 result, the port's no further
  from it than twice JAX's own distance + 1e-3.  Both round the same values
  at the same points but sum them in another order, and through six GAT
  layers and three basis modules their distance from each other is that of
  either from the f32 result: on the four width pairs and two variants the
  two bf16 results read 5.3e-3 to 1.64e-2 apart, the port's 4.8e-3 to
  2.53e-2 and JAX's 2.5e-3 to 1.90e-2 from the f32 result (at most 1.97x
  JAX's own), so the 1e-2 bar that holds between them at two modules of
  two layers does not hold here.  The wrapper learns the basis width from
  the packed buffer's length, as the JAX kernel reads it from the packed
  shapes.  No self-pairs, as the extended graph holds none.  Two width
  pairs run (each hidden and each basis width once: the JAX kernel's
  interpret mode takes ~3 s a call).
- ``SDEModel2Dto3D(hidden_dim=H).score_from_cond_fused`` (the model's 8
  heads, basis 128) against its own ``score_from_cond`` at hidden 16 and
  64 (1e-4, the JAX package's bar for its kernel against XLA), and the
  fused PC chain against the feature-layout chain on the same draws.
- ``score_plan``: the cluster plan only at (32, 8, 128) and 128 segments
  or fewer, the layered plan at every other width; the layered plan's
  shared memory and device scratch at those widths, counted from what its
  passes hold.
- Refusals before dispatch, on the CPU as on the card: more than 8 heads
  (the TPU kernel's head selector has 8 columns and drops the rest), a
  hidden width that the heads do not divide, a basis width past 64 that
  is not a multiple of 64 (the TPU kernel's 64-channel chunks).

The weights are drawn with numpy in the packed layout and handed to both
packages: JAX's as its parameter tree, the port's as its packed buffer.
"""

import functools
import math

import numpy as np
import pytest
import torch

from moleculesde_tpu.ops.score_kernel import pack_score_params as jax_pack
from moleculesde_tpu.ops.score_kernel import score_eval_fused as jax_score_eval_fused
from moleculesde_tpu_torch.core.batch import pad_graphs
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.ops.score_kernel import (
    score_eval_fused, score_param_layout, score_plan, score_scratch_bytes)
from moleculesde_tpu_torch.sampling.pc import sample_positions_pc

from torch_port_common import graphs, ieee_f32, rel_err, t  # noqa: F401 (ieee_f32: autouse)

B, N = 2, 8
HEADS = 4
LAYERS, CONVS = 3, 2
_GAT = {"wq": ("lin_query", "kernel"), "bq": ("lin_query", "bias"),
        "wk": ("lin_key", "kernel"), "bk": ("lin_key", "bias"),
        "wv": ("lin_value", "kernel"), "bv": ("lin_value", "bias"),
        "we": ("lin_edge", "kernel"), "be": ("lin_edge", "bias"),
        "wsk": ("lin_skip", "kernel"), "bsk": ("lin_skip", "bias"),
        "wf1": ("Dense_0", "kernel"), "bf1": ("Dense_0", "bias"),
        "wf2": ("Dense_1", "kernel"), "bf2": ("Dense_1", "bias"),
        "s1": ("LayerNorm_0", "scale"), "o1": ("LayerNorm_0", "bias"),
        "s2": ("LayerNorm_1", "scale"), "o2": ("LayerNorm_1", "bias")}
_TOP = {"coff_W": ("coff_fourier_W",), "coff_mlp.kernel": ("coff_mlp", "kernel"),
        "coff_mlp.bias": ("coff_mlp", "bias"), "proj1.kernel": ("project", "Dense_0", "kernel"),
        "proj1.bias": ("project", "Dense_0", "bias"),
        "proj2.kernel": ("project", "Dense_1", "kernel"),
        "proj2.bias": ("project", "Dense_1", "bias"), "dist_W": ("dist_fourier_W",),
        "input_mlp.kernel": ("input_mlp", "Dense_0", "kernel"),
        "input_mlp.bias": ("input_mlp", "Dense_0", "bias")}
_BASIS = {"wh": ("basis_node_{}", "kernel"), "wbe": ("basis_edge_{}", "kernel"),
          "bbe": ("basis_edge_{}", "bias"), "wo": ("basis_out_{}", "kernel"),
          "bo": ("basis_out_{}", "bias")}


def _path(name: str):
    """Where the packed segment ``name`` sits in the JAX parameter tree."""
    if name in _TOP:
        return _TOP[name]
    head, part = name.split(".")
    if head.startswith("gat"):
        return ("score_network", f"DenseGATLayer_{head[3:]}") + _GAT[part]
    mod, leaf = _BASIS[part]
    return ("score_network", mod.format(head[5:]), leaf)


def _weights(variant: int, h: int, coff_dim: int, seed: int):
    """(JAX parameter tree, the port's packed buffer) of one draw: kernels
    scaled by 1 / sqrt(fan-in), biases and LayerNorm offsets small, scales
    near 1, the Fourier rows standard normal (the model's initialisers,
    every bias and offset non-zero)."""
    rng = np.random.default_rng(seed)
    layout, total = score_param_layout(variant, h, coff_dim, LAYERS, CONVS)
    packed = np.zeros(total, np.float32)
    tree = {}
    for name, shape, off in layout:
        part = name.rsplit(".", 1)[-1]
        if len(shape) == 2:
            w = rng.normal(size=shape) / math.sqrt(shape[0])
        elif part in ("s1", "s2"):
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ("coff_W", "dist_W"):
            w = rng.normal(size=shape)
        else:
            w = 0.1 * rng.normal(size=shape)
        w = w.astype(np.float32)
        packed[off:off + w.size] = w.reshape(-1)
        node = tree
        path = _path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = w
    return tree, torch.from_numpy(packed)


def _operands(h: int, seed: int):
    rng = np.random.default_rng(seed)
    pos = (1.5 * rng.normal(size=(B, N, 3))).astype(np.float32)
    node = rng.normal(size=(B, N, h)).astype(np.float32)
    edge = rng.normal(size=(B, N, N, h)).astype(np.float32)
    mask = rng.random((B, N, N)) < 0.6
    mask[:, np.arange(N), np.arange(N)] = False   # no self-pairs, as in the extended graph
    mask[0, :, 2] = False                  # a destination with no valid source
    return pos, node, edge, mask


# (hidden, basis width): both hidden widths and both basis widths, one below
# and one past the sampler's 128 channels; then the layered plan's tile
# edges: hidden widths not a multiple of 16 (8, 24, 48), several slices
# (128, 160: the front rows in device memory; 640: the GAT pass's FFN rows
# too), basis widths 32, 48, 192
WIDTHS = [(16, 64), (16, 256), (64, 64), (64, 256), (8, 32), (24, 192), (48, 48), (128, 128),
          (160, 64), (640, 64)]
PARITY_WIDTHS = [(16, 256), (64, 64)]


@functools.lru_cache(maxsize=None)
def _scores(h: int, coff_dim: int, variant: int, bf16: bool):
    """(port, JAX) score of one draw in one mode (the f32 JAX result is the
    bf16 cases' oracle)."""
    tree, packed = _weights(variant, h, coff_dim, seed=h + coff_dim + variant)
    pos, node, edge, mask = _operands(h, seed=variant)
    kw = dict(variant=variant, num_layers=LAYERS, num_convs=CONVS, n_head=HEADS, bf16=bf16)
    ref = np.asarray(jax_score_eval_fused(
        pos, node, edge, mask, jax_pack(tree, variant, LAYERS, CONVS, HEADS), interpret=True,
        **kw))
    out = score_eval_fused(t(pos), t(node), t(edge), t(mask), packed, **kw)
    return out.numpy(), ref


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("h,coff_dim", PARITY_WIDTHS)
def test_score_eval_fused_matches_pallas_kernel_at_other_widths(h, coff_dim, variant, bf16):
    out, ref = _scores(h, coff_dim, variant, bf16)
    assert out.shape == ref.shape == (B, N, 3)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    if not bf16:
        assert rel_err(out, ref) <= 2e-5
        return
    oracle = _scores(h, coff_dim, variant, False)[1]
    port, jax_own = rel_err(out, oracle), rel_err(ref, oracle)
    assert port <= 2 * jax_own + 1e-3, (port, jax_own, rel_err(out, ref))


def _al(v: int) -> int:
    return -(-v // 256) * 256


def _r32(v: int) -> int:
    return -(-v // 32) * 32


def _layered_counts(n: int, bf16: bool, h: int, coff_dim: int, variant: int = 1):
    """(shared memory, device scratch) of csrc/score_layered.cu's passes at
    these widths, counted from what they hold, under the caps that
    ``ops/score_kernel.py`` shares with the C entries: the front pass's
    three rows of h (padded to 32) x 32 pairs a warp (bf16 fragments or
    f32), 8 warps, on the chip up to its cap; the GAT pass's [32][36] tile
    of the logits' terms, a chunk's softmax weights and (where 8 warps' fit
    under its cap) three FFN rows a warp, its kept rows (v + e2 of every
    pair at 32 floats a channel, a logit a chunk, head and lane) in device
    memory; the basis pass's [32][36] tile a warp and, where they fit under
    its cap, a module's basis_edge and basis_out weights; the slab, mask,
    counts, node rows, node states, weight image, kept rows and whatever
    rows are not on the chip in device memory."""
    from moleculesde_tpu_torch.ops.score_kernel import (
        _BASIS_STAGE_CAP, _FRONT_CAP, _GAT_CAP, _TILE_FLOATS)

    hp, cdp = _r32(h), _r32(coff_dim)
    chunks, warps = -(-n // 32), B * -(-n // 8) * 8
    rows = 3 * hp * 32 * (2 if bf16 else 4)
    keep = chunks * (hp * 32 + HEADS * 32)       # in device memory: 32 floats a channel
    ffn_on = 8 * 4 * (_TILE_FLOATS + 8 * 32 + 3 * hp) <= _GAT_CAP
    fixed = _TILE_FLOATS + 8 * 32 + (3 * hp if ffn_on else 0)   # terms' tile, weights, FFN rows
    front_on = 8 * rows <= _FRONT_CAP
    per_pair = 2 if bf16 else 1      # per-pair kernels: two bf16 values a float
    staged = 4 * (hp * cdp // per_pair + cdp + 4 * cdp + 4)   # a module's pair weights
    smem = max(8 * rows if front_on else 0, 8 * 4 * fixed,
               8 * 4 * _TILE_FLOATS + (staged if staged <= _BASIS_STAGE_CAP else 0))
    front = (hp + 4 * hp * hp // per_pair + hp + 2 * hp + 2 * hp * hp // per_pair + hp
             + hp * hp // per_pair + hp)
    if variant == 2:
        front += hp + 2 * hp * hp // per_pair + hp
    gat = 6 * hp * hp + hp * hp // per_pair + 11 * hp
    basis = hp * cdp + hp * cdp // per_pair + cdp + 4 * cdp + 4
    image = 4 * (front + LAYERS * CONVS * gat + LAYERS * basis)
    node_row = max(4 * hp, cdp)
    scratch = (_al(B * n * chunks * 32 * hp * (2 if bf16 else 4)) + _al(4 * B * n * n)
               + _al(4 * B * n) + _al(4 * B * n * node_row) + 2 * _al(4 * B * n * h) + _al(image)
               + (0 if front_on else _al(warps * rows)) + _al(warps * keep * 4)
               + (0 if ffn_on else _al(warps * 3 * hp * 4)))
    return smem, scratch


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,coff_dim", WIDTHS)
def test_score_plan_at_other_widths(h, coff_dim, bf16):
    """The layered plan at every width but the cluster plan's own, at any
    n_max; its shared memory and scratch are what its passes hold
    (:func:`_layered_counts`), the shared memory under the card's 227 KB and
    never growing with N; its scratch grows with the hidden and basis widths
    (the slab, the node rows, the image)."""
    from moleculesde_tpu_torch.ops.common import SMEM_LIMIT
    from moleculesde_tpu_torch.ops.score_kernel import layered_smem

    widths = dict(h=h, n_head=HEADS, coff_dim=coff_dim, num_layers=LAYERS, num_convs=CONVS)
    last = None
    for n in (1, 8, 32, 33, 64, 65, 129, 300, 1024):
        for variant in (1, 2):
            p = score_plan(n, bf16, b=B, variant=variant, **widths)
            assert p["plan"] == "layered" and p["dests"] == 8 and p["threads"] == 256
            assert p["scratch"] == score_scratch_bytes(B, n, bf16, h=h, coff_dim=coff_dim,
                                                       num_layers=LAYERS, num_convs=CONVS,
                                                       n_head=HEADS, variant=variant)
            smem, scratch = _layered_counts(n, bf16, h, coff_dim, variant)
            assert (p["smem"], p["scratch"]) == (smem, scratch), (n, variant)
            assert p["smem"] == layered_smem(bf16, h, coff_dim, LAYERS, CONVS) <= SMEM_LIMIT
        assert last is None or p["smem"] == last, (n, p["smem"], last)
        last = p["smem"]
    with pytest.raises(ValueError, match=f"hidden {h}"):
        score_plan(32, bf16, plan="cluster", **widths)
    wider = score_scratch_bytes(B, 32, bf16, h=2 * h, coff_dim=coff_dim)
    assert score_scratch_bytes(B, 32, bf16, h=h, coff_dim=coff_dim) < wider
    # the cluster plan stays where it ran: (32, 8, 128) at two modules of
    # two layers (79 segments in variant 1); three modules (130) take the
    # layered plan
    assert score_plan(32, bf16)["plan"] == "cluster"
    assert score_plan(32, bf16, num_layers=3)["plan"] == "layered"
    assert len(score_param_layout(1, num_layers=3)[0]) == 130


@pytest.mark.parametrize("h,n_head,coff_dim,what", [
    (64, 16, 64, "16 heads"), (30, 8, 64, "hidden 30"), (64, 4, 100, "basis width 100")])
def test_score_eval_fused_refuses_what_the_jax_kernel_cannot_compute(h, n_head, coff_dim,
                                                                     what):
    """Refused by name before dispatch, on the CPU as on the card."""
    _, packed = _weights(1, h, coff_dim, seed=0)
    pos, node, edge, mask = _operands(h, seed=0)
    with pytest.raises(ValueError, match=what):
        score_eval_fused(t(pos), t(node), t(edge), t(mask), packed, variant=1,
                         num_layers=LAYERS, num_convs=CONVS, n_head=n_head)
    with pytest.raises(ValueError, match="variant 3"):
        score_eval_fused(t(pos), t(node), t(edge), t(mask), packed, variant=3,
                         num_layers=LAYERS, num_convs=CONVS, n_head=4)


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("h", [16, 64])
def test_score_from_cond_fused_at_other_hidden_widths(h, variant):
    """The model's fused entry at hidden 16 and 64 takes the widths from
    its network and matches its unfused score; two fused PC steps match the
    feature-layout chain on the same draws (atol 2e-4, rtol 1e-3)."""
    batch = pad_graphs(graphs(seed=h + variant, count=3, n_max=7), n_max=7, e_max=28,
                       ext_e_max=49)
    model = SDEModel2Dto3D(emb_dim=8, hidden_dim=h, variant=variant, device="cpu",
                           generator=torch.Generator().manual_seed(variant))
    rng = np.random.default_rng(h)
    node_2d = t(rng.normal(size=(batch.num_nodes, 8)).astype(np.float32))
    pos = t(rng.normal(size=(batch.num_nodes, 3)).astype(np.float32))
    with torch.no_grad():
        cond = model.precompute_conditioning(node_2d, batch, layout="feature")
        ref = model.score_from_cond(cond, pos)
        out = model.score_from_cond_fused(cond, pos)
    assert rel_err(out.numpy(), ref.numpy()) < 1e-4
    shape = tuple(batch.positions.shape)
    draws = {"prior": t(rng.normal(size=shape).astype(np.float32)),
             "noise_p": t(rng.normal(size=(2,) + shape).astype(np.float32)),
             "noise_c": t(rng.normal(size=(2, 1) + shape).astype(np.float32))}
    fused = sample_positions_pc(model, node_2d, batch, n_steps=2, fused=True, **draws)
    feature = sample_positions_pc(model, node_2d, batch, n_steps=2, layout="feature", **draws)
    np.testing.assert_allclose(fused.numpy(), feature.numpy(), atol=2e-4, rtol=1e-3)
