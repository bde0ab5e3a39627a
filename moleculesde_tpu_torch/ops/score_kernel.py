"""One whole 2D->3D score evaluation as a single kernel (K6), forward only.

Counterpart of ``moleculesde_tpu/ops/score_kernel.py``: the PC sampler
evaluates the score ``2 * corrector_steps`` times per step, and as separate
operators each evaluation is ~550 launches on the card (the chain is
bound by launches, not by the device).  :func:`score_eval_fused` runs frame
construction, the Gaussian-Fourier coefficient embeddings, the projection
MLP, the DenseGAT layers (LayerNorm, FFN) and the basis-mixing modules of
``SDEModel2Dto3D`` in ``csrc/score_eval.cu``, which replaces the TPU kernel
``_kernel`` (``pallas_call`` at ``ops/score_kernel.py:388``).  At the
sampler's widths (hidden 32, 8 heads, basis width 128) and n_max up to 128
one launch does it all: a thread-block cluster per molecule, its blocks
splitting the destinations (:func:`score_plan`; past 64 the masked edge
features live in a scratch buffer in device memory,
:func:`score_slab_bytes`).  Everywhere else (past n_max 128, at any other
width the JAX kernel takes, or past 128 packed segments) the layered plan,
``csrc/score_layered.cu``, runs the evaluation as ``2 + 2 L C + 2 L``
launches with the node-wide state in device memory
(:func:`score_scratch_bytes`) and its per-pair products as warp tile
products (``mma.sync`` in bf16 mode, register-blocked FMAs in f32 mode).  The kernel has two
variants: 2 gates the 2D edge features by the distance Fourier features, 1
adds them as they are, which is also how model variants 3 and 4 use theirs
(``SDEModel2Dto3D.kernel_variant``, as the JAX package passes them).  On a
CPU tensor it takes :func:`score_eval_fused_plain`, the same function in
PyTorch.

Widths: the hidden width is node_attr's last axis; the basis width is
learnt from the packed buffer's length (:func:`score_coff_dim`), as the JAX
kernel reads it from its packed shapes.  Refused by name on both paths,
because the JAX kernel does not compute its own model's function there:
more than 8 heads (its head selector has 8 columns and drops the rest), a
hidden width the heads do not divide, and a basis width past 64 that is not
a multiple of 64 (its 64-channel chunks).

The weights the kernel reads are packed once into one contiguous f32
buffer (:func:`pack_score_params`) in the JAX package's order
(``pack_score_params``, l.44-93), each segment starting on a 16-byte
boundary; the TPU's selector constants and its 8-column padding of
``basis_out`` are left out.  ``bf16`` rounds where the TPU kernel rounds:
both operands of every matrix product (its ``mm``, products with its
selector matrices included), the masked edge features, the node state
``x`` and its residual adds, the LayerNorm outputs; frame geometry, softmax
and LayerNorm statistics stay f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.models.score_2d3d import dense_frames
from moleculesde_tpu_torch.ops.common import SQRT_GUARD, resolve_impl, round_bf16, stream
from moleculesde_tpu_torch.utils.flops import report_flops

# the widths csrc/score_eval.cu's cluster plan is compiled for
KERNEL_N_MAX = 128        # the cluster plan's: four chunks of 32 sources per lane
KERNEL_HIDDEN = 32
KERNEL_HEADS = 8
KERNEL_COFF_DIM = 128
MAX_SEGMENTS = 128        # the cluster plan's Offsets table
MAX_HEADS = 8             # the TPU kernel's head selector: [hidden, 8]
_TWO_PI = 2.0 * math.pi
_GAT_PARTS = (("lin_query", "wq", "bq"), ("lin_key", "wk", "bk"), ("lin_value", "wv", "bv"),
              ("lin_edge", "we", "be"), ("lin_skip", "wsk", "bsk"), ("Dense_0", "wf1", "bf1"),
              ("Dense_1", "wf2", "bf2"))


def score_param_layout(variant: int, h: int = 32, coff_dim: int = 128,
                       num_layers: int = 2, num_convs: int = 2
                       ) -> Tuple[List[Tuple[str, Tuple[int, ...], int]], int]:
    """``([(name, shape, offset), ...], total floats)`` of the packed buffer,
    in the JAX package's order; every offset is a multiple of 4 floats."""
    shapes: List[Tuple[str, Tuple[int, ...]]] = [
        ("coff_W", (h,)), ("coff_mlp.kernel", (4 * h, h)), ("coff_mlp.bias", (h,)),
        ("proj1.kernel", (2 * h + 2, h)), ("proj1.bias", (h,)),
        ("proj2.kernel", (h, h)), ("proj2.bias", (h,))]
    if variant == 2:
        shapes += [("dist_W", (h,)), ("input_mlp.kernel", (2 * h, h)),
                   ("input_mlp.bias", (h,))]
    for li in range(num_layers * num_convs):
        for _, w, b in _GAT_PARTS:
            shapes += [(f"gat{li}.{w}", (h, h)), (f"gat{li}.{b}", (h,))]
        shapes += [(f"gat{li}.{k}", (h,)) for k in ("s1", "o1", "s2", "o2")]
    for m in range(num_layers):
        shapes += [(f"basis{m}.wh", (h, coff_dim)), (f"basis{m}.wbe", (h, coff_dim)),
                   (f"basis{m}.bbe", (coff_dim,)), (f"basis{m}.wo", (coff_dim, 3)),
                   (f"basis{m}.bo", (3,))]
    layout, off = [], 0
    for name, shape in shapes:
        layout.append((name, shape, off))
        off += -(-math.prod(shape) // 4) * 4
    return layout, off


def _model_tensors(model, variant: int) -> List[torch.Tensor]:
    """The model's tensors in :func:`score_param_layout` order."""
    sn = model.score_network
    ts = [model.coff_fourier_W, model.coff_mlp.kernel, model.coff_mlp.bias,
          model.project.Dense_0.kernel, model.project.Dense_0.bias,
          model.project.Dense_1.kernel, model.project.Dense_1.bias]
    if variant == 2:
        ts += [model.dist_fourier_W, model.input_mlp.Dense_0.kernel,
               model.input_mlp.Dense_0.bias]
    for li in range(sn.num_layers * sn.num_convs):
        g = getattr(sn, f"DenseGATLayer_{li}")
        for mod, _, _ in _GAT_PARTS:
            ts += [getattr(g, mod).kernel, getattr(g, mod).bias]
        ts += [g.LayerNorm_0.scale, g.LayerNorm_0.bias, g.LayerNorm_1.scale,
               g.LayerNorm_1.bias]
    for m in range(sn.num_layers):
        ts += [getattr(sn, f"basis_node_{m}").kernel, getattr(sn, f"basis_edge_{m}").kernel,
               getattr(sn, f"basis_edge_{m}").bias, getattr(sn, f"basis_out_{m}").kernel,
               getattr(sn, f"basis_out_{m}").bias]
    return ts


def pack_score_params(model, variant: int) -> torch.Tensor:
    """The weights K6 reads from ``model`` (an ``SDEModel2Dto3D``) as one
    contiguous, detached f32 buffer on the model's device, laid out by
    :func:`score_param_layout`."""
    sn = model.score_network
    h = model.hidden_dim
    coff_dim = sn.basis_out_0.kernel.shape[0]
    layout, total = score_param_layout(variant, h, coff_dim, sn.num_layers, sn.num_convs)
    tensors = _model_tensors(model, variant)
    out = torch.zeros(total, dtype=torch.float32, device=model.coff_mlp.kernel.device)
    with torch.no_grad():
        for (name, shape, off), t in zip(layout, tensors):
            if tuple(t.shape) != shape:
                raise ValueError(f"pack_score_params: {name} has shape {tuple(t.shape)}, "
                                 f"expected {shape}")
            out[off:off + t.numel()] = t.detach().reshape(-1).float()
    return out


def score_segments(packed: torch.Tensor, variant: int, h: int = 32, coff_dim: int = 128,
                   num_layers: int = 2, num_convs: int = 2) -> Dict[str, torch.Tensor]:
    """{name: view of ``packed`` in its shape}."""
    layout, total = score_param_layout(variant, h, coff_dim, num_layers, num_convs)
    if packed.numel() != total:
        raise ValueError(f"packed score weights: {packed.numel()} floats, layout needs {total}")
    return {name: packed[off:off + math.prod(shape)].reshape(shape)
            for name, shape, off in layout}


def _layernorm(x, scale, bias):
    """The TPU kernel's LayerNorm: two-pass f32 statistics, eps 1e-6."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6) * scale + bias


def score_eval_fused_plain(pos3, node_attr, edge_attr_2d, pair_mask, packed, *,
                           variant: int = 1, bf16: bool = False, num_layers: int = 2,
                           num_convs: int = 2, n_head: int = 8,
                           coff_dim: int = 128) -> torch.Tensor:
    """Plain PyTorch version of K6: the TPU kernel's ``_kernel``
    (l.141-330), rounding to bf16 in ``bf16`` mode at the points where it
    rounds.  pos3 [B, N, 3], node_attr [B, N, H], edge_attr_2d [B, N, N, H],
    pair_mask [B, N, N] -> raw score [B, N, 3] f32."""
    b, n, h = node_attr.shape
    ws = score_segments(packed, variant, h, coff_dim, num_layers, num_convs)
    nn_ = n * n

    def r(t):
        return round_bf16(t, bf16)

    def mm(a, w):  # both operands in the compute dtype, f32 accumulation
        return r(a) @ r(w)

    pos = pos3.float()
    maskf = pair_mask.float()
    (diff, cross, vert), coff_s, coff_d, (pseudo_sin, pseudo_cos) = dense_frames(pos)

    def pairh(plane, w_row):   # [B, N, N] x [h] -> [B, N*N, h]
        return plane.reshape(b, nn_, 1) * w_row

    w_c = ws["coff_W"] * _TWO_PI
    wm, bm = ws["coff_mlp.kernel"], ws["coff_mlp.bias"]
    blocks = [wm[i * h:(i + 1) * h] for i in range(4)]

    def coff_embed(coff):
        p0, p2 = pairh(coff[0], w_c), pairh(coff[2], w_c)
        acc = mm(torch.sin(p0), blocks[0])
        acc = acc + mm(torch.cos(p0), blocks[1])
        acc = acc + mm(torch.sin(p2), blocks[2])
        acc = acc + mm(torch.cos(p2), blocks[3])
        return acc + bm

    w1, b1 = ws["proj1.kernel"], ws["proj1.bias"]
    pre = (pairh(pseudo_sin, w1[0]) + pairh(pseudo_cos, w1[1])
           + mm(coff_embed(coff_s), w1[2:2 + h]) + mm(coff_embed(coff_d), w1[2 + h:]) + b1)
    frame_inv = mm(F.silu(pre), ws["proj2.kernel"]) + ws["proj2.bias"]
    edge2d = edge_attr_2d.float().reshape(b, nn_, h)
    if variant == 2:
        comps = [pos[..., k] for k in range(3)]
        dist = torch.sqrt(sum((c[:, :, None] - c[:, None, :]) ** 2 for c in comps)
                          + SQRT_GUARD)
        dp = pairh(dist, ws["dist_W"] * _TWO_PI)
        wi = ws["input_mlp.kernel"]
        dist_inv = mm(torch.sin(dp), wi[:h]) + mm(torch.cos(dp), wi[h:]) + ws["input_mlp.bias"]
        edge_attr = dist_inv * edge2d + frame_inv
    else:
        edge_attr = edge2d + frame_inv
    edge_attr = r(edge_attr * maskf.reshape(b, nn_, 1))             # [B, N*N, h]

    c_head = h // n_head
    scale = 1.0 / math.sqrt(float(c_head))
    neg = torch.finfo(torch.float32).min
    maskn = maskf / maskf.sum(dim=1, keepdim=True).clamp(min=1.0)  # EquiLayer mean
    x = r(node_attr.float())
    grad = torch.zeros((b, n, 3), dtype=torch.float32, device=pos.device)
    li = 0
    for m in range(num_layers):
        for conv in range(num_convs):
            g = {k.split(".", 1)[1]: v for k, v in ws.items() if k.startswith(f"gat{li}.")}
            li += 1
            q = mm(x, g["wq"]) + g["bq"]                                # [B, N, h]
            k_ = mm(x, g["wk"]) + g["bk"]
            v = mm(x, g["wv"]) + g["bv"]
            e2 = (mm(edge_attr, g["we"]) + g["be"]).reshape(b, n, n, h)  # [B, s, d, h]
            ke = (k_[:, :, None, :] + e2) * q[:, None, :, :]
            logits = r(ke).reshape(b, n, n, n_head, c_head).sum(dim=-1) * scale
            l4 = torch.where(maskf[..., None] > 0, logits, neg)
            ex = torch.exp(l4 - l4.amax(dim=1, keepdim=True))
            alpha = ex / ex.sum(dim=1, keepdim=True).clamp(min=1e-30) * maskf[..., None]
            alpha_full = r(alpha).repeat_interleave(c_head, dim=-1)
            msg = (alpha_full * (v[:, :, None, :] + e2)).sum(dim=1)    # [B, d, h]
            mha = msg + (mm(x, g["wsk"]) + g["bsk"])
            x = r(x + r(_layernorm(r(mha), g["s1"], g["o1"])))
            ffn = mm(F.silu(mm(x, g["wf1"]) + g["bf1"]), g["wf2"]) + g["bf2"]
            x = r(x + r(_layernorm(r(ffn), g["s2"], g["o2"])))
            if conv < num_convs - 1:
                x = F.silu(x)
            x = r(x)
        wh, wbe, bbe = ws[f"basis{m}.wh"], ws[f"basis{m}.wbe"], ws[f"basis{m}.bbe"]
        wo, bo = ws[f"basis{m}.wo"], ws[f"basis{m}.bo"]
        cc = bo.expand(b, nn_, 3)
        for c0 in range(0, coff_dim, 64):      # the TPU kernel's channel chunks
            csl = slice(c0, c0 + 64)
            hp = mm(x, wh[:, csl])                                     # [B, N, 64]
            ep = (mm(edge_attr, wbe[:, csl]) + bbe[csl]).reshape(b, n, n, -1)
            coff = F.silu(hp[:, :, None, :] + hp[:, None, :, :] + ep)
            cc = cc + mm(coff.reshape(b, nn_, -1), wo[csl])
        cc = cc.reshape(b, n, n, 3)
        for comp, bx in enumerate(zip(diff, cross, vert)):
            rows = r(cc[..., 0] * bx[0]) + r(cc[..., 1] * bx[1]) + r(cc[..., 2] * bx[2])
            grad[..., comp] = grad[..., comp] + (rows * maskn).sum(dim=1)
    return grad


def flops(b: int, n: int, variant: int = 1, h: int = 32, coff_dim: int = 128,
          num_layers: int = 2, num_convs: int = 2) -> int:
    """Matrix-product FLOPs of the plain version (what ``matmul_flops``
    counts there), which the kernel reports.  Per pair ([B*N*N] rows): the
    two coefficient embeddings' 4 + 4 [h, h] blocks, the projection's two
    [h, h] halves and its second layer, variant 2's distance MLP (2 more),
    each GAT layer's edge projection, each basis layer's edge half [h,
    coff] and output [coff, 3]; per node ([B*N] rows): each GAT layer's q,
    k, v, skip and two FFN products, each basis layer's node half."""
    layers = num_layers * num_convs
    per_pair = (11 + (2 if variant == 2 else 0) + layers) * h * h + num_layers * coff_dim * (h + 3)
    per_node = 6 * layers * h * h + num_layers * h * coff_dim
    return 2 * b * n * (n * per_pair + per_node)


# csrc/score_eval.cu's shared-memory layout
_ROW_BYTES = {True: 80, False: 128}       # a slab row: 40 bf16 / 32 f32 values
_WBUF_BYTES = 9472 * 4
_TILE_BYTES = 4608                        # a warp's tile, bf16 mode


def _align16(v: int) -> int:
    return (v + 15) & ~15


def _threads(n: int) -> int:
    """Threads per block (csrc/score_eval.cu::threads_for): 512 at n_max <=
    32, 256 above (two or four source chunks per lane hold more registers)."""
    return 512 if n <= 32 else 256


def _chunks(n: int) -> int:
    """Chunks of 32 sources a lane takes (csrc/score_eval.cu::chunks_for):
    1, 2 or 4; the block pads the sources to 32 times as many."""
    return 1 if n <= 32 else 2 if n <= 64 else 4


def _global_slab(n: int) -> bool:
    """Past n_max 64 (four source chunks) the slab lives in device memory
    (csrc/score_eval.cu::global_slab)."""
    return n > 64


def score_slab_bytes(b: int, n: int, bf16: bool) -> int:
    """Bytes of the device-memory slab past n_max 64: 32 values in the
    mode's type for each of the B x N x 128 pairs of 128 padded sources
    (1 MB a molecule at n_max 128 in bf16, 2 MB in f32); 0 at n_max <= 64,
    where it lives in shared memory."""
    return b * n * 128 * KERNEL_HIDDEN * (2 if bf16 else 4) if _global_slab(n) else 0


def score_layout_bytes(n: int, dests: int, bf16: bool) -> int:
    """Shared-memory bytes of one block of K6 at n_max ``n`` with ``dests``
    destinations per block, as ``csrc/score_eval.cu::make_layout`` counts
    them: the block's slab rows (none past n_max 64), the weight buffer,
    the double-buffered node state, q / k / v / skip (or the basis node
    part), the warps' tiles (bf16 mode), the FFN rows, positions, mask,
    counts and score rows."""
    nsp = 32 * _chunks(n)
    warps = _threads(n) // 32
    node = max(4 * nsp * (KERNEL_HIDDEN + 1), nsp * (KERNEL_COFF_DIM + 1))
    slab = 0 if _global_slab(n) else _align16(dests * nsp * _ROW_BYTES[bf16])
    return (slab + _WBUF_BYTES + 2 * nsp * KERNEL_HIDDEN * 4
            + _align16(node * 4) + (warps * _TILE_BYTES if bf16 else 0) + warps * KERNEL_HIDDEN * 4
            + _align16(nsp * 12) + _align16(dests * (nsp + 1) * 4) + _align16(dests * 4)
            + _align16(dests * 12))


def score_coff_dim(numel: int, variant: int, h: int, num_layers: int = 2,
                   num_convs: int = 2) -> int:
    """The basis width of a packed buffer of ``numel`` floats at these
    widths (its layout's length grows with the basis width by at least
    ``2 h + 4`` floats a module a channel, so one width fits at most);
    raises if none does."""
    base = score_param_layout(variant, h, 0, num_layers, num_convs)[1]
    if num_layers < 1:
        if numel == base:
            return 0
    else:
        est = (numel - base) // (num_layers * (2 * h + 4))
        for cd in range(max(est - 2, 0), est + 3):
            if score_param_layout(variant, h, cd, num_layers, num_convs)[1] == numel:
                return cd
    raise ValueError(f"score_eval_fused: packed weights have {numel} floats, which no basis "
                     f"width gives at hidden {h}, variant {variant}, {num_layers} modules of "
                     f"{num_convs} GAT layers")


def check_widths(variant: int, h: int, n_head: int, coff_dim: int) -> None:
    """Refuse, by name, what the JAX kernel cannot compute: a variant other
    than 1 or 2, more than 8 heads (its [hidden, 8] head selector drops the
    heads past 8), a hidden width the heads do not divide (it leaves the
    rest of the channels out of every head), a basis width past 64 that is
    not a multiple of 64 (its 64-channel chunks)."""
    if variant not in (1, 2):
        raise ValueError(f"score_eval_fused: variant {variant}; the kernel has variants 1 "
                         "and 2 (model variants 3 and 4 run as 1)")
    if not 1 <= n_head <= MAX_HEADS:
        raise ValueError(f"score_eval_fused: {n_head} heads; the TPU kernel's head selector "
                         f"has {MAX_HEADS} columns and drops the heads past {MAX_HEADS}")
    if h % n_head:
        raise ValueError(f"score_eval_fused: hidden {h} is not a multiple of {n_head} heads "
                         "(the TPU kernel leaves the remaining channels out of every head)")
    if coff_dim > 64 and coff_dim % 64:
        raise ValueError(f"score_eval_fused: basis width {coff_dim}; the TPU kernel's "
                         "64-channel chunks take a width of at most 64 or a multiple of 64")


# csrc/score_layered.cu, the layered plan: blocks of (molecule, 8
# destinations), a warp each; a pass keeps its rows in shared memory where 8
# warps' rows fit under a cap, else in the warps' rows of device scratch
LAYERED_DESTS = 8
LAYERED_THREADS = 32 * LAYERED_DESTS
_FRONT_CAP = 200 * 1024      # bytes of the front pass's rows on the chip
_GAT_CAP = 100 * 1024        # bytes of the GAT pass's FFN rows on the chip
_TILE_FLOATS = 32 * 36       # a warp's [32 columns][36] tile (conflict-free scatter)
_BASIS_SMEM = 4 * LAYERED_DESTS * _TILE_FLOATS
_BASIS_STAGE_CAP = 72 * 1024  # bytes of a basis module's per-pair weights staged
_INT32_MAX = 2 ** 31 - 1


def _round32(v: int) -> int:
    return -(-v // 32) * 32


def _front_rows(h: int, bf16: bool) -> int:
    """Bytes of a warp's front-pass rows (csrc/score_layered.cu::
    front_rows_bytes): the two coefficient embeddings and the projection's
    silu output, h padded to 32 channels x 32 pairs each, as bf16 fragments
    or f32."""
    return 3 * _round32(h) * (64 if bf16 else 128)


def _keep_floats(h: int, n_head: int, chunks: int) -> int:
    """Floats of a GAT warp's kept rows in device scratch (csrc/
    score_layered.cu::keep_floats): v[s] + e2 + b_e of every pair of its
    destination ([chunk][h padded to 32][32], f32) and the logits
    ([chunk][head][32])."""
    return chunks * (_round32(h) * 32 + n_head * 32)


def _front_on_chip(h: int, bf16: bool) -> bool:
    return LAYERED_DESTS * _front_rows(h, bf16) <= _FRONT_CAP


def _ffn_rows_on_chip(h: int) -> bool:
    """Whether 8 GAT warps' FFN rows fit in shared memory beside their tiles
    (csrc/score_layered.cu::ffn_rows_on_chip); else they go to device
    scratch."""
    return 4 * LAYERED_DESTS * _gat_warp(h, True) <= _GAT_CAP


def _gat_warp(h: int, ffn_on_chip: bool) -> int:
    """Floats of a GAT warp's shared memory (csrc/score_layered.cu::
    gat_warp_floats): the [32][36] tile of the logits' terms, a chunk's
    softmax weights ([8][32]) and, where they fit, the FFN's input, hidden
    and output rows of h padded to 32."""
    return _TILE_FLOATS + 8 * 32 + (3 * _round32(h) if ffn_on_chip else 0)


def layered_smem(bf16: bool, h: int = 32, coff_dim: int = 128, num_layers: int = 2,
                 num_convs: int = 2) -> int:
    """Dynamic shared memory of the layered plan's largest pass block at any
    n_max (csrc/score_layered.cu::layered_smem): the front pass's rows of 8
    warps where they fit in 200 KB (else none: they go to device scratch);
    the GAT pass's [32][36] tile of the logits' terms, a chunk's softmax
    weights and its FFN rows (three rows of h a warp) where they fit in 100
    KB (its kept rows are in device scratch); the basis pass's [32][36] tile
    a warp, with a module's basis_edge and basis_out weights where they fit
    in 72 KB.  No width takes it past 200 KB."""
    front = LAYERED_DESTS * _front_rows(h, bf16) if _front_on_chip(h, bf16) else 0
    # the basis module's per-pair weights (basis_edge's tile, its bias,
    # basis_out, its bias) staged beside the tiles where they fit in 72 KB
    cdp = _round32(coff_dim)
    weights = 4 * (_round32(h) * cdp // (2 if bf16 else 1) + cdp + 4 * cdp + 4)
    basis = _BASIS_SMEM + (weights if weights <= _BASIS_STAGE_CAP else 0)
    gat = 4 * LAYERED_DESTS * _gat_warp(h, _ffn_rows_on_chip(h))
    return max(front, gat if num_layers * num_convs else 0, basis if num_layers else 0)


def _node_row(h: int, coff_dim: int) -> int:
    """Floats of a node row of the layered plan: q | k | v | skip, each
    padded to 32 channels, or the basis node part."""
    return max(4 * _round32(h), _round32(coff_dim))


def _image_floats(variant: int, h: int, coff_dim: int, num_layers: int, num_convs: int,
                  bf16: bool = False) -> int:
    """Floats of the layered plan's weight image (csrc/score_layered.cu::
    seg_image_floats): vectors padded to 32 (basis_out's bias to 4); the
    node passes' and the FFN's kernels as [h padded to 32][columns padded to
    32]; each per-pair product's kernel (coff_mlp's four blocks of h rows,
    proj1's two after its two angle rows of h padded to 32, proj2,
    input_mlp's two, each GAT layer's lin_edge, each module's basis_edge) as
    its blocks of h rows each padded to 32, by its columns padded to 32,
    half as many floats in bf16 mode (two values a float); basis_out as 4
    floats a channel of the basis width padded to 32."""
    hp, cdp = _round32(h), _round32(coff_dim)
    pair = {"coff_mlp.kernel": 4, "proj2.kernel": 1, "input_mlp.kernel": 2, "we": 1, "wbe": 1}
    total = 0
    for name, shape, _ in score_param_layout(variant, h, coff_dim, num_layers, num_convs)[0]:
        part = name.rsplit(".", 1)[-1]
        key = part if name.split(".")[0].startswith(("gat", "basis")) else name
        cols = shape[-1]
        if name == "proj1.kernel":
            total += 2 * hp + 2 * hp * hp // (2 if bf16 else 1)
        elif key in pair:
            total += pair[key] * hp * _round32(cols) // (2 if bf16 else 1)
        elif part == "wo":
            total += 4 * cdp
        elif len(shape) == 2:
            total += hp * _round32(cols)
        else:
            total += 4 if cols == 3 else _round32(cols)
    return total


def score_scratch_bytes(b: int, n: int, bf16: bool, h: int = 32, coff_dim: int = 128,
                        num_layers: int = 2, num_convs: int = 2, variant: int = 1,
                        n_head: int = 8) -> int:
    """Device scratch of the layered plan (csrc/score_layered.cu::
    layered_scratch), each region 256-byte aligned: the slab (h padded to 32
    values in the mode's type a pair, sources padded to chunks of 32), the
    mask as [b][d][s], the valid sources per destination, the node rows
    (:func:`_node_row`), two node states, the weight image
    (:func:`_image_floats`), each warp's GAT kept rows, and its front and
    FFN rows where they are not on the chip.  About 128 MiB of slab and 320
    MiB of kept rows at n_max 1024, B = 2, hidden 32 in bf16."""
    def al(v: int) -> int:
        return -(-v // 256) * 256
    hp = _round32(h)
    chunks = -(-n // 32)
    warps = b * -(-n // LAYERED_DESTS) * LAYERED_DESTS
    rows = 0 if _front_on_chip(h, bf16) else al(warps * _front_rows(h, bf16))
    keep = al(warps * _keep_floats(h, n_head, chunks) * 4)
    ffn = 0 if _ffn_rows_on_chip(h) else al(warps * 3 * hp * 4)
    return (al(b * n * chunks * 32 * hp * (2 if bf16 else 4)) + al(b * n * n * 4)
            + al(b * n * 4) + al(b * n * _node_row(h, coff_dim) * 4) + 2 * al(b * n * h * 4)
            + al(_image_floats(variant, h, coff_dim, num_layers, num_convs, bf16) * 4)
            + rows + keep + ffn)


def score_plan(n: int, bf16: bool, plan: str = None, b: int = 1, *, h: int = KERNEL_HIDDEN,
               n_head: int = KERNEL_HEADS, coff_dim: int = KERNEL_COFF_DIM,
               num_layers: int = 2, num_convs: int = 2, variant: int = 1) -> Dict[str, int]:
    """K6's launch plan at n_max ``n`` (``b`` molecules) and these widths:
    the cluster plan at hidden 32, 8 heads, basis width 128, n_max up to
    128 and at most 128 packed segments, ``cluster`` blocks per molecule (2
    up to n_max 32, 4 up to 64, 8 up to 128), ``dests`` destinations per
    block, ``threads`` per block and ``smem`` bytes of shared memory per
    block; everywhere else the layered plan (``csrc/score_layered.cu``:
    blocks of 8 destinations, ``smem`` bytes of its largest pass block's
    rows, :func:`layered_smem`, ``scratch`` bytes of device memory,
    :func:`score_scratch_bytes`).  ``plan`` forces "cluster" (raises where
    it does not run) or "layered" (raises only where a launch's blocks pass
    the int32 grid index)."""
    segments = len(score_param_layout(variant, h, coff_dim, num_layers, num_convs)[0])
    widths = (h, n_head, coff_dim) == (KERNEL_HIDDEN, KERNEL_HEADS, KERNEL_COFF_DIM)
    fits = widths and segments <= MAX_SEGMENTS
    which = plan or ("cluster" if fits and n <= KERNEL_N_MAX else "layered")
    if which == "cluster":
        if not fits:
            raise ValueError(
                f"score_eval_fused kernel: the cluster plan takes hidden {KERNEL_HIDDEN}, "
                f"{KERNEL_HEADS} heads, basis width {KERNEL_COFF_DIM} and at most "
                f"{MAX_SEGMENTS} packed segments (got hidden {h}, {n_head} heads, basis width "
                f"{coff_dim}, {segments} segments)")
        if not 1 <= n <= KERNEL_N_MAX:
            raise ValueError(f"score_eval_fused kernel: n_max {n} is past the cluster plan "
                             f"(n_max <= {KERNEL_N_MAX} in {'bf16' if bf16 else 'f32'} mode)")
        cluster = 2 if n <= 32 else 4 if n <= 64 else 8
        dests = -(-n // cluster)
        return {"plan": "cluster", "cluster": cluster, "dests": dests, "threads": _threads(n),
                "smem": score_layout_bytes(n, dests, bf16)}
    if which != "layered":
        raise ValueError(f"score_eval_fused kernel: unknown plan {which!r}")
    if n < 1:
        raise ValueError(f"score_eval_fused kernel: n_max {n}")
    blocks = max(b * -(-n // LAYERED_DESTS), -(-b * n * _node_row(h, coff_dim) // 256))
    if blocks > _INT32_MAX:
        raise ValueError(f"score_eval_fused kernel: B={b}, n_max {n} need {blocks} blocks in "
                         f"the layered plan, past the int32 grid index ({_INT32_MAX})")
    if _image_floats(variant, h, coff_dim, num_layers, num_convs, bf16) > _INT32_MAX:
        raise ValueError(f"score_eval_fused kernel: hidden {h}, basis width {coff_dim}: the "
                         "layered plan's weight image is past the int32 index")
    return {"plan": "layered", "dests": LAYERED_DESTS, "threads": LAYERED_THREADS,
            "smem": layered_smem(bf16, h, coff_dim, num_layers, num_convs),
            "scratch": score_scratch_bytes(b, n, bf16, h, coff_dim, num_layers, num_convs,
                                           variant, n_head)}


def _check_kernel_inputs(pos3, node_attr, edge_attr_2d, maskf, packed, variant,
                         num_layers, num_convs, n_head, coff_dim, bf16, which):
    b, n, h = node_attr.shape
    widths = dict(h=h, n_head=n_head, coff_dim=coff_dim, num_layers=num_layers,
                  num_convs=num_convs, variant=variant)
    plan = score_plan(n, bf16, which, b=max(b, 1), **widths)
    layout, _ = score_param_layout(variant, h, coff_dim, num_layers, num_convs)
    shapes = {"pos3": (b, n, 3), "edge_attr_2d": (b, n, n, h), "pair_mask": (b, n, n)}
    for name, t in (("pos3", pos3), ("edge_attr_2d", edge_attr_2d), ("pair_mask", maskf)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"score_eval_fused kernel: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    for name, t in (("pos3", pos3), ("node_attr", node_attr), ("edge_attr_2d", edge_attr_2d),
                    ("pair_mask", maskf), ("packed", packed)):
        if not t.is_cuda or t.device != node_attr.device:
            raise ValueError(f"score_eval_fused kernel: {name} must be on {node_attr.device} "
                             "(CUDA)")
    return layout, plan


def _launch(pos3, node_attr, edge_attr_2d, pair_mask, packed, variant, bf16,
            num_layers, num_convs, n_head, coff_dim, which):
    f32 = [t.to(torch.float32).contiguous()
           for t in (pos3, node_attr, edge_attr_2d, pair_mask, packed)]
    layout, plan = _check_kernel_inputs(*f32, variant, num_layers, num_convs, n_head, coff_dim,
                                        bf16, which)
    pos3, node_attr, edge_attr_2d, maskf, packed = f32
    b, n, h = node_attr.shape
    out = torch.empty((b, n, 3), dtype=torch.float32, device=node_attr.device)
    if b == 0:
        return out
    offsets = (ctypes.c_int * len(layout))(*(off for _, _, off in layout))
    if plan["plan"] == "layered":
        scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=node_attr.device)
        fn = build.load("score_layered").score_eval_layered
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        rc = fn(pos3.data_ptr(), node_attr.data_ptr(), edge_attr_2d.data_ptr(),
                maskf.data_ptr(), packed.data_ptr(), offsets, len(layout), out.data_ptr(),
                scratch.data_ptr(), b, n, variant, num_layers, num_convs, h, n_head, coff_dim,
                int(bf16), stream(node_attr))
        build.check_launch(rc, "score_eval_fused (layered plan)")
    else:
        _launch_cluster(pos3, node_attr, edge_attr_2d, maskf, packed, offsets, len(layout),
                        out, variant, bf16, num_layers, num_convs, plan)
    score_eval_fused.launches += 1
    report_flops(flops(b, n, variant, h, coff_dim, num_layers, num_convs))
    return out


def _launch_cluster(pos3, node_attr, edge_attr_2d, maskf, packed, offsets, n_offsets, out,
                    variant, bf16, num_layers, num_convs, plan):
    b, n, _ = node_attr.shape
    slab_bytes = score_slab_bytes(b, n, bf16)
    slab = (torch.empty(slab_bytes, dtype=torch.uint8, device=node_attr.device)
            if slab_bytes else None)
    fn = build.load("score_eval").score_eval_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    rc = fn(pos3.data_ptr(), node_attr.data_ptr(), edge_attr_2d.data_ptr(), maskf.data_ptr(),
            packed.data_ptr(), offsets, n_offsets, out.data_ptr(),
            slab.data_ptr() if slab is not None else None, b, n, variant,
            num_layers, num_convs, int(bf16), plan["cluster"], plan["dests"], plan["smem"],
            stream(node_attr))
    build.check_launch(rc, "score_eval_fused")


def score_eval_fused(pos3, node_attr, edge_attr_2d, pair_mask, packed, *, variant: int = 1,
                     bf16: bool = False, impl: str = "auto", num_layers: int = 2,
                     num_convs: int = 2, n_head: int = 8, plan: str = None) -> torch.Tensor:
    """One fused score evaluation -> raw score [B, N, 3] f32 (the TPU
    kernel's ``score_eval_fused``, with its signature).  Forward only:
    raises if an input requires grad, as the TPU kernel has no VJP.
    ``impl``: "auto" (the kernel for a CUDA tensor, the plain version for a
    CPU tensor), "kernel" or "plain".  The hidden width is node_attr's, the
    basis width the packed buffer's (:func:`score_coff_dim`); widths the
    JAX kernel cannot compute raise on both paths (:func:`check_widths`).
    The kernel takes every other width at any n_max (:func:`score_plan`:
    the cluster plan at hidden 32, 8 heads, basis width 128 up to n_max
    128, the layered plan everywhere else; ``plan`` forces one)."""
    args = (pos3, node_attr, edge_attr_2d, pair_mask, packed)
    if any(t.requires_grad for t in args):
        raise RuntimeError("score_eval_fused is forward only: no input may require grad")
    h = node_attr.shape[-1]
    if variant not in (1, 2):
        check_widths(variant, h, n_head, 0)
    coff_dim = score_coff_dim(packed.numel(), variant, h, num_layers, num_convs)
    check_widths(variant, h, n_head, coff_dim)
    if resolve_impl(impl, node_attr, "score_eval_fused") == "plain":
        score_plan(node_attr.shape[1], bf16, plan, b=max(node_attr.shape[0], 1), h=h,
                   n_head=n_head, coff_dim=coff_dim, num_layers=num_layers,
                   num_convs=num_convs, variant=variant)
        return score_eval_fused_plain(*args, variant=variant, bf16=bf16,
                                      num_layers=num_layers, num_convs=num_convs,
                                      n_head=n_head, coff_dim=coff_dim)
    return _launch(*args, variant, bf16, num_layers, num_convs, n_head, coff_dim, plan)


score_eval_fused.launches = 0
