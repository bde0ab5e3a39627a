"""Port parity: ``matmul_flops`` (moleculesde_tpu_torch/utils/flops.py)
against the JAX package's (moleculesde_tpu/utils/flops.py), and the FLOPs
each kernel wrapper reports.

- The JAX package's five cases (tests/test_flops.py), as equal integer
  counts of the two packages: a plain matmul, a batched einsum, a gradient,
  a Python loop of five products against ``lax.scan`` of length 5, and
  ``torch.utils.checkpoint`` against ``jax.checkpoint`` (both count the
  recomputed forward once more).
- Forward counts of GIN, SchNet, PaiNN, the 2D->3D loss and the 3D->2D
  scores, JAX's "xla" paths against the port's plain ones, and the whole
  pretraining step in f32 (forward, backward and Adam): equal once the
  products that only one package runs are named and counted from the
  shapes (the ``*_only`` functions below).  They are layout choices, not
  work the other package skips: JAX's one-hot selector matmuls (GIN's edge
  gather and aggregation, the 2D->3D score's source mean) where the port
  gathers and scatters; JAX's merged q / k nets of the 3D->2D bank (a
  block-diagonal second layer, twice the products of two nets); the port's
  one-hot atom embedding in SchNet and PaiNN where JAX gathers; and the
  plain versions of the kernels K1 and K2 recomputing the bond embedding
  and the filter net in their backward, where JAX keeps them.
- Every kernel's report (``ops/*.py::flops``) equals ``matmul_flops`` of
  its plain version, forward and backward, at two shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from moleculesde_tpu.core.batch import pad_graphs as jax_pad_graphs
from moleculesde_tpu.models import GNN2D as JaxGNN2D
from moleculesde_tpu.models import PaiNN as JaxPaiNN
from moleculesde_tpu.models import SchNet as JaxSchNet
from moleculesde_tpu.models import SDEModel2Dto3D as JaxSDEModel2Dto3D
from moleculesde_tpu.models import SDEModel3Dto2D as JaxSDEModel3Dto2D
from moleculesde_tpu.pretrain.train_state import PretrainConfig as JaxPretrainConfig
from moleculesde_tpu.pretrain.train_state import build_models as jax_build_models
from moleculesde_tpu.pretrain.train_state import create_pretrain_state
from moleculesde_tpu.pretrain.train_step import make_pretrain_step
from moleculesde_tpu.utils.flops import matmul_flops as jax_flops
from moleculesde_tpu_torch.data.loader import GraphLoader
from moleculesde_tpu_torch.models.gnn2d import GNN2D
from moleculesde_tpu_torch.models.painn import PaiNN
from moleculesde_tpu_torch.models.schnet import SchNet
from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D
from moleculesde_tpu_torch.models.score_3d2d import SDEModel3Dto2D
from moleculesde_tpu_torch.ops import (
    attn_bank, attn_qk_bank, cfconv, gin_messages, pair_block, score_kernel)
from moleculesde_tpu_torch.pretrain.train_state import (
    PretrainConfig, build_models, make_optimizer)
from moleculesde_tpu_torch.pretrain.train_step import pretrain_step
from moleculesde_tpu_torch.utils.flops import matmul_flops, report_flops

from torch_port_common import both_batches, CPU, graphs, t

EMB, B, N = 16, 4, 8
E = 4 * N                 # both_batches' e_max
ATOM_CLASSES = 119


def test_plain_matmul():
    a, b = np.zeros((8, 16), np.float32), np.zeros((16, 32), np.float32)
    port = matmul_flops(lambda a, b: a @ b, t(a), t(b))
    assert port == jax_flops(lambda a, b: a @ b, a, b) == 2 * 8 * 16 * 32


def test_batched_einsum():
    a, b = np.zeros((4, 8, 16), np.float32), np.zeros((4, 16, 32), np.float32)
    port = matmul_flops(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b), t(a), t(b))
    assert port == jax_flops(lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b), a, b)


def test_grad_counts_forward_and_backward():
    """One product forward, its weight gradient backward: the input is a
    constant in both packages, so neither computes its gradient."""
    a = np.zeros((8, 16), np.float32)
    ta = t(a)
    port = matmul_flops(lambda w: torch.autograd.grad((ta @ w).sum(), w),
                        torch.zeros(16, 4, requires_grad=True))
    assert port == jax_flops(jax.grad(lambda w: jnp.sum(a @ w)), jnp.zeros((16, 4)))
    assert port == 2 * (2 * 8 * 16 * 4)


def test_loop_counts_every_iteration_as_scan_does():
    def loop(w):
        x = torch.zeros(8, 16)
        for _ in range(5):
            x = x @ w
        return x

    def scan(w):
        x, _ = jax.lax.scan(lambda x, _: (x @ w, None), jnp.zeros((8, 16)), None, length=5)
        return x

    assert matmul_flops(loop, torch.zeros(16, 16)) == jax_flops(jax.jit(scan),
                                                                jnp.zeros((16, 16)))


def test_checkpoint_recompute_counted_as_remat():
    a = np.zeros((8, 16), np.float32)
    ta = t(a)

    def port(w, remat):
        block = lambda w: torch.tanh(ta @ w)  # noqa: E731
        y = torch.utils.checkpoint.checkpoint(block, w, use_reentrant=False) if remat \
            else block(w)
        return torch.autograd.grad(y.sum(), w)

    def ref(remat):
        block = lambda w: jnp.tanh(a @ w)  # noqa: E731
        return jax.grad(lambda w: jnp.sum((jax.checkpoint(block) if remat else block)(w)))

    w = torch.zeros(16, 16, requires_grad=True)
    for remat in (False, True):
        assert matmul_flops(port, w, remat) == jax_flops(ref(remat), jnp.zeros((16, 16)))
    assert matmul_flops(port, w, True) - matmul_flops(port, w, False) == 2 * 8 * 16 * 16


def test_kernel_reports_reach_the_count():
    def fn(x):
        report_flops(1000)
        return x @ x

    x = torch.zeros(4, 4)
    assert matmul_flops(fn, x) == 1000 + 2 * 4 * 4 * 4
    report_flops(5)     # no count in progress: nothing happens
    assert matmul_flops(lambda: x @ x) == 2 * 4 * 4 * 4
    # a call with no product (a kernel's launch alone): its reports only
    assert matmul_flops(lambda: report_flops(7)) == 7
    assert matmul_flops(lambda: x + 1) == 0


# products that only one package runs, [B, N] batches of E edge slots

def gin_selectors_jax_only(layers: int, f: int) -> int:
    """JAX's GIN (``msg_impl="xla"``) gathers ``x[src]`` and aggregates at
    ``dst`` as one-hot matmuls [B, E, N] x [B, N, F] and [B, N, E] x [B, E,
    F] (moleculesde_tpu/core/segment.py:115, 144), per layer."""
    return layers * 2 * (2 * B * E * N * f)


def atom_embedding_port_only(width: int) -> int:
    """The port's SchNet and PaiNN embed atoms as a one-hot matmul [B*N, 119]
    x [119, H] (models/schnet.py, models/painn.py); JAX gathers."""
    return 2 * B * N * ATOM_CLASSES * width


def source_mean_jax_only(layers: int) -> int:
    """JAX's 2D->3D score (channel-major) takes the EquiLayer source mean of
    each of the 3 frame components as a selector matmul [B, N*N] x [N*N, N]
    (moleculesde_tpu/models/score_2d3d.py:384-386), per score layer."""
    return layers * 3 * 2 * B * N * N * N


def v4_pair_features_jax_only(emb: int, h: int) -> int:
    """Variant 4's pair features: JAX's three-operand einsum forms the outer
    product h_s h_d as a product with a contraction of 1, and it projects
    ``h2d @ W_add`` twice (moleculesde_tpu/models/score_2d3d.py:647-652)."""
    return 2 * B * N * N * emb + 2 * B * N * emb * h


def qk_block_diagonal_jax_only(layers) -> int:
    """JAX's 3D->2D bank merges the q and k nets: their second layer is one
    block-diagonal [2 A2, 2 A2] product per channel
    (moleculesde_tpu/models/score_3d2d.py:150-156), twice the FLOPs of the
    port's two [A2, A2] products: 4 C B N A2^2 more per edge layer of C
    channels and q / k width A2."""
    return sum(4 * c * B * N * a2 * a2 for c, a2 in layers)


@pytest.fixture(scope="module")
def batches():
    return both_batches(graphs(seed=61, count=B, n_max=N), n_max=N)


def _jax_count(fn, *args):
    return jax_flops(fn, *args)


def test_gin_forward_count(batches):
    jb, tb = batches
    jm = JaxGNN2D(num_layers=2, emb_dim=EMB)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb))
    ref = _jax_count(lambda v: jm.apply(v, jb, deterministic=True, use_running_average=True),
                     v)
    tm = GNN2D(num_layers=2, emb_dim=EMB, device=CPU)
    port = matmul_flops(tm, tb, use_running_average=True)
    assert ref == port + gin_selectors_jax_only(2, EMB)


@pytest.mark.parametrize("name", ["SchNet", "PaiNN"])
def test_3d_encoder_forward_count(batches, name):
    jb, tb = batches
    if name == "SchNet":
        width = dict(hidden_channels=EMB, num_filters=8, num_interactions=2, num_gaussians=11)
        jm, tm = JaxSchNet(**width, agg="reduce"), SchNet(**width, device=CPU)
    else:
        width = dict(n_atom_basis=EMB, n_interactions=2, n_rbf=8)
        jm, tm = JaxPaiNN(**width), PaiNN(**width, device=CPU)
    args = (jb.atomic_numbers, jb.positions, jb.node_mask, jb.num_graphs, jb.n_max)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    ref = _jax_count(lambda v: jm.apply(v, *args), v)
    port = matmul_flops(tm.encode_batch, tb)
    assert ref == port - atom_embedding_port_only(EMB)


@pytest.mark.parametrize("variant", [1, 4])
def test_sde_2dto3d_loss_forward_count(batches, variant):
    jb, tb = batches
    h = 16
    node_2d = jnp.zeros((jb.num_nodes, EMB))
    jm = JaxSDEModel2Dto3D(emb_dim=EMB, hidden_dim=h, variant=variant, pair_impl="xla",
                           score_dtype="float32")
    key = jax.random.PRNGKey(1)
    v = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key}, node_2d, jb, key,
                                       method=JaxSDEModel2Dto3D.loss))
    ref = _jax_count(lambda v: jm.apply(v, node_2d, jb, key, 0.0, deterministic=True,
                                        use_running_average=False, mutable=["batch_stats"],
                                        method=JaxSDEModel2Dto3D.loss), v)
    tm = SDEModel2Dto3D(emb_dim=EMB, hidden_dim=h, variant=variant, device=CPU)
    port = matmul_flops(lambda: tm.loss(torch.zeros(jb.num_nodes, EMB), tb, deterministic=True,
                                        generator=torch.Generator().manual_seed(0)))
    extra = v4_pair_features_jax_only(EMB, h) if variant == 4 else 0
    assert ref == port + source_mean_jax_only(2) + extra


def test_sde_3dto2d_scores_forward_count(batches):
    jb, _ = batches
    kw = dict(dim3d=EMB, nhid=8, num_layers=2, bf16_attn=False)
    args = [np.zeros((B, N, EMB), np.float32), np.zeros((B, N, 119), np.float32),
            np.zeros((B, N, N), np.float32), np.ones((B, N), np.float32),
            np.full((B,), 0.5, np.float32)]
    jm = JaxSDEModel3Dto2D(**kw, attn_impl="xla")
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((jb.num_nodes, EMB)),
                                       jb, jax.random.PRNGKey(1),
                                       method=JaxSDEModel3Dto2D.loss))
    ref = _jax_count(lambda v, *a: jm.apply(v, *a, method=JaxSDEModel3Dto2D.scores), v,
                     *[jnp.asarray(a) for a in args])
    tm = SDEModel3Dto2D(**kw, device=CPU)
    with torch.no_grad():
        port = matmul_flops(tm.scores, *(t(a) for a in args))
    # edge layer 0: c_init 2 channels, q / k width 2 nhid; layer 1: c_hid 8,
    # width 2 adim (16)
    assert ref == port + qk_block_diagonal_jax_only([(2, 16), (8, 32)])


def test_pretrain_step_count():
    """One f32 step of each package at the tiny widths (GIN 2 x 16, SchNet
    2 x 8 filters x 11 Gaussians, hidden 16, the 3D->2D model at its
    defaults): JAX's ``make_pretrain_step`` (forward, backward, Adam)
    against the port's ``pretrain_step``, every named product counted
    forward and backward."""
    gs = graphs(seed=41, count=B, n_max=N)
    jb = jax_pad_graphs(gs, n_max=N, e_max=E, ext_e_max=N * N)
    tb = GraphLoader(gs, batch_size=B, n_max=N, e_max=E, ext_e_max=N * N, shuffle=False
                     ).collate_indices(np.arange(B))[0]
    tiny = dict(emb_dim=EMB, num_layer=2, schnet_num_filters=8, schnet_num_interactions=2,
                schnet_num_gaussians=11, hidden_dim_2dto3d=16, dropout_ratio=0.0,
                cl_similarity_metric="InfoNCE_dot_prod")
    jcfg = JaxPretrainConfig(**tiny, bf16_pairs=False, score_dtype_2dto3d="float32",
                             schnet_bf16=False, gnn2d_bf16=False, bf16_attn_3dto2d=False)
    models = jax_build_models(jcfg)
    state = jax.eval_shape(lambda k: create_pretrain_state(jcfg, jb, k)[1],
                           jax.random.PRNGKey(0))
    step = make_pretrain_step(models, jcfg, jit=False)
    ref = _jax_count(lambda s: step(s, jb, jax.random.PRNGKey(3), jnp.asarray(1.0)), state)
    tcfg = PretrainConfig(**tiny, train_precision="float32")
    tm = build_models(tcfg, CPU)
    port = matmul_flops(pretrain_step, tm, make_optimizer(tm, tcfg), tcfg, tb,
                        torch.Generator().manual_seed(0))
    # the one-hot products count twice (forward, and the gradient of the
    # operand that is not one-hot); the merged q / k layer three times
    # (forward, and both operands' gradients); the recomputed products once
    jax_only = (2 * gin_selectors_jax_only(2, EMB) + 2 * source_mean_jax_only(2)
                # 3D->2D defaults: layer 0 c_init 2 at width 2 x 16, layers
                # 1-3 c_hid 8 at width 2 x 16
                + 3 * qk_block_diagonal_jax_only([(2, 32)] + [(8, 32)] * 3))
    port_only = (2 * atom_embedding_port_only(EMB)
                 + 2 * (2 * B * E * 13 * EMB)                            # K1: boh @ table
                 + 2 * (2 * B * N * N * 8 * (11 + 8)))                  # K2: the filter net
    assert ref == port + jax_only - port_only


SHAPES = [(2, 5, 7, 16), (3, 8, 12, 24)]      # (B, N, E, F)


def _rng_tensors(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_reports_equal_plain_counts(shape):
    """Each kernel's reported FLOPs (forward and backward) against
    ``matmul_flops`` of its plain version: K1, K2, K5, K3, K4, K7, K8, and
    K6 (forward only) in both variants."""
    b, n, e, f = shape
    r = _rng_tensors(sum(shape))
    x, g_node = r(b, n, f), r(b, n, f)
    src = torch.from_numpy(np.random.default_rng(0).integers(0, n + 1, (b, e)).astype(np.int32))
    dst = src.flip(1).contiguous()
    boh, table = r(b, e, 13), r(13, f)
    assert matmul_flops(gin_messages.gin_messages_plain, x, src, dst, boh, table) \
        == gin_messages.flops(b, e, 13, f)
    assert matmul_flops(gin_messages.gin_messages_bwd_plain, x, src, dst, boh, table, g_node) \
        == gin_messages.flops(b, e, 13, f, bwd=True)
    gdim = 11
    ea, env, dist = r(b, n, n, gdim), r(b, n, n), r(b, n, n).abs()
    w = (r(gdim, f), r(f), r(f, f), r(f))
    rbf = dict(start=0.0, stop=5.0, num_gaussians=gdim)
    for fwd, bwd, first, kw in (
            (cfconv.fused_cfconv_plain, cfconv.fused_cfconv_bwd_plain, ea, {}),
            (cfconv.fused_cfconv_rbf_plain, cfconv.fused_cfconv_rbf_bwd_plain, dist, rbf)):
        assert matmul_flops(fwd, first, env, x, *w, **kw) == cfconv.flops(b, n, gdim, f)
        assert matmul_flops(bwd, first, env, x, *w, g_node, **kw) \
            == cfconv.flops(b, n, gdim, f, bwd=True)
    h = 8
    wp = r(f, h)
    assert matmul_flops(pair_block.pair_relu_project_plain, x, x, wp, r(h)) \
        == pair_block.flops(b, n, f, h)
    assert matmul_flops(pair_block.pair_relu_project_bwd_plain, x, x, wp, r(b, n, n, h)) \
        == pair_block.flops(b, n, f, h, bwd=True)
    assert matmul_flops(pair_block.pair_relu_project_cm_plain, x, x, wp) \
        == pair_block.flops(b, n, f, h)
    assert matmul_flops(pair_block.pair_relu_project_cm_bwd_plain, x, x, wp, r(b, h, n * n)) \
        == pair_block.flops(b, n, f, h, bwd=True)
    c, a, ds = 3, 8, 2
    q, k, g_map = r(b, c, n, a), r(b, c, n, a), r(b, c, n, n)
    assert matmul_flops(attn_bank.attn_map_bank_plain, q, k, ds) == attn_bank.flops(b, c, n, a)
    assert matmul_flops(attn_bank.attn_map_bank_bwd_plain, q, k, g_map, ds) \
        == attn_bank.flops(b, c, n, a, bwd=True)
    ws = [r(c, f, a), r(c, a), r(c, a, a), r(c, a)] * 2
    assert matmul_flops(attn_qk_bank.attn_qk_bank_plain, x, *ws, ds) \
        == attn_qk_bank.flops(b, n, f, c, a)
    assert matmul_flops(attn_qk_bank.attn_qk_bank_bwd_plain, x, *ws, g_map, ds) \
        == attn_qk_bank.flops(b, n, f, c, a, bwd=True)
    hid = score_kernel.KERNEL_HIDDEN
    pair_mask = (r(b, n, n) > 0).float()
    for variant in (1, 2):
        _, total = score_kernel.score_param_layout(variant)
        assert matmul_flops(score_kernel.score_eval_fused_plain, r(b, n, 3), r(b, n, hid),
                            r(b, n, n, hid), pair_mask, 0.1 * r(total), variant=variant) \
            == score_kernel.flops(b, n, variant)
