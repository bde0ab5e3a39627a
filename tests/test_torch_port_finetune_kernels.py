"""The finetunes' kernels on the card: K1 on the MoleculeNet model's
operands and K2 on the QM9 model's, in f32 (the finetunes' mode), against
their plain versions; the MD17 step launches no kernel.

Marked ``gpu``: they skip without a CUDA device (the kernels have no CPU
mode).  Run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_port_finetune_kernels.py -q``.
Tolerances as ``tests/test_torch_port_kernels.py`` states them for f32:
outputs 1e-5 and gradients 1e-4 of their largest value (floored at 1), the
same sums in another order.  The plain build's training pass runs under
PyTorch's deterministic algorithms: its message sum (``index_add_``) is a
float atomic on the card, whose order moved every gradient of that build
by up to 6.6e-4 between two runs (the kernel build keeps its bits);
pinned, the two builds read 1.5e-8 apart
(``benchmarks/k1_moleculenet_bits.py``).
"""

import contextlib

import numpy as np
import pytest
import torch

from moleculesde_tpu_torch.core.batch import pad_graphs
from moleculesde_tpu_torch.data.synthetic import random_molecule
from moleculesde_tpu_torch.finetune.classification import classification_loss
from moleculesde_tpu_torch.finetune.common import make_optimizer
from moleculesde_tpu_torch.finetune.md17 import md17_step
from moleculesde_tpu_torch.finetune.regression import RegressionModel
from moleculesde_tpu_torch.models.gnn2d import GNNGraphPred
from moleculesde_tpu_torch.models.schnet import SchNet
from moleculesde_tpu_torch.ops.cfconv import fused_cfconv, fused_cfconv_bwd
from moleculesde_tpu_torch.ops.gin_messages import gin_messages, gin_messages_bwd

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _batch(dev, b=16, n_max=32, tasks=3):
    rng = np.random.default_rng(0)
    gs = []
    for _ in range(b - 1):   # one empty slot
        g = random_molecule(rng, int(rng.integers(4, n_max + 1)), extend=False)
        g["y"] = rng.choice([-1.0, 0.0, 1.0], size=tasks)
        g["forces"] = rng.normal(size=g["positions"].shape)
        gs.append(g)
    return pad_graphs(gs, n_max=n_max, e_max=4 * n_max, num_graphs=b, num_tasks=tasks,
                      with_forces=True).to(dev)


def _close(out, ref, tol, what=""):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), (what, err)


@contextlib.contextmanager
def _pinned_order():
    """PyTorch's deterministic algorithms for the block (``index_add_`` sums
    in a fixed order on the card instead of by float atomics); the
    process's setting is restored afterwards."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def _loss_and_grads(model, loss_of):
    model.zero_grad(set_to_none=True)
    loss = loss_of(model)
    loss.backward()
    return loss.detach(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def test_k1_on_moleculenet_operands(cuda):
    batch = _batch(cuda)
    model = GNNGraphPred(3, 5, 300, drop_ratio=0.5, device=cuda)
    plain = GNNGraphPred(3, 5, 300, drop_ratio=0.5, msg_impl="plain", device=cuda)
    plain.load_state_dict(model.state_dict())
    before = (gin_messages.launches, gin_messages_bwd.launches)
    gm = torch.arange(16, device=cuda) < 15
    runs = []
    for m, order in ((model, contextlib.nullcontext()), (plain, _pinned_order())):
        saved = {k: v.clone() for k, v in m.state_dict().items()}
        gen = torch.Generator(device=cuda).manual_seed(1)   # the same dropout masks
        with order:
            runs.append(_loss_and_grads(m, lambda mm: classification_loss(mm, batch, gm, gen)))
        m.load_state_dict(saved)
    assert (gin_messages.launches - before[0], gin_messages_bwd.launches - before[1]) == (5, 5)
    (loss, grads), (loss_p, grads_p) = runs
    _close(loss, loss_p, 1e-5, "loss")
    for k in grads:
        _close(grads[k], grads_p[k], 1e-4, k)
    with torch.no_grad():
        _close(model(batch, use_running_average=True), plain(batch, use_running_average=True),
               1e-5, "evaluation logits")
        x0 = model.gnn.AtomEncoder_0(batch.atom_feats)
        ops = model.gnn.GINConv_0.message_inputs(x0, batch)
        _close(gin_messages(*ops, impl="kernel"), gin_messages(*ops, impl="plain"), 1e-5, "K1")
        g = torch.randn_like(ops[0])
        for a, b in zip(gin_messages_bwd(*ops, g, impl="kernel"),
                        gin_messages_bwd(*ops, g, impl="plain")):
            _close(a, b, 1e-4, "K1 backward")


def test_k2_on_qm9_operands(cuda):
    batch = _batch(cuda)
    kw = dict(hidden_channels=300, num_filters=128, num_interactions=6, num_gaussians=51)
    model = RegressionModel(SchNet(**kw, device=cuda))
    plain = RegressionModel(SchNet(**kw, impl="plain", device=cuda))
    plain.load_state_dict(model.state_dict())
    before = (fused_cfconv.launches, fused_cfconv_bwd.launches)
    def loss_of(m):
        return ((m(batch) - batch.y[:, 0]).abs() * (batch.y[:, 0] != 0)).mean()

    (loss, grads), (loss_p, grads_p) = (_loss_and_grads(m, loss_of) for m in (model, plain))
    assert (fused_cfconv.launches - before[0], fused_cfconv_bwd.launches - before[1]) == (6, 6)
    _close(loss, loss_p, 1e-5, "loss")
    for k in grads:
        _close(grads[k], grads_p[k], 1e-4, k)


def test_md17_step_launches_no_kernel(cuda):
    batch = _batch(cuda, b=8, n_max=12)
    model = RegressionModel(SchNet(hidden_channels=300, num_filters=128, num_interactions=6,
                                   num_gaussians=51, cfconv="xla", device=cuda))
    counters = (fused_cfconv, fused_cfconv_bwd, gin_messages, gin_messages_bwd)
    before = [c.launches for c in counters]
    metrics = md17_step(model, make_optimizer(model, 1e-4), batch, batch.y[:, 0],
                        batch.forces, torch.ones(8, dtype=torch.bool, device=cuda), 1e-4)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert [c.launches for c in counters] == before
