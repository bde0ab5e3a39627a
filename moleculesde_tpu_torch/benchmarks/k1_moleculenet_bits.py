"""Which sum of the K1 MoleculeNet card test moves from run to run
(``tests/test_torch_port_finetune_kernels.py::test_k1_on_moleculenet_operands``):
its operands (16 synthetic molecules of 4-32 atoms, GNNGraphPred 5 x 300,
dropout 0.5, 3 tasks, f32), one training-mode loss and backward with K1
(the kernel build) and with K1's plain version (the plain build), each
side run twice on the same weights and dropout generator.  Printed per
side: whether the loss and each gradient keep their bits between the two
runs and the largest difference of those that move; then the test's
reading (each gradient against the plain build's, relative to
max(1, max |plain|), bar 1e-4) over ``--repeats`` runs.  All of it first
as PyTorch runs by default, then under
``torch.use_deterministic_algorithms(True)`` (the order of ``index_add_``
pinned).

    python3 -m moleculesde_tpu_torch.benchmarks.k1_moleculenet_bits [--repeats 5]
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch


def moleculenet_batch(dev, b: int = 16, n_max: int = 32, tasks: int = 3):
    """The card test's batch: b - 1 molecules and one empty slot."""
    from moleculesde_tpu_torch.core.batch import pad_graphs
    from moleculesde_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(0)
    gs = []
    for _ in range(b - 1):
        g = random_molecule(rng, int(rng.integers(4, n_max + 1)), extend=False)
        g["y"] = rng.choice([-1.0, 0.0, 1.0], size=tasks)
        g["forces"] = rng.normal(size=g["positions"].shape)
        gs.append(g)
    return pad_graphs(gs, n_max=n_max, e_max=4 * n_max, num_graphs=b, num_tasks=tasks,
                      with_forces=True).to(dev)


def loss_and_grads(model, batch, graph_mask):
    """The test's step: a training-mode loss and backward with the dropout
    generator seeded 1, the model's state restored afterwards."""
    from moleculesde_tpu_torch.finetune.classification import classification_loss

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=batch.atom_feats.device).manual_seed(1)
    loss = classification_loss(model, batch, graph_mask, gen)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.load_state_dict(saved)
    return {"loss": loss.detach(), **grads}


@contextlib.contextmanager
def deterministic(on: bool):
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved)


def moved(a: dict, b: dict) -> dict:
    """{name: largest difference} of the tensors whose bits differ."""
    return {k: (a[k] - b[k]).abs().max().item() for k in a if not torch.equal(a[k], b[k])}


def reading(kernel: dict, plain: dict):
    """(worst gradient, its error relative to max(1, max |plain|))."""
    worst = max((k for k in kernel if k != "loss"),
                key=lambda k: (kernel[k] - plain[k]).abs().max().item()
                / max(1.0, plain[k].abs().max().item()))
    err = ((kernel[worst] - plain[worst]).abs().max().item()
           / max(1.0, plain[worst].abs().max().item()))
    return worst, err


def main() -> None:
    from moleculesde_tpu_torch.models.gnn2d import GNNGraphPred

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    batch = moleculenet_batch(dev)
    model = GNNGraphPred(3, 5, 300, drop_ratio=0.5, device=dev)
    plain = GNNGraphPred(3, 5, 300, drop_ratio=0.5, msg_impl="plain", device=dev)
    plain.load_state_dict(model.state_dict())
    gm = torch.arange(16, device=dev) < 15
    for det in (False, True):
        mode = "deterministic algorithms" if det else "default algorithms"
        with deterministic(det):
            for side, m in (("kernel build", model), ("plain build", plain)):
                first, second = loss_and_grads(m, batch, gm), loss_and_grads(m, batch, gm)
                diff = moved(first, second)
                print(f"[{mode}] {side}: two runs, {len(diff)} of {len(first)} tensors move "
                      f"bits: {diff}", flush=True)
            errs = []
            for _ in range(args.repeats):
                worst, err = reading(loss_and_grads(model, batch, gm),
                                     loss_and_grads(plain, batch, gm))
                errs.append(err)
                print(f"[{mode}] kernel vs plain: worst gradient {worst} at {err:.3e} of "
                      f"max(1, |plain|) (bar 1e-4){' OVER' if err > 1e-4 else ''}", flush=True)
            print(f"[{mode}] {sum(e > 1e-4 for e in errs)} of {len(errs)} readings over the bar; "
                  f"range {min(errs):.3e}-{max(errs):.3e} ({torch.cuda.get_device_name(0)})",
                  flush=True)


if __name__ == "__main__":
    main()
