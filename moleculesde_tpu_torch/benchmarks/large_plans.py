"""Bits and device times of the kernels whose large-N plans sit beside
their block plans -- K1's forward and backward, K3's and K4's backward,
K8's forward and backward, K6's cluster plan, K7's forward and backward
-- at shapes the block plans take, for parent / change turns on the GPU:
whichever ``moleculesde_tpu_torch`` is first on the path is timed, so a
parent checkout unpacked in ``out/parent`` runs the same lines.

K6 on seeded operands (the card tests' perturbed weights) at B=64, n_max
32, 64 and 128, variants 1 and 2; K7 at B=128, C=8, N=32, A=32, ds=4 (the
3D->2D chain's edge layers 1-3).  Where the checkout has them, K6's
layered plan at n_max 256 and 1024 (B = 2) and forced at 32 / 64 / 128,
K7's grouped plan at A = 512 (B C = 16, N = 32) and forced at A = 32 (the
forward in 2 / 4 / 8 slices, the grouped backward).

At B=128, n_max 32 (the pretraining step's shape): K1 on GIN layer 0's
operands of the pretraining CLI's first batch, K3 / K4 on seeded normal
operands (C = 300, H = 32), K8 on seeded operands at the 3D->2D chain's
edge layer 1 (F = 16, C = 8) and 0 (F = 300, C = 2) widths; each output's
SHA-256 prefix, so equal bits show as equal prefixes.  Then K8's backward
at N = 256, B = 2 (edge layer 1 widths), where the block plan still runs,
and, where the checkout has it, the tiled plan forced there.  Device
times: 10 calls in a CUDA graph, replays timed with CUDA events
(``timing.py``).

    for p in out/parent . . out/parent; do env PYTHONPATH=$p \\
        python3 moleculesde_tpu_torch/benchmarks/large_plans.py --label $p; done

``--kernels k6,k7`` runs only those kernels' lines.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import subprocess

import torch


def show(label: str, what: str, fn) -> None:
    """Device ms and the SHA-256 prefix of every output of ``fn``."""
    from moleculesde_tpu_torch.benchmarks.timing import device_ms

    with torch.no_grad():
        out = fn()
        bits = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            bits.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        print(f"[{label}] {what}: device_ms={device_ms(fn):.4f} bits={bits.hexdigest()[:16]}",
              flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="this checkout", help="tag of the lines")
    parser.add_argument("--kernels", default="k1,k3,k8,k6,k7",
                        help="comma-separated kernels to run (of k1, k3, k8, k6, k7)")
    args = parser.parse_args()
    which = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("large_plans: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0), flush=True)
    label, dev = args.label, torch.device("cuda")
    modes = (("bf16", True), ("f32", False))
    if "k1" in which:
        k1_turns(label, dev, modes)
    if "k3" in which:
        k3_turns(label, dev, modes)
    if "k8" in which:
        k8_turns(label, dev, modes)
    if "k6" in which:
        k6_turns(label, dev, modes)
    if "k7" in which:
        k7_turns(label, dev, modes)


def k1_turns(label: str, dev, modes) -> None:
    from moleculesde_tpu_torch.benchmarks.profile_gin_pair import k1_operands
    from moleculesde_tpu_torch.ops.gin_messages import gin_messages, gin_messages_bwd

    x, src, dst, boh, table = k1_operands(32, 128, dev)
    g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    for mode, bf16 in modes:
        show(label, f"K1 fwd B=128 n_max 32 {mode}",
             lambda: gin_messages(x, src, dst, boh, table, bf16=bf16, impl="kernel"))
        show(label, f"K1 bwd B=128 n_max 32 {mode}",
             lambda: gin_messages_bwd(x, src, dst, boh, table, g, bf16=bf16, impl="kernel"))


def k3_turns(label: str, dev, modes) -> None:
    from moleculesde_tpu_torch.benchmarks.profile_gin_pair import pair_operands
    from moleculesde_tpu_torch.ops.pair_block import (
        pair_relu_project_bwd, pair_relu_project_cm_bwd)

    a, cc, w, g3, g4 = pair_operands(32, 128, dev)
    for mode, bf16 in modes:
        show(label, f"K3 bwd B=128 N=32 {mode}",
             lambda: pair_relu_project_bwd(a, cc, w, g3, bf16=bf16, impl="kernel"))
        show(label, f"K4 bwd B=128 N=32 {mode}",
             lambda: pair_relu_project_cm_bwd(a, cc, w, g4, bf16=bf16, impl="kernel"))


def k8_turns(label: str, dev, modes) -> None:
    from moleculesde_tpu_torch.benchmarks.profile_score_bank import K8_DS, k8_operands
    from moleculesde_tpu_torch.ops import attn_qk_bank as k8

    for f, c in ((16, 8), (300, 2)):
        qk, ws = k8_operands(128, 32, f, c)
        gk = torch.randn(128, c, 32, 32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
        for mode, bf16 in modes:
            q = qk.to(torch.bfloat16 if bf16 else torch.float32)
            show(label, f"K8 fwd B=128 N=32 F={f} C={c} {mode}",
                 lambda: k8.attn_qk_bank(q, *ws, K8_DS, bf16=bf16, impl="kernel"))
            show(label, f"K8 bwd B=128 N=32 F={f} C={c} {mode}",
                 lambda: k8.attn_qk_bank_bwd(q, *ws, gk, K8_DS, bf16=bf16, impl="kernel"))
    qk, ws = k8_operands(2, 256, 16, 8)
    q = qk.to(torch.bfloat16)
    gk = torch.randn(2, 8, 256, 256, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    show(label, "K8 bwd B=2 N=256 F=16 C=8 bf16 (the wrapper's plan)",
         lambda: k8.attn_qk_bank_bwd(q, *ws, gk, K8_DS, bf16=True, impl="kernel"))
    if "plan" in inspect.signature(k8._launch_bwd).parameters:
        show(label, "K8 bwd B=2 N=256 F=16 C=8 bf16 (the tiled plan)",
             lambda: k8._launch_bwd(q, ws, gk, K8_DS, True, plan="tiled"))


def score_operands(b: int, n: int, variant: int, dev):
    """K6's operands as the card tests draw them: seeded positions, node
    and edge features, a mask without self-pairs, perturbed weights."""
    from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D

    model = SDEModel2Dto3D(emb_dim=8, hidden_dim=32, variant=variant, device=dev)
    gen = torch.Generator(device=dev).manual_seed(10 + variant)
    packed = model.packed_score_params()
    packed = packed + 0.05 * torch.randn(packed.shape, device=dev, generator=gen)
    pos = 1.5 * torch.randn(b, n, 3, device=dev, generator=gen)
    node = torch.randn(b, n, 32, device=dev, generator=gen)
    edge = torch.randn(b, n, n, 32, device=dev, generator=gen)
    mask = torch.rand(b, n, n, device=dev, generator=gen) < 0.6
    mask[:, torch.arange(n), torch.arange(n)] = False
    return pos, node, edge, mask.float(), packed


def k6_turns(label: str, dev, modes) -> None:
    from moleculesde_tpu_torch.ops.score_kernel import score_eval_fused

    layered = "plan" in inspect.signature(score_eval_fused).parameters
    for n in (32, 64, 128):
        for variant in (1, 2):
            ops = score_operands(64, n, variant, dev)
            for mode, bf16 in modes:
                show(label, f"K6 B=64 n_max {n} v{variant} {mode}",
                     lambda: score_eval_fused(*ops, variant=variant, bf16=bf16, impl="kernel"))
                if layered and variant == 1:
                    show(label, f"K6 B=64 n_max {n} v1 {mode} (the layered plan forced)",
                         lambda: score_eval_fused(*ops, bf16=bf16, impl="kernel",
                                                  plan="layered"))
    if layered:
        for n in (256, 1024):
            ops = score_operands(2, n, 1, dev)
            for mode, bf16 in modes:
                show(label, f"K6 B=2 n_max {n} v1 {mode} (the layered plan)",
                     lambda: score_eval_fused(*ops, bf16=bf16, impl="kernel"))


def k7_turns(label: str, dev, modes) -> None:
    from moleculesde_tpu_torch.ops.attn_bank import attn_map_bank_kernel, attn_map_bank_kernel_bwd

    grouped = "groups" in inspect.signature(attn_map_bank_kernel).parameters
    gen = torch.Generator(device=dev).manual_seed(6)
    q32, k32 = (0.8 * torch.randn(128, 8, 32, 32, device=dev, generator=gen) for _ in range(2))
    g = torch.randn(128, 8, 32, 32, device=dev, generator=gen)
    for mode, bf16 in modes:
        q, k = (q32.bfloat16(), k32.bfloat16()) if bf16 else (q32, k32)
        show(label, f"K7 fwd B=128 C=8 N=32 A=32 {mode}",
             lambda: attn_map_bank_kernel(q, k, 4, bf16=bf16, impl="kernel"))
        show(label, f"K7 bwd B=128 C=8 N=32 A=32 {mode}",
             lambda: attn_map_bank_kernel_bwd(q, k, g, 4, bf16=bf16, impl="kernel"))
        if not grouped:
            continue
        for groups in (2, 4, 8):
            show(label, f"K7 fwd B=128 C=8 N=32 A=32 {mode} ({groups} slices)",
                 lambda: attn_map_bank_kernel(q, k, 4, bf16=bf16, impl="kernel", groups=groups))
        show(label, f"K7 bwd B=128 C=8 N=32 A=32 {mode} (the grouped plan)",
             lambda: attn_map_bank_kernel_bwd(q, k, g, 4, bf16=bf16, impl="kernel", groups=2))
    if grouped:
        qw, kw = (0.8 * torch.randn(2, 8, 32, 512, device=dev, generator=gen) for _ in range(2))
        gw = torch.randn(2, 8, 32, 32, device=dev, generator=gen)
        for mode, bf16 in modes:
            q, k = (qw.bfloat16(), kw.bfloat16()) if bf16 else (qw, kw)
            show(label, f"K7 fwd B=2 C=8 N=32 A=512 ds=64 {mode} (the grouped plan)",
                 lambda: attn_map_bank_kernel(q, k, 64, bf16=bf16, impl="kernel"))
            show(label, f"K7 bwd B=2 C=8 N=32 A=512 ds=64 {mode} (the grouped plan)",
                 lambda: attn_map_bank_kernel_bwd(q, k, gw, 64, bf16=bf16, impl="kernel"))


if __name__ == "__main__":
    main()
