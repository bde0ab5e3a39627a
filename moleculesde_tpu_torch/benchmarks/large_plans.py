"""Bits and device times of the kernels whose large-N plans sit beside
their block plans -- K1's forward and backward, K3's and K4's backward,
K8's forward and backward -- at shapes the block plans take, for parent /
change turns on the GPU: whichever ``moleculesde_tpu_torch`` is first on
the path is timed, so a parent checkout unpacked in ``out/parent`` runs
the same lines.

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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("large_plans: needs a CUDA device")
    from moleculesde_tpu_torch.benchmarks.profile_gin_pair import k1_operands, pair_operands
    from moleculesde_tpu_torch.benchmarks.profile_score_bank import K8_DS, k8_operands
    from moleculesde_tpu_torch.ops import attn_qk_bank as k8
    from moleculesde_tpu_torch.ops.gin_messages import gin_messages, gin_messages_bwd
    from moleculesde_tpu_torch.ops.pair_block import (
        pair_relu_project_bwd, pair_relu_project_cm_bwd)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0), flush=True)
    label, dev = args.label, torch.device("cuda")
    modes = (("bf16", True), ("f32", False))
    x, src, dst, boh, table = k1_operands(32, 128, dev)
    g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    for mode, bf16 in modes:
        show(label, f"K1 fwd B=128 n_max 32 {mode}",
             lambda: gin_messages(x, src, dst, boh, table, bf16=bf16, impl="kernel"))
        show(label, f"K1 bwd B=128 n_max 32 {mode}",
             lambda: gin_messages_bwd(x, src, dst, boh, table, g, bf16=bf16, impl="kernel"))
    a, cc, w, g3, g4 = pair_operands(32, 128, dev)
    for mode, bf16 in modes:
        show(label, f"K3 bwd B=128 N=32 {mode}",
             lambda: pair_relu_project_bwd(a, cc, w, g3, bf16=bf16, impl="kernel"))
        show(label, f"K4 bwd B=128 N=32 {mode}",
             lambda: pair_relu_project_cm_bwd(a, cc, w, g4, bf16=bf16, impl="kernel"))
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


if __name__ == "__main__":
    main()
