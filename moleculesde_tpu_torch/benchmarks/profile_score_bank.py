"""Where the time of K6 (the fused score evaluation) and of K8's forward (the
q/k-net attention bank) goes on the GPU, and their device times.

Phases (the default): builds ``csrc/score_eval.cu`` and
``csrc/attn_qk_bank.cu`` with ``-DPHASE_PROFILE`` into ``build/profile/``
(the port's ``nvcc`` flags otherwise), where thread 0 of every block stamps
``%globaltimer`` at the kernels' phase marks, and launches them through
their C entries on seeded operands: K6 at B=64, n_max 32 in bf16 and f32
mode and at n_max 64 in bf16 (variant 1, the fused chain's shapes); K8's
forward at B=128, N=32, the 3D->2D chain's edge layers 1-3 (F=16, C=8, bf16)
and 0 (F=300, C=2, f32), with the chain's A = 32 and ds = 4 (8 heads).  Prints, per launch, the span from the first
block's start to the last block's end, the median block duration, the
median time of each phase (between consecutive marks) and the quantiles of
the blocks' start times, which show the waves.  The marks cost a few
instructions; ``chip_smoke.py`` gives the real times.

Device times (``--times``): K6 and K8's forward through the wrappers of
whichever ``moleculesde_tpu_torch`` is first on the path (so that a parent
checkout can be timed in turns with this one), at the shapes above plus K6
at n_max 64 in f32 and K8 at N=64: 10 calls captured in a CUDA graph, the
replays timed with CUDA events (median of 10), per call (``timing.py``).

    python -m moleculesde_tpu_torch.benchmarks.profile_score_bank
    PYTHONPATH=<checkout> python <this file> --times --label parent
"""

from __future__ import annotations

import argparse
import ctypes

import torch

K6_PHASES = (["staging", "phase 1", "cluster sync"]
             + [f"{layer}: {what}" for layer in ("GAT 0", "GAT 1")
                for what in ("staging", "q k v skip", "attention", "push + cluster sync")]
             + ["basis 0: staging + hp", "basis 0: pairs"]
             + [f"{layer}: {what}" for layer in ("GAT 2", "GAT 3")
                for what in ("staging", "q k v skip", "attention", "push + cluster sync")]
             + ["basis 1: staging + hp", "basis 1: pairs"])
K8_PHASES = ("W2 + bias copies issued", "chunk copies + wait", "layer 1", "barrier",
             "layer 2", "barrier", "map")
K6_SHAPES = ((64, 32, True), (64, 32, False), (64, 64, True))
K8_SHAPES = ((128, 32, 16, 8, True), (128, 32, 300, 2, False))
K8_DS = 4          # the 3D->2D chain's head width (A = 32, 8 heads)


def k6_operands(b: int, n: int, variant: int = 1, seed: int = 10):
    from moleculesde_tpu_torch.models.score_2d3d import SDEModel2Dto3D

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    packed = SDEModel2Dto3D(emb_dim=8, hidden_dim=32, variant=variant,
                            device=dev).packed_score_params()
    packed = packed + 0.05 * torch.randn(packed.shape, device=dev, generator=gen)
    pos = 1.5 * torch.randn(b, n, 3, device=dev, generator=gen)
    node = torch.randn(b, n, 32, device=dev, generator=gen)
    edge = torch.randn(b, n, n, 32, device=dev, generator=gen)
    mask = (torch.rand(b, n, n, device=dev, generator=gen) < 0.6).float()
    mask[:, torch.arange(n), torch.arange(n)] = 0.0
    return pos, node, edge, mask, packed


def k8_operands(b: int, n: int, f: int, c: int, a: int = 32, seed: int = 21):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(c, f, a), (c, a), (c, a, a), (c, a)] * 2
    ws = [torch.randn(s, device=dev, generator=gen) / (s[-2] ** 0.5 if len(s) == 3 else 4.0)
          for s in shapes]
    return torch.randn(b, n, f, device=dev, generator=gen), ws


def phases() -> None:
    from moleculesde_tpu_torch.benchmarks.timing import (
        phase_library, phase_stamps, print_phase_stamps)
    from moleculesde_tpu_torch.ops.attn_qk_bank import _weight_ptrs, fwd_plan
    from moleculesde_tpu_torch.ops.common import stream
    from moleculesde_tpu_torch.ops.score_kernel import score_param_layout, score_plan

    lib = phase_library("score_eval")
    fn = lib.score_eval_fused
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    layout, _ = score_param_layout(1)
    offsets = (ctypes.c_int * len(layout))(*(o for _, _, o in layout))
    for b, n, bf16 in K6_SHAPES:
        pos, node, edge, mask, packed = k6_operands(b, n)
        out = torch.empty(b, n, 3, device="cuda")
        plan = score_plan(n, bf16)

        def launch():
            rc = fn(pos.data_ptr(), node.data_ptr(), edge.data_ptr(), mask.data_ptr(),
                    packed.data_ptr(), offsets, len(layout), out.data_ptr(), b, n, 1, 2, 2,
                    int(bf16), plan["cluster"], plan["dests"], plan["smem"], stream(pos))
            assert rc == 0, rc

        print_phase_stamps(f"K6 B={b} n_max {n} {'bf16' if bf16 else 'f32'} {plan}",
                           phase_stamps(lib, b * plan["cluster"], 32, launch), K6_PHASES)
    lib = phase_library("attn_qk_bank")
    fn = lib.attn_qk_bank_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    for b, n, f, c, bf16 in K8_SHAPES:
        qk, ws = k8_operands(b, n, f, c)
        qk = qk.to(torch.bfloat16 if bf16 else torch.float32)
        out = torch.empty(b, c, n, n, device="cuda")
        fc, smem = fwd_plan(n, f, 32)
        ptrs = _weight_ptrs(ws)

        def launch():
            rc = fn(qk.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(), b, n, f, c, 32, K8_DS,
                    int(bf16), int(bf16), fc, smem, stream(qk))
            assert rc == 0, rc

        print_phase_stamps(f"K8 forward B={b} N={n} F={f} C={c} {'bf16' if bf16 else 'f32'}",
                           phase_stamps(lib, b * c, 8, launch), K8_PHASES)


def times(label: str) -> None:
    from moleculesde_tpu_torch.benchmarks.timing import device_ms
    from moleculesde_tpu_torch.ops.attn_qk_bank import attn_qk_bank
    from moleculesde_tpu_torch.ops.score_kernel import score_eval_fused

    def show(what, fn):
        try:
            fn()   # outside graph capture: a checkout whose kernel takes no such shape raises
        except ValueError as e:
            print(f"{label}: {what}: refused ({e})", flush=True)
            return
        print(f"{label}: {what}: device_ms={device_ms(fn):.4f}", flush=True)

    for b, n in ((64, 32), (64, 64)):
        args = k6_operands(b, n)
        for bf16 in (True, False):
            show(f"K6 B={b} n_max {n} {'bf16' if bf16 else 'f32'}",
                 lambda: score_eval_fused(*args, variant=1, bf16=bf16))
    for b, n, f, c in ((128, 32, 16, 8), (128, 32, 300, 2), (128, 64, 16, 8)):
        qk, ws = k8_operands(b, n, f, c)
        for bf16 in (True, False):
            q = qk.to(torch.bfloat16 if bf16 else torch.float32)
            show(f"K8 forward B={b} N={n} F={f} C={c} {'bf16' if bf16 else 'f32'}",
                 lambda: attn_qk_bank(q, *ws, K8_DS, bf16=bf16))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--times", action="store_true", help="device times through the wrappers")
    p.add_argument("--label", default="this checkout")
    opts = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_score_bank: needs a CUDA device")
    if opts.times:
        times(opts.label)
    else:
        phases()


if __name__ == "__main__":
    main()
