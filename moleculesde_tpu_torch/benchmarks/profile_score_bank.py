"""Where the time of K6 (the fused score evaluation), of K7's forward and of
K8 (the q/k-net attention bank), forward and backward, goes on the GPU,
and the device times of K6, K7 and K8.

Phases (the default): builds ``csrc/score_eval.cu``, ``csrc/attn_bank.cu``
and ``csrc/attn_qk_bank.cu`` with ``-DPHASE_PROFILE`` into
``build/profile/`` (the port's ``nvcc`` flags otherwise), where thread 0 of
every block stamps ``%globaltimer`` at the kernels' phase marks, and
launches them through their C entries on seeded operands: K6 at B=64,
n_max 32 in bf16 and f32 mode and at n_max 64 and 128 in bf16 (variant 1,
the fused chain's shapes); K7's forward (A = 32, ds = 4, C = 8) at B=128,
N=32 in bf16 and f32, n_max 128, B=32 and N = 256, B = 2 in bf16: per
persistent block its first unit's copies landing, the conversion of its
rows (and the next unit's copies issued) and the tile with its stores (the
last unit's, where a block takes several); K7's backward at the same
shapes and N = 600, B = 1: per persistent block each phase's time summed
over its chunks (rows landed and converted, logits + du, the unit's dq or,
in a column unit, dk products, dk's where one unit holds the map and the
stores); with ``--old-k7 CHECKOUT`` also the backward of that checkout
(the earlier one block per (graph, channel), marks inserted around its
staging and its map backward into a copy of its source beside it); K8's
forward at B=128, N=32, the 3D->2D chain's edge layers 1-3 (F=16, C=8, bf16)
and 0 (F=300, C=2, f32), with the chain's A = 32 and ds = 4 (8 heads); K8's
backward (staging, the forward's two layers again, the map backward, the
nets' backward, the dW1 / dqk partials) at B=128, N=32 and at n_max 128,
B=32 (F=16, C=8, bf16, and F=300, C=2 at N=32).  Prints, per launch, the span from the first
block's start to the last block's end, the median block duration, the
median time of each phase (between consecutive marks) and the quantiles of
the blocks' start times, which show the waves.  The marks cost a few
instructions; ``chip_smoke.py`` gives the real times.

Device times (``--times``): K6, K7 and K8 through the wrappers of
whichever ``moleculesde_tpu_torch`` is first on the path (so that a parent
checkout can be timed in turns with this one; a shape the checkout's
kernel refuses prints its message): K6 at B=64, n_max 32, 64 and 128,
variants 1 and 2, in bf16 and f32; K8's forward also at N=64; K8's
backward and K7's forward and backward at B=128, N=32 and 64 and at N=128,
B=32 (F=16, C=8, and for K8 F=300, C=2; bf16 and f32), K7's forward and
backward also at C=2 and at N = 256, B = 2 and N = 600, B = 1:
10 calls captured in a CUDA graph, the replays timed with CUDA events
(median of 10), per call (``timing.py``), and the first 16 hex digits of
the SHA-256 of the outputs' bytes, which tell two checkouts' bits apart.
``--times --old-k7 CHECKOUT`` runs that in turns, CHECKOUT / this / this /
CHECKOUT, each a process of its own with its package first on the path.

Numerics (``--numerics``): K8's backward in bf16 on the 3D->2D chain's
edge-layer 0 and 1 operands (``chip_smoke.py``'s, with its cotangents) at
n_max 32 and 64 (B=128) and 128 (B=32): dqk's largest error of max
|plain| and the elements that differ, the kernel against the plain
version on the card, and the plain version on the CPU against the one on
the card (dqk is a bf16 output: an f32 sum in another order can flip its
rounding, by one bf16 ulp, 2^-8 to 2^-7 of the value).

    python -m moleculesde_tpu_torch.benchmarks.profile_score_bank [--old-k7 out/parent]
    python -m moleculesde_tpu_torch.benchmarks.profile_score_bank --times --old-k7 out/parent
    PYTHONPATH=<checkout> python <this file> --times --label parent
    python -m moleculesde_tpu_torch.benchmarks.profile_score_bank --numerics
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

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
K6_SHAPES = ((64, 32, True), (64, 32, False), (64, 64, True), (64, 128, True))
K7_PHASES = ("first unit's rows land", "rows converted, next copies issued", "tile + stores")
K7_BWD_PHASES = ("rows landed + converted", "logits + du", "dq (or dk) products",
                 "dk products (N <= 32) + stores")
K7_OLD_BWD_PHASES = ("staging (f32, a value a thread)", "map backward (row tiles)")
K7_SHAPES = ((128, 32, True), (128, 32, False), (32, 128, True), (2, 256, True))   # C = 8
K7_BWD_SHAPES = K7_SHAPES + ((1, 600, True),)
K7_SLOTS = 5       # csrc/attn_bank.cu::kPhaseSlots
K8_SHAPES = ((128, 32, 16, 8, True), (128, 32, 300, 2, False))
K8_BWD_PHASES = ("W2 + bias copies issued", "layer 1 (qk chunks staged)", "layer 2",
                 "map backward", "nets' backward", "dW1 + dqk partials")
K8_BWD_SHAPES = ((128, 32, 16, 8), (128, 32, 300, 2), (32, 128, 16, 8))
BANK_SHAPES = ((128, 32), (128, 64), (32, 128))   # (B, N) of the device times
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


def k7_operands(b: int, n: int, bf16: bool, c: int = 8, seed: int = 4):
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    q, k = (0.8 * torch.randn(b, c, n, 32, device=dev, generator=gen) for _ in range(2))
    return (q.bfloat16(), k.bfloat16()) if bf16 else (q, k)


def k7_phases(lib) -> None:
    """K7's forward through the C entry of ``lib`` at K7_SHAPES; the shared
    memory the entry checks is asked of the entry's own plan."""
    from moleculesde_tpu_torch.benchmarks.timing import phase_stamps, print_phase_stamps
    from moleculesde_tpu_torch.ops.common import stream

    fn = lib.attn_map_bank_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    plan = lib.attn_bank_plan
    plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for b, n, bf16 in K7_SHAPES:
        q, k = k7_operands(b, n, bf16)
        out = torch.empty(b, 8, n, n, device="cuda")
        got = (ctypes.c_int * 2)()
        plan(n, 32, 8, 0, ctypes.addressof(got))
        smem = got[1]

        def launch():
            rc = fn(q.data_ptr(), k.data_ptr(), out.data_ptr(), b * 8, n, 32, K8_DS,
                    int(bf16), int(bf16), smem, stream(q))
            assert rc == 0, rc

        tiles = -(-n // 32)
        print_phase_stamps(f"K7 forward B={b} N={n} C=8 {'bf16' if bf16 else 'f32'} "
                           f"({smem} B)", phase_stamps(lib, b * 8 * tiles * tiles, K7_SLOTS,
                                                       launch), K7_PHASES)


def k7_bwd_phases(lib, shapes, slots: int, names, title: str = "") -> None:
    """K7's backward through the C entry of ``lib`` at ``shapes``, rows and
    shared memory asked of the entry's own plan (this checkout's units, or
    an earlier checkout's row tile), ``slots`` stamps a block."""
    from moleculesde_tpu_torch.benchmarks.timing import phase_stamps, print_phase_stamps
    from moleculesde_tpu_torch.ops.common import stream

    fn = lib.attn_map_bank_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    plan = lib.attn_bank_plan
    plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for b, n, bf16 in shapes:
        q, k = k7_operands(b, n, bf16)
        g = torch.randn(b, 8, n, n, device="cuda", generator=torch.Generator("cuda").manual_seed(5))
        dq, dk = torch.empty_like(q), torch.empty_like(k)
        got = (ctypes.c_int * 2)()
        plan(n, 32, 8, 1, ctypes.addressof(got))
        rows, smem = got[0], got[1]

        def launch():
            rc = fn(q.data_ptr(), k.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    b * 8, n, 32, K8_DS, int(bf16), int(bf16), rows, smem, stream(q))
            assert rc == 0, rc

        print_phase_stamps(f"K7 backward{title} B={b} N={n} C=8 {'bf16' if bf16 else 'f32'} "
                           f"(rows {rows}, {smem} B)",
                           phase_stamps(lib, 2 * b * 8 * -(-n // 32), slots, launch), names)


def old_k7_bwd_library(checkout: str):
    """The backward of ``checkout`` (an earlier attn_bank.cu: one block per
    (graph, channel), staging then the map backward in row tiles) with
    phase marks inserted around its staging and its map backward, built
    beside its source."""
    from pathlib import Path

    from moleculesde_tpu_torch.benchmarks.timing import phase_library

    csrc = Path(checkout) / "moleculesde_tpu_torch" / "csrc"
    src = (csrc / "attn_bank.cu").read_text()
    stage = "  stage_qk(q + bc * N * A, k + bc * N * A, qs, ks, N, A, QS, bf16);\n  __syncthreads();\n"
    tail = "dk_acc, N, A, ds, R, bf16);\n"
    if stage not in src or tail not in src:
        raise SystemExit(f"--old-k7: {csrc / 'attn_bank.cu'} is not the one-block-per-map backward")
    src = src.replace(stage, "  PHASE_MARK(0);\n" + stage + "  PHASE_MARK(1);\n").replace(
        tail, tail + "  PHASE_MARK(2);\n")
    path = csrc / "attn_bank_old_phases.cu"
    path.write_text(src)
    return phase_library("attn_bank_old", path)


def phases(old_k7: str = "") -> None:
    from moleculesde_tpu_torch.benchmarks.timing import (
        phase_library, phase_stamps, print_phase_stamps)
    from moleculesde_tpu_torch.ops.attn_qk_bank import _weight_ptrs, bwd_plan, fwd_plan
    from moleculesde_tpu_torch.ops.common import stream
    from moleculesde_tpu_torch.ops.score_kernel import (
        score_param_layout, score_plan, score_slab_bytes)

    lib = phase_library("score_eval")
    fn = lib.score_eval_fused
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    layout, _ = score_param_layout(1)
    offsets = (ctypes.c_int * len(layout))(*(o for _, _, o in layout))
    for b, n, bf16 in K6_SHAPES:
        pos, node, edge, mask, packed = k6_operands(b, n)
        out = torch.empty(b, n, 3, device="cuda")
        plan = score_plan(n, bf16)
        slab = torch.empty(max(1, score_slab_bytes(b, n, bf16)), dtype=torch.uint8,
                           device="cuda")

        def launch():
            rc = fn(pos.data_ptr(), node.data_ptr(), edge.data_ptr(), mask.data_ptr(),
                    packed.data_ptr(), offsets, len(layout), out.data_ptr(), slab.data_ptr(),
                    b, n, 1, 2, 2, int(bf16), plan["cluster"], plan["dests"], plan["smem"],
                    stream(pos))
            assert rc == 0, rc

        print_phase_stamps(f"K6 B={b} n_max {n} {'bf16' if bf16 else 'f32'} {plan}",
                           phase_stamps(lib, b * plan["cluster"], 32, launch), K6_PHASES)
    lib = phase_library("attn_bank")
    k7_phases(lib)
    k7_bwd_phases(lib, K7_BWD_SHAPES, K7_SLOTS, K7_BWD_PHASES)
    if old_k7:
        k7_bwd_phases(old_k7_bwd_library(old_k7), K7_SHAPES, 4, K7_OLD_BWD_PHASES,
                      f" ({old_k7})")
    lib = phase_library("attn_qk_bank")
    fn = lib.attn_qk_bank_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2
    for b, n, f, c, bf16 in K8_SHAPES:
        qk, ws = k8_operands(b, n, f, c)
        qk = qk.to(torch.bfloat16 if bf16 else torch.float32)
        out = torch.empty(b, c, n, n, device="cuda")
        fc, smem = fwd_plan(n, f, 32)
        ptrs = _weight_ptrs(ws)

        def launch():
            rc = fn(qk.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(), b, n, f, c, 32, K8_DS,
                    int(bf16), int(bf16), fc, smem, None, stream(qk))
            assert rc == 0, rc

        print_phase_stamps(f"K8 forward B={b} N={n} F={f} C={c} {'bf16' if bf16 else 'f32'}",
                           phase_stamps(lib, b * c, 8, launch), K8_PHASES)
    fn = lib.attn_qk_bank_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2
    for b, n, f, c in K8_BWD_SHAPES:
        qk, ws = k8_operands(b, n, f, c)
        qk = qk.bfloat16()
        g = torch.randn(b, c, n, n, device="cuda")
        dqk = torch.empty_like(qk)
        sizes = sum(w.numel() for w in ws)
        wgrad = torch.empty(sizes, device="cuda")
        part = torch.empty(b * sizes + 2 * b * c * n * f, device="cuda")
        rows, fc, smem = bwd_plan(n, f, 32, 32 // K8_DS)
        ptrs = _weight_ptrs(ws)

        def launch():
            rc = fn(qk.data_ptr(), ctypes.addressof(ptrs), g.data_ptr(), dqk.data_ptr(),
                    wgrad.data_ptr(), part.data_ptr(), b, n, f, c, 32, K8_DS, 1, 1, rows, fc,
                    smem, None, stream(qk))
            assert rc == 0, rc

        print_phase_stamps(f"K8 backward B={b} N={n} F={f} C={c} bf16 (rows {rows}, chunk {fc}, "
                           f"{smem} B)", phase_stamps(lib, b * c, 8, launch), K8_BWD_PHASES)


def times(label: str) -> None:
    from moleculesde_tpu_torch.benchmarks.timing import device_ms
    from moleculesde_tpu_torch.ops.attn_bank import attn_map_bank_kernel, attn_map_bank_kernel_bwd
    from moleculesde_tpu_torch.ops.attn_qk_bank import attn_qk_bank, attn_qk_bank_bwd
    from moleculesde_tpu_torch.ops.score_kernel import score_eval_fused

    def show(what, fn):
        try:
            out = fn()   # outside graph capture: a checkout whose kernel takes no such shape raises
        except ValueError as e:
            print(f"{label}: {what}: refused ({e})", flush=True)
            return
        bits = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            bits.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        print(f"{label}: {what}: device_ms={device_ms(fn):.4f} bits={bits.hexdigest()[:16]}",
              flush=True)

    for b, n in ((64, 32), (64, 64), (64, 128)):
        for variant in (1, 2):
            args = k6_operands(b, n, variant)
            for bf16 in (True, False):
                show(f"K6 B={b} n_max {n} v{variant} {'bf16' if bf16 else 'f32'}",
                     lambda: score_eval_fused(*args, variant=variant, bf16=bf16))
    for b, n, f, c in ((128, 32, 16, 8), (128, 32, 300, 2), (128, 64, 16, 8)):
        qk, ws = k8_operands(b, n, f, c)
        for bf16 in (True, False):
            q = qk.to(torch.bfloat16 if bf16 else torch.float32)
            show(f"K8 forward B={b} N={n} F={f} C={c} {'bf16' if bf16 else 'f32'}",
                 lambda: attn_qk_bank(q, *ws, K8_DS, bf16=bf16))
    dev = torch.device("cuda")
    for b, n in BANK_SHAPES:
        for f, c in ((16, 8), (300, 2)):
            qk, ws = k8_operands(b, n, f, c)
            g = torch.randn(b, c, n, n, device=dev, generator=torch.Generator(dev).manual_seed(3))
            for bf16 in (True, False):
                q = qk.to(torch.bfloat16 if bf16 else torch.float32)
                show(f"K8 backward B={b} N={n} F={f} C={c} {'bf16' if bf16 else 'f32'}",
                     lambda: attn_qk_bank_bwd(q, *ws, g, K8_DS, bf16=bf16))
        g = torch.randn(b, 8, n, n, device=dev, generator=torch.Generator(dev).manual_seed(5))
        for bf16 in (True, False):
            qm, km = k7_operands(b, n, bf16)
            mode = "bf16" if bf16 else "f32"
            show(f"K7 forward B={b} N={n} C=8 {mode}",
                 lambda: attn_map_bank_kernel(qm, km, K8_DS, bf16=bf16))
            show(f"K7 backward B={b} N={n} C=8 {mode}",
                 lambda: attn_map_bank_kernel_bwd(qm, km, g, K8_DS, bf16=bf16))
    for b, n, c in ((128, 32, 2), (128, 64, 2), (32, 128, 2), (2, 256, 8), (1, 600, 8)):
        g = torch.randn(b, c, n, n, device=dev, generator=torch.Generator(dev).manual_seed(5))
        for bf16 in (True, False):
            qm, km = k7_operands(b, n, bf16, c)
            mode = "bf16" if bf16 else "f32"
            show(f"K7 forward B={b} N={n} C={c} {mode}",
                 lambda: attn_map_bank_kernel(qm, km, K8_DS, bf16=bf16))
            show(f"K7 backward B={b} N={n} C={c} {mode}",
                 lambda: attn_map_bank_kernel_bwd(qm, km, g, K8_DS, bf16=bf16))


def numerics() -> None:
    from moleculesde_tpu_torch.benchmarks.profile_sampler_3d2d import chain_bank_operands
    from moleculesde_tpu_torch.ops.attn_qk_bank import attn_qk_bank_bwd, attn_qk_bank_bwd_plain

    dev = torch.device("cuda")

    def diff(x, y):
        x, y = x.float().cpu(), y.float().cpu()
        return (f"{((x - y).abs().max() / y.abs().max()).item():.3e} of max |plain|, "
                f"{int((x != y).sum())} of {y.numel()} elements differ")

    for n_max, b in ((32, 128), (64, 128), (128, 32)):
        for li, ops in enumerate(chain_bank_operands(dev, n_max, b)):
            qd, ws, ds = ops["qk"].bfloat16(), ops["ws"], ops["ds"]
            gen = torch.Generator(device=dev).manual_seed(9 + li)
            g = torch.randn(qd.shape[0], ws[0].shape[0], qd.shape[1], qd.shape[1],
                            generator=gen, device=dev)
            with torch.no_grad():
                kernel = attn_qk_bank_bwd(qd, *ws, g, ds, bf16=True, impl="kernel")[0]
                card = attn_qk_bank_bwd_plain(qd, *ws, g, ds, bf16=True)[0]
                cpu = attn_qk_bank_bwd_plain(qd.cpu(), *(w.cpu() for w in ws), g.cpu(), ds,
                                             bf16=True)[0]
            print(f"K8 backward bf16 dqk, n_max {n_max} B={b} edge layer {li}: kernel vs "
                  f"plain on the card {diff(kernel, card)}; plain on the CPU vs on the card "
                  f"{diff(cpu, card)}", flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--times", action="store_true", help="device times through the wrappers")
    p.add_argument("--numerics", action="store_true", help="K8 backward's bf16 dqk vs plain")
    p.add_argument("--label", default="this checkout")
    p.add_argument("--old-k7", default="", metavar="CHECKOUT",
                   help="also stamp the K7 backward of this (earlier) checkout; with --times, "
                        "time it and this checkout in turns")
    opts = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_score_bank: needs a CUDA device")
    if opts.times and opts.old_k7:
        here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for path, label in ((opts.old_k7, opts.old_k7), (here, "this checkout"), (here, "this checkout"),
                            (opts.old_k7, opts.old_k7)):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--times", "--label", label],
                           env={**os.environ, "PYTHONPATH": os.path.abspath(path)}, check=True)
    elif opts.times:
        times(opts.label)
    elif opts.numerics:
        numerics()
    else:
        phases(opts.old_k7)


if __name__ == "__main__":
    main()
