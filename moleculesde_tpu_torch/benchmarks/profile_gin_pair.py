"""Device times of K1's forward and backward (the GIN message block) and of
K3's and K4's forward and backward (the pair block) at the pretraining
step's operands, for parent / change turns on the GPU.

K1's operands are GIN layer 0's of the pretraining CLI's models (random
weights from seed 42) on its synthetic molecules, padded ingest: n_max 32
and 64 at B=128, n_max 128 at B=32, each with e_max = 4 n_max; K3's and
K4's are seeded normal draws at C = 300, H = 32 (their time does not depend
on the values) at the same three (N, B).  The cotangents are
seeded normal draws.  Times come through the wrappers of whichever
``moleculesde_tpu_torch`` is first on the path, so a parent checkout can be
timed in turns with this one: 10 calls captured in a CUDA graph, the
replays timed with CUDA events (median of 10), per call (``timing.py``).
A shape the checkout's kernel refuses prints its message.

``--phases``: K1's and K3's sources built with ``-DPHASE_PROFILE`` into
``build/profile/`` and their kernels launched through their C entries at
the same operands in bf16 mode; thread 0 of every block stamps
``%globaltimer``: K1's forward and backward after the staging, the sort,
the walk (and the backward after the dtable sum over the node ranges);
K3's and K4's forward (persistent blocks) after staging W, once the first
unit's rows landed, after the first unit, once the last unit's rows landed
and at the end; K3's backward after staging a, after each of the first
three stages of g, after the last and at the end.  ``timing.py`` prints the span, median
block time, phase medians and the quantiles of the blocks' start times
(the waves), as it does for K6 in ``profile_score_bank.py``.

    python -m moleculesde_tpu_torch.benchmarks.profile_gin_pair [--phases]
    PYTHONPATH=<checkout> python <this file> --label parent
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

K1_SHAPES = ((32, 128), (64, 128), (128, 32))      # (n_max, B)
PAIR_SHAPES = ((32, 128), (64, 128), (128, 32))     # (N, B)


def k1_operands(n_max: int, batch: int, dev):
    """GIN layer 0's message-block operands on the CLI's first batch."""
    from moleculesde_tpu_torch.benchmarks.profile_pretrain import (
        PATH_ARGS, parse_path, path_batches)
    from moleculesde_tpu_torch.examples import pretrain as cli

    args = parse_path(PATH_ARGS + ["--n_max", str(n_max), "--batch_size", str(batch)],
                      batches=1)
    gb = path_batches(args, dev)[0]
    _, models, _, _ = cli.setup(args, dev)
    m2d = models["model_2D"]
    with torch.no_grad():
        ops = m2d.GINConv_0.message_inputs(m2d.AtomEncoder_0(gb.atom_feats), gb)
    return tuple(t.detach() for t in ops)


def pair_operands(n: int, batch: int, dev, c: int = 300, h: int = 32):
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(batch, n, c, device=dev, generator=gen)
    cc = torch.randn(batch, n, c, device=dev, generator=gen)
    w = torch.randn(c, h, device=dev, generator=gen) / c ** 0.5
    g = torch.randn(batch, n, n, h, device=dev, generator=gen)
    return a, cc, w, g, g.reshape(batch, n * n, h).transpose(1, 2).contiguous()


def _time(device_ms, run) -> str:
    """Device ms of ``run``, or the message of the wrapper's refusal (raised
    by its first call, before any capture)."""
    with torch.no_grad():
        try:
            run()
        except ValueError as e:
            return f"refused ({e})"
        return f"{device_ms(run):.4f}"


def times(label: str) -> None:
    from moleculesde_tpu_torch.benchmarks.timing import device_ms
    from moleculesde_tpu_torch.ops.gin_messages import gin_messages, gin_messages_bwd
    from moleculesde_tpu_torch.ops.pair_block import (
        pair_relu_project, pair_relu_project_bwd, pair_relu_project_cm,
        pair_relu_project_cm_bwd)

    dev = torch.device("cuda")
    modes = (("bf16", True), ("f32", False))
    for n_max, b in K1_SHAPES:
        x, src, dst, boh, table = k1_operands(n_max, b, dev)
        g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
        valid = int(((dst >= 0) & (dst < n_max)).sum())
        fwd = ", ".join(
            f"{mode} " + _time(device_ms, lambda bf16=bf16: gin_messages(
                x, src, dst, boh, table, bf16=bf16, impl="kernel"))
            for mode, bf16 in modes)
        bwd = ", ".join(
            f"{mode} " + _time(device_ms, lambda bf16=bf16: gin_messages_bwd(
                x, src, dst, boh, table, g, bf16=bf16, impl="kernel"))
            for mode, bf16 in modes)
        print(f"[{label}] K1 B={b} n_max={n_max} E={src.shape[1]} ({valid} valid edges) "
              f"device_ms: fwd {fwd}; bwd {bwd}", flush=True)
    for n, b in PAIR_SHAPES:
        a, cc, w, g, g_cm = pair_operands(n, b, dev)
        bias = torch.zeros(w.shape[1], device=dev)
        runs = (("K3 fwd", lambda bf16: pair_relu_project(a, cc, w, bias, bf16=bf16,
                                                            impl="kernel")),
                ("K4 fwd", lambda bf16: pair_relu_project_cm(a, cc, w, bf16=bf16, impl="kernel")),
                ("K3 bwd", lambda bf16: pair_relu_project_bwd(a, cc, w, g, bf16=bf16,
                                                                impl="kernel")),
                ("K4 bwd", lambda bf16: pair_relu_project_cm_bwd(a, cc, w, g_cm, bf16=bf16,
                                                                   impl="kernel")))
        line = ", ".join(f"{name} {mode} " + _time(device_ms, lambda fn=fn, bf16=bf16: fn(bf16))
                         for name, fn in runs for mode, bf16 in modes)
        print(f"[{label}] pair B={b} N={n} C=300 H=32 device_ms: {line}", flush=True)


K1_BWD_PHASES = ("staging", "sort", "walk", "dtable sum")
K1_FWD_PHASES = ("staging", "sort", "walk")
PAIR_FWD_PHASES = ("W staging", "first unit's rows", "first unit", "units to the last's rows",
                   "last unit")
PAIR_BWD_PHASES = ("a staging", "stage 0", "stage 1", "stage 2", "stages 3 on", "dW, db, da out")


def phases(label: str) -> None:
    import ctypes

    from moleculesde_tpu_torch.benchmarks.timing import (
        phase_library, phase_stamps, print_phase_stamps)
    from moleculesde_tpu_torch.kernels import build
    from moleculesde_tpu_torch.ops.common import stream
    from moleculesde_tpu_torch.ops.gin_messages import bwd_plan, fwd_plan
    from moleculesde_tpu_torch.ops.pair_block import bwd_plan as pair_plan
    from moleculesde_tpu_torch.ops.pair_block import fwd_plan_kernel

    lib = phase_library("gin_messages")
    fwd = lib.gin_messages_fwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    bwd = lib.gin_messages_bwd
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    dev = torch.device("cuda")
    for n_max, b in K1_SHAPES:
        x, src, dst, boh, table = k1_operands(n_max, b, dev)
        g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)
        d, f = table.shape
        out = torch.empty_like(x)
        dx = torch.empty_like(x)
        dtable = torch.empty_like(table)
        part = torch.empty((b, d, f), device=dev)

        def launch_fwd():
            build.check_launch(fwd(x.data_ptr(), src.data_ptr(), dst.data_ptr(), boh.data_ptr(),
                                   table.data_ptr(), out.data_ptr(), b, n_max, src.shape[1], d,
                                   f, 1, 0, None, stream(x)), "gin_messages_fwd")

        def launch_bwd():
            build.check_launch(bwd(x.data_ptr(), src.data_ptr(), dst.data_ptr(), boh.data_ptr(),
                                   table.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                   dtable.data_ptr(), part.data_ptr(), b, n_max, src.shape[1],
                                   d, f, 1, 0, None, stream(x)), "gin_messages_bwd")

        plan = fwd_plan(n_max, src.shape[1], d, f)
        stamps = phase_stamps(lib, b * plan["chunks"], 8, launch_fwd)
        print_phase_stamps(f"[{label}] K1 fwd B={b} n_max={n_max} bf16 {plan}", stamps,
                           K1_FWD_PHASES)
        plan = bwd_plan(n_max, src.shape[1], d, f)
        stamps = phase_stamps(lib, b * plan["chunks"], 8, launch_bwd)
        print_phase_stamps(f"[{label}] K1 bwd B={b} n_max={n_max} bf16 {plan}", stamps,
                           K1_BWD_PHASES)
        # warp 0's first edge groups (blocks whose warp 0 walks three or more)
        walked = stamps[(stamps[:, 5] > 0) & (stamps[:, 6] > 0) & (stamps[:, 7] > 0)]
        if len(walked):
            print("  warp 0 edge groups, medians us: sort end to group 1 "
                  f"{np.median(walked[:, 5] - walked[:, 2]) / 1e3:.2f}, group 1 to 2 "
                  f"{np.median(walked[:, 6] - walked[:, 5]) / 1e3:.2f}, group 2 to 3 "
                  f"{np.median(walked[:, 7] - walked[:, 6]) / 1e3:.2f} ({len(walked)} blocks)",
                  flush=True)

    lib = phase_library("pair_block")
    pfwd = {False: lib.pair_relu_project_fwd, True: lib.pair_relu_project_cm_fwd}
    pfwd[False].argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    pfwd[True].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, b in PAIR_SHAPES:
        a, cc, w, _, _ = pair_operands(n, b, dev)
        c, h = w.shape
        bias = torch.zeros(h, device=dev)
        for cm in (False, True):
            out = torch.empty((b, h, n * n) if cm else (b, n, n, h), device=dev)
            ptrs = ((a, cc, w, out) if cm else (a, cc, w, bias, out))

            def launch_fwd_pair():
                build.check_launch(pfwd[cm](*(t.data_ptr() for t in ptrs), b, n, c, h, 1, sms,
                                            stream(a)), "pair_relu_project_fwd")

            plan = fwd_plan_kernel(n, c, h, True, cm=cm)
            units = b * -(-n // 16) * -(-n // plan["ts"])
            blocks = min(units, plan["resident"])
            stamps = phase_stamps(lib, blocks, 8, launch_fwd_pair)
            print_phase_stamps(f"[{label}] {'K4' if cm else 'K3'} fwd B={b} N={n} bf16 {plan}, "
                               f"{units} units on {blocks} blocks", stamps, PAIR_FWD_PHASES)
    pbwd = lib.pair_relu_project_bwd
    pbwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for n, b in PAIR_SHAPES:
        a, cc, w, g, _ = pair_operands(n, b, dev)
        c, h = w.shape
        da, dc = torch.empty_like(a), torch.empty_like(a)
        dw, db = torch.empty_like(w), torch.empty(h, device=dev)
        dw_part, db_part = torch.empty((b, c, h), device=dev), torch.empty((b, h), device=dev)

        def launch_pair():
            build.check_launch(pbwd(a.data_ptr(), cc.data_ptr(), w.data_ptr(), g.data_ptr(),
                                    da.data_ptr(), dc.data_ptr(), dw.data_ptr(), db.data_ptr(),
                                    dw_part.data_ptr(), db_part.data_ptr(), None, b, n, c, h, 1,
                                    stream(a)), "pair_relu_project_bwd")

        plan = pair_plan(n, c)
        stamps = phase_stamps(lib, b * plan["chunks"], 8, launch_pair)
        print_phase_stamps(f"[{label}] K3 bwd B={b} N={n} bf16 {plan}", stamps, PAIR_BWD_PHASES)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="this checkout", help="tag of the lines")
    parser.add_argument("--phases", action="store_true",
                        help="K1's forward and backward, K3's and K4's forward and K3's "
                             "backward block time by phase (-DPHASE_PROFILE builds)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gin_pair: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0), flush=True)
    if args.phases:
        phases(args.label)
        return
    times(args.label)


if __name__ == "__main__":
    main()
