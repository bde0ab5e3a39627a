"""Where the CFConv kernels' time goes on the GPU, and their device time.

Cycles per tile (the default): first the registers and spills of every
kernel function of ``csrc/cfconv.cu`` (``nvcc -Xptxas -v`` with the port's
flags, names demangled); then it builds the source with
``-DCFCONV_PROFILE`` into ``build/profile/`` (the port's ``nvcc`` flags
otherwise), where thread 0 of every block adds the ``clock64`` cycles
between the kernels' phase marks, and runs K2 and K5 at B=128, N=32 and
N=64, G=51, F=128 (bf16 ea), bf16 and f32 mode.  Forward phases: the wait
for a tile's copies and the vote on its env; a skipped tile; staging (the
ea fix-up, K5's smearing, the next copy's issue); (1) and the softplus;
(2) and its epilogue (the next env / x issue); the out-row sums.  Backward
phases: the copies' wait and (5); the fix-up and next copy's issue; (1);
(2) and its epilogue; dx and (4); (3); the dpre store.  Prints the
CUDA-event time per call and the cycles per tile of each phase (summed over
blocks, divided by the tiles); the forward also the tiles it skipped.  With
two blocks resident per SM (the bf16 forward) a block's cycles per tile
are about twice the SM's.  The instrumented kernels run a little slower
than the real ones; ``chip_smoke.py`` gives the real times.

Device times (``--times``): K2 and K5 forward and backward through the
wrappers of whichever ``moleculesde_tpu_torch`` is first on the path (so
that a parent checkout can be timed in turns with this one), at B=128 N=32,
B=128 N=64 and B=32 N=128, bf16 and f32: 10 calls captured in a CUDA graph,
the replays timed with CUDA events (median of 10), per call -- the method
of ``chip_smoke.py``'s device-time phase (``timing.py``).

Operands, seeded: molecules of 4..N atoms (uniform), env the cutoff
envelope's values (0.5-1) on every pair of distinct atoms -- synthetic
molecules lie inside SchNet's 10 A cutoff whole -- and zero elsewhere.

    python -m moleculesde_tpu_torch.benchmarks.profile_cfconv
    PYTHONPATH=<checkout> python <this file> --times --label parent
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

FWD_PHASES = ("wait + vote", "skipped tile", "staging", "(1) + softplus", "(2) + epilogue",
              "row sums")
BWD_PHASES = ("wait + (5)", "fix-up + issue", "(1)", "(2)", "dx + (4)", "(3)", "dpre store")
PROFILE_BLOCKS = 1024     # kProfileBlocks in the source
SHAPES = ((128, 32), (128, 64), (32, 128))


def operands(b: int, n: int, gdim: int = 51, f: int = 128, seed: int = 0):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    atoms = torch.randint(4, n + 1, (b,), device=dev, generator=gen)
    live = torch.arange(n, device=dev)[None, :] < atoms[:, None]
    pair = live[:, :, None] & live[:, None, :] & ~torch.eye(n, dtype=torch.bool, device=dev)
    env = (0.5 + 0.5 * torch.rand(b, n, n, device=dev, generator=gen)) * pair
    dist = torch.rand(b, n, n, device=dev, generator=gen) * 10.0
    x, g = (torch.randn(b, n, f, device=dev, generator=gen) for _ in range(2))
    w1 = torch.randn(gdim, f, device=dev, generator=gen) / gdim ** 0.5
    w2 = torch.randn(f, f, device=dev, generator=gen) / f ** 0.5
    b1, b2 = (0.1 * torch.randn(f, device=dev, generator=gen) for _ in range(2))
    return dist, env.contiguous(), (x, w1, b1, w2, b2), g


def ptxas_report() -> None:
    """Registers and spill stores per kernel function of ``cfconv.cu`` in
    the kernels' own build (no profile marks)."""
    from moleculesde_tpu_torch.kernels import build

    out = build.BUILD_DIR.parent / "profile"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    text = subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(out / "libcfconv_ptxas.so"),
                           str(build.CSRC_DIR / "cfconv.cu")], check=True, text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          timeout=build.BUILD_TIMEOUT_S).stdout
    stats, current = {}, None
    for ln in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            current = m.group(1)
            stats[current] = {}
        elif current and (m := re.search(r"(\d+) bytes spill stores", ln)):
            stats[current]["spill"] = int(m.group(1))
        elif current and (m := re.search(r"Used (\d+) registers", ln)):
            stats[current]["registers"] = int(m.group(1))
    filt = Path(nvcc).parent / "cu++filt"
    names = list(stats)
    if filt.exists():
        names = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
    for name, st in sorted(zip(names, stats.values())):
        for scope in ("(anonymous namespace)::", "<unnamed>::", "(int)", "void "):
            name = name.replace(scope, "")
        short = name.split("(")[0]
        print(f"ptxas {short}: {st.get('registers')} registers, {st.get('spill', 0)} B spill "
              "stores", flush=True)


def build_library() -> ctypes.CDLL:
    from moleculesde_tpu_torch.kernels import build

    out = build.BUILD_DIR.parent / "profile"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("cfconv.cu", "partials.cuh"):
        shutil.copy(build.CSRC_DIR / name, out / name)
    lib = out / "libcfconv_phases.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DCFCONV_PROFILE", "-o", str(lib),
                    str(out / "cfconv.cu")], check=True, capture_output=True,
                   timeout=build.BUILD_TIMEOUT_S)
    return ctypes.CDLL(str(lib))


def _phase_cycles(lib, call, reps: int) -> tuple:
    """Run ``call`` (a launch returning the C entry's code) 3 times, reset
    the clocks, run it ``reps`` times; returns (per-slot sums over blocks,
    ms per call by CUDA events)."""
    from moleculesde_tpu_torch.kernels import build

    for _ in range(3):
        build.check_launch(call(), "profiled launch")
    torch.cuda.synchronize()
    lib.cfconv_phase_reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (PROFILE_BLOCKS * 16))()
    lib.cfconv_phase_read(buf)
    slots = np.array(buf, dtype=np.float64).reshape(PROFILE_BLOCKS, 16).sum(axis=0)
    return slots, start.elapsed_time(end) / reps


def run_forward(lib, b: int, n: int, bf16: bool, rbf: bool, reps: int = 20) -> None:
    from moleculesde_tpu_torch.ops.cfconv import fwd_plan, smear, smear_constants

    dist, env, params, _ = operands(b, n)
    gdim, f = params[1].shape
    out = torch.empty(b, n, f, device=dist.device)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dist.device).multi_processor_count
    ptrs = [t.data_ptr() for t in (env, *params, out)]
    if rbf:
        fn = lib.cfconv_rbf_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        args = [dist.data_ptr(), *ptrs, b, n, gdim, f, *smear_constants(0.0, 10.0, gdim),
                int(bf16), sms, stream]
        pair_bytes = 4
    else:
        ea = smear(dist, 0.0, 10.0, gdim).to(torch.bfloat16).contiguous()
        fn = lib.cfconv_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        args = [ea.data_ptr(), *ptrs, b, n, gdim, f, 1, int(bf16), sms, stream]
        pair_bytes = 2 * gdim
    plan = fwd_plan(n, gdim, f, bf16, pair_bytes)
    slots, ms = _phase_cycles(lib, lambda: fn(*args), reps)
    tiles = b * plan["tiles"] * plan["chunks"] * reps
    skipped = slots[15]
    live = tiles - skipped
    per_live = [slots[8 + k] / max(live, 1) for k in (2, 3, 4, 5)]
    print(f"forward {'K5' if rbf else 'K2'} B={b} N={n} {'bf16' if bf16 else 'f32'}: "
          f"{ms:.4f} ms per call (events, instrumented); {tiles // reps} tiles per call, "
          f"{skipped / tiles:.3f} skipped; cycles per tile (all tiles): wait + vote "
          f"{slots[8] / tiles:.0f}; per skipped tile {slots[9] / max(skipped, 1):.0f}; per "
          "live tile: " + ", ".join(f"{p} {c:.0f}" for p, c in zip(FWD_PHASES[2:], per_live))
          + f"; total per tile {slots[8:14].sum() / tiles:.0f}", flush=True)


def run_backward(lib, b: int, n: int, bf16: bool, reps: int = 20) -> None:
    from moleculesde_tpu_torch.ops.cfconv import bwd_plan, smear

    dist, env, params, g = operands(b, n)
    x, w1 = params[0], params[1]
    gdim, f = w1.shape
    ea = smear(dist, 0.0, 10.0, gdim).to(torch.bfloat16).contiguous()
    dev = x.device
    plan = bwd_plan(n, gdim, f, bf16, 2 * gdim)
    blocks = min(torch.cuda.get_device_properties(dev).multi_processor_count,
                 b * plan["tiles"], PROFILE_BLOCKS)
    outs = [torch.empty(s, device=dev) for s in ((b, n, f), (gdim, f), (f,), (f, f), (f,))]
    part = torch.empty(blocks * (gdim * f + f * f + 2 * f), device=dev)
    fn = lib.cfconv_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    args = ([t.data_ptr() for t in (ea, env, *params, g, *outs, part)]
            + [b, n, gdim, f, 1, int(bf16), blocks, torch.cuda.current_stream().cuda_stream])
    slots, ms = _phase_cycles(lib, lambda: fn(*args), reps)
    tiles = b * plan["tiles"] * plan["chunks"] * reps
    print(f"backward K2 B={b} N={n} {'bf16' if bf16 else 'f32'}: {ms:.4f} ms per call "
          f"(events, instrumented), {blocks} blocks; cycles per tile: "
          + ", ".join(f"{p} {c / tiles:.0f}" for p, c in zip(BWD_PHASES, slots[:7]))
          + f"; total {slots[:7].sum() / tiles:.0f}", flush=True)


def times(label: str) -> None:
    from moleculesde_tpu_torch.benchmarks.timing import device_ms
    from moleculesde_tpu_torch.ops.cfconv import (
        fused_cfconv, fused_cfconv_bwd, fused_cfconv_rbf, fused_cfconv_rbf_bwd, smear)

    for b, n in SHAPES:
        dist, env, params, g = operands(b, n)
        gdim = params[1].shape[0]
        kw = dict(start=0.0, stop=10.0, num_gaussians=gdim)
        for bf16 in (True, False):
            ea = smear(dist, 0.0, 10.0, gdim)
            ea = (ea.to(torch.bfloat16) if bf16 else ea).contiguous()
            runs = {
                "K2 fwd": lambda: fused_cfconv(ea, env, *params, bf16=bf16, impl="kernel"),
                "K5 fwd": lambda: fused_cfconv_rbf(dist, env, *params, bf16=bf16,
                                                   impl="kernel", **kw),
                "K2 bwd": lambda: fused_cfconv_bwd(ea, env, *params, g, bf16=bf16,
                                                   impl="kernel"),
                "K5 bwd": lambda: fused_cfconv_rbf_bwd(dist, env, *params, g, bf16=bf16,
                                                       impl="kernel", **kw)}
            with torch.no_grad():
                line = ", ".join(f"{name} {device_ms(run):.4f}" for name, run in runs.items())
            print(f"[{label}] B={b} N={n} {'bf16' if bf16 else 'f32'} device_ms: {line}",
                  flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--times", action="store_true",
                        help="device ms through the wrappers instead of cycles per tile")
    parser.add_argument("--label", default="this checkout", help="tag of the --times lines")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_cfconv: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0), flush=True)
    if args.times:
        times(args.label)
        return
    ptxas_report()
    lib = build_library()
    for n in (32, 64):
        for bf16 in (True, False):
            for rbf in (False, True):
                run_forward(lib, 128, n, bf16, rbf)
            run_backward(lib, 128, n, bf16)


if __name__ == "__main__":
    main()
