"""Where the CFConv backward kernel's time goes, phase by phase, on the GPU.

Writes a copy of ``csrc/cfconv.cu`` whose backward kernel sums, in thread 0
of every block, the ``clock64`` cycles between its phase boundaries (the
copies' wait and (5); the ea fix-up and next copy's issue; product (1);
(2) and its epilogue; dx and (4); (3); the dpre store), builds it into
``build/profile/`` with the port's ``nvcc`` flags, and runs K2's backward
at B=128, N=32 and N=64, G=51, F=128 (bf16 ea), bf16 and f32 mode, on
seeded random operands.  Prints the CUDA-event time per call and the
cycles per tile of each phase (summed over blocks and divided by the
tiles).  The instrumented kernel runs a little slower than the real one;
``chip_smoke.py`` gives the real times.  The phase boundaries are found by
their source text, so an edit of the kernel that moves them makes this
script stop with the boundary it could not find.

    python -m moleculesde_tpu_torch.benchmarks.profile_cfconv_bwd
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import torch

from moleculesde_tpu_torch.kernels import build
from moleculesde_tpu_torch.ops.cfconv import bwd_plan

PHASES = ("wait + (5)", "fix-up + issue", "(1)", "(2)", "dx + (4)", "(3)", "dpre store")
# (source text, phase index, where the mark goes relative to the text)
MARKS = (
    ("    __syncthreads();  // this tile's copies landed; the previous tile's (5) has "
     "read eas\n", 0, "after"),
    ("    if (tau + 1 < ntiles) issue_ea(tau + 1);\n", 1, "after"),
    ("    __syncthreads();\n\n    // (2) wf = s @ W2 + b2", 2, "mid"),
    ("    if (tau + 1 < ntiles) issue_env_gx(tau + 1);\n", 3, "after"),
    ("    // (3) ds = dwf @ W2^T, dpre = ds * sigma\n", 4, "before"),
    ("    __syncthreads();  // (4) has read s\n", 5, "after"),
    ("    __syncthreads();\n\n    // (5) dW1 += ea^T @ dpre\n", 6, "mid"),
)
MAX_BLOCKS = 1024


def instrumented_source() -> str:
    src = (build.CSRC_DIR / "cfconv.cu").read_text()
    for text, k, where in MARKS:
        if src.count(text) != 1:
            raise RuntimeError(f"phase boundary {k} not found once in cfconv.cu: {text!r}")
        mark = f"    PH({k});\n"
        if where == "after":
            src = src.replace(text, text + mark)
        elif where == "before":
            src = src.replace(text, mark + text)
        else:
            head, tail = text.split("\n\n", 1)
            src = src.replace(text, head + "\n" + mark + "\n" + tail)
    anchor = "  const int units = B * P.tiles;\n"
    src = src.replace(anchor, anchor + "  unsigned long long last_clk = clock64();\n")
    src = src.replace("namespace {\n", f"""namespace {{
__device__ unsigned long long g_phase[{MAX_BLOCKS} * 8];
#define PH(k) do {{ if (threadIdx.x == 0) {{ unsigned long long c_ = clock64(); \\
  g_phase[blockIdx.x * 8 + (k)] += c_ - last_clk; last_clk = c_; }} }} while (0)
""", 1)
    return src + f"""
extern "C" int cfconv_phase_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}}
extern "C" int cfconv_phase_reset() {{
  static unsigned long long zeros[{MAX_BLOCKS} * 8];
  return (int)cudaMemcpyToSymbol(g_phase, zeros, sizeof(zeros));
}}
"""


def build_library() -> ctypes.CDLL:
    out = build.BUILD_DIR.parent / "profile"
    out.mkdir(parents=True, exist_ok=True)
    (out / "cfconv_phases.cu").write_text(instrumented_source())
    shutil.copy(build.CSRC_DIR / "partials.cuh", out / "partials.cuh")
    lib = out / "libcfconv_phases.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "cfconv_phases.cu")], check=True, capture_output=True,
                   timeout=build.BUILD_TIMEOUT_S)
    return ctypes.CDLL(str(lib))


def run(lib, b: int, n: int, gdim: int, f: int, bf16: bool, reps: int = 20) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ea = torch.rand(b, n, n, gdim, device=dev, generator=gen).to(torch.bfloat16)
    env = torch.rand(b, n, n, device=dev, generator=gen)
    x, g = (torch.randn(b, n, f, device=dev, generator=gen) for _ in range(2))
    w1 = torch.randn(gdim, f, device=dev, generator=gen) / gdim ** 0.5
    w2 = torch.randn(f, f, device=dev, generator=gen) / f ** 0.5
    b1, b2 = torch.zeros(f, device=dev), torch.zeros(f, device=dev)
    plan = bwd_plan(n, gdim, f, bf16, 2 * gdim)
    blocks = min(torch.cuda.get_device_properties(dev).multi_processor_count,
                 b * plan["tiles"], MAX_BLOCKS)
    outs = [torch.empty(s, device=dev) for s in ((b, n, f), (gdim, f), (f,), (f, f), (f,))]
    part = torch.empty(blocks * (gdim * f + f * f + 2 * f), device=dev)
    fn = lib.cfconv_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    args = ([t.data_ptr() for t in (ea, env, x, w1, b1, w2, b2, g, *outs, part)]
            + [b, n, gdim, f, 1, int(bf16), blocks, torch.cuda.current_stream().cuda_stream])
    for _ in range(3):
        build.check_launch(fn(*args), "cfconv_bwd")
    torch.cuda.synchronize()
    lib.cfconv_phase_reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
    lib.cfconv_phase_read(buf)
    cycles = np.array(buf, dtype=np.float64).reshape(MAX_BLOCKS, 8)[:blocks, :7].sum(axis=0)
    tiles = b * plan["tiles"] * plan["chunks"] * reps
    print(f"B={b} N={n} G={gdim} F={f} {'bf16' if bf16 else 'f32'}: "
          f"{start.elapsed_time(end) / reps:.4f} ms per call (events, instrumented), "
          f"{blocks} blocks; cycles per tile: "
          + ", ".join(f"{p} {c / tiles:.0f}" for p, c in zip(PHASES, cycles))
          + f"; total {cycles.sum() / tiles:.0f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_cfconv_bwd: needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    lib = build_library()
    for n in (32, 64):
        for bf16 in (True, False):
            run(lib, 128, n, 51, 128, bf16)


if __name__ == "__main__":
    main()
