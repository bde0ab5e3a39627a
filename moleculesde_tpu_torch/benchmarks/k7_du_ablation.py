"""K7's backward with du as the kernel computes it (the accurate tanhf,
then 1 - t^2, as ``torch.tanh`` in the plain version) against du from
1 - t^2 = 4 e / (1 + e)^2, e = 2^(2 |x| log2 e), on ex2.approx /
rcp.approx with two values sharing one reciprocal (1.5 MUFU operations a
value): the second is a patched copy of ``csrc/attn_bank.cu``, built into
``build/ablation/``.  For each: dq / dk's largest error of max |plain|,
the elements that differ from the plain version, and the device time (a
replayed CUDA graph, ``timing.py``), in bf16 and f32 mode, on seeded
operands (A = 32, ds = 4, C = 8) and on the 3D->2D chain's edge-layer
operands with ``chip_smoke.py``'s cotangents.  In bf16 mode du is rounded
to bf16 before both products, so a du a few ulps off the plain version's
rounds to the other neighbour more often.

    python -m moleculesde_tpu_torch.benchmarks.k7_du_ablation
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

TANHF = """#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = tanhf(u[i][j] * inv);
        s[j] = gv[i][j] * (1.0f - t * t) * scale;
        if (bf16) s[j] = attn_map::round_bf16(s[j]);
      }"""
SECH2 = """float e[4];
      const float c = inv * 2.8853900817779268f;   // 2 log2(e) / sqrt(ds)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = fminf(fabsf(u[i][j]) * c, 26.f);
        asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e[j]) : "f"(a));
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const float d0 = e[j] + 1.f, d1 = e[j + 1] + 1.f;
        float r;
        asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d0 * d1));
        const float r0 = d1 * r, r1 = d0 * r;
        s[j] = 4.f * e[j] * (r0 * r0);
        s[j + 1] = 4.f * e[j + 1] * (r1 * r1);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = gv[i][j] * s[j] * scale;
        if (bf16) s[j] = attn_map::round_bf16(s[j]);
      }"""


def sech2_library() -> ctypes.CDLL:
    from moleculesde_tpu_torch.kernels import build

    src = (build.CSRC_DIR / "attn_bank.cu").read_text()
    if TANHF not in src:
        raise SystemExit("k7_du_ablation: csrc/attn_bank.cu's du loop is not the one this "
                         "script patches")
    out = build.BUILD_DIR.parent / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    path, lib = out / "attn_bank_sech2.cu", out / "libattn_bank_sech2.so"
    path.write_text(src.replace(TANHF, SECH2))
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o",
                    str(lib), str(path)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def backward(lib, q, k, g, ds: int, bf16: bool):
    from moleculesde_tpu_torch.ops.attn_bank import plan
    from moleculesde_tpu_torch.ops.common import stream

    b, c, n, a = q.shape
    rows, smem, _ = plan(n, a, a // ds, True, groups=1)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    fn = lib.attn_map_bank_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), b * c, n,
            a, ds, int(q.dtype == torch.bfloat16), int(bf16), rows, smem, stream(q))
    if rc:
        raise RuntimeError(f"attn_map_bank_bwd: CUDA error {rc}")
    return dq, dk


def compare(libs, label: str, q, k, g, ds: int, bf16: bool) -> None:
    from moleculesde_tpu_torch.benchmarks.timing import device_ms
    from moleculesde_tpu_torch.ops.attn_bank import attn_map_bank_bwd_plain

    ref = attn_map_bank_bwd_plain(q, k, g, ds, bf16=bf16)
    cols = []
    for name, lib in libs.items():
        out = backward(lib, q, k, g, ds, bf16)
        err = [((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
               for x, y in zip(out, ref)]
        differ = [int((x != y).sum()) for x, y in zip(out, ref)]
        ms = device_ms(lambda: backward(lib, q, k, g, ds, bf16))
        cols.append(f"{name}: dq / dk {err[0]:.3e} / {err[1]:.3e} of max |plain|, "
                    f"{differ[0]} / {differ[1]} elements differ, device_ms={ms:.4f}")
    print(f"{label} {'bf16' if bf16 else 'f32'}: " + " | ".join(cols), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k7_du_ablation: needs a CUDA device")
    from moleculesde_tpu_torch.benchmarks.profile_sampler_3d2d import chain_bank_operands
    from moleculesde_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = {"tanhf": build.load("attn_bank"), "4e/(1+e)^2": sech2_library()}
    for b, n, seed in ((128, 32, 23), (32, 128, 23), (2, 256, 17), (1, 600, 19)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q32, k32 = (0.8 * torch.randn(b, 8, n, 32, device=dev, generator=gen) for _ in range(2))
        g = torch.randn(b, 8, n, n, device=dev, generator=gen)
        for bf16 in (True, False):
            q, k = (q32.bfloat16(), k32.bfloat16()) if bf16 else (q32, k32)
            compare(libs, f"seeded B={b} N={n} C=8", q, k, g, 4, bf16)
    for n_max, b in ((32, 128), (64, 128), (128, 32)):
        for li, ops in enumerate(chain_bank_operands(dev, n_max, b)):
            gen = torch.Generator(device=dev).manual_seed(9 + li)
            q = ops["q"]
            g = torch.randn(q.shape[:3] + (q.shape[2],), generator=gen, device=dev)
            for bf16 in (True, False):
                qm, km = (ops["q"], ops["k"]) if bf16 else (ops["q32"], ops["k32"])
                compare(libs, f"chain n_max {n_max} B={b} edge layer {li}", qm, km, g,
                        ops["ds"], bf16)


if __name__ == "__main__":
    main()
