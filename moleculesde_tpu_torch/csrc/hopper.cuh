// What the kernel sources share about the card and its measurement.
//
// kSmemLimit: the dynamic shared memory one block may use on the H100
// (227 KB; ops/common.py::SMEM_LIMIT is the same number for the wrappers'
// launch plans).
//
// PHASE_MARK(k): with -DPHASE_PROFILE (benchmarks/profile_score_bank.py,
// benchmarks/profile_gin_pair.py --phases) thread 0 of each block stamps
// %globaltimer into g_phase[block][k], block the linear index of a 1D or 2D
// grid; set_phase_profile points g_phase at a device buffer (null: no
// stamps).  The including source defines kPhaseSlots, the marks per block.
// Without the flag a mark compiles to nothing.
//
// namespace hopper: the warp-level tensor-core and copy instructions the
// CFConv kernels, K6 and the pair block's two directions issue (mma.sync
// m16n8k16 bf16 -> f32, ldmatrix, cp.async), as inline PTX, and
// mma_gemm, a block's small products on mma.sync with operands read from
// f32 shared memory through accessors (the attention banks' backward).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

constexpr size_t kSmemLimit = 232448;

#ifdef PHASE_PROFILE
__device__ long long* g_phase = nullptr;
extern "C" int set_phase_profile(long long* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, &p, sizeof(p)));
}
#define PHASE_MARK(k)                                                          \
  do {                                                                         \
    if (g_phase && threadIdx.x == 0) {                                         \
      long long t_;                                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \
      g_phase[(blockIdx.y * gridDim.x + blockIdx.x) * kPhaseSlots + (k)] = t_; \
    }                                                                          \
  } while (0)
#else
#define PHASE_MARK(k) ((void)(k))
#endif

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: four (x4) or two (x2) 8x8 b16 matrices from shared memory,
// lane i giving the address of row i % 8 of matrix i / 8 (16-byte
// aligned); _t transposes each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// 16 bytes from device to shared memory, asynchronously; zero-filled where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 16 bytes, asynchronously; only the first ``valid`` of them read, the
// rest zero-filled.
__device__ __forceinline__ void cp_async16n(void* dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid) : "memory");
}

// 8 bytes, asynchronously (both addresses 8-byte aligned); only the first
// ``valid`` of them read, the rest zero-filled.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid) : "memory");
}

// 4 bytes, asynchronously; only the first ``valid`` of them read, the rest
// zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid) : "memory");
}

// This thread's cp.async copies have landed (and are visible to it).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// c += a @ b on the tensor cores: a the m16k16 A fragment (row-major), b
// the k16n8 B fragment (column-major), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two values as the bf16 pair of one fragment register (lo in the low
// half), each rounded to nearest even as __float2bfloat16_rn rounds.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C_t = A_t B_t for t < batches (M x N, depth K) on mma.sync: the block's
// warps take the 16 x 8 tiles of every C_t in turn (tile warp, warp +
// warps, ...: the same warp and lane own an element whenever the shapes
// are the same).  A_t(m, k) = fa(t, m, k) and B_t(k, n) = fb(t, k, n) are
// read as f32 and rounded to bf16 here (the accessors are never called out
// of range, which reads as 0); epi(t, m, n, c) takes each element of C_t
// once its f32 K-sum is done, in the tensor cores' order, the same every
// run.  Needs blockDim.x % 32 == 0; every warp of the block must call it.
template <typename FA, typename FB, typename Epi>
__device__ __forceinline__ void mma_gemm(int batches, int M, int N, int K, FA fa, FB fb,
                                         Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int mt = (M + 15) / 16, nt = (N + 7) / 8, tiles = batches * mt * nt;
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += blockDim.x >> 5) {
    const int bt = tile / (mt * nt), r = tile - bt * mt * nt;
    const int m0 = r / nt * 16, n0 = (r - r / nt * nt) * 8;
    auto a = [&](int m, int k) { return m < M && k < K ? fa(bt, m, k) : 0.f; };
    auto b = [&](int k, int n) { return k < K && n < N ? fb(bt, k, n) : 0.f; };
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int k = k0 + t2;
      const uint32_t af[4] = {pack_bf16(a(m0 + g, k), a(m0 + g, k + 1)),
                              pack_bf16(a(m0 + g + 8, k), a(m0 + g + 8, k + 1)),
                              pack_bf16(a(m0 + g, k + 8), a(m0 + g, k + 9)),
                              pack_bf16(a(m0 + g + 8, k + 8), a(m0 + g + 8, k + 9))};
      const uint32_t bf[2] = {pack_bf16(b(k, n0 + g), b(k + 1, n0 + g)),
                              pack_bf16(b(k + 8, n0 + g), b(k + 9, n0 + g))};
      mma_bf16(c, af, bf);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + (i >> 1) * 8, n = n0 + t2 + (i & 1);
      if (m < M && n < N) epi(bt, m, n, c[i]);
    }
  }
}

}  // namespace hopper
