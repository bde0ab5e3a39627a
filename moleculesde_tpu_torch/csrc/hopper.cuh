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
// m16n8k16 bf16 -> f32, ldmatrix, cp.async), as inline PTX.

#pragma once

#include <cuda_runtime.h>
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

}  // namespace hopper
