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

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

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
