// Fixed-order reduction of per-block partial sums, shared by the backward
// kernels whose weight gradients are batch-wide sums.
//
//   out[m] = sum_{p = 0 .. P-1} part[p, m]      (part [P, M] f32, out [M] f32)
//
// Each thread owns one output element and adds the P partials in index
// order, so the result is the same bit for bit on every run (a float
// atomicAdd would make it depend on block scheduling).  Neighbouring threads
// read neighbouring words of each partial row.

#pragma once

#include <cuda_runtime.h>

namespace partials {

constexpr int kThreads = 256;

__global__ void sum_rows_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int P, int M) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) acc += part[static_cast<size_t>(p) * M + m];
  out[m] = acc;
}

inline void sum_rows(const float* part, float* out, int P, int M,
                     cudaStream_t stream) {
  if (M <= 0) return;
  sum_rows_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, out, P, M);
}

}  // namespace partials
