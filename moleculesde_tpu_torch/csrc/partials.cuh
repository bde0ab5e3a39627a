// Fixed-order reduction of per-block partial sums, shared by the backward
// kernels whose weight gradients are batch-wide sums.
//
//   out[m] = sum_{p = 0 .. P-1} part[p, m]      (part [P, M] f32, out [M] f32)
//
// The callers' P is a batch of graphs or a grid of persistent blocks (a
// hundred and more rows).  A block owns 32 neighbouring outputs: each of its
// kSplit warps adds a contiguous range of the rows in row order (a lane an
// output, so a warp reads 128-byte runs), and warp 0 adds the warps' sums in
// warp order.  A fixed order, so the result is the same bit for bit on every
// run (a float atomicAdd would make it depend on block scheduling), with
// kSplit loads in flight per output where one thread per output has one.

#pragma once

#include <cuda_runtime.h>

namespace partials {

constexpr int kSplit = 8;

__global__ void sum_rows_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int P, int M) {
  __shared__ float sums[kSplit][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int m = blockIdx.x * 32 + lane;
  const int per = (P + kSplit - 1) / kSplit;
  const int p1 = min(P, (w + 1) * per);
  float acc = 0.f;
  if (m < M) {
#pragma unroll 8
    for (int p = w * per; p < p1; ++p) acc += part[static_cast<size_t>(p) * M + m];
  }
  sums[w][lane] = acc;
  __syncthreads();
  if (w == 0 && m < M) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) v += sums[r][lane];
    out[m] = v;
  }
}

inline void sum_rows(const float* part, float* out, int P, int M,
                     cudaStream_t stream) {
  if (M <= 0) return;
  sum_rows_kernel<<<(M + 31) / 32, 32 * kSplit, 0, stream>>>(part, out, P, M);
}

}  // namespace partials
