// The head-mean tanh map of one (graph, channel), shared by K7
// (attn_bank.cu) and K8 (attn_qk_bank.cu):
//   a[n, m] = (1/H) * sum_h tanh(inv * sum_{a in head h} q[n, a] k[m, a])
// with heads the contiguous ds-wide chunks of A (H = A / ds) and
// inv = 1 / sqrt(ds), and its backward.  q and k lie in shared memory as
// f32, rows padded to A + 1 words, so the threads of a warp, which read
// different k rows, hit different banks.  tanh is the accurate tanhf, not
// tanh.approx.f32, whose ~2^-11 relative error would break the f32
// agreement with the plain versions.  Every loop strides over the block's
// threads; the callers put the barriers between phases.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace attn_map {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// 1 / sqrt(ds) and 1 / (H sqrt(ds)), each rounded once from double, as the
// plain versions' Python constants are
__device__ __forceinline__ float inv_sqrt(int ds) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(ds)));
}
__device__ __forceinline__ float du_scale(int ds, int H) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(ds)) / H);
}

// a[n, m] into out (N*N values, row-major)
__device__ void forward(const float* qs, const float* ks, float* out, int N,
                        int A, int ds) {
  const int AP = A + 1, H = A / ds;
  const float inv = inv_sqrt(ds);
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    const float* qr = qs + n * AP;
    const float* kr = ks + m * AP;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) {
      float u = 0.f;
      for (int d = h * ds; d < (h + 1) * ds; ++d) u = fmaf(qr[d], kr[d], u);
      acc += tanhf(u * inv);
    }
    out[i] = acc / static_cast<float>(H);
  }
}

// du_h[n, m] = g[n, m] * (1 - t_h^2) * (inv / H), rounded to bf16 when bf16
// is set, for every head, into dus (head stride N*N + 1: the one-word pad
// puts the heads that a warp reads at once on different banks)
__device__ void backward_du(const float* qs, const float* ks, const float* g,
                            float* dus, int N, int A, int ds, int bf16) {
  const int AP = A + 1, H = A / ds, HS = N * N + 1;
  const float inv = inv_sqrt(ds), scale = du_scale(ds, H);
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    const float* qr = qs + n * AP;
    const float* kr = ks + m * AP;
    const float gv = g[i];
    for (int h = 0; h < H; ++h) {
      float u = 0.f;
      for (int d = h * ds; d < (h + 1) * ds; ++d) u = fmaf(qr[d], kr[d], u);
      const float t = tanhf(u * inv);
      const float du = gv * (1.0f - t * t) * scale;
      dus[h * HS + i] = bf16 ? round_bf16(du) : du;
    }
  }
}

// dq[n, a] = sum_m du_{h(a)}[n, m] k[m, a] and dk[m, a] = sum_n du_{h(a)}[n, m]
// q[n, a], f32 sums in index order, stored row-major [N, A] through store()
template <typename T>
__device__ void backward_dqdk(const float* qs, const float* ks, const float* dus,
                              T* dq, T* dk, int N, int A, int ds) {
  const int AP = A + 1, HS = N * N + 1;
  for (int i = threadIdx.x; i < N * A; i += blockDim.x) {
    const int r = i / A, a = i - r * A;
    const float* du = dus + (a / ds) * HS;
    float sq = 0.f, sk = 0.f;
    for (int j = 0; j < N; ++j) {
      sq = fmaf(du[r * N + j], ks[j * AP + a], sq);
      sk = fmaf(du[j * N + r], qs[j * AP + a], sk);
    }
    store(dq, i, sq);
    store(dk, i, sk);
  }
}

inline int threads_for(int work) {
  const int t = ((work + 31) / 32) * 32;
  return t < 1024 ? t : 1024;
}

}  // namespace attn_map
