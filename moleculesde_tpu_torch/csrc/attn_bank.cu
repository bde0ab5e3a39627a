// Multi-head tanh attention-map bank of the 3D->2D edge layers (K7):
//   a[b, c, n, m] = (1/H) * sum_h tanh(inv * sum_{a in head h} q[n, a] k[m, a])
// with q, k [B, C, N, A] (f32 or bf16), heads the contiguous ds-wide chunks
// of A (H = A / ds), inv = 1 / sqrt(ds), a [B, C, N, N] f32.
//
// Replaces the Pallas kernel
// moleculesde_tpu/ops/rejected/attn_bank.py::_fwd_kernel (pallas_call at
// l.138) and ::_bwd_kernel (l.157), entry attn_map_bank_pallas (l.200).
//
// Bound: bytes.  Each (graph, channel) reads q and k once (2 N A values)
// and writes N*N f32; the work is N*N*A multiply-adds and N*N*H tanh, ~67
// MFLOP at B=128, C=8, N=A=32 against 8.4 MB of traffic (2.5 us at 3.35
// TB/s).  Design: one block per (graph, channel), a thread per (n, m); q
// and k are staged in shared memory as f32 (attn_map.cuh) and the per-head
// logits live in registers only.
//
// The TPU verdict ("rejected") does not carry over.  On the TPU the kernel
// lost end to end because q and k arrived channel-major, so its
// [B, C, N, A] operands forced relayout copies at the pallas_call boundary,
// and the call blocked XLA's fusion of the producers.  Here PyTorch runs
// eagerly, the operands are already contiguous [B, C, N, A], and the chain
// around the bank is bound by its launch count, which one launch in place
// of the eager bank's einsum, scale, tanh and mean cuts.
//
// bf16 != 0 reproduces the TPU kernel's bf16 mode: q and k are rounded to
// bf16 (a no-op when they arrive in bf16), the logits accumulate in f32 and
// tanh and the head mean run in f32.
//
// Backward, per (graph, channel): recompute each head's logits and
// t_h = tanh(inv u_h), form du_h = g * (1 - t_h^2) * (inv / H) (rounded to
// bf16 in bf16 mode, as the TPU kernel rounds it before both products),
// keep all H heads' du in shared memory (H (N*N + 1) words, 32 KB at H=8,
// N=32), then
//   dq[n, a] = sum_m du_{h(a)}[n, m] k[m, a]
//   dk[m, a] = sum_n du_{h(a)}[n, m] q[n, a]
// in f32, stored in q's dtype.  Bound: bytes (q, k, g read, dq, dk
// written), 3 N*N*A multiply-adds per (graph, channel).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attn_map.cuh"

namespace {

// q, k rows of one (graph, channel) into shared memory, stride A + 1
template <typename T>
__device__ void stage_qk(const T* __restrict__ q, const T* __restrict__ k,
                         float* qs, float* ks, int N, int A, int bf16) {
  const int AP = A + 1;
  for (int i = threadIdx.x; i < N * A; i += blockDim.x) {
    const int r = i / A, c = i - r * A;
    float qv = attn_map::load(q, i), kv = attn_map::load(k, i);
    if (bf16) {
      qv = attn_map::round_bf16(qv);
      kv = attn_map::round_bf16(kv);
    }
    qs[r * AP + c] = qv;
    ks[r * AP + c] = kv;
  }
}

template <typename T>
__global__ void attn_map_bank_fwd_kernel(const T* __restrict__ q,
                                         const T* __restrict__ k,
                                         float* __restrict__ out, int N,
                                         int A, int ds, int bf16) {
  extern __shared__ float smem[];
  float* qs = smem;                // [N][A + 1]
  float* ks = qs + N * (A + 1);    // [N][A + 1]
  const size_t bc = blockIdx.x;
  stage_qk(q + bc * N * A, k + bc * N * A, qs, ks, N, A, bf16);
  __syncthreads();
  attn_map::forward(qs, ks, out + bc * N * N, N, A, ds);
}

template <typename T>
__global__ void attn_map_bank_bwd_kernel(const T* __restrict__ q,
                                         const T* __restrict__ k,
                                         const float* __restrict__ g,
                                         T* __restrict__ dq, T* __restrict__ dk,
                                         int N, int A, int ds, int bf16) {
  extern __shared__ float smem[];
  float* qs = smem;                // [N][A + 1]
  float* ks = qs + N * (A + 1);    // [N][A + 1]
  float* dus = ks + N * (A + 1);   // [H][N * N + 1]
  const size_t bc = blockIdx.x;
  stage_qk(q + bc * N * A, k + bc * N * A, qs, ks, N, A, bf16);
  __syncthreads();
  attn_map::backward_du(qs, ks, g + bc * N * N, dus, N, A, ds, bf16);
  __syncthreads();
  attn_map::backward_dqdk(qs, ks, dus, dq + bc * N * A, dk + bc * N * A, N, A, ds);
}

template <typename T>
int launch_fwd(const void* q, const void* k, float* out, int BC, int N, int A,
               int ds, int bf16, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_map_bank_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_map_bank_fwd_kernel<T><<<BC, attn_map::threads_for(N * N), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), out, N, A, ds, bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const float* g, void* dq, void* dk,
               int BC, int N, int A, int ds, int bf16, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_map_bank_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = N * N > N * A ? N * N : N * A;
  attn_map_bank_bwd_kernel<T><<<BC, attn_map::threads_for(work), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), g, static_cast<T*>(dq),
      static_cast<T*>(dk), N, A, ds, bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k [BC, N, A] (bf16 if in_bf16, else f32), out [BC, N, N] f32; smem is
// the wrapper's count of the block's shared memory (2 N (A + 1) floats).
// Needs N <= 32 and A % ds == 0.
extern "C" int attn_map_bank_fwd(const void* q, const void* k, float* out, int BC,
                                 int N, int A, int ds, int in_bf16, int bf16,
                                 int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_fwd<__nv_bfloat16>(q, k, out, BC, N, A, ds, bf16, smem, s)
                 : launch_fwd<float>(q, k, out, BC, N, A, ds, bf16, smem, s);
}

// g [BC, N, N] f32; dq, dk [BC, N, A] in q's dtype; smem = (2 N (A + 1) +
// H (N*N + 1)) floats.
extern "C" int attn_map_bank_bwd(const void* q, const void* k, const float* g,
                                 void* dq, void* dk, int BC, int N, int A, int ds,
                                 int in_bf16, int bf16, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16
             ? launch_bwd<__nv_bfloat16>(q, k, g, dq, dk, BC, N, A, ds, bf16, smem, s)
             : launch_bwd<float>(q, k, g, dq, dk, BC, N, A, ds, bf16, smem, s);
}
