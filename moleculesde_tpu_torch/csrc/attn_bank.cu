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
// Backward, per (graph, channel): attn_map.cuh's tiled map backward.  A
// tile of R rows recomputes each head's logits and t_h = tanh(inv u_h),
// forms du_h = g * (1 - t_h^2) * (inv / H) (rounded to bf16 in bf16 mode,
// as the TPU kernel rounds it before both products) for its R x N pairs,
// holds them in shared memory (H (R N + 1) words; a thread per 2 x 2
// pairs, q and k rows read 16 bytes at a time), then
//   dq[n, a] = sum_m du_{h(a)}[n, m] k[m, a]   (the tile's rows, stored)
//   dk[m, a] = sum_n du_{h(a)}[n, m] q[n, a]   (the tile's rows added)
// in f32, dk carried between tiles in shared memory ([N, A]) and stored in
// q's dtype after the last.  R is the plan's (attn_bank_plan): the whole
// map at N = 32 (one tile, as the kernel before tiles), 8 rows at N = 128,
// fewer where shared memory runs out; any N whose plan fits (N <= 518 at
// A = 32, H = 8; the forward N <= 880).  512 threads, three blocks an SM:
// faster than 1024 threads at two blocks, whose 32 registers spilled
// (PERF.md, PR 13).  Bound: bytes (q, k, g read, dq, dk written), 3 N*N*A
// multiply-adds per (graph, channel).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>

#include "attn_map.cuh"
#include "hopper.cuh"

namespace {

// q, k rows of one (graph, channel) into shared memory, QS words apart
template <typename T>
__device__ void stage_qk(const T* __restrict__ q, const T* __restrict__ k,
                         float* qs, float* ks, int N, int A, int QS, int bf16) {
  for (int i = threadIdx.x; i < N * A; i += blockDim.x) {
    const int r = i / A, c = i - r * A;
    float qv = attn_map::load(q, i), kv = attn_map::load(k, i);
    if (bf16) {
      qv = attn_map::round_bf16(qv);
      kv = attn_map::round_bf16(kv);
    }
    qs[r * QS + c] = qv;
    ks[r * QS + c] = kv;
  }
}

template <typename T>
__global__ void attn_map_bank_fwd_kernel(const T* __restrict__ q,
                                         const T* __restrict__ k,
                                         float* __restrict__ out, int N,
                                         int A, int ds, int bf16) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [N][A + 1]
  float* ks = qs + N * (A + 1);    // [N][A + 1]
  const size_t bc = blockIdx.x;
  stage_qk(q + bc * N * A, k + bc * N * A, qs, ks, N, A, A + 1, bf16);
  __syncthreads();
  attn_map::forward(qs, ks, out + bc * N * N, N, A, ds);
}

constexpr int kBwdThreads = 512;   // three blocks an SM (40 registers)
constexpr int kDuBudget = 8192;    // words of a row tile's du (attn_map.cuh)

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 3)
attn_map_bank_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const float* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
                         int N, int A, int ds, int R, int bf16) {
  extern __shared__ __align__(16) float smem[];
  const int QS = attn_map::row_stride(A);
  float* qs = smem;                // [N][QS]
  float* ks = qs + N * QS;         // [N][QS]
  float* dus = ks + N * QS;        // [H][R * N + 1]
  float* dk_acc = dus + attn_map::du_words(N, R, A / ds);   // [N][A] when R < N
  const size_t bc = blockIdx.x;
  stage_qk(q + bc * N * A, k + bc * N * A, qs, ks, N, A, QS, bf16);
  __syncthreads();
  attn_map::backward_tiled(qs, ks, g + bc * N * N, dus, dq + bc * N * A, dk + bc * N * A,
                           dk_acc, N, A, ds, R, bf16);
}

// The plan of a block: rows R of the backward's tile (N in the forward,
// which walks the whole map) and the shared-memory floats (q and k rows,
// A + 1 words apart in the forward and row_stride(A) in the backward; the
// du tile; dk between tiles), R halved from tile_rows until the block fits
// kSmemLimit (or R = 1: then nothing fits).
struct Plan {
  int rows, words;
};

Plan make_plan(int N, int A, int H, bool bwd) {
  if (!bwd) return Plan{N, 2 * N * (A + 1)};
  const int qk = 2 * N * attn_map::row_stride(A);
  auto words = [&](int r) { return qk + attn_map::du_words(N, r, H) + (r < N ? N * A : 0); };
  int r = attn_map::tile_rows(N, H, kDuBudget);
  while (r > 1 && 4 * static_cast<size_t>(words(r)) > kSmemLimit) r /= 2;
  return Plan{r, words(r)};
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
               int BC, int N, int A, int ds, int R, int bf16, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_map_bank_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = R * N > N * A ? R * N : N * A;
  const int threads = std::min(attn_map::threads_for(work), kBwdThreads);
  attn_map_bank_bwd_kernel<T><<<BC, threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), g, static_cast<T*>(dq),
      static_cast<T*>(dk), N, A, ds, R, bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan of a forward (bwd = 0) or backward block at these widths:
// out[0] the backward's row tile R (N in the forward), out[1] the shared
// memory in bytes, past kSmemLimit where no plan fits.
// ops/attn_bank.py::plan is the same.
extern "C" void attn_bank_plan(int N, int A, int H, int bwd, int* out) {
  const Plan p = make_plan(N, A, H, bwd != 0);
  out[0] = p.rows;
  out[1] = 4 * p.words;
}

// q, k [BC, N, A] (bf16 if in_bf16, else f32), out [BC, N, N] f32; smem the
// plan's bytes (cudaErrorInvalidValue if it disagrees).  Needs A % ds == 0.
extern "C" int attn_map_bank_fwd(const void* q, const void* k, float* out, int BC,
                                 int N, int A, int ds, int in_bf16, int bf16,
                                 int smem, void* stream) {
  if (smem != 4 * make_plan(N, A, A / ds, false).words)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_fwd<__nv_bfloat16>(q, k, out, BC, N, A, ds, bf16, smem, s)
                 : launch_fwd<float>(q, k, out, BC, N, A, ds, bf16, smem, s);
}

// g [BC, N, N] f32; dq, dk [BC, N, A] in q's dtype; rows and smem the
// plan's (cudaErrorInvalidValue if they disagree).
extern "C" int attn_map_bank_bwd(const void* q, const void* k, const float* g,
                                 void* dq, void* dk, int BC, int N, int A, int ds,
                                 int in_bf16, int bf16, int rows, int smem, void* stream) {
  const Plan p = make_plan(N, A, A / ds, true);
  if (rows != p.rows || smem != 4 * p.words) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16
             ? launch_bwd<__nv_bfloat16>(q, k, g, dq, dk, BC, N, A, ds, rows, bf16, smem, s)
             : launch_bwd<float>(q, k, g, dq, dk, BC, N, A, ds, rows, bf16, smem, s);
}
