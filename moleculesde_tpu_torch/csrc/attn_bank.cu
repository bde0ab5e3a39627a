// Multi-head tanh attention-map bank of the 3D->2D edge layers (K7):
//   a[b, c, n, m] = (1/H) * sum_h tanh(inv * sum_{a in head h} q[n, a] k[m, a])
// with q, k [B, C, N, A] (f32 or bf16), heads the contiguous ds-wide chunks
// of A (H = A / ds), inv = 1 / sqrt(ds), a [B, C, N, N] f32.
//
// Replaces the Pallas kernel
// moleculesde_tpu/ops/rejected/attn_bank.py::_fwd_kernel (pallas_call at
// l.138) and ::_bwd_kernel (l.157), entry attn_map_bank_pallas (l.200).
//
// Forward.  Each (graph, channel) reads q and k once (2 N A values) and
// writes N*N f32; the work is N*N*A multiply-adds and N*N*H tanh, ~67
// MFLOP at B=128, C=8, N=A=32 against 8.4 MB of traffic (2.5 us at 3.35
// TB/s).  Bound by bytes on paper; in practice by the tanh (the earlier
// kernel, one block per (graph, channel) and a thread per pair, spent
// ~20 instructions of tanhf, two scalar shared-memory loads per
// multiply-add and a divide per pair, and at N = 256, B = 2 filled 16 of
// 132 SMs).  Design:
// - persistent blocks of 128 threads walk units of (graph, channel, 32 x
//   32 tile of the map), so that every shape fills the card (N = 256, B =
//   2: 1024 units), and shared memory does not grow with N (17 KB at A =
//   32: N is capped by nothing but the int32 index);
// - a unit's 32 q rows and 32 k rows are copied in q's dtype by 16-byte
//   cp.async while the previous unit computes, then converted once to f32
//   rows (rounded to bf16 in bf16 mode) laid out for conflict-free 16-byte
//   reads;
// - a thread computes 2 rows x 4 columns: per head, 6 16-byte loads feed
//   32 FMAs (ds = 4), and each row's four outputs leave in one 16-byte
//   store;
// - tanh as 1 - 2 / (1 + e^{2|x|}) on ex2.approx / rcp.approx, two of them
//   sharing one reciprocal (tanh2, ~5e-7 absolute; not tanh.approx.f32).
//   At ~100 instructions and 12 MUFU operations a pair, the MUFU pipe (16
//   results per SM and cycle) and the issue rate bound it about equally:
//   ~3-4 us at B=128, N=32.
// The logits' FMAs run in index order as before; the head sum in head
// order, times 1 / H (exact for the chain's H = 8).

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
// A = 32, H = 8).  512 threads, three blocks an SM:
// faster than 1024 threads at two blocks, whose 32 registers spilled
// (PERF.md, PR 13).  Bound: bytes (q, k, g read, dq, dk written), 3 N*N*A
// multiply-adds per (graph, channel).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <atomic>
#include <stdint.h>

#include "attn_map.cuh"
#include "hopper.cuh"

constexpr int kPhaseSlots = 4;   // PHASE_PROFILE marks per forward block

namespace {

// q, k rows of one (graph, channel) into shared memory, QS words apart (the
// backward)
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

// ---- the forward: persistent blocks over (graph, channel, 32 x 32 tile) ----

constexpr int kFwdThreads = 128;   // 4 warps, each a 16 x 16 quarter of the tile
constexpr int kFwdTile = 32;       // rows and columns of a unit's tile

// t0 = tanh(x0), t1 = tanh(x1) to ~5e-7 absolute, from a0 = 2 |x0| log2(e)
// and a1 (the caller folds 1 / sqrt(ds) into that factor): with d = 1 +
// 2^a, tanh|x| = 1 - 2 / d, and the two share one reciprocal, 1 / d0 =
// d1 / (d0 d1).  2^a by ex2.approx (2^-22 relative), the reciprocal by
// rcp.approx (1 ulp); a is capped at 26 (|x| ~ 9, where tanh is 1 to
// 3e-8), so that d0 d1 stays finite, and a NaN passes through.  Three MUFU
// operations for two tanh, where the accurate tanhf takes ~20 instructions
// for one; tanh.approx.f32 (2^-11 relative) would fail the 1e-4 bar the
// maps are held to in both modes.
__device__ __forceinline__ void tanh2(float x0, float a0, float x1, float a1, float& t0,
                                      float& t1) {
  a0 = a0 > 26.f ? 26.f : a0;
  a1 = a1 > 26.f ? 26.f : a1;
  float e0, e1, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e0) : "f"(a0));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e1) : "f"(a1));
  const float d0 = e0 + 1.f, d1 = e1 + 1.f;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d0 * d1));
  t0 = copysignf(fmaf(-2.f * d1, r, 1.f), x0);
  t1 = copysignf(fmaf(-2.f * d0, r, 1.f), x1);
}

// four values of a staged row as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The q rows [r0, r0 + 32) and k rows [c0, c0 + 32) of map bc (clipped to
// N) into the staging buffers, as they lie in device memory: by 16-byte
// cp.async copies where the rows are 16-byte aligned (vec), else one value
// at a time, synchronously.
template <typename T>
__device__ __forceinline__ void fwd_stage(const T* __restrict__ q, const T* __restrict__ k,
                                          T* sq, T* sk, size_t bc, int r0, int c0, int N,
                                          int A, bool vec) {
  const int nq = (min(kFwdTile, N - r0)) * A, nk = (min(kFwdTile, N - c0)) * A;
  const T* gq = q + (bc * N + r0) * A;
  const T* gk = k + (bc * N + c0) * A;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    for (int i = threadIdx.x * E; i < nq; i += kFwdThreads * E) hopper::cp_async16(sq + i, gq + i, true);
    for (int i = threadIdx.x * E; i < nk; i += kFwdThreads * E) hopper::cp_async16(sk + i, gk + i, true);
  } else {
    for (int i = threadIdx.x; i < nq; i += kFwdThreads) sq[i] = gq[i];
    for (int i = threadIdx.x; i < nk; i += kFwdThreads) sk[i] = gk[i];
  }
}

// acc[i][j] = sum_h tanh(inv * q_h[row i] . k_h[col j]) for the thread's
// 2 rows and 4 columns; q rows at qr[i], k rows at kr[j] (f32, QS-strided
// slots), each head's products as FMAs in index order; c = 2 log2(e) inv.
// V: ds % 4 == 0, four values of a row in one 16-byte load.
template <bool V>
__device__ __forceinline__ void fwd_tile(const float* const (&qr)[2], const float* const (&kr)[4],
                                         float (&acc)[2][4], int H, int ds, float c) {
#pragma unroll 2
  for (int h = 0; h < H; ++h) {
    float u[2][4] = {};
    const int e = (h + 1) * ds;
    if (V) {
      for (int d = h * ds; d < e; d += 4) {
        float4 a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = *reinterpret_cast<const float4*>(qr[i] + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(kr[j] + d);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            u[i][j] = fmaf(a[i].x, b[j].x, u[i][j]);
            u[i][j] = fmaf(a[i].y, b[j].y, u[i][j]);
            u[i][j] = fmaf(a[i].z, b[j].z, u[i][j]);
            u[i][j] = fmaf(a[i].w, b[j].w, u[i][j]);
          }
      }
    } else {
      for (int d = h * ds; d < e; ++d)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = fmaf(qr[i][d], kr[j][d], u[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        float t0, t1;
        tanh2(u[i][j], fabsf(u[i][j]) * c, u[i][j + 1], fabsf(u[i][j + 1]) * c, t0, t1);
        acc[i][j] += t0;
        acc[i][j + 1] += t1;
      }
  }
}

// Persistent blocks walk the units u = blockIdx.x, + gridDim.x, ...: unit u
// is map bc = u / (T T), row tile (u / T) % T, column tile u % T (T = 32-row
// tiles per side).  Shared memory (fwd_words): the staging buffers (32 q
// and 32 k rows in q's dtype, room for f32), then the unit's q rows and k
// rows in f32, QS = row_stride(A) words apart.  A unit's rows are staged
// while the previous unit computes: the staging buffers are free once
// their values are converted.  k rows sit in slot (c % 4) 8 + c / 4, so
// that the four lanes of a row (columns 4 tx + j) read four consecutive
// slots, 16 bytes each, on distinct banks; a thread owns rows
// {16 (w / 2) + ty, + 8} and columns 16 (w % 2) + 4 tx + {0..3} (warp w,
// ty = lane / 4, tx = lane % 4) and stores each row's four values in one
// 16-byte store where the map's rows are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
attn_map_bank_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         float* __restrict__ out, int BC, int N, int A, int ds, int bf16,
                         int vec) {
  extern __shared__ __align__(16) float smem[];
  const int QS = attn_map::row_stride(A), H = A / ds, tiles = (N + kFwdTile - 1) / kFwdTile;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + kFwdTile * A);
  float* qc = smem + 2 * kFwdTile * A;
  float* kc = qc + kFwdTile * QS;
  const long long units = static_cast<long long>(BC) * tiles * tiles;
  // 2 log2(e) / sqrt(ds), rounded once from double
  const float c2 = static_cast<float>(2.0 * 1.4426950408889634 / sqrt(static_cast<double>(ds)));
  const float hinv = 1.f / static_cast<float>(H);
  // the conversion's fast path: A a multiple of 4 whose quads divide the block
  const bool quads = A >= 4 && A % 4 == 0 && kFwdThreads % (A / 4) == 0;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, ty = lane >> 2, tx = lane & 3;
  const int wr = (w >> 1) * 16, wc = (w & 1) * 16;
  const float* qr[2] = {qc + (wr + ty) * QS, qc + (wr + ty + 8) * QS};
  const float* kr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) kr[j] = kc + (8 * j + wc / 4 + tx) * QS;
  auto where = [&](long long u, size_t& bc, int& r0, int& c0) {
    bc = static_cast<size_t>(u / (static_cast<long long>(tiles) * tiles));
    const int t = static_cast<int>(u - static_cast<long long>(bc) * tiles * tiles);
    r0 = (t / tiles) * kFwdTile;
    c0 = (t % tiles) * kFwdTile;
  };
  PHASE_MARK(0);
  long long u = blockIdx.x;
  size_t bc;
  int r0, c0;
  if (u < units) {
    where(u, bc, r0, c0);
    fwd_stage(q, k, sq, sk, bc, r0, c0, N, A, vec != 0);
  }
  for (; u < units; u += gridDim.x) {
    where(u, bc, r0, c0);
    hopper::cp_async_wait_all();
    __syncthreads();   // the staged rows are in; the last unit's reads of qc / kc are done
    PHASE_MARK(1);
    const int nq = min(kFwdTile, N - r0), nk = min(kFwdTile, N - c0);
    if (quads) {   // a thread keeps one quad of columns, four values a step
      const int c4 = 4 * (threadIdx.x % (A / 4));
      for (int r = threadIdx.x / (A / 4); r < kFwdTile; r += kFwdThreads / (A / 4)) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 vq = r < nq ? load4(sq + r * A + c4) : z, vk = r < nk ? load4(sk + r * A + c4) : z;
        if (bf16 && sizeof(T) == 4) {   // bf16 operands are on the grid already
          vq = make_float4(attn_map::round_bf16(vq.x), attn_map::round_bf16(vq.y),
                           attn_map::round_bf16(vq.z), attn_map::round_bf16(vq.w));
          vk = make_float4(attn_map::round_bf16(vk.x), attn_map::round_bf16(vk.y),
                           attn_map::round_bf16(vk.z), attn_map::round_bf16(vk.w));
        }
        *reinterpret_cast<float4*>(qc + r * QS + c4) = vq;
        *reinterpret_cast<float4*>(kc + ((r & 3) * 8 + (r >> 2)) * QS + c4) = vk;
      }
    } else {
      for (int i = threadIdx.x; i < kFwdTile * A; i += kFwdThreads) {
        const int r = i / A, a = i - r * A;
        float vq = r < nq ? attn_map::load(sq, i) : 0.f;
        float vk = r < nk ? attn_map::load(sk, i) : 0.f;
        if (bf16) {
          vq = attn_map::round_bf16(vq);
          vk = attn_map::round_bf16(vk);
        }
        qc[r * QS + a] = vq;
        kc[((r & 3) * 8 + (r >> 2)) * QS + a] = vk;
      }
    }
    __syncthreads();   // qc / kc are written; the staging buffers are free
    if (u + gridDim.x < units) {
      size_t bn;
      int rn, cn;
      where(u + gridDim.x, bn, rn, cn);
      fwd_stage(q, k, sq, sk, bn, rn, cn, N, A, vec != 0);
    }
    PHASE_MARK(2);
    float acc[2][4] = {};
    if (ds % 4 == 0)
      fwd_tile<true>(qr, kr, acc, H, ds, c2);
    else
      fwd_tile<false>(qr, kr, acc, H, ds, c2);
    const int col = c0 + wc + 4 * tx;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + wr + ty + 8 * i;
      if (row >= N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][j] * hinv;
      float* o = out + (bc * N + row) * N + col;
      if (N % 4 == 0 && col + 3 < N) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) o[j] = v[j];
      }
    }
    PHASE_MARK(3);
  }
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

// The plan of a block: rows R of the backward's tile (the forward's
// kFwdTile) and the shared-memory floats: the forward's staging buffers
// and f32 q / k rows of one 32 x 32 tile (fwd_words, whatever N); the
// backward's q and k rows (row_stride(A) words apart), the du tile and dk
// between tiles, R halved from tile_rows until the block fits kSmemLimit
// (or R = 1: then nothing fits).
struct Plan {
  int rows, words;
};

__host__ __device__ inline int fwd_words(int A) {
  return 2 * kFwdTile * (A + attn_map::row_stride(A));
}

Plan make_plan(int N, int A, int H, bool bwd) {
  if (!bwd) return Plan{kFwdTile, fwd_words(A)};
  const int qk = 2 * N * attn_map::row_stride(A);
  auto words = [&](int r) { return qk + attn_map::du_words(N, r, H) + (r < N ? N * A : 0); };
  int r = attn_map::tile_rows(N, H, kDuBudget);
  while (r > 1 && 4 * static_cast<size_t>(words(r)) > kSmemLimit) r /= 2;
  return Plan{r, words(r)};
}

// The forward on min(units, resident) persistent blocks; the blocks an SM
// holds at this shared memory are queried once per instantiation and size.
template <typename T>
int launch_fwd(const void* q, const void* k, float* out, int BC, int N, int A,
               int ds, int bf16, int smem, cudaStream_t s) {
  auto kernel = attn_map_bank_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<long long> resident_for{0};   // smem << 32 | blocks on the card
  long long known = resident_for.load(std::memory_order_relaxed);
  long long all = known & 0xffffffffll;
  if ((known >> 32) != smem) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    all = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    resident_for.store(static_cast<long long>(smem) << 32 | all, std::memory_order_relaxed);
  }
  const long long tiles = (N + kFwdTile - 1) / kFwdTile;
  const long long units = static_cast<long long>(BC) * tiles * tiles;
  const int blocks = static_cast<int>(units < all ? units : all);
  if (blocks == 0) return 0;
  const size_t e = sizeof(T);
  const int vec = (static_cast<size_t>(A) * e) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0;
  kernel<<<blocks, kFwdThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           out, BC, N, A, ds, bf16, vec);
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
// out[0] the backward's row tile R (the forward's 32-row tile), out[1] the
// shared memory in bytes, past kSmemLimit where no plan fits.
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
