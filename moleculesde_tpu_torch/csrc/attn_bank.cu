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
// Backward: persistent blocks of 128 threads walk units of (graph,
// channel, 32-row tile), as the forward walks its tiles.  A unit holds its
// 32 rows (f32) and loops over the map's 32-column chunks; each chunk's 32
// rows of the other operand arrive by 16-byte cp.async, and each thread's
// g by a register load, while the previous chunk computes.  Per chunk:
//   du_h[n, m] = g[n, m] * (1 - t_h^2) * (inv / H), t_h = tanh(inv u_h)
//                recomputed (2 x 4 pairs a thread, as the forward's tile),
//                rounded to bf16 in bf16 mode (the TPU kernel rounds it
//                before both products), every head's 32 x 32 in shared
//                memory, each head padded against bank conflicts;
//   dq[n, a]  += sum_m du_{h(a)}[n, m] k[m, a]   (2 rows x 4 features a
//                thread, du and k read 16 bytes at a time; one FMA chain
//                per element over m in index order across the chunks,
//                kept in shared memory between chunks).
// dk[m, a] = sum_n du_{h(a)}[n, m] q[n, a] is the same product on the
// transposed map: where one tile holds the map (N <= 32) its unit also
// runs dk's chains (4 columns x 2 features a thread); past that a second
// set of units, (graph, channel, 32 columns), holds k's rows and streams
// q's, recomputing du, so that dk too is one FMA chain per element over n
// in index order.  Partial sums of the row tiles, added in a second pass,
// were tried first (PERF.md): they took dk further from the plain
// version's sums, and in bf16 mode at N = 600 one more rounding flip left
// the 3e-3 bar.  t is the accurate tanhf, the same bits as torch.tanh on
// the card (bwd_du says why no cheaper 1 - t^2 without t).  No atomics:
// two runs give the same bits.  Shared memory depends on A and H, not on N
// (54,400 B at A = 32, H = 8, four blocks an SM): N is capped by nothing
// but the int32 index.  Bound: bytes (q, k, g read, dq, dk written) or the
// 3 N*N*A multiply-adds per (graph, channel); in practice the issue of the
// products' FMAs and shared-memory loads and du's tanhf.  The products
// stay FMAs in index order, off the tensor cores: see attn_map.cuh's
// header (K8's bf16 output on mma.sync).

// The grouped plan, where A is too wide for a block's shared memory (the
// forward past A = 448, the backward past A = 304 at H = 8): the forward's
// unit walks A in column slices of at most 128 (the logits of a head that
// spans two slices continue across them; the next slice is staged while
// this one computes), so that every slicing gives the bits of the whole
// row; the backward runs K8's tiled map backward (attn_map.cuh's
// map_dqk_kernel: units of (map, 32-row tile, head, 32-feature slice),
// the same chains in the same order as the block backward, so its bits).
// Shared memory then depends on neither N nor A: any A with A % ds == 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <stdint.h>

#include "attn_map.cuh"
#include "hopper.cuh"

// PHASE_PROFILE slots per block: the forward marks 0-3; the backward's
// block writes its start and its running phase totals in 0-4 (Laps)
constexpr int kPhaseSlots = 5;

namespace {

// ---- what both directions share: persistent blocks over 32-row units ----

constexpr int kThreads = 128;   // 4 warps, each a 16 x 16 quarter of a 32 x 32 tile
constexpr int kTile = 32;       // rows (and columns) of a unit's tile

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

// The rows [r0, r0 + 32) of map bc of x (clipped to N) into the staging
// buffer s, as they lie in device memory: by 16-byte cp.async copies where
// the rows are 16-byte aligned (vec), else one value at a time,
// synchronously.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, T* s, size_t bc, int r0,
                                           int N, int A, bool vec) {
  const int n = min(kTile, N - r0) * A;
  const T* gx = x + (bc * N + r0) * A;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    for (int i = threadIdx.x * E; i < n; i += kThreads * E) hopper::cp_async16(s + i, gx + i, true);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) s[i] = gx[i];
  }
}

// Columns [a0, a0 + w) of the rows [r0, r0 + 32) of map bc of x (clipped to
// N) into the staging buffer s, w values a row: 16-byte cp.async copies
// where the slice's rows are 16-byte aligned (vec), else one value at a
// time, synchronously.
template <typename T>
__device__ __forceinline__ void stage_cols(const T* __restrict__ x, T* s, size_t bc, int r0,
                                           int N, int A, int a0, int w, bool vec) {
  const int rows = min(kTile, N - r0);
  const T* gx = x + (bc * N + r0) * A + a0;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per = w / E;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = (i - r * per) * E;
      hopper::cp_async16(s + r * w + c, gx + static_cast<size_t>(r) * A + c, true);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += kThreads) {
      const int r = i / w, c = i - r * w;
      s[i] = gx[static_cast<size_t>(r) * A + c];
    }
  }
}

// k rows sit in slot (c % 4) 8 + c / 4 of a tile, so that the four lanes of
// a row (columns 4 tx + j) read four consecutive slots
__host__ __device__ __forceinline__ int kslot(int c) { return (c & 3) * 8 + (c >> 2); }

// The staged rows as f32, rounded to bf16 in bf16 mode (bf16 operands are
// on the grid already), QS words a row: sq's nq valid rows into qc in row
// order (unless sq is null) and sk's nk into kc in k's slots, in one pass;
// rows past the valid ones read as 0.  A quad of columns a step where A is
// a multiple of 4 whose quads divide the block.
template <typename T>
__device__ __forceinline__ void convert_rows(const T* sq, float* qc, int nq, const T* sk,
                                             float* kc, int nk, int A, int QS, int bf16) {
  if (A >= 4 && A % 4 == 0 && kThreads % (A / 4) == 0) {
    const int c4 = 4 * (threadIdx.x % (A / 4));
    auto quad = [&](const T* s, int r, int n) {
      float4 v = r < n ? load4(s + r * A + c4) : make_float4(0.f, 0.f, 0.f, 0.f);
      if (bf16 && sizeof(T) == 4)
        v = make_float4(attn_map::round_bf16(v.x), attn_map::round_bf16(v.y),
                        attn_map::round_bf16(v.z), attn_map::round_bf16(v.w));
      return v;
    };
    for (int r = threadIdx.x / (A / 4); r < kTile; r += kThreads / (A / 4)) {
      if (sq) *reinterpret_cast<float4*>(qc + r * QS + c4) = quad(sq, r, nq);
      *reinterpret_cast<float4*>(kc + kslot(r) * QS + c4) = quad(sk, r, nk);
    }
  } else {
    auto one = [&](const T* s, int i, int r, int n) {
      const float v = r < n ? attn_map::load(s, i) : 0.f;
      return bf16 ? attn_map::round_bf16(v) : v;
    };
    for (int i = threadIdx.x; i < kTile * A; i += kThreads) {
      const int r = i / A, a = i - r * A;
      if (sq) qc[r * QS + a] = one(sq, i, r, nq);
      kc[kslot(r) * QS + a] = one(sk, i, r, nk);
    }
  }
}

// u[i][j] = q_h[row i] . k_h[col j] for head h = d0 / ds of the thread's 2
// rows and 4 columns; q rows at qr[i], k rows at kr[j] (f32, QS-strided
// slots), the products as FMAs in index order.  V: ds % 4 == 0, four
// values of a row in one 16-byte load.
template <bool V>
__device__ __forceinline__ void logits_add(const float* const (&qr)[2],
                                           const float* const (&kr)[4], float (&u)[2][4],
                                           int d0, int e);

template <bool V>
__device__ __forceinline__ void head_logits(const float* const (&qr)[2],
                                            const float* const (&kr)[4], float (&u)[2][4],
                                            int d0, int ds) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
  logits_add<V>(qr, kr, u, d0, d0 + ds);
}

// u[i][j] += q[row i][d] k[col j][d] for d in [d0, e), as FMAs in index
// order (head_logits's chain, continued where a head spans slices)
template <bool V>
__device__ __forceinline__ void logits_add(const float* const (&qr)[2],
                                           const float* const (&kr)[4], float (&u)[2][4],
                                           int d0, int e) {
  if (V) {
    for (int d = d0; d < e; d += 4) {
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
    for (int d = d0; d < e; ++d)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] = fmaf(qr[i][d], kr[j][d], u[i][j]);
  }
}

// The blocks an SM holds of kernel at smem bytes, times the SMs: queried
// once per instantiation and size (cache: smem << 32 | blocks on the card)
template <typename K>
cudaError_t resident_blocks(K kernel, int smem, std::atomic<long long>& cache, long long& all) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const long long known = cache.load(std::memory_order_relaxed);
  all = known & 0xffffffffll;
  if ((known >> 32) != smem) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    all = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    cache.store(static_cast<long long>(smem) << 32 | all, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// ---- the forward: persistent blocks over (graph, channel, 32 x 32 tile) ----

// acc[i][j] = sum_h tanh(inv * q_h[row i] . k_h[col j]) for the thread's
// 2 rows and 4 columns (head_logits); c = 2 log2(e) inv.
template <bool V>
__device__ __forceinline__ void fwd_tile(const float* const (&qr)[2], const float* const (&kr)[4],
                                         float (&acc)[2][4], int H, int ds, float c) {
#pragma unroll 2
  for (int h = 0; h < H; ++h) {
    float u[2][4];
    head_logits<V>(qr, kr, u, h * ds, ds);
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

// A column slice [a0, a0 + w) of the forward's tile (G > 1): each head's
// logits continue in uo across slices (its FMA chain in index order), and
// a head that ends in this slice adds its tanh to acc, in head order, as
// fwd_tile; the slice's columns are staged from column 0.
template <bool V>
__device__ __forceinline__ void fwd_slice(const float* const (&qr)[2], const float* const (&kr)[4],
                                          float (&uo)[2][4], float (&acc)[2][4], int a0, int w,
                                          int ds, float c) {
  for (int a = a0; a < a0 + w;) {
    const int end = (a / ds + 1) * ds, e = min(a0 + w, end);
    logits_add<V>(qr, kr, uo, a - a0, e - a0);
    if (e == end) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          float t0, t1;
          tanh2(uo[i][j], fabsf(uo[i][j]) * c, uo[i][j + 1], fabsf(uo[i][j + 1]) * c, t0, t1);
          acc[i][j] += t0;
          acc[i][j + 1] += t1;
          uo[i][j] = 0.f;
          uo[i][j + 1] = 0.f;
        }
    }
    a = e;
  }
}

// Persistent blocks walk the units u = blockIdx.x, + gridDim.x, ...: unit u
// is map bc = u / (T T), row tile (u / T) % T, column tile u % T (T = 32-row
// tiles per side).  Shared memory (fwd_words): the staging buffers (32 q
// and 32 k rows in q's dtype, room for f32), then the unit's q rows and k
// rows in f32, QS = row_stride(A) words apart.  A unit's rows are staged
// while the previous unit computes: the staging buffers are free once
// their values are converted.  k rows sit in their slots (kslot), so that
// the four lanes of a row read four consecutive slots, 16 bytes each, on
// distinct banks; a thread owns rows {16 (w / 2) + ty, + 8} and columns
// 16 (w % 2) + 4 tx + {0..3} (warp w, ty = lane / 4, tx = lane % 4) and
// stores each row's four values in one 16-byte store where the map's rows
// are 16-byte aligned.  Where A is wider than a unit's shared memory takes
// (the grouped plan), the unit walks A in G column slices of W (the last
// narrower), staged and converted one at a time, the next slice (or the
// next unit's first) staged while this one computes; the logits of a head
// that spans slices continue across them (fwd_slice), so that every forced
// slicing gives the bits of G = 1.  SLICED: the grouped plan's
// instantiation (the block plan's is the whole row, W = A, G = 1).
template <typename T, bool SLICED>
__global__ void __launch_bounds__(kThreads)
attn_map_bank_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         float* __restrict__ out, int BC, int N, int A, int ds, int bf16,
                         int vec, int W) {
  extern __shared__ __align__(16) float smem[];
  const int QS = attn_map::row_stride(W), H = A / ds, tiles = (N + kTile - 1) / kTile;
  const int G = SLICED ? (A + W - 1) / W : 1;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + kTile * W);
  float* qc = smem + 2 * kTile * W;
  float* kc = qc + kTile * QS;
  const long long units = static_cast<long long>(BC) * tiles * tiles;
  // 2 log2(e) / sqrt(ds), rounded once from double
  const float c2 = static_cast<float>(2.0 * 1.4426950408889634 / sqrt(static_cast<double>(ds)));
  const float hinv = 1.f / static_cast<float>(H);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, ty = lane >> 2, tx = lane & 3;
  const int wr = (w >> 1) * 16, wc = (w & 1) * 16;
  const float* qr[2] = {qc + (wr + ty) * QS, qc + (wr + ty + 8) * QS};
  const float* kr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) kr[j] = kc + (8 * j + wc / 4 + tx) * QS;
  auto where = [&](long long u, size_t& bc, int& r0, int& c0) {
    bc = static_cast<size_t>(u / (static_cast<long long>(tiles) * tiles));
    const int t = static_cast<int>(u - static_cast<long long>(bc) * tiles * tiles);
    r0 = (t / tiles) * kTile;
    c0 = (t % tiles) * kTile;
  };
  // slice g of unit u (the whole rows in the block plan): 16-byte copies
  // where the slice's rows stay aligned
  auto stage = [&](long long u, int g) {
    size_t bc;
    int r0, c0;
    where(u, bc, r0, c0);
    if constexpr (!SLICED) {
      stage_rows(q, sq, bc, r0, N, A, vec != 0);
      stage_rows(k, sk, bc, c0, N, A, vec != 0);
    } else {
      const int a0 = g * W, sw = min(W, A - a0);
      const bool v = vec != 0 && (a0 * sizeof(T)) % 16 == 0 && (sw * sizeof(T)) % 16 == 0;
      stage_cols(q, sq, bc, r0, N, A, a0, sw, v);
      stage_cols(k, sk, bc, c0, N, A, a0, sw, v);
    }
  };
  PHASE_MARK(0);
  long long u = blockIdx.x;
  if (u < units) stage(u, 0);
  for (; u < units; u += gridDim.x) {
    size_t bc;
    int r0, c0;
    where(u, bc, r0, c0);
    float acc[2][4] = {}, uo[2][4] = {};
    for (int g = 0; g < G; ++g) {
      const int a0 = g * W, sw = SLICED ? min(W, A - a0) : A;   // the slice's columns
      hopper::cp_async_wait_all();
      __syncthreads();   // the staged rows are in; the last slice's reads of qc / kc are done
      PHASE_MARK(1);
      convert_rows(sq, qc, min(kTile, N - r0), sk, kc, min(kTile, N - c0), sw, QS, bf16);
      __syncthreads();   // qc / kc are written; the staging buffers are free
      if (g + 1 < G)
        stage(u, g + 1);
      else if (u + gridDim.x < units)
        stage(u + gridDim.x, 0);
      PHASE_MARK(2);
      if constexpr (!SLICED) {
        if (ds % 4 == 0)
          fwd_tile<true>(qr, kr, acc, H, ds, c2);
        else
          fwd_tile<false>(qr, kr, acc, H, ds, c2);
      } else if (ds % 4 == 0) {
        fwd_slice<true>(qr, kr, uo, acc, a0, sw, ds, c2);
      } else {
        fwd_slice<false>(qr, kr, uo, acc, a0, sw, ds, c2);
      }
    }
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

// ---- the backward: persistent blocks over (graph, channel, 32-row tile) ----

constexpr int kDuHead = kTile * kTile + 4;   // one head's du, 32 x 32: 4 banks past the last

// With -DPHASE_PROFILE each thread times the phases of its chunks (one lap
// closes phase k) and thread 0 writes the block's start and its running
// totals at the end, so that consecutive slots differ by each phase's time
// summed over the block's chunks; otherwise nothing.
struct Laps {
#ifdef PHASE_PROFILE
  long long start, last, sum[4];
  __device__ static long long now() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ Laps() : sum{0, 0, 0, 0} { start = last = now(); }
  __device__ void lap(int k) {
    const long long t = now();
    sum[k] += t - last;
    last = t;
  }
  __device__ void write() const {
    if (!g_phase || threadIdx.x != 0) return;
    long long* p = g_phase + static_cast<size_t>(blockIdx.x) * kPhaseSlots;
    p[0] = start;
    for (int k = 0; k < 4; ++k) p[k + 1] = p[k] + sum[k];
  }
#else
  __device__ void lap(int) {}
  __device__ void write() const {}
#endif
};

// g of the thread's 2 rows x 4 columns of a chunk into registers (zero past
// N): held rows r[i], chunk columns c + j, g[r, c + j] for a row unit and
// g[c + j, r] for a column unit; a 16-byte load a row where N % 4 == 0 and
// g is 16-byte aligned (vec).
__device__ __forceinline__ void load_g(const float* __restrict__ gm, const int (&r)[2], int c,
                                       int N, bool col, bool vec, float (&gv)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!col && vec && r[i] < N && c + 3 < N) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(gm + static_cast<size_t>(r[i]) * N + c));
      gv[i][0] = v.x, gv[i][1] = v.y, gv[i][2] = v.z, gv[i][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t at = col ? static_cast<size_t>(c + j) * N + r[i]
                              : static_cast<size_t>(r[i]) * N + c + j;
        gv[i][j] = r[i] < N && c + j < N ? __ldg(gm + at) : 0.f;
      }
    }
  }
}

// du of the thread's 2 rows and 4 columns for every head into dus (head h
// at h kDuHead, row r at 32 r, one 16-byte store a row and head):
// g gv, t = tanhf(inv u), du = g (1 - t^2) scale (scale = inv / H),
// rounded to bf16 in bf16 mode.  The accurate tanhf, as torch.tanh on the
// card, and not 4 e / (1 + e)^2 on ex2 / rcp.approx (1.5 MUFU operations a
// value, 11-15% less time): that is as accurate, but 1 - t^2 then lacks
// the plain version's rounding of t, and in bf16 mode far more values of
// du round to the other bf16 neighbour, which took dk to 3.6e-3 of max
// |plain| on the 3D->2D chain's operands at n_max 128, past the 3e-3 bar
// (benchmarks/k7_du_ablation.py builds that form beside this one).
template <bool V>
__device__ __forceinline__ void bwd_du(const float* const (&qr)[2], const float* const (&kr)[4],
                                       const float (&gv)[2][4], float* const (&dr)[2], int H,
                                       int ds, float inv, float scale, int bf16) {
#pragma unroll 2
  for (int h = 0; h < H; ++h) {
    float u[2][4];
    head_logits<V>(qr, kr, u, h * ds, ds);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = tanhf(u[i][j] * inv);
        s[j] = gv[i][j] * (1.0f - t * t) * scale;
        if (bf16) s[j] = attn_map::round_bf16(s[j]);
      }
      *reinterpret_cast<float4*>(dr[i] + h * kDuHead) = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
}

// dq of the unit's rows, continued over this chunk's nk columns: V, a
// thread per 2 rows (p, p + 16) x 4 features, du rows and k slots read 16
// bytes at a time; else a thread per element.  The chains live in dqs
// ([32, A] f32; first: they start at 0) between chunks, each owned by one
// thread in every chunk.
template <bool V>
__device__ __forceinline__ void bwd_dq(const float* dus, const float* kc, float* dqs, int nk,
                                       int A, int ds, int QS, bool first) {
  if (V) {
    const int nq = A / 4, m4s = (nk + 3) / 4;
    for (int it = threadIdx.x; it < (kTile / 2) * nq; it += kThreads) {
      const int p = it / nq, f = 4 * (it - p * nq);
      const float* d0 = dus + (f / ds) * kDuHead + p * kTile;
      const float* d1 = d0 + (kTile / 2) * kTile;
      float* s0 = dqs + p * A + f;
      float* s1 = s0 + (kTile / 2) * A;
      float4 a0 = first ? make_float4(0.f, 0.f, 0.f, 0.f) : load4(s0);
      float4 a1 = first ? make_float4(0.f, 0.f, 0.f, 0.f) : load4(s1);
#pragma unroll 2
      for (int m4 = 0; m4 < m4s; ++m4) {
        const float4 x0 = load4(d0 + 4 * m4), x1 = load4(d1 + 4 * m4);
        const float w0[4] = {x0.x, x0.y, x0.z, x0.w}, w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kv = load4(kc + (8 * j + m4) * QS + f);
          a0.x = fmaf(w0[j], kv.x, a0.x);
          a0.y = fmaf(w0[j], kv.y, a0.y);
          a0.z = fmaf(w0[j], kv.z, a0.z);
          a0.w = fmaf(w0[j], kv.w, a0.w);
          a1.x = fmaf(w1[j], kv.x, a1.x);
          a1.y = fmaf(w1[j], kv.y, a1.y);
          a1.z = fmaf(w1[j], kv.z, a1.z);
          a1.w = fmaf(w1[j], kv.w, a1.w);
        }
      }
      *reinterpret_cast<float4*>(s0) = a0;
      *reinterpret_cast<float4*>(s1) = a1;
    }
  } else {
    for (int it = threadIdx.x; it < kTile * A; it += kThreads) {
      const int r = it / A, a = it - r * A;
      const float* d = dus + (a / ds) * kDuHead + r * kTile;
      float acc = first ? 0.f : dqs[it];
      for (int m = 0; m < nk; ++m) acc = fmaf(d[m], kc[kslot(m) * QS + a], acc);
      dqs[it] = acc;
    }
  }
}

// dk of this chunk's columns over the unit's nr rows where one unit holds
// the whole map (T = 1), into out (row m at m A): V, a thread per 4
// columns x 2 features, du read 16 bytes and q 8 bytes at a time; else a
// thread per element.  One FMA chain per element over n in index order.
template <bool V, typename T>
__device__ __forceinline__ void bwd_dk(const float* dus, const float* qc, T* out, int nr,
                                       int nk, int A, int ds, int QS) {
  if (V) {
    const int np = A / 2;
    for (int it = threadIdx.x; it < (kTile / 4) * np; it += kThreads) {
      const int mq = it & 7, f = 2 * (it >> 3);
      const float* d = dus + (f / ds) * kDuHead + 4 * mq;
      float acc[4][2] = {};
      for (int n = 0; n < nr; ++n) {
        const float4 x = load4(d + n * kTile);
        const float2 qv = *reinterpret_cast<const float2*>(qc + n * QS + f);
        const float w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] = fmaf(w[j], qv.x, acc[j][0]);
          acc[j][1] = fmaf(w[j], qv.y, acc[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = 4 * mq + j;
        if (m >= nk) break;
        attn_map::store(out, static_cast<size_t>(m) * A + f, acc[j][0]);
        attn_map::store(out, static_cast<size_t>(m) * A + f + 1, acc[j][1]);
      }
    }
  } else {
    for (int it = threadIdx.x; it < kTile * A; it += kThreads) {
      const int m = it / A, a = it - m * A;
      if (m >= nk) continue;
      const float* d = dus + (a / ds) * kDuHead + m;
      float acc = 0.f;
      for (int n = 0; n < nr; ++n) acc = fmaf(d[n * kTile], qc[n * QS + a], acc);
      attn_map::store(out, it, acc);
    }
  }
}

// Persistent blocks walk the units u = blockIdx.x, + gridDim.x, ...  Where
// one 32-row tile holds the map (T = 1) unit u is map u, and gives dq and
// dk.  Past that (T row tiles) the first BC T units are row units, map u /
// T, rows [32 (u % T), + 32), which give dq; the next BC T are column
// units, which give dk: the same work on the transposed map, k's rows held
// and q's streamed, g read across (du_h[n, m] is symmetric in its
// logits: k . q gives the bits of q . k).  So every element of dq and dk
// is one FMA chain over the map in index order, and each unit's du is
// computed twice where T > 1.  A unit holds its 32 rows and loops over the
// map's 32-column chunks.  Shared memory (bwd_words): the staging buffers
// (the unit's 32 rows and a chunk's 32 rows in q's dtype, room for f32),
// the held rows and the chunk's rows in f32 (QS = row_stride(A) apart,
// the chunk's in k's slots), every head's du (kDuHead words a head) and
// the output's chains ([32, A]).  The next chunk's rows (or the next
// unit's) are staged while this chunk computes, and each thread loads its
// next g into registers.  The logits run on the forward's 2 x 4 tile of a
// thread.  Four blocks an SM, by shared memory and by registers (128 a
// thread: with no minimum of blocks nvcc held the kernel to 80 and
// spilled).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
attn_map_bank_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const float* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
                         int BC, int N, int A, int ds, float inv, float scale, int bf16,
                         int vec, int vecg) {
  extern __shared__ __align__(16) float smem[];
  const int QS = attn_map::row_stride(A), H = A / ds, tiles = (N + kTile - 1) / kTile;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + kTile * A);
  float* qc = smem + 2 * kTile * A;
  float* kc = qc + kTile * QS;
  float* dus = kc + kTile * QS;
  float* dqs = dus + H * kDuHead;
  const int rows_units = BC * tiles, units = tiles == 1 ? BC : 2 * rows_units;
  const bool V = ds % 4 == 0;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, ty = lane >> 2, tx = lane & 3;
  const int wr = (w >> 1) * 16, wc = (w & 1) * 16;
  const float* qr[2] = {qc + (wr + ty) * QS, qc + (wr + ty + 8) * QS};
  const float* kr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) kr[j] = kc + (8 * j + wc / 4 + tx) * QS;
  float* const dr[2] = {dus + (wr + ty) * kTile + wc + 4 * tx,
                        dus + (wr + ty + 8) * kTile + wc + 4 * tx};
  // unit u: its map, first row and direction (column unit: dk)
  auto where = [&](int u, size_t& bc, int& r0, bool& col) {
    col = u >= rows_units;
    const int v = col ? u - rows_units : u;
    bc = v / tiles;
    r0 = (v - static_cast<int>(bc) * tiles) * kTile;
  };
  // chunk c0 of unit u: its rows staged (the held rows with chunk 0), its g
  // into gn
  auto stage = [&](int u, int c0, float (&gn)[2][4]) {
    size_t bc;
    int r0;
    bool col;
    where(u, bc, r0, col);
    if (c0 == 0) stage_rows(col ? k : q, sq, bc, r0, N, A, vec != 0);
    stage_rows(col ? q : k, sk, bc, c0, N, A, vec != 0);
    const int r[2] = {r0 + wr + ty, r0 + wr + ty + 8};
    load_g(g + bc * N * N, r, c0 + wc + 4 * tx, N, col, vecg != 0, gn);
  };
  Laps laps;
  float gv[2][4], gn[2][4];
  int u = blockIdx.x;
  if (u < units) stage(u, 0, gn);
  for (; u < units; u += gridDim.x) {
    size_t bc;
    int r0;
    bool col;
    where(u, bc, r0, col);
    const int nr = min(kTile, N - r0);
    for (int c0 = 0; c0 < N; c0 += kTile) {
      const int nk = min(kTile, N - c0);
      hopper::cp_async_wait_all();
      __syncthreads();   // staged; the last chunk's reads of qc / kc / dus are done
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[i][j] = gn[i][j];
      convert_rows(c0 == 0 ? sq : nullptr, qc, nr, sk, kc, nk, A, QS, bf16);
      __syncthreads();   // qc / kc are written: the staging buffers are free
      if (c0 + kTile < N)
        stage(u, c0 + kTile, gn);
      else if (u + static_cast<int>(gridDim.x) < units)
        stage(u + gridDim.x, 0, gn);
      laps.lap(0);
      if (V)
        bwd_du<true>(qr, kr, gv, dr, H, ds, inv, scale, bf16);
      else
        bwd_du<false>(qr, kr, gv, dr, H, ds, inv, scale, bf16);
      __syncthreads();   // du of the chunk is in
      laps.lap(1);
      if (V)
        bwd_dq<true>(dus, kc, dqs, nk, A, ds, QS, c0 == 0);
      else
        bwd_dq<false>(dus, kc, dqs, nk, A, ds, QS, c0 == 0);
      laps.lap(2);
      if (tiles == 1) {   // the unit is the whole map: dk too
        if (V)
          bwd_dk<true>(dus, qc, dk + bc * N * A, nr, nk, A, ds, QS);
        else
          bwd_dk<false>(dus, qc, dk + bc * N * A, nr, nk, A, ds, QS);
      }
      laps.lap(3);
    }
    // the unit's chains (dq, or dk for a column unit), each stored by the
    // thread that ran it (bwd_dq's items)
    T* o = (col ? dk : dq) + (bc * N + r0) * A;
    if (V) {
      const int nq = A / 4;
      for (int it = threadIdx.x; it < (kTile / 2) * nq; it += kThreads) {
        const int p = it / nq, f = 4 * (it - p * nq);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = p + i * (kTile / 2);
          if (r >= nr) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            attn_map::store(o, static_cast<size_t>(r) * A + f + j, dqs[r * A + f + j]);
        }
      }
    } else {
      for (int it = threadIdx.x; it < nr * A; it += kThreads) attn_map::store(o, it, dqs[it]);
    }
    laps.lap(3);
  }
  laps.write();
}

// The plan of a block: the rows of its unit (kTile, both directions) and
// the shared-memory floats.  The forward: its staging buffers and f32 q /
// k rows of one 32 x 32 tile (fwd_words); the backward: the same staging
// buffers and rows, every head's du and the output's chains (bwd_words).
// Neither depends on N.
struct Plan {
  int rows, words;
};

// W: the columns of a slice (A where the whole row fits)
__host__ __device__ inline int fwd_words(int W) {
  return 2 * kTile * (W + attn_map::row_stride(W));
}

__host__ __device__ inline int bwd_words(int A, int H) {
  return 3 * kTile * A + 2 * kTile * attn_map::row_stride(A) + H * kDuHead;
}

Plan make_plan(int A, int H, bool bwd) {
  return Plan{kTile, bwd ? bwd_words(A, H) : fwd_words(A)};
}

// The grouped plan: past a block's shared memory (whole rows of A in the
// forward, every head's du and A-wide chains in the backward).  The
// forward walks column slices of at most kSliceMax (66,560 B, three blocks
// an SM); the backward runs attn_map.cuh's map_dqk_kernel, whose units
// are (map, 32-row tile, head, 32-feature slice of the head): 16,896 B of
// static shared memory.  Neither depends on N or, past the slice, on A.
constexpr int kSliceMax = 128;
constexpr int kGroupedBwdSmem =
    4 * 4 * attn_map::kMapTile * attn_map::kSliceStride;

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// the forward's slice width at groups G (G = 1: the whole row)
__host__ __device__ inline int slice_width(int A, int G) {
  return G <= 1 ? A : round4((A + G - 1) / G);
}

// The plan at these widths, groups <= 0 the default: out[0] the unit's
// rows, out[1] the shared memory in bytes (past kSmemLimit where a forced
// plan does not fit), out[2] the groups: the forward's column slices, or
// the backward's (head, 32-feature slice) units per row tile (1: the
// block backward, every head at once).
void group_plan(int A, int H, int bwd, int groups, int* out) {
  if (groups <= 0) {
    const size_t block = 4 * static_cast<size_t>(bwd ? bwd_words(A, H) : fwd_words(A));
    const bool fits = block <= kSmemLimit;
    groups = fits ? 1 : bwd ? 2 : (A + kSliceMax - 1) / kSliceMax;
  }
  out[0] = kTile;
  if (bwd) {
    const int ds = A / H;
    out[1] = groups == 1 ? 4 * bwd_words(A, H) : kGroupedBwdSmem;
    out[2] = groups == 1 ? 1 : H * ((ds + attn_map::kSlice - 1) / attn_map::kSlice);
  } else {
    const int W = slice_width(A, groups);
    out[1] = 4 * fwd_words(W);
    out[2] = (A + W - 1) / W;
  }
}

// The forward on min(units, resident) persistent blocks, column slices of
// W (A: the whole row).
template <typename T>
int launch_fwd(const void* q, const void* k, float* out, int BC, int N, int A,
               int ds, int bf16, int W, int smem, cudaStream_t s) {
  static std::atomic<long long> resident[2] = {{0}, {0}};
  long long all = 0;
  const cudaError_t err =
      W == A ? resident_blocks(attn_map_bank_fwd_kernel<T, false>, smem, resident[0], all)
             : resident_blocks(attn_map_bank_fwd_kernel<T, true>, smem, resident[1], all);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (N + kTile - 1) / kTile;
  const long long units = static_cast<long long>(BC) * tiles * tiles;
  const int blocks = static_cast<int>(units < all ? units : all);
  if (blocks == 0) return 0;
  const int vec = (static_cast<size_t>(A) * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0;
  if (W == A)
    attn_map_bank_fwd_kernel<T, false><<<blocks, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), out, BC, N, A, ds, bf16, vec, W);
  else
    attn_map_bank_fwd_kernel<T, true><<<blocks, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), out, BC, N, A, ds, bf16, vec, W);
  return static_cast<int>(cudaGetLastError());
}

// The grouped backward: map_dqk_kernel's dq units, then its dk units, on
// q / k in their dtype (rounded to bf16 as staged in bf16 mode), dq / dk
// stored in it.
template <typename T>
int launch_bwd_grouped(const void* q, const void* k, const float* g, void* dq, void* dk, int BC,
                       int N, int A, int ds, int bf16, cudaStream_t s) {
  const long long tiles = (N + attn_map::kMapTile - 1) / attn_map::kMapTile;
  const int slices = (ds + attn_map::kSlice - 1) / attn_map::kSlice;
  const long long units = static_cast<long long>(BC) * tiles * (A / ds) * slices;
  if (units > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  if (units == 0) return 0;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const size_t na = static_cast<size_t>(N) * A;
  const unsigned grid = static_cast<unsigned>(units);
  attn_map::map_dqk_kernel<true, T, T><<<grid, attn_map::kTileThreads, 0, s>>>(
      qq, kk, na, g, static_cast<T*>(dq), na, N, A, ds, static_cast<int>(tiles), slices, bf16,
      bf16);
  attn_map::map_dqk_kernel<false, T, T><<<grid, attn_map::kTileThreads, 0, s>>>(
      qq, kk, na, g, static_cast<T*>(dk), na, N, A, ds, static_cast<int>(tiles), slices, bf16,
      bf16);
  return static_cast<int>(cudaGetLastError());
}

// The backward on min(units, resident) persistent blocks.  The units (BC,
// or 2 BC T past one tile) and the constants go in as 32-bit values: a
// 64-bit divide or a double one in the kernel is a subroutine call, whose
// saved registers spilled.
template <typename T>
int launch_bwd(const void* q, const void* k, const float* g, void* dq, void* dk, int BC,
               int N, int A, int ds, int bf16, int smem, cudaStream_t s) {
  static std::atomic<long long> resident{0};
  long long all = 0;
  const cudaError_t err = resident_blocks(attn_map_bank_bwd_kernel<T>, smem, resident, all);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (N + kTile - 1) / kTile;
  const long long units = tiles == 1 ? BC : 2ll * BC * tiles;
  if (units > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(units < all ? units : all);
  if (blocks == 0) return 0;
  const int vec = (static_cast<size_t>(A) * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const int vecg = N % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  // 1 / sqrt(ds) and 1 / (H sqrt(ds)), each rounded once from double, as
  // the plain versions' Python constants are
  const float inv = static_cast<float>(1.0 / std::sqrt(static_cast<double>(ds)));
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(ds)) / (A / ds));
  attn_map_bank_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), g, static_cast<T*>(dq),
      static_cast<T*>(dk), BC, N, A, ds, inv, scale, bf16, vec, vecg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan of a forward (bwd = 0) or backward block at these widths:
// out[0] the unit's rows (32), out[1] the shared memory in bytes (past
// kSmemLimit where the widths do not fit).  N enters neither.
// ops/attn_bank.py::plan is the same.
extern "C" void attn_bank_plan(int N, int A, int H, int bwd, int* out) {
  (void)N;
  const Plan p = make_plan(A, H, bwd != 0);
  out[0] = p.rows;
  out[1] = 4 * p.words;
}

// The plan at these widths with the grouped plan past a block's shared
// memory: out[0] rows, out[1] shared bytes, out[2] groups (group_plan;
// groups <= 0: the default, 1: the block plan, more: that many slices
// forward, the grouped backward).  ops/attn_bank.py::plan is the same.
extern "C" void attn_bank_group_plan(int N, int A, int H, int bwd, int groups, int* out) {
  (void)N;
  group_plan(A, H, bwd, groups, out);
}

// q, k [BC, N, A] (bf16 if in_bf16, else f32), out [BC, N, N] f32; smem the
// plan's bytes (cudaErrorInvalidValue if it disagrees).  Needs A % ds == 0.
extern "C" int attn_map_bank_fwd(const void* q, const void* k, float* out, int BC,
                                 int N, int A, int ds, int in_bf16, int bf16,
                                 int smem, void* stream) {
  if (smem != 4 * make_plan(A, A / ds, false).words)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_fwd<__nv_bfloat16>(q, k, out, BC, N, A, ds, bf16, A, smem, s)
                 : launch_fwd<float>(q, k, out, BC, N, A, ds, bf16, A, smem, s);
}

// attn_map_bank_fwd in `groups` column slices (attn_bank_group_plan; 1:
// the whole row); smem the plan's bytes.
extern "C" int attn_map_bank_fwd_groups(const void* q, const void* k, float* out, int BC,
                                        int N, int A, int ds, int in_bf16, int bf16, int groups,
                                        int smem, void* stream) {
  const int W = slice_width(A, groups);
  if (groups < 1 || ds < 1 || A % ds != 0 || smem != 4 * fwd_words(W) ||
      (A + W - 1) / W != groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_fwd<__nv_bfloat16>(q, k, out, BC, N, A, ds, bf16, W, smem, s)
                 : launch_fwd<float>(q, k, out, BC, N, A, ds, bf16, W, smem, s);
}

// The grouped backward (attn_bank_group_plan with groups != 1): g [BC, N, N]
// f32; dq, dk [BC, N, A] in q's dtype.  cudaErrorInvalidValue past the
// int32 grid index.
extern "C" int attn_map_bank_bwd_grouped(const void* q, const void* k, const float* g,
                                         void* dq, void* dk, int BC, int N, int A, int ds,
                                         int in_bf16, int bf16, void* stream) {
  if (ds < 1 || A % ds != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_bwd_grouped<__nv_bfloat16>(q, k, g, dq, dk, BC, N, A, ds, bf16, s)
                 : launch_bwd_grouped<float>(q, k, g, dq, dk, BC, N, A, ds, bf16, s);
}

// g [BC, N, N] f32; dq, dk [BC, N, A] in q's dtype; rows and smem the
// plan's (cudaErrorInvalidValue if they disagree).
extern "C" int attn_map_bank_bwd(const void* q, const void* k, const float* g,
                                 void* dq, void* dk, int BC, int N, int A, int ds,
                                 int in_bf16, int bf16, int rows, int smem, void* stream) {
  const Plan p = make_plan(A, A / ds, true);
  if (rows != p.rows || smem != 4 * p.words) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_bwd<__nv_bfloat16>(q, k, g, dq, dk, BC, N, A, ds, bf16, smem, s)
                 : launch_bwd<float>(q, k, g, dq, dk, BC, N, A, ds, bf16, smem, s);
}
