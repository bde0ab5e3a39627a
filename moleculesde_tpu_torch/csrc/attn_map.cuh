// The backward of the head-mean tanh map of one (graph, channel), K8's
// (attn_qk_bank.cu; K7's backward has its own, in attn_bank.cu; past it
// both take map_dqk_kernel below):
//   a[n, m] = (1/H) * sum_h tanh(inv * sum_{a in head h} q[n, a] k[m, a])
// with heads the contiguous ds-wide chunks of A (H = A / ds) and
// inv = 1 / sqrt(ds), taken in tiles of rows so that shared memory grows
// as N, not as N^2 H.  q and k lie in shared memory as f32, rows
// row_stride(A) words apart, read 16 bytes at a time.  tanh is the
// accurate tanhf, not tanh.approx.f32, whose ~2^-11 relative error would
// break the f32 agreement with the plain versions.  Every loop strides
// over the block's threads; the caller puts the barriers between phases.
//
// The backward's two du products run as FMAs in index order in both
// modes, not on mma.sync, though du, q and k are bf16 values in bf16 mode
// (K7's backward keeps the rule): dq and dk are rounded again (K7's
// outputs, K8's dout), and mma.sync's f32 sums, in another order than the
// plain versions' (cuBLAS, one chain in k order), flipped enough of those
// roundings that K8's bf16 dqk left its 3e-3 bar at n_max 128 (PERF.md).

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

// Rows of the map the backward takes at once, before shared memory
// forces fewer: as many as keep every head's du of the tile within
// du_budget words (K8: 16384, 16 rows at N = 128).  ops/attn_bank.py and
// ops/attn_qk_bank.py count the same.
__host__ __device__ inline int tile_rows(int N, int H, int du_budget) {
  const int r = du_budget / (H * N);
  return r < 1 ? 1 : (r > N ? N : r);
}

// Row stride of the q and k rows the backward reads: 16-byte aligned and 4
// words past a multiple of 32 (36 at A = 32), so that the 8 lanes of a
// quarter warp reading 16 bytes of 8 neighbouring rows hit 32 banks.
__host__ __device__ inline int row_stride(int A) { return (A + 3) / 4 * 4 + 4; }

// Words of the tile's du: every head's R x N values, each head padded by
// one word, so that the heads a warp reads at once sit on different banks.
__host__ __device__ inline int du_words(int N, int R, int H) { return H * (R * N + 1); }

// The map's backward for the cotangent g [N, N] (device memory), row tile
// by row tile (R rows; dus holds du_words(N, R, H) floats), q and k rows
// (f32) row_stride(A) apart and 16-byte aligned:
//   du_h[n, m] = g[n, m] * (1 - t_h^2) * (inv / H), rounded to bf16 when
//                bf16 is set, t_h = tanh(inv * q_h[n] . k_h[m]) recomputed
//   dq[n, a]   = sum_m du_{h(a)}[n, m] k[m, a]   (the tile's rows, stored)
//   dk[m, a]   = sum_n du_{h(a)}[n, m] q[n, a]   (every tile adds its rows)
// Each sum runs as FMAs in index order in one thread (dk's as one chain
// across the tiles: a thread owns the same (m, a) in every tile), so the
// bits do not depend on R or on the block's size.  dq and dk are row-major
// [N, A] through store(); dk_acc ([N, A] f32, shared memory) carries dk
// between tiles and may be dk itself, and is not read when one tile holds
// the whole map.  Ends with a barrier.
template <typename TQ, typename TK>
__device__ void backward_tiled(const float* qs, const float* ks, const float* g,
                               float* dus, TQ* dq, TK* dk, float* dk_acc, int N, int A,
                               int ds, int R, int bf16) {
  const int QS = row_stride(A), H = A / ds, HS = R * N + 1;
  const float inv = inv_sqrt(ds), scale = du_scale(ds, H);
  const bool vec = ds % 4 == 0;
  for (int r0 = 0; r0 < N; r0 += R) {
    const int rows = min(R, N - r0);
    const bool last = r0 + rows >= N;
    // du of the tile, a thread per 2 x 2 pairs (r, r + SR) x (m, m + SN):
    // each q and k row read once for two pairs, 16 bytes at a time where
    // ds % 4 == 0; a pair past the tile or the map reads row rr / column
    // mm and is not stored
    const int SR = (rows + 1) / 2, SN = (N + 1) / 2;
    for (int blk = threadIdx.x; blk < SR * SN; blk += blockDim.x) {
      const int rr = blk / SN, mm = blk - rr * SN;
      const int rs[2] = {rr, rr + SR}, ms[2] = {mm, mm + SN};
      const bool okr[2] = {true, rs[1] < rows}, okm[2] = {true, ms[1] < N};
      const float* qr[2] = {qs + (r0 + rr) * QS, qs + (r0 + (okr[1] ? rs[1] : rr)) * QS};
      const float* kr[2] = {ks + mm * QS, ks + (okm[1] ? ms[1] : mm) * QS};
      float gv[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          gv[i][j] = okr[i] && okm[j] ? g[static_cast<size_t>(r0 + rs[i]) * N + ms[j]] : 0.f;
      for (int h = 0; h < H; ++h) {
        float u[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        int d = h * ds;
        const int e = d + ds;
        if (vec) {
          for (; d < e; d += 4) {
            float qa[2][4], ka[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float4 a4 = *reinterpret_cast<const float4*>(qr[i] + d);
              const float4 b4 = *reinterpret_cast<const float4*>(kr[i] + d);
              qa[i][0] = a4.x, qa[i][1] = a4.y, qa[i][2] = a4.z, qa[i][3] = a4.w;
              ka[i][0] = b4.x, ka[i][1] = b4.y, ka[i][2] = b4.z, ka[i][3] = b4.w;
            }
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) u[i][j] = fmaf(qa[i][t], ka[j][t], u[i][j]);
          }
        } else {
          for (; d < e; ++d)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) u[i][j] = fmaf(qr[i][d], kr[j][d], u[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!okr[i] || !okm[j]) continue;
            const float t = tanhf(u[i][j] * inv);
            const float du = gv[i][j] * (1.0f - t * t) * scale;
            dus[h * HS + rs[i] * N + ms[j]] = bf16 ? round_bf16(du) : du;
          }
      }
    }
    __syncthreads();
    // dk carried between tiles; the last tile stores it
    auto dk_put = [&](int i, float s) {
      if (last)
        store(dk, i, s);
      else
        dk_acc[i] = s;
    };
    // dq's and dk's chains, interleaved where both run
    for (int i = threadIdx.x; i < N * A; i += blockDim.x) {
      const int m = i / A, a = i - m * A;
      const float* du = dus + (a / ds) * HS;
      float sk = r0 > 0 ? dk_acc[i] : 0.f;   // one chain across the tiles
      if (m < rows) {   // dq of the tile's row m
        float sq = 0.f;
        int j = 0;
        for (; j < rows; ++j) {
          sq = fmaf(du[m * N + j], ks[j * QS + a], sq);
          sk = fmaf(du[j * N + m], qs[(r0 + j) * QS + a], sk);
        }
        for (; j < N; ++j) sq = fmaf(du[m * N + j], ks[j * QS + a], sq);
        store(dq, static_cast<size_t>(r0 + m) * A + a, sq);
      } else {
        for (int r = 0; r < rows; ++r) sk = fmaf(du[r * N + m], qs[(r0 + r) * QS + a], sk);
      }
      dk_put(i, sk);
    }
    __syncthreads();   // dus is rewritten by the next tile
  }
}

// ---- the map's backward in small units (K8's tiled plan, K7's grouped plan) --
// Units of (map, 32-row tile, head, 32-feature slice of the head) give dq,
// units of (map, 32-column tile, head, slice) give dk: each walks the other
// side's 32-tiles in order, forms the tile's du of its head (g (1 - t^2)
// inv / H, rounded to bf16 when bf16 is set, the head's dot in index order
// over its features, staged 32 at a time) and carries its chains across
// the tiles, each sum one chain in index order, as backward_tiled's and
// K7's block backward's: the same bits as those.  Shared memory is four
// static [32][33] f32 tiles, whatever N, A or ds.

constexpr int kTileThreads = 256;
constexpr int kMapTile = 32;             // rows (columns) of a map tile
constexpr int kSlice = 32;               // features of q / k staged at once
constexpr int kSliceStride = kSlice + 1;

// Rows r0 .. r0 + kMapTile - 1 of x ([rows][A]), features a0 .. a0 + kSlice
// - 1, into s ([kMapTile][kSliceStride]) as f32, rounded to bf16 where rnd
// is set, zero past N and A.
template <typename T>
__device__ __forceinline__ void stage_slice(float* s, const T* x, int r0, int N, int a0, int A,
                                            int rnd) {
  for (int i = threadIdx.x; i < kMapTile * kSlice; i += kTileThreads) {
    const int r = i / kSlice, a = i - r * kSlice;
    const float v = (r0 + r < N && a0 + a < A)
                        ? load(x, static_cast<size_t>(r0 + r) * A + a0 + a) : 0.f;
    s[r * kSliceStride + a] = rnd ? round_bf16(v) : v;
  }
}

// du of head h for the tile of rows n0.. (q) by columns m0.. (k) into dus
// [kMapTile][kSliceStride]: du = g (1 - t^2) scale, t = tanh(inv q_h . k_h)
// (the head's dot in index order, its features staged 32 at a time),
// rounded to bf16 in bf16 mode; zero past N.
template <typename T>
__device__ __forceinline__ void head_du(float* dus, float* qs, float* ks, const T* q, const T* k,
                                        const float* g, int n0, int m0, int N, int A, int ds,
                                        int h, int bf16, int rnd) {
  const int nl = threadIdx.x / 16, ml = threadIdx.x % 16;
  const int H = A / ds;
  const float inv = inv_sqrt(ds), scale = du_scale(ds, H);
  float uu[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int a0 = h * ds; a0 < (h + 1) * ds; a0 += kSlice) {
    __syncthreads();   // the stages and du are free
    stage_slice(qs, q, n0, N, a0, A, rnd);
    stage_slice(ks, k, m0, N, a0, A, rnd);
    __syncthreads();
    const int w = min(kSlice, (h + 1) * ds - a0);
    for (int a = 0; a < w; ++a) {
      const float qa[2] = {qs[nl * kSliceStride + a], qs[(nl + 16) * kSliceStride + a]};
      const float ka[2] = {ks[ml * kSliceStride + a], ks[(ml + 16) * kSliceStride + a]};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) uu[i][jj] = fmaf(qa[i], ka[jj], uu[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int r = nl + 16 * i, cix = ml + 16 * jj, n = n0 + r, m = m0 + cix;
      float du = 0.f;
      if (n < N && m < N) {
        const float t = tanhf(uu[i][jj] * inv);
        du = g[static_cast<size_t>(n) * N + m] * (1.0f - t * t) * scale;
        if (bf16) du = round_bf16(du);
      }
      dus[r * kSliceStride + cix] = du;
    }
}

// dq (DQ) or dk of one (map, 32-row (column) tile, head h, 32-feature slice
// of the head) unit: the other side's 32-tiles in order, each tile's du of
// the head, then the unit's chains
//   dq[n, a] += du[n, m] k[m, a]  (m in order)   dk[m, a] += du[n, m] q[n, a]
// carried across the tiles in registers (4 items a thread), stored through
// store().  Map u's q and k start at qb + u in_stride and kb + u in_stride
// ([N][A] each, rounded to bf16 as staged where rnd is set), g at u N N,
// its output at ob + u out_stride.  Blocks: maps x tiles x H x slices, of
// kTileThreads threads.
template <bool DQ, typename T, typename TO>
__global__ void __launch_bounds__(kTileThreads)
map_dqk_kernel(const T* __restrict__ qb, const T* __restrict__ kb, size_t in_stride,
               const float* __restrict__ g, TO* __restrict__ ob, size_t out_stride, int N, int A,
               int ds, int tiles, int slices, int bf16, int rnd) {
  __shared__ float qs[kMapTile * kSliceStride], ks[kMapTile * kSliceStride];
  __shared__ float dus[kMapTile * kSliceStride], os[kMapTile * kSliceStride];
  const int H = A / ds;
  long long blk = blockIdx.x;
  const int sl = static_cast<int>(blk % slices);
  blk /= slices;
  const int h = static_cast<int>(blk % H);
  blk /= H;
  const int t0 = static_cast<int>(blk % tiles);
  const size_t u = static_cast<size_t>(blk / tiles);
  const T* q = qb + u * in_stride;
  const T* k = kb + u * in_stride;
  const float* gu = g + u * N * N;
  const int a0 = h * ds + sl * kSlice, aw = min(kSlice, (h + 1) * ds - a0);
  const int own0 = t0 * kMapTile;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};   // items threadIdx.x + 256 it: (row i4 / 32, a i4 % 32)
  for (int t = 0; t < tiles; ++t) {
    const int other0 = t * kMapTile;
    if (DQ)
      head_du(dus, qs, ks, q, k, gu, own0, other0, N, A, ds, h, bf16, rnd);
    else
      head_du(dus, qs, ks, q, k, gu, other0, own0, N, A, ds, h, bf16, rnd);
    // the other side's rows at the unit's features (k for dq, q for dk)
    stage_slice(os, DQ ? k : q, other0, N, a0, A, rnd);
    __syncthreads();
    const int on = min(kMapTile, N - other0);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i4 = threadIdx.x + kTileThreads * it, r = i4 / kSlice, a = i4 % kSlice;
      float s = acc[it];
      for (int o = 0; o < on; ++o)
        s = fmaf(DQ ? dus[r * kSliceStride + o] : dus[o * kSliceStride + r],
                 os[o * kSliceStride + a], s);
      acc[it] = s;
    }
  }
  TO* out = ob + u * out_stride;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i4 = threadIdx.x + kTileThreads * it, r = i4 / kSlice, a = i4 % kSlice;
    if (own0 + r < N && a < aw) store(out, static_cast<size_t>(own0 + r) * A + a0 + a, acc[it]);
  }
}

}  // namespace attn_map
