// The backward of the head-mean tanh map of one (graph, channel), K8's
// (attn_qk_bank.cu; K7's backward has its own, in attn_bank.cu):
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

}  // namespace attn_map
