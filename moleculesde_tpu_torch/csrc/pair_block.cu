// Fused pair block, forward:
//   out[b, s, d, h] = sum_c relu(a[b, s, c] + cc[b, d, c]) * w[c, h] + bias[h]
// with a, cc [B, N, C] f32, w [C, H] f32, bias [H] f32, out [B, N, N, H] f32.
// The [B, N, N, C] pair tensor is never written to device memory.
//
// Replaces the Pallas kernel moleculesde_tpu/ops/pair_block.py::_fwd_kernel
// (pallas_call at l.170, entry pair_relu_project l.449).
//
// Bound: arithmetic.  2*N*N*C*H flops per graph (1.26 GFLOP at B=64, N=32,
// C=300, H=32) against ~13 MB of compulsory traffic (a, cc read once, out
// written once).  This first version runs on the CUDA cores in f32 (67
// TFLOP/s peak), not the tensor cores; wgmma is later work.  Design: one
// block per (graph, tile of TS source rows); w (38 KB at C=300, H=32, zero
// padded to a multiple of 32 columns), the bias, the tile's a rows and all
// N cc rows are staged in shared memory.  Each thread owns one (s, d) pair
// and 32 output channels in registers: it forms relu(a + cc) once per c and
// feeds 32 FMAs, so the pair value is computed once per (s, d, c), not once
// per output.  Rows of a/cc are padded to an odd stride (C + 1 words) so
// the 32 threads of a warp, which read 32 different d rows, hit 32
// different banks; w and a reads are warp-wide broadcasts.
//
// bf16 != 0 reproduces the TPU kernel's bf16 mode: the relu'd pair value
// and w are rounded to bf16, the products accumulate in f32.
//
// Backward (replaces _bwd_kernel, pallas_call at l.193), for H <= 32:
//   pair[s, d, c] = a[s, c] + cc[d, c]                     (f32)
//   dpair         = 1[pair > 0] * sum_h g[s, d, h] * w[c, h]
//   da[s, c] = sum_d dpair,  dc[d, c] = sum_s dpair
//   dw[c, h] = sum_{b, s, d} relu(pair)[s, d, c] * g[s, d, h]
//   db[h]    = sum_{b, s, d} g[s, d, h]
// bf16 mode rounds g, w and relu(pair) to bf16 for the two products (the
// relu mask still comes from the f32 pair) and keeps db in f32, as the TPU
// kernel does.  Bound: arithmetic, 4*N*N*C*H flops per graph (two
// products), ~2.5 GFLOP at B=128, N=32, C=300, H=32.  Design: one block
// per (graph, chunk of CC channels), one thread per channel c.  A thread
// holds w[c, :] and its dw[c, :] accumulators in registers; the chunk's
// columns of the graph's cc rows and its dc accumulators live in shared
// memory (the thread's own column, so no conflicts), and each block stages
// g one source row s at a time ([N, 32], broadcast reads).  The pair value
// is formed once per (s, d, c) and feeds both products.  Shared memory is
// (32*N + 2*N*CC) words: bwd_chunk picks the fewest chunks that fit (one,
// CC = C, up to N = 64 at C = 300; two of up to 160 channels at N = 128),
// and a thread's order of operations does not depend on the chunking, so
// neither does the result.  dw and db are batch-wide sums: each block
// writes its channels' share of its graph's partial (chunk 0 also db) and
// a second launch adds them in graph order (partials.cuh), so the result
// is the same on every run.
//
// K4, the channel-major variant (template flag CM), replaces
// moleculesde_tpu/ops/pair_block.py::_fwd_kernel_cm (pallas_call at l.337)
// and ::_bwd_kernel_cm (l.361), entry pair_relu_project_cm (l.409):
//   out[b, h, s*N + d] = sum_c relu(a[b, s, c] + cc[b, d, c]) * w[c, h]
// with no bias (the wrapper adds it, so autograd gives db).  The TPU kernel
// builds the pair slab [C, N*N] with two selector matmuls because its lanes
// want the N*N axis minor; on this card the pair value is formed in
// registers as in K3, and only the store changes: a warp holds 32
// neighbouring d of one source row, so each output channel is written as a
// contiguous 128-byte run.  Same bound as K3: arithmetic, 2*N*N*C*H flops
// per graph forward, 4*N*N*C*H backward.  Its bf16 mode rounds where the
// TPU kernel rounds, which is not where K3 does: a and cc are rounded to
// bf16 BEFORE the add (the TPU kernel casts its inputs), the relu mask
// comes from that f32 sum, and the backward rounds the masked dpair to
// bf16 before the da / dc sums.  The backward stages g's [H, N*N] rows with
// neighbouring threads on neighbouring d, gives no db, and sums dw through
// partials.cuh like K3.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "partials.cuh"

namespace {

constexpr int kChanTile = 32;  // output channels held in registers per pass

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool CM>
__global__ void pair_relu_project_fwd_kernel(const float* __restrict__ a,
                                             const float* __restrict__ cc,
                                             const float* __restrict__ w,
                                             const float* __restrict__ bias,
                                             float* __restrict__ out,
                                             int N, int C, int H, int TS,
                                             int bf16) {
  extern __shared__ __align__(16) float smem[];
  const int HP = ((H + kChanTile - 1) / kChanTile) * kChanTile;
  const int CP = C + 1;
  float* ws = smem;              // [C][HP]
  float* bs = ws + C * HP;       // [HP]
  float* as = bs + HP;           // [TS][CP]
  float* cs = as + TS * CP;      // [N][CP]

  const int b = blockIdx.x;
  const int s0 = blockIdx.y * TS;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (int i = tid; i < C * HP; i += nthr) {
    const int k = i / HP, h = i - k * HP;
    const float v = h < H ? w[static_cast<size_t>(k) * H + h] : 0.f;
    ws[i] = bf16 ? round_bf16(v) : v;
  }
  for (int i = tid; i < HP; i += nthr) bs[i] = (!CM && i < H) ? bias[i] : 0.f;
  const float* ab = a + static_cast<size_t>(b) * N * C;
  const float* cb = cc + static_cast<size_t>(b) * N * C;
  const bool round_halves = CM && bf16;  // K4 rounds a and cc before the add
  for (int i = tid; i < TS * C; i += nthr) {
    const int r = i / C, k = i - r * C;
    const float v = (s0 + r < N) ? ab[static_cast<size_t>(s0 + r) * C + k] : 0.f;
    as[r * CP + k] = round_halves ? round_bf16(v) : v;
  }
  for (int i = tid; i < N * C; i += nthr) {
    const int r = i / C, k = i - r * C;
    cs[r * CP + k] = round_halves ? round_bf16(cb[i]) : cb[i];
  }
  __syncthreads();

  const int r = tid / N;
  const int d = tid - r * N;
  const int s = s0 + r;
  if (r >= TS || s >= N) return;  // no barrier below this point
  const float* arow = as + r * CP;
  const float* crow = cs + d * CP;
  float* orow = out + ((static_cast<size_t>(b) * N + s) * N + d) * H;  // !CM
  const bool vec_store = (H % 4) == 0;

  for (int h0 = 0; h0 < HP; h0 += kChanTile) {
    float acc[kChanTile];
#pragma unroll
    for (int j = 0; j < kChanTile; ++j) acc[j] = 0.f;
    for (int k = 0; k < C; ++k) {
      float p = fmaxf(arow[k] + crow[k], 0.f);
      if (bf16) p = round_bf16(p);
      const float4* wr = reinterpret_cast<const float4*>(ws + k * HP + h0);
#pragma unroll
      for (int j = 0; j < kChanTile / 4; ++j) {
        const float4 wv = wr[j];
        acc[4 * j + 0] = fmaf(p, wv.x, acc[4 * j + 0]);
        acc[4 * j + 1] = fmaf(p, wv.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(p, wv.z, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(p, wv.w, acc[4 * j + 3]);
      }
    }
    if (CM) {
      // channel-major [B, H, N*N]: a warp's threads hold neighbouring d,
      // so each channel's store is one contiguous run
      const size_t nn = static_cast<size_t>(N) * N;
      float* ob = out + static_cast<size_t>(b) * H * nn + static_cast<size_t>(s) * N + d;
#pragma unroll
      for (int j = 0; j < kChanTile; ++j)
        if (h0 + j < H) ob[(h0 + j) * nn] = acc[j];
    } else if (vec_store) {
#pragma unroll
      for (int j = 0; j < kChanTile; j += 4) {
        if (h0 + j < H) {
          float4 o;
          o.x = acc[j + 0] + bs[h0 + j + 0];
          o.y = acc[j + 1] + bs[h0 + j + 1];
          o.z = acc[j + 2] + bs[h0 + j + 2];
          o.w = acc[j + 3] + bs[h0 + j + 3];
          *reinterpret_cast<float4*>(orow + h0 + j) = o;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChanTile; ++j)
        if (h0 + j < H) orow[h0 + j] = acc[j] + bs[h0 + j];
    }
  }
}

template <bool CM>
__global__ void pair_relu_project_bwd_kernel(const float* __restrict__ a,
                                             const float* __restrict__ cc,
                                             const float* __restrict__ w,
                                             const float* __restrict__ g,
                                             float* __restrict__ da,
                                             float* __restrict__ dc,
                                             float* __restrict__ dw_part,  // [B, C, H]
                                             float* __restrict__ db_part,  // [B, H]; !CM
                                             int N, int C, int H, int CC, int bf16) {
  extern __shared__ __align__(16) float smem[];
  float* grow = smem;                  // [N][kChanTile]: g[b, s, :, :]
  float* cs = grow + N * kChanTile;    // [N][CC]: the chunk's columns of cc
  float* dcs = cs + N * CC;            // [N][CC]

  const int b = blockIdx.x;
  const int c0 = blockIdx.y * CC;      // the chunk's first channel
  const int cl = threadIdx.x;          // the thread's channel within the chunk
  const int c = c0 + cl;
  const bool active = cl < CC && c < C;
  const size_t nn = static_cast<size_t>(N) * N;
  const float* ab = a + static_cast<size_t>(b) * N * C;
  const float* cb = cc + static_cast<size_t>(b) * N * C;
  const float* gb = g + static_cast<size_t>(b) * nn * H;  // [N*N, H], or [H, N*N] if CM
  const bool round_halves = CM && bf16;

  for (int i = cl; i < N * CC; i += blockDim.x) {
    const int r = i / CC, k = i - r * CC;
    const float v = c0 + k < C ? cb[static_cast<size_t>(r) * C + c0 + k] : 0.f;
    cs[i] = round_halves ? round_bf16(v) : v;
    dcs[i] = 0.f;
  }
  float wr[kChanTile], dwr[kChanTile];
#pragma unroll
  for (int h = 0; h < kChanTile; ++h) {
    const float v = (active && h < H) ? w[static_cast<size_t>(c) * H + h] : 0.f;
    wr[h] = bf16 ? round_bf16(v) : v;
    dwr[h] = 0.f;
  }
  // db: unrounded f32 sum of g over the graph's pairs, in pair order (chunk 0)
  if (!CM && blockIdx.y == 0 && cl < H) {
    float acc = 0.f;
    for (size_t p = 0; p < nn; ++p) acc += gb[p * H + cl];
    db_part[static_cast<size_t>(b) * H + cl] = acc;
  }

  for (int s = 0; s < N; ++s) {
    __syncthreads();  // previous row's g fully consumed (and cs / dcs ready)
    for (int i = cl; i < N * kChanTile; i += blockDim.x) {
      float v;
      int d, h;
      if (CM) {  // neighbouring threads read neighbouring d of one channel
        h = i / N;
        d = i - h * N;
        v = h < H ? gb[static_cast<size_t>(h) * nn + static_cast<size_t>(s) * N + d] : 0.f;
      } else {
        d = i / kChanTile;
        h = i - d * kChanTile;
        v = h < H ? gb[(static_cast<size_t>(s) * N + d) * H + h] : 0.f;
      }
      grow[d * kChanTile + h] = bf16 ? round_bf16(v) : v;
    }
    __syncthreads();
    if (!active) continue;
    const float a_raw = ab[static_cast<size_t>(s) * C + c];
    const float as = round_halves ? round_bf16(a_raw) : a_raw;
    float da_acc = 0.f;
    for (int d = 0; d < N; ++d) {
      const float pair = as + cs[d * CC + cl];
      const float r = fmaxf(pair, 0.f);
      const float rr = bf16 ? round_bf16(r) : r;
      const float4* gr = reinterpret_cast<const float4*>(grow + d * kChanTile);
      float dr = 0.f;
#pragma unroll
      for (int j = 0; j < kChanTile / 4; ++j) {
        const float4 gv = gr[j];
        dr = fmaf(gv.x, wr[4 * j + 0], dr);
        dr = fmaf(gv.y, wr[4 * j + 1], dr);
        dr = fmaf(gv.z, wr[4 * j + 2], dr);
        dr = fmaf(gv.w, wr[4 * j + 3], dr);
        dwr[4 * j + 0] = fmaf(rr, gv.x, dwr[4 * j + 0]);
        dwr[4 * j + 1] = fmaf(rr, gv.y, dwr[4 * j + 1]);
        dwr[4 * j + 2] = fmaf(rr, gv.z, dwr[4 * j + 2]);
        dwr[4 * j + 3] = fmaf(rr, gv.w, dwr[4 * j + 3]);
      }
      float dp = pair > 0.f ? dr : 0.f;
      if (round_halves) dp = round_bf16(dp);  // K4 rounds dpair before the sums
      da_acc += dp;
      dcs[d * CC + cl] += dp;
    }
    da[(static_cast<size_t>(b) * N + s) * C + c] = da_acc;
  }

  if (!active) return;  // no barrier below this point
  for (int d = 0; d < N; ++d)
    dc[(static_cast<size_t>(b) * N + d) * C + c] = dcs[d * CC + cl];
  float* pw = dw_part + (static_cast<size_t>(b) * C + c) * H;
#pragma unroll
  for (int h = 0; h < kChanTile; ++h)
    if (h < H) pw[h] = dwr[h];
}

// Channels per block of the backward: the fewest chunks of
// min(C, 32 * ceil(ceil(C / k) / 32)) channels whose shared memory,
// (32*N + 2*N*CC) words, fits a block; 0 if even 32 channels do not fit.
// Mirrored by ops/pair_block.py::bwd_plan.
int bwd_chunk(int N, int C) {
  for (int k = 1;; ++k) {
    const int per = ((C + k - 1) / k + 31) / 32 * 32;
    const int cc = per < C ? per : C;
    const size_t smem = (static_cast<size_t>(N) * kChanTile +
                         2 * static_cast<size_t>(N) * cc) * sizeof(float);
    if (cc <= 1024 && smem <= kSmemLimit) return cc;
    if (cc <= 32) return 0;
  }
}

template <bool CM>
int launch_bwd(const float* a, const float* cc, const float* w, const float* g, float* da,
               float* dc, float* dw_part, float* db_part, int B, int N, int C, int H,
               int bf16, cudaStream_t s) {
  const int CC = bwd_chunk(N, C);
  if (CC <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(N) * kChanTile +
                       2 * static_cast<size_t>(N) * CC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pair_relu_project_bwd_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (C + CC - 1) / CC);
  const int threads = ((CC + 31) / 32) * 32;
  pair_relu_project_bwd_kernel<CM><<<grid, threads, smem, s>>>(
      a, cc, w, g, da, dc, dw_part, db_part, N, C, H, CC, bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pair_relu_project_fwd(const float* a, const float* cc,
                                     const float* w, const float* bias,
                                     float* out, int B, int N, int C, int H,
                                     int TS, int bf16, void* stream) {
  const int HP = ((H + kChanTile - 1) / kChanTile) * kChanTile;
  const size_t smem = (static_cast<size_t>(C) * HP + HP +
                       static_cast<size_t>(TS + N) * (C + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pair_relu_project_fwd_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (N + TS - 1) / TS);
  pair_relu_project_fwd_kernel<false><<<grid, TS * N, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      a, cc, w, bias, out, N, C, H, TS, bf16);
  return static_cast<int>(cudaGetLastError());
}

// K4 forward: out [B, H, N*N] channel-major, no bias; same launch as K3's.
extern "C" int pair_relu_project_cm_fwd(const float* a, const float* cc,
                                        const float* w, float* out, int B,
                                        int N, int C, int H, int TS, int bf16,
                                        void* stream) {
  const int HP = ((H + kChanTile - 1) / kChanTile) * kChanTile;
  const size_t smem = (static_cast<size_t>(C) * HP + HP +
                       static_cast<size_t>(TS + N) * (C + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pair_relu_project_fwd_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (N + TS - 1) / TS);
  pair_relu_project_fwd_kernel<true><<<grid, TS * N, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      a, cc, w, nullptr, out, N, C, H, TS, bf16);
  return static_cast<int>(cudaGetLastError());
}

// da, dc [B, N, C], dw [C, H], db [H]; dw_part (B * C * H floats) and
// db_part (B * H floats) are caller-allocated scratch.  Needs H <= 32 and
// a channel chunk that fits (bwd_chunk).
extern "C" int pair_relu_project_bwd(const float* a, const float* cc,
                                     const float* w, const float* g, float* da,
                                     float* dc, float* dw, float* db,
                                     float* dw_part, float* db_part, int B,
                                     int N, int C, int H, int bf16,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_bwd<false>(a, cc, w, g, da, dc, dw_part, db_part, B, N, C, H,
                                   bf16, s);
  if (rc != 0) return rc;
  partials::sum_rows(dw_part, dw, B, C * H, s);
  partials::sum_rows(db_part, db, B, H, s);
  return static_cast<int>(cudaGetLastError());
}

// K4 backward: g [B, H, N*N]; da, dc [B, N, C], dw [C, H], no db; dw_part
// (B * C * H floats) is caller-allocated scratch.  Needs H <= 32 and a
// channel chunk that fits (bwd_chunk).
extern "C" int pair_relu_project_cm_bwd(const float* a, const float* cc,
                                        const float* w, const float* g,
                                        float* da, float* dc, float* dw,
                                        float* dw_part, int B, int N, int C,
                                        int H, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_bwd<true>(a, cc, w, g, da, dc, dw_part, nullptr, B, N, C, H,
                                  bf16, s);
  if (rc != 0) return rc;
  partials::sum_rows(dw_part, dw, B, C * H, s);
  return static_cast<int>(cudaGetLastError());
}

// The backward's channels per block at (N, C), 0 where none fits: the
// plan the wrappers mirror (ops/pair_block.py::bwd_plan).
extern "C" int pair_relu_project_bwd_chunk(int N, int C) { return bwd_chunk(N, C); }
