// GIN message block, forward:
//   out[b, n, f] = sum_{e : dst[b,e] = n} relu(x[b, src[b,e], f] + emb[b, e, f])
//   emb[b, e, f] = sum_k boh[b, e, k] * table[k, f]
// with x [B, N, F] f32, src/dst [B, E] int32 LOCAL node indices (masked
// edges carry the sentinel N), boh [B, E, D] f32 bond one-hots, table
// [D, F] f32 row-stacked bond embeddings, out [B, N, F] f32.  An edge whose
// src is out of range gathers zeros; one whose dst is out of range adds
// nothing (the one-hot semantics of the TPU kernel).
//
// Replaces the Pallas kernel moleculesde_tpu/ops/gin_messages.py::_fwd_kernel
// (pallas_call at l.128, entry gin_messages l.198).  The TPU kernel builds
// src/dst one-hot matrices in VMEM only to feed its matrix unit; on Hopper
// the same function is a gather plus a segmented sum.
//
// Bound: device memory.  The work is ~2*E*F*(D+1) flops per graph against
// reading x and writing out once (~5.4 MB at B=64, N=32, E=128, F=300,
// D=13), far below the 295 flop/byte ridge.  Design: one block per
// (graph, 128-feature chunk); the graph's x columns, the table columns,
// its bond one-hots and its edge lists are staged in shared memory, so x is
// read from device memory once and the output written once.  Each thread
// owns one feature column and walks the edges in order, accumulating into
// its own column of a shared [N, 128] tile: no atomics, a fixed summation
// order, and conflict-free shared accesses (consecutive threads,
// consecutive words).
//
// bf16 != 0 reproduces the TPU kernel's bf16 mode: x, boh and table are
// rounded to bf16, the embedding and the sum accumulate in f32, and each
// message is rounded to bf16 before it is summed.
//
// Backward (replaces _bwd_kernel, pallas_call at l.144):
//   pre[b, e, f]  = x[b, src_e, f] + emb[b, e, f]         (f32, as forward)
//   dmsg[b, e, f] = 1[pre > 0] * g[b, dst_e, f]           (0 if dst_e invalid)
//   dx[b, n, f]   = sum_{e : src_e = n} dmsg[b, e, f]
//   dtable[k, f]  = sum_{b, e} boh[b, e, k] * dmsg[b, e, f]
// An edge whose src is out of range adds nothing to dx, but its relu(emb)
// still reaches dtable when its dst is valid (one-hot semantics).  bf16
// mode rounds g to bf16 (so dmsg is bf16 exactly) and dx to bf16, as the
// TPU kernel returns dx in x's bf16 dtype; dtable stays f32.  The layout
// is the forward's with the roles swapped: one block per (graph, 128-
// feature chunk), each thread owning a feature column and walking the
// edges in order, accumulating dx in its column of a shared tile and its
// dtable column in shared memory.  dtable is a sum over the whole batch:
// each block writes its graph's partial [D, chunk] and a second launch
// adds the B partials in graph order (partials.cuh) -- no float atomics,
// the same result on every run.  Bound: device memory, like the forward.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "partials.cuh"

namespace {

constexpr int kFeatChunk = 128;  // features per block == threads per block

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kFeatChunk)
gin_messages_fwd_kernel(const float* __restrict__ x,
                        const int* __restrict__ src,
                        const int* __restrict__ dst,
                        const float* __restrict__ boh,
                        const float* __restrict__ table,
                        float* __restrict__ out,
                        int N, int E, int D, int F, int bf16) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [N][kFeatChunk]
  float* acc = xs + N * kFeatChunk;          // [N][kFeatChunk]
  float* tbl = acc + N * kFeatChunk;         // [D][kFeatChunk]
  float* bo = tbl + D * kFeatChunk;          // [E][D]
  int* s_src = reinterpret_cast<int*>(bo + E * D);  // [E]
  int* s_dst = s_src + E;                            // [E]

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int f = blockIdx.y * kFeatChunk + t;
  const bool active = f < F;

  const float* xb = x + static_cast<size_t>(b) * N * F;
  for (int n = 0; n < N; ++n) {
    float v = active ? xb[static_cast<size_t>(n) * F + f] : 0.f;
    xs[n * kFeatChunk + t] = bf16 ? round_bf16(v) : v;
    acc[n * kFeatChunk + t] = 0.f;
  }
  for (int k = 0; k < D; ++k) {
    float v = active ? table[static_cast<size_t>(k) * F + f] : 0.f;
    tbl[k * kFeatChunk + t] = bf16 ? round_bf16(v) : v;
  }
  const float* bob = boh + static_cast<size_t>(b) * E * D;
  for (int i = t; i < E * D; i += blockDim.x) {
    float v = bob[i];
    bo[i] = bf16 ? round_bf16(v) : v;
  }
  for (int i = t; i < E; i += blockDim.x) {
    s_src[i] = src[static_cast<size_t>(b) * E + i];
    s_dst[i] = dst[static_cast<size_t>(b) * E + i];
  }
  __syncthreads();

  for (int e = 0; e < E; ++e) {
    const int dn = s_dst[e];
    if (dn < 0 || dn >= N) continue;  // same branch for the whole block
    const int sn = s_src[e];
    const float* bor = bo + e * D;
    float emb = 0.f;
    for (int k = 0; k < D; ++k) emb = fmaf(bor[k], tbl[k * kFeatChunk + t], emb);
    const float g = (sn >= 0 && sn < N) ? xs[sn * kFeatChunk + t] : 0.f;
    float m = fmaxf(g + emb, 0.f);
    if (bf16) m = round_bf16(m);
    acc[dn * kFeatChunk + t] += m;
  }

  // each thread read and wrote only its own column: no barrier needed
  if (active) {
    float* ob = out + static_cast<size_t>(b) * N * F;
    for (int n = 0; n < N; ++n) ob[static_cast<size_t>(n) * F + f] = acc[n * kFeatChunk + t];
  }
}

__global__ void __launch_bounds__(kFeatChunk)
gin_messages_bwd_kernel(const float* __restrict__ x,
                        const int* __restrict__ src,
                        const int* __restrict__ dst,
                        const float* __restrict__ boh,
                        const float* __restrict__ table,
                        const float* __restrict__ g,
                        float* __restrict__ dx,
                        float* __restrict__ dtable_part,   // [B, D, F]
                        int N, int E, int D, int F, int bf16) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [N][kFeatChunk]
  float* gs = xs + N * kFeatChunk;           // [N][kFeatChunk]
  float* dxa = gs + N * kFeatChunk;          // [N][kFeatChunk]
  float* tbl = dxa + N * kFeatChunk;         // [D][kFeatChunk]
  float* dta = tbl + D * kFeatChunk;         // [D][kFeatChunk]
  float* bo = dta + D * kFeatChunk;          // [E][D]
  int* s_src = reinterpret_cast<int*>(bo + E * D);  // [E]
  int* s_dst = s_src + E;                            // [E]

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int f = blockIdx.y * kFeatChunk + t;
  const bool active = f < F;

  const float* xb = x + static_cast<size_t>(b) * N * F;
  const float* gb = g + static_cast<size_t>(b) * N * F;
  for (int n = 0; n < N; ++n) {
    const float xv = active ? xb[static_cast<size_t>(n) * F + f] : 0.f;
    const float gv = active ? gb[static_cast<size_t>(n) * F + f] : 0.f;
    xs[n * kFeatChunk + t] = bf16 ? round_bf16(xv) : xv;
    gs[n * kFeatChunk + t] = bf16 ? round_bf16(gv) : gv;
    dxa[n * kFeatChunk + t] = 0.f;
  }
  for (int k = 0; k < D; ++k) {
    const float v = active ? table[static_cast<size_t>(k) * F + f] : 0.f;
    tbl[k * kFeatChunk + t] = bf16 ? round_bf16(v) : v;
    dta[k * kFeatChunk + t] = 0.f;
  }
  const float* bob = boh + static_cast<size_t>(b) * E * D;
  for (int i = t; i < E * D; i += blockDim.x) {
    const float v = bob[i];
    bo[i] = bf16 ? round_bf16(v) : v;
  }
  for (int i = t; i < E; i += blockDim.x) {
    s_src[i] = src[static_cast<size_t>(b) * E + i];
    s_dst[i] = dst[static_cast<size_t>(b) * E + i];
  }
  __syncthreads();

  for (int e = 0; e < E; ++e) {
    const int dn = s_dst[e];
    if (dn < 0 || dn >= N) continue;  // g_msg = 0: nothing flows back
    const int sn = s_src[e];
    const bool src_ok = sn >= 0 && sn < N;
    const float* bor = bo + e * D;
    float emb = 0.f;
    for (int k = 0; k < D; ++k) emb = fmaf(bor[k], tbl[k * kFeatChunk + t], emb);
    const float pre = (src_ok ? xs[sn * kFeatChunk + t] : 0.f) + emb;
    if (pre > 0.f) {
      const float d = gs[dn * kFeatChunk + t];
      if (src_ok) dxa[sn * kFeatChunk + t] += d;
      for (int k = 0; k < D; ++k) dta[k * kFeatChunk + t] = fmaf(bor[k], d, dta[k * kFeatChunk + t]);
    }
  }

  // each thread read and wrote only its own columns: no barrier needed
  if (active) {
    float* dxb = dx + static_cast<size_t>(b) * N * F;
    for (int n = 0; n < N; ++n) {
      const float v = dxa[n * kFeatChunk + t];
      dxb[static_cast<size_t>(n) * F + f] = bf16 ? round_bf16(v) : v;
    }
    float* pb = dtable_part + static_cast<size_t>(b) * D * F;
    for (int k = 0; k < D; ++k) pb[static_cast<size_t>(k) * F + f] = dta[k * kFeatChunk + t];
  }
}

}  // namespace

extern "C" int gin_messages_fwd(const float* x, const int* src, const int* dst,
                                const float* boh, const float* table, float* out,
                                int B, int N, int E, int D, int F, int bf16,
                                void* stream) {
  const size_t smem = static_cast<size_t>(2 * N + D) * kFeatChunk * sizeof(float) +
                      static_cast<size_t>(E) * D * sizeof(float) +
                      static_cast<size_t>(2 * E) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      gin_messages_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (F + kFeatChunk - 1) / kFeatChunk);
  gin_messages_fwd_kernel<<<grid, kFeatChunk, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, src, dst, boh, table, out, N, E, D, F, bf16);
  return static_cast<int>(cudaGetLastError());
}

// dx [B, N, F] and dtable [D, F]; dtable_part is caller-allocated scratch
// of B * D * F floats.
extern "C" int gin_messages_bwd(const float* x, const int* src, const int* dst,
                                const float* boh, const float* table,
                                const float* g, float* dx, float* dtable,
                                float* dtable_part, int B, int N, int E, int D,
                                int F, int bf16, void* stream) {
  const size_t smem = static_cast<size_t>(3 * N + 2 * D) * kFeatChunk * sizeof(float) +
                      static_cast<size_t>(E) * D * sizeof(float) +
                      static_cast<size_t>(2 * E) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      gin_messages_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, (F + kFeatChunk - 1) / kFeatChunk);
  gin_messages_bwd_kernel<<<grid, kFeatChunk, smem, s>>>(
      x, src, dst, boh, table, g, dx, dtable_part, N, E, D, F, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partials::sum_rows(dtable_part, dtable, B, D * F, s);
  return static_cast<int>(cudaGetLastError());
}
