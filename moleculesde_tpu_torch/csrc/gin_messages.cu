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
// mode rounds x, boh, table and g to bf16 (so dmsg is bf16 exactly) and dx
// to bf16, as the TPU kernel returns dx in x's bf16 dtype; dtable stays
// f32.
//
// Bound: device memory.  x and g are read and dx written once, ~15.7 MB
// with the edges and one-hots at B=128, N=32, E=128, F=300, D=13: 0.0047
// ms at 3.35 TB/s; the ~2*E*F*(2D+1) flops per graph are far below the
// ridge.  What holds the kernel back is the work per (edge, feature): each
// needs the edge's one-hot row broadcast to every lane, 2D FMAs and its
// bookkeeping, so it is bound by instruction issue and by the latency of
// each warp's walk, not by bytes.  Design: one block of 8 warps per
// (graph, 64-feature chunk): 2 warp columns of 32 features (one a lane,
// its table column in registers) by 4 node ranges.  No tile grows with N:
// any N whose edge data fits a block runs (bwd_smem; N ~ 660 at E = 4 N).
//  1. staging: the graph's edge lists and bond one-hot rows (zero padded
//     to MAXD columns), every load of a round issued before its stores;
//  2. a stable counting sort of the edges whose dst is valid by source
//     node (bin N: an out-of-range src): integer-atomic counts, a warp
//     scan, each edge's rank among the earlier edges of its bin;
//  3. the walk: each warp takes whole nodes cut at equal shares of the
//     kept edges (molecules fill the low node indices, so equal node
//     ranges would leave most warps idle) and walks their edges, a
//     contiguous run of the sorted list, 4 at a time, the next 4 edges'
//     gathers of g[dst] and x[src] (128-byte runs a warp, straight from
//     device memory) issued before the current 4 are summed: pre, dmsg,
//     the node's dx in edge order and the warp's dtable column in
//     registers.  dx is written once per node by its owner, zero for a
//     node with no edge: no atomics;
//  4. the warps' dtable columns summed over the node ranges in order;
//     a second launch adds the graphs' partials in a fixed order
//     (partials.cuh, sum_rows): the same bits on every run.
// With -DPHASE_PROFILE, thread 0 stamps the end of each step and the
// start of its warp's first three edge groups
// (benchmarks/profile_gin_pair.py --phases).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "partials.cuh"

constexpr int kPhaseSlots = 8;   // PHASE_PROFILE marks per block

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

constexpr int kBwdWarps = 8;                     // warps per backward block
constexpr int kBwdGroups = 2;                    // warp columns of 32 features
constexpr int kBwdFeat = 32 * kBwdGroups;        // features per block
constexpr int kBwdSlots = kBwdWarps / kBwdGroups;  // node ranges per block
constexpr int kUnroll = 4;                       // edges whose gathers fly together
constexpr int kStage = 8;                        // one-hot words a thread copies per round

// One-hot columns staged per edge: D rounded up to 16 or 32, 0 if D > 32.
int bwd_maxd(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : 0; }

// Shared memory of the backward at (N, E, D), 0 where it has no plan:
// one-hot rows [E][MAXD], the warps' dtable columns [slots][MAXD][64],
// the edges' bins, src, dst and sorted order [E] each, bin starts
// [N + 2].  Mirrored by ops/gin_messages.py::bwd_plan.
size_t bwd_smem(int N, int E, int D) {
  const int maxd = bwd_maxd(D);
  if (maxd == 0) return 0;
  const size_t words = static_cast<size_t>(E) * maxd + kBwdSlots * maxd * kBwdFeat +
                       4 * static_cast<size_t>(E) + static_cast<size_t>(N) + 2;
  return words * 4 <= kSmemLimit ? words * 4 : 0;
}

// MAXD: staged one-hot columns (16 or 32); KD: the columns summed, D
// itself for the repo's bond one-hots (D = 13), else MAXD (zero padded).
template <int MAXD, int KD>
__global__ void __launch_bounds__(32 * kBwdWarps)
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
  float* bo = smem;                                   // [E][MAXD]
  float* red = bo + static_cast<size_t>(E) * MAXD;    // [kBwdSlots][MAXD][kBwdFeat]
  int* bins = reinterpret_cast<int*>(red + kBwdSlots * MAXD * kBwdFeat);  // [E]
  int* s_src = bins + E;                              // [E]
  int* s_dst = s_src + E;                             // [E]
  int* order = s_dst + E;                             // [E] kept edges by (bin, edge)
  int* start = order + E;                             // [N + 2] bin starts

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = warp % kBwdGroups;
  const int slot = warp / kBwdGroups;
  const int nthr = 32 * kBwdWarps;
  const int col = grp * 32 + lane;                    // the thread's feature in the block
  const int f = blockIdx.y * kBwdFeat + col;
  const bool active = f < F;

  PHASE_MARK(0);
  // stage the edges (each with its bin: its src node, N for an
  // out-of-range src, -1 = dropped for an out-of-range dst) and the
  // one-hot rows, every load of a round issued before its stores; the
  // table column goes to registers
  float tb[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    const float v = (active && k < D) ? table[static_cast<size_t>(k) * F + f] : 0.f;
    tb[k] = bf16 ? round_bf16(v) : v;
  }
  for (int i = tid; i < N + 2; i += nthr) start[i] = 0;
  const int* srcb = src + static_cast<size_t>(b) * E;
  const int* dstb = dst + static_cast<size_t>(b) * E;
  for (int i = tid; i < E; i += nthr) {
    const int sn = srcb[i], dn = dstb[i];
    s_src[i] = sn;
    s_dst[i] = dn;
    bins[i] = (dn < 0 || dn >= N) ? -1 : (sn >= 0 && sn < N) ? sn : N;
  }
  const float* bob = boh + static_cast<size_t>(b) * E * D;
  for (int base = 0; base < E * MAXD; base += nthr * kStage) {
    float v[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = base + j * nthr + tid;
      const int e = i / MAXD, k = i - e * MAXD;
      v[j] = (i < E * MAXD && k < D) ? bob[static_cast<size_t>(e) * D + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = base + j * nthr + tid;
      if (i < E * MAXD) bo[i] = bf16 ? round_bf16(v[j]) : v[j];
    }
  }
  __syncthreads();
  PHASE_MARK(1);

  // stable counting sort of the kept edges by bin: counts (integer
  // atomics, the same counts whatever their order), a warp scan of them,
  // and each edge's rank among the earlier edges of its bin
  for (int i = tid; i < E; i += nthr)
    if (bins[i] >= 0) atomicAdd(&start[bins[i] + 1], 1);
  __syncthreads();
  if (warp == 0) {   // inclusive scan of start[0 .. N+1]: start[i] = edges of bins < i
    int carry = 0;
    for (int base = 0; base < N + 2; base += 32) {
      const int i = base + lane;
      int v = i < N + 2 ? start[i] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (i < N + 2) start[i] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += nthr) {
    const int bin = bins[e];
    if (bin < 0) continue;
    int rank = 0, q = 0;
    const int4* b4 = reinterpret_cast<const int4*>(bins);
    for (; q + 4 <= e; q += 4) {
      const int4 v = b4[q >> 2];
      rank += (v.x == bin) + (v.y == bin) + (v.z == bin) + (v.w == bin);
    }
    for (; q < e; ++q) rank += bins[q] == bin;
    order[start[bin] + rank] = e;
  }
  __syncthreads();
  PHASE_MARK(2);

  // the warp's nodes [n0, n1), whole nodes cut at about equal shares of
  // the kept edges, and their edges order[p0 .. p1) (the last range also
  // walks bin N: dtable only)
  const int kept = start[N + 1];
  auto node_at = [&](int r) {   // first node whose edges start at or past share r
    const int target = static_cast<int>(static_cast<long long>(r) * kept / kBwdSlots);
    int lo = 0, hi = N;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (start[mid] >= target) hi = mid; else lo = mid + 1;
    }
    return lo;
  };
  const int n0 = node_at(slot);
  const int n1 = slot == kBwdSlots - 1 ? N : node_at(slot + 1);
  const int p0 = start[n0];
  const int p1 = slot == kBwdSlots - 1 ? kept : start[n1];
  const float* xb = x + static_cast<size_t>(b) * N * F;
  const float* gb = g + static_cast<size_t>(b) * N * F;
  float* dxb = dx + static_cast<size_t>(b) * N * F;

  // kUnroll edges' gathers in flight together, the next group's issued
  // before the current group is summed
  int es[kUnroll], es_next[kUnroll];
  float xv[kUnroll], gv[kUnroll], xv_next[kUnroll], gv_next[kUnroll];
  auto gather = [&](int p, int (&e_o)[kUnroll], float (&x_o)[kUnroll], float (&g_o)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e_o[u] = -1;
      x_o[u] = g_o[u] = 0.f;
      if (p + u < p1) {
        const int e = order[p + u];
        const int sn = s_src[e];
        e_o[u] = e;
        if (active) {
          g_o[u] = gb[static_cast<size_t>(s_dst[e]) * F + f];
          if (sn >= 0 && sn < N) x_o[u] = xb[static_cast<size_t>(sn) * F + f];
        }
      }
    }
  };
  auto flush = [&](int node, float& a) {
    if (active) dxb[static_cast<size_t>(node) * F + f] = bf16 ? round_bf16(a) : a;
    a = 0.f;
  };
  float dt[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) dt[k] = 0.f;
  float acc = 0.f;   // dx of node n
  int n = n0;
  gather(p0, es, xv, gv);
  for (int p = p0; p < p1; p += kUnroll) {
    if ((p - p0) / kUnroll < 3) PHASE_MARK(5 + (p - p0) / kUnroll);
    gather(p + kUnroll, es_next, xv_next, gv_next);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = es[u];
      if (e >= 0) {
        const int bin = bins[e];
        for (; n < bin && n < n1; ++n) flush(n, acc);   // nodes before this edge's are done
        // the one-hot row: whole float4 broadcasts, then the KD % 4 rest
        float bk[KD];
        const float* row = bo + static_cast<size_t>(e) * MAXD;
#pragma unroll
        for (int k4 = 0; k4 < KD / 4; ++k4) {
          const float4 v = reinterpret_cast<const float4*>(row)[k4];
          bk[4 * k4 + 0] = v.x;
          bk[4 * k4 + 1] = v.y;
          bk[4 * k4 + 2] = v.z;
          bk[4 * k4 + 3] = v.w;
        }
#pragma unroll
        for (int k = KD / 4 * 4; k < KD; ++k) bk[k] = row[k];
        float emb = 0.f;
#pragma unroll
        for (int k = 0; k < KD; ++k) emb = fmaf(bk[k], tb[k], emb);
        const float pre = (bf16 ? round_bf16(xv[u]) : xv[u]) + emb;
        const float dm = pre > 0.f ? (bf16 ? round_bf16(gv[u]) : gv[u]) : 0.f;
        if (bin < N) acc += dm;
#pragma unroll
        for (int k = 0; k < KD; ++k) dt[k] = fmaf(bk[k], dm, dt[k]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      es[u] = es_next[u];
      xv[u] = xv_next[u];
      gv[u] = gv_next[u];
    }
  }
  for (; n < n1; ++n) flush(n, acc);

  // the block's dtable partial: the node ranges' columns summed in order
#pragma unroll
  for (int k = 0; k < KD; ++k) red[(slot * MAXD + k) * kBwdFeat + col] = dt[k];
  __syncthreads();
  PHASE_MARK(3);
  float* pb = dtable_part + static_cast<size_t>(b) * D * F;
  for (int i = tid; i < D * kBwdFeat; i += nthr) {
    const int k = i / kBwdFeat, fl = i - k * kBwdFeat;
    const int fg = blockIdx.y * kBwdFeat + fl;
    if (fg >= F) continue;
    float v = 0.f;
    for (int r = 0; r < kBwdSlots; ++r) v += red[(r * MAXD + k) * kBwdFeat + fl];
    pb[static_cast<size_t>(k) * F + fg] = v;
  }
  PHASE_MARK(4);
}

template <int MAXD, int KD>
int launch_bwd(const float* x, const int* src, const int* dst, const float* boh,
               const float* table, const float* g, float* dx, float* dtable_part,
               int B, int N, int E, int D, int F, int bf16, size_t smem,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gin_messages_bwd_kernel<MAXD, KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (F + kBwdFeat - 1) / kBwdFeat);
  gin_messages_bwd_kernel<MAXD, KD><<<grid, 32 * kBwdWarps, smem, s>>>(
      x, src, dst, boh, table, g, dx, dtable_part, N, E, D, F, bf16);
  return static_cast<int>(cudaGetLastError());
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
// of B * D * F floats.  Needs D <= 32 and edge data that fits (bwd_smem).
extern "C" int gin_messages_bwd(const float* x, const int* src, const int* dst,
                                const float* boh, const float* table,
                                const float* g, float* dx, float* dtable,
                                float* dtable_part, int B, int N, int E, int D,
                                int F, int bf16, void* stream) {
  const size_t smem = bwd_smem(N, E, D);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      D == 13 ? launch_bwd<16, 13>(x, src, dst, boh, table, g, dx, dtable_part, B, N, E, D,
                                   F, bf16, smem, s)
      : bwd_maxd(D) == 16 ? launch_bwd<16, 16>(x, src, dst, boh, table, g, dx, dtable_part,
                                               B, N, E, D, F, bf16, smem, s)
      : launch_bwd<32, 32>(x, src, dst, boh, table, g, dx, dtable_part, B, N, E, D, F, bf16,
                           smem, s);
  if (rc != 0) return rc;
  partials::sum_rows(dtable_part, dtable, B, D * F, s);
  return static_cast<int>(cudaGetLastError());
}

// The backward's shared memory at (N, E, D) as the launch computes it, 0
// where it has no plan (ops/gin_messages.py::bwd_plan mirrors it).
extern "C" long long gin_messages_bwd_smem(int N, int E, int D) {
  return static_cast<long long>(bwd_smem(N, E, D));
}
