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
// D=13), far below the 295 flop/byte ridge.  Like the backward's, the
// walk is bound by instruction issue per (edge, feature).  Design
// (redesigned on the backward's layout, keyed by dst): the backward's
// blocks of 8 warps per (graph, 64-feature chunk), its staging (step 1
// below) and its stable counting sort (step 2), the edges binned by dst
// (an out-of-range dst drops the edge); each warp walks whole dst nodes
// cut at equal shares of the kept edges, gathering x[src] straight from
// device memory 4 edges ahead, the table column in registers, and writes
// each node's sum once (zero for a node with no edge).  The sort is stable,
// so a node's messages are summed in edge order, as the first version of
// this kernel summed them: the same bits.  No tile grows with N: any N
// whose edge data fits a block runs (edge_smem; N ~ 717 at E = 4 N).
// With -DPHASE_PROFILE, thread 0 stamps the start and the end of the
// staging, the sort and the walk.
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
// any N whose edge data fits a block runs (edge_smem; N ~ 660 at E = 4 N).
// Steps 1 and 2 are one device function for both directions
// (stage_and_sort), which bins by src here and by dst in the forward.
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
//
// The ranges plan (both directions), where a graph's edge data does not
// fit a block (past N ~ 717 forward, ~ 660 backward at E = 4 N) or D > 32:
//  * a pre-pass (gin_sort_kernel, a block per graph) runs steps 1 and 2 in
//    device memory: each edge's bin, the bins' starts and the kept edges'
//    stable order, the same counting sort (a warp ranks 32 edges at a time
//    with __match_any_sync, in edge order, against per-bin cursors kept in
//    shared memory where N + 2 words fit 64 KB, else in device memory);
//  * the walk runs in blocks of (graph, node range r of R, 64-feature
//    chunk): the graph's kept edges are cut into 4 R slots at equal shares
//    (node_at), a block's 4 warp slots walk theirs as in the block plan,
//    reading src, dst, the one-hot rows and the sorted order from device
//    memory.  R = ceil(E / 256).  No shared memory grows with N or E: the
//    forward needs none, the backward its warps' dtable columns (32 KB);
//  * D > 32: the embedding's sum runs over the one-hot row in 32-column
//    slices (the table read from device memory, k in order), and the
//    backward runs one block per 32-column slice of dtable (blocks of
//    slice 0 write dx);
//  * the backward's dtable partials are one row per (graph, range [,
//    slice]), added in a fixed order (partials.cuh).
// Each node's messages (forward) and each source's dmsg (backward) are
// still summed in edge order by one thread: at R = 1 and D <= 32 the ranges
// plan gives the block plan's bits, and past it the forward the same bits
// as its plain version's order would in one chain.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "partials.cuh"

constexpr int kPhaseSlots = 8;   // PHASE_PROFILE marks per block

namespace {

constexpr int kWarps = 8;                        // warps per block (both directions)
constexpr int kGroups = 2;                       // warp columns of 32 features
constexpr int kFeat = 32 * kGroups;              // features per block
constexpr int kSlots = kWarps / kGroups;         // node ranges per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;                       // edges whose gathers fly together
constexpr int kStage = 8;                        // one-hot words a thread copies per round
constexpr int kRangeEdges = 256;                 // ranges plan: edges a block walks, about
constexpr int kSortSmemWords = 16384;            // ranges plan: cursors in shared memory up to

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One-hot columns staged per edge: D rounded up to 16 or 32, 0 if D > 32.
int maxd_of(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : 0; }

// Shared memory of the block plan at (N, E, D), 0 where it has none: one-hot
// rows [E][MAXD], the edges' bins, src, dst and sorted order [E] each, bin
// starts [N + 2]; the backward adds the warps' dtable columns
// [slots][MAXD][64].  Mirrored by ops/gin_messages.py::fwd_plan / bwd_plan.
size_t edge_smem(int N, int E, int D, bool bwd) {
  const int maxd = maxd_of(D);
  if (maxd == 0) return 0;
  const size_t words = static_cast<size_t>(E) * maxd + (bwd ? kSlots * maxd * kFeat : 0) +
                       4 * static_cast<size_t>(E) + static_cast<size_t>(N) + 2;
  return words * 4 <= kSmemLimit ? words * 4 : 0;
}

// The ranges plan: node ranges a graph (R), and its two kernels' shared
// memory (the sort's cursors where they fit 64 KB; the backward walk's
// dtable columns of a 16- or 32-column slice).
__host__ __device__ inline int ranges_of(int E) {
  return E <= kRangeEdges ? 1 : (E + kRangeEdges - 1) / kRangeEdges;
}
__host__ __device__ inline size_t sort_smem(int N) {
  return N + 2 <= kSortSmemWords ? 4 * static_cast<size_t>(N + 2) : 0;
}
size_t walk_smem(int D, bool bwd) {
  return bwd ? 4 * static_cast<size_t>(kSlots) * (D <= 16 ? 16 : 32) * kFeat : 0;
}

// The shared-memory arrays of a block's edges (edge_smem's layout; the
// backward's dtable columns follow the one-hot rows).
struct EdgeArrays {
  float* bo;      // [E][MAXD] one-hot rows, rounded in bf16 mode
  float* red;     // [kSlots][MAXD][kFeat] (backward)
  int* bins;      // [E] the edge's node (src or dst), N, or -1 = dropped
  int* s_src;     // [E]
  int* s_dst;     // [E]
  int* order;     // [E] kept edges by (bin, edge)
  int* start;     // [N + 2] bin starts
};

template <int MAXD>
__device__ __forceinline__ EdgeArrays edge_arrays(float* smem, int E, bool bwd) {
  EdgeArrays s;
  s.bo = smem;
  s.red = s.bo + static_cast<size_t>(E) * MAXD;
  s.bins = reinterpret_cast<int*>(s.red + (bwd ? kSlots * MAXD * kFeat : 0));
  s.s_src = s.bins + E;
  s.s_dst = s.s_src + E;
  s.order = s.s_dst + E;
  s.start = s.order + E;
  return s;
}

// What a walk reads of one graph's edges: the block plan's shared arrays
// (one-hot rows staged [E][MAXD], rounded), or the ranges plan's device
// memory (the sort's bins, order and starts, the caller's src, dst and
// one-hot rows [E][D], unrounded).
struct EdgeView {
  const int* bins;
  const int* order;
  const int* start;
  const int* src;
  const int* dst;
  const float* bo;
};

__device__ __forceinline__ EdgeView view_of(const EdgeArrays& s) {
  return EdgeView{s.bins, s.order, s.start, s.s_src, s.s_dst, s.bo};
}

// An edge's bin: BY_DST (forward) its dst, -1 (dropped) if out of range;
// otherwise (backward) -1 for an out-of-range dst, else its src, N for an
// out-of-range src.
template <bool BY_DST>
__device__ __forceinline__ int bin_of(int sn, int dn, int N) {
  return (dn < 0 || dn >= N) ? -1 : BY_DST ? dn : (sn >= 0 && sn < N) ? sn : N;
}

// Steps 1 and 2 of both directions (the header): stage graph b's edges and
// one-hot rows, then sort the kept edges stably by bin (bin_of).  Stamps
// PHASE_MARK 1 and 2.
template <int MAXD, bool BY_DST>
__device__ __forceinline__ void stage_and_sort(const EdgeArrays& s, const int* __restrict__ src,
                                               const int* __restrict__ dst,
                                               const float* __restrict__ boh, int b, int N,
                                               int E, int D, int bf16) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < N + 2; i += kThreads) s.start[i] = 0;
  const int* srcb = src + static_cast<size_t>(b) * E;
  const int* dstb = dst + static_cast<size_t>(b) * E;
  for (int i = tid; i < E; i += kThreads) {
    const int sn = srcb[i], dn = dstb[i];
    s.s_src[i] = sn;
    s.s_dst[i] = dn;
    s.bins[i] = bin_of<BY_DST>(sn, dn, N);
  }
  // every load of a round issued before its stores
  const float* bob = boh + static_cast<size_t>(b) * E * D;
  for (int base = 0; base < E * MAXD; base += kThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = base + j * kThreads + tid;
      const int e = i / MAXD, k = i - e * MAXD;
      v[j] = (i < E * MAXD && k < D) ? bob[static_cast<size_t>(e) * D + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = base + j * kThreads + tid;
      if (i < E * MAXD) s.bo[i] = bf16 ? round_bf16(v[j]) : v[j];
    }
  }
  __syncthreads();
  PHASE_MARK(1);

  // counts (integer atomics, the same counts whatever their order), a
  // warp scan of them, and each edge's rank among the earlier edges of
  // its bin
  for (int i = tid; i < E; i += kThreads)
    if (s.bins[i] >= 0) atomicAdd(&s.start[s.bins[i] + 1], 1);
  __syncthreads();
  if (tid < 32) {   // inclusive scan of start[0 .. N+1]: start[i] = edges of bins < i
    int carry = 0;
    for (int base = 0; base < N + 2; base += 32) {
      const int i = base + lane;
      int v = i < N + 2 ? s.start[i] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (i < N + 2) s.start[i] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const int bin = s.bins[e];
    if (bin < 0) continue;
    int rank = 0, q = 0;
    const int4* b4 = reinterpret_cast<const int4*>(s.bins);
    for (; q + 4 <= e; q += 4) {
      const int4 v = b4[q >> 2];
      rank += (v.x == bin) + (v.y == bin) + (v.z == bin) + (v.w == bin);
    }
    for (; q < e; ++q) rank += s.bins[q] == bin;
    s.order[s.start[bin] + rank] = e;
  }
  __syncthreads();
  PHASE_MARK(2);
}

// The ranges plan's steps 1 and 2 for graph blockIdx.x in device memory:
// bins [B][E], order [B][E], start [B][N + 2] as stage_and_sort leaves them
// in shared memory.  The counts go to per-bin cursors (shared memory where
// sort_smem says so, else cursor_g [B][N + 2]), a warp scans them into
// start, and one warp ranks the edges 32 at a time in edge order: the
// lanes of a bin (__match_any_sync) take the bin's next places in lane
// order, its first lane moving the cursor: the same stable order.
template <bool BY_DST>
__global__ void __launch_bounds__(kThreads)
gin_sort_kernel(const int* __restrict__ src, const int* __restrict__ dst, int* __restrict__ bins,
                int* __restrict__ order, int* __restrict__ start, int* __restrict__ cursor_g,
                int N, int E) {
  extern __shared__ int cursor_s[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  int* cur = sort_smem(N) ? cursor_s : cursor_g + static_cast<size_t>(b) * (N + 2);
  int* st = start + static_cast<size_t>(b) * (N + 2);
  int* bn = bins + static_cast<size_t>(b) * E;
  int* od = order + static_cast<size_t>(b) * E;
  const int* srcb = src + static_cast<size_t>(b) * E;
  const int* dstb = dst + static_cast<size_t>(b) * E;
  for (int i = tid; i < N + 2; i += kThreads) cur[i] = 0;
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const int bin = bin_of<BY_DST>(srcb[e], dstb[e], N);
    bn[e] = bin;
    if (bin >= 0) atomicAdd(&cur[bin + 1], 1);
  }
  __syncthreads();
  if (tid >= 32) return;
  int carry = 0;
  for (int base = 0; base < N + 2; base += 32) {
    const int i = base + lane;
    int v = i < N + 2 ? cur[i] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (i < N + 2) cur[i] = st[i] = v + carry;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
  __syncwarp();
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const int bin = e < E ? bn[e] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    const int leader = __ffs(peers) - 1;
    int pos = 0;
    if (bin >= 0 && lane == leader) {
      pos = cur[bin];
      cur[bin] = pos + __popc(peers);
    }
    pos = __shfl_sync(0xffffffffu, pos, leader);
    if (bin >= 0) od[pos + __popc(peers & ((1u << lane) - 1u))] = e;
    __syncwarp();
  }
}

// The first node whose edges start at or past share r of `slots` shares of
// the kept edges: slot r walks nodes [node_at(r), node_at(r + 1)), whole
// nodes at about equal shares of the edges (molecules fill the low node
// indices, so equal node ranges would leave most warps idle).
__device__ __forceinline__ int node_at(const int* start, int N, int kept, int r, int slots) {
  const int target = static_cast<int>(static_cast<long long>(r) * kept / slots);
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] >= target) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// The edge's one-hot row as KD values: staged rows ([E][MAXD], rounded):
// whole float4 broadcasts, then the KD % 4 rest; device-memory rows
// ([E][D]): k < D, rounded here in bf16 mode, zero past D.
template <int MAXD, int KD, bool STAGED>
__device__ __forceinline__ void one_hot_row(const float* bo, int e, int D, int bf16,
                                            float (&bk)[KD]) {
  if constexpr (STAGED) {
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
  } else {
    const float* row = bo + static_cast<size_t>(e) * D;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const float v = k < D ? row[k] : 0.f;
      bk[k] = bf16 ? round_bf16(v) : v;
    }
  }
}

// KD columns of the table in registers (KD > 0), or one slot (KD = 0: D >
// 32, the table read from device memory as the sum goes)
template <int KD>
constexpr int kTb = KD > 0 ? KD : 1;

template <int KD>
__device__ __forceinline__ void load_table(const float* table, int D, int F, int f, bool active,
                                           int bf16, float (&tb)[kTb<KD>]) {
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    const float v = (active && k < D) ? table[static_cast<size_t>(k) * F + f] : 0.f;
    tb[k] = bf16 ? round_bf16(v) : v;
  }
}

// emb = sum_k bk[k] * tb[k] as one chain in k order.  KD > 0: the row's KD
// columns against the registers; KD = 0 (ranges plan, D > 32): the row in
// 32-column slices from device memory against the table's column.
template <int MAXD, int KD, bool STAGED>
__device__ __forceinline__ float embed(const float* bo, int e, int D, const float (&tb)[kTb<KD>],
                                       const float* table, int F, int f, bool active, int bf16) {
  float emb = 0.f;
  if constexpr (KD > 0) {
    float bk[KD];
    one_hot_row<MAXD, KD, STAGED>(bo, e, D, bf16, bk);
#pragma unroll
    for (int k = 0; k < KD; ++k) emb = fmaf(bk[k], tb[k], emb);
  } else {
    const float* row = bo + static_cast<size_t>(e) * D;
    for (int k0 = 0; k0 < D; k0 += 32) {
      float bk[32], tk[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const bool in = k0 + k < D;
        const float v = in ? row[k0 + k] : 0.f;
        const float t = (in && active) ? table[static_cast<size_t>(k0 + k) * F + f] : 0.f;
        bk[k] = bf16 ? round_bf16(v) : v;
        tk[k] = bf16 ? round_bf16(t) : t;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k0 + k < D) emb = fmaf(bk[k], tk[k], emb);
    }
  }
  return emb;
}

// The forward walk of one warp: dst nodes [n0, n1), their kept edges
// order[p0 .. p1), kUnroll edges' gathers of x[src] in flight together (the
// next group's issued before the current group is summed); each node's
// sum written once (zero for a node with no edge).
template <int MAXD, int KD, bool STAGED>
__device__ __forceinline__ void walk_fwd(const EdgeView& v, const float (&tb)[kTb<KD>],
                                         const float* __restrict__ table,
                                         const float* __restrict__ xb, float* __restrict__ ob,
                                         int n0, int n1, int p0, int p1, int N, int D, int F,
                                         int f, bool active, int bf16) {
  int es[kUnroll], es_next[kUnroll];
  float xv[kUnroll], xv_next[kUnroll];
  auto gather = [&](int p, int (&e_o)[kUnroll], float (&x_o)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e_o[u] = -1;
      x_o[u] = 0.f;
      if (p + u < p1) {
        const int e = v.order[p + u];
        const int sn = v.src[e];
        e_o[u] = e;
        if (active && sn >= 0 && sn < N) x_o[u] = xb[static_cast<size_t>(sn) * F + f];
      }
    }
  };
  auto flush = [&](int node, float& a) {
    if (active) ob[static_cast<size_t>(node) * F + f] = a;
    a = 0.f;
  };
  float acc = 0.f;   // out of node n: its messages in edge order
  int n = n0;
  gather(p0, es, xv);
  for (int p = p0; p < p1; p += kUnroll) {
    gather(p + kUnroll, es_next, xv_next);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = es[u];
      if (e >= 0) {
        const int bin = v.bins[e];
        for (; n < bin; ++n) flush(n, acc);   // nodes before this edge's are done
        const float emb = embed<MAXD, KD, STAGED>(v.bo, e, D, tb, table, F, f, active, bf16);
        float m = fmaxf((bf16 ? round_bf16(xv[u]) : xv[u]) + emb, 0.f);
        if (bf16) m = round_bf16(m);
        acc += m;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      es[u] = es_next[u];
      xv[u] = xv_next[u];
    }
  }
  for (; n < n1; ++n) flush(n, acc);
}

// The backward walk of one warp: src nodes [n0, n1) and the kept edges
// order[p0 .. p1) (the graph's last slot also walks bin N: dtable only),
// kUnroll edges' gathers of g[dst] and x[src] in flight together; dx
// written once per node by its owner, dt[k] += bk[k0 + k] * dmsg for the
// KDT columns k0 .. k0 + KDT - 1 (k0 = 0 unless KD = 0); dx only where
// write_dx.
template <int MAXD, int KD, bool STAGED, int KDT>
__device__ __forceinline__ void walk_bwd(const EdgeView& v, const float (&tb)[kTb<KD>],
                                         const float* __restrict__ table,
                                         const float* __restrict__ xb,
                                         const float* __restrict__ gb, float* __restrict__ dxb,
                                         int n0, int n1, int p0, int p1, int N, int D, int F,
                                         int f, bool active, int bf16, int k0, bool write_dx,
                                         float (&dt)[KDT]) {
  int es[kUnroll], es_next[kUnroll];
  float xv[kUnroll], gv[kUnroll], xv_next[kUnroll], gv_next[kUnroll];
  auto gather = [&](int p, int (&e_o)[kUnroll], float (&x_o)[kUnroll], float (&g_o)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e_o[u] = -1;
      x_o[u] = g_o[u] = 0.f;
      if (p + u < p1) {
        const int e = v.order[p + u];
        const int sn = v.src[e];
        e_o[u] = e;
        if (active) {
          g_o[u] = gb[static_cast<size_t>(v.dst[e]) * F + f];
          if (sn >= 0 && sn < N) x_o[u] = xb[static_cast<size_t>(sn) * F + f];
        }
      }
    }
  };
  auto flush = [&](int node, float& a) {
    if (active && write_dx) dxb[static_cast<size_t>(node) * F + f] = bf16 ? round_bf16(a) : a;
    a = 0.f;
  };
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
        const int bin = v.bins[e];
        for (; n < bin && n < n1; ++n) flush(n, acc);   // nodes before this edge's are done
        float bk[KDT];
        float emb;
        if constexpr (KD > 0) {
          one_hot_row<MAXD, KD, STAGED>(v.bo, e, D, bf16, bk);
          emb = 0.f;
#pragma unroll
          for (int k = 0; k < KD; ++k) emb = fmaf(bk[k], tb[k], emb);
        } else {
          emb = embed<MAXD, 0, false>(v.bo, e, D, tb, table, F, f, active, bf16);
          const float* row = v.bo + static_cast<size_t>(e) * D + k0;
#pragma unroll
          for (int k = 0; k < KDT; ++k) {
            const float w = k0 + k < D ? row[k] : 0.f;
            bk[k] = bf16 ? round_bf16(w) : w;
          }
        }
        const float pre = (bf16 ? round_bf16(xv[u]) : xv[u]) + emb;
        const float dm = pre > 0.f ? (bf16 ? round_bf16(gv[u]) : gv[u]) : 0.f;
        if (bin < N) acc += dm;
#pragma unroll
        for (int k = 0; k < KDT; ++k) dt[k] = fmaf(bk[k], dm, dt[k]);
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
}

// MAXD: staged one-hot columns (16 or 32); KD: the columns summed, D
// itself for the repo's bond one-hots (D = 13), else MAXD (zero padded).
template <int MAXD, int KD>
__global__ void __launch_bounds__(kThreads)
gin_messages_fwd_kernel(const float* __restrict__ x,
                        const int* __restrict__ src,
                        const int* __restrict__ dst,
                        const float* __restrict__ boh,
                        const float* __restrict__ table,
                        float* __restrict__ out,
                        int N, int E, int D, int F, int bf16) {
  extern __shared__ __align__(16) float smem[];
  const EdgeArrays s = edge_arrays<MAXD>(smem, E, false);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int slot = warp / kGroups;
  const int f = blockIdx.y * kFeat + (warp % kGroups) * 32 + (threadIdx.x & 31);
  const bool active = f < F;

  PHASE_MARK(0);
  float tb[KD];   // the table column, in registers
  load_table<KD>(table, D, F, f, active, bf16, tb);
  stage_and_sort<MAXD, true>(s, src, dst, boh, b, N, E, D, bf16);

  // the warp's dst nodes [n0, n1) and their edges order[p0 .. p1)
  const int kept = s.start[N];
  const int n0 = node_at(s.start, N, kept, slot, kSlots);
  const int n1 = slot == kSlots - 1 ? N : node_at(s.start, N, kept, slot + 1, kSlots);
  walk_fwd<MAXD, KD, true>(view_of(s), tb, table, x + static_cast<size_t>(b) * N * F,
                           out + static_cast<size_t>(b) * N * F, n0, n1, s.start[n0],
                           s.start[n1], N, D, F, f, active, bf16);
  PHASE_MARK(3);
}

template <int MAXD, int KD>
__global__ void __launch_bounds__(kThreads)
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
  const EdgeArrays s = edge_arrays<MAXD>(smem, E, true);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int slot = warp / kGroups;
  const int col = (warp % kGroups) * 32 + (tid & 31);   // the thread's feature in the block
  const int f = blockIdx.y * kFeat + col;
  const bool active = f < F;

  PHASE_MARK(0);
  float tb[KD];   // the table column, in registers
  load_table<KD>(table, D, F, f, active, bf16, tb);
  stage_and_sort<MAXD, false>(s, src, dst, boh, b, N, E, D, bf16);

  // the warp's src nodes [n0, n1) and their edges order[p0 .. p1) (the
  // last range also walks bin N: dtable only)
  const int kept = s.start[N + 1];
  const int n0 = node_at(s.start, N, kept, slot, kSlots);
  const int n1 = slot == kSlots - 1 ? N : node_at(s.start, N, kept, slot + 1, kSlots);
  const int p1 = slot == kSlots - 1 ? kept : s.start[n1];
  float dt[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) dt[k] = 0.f;
  const size_t gofs = static_cast<size_t>(b) * N * F;
  walk_bwd<MAXD, KD, true, KD>(view_of(s), tb, table, x + gofs, g + gofs, dx + gofs, n0, n1,
                               s.start[n0], p1, N, D, F, f, active, bf16, 0, true, dt);

  // the block's dtable partial: the node ranges' columns summed in order
#pragma unroll
  for (int k = 0; k < KD; ++k) s.red[(slot * MAXD + k) * kFeat + col] = dt[k];
  __syncthreads();
  PHASE_MARK(3);
  float* pb = dtable_part + static_cast<size_t>(b) * D * F;
  for (int i = tid; i < D * kFeat; i += kThreads) {
    const int k = i / kFeat, fl = i - k * kFeat;
    const int fg = blockIdx.y * kFeat + fl;
    if (fg >= F) continue;
    float v = 0.f;
    for (int r = 0; r < kSlots; ++r) v += s.red[(r * MAXD + k) * kFeat + fl];
    pb[static_cast<size_t>(k) * F + fg] = v;
  }
  PHASE_MARK(4);
}

// The ranges plan's scratch for B graphs (int words): bins and order [B][E]
// each, start and the cursors [B][N + 2] each.
struct SortScratch {
  int *bins, *order, *start, *cursor;
};

SortScratch sort_scratch(int* base, int B, int N, int E) {
  const size_t be = static_cast<size_t>(B) * E, bn = static_cast<size_t>(B) * (N + 2);
  return SortScratch{base, base + be, base + 2 * be, base + 2 * be + bn};
}

// A ranges-plan block's graph, its node range r of R, its feature chunk
// (and, in the backward, its 32-column slice) from the flat block index,
// graph-major: unit = ((b R + r) slices + slice) chunks + chunk.
struct RangeBlock {
  int b, r, slice, chunk;
};

__device__ __forceinline__ RangeBlock range_block(int R, int slices, int chunks) {
  RangeBlock rb_;
  long long u = blockIdx.x;
  rb_.chunk = static_cast<int>(u % chunks);
  u /= chunks;
  rb_.slice = static_cast<int>(u % slices);
  u /= slices;
  rb_.r = static_cast<int>(u % R);
  rb_.b = static_cast<int>(u / R);
  return rb_;
}

// The warp's nodes [n0, n1) and kept edges [p0, p1) in the ranges plan:
// slot gs = 4 r + slot of the graph's 4 R (the last slot also takes bin N
// where last_bin, the backward).
__device__ __forceinline__ void range_slot(const int* start, int N, int kept, int gs, int slots,
                                           bool last_bin, int& n0, int& n1, int& p0, int& p1) {
  n0 = node_at(start, N, kept, gs, slots);
  n1 = gs == slots - 1 ? N : node_at(start, N, kept, gs + 1, slots);
  p0 = start[n0];
  p1 = (gs == slots - 1 && last_bin) ? kept : start[n1];
}

template <int KD>
__global__ void __launch_bounds__(kThreads)
gin_messages_fwd_ranges_kernel(const float* __restrict__ x, const int* __restrict__ src,
                               const int* __restrict__ dst, const float* __restrict__ boh,
                               const float* __restrict__ table, const int* __restrict__ bins,
                               const int* __restrict__ order, const int* __restrict__ start,
                               float* __restrict__ out, int N, int E, int D, int F, int R,
                               int chunks, int bf16) {
  const RangeBlock rb_ = range_block(R, 1, chunks);
  const int b = rb_.b;
  const int warp = threadIdx.x >> 5;
  const int f = rb_.chunk * kFeat + (warp % kGroups) * 32 + (threadIdx.x & 31);
  const bool active = f < F;
  PHASE_MARK(0);
  float tb[kTb<KD>];
  load_table<KD>(table, D, F, f, active, bf16, tb);
  const size_t be = static_cast<size_t>(b) * E;
  const EdgeView v{bins + be, order + be, start + static_cast<size_t>(b) * (N + 2), src + be,
                   dst + be, boh + be * D};
  int n0, n1, p0, p1;
  range_slot(v.start, N, v.start[N], rb_.r * kSlots + warp / kGroups, R * kSlots, false, n0, n1,
             p0, p1);
  walk_fwd<32, KD, false>(v, tb, table, x + static_cast<size_t>(b) * N * F,
                          out + static_cast<size_t>(b) * N * F, n0, n1, p0, p1, N, D, F, f,
                          active, bf16);
  PHASE_MARK(3);
}

// KDT: the dtable columns of a block (KD, or 32: a slice of D > 32).
template <int KD, int KDT>
__global__ void __launch_bounds__(kThreads)
gin_messages_bwd_ranges_kernel(const float* __restrict__ x, const int* __restrict__ src,
                               const int* __restrict__ dst, const float* __restrict__ boh,
                               const float* __restrict__ table, const float* __restrict__ g,
                               const int* __restrict__ bins, const int* __restrict__ order,
                               const int* __restrict__ start, float* __restrict__ dx,
                               float* __restrict__ dtable_part,   // [B R, D, F]
                               int N, int E, int D, int F, int R, int slices, int chunks,
                               int bf16) {
  __shared__ __align__(16) float red[kSlots * KDT * kFeat];
  const RangeBlock rb_ = range_block(R, slices, chunks);
  const int b = rb_.b;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int slot = warp / kGroups;
  const int col = (warp % kGroups) * 32 + (tid & 31);
  const int f = rb_.chunk * kFeat + col;
  const bool active = f < F;
  const int k0 = rb_.slice * KDT;
  PHASE_MARK(0);
  float tb[kTb<KD>];
  load_table<KD>(table, D, F, f, active, bf16, tb);
  const size_t be = static_cast<size_t>(b) * E;
  const EdgeView v{bins + be, order + be, start + static_cast<size_t>(b) * (N + 2), src + be,
                   dst + be, boh + be * D};
  int n0, n1, p0, p1;
  range_slot(v.start, N, v.start[N + 1], rb_.r * kSlots + slot, R * kSlots, true, n0, n1, p0,
             p1);
  float dt[KDT];
#pragma unroll
  for (int k = 0; k < KDT; ++k) dt[k] = 0.f;
  const size_t gofs = static_cast<size_t>(b) * N * F;
  walk_bwd<32, KD, false, KDT>(v, tb, table, x + gofs, g + gofs, dx + gofs, n0, n1, p0, p1, N,
                               D, F, f, active, bf16, k0, rb_.slice == 0, dt);
#pragma unroll
  for (int k = 0; k < KDT; ++k) red[(slot * KDT + k) * kFeat + col] = dt[k];
  __syncthreads();
  PHASE_MARK(3);
  float* pb = dtable_part + (static_cast<size_t>(b) * R + rb_.r) * D * F;
  for (int i = tid; i < KDT * kFeat; i += kThreads) {
    const int k = i / kFeat, fl = i - k * kFeat;
    const int fg = rb_.chunk * kFeat + fl;
    if (fg >= F || k0 + k >= D) continue;
    float s = 0.f;
    for (int r = 0; r < kSlots; ++r) s += red[(r * KDT + k) * kFeat + fl];
    pb[static_cast<size_t>(k0 + k) * F + fg] = s;
  }
  PHASE_MARK(4);
}

template <int MAXD, int KD>
int launch_fwd(const float* x, const int* src, const int* dst, const float* boh,
               const float* table, float* out, int B, int N, int E, int D, int F, int bf16,
               size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gin_messages_fwd_kernel<MAXD, KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (F + kFeat - 1) / kFeat);
  gin_messages_fwd_kernel<MAXD, KD><<<grid, kThreads, smem, s>>>(
      x, src, dst, boh, table, out, N, E, D, F, bf16);
  return static_cast<int>(cudaGetLastError());
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
  const dim3 grid(B, (F + kFeat - 1) / kFeat);
  gin_messages_bwd_kernel<MAXD, KD><<<grid, kThreads, smem, s>>>(
      x, src, dst, boh, table, g, dx, dtable_part, N, E, D, F, bf16);
  return static_cast<int>(cudaGetLastError());
}

// The ranges plan's pre-pass: bins, order and starts of every graph.
template <bool BY_DST>
int launch_sort(const int* src, const int* dst, const SortScratch& sc, int B, int N, int E,
                cudaStream_t s) {
  const size_t smem = sort_smem(N);
  const cudaError_t err = cudaFuncSetAttribute(
      gin_sort_kernel<BY_DST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gin_sort_kernel<BY_DST><<<B, kThreads, smem, s>>>(src, dst, sc.bins, sc.order, sc.start,
                                                    sc.cursor, N, E);
  return static_cast<int>(cudaGetLastError());
}

template <int KD>
int launch_fwd_ranges(const float* x, const int* src, const int* dst, const float* boh,
                      const float* table, float* out, const SortScratch& sc, int B, int N,
                      int E, int D, int F, int R, int bf16, cudaStream_t s) {
  const int chunks = (F + kFeat - 1) / kFeat;
  gin_messages_fwd_ranges_kernel<KD><<<static_cast<unsigned>(static_cast<long long>(B) * R *
                                                             chunks),
                                       kThreads, 0, s>>>(x, src, dst, boh, table, sc.bins,
                                                         sc.order, sc.start, out, N, E, D, F,
                                                         R, chunks, bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int KD, int KDT>
int launch_bwd_ranges(const float* x, const int* src, const int* dst, const float* boh,
                      const float* table, const float* g, float* dx, float* dtable_part,
                      const SortScratch& sc, int B, int N, int E, int D, int F, int R,
                      int bf16, cudaStream_t s) {
  const int chunks = (F + kFeat - 1) / kFeat, slices = KD > 0 ? 1 : (D + KDT - 1) / KDT;
  gin_messages_bwd_ranges_kernel<KD, KDT>
      <<<static_cast<unsigned>(static_cast<long long>(B) * R * slices * chunks), kThreads, 0,
         s>>>(x, src, dst, boh, table, g, sc.bins, sc.order, sc.start, dx, dtable_part, N, E,
              D, F, R, slices, chunks, bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [B, N, F].  ranges = 0: the block plan (needs D <= 32 and edge data
// that fits, edge_smem); ranges = R > 0: the ranges plan, with sort
// (gin_messages_sort_words(B, N, E) ints) caller-allocated scratch.
extern "C" int gin_messages_fwd(const float* x, const int* src, const int* dst,
                                const float* boh, const float* table, float* out,
                                int B, int N, int E, int D, int F, int bf16, int ranges,
                                int* sort, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ranges > 0) {
    const SortScratch sc = sort_scratch(sort, B, N, E);
    const int rc = launch_sort<true>(src, dst, sc, B, N, E, s);
    if (rc != 0) return rc;
    return D == 13 ? launch_fwd_ranges<13>(x, src, dst, boh, table, out, sc, B, N, E, D, F,
                                           ranges, bf16, s)
           : D <= 16 ? launch_fwd_ranges<16>(x, src, dst, boh, table, out, sc, B, N, E, D, F,
                                             ranges, bf16, s)
           : D <= 32 ? launch_fwd_ranges<32>(x, src, dst, boh, table, out, sc, B, N, E, D, F,
                                             ranges, bf16, s)
                     : launch_fwd_ranges<0>(x, src, dst, boh, table, out, sc, B, N, E, D, F,
                                            ranges, bf16, s);
  }
  const size_t smem = edge_smem(N, E, D, false);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return D == 13 ? launch_fwd<16, 13>(x, src, dst, boh, table, out, B, N, E, D, F, bf16,
                                      smem, s)
         : maxd_of(D) == 16 ? launch_fwd<16, 16>(x, src, dst, boh, table, out, B, N, E, D, F,
                                                 bf16, smem, s)
         : launch_fwd<32, 32>(x, src, dst, boh, table, out, B, N, E, D, F, bf16, smem, s);
}

// dx [B, N, F] and dtable [D, F]; dtable_part is caller-allocated scratch
// of B * D * F floats (block plan, ranges = 0: needs D <= 32 and edge data
// that fits, edge_smem) or B * R * D * F (ranges plan, ranges = R > 0,
// with sort as in the forward).
extern "C" int gin_messages_bwd(const float* x, const int* src, const int* dst,
                                const float* boh, const float* table,
                                const float* g, float* dx, float* dtable,
                                float* dtable_part, int B, int N, int E, int D,
                                int F, int bf16, int ranges, int* sort, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (ranges > 0) {
    const SortScratch sc = sort_scratch(sort, B, N, E);
    rc = launch_sort<false>(src, dst, sc, B, N, E, s);
    if (rc != 0) return rc;
    rc = D == 13 ? launch_bwd_ranges<13, 13>(x, src, dst, boh, table, g, dx, dtable_part, sc,
                                             B, N, E, D, F, ranges, bf16, s)
         : D <= 16 ? launch_bwd_ranges<16, 16>(x, src, dst, boh, table, g, dx, dtable_part,
                                               sc, B, N, E, D, F, ranges, bf16, s)
         : D <= 32 ? launch_bwd_ranges<32, 32>(x, src, dst, boh, table, g, dx, dtable_part,
                                               sc, B, N, E, D, F, ranges, bf16, s)
                   : launch_bwd_ranges<0, 32>(x, src, dst, boh, table, g, dx, dtable_part, sc,
                                              B, N, E, D, F, ranges, bf16, s);
    if (rc != 0) return rc;
    partials::sum_rows(dtable_part, dtable, B * ranges, D * F, s);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = edge_smem(N, E, D, true);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  rc = D == 13 ? launch_bwd<16, 13>(x, src, dst, boh, table, g, dx, dtable_part, B, N, E, D,
                                    F, bf16, smem, s)
       : maxd_of(D) == 16 ? launch_bwd<16, 16>(x, src, dst, boh, table, g, dx, dtable_part,
                                               B, N, E, D, F, bf16, smem, s)
       : launch_bwd<32, 32>(x, src, dst, boh, table, g, dx, dtable_part, B, N, E, D, F, bf16,
                            smem, s);
  if (rc != 0) return rc;
  partials::sum_rows(dtable_part, dtable, B, D * F, s);
  return static_cast<int>(cudaGetLastError());
}

// The forward's and the backward's block-plan shared memory at (N, E, D)
// as their launches compute it, 0 where there is no block plan
// (ops/gin_messages.py::fwd_plan and bwd_plan mirror them).
extern "C" long long gin_messages_fwd_smem(int N, int E, int D) {
  return static_cast<long long>(edge_smem(N, E, D, false));
}

extern "C" long long gin_messages_bwd_smem(int N, int E, int D) {
  return static_cast<long long>(edge_smem(N, E, D, true));
}

// The ranges plan at (N, E, D): out[0] its node ranges a graph, out[1] the
// sort's shared memory, out[2] the backward walk's (ops/gin_messages.py::
// _edge_plan mirrors them).
extern "C" void gin_messages_ranges_plan(int N, int E, int D, long long* out) {
  out[0] = ranges_of(E);
  out[1] = static_cast<long long>(sort_smem(N));
  out[2] = static_cast<long long>(walk_smem(D, true));
}
