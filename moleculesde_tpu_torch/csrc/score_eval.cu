// One whole 2D->3D score evaluation of SDEModel2Dto3D (variants 1 and 2)
// in one launch (K6), forward only:
//   pos [B, N, 3], node_attr [B, N, H], edge_attr_2d [B, N, N, H] and the
//   pair mask [B, N, N] (all f32), the packed weights (ops/score_kernel.py::
//   pack_score_params) -> raw score out [B, N, 3] f32.
// This source is the cluster plan, compiled for the sampler's widths
// (hidden H = 32, 8 heads, basis width 128) at n_max <= 128; the layered
// plan (csrc/score_layered.cu) takes every other width and n_max.  What
// both use sits in csrc/score_common.cuh.
// Frames, Gaussian-Fourier coefficient embeddings, the projection MLP
// (and variant 2's distance gate), four DenseGAT layers with LayerNorm and
// FFN, and the two basis-mixing modules.
//
// Replaces the Pallas kernel moleculesde_tpu/ops/score_kernel.py::_kernel
// (pallas_call at l.388, entry score_eval_fused l.353).
//
// What bounds it on this card: as separate operators an evaluation is ~550
// launches, and the PC chain was bound by the host issuing them.  In one
// launch the work itself is left: ~54 MFLOP per molecule at N = 32 (3.5
// GFLOP at B=64), ~95% of it per-pair products (the two coefficient
// embeddings [128 -> 32], the projection MLP, variant 2's input MLP, the
// edge projection of each GAT layer [32 -> 32], each basis module's edge
// MLP [32 -> 128] and its output [128 -> 3]), against ~9 MB of compulsory
// traffic.  Operation-bound: the tensor cores in bf16 mode, the CUDA cores
// in f32 mode.
//
// Design.
// - A thread-block cluster per molecule (cudaLaunchKernelEx): 2 blocks at
//   N <= 32, 4 at N <= 64, 8 at N <= 128 (ops/score_kernel.py::score_plan),
//   so that B=64 molecules fill 128, 256 or 512 SMs' worth of blocks.  Block r of a cluster
//   owns destinations [r * D, (r + 1) * D) and holds their masked edge
//   features ("the slab", rows [d][s] for every source s) in its shared
//   memory for the whole evaluation: the slab is the only large tensor.
//   Every block forms k and v of all N nodes, and q and skip of its own
//   destinations, itself (cheap); after each GAT layer it writes its destinations' new node state into every
//   peer's shared memory (distributed shared memory,
//   cluster.map_shared_rank) and the cluster synchronises.  The node state
//   is double-buffered, so one cluster.sync per layer separates a layer's
//   reads from the next layer's remote writes.  The basis modules and the
//   output rows belong to the owning block: a score row is summed in one
//   block in a fixed order, and two runs agree bit for bit.
// - N in 65..128 (four chunks of 32 sources a lane): the slab of 16
//   destinations x 128 sources is 160 KB in bf16 and 256 KB in f32, and
//   beside the 37 KB weight buffer, the 32 KB node state and the 66 KB
//   basis node part no split of it fits a block's 227 KB (16 destinations
//   a block: 350 KB; clusters of 16 blocks x 8 destinations: 232,160 B in
//   bf16, 288 B under the limit, 244,448 B in f32).  So past N = 64 the
//   slab lives in device memory, in a scratch buffer the wrapper allocates
//   (1 MB a molecule in bf16, 2 MB in f32; the 16 clusters of 8 blocks in
//   flight hold 16-32 MB, which the 50 MB L2 keeps), laid out so that each
//   lane writes in phase 1 exactly the 64 or 128 bytes it reads back in
//   the 4 GAT layers and 2 basis modules: in bf16 mode its mma.sync A
//   fragments, in f32 mode its pair's row (store_frags / store_row).
//   Shared memory is then 186,176 B (bf16) / 149,312 B (f32) whatever the
//   clusters hold, and the plans at N <= 64 keep their layout and bits.
//   A lane holds one e2 row, not four (128 floats would spill at 256
//   threads): the GAT layer takes its logits chunk by chunk, the softmax
//   its max and sum over all four, and the message forms e2 again chunk by
//   chunk, summing the terms in the same order.
// - N > 128, another width or more than 128 packed segments: the layered
//   plan (csrc/score_layered.cu), a few launches an evaluation with the
//   node-wide state in device memory, at any N and width.
// - A warp takes one destination d at a time, a lane one source s (s = 32j
//   + lane for the j-th chunk of 32 sources: one, two or four chunks); sums over
//   sources are warp shuffles, and the softmax over sources takes its max
//   and sum over every chunk.  A lane forms its pair's frame, logits,
//   softmax weight and message terms in registers; a reduce-scatter of 31
//   shuffles leaves the message of channel c in lane c, which then runs
//   LayerNorm and the FFN with warp reductions.
// - bf16 mode: the per-pair products run on the tensor cores, mma.sync
//   m16n8k16 bf16 -> f32 with the warp's 32 pairs as M and the output
//   channels as N.  Operands come from shared memory through ldmatrix: the
//   Fourier features, embeddings and silu outputs a lane writes into its
//   warp's 4.5 KB tile, the slab rows, and the weights staged once per
//   phase as bf16 tiles.  Products whose result the lanes need as rows go
//   back through the same tile (f32); the basis edge MLP's silu output
//   feeds basis_out (3 outputs, padded to 8) straight from the accumulator
//   fragments.  Both operands were already rounded to bf16 by the kernel
//   this replaces, so the products are the same and only the order of the
//   f32 sums changes.  silu takes __expf / __fdividef (its output is
//   rounded to bf16); sincosf stays accurate (its arguments c * W * 2 pi
//   are not small).
// - f32 mode: every product on the CUDA cores as per-lane FMA rows (no
//   TF32), the slab rows 128 B with their 16-byte chunks XOR-swizzled by
//   row so that the lanes' row reads hit distinct banks.
// - 512 threads at N <= 32, 256 above (a second source chunk holds more
//   registers per lane, and shared memory is full).
// - The frame basis is recomputed from the position floats wherever it is
//   needed instead of storing nine [N, N] planes.
// - Each phase's weights are staged into one 37 KB shared buffer before it,
//   by asynchronous 16-byte copies, all in flight at once (bf16 mode rounds
//   them in place; its product weights become bf16 tiles).
//
// bf16 != 0 rounds where the TPU kernel rounds (its mm() casts both
// operands, so the products with its selector matrices round too): every
// product operand (the Fourier features, the embeddings before the
// projection, silu outputs, edge features, node state, q.(k+e) terms
// before the head sum, alpha before the channel broadcast, the basis-MLP
// output before basis_out, and cc * basis before the row sum); the masked
// edge features are stored rounded; x is rounded and its residual adds
// are bf16 adds; LayerNorm takes a rounded input, keeps f32 statistics
// (eps 1e-6) and rounds its output.  Frame geometry, softmax and the sums
// stay f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "hopper.cuh"
#include "score_common.cuh"

namespace cg = cooperative_groups;

constexpr int kPhaseSlots = 32;   // PHASE_PROFILE marks per block

namespace {

using namespace score_common;   // rounding, silu, warp sums, pair frames

constexpr int kH = 32;          // hidden width
constexpr int kHeads = 8;
constexpr int kCHead = kH / kHeads;
constexpr int kCD = 128;        // basis-MLP width (hidden_coff_dim)
constexpr int kMaxS = 4;        // chunks of 32 sources a lane takes (N <= 128)
constexpr int kMaxCluster = 8;
constexpr int kMaxSegments = 128;

constexpr int kNR = kH + 1;     // q / k / v / skip row stride (bank-conflict free)
constexpr int kHPR = kCD + 1;   // basis-MLP node part row stride
constexpr int kWBuf = 9472;     // floats: the largest phase's weights (f32 variant 2 features)
constexpr int kScratch = 4608;  // bytes of a warp's tile (bf16 mode)
constexpr int kAT = 72;         // the tile as bf16 A operand: [32][72]
constexpr int kCT = 36;         // the tile as f32 rows: [32][36]
constexpr int kB32 = 40;        // bf16 weight tiles [K][32], row stride
constexpr int kB128 = 136;      // [K][128]
constexpr int kB8 = 24;         // [K][8] (basis_out, 3 columns used)
constexpr int kSlabF32Row = 32;     // floats, 16-byte chunks swizzled
constexpr int kSlabBf16Row = 40;    // bf16 values (80 bytes)

// threads per block: 16 warps at N <= 32; 8 with two or four source
// chunks, which hold more per lane (and, in bf16 mode, more shared memory)
__host__ __device__ constexpr int threads_for(bool bf16, int S) {
  return S > 1 ? 256 : 512;
}

// past 64 sources (four chunks a lane) the slab lives in device memory
__host__ __device__ constexpr bool global_slab(int S) { return S > 2; }

// chunks of 32 sources a lane takes at n_max N: the instantiation's S
__host__ __device__ constexpr int chunks_for(int N) { return N <= 32 ? 1 : N <= 64 ? 2 : 4; }

struct Offsets {
  int v[kMaxSegments];
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) & ~15; }

// byte offsets of the shared-memory regions; ops/score_kernel.py::
// score_layout counts the same
struct Layout {
  int slab, wbuf, xs, node, scratch, fs, pos, mask, cnt, grad, total;
};

__host__ __device__ inline Layout make_layout(int N, int nd, bool bf16) {
  const int nsp = 32 * chunks_for(N);
  const int warps = threads_for(bf16, nsp / 32) / 32;
  const int node_floats = 4 * nsp * kNR > nsp * kHPR ? 4 * nsp * kNR : nsp * kHPR;
  Layout L;
  int o = 0;
  L.slab = o;
  if (!global_slab(nsp / 32)) o += align16(nd * nsp * (bf16 ? kSlabBf16Row * 2 : kSlabF32Row * 4));
  L.wbuf = o;
  o += kWBuf * 4;
  L.xs = o;
  o += 2 * nsp * kH * 4;
  L.node = o;
  o += align16(node_floats * 4);
  L.scratch = o;
  o += bf16 ? warps * kScratch : 0;
  L.fs = o;
  o += warps * kH * 4;
  L.pos = o;
  o += align16(nsp * 3 * 4);
  L.mask = o;
  o += align16(nd * (nsp + 1) * 4);
  L.cnt = o;
  o += align16(nd * 4);
  L.grad = o;
  o += align16(nd * 3 * 4);
  L.total = o;
  return L;
}


// ---- tensor-core fragments (bf16 mode) -----------------------------------

using namespace hopper;   // ldmatrix, mma.sync (hopper.cuh)

// acc[mt][nt] += A[16 mt .. +16, 0:K] @ B[0:K, 8 nt .. +8]: the warp's
// accumulator fragments (lane l holds rows l/4 and l/4 + 8, columns
// 2 (l%4) and +1 of each); A row-major [M][lda], B row-major [K][ldb], both
// bf16 in shared memory with 16-byte aligned rows.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const __nv_bfloat16* A,
                                         int lda, const __nv_bfloat16* B, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], A + (mt * 16 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
    const int kk = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      if (nt + 1 < NT) {
        ldsm_x4_t(b, B + kk * ldb + nt * 8 + ((lane >> 4) & 1) * 8);
      } else {
        ldsm_x2_t(*reinterpret_cast<uint32_t(*)[2]>(b), B + kk * ldb + nt * 8);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (nt + h >= NT) break;
        const uint32_t bh[2] = {b[2 * h], b[2 * h + 1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt + h], a[mt], bh);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// the fragments (+ bias[column], if given), rounded, into a bf16 tile at
// column col0
template <int NT>
__device__ __forceinline__ void frag_to_tile(const float (&acc)[2][NT][4], const float* bias,
                                             __nv_bfloat16* T, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = mt * 16 + g, c = nt * 8 + c2;
      const float b0 = bias ? bias[c] : 0.f, b1 = bias ? bias[c + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(T + r * kAT + col0 + c) =
          pack_bf16x2(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      *reinterpret_cast<uint32_t*>(T + (r + 8) * kAT + col0 + c) =
          pack_bf16x2(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
}

// the [32][32] fragments into the f32 tile, then this lane's row + bias into v
__device__ __forceinline__ void frag_rows(const float (&acc)[2][4][4], float* T,
                                          const float* bias, float (&v)[32]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = mt * 16 + g, c = nt * 8 + c2;
      *reinterpret_cast<float2*>(T + r * kCT + c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(T + (r + 8) * kCT + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncwarp();
  const float4* row = reinterpret_cast<const float4*>(T + lane * kCT);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 q = row[j];
    v[4 * j] = q.x + bias[4 * j];
    v[4 * j + 1] = q.y + bias[4 * j + 1];
    v[4 * j + 2] = q.z + bias[4 * j + 2];
    v[4 * j + 3] = q.w + bias[4 * j + 3];
  }
  __syncwarp();
}

// ---- the slab: masked edge features, rows [dl * NSP + s] -----------------
// bf16 mode: 40 bf16 values (80 bytes) per row, written from the
// accumulator fragments and read by ldmatrix.  f32 mode: 32 floats per
// row, 16-byte chunk j stored at j ^ (row & 7), written and read by the
// row's lane.

struct SlabF32 {
  __device__ static void store(void* base, int row, const float (&v)[32]) {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + row * kSlabF32Row);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      p[j ^ (row & 7)] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
  __device__ static void load(const void* base, int row, float (&v)[32]) {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + row * kSlabF32Row);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 q = p[j ^ (row & 7)];
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  }
};

// ---- the slab in device memory (four source chunks, N > 64) --------------
// Each (molecule, destination, chunk of 32 sources) owns a unit of 32 lanes
// x 64 bytes (bf16 mode) or x 128 bytes (f32 mode) of a scratch buffer the
// wrapper allocates (ops/score_kernel.py::score_slab_bytes).  A lane reads
// back only what it wrote itself in phase 1: in bf16 mode its mma.sync A
// fragments of the unit's [32 pairs][32 channels] block (phase 1's
// accumulator fragments are exactly those), in f32 mode its pair's row.  So
// no barrier orders a read after its write, and no shared memory stages
// the rows.  16-byte word k of lane l sits at word 32 k + l: a warp's load
// or store covers 512 contiguous bytes.  Cached in L2 only (.cg).

__device__ __forceinline__ void store_frags(uint4* p, const uint32_t (&a)[2][2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      __stcg(p + (2 * mt + kk) * 32, make_uint4(a[mt][kk][0], a[mt][kk][1], a[mt][kk][2],
                                                a[mt][kk][3]));
}

__device__ __forceinline__ void load_frags(const uint4* p, uint32_t (&a)[2][2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 v = __ldcg(p + (2 * mt + kk) * 32);
      a[mt][kk][0] = v.x;
      a[mt][kk][1] = v.y;
      a[mt][kk][2] = v.z;
      a[mt][kk][3] = v.w;
    }
}

__device__ __forceinline__ void store_row(uint4* p, const float (&v)[32]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    __stcg(q + 32 * j, make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]));
}

__device__ __forceinline__ void load_row(const uint4* p, float (&v)[32]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 r = __ldcg(q + 32 * j);
    v[4 * j] = r.x;
    v[4 * j + 1] = r.y;
    v[4 * j + 2] = r.z;
    v[4 * j + 3] = r.w;
  }
}

// acc[mt][nt] += A @ B[0:32, 8 nt .. +8] with A the warp's [32][32] block
// held as A fragments (a[mt][kk]: m-tile mt, k-step kk); B as in warp_mma
template <int NT>
__device__ __forceinline__ void warp_mma_regs(float (&acc)[2][NT][4],
                                              const uint32_t (&a)[2][2][4],
                                              const __nv_bfloat16* B, int ldb) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int k = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, B + k * ldb + nt * 8 + ((lane >> 4) & 1) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t bh[2] = {b[2 * h], b[2 * h + 1]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt + h], a[mt][kk], bh);
      }
    }
  }
}


// acc[j] += sum_k v[k] * w[k][j] for a [32, 32]-slice of a row-major weight
// with row stride ws (in floats); w is 16-byte aligned
__device__ __forceinline__ void matvec32(const float (&v)[32], const float* w, int ws,
                                         float (&acc)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float e = v[k];
    const float4* wr = reinterpret_cast<const float4*>(w + k * ws);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 q = wr[j];
      acc[4 * j] = fmaf(e, q.x, acc[4 * j]);
      acc[4 * j + 1] = fmaf(e, q.y, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(e, q.z, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(e, q.w, acc[4 * j + 3]);
    }
  }
}

// f32 mode: embedding of one coefficient pair:
// [sin, cos](c0 * wc) | [sin, cos](c2 * wc) through the [4h, h] coff_mlp
// kernel, plus its bias; R rounds the Fourier features to bf16 first
template <bool R = false>
__device__ __forceinline__ void coff_embed(float c0, float c2, const float* wc, const float* wm,
                                           const float* bm, float (&acc)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < 32; ++k) {
    float s0, k0, s2, k2;
    sincosf(c0 * wc[k], &s0, &k0);
    sincosf(c2 * wc[k], &s2, &k2);
    if (R) {
      s0 = rbf(s0);
      k0 = rbf(k0);
      s2 = rbf(s2);
      k2 = rbf(k2);
    }
    const float4* r0 = reinterpret_cast<const float4*>(wm + k * kH);
    const float4* r1 = reinterpret_cast<const float4*>(wm + (kH + k) * kH);
    const float4* r2 = reinterpret_cast<const float4*>(wm + (2 * kH + k) * kH);
    const float4* r3 = reinterpret_cast<const float4*>(wm + (3 * kH + k) * kH);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 a = r0[j], b = r1[j], c = r2[j], d = r3[j];
      acc[4 * j] += s0 * a.x + k0 * b.x + s2 * c.x + k2 * d.x;
      acc[4 * j + 1] += s0 * a.y + k0 * b.y + s2 * c.y + k2 * d.y;
      acc[4 * j + 2] += s0 * a.z + k0 * b.z + s2 * c.z + k2 * d.z;
      acc[4 * j + 3] += s0 * a.w + k0 * b.w + s2 * c.w + k2 * d.w;
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] += bm[j];
}

// bf16 mode: a lane's [sin, cos](c * w[k]) for k < n (16 or 32) into its
// row of the tile from column col0 (n sin, then n cos), rounded
__device__ __forceinline__ void fourier_row(float c, const float* w, int n, __nv_bfloat16* T,
                                            int col0) {
  const int lane = threadIdx.x & 31;
  uint4* row = reinterpret_cast<uint4*>(T + lane * kAT + col0);
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += 8) {
    float sn[8], cs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sincosf(c * w[k0 + i], &sn[i], &cs[i]);
    row[k0 / 8] = make_uint4(pack_bf16x2(sn[0], sn[1]), pack_bf16x2(sn[2], sn[3]),
                             pack_bf16x2(sn[4], sn[5]), pack_bf16x2(sn[6], sn[7]));
    row[n / 8 + k0 / 8] = make_uint4(pack_bf16x2(cs[0], cs[1]), pack_bf16x2(cs[2], cs[3]),
                                     pack_bf16x2(cs[4], cs[5]), pack_bf16x2(cs[6], cs[7]));
  }
}

// n floats from device to shared memory (both 16-byte aligned) by
// asynchronous 16-byte copies, every copy of a phase in flight at once;
// they land after staged().  The tail past a multiple of 4 is copied
// directly.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int threads) {
  const int n4 = n & ~3;
  for (int i = threadIdx.x * 4; i < n4; i += threads * 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst + i)), "l"(src + i) : "memory");
  for (int i = n4 + threadIdx.x; i < n; i += threads) dst[i] = src[i];
}

__device__ __forceinline__ void staged() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// after staged(): what this thread staged of dst (n % 4 == 0) rounded to
// bf16 values in place
__device__ __forceinline__ void round_staged(float* dst, int n, int threads) {
  for (int i = threadIdx.x * 4; i < n; i += threads * 4) {
    const float4 v = *reinterpret_cast<const float4*>(dst + i);
    *reinterpret_cast<float4*>(dst + i) = make_float4(rbf(v.x), rbf(v.y), rbf(v.z), rbf(v.w));
  }
}

// a [K][cols] row-major f32 weight as a bf16 tile [K][ld]; columns cols ..
// 8 * ceil(cols / 8) (read by the last n-tile) zero
__device__ __forceinline__ void stage_tile(__nv_bfloat16* __restrict__ dst, int ld,
                                           const float* __restrict__ src, int K, int cols,
                                           int threads) {
  if (cols % 4 == 0) {
    const int n4 = K * cols / 4;
    for (int i = threadIdx.x; i < n4; i += threads) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
      const int k = 4 * i / cols, c = 4 * i - k * cols;
      *reinterpret_cast<uint2*>(dst + k * ld + c) =
          make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
    }
  } else {
    const int wide = (cols + 7) / 8 * 8;
    for (int i = threadIdx.x; i < K * wide; i += threads) {
      const int k = i / wide, c = i - k * wide;
      dst[k * ld + c] = __float2bfloat16_rn(c < cols ? src[k * cols + c] : 0.f);
    }
  }
}

// weight-buffer offsets, in floats (f32 parts) or bytes (bf16 tiles)
// phase 1, f32 mode
constexpr int kWC = 0, kCM = 32, kBM = kCM + 4 * kH * kH, kP1 = kBM + kH,
              kB1 = kP1 + (2 * kH + 2) * kH, kP2 = kB1 + kH, kB2 = kP2 + kH * kH,
              kDW = kB2 + kH, kIN = kDW + kH, kBI = kIN + 2 * kH * kH;
static_assert(kBI + kH <= kWBuf, "phase-1 weights");
// phase 1, bf16 mode: the elementwise parts in f32, then the product tiles
constexpr int kXWC = 0, kXBM = 32, kXP1 = 64, kXB1 = 128, kXB2 = 160, kXDW = 192,
              kXBI = 224;
constexpr int kTCM = 1024, kTP1 = kTCM + 128 * kB32 * 2, kTP2 = kTP1 + 64 * kB32 * 2,
              kTIN = kTP2 + 32 * kB32 * 2;
static_assert(kTIN + 64 * kB32 * 2 <= kWBuf * 4, "phase-1 tiles");
// a GAT layer: seven [h, h] kernels (q, k, v, edge, skip, FFN 1, FFN 2),
// seven biases, two LayerNorms; bf16 mode stages the edge kernel as a tile
constexpr int kGBias = 7 * kH * kH, kGNorm = kGBias + 7 * kH;
constexpr int kWE = 3 * kH * kH, kWF1 = 5 * kH * kH, kWF2 = 6 * kH * kH;
constexpr int kTWE = (kGNorm + 4 * kH) * 4;
static_assert(kTWE + kH * kB32 * 2 <= kWBuf * 4, "GAT weights");
// a basis module
constexpr int kWH = 0, kWBE = kH * kCD, kBBE = 2 * kH * kCD, kWO = kBBE + kCD,
              kBO = kWO + kCD * 3;
static_assert(kBO + 4 <= kWBuf, "basis weights");
constexpr int kXBBE = kH * kCD, kXBO = kXBBE + kCD;     // bf16 mode, floats
constexpr int kTBE = align16((kXBO + 4) * 4), kTWO = kTBE + kH * kB128 * 2;
static_assert(kTWO + kCD * kB8 * 2 <= kWBuf * 4, "basis tiles");

// ---- the kernel ------------------------------------------------------------

// Shared memory (make_layout): the slab; the weight buffer; the node state
// xs [2][NSP][kH], double-buffered by layer; q, k, v, skip [NSP][kNR] each
// (hp [NSP][kHPR] in the basis phases); the warps' tiles (bf16 mode); FFN
// rows; positions; mask[s, d0 + dl] as [dl][NSP + 1]; valid sources per
// destination (>= 1); the block's score rows.  S: chunks of 32 sources.
template <bool BF16, int S>
__global__ void __launch_bounds__(threads_for(BF16, S), 1)
score_eval_kernel(const float* __restrict__ pos, const float* __restrict__ node,
                  const float* __restrict__ edge2d, const float* __restrict__ mask,
                  const float* __restrict__ params, const Offsets off,
                  float* __restrict__ out, void* __restrict__ gslab, int N, int variant,
                  int L, int NC, int nd) {
  constexpr int T = threads_for(BF16, S), W = T / 32, NSP = 32 * S;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / cs;
  const int d0 = rank * nd;
  const int nown = max(0, min(nd, N - d0));
  const int MR = NSP + 1;
  const Layout lay = make_layout(N, nd, BF16);
  void* slab = smem + lay.slab;
  float* wbuf = reinterpret_cast<float*>(smem + lay.wbuf);
  unsigned char* wbytes = smem + lay.wbuf;
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* qs = reinterpret_cast<float*>(smem + lay.node);
  float* ks = qs + NSP * kNR;
  float* vs = ks + NSP * kNR;
  float* sks = vs + NSP * kNR;
  float* hps = qs;
  float* fs = reinterpret_cast<float*>(smem + lay.fs);
  float* posS = reinterpret_cast<float*>(smem + lay.pos);
  float* maskT = reinterpret_cast<float*>(smem + lay.mask);
  float* cnt = reinterpret_cast<float*>(smem + lay.cnt);
  float* gradS = reinterpret_cast<float*>(smem + lay.grad);

  int phase = 0;
  PHASE_MARK(phase++);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  unsigned char* tile = smem + lay.scratch + warp * kScratch;   // bf16 mode
  __nv_bfloat16* At = reinterpret_cast<__nv_bfloat16*>(tile);
  float* Ct = reinterpret_cast<float*>(tile);
  // this lane's 16-byte words of the device-memory slab unit (d, chunk j)
  auto gunit = [&](int d, int j) {
    return static_cast<uint4*>(gslab) + ((static_cast<size_t>(b) * N + d) * S + j) *
                                            (BF16 ? 4 : 8) * 32 + lane;
  };
  const int gat0 = variant == 2 ? 10 : 7;      // first GAT segment
  const int basis0 = gat0 + 18 * L * NC;       // first basis segment

  for (int i = tid; i < NSP * 3; i += T)
    posS[i] = i < N * 3 ? pos[static_cast<size_t>(b) * N * 3 + i] : 0.f;
  for (int i = tid; i < nd * 3; i += T) gradS[i] = 0.f;
  for (int i = tid; i < nd * NSP; i += T) {
    const int dl = i / NSP, s = i - dl * NSP;
    maskT[dl * MR + s] = (s < N && dl < nown)
                             ? mask[(static_cast<size_t>(b) * N + s) * N + d0 + dl] : 0.f;
  }
  for (int i = tid; i < 2 * NSP * kH; i += T) {
    const int n = (i / kH) % NSP;
    xs[i] = (i < NSP * kH && n < N) ? rnd<BF16>(node[static_cast<size_t>(b) * N * kH + i]) : 0.f;
  }
  {
    const float two_pi = static_cast<float>(2.0 * 3.14159265358979323846);
    if (BF16) {
      for (int i = tid; i < kH; i += T) {
        wbuf[kXWC + i] = params[off.v[0] + i] * two_pi;
        wbuf[kXBM + i] = params[off.v[2] + i];
        wbuf[kXB1 + i] = params[off.v[4] + i];
        wbuf[kXB2 + i] = params[off.v[6] + i];
        if (variant == 2) {
          wbuf[kXDW + i] = params[off.v[7] + i] * two_pi;
          wbuf[kXBI + i] = params[off.v[9] + i];
        }
      }
      stage(wbuf + kXP1, params + off.v[3], 2 * kH, T);   // angle rows: elementwise
      stage_tile(reinterpret_cast<__nv_bfloat16*>(wbytes + kTCM), kB32, params + off.v[1],
                 4 * kH, kH, T);
      stage_tile(reinterpret_cast<__nv_bfloat16*>(wbytes + kTP1), kB32,
                 params + off.v[3] + 2 * kH, 2 * kH, kH, T);
      stage_tile(reinterpret_cast<__nv_bfloat16*>(wbytes + kTP2), kB32, params + off.v[5], kH,
                 kH, T);
      if (variant == 2)
        stage_tile(reinterpret_cast<__nv_bfloat16*>(wbytes + kTIN), kB32, params + off.v[8],
                   2 * kH, kH, T);
    } else {
      for (int i = tid; i < kH; i += T) {
        wbuf[kWC + i] = params[off.v[0] + i] * two_pi;
        if (variant == 2) wbuf[kDW + i] = params[off.v[7] + i] * two_pi;
      }
      stage(wbuf + kCM, params + off.v[1], 4 * kH * kH, T);
      stage(wbuf + kBM, params + off.v[2], kH, T);
      stage(wbuf + kP1, params + off.v[3], (2 * kH + 2) * kH, T);
      stage(wbuf + kB1, params + off.v[4], kH, T);
      stage(wbuf + kP2, params + off.v[5], kH * kH, T);
      stage(wbuf + kB2, params + off.v[6], kH, T);
      if (variant == 2) {
        stage(wbuf + kIN, params + off.v[8], 2 * kH * kH, T);
        stage(wbuf + kBI, params + off.v[9], kH, T);
      }
    }
  }
  staged();
  __syncthreads();
  PHASE_MARK(phase++);

  // ---- phase 1: masked edge features of the block's pairs into the slab ---
  for (int dl = warp; dl < nown; dl += W) {
    const int d = d0 + dl;
    const float* pd = posS + 3 * d;
    float count = 0.f;
#pragma unroll 1
    for (int j = 0; j < S; ++j) {
      const int s = 32 * j + lane;
      const float m = maskT[dl * MR + s];
      count += warp_sum(m);
      const float* ps = posS + 3 * s;
      float cs[3], cd[3], psin, pcos;
      pair_geometry(ps, pd, cs, cd, psin, pcos);
      if constexpr (BF16) {
        // each embedding in four steps of 16 frequencies of one coefficient
        // (sin and cos features in tile columns 32-63), the first embedding
        // parked, rounded, in columns 0-31 while the second accumulates
        const __nv_bfloat16* tcm = reinterpret_cast<const __nv_bfloat16*>(wbytes + kTCM);
#pragma unroll 1
        for (int side = 0; side < 2; ++side) {
          float emb[2][4][4];
          zero(emb);
#pragma unroll 1
          for (int q = 0; q < 4; ++q) {
            const int k0 = (q & 1) * 16, row0 = (q >> 1) * 64 + k0;   // coff_mlp's sin rows
            fourier_row((side ? cd : cs)[(q >> 1) * 2], wbuf + kXWC + k0, 16, At, 32);
            __syncwarp();
            warp_mma(emb, At + 32, kAT, tcm + row0 * kB32, kB32, 16);
            warp_mma(emb, At + 48, kAT, tcm + (row0 + 32) * kB32, kB32, 16);
            __syncwarp();
          }
          frag_to_tile(emb, wbuf + kXBM, At, side * kH);
        }
        __syncwarp();
        float pre[2][4][4];
        zero(pre);
        warp_mma(pre, At, kAT, reinterpret_cast<const __nv_bfloat16*>(wbytes + kTP1), kB32,
                 2 * kH);
        __syncwarp();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            const int r = mt * 16 + g + 8 * h8;
            const float rs = __shfl_sync(kFull, psin, r), rc = __shfl_sync(kFull, pcos, r);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = nt * 8 + c2 + e;
                float& v = pre[mt][nt][2 * h8 + e];
                v += rs * wbuf[kXP1 + c] + rc * wbuf[kXP1 + kH + c] + wbuf[kXB1 + c];
                v = silu<true>(v);
              }
          }
        }
        frag_to_tile(pre, nullptr, At, 0);
        __syncwarp();
        float fi[2][4][4];
        zero(fi);
        warp_mma(fi, At, kAT, reinterpret_cast<const __nv_bfloat16*>(wbytes + kTP2), kB32, kH);
        __syncwarp();
        if (variant == 2) {   // input_mlp: one Linear on [sin, cos](dist * w)
          fourier_row(norm3(ps[0] - pd[0], ps[1] - pd[1], ps[2] - pd[2]), wbuf + kXDW, 32, At,
                      0);
          __syncwarp();
          zero(pre);
          warp_mma(pre, At, kAT, reinterpret_cast<const __nv_bfloat16*>(wbytes + kTIN), kB32,
                   2 * kH);
          __syncwarp();
        }
        __nv_bfloat16* sl = static_cast<__nv_bfloat16*>(slab);
        uint32_t fr[2][2][4];   // the same values as A fragments (device-memory slab)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            const int r = mt * 16 + g + 8 * h8, sr = 32 * j + r;
            const float mr = maskT[dl * MR + sr];
            const float* e2d = edge2d + ((static_cast<size_t>(b) * N + (sr < N ? sr : 0)) * N + d) * kH;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int c = nt * 8 + c2;
              const float2 e = sr < N ? *reinterpret_cast<const float2*>(e2d + c)
                                      : make_float2(0.f, 0.f);
              float v[2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float ev = i ? e.y : e.x;
                const float f = fi[mt][nt][2 * h8 + i] + wbuf[kXB2 + c + i];
                v[i] = (variant == 2 ? (pre[mt][nt][2 * h8 + i] + wbuf[kXBI + c + i]) * ev + f
                                     : ev + f) * mr;
              }
              const uint32_t two = pack_bf16x2(v[0], v[1]);
              if constexpr (global_slab(S))
                fr[mt][nt >> 1][2 * (nt & 1) + h8] = two;
              else
                *reinterpret_cast<uint32_t*>(sl + (dl * NSP + sr) * kSlabBf16Row + c) = two;
            }
          }
        if constexpr (global_slab(S)) store_frags(gunit(d, j), fr);
      } else {
        const bool real = s < N;
        float pre[32], acc[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) pre[k] = 0.f;
        coff_embed(cs[0], cs[2], wbuf + kWC, wbuf + kCM, wbuf + kBM, acc);
        matvec32(acc, wbuf + kP1 + 2 * kH, kH, pre);
        coff_embed(cd[0], cd[2], wbuf + kWC, wbuf + kCM, wbuf + kBM, acc);
        matvec32(acc, wbuf + kP1 + (2 + kH) * kH, kH, pre);
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          pre[k] += psin * wbuf[kP1 + k] + pcos * wbuf[kP1 + kH + k] + wbuf[kB1 + k];
          pre[k] = silu<false>(pre[k]);
          acc[k] = 0.f;
        }
        matvec32(pre, wbuf + kP2, kH, acc);          // frame_inv (without bias)
        const float4* e2d = reinterpret_cast<const float4*>(
            edge2d + ((static_cast<size_t>(b) * N + (real ? s : 0)) * N + d) * kH);
        if (variant == 2) {
          const float dist = norm3(ps[0] - pd[0], ps[1] - pd[1], ps[2] - pd[2]);
#pragma unroll
          for (int k = 0; k < 32; ++k) pre[k] = 0.f;
#pragma unroll 2
          for (int k = 0; k < 32; ++k) {
            float sn, cs_;
            sincosf(dist * wbuf[kDW + k], &sn, &cs_);
            const float4* ra = reinterpret_cast<const float4*>(wbuf + kIN + k * kH);
            const float4* rb = reinterpret_cast<const float4*>(wbuf + kIN + (kH + k) * kH);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float4 qa = ra[q], qb = rb[q];
              pre[4 * q] += sn * qa.x + cs_ * qb.x;
              pre[4 * q + 1] += sn * qa.y + cs_ * qb.y;
              pre[4 * q + 2] += sn * qa.z + cs_ * qb.z;
              pre[4 * q + 3] += sn * qa.w + cs_ * qb.w;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 e = real ? e2d[q] : make_float4(0.f, 0.f, 0.f, 0.f);
          const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 4 * q + i;
            acc[c] = variant == 2 ? (pre[c] + wbuf[kBI + c]) * ev[i] + (acc[c] + wbuf[kB2 + c])
                                  : ev[i] + (acc[c] + wbuf[kB2 + c]);
            acc[c] *= m;
          }
        }
        if constexpr (global_slab(S))
          store_row(gunit(d, j), acc);
        else
          SlabF32::store(slab, dl * NSP + s, acc);
      }
    }
    if (lane == 0) cnt[dl] = fmaxf(count, 1.f);
  }

  // the e2 = slab @ W_edge + b_edge row of this lane's pair (dl, 32 j + lane)
  auto edge_row = [&](int dl, int j, float (&e2)[32]) {
    const int row = dl * NSP + 32 * j;
    if constexpr (BF16) {
      const __nv_bfloat16* we = reinterpret_cast<const __nv_bfloat16*>(wbytes + kTWE);
      float acc[2][4][4];
      zero(acc);
      if constexpr (global_slab(S)) {
        uint32_t a[2][2][4];
        load_frags(gunit(d0 + dl, j), a);
        warp_mma_regs(acc, a, we, kB32);
      } else {
        warp_mma(acc, static_cast<const __nv_bfloat16*>(slab) + row * kSlabBf16Row,
                 kSlabBf16Row, we, kB32, kH);
      }
      frag_rows(acc, Ct, wbuf + kGBias + 3 * kH, e2);
    } else {
      float ea[32];
      if constexpr (global_slab(S))
        load_row(gunit(d0 + dl, j), ea);
      else
        SlabF32::load(slab, row + lane, ea);
#pragma unroll
      for (int c = 0; c < 32; ++c) e2[c] = 0.f;
      matvec32(ea, wbuf + kWE, kH, e2);
#pragma unroll
      for (int c = 0; c < 32; ++c) e2[c] += wbuf[kGBias + 3 * kH + c];
    }
  };

  PHASE_MARK(phase++);
  cluster.sync();    // every block of the cluster runs before any remote write
  PHASE_MARK(phase++);
  const float scale = 1.f / sqrtf(static_cast<float>(kCHead));
  int cur = 0;
  for (int mod = 0; mod < L; ++mod) {
    for (int conv = 0; conv < NC; ++conv) {
      const int seg = gat0 + 18 * (mod * NC + conv);
      float* xc = xs + cur * NSP * kH;
      float* xn = xs + (cur ^ 1) * NSP * kH;
      __syncthreads();   // the previous phase is done with wbuf and the node area
      for (int j = 0; j < 7; ++j) {
        if (!(BF16 && j == 3)) stage(wbuf + j * kH * kH, params + off.v[seg + 2 * j], kH * kH, T);
        stage(wbuf + kGBias + j * kH, params + off.v[seg + 2 * j + 1], kH, T);
      }
      for (int j = 0; j < 4; ++j) stage(wbuf + kGNorm + j * kH, params + off.v[seg + 14 + j], kH, T);
      if (BF16)
        stage_tile(reinterpret_cast<__nv_bfloat16*>(wbytes + kTWE), kB32, params + off.v[seg + 6],
                   kH, kH, T);
      staged();
      if (BF16)
        for (int j = 0; j < 7; ++j)
          if (j != 3) round_staged(wbuf + j * kH * kH, kH * kH, T);
      __syncthreads();
      PHASE_MARK(phase++);

      // k and v of every node, q and the skip projection of the block's own
      // destinations
      const int kv = NSP * 2 * kH;
      for (int o = tid; o < kv + nown * 2 * kH; o += T) {
        const bool own = o >= kv;
        const int r = own ? o - kv : o;
        const int n = (own ? d0 : 0) + r / (2 * kH), col = r % (2 * kH);
        const int which = (own ? 0 : 1) + (own ? 3 : 1) * (col / kH), c = col % kH;
        const int wi = which == 3 ? 4 : which;   // q, k, v, skip = kernels 0, 1, 2, 4
        const float* w = wbuf + wi * kH * kH;
        float acc = 0.f;
#pragma unroll 8
        for (int k = 0; k < kH; ++k) acc = fmaf(xc[n * kH + k], w[k * kH + c], acc);
        qs[which * NSP * kNR + n * kNR + c] = acc + wbuf[kGBias + wi * kH + c];
      }
      __syncthreads();
      PHASE_MARK(phase++);

      // attention, LayerNorm, FFN, LayerNorm: warp = destination d
      const float* s1 = wbuf + kGNorm;
      const float* o1 = s1 + kH;
      const float* s2 = o1 + kH;
      const float* o2 = s2 + kH;
      for (int dl = warp; dl < nown; dl += W) {
        const int d = d0 + dl;
        // four chunks keep one e2 row a lane and form it again for the
        // message: 4 x 32 floats do not stay in registers at 256 threads.
        // Their loops over the chunks are not unrolled (the compiler would
        // keep every chunk's rows live at once); alpha and mj take chunk
        // j's values through selects, so that they stay in registers.
        constexpr int SK = global_slab(S) ? 1 : S;
        float e2[SK][32], alpha[S][kHeads], mj[S];
        auto logits = [&](int s, const float (&ej)[32], float m, float (&l8)[kHeads]) {
#pragma unroll
          for (int hh = 0; hh < kHeads; ++hh) {
            float l = 0.f;
#pragma unroll
            for (int cc = 0; cc < kCHead; ++cc) {
              const int c = hh * kCHead + cc;
              l += rnd<BF16>((ks[s * kNR + c] + ej[c]) * qs[d * kNR + c]);
            }
            l8[hh] = m > 0.f ? l * scale : -3.402823466e38f;
          }
        };
        if constexpr (global_slab(S)) {
#pragma unroll 1
          for (int j = 0; j < S; ++j) {
            const float m = maskT[dl * MR + 32 * j + lane];
            float l8[kHeads];
            edge_row(dl, j, e2[0]);
            logits(32 * j + lane, e2[0], m, l8);
#pragma unroll
            for (int i = 0; i < S; ++i) {
              if (i == j) {
                mj[i] = m;
#pragma unroll
                for (int hh = 0; hh < kHeads; ++hh) alpha[i][hh] = l8[hh];
              }
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            mj[j] = maskT[dl * MR + 32 * j + lane];
            edge_row(dl, j, e2[j]);
            logits(32 * j + lane, e2[j], mj[j], alpha[j]);
          }
        }
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          float mx = alpha[0][hh];
#pragma unroll
          for (int j = 1; j < S; ++j) mx = fmaxf(mx, alpha[j][hh]);
          mx = warp_max(mx);
          float ex[S], sum = 0.f;
#pragma unroll
          for (int j = 0; j < S; ++j) {
            ex[j] = expf(alpha[j][hh] - mx);
            sum += ex[j];
          }
          sum = fmaxf(warp_sum(sum), 1e-30f);
#pragma unroll
          for (int j = 0; j < S; ++j) alpha[j][hh] = rnd<BF16>(ex[j] / sum * mj[j]);
        }
        // message terms, summed over the chunks in order, in place of e2[0]
        if constexpr (global_slab(S)) {
#pragma unroll
          for (int c = 0; c < 32; ++c) e2[0][c] = 0.f;
#pragma unroll 1
          for (int j = 0; j < S; ++j) {
            float ej[32], aj[kHeads];
            edge_row(dl, j, ej);
#pragma unroll
            for (int hh = 0; hh < kHeads; ++hh) aj[hh] = alpha[0][hh];
#pragma unroll
            for (int i = 1; i < S; ++i) {
              if (i == j) {
#pragma unroll
                for (int hh = 0; hh < kHeads; ++hh) aj[hh] = alpha[i][hh];
              }
            }
#pragma unroll
            for (int c = 0; c < 32; ++c)
              e2[0][c] += aj[c / kCHead] * (vs[(32 * j + lane) * kNR + c] + ej[c]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < 32; ++c) {
            float t = alpha[0][c / kCHead] * (vs[lane * kNR + c] + e2[0][c]);
#pragma unroll
            for (int j = 1; j < S; ++j)
              t += alpha[j][c / kCHead] * (vs[(32 * j + lane) * kNR + c] + e2[j][c]);
            e2[0][c] = t;
          }
        }
        const int c = lane;
        const float mha = rnd<BF16>(reduce_scatter(e2[0], lane) + sks[d * kNR + c]);
        float mean = warp_sum(mha) * (1.f / kH);
        float dv = mha - mean;
        float y = dv * rsqrtf(warp_sum(dv * dv) * (1.f / kH) + 1e-6f) * s1[c] + o1[c];
        const float x1 = rnd<BF16>(xc[d * kH + c] + rnd<BF16>(y));
        float* f = fs + warp * kH;
        f[c] = x1;
        __syncwarp();
        float hacc = 0.f;
#pragma unroll 8
        for (int k = 0; k < kH; ++k) hacc = fmaf(f[k], wbuf[kWF1 + k * kH + c], hacc);
        const float hval = rnd<BF16>(silu<BF16>(hacc + wbuf[kGBias + 5 * kH + c]));
        __syncwarp();
        f[c] = hval;
        __syncwarp();
        float o = 0.f;
#pragma unroll 8
        for (int k = 0; k < kH; ++k) o = fmaf(f[k], wbuf[kWF2 + k * kH + c], o);
        o = rnd<BF16>(o + wbuf[kGBias + 6 * kH + c]);
        __syncwarp();
        mean = warp_sum(o) * (1.f / kH);
        dv = o - mean;
        y = dv * rsqrtf(warp_sum(dv * dv) * (1.f / kH) + 1e-6f) * s2[c] + o2[c];
        float x2 = rnd<BF16>(x1 + rnd<BF16>(y));
        if (conv < NC - 1) x2 = silu<BF16>(x2);
        xn[d * kH + c] = rnd<BF16>(x2);
      }
      // this block's new rows into every peer's node state, then the cluster
      // waits for all of them
      __syncthreads();
      PHASE_MARK(phase++);
      const int own = nown * kH;
      for (int i = tid; i < (cs - 1) * own; i += T) {
        const int k = i / own, e = i - k * own;
        const int r = k < rank ? k : k + 1;
        float* peer = cluster.map_shared_rank(xn, r);
        peer[d0 * kH + e] = xn[d0 * kH + e];
      }
      cluster.sync();
      PHASE_MARK(phase++);
      cur ^= 1;
    }

    // ---- basis module: dynamic coefficients mix the frame basis --------
    const float* xc = xs + cur * NSP * kH;
    const int seg = basis0 + 5 * mod;
    __syncthreads();
    if (BF16) {
      stage(wbuf + kWH, params + off.v[seg], kH * kCD, T);
      stage(wbuf + kXBBE, params + off.v[seg + 2], kCD, T);
      stage(wbuf + kXBO, params + off.v[seg + 4], 3, T);
      stage_tile(reinterpret_cast<__nv_bfloat16*>(wbytes + kTBE), kB128, params + off.v[seg + 1],
                 kH, kCD, T);
      stage_tile(reinterpret_cast<__nv_bfloat16*>(wbytes + kTWO), kB8, params + off.v[seg + 3],
                 kCD, 3, T);
    } else {
      stage(wbuf + kWH, params + off.v[seg], kH * kCD, T);
      stage(wbuf + kWBE, params + off.v[seg + 1], kH * kCD, T);
      stage(wbuf + kBBE, params + off.v[seg + 2], kCD, T);
      stage(wbuf + kWO, params + off.v[seg + 3], kCD * 3, T);
      stage(wbuf + kBO, params + off.v[seg + 4], 3, T);
    }
    staged();
    if (BF16) round_staged(wbuf + kWH, kH * kCD, T);
    __syncthreads();
    for (int o = tid; o < NSP * kCD; o += T) {
      const int n = o / kCD, c = o - n * kCD;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < kH; ++k) acc = fmaf(xc[n * kH + k], wbuf[kWH + k * kCD + c], acc);
      hps[n * kHPR + c] = acc;
    }
    __syncthreads();
    PHASE_MARK(phase++);
    for (int dl = warp; dl < nown; dl += W) {
      const int d = d0 + dl;
      float tot[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
      for (int j = 0; j < S; ++j) {
        const int s = 32 * j + lane;
        float cc[3];
        if constexpr (BF16) {
          // cc = (bo + chunk 0 @ wo) + chunk 1 @ wo, the TPU kernel's 64-channel
          // chunks, each from the edge MLP's fragments straight into basis_out
          const __nv_bfloat16* rows =
              static_cast<const __nv_bfloat16*>(slab) + (dl * NSP + 32 * j) * kSlabBf16Row;
          const __nv_bfloat16* wbe = reinterpret_cast<const __nv_bfloat16*>(wbytes + kTBE);
          const __nv_bfloat16* wo = reinterpret_cast<const __nv_bfloat16*>(wbytes + kTWO);
          float part[2][2][1][4];   // [TPU chunk][m-tile]
          zero(part[0]);
          zero(part[1]);
          uint32_t sa[2][2][4];   // the slab unit's A fragments (device-memory slab)
          if constexpr (global_slab(S)) load_frags(gunit(d, j), sa);
#pragma unroll 1
          for (int qc = 0; qc < 4; ++qc) {   // 32 channels at a time
            const int ch = qc >> 1, c0 = 32 * qc;
            float ep[2][4][4];
            zero(ep);
            if constexpr (global_slab(S))
              warp_mma_regs(ep, sa, wbe + c0, kB128);
            else
              warp_mma(ep, rows, kSlabBf16Row, wbe + c0, kB128, kH);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              uint32_t a[2][4];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                float v[2][4];
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const int r = mt * 16 + g + (e >> 1) * 8;
                    const int col = c0 + (2 * kk + h) * 8 + c2 + (e & 1);
                    const int sr = 32 * j + r;
                    v[h][e] = silu<true>((hps[sr * kHPR + col] + hps[d * kHPR + col]) +
                                         (ep[mt][2 * kk + h][e] + wbuf[kXBBE + col]));
                  }
                a[mt][0] = pack_bf16x2(v[0][0], v[0][1]);
                a[mt][1] = pack_bf16x2(v[0][2], v[0][3]);
                a[mt][2] = pack_bf16x2(v[1][0], v[1][1]);
                a[mt][3] = pack_bf16x2(v[1][2], v[1][3]);
              }
              uint32_t bw[2];
              ldsm_x2_t(bw, wo + (c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kB8);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_bf16(part[ch][mt][0], a[mt], bw);
            }
          }
          // columns 0-2 of each row sit in lanes 4r (0, 1) and 4r + 1 (2):
          // through the tile to the row's lane
          if (c2 < 4) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h8 = 0; h8 < 2; ++h8) {
                const int r = mt * 16 + g + 8 * h8;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int col = c2 + e;
                  if (col < 3)
                    Ct[r * kCT + col] = (wbuf[kXBO + col] + part[0][mt][0][2 * h8 + e]) +
                                        part[1][mt][0][2 * h8 + e];
                }
              }
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 3; ++i) cc[i] = Ct[lane * kCT + i];
          __syncwarp();
        } else {
          float ea[32];
          if constexpr (global_slab(S))
            load_row(gunit(d, j), ea);
          else
            SlabF32::load(slab, dl * NSP + s, ea);
          float part[3] = {0.f, 0.f, 0.f};
          cc[0] = wbuf[kBO];
          cc[1] = wbuf[kBO + 1];
          cc[2] = wbuf[kBO + 2];
          for (int c0 = 0; c0 < kCD; c0 += 32) {
            float acc[32];
#pragma unroll
            for (int k = 0; k < 32; ++k) acc[k] = 0.f;
            matvec32(ea, wbuf + kWBE + c0, kCD, acc);
#pragma unroll
            for (int k = 0; k < 32; ++k) {
              const int c = c0 + k;
              const float coff = silu<false>((hps[s * kHPR + c] + hps[d * kHPR + c]) +
                                             (acc[k] + wbuf[kBBE + c]));
              part[0] = fmaf(coff, wbuf[kWO + 3 * c], part[0]);
              part[1] = fmaf(coff, wbuf[kWO + 3 * c + 1], part[1]);
              part[2] = fmaf(coff, wbuf[kWO + 3 * c + 2], part[2]);
            }
            if ((c0 + 32) % 64 == 0) {   // the TPU kernel's 64-channel chunks
#pragma unroll
              for (int i = 0; i < 3; ++i) {
                cc[i] += part[i];
                part[i] = 0.f;
              }
            }
          }
        }
        Frame f;
        make_frame(posS + 3 * s, posS + 3 * d, f);
        const float mn = maskT[dl * MR + s] / cnt[dl];
#pragma unroll
        for (int comp = 0; comp < 3; ++comp) {
          const float rows = rnd<BF16>(cc[0] * f.df[comp]) + rnd<BF16>(cc[1] * f.cr[comp]) +
                             rnd<BF16>(cc[2] * f.vt[comp]);
          tot[comp] += warp_sum(rows * mn);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int comp = 0; comp < 3; ++comp) gradS[dl * 3 + comp] += tot[comp];
      }
    }
    __syncthreads();
    PHASE_MARK(phase++);
  }
  __syncthreads();
  for (int i = tid; i < nown * 3; i += T)
    out[(static_cast<size_t>(b) * N + d0) * 3 + i] = gradS[i];
}

template <bool BF16, int S>
int launch(const float* pos, const float* node, const float* edge2d, const float* mask,
           const float* params, const Offsets& off, float* out, void* gslab, int B, int N,
           int variant, int L, int NC, int cluster, int nd, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(score_eval_kernel<BF16, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(threads_for(BF16, S));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, score_eval_kernel<BF16, S>, pos, node, edge2d, mask, params,
                           off, out, gslab, N, variant, L, NC, nd);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch_n(const float* pos, const float* node, const float* edge2d, const float* mask,
             const float* params, const Offsets& off, float* out, void* gslab, int B, int N,
             int variant, int L, int NC, int cluster, int nd, int smem, cudaStream_t stream) {
  if (chunks_for(N) == 1)
    return launch<BF16, 1>(pos, node, edge2d, mask, params, off, out, gslab, B, N, variant, L,
                           NC, cluster, nd, smem, stream);
  if (chunks_for(N) == 2)
    return launch<BF16, 2>(pos, node, edge2d, mask, params, off, out, gslab, B, N, variant, L,
                           NC, cluster, nd, smem, stream);
  return launch<BF16, 4>(pos, node, edge2d, mask, params, off, out, gslab, B, N, variant, L,
                         NC, cluster, nd, smem, stream);
}

}  // namespace

// Shared-memory bytes of one block of the cluster plan at n_max N with nd
// destinations per block (ops/score_kernel.py::score_plan counts the same).
extern "C" int score_eval_smem_bytes(int N, int nd, int bf16) {
  return make_layout(N, nd, bf16 != 0).total;
}

// The cluster plan.  offsets: the packed buffer's segment offsets in floats,
// in pack_score_params order (n_offsets of them).  cluster, nd and smem: the
// wrapper's plan (ops/score_kernel.py::score_plan): blocks per molecule,
// destinations per block, shared-memory bytes per block.  slab: past N =
// 64, device scratch of B * N * 128 * 32 values in the mode's type (bf16 or
// f32; ops/score_kernel.py::score_slab_bytes), 16-byte aligned; not read
// at N <= 64.  Takes N <= 128, hidden 32, 8 heads and basis width 128;
// returns cudaErrorInvalidValue otherwise, when the plan does not cover N
// or disagrees with the layout, or when N > 64 has no slab.
extern "C" int score_eval_fused(const float* pos, const float* node, const float* edge2d,
                                const float* mask, const float* params, const int* offsets,
                                int n_offsets, float* out, void* slab, int B, int N,
                                int variant, int num_layers, int num_convs, int bf16,
                                int cluster, int nd, int smem, void* stream) {
  const int expected = (variant == 2 ? 10 : 7) + 18 * num_layers * num_convs + 5 * num_layers;
  if (N < 1 || N > 32 * kMaxS || (variant != 1 && variant != 2) || n_offsets != expected ||
      n_offsets > kMaxSegments || cluster < 1 || cluster > kMaxCluster || nd < 1 ||
      cluster * nd < N || smem != make_layout(N, nd, bf16 != 0).total ||
      (N > 64 && (slab == nullptr || reinterpret_cast<uintptr_t>(slab) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets off;
  for (int i = 0; i < kMaxSegments; ++i) off.v[i] = i < n_offsets ? offsets[i] : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_n<true>(pos, node, edge2d, mask, params, off, out, slab, B, N, variant,
                               num_layers, num_convs, cluster, nd, smem, s)
              : launch_n<false>(pos, node, edge2d, mask, params, off, out, slab, B, N, variant,
                                num_layers, num_convs, cluster, nd, smem, s);
}
