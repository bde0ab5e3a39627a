// One whole 2D->3D score evaluation of SDEModel2Dto3D (variants 1 and 2)
// in one launch (K6), forward only:
//   pos [B, N, 3], node_attr [B, N, H], edge_attr_2d [B, N, N, H] and the
//   pair mask [B, N, N] (all f32), the packed weights (ops/score_kernel.py::
//   pack_score_params) -> raw score out [B, N, 3] f32.
// The cluster plan below is compiled for the sampler's widths (hidden H = 32,
// 8 heads, basis width 128) at n_max <= 128; the layered plan (its own
// section) takes every other width and n_max.
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
//   plan (its own section below), a few launches an evaluation with the
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

namespace cg = cooperative_groups;

constexpr int kPhaseSlots = 32;   // PHASE_PROFILE marks per block

namespace {

constexpr int kH = 32;          // hidden width
constexpr int kHeads = 8;
constexpr int kCHead = kH / kHeads;
constexpr int kCD = 128;        // basis-MLP width (hidden_coff_dim)
constexpr int kMaxS = 4;        // chunks of 32 sources a lane takes (N <= 128)
constexpr int kMaxCluster = 8;
constexpr int kMaxSegments = 128;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? rbf(v) : v;
}

template <bool BF16>
__device__ __forceinline__ float silu(float v) {
  return BF16 ? __fdividef(v, 1.f + __expf(-v)) : v / (1.f + expf(-v));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// one halving step of the reduce-scatter: afterwards v[0 .. O-1] hold the
// half of the channels this lane keeps, summed with its partner lane
template <int O>
__device__ __forceinline__ void rs_step(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// sum of v[c] over the 32 lanes, returned in lane c
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  rs_step<16>(v, lane);
  rs_step<8>(v, lane);
  rs_step<4>(v, lane);
  rs_step<2>(v, lane);
  rs_step<1>(v, lane);
  return v[0];
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

// frame basis of the pair (s, d), as score_2d3d.dense_frames computes it
struct Frame {
  float df[3], cr[3], vt[3];
};

__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqrtf(a * a + b * b + c * c + 1e-24f);
}

__device__ __forceinline__ void make_frame(const float* ps, const float* pd, Frame& f) {
  float df[3] = {ps[0] - pd[0], ps[1] - pd[1], ps[2] - pd[2]};
  float cr[3] = {ps[1] * pd[2] - ps[2] * pd[1], ps[2] * pd[0] - ps[0] * pd[2],
                 ps[0] * pd[1] - ps[1] * pd[0]};
  const float dn = norm3(df[0], df[1], df[2]) + 1e-6f;
  const float cn = norm3(cr[0], cr[1], cr[2]) + 1e-6f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.df[k] = df[k] / dn;
    f.cr[k] = cr[k] / cn;
  }
  f.vt[0] = f.df[1] * f.cr[2] - f.df[2] * f.cr[1];
  f.vt[1] = f.df[2] * f.cr[0] - f.df[0] * f.cr[2];
  f.vt[2] = f.df[0] * f.cr[1] - f.df[1] * f.cr[0];
}

// coefficients of r in the frame (component 1 folded by |.|)
__device__ __forceinline__ void frame_coffs(const Frame& f, const float* r, float* c) {
  c[0] = f.df[0] * r[0] + f.df[1] * r[1] + f.df[2] * r[2];
  c[1] = fabsf(f.cr[0] * r[0] + f.cr[1] * r[1] + f.cr[2] * r[2]);
  c[2] = f.vt[0] * r[0] + f.vt[1] * r[1] + f.vt[2] * r[2];
}

// the pair's coefficients of s and of d in its frame and the pseudo-angle
__device__ __forceinline__ void pair_geometry(const float* ps, const float* pd, float (&cs)[3],
                                              float (&cd)[3], float& psin, float& pcos) {
  Frame f;
  make_frame(ps, pd, f);
  frame_coffs(f, ps, cs);
  frame_coffs(f, pd, cd);
  const float dot = cs[0] * cd[0] + cs[1] * cd[1] + cs[2] * cd[2];
  pcos = dot / (norm3(cs[0], cs[1], cs[2]) + 1e-6f) / (norm3(cd[0], cd[1], cd[2]) + 1e-6f);
  psin = sqrtf(fmaxf(1.f - pcos * pcos, 1e-12f));
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

// f32 mode (and the layered plan): embedding of one coefficient pair:
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

// ---- the layered plan: any n_max and any width ------------------------------
// The cluster plan is compiled for hidden 32, 8 heads, basis width 128 and n_max
// <= 128.  Everywhere else (another width, past n_max 128, more than 128
// packed segments) the layered plan runs an evaluation as 2 + 2 L C + 2 L
// launches with every node-wide tensor in device memory and shared memory
// that holds only a pass's weights, where they fit under kStageCap, so that
// nothing it holds on the chip grows without bound with N, the hidden width H
// or the basis width CD (ops/score_kernel.py::score_plan):
//   0. layered_weights_kernel: the packed weights into an image whose rows are
//      padded to a multiple of 32 columns with zeros (the basis output's 3 to
//      4) and whose kernels of H rows are padded to Hp zero rows
//      (image_rows), each product's weights rounded to bf16 in bf16 mode and
//      the Fourier rows times 2 pi, as the cluster plan stages them;
//   1. layered_front_kernel: frames, the two coefficient embeddings, the
//      projection MLP (and variant 2's distance gate) and the masked edge
//      features of every pair into the slab (Hp values a pair in the mode's
//      type, zero past H), the mask transposed to [b][d][s] and the valid
//      sources per destination;
//   2. per GAT layer, layered_node_kernel (q, k, v and skip of every node, a
//      thread per value) and layered_gat_kernel (a warp per destination, a
//      lane per source of each 32-source chunk: e2 = slab row @ W_e + b_e and
//      the logits, kept in the warp's logit rows, the softmax over all
//      sources by an online max and sum, then e2 again for the message,
//      LayerNorm, FFN and residuals; the new node state into the other of
//      two buffers);
//   3. per basis module, layered_node_kernel (hp = x @ W_h) and
//      layered_basis_kernel (cc of every pair, times the frame basis and the
//      EquiLayer mean, summed over the sources chunk by chunk in order by the
//      destination's warp into its score row).
// Blocks are (molecule, 8 destinations): B * N / 8 blocks, 256 at B = 2, N =
// 1024, two an SM (128 registers a thread: the passes wait on their loads,
// and a second block hides more of that than registers save).  A lane's pair
// rows are cut into slices of 32 channels: a slice of a product's output is
// 32 registers (16 for e2), and past one slice a row it needs whole (an
// embedding, the projection's input) sits in the warp's rows in device
// memory, [channel][lane], which its lane alone reads back (L1 / L2).
// Weights are read with 16-byte loads, the same address in every lane, from
// shared memory where a pass staged them (make_stage) and from the image
// elsewhere.  Every product runs as FMAs on the CUDA cores in both modes, in
// the order of its input channels; bf16 mode rounds their operands where the
// plain version's mm() rounds them and the values the cluster plan rounds.
// silu and the softmax's exp are the accurate expf.  A score row is summed by
// one warp in a fixed order and nothing is added atomically: two runs give
// the same bits.

constexpr int kLDests = 8;                    // destinations per block, a warp each
constexpr int kLThreads = 32 * kLDests;
constexpr int kLMaxHeads = 8;                 // the TPU kernel's head selector
constexpr int kLNodeThreads = 256;

__host__ __device__ constexpr int round32(int v) { return (v + 31) / 32 * 32; }

// the widths of one evaluation, as the launches read them
struct Widths {
  int variant, L, NC;   // kernel variant, modules, GAT layers a module
  int H, Hp;            // hidden width, padded to 32
  int CD, CDp;          // basis width, padded to 32
  int NR;               // floats a node row: q | k | v | skip (4 Hp) or hp (CDp)
  int heads, chead;     // heads, channels a head
  float scale, inv_h;   // 1 / sqrt(chead), 1 / H
};

// segment i of the packed layout (ops/score_kernel.py::score_param_layout):
// rows x cols and how the weight image holds it
enum SegKind { kSegPlain = 0, kSegProduct = 1, kSegFourier = 2, kSegProj1 = 3 };

struct Seg {
  int rows, cols, kind;
};

__host__ __device__ inline int front_segments(int variant) { return variant == 2 ? 10 : 7; }

__host__ __device__ inline int num_segments(const Widths& w) {
  return front_segments(w.variant) + 18 * w.L * w.NC + 5 * w.L;
}

__host__ __device__ inline Seg seg_shape(int i, const Widths& w) {
  const int H = w.H, front = front_segments(w.variant), gat = 18 * w.L * w.NC;
  if (i < front) {
    switch (i) {
      case 0: case 7: return {1, H, kSegFourier};     // coff_W, dist_W
      case 1: return {4 * H, H, kSegProduct};         // coff_mlp
      case 3: return {2 * H + 2, H, kSegProj1};       // proj1: angle rows, embedding rows
      case 5: return {H, H, kSegProduct};             // proj2
      case 8: return {2 * H, H, kSegProduct};         // input_mlp
      default: return {1, H, kSegPlain};              // biases
    }
  }
  i -= front;
  if (i < gat) {
    const int r = i % 18;
    return r < 14 && r % 2 == 0 ? Seg{H, H, kSegProduct} : Seg{1, H, kSegPlain};
  }
  switch ((i - gat) % 5) {
    case 0: case 1: return {H, w.CD, kSegProduct};  // basis_node, basis_edge kernels
    case 2: return {1, w.CD, kSegPlain};
    case 3: return {w.CD, 3, kSegProduct};          // basis_out
    default: return {1, 3, kSegPlain};
  }
}

// columns of a segment's rows in the image: 32-aligned slices (4 for the
// basis output's 3)
__host__ __device__ inline int image_cols(int cols) { return cols == 3 ? 4 : round32(cols); }

// rows of a segment in the image: a kernel of H rows padded to Hp zero-filled
// rows, the projection's two embedding blocks to Hp each, so that a product
// takes its input 32 channels at a time with no test (the inputs past H are
// zero too)
__host__ __device__ inline int image_rows(const Seg& s, const Widths& w) {
  if (s.kind == kSegProj1) return 2 + 2 * w.Hp;
  return s.kind == kSegProduct && s.rows == w.H ? w.Hp : s.rows;
}

// the packed row of image row r of a segment, -1 for a padding row
__host__ __device__ inline int packed_row(const Seg& s, const Widths& w, int r) {
  if (s.kind == kSegProj1 && r >= 2) {
    const int block = (r - 2) / w.Hp, within = r - 2 - block * w.Hp;
    return within < w.H ? 2 + block * w.H + within : -1;
  }
  return r < s.rows ? r : -1;
}

// offsets in floats of segment i in the packed buffer (rounded up to 4 floats
// each, as pack_score_params lays them out) and in the image
__host__ __device__ inline void seg_offsets(int i, const Widths& w, long long& packed,
                                            long long& image) {
  packed = image = 0;
  for (int k = 0; k < i; ++k) {
    const Seg s = seg_shape(k, w);
    packed += (static_cast<long long>(s.rows) * s.cols + 3) / 4 * 4;
    image += static_cast<long long>(image_rows(s, w)) * image_cols(s.cols);
  }
}

// byte offsets of the layered plan's device scratch, each region 256-byte
// aligned; ops/score_kernel.py::score_scratch_bytes counts the same
struct LayeredScratch {
  size_t slab, mask, cnt, node, xa, xb, image, rows, logits, total;
};

// floats of one warp's rows: two [Hp][32] row blocks (a lane's embedding and
// projection input in the front pass; its FFN outputs in a GAT layer) and two
// [Hp] rows the warp shares (the FFN's input and hidden values).  A GAT layer
// also keeps each pair's logits, then softmax weights, in the warp's logit
// rows: [chunk][head][lane], S * heads * 32 floats.
__host__ __device__ inline long long warp_row_floats(const Widths& w) {
  return 2LL * w.Hp * 32 + 2LL * w.Hp;
}

__host__ inline LayeredScratch layered_scratch(long long B, long long N, bool bf16,
                                               const Widths& w) {
  auto al = [](size_t v) { return (v + 255) & ~static_cast<size_t>(255); };
  const size_t b = static_cast<size_t>(B), n = static_cast<size_t>(N), S = (n + 31) / 32;
  long long packed = 0, image = 0;
  seg_offsets(num_segments(w), w, packed, image);
  const size_t warps = b * ((n + kLDests - 1) / kLDests) * kLDests;
  LayeredScratch L;
  size_t o = 0;
  L.slab = o;
  o += al(b * n * S * 32 * w.Hp * (bf16 ? 2 : 4));
  L.mask = o;
  o += al(b * n * n * 4);
  L.cnt = o;
  o += al(b * n * 4);
  L.node = o;
  o += al(b * n * w.NR * 4);
  L.xa = o;
  o += al(b * n * w.H * 4);
  L.xb = o;
  o += al(b * n * w.H * 4);
  L.image = o;
  o += al(static_cast<size_t>(image) * 4);
  L.rows = o;
  o += al(warps * static_cast<size_t>(warp_row_floats(w)) * 4);
  L.logits = o;
  o += al(warps * S * w.heads * 32 * 4);
  L.total = o;
  return L;
}

// Launch 0: every segment into the image (blockIdx.y: the segment).
template <bool BF16>
__global__ void __launch_bounds__(256)
layered_weights_kernel(const float* __restrict__ params, float* __restrict__ image,
                       const Widths w) {
  const int i = blockIdx.y;
  const Seg s = seg_shape(i, w);
  long long src, dst;
  seg_offsets(i, w, src, dst);
  const float two_pi = static_cast<float>(2.0 * 3.14159265358979323846);
  const int ic = image_cols(s.cols);
  const long long n = static_cast<long long>(image_rows(s, w)) * ic;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n; e += 256LL * gridDim.x) {
    const int r = static_cast<int>(e / ic);
    const int c = static_cast<int>(e - static_cast<long long>(r) * ic);
    const int pr = packed_row(s, w, r);
    float v = c < s.cols && pr >= 0 ? params[src + static_cast<long long>(pr) * s.cols + c] : 0.f;
    if (s.kind == kSegFourier) v = v * two_pi;
    if (BF16 && (s.kind == kSegProduct || (s.kind == kSegProj1 && r >= 2))) v = rbf(v);
    image[dst + e] = v;
  }
}

// The weights a pass reads, in the pass's order (the kFw*, kGw* and kBw*
// indices below): each one's image offset and length.  Where all of them fit
// under kStageCap the pass stages them in the block's shared memory and reads
// them there (the kernels' SW = true); else it reads them all from the image,
// where L1 / L2 hold them (make_stage).  Either way the compiler sees one
// address space per instantiation.
constexpr int kMaxStaged = 10;
constexpr int kStageCap = 100 * 1024;   // bytes: two blocks an SM
struct Stage {
  long long img[kMaxStaged];   // image offset (floats)
  int len[kMaxStaged];         // floats, a multiple of 4; 0: the pass has no such weight
  int smem[kMaxStaged];        // offset in shared memory (floats) where staged
  int bytes;                   // shared memory the block stages, 0: none
};
enum { kFwWc, kFwCm, kFwBm, kFwP1, kFwB1, kFwP2, kFwB2, kFwDw, kFwIn, kFwBi };
enum { kGwWe, kGwBe, kGwWf1, kGwBf1, kGwWf2, kGwBf2, kGwS1, kGwO1, kGwS2, kGwO2 };
enum { kBwWbe, kBwBbe, kBwWo, kBwBo };

__host__ inline Stage make_stage(const long long (&img)[kMaxStaged], const int (&len)[kMaxStaged]) {
  Stage st;
  int used = 0;
  for (int i = 0; i < kMaxStaged; ++i) {
    st.img[i] = img[i];
    st.len[i] = len[i];
    st.smem[i] = used;
    used += len[i];
  }
  st.bytes = used * 4 <= kStageCap ? used * 4 : 0;
  return st;
}

// where the pass reads weight i: the block's shared memory after staging
// every weight there (SW, by the whole block, before any thread returns), or
// the image
template <bool SW>
__device__ __forceinline__ void stage_weights(const float* image, const Stage& st, float* smem,
                                              const float* (&ptr)[kMaxStaged]) {
#pragma unroll
  for (int i = 0; i < kMaxStaged; ++i) {
    if (SW) {
      stage(smem + st.smem[i], image + st.img[i], st.len[i], blockDim.x);
      ptr[i] = smem + st.smem[i];
    } else {
      ptr[i] = image + st.img[i];
    }
  }
  if (SW) {
    staged();
    __syncthreads();
  }
}

struct NodeW {
  long long w[4], b[4];   // up to four [H, cols] kernels side by side; b < 0: no bias
};

// this lane's 16-byte words of the slab unit (molecule b, destination d,
// chunk j): 32 lanes x Hp / 8 words (bf16) or Hp / 4 (f32), word k of lane l
// at 32 k + l
template <bool BF16>
__device__ __forceinline__ uint4* lunit(void* slab, int b, int N, int S, int d, int j, int Hp) {
  const int words = BF16 ? Hp / 8 : Hp / 4;
  return static_cast<uint4*>(slab) +
         ((static_cast<size_t>(b) * N + d) * S + j) * words * 32 + (threadIdx.x & 31);
}

// the 32 values of slice o (a multiple of 32) into the lane's slab words
template <bool BF16>
__device__ __forceinline__ void lstore_slice(uint4* unit, int o, const float (&v)[32]) {
  if constexpr (BF16) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      __stcg(unit + 32 * (o / 8 + q),
             make_uint4(pack_bf16x2(v[8 * q], v[8 * q + 1]),
                        pack_bf16x2(v[8 * q + 2], v[8 * q + 3]),
                        pack_bf16x2(v[8 * q + 4], v[8 * q + 5]),
                        pack_bf16x2(v[8 * q + 6], v[8 * q + 7])));
  } else {
    float4* p = reinterpret_cast<float4*>(unit);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      __stcg(p + 32 * (o / 4 + q), make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  }
}

// values k0 .. k0 + 7 (k0 a multiple of 8) of the lane's slab row
template <bool BF16>
__device__ __forceinline__ void lload8(const uint4* unit, int k0, float (&e)[8]) {
  if constexpr (BF16) {
    const uint4 r = __ldcg(unit + 32 * (k0 / 8));
    const uint32_t x[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[2 * i] = __uint_as_float(x[i] << 16);
      e[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(unit);
    const float4 a = __ldcg(p + 32 * (k0 / 4)), b = __ldcg(p + 32 * (k0 / 4 + 1));
    e[0] = a.x; e[1] = a.y; e[2] = a.z; e[3] = a.w;
    e[4] = b.x; e[5] = b.y; e[6] = b.z; e[7] = b.w;
  }
}

// acc[j] += e * w[j] for one weight row slice of W floats (16-byte aligned,
// in shared memory or the image)
template <int W>
__device__ __forceinline__ void fma_row(float e, const float* w, float (&acc)[W]) {
  const float4* wr = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const float4 q = wr[j];
    acc[4 * j] = fmaf(e, q.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(e, q.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(e, q.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(e, q.w, acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void store_rows(float* row, int o, const float (&v)[32]) {
#pragma unroll
  for (int c = 0; c < 32; ++c) row[32 * (o + c)] = v[c];
}

__device__ __forceinline__ void load_rows(const float* row, int o, float (&v)[32]) {
#pragma unroll
  for (int c = 0; c < 32; ++c) v[c] = row[32 * (o + c)];
}

// acc[j] += sum_{k < 32} e[k] * w[k][j] for 32 inputs in registers, w a
// weight slice with row stride ldw (its rows past H zero, as the inputs
// there), in the order of k
__device__ __forceinline__ void matvec_regs(const float (&e)[32], const float* w, int ldw,
                                            float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) fma_row(e[i], w + static_cast<size_t>(i) * ldw, acc);
}

// the same for K inputs from the lane's [channel][lane] rows (a stride of 32
// floats), 8 at a time into registers (K rounded up to 32: the rows past K
// are zero, as the inputs there)
__device__ __forceinline__ void matvec_rows(const float* row, int K, const float* w, int ldw,
                                            float (&acc)[32]) {
  const int kp = round32(K);
#pragma unroll 1
  for (int k0 = 0; k0 < kp; k0 += 8) {
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = row[32 * (k0 + i)];
#pragma unroll
    for (int i = 0; i < 8; ++i) fma_row(e[i], w + static_cast<size_t>(k0 + i) * ldw, acc);
  }
}

// values k0 .. k0 + 31 (k0 a multiple of 32) of the lane's slab row
template <bool BF16>
__device__ __forceinline__ void lload32(const uint4* unit, int k0, float (&e)[32]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float part[8];
    lload8<BF16>(unit, k0 + 8 * q, part);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[8 * q + i] = part[i];
  }
}

// the same for K inputs from the lane's slab words, 8 at a time, into W
// outputs
template <bool BF16, int W>
__device__ __forceinline__ void matvec_slab(const uint4* unit, int K, const float* w, int ldw,
                                            float (&acc)[W]) {
  const int kp = round32(K);
#pragma unroll 1
  for (int k0 = 0; k0 < kp; k0 += 8) {
    float e[8];
    lload8<BF16>(unit, k0, e);
#pragma unroll
    for (int i = 0; i < 8; ++i) fma_row(e[i], w + static_cast<size_t>(k0 + i) * ldw, acc);
  }
}

// slice o of one coefficient pair's embedding: [sin, cos](c0 * wc) | [sin,
// cos](c2 * wc) through the [4H, H] coff_mlp kernel (image rows of ldw), plus
// its bias; bf16 mode rounds the Fourier features first (coff_embed's sums)
template <bool BF16>
__device__ __forceinline__ void coff_embed_slice(float c0, float c2, const float* wc,
                                                 const float* wm, const float* bm, int H, int ldw,
                                                 int o, float (&acc)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
    float s0, k0, s2, k2;
    const float wk = wc[k];
    sincosf(c0 * wk, &s0, &k0);
    sincosf(c2 * wk, &s2, &k2);
    if (BF16) {
      s0 = rbf(s0);
      k0 = rbf(k0);
      s2 = rbf(s2);
      k2 = rbf(k2);
    }
    const float4* r0 = reinterpret_cast<const float4*>(wm + static_cast<size_t>(k) * ldw + o);
    const float4* r1 = reinterpret_cast<const float4*>(wm + static_cast<size_t>(H + k) * ldw + o);
    const float4* r2 =
        reinterpret_cast<const float4*>(wm + static_cast<size_t>(2 * H + k) * ldw + o);
    const float4* r3 =
        reinterpret_cast<const float4*>(wm + static_cast<size_t>(3 * H + k) * ldw + o);
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
  for (int j = 0; j < 32; ++j) acc[j] += bm[o + j];
}

// this warp's rows (warp_row_floats of them), the lane's column of the row blocks
__device__ __forceinline__ float* warp_rows(float* rows, const Widths& w) {
  return rows + (static_cast<size_t>(blockIdx.x) * kLDests + (threadIdx.x >> 5)) *
                    static_cast<size_t>(warp_row_floats(w));
}

// Launch 1: the masked edge features of the block's destinations and every
// source into the slab, the mask as maskT[b][d][s], and cnt[b][d] = max(1,
// valid sources).  The lane's embedding of s sits in its first row block,
// the projection's input in the second.
template <bool BF16, bool SW>
__global__ void __launch_bounds__(kLThreads, 2)
layered_front_kernel(const float* __restrict__ pos, const float* __restrict__ edge2d,
                     const float* __restrict__ mask, const float* __restrict__ image,
                     const Stage st, void* __restrict__ slab, float* __restrict__ maskT,
                     float* __restrict__ cnt, float* __restrict__ rows, int N, int S, int dtiles,
                     const Widths w) {
  extern __shared__ __align__(16) float stg[];
  const float* wt[kMaxStaged];
  stage_weights<SW>(image, st, stg, wt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / dtiles, d = (blockIdx.x - b * dtiles) * kLDests + warp;
  if (d >= N) return;
  const int H = w.H, Hp = w.Hp;
  float* emb = warp_rows(rows, w) + lane;
  float* pre_row = emb + static_cast<size_t>(Hp) * 32;
  const float* wc = wt[kFwWc];
  const float* p1 = wt[kFwP1];
  const size_t dn = static_cast<size_t>(b) * N + d;
  const float pd[3] = {pos[dn * 3], pos[dn * 3 + 1], pos[dn * 3 + 2]};
  float count = 0.f;
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    const int s = 32 * j + lane;
    const bool real = s < N;
    const size_t sn = static_cast<size_t>(b) * N + s;
    const float m = real ? mask[sn * N + d] : 0.f;
    count += warp_sum(m);
    if (!real) continue;
    maskT[dn * N + s] = m;
    const float ps[3] = {pos[sn * 3], pos[sn * 3 + 1], pos[sn * 3 + 2]};
    float cs[3], cd[3], psin, pcos;
    pair_geometry(ps, pd, cs, cd, psin, pcos);
    const float dist = norm3(ps[0] - pd[0], ps[1] - pd[1], ps[2] - pd[2]);
    const float* e2d = edge2d + (sn * N + d) * H;
    uint4* unit = lunit<BF16>(slab, b, N, S, d, j, Hp);
    // slice o of frame_inv (acc, without its bias) with variant 2's distance
    // gate, the 2D edge features and the mask into the slab
    auto edge_slice = [&](int o, float (&acc)[32]) {
      float gate[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) gate[k] = 0.f;
      if (w.variant == 2) {
        const float* in = wt[kFwIn] + o;
#pragma unroll 1
        for (int k = 0; k < H; ++k) {
          float sn_, cs_;
          sincosf(dist * wt[kFwDw][k], &sn_, &cs_);
          sn_ = rnd<BF16>(sn_);
          cs_ = rnd<BF16>(cs_);
          const float4* ra = reinterpret_cast<const float4*>(in + static_cast<size_t>(k) * Hp);
          const float4* rb =
              reinterpret_cast<const float4*>(in + static_cast<size_t>(H + k) * Hp);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float4 qa = ra[q], qb = rb[q];
            gate[4 * q] += sn_ * qa.x + cs_ * qb.x;
            gate[4 * q + 1] += sn_ * qa.y + cs_ * qb.y;
            gate[4 * q + 2] += sn_ * qa.z + cs_ * qb.z;
            gate[4 * q + 3] += sn_ * qa.w + cs_ * qb.w;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int c = o + k;
        const float ev = c < H ? __ldg(e2d + c) : 0.f;
        const float b2 = wt[kFwB2][c];
        const float v = w.variant == 2 ? (gate[k] + wt[kFwBi][c]) * ev + (acc[k] + b2)
                                       : ev + (acc[k] + b2);
        acc[k] = rnd<BF16>(v * m);
      }
      lstore_slice<BF16>(unit, o, acc);
    };
    // the projection's input: the embedding of s's coefficients through its
    // rows 2 .. H + 1, then that of d's through rows H + 2 .. 2 H + 1, in
    // one sum per channel
    float acc[32];
    if (Hp == 32) {   // one slice: the pair's rows stay in registers
      float pre[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) pre[k] = 0.f;
      coff_embed_slice<BF16>(cs[0], cs[2], wc, wt[kFwCm], wt[kFwBm], H, Hp, 0, acc);
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = rnd<BF16>(acc[k]);
      matvec_regs(acc, p1 + 2 * Hp, Hp, pre);
      coff_embed_slice<BF16>(cd[0], cd[2], wc, wt[kFwCm], wt[kFwBm], H, Hp, 0, acc);
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = rnd<BF16>(acc[k]);
      matvec_regs(acc, p1 + static_cast<size_t>(2 + Hp) * Hp, Hp, pre);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        pre[k] += psin * p1[k] + pcos * p1[Hp + k] + wt[kFwB1][k];
        pre[k] = rnd<BF16>(silu<false>(pre[k]));
        acc[k] = 0.f;
      }
      matvec_regs(pre, wt[kFwP2], Hp, acc);   // frame_inv (without bias)
      edge_slice(0, acc);
      continue;
    }
#pragma unroll 1
    for (int o = 0; o < Hp; o += 32) {
      coff_embed_slice<BF16>(cs[0], cs[2], wc, wt[kFwCm], wt[kFwBm], H, Hp, o, acc);
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = rnd<BF16>(acc[k]);
      store_rows(emb, o, acc);
    }
#pragma unroll 1
    for (int o = 0; o < Hp; o += 32) {
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
      matvec_rows(emb, H, p1 + 2 * static_cast<size_t>(Hp) + o, Hp, acc);
      store_rows(pre_row, o, acc);
    }
#pragma unroll 1
    for (int o = 0; o < Hp; o += 32) {
      coff_embed_slice<BF16>(cd[0], cd[2], wc, wt[kFwCm], wt[kFwBm], H, Hp, o, acc);
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = rnd<BF16>(acc[k]);
      store_rows(emb, o, acc);
    }
#pragma unroll 1
    for (int o = 0; o < Hp; o += 32) {
      load_rows(pre_row, o, acc);
      matvec_rows(emb, H, p1 + static_cast<size_t>(2 + Hp) * Hp + o, Hp, acc);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        acc[k] += psin * p1[o + k] + pcos * p1[Hp + o + k] + wt[kFwB1][o + k];
        acc[k] = rnd<BF16>(silu<false>(acc[k]));
      }
      store_rows(pre_row, o, acc);
    }
    // frame_inv slice by slice into the slab
#pragma unroll 1
    for (int o = 0; o < Hp; o += 32) {
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
      matvec_rows(pre_row, H, wt[kFwP2] + o, Hp, acc);
      edge_slice(o, acc);
    }
  }
  if (lane == 0) cnt[dn] = fmaxf(count, 1.f);
}

// out[row][m cols + c] = sum_k x[row][k] W_m[k][c] (+ b_m[c]) for every node
// row (B N of them, row stride NR; x rows of H), a thread per value, one FMA
// chain over k in order; the image's product weights are rounded in bf16
// mode, x is rounded here (already so past layer 0)
template <bool BF16>
__global__ void __launch_bounds__(kLNodeThreads)
layered_node_kernel(const float* __restrict__ x, const float* __restrict__ image, const NodeW nw,
                    float* __restrict__ out, long long total, int per_row, int cols,
                    const Widths w) {
  const long long i = static_cast<long long>(blockIdx.x) * kLNodeThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / per_row;
  const int o = static_cast<int>(i - row * per_row), m = o / cols, c = o - m * cols;
  const float* xr = x + row * w.H;
  const float* wt = image + nw.w[m] + c;
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < w.H; ++k) acc = fmaf(rnd<BF16>(__ldg(xr + k)), __ldg(wt + k * cols), acc);
  out[row * w.NR + o] = nw.b[m] >= 0 ? acc + __ldg(image + nw.b[m] + c) : acc;
}

// the logits of the lane's pair (s, d) for every head: sum over the head's
// channels of round((k[s] + e2) * q[d]) times 1 / sqrt(chead), the float
// minimum where the pair is masked (the plain version's fill).  e2 = slab row
// @ W_e + b_e slice by slice; k[s] (the lane's own row) and q[d] (the same in
// every lane) are read 16 bytes at a time.
template <bool BF16>
__device__ __forceinline__ void llogits(const uint4* unit, const float* __restrict__ ks,
                                        const float* __restrict__ qd, const float* we,
                                        const float* be, float m, const Widths& w,
                                        float (&lh)[kLMaxHeads]) {
  const int H = w.H, Hp = w.Hp;
  float cur = 0.f;
  int head = 0, in_head = 0;
#pragma unroll
  for (int hh = 0; hh < kLMaxHeads; ++hh) lh[hh] = 0.f;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 16) {   // e2 in halves of a slice: fewer registers
    float e2[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) e2[c] = 0.f;
    matvec_slab<BF16, 16>(unit, H, we + o, Hp, e2);
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const float4 k4 = __ldg(reinterpret_cast<const float4*>(ks + o) + q4);
      const float4 d4 = __ldg(reinterpret_cast<const float4*>(qd + o) + q4);
      const float kv[4] = {k4.x, k4.y, k4.z, k4.w}, qv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * q4 + i;
        if (o + c < H) {
          const float e = e2[c] + be[o + c];
          cur += rnd<BF16>(__fmul_rn(kv[i] + e, qv[i]));
          if (++in_head == w.chead) {
#pragma unroll
            for (int hh = 0; hh < kLMaxHeads; ++hh)
              if (hh == head) lh[hh] = cur;
            cur = 0.f;
            in_head = 0;
            ++head;
          }
        }
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kLMaxHeads; ++hh)
    lh[hh] = m > 0.f ? lh[hh] * w.scale : -3.402823466e38f;
}

// One DenseGAT layer of the block's destinations (a warp each): node row [q |
// k | v | skip] (offsets 0, Hp, 2 Hp, 3 Hp) from layered_node_kernel, x in,
// the new x out.  The first pass keeps each pair's logits, then its softmax
// weight, in the lane's logit rows ([chunk][head][lane]); the message is
// formed slice by slice, e2 again and the sum over the lane's chunks in
// registers.  The warp's FFN input and hidden values sit in its two rows.
template <bool BF16, bool SW>
__global__ void __launch_bounds__(kLThreads, 2)
layered_gat_kernel(void* __restrict__ slab, const float* __restrict__ maskT,
                   const float* __restrict__ nodeq, const float* __restrict__ xin,
                   float* __restrict__ xout, const float* __restrict__ image, const Stage st,
                   float* __restrict__ rows, float* __restrict__ logit_rows, int N, int S,
                   int dtiles, int silu_out, const Widths w) {
  extern __shared__ __align__(16) float stg[];
  const float* wt[kMaxStaged];
  stage_weights<SW>(image, st, stg, wt);
  const float *we = wt[kGwWe], *be = wt[kGwBe];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / dtiles, d = (blockIdx.x - b * dtiles) * kLDests + warp;
  if (d >= N) return;
  const int H = w.H, Hp = w.Hp, NR = w.NR, heads = w.heads;
  float* f = warp_rows(rows, w) + 2 * static_cast<size_t>(Hp) * 32;   // the FFN input row
  float* g = f + Hp;                                                   // and hidden row
  float* lg = logit_rows +
              (static_cast<size_t>(blockIdx.x) * kLDests + warp) * S * heads * 32 + lane;
  const size_t dn = static_cast<size_t>(b) * N + d;
  const float* qd = nodeq + dn * NR;
  const float* mrow = maskT + dn * N;
  // the softmax over the sources: each lane's running max and sum per head
  // over its chunks, then merged across the warp
  float mx[kLMaxHeads], sm[kLMaxHeads];
#pragma unroll
  for (int hh = 0; hh < kLMaxHeads; ++hh) {
    mx[hh] = __uint_as_float(0xff800000u);   // -inf
    sm[hh] = 0.f;
  }
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    const int s = 32 * j + lane;
    if (s >= N) continue;
    float lh[kLMaxHeads];
    llogits<BF16>(lunit<BF16>(slab, b, N, S, d, j, Hp),
                  nodeq + (static_cast<size_t>(b) * N + s) * NR + Hp, qd, we, be, mrow[s], w,
                  lh);
#pragma unroll
    for (int hh = 0; hh < kLMaxHeads; ++hh) {
      if (hh >= heads) break;
      lg[32 * (j * heads + hh)] = lh[hh];
      if (lh[hh] > mx[hh]) {
        sm[hh] = sm[hh] * expf(mx[hh] - lh[hh]) + 1.f;
        mx[hh] = lh[hh];
      } else {
        sm[hh] += expf(lh[hh] - mx[hh]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kLMaxHeads; ++hh) {
    if (hh >= heads) break;
    const float top = warp_max(mx[hh]);
    const float part = sm[hh] > 0.f ? sm[hh] * expf(mx[hh] - top) : 0.f;
    sm[hh] = fmaxf(warp_sum(part), 1e-30f);
    mx[hh] = top;
  }
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    const int s = 32 * j + lane;
    if (s >= N) continue;
    const float m = mrow[s];
#pragma unroll
    for (int hh = 0; hh < kLMaxHeads; ++hh) {
      if (hh >= heads) break;
      float* l = lg + 32 * (j * heads + hh);
      *l = rnd<BF16>(expf(*l - mx[hh]) / sm[hh] * m);
    }
  }
  // the message, slice by slice: alpha (v[s] + e2) summed over this lane's
  // chunks in order, then over the lanes; lane l keeps channel o + l of each
  // slice o from here on, its mha in the warp's FFN input row
  const float *s1 = wt[kGwS1], *o1 = wt[kGwO1], *s2 = wt[kGwS2], *o2 = wt[kGwO2];
  float loc = 0.f;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    float msg[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) msg[c] = 0.f;
    int head = o / w.chead;
    const int in0 = o - head * w.chead;
#pragma unroll 1
    for (int j = 0; j < S; ++j) {
      const int s = 32 * j + lane;
      if (s >= N) continue;
      const uint4* unit = lunit<BF16>(slab, b, N, S, d, j, Hp);
      const float* alpha = lg + 32 * (j * heads);
      const float* vs = nodeq + (static_cast<size_t>(b) * N + s) * NR + 2 * Hp + o;
      int hd = head, in_head = in0;
      float a = alpha[32 * hd];
#pragma unroll
      for (int half = 0; half < 32; half += 16) {   // e2 in halves: fewer registers
        float e2[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) e2[c] = 0.f;
        matvec_slab<BF16, 16>(unit, H, we + o + half, Hp, e2);
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(vs + half) + q4);
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = half + 4 * q4 + i;
            if (o + c < H) {
              msg[c] += a * (vv[i] + (e2[c - half] + be[o + c]));
              if (++in_head == w.chead && o + c + 1 < H) {
                in_head = 0;
                a = alpha[32 * ++hd];
              }
            }
          }
        }
      }
    }
    const int c = o + lane;
    const float mha = rnd<BF16>(reduce_scatter(msg, lane) + (c < H ? qd[3 * Hp + c] : 0.f));
    f[c] = mha;
    if (c < H) loc = o == 0 ? mha : loc + mha;
  }
  float mean = warp_sum(loc) * w.inv_h;
  loc = 0.f;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    const float dv = f[c] - mean;
    if (c < H) loc = o == 0 ? dv * dv : loc + dv * dv;
  }
  float rstd = rsqrtf(warp_sum(loc) * w.inv_h + 1e-6f);
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    if (c < H) {
      const float dv = f[c] - mean;
      const float y = dv * rstd * s1[c] + o1[c];
      f[c] = rnd<BF16>(rnd<BF16>(xin[dn * H + c]) + rnd<BF16>(y));
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    if (c < H) {
      float hacc = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) hacc = fmaf(f[k], wt[kGwWf1][k * Hp + c], hacc);
      g[c] = rnd<BF16>(silu<false>(hacc + wt[kGwBf1][c]));
    }
  }
  __syncwarp();
  // the FFN's outputs into the lane's own row (the front pass's first row
  // block, free here), then LayerNorm and the residual
  float* own = warp_rows(rows, w) + lane;
  loc = 0.f;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    if (c < H) {
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(g[k], wt[kGwWf2][k * Hp + c], acc);
      acc = rnd<BF16>(acc + wt[kGwBf2][c]);
      own[32 * o] = acc;
      loc = o == 0 ? acc : loc + acc;
    }
  }
  mean = warp_sum(loc) * w.inv_h;
  loc = 0.f;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    const float dv = own[32 * o] - mean;
    if (c < H) loc = o == 0 ? dv * dv : loc + dv * dv;
  }
  rstd = rsqrtf(warp_sum(loc) * w.inv_h + 1e-6f);
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    if (c < H) {
      const float dv = own[32 * o] - mean;
      const float y = dv * rstd * s2[c] + o2[c];
      float x2 = rnd<BF16>(f[c] + rnd<BF16>(y));
      if (silu_out) x2 = silu<false>(x2);
      xout[dn * H + c] = rnd<BF16>(x2);
    }
  }
}

// One basis module: cc = b_o + the sum over the TPU kernel's chunks of 64
// channels (CD itself where CD < 64) of coff[:, chunk] @ W_o[chunk], coff =
// silu((hp[s] + hp[d]) + (slab row @ W_be + b_be)), rounded as W_o's operand
// in bf16 mode; the score row of d gets sum_s rows(cc, frame) mask[s, d] /
// cnt[d], chunk of sources by chunk in order (first: written, else added).
template <bool BF16, bool SW>
__global__ void __launch_bounds__(kLThreads, 2)
layered_basis_kernel(void* __restrict__ slab, const float* __restrict__ maskT,
                     const float* __restrict__ cnt, const float* __restrict__ pos,
                     const float* __restrict__ hp, const float* __restrict__ image,
                     const Stage st, int N, int S, int dtiles, float* __restrict__ out,
                     int first, const Widths w) {
  extern __shared__ __align__(16) float stg[];
  const float* wt[kMaxStaged];
  stage_weights<SW>(image, st, stg, wt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / dtiles, d = (blockIdx.x - b * dtiles) * kLDests + warp;
  if (d >= N) return;
  const int H = w.H, Hp = w.Hp, CD = w.CD, CDp = w.CDp, NR = w.NR;
  const size_t dn = static_cast<size_t>(b) * N + d;
  const float* hpd = hp + dn * NR;
  const float* wo = wt[kBwWo];
  const float pd[3] = {pos[dn * 3], pos[dn * 3 + 1], pos[dn * 3 + 2]};
  const float* mrow = maskT + dn * N;
  const float count = cnt[dn];
  float tot[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    const int s = 32 * j + lane;
    float contrib[3] = {0.f, 0.f, 0.f};
    if (s < N) {
      const size_t sn = static_cast<size_t>(b) * N + s;
      const uint4* unit = lunit<BF16>(slab, b, N, S, d, j, Hp);
      float ea[32];   // the slab row, read once where it is one slice (H <= 32)
      if (Hp == 32) lload32<BF16>(unit, 0, ea);
      const float* hs = hp + sn * NR;
      float cc[3] = {wt[kBwBo][0], wt[kBwBo][1], wt[kBwBo][2]};
      float part[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
      for (int c0 = 0; c0 < CDp; c0 += 32) {
        float acc[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] = 0.f;
        if (Hp == 32)
          matvec_regs(ea, wt[kBwWbe] + c0, CDp, acc);
        else
          matvec_slab<BF16, 32>(unit, H, wt[kBwWbe] + c0, CDp, acc);
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4) {
          const float4 h4 = __ldg(reinterpret_cast<const float4*>(hs + c0) + q4);
          const float4 d4 = __ldg(reinterpret_cast<const float4*>(hpd + c0) + q4);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w}, dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = c0 + 4 * q4 + i;
            if (c < CD) {
              const float coff = rnd<BF16>(
                  silu<false>((hv[i] + dv[i]) + (acc[4 * q4 + i] + wt[kBwBbe][c])));
              const float4 wo4 = reinterpret_cast<const float4*>(wo)[c];
              part[0] = fmaf(coff, wo4.x, part[0]);
              part[1] = fmaf(coff, wo4.y, part[1]);
              part[2] = fmaf(coff, wo4.z, part[2]);
            }
          }
        }
        if ((c0 + 32) % 64 == 0 || c0 + 32 >= CD) {   // the TPU kernel's chunks
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            cc[i] += part[i];
            part[i] = 0.f;
          }
        }
      }
      const float ps[3] = {pos[sn * 3], pos[sn * 3 + 1], pos[sn * 3 + 2]};
      Frame fr;
      make_frame(ps, pd, fr);
      const float mn = mrow[s] / count;
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        const float r = rnd<BF16>(cc[0] * fr.df[comp]) + rnd<BF16>(cc[1] * fr.cr[comp]) +
                        rnd<BF16>(cc[2] * fr.vt[comp]);
        contrib[comp] = r * mn;
      }
    }
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) tot[comp] += warp_sum(contrib[comp]);
  }
  if (lane == 0) {
#pragma unroll
    for (int comp = 0; comp < 3; ++comp)
      out[dn * 3 + comp] = first ? tot[comp] : out[dn * 3 + comp] + tot[comp];
  }
}

// the image offset and length (floats) of packed segment i
__host__ inline long long image_at(int i, const Widths& w) {
  long long packed, image;
  seg_offsets(i, w, packed, image);
  return image;
}

__host__ inline int image_len(int i, const Widths& w) {
  const Seg s = seg_shape(i, w);
  return image_rows(s, w) * image_cols(s.cols);
}

// the front pass's weights: segments 0 .. 6 (9 in variant 2), the kFw order
__host__ inline Stage front_stage(const Widths& w) {
  long long img[kMaxStaged] = {};
  int len[kMaxStaged] = {};
  for (int i = 0; i < front_segments(w.variant); ++i) {
    img[i] = image_at(i, w);
    len[i] = image_len(i, w);
  }
  return make_stage(img, len);
}

// a GAT layer's pair pass from its first segment seg: the edge kernel, the
// FFN's and the LayerNorms (q / k / v / skip are the node pass's)
__host__ inline Stage gat_stage(int seg, const Widths& w) {
  static const int part[kMaxStaged] = {6, 7, 10, 11, 12, 13, 14, 15, 16, 17};   // kGw order
  long long img[kMaxStaged] = {};
  int len[kMaxStaged] = {};
  for (int i = 0; i < kMaxStaged; ++i) {
    img[i] = image_at(seg + part[i], w);
    len[i] = image_len(seg + part[i], w);
  }
  return make_stage(img, len);
}

// a basis module's pair pass from its first segment seg (basis_node is the
// node pass's)
__host__ inline Stage basis_stage(int seg, const Widths& w) {
  long long img[kMaxStaged] = {};
  int len[kMaxStaged] = {};
  for (int i = 0; i < 4; ++i) {   // kBw order: segments seg + 1 .. seg + 4
    img[i] = image_at(seg + 1 + i, w);
    len[i] = image_len(seg + 1 + i, w);
  }
  return make_stage(img, len);
}

// dynamic shared memory of the layered plan's largest pass block
__host__ inline int layered_smem(const Widths& w) {
  const int gat0 = front_segments(w.variant), basis0 = gat0 + 18 * w.L * w.NC;
  int bytes = front_stage(w).bytes;
  const int gat = w.L * w.NC > 0 ? gat_stage(gat0, w).bytes : 0;
  const int basis = w.L > 0 ? basis_stage(basis0, w).bytes : 0;
  return bytes > gat ? (bytes > basis ? bytes : basis) : (gat > basis ? gat : basis);
}

template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute((const void*)kernel,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  bytes)
                           : cudaSuccess;
}

// the widths of an evaluation; false where the layered plan cannot take them
// (the TPU kernel cannot compute them either: more than 8 heads, heads that
// do not divide the hidden width, a basis width past 64 that is not a multiple
// of 64)
__host__ inline bool make_widths(int variant, int L, int NC, int H, int heads, int CD,
                                 Widths& w) {
  if ((variant != 1 && variant != 2) || L < 0 || NC < 0 || H < 1 || CD < 1 || heads < 1 ||
      heads > kLMaxHeads || H % heads != 0 || (CD > 64 && CD % 64 != 0))
    return false;
  w.variant = variant;
  w.L = L;
  w.NC = NC;
  w.H = H;
  w.Hp = round32(H);
  w.CD = CD;
  w.CDp = round32(CD);
  w.NR = 4 * w.Hp > w.CDp ? 4 * w.Hp : w.CDp;
  w.heads = heads;
  w.chead = H / heads;
  w.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(w.chead)));
  w.inv_h = 1.f / static_cast<float>(H);
  return true;
}

template <bool BF16>
int launch_layered(const float* pos, const float* node, const float* edge2d, const float* mask,
                   const float* params, float* out, unsigned char* scratch, int B, int N,
                   const Widths& w, cudaStream_t st) {
  const LayeredScratch sc = layered_scratch(B, N, BF16, w);
  void* slab = scratch + sc.slab;
  float* maskT = reinterpret_cast<float*>(scratch + sc.mask);
  float* cnt = reinterpret_cast<float*>(scratch + sc.cnt);
  float* nodebuf = reinterpret_cast<float*>(scratch + sc.node);
  float* xbuf[2] = {reinterpret_cast<float*>(scratch + sc.xa),
                    reinterpret_cast<float*>(scratch + sc.xb)};
  float* image = reinterpret_cast<float*>(scratch + sc.image);
  float* rows = reinterpret_cast<float*>(scratch + sc.rows);
  float* logit_rows = reinterpret_cast<float*>(scratch + sc.logits);
  const int S = (N + 31) / 32, dtiles = (N + kLDests - 1) / kLDests;
  const long long pair_blocks = static_cast<long long>(B) * dtiles;
  const long long node_items = static_cast<long long>(B) * N * w.NR;
  const long long node_blocks = (node_items + kLNodeThreads - 1) / kLNodeThreads;
  const int nseg = num_segments(w);
  if (pair_blocks > 0x7fffffffll || node_blocks > 0x7fffffffll || nseg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto at = [&](int i) { return image_at(i, w); };
  layered_weights_kernel<BF16><<<dim3(8, nseg), 256, 0, st>>>(params, image, w);
  if (w.L == 0) {   // no module: the score is 0
    const cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(B) * N * 3 * 4, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  // each pass in its staged instantiation where its weights fit (make_stage)
  const int gat0 = front_segments(w.variant), basis0 = gat0 + 18 * w.L * w.NC;
  const Stage fst = front_stage(w), bst0 = basis_stage(basis0, w);
  const int gat_bytes = w.NC > 0 ? gat_stage(gat0, w).bytes : 0;
  cudaError_t e = allow_smem(layered_front_kernel<BF16, true>, fst.bytes);
  if (e == cudaSuccess) e = allow_smem(layered_gat_kernel<BF16, true>, gat_bytes);
  if (e == cudaSuccess) e = allow_smem(layered_basis_kernel<BF16, true>, bst0.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned pb = static_cast<unsigned>(pair_blocks);
  if (fst.bytes)
    layered_front_kernel<BF16, true><<<pb, kLThreads, fst.bytes, st>>>(
        pos, edge2d, mask, image, fst, slab, maskT, cnt, rows, N, S, dtiles, w);
  else
    layered_front_kernel<BF16, false><<<pb, kLThreads, 0, st>>>(
        pos, edge2d, mask, image, fst, slab, maskT, cnt, rows, N, S, dtiles, w);
  const float* x = node;
  int li = 0;
  for (int mod = 0; mod < w.L; ++mod) {
    for (int conv = 0; conv < w.NC; ++conv) {
      const int seg = gat0 + 18 * (mod * w.NC + conv);
      // q, k, v, skip: GAT kernels 0, 1, 2 and 4, each followed by its bias
      const NodeW nw = {{at(seg), at(seg + 2), at(seg + 4), at(seg + 8)},
                        {at(seg + 1), at(seg + 3), at(seg + 5), at(seg + 9)}};
      const long long items = static_cast<long long>(B) * N * 4 * w.Hp;
      layered_node_kernel<BF16><<<static_cast<unsigned>((items + kLNodeThreads - 1) /
                                                        kLNodeThreads),
                                  kLNodeThreads, 0, st>>>(x, image, nw, nodebuf, items,
                                                          4 * w.Hp, w.Hp, w);
      const Stage gst = gat_stage(seg, w);
      float* xn = xbuf[li++ & 1];
      if (gst.bytes)
        layered_gat_kernel<BF16, true><<<pb, kLThreads, gst.bytes, st>>>(
            slab, maskT, nodebuf, x, xn, image, gst, rows, logit_rows, N, S, dtiles,
            conv < w.NC - 1, w);
      else
        layered_gat_kernel<BF16, false><<<pb, kLThreads, 0, st>>>(
            slab, maskT, nodebuf, x, xn, image, gst, rows, logit_rows, N, S, dtiles,
            conv < w.NC - 1, w);
      x = xn;
    }
    const int seg = basis0 + 5 * mod;
    const NodeW hw = {{at(seg), 0, 0, 0}, {-1, -1, -1, -1}};
    const long long items = static_cast<long long>(B) * N * w.CDp;
    layered_node_kernel<BF16><<<static_cast<unsigned>((items + kLNodeThreads - 1) /
                                                      kLNodeThreads),
                                kLNodeThreads, 0, st>>>(x, image, hw, nodebuf, items, w.CDp,
                                                        w.CDp, w);
    const Stage bst = basis_stage(seg, w);
    if (bst.bytes)
      layered_basis_kernel<BF16, true><<<pb, kLThreads, bst.bytes, st>>>(
          slab, maskT, cnt, pos, nodebuf, image, bst, N, S, dtiles, out, mod == 0, w);
    else
      layered_basis_kernel<BF16, false><<<pb, kLThreads, 0, st>>>(
          slab, maskT, cnt, pos, nodebuf, image, bst, N, S, dtiles, out, mod == 0, w);
  }
  return static_cast<int>(cudaGetLastError());
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

// The layered plan: dynamic shared memory of its largest pass block at these
// widths (the weights it stages, ops/score_kernel.py::layered_smem counts the
// same); -1 for widths it does not take.
extern "C" int score_eval_layered_smem_bytes(int variant, int num_layers, int num_convs,
                                             int hidden, int heads, int coff_dim) {
  Widths w;
  if (!make_widths(variant, num_layers, num_convs, hidden, heads, coff_dim, w)) return -1;
  return layered_smem(w);
}

// The layered plan: bytes of device scratch it needs at B x N and these
// widths (ops/score_kernel.py::score_scratch_bytes counts the same); -1 for
// widths it does not take.
extern "C" long long score_eval_layered_scratch_bytes(int B, int N, int bf16, int variant,
                                                      int num_layers, int num_convs,
                                                      int hidden, int heads, int coff_dim) {
  Widths w;
  if (!make_widths(variant, num_layers, num_convs, hidden, heads, coff_dim, w)) return -1;
  return static_cast<long long>(layered_scratch(B, N, bf16 != 0, w).total);
}

// The layered plan at any N and any width the TPU kernel computes: the
// arguments of score_eval_fused with the widths in place of the cluster plan,
// and scratch (score_eval_layered_scratch_bytes of device memory, 256-byte
// aligned) in place of the slab.  offsets: any number of segments, each at
// the offset of pack_score_params' layout for these widths.  Returns
// cudaErrorInvalidValue on widths it does not take (make_widths), on another
// layout, or when a launch's blocks pass the int32 grid index.
extern "C" int score_eval_layered(const float* pos, const float* node, const float* edge2d,
                                  const float* mask, const float* params, const int* offsets,
                                  int n_offsets, float* out, void* scratch, int B, int N,
                                  int variant, int num_layers, int num_convs, int hidden,
                                  int heads, int coff_dim, int bf16, void* stream) {
  Widths w;
  if (B < 1 || N < 1 || !make_widths(variant, num_layers, num_convs, hidden, heads, coff_dim, w) ||
      n_offsets != num_segments(w) || scratch == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long packed = 0, image = 0;
  for (int i = 0; i < n_offsets; ++i) {
    seg_offsets(i, w, packed, image);
    if (offsets[i] != packed) return static_cast<int>(cudaErrorInvalidValue);
  }
  seg_offsets(n_offsets, w, packed, image);
  if (image > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  return bf16 ? launch_layered<true>(pos, node, edge2d, mask, params, out, sc, B, N, w, s)
              : launch_layered<false>(pos, node, edge2d, mask, params, out, sc, B, N, w, s);
}
