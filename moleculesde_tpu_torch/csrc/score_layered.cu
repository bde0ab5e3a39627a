// K6's layered plan: one whole 2D->3D score evaluation of SDEModel2Dto3D
// (variants 1 and 2), forward only, at any n_max and any width the TPU kernel
// computes (any hidden width H, 1-8 heads that divide it, a basis width CD of
// at most 64 or a multiple of 64, any modules x GAT layers):
//   pos [B, N, 3], node_attr [B, N, H], edge_attr_2d [B, N, N, H] and the
//   pair mask [B, N, N] (all f32), the packed weights (ops/score_kernel.py::
//   pack_score_params) -> raw score out [B, N, 3] f32.
// The cluster plan (csrc/score_eval.cu) runs the sampler's widths (32, 8,
// 128) at n_max <= 128 in one launch; this plan everything else
// (ops/score_kernel.py::score_plan).  Both replace the Pallas kernel
// moleculesde_tpu/ops/score_kernel.py::_kernel (pallas_call at l.388,
// entry score_eval_fused l.353).
//
// What bounds it on this card: ~95% of the operations are per-pair products
// (the two coefficient embeddings [4H -> H], the projection MLP [2H + 2 ->
// H, H -> H], variant 2's input MLP, each GAT layer's edge projection [H ->
// H], each basis module's edge MLP [H -> CD] and output [CD -> 3]), 107 GFLOP
// at H = 32, n_max 1024, B = 2 (bound 0.108 ms in bf16 on the tensor cores,
// 1.60 ms in f32 on the CUDA cores) against ~0.7 GB of compulsory traffic;
// what is left is per-pair elementwise work (frames, sincos, silu, the
// softmax) and the slab of masked edge features, written once and read by
// every GAT layer and basis module.
//
// Launches: 2 + 2 L C + 2 L (a weight image; the front pass; per GAT layer a
// node pass and a GAT pass; per basis module a node pass and a basis pass).
//   0. layered_weights_kernel: the packed weights into an image laid out for
//      the passes: vectors padded to 32 columns (the basis output's 3 to 4),
//      the node passes' kernels row-major with H rows padded to Hp =
//      round32(H) (rounded to bf16 in bf16 mode), and each per-pair product's
//      kernel as a tile of K rows (each block of H rows padded to Hp) by Cp =
//      round32(columns): in bf16 mode already in mma.sync B-fragment order
//      (uint4 (k-step, pair of n-tiles, lane): one coalesced 16-byte load a
//      lane gives two n-tiles' fragments), in f32 mode in rows whose 32
//      columns are permuted so that a lane's 8 output columns are adjacent.
//   1. layered_front_kernel: frames, the coefficient embeddings, the
//      projection MLP (and variant 2's gate) and the masked edge features of
//      every pair into the slab; the mask as [b][d][s]; the valid sources.
//   2. per GAT layer, layered_node_kernel (q, k, v, skip of every node, a
//      thread per value) and layered_gat_kernel (e2, logits, softmax,
//      message, LayerNorm, FFN).
//   3. per basis module, layered_node_kernel (hp = x @ W_h) and
//      layered_basis_kernel (cc of every pair, the frame basis and the
//      EquiLayer mean into the score row).
//
// Design.
// - Blocks of (molecule, 8 destinations), a warp each, 256 threads; a warp
//   takes its destination's sources in tiles of 32 (chunk j: s = 32 j + r).
// - Per-pair products are warp tile products: M = the tile's 32 pairs, K the
//   input channels (padded to 16 / 32), N an output slice of 32 channels.
//   A lane holds the slice as the mma.sync accumulator layout in both modes
//   (float v[4][8]: rows g + 8 i, columns 8 (q >> 1) + 2 t + (q & 1), g =
//   lane / 4, t = lane % 4), so that the epilogues are one code.
//   * bf16 mode: mma.sync m16n8k16 bf16 -> f32 on the tensor cores.  The A
//     operand of a chained product is made from the previous slice's
//     accumulators in registers (two 32-channel slices' fragments are one
//     k-step's A fragments: no shuffle and no ldmatrix) and kept, where the
//     next product needs a whole row, as the lane's own 16-byte words
//     ([k-step][m-tile][lane]); the Fourier features are computed straight
//     into A fragments (each lane the sincos of its own fragment elements:
//     one sincosf a pair and frequency); B comes from the fragment-ordered
//     image through L1 (the basis pass stages its module's weights in
//     shared memory where they fit), so no width caps shared memory.  The
//     operands are the values the plain version's mm() rounds to bf16, so
//     only the order of the f32 sums changes.
//   * f32 mode: FMAs on the CUDA cores, register-blocked: a lane computes 4
//     pairs x 8 channels, so each weight it loads (two 16-byte loads a row)
//     feeds 4 pairs and each input (one 16-byte load: the 4 pairs' value of
//     channel k, from a [k][32] tile whose pairs are interleaved by 8) feeds 8
//     channels.  Every output's FMA chain runs over its input channels in
//     order, and the Fourier embeddings, projection, gate and epilogues sum
//     their terms in one fixed expression each, the order a lane summing
//     its own pair's row would take, so f32 mode's bits do not depend on
//     the tiling.
// - Intermediate rows stay on the chip: the front pass's embeddings and
//   projection input (bf16: 3 Hp x 64 bytes a warp; f32: 3 Hp x 128) in
//   shared memory while 8 warps' rows fit in kFrontCap, else in the warp's
//   rows of device scratch, written and read back by the same lane; the slab
//   in device memory in the product's A layout (bf16: the lane's fragment
//   words; f32: [k][32] tiles), written once.
// - The GAT pass forms e2 = slab @ W_e once per layer and pair (a tile
//   product): the logits' terms come from the accumulators, and v[s] + e2
//   + b_e goes into the warp's kept rows in device scratch ([j][c][pair]:
//   32 floats a channel, whole sectors, f32 as the plain version keeps
//   them; 128 bytes a pair at hidden 32), which the message reads, with the
//   logits beside them: shared memory never grows with N.  A lane then
//   takes one pair (s = 32 j + lane) as in the cluster plan: its logits are the
//   head sums of the terms round((k + e2) * q), which the lanes form in the
//   accumulator layout right after the product (k read 8 bytes a lane) and
//   pass through a [32][36] shared tile, head by head (each head's channel
//   range resolved once a slice, not a test per channel), the softmax over
//   all sources by an online max and sum, alpha rounded before
//   the channel broadcast, the message with each channel's head offset
//   computed once per 32-channel slice, a reduce-scatter, then LayerNorm
//   and the FFN (node-level, a lane per channel).
// - The basis pass forms the edge MLP as a tile product; in bf16 mode its
//   silu output feeds basis_out (3 columns padded to 8) from the same lane's
//   accumulators, in the TPU kernel's 64-channel chunks; in f32 mode the
//   lane of each pair sums it over the channels in order from a shared tile.
// - Shared memory holds the passes' rows, a basis module's per-pair
//   weights where they fit under kBasisStageCap, and nothing that grows
//   with N; device scratch is score_eval_layered_scratch_bytes.
// - bf16 != 0 rounds where the plain version rounds (its mm() operands, the
//   masked edge features, x and its residuals, q.(k + e) before the head
//   sum, alpha before the channel broadcast, LayerNorm outputs, cc * basis).
//   silu is the accurate expf and division where its output stays f32
//   (and in f32 mode), __expf / __fdividef where it is rounded to bf16
//   next (the projection and the basis edge MLP in bf16 mode, as the
//   cluster plan does); the softmax's exp is the accurate expf.
// - A score row is summed by one warp in a fixed order and nothing is added
//   atomically: two launches give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "score_common.cuh"

constexpr int kPhaseSlots = 8;   // PHASE_MARK marks a block (the GAT pass's phases)

namespace {

using namespace score_common;   // rounding, silu, warp sums, pair frames
using namespace hopper;         // mma.sync

constexpr int kLDests = 8;                    // destinations per block, a warp each
constexpr int kLThreads = 32 * kLDests;
constexpr int kLMaxHeads = 8;                 // the TPU kernel's head selector
constexpr int kLNodeThreads = 256;
constexpr int kKeepLd = 36;                   // floats a channel of a warp's [c][32] tiles in
                                              // shared memory (conflict-free scatter)
constexpr int kStageK = 8;                    // f32 mode: frequencies staged at a time
constexpr int kFrontCap = 200 * 1024;         // bytes: the front pass's rows on the chip
constexpr int kGatCap = 100 * 1024;           // bytes: the GAT pass's FFN rows on the chip (two blocks an SM)

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

// ---- the weight image -------------------------------------------------------
// segment i of the packed layout (ops/score_kernel.py::score_param_layout):
// rows x cols, how the image holds it and, for a per-pair product, its blocks
// of H rows
enum SegKind {
  kSegPlain = 0,     // a vector, padded to 32 (3 to 4)
  kSegFourier = 1,   // coff_W / dist_W: a vector times 2 pi
  kSegNode = 2,      // a node pass's or the FFN's kernel: [Hp][round32(cols)] row-major
  kSegPair = 3,      // a per-pair product's kernel: [blocks Hp][Cp], the mode's tile layout
  kSegProj1 = 4,     // proj1: its two angle rows [2][Hp] f32, then a kSegPair of 2 blocks
  kSegOut = 5        // basis_out [CD, 3]: bf16 fragments [CDp][8], f32 rows [CDp][4]
};

struct Seg {
  int rows, cols, kind, blocks;
};

__host__ __device__ inline int front_segments(int variant) { return variant == 2 ? 10 : 7; }

__host__ __device__ inline int num_segments(const Widths& w) {
  return front_segments(w.variant) + 18 * w.L * w.NC + 5 * w.L;
}

__host__ __device__ inline Seg seg_shape(int i, const Widths& w) {
  const int H = w.H, front = front_segments(w.variant), gat = 18 * w.L * w.NC;
  if (i < front) {
    switch (i) {
      case 0: case 7: return {1, H, kSegFourier, 0};   // coff_W, dist_W
      case 1: return {4 * H, H, kSegPair, 4};          // coff_mlp: [sin c0 | cos c0 | sin c2 | cos c2]
      case 3: return {2 * H + 2, H, kSegProj1, 2};     // proj1: angle rows, two embedding blocks
      case 5: return {H, H, kSegPair, 1};              // proj2
      case 8: return {2 * H, H, kSegPair, 2};          // input_mlp: [sin | cos]
      default: return {1, H, kSegPlain, 0};            // biases
    }
  }
  i -= front;
  if (i < gat) {
    const int r = i % 18;
    if (r == 6) return {H, H, kSegPair, 1};            // lin_edge
    return r < 14 && r % 2 == 0 ? Seg{H, H, kSegNode, 0} : Seg{1, H, kSegPlain, 0};
  }
  switch ((i - gat) % 5) {
    case 0: return {H, w.CD, kSegNode, 0};             // basis_node
    case 1: return {H, w.CD, kSegPair, 1};             // basis_edge
    case 2: return {1, w.CD, kSegPlain, 0};
    case 3: return {w.CD, 3, kSegOut, 0};              // basis_out
    default: return {1, 3, kSegPlain, 0};
  }
}

__host__ __device__ inline int vec_cols(int cols) { return cols == 3 ? 4 : round32(cols); }

// floats of a per-pair product's tile: blocks x Hp rows x Cp columns, two
// bf16 values a float in bf16 mode
__host__ __device__ inline long long pair_floats(int blocks, int cols, const Widths& w, bool bf16) {
  const long long n = static_cast<long long>(blocks) * w.Hp * round32(cols);
  return bf16 ? n / 2 : n;
}

// floats of segment i's image
__host__ __device__ inline long long seg_image_floats(const Seg& s, const Widths& w, bool bf16) {
  switch (s.kind) {
    case kSegNode: return static_cast<long long>(w.Hp) * round32(s.cols);
    case kSegPair: return pair_floats(s.blocks, s.cols, w, bf16);
    case kSegProj1: return 2LL * w.Hp + pair_floats(2, s.cols, w, bf16);
    case kSegOut: return 4LL * w.CDp;
    default: return vec_cols(s.cols);
  }
}

// offsets in floats of segment i in the packed buffer (rounded up to 4 floats
// each, as pack_score_params lays them out) and in the image
__host__ __device__ inline void seg_offsets(int i, const Widths& w, bool bf16, long long& packed,
                                            long long& image) {
  packed = image = 0;
  for (int k = 0; k < i; ++k) {
    const Seg s = seg_shape(k, w);
    packed += (static_cast<long long>(s.rows) * s.cols + 3) / 4 * 4;
    image += seg_image_floats(s, w, bf16);
  }
}

__host__ inline long long image_at(int i, const Widths& w, bool bf16) {
  long long packed, image;
  seg_offsets(i, w, bf16, packed, image);
  return image;
}

// column c of a 32-column group at f32 tile position p: lane t's 8 columns
// (8 (q >> 1) + 2 t + (q & 1), q < 8) sit at 8 t .. 8 t + 7
__host__ __device__ inline int unpermute(int p) {
  const int pp = p & 31, t = pp >> 3, q = pp & 7;
  return (p - pp) + 8 * (q >> 1) + 2 * t + (q & 1);
}

// row r (of blocks x Hp) and column c of a per-pair product's padded kernel:
// the packed value, or 0 in the padding
__device__ __forceinline__ float pair_value(const float* __restrict__ src, int r, int c, int R,
                                            int cols, int Hp) {
  const int block = r / Hp, within = r - block * Hp;
  return within < R && c < cols ? __ldg(src + static_cast<long long>(block * R + within) * cols + c)
                                : 0.f;
}

// element e of a per-pair product's tile in the mode's layout; bf16 mode
// returns the bits of a packed pair as a float
template <bool BF16>
__device__ __forceinline__ float pair_element(const float* __restrict__ src, long long e, int R,
                                              int cols, int Cp, int Hp) {
  if constexpr (BF16) {
    // word e of uint4 (k-step kk, pair of n-tiles np, lane): {b0, b1} of
    // n-tile 2 np, then of 2 np + 1; b0 = rows 16 kk + 2 t, +1 of column
    // 8 nt + g, b1 the same 8 rows on
    const long long u = e >> 2;
    const int wd = static_cast<int>(e & 3), lane = static_cast<int>(u & 31);
    const long long rest = u >> 5;
    const int NP = Cp / 16, np = static_cast<int>(rest % NP), kk = static_cast<int>(rest / NP);
    const int t = lane & 3, g = lane >> 2, nt = 2 * np + (wd >> 1);
    const int k = 16 * kk + 2 * t + 8 * (wd & 1), n = 8 * nt + g;
    const uint32_t bits =
        pack_bf16x2(pair_value(src, k, n, R, cols, Hp), pair_value(src, k + 1, n, R, cols, Hp));
    return __uint_as_float(bits);
  } else {
    const int r = static_cast<int>(e / Cp), p = static_cast<int>(e - static_cast<long long>(r) * Cp);
    return pair_value(src, r, unpermute(p), R, cols, Hp);
  }
}

// Launch 0: every segment into the image (blockIdx.y: the segment).
template <bool BF16>
__global__ void __launch_bounds__(256)
layered_weights_kernel(const float* __restrict__ params, float* __restrict__ image,
                       const Widths w) {
  const int i = blockIdx.y;
  const Seg s = seg_shape(i, w);
  long long src, dst;
  seg_offsets(i, w, BF16, src, dst);
  const float two_pi = static_cast<float>(2.0 * 3.14159265358979323846);
  const long long n = seg_image_floats(s, w, BF16);
  const float* ps = params + src;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n; e += 256LL * gridDim.x) {
    float v;
    switch (s.kind) {
      case kSegNode: {
        const int ic = round32(s.cols), r = static_cast<int>(e / ic);
        const int c = static_cast<int>(e - static_cast<long long>(r) * ic);
        v = r < s.rows && c < s.cols ? __ldg(ps + static_cast<long long>(r) * s.cols + c) : 0.f;
        if (BF16) v = rbf(v);
        break;
      }
      case kSegPair:
        v = pair_element<BF16>(ps, e, w.H, s.cols, round32(s.cols), w.Hp);
        break;
      case kSegProj1:
        if (e < 2LL * w.Hp) {   // the angle rows: elementwise, f32
          const int r = static_cast<int>(e / w.Hp), c = static_cast<int>(e - r * w.Hp);
          v = c < w.H ? __ldg(ps + r * w.H + c) : 0.f;
        } else {
          v = pair_element<BF16>(ps + 2 * w.H, e - 2LL * w.Hp, w.H, s.cols, w.Hp, w.Hp);
        }
        break;
      case kSegOut: {
        int r, c;
        if (BF16) {   // uint2 (k-step, lane): b0, b1 of the one n-tile
          const int u = static_cast<int>(e >> 1), lane = u & 31, kk = u >> 5;
          const int t = lane & 3, g = lane >> 2;
          r = 16 * kk + 2 * t + 8 * static_cast<int>(e & 1);
          c = g;
          const float lo = r < s.rows && c < 3 ? __ldg(ps + r * 3 + c) : 0.f;
          const float hi = r + 1 < s.rows && c < 3 ? __ldg(ps + (r + 1) * 3 + c) : 0.f;
          v = __uint_as_float(pack_bf16x2(lo, hi));
        } else {
          r = static_cast<int>(e >> 2);
          c = static_cast<int>(e & 3);
          v = r < s.rows && c < 3 ? __ldg(ps + r * 3 + c) : 0.f;
        }
        break;
      }
      default: {
        const int c = static_cast<int>(e);
        v = c < s.cols ? __ldg(ps + c) : 0.f;
        if (s.kind == kSegFourier) v = v * two_pi;
        break;
      }
    }
    image[dst + e] = v;
  }
}

// ---- device scratch and shared memory --------------------------------------
// byte offsets of the layered plan's device scratch, each region 256-byte
// aligned; ops/score_kernel.py::score_scratch_bytes counts the same
struct LayeredScratch {
  size_t slab, mask, cnt, node, xa, xb, image, rows, keep, ffn, total;
};

// bytes of a warp's front-pass rows: the two embeddings and the projection's
// silu output, Hp channels x 32 pairs each (bf16 fragments / f32)
__host__ __device__ inline int front_rows_bytes(const Widths& w, bool bf16) {
  return 3 * w.Hp * (bf16 ? 64 : 128);
}

__host__ __device__ inline bool front_on_chip(const Widths& w, bool bf16) {
  return kLDests * front_rows_bytes(w, bf16) <= kFrontCap;
}

// floats of a GAT warp's shared memory: a [32 columns][kKeepLd] tile of the
// logits' terms, a chunk's softmax weights [head][32], then the FFN input,
// hidden and output rows (Hp each) where 8 warps' rows fit under kGatCap,
// else those three rows in device scratch
constexpr int kTileFloats = 32 * kKeepLd;
__host__ __device__ inline bool ffn_rows_on_chip(const Widths& w) {
  return 4 * kLDests * (kTileFloats + kLMaxHeads * 32 + 3 * w.Hp) <= kGatCap;
}

__host__ __device__ inline int gat_warp_floats(const Widths& w) {
  return kTileFloats + kLMaxHeads * 32 + (ffn_rows_on_chip(w) ? 3 * w.Hp : 0);
}

// floats of a GAT warp's kept rows in device scratch at S chunks: v[s] + e2
// + b_e [S][Hp][32], the logits [S][heads][32]
__host__ __device__ inline long long keep_floats(const Widths& w, long long S) {
  return S * (static_cast<long long>(w.Hp) * 32 + w.heads * 32);
}

// the basis pass's [32 columns][kKeepLd] tile a warp
constexpr int kBasisTileFloats = 32 * kKeepLd;

__host__ inline int front_smem(const Widths& w, bool bf16) {
  return front_on_chip(w, bf16) ? kLDests * front_rows_bytes(w, bf16) : 0;
}

__host__ inline int gat_smem(const Widths& w) {
  return 4 * kLDests * gat_warp_floats(w);
}

constexpr int kBasisSmem = 4 * kLDests * kBasisTileFloats;

// a basis module's per-pair weights (basis_edge's tile, its bias, basis_out
// and its bias: image segments seg + 1 .. seg + 4, contiguous), staged in the
// basis pass's shared memory beside the tiles where they fit under
// kBasisStageCap (two blocks an SM), else read from the image
constexpr int kBasisStageCap = 72 * 1024;
__host__ __device__ inline long long basis_weight_floats(const Widths& w, bool bf16) {
  return pair_floats(1, w.CD, w, bf16) + w.CDp + 4LL * w.CDp + 4;
}

__host__ __device__ inline bool basis_staged(const Widths& w, bool bf16) {
  return 4 * basis_weight_floats(w, bf16) <= kBasisStageCap;
}

__host__ inline int basis_smem(const Widths& w, bool bf16) {
  return kBasisSmem + (basis_staged(w, bf16) ? 4 * static_cast<int>(basis_weight_floats(w, bf16)) : 0);
}

// dynamic shared memory of the layered plan's largest pass block
__host__ inline int layered_smem(const Widths& w, bool bf16) {
  int bytes = front_smem(w, bf16);
  if (w.L * w.NC > 0 && gat_smem(w) > bytes) bytes = gat_smem(w);
  if (w.L > 0 && basis_smem(w, bf16) > bytes) bytes = basis_smem(w, bf16);
  return bytes;
}

__host__ inline LayeredScratch layered_scratch(long long B, long long N, bool bf16,
                                               const Widths& w) {
  auto al = [](size_t v) { return (v + 255) & ~static_cast<size_t>(255); };
  const size_t b = static_cast<size_t>(B), n = static_cast<size_t>(N), S = (n + 31) / 32;
  long long packed = 0, image = 0;
  seg_offsets(num_segments(w), w, bf16, packed, image);
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
  if (!front_on_chip(w, bf16)) o += al(warps * front_rows_bytes(w, bf16));
  L.keep = o;
  o += al(warps * static_cast<size_t>(keep_floats(w, static_cast<long long>(S))) * 4);
  L.ffn = o;
  if (!ffn_rows_on_chip(w)) o += al(warps * 3 * static_cast<size_t>(w.Hp) * 4);
  L.total = o;
  return L;
}

// ---- warp tile products ------------------------------------------------------
// A warp's tile: 32 pairs x 32 channels, lane (g, t) holding v[i][q] = row
// g + 8 i, column tile_col(q, t) (the mma.sync accumulator layout).

__device__ __forceinline__ int tile_col(int q, int t) { return 8 * (q >> 1) + 2 * t + (q & 1); }

__device__ __forceinline__ void zero_tile(float (&v)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) v[i][q] = 0.f;
}

// bytes of device memory from p on their way to L2 (one prefetch a lane
// for each 128-byte line), so that a loop's next iteration finds them there
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  for (int o = (threadIdx.x & 31) * 128; o < bytes; o += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(static_cast<const char*>(p) + o));
}

// bf16: v += A @ B for one k-step: a[mt] the A fragments of rows 16 mt ..,
// bl / bh the B fragments of n-tiles 0, 1 / 2, 3 (uint4 {b0, b1, b0, b1})
__device__ __forceinline__ void mma_kstep(float (&v)[4][8], const uint32_t (&a)[2][4],
                                          const uint4& bl, const uint4& bh) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const uint4 bb = nt < 2 ? bl : bh;
    const uint32_t b[2] = {nt & 1 ? bb.z : bb.x, nt & 1 ? bb.w : bb.y};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float c[4] = {v[2 * mt][2 * nt], v[2 * mt][2 * nt + 1], v[2 * mt + 1][2 * nt],
                    v[2 * mt + 1][2 * nt + 1]};
      mma_bf16(c, a[mt], b);
      v[2 * mt][2 * nt] = c[0];
      v[2 * mt][2 * nt + 1] = c[1];
      v[2 * mt + 1][2 * nt] = c[2];
      v[2 * mt + 1][2 * nt + 1] = c[3];
    }
  }
}

// bf16: the A fragments (rounded) of k-step kk (0, 1) of a tile: its columns
// 16 kk .. 16 kk + 15 as the input channels of the next product
__device__ __forceinline__ void tile_frags(const float (&v)[4][8], int kk, uint32_t (&a)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    a[mt][0] = pack_bf16x2(v[2 * mt][4 * kk], v[2 * mt][4 * kk + 1]);
    a[mt][1] = pack_bf16x2(v[2 * mt + 1][4 * kk], v[2 * mt + 1][4 * kk + 1]);
    a[mt][2] = pack_bf16x2(v[2 * mt][4 * kk + 2], v[2 * mt][4 * kk + 3]);
    a[mt][3] = pack_bf16x2(v[2 * mt + 1][4 * kk + 2], v[2 * mt + 1][4 * kk + 3]);
  }
}

// bf16: a tile into the lane's fragment words from k-step ks0 ([k-step][m-tile][lane])
template <bool CG>
__device__ __forceinline__ void store_frags(uint4* words, int ks0, const float (&v)[4][8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t a[2][4];
    tile_frags(v, kk, a);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint4 u = make_uint4(a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
      uint4* p = words + ((ks0 + kk) * 2 + mt) * 32 + lane;
      if (CG)
        __stcg(p, u);
      else
        *p = u;
    }
  }
}

// bf16: v += A @ B over ksteps k-steps, A the lane's fragment words, B the
// fragment-ordered tile at the slice's first pair of n-tiles (NP pairs a
// k-step)
__device__ __forceinline__ void mma_words(float (&v)[4][8], const uint4* A, int ksteps,
                                          const uint4* __restrict__ B, int NP) {
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint4 a0 = A[(2 * kk) * 32 + lane], a1 = A[(2 * kk + 1) * 32 + lane];
    const uint4 bl = B[(kk * NP) * 32 + lane], bh = B[(kk * NP + 1) * 32 + lane];
    const uint32_t a[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
    mma_kstep(v, a, bl, bh);
  }
}

// f32: v[i][q] = fma(A[k][row i], W[k][col q], v[i][q]) for k < K in order; A
// a [k][32] tile (pair r at (r % 8) * 4 + r / 8), W the permuted tile at the
// slice's first column (row stride ldw)
__device__ __forceinline__ void fma_rows(float (&v)[4][8], const float* At, int K,
                                         const float* __restrict__ W, int ldw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * 32 + 4 * g);
    const float4 w0 = *reinterpret_cast<const float4*>(W + static_cast<size_t>(k) * ldw + 8 * t);
    const float4 w1 = *reinterpret_cast<const float4*>(W + static_cast<size_t>(k) * ldw + 8 * t + 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) v[i][q] = fmaf(av[i], wv[q], v[i][q]);
  }
}

// f32: a tile into a [k][32] tile from channel o
template <bool CG>
__device__ __forceinline__ void store_rows_f32(float* At, int o, const float (&v)[4][8]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float4* p = reinterpret_cast<float4*>(At + (o + tile_col(q, t)) * 32 + 4 * g);
    const float4 u = make_float4(v[0][q], v[1][q], v[2][q], v[3][q]);
    if (CG)
      __stcg(p, u);
    else
      *p = u;
  }
}

// the tile scattered into [c][kKeepLd] rows from channel row c0 (pair r at r)
__device__ __forceinline__ void scatter_tile(float* rows, int c0, const float (&v)[4][8]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) rows[(c0 + tile_col(q, t)) * kKeepLd + g + 8 * i] = v[i][q];
}

// the tile product of the slab unit (32 pairs x Hp channels, the mode's A
// layout) with columns o .. o + 31 of a per-pair kernel of Cp columns
template <bool BF16>
__device__ __forceinline__ void slab_product(float (&v)[4][8], const void* unit,
                                             const float* __restrict__ Wimg, int o, int Cp,
                                             const Widths& w) {
  zero_tile(v);
  if constexpr (BF16)
    mma_words(v, static_cast<const uint4*>(unit), w.Hp / 16,
              reinterpret_cast<const uint4*>(Wimg) + (o / 16) * 32, Cp / 16);
  else
    fma_rows(v, static_cast<const float*>(unit), w.Hp, Wimg + o, Cp);
}

// this (molecule, destination, chunk)'s slab unit: 32 pairs x Hp values
template <bool BF16>
__device__ __forceinline__ size_t slab_unit(int b, int N, int S, int d, int j, int Hp) {
  return ((static_cast<size_t>(b) * N + d) * S + j) * 32 * Hp * (BF16 ? 2 : 4);
}

// ---- launch 1: the front pass -----------------------------------------------

// the image offsets a pass reads, in floats
struct FrontW {
  long long wc, cm, bm, p1, b1, p2, b2, dw, in, bi;
};

// bf16: v += the Fourier embedding's products for one coefficient: the A
// fragments of [sin, cos](c_row * w[k]) straight from sincosf (rows g + 8 i
// take c[i]), against kernel blocks blk (sin) and blk + 1 (cos)
__device__ __forceinline__ void fourier_mma(float (&v)[4][8], const float (&c)[4],
                                            const float* __restrict__ wrow,
                                            const uint4* __restrict__ B, int blk, int NP,
                                            int Hp) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ks = Hp / 16;
#pragma unroll 1
  for (int kk = 0; kk < ks; ++kk) {
    const int k0 = 16 * kk + 2 * t;
    const float wk[4] = {__ldg(wrow + k0), __ldg(wrow + k0 + 1), __ldg(wrow + k0 + 8),
                         __ldg(wrow + k0 + 9)};
    uint32_t as[2][4], ac[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float sn[2][4], cs[2][4];   // [row h][column]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 4; ++x) sincosf(c[2 * mt + h] * wk[x], &sn[h][x], &cs[h][x]);
      as[mt][0] = pack_bf16x2(sn[0][0], sn[0][1]);
      as[mt][1] = pack_bf16x2(sn[1][0], sn[1][1]);
      as[mt][2] = pack_bf16x2(sn[0][2], sn[0][3]);
      as[mt][3] = pack_bf16x2(sn[1][2], sn[1][3]);
      ac[mt][0] = pack_bf16x2(cs[0][0], cs[0][1]);
      ac[mt][1] = pack_bf16x2(cs[1][0], cs[1][1]);
      ac[mt][2] = pack_bf16x2(cs[0][2], cs[0][3]);
      ac[mt][3] = pack_bf16x2(cs[1][2], cs[1][3]);
    }
    const uint4* bs = B + ((blk * ks + kk) * NP) * 32 + lane;
    const uint4* bc = B + (((blk + 1) * ks + kk) * NP) * 32 + lane;
    mma_kstep(v, as, __ldg(bs), __ldg(bs + 32));
    mma_kstep(v, ac, __ldg(bc), __ldg(bc + 32));
  }
}

// f32: v[i][q] += the embedding of one coefficient pair over its H
// frequencies, each frequency's four terms in one expression; the pair's
// lane stages the Fourier features of kStageK frequencies at a time into stg
__device__ __forceinline__ void fourier_fma(float (&v)[4][8], float c0, float c2,
                                            const float* __restrict__ wrow,
                                            const float* __restrict__ W, int o, const Widths& w,
                                            float* stg) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int slot = (lane & 7) * 4 + (lane >> 3);
  const int H = w.H, Hp = w.Hp;
#pragma unroll 1
  for (int k0 = 0; k0 < H; k0 += kStageK) {
    const int nk = min(kStageK, H - k0);
    for (int kk = 0; kk < nk; ++kk) {
      const float wk = __ldg(wrow + k0 + kk);
      float s0, k0v, s2, k2;
      sincosf(c0 * wk, &s0, &k0v);
      sincosf(c2 * wk, &s2, &k2);
      stg[(0 * kStageK + kk) * 32 + slot] = s0;
      stg[(1 * kStageK + kk) * 32 + slot] = k0v;
      stg[(2 * kStageK + kk) * 32 + slot] = s2;
      stg[(3 * kStageK + kk) * 32 + slot] = k2;
    }
    __syncwarp();
#pragma unroll 1
    for (int kk = 0; kk < nk; ++kk) {
      float f[4][4];   // [term][row i]
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 a = *reinterpret_cast<const float4*>(stg + (x * kStageK + kk) * 32 + 4 * g);
        f[x][0] = a.x;
        f[x][1] = a.y;
        f[x][2] = a.z;
        f[x][3] = a.w;
      }
      float wv[4][8];  // [block][column q]
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float* wr = W + static_cast<size_t>(x * Hp + k0 + kk) * Hp + o + 8 * t;
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wr));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wr + 4));
        wv[x][0] = w0.x; wv[x][1] = w0.y; wv[x][2] = w0.z; wv[x][3] = w0.w;
        wv[x][4] = w1.x; wv[x][5] = w1.y; wv[x][6] = w1.z; wv[x][7] = w1.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[i][q] += f[0][i] * wv[0][q] + f[1][i] * wv[1][q] + f[2][i] * wv[2][q] +
                     f[3][i] * wv[3][q];
    }
    __syncwarp();
  }
}

// f32: the gate's products over the H distance frequencies (sin and cos
// blocks), each frequency's two terms in one expression
__device__ __forceinline__ void gate_fma(float (&v)[4][8], float dist,
                                         const float* __restrict__ wrow,
                                         const float* __restrict__ W, int o, const Widths& w,
                                         float* stg) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int slot = (lane & 7) * 4 + (lane >> 3);
  const int H = w.H, Hp = w.Hp;
#pragma unroll 1
  for (int k0 = 0; k0 < H; k0 += kStageK) {
    const int nk = min(kStageK, H - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float sn, cs;
      sincosf(dist * __ldg(wrow + k0 + kk), &sn, &cs);
      stg[(0 * kStageK + kk) * 32 + slot] = sn;
      stg[(1 * kStageK + kk) * 32 + slot] = cs;
    }
    __syncwarp();
#pragma unroll 1
    for (int kk = 0; kk < nk; ++kk) {
      const float4 sa = *reinterpret_cast<const float4*>(stg + kk * 32 + 4 * g);
      const float4 ca = *reinterpret_cast<const float4*>(stg + (kStageK + kk) * 32 + 4 * g);
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w}, cv[4] = {ca.x, ca.y, ca.z, ca.w};
      const float* ra = W + static_cast<size_t>(k0 + kk) * Hp + o + 8 * t;
      const float* rb = W + static_cast<size_t>(Hp + k0 + kk) * Hp + o + 8 * t;
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(ra));
      const float4 a1 = __ldg(reinterpret_cast<const float4*>(ra + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(rb));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(rb + 4));
      const float qa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float qb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) v[i][q] += sv[i] * qa[q] + cv[i] * qb[q];
    }
    __syncwarp();
  }
}

// Launch 1: the masked edge features of the block's destinations and every
// source into the slab, the mask as maskT[b][d][s], and cnt[b][d] = max(1,
// valid sources).  rows: device rows where the front rows are not on the chip.
template <bool BF16>
__global__ void __launch_bounds__(kLThreads, 2)
layered_front_kernel(const float* __restrict__ pos, const float* __restrict__ edge2d,
                     const float* __restrict__ mask, const float* __restrict__ image,
                     const FrontW fw, void* __restrict__ slab, float* __restrict__ maskT,
                     float* __restrict__ cnt, unsigned char* __restrict__ rows_g, int N, int S,
                     int dtiles, const Widths w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / dtiles, d = (blockIdx.x - b * dtiles) * kLDests + warp;
  if (d >= N) return;
  const int H = w.H, Hp = w.Hp, RB = front_rows_bytes(w, BF16);
  unsigned char* rows = rows_g ? rows_g + (static_cast<size_t>(blockIdx.x) * kLDests + warp) * RB
                               : smem + warp * RB;
  const size_t dn = static_cast<size_t>(b) * N + d;
  const float pd[3] = {pos[dn * 3], pos[dn * 3 + 1], pos[dn * 3 + 2]};
  const float* wc = image + fw.wc;
  const float* p1a = image + fw.p1;         // proj1's angle rows
  const float* p1b = p1a + Hp;
  const float* p1w = p1a + 2 * Hp;          // its two embedding blocks
  float count = 0.f;
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    __syncwarp();   // the warp converged for its tile products
    const int s = 32 * j + lane;
    const bool real = s < N;
    const size_t sn = static_cast<size_t>(b) * N + (real ? s : 0);
    const float m = real ? mask[sn * N + d] : 0.f;
    count += warp_sum(m);
    if (real) maskT[dn * N + s] = m;
    const float ps[3] = {real ? pos[sn * 3] : 0.f, real ? pos[sn * 3 + 1] : 0.f,
                         real ? pos[sn * 3 + 2] : 0.f};
    float cs[3], cd[3], psin, pcos;
    pair_geometry(ps, pd, cs, cd, psin, pcos);
    const float dist = norm3(ps[0] - pd[0], ps[1] - pd[1], ps[2] - pd[2]);
    // the values of the lane's tile rows g + 8 i
    float rm[4], rpsin[4], rpcos[4], rdist[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * i;
      rm[i] = __shfl_sync(kFull, m, r);
      rpsin[i] = __shfl_sync(kFull, psin, r);
      rpcos[i] = __shfl_sync(kFull, pcos, r);
      rdist[i] = __shfl_sync(kFull, dist, r);
    }
    char* unit = static_cast<char*>(slab) + slab_unit<BF16>(b, N, S, d, j, Hp);
    // the epilogue of frame_inv slice o (acc, without its bias), with
    // variant 2's gate, the 2D edge features and the mask, into the slab
    auto edge_tile = [&](int o, float (&acc)[4][8], const float (&gate)[4][8]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 32 * j + g + 8 * i;
        const float* e2d = edge2d + ((static_cast<size_t>(b) * N + (r < N ? r : 0)) * N + d) * H;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = o + tile_col(q, t);
          const float ev = r < N && c < H ? __ldg(e2d + c) : 0.f;
          const float b2 = __ldg(image + fw.b2 + c);
          const float v = w.variant == 2
                              ? (gate[i][q] + __ldg(image + fw.bi + c)) * ev + (acc[i][q] + b2)
                              : ev + (acc[i][q] + b2);
          acc[i][q] = v * rm[i];
        }
      }
    };
    float v[4][8], gt[4][8];
    if constexpr (BF16) {
      uint4* embS = reinterpret_cast<uint4*>(rows);
      uint4* embD = embS + Hp * 4;     // Hp / 16 k-steps x 2 m-tiles x 32 lanes
      uint4* pre = embD + Hp * 4;
      const uint4* cm = reinterpret_cast<const uint4*>(image + fw.cm);
      const int NP = Hp / 16;
#pragma unroll 1
      for (int side = 0; side < 2; ++side) {
        const float c0 = side ? cd[0] : cs[0], c2 = side ? cd[2] : cs[2];
        float r0[4], r2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r0[i] = __shfl_sync(kFull, c0, g + 8 * i);
          r2[i] = __shfl_sync(kFull, c2, g + 8 * i);
        }
#pragma unroll 1
        for (int o = 0; o < Hp; o += 32) {
          zero_tile(v);
          fourier_mma(v, r0, wc, cm + (o / 16) * 32, 0, NP, Hp);
          fourier_mma(v, r2, wc, cm + (o / 16) * 32, 2, NP, Hp);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float bm = __ldg(image + fw.bm + o + tile_col(q, t));
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i][q] += bm;
          }
          store_frags<false>(side ? embD : embS, o / 16, v);
        }
      }
      const uint4* w1 = reinterpret_cast<const uint4*>(p1w);
#pragma unroll 1
      for (int o = 0; o < Hp; o += 32) {
        zero_tile(v);
        mma_words(v, embS, Hp / 16, w1 + (o / 16) * 32, NP);
        mma_words(v, embD, Hp / 16, w1 + ((Hp / 16) * NP + o / 16) * 32, NP);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = o + tile_col(q, t);
          const float pa = __ldg(p1a + c), pb = __ldg(p1b + c), b1 = __ldg(image + fw.b1 + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i][q] += rpsin[i] * pa + rpcos[i] * pb + b1;
            v[i][q] = silu<true>(v[i][q]);   // rounded to bf16 next
          }
        }
        store_frags<false>(pre, o / 16, v);
      }
      const uint4* w2 = reinterpret_cast<const uint4*>(image + fw.p2);
      const uint4* win = reinterpret_cast<const uint4*>(image + fw.in);
#pragma unroll 1
      for (int o = 0; o < Hp; o += 32) {
        zero_tile(v);
        mma_words(v, pre, Hp / 16, w2 + (o / 16) * 32, NP);
        zero_tile(gt);
        if (w.variant == 2) {
          const float* wd = image + fw.dw;
          const uint4* bi = win + (o / 16) * 32;
          const int ks = Hp / 16;
#pragma unroll 1
          for (int kk = 0; kk < ks; ++kk) {   // the gate: one coefficient, blocks sin / cos
            const int k0 = 16 * kk + 2 * t;
            const float wk[4] = {__ldg(wd + k0), __ldg(wd + k0 + 1), __ldg(wd + k0 + 8),
                                 __ldg(wd + k0 + 9)};
            uint32_t as[2][4], ac[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              float sn[2][4], cn[2][4];
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int x = 0; x < 4; ++x) sincosf(rdist[2 * mt + h] * wk[x], &sn[h][x], &cn[h][x]);
              as[mt][0] = pack_bf16x2(sn[0][0], sn[0][1]);
              as[mt][1] = pack_bf16x2(sn[1][0], sn[1][1]);
              as[mt][2] = pack_bf16x2(sn[0][2], sn[0][3]);
              as[mt][3] = pack_bf16x2(sn[1][2], sn[1][3]);
              ac[mt][0] = pack_bf16x2(cn[0][0], cn[0][1]);
              ac[mt][1] = pack_bf16x2(cn[1][0], cn[1][1]);
              ac[mt][2] = pack_bf16x2(cn[0][2], cn[0][3]);
              ac[mt][3] = pack_bf16x2(cn[1][2], cn[1][3]);
            }
            const uint4* bs = bi + (kk * NP) * 32 + lane;
            const uint4* bc = bi + ((ks + kk) * NP) * 32 + lane;
            mma_kstep(gt, as, __ldg(bs), __ldg(bs + 32));
            mma_kstep(gt, ac, __ldg(bc), __ldg(bc + 32));
          }
        }
        edge_tile(o, v, gt);
        store_frags<true>(reinterpret_cast<uint4*>(unit), o / 16, v);
      }
    } else {
      float* embS = reinterpret_cast<float*>(rows);
      float* embD = embS + Hp * 32;
      float* pre = embD + Hp * 32;
      const float* cm = image + fw.cm;
#pragma unroll 1
      for (int side = 0; side < 2; ++side) {
        const float c0 = side ? cd[0] : cs[0], c2 = side ? cd[2] : cs[2];
#pragma unroll 1
        for (int o = 0; o < Hp; o += 32) {
          zero_tile(v);
          fourier_fma(v, c0, c2, wc, cm, o, w, pre);   // staged where pre goes later
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float bm = __ldg(image + fw.bm + o + tile_col(q, t));
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i][q] += bm;
          }
          store_rows_f32<false>(side ? embD : embS, o, v);
        }
      }
      __syncwarp();
      const float* w1 = p1w;
#pragma unroll 1
      for (int o = 0; o < Hp; o += 32) {
        zero_tile(v);
        fma_rows(v, embS, Hp, w1 + o, Hp);
        fma_rows(v, embD, Hp, w1 + static_cast<size_t>(Hp) * Hp + o, Hp);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = o + tile_col(q, t);
          const float pa = __ldg(p1a + c), pb = __ldg(p1b + c), b1 = __ldg(image + fw.b1 + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i][q] += rpsin[i] * pa + rpcos[i] * pb + b1;
            v[i][q] = silu<false>(v[i][q]);
          }
        }
        store_rows_f32<false>(pre, o, v);
      }
      __syncwarp();
#pragma unroll 1
      for (int o = 0; o < Hp; o += 32) {
        zero_tile(v);
        fma_rows(v, pre, Hp, image + fw.p2 + o, Hp);
        zero_tile(gt);
        if (w.variant == 2)
          gate_fma(gt, dist, image + fw.dw, image + fw.in, o, w, embS);   // embS is free now
        edge_tile(o, v, gt);
        store_rows_f32<true>(reinterpret_cast<float*>(unit), o, v);
      }
      __syncwarp();   // the rows are staged into again by the next chunk
    }
  }
  if (lane == 0) cnt[dn] = fmaxf(count, 1.f);
}

// ---- the node pass ---------------------------------------------------------------

struct NodeW {
  long long w[4], b[4];   // up to four [H, cols] kernels side by side; b < 0: no bias
};

// out[row][m cols + c] = sum_k x[row][k] W_m[k][c] (+ b_m[c]) for every node
// row (B N of them, row stride NR; x rows of H), a thread per value, one FMA
// chain over k in order; the image's node kernels are rounded in bf16 mode,
// x is rounded here (already so past layer 0)
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

// ---- launch per GAT layer: the GAT pass --------------------------------------------

struct GatW {
  long long we, be, wf1, bf1, wf2, bf2, s1, o1, s2, o2;
};

// One DenseGAT layer of the block's destinations (a warp each): node row [q |
// k | v | skip] (offsets 0, Hp, 2 Hp, 3 Hp) from layered_node_kernel, x in,
// the new x out.  keep_g: the warps' kept rows; ffn_g: their FFN rows where
// those are not on the chip.
template <bool BF16>
__global__ void __launch_bounds__(kLThreads, 2)
layered_gat_kernel(const void* __restrict__ slab, const float* __restrict__ maskT,
                   const float* __restrict__ nodeq, const float* __restrict__ xin,
                   float* __restrict__ xout, const float* __restrict__ image, const GatW gw,
                   float* __restrict__ keep_g, float* __restrict__ ffn_g, int N, int S,
                   int dtiles, int silu_out, const Widths w) {
  extern __shared__ __align__(16) float gsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / dtiles, d = (blockIdx.x - b * dtiles) * kLDests + warp;
  if (d >= N) return;
  PHASE_MARK(0);
  const int H = w.H, Hp = w.Hp, NR = w.NR, heads = w.heads;
  const size_t wi = static_cast<size_t>(blockIdx.x) * kLDests + warp;   // the warp's scratch rows
  float* ts = gsm + static_cast<size_t>(warp) * gat_warp_floats(w);   // [32][kKeepLd]
  float* as = ts + kTileFloats;   // a chunk's softmax weights [head][32]
  float* f = ffn_g ? ffn_g + wi * 3 * Hp : as + kLMaxHeads * 32;   // the FFN's input row
  float* gh = f + Hp;      // its hidden row
  float* own = gh + Hp;    // its output row
  float* e2k = keep_g + wi * keep_floats(w, S);   // [S][Hp][32]
  float* lg = e2k + static_cast<size_t>(S) * Hp * 32;  // [S][heads][32]
  const float* we = image + gw.we;
  const float* be = image + gw.be;
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
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    __syncwarp();   // the warp converged for its tile products
    // e2 of the chunk's 32 pairs, once: a tile product a slice, kept for the
    // message; the logits' terms round((k[s] + (e2 + b_e)) * q[d]) from the
    // same accumulators, summed head by head by the pair's lane (the sum
    // over the head's channels in order, across slices)
    const char* unit = static_cast<const char*>(slab) + slab_unit<BF16>(b, N, S, d, j, Hp);
    if (j + 1 < S)   // the next chunk's slab unit on its way to L2
      prefetch_l2(unit + slab_unit<BF16>(0, N, S, 0, 1, Hp), 32 * Hp * (BF16 ? 2 : 4));
    float* kj = e2k + static_cast<size_t>(j) * Hp * 32;
    float cur[kLMaxHeads];
#pragma unroll
    for (int hh = 0; hh < kLMaxHeads; ++hh) cur[hh] = 0.f;
#pragma unroll 1
    for (int o = 0; o < Hp; o += 32) {
      float v[4][8];
      slab_product<BF16>(v, unit, we, o, Hp, w);
      float bq[8], qq[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        bq[q] = __ldg(be + o + tile_col(q, t));
        qq[q] = __ldg(qd + o + tile_col(q, t));
      }
      // e = e2 + b_e of pair (s, d) channel c: the term round((k[s] + e) *
      // q[d]) into the tile, v[s] + e into the kept rows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 32 * j + g + 8 * i, row = g + 8 * i;
        const float* kr = nodeq + (static_cast<size_t>(b) * N + (r < N ? r : 0)) * NR + Hp + o;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 k2 = __ldg(reinterpret_cast<const float2*>(kr + 8 * nt + 2 * t));
          const float2 v2 = __ldg(reinterpret_cast<const float2*>(kr + Hp + 8 * nt + 2 * t));
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int q = 2 * nt + x, col = tile_col(q, t);
            const float e = v[i][q] + bq[q];
            kj[(o + col) * 32 + row] = (x ? v2.y : v2.x) + e;
            ts[col * kKeepLd + row] = rnd<BF16>(__fmul_rn((x ? k2.y : k2.x) + e, qq[q]));
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int hh = 0; hh < kLMaxHeads; ++hh) {
        if (hh >= heads) break;
        const int lo = max(hh * w.chead, o), hi = min((hh + 1) * w.chead, o + 32);
        for (int c = lo; c < hi; ++c) cur[hh] += ts[(c - o) * kKeepLd + lane];
      }
      __syncwarp();
    }
    const int s = 32 * j + lane;
    if (s >= N) continue;   // no tile product follows in this chunk
    // the logits of the lane's pair (s, d): the head sums times 1 /
    // sqrt(chead), the float minimum where the pair is masked (the plain
    // version's fill)
    const float m = mrow[s];
#pragma unroll
    for (int hh = 0; hh < kLMaxHeads; ++hh) {
      if (hh >= heads) break;
      const float lh = m > 0.f ? cur[hh] * w.scale : -3.402823466e38f;
      lg[32 * (j * heads + hh) + lane] = lh;
      if (lh > mx[hh]) {
        sm[hh] = sm[hh] * expf(mx[hh] - lh) + 1.f;
        mx[hh] = lh;
      } else {
        sm[hh] += expf(lh - mx[hh]);
      }
    }
  }
  PHASE_MARK(1);
#pragma unroll
  for (int hh = 0; hh < kLMaxHeads; ++hh) {
    if (hh >= heads) break;
    const float top = warp_max(mx[hh]);
    const float part = sm[hh] > 0.f ? sm[hh] * expf(mx[hh] - top) : 0.f;
    sm[hh] = fmaxf(warp_sum(part), 1e-30f);
    mx[hh] = top;
  }
  PHASE_MARK(2);
  // the message, slice by slice: alpha (v[s] + e2) summed over this lane's
  // chunks in order, then over the lanes; lane l keeps channel o + l of each
  // slice o from here on, its mha in the warp's FFN input row.  A chunk's
  // softmax weights (rounded before the channel broadcast) are formed from
  // its logits as the message needs them, into the lane's column of as.
  const float* s1 = image + gw.s1;
  const float* o1 = image + gw.o1;
  const float* s2 = image + gw.s2;
  const float* o2 = image + gw.o2;
  float loc = 0.f;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    float msg[32];
    int hoff[32];   // channel o + c's softmax weight: lg + 32 head(o + c)
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      msg[c] = 0.f;
      hoff[c] = o + c < H ? (o + c) / w.chead * 32 : 0;
    }
#pragma unroll 1
    for (int j = 0; j < S; ++j) {
      const float* ej = e2k + (static_cast<size_t>(j) * Hp + o) * 32 + lane;
      if (j + 1 < S) {   // the next chunk's kept rows on their way to L2
        prefetch_l2(ej - lane + Hp * 32, 32 * 32 * 4);
        prefetch_l2(lg + 32 * ((j + 1) * heads), heads * 32 * 4);
      }
      const int s = 32 * j + lane;
      if (s >= N) continue;
      const float m = mrow[s];
#pragma unroll
      for (int hh = 0; hh < kLMaxHeads; ++hh) {
        if (hh >= heads) break;
        as[32 * hh + lane] =
            rnd<BF16>(expf(lg[32 * (j * heads + hh) + lane] - mx[hh]) / sm[hh] * m);
      }
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (o + c < H) msg[c] += as[hoff[c] + lane] * ej[c * 32];
    }
    const int c = o + lane;
    const float mha = rnd<BF16>(reduce_scatter(msg, lane) + (c < H ? qd[3 * Hp + c] : 0.f));
    f[c] = mha;
    if (c < H) loc = o == 0 ? mha : loc + mha;
  }
  PHASE_MARK(3);
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
      const float y = dv * rstd * __ldg(s1 + c) + __ldg(o1 + c);
      f[c] = rnd<BF16>(rnd<BF16>(xin[dn * H + c]) + rnd<BF16>(y));
    }
  }
  __syncwarp();
  const float* wf1 = image + gw.wf1;
  const float* wf2 = image + gw.wf2;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    if (c < H) {
      float hacc = 0.f;
#pragma unroll 32
      for (int k = 0; k < H; ++k) hacc = fmaf(f[k], __ldg(wf1 + k * Hp + c), hacc);
      gh[c] = rnd<BF16>(silu<false>(hacc + __ldg(image + gw.bf1 + c)));
    }
  }
  __syncwarp();
  // the FFN's outputs into the warp's output row, then LayerNorm and the
  // residual
  loc = 0.f;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    if (c < H) {
      float acc = 0.f;
#pragma unroll 32
      for (int k = 0; k < H; ++k) acc = fmaf(gh[k], __ldg(wf2 + k * Hp + c), acc);
      acc = rnd<BF16>(acc + __ldg(image + gw.bf2 + c));
      own[c] = acc;
      loc = o == 0 ? acc : loc + acc;
    }
  }
  mean = warp_sum(loc) * w.inv_h;
  loc = 0.f;
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    const float dv = own[c] - mean;
    if (c < H) loc = o == 0 ? dv * dv : loc + dv * dv;
  }
  rstd = rsqrtf(warp_sum(loc) * w.inv_h + 1e-6f);
#pragma unroll 1
  for (int o = 0; o < Hp; o += 32) {
    const int c = o + lane;
    if (c < H) {
      const float dv = own[c] - mean;
      const float y = dv * rstd * __ldg(s2 + c) + __ldg(o2 + c);
      float x2 = rnd<BF16>(f[c] + rnd<BF16>(y));
      if (silu_out) x2 = silu<false>(x2);
      xout[dn * H + c] = rnd<BF16>(x2);
    }
  }
  PHASE_MARK(4);
}

// ---- launch per basis module: the basis pass ---------------------------------------

struct BasisW {
  long long wbe, bbe, wo, bo;
};

// One basis module: cc = b_o + the sum over the TPU kernel's chunks of 64
// channels (CD itself where CD < 64) of coff[:, chunk] @ W_o[chunk], coff =
// silu((hp[s] + hp[d]) + (slab row @ W_be + b_be)), rounded as W_o's operand
// in bf16 mode; the score row of d gets sum_s rows(cc, frame) mask[s, d] /
// cnt[d], chunk of sources by chunk in order (first: written, else added).
template <bool BF16>
__global__ void __launch_bounds__(kLThreads, 2)
layered_basis_kernel(const void* __restrict__ slab, const float* __restrict__ maskT,
                     const float* __restrict__ cnt, const float* __restrict__ pos,
                     const float* __restrict__ hp, const float* __restrict__ image,
                     const BasisW bw, int N, int S, int dtiles, float* __restrict__ out,
                     int first, const Widths w) {
  extern __shared__ __align__(16) float bsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the module's weights: staged by the whole block before any warp returns
  const float* wt = image + bw.wbe;
  if (basis_staged(w, BF16)) {
    float* ws = bsm + kLDests * kBasisTileFloats;
    const int n4 = static_cast<int>(basis_weight_floats(w, BF16)) / 4;
    for (int i = threadIdx.x; i < n4; i += kLThreads)
      reinterpret_cast<float4*>(ws)[i] = __ldg(reinterpret_cast<const float4*>(wt) + i);
    __syncthreads();
    wt = ws;
  }
  const int b = blockIdx.x / dtiles, d = (blockIdx.x - b * dtiles) * kLDests + warp;
  if (d >= N) return;
  const int Hp = w.Hp, CD = w.CD, CDp = w.CDp, NR = w.NR;
  float* T = bsm + warp * kBasisTileFloats;   // [32 columns][kKeepLd]
  const size_t dn = static_cast<size_t>(b) * N + d;
  const float* hpd = hp + dn * NR;
  const float* wbe = wt;
  const float* bbe = wt + (bw.bbe - bw.wbe);
  const float* bo = wt + (bw.bo - bw.wbe);
  const float pd[3] = {pos[dn * 3], pos[dn * 3 + 1], pos[dn * 3 + 2]};
  const float* mrow = maskT + dn * N;
  const float count = cnt[dn];
  float tot[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    __syncwarp();   // the warp converged for its tile products
    const int s = 32 * j + lane;
    const char* unit = static_cast<const char*>(slab) + slab_unit<BF16>(b, N, S, d, j, Hp);
    if (j + 1 < S)   // the next chunk's slab unit on its way to L2
      prefetch_l2(unit + slab_unit<BF16>(0, N, S, 0, 1, Hp), 32 * Hp * (BF16 ? 2 : 4));
    // the edge MLP's pre-activation (hp[s] + hp[d]) + (slab row @ W_be + b_be)
    // of slice c0 in the accumulator layout (0 past CD)
    auto edge_mlp = [&](float (&v)[4][8], int c0) {
      slab_product<BF16>(v, unit, wbe, c0, CDp, w);
      float hd[8], bb[8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 d2 = __ldg(reinterpret_cast<const float2*>(hpd + c0 + 8 * nt + 2 * t));
        const float2 b2 = *reinterpret_cast<const float2*>(bbe + c0 + 8 * nt + 2 * t);
        hd[2 * nt] = d2.x;
        hd[2 * nt + 1] = d2.y;
        bb[2 * nt] = b2.x;
        bb[2 * nt + 1] = b2.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 32 * j + g + 8 * i;
        const float* hs = hp + (static_cast<size_t>(b) * N + (r < N ? r : 0)) * NR + c0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 h2 = r < N ? __ldg(reinterpret_cast<const float2*>(hs + 8 * nt + 2 * t))
                                  : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 2 * nt + e, col = c0 + tile_col(q, t);
            v[i][q] = col < CD ? ((e ? h2.y : h2.x) + hd[q]) + (v[i][q] + bb[q]) : 0.f;
          }
        }
      }
    };
    float cc[3];
    if constexpr (BF16) {
      // cc in the accumulator layout of basis_out's one n-tile (columns 2 t,
      // 2 t + 1 of rows g, g + 8 of each m-tile): b_o, then each chunk's sum
      float ccf[2][4], pc[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 2 * t + (e & 1);
          ccf[mt][e] = col < 3 ? bo[col] : 0.f;
          pc[mt][e] = 0.f;
        }
      const uint2* wo = reinterpret_cast<const uint2*>(wt + (bw.wo - bw.wbe));
#pragma unroll 1
      for (int c0 = 0; c0 < CDp; c0 += 32) {
        float v[4][8];
        edge_mlp(v, c0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) v[i][q] = silu<true>(v[i][q]);   // rounded next
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[2][4];
          tile_frags(v, kk, a);
          const uint2 bb = wo[(c0 / 16 + kk) * 32 + lane];
          const uint32_t bf[2] = {bb.x, bb.y};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(pc[mt], a[mt], bf);
        }
        if ((c0 + 32) % 64 == 0 || c0 + 32 >= CD) {   // the TPU kernel's chunks
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ccf[mt][e] += pc[mt][e];
              pc[mt][e] = 0.f;
            }
        }
      }
      // columns 0-2 of each row sit in lanes 4 g (0, 1) and 4 g + 1 (2):
      // through the tile to the row's lane
      if (t < 2) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 2 * t + (e & 1);
            if (col < 3) T[col * kKeepLd + 16 * mt + g + 8 * (e >> 1)] = ccf[mt][e];
          }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 3; ++i) cc[i] = T[i * kKeepLd + lane];
      __syncwarp();
    } else {
      const float4* wo = reinterpret_cast<const float4*>(wt + (bw.wo - bw.wbe));
      cc[0] = bo[0];
      cc[1] = bo[1];
      cc[2] = bo[2];
      float part[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
      for (int c0 = 0; c0 < CDp; c0 += 32) {
        float v[4][8];
        edge_mlp(v, c0);
        scatter_tile(T, 0, v);
        __syncwarp();
        if (s < N) {   // the pair's lane: silu and basis_out over the channels in order
#pragma unroll
          for (int c = 0; c < 32; ++c) {
            if (c0 + c < CD) {
              const float coff = silu<false>(T[c * kKeepLd + lane]);
              const float4 wo4 = wo[c0 + c];
              part[0] = fmaf(coff, wo4.x, part[0]);
              part[1] = fmaf(coff, wo4.y, part[1]);
              part[2] = fmaf(coff, wo4.z, part[2]);
            }
          }
        }
        __syncwarp();
        if ((c0 + 32) % 64 == 0 || c0 + 32 >= CD) {   // the TPU kernel's chunks
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            cc[i] += part[i];
            part[i] = 0.f;
          }
        }
      }
    }
    float contrib[3] = {0.f, 0.f, 0.f};
    if (s < N) {
      const size_t sn = static_cast<size_t>(b) * N + s;
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

// ---- host side -------------------------------------------------------------------

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
  const int S = (N + 31) / 32, dtiles = (N + kLDests - 1) / kLDests;
  unsigned char* rows = front_on_chip(w, BF16) ? nullptr : scratch + sc.rows;
  float* keep = reinterpret_cast<float*>(scratch + sc.keep);
  float* ffn = ffn_rows_on_chip(w) ? nullptr : reinterpret_cast<float*>(scratch + sc.ffn);
  const long long pair_blocks = static_cast<long long>(B) * dtiles;
  const long long node_items = static_cast<long long>(B) * N * w.NR;
  const long long node_blocks = (node_items + kLNodeThreads - 1) / kLNodeThreads;
  const int nseg = num_segments(w);
  if (pair_blocks > 0x7fffffffll || node_blocks > 0x7fffffffll || nseg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto at = [&](int i) { return image_at(i, w, BF16); };
  layered_weights_kernel<BF16><<<dim3(8, nseg), 256, 0, st>>>(params, image, w);
  if (w.L == 0) {   // no module: the score is 0
    const cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(B) * N * 3 * 4, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const int fsm = front_smem(w, BF16), gsm = gat_smem(w);
  cudaError_t e = allow_smem(layered_front_kernel<BF16>, fsm);
  if (e == cudaSuccess) e = allow_smem(layered_gat_kernel<BF16>, gsm);
  if (e == cudaSuccess) e = allow_smem(layered_basis_kernel<BF16>, basis_smem(w, BF16));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned pb = static_cast<unsigned>(pair_blocks);
  const FrontW fw = {at(0), at(1), at(2), at(3), at(4), at(5), at(6),
                     w.variant == 2 ? at(7) : 0, w.variant == 2 ? at(8) : 0,
                     w.variant == 2 ? at(9) : 0};
  layered_front_kernel<BF16><<<pb, kLThreads, fsm, st>>>(pos, edge2d, mask, image, fw, slab,
                                                         maskT, cnt, rows, N, S, dtiles, w);
  const float* x = node;
  int li = 0;
  const int gat0 = front_segments(w.variant), basis0 = gat0 + 18 * w.L * w.NC;
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
      const GatW gw = {at(seg + 6),  at(seg + 7),  at(seg + 10), at(seg + 11), at(seg + 12),
                       at(seg + 13), at(seg + 14), at(seg + 15), at(seg + 16), at(seg + 17)};
      float* xn = xbuf[li++ & 1];
      layered_gat_kernel<BF16><<<pb, kLThreads, gsm, st>>>(slab, maskT, nodebuf, x, xn, image,
                                                           gw, keep, ffn, N, S, dtiles,
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
    const BasisW bw = {at(seg + 1), at(seg + 2), at(seg + 3), at(seg + 4)};
    layered_basis_kernel<BF16><<<pb, kLThreads, basis_smem(w, BF16), st>>>(
        slab, maskT, cnt, pos, nodebuf, image, bw, N, S, dtiles, out, mod == 0, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The layered plan: dynamic shared memory of its largest pass block, in the
// mode, at these widths, at any N (the front pass's rows and the GAT pass's
// FFN rows where they fit on the chip, the tiles, a basis module's staged
// weights; ops/score_kernel.py::layered_smem counts the same); -1 for widths
// it does not take.
extern "C" int score_eval_layered_smem_bytes(int bf16, int variant, int num_layers,
                                             int num_convs, int hidden, int heads,
                                             int coff_dim) {
  Widths w;
  if (!make_widths(variant, num_layers, num_convs, hidden, heads, coff_dim, w)) return -1;
  return layered_smem(w, bf16 != 0);
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
// arguments of score_eval_fused (csrc/score_eval.cu) with the widths in place
// of the cluster plan, and scratch (score_eval_layered_scratch_bytes of device
// memory, 256-byte aligned) in place of the slab.  offsets: any number of
// segments, each at the offset of pack_score_params' layout for these widths.
// Returns cudaErrorInvalidValue on widths it does not take (make_widths), on
// another layout, or when a launch's blocks pass the int32 grid index.
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
    seg_offsets(i, w, bf16 != 0, packed, image);
    if (offsets[i] != packed) return static_cast<int>(cudaErrorInvalidValue);
  }
  seg_offsets(n_offsets, w, bf16 != 0, packed, image);
  if (image > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  return bf16 ? launch_layered<true>(pos, node, edge2d, mask, params, out, sc, B, N, w, s)
              : launch_layered<false>(pos, node, edge2d, mask, params, out, sc, B, N, w, s);
}
