// Fused SchNet CFConv (continuous-filter convolution), forward and backward:
//   pre[b, i, j, k] = sum_g ea[b, i, j, g] * w1[g, k] + b1[k]
//   s               = softplus(pre) - log 2                         (f32)
//   wf[b, i, j, f]  = sum_k s[b, i, j, k] * w2[k, f] + b2[f]
//   out[b, i, f]    = sum_j (wf[b, i, j, f] * env[b, i, j]) * x[b, j, f]
// with ea [B, N, N, G] smeared distances (f32 or bf16: the kernels are
// built for both and read ea as given), env [B, N, N] cutoff envelope times
// the pair mask, x [B, N, F] node features, w1 [G, F], w2 [F, F], f32 in
// device memory.  The [B, N, N, F] filter tensors never reach device
// memory.
//
// Replaces the Pallas kernels moleculesde_tpu/ops/cfconv.py::_fwd_kernel
// (pallas_call at l.212) and ::_bwd_kernel (pallas_call at l.228), entry
// fused_cfconv l.301.  Gradient contract as there: dx, dw1, db1, dw2, db2;
// ea and env get none (the Python wrapper refuses them if they need one).
//
// K5 (cfconv_rbf_fwd / cfconv_rbf_bwd) is the same pair of kernels fed from
// the raw distances dist [B, N, N] f32 instead of ea: the block builds each
// ea value it stages in shared memory as the TPU kernel's _smear does
// (ops/cfconv.py:66-89, the smear= form of the same two pallas_calls, entry
// fused_cfconv_rbf l.337):
//   ea[g] = exp((coeff * diff) * diff),  diff = dist - (float(g) * step + start)
// in f32 without contraction into FMAs, with accurate expf, rounded to bf16
// in bf16 mode.  The [B, N, N, G] slab never exists in device memory.
//
// bf16 != 0 reproduces the TPU kernel's bf16 mode: ea, x, w1, w2 and s are
// rounded to bf16 before the products, which accumulate in f32; the biases,
// softplus, envelope and the aggregation stay f32.  In the backward, dwf =
// (g * x) * env and dpre are rounded to bf16 for the weight products, dx is
// returned rounded to bf16 (x's dtype there), and db1 / db2 sum unrounded.
//
// BACKWARD (cfconv_bwd_kernel): five products per pair (i, j) --
//   (1) pre = ea @ W1 + b1, s = softplus(pre) - log 2, sigma = sigmoid(pre)
//       (one fast __expf(-|pre|) for both; JAX's exp(pre - s - log 2) up to
//       a few f32 ulps)
//   (2) wf = s @ W2 + b2;  dx[j, f] = sum_i (wf * env) * g[i, f]
//   (3) dwf = (g[i] * x[j]) * env;  ds = dwf @ W2^T;  dpre = ds * sigma
//   (4) dW2 += s^T @ dwf      (5) dW1 += ea^T @ dpre
// plus db1 = sum dpre, db2 = sum dwf.
// Bound: operations.  About 2 * (2 G16 F + 3 F^2 + ...) flops per pair:
// 17 GFLOP at B=128, N=32, G=51 (padded to 64), F=128, ~17 us on the bf16
// tensor cores at 989 TFLOP/s (~0.25 ms on the CUDA cores in f32); the
// compulsory traffic (bf16 ea once, 13 MB) is ~4 us.
// Design:
//  * Work unit = (graph b, a tile of J columns j) over all rows i.  The unit's
//    pair tile has M = IC * J rows (pair p = jj * IC + ii), with M = 128 / CW
//    and F padded to FP = 64 * CW (CW = 1, 2, 4: M * FP = 8192), IC = the
//    power of two >= max(N, 16), at most M.  For N > IC a column's rows are
//    taken in chunks of IC, in order, and the unit's dx is summed across the
//    chunks in that order.  Rows past N, G's padding to G16 (a multiple of
//    16) and F's padding to FP are zero-filled.  There is no cap on N.
//  * Persistent blocks: the launcher runs min(#SMs, units) blocks of 8 warps;
//    block k takes units k, k + grid, ... (a fixed assignment), so B=64
//    fills the card as B=128 does.
//  * The weights are staged once per block, rounded to the mode's type, as
//    W1 [G16][FP] and W2 [FP][FP] (rows padded by 16 bytes, so the 8 rows an
//    ldmatrix reads fall in 8 distinct bank groups).  Tiles are software-
//    pipelined with cp.async: the next tile's ea source bytes (K2: ea; K5:
//    the distances) are copied as 4-byte words into a staging copy while
//    this tile computes (a bf16 row of odd G starts mid-word, so 16-byte
//    copies cannot be aligned), and fixed up into the aligned ea tile (K5:
//    smeared there) at the tile's start; the next tile's env and its g and
//    x rows (f32, 16-byte copies) follow once this tile's (2), their only
//    reader, is done.  In f32 mode, and at FP = 256, the tiles leave no room
//    for g and x, which (2) then reads from device memory.
//  * bf16 mode: the products run on the tensor cores, mma.sync m16n8k16 bf16
//    -> f32, operands from shared memory through ldmatrix (.trans for the
//    transposed operands W1, W2 in (2), s^T, ea^T, dwf and dpre).  f32 mode:
//    the same tiles, schedule and fragment layout, the products as f32 FMAs
//    on the CUDA cores (frag_gemm's f32 overload), so it keeps its 1e-4 bar.
//  * Products (1)-(3): warp w takes 16 pair rows and 64 feature columns
//    (8 fragments of 16 x 8).  s, dwf and then dpre (into s's buffer once
//    (4) has read s) go to shared memory in the mode's type for the next
//    product; sigma stays in registers.  dx: each warp's 16 rows share one
//    column j (IC >= 16); they are summed by shuffles, then the row-warps
//    of a column in warp order, then the chunks in order.  db1 / db2 are
//    per-thread sums over the thread's rows, reduced at the end.
//  * (4) and (5): dW2 (FP x FP, a 4 x 2 warp grid) and dW1 (G16 x FP, warp w
//    columns w * FP / 8) accumulate in registers across the block's units
//    when FP <= 128 (and G16 <= 64 for dW1); otherwise each tile's product
//    is added into the block's partial in device memory (its own rows,
//    L2-resident) -- the same order on every run.
//  * Deterministic sums: each block writes one partial of dW1, dW2, db1 and
//    db2; a second launch adds the partials in block order (partials.cuh).
//    No atomics: two runs give the same bits.
// Shared memory (bf16 mode, bf16 ea, G16 = 64, FP = 128, M = 64, N >= 64):
// W1 17.0 KB, W2 34.0 KB, ea 9.0 KB, s / dpre 17.0 KB, dwf 17.0 KB, the ea
// copy 6.8 KB, g 34.0 KB, x 0.5 KB, env, biases and the sums 5.3 KB: 139 KB,
// and no more at any N.  f32 mode at FP = 128: 186-199 KB (g and x not
// staged); the wrapper raises where the plan exceeds the 227 KB a block may
// use (f32 mode at F > 128, or at F > 64 with G > 64), naming the sizes.
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8, from
// benchmarks/profile_cfconv.py): bf16 mode at FP = 128 (the main path) 255
// registers and 140-164 B of spill stores per thread; FP = 64 255 and
// 208-316 B; FP = 256 227-229 and none.  f32 mode: FP = 128 255 and 0-8 B;
// FP = 64 252-254 and none.  The dW1 / dW2 accumulators take 96 of them,
// so a block of 8 warps fills an SM.
//
// FORWARD (cfconv_fwd_kernel): two products per pair --
//   (1) pre = ea @ W1 + b1, s = softplus(pre) - log 2
//   (2) wf = s @ W2 + b2;  out[i, f] += (wf * env) * x[j, f]
// Bound at B=128, N=32, G=51, F=128: K2 in bf16 by its bytes (bf16 ea read
// once, 13 MB, ~5 us), K5 by its operations (2 (G F + F^2) flops per pair
// inside the cutoff, ~2 us on the tensor cores); f32 mode by the CUDA
// cores' FMA rate (~30 us).  Design (plan: fwd_plan, ops/cfconv.py::fwd_plan):
//  * Work unit = (graph b, a tile of R rows i) over all columns j, in chunks
//    of C = 16 (N <= 16) or 32 columns: tile of M = R * C = 128 / CW pair
//    rows (pair p = r * C + jj), F padded to FP = 64 * CW.  Each warp's 16
//    pair rows share one row i; the sum over j of an output row stays in its
//    unit -- no partials, no atomics, one write of out[b, i, :].  For fixed
//    i the ea source of a chunk is one contiguous run.
//  * Persistent blocks: min(units, resident blocks per SM x #SMs) blocks of
//    8 warps, block k taking units k, k + grid, ...  Units are numbered row
//    tile major (u = row tile * B + b), so each block walks every grid/B-th
//    row tile across many graphs: rows past a graph's atoms, whose tiles are
//    skipped, fall to every block alike.
//  * W1 [G16][FS] and W2 [FP][FS] are staged once per block in the mode's
//    type.  Each tile's ea source bytes are copied one tile ahead by cp.async
//    and fixed up in shared memory (copy_ea_rows / fix_up_ea, as the
//    backward; 16-byte pieces from the aligned address that holds a row's
//    first byte, since a row here is a long run), its env and the chunk's x
//    rows (16-byte cp.async) one tile ahead from the end of (2), their only
//    reader.
//  * Skips: a tile whose env is zero on every pair (rows past the atoms,
//    padding) is skipped after a block-wide vote (__syncthreads_or; each
//    thread reads the env word it copied itself); a warp whose 16 pairs all
//    have env == 0 skips (1) and (2); pairs with env == 0 stage ea = 0.
//    Such a pair adds exactly 0 to out, so the skips change no bit, and a
//    skipped row of out is written as zeros.
//  * bf16 mode: (1) and (2) on the tensor cores, mma.sync m16n8k16 bf16 ->
//    f32 (frag_gemm, ldmatrix); the softplus in the fast __expf / __logf
//    (s is rounded to bf16 next).  f32 mode: the same tiles and schedule,
//    the products as f32 FMAs (frag_gemm's f32 overload) and the accurate
//    expf / log1pf, for its 1e-4 bar.
//  * (2)'s epilogue folds (wf + b2) * env * x in registers and sums the
//    fragment's 16 rows j by shuffles; then a row's warps in warp order, then
//    the chunks in order.  No [M, FP] wf tile goes to shared memory.
//  * Coverage: where W1, W2 and the tiles do not fit, the plan stages ea in
//    chunks of 64 entries of G read straight from device memory (no copy),
//    and then reads the weights from device memory on the CUDA cores
//    (frag_gemm_dev): every G and F <= 256 has a plan at every N.
// Shared memory (bf16 mode, bf16 ea, G16 = 64, FP = 128, M = 64, N > 16):
// W1 17.0 KB, W2 34.0 KB, ea 9.0 KB, s 17.0 KB, x 17.0 KB, the ea copy
// 6.4 KB, env, biases and row sums 4.3 KB: 104.7 KB, two blocks per SM
// (K5: 98.5 KB).  f32 mode: 170.5-183.0 KB, one block.
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8, from
// benchmarks/profile_cfconv.py): bf16 mode, held to 128 for two blocks per
// SM, K2 (bf16 or f32 ea): FP = 128 (the main path) 128 registers and 36 B
// of spill stores, FP = 64 128 and 84 B, FP = 256 127 and none; K5: 128 and
// none (4 B at FP = 256).  f32 mode: 147-167 registers, no spills.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <atomic>
#include <cstdint>

#include "hopper.cuh"
#include "partials.cuh"

namespace {

constexpr float kLog2 = 0.693147180559945309f;
// pieces the ea copies are made of: the forward's rows are long runs
// (a 32-column chunk of one row i), the backward's short (J pairs)
constexpr int kFwdCopyBytes = 16, kBwdCopyBytes = 4;

// Phase clocks for benchmarks/profile_cfconv.py, which builds this source
// with -DCFCONV_PROFILE: thread 0 of each block adds the clock64 cycles
// since its last mark to slot k of the block (backward 0-6, forward 8-13;
// CFCONV_COUNT adds one).  Empty in the kernels' own build.
#ifdef CFCONV_PROFILE
constexpr int kProfileBlocks = 1024;
__device__ unsigned long long g_cfconv_phase[kProfileBlocks * 16];
#define CFCONV_CLOCK unsigned long long last_clk_ = clock64()
#define CFCONV_MARK(k)                                                        \
  do {                                                                        \
    if (threadIdx.x == 0) {                                                   \
      const unsigned long long c_ = clock64();                                \
      g_cfconv_phase[blockIdx.x * 16 + (k)] += c_ - last_clk_;                \
      last_clk_ = c_;                                                         \
    }                                                                         \
  } while (0)
#define CFCONV_COUNT(k) \
  do { if (threadIdx.x == 0) g_cfconv_phase[blockIdx.x * 16 + (k)] += 1; } while (0)
#else
#define CFCONV_CLOCK
#define CFCONV_MARK(k)
#define CFCONV_COUNT(k)
#endif

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float rnd(float v, int bf16) {
  return bf16 ? round_bf16(v) : v;
}

// shifted softplus, as jnp.logaddexp(p, 0) - log 2
__device__ __forceinline__ float ssp(float p) {
  return fmaxf(p, 0.f) + log1pf(expf(-fabsf(p))) - kLog2;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float value(const float* p) { return *p; }

__device__ __forceinline__ float value(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Where a block's ea values come from; ``pair`` is (b * N + i) * N + j.
// The kernels copy each pair's source bytes (``pair_bytes(G)`` from ``src``,
// ``bytes`` in all) to shared memory and read them there with from_copy; a
// forward plan without the copy reads them with operator().
// EaRead: the smeared distances ea [B, N, N, G] in device memory (K2).
template <typename EA>
struct EaRead {
  const EA* ea;
  size_t bytes;
  __device__ __forceinline__ float operator()(size_t pair, int g, int G) const {
    return load(ea + pair * G + g);
  }
  __host__ __device__ static int pair_bytes(int G) { return G * static_cast<int>(sizeof(EA)); }
  __device__ const unsigned char* src() const { return reinterpret_cast<const unsigned char*>(ea); }
  __device__ __forceinline__ float from_copy(const unsigned char* pair, int g) const {
    return value(reinterpret_cast<const EA*>(pair) + g);
  }
};

// EaSmear: built from the raw distances dist [B, N, N] (K5), as _smear:
// offset = float(g) * step + start, exp((coeff * diff) * diff), every op
// rounded to f32 on its own (the _rn intrinsics keep nvcc from fusing them).
struct EaSmear {
  const float* dist;
  float start, step, coeff;
  size_t bytes;
  __device__ __forceinline__ float smear(float d, int g) const {
    const float offset = __fadd_rn(__fmul_rn(static_cast<float>(g), step), start);
    const float diff = __fsub_rn(d, offset);
    return expf(__fmul_rn(__fmul_rn(coeff, diff), diff));
  }
  __device__ __forceinline__ float operator()(size_t pair, int g, int) const {
    return smear(__ldg(dist + pair), g);
  }
  __host__ __device__ static int pair_bytes(int) { return 4; }
  __device__ const unsigned char* src() const {
    return reinterpret_cast<const unsigned char*>(dist);
  }
  __device__ __forceinline__ float from_copy(const unsigned char* pair, int g) const {
    return smear(*reinterpret_cast<const float*>(pair), g);
  }
};

// ---------------------------------------------------------------------------
// shared pieces: fragment products, the ea copy
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// 4-byte words of a row of the ea copy holding ``cols`` pairs of ``pb``
// source bytes in pieces of ``bytes`` (4 or 16): the pieces from the one
// that holds the row's first byte, and one more.
__host__ __device__ inline int copy_row_words(int cols, int pb, int bytes) {
  return ((cols * pb + bytes - 1) / bytes + 1) * (bytes / 4);
}

// The backward's tiling and shared-memory plan (mirrored by
// moleculesde_tpu_torch/ops/cfconv.py::bwd_plan).  esz: 2 (bf16 mode) or
// 4 (f32 mode).  FP = 0 where F > 256.
struct BwdPlan {
  int FP, M, IC, J, chunks, tiles, G16, GS, FS, GXS, RS;
  size_t off_w2, off_ea, off_s, off_dwf, off_env, off_b1, off_b2, off_red, off_dx, off_copy,
      off_g, off_x, bytes;
};

// g and x rows are staged in shared memory (cp.async) in bf16 mode at
// FP <= 128; elsewhere the f32 tiles or the weights leave no room, and the
// epilogue of (2) reads them from device memory
__host__ __device__ constexpr bool stage_gx(int FP, int esz) { return FP <= 128 && esz == 2; }

__host__ __device__ inline BwdPlan bwd_plan(int N, int G, int F, int esz, int pair_bytes) {
  BwdPlan P{};
  P.FP = F <= 64 ? 64 : (F <= 128 ? 128 : (F <= 256 ? 256 : 0));
  if (P.FP == 0) return P;
  P.M = 128 / (P.FP / 64);
  P.IC = 16;
  while (P.IC < N && P.IC < P.M) P.IC *= 2;
  P.J = P.M / P.IC;
  P.chunks = (N + P.IC - 1) / P.IC;
  P.tiles = (N + P.J - 1) / P.J;
  P.G16 = (G + 15) / 16 * 16;
  const int pad = esz == 2 ? 8 : 4;  // 16 bytes per row
  P.GS = P.G16 + pad;
  P.FS = P.FP + pad;
  size_t o = align16(static_cast<size_t>(P.G16) * P.FS * esz);        // W1 [G16][FS]
  P.off_w2 = o;  o += align16(static_cast<size_t>(P.FP) * P.FS * esz);  // W2 [FP][FS]
  P.off_ea = o;  o += align16(static_cast<size_t>(P.M) * P.GS * esz);   // ea [M][GS]
  P.off_s = o;   o += align16(static_cast<size_t>(P.M) * P.FS * esz);   // s, then dpre
  P.off_dwf = o; o += align16(static_cast<size_t>(P.M) * P.FS * esz);   // dwf
  P.off_env = o; o += align16(static_cast<size_t>(P.M) * 4);            // env [M]
  P.off_b1 = o;  o += align16(static_cast<size_t>(P.FP) * 4);
  P.off_b2 = o;  o += align16(static_cast<size_t>(P.FP) * 4);
  P.off_red = o; o += align16(static_cast<size_t>(P.M / 16) * P.FP * 4);  // [M/16][FP]
  P.off_dx = o;  o += align16(static_cast<size_t>(P.J) * P.FP * 4);       // [J][FP]
  // the copy of a tile's ea source bytes: row ii holds pairs (i0 + ii, j0 ..
  // j0 + J - 1) from the 4-byte word that holds their first byte
  P.RS = copy_row_words(P.J, pair_bytes, kBwdCopyBytes);
  P.off_copy = o; o += align16(static_cast<size_t>(P.IC) * P.RS * 4);   // [IC][RS] words
  P.GXS = P.FP + 8;  // f32 rows padded by 32 bytes: 2-way bank conflicts at most
  P.off_g = o;   // g rows of the chunk [IC][GXS], x rows of the unit [J][GXS]
  if (stage_gx(P.FP, esz)) o += align16(static_cast<size_t>(P.IC) * P.GXS * 4);
  P.off_x = o;
  if (stage_gx(P.FP, esz)) o += align16(static_cast<size_t>(P.J) * P.GXS * 4);
  P.bytes = o;
  return P;
}

template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <> struct Elem<float> {
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

using namespace hopper;   // ldmatrix, cp.async, mma.sync (hopper.cuh)

// acc[mt][nt] (the m16n8 accumulator fragment at rows m0 + 16 mt, columns
// n0 + 8 nt: lane l holds rows l/4 and l/4 + 8, columns 2 (l%4) and +1) +=
// A[m, 0:K] @ B[0:K, n] over the warp's MT x NT fragments, mt < mcount.
// A_KM: A is stored [K][M] (A = S^T), else [M][K]; B_KN: B is stored
// [K][N], else [N][K].  Row strides lda / ldb in elements.  Warp-uniform.
template <int MT, int NT, bool A_KM, bool B_KN>
__device__ __forceinline__ void frag_gemm(float (&acc)[MT][NT][4],
                                          const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int ldb,
                                          int m0, int n0, int K, int mcount) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < mcount) {
        const int m = m0 + mt * 16;
        if (A_KM) {
          const int q = lane >> 3;
          ldsm_x4_t(a[mt], A + (k0 + (lane & 7) + (q >> 1) * 8) * lda + m + (q & 1) * 8);
        } else {
          ldsm_x4(a[mt], A + (m + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
        }
      }
    }
    // B two fragments (n-tiles nt, nt + 1) per ldmatrix.x4, the last one of
    // an odd NT alone
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      const int n = n0 + nt * 8;
      const int kk = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      if (nt + 1 < NT) {
        if (B_KN) {
          ldsm_x4_t(b, B + kk * ldb + n + ((lane >> 4) & 1) * 8);
        } else {
          ldsm_x4(b, B + (n + (lane & 7) + ((lane >> 4) & 1) * 8) * ldb + k0 +
                         ((lane >> 3) & 1) * 8);
        }
      } else {
        uint32_t (&b2)[2] = *reinterpret_cast<uint32_t (*)[2]>(b);
        if (B_KN) {
          ldsm_x2_t(b2, B + kk * ldb + n);
        } else {
          ldsm_x2(b2, B + (n + (lane & 7)) * ldb + k0 + ((lane >> 3) & 1) * 8);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (nt + h >= NT) break;
        const uint32_t bh[2] = {b[2 * h], b[2 * h + 1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (mt < mcount) mma_bf16(acc[mt][nt + h], a[mt], bh);
      }
    }
  }
}

// f32 mode: the same fragments, computed with f32 FMAs on the CUDA cores
// (k in order within each fragment).
template <int MT, int NT, bool A_KM, bool B_KN>
__device__ __forceinline__ void frag_gemm(float (&acc)[MT][NT][4],
                                          const float* A, int lda,
                                          const float* B, int ldb,
                                          int m0, int n0, int K, int mcount) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, c2 = (lane & 3) * 2;
  for (int k = 0; k < K; ++k) {
    float a[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = m0 + mt * 16 + r;
      a[mt][0] = a[mt][1] = 0.f;
      if (mt < mcount) {
        a[mt][0] = A_KM ? A[k * lda + m] : A[m * lda + k];
        a[mt][1] = A_KM ? A[k * lda + m + 8] : A[(m + 8) * lda + k];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + c2;
      const float b0 = B_KN ? B[k * ldb + n] : B[n * ldb + k];
      const float b1 = B_KN ? B[k * ldb + n + 1] : B[(n + 1) * ldb + k];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mcount) {
          acc[mt][nt][0] = fmaf(a[mt][0], b0, acc[mt][nt][0]);
          acc[mt][nt][1] = fmaf(a[mt][0], b1, acc[mt][nt][1]);
          acc[mt][nt][2] = fmaf(a[mt][1], b0, acc[mt][nt][2]);
          acc[mt][nt][3] = fmaf(a[mt][1], b1, acc[mt][nt][3]);
        }
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

// Write (or add, ``add``) the warp's fragments into dst [rows][cols] (row
// stride ld), fragments mt < mcount, elements inside rows x cols only.
template <int MT, int NT>
__device__ __forceinline__ void put(const float (&acc)[MT][NT][4], float* dst, int ld,
                                    int rows, int cols, int m0, int n0, int mcount,
                                    bool add) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mcount) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mt * 16 + r + (e >> 1) * 8;
        const int col = n0 + nt * 8 + c2 + (e & 1);
        if (row < rows && col < cols) {
          float* p = dst + static_cast<size_t>(row) * ld + col;
          *p = add ? *p + acc[mt][nt][e] : acc[mt][nt][e];
        }
      }
  }
}

// Sum a per-thread [8][2] column vector over the block's rows: lanes of a
// warp (xor 4, 8, 16), then the row-warps in order, into out[0:F].
template <int RW, int FP>
__device__ __forceinline__ void block_col_sum(float (&v)[8][2], float* red, float* out,
                                              int F, int rw, int n0) {
  const int t = threadIdx.x, lane = t & 31, c2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[nt][e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[rw * FP + n0 + nt * 8 + c2 + e] = s;
    }
  __syncthreads();
  for (int f = t; f < F; f += kThreads) {
    float s = 0.f;
    for (int k = 0; k < RW; ++k) s += red[k * FP + f];
    out[f] = s;
  }
  __syncthreads();
}

// f32 mode's products where the weights are not in shared memory (plans
// whose weights do not fit): acc[0][nt] += A[m0:m0+16, 0:K] @ w[k0:k0+K,
// n0 + 8 nt ...] as f32 FMAs, A from shared memory, w [kmax][nmax] f32 in
// device memory (row stride nmax, zero outside), rounded to bf16 in bf16
// mode.  Warp-uniform.
template <typename T>
__device__ __forceinline__ void frag_gemm_dev(float (&acc)[1][8][4], const T* A, int lda,
                                              const float* __restrict__ w, int k0, int kmax,
                                              int nmax, int m0, int n0, int K) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, c2 = (lane & 3) * 2;
  for (int k = 0; k < K; ++k) {
    const float a0 = value(A + (m0 + r) * lda + k), a1 = value(A + (m0 + r + 8) * lda + k);
    const bool kok = k0 + k < kmax;
    const float* wk = w + static_cast<size_t>(k0 + k) * nmax;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = n0 + nt * 8 + c2;
      const float b0 = kok && n < nmax ? rnd(__ldg(wk + n), kBf16) : 0.f;
      const float b1 = kok && n + 1 < nmax ? rnd(__ldg(wk + n + 1), kBf16) : 0.f;
      acc[0][nt][0] = fmaf(a0, b0, acc[0][nt][0]);
      acc[0][nt][1] = fmaf(a0, b1, acc[0][nt][1]);
      acc[0][nt][2] = fmaf(a1, b0, acc[0][nt][2]);
      acc[0][nt][3] = fmaf(a1, b1, acc[0][nt][3]);
    }
  }
}

// A tile's ea source bytes into ``copy`` ([rows][RS] 4-byte words): row k
// the pairs (i0 + k, j0 .. j0 + cols - 1) inside N, by cp.async of BYTES
// (4 or 16) from the BYTES-aligned address that holds the row's first byte
// (a bf16 row of odd G starts mid-word, so the rows cannot be copied
// aligned), the last piece of the tensor read only as far as it goes.  The
// block's threads take the pieces of all rows in turn.  Needs ``ea.src()``
// 16-byte aligned (the wrapper checks it).
template <int BYTES, typename Src>
__device__ __forceinline__ void copy_ea_rows(const Src& ea, unsigned char* copy, int RS,
                                             int rows, int cols, int b, int i0, int j0,
                                             int N, int pb) {
  const int nbytes = min(cols, N - j0) * pb;
  const int per_row = RS * 4 / BYTES;
  for (int q = threadIdx.x; q < rows * per_row; q += kThreads) {
    const int k = q / per_row, c = q - k * per_row;
    if (i0 + k >= N) break;
    const size_t start = ((static_cast<size_t>(b) * N + i0 + k) * N + j0) * pb;
    if (c >= (static_cast<int>(start % BYTES) + nbytes + BYTES - 1) / BYTES) continue;
    const size_t off = (start / BYTES + c) * BYTES;
    const int valid = off + BYTES <= ea.bytes ? BYTES : static_cast<int>(ea.bytes - off);
    if (BYTES == 16)
      cp_async16n(copy + k * RS * 4 + c * 16, ea.src() + off, valid);
    else
      cp_async4(copy + k * RS * 4 + c * 4, ea.src() + off, valid);
  }
}

// The tile's ea from its copy into eas [M][GS], entries g < G16 (zero past
// G; K5: the smearing is built here): warp w takes pairs p = w, w + 8, ...,
// lane l the entries l, l + 32, ... of each.  at(p, k, jj) returns whether
// pair p is staged and places it in the copy (row k, the row's jj-th pair);
// a pair not staged gets zeros.  BYTES as in copy_ea_rows.
template <int M, int BYTES, typename T, typename Src, typename At>
__device__ __forceinline__ void fix_up_ea(T* eas, int GS, const unsigned char* copy, int RS,
                                          const Src& ea, int b, int N, int i0, int j0, int G,
                                          int G16, int pb, At at) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g0 = 0; g0 < G16; g0 += 64) {
#pragma unroll
    for (int k = 0; k < M / kWarps; ++k) {
      const int p = warp + kWarps * k;
      int row, jj;
      const bool ok = at(p, row, jj);
      // the row's first byte sits at offset start % BYTES of its copy (32-bit
      // arithmetic keeps the low bits of the 64-bit offset)
      const unsigned un = static_cast<unsigned>(N);
      const unsigned shift = ((static_cast<unsigned>(b) * un + i0 + row) * un + j0) *
                             static_cast<unsigned>(pb) % static_cast<unsigned>(BYTES);
      const unsigned char* pair = copy + row * RS * 4 + shift + jj * pb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gg = g0 + lane + 32 * h;
        if (gg < G16) eas[p * GS + gg] = Elem<T>::from(ok && gg < G ? ea.from_copy(pair, gg) : 0.f);
      }
    }
  }
}

// T: __nv_bfloat16 (bf16 mode, tensor cores) or float (f32 mode).  CW:
// FP = 64 CW padded features, M = 128 / CW pair rows per tile.
template <typename Src, typename T, int CW>
__global__ void __launch_bounds__(kThreads, 1)
cfconv_bwd_kernel(const Src ea, const float* __restrict__ env,
                  const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ g,
                  float* __restrict__ dx,
                  float* __restrict__ dw1_part,   // [grid, G, F]
                  float* __restrict__ db1_part,   // [grid, F]
                  float* __restrict__ dw2_part,   // [grid, F, F]
                  float* __restrict__ db2_part,   // [grid, F]
                  int B, int N, int G, int F) {
  constexpr int FP = 64 * CW, M = 128 / CW, RW = M / 16;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr bool kRegW2 = CW <= 2;       // dW2 in registers across units
  constexpr bool kStageGX = stage_gx(FP, sizeof(T));
  constexpr int MT4 = CW, NT4 = 4 * CW;  // dW2 fragments per warp (4 x 2 warps)
  constexpr int NT5 = CW;                // dW1 fragments per warp, per 16 rows
  const int pb = Src::pair_bytes(G);
  const BwdPlan P = bwd_plan(N, G, F, sizeof(T), pb);
  const int IC = P.IC, J = P.J, G16 = P.G16, GS = P.GS, FS = P.FS;
  const bool reg_w1 = kRegW2 && G16 <= 64;

  extern __shared__ __align__(16) float smem_f[];   // one declaration per file
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  T* w1s = reinterpret_cast<T*>(smem);                  // [G16][FS]
  T* w2s = reinterpret_cast<T*>(smem + P.off_w2);       // [FP][FS]
  T* eas = reinterpret_cast<T*>(smem + P.off_ea);       // [M][GS]
  T* ss = reinterpret_cast<T*>(smem + P.off_s);         // [M][FS]: s, then dpre
  T* dwfs = reinterpret_cast<T*>(smem + P.off_dwf);     // [M][FS]
  float* envs = reinterpret_cast<float*>(smem + P.off_env);
  float* b1s = reinterpret_cast<float*>(smem + P.off_b1);
  float* b2s = reinterpret_cast<float*>(smem + P.off_b2);
  float* red = reinterpret_cast<float*>(smem + P.off_red);  // [RW][FP]
  float* dxs = reinterpret_cast<float*>(smem + P.off_dx);   // [J][FP]
  unsigned char* copy = smem + P.off_copy;                 // [IC][RS] words
  float* gs = reinterpret_cast<float*>(smem + P.off_g);     // [IC][GXS] (kStageGX)
  float* xs = reinterpret_cast<float*>(smem + P.off_x);     // [J][GXS] (kStageGX)
  const int GXS = P.GXS;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r = lane >> 2, c2 = (lane & 3) * 2;
  const int rw = warp % RW, m0 = rw * 16, n0 = (warp / RW) * 64;  // (1)-(3)
  const int m4 = (warp & 3) * (FP / 4), n4 = (warp >> 2) * (FP / 2);  // (4)
  const int n5 = warp * (FP / 8);                                    // (5)
  const int blk = blockIdx.x;
  float* dw1b = dw1_part + static_cast<size_t>(blk) * G * F;
  float* dw2b = dw2_part + static_cast<size_t>(blk) * F * F;

  for (int q = t; q < G16 * FP; q += kThreads) {
    const int gg = q / FP, f = q - gg * FP;
    w1s[gg * FS + f] = Elem<T>::from(gg < G && f < F ? w1[gg * F + f] : 0.f);
  }
  for (int q = t; q < FP * FP; q += kThreads) {
    const int k = q / FP, f = q - k * FP;
    w2s[k * FS + f] = Elem<T>::from(k < F && f < F ? w2[k * F + f] : 0.f);
  }
  for (int f = t; f < FP; f += kThreads) {
    b1s[f] = f < F ? b1[f] : 0.f;
    b2s[f] = f < F ? b2[f] : 0.f;
  }
  // partials added to in device memory start at zero (each block its own)
  if (!kRegW2)
    for (int q = t; q < F * F; q += kThreads) dw2b[q] = 0.f;
  if (!reg_w1)
    for (int q = t; q < G * F; q += kThreads) dw1b[q] = 0.f;

  float acc_w2[kRegW2 ? MT4 : 1][kRegW2 ? NT4 : 1][4];
  float acc_w1[4][kRegW2 ? NT5 : 1][4];
  zero(acc_w2);
  zero(acc_w1);
  float db1r[8][2], db2r[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) db1r[nt][e] = db2r[nt][e] = 0.f;

  // The block's tiles in order: its units blk, blk + grid, ..., each unit's
  // row chunks in order.
  const int units = B * P.tiles;
  CFCONV_CLOCK;
  const int ntiles = (units - blk + gridDim.x - 1) / gridDim.x * P.chunks;
  auto tile_at = [&](int tau, int& b, int& j0, int& i0, int& ch) {
    const int u = blk + tau / P.chunks * gridDim.x;
    ch = tau % P.chunks;
    b = u / P.tiles;
    j0 = (u - b * P.tiles) * J;
    i0 = ch * IC;
  };
  auto issue_ea = [&](int tau) {
    int b, j0, i0, ch;
    tile_at(tau, b, j0, i0, ch);
    copy_ea_rows<kBwdCopyBytes>(ea, copy, P.RS, IC, J, b, i0, j0, N, pb);
  };
  // A tile's env into envs, its g and x rows into gs / xs (16 bytes per
  // cp.async, zero-filled past N and F; F % 4 == 0: a 16-byte chunk never
  // straddles F).
  auto issue_env_gx = [&](int tau) {
    int b, j0, i0, ch;
    tile_at(tau, b, j0, i0, ch);
    for (int p = t; p < M; p += kThreads) {
      const int jj = p / IC, i = i0 + p - jj * IC, j = j0 + jj;
      const bool ok = i < N && j < N;
      cp_async4(envs + p, ok ? env + (static_cast<size_t>(b) * N + i) * N + j : env,
                ok ? 4 : 0);
    }
    if constexpr (kStageGX) {
      const int quads = FP / 4;
      for (int q = t; q < (IC + J) * quads; q += kThreads) {
        const int row = q / quads, c = (q - row * quads) * 4;
        const bool is_g = row < IC;
        const int node = is_g ? i0 + row : j0 + row - IC;
        const float* src = (is_g ? g : x) + static_cast<size_t>(b) * N * F;
        const bool ok = node < N && c < F;
        cp_async16((is_g ? gs + row * GXS : xs + (row - IC) * GXS) + c,
                   ok ? src + node * F + c : src, ok);
      }
    }
  };

  // Software pipeline: the next tile's ea copy is in flight while this tile
  // computes from eas; its env, g and x from the end of this tile's (2),
  // their only reader.
  if (ntiles > 0) {
    issue_ea(0);
    issue_env_gx(0);
  }
  for (int tau = 0; tau < ntiles; ++tau) {
    int b, j0, i0, ch;
    tile_at(tau, b, j0, i0, ch);
    const float* gb = g + static_cast<size_t>(b) * N * F;
    const float* xb = x + static_cast<size_t>(b) * N * F;
    cp_async_wait_all();
    __syncthreads();  // this tile's copies landed; the previous tile's (5) has read eas
    CFCONV_MARK(0);
    // ea from the copy (K5: the smearing, built here); row ii of the copy
    // holds column j0 + jj's pair at place jj
    fix_up_ea<M, kBwdCopyBytes>(eas, GS, copy, P.RS, ea, b, N, i0, j0, G, G16, pb,
                    [&](int p, int& ii, int& jj) {
                      jj = p / IC;
                      ii = p - jj * IC;
                      return i0 + ii < N && j0 + jj < N;
                    });
    __syncthreads();
    if (tau + 1 < ntiles) issue_ea(tau + 1);
    CFCONV_MARK(1);

    // (1) pre = ea @ W1 + b1 -> s (to shared memory), sigma (registers)
    float acc[1][8][4], sig[8][4];
    zero(acc);
    frag_gemm<1, 8, false, true>(acc, eas, GS, w1s, FS, m0, n0, G16, 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // ssp(pre), and its derivative sigmoid(pre) from the same exp, in
        // the fast intrinsics (a few f32 ulps, far inside the bars)
        const float pre = acc[0][nt][e] + b1s[n0 + nt * 8 + c2 + (e & 1)];
        const float ex = __expf(-fabsf(pre));
        sig[nt][e] = __fdividef(pre >= 0.f ? 1.f : ex, 1.f + ex);
        acc[0][nt][e] = fmaxf(pre, 0.f) + __logf(1.f + ex) - kLog2;
      }
      T* row = ss + (m0 + r) * FS + n0 + nt * 8 + c2;
      Elem<T>::store2(row, acc[0][nt][0], acc[0][nt][1]);
      Elem<T>::store2(row + 8 * FS, acc[0][nt][2], acc[0][nt][3]);
    }
    __syncthreads();
    CFCONV_MARK(2);

    // (2) wf = s @ W2 + b2 -> this warp's part of dx; dwf = (g x) env
    zero(acc);
    frag_gemm<1, 8, false, true>(acc, ss, FS, w2s, FS, m0, n0, FP, 1);
    {
      const int jj = m0 / IC, j = j0 + jj;           // the warp's rows share j
      const int i_lo = i0 + m0 + r - jj * IC, i_hi = i_lo + 8;
      const float env_lo = envs[m0 + r], env_hi = envs[m0 + r + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float dxv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + nt * 8 + c2 + e;
          float xj, g_lo, g_hi;
          if constexpr (kStageGX) {   // zero-filled past N and F
            xj = rnd(xs[jj * GXS + col], kBf16);
            g_lo = gs[(i_lo - i0) * GXS + col];
            g_hi = gs[(i_hi - i0) * GXS + col];
          } else {
            const bool fok = col < F;
            xj = j < N && fok ? rnd(xb[j * F + col], kBf16) : 0.f;
            g_lo = i_lo < N && fok ? gb[i_lo * F + col] : 0.f;
            g_hi = i_hi < N && fok ? gb[i_hi * F + col] : 0.f;
          }
          const float wf_lo = acc[0][nt][e] + b2s[col];
          const float wf_hi = acc[0][nt][2 + e] + b2s[col];
          dxv[e] = (wf_lo * env_lo) * g_lo + (wf_hi * env_hi) * g_hi;
          const float d_lo = (g_lo * xj) * env_lo, d_hi = (g_hi * xj) * env_hi;
          db2r[nt][e] += d_lo;
          db2r[nt][e] += d_hi;
          acc[0][nt][e] = d_lo;
          acc[0][nt][2 + e] = d_hi;
        }
        T* row = dwfs + (m0 + r) * FS + n0 + nt * 8 + c2;
        Elem<T>::store2(row, acc[0][nt][0], acc[0][nt][1]);
        Elem<T>::store2(row + 8 * FS, acc[0][nt][2], acc[0][nt][3]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = dxv[e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) red[rw * FP + n0 + nt * 8 + c2 + e] = v;
        }
      }
    }
    __syncthreads();
    if (tau + 1 < ntiles) issue_env_gx(tau + 1);
    CFCONV_MARK(3);

    // dx[j, f]: the row-warps of each column in order, then the chunks
    for (int q = t; q < J * FP; q += kThreads) {
      const int jj = q / FP, f = q - jj * FP;
      float v = 0.f;
      for (int k = jj * (IC / 16); k < (jj + 1) * (IC / 16); ++k) v += red[k * FP + f];
      const float tot = ch == 0 ? v : dxs[q] + v;
      dxs[q] = tot;
      const int j = j0 + jj;
      if (ch == P.chunks - 1 && j < N && f < F)
        dx[(static_cast<size_t>(b) * N + j) * F + f] = rnd(tot, kBf16);
    }

    // (4) dW2 += s^T @ dwf
    if constexpr (kRegW2) {
      frag_gemm<MT4, NT4, true, true>(acc_w2, ss, FS, dwfs, FS, m4, n4, M, MT4);
    } else {
#pragma unroll 1
      for (int mt = 0; mt < MT4; ++mt)
#pragma unroll 1
        for (int nc = 0; nc < NT4 / 8; ++nc) {
          float tmp[1][8][4];
          zero(tmp);
          frag_gemm<1, 8, true, true>(tmp, ss, FS, dwfs, FS, m4 + mt * 16, n4 + nc * 64, M, 1);
          put(tmp, dw2b, F, F, F, m4 + mt * 16, n4 + nc * 64, 1, true);
        }
    }

    CFCONV_MARK(4);
    // (3) ds = dwf @ W2^T, dpre = ds * sigma
    zero(acc);
    frag_gemm<1, 8, false, false>(acc, dwfs, FS, w2s, FS, m0, n0, FP, 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dp = acc[0][nt][e] * sig[nt][e];
        db1r[nt][e & 1] += dp;
        acc[0][nt][e] = dp;
      }
    __syncthreads();  // (4) has read s
    CFCONV_MARK(5);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      T* row = ss + (m0 + r) * FS + n0 + nt * 8 + c2;
      Elem<T>::store2(row, acc[0][nt][0], acc[0][nt][1]);
      Elem<T>::store2(row + 8 * FS, acc[0][nt][2], acc[0][nt][3]);
    }
    __syncthreads();
    CFCONV_MARK(6);

    // (5) dW1 += ea^T @ dpre
    if (reg_w1) {
      frag_gemm<4, (kRegW2 ? NT5 : 1), true, true>(acc_w1, eas, GS, ss, FS, 0, n5, M,
                                                   G16 / 16);
    } else {
#pragma unroll 1
      for (int mt = 0; mt < G16 / 16; ++mt) {
        float tmp[1][NT5][4];
        zero(tmp);
        frag_gemm<1, NT5, true, true>(tmp, eas, GS, ss, FS, mt * 16, n5, M, 1);
        put(tmp, dw1b, F, G, F, mt * 16, n5, 1, true);
      }
    }
  }

  if constexpr (kRegW2) put(acc_w2, dw2b, F, F, F, m4, n4, MT4, false);
  if (reg_w1) put(acc_w1, dw1b, F, G, F, 0, n5, G16 / 16, false);
  __syncthreads();
  block_col_sum<RW, FP>(db1r, red, db1_part + static_cast<size_t>(blk) * F, F, rw, n0);
  block_col_sum<RW, FP>(db2r, red, db2_part + static_cast<size_t>(blk) * F, F, rw, n0);
}

template <typename Src, typename T, int CW>
int launch_bwd_t(Src ea, const float* env, const float* x, const float* w1,
                 const float* b1, const float* w2, const float* b2, const float* g,
                 float* dx, float* dw1, float* db1, float* dw2, float* db2, float* part,
                 int B, int N, int G, int F, int blocks, cudaStream_t s) {
  const BwdPlan P = bwd_plan(N, G, F, sizeof(T), Src::pair_bytes(G));
  cudaError_t err = cudaFuncSetAttribute(
      cfconv_bwd_kernel<Src, T, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dw1_part = part;
  float* dw2_part = dw1_part + static_cast<size_t>(blocks) * G * F;
  float* db1_part = dw2_part + static_cast<size_t>(blocks) * F * F;
  float* db2_part = db1_part + static_cast<size_t>(blocks) * F;
  cfconv_bwd_kernel<Src, T, CW><<<blocks, kThreads, P.bytes, s>>>(
      ea, env, x, w1, b1, w2, b2, g, dx, dw1_part, db1_part, dw2_part, db2_part, B, N, G, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partials::sum_rows(dw1_part, dw1, blocks, G * F, s);
  partials::sum_rows(dw2_part, dw2, blocks, F * F, s);
  partials::sum_rows(db1_part, db1, blocks, F, s);
  partials::sum_rows(db2_part, db2, blocks, F, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename Src>
int launch_bwd(Src ea, const float* env, const float* x, const float* w1,
               const float* b1, const float* w2, const float* b2, const float* g,
               float* dx, float* dw1, float* db1, float* dw2, float* db2,
               float* part, int B, int N, int G, int F, int bf16, int blocks,
               cudaStream_t s) {
  const int fp = bwd_plan(N, G, F, bf16 ? 2 : 4, Src::pair_bytes(G)).FP;
#define CFCONV_BWD(T, CW)                                                                \
  return launch_bwd_t<Src, T, CW>(ea, env, x, w1, b1, w2, b2, g, dx, dw1, db1, dw2, db2, \
                                  part, B, N, G, F, blocks, s)
  if (bf16) {
    if (fp == 64) CFCONV_BWD(__nv_bfloat16, 1);
    if (fp == 128) CFCONV_BWD(__nv_bfloat16, 2);
    if (fp == 256) CFCONV_BWD(__nv_bfloat16, 4);
  } else {
    if (fp == 64) CFCONV_BWD(float, 1);
    if (fp == 128) CFCONV_BWD(float, 2);
  }
#undef CFCONV_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The forward's tiling and shared-memory plan (mirrored by
// moleculesde_tpu_torch/ops/cfconv.py::fwd_plan).  esz: 2 (bf16 mode) or
// 4 (f32 mode).  w_res: W1 and W2 staged in shared memory (else read from
// device memory); copy: each tile's ea source copied one tile ahead and
// fixed up, ea staged whole (GK = G16; else ea staged GK = 64 entries of G
// at a time, read straight from device memory).  FP = 0 where F > 256.
struct FwdPlan {
  int FP, M, C, R, chunks, tiles, G16, GK, GS, FS, XS, RS;
  bool w_res, copy;
  size_t off_w2, off_ea, off_s, off_x, off_env, off_b1, off_b2, off_red, off_acc, off_copy,
      bytes;
};

__host__ __device__ inline FwdPlan fwd_plan_with(int N, int G, int F, int esz, int pair_bytes,
                                                 bool w_res, bool copy) {
  FwdPlan P{};
  P.FP = F <= 64 ? 64 : (F <= 128 ? 128 : (F <= 256 ? 256 : 0));
  if (P.FP == 0) return P;
  P.M = 128 / (P.FP / 64);
  P.C = N <= 16 ? 16 : 32;
  P.R = P.M / P.C;
  P.chunks = (N + P.C - 1) / P.C;
  P.tiles = (N + P.R - 1) / P.R;
  P.G16 = (G + 15) / 16 * 16;
  P.GK = copy || P.G16 < 64 ? P.G16 : 64;
  P.w_res = w_res;
  P.copy = copy;
  const int pad = esz == 2 ? 8 : 4;  // 16 bytes per row
  P.GS = P.GK + pad;
  P.FS = P.FP + pad;
  P.XS = P.FP + 8;                   // f32 rows padded by 32 bytes
  P.RS = copy_row_words(P.C, pair_bytes, kFwdCopyBytes);
  size_t o = 0;
  if (w_res) o += align16(static_cast<size_t>(P.G16) * P.FS * esz);    // W1 [G16][FS]
  P.off_w2 = o;
  if (w_res) o += align16(static_cast<size_t>(P.FP) * P.FS * esz);     // W2 [FP][FS]
  P.off_ea = o;  o += align16(static_cast<size_t>(P.M) * P.GS * esz);    // ea [M][GS]
  P.off_s = o;   o += align16(static_cast<size_t>(P.M) * P.FS * esz);    // s [M][FS]
  P.off_x = o;   o += align16(static_cast<size_t>(P.C) * P.XS * 4);      // x [C][XS]
  P.off_env = o; o += align16(static_cast<size_t>(P.M) * 4);             // env [M]
  P.off_b1 = o;  o += align16(static_cast<size_t>(P.FP) * 4);
  P.off_b2 = o;  o += align16(static_cast<size_t>(P.FP) * 4);
  P.off_red = o; o += align16(static_cast<size_t>(P.M / 16) * P.FP * 4);  // [M/16][FP]
  P.off_acc = o; o += align16(static_cast<size_t>(P.R) * P.FP * 4);       // [R][FP]
  P.off_copy = o;                                                          // [R][RS] words
  if (copy) o += align16(static_cast<size_t>(P.R) * P.RS * 4);
  P.bytes = o;
  return P;
}

// The first plan that fits: weights resident with the ea copy (the main
// path), weights resident with ea in chunks, weights in device memory with
// the copy, then with chunks (which fits at every G and F <= 256).
__host__ __device__ inline FwdPlan fwd_plan(int N, int G, int F, int esz, int pair_bytes) {
  FwdPlan P{};
  for (int k = 0; k < 4; ++k) {
    P = fwd_plan_with(N, G, F, esz, pair_bytes, k < 2, k % 2 == 0);
    if (P.FP == 0 || P.bytes <= kSmemLimit) break;
  }
  return P;
}

// T: __nv_bfloat16 (bf16 mode, tensor cores) or float (f32 mode).  CW:
// FP = 64 CW padded features, M = 128 / CW pair rows per tile.  Two blocks
// per SM in bf16 mode: at most 128 registers a thread.
template <typename Src, typename T, int CW>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
cfconv_fwd_kernel(const Src ea, const float* __restrict__ env,
                  const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out,
                  int B, int N, int G, int F) {
  constexpr int FP = 64 * CW, M = 128 / CW, RW = M / 16;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int pb = Src::pair_bytes(G);
  const FwdPlan P = fwd_plan(N, G, F, sizeof(T), pb);
  const int C = P.C, R = P.R, G16 = P.G16, GK = P.GK, GS = P.GS, FS = P.FS, XS = P.XS;

  extern __shared__ __align__(16) float smem_f[];   // one declaration per file
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  T* w1s = reinterpret_cast<T*>(smem);                  // [G16][FS] (w_res)
  T* w2s = reinterpret_cast<T*>(smem + P.off_w2);       // [FP][FS] (w_res)
  T* eas = reinterpret_cast<T*>(smem + P.off_ea);       // [M][GS]
  T* ss = reinterpret_cast<T*>(smem + P.off_s);         // [M][FS]
  float* xs = reinterpret_cast<float*>(smem + P.off_x);     // [C][XS]
  float* envs = reinterpret_cast<float*>(smem + P.off_env);
  float* b1s = reinterpret_cast<float*>(smem + P.off_b1);
  float* b2s = reinterpret_cast<float*>(smem + P.off_b2);
  float* red = reinterpret_cast<float*>(smem + P.off_red);  // [RW][FP]
  float* accs = reinterpret_cast<float*>(smem + P.off_acc); // [R][FP]
  unsigned char* copy = smem + P.off_copy;                 // [R][RS] words (copy)

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r = lane >> 2, c2 = (lane & 3) * 2;
  const int rw = warp % RW, m0 = rw * 16, n0 = (warp / RW) * 64;
  const int jw = m0 % C;   // the warp's 16 pairs: one row i, columns jw .. jw + 15
  const int blk = blockIdx.x;

  if (P.w_res) {
    for (int q = t; q < G16 * FP; q += kThreads) {
      const int gg = q / FP, f = q - gg * FP;
      w1s[gg * FS + f] = Elem<T>::from(gg < G && f < F ? w1[gg * F + f] : 0.f);
    }
    for (int q = t; q < FP * FP; q += kThreads) {
      const int k = q / FP, f = q - k * FP;
      w2s[k * FS + f] = Elem<T>::from(k < F && f < F ? w2[k * F + f] : 0.f);
    }
  }
  for (int f = t; f < FP; f += kThreads) {
    b1s[f] = f < F ? b1[f] : 0.f;
    b2s[f] = f < F ? b2[f] : 0.f;
  }

  // The block's tiles in order: its units blk, blk + grid, ... (u = row
  // tile * B + b), each unit's column chunks in order.
  const int units = B * P.tiles;
  CFCONV_CLOCK;
  const int ntiles = (units - blk + gridDim.x - 1) / gridDim.x * P.chunks;
  auto tile_at = [&](int tau, int& b, int& i0, int& j0, int& ch) {
    const int u = blk + tau / P.chunks * gridDim.x;
    ch = tau % P.chunks;
    const int rt = u / B;
    b = u - rt * B;
    i0 = rt * R;
    j0 = ch * C;
  };
  auto issue_ea = [&](int tau) {
    int b, i0, j0, ch;
    tile_at(tau, b, i0, j0, ch);
    copy_ea_rows<kFwdCopyBytes>(ea, copy, P.RS, R, C, b, i0, j0, N, pb);
  };
  // A tile's env into envs (thread p < M its pair p, so that it can read
  // it after its own wait), the chunk's x rows into xs (16 bytes per
  // cp.async, zero-filled past N and F; F % 4 == 0).
  auto issue_env_x = [&](int tau) {
    int b, i0, j0, ch;
    tile_at(tau, b, i0, j0, ch);
    if (t < M) {
      const int row = t / C, i = i0 + row, j = j0 + t - row * C;
      const bool ok = i < N && j < N;
      cp_async4(envs + t, ok ? env + (static_cast<size_t>(b) * N + i) * N + j : env,
                ok ? 4 : 0);
    }
    const int quads = FP / 4;
    for (int q = t; q < C * quads; q += kThreads) {
      const int row = q / quads, c = (q - row * quads) * 4, j = j0 + row;
      const bool ok = j < N && c < F;
      cp_async16(xs + row * XS + c, ok ? x + (static_cast<size_t>(b) * N + j) * F + c : x, ok);
    }
  };
  // Plans without the copy: ea entries g0 .. g0 + GK - 1 of the tile's
  // pairs from device memory (zero where env == 0, past N and past G).
  auto stage_direct = [&](int b, int i0, int j0, int g0) {
    for (int q = t; q < M * GK; q += kThreads) {
      const int p = q / GK, gg = q - p * GK, g = g0 + gg;
      const int row = p / C, i = i0 + row, j = j0 + p - row * C;
      const bool ok = i < N && j < N && g < G && envs[p] != 0.f;
      eas[p * GS + gg] = Elem<T>::from(
          ok ? ea((static_cast<size_t>(b) * N + i) * N + j, g, G) : 0.f);
    }
  };

  // Software pipeline: the next tile's ea copy is in flight while this tile
  // computes; its env and x from the end of this tile's (2), their only
  // reader.
  if (ntiles > 0) {
    if (P.copy) issue_ea(0);
    issue_env_x(0);
  }
  for (int tau = 0; tau < ntiles; ++tau) {
    int b, i0, j0, ch;
    tile_at(tau, b, i0, j0, ch);
    const bool last = ch == P.chunks - 1;
    cp_async_wait_all();
    // this tile's copies landed; the previous tile has read eas, ss and red.
    // The vote: does any pair of the tile lie inside the cutoff?
    const int any = __syncthreads_or(t < M && envs[t] != 0.f);
    CFCONV_MARK(8);
    if (!any) {   // every pair adds 0: the rows' sums stand as they are
      if (tau + 1 < ntiles) {
        if (P.copy) issue_ea(tau + 1);
        issue_env_x(tau + 1);
      }
      for (int q = t; q < R * FP; q += kThreads) {
        const int row = q / FP, f = q - row * FP;
        const float tot = ch == 0 ? 0.f : accs[q];
        accs[q] = tot;
        if (last && i0 + row < N && f < F)
          out[(static_cast<size_t>(b) * N + i0 + row) * F + f] = tot;
      }
      CFCONV_COUNT(15);
      CFCONV_MARK(9);
      continue;
    }
    // the warp's 16 pairs: any inside the cutoff?
    const bool live = __any_sync(0xffffffffu, envs[m0 + (lane & 15)] != 0.f);
    if (P.copy) {
      // ea from the copy (K5: the smearing, built here); row r of the copy
      // holds row i0 + r's pairs from column j0
      fix_up_ea<M, kFwdCopyBytes>(eas, GS, copy, P.RS, ea, b, N, i0, j0, G, G16, pb,
                   [&](int p, int& row, int& jj) {
                     row = p / C;
                     jj = p - row * C;
                     return i0 + row < N && j0 + jj < N && envs[p] != 0.f;
                   });
    } else {
      stage_direct(b, i0, j0, 0);
    }
    __syncthreads();
    if (P.copy && tau + 1 < ntiles) issue_ea(tau + 1);
    CFCONV_MARK(10);

    // (1) pre = ea @ W1 + b1 -> s (to shared memory)
    float acc[1][8][4];
    zero(acc);
    for (int g0 = 0; g0 < G16; g0 += GK) {
      if (g0 > 0) {   // plans without the copy: the next GK entries of G
        __syncthreads();
        stage_direct(b, i0, j0, g0);
        __syncthreads();
      }
      const int K = min(GK, G16 - g0);
      if (live) {
        if (P.w_res)
          frag_gemm<1, 8, false, true>(acc, eas, GS, w1s + g0 * FS, FS, m0, n0, K, 1);
        else
          frag_gemm_dev(acc, eas, GS, w1, g0, G, F, m0, n0, K);
      }
    }
    if (live) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pre = acc[0][nt][e] + b1s[n0 + nt * 8 + c2 + (e & 1)];
          // bf16 mode rounds s to bf16 next: the fast intrinsics (a few f32
          // ulps) suffice there; f32 mode takes the accurate ones
          acc[0][nt][e] = kBf16 ? fmaxf(pre, 0.f) + __logf(1.f + __expf(-fabsf(pre))) - kLog2
                                : ssp(pre);
        }
        T* row = ss + (m0 + r) * FS + n0 + nt * 8 + c2;
        Elem<T>::store2(row, acc[0][nt][0], acc[0][nt][1]);
        Elem<T>::store2(row + 8 * FS, acc[0][nt][2], acc[0][nt][3]);
      }
    }
    __syncthreads();
    CFCONV_MARK(11);

    // (2) wf = s @ W2 + b2, folded at once into the warp's part of out:
    // sum over its 16 columns j of (wf + b2) env x
    if (live) {
      zero(acc);
      if (P.w_res)
        frag_gemm<1, 8, false, true>(acc, ss, FS, w2s, FS, m0, n0, FP, 1);
      else
        frag_gemm_dev(acc, ss, FS, w2, 0, F, F, m0, n0, FP);
      const float env_lo = envs[m0 + r], env_hi = envs[m0 + r + 8];
      const float* x_lo = xs + (jw + r) * XS;
      const float* x_hi = x_lo + 8 * XS;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + nt * 8 + c2 + e;
          float v = ((acc[0][nt][e] + b2s[col]) * env_lo) * rnd(x_lo[col], kBf16) +
                    ((acc[0][nt][2 + e] + b2s[col]) * env_hi) * rnd(x_hi[col], kBf16);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) red[rw * FP + col] = v;
        }
      }
    } else {
      for (int c = lane; c < 64; c += 32) red[rw * FP + n0 + c] = 0.f;
    }
    __syncthreads();
    if (tau + 1 < ntiles) issue_env_x(tau + 1);
    CFCONV_MARK(12);

    // out[b, i, :]: the row-warps of each row in order, then the chunks
    for (int q = t; q < R * FP; q += kThreads) {
      const int row = q / FP, f = q - row * FP;
      float v = 0.f;
      for (int k = row * (C / 16); k < (row + 1) * (C / 16); ++k) v += red[k * FP + f];
      const float tot = ch == 0 ? v : accs[q] + v;
      accs[q] = tot;
      if (last && i0 + row < N && f < F)
        out[(static_cast<size_t>(b) * N + i0 + row) * F + f] = tot;
    }
    CFCONV_MARK(13);
  }
}

template <typename Src, typename T, int CW>
int launch_fwd_t(Src ea, const float* env, const float* x, const float* w1, const float* b1,
                 const float* w2, const float* b2, float* out, int B, int N, int G, int F,
                 int sms, cudaStream_t s) {
  const FwdPlan P = fwd_plan(N, G, F, sizeof(T), Src::pair_bytes(G));
  if (P.bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = cfconv_fwd_kernel<Src, T, CW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: as many as are resident at once on the ``sms`` SMs,
  // at most one per unit.  The residency query runs once per instantiation
  // and shared-memory size, kept as bytes << 32 | blocks per SM.
  static std::atomic<unsigned long long> resident_for{0};
  unsigned long long known = resident_for.load(std::memory_order_relaxed);
  int per_sm = static_cast<int>(known & 0xffffffffull);
  if ((known >> 32) != P.bytes) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, P.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = per_sm > 0 ? per_sm : 1;
    resident_for.store(static_cast<unsigned long long>(P.bytes) << 32 | per_sm,
                       std::memory_order_relaxed);
  }
  const long long units = static_cast<long long>(B) * P.tiles;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(units < resident ? units : resident);
  kernel<<<blocks, kThreads, P.bytes, s>>>(ea, env, x, w1, b1, w2, b2, out, B, N, G, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename Src>
int launch_fwd(Src ea, const float* env, const float* x, const float* w1, const float* b1,
               const float* w2, const float* b2, float* out, int B, int N, int G, int F,
               int bf16, int sms, cudaStream_t s) {
  const int fp = fwd_plan(N, G, F, bf16 ? 2 : 4, Src::pair_bytes(G)).FP;
#define CFCONV_FWD(T, CW) \
  return launch_fwd_t<Src, T, CW>(ea, env, x, w1, b1, w2, b2, out, B, N, G, F, sms, s)
  if (bf16) {
    if (fp == 64) CFCONV_FWD(__nv_bfloat16, 1);
    if (fp == 128) CFCONV_FWD(__nv_bfloat16, 2);
    if (fp == 256) CFCONV_FWD(__nv_bfloat16, 4);
  } else {
    if (fp == 64) CFCONV_FWD(float, 1);
    if (fp == 128) CFCONV_FWD(float, 2);
    if (fp == 256) CFCONV_FWD(float, 4);
  }
#undef CFCONV_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The forward's plan for the wrapper (ops/cfconv.py::fwd_plan mirrors it),
// ``pair_bytes`` as in cfconv_bwd_plan: out[0..9] = FP, M, C, R, chunks,
// row tiles per graph, G16, GK, w_res, copy; returns the shared-memory
// bytes, or -1 where F > 256.
extern "C" long long cfconv_fwd_plan(int N, int G, int F, int bf16, int pair_bytes, int* out) {
  const FwdPlan P = fwd_plan(N, G, F, bf16 ? 2 : 4, pair_bytes);
  if (P.FP == 0) return -1;
  const int v[10] = {P.FP, P.M, P.C, P.R, P.chunks, P.tiles, P.G16, P.GK, P.w_res, P.copy};
  for (int k = 0; k < 10; ++k) out[k] = v[k];
  return static_cast<long long>(P.bytes);
}

// The backward's plan for the wrapper (ops/cfconv.py::bwd_plan mirrors it),
// ``pair_bytes`` the bytes of one pair's ea source (2 G or 4 G for K2's bf16
// or f32 ea, 4 for K5's distance): out[0..6] = FP, M, IC, J, chunks, column
// tiles per graph, G16; returns the shared-memory bytes, or -1 where F > 256.
extern "C" long long cfconv_bwd_plan(int N, int G, int F, int bf16, int pair_bytes, int* out) {
  const BwdPlan P = bwd_plan(N, G, F, bf16 ? 2 : 4, pair_bytes);
  if (P.FP == 0) return -1;
  const int v[7] = {P.FP, P.M, P.IC, P.J, P.chunks, P.tiles, P.G16};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return static_cast<long long>(P.bytes);
}

// out [B, N, F]; ea is bf16 if ea_bf16 != 0, else f32; ``sms`` the card's
// SM count.  Needs F % 4 == 0, F <= 256 and the plan's shared memory within
// the limit.
extern "C" int cfconv_fwd(const void* ea, const float* env, const float* x,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, float* out, int B, int N, int G,
                          int F, int ea_bf16, int bf16, int sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t pairs = static_cast<size_t>(B) * N * N;
  if (ea_bf16)
    return launch_fwd(EaRead<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(ea),
                                            pairs * G * sizeof(__nv_bfloat16)},
                      env, x, w1, b1, w2, b2, out, B, N, G, F, bf16, sms, s);
  return launch_fwd(EaRead<float>{static_cast<const float*>(ea), pairs * G * sizeof(float)},
                    env, x, w1, b1, w2, b2, out, B, N, G, F, bf16, sms, s);
}

// dx [B, N, F], dw1 [G, F], db1 [F], dw2 [F, F], db2 [F]; ea as in
// cfconv_fwd; ``blocks`` persistent blocks (at most the units, B * column
// tiles); part is caller-allocated scratch of blocks * (G * F + F * F + 2 * F)
// floats.  Needs F <= 256 and the plan's shared memory within the limit.
extern "C" int cfconv_bwd(const void* ea, const float* env, const float* x,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* g, float* dx,
                          float* dw1, float* db1, float* dw2, float* db2,
                          float* part, int B, int N, int G, int F, int ea_bf16,
                          int bf16, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t pairs = static_cast<size_t>(B) * N * N;
  if (ea_bf16)
    return launch_bwd(EaRead<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(ea),
                                            pairs * G * sizeof(__nv_bfloat16)},
                      env, x, w1, b1, w2, b2, g, dx, dw1, db1, dw2, db2, part, B, N,
                      G, F, bf16, blocks, s);
  return launch_bwd(EaRead<float>{static_cast<const float*>(ea), pairs * G * sizeof(float)},
                    env, x, w1, b1, w2, b2, g, dx, dw1, db1, dw2, db2, part, B, N, G, F,
                    bf16, blocks, s);
}

// K5: cfconv_fwd / cfconv_bwd with ea built in-kernel from dist [B, N, N]
// f32 (EaSmear); start, step = (stop - start) / (G - 1) and coeff =
// -0.5 / step^2 come from the wrapper as f32.
extern "C" int cfconv_rbf_fwd(const float* dist, const float* env, const float* x,
                              const float* w1, const float* b1, const float* w2,
                              const float* b2, float* out, int B, int N, int G, int F,
                              float start, float step, float coeff, int bf16, int sms,
                              void* stream) {
  const size_t pairs = static_cast<size_t>(B) * N * N;
  return launch_fwd(EaSmear{dist, start, step, coeff, pairs * sizeof(float)}, env, x, w1, b1,
                    w2, b2, out, B, N, G, F, bf16, sms, static_cast<cudaStream_t>(stream));
}

extern "C" int cfconv_rbf_bwd(const float* dist, const float* env, const float* x,
                              const float* w1, const float* b1, const float* w2,
                              const float* b2, const float* g, float* dx,
                              float* dw1, float* db1, float* dw2, float* db2,
                              float* part, int B, int N, int G, int F, float start,
                              float step, float coeff, int bf16, int blocks,
                              void* stream) {
  const size_t pairs = static_cast<size_t>(B) * N * N;
  return launch_bwd(EaSmear{dist, start, step, coeff, pairs * sizeof(float)}, env, x, w1, b1,
                    w2, b2, g, dx, dw1, db1, dw2, db2, part, B, N, G, F, bf16, blocks,
                    static_cast<cudaStream_t>(stream));
}

#ifdef CFCONV_PROFILE
// The phase clocks (benchmarks/profile_cfconv.py): read, and reset to zero.
extern "C" int cfconv_phase_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_cfconv_phase, sizeof(g_cfconv_phase)));
}
extern "C" int cfconv_phase_reset() {
  static unsigned long long zeros[kProfileBlocks * 16];
  return static_cast<int>(cudaMemcpyToSymbol(g_cfconv_phase, zeros, sizeof(zeros)));
}
#endif
