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
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8): bf16 mode at
// FP = 128 (the main path) 255 registers and 140-152 B of spill stores per
// thread (72 B stack); FP = 64 255 and 176-184 B; FP = 256 216-220 and none.
// f32 mode: FP = 128 255 and 16-20 B; FP = 64 225-231 and none.  The dW1 /
// dW2 accumulators take 96 of them, so a block of 8 warps fills an SM.
//
// FORWARD (cfconv_fwd_kernel): grid (B, N / RG); RG row groups of F
// threads, one group per output row i, one thread per feature f.  w1 and w2
// (90 KB at G=51, F=128) are staged in shared memory once per block; the
// columns j are walked in chunks of at most kFwdChunk, each staging its x
// rows (shared by the groups) and each group's ea [chunk, G] and env.
// Phase 1: thread f forms pre / s for every j of the chunk (ea reads are
// broadcasts) into a shared [chunk, F] tile.  Phase 2: thread f forms wf for
// 8 rows j at a time in registers (float4 broadcast reads of s, one w2 read
// per 8 FMAs) and folds each into its running sum over j, in order.  Shared
// memory does not grow with N.  On the CUDA cores: its bound is the f32
// rate (>= 0.09 ms at B=128, N=32); its tensor-core redesign is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "partials.cuh"

namespace {

constexpr float kLog2 = 0.693147180559945309f;
constexpr int kTile = 8;       // forward: rows per register tile
constexpr int kFwdChunk = 32;  // forward: columns j per staged chunk

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
// The forward reads them with operator(); the backward copies each pair's
// source bytes (``pair_bytes(G)`` from ``src``, ``bytes`` in all) to shared
// memory and reads them there with from_copy.
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

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename Src>
__global__ void cfconv_fwd_kernel(const Src ea,
                                  const float* __restrict__ env,
                                  const float* __restrict__ x,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ b1,
                                  const float* __restrict__ w2,
                                  const float* __restrict__ b2,
                                  float* __restrict__ out,
                                  int N, int G, int F, int RG, int bf16) {
  extern __shared__ __align__(16) float smem[];
  const int CH = N < kFwdChunk ? N : kFwdChunk;
  const int per_group = align4(CH * G) + align4(CH) + CH * F;
  float* w1s = smem;            // [G][F]
  float* w2s = w1s + G * F;     // [F][F]
  float* xs = w2s + F * F;      // [CH][F]: x[b, chunk, :]
  const int t = threadIdx.x;
  const int r = t / F;
  const int f = t - r * F;
  float* eas = xs + CH * F + r * per_group;  // [CH][G]: ea[b, i, chunk, :]
  float* envs = eas + align4(CH * G);        // [CH]
  float* ss = envs + align4(CH);             // [CH][F]

  const int b = blockIdx.x;
  const int i = blockIdx.y * RG + r;
  const bool row_ok = i < N;
  const int nthr = blockDim.x;

  for (int q = t; q < G * F; q += nthr) w1s[q] = rnd(w1[q], bf16);
  for (int q = t; q < F * F; q += nthr) w2s[q] = rnd(w2[q], bf16);
  const float* xb = x + static_cast<size_t>(b) * N * F;
  const size_t row = (static_cast<size_t>(b) * N + (row_ok ? i : 0)) * N;
  const float* envb = env + row;
  const float b1f = b1[f], b2f = b2[f];
  float out_acc = 0.f;

  for (int jc = 0; jc < N; jc += CH) {
    const int nch = N - jc < CH ? N - jc : CH;
    __syncthreads();  // the previous chunk's tiles fully consumed
    for (int q = t; q < nch * F; q += nthr) xs[q] = rnd(xb[jc * F + q], bf16);
    for (int q = f; q < nch * G; q += F) {
      const int j = q / G;
      eas[q] = row_ok ? rnd(ea(row + jc + j, q - j * G, G), bf16) : 0.f;
    }
    for (int q = f; q < nch; q += F) envs[q] = row_ok ? envb[jc + q] : 0.f;
    __syncthreads();

    for (int j = 0; j < nch; ++j) {
      const float* er = eas + j * G;
      float pre = 0.f;
      for (int g = 0; g < G; ++g) pre = fmaf(er[g], w1s[g * F + f], pre);
      ss[j * F + f] = rnd(ssp(pre + b1f), bf16);
    }
    __syncthreads();

    if (row_ok) {
      for (int j0 = 0; j0 < nch; j0 += kTile) {
        float acc[kTile];
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) acc[jj] = 0.f;
        for (int k = 0; k < F; k += 4) {
          const float wa = w2s[(k + 0) * F + f], wb = w2s[(k + 1) * F + f];
          const float wc = w2s[(k + 2) * F + f], wd = w2s[(k + 3) * F + f];
#pragma unroll
          for (int jj = 0; jj < kTile; ++jj) {
            const int j = min(j0 + jj, nch - 1);
            const float4 sv = *reinterpret_cast<const float4*>(ss + j * F + k);
            acc[jj] = fmaf(sv.x, wa, acc[jj]);
            acc[jj] = fmaf(sv.y, wb, acc[jj]);
            acc[jj] = fmaf(sv.z, wc, acc[jj]);
            acc[jj] = fmaf(sv.w, wd, acc[jj]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          const int j = j0 + jj;
          if (j < nch) out_acc += ((acc[jj] + b2f) * envs[j]) * xs[j * F + f];
        }
      }
    }
  }
  if (row_ok) out[(static_cast<size_t>(b) * N + i) * F + f] = out_acc;
}

size_t fwd_smem(int N, int G, int F, int RG) {
  const int CH = N < kFwdChunk ? N : kFwdChunk;
  return (static_cast<size_t>(G) * F + static_cast<size_t>(F) * F +
          static_cast<size_t>(CH) * F +
          static_cast<size_t>(RG) * (align4(CH * G) + align4(CH) + CH * F)) *
         sizeof(float);
}

template <typename Src>
int launch_fwd(Src ea, const float* env, const float* x, const float* w1,
               const float* b1, const float* w2, const float* b2, float* out,
               int B, int N, int G, int F, int RG, int bf16, cudaStream_t s) {
  const size_t smem = fwd_smem(N, G, F, RG);
  cudaError_t err = cudaFuncSetAttribute(
      cfconv_fwd_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (N + RG - 1) / RG);
  cfconv_fwd_kernel<Src><<<grid, RG * F, smem, s>>>(ea, env, x, w1, b1, w2, b2, out,
                                                    N, G, F, RG, bf16);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward: tile plan, fragment products, kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

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
  P.RS = (P.J * pair_bytes + 3) / 4 + 1;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// 16 bytes from device to shared memory, asynchronously; zero-filled where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes, asynchronously; only the first ``valid`` of them read, the rest
// zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
  const int ntiles = (units - blk + gridDim.x - 1) / gridDim.x * P.chunks;
  auto tile_at = [&](int tau, int& b, int& j0, int& i0, int& ch) {
    const int u = blk + tau / P.chunks * gridDim.x;
    ch = tau % P.chunks;
    b = u / P.tiles;
    j0 = (u - b * P.tiles) * J;
    i0 = ch * IC;
  };
  // Byte offset of pair (b, i, j0)'s source.
  auto pair_at = [&](int b, int i, int j0) -> size_t {
    return ((static_cast<size_t>(b) * N + i) * N + j0) * pb;
  };
  // A tile's ea source bytes into copy, 4-byte words by cp.async (the row
  // of an odd G in bf16 starts mid-word, so 16-byte copies cannot be
  // aligned), the last word of the tensor read only as far as it goes.
  auto issue_ea = [&](int tau) {
    int b, j0, i0, ch;
    tile_at(tau, b, j0, i0, ch);
    const int nbytes = min(J, N - j0) * pb;
    for (int ii = warp; ii < IC && i0 + ii < N; ii += kWarps) {   // warp w: rows w, w + 8, ...
      const size_t start = pair_at(b, i0 + ii, j0);
      const int words = (static_cast<int>(start % 4) + nbytes + 3) / 4;
      for (int w = lane; w < words; w += 32) {
        const size_t off = (start / 4 + w) * 4;
        cp_async4(copy + (ii * P.RS + w) * 4, ea.src() + off,
                  off + 4 <= ea.bytes ? 4 : static_cast<int>(ea.bytes - off));
      }
    }
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
    // ea from the copy: warp w takes pairs p = w, w + 8, ..., lane l the
    // entries l, l + 32, ... of each (K5: the smearing, built here)
    for (int g0 = 0; g0 < G16; g0 += 64) {
#pragma unroll
      for (int k = 0; k < M / kWarps; ++k) {
        const int p = warp + kWarps * k;
        const int jj = p / IC, ii = p - jj * IC, i = i0 + ii, j = j0 + jj;
        // the row's first byte sits at offset start % 4 of its copy (32-bit
        // arithmetic keeps the low bits of the 64-bit offset)
        const unsigned un = static_cast<unsigned>(N);
        const unsigned shift =
            ((static_cast<unsigned>(b) * un + i) * un + j0) * static_cast<unsigned>(pb) % 4u;
        const unsigned char* pair = copy + ii * P.RS * 4 + shift + jj * pb;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gg = g0 + lane + 32 * h;
          if (gg < G16)
            eas[p * GS + gg] =
                Elem<T>::from(i < N && j < N && gg < G ? ea.from_copy(pair, gg) : 0.f);
        }
      }
    }
    __syncthreads();
    if (tau + 1 < ntiles) issue_ea(tau + 1);

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
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      T* row = ss + (m0 + r) * FS + n0 + nt * 8 + c2;
      Elem<T>::store2(row, acc[0][nt][0], acc[0][nt][1]);
      Elem<T>::store2(row + 8 * FS, acc[0][nt][2], acc[0][nt][3]);
    }
    __syncthreads();

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

}  // namespace

// Shared memory each launch needs, for the wrapper's checks (K5's launches
// stage the same tiles as K2's and need the same).
extern "C" long long cfconv_fwd_smem(int N, int G, int F, int RG) {
  return static_cast<long long>(fwd_smem(N, G, F, RG));
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

// out [B, N, F]; ea is bf16 if ea_bf16 != 0, else f32.  Needs F % 4 == 0
// and RG * F <= 1024.
extern "C" int cfconv_fwd(const void* ea, const float* env, const float* x,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, float* out, int B, int N, int G,
                          int F, int RG, int ea_bf16, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ea_bf16)
    return launch_fwd(EaRead<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(ea), 0},
                      env, x, w1, b1, w2, b2, out, B, N, G, F, RG, bf16, s);
  return launch_fwd(EaRead<float>{static_cast<const float*>(ea), 0}, env, x, w1, b1,
                    w2, b2, out, B, N, G, F, RG, bf16, s);
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
                              const float* b2, float* out, int B, int N, int G,
                              int F, int RG, float start, float step, float coeff,
                              int bf16, void* stream) {
  return launch_fwd(EaSmear{dist, start, step, coeff, 0}, env, x, w1, b1, w2, b2, out,
                    B, N, G, F, RG, bf16, static_cast<cudaStream_t>(stream));
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
