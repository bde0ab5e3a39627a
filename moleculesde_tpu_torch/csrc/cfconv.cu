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
// in bf16 mode.  The [B, N, N, G] slab never exists in device memory: the
// kernels read 4 bytes per pair where K2 reads 2G (bf16) and pay N*G / F
// expf per thread per row (forward) or per column (backward) instead.
//
// bf16 != 0 reproduces the TPU kernel's bf16 mode: ea, x, w1, w2 and s are
// rounded to bf16 before the products, which accumulate in f32; the biases,
// softplus, envelope and the aggregation stay f32.  In the backward, dwf =
// (g * x) * env and dpre are rounded to bf16 for the weight products, dx is
// returned rounded to bf16 (x's dtype there), and db1 / db2 sum unrounded.
//
// Bound: arithmetic.  Per (i, j) pair the forward does 2*G*F + 2*F*F flops
// (6.1 GFLOP at B=128, N=32, G=51, F=128) and the backward about three
// times that; on the CUDA cores at 67 TFLOP/s that is >= 0.09 ms and
// >= 0.27 ms, against ~6 us and ~18 us on the bf16 tensor cores (later
// work: wgmma).  The compulsory traffic (ea read once, 13 MB in bf16, as
// the pretraining step hands it over) is ~4 us.
//
// Forward design: grid (B, N / RG); RG row groups of F threads, one group
// per output row i, one thread per feature f.  w1 and w2 (90 KB at G=51,
// F=128) and the graph's x rows are staged in shared memory once per block
// and shared by the groups; each group stages its row's ea [N, G].  Phase 1:
// thread f forms pre / s for every j of its row (ea reads are broadcasts)
// into a shared [N, F] tile.  Phase 2: thread f forms wf for 8 rows j at a
// time in registers (float4 broadcast reads of s, one w2 read per 8 FMAs)
// and folds each into its running sum over j.
//
// Backward design: one block per graph of S row groups (S = 4 at F=128)
// of F threads, one thread per (group, feature), looping over the columns
// j; every sum has a fixed order, there are no atomics.  For column j:
// stage ea[:, j, :] and env[:, j]; (A) thread f of group q recomputes
// pre / s for rows i = q, q + S, ... and keeps s and softplus' =
// exp(pre - s - log 2); (B) it forms wf[i, j, f] for its row tiles (8 rows
// in registers), sums wf * env * g[i, f] -- the groups' parts of dx[j, f]
// are then added in group order, and the block owns column j, so dx needs
// no cross-block sum -- and writes dwf = (g * x) * env to a shared tile;
// (C) thread k forms ds[i, k] = sum_f dwf[i, f] * w2[k, f] for its rows (w2
// padded to F + 1 columns so a warp's 32 rows k hit 32 banks), dpre = ds *
// softplus'; (C') thread f adds sum_i s[i, k] * dwf[i, f] into its column
// of a shared dw2 tile for its group's k tiles; (D) thread k adds sum_i
// ea[i, g] * dpre[i, k] into its column of the graph's dw1 partial in
// device memory for its group's rows g.  The weight gradients are
// batch-wide: each block writes its graph's partials and a second launch
// adds the B partials in graph order (partials.cuh).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "partials.cuh"

namespace {

constexpr float kLog2 = 0.693147180559945309f;
constexpr int kTile = 8;  // rows per register tile

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

// Where a block's ea values come from; ``pair`` is (b * N + i) * N + j.
// EaRead: the smeared distances ea [B, N, N, G] in device memory (K2).
template <typename EA>
struct EaRead {
  const EA* ea;
  __device__ __forceinline__ float operator()(size_t pair, int g, int G) const {
    return load(ea + pair * G + g);
  }
};

// EaSmear: built from the raw distances dist [B, N, N] (K5), as _smear:
// offset = float(g) * step + start, exp((coeff * diff) * diff), every op
// rounded to f32 on its own (the _rn intrinsics keep nvcc from fusing them).
struct EaSmear {
  const float* dist;
  float start, step, coeff;
  __device__ __forceinline__ float operator()(size_t pair, int g, int) const {
    const float offset = __fadd_rn(__fmul_rn(static_cast<float>(g), step), start);
    const float diff = __fsub_rn(__ldg(dist + pair), offset);
    return expf(__fmul_rn(__fmul_rn(coeff, diff), diff));
  }
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

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
  const int per_group = align4(N * G) + align4(N) + N * F;
  float* w1s = smem;            // [G][F]
  float* w2s = w1s + G * F;     // [F][F]
  float* xs = w2s + F * F;      // [N][F]
  const int t = threadIdx.x;
  const int r = t / F;
  const int f = t - r * F;
  float* eas = xs + N * F + r * per_group;  // [N][G]: ea[b, i, :, :]
  float* envs = eas + align4(N * G);        // [N]
  float* ss = envs + align4(N);             // [N][F]

  const int b = blockIdx.x;
  const int i = blockIdx.y * RG + r;
  const bool row_ok = i < N;
  const int nthr = blockDim.x;

  for (int q = t; q < G * F; q += nthr) w1s[q] = rnd(w1[q], bf16);
  for (int q = t; q < F * F; q += nthr) w2s[q] = rnd(w2[q], bf16);
  const float* xb = x + static_cast<size_t>(b) * N * F;
  for (int q = t; q < N * F; q += nthr) xs[q] = rnd(xb[q], bf16);
  const size_t row = (static_cast<size_t>(b) * N + (row_ok ? i : 0)) * N;
  for (int q = f; q < N * G; q += F) {
    const int j = q / G;
    eas[q] = row_ok ? rnd(ea(row + j, q - j * G, G), bf16) : 0.f;
  }
  const float* envb = env + (static_cast<size_t>(b) * N + (row_ok ? i : 0)) * N;
  for (int q = f; q < N; q += F) envs[q] = row_ok ? envb[q] : 0.f;
  __syncthreads();

  const float b1f = b1[f];
  for (int j = 0; j < N; ++j) {
    const float* er = eas + j * G;
    float pre = 0.f;
    for (int g = 0; g < G; ++g) pre = fmaf(er[g], w1s[g * F + f], pre);
    ss[j * F + f] = rnd(ssp(pre + b1f), bf16);
  }
  __syncthreads();
  if (!row_ok) return;  // no barrier below this point

  const float b2f = b2[f];
  float out_acc = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    float acc[kTile];
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) acc[jj] = 0.f;
    for (int k = 0; k < F; k += 4) {
      const float wa = w2s[(k + 0) * F + f], wb = w2s[(k + 1) * F + f];
      const float wc = w2s[(k + 2) * F + f], wd = w2s[(k + 3) * F + f];
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        const int j = min(j0 + jj, N - 1);
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
      if (j < N) out_acc += ((acc[jj] + b2f) * envs[j]) * xs[j * F + f];
    }
  }
  out[(static_cast<size_t>(b) * N + i) * F + f] = out_acc;
}

template <typename Src>
__global__ void cfconv_bwd_kernel(const Src ea,
                                  const float* __restrict__ env,
                                  const float* __restrict__ x,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ b1,
                                  const float* __restrict__ w2,
                                  const float* __restrict__ b2,
                                  const float* __restrict__ g,
                                  float* __restrict__ dx,
                                  float* __restrict__ dw1_part,  // [B, G, F]
                                  float* __restrict__ db1_part,  // [B, F]
                                  float* __restrict__ dw2_part,  // [B, F, F]
                                  float* __restrict__ db2_part,  // [B, F]
                                  int N, int G, int F, int S, int bf16) {
  extern __shared__ __align__(16) float smem[];
  const int FP = F + 1;
  float* w2s = smem;                     // [F][F + 1]
  float* dw2s = w2s + F * FP;            // [F][F]
  float* eas = dw2s + F * F;             // [N][G]: ea[b, :, j, :]
  float* envs = eas + align4(N * G);     // [N]
  float* ss = envs + align4(N);          // [N][F]: s (bf16-rounded in bf16 mode)
  float* sig = ss + N * F;               // [N][F]: softplus', then dpre
  float* dwf = sig + N * F;              // [N][F]
  float* red = dwf + N * F;              // [2][S][F]: per-group partial sums

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int sg = t / F;       // row group: rows i = sg, sg + S, ... (tiles alike)
  const int f = t - sg * F;   // feature; also the role k of phases C and D
  const int nthr = blockDim.x;
  const size_t nn = static_cast<size_t>(N) * N;
  const float* gb = g + static_cast<size_t>(b) * N * F;
  const float* xb = x + static_cast<size_t>(b) * N * F;
  float* dw1b = dw1_part + static_cast<size_t>(b) * G * F;

  for (int q = t; q < F * F; q += nthr) {
    const int k = q / F, c = q - k * F;
    w2s[k * FP + c] = rnd(w2[q], bf16);
    dw2s[q] = 0.f;
  }
  for (int gg = sg; gg < G; gg += S) dw1b[gg * F + f] = 0.f;
  const float b1f = b1[f], b2f = b2[f];
  float db1_acc = 0.f, db2_acc = 0.f;

  for (int j = 0; j < N; ++j) {
    __syncthreads();  // previous column's tiles fully consumed
    for (int q = t; q < N * G; q += nthr) {
      const int i = q / G, gg = q - i * G;
      eas[q] = rnd(ea((static_cast<size_t>(b) * N + i) * N + j, gg, G), bf16);
    }
    for (int i = t; i < N; i += nthr) envs[i] = env[static_cast<size_t>(b) * nn + i * N + j];
    __syncthreads();

    // (A) pre, s, softplus' for this group's rows i of column j
    for (int i = sg; i < N; i += S) {
      const float* er = eas + i * G;
      float pre = 0.f;
      for (int gg = 0; gg < G; ++gg)
        pre = fmaf(er[gg], rnd(__ldg(w1 + gg * F + f), bf16), pre);
      pre += b1f;
      const float sv = ssp(pre);
      ss[i * F + f] = rnd(sv, bf16);
      sig[i * F + f] = expf(pre - sv - kLog2);
    }
    __syncthreads();

    // (B) wf, this group's part of dx[j, f], dwf
    const float xj = rnd(xb[j * F + f], bf16);
    float dx_acc = 0.f;
    for (int i0 = sg * kTile; i0 < N; i0 += S * kTile) {
      float acc[kTile];
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) acc[ii] = 0.f;
      for (int k = 0; k < F; k += 4) {
        const float wa = w2s[(k + 0) * FP + f], wb = w2s[(k + 1) * FP + f];
        const float wc = w2s[(k + 2) * FP + f], wd = w2s[(k + 3) * FP + f];
#pragma unroll
        for (int ii = 0; ii < kTile; ++ii) {
          const int i = min(i0 + ii, N - 1);
          const float4 sv = *reinterpret_cast<const float4*>(ss + i * F + k);
          acc[ii] = fmaf(sv.x, wa, acc[ii]);
          acc[ii] = fmaf(sv.y, wb, acc[ii]);
          acc[ii] = fmaf(sv.z, wc, acc[ii]);
          acc[ii] = fmaf(sv.w, wd, acc[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
        const int i = i0 + ii;
        if (i < N) {
          const float gi = gb[i * F + f];
          dx_acc += ((acc[ii] + b2f) * envs[i]) * gi;
          const float d = (gi * xj) * envs[i];
          db2_acc += d;
          dwf[i * F + f] = rnd(d, bf16);
        }
      }
    }
    red[sg * F + f] = dx_acc;
    __syncthreads();
    if (sg == 0) {  // the groups' parts of dx[j, f], in group order
      float v = 0.f;
      for (int q = 0; q < S; ++q) v += red[q * F + f];
      dx[(static_cast<size_t>(b) * N + j) * F + f] = rnd(v, bf16);
    }

    // (C) ds = dwf @ w2^T, dpre = ds * softplus' (thread k = f, own cells)
    for (int i0 = sg * kTile; i0 < N; i0 += S * kTile) {
      float acc[kTile];
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) acc[ii] = 0.f;
      for (int c = 0; c < F; c += 4) {
        const float wa = w2s[f * FP + c + 0], wb = w2s[f * FP + c + 1];
        const float wc = w2s[f * FP + c + 2], wd = w2s[f * FP + c + 3];
#pragma unroll
        for (int ii = 0; ii < kTile; ++ii) {
          const int i = min(i0 + ii, N - 1);
          const float4 dv = *reinterpret_cast<const float4*>(dwf + i * F + c);
          acc[ii] = fmaf(dv.x, wa, acc[ii]);
          acc[ii] = fmaf(dv.y, wb, acc[ii]);
          acc[ii] = fmaf(dv.z, wc, acc[ii]);
          acc[ii] = fmaf(dv.w, wd, acc[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
        const int i = i0 + ii;
        if (i < N) {
          const float dpre = acc[ii] * sig[i * F + f];
          db1_acc += dpre;
          sig[i * F + f] = rnd(dpre, bf16);
        }
      }
    }

    // (C') dw2[k, f] += sum_i s[i, k] * dwf[i, f], this group's k tiles
    for (int k0 = sg * kTile; k0 < F; k0 += S * kTile) {
      float acc[kTile];
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk) acc[kk] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float d = dwf[i * F + f];
        const float* sr = ss + i * F + k0;
#pragma unroll
        for (int kk = 0; kk < kTile; ++kk)
          if (k0 + kk < F) acc[kk] = fmaf(sr[kk], d, acc[kk]);
      }
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk)
        if (k0 + kk < F) dw2s[(k0 + kk) * F + f] += acc[kk];
    }
    __syncthreads();  // every group's dpre rows written

    // (D) dw1[g, k] += sum_i ea[i, g] * dpre[i, k], this group's rows g
    for (int gg = sg; gg < G; gg += S) {
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc = fmaf(eas[i * G + gg], sig[i * F + f], acc);
      dw1b[gg * F + f] += acc;
    }
  }

  red[sg * F + f] = db1_acc;
  red[(S + sg) * F + f] = db2_acc;
  __syncthreads();
  float* dw2b = dw2_part + static_cast<size_t>(b) * F * F;
  for (int q = t; q < F * F; q += nthr) dw2b[q] = dw2s[q];
  if (sg == 0) {  // the groups' parts of db1 / db2, in group order
    float v1 = 0.f, v2 = 0.f;
    for (int q = 0; q < S; ++q) {
      v1 += red[q * F + f];
      v2 += red[(S + q) * F + f];
    }
    db1_part[static_cast<size_t>(b) * F + f] = v1;
    db2_part[static_cast<size_t>(b) * F + f] = v2;
  }
}

// row groups of the backward: as many as fit 1024 threads, at most 4
int bwd_groups(int F) { return F >= 1024 ? 1 : (1024 / F < 4 ? 1024 / F : 4); }

size_t fwd_smem(int N, int G, int F, int RG) {
  return (static_cast<size_t>(G) * F + static_cast<size_t>(F) * F +
          static_cast<size_t>(N) * F +
          static_cast<size_t>(RG) * (align4(N * G) + align4(N) + N * F)) *
         sizeof(float);
}

size_t bwd_smem(int N, int G, int F) {
  return (static_cast<size_t>(F) * (F + 1) + static_cast<size_t>(F) * F +
          align4(N * G) + align4(N) + 3 * static_cast<size_t>(N) * F +
          2 * static_cast<size_t>(bwd_groups(F)) * F) *
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

template <typename Src>
int launch_bwd(Src ea, const float* env, const float* x, const float* w1,
               const float* b1, const float* w2, const float* b2, const float* g,
               float* dx, float* dw1, float* db1, float* dw2, float* db2,
               float* part, int B, int N, int G, int F, int bf16, cudaStream_t s) {
  const size_t smem = bwd_smem(N, G, F);
  cudaError_t err = cudaFuncSetAttribute(
      cfconv_bwd_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dw1_part = part;
  float* dw2_part = dw1_part + static_cast<size_t>(B) * G * F;
  float* db1_part = dw2_part + static_cast<size_t>(B) * F * F;
  float* db2_part = db1_part + static_cast<size_t>(B) * F;
  const int S = bwd_groups(F);
  cfconv_bwd_kernel<Src><<<B, S * F, smem, s>>>(ea, env, x, w1, b1, w2, b2, g, dx,
                                                dw1_part, db1_part, dw2_part,
                                                db2_part, N, G, F, S, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partials::sum_rows(dw1_part, dw1, B, G * F, s);
  partials::sum_rows(dw2_part, dw2, B, F * F, s);
  partials::sum_rows(db1_part, db1, B, F, s);
  partials::sum_rows(db2_part, db2, B, F, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory each launch needs, for the wrapper's checks (K5's launches
// stage the same tiles as K2's and need the same).
extern "C" long long cfconv_fwd_smem(int N, int G, int F, int RG) {
  return static_cast<long long>(fwd_smem(N, G, F, RG));
}

extern "C" long long cfconv_bwd_smem(int N, int G, int F) {
  return static_cast<long long>(bwd_smem(N, G, F));
}

// out [B, N, F]; ea is bf16 if ea_bf16 != 0, else f32.  Needs F % 4 == 0
// and RG * F <= 1024.
extern "C" int cfconv_fwd(const void* ea, const float* env, const float* x,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, float* out, int B, int N, int G,
                          int F, int RG, int ea_bf16, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ea_bf16)
    return launch_fwd(EaRead<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(ea)},
                      env, x, w1, b1, w2, b2, out, B, N, G, F, RG, bf16, s);
  return launch_fwd(EaRead<float>{static_cast<const float*>(ea)}, env, x, w1, b1,
                    w2, b2, out, B, N, G, F, RG, bf16, s);
}

// dx [B, N, F], dw1 [G, F], db1 [F], dw2 [F, F], db2 [F]; ea as in
// cfconv_fwd; part is caller-allocated scratch of B * (G * F + F * F + 2 * F)
// floats.  Needs F % 4 == 0 and F <= 1024.
extern "C" int cfconv_bwd(const void* ea, const float* env, const float* x,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* g, float* dx,
                          float* dw1, float* db1, float* dw2, float* db2,
                          float* part, int B, int N, int G, int F, int ea_bf16,
                          int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ea_bf16)
    return launch_bwd(EaRead<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(ea)},
                      env, x, w1, b1, w2, b2, g, dx, dw1, db1, dw2, db2, part, B, N,
                      G, F, bf16, s);
  return launch_bwd(EaRead<float>{static_cast<const float*>(ea)}, env, x, w1, b1,
                    w2, b2, g, dx, dw1, db1, dw2, db2, part, B, N, G, F, bf16, s);
}

// K5: cfconv_fwd / cfconv_bwd with ea built in-kernel from dist [B, N, N]
// f32 (EaSmear); start, step = (stop - start) / (G - 1) and coeff =
// -0.5 / step^2 come from the wrapper as f32.
extern "C" int cfconv_rbf_fwd(const float* dist, const float* env, const float* x,
                              const float* w1, const float* b1, const float* w2,
                              const float* b2, float* out, int B, int N, int G,
                              int F, int RG, float start, float step, float coeff,
                              int bf16, void* stream) {
  return launch_fwd(EaSmear{dist, start, step, coeff}, env, x, w1, b1, w2, b2, out,
                    B, N, G, F, RG, bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int cfconv_rbf_bwd(const float* dist, const float* env, const float* x,
                              const float* w1, const float* b1, const float* w2,
                              const float* b2, const float* g, float* dx,
                              float* dw1, float* db1, float* dw2, float* db2,
                              float* part, int B, int N, int G, int F, float start,
                              float step, float coeff, int bf16, void* stream) {
  return launch_bwd(EaSmear{dist, start, step, coeff}, env, x, w1, b1, w2, b2, g, dx,
                    dw1, db1, dw2, db2, part, B, N, G, F, bf16,
                    static_cast<cudaStream_t>(stream));
}
