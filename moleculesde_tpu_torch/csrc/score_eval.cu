// One whole 2D->3D score evaluation of SDEModel2Dto3D (variants 1 and 2)
// in one launch (K6), forward only:
//   pos [B, N, 3], node_attr [B, N, 32], edge_attr_2d [B, N, N, 32] and the
//   pair mask [B, N, N] (all f32), the packed weights (ops/score_kernel.py::
//   pack_score_params) -> raw score out [B, N, 3] f32.
// Frames, Gaussian-Fourier coefficient embeddings, the projection MLP
// (and variant 2's distance gate), four DenseGAT layers with LayerNorm and
// FFN, and the two basis-mixing modules.
//
// Replaces the Pallas kernel moleculesde_tpu/ops/score_kernel.py::_kernel
// (pallas_call at l.388, entry score_eval_fused l.353).
//
// What bounds it on this card: as separate operators an evaluation is ~550
// launches, and the PC chain was bound by the host issuing them (the device
// idle 84-92% of the chain).  In one launch the work itself is what is
// left: ~54 MFLOP per molecule (3.5 GFLOP at B=64, N=32), of which the
// per-pair products dominate (the two coefficient embeddings [128 -> 32],
// the projection MLP, the edge projection of each GAT layer [32 -> 32] and
// each basis module's [32 -> 128] edge MLP), against ~9 MB of compulsory
// traffic.  Arithmetic-bound: ~0.05 ms on the CUDA cores' f32 rate, the
// rate this first version runs at in both modes (no tensor cores yet).
//
// Design.  One block per molecule: each GAT layer needs every node's new
// state before the next starts, and a molecule's whole working set fits in
// one SM's shared memory.  At B=64 that is 64 of the 132 SMs.  512 threads
// = 16 warps; every pair phase maps a warp to a destination d and a lane to
// a source s (N <= 32), so sums over sources are warp shuffles.
// - The masked edge features [N*N, 32] are the only large tensor: computed
//   once per evaluation and kept in shared memory for the whole of it
//   (f32 147 KB, bf16 80 KB), rows [d][s] padded to 36 f32 / 40 bf16 so the
//   32 lanes' 16-byte row reads hit distinct banks.
// - The frame basis is recomputed from the 96 position floats wherever it
//   is needed instead of storing nine [N, N] planes.
// - Attention streams over pairs: each lane forms its e2[s, d, :] row, the
//   8 head logits, its softmax weight (warp max / sum; a destination with
//   no valid source gets alpha = 0, as the TPU kernel's mask multiply
//   gives) and its message terms in registers; a reduce-scatter of 31
//   shuffles leaves the message of channel c in lane c, which then does
//   LayerNorm and the FFN with warp reductions.  e2, alpha and the
//   [N*N, 128] basis-MLP slab never reach memory.
// - Each phase's weights are staged into one 37 KB shared buffer before it.
// - Registers: 512 threads leave at most 128 per thread; the heaviest
//   phase holds two 32-float rows.
// The batch-wide order of every sum is fixed, so results are the same on
// every run.
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

namespace {

constexpr int kN = 32;          // n_max the kernel takes (at most)
constexpr int kH = 32;          // hidden width
constexpr int kHeads = 8;
constexpr int kCHead = kH / kHeads;
constexpr int kCD = 128;        // basis-MLP width (hidden_coff_dim)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSegments = 128;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kNR = kH + 1;     // q / k / v / skip row stride (bank-conflict free)
constexpr int kHPR = kCD + 1;   // basis-MLP node part row stride
constexpr int kMR = kN + 1;     // transposed mask row stride

// shared memory, after the edge slab (in floats)
constexpr int kWBuf = 9472;     // the largest phase's weights (variant 2 features)
constexpr int kNodeQ = 4 * kN * kNR;   // q, k, v, skip; the basis phase's hp aliases it
constexpr int kFloats = kWBuf + kN * kH + kNodeQ + kWarps * kH + 128 + kN * kMR + kN + 128;

static_assert(kN * kHPR <= kNodeQ, "hp must fit in the q/k/v/skip area");

struct Offsets {
  int v[kMaxSegments];
};

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? rbf(v) : v;
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16x2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
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

// the masked edge features, rows [d * kN + s]
template <bool BF16>
struct Slab;

template <>
struct Slab<false> {
  static constexpr int kRow = 36;   // floats
  static constexpr int kBytes = kN * kN * kRow * 4;
  __device__ static void store(void* base, int row, const float (&v)[32]) {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + row * kRow);
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
  __device__ static void load(const void* base, int row, float (&v)[32]) {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + row * kRow);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 q = p[j];
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  }
};

template <>
struct Slab<true> {
  static constexpr int kRow = 40;   // bf16 values (80 bytes)
  static constexpr int kBytes = kN * kN * kRow * 2;
  __device__ static void store(void* base, int row, const float (&v)[32]) {
    uint4* p = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + row * kRow);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[j] = make_uint4(pack_bf16x2(v[8 * j], v[8 * j + 1]), pack_bf16x2(v[8 * j + 2], v[8 * j + 3]),
                        pack_bf16x2(v[8 * j + 4], v[8 * j + 5]),
                        pack_bf16x2(v[8 * j + 6], v[8 * j + 7]));
  }
  __device__ static void load(const void* base, int row, float (&v)[32]) {
    const uint4* p =
        reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + row * kRow);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 u = p[j];
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_bf16x2(w[i]);
        v[8 * j + 2 * i] = f.x;
        v[8 * j + 2 * i + 1] = f.y;
      }
    }
  }
};

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

// embedding of one coefficient pair: [sin, cos](c0 * wc) | [sin, cos](c2 * wc)
// through the [4h, h] coff_mlp kernel, plus its bias
template <bool BF16>
__device__ __forceinline__ void coff_embed(float c0, float c2, const float* wc, const float* wm,
                                           const float* bm, float (&acc)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < 32; ++k) {
    float s0, k0, s2, k2;
    sincosf(c0 * wc[k], &s0, &k0);
    sincosf(c2 * wc[k], &s2, &k2);
    s0 = rnd<BF16>(s0);
    k0 = rnd<BF16>(k0);
    s2 = rnd<BF16>(s2);
    k2 = rnd<BF16>(k2);
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

__device__ __forceinline__ void stage(float* dst, const float* src, int n, bool round) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = src[i];
    dst[i] = round ? rbf(v) : v;
  }
}

// local offsets in the weight buffer
// phase 1 (frame features)
constexpr int kWC = 0, kCM = 32, kBM = kCM + 4 * kH * kH, kP1 = kBM + kH,
              kB1 = kP1 + (2 * kH + 2) * kH, kP2 = kB1 + kH, kB2 = kP2 + kH * kH,
              kDW = kB2 + kH, kIN = kDW + kH, kBI = kIN + 2 * kH * kH;
static_assert(kBI + kH <= kWBuf, "phase-1 weights");
// a GAT layer: seven [h, h] kernels (q, k, v, edge, skip, FFN 1, FFN 2),
// seven biases, two LayerNorms
constexpr int kGBias = 7 * kH * kH, kGNorm = kGBias + 7 * kH;
constexpr int kWE = 3 * kH * kH, kWF1 = 5 * kH * kH, kWF2 = 6 * kH * kH;
// a basis module
constexpr int kWH = 0, kWBE = kH * kCD, kBBE = 2 * kH * kCD, kWO = kBBE + kCD,
              kBO = kWO + kCD * 3;
static_assert(kBO + 4 <= kWBuf, "basis weights");

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
score_eval_kernel(const float* __restrict__ pos, const float* __restrict__ node,
                  const float* __restrict__ edge2d, const float* __restrict__ mask,
                  const float* __restrict__ params, const Offsets off,
                  float* __restrict__ out, int N, int variant, int L, int NC) {
  using SlabT = Slab<BF16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  void* slab = smem_raw;
  float* wbuf = reinterpret_cast<float*>(smem_raw + SlabT::kBytes);
  float* xs = wbuf + kWBuf;               // [kN][kH] node state
  float* qs = xs + kN * kH;               // [kN][kNR] each: q, k, v, skip
  float* ks = qs + kN * kNR;
  float* vs = ks + kN * kNR;
  float* sks = vs + kN * kNR;
  float* hps = qs;                        // [kN][kHPR] in the basis phases
  float* fs = qs + kNodeQ;                // [kWarps][kH] FFN scratch
  float* posS = fs + kWarps * kH;         // [kN][3] (128 floats)
  float* maskT = posS + 128;              // [d][kMR]: mask[s, d]
  float* cnt = maskT + kN * kMR;          // [kN] valid sources per dest (>= 1)
  float* gradS = cnt + kN;                // [kN][3] (128 floats)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gat0 = variant == 2 ? 10 : 7;      // first GAT segment
  const int basis0 = gat0 + 18 * L * NC;       // first basis segment

  for (int i = tid; i < kN * 3; i += kThreads) {
    posS[i] = i < N * 3 ? pos[static_cast<size_t>(b) * N * 3 + i] : 0.f;
    gradS[i] = 0.f;
  }
  for (int i = tid; i < kN * kN; i += kThreads) {
    const int s = i / kN, d = i - s * kN;
    maskT[d * kMR + s] =
        (s < N && d < N) ? mask[(static_cast<size_t>(b) * N + s) * N + d] : 0.f;
  }
  for (int i = tid; i < kN * kH; i += kThreads) {
    const int n = i / kH;
    xs[i] = n < N ? rnd<BF16>(node[static_cast<size_t>(b) * N * kH + i]) : 0.f;
  }
  {
    const float two_pi = static_cast<float>(2.0 * 3.14159265358979323846);
    for (int i = tid; i < kH; i += kThreads) {
      wbuf[kWC + i] = params[off.v[0] + i] * two_pi;
      if (variant == 2) wbuf[kDW + i] = params[off.v[7] + i] * two_pi;
    }
    stage(wbuf + kCM, params + off.v[1], 4 * kH * kH, BF16);
    stage(wbuf + kBM, params + off.v[2], kH, false);
    stage(wbuf + kP1, params + off.v[3], 2 * kH, false);  // angle rows: elementwise
    stage(wbuf + kP1 + 2 * kH, params + off.v[3] + 2 * kH, 2 * kH * kH, BF16);
    stage(wbuf + kB1, params + off.v[4], kH, false);
    stage(wbuf + kP2, params + off.v[5], kH * kH, BF16);
    stage(wbuf + kB2, params + off.v[6], kH, false);
    if (variant == 2) {
      stage(wbuf + kIN, params + off.v[8], 2 * kH * kH, BF16);
      stage(wbuf + kBI, params + off.v[9], kH, false);
    }
  }
  __syncthreads();

  // ---- phase 1: masked edge features of every pair into the slab --------
  for (int d = warp; d < kN; d += kWarps) {
    const int s = lane;
    const float m = maskT[d * kMR + s];
    const float count = warp_sum(m);
    if (lane == 0) cnt[d] = fmaxf(count, 1.f);
    const float* ps = posS + 3 * s;
    const float* pd = posS + 3 * d;
    float cs[3], cd[3];
    float psin, pcos;
    {
      Frame f;
      make_frame(ps, pd, f);
      frame_coffs(f, ps, cs);
      frame_coffs(f, pd, cd);
      const float dot = cs[0] * cd[0] + cs[1] * cd[1] + cs[2] * cd[2];
      pcos = dot / (norm3(cs[0], cs[1], cs[2]) + 1e-6f) / (norm3(cd[0], cd[1], cd[2]) + 1e-6f);
      psin = sqrtf(fmaxf(1.f - pcos * pcos, 1e-12f));
    }
    float pre[32], acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) pre[j] = 0.f;
    coff_embed<BF16>(cs[0], cs[2], wbuf + kWC, wbuf + kCM, wbuf + kBM, acc);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = rnd<BF16>(acc[j]);
    matvec32(acc, wbuf + kP1 + 2 * kH, kH, pre);
    coff_embed<BF16>(cd[0], cd[2], wbuf + kWC, wbuf + kCM, wbuf + kBM, acc);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = rnd<BF16>(acc[j]);
    matvec32(acc, wbuf + kP1 + (2 + kH) * kH, kH, pre);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      pre[j] += psin * wbuf[kP1 + j] + pcos * wbuf[kP1 + kH + j] + wbuf[kB1 + j];
      pre[j] = rnd<BF16>(silu(pre[j]));
      acc[j] = 0.f;
    }
    matvec32(pre, wbuf + kP2, kH, acc);          // frame_inv (without bias)
    const bool real = s < N && d < N;
    const float4* e2d = reinterpret_cast<const float4*>(
        edge2d + ((static_cast<size_t>(b) * N + (real ? s : 0)) * N + (real ? d : 0)) * kH);
    if (variant == 2) {
      // input_mlp: one Linear on [sin, cos](dist * w) (no activation)
      const float dist = norm3(ps[0] - pd[0], ps[1] - pd[1], ps[2] - pd[2]);
#pragma unroll
      for (int j = 0; j < 32; ++j) pre[j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < 32; ++k) {
        float sn, cs_;
        sincosf(dist * wbuf[kDW + k], &sn, &cs_);
        sn = rnd<BF16>(sn);
        cs_ = rnd<BF16>(cs_);
        const float4* ra = reinterpret_cast<const float4*>(wbuf + kIN + k * kH);
        const float4* rb = reinterpret_cast<const float4*>(wbuf + kIN + (kH + k) * kH);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 qa = ra[j], qb = rb[j];
          pre[4 * j] += sn * qa.x + cs_ * qb.x;
          pre[4 * j + 1] += sn * qa.y + cs_ * qb.y;
          pre[4 * j + 2] += sn * qa.z + cs_ * qb.z;
          pre[4 * j + 3] += sn * qa.w + cs_ * qb.w;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 e = real ? e2d[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * j + i;
          acc[c] = (pre[c] + wbuf[kBI + c]) * ev[i] + (acc[c] + wbuf[kB2 + c]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 e = real ? e2d[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * j + i;
          acc[c] = ev[i] + (acc[c] + wbuf[kB2 + c]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = rnd<BF16>(acc[j] * m);
    SlabT::store(slab, d * kN + s, acc);
  }

  const float scale = 1.f / sqrtf(static_cast<float>(kCHead));
  for (int mod = 0; mod < L; ++mod) {
    for (int conv = 0; conv < NC; ++conv) {
      const int seg = gat0 + 18 * (mod * NC + conv);
      __syncthreads();   // the previous phase is done with wbuf and xs
      for (int j = 0; j < 7; ++j) {
        stage(wbuf + j * kH * kH, params + off.v[seg + 2 * j], kH * kH, BF16);
        stage(wbuf + kGBias + j * kH, params + off.v[seg + 2 * j + 1], kH, false);
      }
      for (int j = 0; j < 4; ++j) stage(wbuf + kGNorm + j * kH, params + off.v[seg + 14 + j], kH, false);
      __syncthreads();

      // q, k, v and the skip projection of every node
      for (int o = tid; o < kN * 4 * kH; o += kThreads) {
        const int n = o / (4 * kH), col = o - n * 4 * kH;
        const int which = col / kH, c = col - which * kH;
        const int wi = which == 3 ? 4 : which;   // q, k, v, skip = kernels 0, 1, 2, 4
        const float* w = wbuf + wi * kH * kH;
        float acc = 0.f;
#pragma unroll 8
        for (int k = 0; k < kH; ++k) acc = fmaf(xs[n * kH + k], w[k * kH + c], acc);
        qs[which * kN * kNR + n * kNR + c] = acc + wbuf[kGBias + wi * kH + c];
      }
      __syncthreads();

      // attention, LayerNorm, FFN, LayerNorm: warp = destination d
      const float* s1 = wbuf + kGNorm;
      const float* o1 = s1 + kH;
      const float* s2 = o1 + kH;
      const float* o2 = s2 + kH;
      for (int d = warp; d < kN; d += kWarps) {
        const int s = lane;
        const float m = maskT[d * kMR + s];
        float ea[32], e2[32];
        SlabT::load(slab, d * kN + s, ea);
#pragma unroll
        for (int j = 0; j < 32; ++j) e2[j] = 0.f;
        matvec32(ea, wbuf + kWE, kH, e2);
#pragma unroll
        for (int j = 0; j < 32; ++j) e2[j] += wbuf[kGBias + 3 * kH + j];
        float alpha[kHeads];
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          float l = 0.f;
#pragma unroll
          for (int cc = 0; cc < kCHead; ++cc) {
            const int c = hh * kCHead + cc;
            l += rnd<BF16>((ks[s * kNR + c] + e2[c]) * qs[d * kNR + c]);
          }
          l = m > 0.f ? l * scale : -3.402823466e38f;
          const float ex = expf(l - warp_max(l));
          alpha[hh] = rnd<BF16>(ex / fmaxf(warp_sum(ex), 1e-30f) * m);
        }
#pragma unroll
        for (int c = 0; c < 32; ++c) e2[c] = alpha[c / kCHead] * (vs[s * kNR + c] + e2[c]);
        const int c = lane;
        const float mha = rnd<BF16>(reduce_scatter(e2, lane) + sks[d * kNR + c]);
        float mean = warp_sum(mha) * (1.f / kH);
        float dv = mha - mean;
        float y = dv * rsqrtf(warp_sum(dv * dv) * (1.f / kH) + 1e-6f) * s1[c] + o1[c];
        const float x1 = rnd<BF16>(xs[d * kH + c] + rnd<BF16>(y));
        float* f = fs + warp * kH;
        f[c] = x1;
        __syncwarp();
        float hacc = 0.f;
#pragma unroll 8
        for (int k = 0; k < kH; ++k) hacc = fmaf(f[k], wbuf[kWF1 + k * kH + c], hacc);
        const float hval = rnd<BF16>(silu(hacc + wbuf[kGBias + 5 * kH + c]));
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
        if (conv < NC - 1) x2 = silu(x2);
        xs[d * kH + c] = rnd<BF16>(x2);
      }
    }

    // ---- basis module: dynamic coefficients mix the frame basis --------
    const int seg = basis0 + 5 * mod;
    __syncthreads();
    stage(wbuf + kWH, params + off.v[seg], kH * kCD, BF16);
    stage(wbuf + kWBE, params + off.v[seg + 1], kH * kCD, BF16);
    stage(wbuf + kBBE, params + off.v[seg + 2], kCD, false);
    stage(wbuf + kWO, params + off.v[seg + 3], kCD * 3, BF16);
    stage(wbuf + kBO, params + off.v[seg + 4], 3, false);
    __syncthreads();
    for (int o = tid; o < kN * kCD; o += kThreads) {
      const int n = o / kCD, c = o - n * kCD;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < kH; ++k) acc = fmaf(xs[n * kH + k], wbuf[kWH + k * kCD + c], acc);
      hps[n * kHPR + c] = acc;
    }
    __syncthreads();
    for (int d = warp; d < kN; d += kWarps) {
      const int s = lane;
      float ea[32];
      SlabT::load(slab, d * kN + s, ea);
      float cc[3] = {wbuf[kBO], wbuf[kBO + 1], wbuf[kBO + 2]};
      float part[3] = {0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < kCD; c0 += 32) {
        float acc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] = 0.f;
        matvec32(ea, wbuf + kWBE + c0, kCD, acc);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int c = c0 + j;
          const float coff = rnd<BF16>(silu((hps[s * kHPR + c] + hps[d * kHPR + c]) +
                                            (acc[j] + wbuf[kBBE + c])));
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
      Frame f;
      make_frame(posS + 3 * s, posS + 3 * d, f);
      const float mn = maskT[d * kMR + s] / cnt[d];
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        const float rows = rnd<BF16>(cc[0] * f.df[comp]) + rnd<BF16>(cc[1] * f.cr[comp]) +
                           rnd<BF16>(cc[2] * f.vt[comp]);
        const float tot = warp_sum(rows * mn);
        if (lane == 0) gradS[d * 3 + comp] += tot;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * 3; i += kThreads) out[static_cast<size_t>(b) * N * 3 + i] = gradS[i];
}

template <bool BF16>
int launch(const float* pos, const float* node, const float* edge2d, const float* mask,
           const float* params, const Offsets& off, float* out, int B, int N, int variant,
           int L, int NC, cudaStream_t stream) {
  const size_t smem = Slab<BF16>::kBytes + static_cast<size_t>(kFloats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(score_eval_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  score_eval_kernel<BF16><<<B, kThreads, smem, stream>>>(pos, node, edge2d, mask, params, off,
                                                          out, N, variant, L, NC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// offsets: the packed buffer's segment offsets in floats, in
// pack_score_params order (n_offsets of them).  Takes N <= 32, hidden 32,
// 8 heads and basis width 128; returns cudaErrorInvalidValue otherwise.
extern "C" int score_eval_fused(const float* pos, const float* node, const float* edge2d,
                                const float* mask, const float* params, const int* offsets,
                                int n_offsets, float* out, int B, int N, int variant,
                                int num_layers, int num_convs, int bf16, void* stream) {
  const int expected = (variant == 2 ? 10 : 7) + 18 * num_layers * num_convs + 5 * num_layers;
  if (N < 1 || N > kN || (variant != 1 && variant != 2) || n_offsets != expected ||
      n_offsets > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets off;
  for (int i = 0; i < kMaxSegments; ++i) off.v[i] = i < n_offsets ? offsets[i] : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(pos, node, edge2d, mask, params, off, out, B, N, variant,
                             num_layers, num_convs, s)
              : launch<false>(pos, node, edge2d, mask, params, off, out, B, N, variant,
                              num_layers, num_convs, s);
}
