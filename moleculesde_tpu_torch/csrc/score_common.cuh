// What K6's two plans share (csrc/score_eval.cu, the cluster plan, and
// csrc/score_layered.cu, the layered plan): bf16 rounding as the TPU
// kernel rounds, silu, warp reductions, the reduce-scatter of a lane's
// 32 channels, and the pair frame of score_2d3d.dense_frames.  All of it
// inlines into each plan's kernels.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace score_common {

constexpr unsigned kFull = 0xffffffffu;

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

}  // namespace score_common
