// Fused per-channel q/k nets and tanh attention-map bank of the 3D->2D
// edge layers (K8):
//   q_c = tanh(qk @ Wq1[c] + bq1[c]) @ Wq2[c] + bq2[c]          [N, A]
//   k_c = tanh(qk @ Wk1[c] + bk1[c]) @ Wk2[c] + bk2[c]
//   a[b, c, n, m] = (1/H) sum_h tanh(inv * q_c,h[n] . k_c,h[m])   (attn_map.cuh)
// with qk [B, N, F] (f32 or bf16), W1 [C, F, A], b1 [C, A], W2 [C, A, A],
// b2 [C, A] in f32 and a [B, C, N, N] f32.
//
// Replaces the Pallas kernel
// moleculesde_tpu/ops/rejected/attn_qk_bank.py::_fwd_kernel (pallas_call at
// l.209) and ::_bwd_kernel (l.232), entry attn_qk_bank (l.292).
//
// Bound: bytes in bf16 mode (qk, the weights and a; the ~0.37 GFLOP of
// the q/k nets and logits at B=128, F=300, C=2 sit far under the tensor
// cores' rate), operations in f32 mode on the CUDA cores.
//
// Forward design: one 256-thread block per (graph, channel), B x C blocks
// (1024 at the 3D->2D chain's layers 1-3), four resident per SM so that
// they hide each other's latency (the one-block-per-graph kernel it
// replaced ran 128 blocks, each walking the 8 channels in turn).  A block
// stages its channel's W1 rows (in chunks of FC <= 128 features, with the
// matching qk chunk), W2 and biases of both nets by asynchronous 16-byte
// copies, all in flight at once, rounding the weights in place in bf16
// mode.  Rows are paired (n and n + ceil(N / 2)): a thread forms one
// column of the first layer of q or k for two rows, reading each weight
// once (its pre-activation carried across the chunks in shared memory, f
// in order; tanh after the last), then the second layer the same way,
// then a 2 x 2 tile of the map (attn_map.cuh's formula), each q and k
// row read once for two pairs, with 16-byte reads where ds % 4 == 0.  The
// map goes straight to device memory, so N grows only the staged rows:
// any N whose plan fits (ops/attn_qk_bank.py::fwd_plan; N <= 334 at
// A = 32, F <= 16).  A = 32 is a compile-time width.  Every sum runs in
// the order of the kernel it replaced (f ascending, j ascending, each
// head's d ascending, heads in order), so the bits are the same.
//
// Backward design: one block per graph walking the channels in order, as
// the TPU kernel's grid step does.  qk[b] is staged once in shared memory
// ([N, F] f32: 115 KB at variant 3's F = 900); a thread per (n, j) forms
// pre = qk[n] . W1[:, j] reading W1 rows straight from global memory
// (neighbouring threads on neighbouring j, every warp of the block on the
// same rows, so the reads are coalesced and served by L1 after the first
// warp), then t1, then q or k against W2 staged in shared memory, then
// K7's map terms for the channel.  N <= 32 (the per-head du of the whole
// map is held in shared memory).  Only qk, the weights, g and the
// gradients touch device memory.
//
// The TPU verdict ("rejected") does not carry over.  On the TPU the
// statically unrolled channels x heads structure turned one batched
// contraction into 64 small matrix-unit dots that ran one after another.
// On this card the small dots are plain per-thread loops on the CUDA
// cores, the blocks run side by side, and the eager chain around the
// bank is bound by its launch count: this one launch replaces the q/k
// MLPs' einsums, bias adds and tanh and the map's einsum, scale, tanh and
// mean.
//
// Rounding, as the TPU kernel's (attn_qk_bank.py:63-100) in bf16 mode: qk
// arrives rounded (the wrapper casts it), each weight is rounded to bf16 as
// it enters its product, b1 and b2 are added in f32, tanh(pre) runs in f32,
// t1 is rounded only as the second product's operand, q and k are rounded
// before the logits.
//
// Backward (l.103-184), per graph and channel: recompute t1, q and k,
// the map's du and dq3, dk3 (attn_map.cuh, f32), then for q and for k
//   dout = d3 (f32), dt1 = round(dout) @ round(W2)^T, dpre = dt1 * (1 - t1^2)
//   dW2 = round(t1)^T round(dout)   db2 = sum_n dout   (unrounded)
//   dW1 = qk^T round(dpre)          db1 = sum_n dpre   (unrounded)
// and, after the last channel,
//   dqk = sum_c (round(dpre_q,c) @ round(Wq1[c])^T + round(dpre_k,c) @ round(Wk1[c])^T)
// accumulated in f32 in that order and stored in qk's dtype.  The rounded
// dpre of every channel stays in shared memory for the dqk pass.  The
// weight gradients are per-graph partials [B, P] summed over graphs in
// graph order (partials.cuh): no float atomics, the same bits every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attn_map.cuh"
#include "hopper.cuh"
#include "partials.cuh"

constexpr int kPhaseSlots = 8;   // PHASE_PROFILE marks per block

namespace {

using attn_map::round_bf16;

struct Net {            // one q or k net's weights, all channels
  const float* w1;      // [C, F, A]
  const float* b1;      // [C, A]
  const float* w2;      // [C, A, A]
  const float* b2;      // [C, A]
};

struct Nets {
  Net p[2];             // 0: q, 1: k
};

__device__ __forceinline__ float rb(float v, int bf16) { return bf16 ? round_bf16(v) : v; }

// qk[b] into shared memory as f32 [N][F]
template <typename T>
__device__ void stage_qk(const T* __restrict__ qk, float* qks, int N, int F) {
  for (int i = threadIdx.x; i < N * F; i += blockDim.x) qks[i] = attn_map::load(qk, i);
}

// W2[c] (rounded in bf16 mode) into shared memory [A][A + 1]
__device__ void stage_w2(const float* __restrict__ w2, float* w2s, int A, int bf16) {
  for (int i = threadIdx.x; i < A * A; i += blockDim.x) {
    const int j = i / A, o = i - j * A;
    w2s[j * (A + 1) + o] = rb(w2[i], bf16);
  }
}

// One channel's net: t1 = tanh(qk @ W1 + b1) (f32, into t1s [N][A + 1]) and
// out = round(t1) @ round(W2) + b2, rounded to bf16 in bf16 mode, into
// outs [N][A + 1].  Ends with a barrier; w2s is scratch.
__device__ void run_net(const float* qks, const Net& net, int c, float* t1s,
                        float* w2s, float* outs, int N, int F, int A, int bf16) {
  const int AP = A + 1;
  const float* w1 = net.w1 + static_cast<size_t>(c) * F * A;
  const float* b1 = net.b1 + c * A;
  stage_w2(net.w2 + static_cast<size_t>(c) * A * A, w2s, A, bf16);
  for (int i = threadIdx.x; i < N * A; i += blockDim.x) {
    const int n = i / A, j = i - n * A;
    const float* xr = qks + n * F;
    float acc = 0.f;
    for (int f = 0; f < F; ++f) acc = fmaf(xr[f], rb(__ldg(w1 + f * A + j), bf16), acc);
    t1s[n * AP + j] = tanhf(acc + b1[j]);
  }
  __syncthreads();
  const float* b2 = net.b2 + c * A;
  for (int i = threadIdx.x; i < N * A; i += blockDim.x) {
    const int n = i / A, o = i - n * A;
    const float* tr = t1s + n * AP;
    float acc = 0.f;
    for (int j = 0; j < A; ++j) acc = fmaf(rb(tr[j], bf16), w2s[j * AP + o], acc);
    outs[n * AP + o] = rb(acc + b2[o], bf16);
  }
  __syncthreads();
}

constexpr int kFwdThreads = 256;
constexpr int kBatch = 4;   // register-staged loads in flight per thread

// Row stride of the forward's staged rows: 16-byte aligned, and 4 words
// past a multiple of 32, so that lanes on neighbouring rows read distinct
// banks with 16-byte loads.  ops/attn_qk_bank.py::fwd_plan counts the same.
__host__ __device__ inline int fwd_stride(int width) { return (width + 3) / 4 * 4 + 4; }

__host__ __device__ inline int align4(int v) { return (v + 3) & ~3; }

// float offsets of the forward block's shared-memory regions, each 16-byte
// aligned; ops/attn_qk_bank.py::fwd_plan counts the same
struct FwdLayout {
  int w1, w2, b, t1, out, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int N, int FC, int A) {
  const int R = 2 * ((N + 1) / 2), AS = fwd_stride(A);
  FwdLayout L;
  L.w1 = R * fwd_stride(FC);
  L.w2 = L.w1 + align4(2 * FC * A);
  L.b = L.w2 + align4(2 * A * A);
  L.t1 = L.b + align4(4 * A);
  L.out = L.t1 + 2 * R * AS;
  L.total = L.out + 2 * R * AS;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

// n floats (n % 4 == 0, both ends 16-byte aligned) from device to shared
// memory by 16-byte asynchronous copies, all in flight at once; the caller
// waits with cp.async.wait_all and may then round what this thread copied
// with round_copied (the same indices)
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += kFwdThreads * 4) cp_async16(dst + i, src + i);
}

__device__ __forceinline__ void round_copied(float* dst, int n) {
  for (int i = threadIdx.x * 4; i < n; i += kFwdThreads * 4) {
    float4 v = *reinterpret_cast<float4*>(dst + i);
    v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
    *reinterpret_cast<float4*>(dst + i) = v;
  }
}

// acc[i][c] + x_i . w[:, c] for the rows x0, x1 and the C columns of w
// (rows f = 0 .. fc - 1 of stride ws), each an fmaf in f order; x0 and x1
// 16-byte aligned, and so are w's rows when C == 4
template <int C>
__device__ __forceinline__ void dot2(const float* x0, const float* x1, const float* w, int ws,
                                     int fc, float (&acc)[2][C]) {
  auto row = [&](int f, float (&v)[C]) {
    if constexpr (C == 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + f * ws);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = w[f * ws];
    }
  };
  int f = 0;
  for (; f + 4 <= fc; f += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(x0 + f);
    const float4 a1 = *reinterpret_cast<const float4*>(x1 + f);
    const float xa[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float v[C];
      row(f + t, v);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[0][c] = fmaf(xa[0][t], v[c], acc[0][c]);
        acc[1][c] = fmaf(xa[1][t], v[c], acc[1][c]);
      }
    }
  }
  for (; f < fc; ++f) {
    float v[C];
    row(f, v);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[0][c] = fmaf(x0[f], v[c], acc[0][c]);
      acc[1][c] = fmaf(x1[f], v[c], acc[1][c]);
    }
  }
}

enum Epilogue { kCarry, kTanh, kBias };   // what a net layer stores

// One layer of both nets for the block's row pairs, a thread per (net, row
// pair, C columns): net p's rows x = xs + p * xnet (stride xst) times its
// K weight rows w + p * wnet ([K][A]), added to what dst holds (carry)
// or to 0, then stored as is (kCarry: the first layer's pre-activation
// between chunks), as tanh(acc + b1) rounded (kTanh: t1, which enters
// only the second product) or as acc + b2 rounded (kBias: q or k).
template <int C>
__device__ __forceinline__ void net_layer(const float* xs, int xnet, int xst, const float* w,
                                          int wnet, int K, const float* bias, float* dst,
                                          int R, int SN, int A, int AS, bool carry,
                                          Epilogue epi, int bf16) {
  const int AC = A / C, items = 2 * SN * AC;
  for (int it = threadIdx.x; it < items; it += kFwdThreads) {
    const int p = it / (SN * AC), r = it - p * SN * AC, n = r / AC, j = C * (r - n * AC);
    float* d0 = dst + (p * R + n) * AS + j;
    float* d1 = d0 + SN * AS;
    float acc[2][C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[0][c] = carry ? d0[c] : 0.f;
      acc[1][c] = carry ? d1[c] : 0.f;
    }
    const float* x0 = xs + p * xnet + n * xst;
    dot2<C>(x0, x0 + SN * xst, w + p * wnet + j, A, K, acc);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float b = bias[2 * p * A + j + c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (epi == kTanh) acc[i][c] = rb(tanhf(acc[i][c] + b), bf16);
        if (epi == kBias) acc[i][c] = rb(acc[i][c] + b, bf16);
      }
      d0[c] = acc[0][c];
      d1[c] = acc[1][c];
    }
  }
}

// One (graph, channel) block of the forward.  Rows are paired, n and
// n + SN (SN = ceil(N / 2)), so that a thread reads each weight once for
// two rows of output and, in the map, each q and k row once for two pairs;
// the staged rows run to 2 SN, those past N zero.  Shared memory (each
// region 16-byte aligned): a qk chunk [2 SN][FC] (fwd_stride rows), the
// chunk's W1 rows [2][FC][A] and W2 [2][A][A] of q then k, the biases
// [2][2][A], t1 [2][2 SN][A] and q, k [2][2 SN][A] (fwd_stride rows).  The
// weights and f32 qk rows arrive by asynchronous 16-byte copies, all in
// flight at once, and are rounded in place in bf16 mode.  KA: A at compile
// time (the 3D->2D edge layers' 32), or 0 to take it at run time.
template <typename T, int KA>
__global__ void __launch_bounds__(kFwdThreads, 4)
attn_qk_bank_fwd_kernel(const T* __restrict__ qk, Nets nets, float* __restrict__ out,
                        int N, int F, int C, int A_, int ds, int FC, int bf16) {
  const int A = KA ? KA : A_;
  extern __shared__ __align__(16) float smem[];
  const int SN = (N + 1) / 2, R = 2 * SN;
  const int FP = fwd_stride(FC), AS = fwd_stride(A);
  const FwdLayout lay = fwd_layout(N, FC, A);
  float* qks = smem;                // [R][FP]
  float* w1s = smem + lay.w1;       // [2][FC][A]
  float* w2s = smem + lay.w2;       // [2][A][A]
  float* bs = smem + lay.b;         // [2][2][A]: b1, b2 of q, then of k
  float* t1s = smem + lay.t1;       // [2][R][AS]: pre-activation, then rounded t1
  float* outs = smem + lay.out;     // [2][R][AS]: rounded q, k
  const int b = blockIdx.x / C, c = blockIdx.x - b * C;
  const int tid = threadIdx.x;
  // 16-byte copies need A % 4 == 0 (W1 and W2 rows) and, for qk, f32 rows
  // with F % 4 == 0
  const bool vec = A % 4 == 0;
  const bool vec_x = vec && sizeof(T) == 4 && F % 4 == 0 && FC % 4 == 0;
  PHASE_MARK(0);

  if (vec) {
    for (int p = 0; p < 2; ++p) copy_async(w2s + p * A * A, nets.p[p].w2 + c * A * A, A * A);
  } else {
    for (int i = tid; i < 2 * A * A; i += kFwdThreads) {
      const int p = i / (A * A);
      w2s[i] = rb(nets.p[p].w2[static_cast<size_t>(c) * A * A + i - p * A * A], bf16);
    }
  }
  if (vec) {   // the biases too, so that no thread waits before the first chunk's copies
    for (int i = 0; i < 4; ++i)
      copy_async(bs + i * A, (i & 1 ? nets.p[i / 2].b2 : nets.p[i / 2].b1) + c * A, A);
  } else {
    for (int i = tid; i < 4 * A; i += kFwdThreads) {
      const int p = i / (2 * A), which = (i / A) & 1, a = i % A;
      bs[i] = __ldg((which ? nets.p[p].b2 : nets.p[p].b1) + c * A + a);
    }
  }
  PHASE_MARK(1);
  const T* x = qk + static_cast<size_t>(b) * N * F;
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fc = min(FC, F - f0);
    const bool last = f0 + fc >= F;
    if (f0 > 0) __syncthreads();    // the previous chunk is read
    if (vec) {
      for (int p = 0; p < 2; ++p)
        copy_async(w1s + p * FC * A, nets.p[p].w1 + (static_cast<size_t>(c) * F + f0) * A,
                   fc * A);
    } else {
      for (int i = tid; i < 2 * fc * A; i += kFwdThreads) {
        const int p = i / (fc * A);
        w1s[p * FC * A + i - p * fc * A] =
            rb(nets.p[p].w1[(static_cast<size_t>(c) * F + f0) * A + i - p * fc * A], bf16);
      }
    }
    if (vec_x) {
      const int q4 = fc / 4;
      for (int i = tid; i < R * q4; i += kFwdThreads) {
        const int n = i / q4, f = 4 * (i - n * q4);
        if (n < N)
          cp_async16(qks + n * FP + f, reinterpret_cast<const float*>(x) + n * F + f0 + f);
        else
          *reinterpret_cast<float4*>(qks + n * FP + f) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i0 = tid; i0 < R * fc; i0 += kBatch * kFwdThreads) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kFwdThreads, n = i / fc;
          v[u] = (i < R * fc && n < N)
                     ? attn_map::load(x, static_cast<size_t>(n) * F + f0 + i - n * fc) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kFwdThreads, n = i / fc;
          if (i < R * fc) qks[n * FP + i - n * fc] = v[u];
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (vec && bf16) {
      for (int p = 0; p < 2; ++p) {
        round_copied(w1s + p * FC * A, fc * A);
        if (f0 == 0) round_copied(w2s + p * A * A, A * A);
      }
    }
    __syncthreads();
    PHASE_MARK(2);
    // the first layer's chunk: both nets read the qk rows [R][FP]
    const Epilogue epi = last ? kTanh : kCarry;
    if (A % 4 == 0)
      net_layer<4>(qks, 0, FP, w1s, FC * A, fc, bs, t1s, R, SN, A, AS, f0 > 0, epi, bf16);
    else
      net_layer<1>(qks, 0, FP, w1s, FC * A, fc, bs, t1s, R, SN, A, AS, f0 > 0, epi, bf16);
  }
  PHASE_MARK(3);
  __syncthreads();
  PHASE_MARK(4);
  // the second layer: net p reads its own t1 rows [R][AS]
  if (A % 4 == 0)
    net_layer<4>(t1s, R * AS, AS, w2s, A * A, A, bs + A, outs, R, SN, A, AS, false, kBias, bf16);
  else
    net_layer<1>(t1s, R * AS, AS, w2s, A * A, A, bs + A, outs, R, SN, A, AS, false, kBias, bf16);
  PHASE_MARK(5);
  __syncthreads();
  PHASE_MARK(6);
  // the map, a thread per 2 x 2 pairs (n, n + SN) x (m, m + SN); each head's
  // dot in index order, the heads' tanh summed in order
  const float* qs = outs;
  const float* ks = outs + R * AS;
  const int H = A / ds;
  const float inv = attn_map::inv_sqrt(ds);
  float* ob = out + static_cast<size_t>(blockIdx.x) * N * N;
  for (int blk = tid; blk < SN * SN; blk += kFwdThreads) {
    const int n = blk / SN, m = blk - n * SN;
    const float* q0 = qs + n * AS;
    const float* q1 = q0 + SN * AS;
    const float* k0 = ks + m * AS;
    const float* k1 = k0 + SN * AS;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int h = 0; h < H; ++h) {
      float u[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      int d = h * ds;
      const int e = d + ds;
      if (ds % 4 == 0) {
        for (; d < e; d += 4) {
          const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
          const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
          const float4 c0 = *reinterpret_cast<const float4*>(k0 + d);
          const float4 c1 = *reinterpret_cast<const float4*>(k1 + d);
          const float qa[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
          const float ka[2][4] = {{c0.x, c0.y, c0.z, c0.w}, {c1.x, c1.y, c1.z, c1.w}};
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) u[i][jj] = fmaf(qa[i][t], ka[jj][t], u[i][jj]);
        }
      } else {
        for (; d < e; ++d) {
          const float qa[2] = {q0[d], q1[d]}, ka[2] = {k0[d], k1[d]};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) u[i][jj] = fmaf(qa[i], ka[jj], u[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) acc[i][jj] += tanhf(u[i][jj] * inv);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int nn = n + i * SN, mm = m + jj * SN;
        if (nn < N && mm < N) ob[nn * N + mm] = acc[i][jj] / static_cast<float>(H);
      }
  }
  PHASE_MARK(7);
}

template <typename T>
__global__ void __launch_bounds__(1024)
attn_qk_bank_bwd_kernel(const T* __restrict__ qk, Nets nets, const float* __restrict__ g,
                        T* __restrict__ dqk, float* __restrict__ part, int N, int F,
                        int C, int A, int ds, int bf16) {
  extern __shared__ float smem[];
  const int AP = A + 1, H = A / ds;
  float* qks = smem;                      // [N][F]
  float* t1s = qks + N * F;               // [2][N][A + 1]: f32 t1 of q, k
  float* outs = t1s + 2 * N * AP;         // [2][N][A + 1]: rounded q, k
  float* w2s = outs + 2 * N * AP;         // [A][A + 1]
  float* dus = w2s + A * AP;              // [H][N*N + 1]
  float* d3s = dus + H * (N * N + 1);     // [2][N][A]: dq3, dk3 (f32)
  float* dpt = d3s + 2 * N * A;           // [N][A + 1]: f32 dpre of one net
  float* dpl = dpt + N * AP;              // [C][2][N][A + 1]: rounded dpre
  const int b = blockIdx.x;
  stage_qk(qk + static_cast<size_t>(b) * N * F, qks, N, F);
  __syncthreads();

  // this graph's partials: per net [W1 C*F*A][b1 C*A][W2 C*A*A][b2 C*A]
  const size_t per_net = static_cast<size_t>(C) * F * A + C * A + C * A * A + C * A;
  float* pb = part + static_cast<size_t>(b) * 2 * per_net;

  for (int c = 0; c < C; ++c) {
    for (int p = 0; p < 2; ++p)
      run_net(qks, nets.p[p], c, t1s + p * N * AP, w2s, outs + p * N * AP, N, F, A, bf16);
    attn_map::backward_du(outs, outs + N * AP, g + (static_cast<size_t>(b) * C + c) * N * N,
                          dus, N, A, ds, bf16);
    __syncthreads();
    attn_map::backward_dqdk(outs, outs + N * AP, dus, d3s, d3s + N * A, N, A, ds);
    __syncthreads();

    for (int p = 0; p < 2; ++p) {
      const float* t1 = t1s + p * N * AP;
      const float* d3 = d3s + p * N * A;
      float* dl = dpl + (static_cast<size_t>(c) * 2 + p) * N * AP;
      float* pw1 = pb + p * per_net + static_cast<size_t>(c) * F * A;
      float* pb1 = pb + p * per_net + static_cast<size_t>(C) * F * A + c * A;
      float* pw2 = pb + p * per_net + static_cast<size_t>(C) * F * A + C * A +
                   static_cast<size_t>(c) * A * A;
      float* pb2 = pb + p * per_net + static_cast<size_t>(C) * F * A + C * A +
                   static_cast<size_t>(C) * A * A + c * A;
      stage_w2(nets.p[p].w2 + static_cast<size_t>(c) * A * A, w2s, A, bf16);
      __syncthreads();
      // dt1 = round(dout) @ round(W2)^T, dpre = dt1 * (1 - t1^2)
      for (int i = threadIdx.x; i < N * A; i += blockDim.x) {
        const int n = i / A, j = i - n * A;
        float acc = 0.f;
        for (int o = 0; o < A; ++o) acc = fmaf(rb(d3[n * A + o], bf16), w2s[j * AP + o], acc);
        const float t = t1[n * AP + j];
        const float dpre = acc * (1.0f - t * t);
        dpt[n * AP + j] = dpre;
        dl[n * AP + j] = rb(dpre, bf16);
      }
      // dW2 = round(t1)^T round(dout); db2 = sum_n dout
      for (int i = threadIdx.x; i < A * A; i += blockDim.x) {
        const int j = i / A, o = i - j * A;
        float acc = 0.f;
        for (int n = 0; n < N; ++n)
          acc = fmaf(rb(t1[n * AP + j], bf16), rb(d3[n * A + o], bf16), acc);
        pw2[i] = acc;
      }
      for (int o = threadIdx.x; o < A; o += blockDim.x) {
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc += d3[n * A + o];
        pb2[o] = acc;
      }
      __syncthreads();
      // db1 = sum_n dpre; dW1 = qk^T round(dpre)
      for (int j = threadIdx.x; j < A; j += blockDim.x) {
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc += dpt[n * AP + j];
        pb1[j] = acc;
      }
      for (int i = threadIdx.x; i < F * A; i += blockDim.x) {
        const int f = i / A, j = i - f * A;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(qks[n * F + f], dl[n * AP + j], acc);
        pw1[i] = acc;
      }
      __syncthreads();          // w2s, dpt are rewritten by the next net
    }
  }

  // dqk[n, f] = sum_c sum_{q, k} round(dpre) @ round(W1)^T, a lane per n
  T* db = dqk + static_cast<size_t>(b) * N * F;
  for (int i = threadIdx.x; i < N * F; i += blockDim.x) {
    const int f = i / N, n = i - f * N;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      for (int p = 0; p < 2; ++p) {
        const float* dl = dpl + ((static_cast<size_t>(c) * 2 + p) * N + n) * AP;
        const float* w1 = nets.p[p].w1 + (static_cast<size_t>(c) * F + f) * A;
        float s = 0.f;
        for (int j = 0; j < A; ++j) s = fmaf(dl[j], rb(__ldg(w1 + j), bf16), s);
        acc += s;
      }
    }
    attn_map::store(db, static_cast<size_t>(n) * F + f, acc);
  }
}

Nets make_nets(const float* const* w) {
  Nets nets;
  for (int p = 0; p < 2; ++p) nets.p[p] = Net{w[4 * p], w[4 * p + 1], w[4 * p + 2], w[4 * p + 3]};
  return nets;
}

template <typename T, int KA>
int launch_fwd_a(const void* qk, const float* const* w, float* out, int B, int N, int F,
                 int C, int A, int ds, int FC, int bf16, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_qk_bank_fwd_kernel<T, KA>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_qk_bank_fwd_kernel<T, KA><<<B * C, kFwdThreads, smem, s>>>(
      static_cast<const T*>(qk), make_nets(w), out, N, F, C, A, ds, FC, bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* qk, const float* const* w, float* out, int B, int N, int F,
               int C, int A, int ds, int FC, int bf16, int smem, cudaStream_t s) {
  return A == 32 ? launch_fwd_a<T, 32>(qk, w, out, B, N, F, C, A, ds, FC, bf16, smem, s)
                 : launch_fwd_a<T, 0>(qk, w, out, B, N, F, C, A, ds, FC, bf16, smem, s);
}

template <typename T>
int launch_bwd(const void* qk, const float* const* w, const float* g, void* dqk,
               float* wgrad, float* part, int B, int N, int F, int C, int A, int ds,
               int bf16, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_qk_bank_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_qk_bank_bwd_kernel<T><<<B, 1024, smem, s>>>(
      static_cast<const T*>(qk), make_nets(w), g, static_cast<T*>(dqk), part, N, F, C, A,
      ds, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = 2 * (C * F * A + C * A + C * A * A + C * A);
  partials::sum_rows(part, wgrad, B, P, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes of a forward block staging fc features at a time.
extern "C" int attn_qk_bank_fwd_smem_bytes(int N, int fc, int A) {
  return 4 * fwd_layout(N, fc, A).total;
}

// qk [B, N, F] (bf16 if in_bf16, else f32); w: the eight f32 weight pointers
// (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2); out [B, C, N, N] f32.  fc and
// smem are the wrapper's plan (ops/attn_qk_bank.py::fwd_plan): W1 and qk
// staged in chunks of fc features, smem bytes of shared memory per block
// (cudaErrorInvalidValue if it disagrees with the layout).  Needs A % ds
// == 0.
extern "C" int attn_qk_bank_fwd(const void* qk, const float* const* w, float* out, int B,
                                int N, int F, int C, int A, int ds, int in_bf16, int bf16,
                                int fc, int smem, void* stream) {
  if (fc < 1 || fc > F || smem != 4 * fwd_layout(N, fc, A).total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16
             ? launch_fwd<__nv_bfloat16>(qk, w, out, B, N, F, C, A, ds, fc, bf16, smem, s)
             : launch_fwd<float>(qk, w, out, B, N, F, C, A, ds, fc, bf16, smem, s);
}

// g [B, C, N, N] f32; dqk [B, N, F] in qk's dtype; wgrad: the eight weight
// gradients packed as [dWq1 dbq1 dWq2 dbq2 dWk1 dbk1 dWk2 dbk2] (P floats);
// part: caller-allocated scratch of B * P floats.
extern "C" int attn_qk_bank_bwd(const void* qk, const float* const* w, const float* g,
                                void* dqk, float* wgrad, float* part, int B, int N, int F,
                                int C, int A, int ds, int in_bf16, int bf16, int smem,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_bwd<__nv_bfloat16>(qk, w, g, dqk, wgrad, part, B, N, F, C, A,
                                             ds, bf16, smem, s)
                 : launch_bwd<float>(qk, w, g, dqk, wgrad, part, B, N, F, C, A, ds, bf16,
                                     smem, s);
}
