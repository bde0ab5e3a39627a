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
// Backward design: one block per (graph, channel), as the forward's grid,
// of 256 threads (512 where one block fills an SM's shared memory, as at
// n_max 128), B x C blocks (1024 at the chain's layers 1-3; the
// kernel it replaced ran one 1024-thread block per graph, 128 blocks on
// 132 SMs, walking the channels in turn and holding every head's du of the
// whole map and every channel's dpre, so it stopped at N = 32).  A block
// stages W2 and the biases of both nets and, in chunks of FC <= 64
// features, qk and the chunk's W1 rows by asynchronous 4-byte copies into
// rows padded to A + 1 words, rounding the weights in place in bf16 mode;
// recomputes t1 (f32) and q / k; runs attn_map.cuh's tiled map backward
// (R rows at a time: the whole map at N = 32, 16 rows at N = 128), which
// leaves dq and dk in shared memory; forms each net's dpre, dW2, db2 and
// db1; then walks qk's chunks again for dW1 and the channel's terms of
// dqk.  The scratch region holds a qk / W1 chunk while the nets run and
// the du tile in between, so shared memory grows as N (A + 1) and not as
// N^2 H: any N whose plan fits (ops/attn_qk_bank.py::bwd_plan; N <= 266
// at A = 32, H = 8, whatever F).
//
// Products: every one whose result is rounded again (pre -> t1, t1 @ W2 ->
// q / k, the map's dq / dk -> dout, dout @ W2^T -> dpre, dpre @ W1^T ->
// dqk) runs as FMAs, each element one chain in index order (fma_gemm, a
// thread per 2 rows x 4 columns): the plain version's cuBLAS products sum
// in that order, so few of those bf16 roundings flip.  Run on mma.sync,
// they flipped enough of them that dqk's bf16 error left its 3e-3 bar at
// n_max 128 (PERF.md, PR 13).  dW2 and
// dW1, f32 outputs that nothing rounds again, run on mma.sync in bf16 mode
// (hopper.cuh's mma_gemm) and as FMAs in f32 mode.  dqk: each unit writes
// its channel's q and k terms (f32) to a partial buffer [B, C, 2, N, F],
// added in channel order, q's before k's (the plain version's order), and
// cast once to qk's dtype (sum_channels_kernel); the weight gradients are
// per-(graph, channel) slices of per-graph partial rows [B, P] summed over
// graphs in graph order (partials.cuh).  No float atomics: the same bits
// every run.
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
// The tiled plan, where a (graph, channel) block's plan does not fit (the
// forward past N = 334 at A = 32, F = 16; the backward past N = 266): the
// nets' outputs go through device memory once, and every later step runs
// in units small enough for any N, with shared memory that depends on
// neither N, F nor A (at most 17 KB, static).
//  * nets_t1_kernel and nets_out_kernel, a thread per output element: t1 =
//    tanh(qk @ W1 + b1) (f32, the chain over f in order from 0) and q / k =
//    round(round(t1) @ W2 + b2) (the chain over j), for all channels and
//    both nets, [B C 2][N][A] each: the chains and roundings of the block
//    kernels above, so the same bits.
//  * The forward's map in (graph, channel, 32 x 32 tile) units
//    (map_fwd_tiled_kernel): q and k rows staged 32 features at a time, a
//    thread's 2 x 2 pairs each head's dot in index order, the heads' tanh
//    added in order: the block forward's map, bit for bit.
//  * The map's backward in (graph, channel, 32-row tile, head, 32-feature
//    slice of the head) units for dq and (graph, channel, 32-column tile,
//    ...) units for dk (attn_map.cuh's map_dqk_kernel, which K7 shares):
//    each walks the other side's tiles in order, forms the tile's du of
//    its head (g (1 - t^2) inv / H, bf16-rounded in bf16 mode) and carries
//    its dq (dk) chains across the tiles: each sum one chain in index
//    order, as backward_tiled's.  d3 = (dq, dk) [B C 2][N][A] f32.
//  * The nets' backward, a thread per output element: dpre = (round(d3) @
//    round(W2)^T) (1 - t1^2) (dpre_kernel); the weight gradients' slices of
//    the per-graph partial rows (wgrad_kernel: dW1, db1, dW2, db2, each a
//    chain over n in order; dW1 and dW2 as FMAs in both modes); each
//    channel's q and k terms of dqk into the same partial buffer
//    (dqk_terms_kernel); then sum_channels_kernel and partials.cuh as the
//    block plan.  Its units fill the card at small B (B C N / 32 map
//    tiles a head), where the block plan runs B C blocks.
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
// and
//   dqk = sum_c (round(dpre_q,c) @ round(Wq1[c])^T + round(dpre_k,c) @ round(Wk1[c])^T)
// accumulated in f32 and stored in qk's dtype.

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

// C_t = A_t B_t for t < batches (M x N, depth K) as FMAs: a thread takes
// rows m and m + ceil(M / 2) by four neighbouring columns, so that each A
// value read serves four products and each B value two; every element is
// one chain in k order from init(t, m, n), the bits of a thread per
// element.  A_t(m, k) = fa(t, m, k), B_t(k, n) = fb(t, k, n) (never called
// out of range); epi(t, m, n, c) takes each element.
template <typename FA, typename FB, typename Init, typename Epi>
__device__ __forceinline__ void fma_gemm(int batches, int M, int N, int K, FA fa, FB fb,
                                         Init init, Epi epi) {
  const int MH = (M + 1) / 2, NQ = (N + 3) / 4, items = batches * MH * NQ;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int t = it / (MH * NQ), r = it - t * MH * NQ, m0 = r / NQ, n0 = 4 * (r - m0 * NQ);
    const bool two = m0 + MH < M;
    const int m1 = two ? m0 + MH : m0, nc = min(4, N - n0);
    float acc[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[0][c] = c < nc ? init(t, m0, n0 + c) : 0.f;
      acc[1][c] = c < nc && two ? init(t, m1, n0 + c) : 0.f;
    }
    for (int k = 0; k < K; ++k) {
      const float a0 = fa(t, m0, k), a1 = fa(t, m1, k);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = c < nc ? fb(t, k, n0 + c) : 0.f;
        acc[0][c] = fmaf(a0, b, acc[0][c]);
        acc[1][c] = fmaf(a1, b, acc[1][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nc) continue;
      epi(t, m0, n0 + c, acc[0][c]);
      if (two) epi(t, m1, n0 + c, acc[1][c]);
    }
  }
}

constexpr int kBwdMaxChunk = 64;   // features of qk and W1 staged at once
constexpr int kBwdDuBudget = 16384;   // words of a row tile's du (attn_map.cuh)

// float offsets of the backward block's shared-memory regions (rows of A
// values padded to A + 1 words, but q / k's: attn_map.cuh's row_stride(A),
// 16-byte aligned); the scratch region holds a qk chunk [N][fc] and the
// chunk's W1 rows [2][FC][A + 1] while the nets run, and the map
// backward's du tile in between.  ops/attn_qk_bank.py::bwd_plan counts the
// same.
struct BwdLayout {
  int b, t1, qo, d3, scratch, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int N, int A, int H, int R, int FC) {
  const int AP = A + 1;
  const int chunk = N * FC + 2 * FC * AP, du = attn_map::du_words(N, R, H);
  BwdLayout L;
  L.b = 2 * A * AP;            // after W2 [2][A][A + 1]
  L.t1 = L.b + 4 * A;
  L.qo = align4(L.t1 + 2 * N * AP);
  L.d3 = L.qo + 2 * N * attn_map::row_stride(A);
  L.scratch = L.d3 + 2 * N * A;
  L.total = L.scratch + (chunk > du ? chunk : du);
  return L;
}

struct BwdPlan {
  int rows, fc, smem;
};

// The backward's plan: the map backward's row tile R (attn_map.cuh's
// tile_rows) and the feature chunk FC (min(F, 64)), the larger of the two
// scratch uses halved (R last) until the block fits kSmemLimit; smem in
// bytes, past the limit where nothing fits.
BwdPlan make_bwd_plan(int N, int F, int A, int H) {
  int r = attn_map::tile_rows(N, H, kBwdDuBudget), fc = F < kBwdMaxChunk ? F : kBwdMaxChunk;
  for (;;) {
    const size_t bytes = 4 * static_cast<size_t>(bwd_layout(N, A, H, r, fc).total);
    const int chunk = N * fc + 2 * fc * (A + 1);
    if (bytes <= kSmemLimit || (r == 1 && fc == 1)) return BwdPlan{r, fc, static_cast<int>(bytes)};
    if (fc > 1 && (chunk >= attn_map::du_words(N, r, H) || r == 1))
      fc /= 2;
    else
      r /= 2;
  }
}

// Threads of a backward block: 256 while two or more blocks fit on an SM
// (three at N = 32), 512 where the plan's shared memory leaves room for
// one (n_max 128: 16 warps an SM, not 8).
inline int bwd_threads(int smem) { return 2 * static_cast<size_t>(smem) > kSmemLimit ? 512 : 256; }

// One (graph, channel) unit of the backward, B x C blocks of THREADS.
// Shared memory (bwd_layout): W2 and the biases of both nets, t1 [2][N]
// (f32), q / k [2][N] (rounded; then each net's f32 dpre), dq / dk [2][N]
// (f32) and the scratch region.  part: this graph's row of the weight
// gradients' partials (per net [W1 C*F*A][b1 C*A][W2 C*A*A][b2 C*A], the
// unit writes its channel's slices); dqk_part [B][C][N][F]: the unit's
// terms of dqk.  BF16: the TPU kernel's bf16 mode, where dW1 and dW2 run
// on mma.sync (an f32 instantiation holds no tensor-core instruction).
template <typename T, bool BF16, int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 3 : 1)
attn_qk_bank_bwd_kernel(const T* __restrict__ qk, Nets nets, const float* __restrict__ g,
                        float* __restrict__ part, float* __restrict__ dqk_part, int N, int F,
                        int C, int A, int ds, int R, int FC) {
  constexpr int bf16 = BF16;
  extern __shared__ __align__(16) float smem[];
  const int AP = A + 1, QS = attn_map::row_stride(A), H = A / ds;
  const BwdLayout lay = bwd_layout(N, A, H, R, FC);
  float* w2s = smem;                 // [2][A][AP], rounded in bf16 mode
  float* bs = smem + lay.b;          // [2][2][A]: b1, b2 of q, then of k
  float* t1s = smem + lay.t1;        // [2][N][AP]: pre-activation, then f32 t1
  float* qo = smem + lay.qo;         // [2][N][QS]: rounded q, k; then dpre
  float* d3 = smem + lay.d3;         // [2][N][A]: dq, dk (f32)
  float* xs = smem + lay.scratch;    // [N][fc]: qk chunk (f32)
  float* w1s = xs + N * FC;          // [2][FC][AP]: the chunk's W1 rows, rounded in bf16 mode
  float* dus = smem + lay.scratch;   // [H][R N + 1]: the map backward's du tile
  const int b = blockIdx.x / C, c = blockIdx.x - b * C;
  const int tid = threadIdx.x;
  PHASE_MARK(0);

  for (int i = tid; i < 2 * A * A; i += THREADS) {
    const int p = i / (A * A), r = i - p * A * A, j = r / A;
    hopper::cp_async4(w2s + (p * A + j) * AP + r - j * A,
                      nets.p[p].w2 + static_cast<size_t>(c) * A * A + r, 4);
  }
  for (int i = tid; i < 4 * A; i += THREADS) {
    const int p = i / (2 * A), which = (i / A) & 1;
    hopper::cp_async4(bs + i, (which ? nets.p[p].b2 : nets.p[p].b1) + c * A + i % A, 4);
  }
  PHASE_MARK(1);

  // qk's features f0 .. f0 + fc - 1 into xs and both nets' W1 rows into
  // w1s, rounded in bf16 mode (and W2, whose copies land with the first
  // chunk's: round_w2), then a barrier
  const T* x = qk + static_cast<size_t>(b) * N * F;
  auto stage_chunk = [&](int f0, int fc, bool round_w2) {
    for (int i = tid; i < 2 * fc * A; i += THREADS) {
      const int p = i / (fc * A), r = i - p * fc * A, f = r / A;
      hopper::cp_async4(w1s + (p * FC + f) * AP + r - f * A,
                        nets.p[p].w1 + (static_cast<size_t>(c) * F + f0) * A + r, 4);
    }
    for (int i = tid; i < N * fc; i += THREADS) {
      const int n = i / fc, f = i - n * fc;
      if constexpr (sizeof(T) == 4)
        hopper::cp_async4(xs + i, x + static_cast<size_t>(n) * F + f0 + f, 4);
      else
        xs[i] = attn_map::load(x, static_cast<size_t>(n) * F + f0 + f);
    }
    hopper::cp_async_wait_all();
    if (bf16) {   // what this thread copied
      for (int i = tid; i < 2 * fc * A; i += THREADS) {
        const int p = i / (fc * A), r = i - p * fc * A, f = r / A;
        float* w = w1s + (p * FC + f) * AP + r - f * A;
        *w = round_bf16(*w);
      }
      if (round_w2) {
        for (int i = tid; i < 2 * A * A; i += THREADS) {
          const int j = i / A;
          float* w = w2s + j * AP + i - j * A;
          *w = round_bf16(*w);
        }
      }
    }
    __syncthreads();
  };

  // the forward again: pre = qk @ W1 (f in order, one chain across the
  // chunks), t1 = tanh(pre + b1) in f32, then q / k = round(round(t1) @ W2
  // + b2); every product here and below that is rounded again afterwards
  // runs as FMAs in index order (fma_gemm), the order of the plain
  // version's cuBLAS products, so that few of those roundings flip
  auto zero = [](int, int, int) { return 0.f; };
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fc = min(FC, F - f0);
    const bool last = f0 + fc >= F;
    if (f0 > 0) __syncthreads();   // the previous chunk is read
    stage_chunk(f0, fc, f0 == 0);
    fma_gemm(
        2, N, A, fc, [&](int, int n, int f) { return xs[n * fc + f]; },
        [&](int p, int f, int j) { return w1s[(p * FC + f) * AP + j]; },
        [&](int p, int n, int j) { return f0 > 0 ? t1s[(p * N + n) * AP + j] : 0.f; },
        [&](int p, int n, int j, float acc) {
          t1s[(p * N + n) * AP + j] = last ? tanhf(acc + bs[2 * p * A + j]) : acc;
        });
  }
  __syncthreads();
  PHASE_MARK(2);
  fma_gemm(
      2, N, A, A, [&](int p, int n, int j) { return rb(t1s[(p * N + n) * AP + j], bf16); },
      [&](int p, int j, int o) { return w2s[(p * A + j) * AP + o]; }, zero,
      [&](int p, int n, int o, float acc) {
        qo[(p * N + n) * QS + o] = rb(acc + bs[(2 * p + 1) * A + o], bf16);
      });
  __syncthreads();
  PHASE_MARK(3);

  // the map's backward: dq, dk of this channel into d3
  attn_map::backward_tiled(qo, qo + N * QS, g + static_cast<size_t>(blockIdx.x) * N * N, dus,
                           d3, d3 + N * A, d3 + N * A, N, A, ds, R, bf16);
  PHASE_MARK(4);

  // the nets' backward, both nets at once (dout = d3[p]):
  //   dpre = (round(dout) @ round(W2)^T) * (1 - t1^2)   (f32, over q / k)
  //   dW2 = round(t1)^T round(dout)   db2 = sum_n dout   db1 = sum_n dpre
  // dW2 and dW1 are f32 outputs that nothing rounds again: in bf16 mode they
  // run on mma.sync (pack_bf16 rounds their operands as the TPU kernel does)
  const size_t per_net = static_cast<size_t>(C) * (F * A + A + A * A + A);
  float* pb = part + static_cast<size_t>(b) * 2 * per_net;
  auto pw1 = [&](int p) { return pb + p * per_net + static_cast<size_t>(c) * F * A; };
  auto pb1 = [&](int p) { return pb + p * per_net + static_cast<size_t>(C) * F * A + c * A; };
  auto pw2 = [&](int p) {
    return pb + p * per_net + static_cast<size_t>(C) * (F * A + A) +
           static_cast<size_t>(c) * A * A;
  };
  auto pb2 = [&](int p) {
    return pb + p * per_net + static_cast<size_t>(C) * (F * A + A + A * A) + c * A;
  };
  fma_gemm(
      2, N, A, A, [&](int p, int n, int o) { return rb(d3[(p * N + n) * A + o], bf16); },
      [&](int p, int o, int j) { return w2s[(p * A + j) * AP + o]; }, zero,
      [&](int p, int n, int j, float acc) {
        const float t = t1s[(p * N + n) * AP + j];
        qo[(p * N + n) * QS + j] = acc * (1.0f - t * t);
      });
  auto t1_of = [&](int p, int j, int n) { return rb(t1s[(p * N + n) * AP + j], bf16); };
  auto dout_of = [&](int p, int n, int o) { return rb(d3[(p * N + n) * A + o], bf16); };
  auto dw2 = [&](int p, int j, int o, float v) { pw2(p)[j * A + o] = v; };
  if constexpr (BF16)
    hopper::mma_gemm(2, A, A, N, t1_of, dout_of, dw2);
  else
    fma_gemm(2, A, A, N, t1_of, dout_of, zero, dw2);
  for (int i = tid; i < 2 * A; i += THREADS) {
    const int p = i / A, o = i - p * A;
    const float* dc = d3 + p * N * A + o;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc += dc[n * A];
    pb2(p)[o] = acc;
  }
  __syncthreads();
  for (int i = tid; i < 2 * A; i += THREADS) {
    const int p = i / A, j = i - p * A;
    const float* dc = qo + p * N * QS + j;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc += dc[n * QS];
    pb1(p)[j] = acc;
  }
  PHASE_MARK(5);

  // per qk chunk: dW1 = qk^T round(dpre) and this channel's terms of dqk,
  // round(dpre_q) @ round(Wq1)^T and round(dpre_k) @ round(Wk1)^T, apart
  // (dx [2][N][F]: the sum over channels adds them in the plain version's
  // order)
  float* dx = dqk_part + static_cast<size_t>(blockIdx.x) * 2 * N * F;
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fc = min(FC, F - f0);
    __syncthreads();   // dpre is written, the previous chunk read
    stage_chunk(f0, fc, false);
    auto qk_of = [&](int, int f, int n) { return xs[n * fc + f]; };
    auto dpre_of = [&](int p, int n, int j) { return rb(qo[(p * N + n) * QS + j], bf16); };
    auto dw1 = [&](int p, int f, int j, float v) {
      pw1(p)[static_cast<size_t>(f0 + f) * A + j] = v;
    };
    if constexpr (BF16)
      hopper::mma_gemm(2, fc, A, N, qk_of, dpre_of, dw1);
    else
      fma_gemm(2, fc, A, N, qk_of, dpre_of, zero, dw1);
    fma_gemm(
        2, N, fc, A, dpre_of, [&](int p, int j, int f) { return w1s[(p * FC + f) * AP + j]; },
        zero, [&](int p, int n, int f, float acc) {
          dx[(static_cast<size_t>(p) * N + n) * F + f0 + f] = acc;
        });
  }
  PHASE_MARK(6);
}

// dqk[b, n, f] = sum_c (part[b, c, 0, n, f] + part[b, c, 1, n, f]), the
// terms added one by one in channel order, q's before k's (the plain
// version's order), cast once to qk's dtype (NF = N * F)
template <typename T>
__global__ void sum_channels_kernel(const float* __restrict__ part, T* __restrict__ dqk,
                                    int B, int C, int NF) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * NF) return;
  const size_t b = i / NF;
  const float* p = part + b * C * 2 * NF + (i - b * NF);
  float acc = 0.f;
  for (int t = 0; t < 2 * C; ++t) acc += p[static_cast<size_t>(t) * NF];
  attn_map::store(dqk, i, acc);
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

template <typename T, bool BF16, int THREADS>
cudaError_t launch_bwd_kernel(const T* qk, const Nets& nets, const float* g, float* part,
                              float* dqk_part, int B, int N, int F, int C, int A, int ds, int R,
                              int FC, int smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(attn_qk_bank_bwd_kernel<T, BF16, THREADS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_qk_bank_bwd_kernel<T, BF16, THREADS><<<B * C, THREADS, smem, s>>>(
      qk, nets, g, part, dqk_part, N, F, C, A, ds, R, FC);
  return cudaGetLastError();
}

template <typename T, bool BF16>
int launch_bwd_mode(const void* qk, const float* const* w, const float* g, void* dqk,
                    float* wgrad, float* part, int B, int N, int F, int C, int A, int ds, int R,
                    int FC, int smem, cudaStream_t s) {
  const int P = 2 * C * (F * A + A + A * A + A);
  float* dqk_part = part + static_cast<size_t>(B) * P;
  const T* x = static_cast<const T*>(qk);
  const Nets nets = make_nets(w);
  cudaError_t err =
      bwd_threads(smem) == 512
          ? launch_bwd_kernel<T, BF16, 512>(x, nets, g, part, dqk_part, B, N, F, C, A, ds, R,
                                            FC, smem, s)
          : launch_bwd_kernel<T, BF16, 256>(x, nets, g, part, dqk_part, B, N, F, C, A, ds, R,
                                            FC, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * N * F;
  sum_channels_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      dqk_part, static_cast<T*>(dqk), B, C, N * F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partials::sum_rows(part, wgrad, B, P, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* qk, const float* const* w, const float* g, void* dqk,
               float* wgrad, float* part, int B, int N, int F, int C, int A, int ds, int R,
               int FC, int bf16, int smem, cudaStream_t s) {
  return bf16 ? launch_bwd_mode<T, true>(qk, w, g, dqk, wgrad, part, B, N, F, C, A, ds, R, FC,
                                         smem, s)
              : launch_bwd_mode<T, false>(qk, w, g, dqk, wgrad, part, B, N, F, C, A, ds, R,
                                          FC, smem, s);
}

// ---- the tiled plan (the header) ----

using attn_map::kMapTile;
using attn_map::kSlice;
using attn_map::kSliceStride;
using attn_map::kTileThreads;

// t1[(u 2 + p) N + n][j] = tanh(sum_f qk[b, n, f] round(W1_p[c, f, j]) + b1_p[c, j])
// (u = b C + c), one chain in f order from 0, f32
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
nets_t1_kernel(const T* __restrict__ qk, Nets nets, float* __restrict__ t1, int B, int N,
               int F, int C, int A, int bf16) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kTileThreads + threadIdx.x;
  if (i >= static_cast<size_t>(B) * C * 2 * N * A) return;
  const int j = static_cast<int>(i % A);
  size_t r = i / A;
  const int n = static_cast<int>(r % N);
  r /= N;
  const int p = static_cast<int>(r % 2);
  const size_t u = r / 2;
  const int c = static_cast<int>(u % C);
  const size_t b = u / C;
  const T* x = qk + (b * N + n) * F;
  const float* w = nets.p[p].w1 + static_cast<size_t>(c) * F * A + j;
  float acc = 0.f;
  for (int f = 0; f < F; ++f)
    acc = fmaf(attn_map::load(x, f), rb(w[static_cast<size_t>(f) * A], bf16), acc);
  t1[i] = tanhf(acc + nets.p[p].b1[static_cast<size_t>(c) * A + j]);
}

// out[(u 2 + p) N + n][o] = round(sum_j round(t1[..][j]) round(W2_p[c, j, o]) + b2_p[c, o])
__global__ void __launch_bounds__(kTileThreads)
nets_out_kernel(const float* __restrict__ t1, Nets nets, float* __restrict__ out, int B, int N,
                int C, int A, int bf16) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kTileThreads + threadIdx.x;
  if (i >= static_cast<size_t>(B) * C * 2 * N * A) return;
  const int o = static_cast<int>(i % A);
  const size_t row = i / A;
  const int p = static_cast<int>((row / N) % 2);
  const int c = static_cast<int>((row / N / 2) % C);
  const float* t = t1 + row * A;
  const float* w = nets.p[p].w2 + static_cast<size_t>(c) * A * A + o;
  float acc = 0.f;
  for (int j = 0; j < A; ++j)
    acc = fmaf(rb(t[j], bf16), rb(w[static_cast<size_t>(j) * A], bf16), acc);
  out[i] = rb(acc + nets.p[p].b2[static_cast<size_t>(c) * A + o], bf16);
}

// One (graph, channel, 32 x 32 tile) of the forward's map; a thread the
// 2 x 2 pairs (n, n + 16) x (m, m + 16) of the tile.
__global__ void __launch_bounds__(kTileThreads)
map_fwd_tiled_kernel(const float* __restrict__ qo, float* __restrict__ out, int N, int A,
                     int ds, int tiles) {
  __shared__ float qs[kMapTile * kSliceStride], ks[kMapTile * kSliceStride];
  const long long blk = blockIdx.x;
  const int tm = static_cast<int>(blk % tiles), tn = static_cast<int>((blk / tiles) % tiles);
  const size_t u = static_cast<size_t>(blk / tiles / tiles);
  const float* q = qo + u * 2 * N * A;
  const float* k = q + static_cast<size_t>(N) * A;
  const int n0 = tn * kMapTile, m0 = tm * kMapTile;
  const int nl = threadIdx.x / 16, ml = threadIdx.x % 16;
  const int H = A / ds;
  const float inv = attn_map::inv_sqrt(ds);
  float uu[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int a0 = 0; a0 < A; a0 += kSlice) {
    __syncthreads();   // the last slice is read
    attn_map::stage_slice(qs, q, n0, N, a0, A, 0);
    attn_map::stage_slice(ks, k, m0, N, a0, A, 0);
    __syncthreads();
    const int w = min(kSlice, A - a0);
    for (int a = 0; a < w; ++a) {
      const float qa[2] = {qs[nl * kSliceStride + a], qs[(nl + 16) * kSliceStride + a]};
      const float ka[2] = {ks[ml * kSliceStride + a], ks[(ml + 16) * kSliceStride + a]};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) uu[i][jj] = fmaf(qa[i], ka[jj], uu[i][jj]);
      if ((a0 + a + 1) % ds == 0) {   // a head ends: its tanh joins the sum
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            acc[i][jj] += tanhf(uu[i][jj] * inv);
            uu[i][jj] = 0.f;
          }
      }
    }
  }
  float* ob = out + u * N * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int n = n0 + nl + 16 * i, m = m0 + ml + 16 * jj;
      if (n < N && m < N) ob[static_cast<size_t>(n) * N + m] = acc[i][jj] / static_cast<float>(H);
    }
}

// dpre[(u 2 + p) N + n][j] = (sum_o round(d3[..][o]) round(W2_p[c, j, o])) (1 - t1^2)
__global__ void __launch_bounds__(kTileThreads)
dpre_kernel(const float* __restrict__ d3, const float* __restrict__ t1, Nets nets,
            float* __restrict__ dpre, int B, int N, int C, int A, int bf16) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kTileThreads + threadIdx.x;
  if (i >= static_cast<size_t>(B) * C * 2 * N * A) return;
  const int j = static_cast<int>(i % A);
  const size_t row = i / A;
  const int p = static_cast<int>((row / N) % 2);
  const int c = static_cast<int>((row / N / 2) % C);
  const float* dr = d3 + row * A;
  const float* w = nets.p[p].w2 + (static_cast<size_t>(c) * A + j) * A;
  float acc = 0.f;
  for (int o = 0; o < A; ++o) acc = fmaf(rb(dr[o], bf16), rb(w[o], bf16), acc);
  const float t = t1[i];
  dpre[i] = acc * (1.0f - t * t);
}

// The weight gradients of (graph b, net p, channel c) into graph b's
// partial row (attn_qk_bank_bwd_kernel's layout), a thread per element:
// dW1[f, j] = sum_n qk[n, f] round(dpre[n, j]), db1[j] = sum_n dpre[n, j],
// dW2[j, o] = sum_n round(t1[n, j]) round(d3[n, o]), db2[o] = sum_n d3[n, o],
// each a chain over n in order.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
wgrad_kernel(const T* __restrict__ qk, const float* __restrict__ t1,
             const float* __restrict__ d3, const float* __restrict__ dpre,
             float* __restrict__ part, int B, int N, int F, int C, int A, int bf16) {
  const size_t FA = static_cast<size_t>(F) * A, AA = static_cast<size_t>(A) * A;
  const size_t Q = FA + A + AA + A;
  const size_t i = static_cast<size_t>(blockIdx.x) * kTileThreads + threadIdx.x;
  if (i >= static_cast<size_t>(B) * 2 * C * Q) return;
  const size_t q = i % Q;
  size_t r = i / Q;
  const int c = static_cast<int>(r % C);
  r /= C;
  const int p = static_cast<int>(r % 2);
  const size_t b = r / 2;
  const size_t row = ((b * C + c) * 2 + p) * N;   // the unit's rows of t1, d3, dpre
  const size_t per_net = static_cast<size_t>(C) * Q;
  float* pb = part + b * 2 * per_net + p * per_net;
  float acc = 0.f;
  if (q < FA) {   // dW1
    const int f = static_cast<int>(q / A), j = static_cast<int>(q % A);
    const T* x = qk + b * N * F + f;
    for (int n = 0; n < N; ++n)
      acc = fmaf(attn_map::load(x, static_cast<size_t>(n) * F),
                 rb(dpre[(row + n) * A + j], bf16), acc);
    pb[static_cast<size_t>(c) * FA + q] = acc;
  } else if (q < FA + A) {   // db1
    const size_t j = q - FA;
    for (int n = 0; n < N; ++n) acc += dpre[(row + n) * A + j];
    pb[C * FA + static_cast<size_t>(c) * A + j] = acc;
  } else if (q < FA + A + AA) {   // dW2
    const size_t jo = q - FA - A;
    const size_t j = jo / A, o = jo % A;
    for (int n = 0; n < N; ++n)
      acc = fmaf(rb(t1[(row + n) * A + j], bf16), rb(d3[(row + n) * A + o], bf16), acc);
    pb[C * (FA + A) + static_cast<size_t>(c) * AA + jo] = acc;
  } else {   // db2
    const size_t o = q - FA - A - AA;
    for (int n = 0; n < N; ++n) acc += d3[(row + n) * A + o];
    pb[C * (FA + A + AA) + static_cast<size_t>(c) * A + o] = acc;
  }
}

// dqk_part[(u 2 + p) N + n][f] = sum_j round(dpre[..][j]) round(W1_p[c, f, j])
__global__ void __launch_bounds__(kTileThreads)
dqk_terms_kernel(const float* __restrict__ dpre, Nets nets, float* __restrict__ dqk_part, int B,
                 int N, int F, int C, int A, int bf16) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kTileThreads + threadIdx.x;
  if (i >= static_cast<size_t>(B) * C * 2 * N * F) return;
  const int f = static_cast<int>(i % F);
  const size_t row = i / F;
  const int p = static_cast<int>((row / N) % 2);
  const int c = static_cast<int>((row / N / 2) % C);
  const float* d = dpre + row * A;
  const float* w = nets.p[p].w1 + (static_cast<size_t>(c) * F + f) * A;
  float acc = 0.f;
  for (int j = 0; j < A; ++j) acc = fmaf(rb(d[j], bf16), rb(w[j], bf16), acc);
  dqk_part[i] = acc;
}

unsigned grid_of(size_t items) {
  return static_cast<unsigned>((items + kTileThreads - 1) / kTileThreads);
}

// t1 and q / k of every (graph, channel, net) row: the tiled plan's first
// two launches.
template <typename T>
int launch_nets_tiled(const T* qk, const Nets& nets, float* t1, float* qo, int B, int N, int F,
                      int C, int A, int bf16, cudaStream_t s) {
  const size_t items = static_cast<size_t>(B) * C * 2 * N * A;
  nets_t1_kernel<T><<<grid_of(items), kTileThreads, 0, s>>>(qk, nets, t1, B, N, F, C, A, bf16);
  nets_out_kernel<<<grid_of(items), kTileThreads, 0, s>>>(t1, nets, qo, B, N, C, A, bf16);
  return static_cast<int>(cudaGetLastError());
}

// scratch: t1 and q / k, [B C 2][N][A] floats each
template <typename T>
int launch_fwd_tiled(const void* qk, const float* const* w, float* out, float* scratch, int B,
                     int N, int F, int C, int A, int ds, int bf16, cudaStream_t s) {
  const size_t un = static_cast<size_t>(B) * C * 2 * N * A;
  float *t1 = scratch, *qo = scratch + un;
  const int rc = launch_nets_tiled<T>(static_cast<const T*>(qk), make_nets(w), t1, qo, B, N, F,
                                      C, A, bf16, s);
  if (rc != 0) return rc;
  const int tiles = (N + kMapTile - 1) / kMapTile;
  map_fwd_tiled_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * C * tiles * tiles),
                         kTileThreads, 0, s>>>(qo, out, N, A, ds, tiles);
  return static_cast<int>(cudaGetLastError());
}

// scratch: t1, q / k, d3 and dpre, [B C 2][N][A] floats each
template <typename T>
int launch_bwd_tiled(const void* qk, const float* const* w, const float* g, void* dqk,
                     float* wgrad, float* part, float* scratch, int B, int N, int F, int C,
                     int A, int ds, int bf16, cudaStream_t s) {
  const size_t un = static_cast<size_t>(B) * C * 2 * N * A;
  float *t1 = scratch, *qo = scratch + un, *d3 = scratch + 2 * un, *dpre = scratch + 3 * un;
  const T* x = static_cast<const T*>(qk);
  const Nets nets = make_nets(w);
  const int rc = launch_nets_tiled<T>(x, nets, t1, qo, B, N, F, C, A, bf16, s);
  if (rc != 0) return rc;
  const int tiles = (N + kMapTile - 1) / kMapTile, H = A / ds;
  const int slices = (ds + kSlice - 1) / kSlice;
  const unsigned units =
      static_cast<unsigned>(static_cast<long long>(B) * C * tiles * H * slices);
  // q at qo + u 2 N A, k N A past it, d3 likewise (dq then dk)
  const size_t na = static_cast<size_t>(N) * A;
  attn_map::map_dqk_kernel<true, float, float><<<units, kTileThreads, 0, s>>>(
      qo, qo + na, 2 * na, g, d3, 2 * na, N, A, ds, tiles, slices, bf16, 0);
  attn_map::map_dqk_kernel<false, float, float><<<units, kTileThreads, 0, s>>>(
      qo, qo + na, 2 * na, g, d3 + na, 2 * na, N, A, ds, tiles, slices, bf16, 0);
  dpre_kernel<<<grid_of(un), kTileThreads, 0, s>>>(d3, t1, nets, dpre, B, N, C, A, bf16);
  const size_t P = 2 * static_cast<size_t>(C) * (static_cast<size_t>(F) * A + A +
                                                 static_cast<size_t>(A) * A + A);
  wgrad_kernel<T><<<grid_of(B * P), kTileThreads, 0, s>>>(x, t1, d3, dpre, part, B, N, F, C, A,
                                                          bf16);
  float* dqk_part = part + B * P;
  dqk_terms_kernel<<<grid_of(static_cast<size_t>(B) * C * 2 * N * F), kTileThreads, 0, s>>>(
      dpre, nets, dqk_part, B, N, F, C, A, bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * N * F;
  sum_channels_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      dqk_part, static_cast<T*>(dqk), B, C, N * F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partials::sum_rows(part, wgrad, B, static_cast<int>(P), s);
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
// (cudaErrorInvalidValue if it disagrees with the layout).  tiled: the
// tiled plan instead, with 2 x (B C 2 N A) floats of caller-allocated
// scratch (fc and smem are then not read).  Needs A % ds == 0.
extern "C" int attn_qk_bank_fwd(const void* qk, const float* const* w, float* out, int B,
                                int N, int F, int C, int A, int ds, int in_bf16, int bf16,
                                int fc, int smem, float* tiled, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled)
    return in_bf16 ? launch_fwd_tiled<__nv_bfloat16>(qk, w, out, tiled, B, N, F, C, A, ds,
                                                     bf16, s)
                   : launch_fwd_tiled<float>(qk, w, out, tiled, B, N, F, C, A, ds, bf16, s);
  if (fc < 1 || fc > F || smem != 4 * fwd_layout(N, fc, A).total)
    return static_cast<int>(cudaErrorInvalidValue);
  return in_bf16
             ? launch_fwd<__nv_bfloat16>(qk, w, out, B, N, F, C, A, ds, fc, bf16, smem, s)
             : launch_fwd<float>(qk, w, out, B, N, F, C, A, ds, fc, bf16, smem, s);
}

// The backward's plan at these widths: out[0] the map backward's row tile,
// out[1] the feature chunk, out[2] the shared memory in bytes (past
// kSmemLimit where nothing fits).  ops/attn_qk_bank.py::bwd_plan is the
// same.
extern "C" void attn_qk_bank_bwd_plan(int N, int F, int A, int H, int* out) {
  const BwdPlan p = make_bwd_plan(N, F, A, H);
  out[0] = p.rows;
  out[1] = p.fc;
  out[2] = p.smem;
}

// g [B, C, N, N] f32; dqk [B, N, F] in qk's dtype; wgrad: the eight weight
// gradients packed as [dWq1 dbq1 dWq2 dbq2 dWk1 dbk1 dWk2 dbk2] (P floats);
// part: caller-allocated scratch of B * P + 2 * B * C * N * F floats; rows, fc
// and smem the plan's (cudaErrorInvalidValue if they disagree).  tiled:
// the tiled plan instead, with 4 x (B C 2 N A) floats of caller-allocated
// scratch (rows, fc and smem not read).  Needs A % ds == 0.
extern "C" int attn_qk_bank_bwd(const void* qk, const float* const* w, const float* g,
                                void* dqk, float* wgrad, float* part, int B, int N, int F,
                                int C, int A, int ds, int in_bf16, int bf16, int rows, int fc,
                                int smem, float* tiled, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled)
    return in_bf16 ? launch_bwd_tiled<__nv_bfloat16>(qk, w, g, dqk, wgrad, part, tiled, B, N,
                                                     F, C, A, ds, bf16, s)
                   : launch_bwd_tiled<float>(qk, w, g, dqk, wgrad, part, tiled, B, N, F, C, A,
                                             ds, bf16, s);
  const BwdPlan p = make_bwd_plan(N, F, A, A / ds);
  if (rows != p.rows || fc != p.fc || smem != p.smem)
    return static_cast<int>(cudaErrorInvalidValue);
  return in_bf16 ? launch_bwd<__nv_bfloat16>(qk, w, g, dqk, wgrad, part, B, N, F, C, A,
                                             ds, rows, fc, bf16, smem, s)
                 : launch_bwd<float>(qk, w, g, dqk, wgrad, part, B, N, F, C, A, ds, rows, fc,
                                     bf16, smem, s);
}
