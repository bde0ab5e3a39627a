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
// cores' rate), operations in f32 mode on the CUDA cores.  Design: one
// block per graph walking the channels in order, as the TPU kernel's grid
// step does.  qk[b] is staged once in shared memory ([N, F] f32: 115 KB
// at variant 3's F = 900); a thread per (n, j) forms pre = qk[n] . W1[:, j]
// reading W1 rows straight from global memory (neighbouring threads on
// neighbouring j, every warp of the block on the same rows, so the reads
// are coalesced and served by L1 after the first warp), then t1, then q or
// k against W2 staged in shared memory, then K7's map for the channel.
// Only qk, the weights and a touch device memory.
//
// The TPU verdict ("rejected") does not carry over.  On the TPU the
// statically unrolled channels x heads structure turned one batched
// contraction into 64 small matrix-unit dots that ran one after another.
// On this card the small dots are plain per-thread loops on the CUDA
// cores, 128 blocks run side by side, and the eager chain around the
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
#include "partials.cuh"

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

template <typename T>
__global__ void __launch_bounds__(1024)
attn_qk_bank_fwd_kernel(const T* __restrict__ qk, Nets nets, float* __restrict__ out,
                        int N, int F, int C, int A, int ds, int bf16) {
  extern __shared__ float smem[];
  const int AP = A + 1;
  float* qks = smem;              // [N][F]
  float* t1s = qks + N * F;       // [N][A + 1]
  float* qs = t1s + N * AP;       // [N][A + 1]
  float* ks = qs + N * AP;        // [N][A + 1]
  float* w2s = ks + N * AP;       // [A][A + 1]
  const int b = blockIdx.x;
  stage_qk(qk + static_cast<size_t>(b) * N * F, qks, N, F);
  __syncthreads();
  for (int c = 0; c < C; ++c) {
    run_net(qks, nets.p[0], c, t1s, w2s, qs, N, F, A, bf16);
    run_net(qks, nets.p[1], c, t1s, w2s, ks, N, F, A, bf16);
    attn_map::forward(qs, ks, out + (static_cast<size_t>(b) * C + c) * N * N, N, A, ds);
    __syncthreads();              // qs / ks are rewritten by the next channel
  }
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

template <typename T>
int launch_fwd(const void* qk, const float* const* w, float* out, int B, int N, int F,
               int C, int A, int ds, int bf16, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_qk_bank_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = N * N > N * A ? N * N : N * A;
  attn_qk_bank_fwd_kernel<T><<<B, attn_map::threads_for(work), smem, s>>>(
      static_cast<const T*>(qk), make_nets(w), out, N, F, C, A, ds, bf16);
  return static_cast<int>(cudaGetLastError());
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

// qk [B, N, F] (bf16 if in_bf16, else f32); w: the eight f32 weight pointers
// (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2); out [B, C, N, N] f32.  smem is
// the wrapper's count of the block's shared memory.  Needs A % ds == 0.
extern "C" int attn_qk_bank_fwd(const void* qk, const float* const* w, float* out, int B,
                                int N, int F, int C, int A, int ds, int in_bf16, int bf16,
                                int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16
             ? launch_fwd<__nv_bfloat16>(qk, w, out, B, N, F, C, A, ds, bf16, smem, s)
             : launch_fwd<float>(qk, w, out, B, N, F, C, A, ds, bf16, smem, s);
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
