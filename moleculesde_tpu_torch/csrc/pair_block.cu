// Fused pair block, forward (K3):
//   out[b, s, d, h] = sum_c relu(a[b, s, c] + cc[b, d, c]) * w[c, h] + bias[h]
// with a, cc [B, N, C] f32, w [C, H] f32, bias [H] f32, out [B, N, N, H] f32.
// The [B, N, N, C] pair tensor is never written to device memory.
//
// Replaces the Pallas kernel moleculesde_tpu/ops/pair_block.py::_fwd_kernel
// (pallas_call at l.170, entry pair_relu_project l.449).
//
// Bound: per graph one GEMM, out[pairs, H] = relu(a_s + c_d)[pairs, C] @
// W[C, H] (M = N^2, K = C, n = H): 2 N^2 C H operations against the
// output's 4 N^2 H bytes.  In bf16 the output's bytes bound it (16.8 MB at
// B=128, N=32, C=300, H=32: 5 us), in f32 the CUDA cores' 67 TFLOP/s.
// Design (redesigned for the tensor cores):
//  * Unit = (graph, dest tile of 16 d, source tile of TS s rows), numbered
//    graph-major, so a graph's a and cc rows are read while they sit in L2.
//    Persistent blocks, as many as are resident (the occupancy query), walk
//    the units blockIdx.x, + gridDim.x, ...  A block has 16 TS threads; TS
//    is 32, or 16 where 32 does not fit, or 8 where 16 does not (a wide W:
//    f32 at C = 300, H = 128) (fwd_ts).
//  * A block stages W once (bf16 mode rounded to bf16, [C'][H' + 8] halves;
//    f32 [C'][H'] floats), then per unit only that unit's TS a rows and 16
//    cc rows, f32, with cp.async, double buffered: the next unit's rows fly
//    while this one computes.  C is zero-padded to C', a multiple of 16
//    (each padded channel adds relu(0) * 0 = 0), N to whole tiles (rows
//    past N zero-filled, their outputs dropped), H to H', passes of 32 (zero
//    columns of W).  Shared memory does not depend on N: the forward takes
//    any N whose B N^2 H output the int32 index reaches.  A staged row keeps
//    each 16-channel group in the order a lane's A fragment reads it
//    (fwd_slot: channels 2 r4, 2 r4 + 1, 2 r4 + 8, 2 r4 + 9 side by side),
//    so one vector load gives a lane its four channels of a row.
//  * bf16 mode on the tensor cores (mma.sync m16n8k16 bf16 -> f32): a warp
//    owns two source rows of the unit and the 32 h of a pass.  The m16 rows
//    of the A fragment are the unit's 16 dests, its k16 columns 16
//    channels: a lane loads cc at its two dests (two vector loads a k step,
//    shared by the warp's rows) and a[s] (one), adds, relus and packs in
//    registers (8 FADD, 4 cvt.rn.relu.bf16x2) and never stores the
//    fragment.  W's B fragments come from the resident copy by ldmatrix
//    .trans, two x4 loads a k step for both rows: 4 HMMA per (row, k step).
//    K3 forms the pair in f32 and rounds relu(pair) and W; K4 rounds a and
//    cc at the stage, before the add, as the TPU kernel casts its inputs.
//  * f32 mode keeps f32 products (its bar is 1e-5, so not TF32): the same
//    units and stages, a thread owning 2 source rows x 2 dests x 8 h, one
//    vector load of each of its rows per 4 channels: each relu'd pair feeds
//    8 FMAs, each W value read serves 4 pairs.
//  * Stores: K3 writes [B, N, N, H], the bias added after the product in
//    f32; K4 [B, H, N*N], each h row's 16 pairs s N + d0 .. d0 + 15 of a
//    unit contiguous.  The accumulators go out directly from registers: at
//    N and H multiples of 8 each store instruction fills whole 32-byte
//    sectors.  Each output is written once, by one lane, its k order fixed:
//    two runs give the same bits.
//  * What holds it back (benchmarks/profile_gin_pair.py --phases, PERF.md):
//    not the tensor cores.  A unit takes ~7 us on the H100: its 16 warps
//    issue ~40 instructions a k step (the A build; the loads of cc, a and
//    W's fragments, ~18 shared-memory wavefronts a warp) for 8 HMMAs.  At
//    B=128, N=32 a block (two units) also spends ~3.8 us staging W and
//    ~2.4 us more waiting for its first unit's rows.  With -DPHASE_PROFILE
//    thread 0 stamps the start, W staged, the first unit staged, the first
//    unit done, the last unit staged and the end.
// Shared memory: W (bf16 C' (H' + 8) x 2 B, f32 C' H' x 4 B) and two stages
// of (TS + 16) rows of C' + 16 or C' floats (fwd_smem).
//
// Backward (replaces _bwd_kernel, pallas_call at l.193):
//   pair[s, d, c] = a[s, c] + cc[d, c]                     (f32)
//   dpair         = 1[pair > 0] * sum_h g[s, d, h] * w[c, h]
//   da[s, c] = sum_d dpair,  dc[d, c] = sum_s dpair
//   dw[c, h] = sum_{b, s, d} relu(pair)[s, d, c] * g[s, d, h]
//   db[h]    = sum_{b, s, d} g[s, d, h]
// bf16 mode rounds g, w and relu(pair) to bf16 for the two products (the
// relu mask still comes from the f32 pair) and keeps db in f32, as the TPU
// kernel does.  Bound: arithmetic, 4*N*N*C*H flops per graph (two
// products), 5.0 GFLOP at B=128, N=32, C=300, H=32 (5 us on the bf16
// tensor cores), 20 GFLOP at B=32, N=128.  Both products are per-graph
// GEMMs: dpair^T [C, pairs] = W [C, H] @ g^T (K = H = 32) and dW [C, H] =
// relu(pair)^T @ g (K = pairs).  Design (redesigned for the tensor cores):
//  * Block = (graph, chunk of CH channels), numbered graph-major, so the
//    chunks of a graph read its g while it sits in L2; CH = 64, or 32 where
//    64 does not fit (bwd_chunk: 64 up to N = 366, 32 up to 748), C padded
//    to a multiple of CH with zero rows.  Two halves of CH / 32 warps (bf16;
//    a warp owns 32 channels, two m16 tiles that share each g fragment) or
//    CH / 16 warps (f32): warp (cg, half) owns its channels and half of each
//    stage's source rows.
//  * Work = (dest tile of 16 d, source row s) tiles: the dest tile is the
//    outer loop, so the lane's cc values and dc sums for it stay in
//    registers; da[s] sums over the dest tiles in shared memory.  Stages of
//    8 source rows x 16 dest nodes of g are copied with cp.async, double
//    buffered (the next stage flies while this one computes), zero-filled
//    past N and H, a thread's slots fixed at compile time; bf16 mode rounds
//    each stage once into a bf16 tile.
//  * bf16 mode, per tile, on the tensor cores (mma.sync m16n8k16 bf16 ->
//    f32): W's A fragments stay in registers for the whole block; g's B
//    fragments come through ldmatrix (.trans where the layout is [k][n]).
//    The dpair^T accumulator of a 16 x 16 tile has exactly the layout of an
//    m16k16 A fragment, so the pair is formed in registers at those
//    positions (a from shared memory, cc from registers), relu'd and
//    packed to bf16 in one cvt and fed straight to the dW product: the pair
//    tensor never reaches shared or device memory.  The mask (f32 pair > 0)
//    and K4's rounding apply to the accumulator elements; da is reduced
//    over the quad's lanes by a reduce-scatter (3 shuffles a row), each
//    lane adding one channel's sum to its row in shared memory, and dc
//    stays in registers.
//    a's columns and the da sums keep a lane's channels side by side
//    (chan_slot), so one vector load reads a[s] for a row.
//  * f32 mode keeps f32 products (its bar against plain is 1e-4, so not
//    TF32): the same blocks, stages and lane positions, the two products as
//    f32 FMAs on the CUDA cores into 8 + 64 independent accumulators a lane
//    (its 8 dpair values over h, its dW partial over its pairs, W's two
//    rows in registers), g read from the f32 stage 4 h at a time.
//  * Fixed orders: dc of the two halves added half 0 first, dW likewise
//    (f32: over the quad's lanes first); db (K3, chunk 0) sums the f32
//    stages' unrounded g, a thread a column, then the threads in order; a
//    second launch adds the graphs' dW and db partials (partials.cuh).  No
//    atomics: the same bits on every run.
//  * What holds it back (benchmarks/profile_gin_pair.py, PERF.md): not the
//    tensor cores.  The ~7 elementwise operations per (pair, channel) issue
//    at a third of the card's rate, and each block stages and rounds all
//    of its graph's g, once per channel chunk.  With -DPHASE_PROFILE,
//    thread 0 stamps the start, a's staging, the first three stages, the
//    last and the end.
// Shared memory: (2 N CH + 32 CH) words + a 36 KB stage area (bwd_smem).
//  * The tiled plan, where the whole-graph plan does not fit (N > 748) or H
//    > 32 (make_bwd_plan): blocks of (graph, row tile of RS source rows,
//    pass hpd of h, 64 channels), RS = 128 (64 with passes), so shared
//    memory does not grow with N.  A block walks every dest tile for its
//    rows: da of its rows is whole and goes out; dc of its rows is a
//    partial, one per tile ([B, tiles, N, C]), and a second launch adds
//    the tiles in order (sum_tiles_kernel); dW and db partials are one row
//    per (graph, tile).  H > 32 runs in HP = ceil(H / 32) passes of 32 h:
//    a block of pass 0 stages every pass of each (dest tile, 8 rows) in
//    turn and carries the lane's dpair accumulators between passes in
//    shared memory ([128][CH]), so dpair is one f32 sum over all of H
//    before the relu mask and K4's single bf16 rounding, as in the plain
//    version; its W fragments are reloaded per pass.  It gives pass 0's dW
//    (and db); a block of pass hpd > 0 stages only its pass and gives only
//    that pass's dW (and db).  At tiles = HP = 1 it is the whole-graph
//    plan, the same code and bits.
//
// K4, the channel-major variant (template flag CM), replaces
// moleculesde_tpu/ops/pair_block.py::_fwd_kernel_cm (pallas_call at l.337)
// and ::_bwd_kernel_cm (l.361), entry pair_relu_project_cm (l.409):
//   out[b, h, s*N + d] = sum_c relu(a[b, s, c] + cc[b, d, c]) * w[c, h]
// with no bias (the wrapper adds it, so autograd gives db).  The TPU kernel
// builds the pair slab [C, N*N] with two selector matmuls because its lanes
// want the N*N axis minor; on this card the pair value is formed in
// registers as in K3, and only the store changes: a unit's 16 dests of one
// source row are contiguous in each h row.  Same bound as K3: the output's
// bytes (bf16) or 2*N*N*C*H operations (f32) per graph forward,
// 4*N*N*C*H backward.  Its bf16 mode rounds where the
// TPU kernel rounds, which is not where K3 does: a and cc are rounded to
// bf16 BEFORE the add (the TPU kernel casts its inputs), the relu mask
// comes from that f32 sum, and the backward rounds the masked dpair to
// bf16 before the da / dc sums.  The backward is K3's template with CM:
// its stages keep g's [H, N*N] rows, so the ldmatrix transposes swap, and
// it gives no db.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <atomic>
#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "partials.cuh"

constexpr int kPhaseSlots = 8;   // PHASE_PROFILE marks per block (both directions)

namespace {

constexpr int kChanTile = 32;  // output channels held in registers per pass

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- backward (K3 and K4): see the header ----

constexpr int kStageRows = 8;                          // source rows per stage
constexpr int kDTile = 16;                             // dest nodes per tile
constexpr int kStagePairs = kStageRows * kDTile;       // pair rows per stage
constexpr int kSlots = kStagePairs * kChanTile / 4;    // 16-byte slots of g per stage
constexpr size_t kStageBytes = 36864;                  // the stage area, every layout

// A stage of g in shared memory: K3 keeps g's pair rows ([128][32]), K4 its
// channel rows ([32][128]), each padded so that the rows a warp reads
// together fall in distinct banks.  f32 mode computes on two f32 tiles of
// FS floats a row; bf16 mode copies into one f32 tile (unpadded) and
// computes on two bf16 tiles of BS halves a row.
template <bool CM, bool BF16>
struct StageLayout {
  static constexpr int kRows = CM ? kChanTile : kStagePairs;
  static constexpr int kCols = CM ? kStagePairs : kChanTile;
  static constexpr int FS = kCols + (BF16 ? 0 : 4);
  static constexpr int BS = kCols + 8;
  static constexpr int kTile32 = kRows * FS;
  static constexpr int kTile16 = kRows * BS;
  static_assert((BF16 ? 4 * kTile32 + 2 * 2 * kTile16 : 2 * 4 * kTile32) <= kStageBytes,
                "stage area");
};

// Channels a warp owns: two m16 tiles in bf16 mode (they share each g
// fragment), one in f32 mode (a lane holds W's rows and its dW partial).
template <bool BF16>
constexpr int kWarpChan = BF16 ? 32 : 16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// pack_bf16(relu(lo), relu(hi)) in one instruction
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Threads of a block of CH channels: two halves of CH / kWarpChan warps.
template <bool BF16, int CH>
constexpr int kBwdThreads = 2 * 32 * (CH / kWarpChan<BF16>);

// Where channel k of a block's chunk sits in a row of a's columns and of
// the da sums: a lane's 2 MT channels (m tile mt, accumulator rows q and
// q + 8) side by side, so one vector load reads them.
template <bool BF16>
__device__ __forceinline__ int chan_slot(int k) {
  constexpr int W = kWarpChan<BF16>;
  const int rem = k % W, q = rem % 8;
  return k - rem + q * (W / 8) + rem / 8;   // rem / 8 = 2 mt + hi
}

// TILED: the tiled plan's instantiation (row tiles, passes of h); the
// whole-graph plan's (TILED false) takes RS = N, one tile and one pass as
// compile-time facts, so its code is the plan's own.
template <bool CM, bool BF16, int CH, bool TILED>
__global__ void __launch_bounds__(kBwdThreads<BF16, CH>, BF16 ? 3 : 1)
pair_relu_project_bwd_kernel(const float* __restrict__ a,
                             const float* __restrict__ cc,
                             const float* __restrict__ w,
                             const float* __restrict__ g,
                             float* __restrict__ da,
                             float* __restrict__ dc,
                             float* __restrict__ dw_part,   // [B tiles, C, H]
                             float* __restrict__ db_part,   // [B tiles, H]; !CM
                             float* __restrict__ dc_part,   // [B, tiles, N, C]; tiles > 1
                             int N, int C, int H, int chunks, int RS_, int tiles_,
                             int HP_) {
  using L = StageLayout<CM, BF16>;
  const int RS = TILED ? RS_ : N, tiles = TILED ? tiles_ : 1, HP = TILED ? HP_ : 1;
  constexpr int MT = kWarpChan<BF16> / 16;          // m16 tiles a warp
  constexpr int nthr = kBwdThreads<BF16, CH>;
  constexpr int kPer = kSlots / nthr;                // g slots a thread copies per stage
  static_assert(kSlots % nthr == 0, "slots per thread");
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                                  // [RS][CH] a's chunk columns
  float* das = as + RS * CH;                         // [RS][CH] da sums (both chan_slot order)
  float* dcx = das + RS * CH;                        // [2][kDTile][CH] half 1's dc
  float* drx = dcx + 2 * kDTile * CH;                // [kStagePairs][CH] dpair between passes
  float* stage = drx + (HP > 1 ? kStagePairs * CH : 0);   // kStageBytes
  float* tile32 = stage;
  __nv_bfloat16* tile16 = reinterpret_cast<__nv_bfloat16*>(stage + L::kTile32);

  // graph-major block numbers: ((b tiles + tile) HP + hpd) chunks + chunk
  int unit = blockIdx.x;
  const int chunk = unit % chunks;
  unit /= chunks;
  const int hpd = unit % HP;                         // the pass of h whose dW (and db) it gives
  unit /= HP;
  const int tile = unit % tiles;                     // its source rows [s_lo, s_hi)
  const int b = unit / tiles;
  const int s_lo = tile * RS, s_hi = min(N, s_lo + RS), rows_t = s_hi - s_lo;
  // blocks of passes hpd > 0 give only dW (and db) of their pass; a block
  // of pass 0 sums dpair over every pass and gives da, dc and pass 0's dW
  const bool dw_only = hpd > 0;
  const int hps = dw_only ? 1 : HP;                  // passes a block stages
  const int c0 = chunk * CH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int groups = CH / kWarpChan<BF16>;
  const int cg = warp % groups;                      // the warp's channels
  const int half = warp / groups;                    // the warp's rows of a stage
  const int q = lane >> 2, r4 = lane & 3;
  const int slot0 = cg * kWarpChan<BF16> + q * 2 * MT;   // the lane's channels' chan_slot
  // the lane's channels in the chunk: [m tile][accumulator rows q, q + 8]
  int cl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    cl[mt][0] = cg * kWarpChan<BF16> + 16 * mt + q;
    cl[mt][1] = cl[mt][0] + 8;
  }
  const bool round_halves = CM && BF16;
  const size_t nn = static_cast<size_t>(N) * N;
  const float* ab = a + static_cast<size_t>(b) * N * C;
  const float* cb = cc + static_cast<size_t>(b) * N * C;
  const float* gb = g + static_cast<size_t>(b) * nn * H;
  const bool db_block = !CM && chunk == 0;
  const bool vec = CM ? (N % 4 == 0) : (H % 4 == 0);  // 16-byte aligned g slots

  PHASE_MARK(0);
  for (int i = tid; i < rows_t * CH; i += nthr) {
    const int r = i / CH, k = i - r * CH;
    const float v = c0 + k < C ? ab[static_cast<size_t>(s_lo + r) * C + c0 + k] : 0.f;
    as[r * CH + chan_slot<BF16>(k)] = round_halves ? round_bf16(v) : v;
    das[i] = 0.f;
  }
  int h0 = (dw_only ? hpd : 0) * kChanTile;          // the first h of the pass W is loaded for
  auto wval = [&](int cl_, int h) {
    const int c = c0 + cl_;
    h += h0;
    const float v = (c < C && h < H) ? w[static_cast<size_t>(c) * H + h] : 0.f;
    return BF16 ? round_bf16(v) : v;
  };
  // BF16: W's A fragments (m = channel, k = h), the dW accumulator
  // fragments (m = channel, n = h); f32: W's two rows and the lane's dW
  // partial over its pairs
  uint32_t wa[MT][2][4];
  float dwa[MT][4][4];
  float wr[2][kChanTile], dwr[2][kChanTile];
  auto load_w = [&]() {   // W's fragments (BF16) or rows (f32) of the pass at h0
    if constexpr (BF16) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int h = 16 * ks + (j >> 1) * 8 + 2 * r4;
            wa[mt][ks][j] = pack_bf16(wval(cl[mt][j & 1], h), wval(cl[mt][j & 1], h + 1));
          }
    } else {
#pragma unroll
      for (int h = 0; h < kChanTile; ++h) {
        wr[0][h] = wval(cl[0][0], h);
        wr[1][h] = wval(cl[0][1], h);
      }
    }
  };
  load_w();
  if constexpr (BF16) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dwa[mt][j][e] = 0.f;
  } else {
#pragma unroll
    for (int h = 0; h < kChanTile; ++h) dwr[0][h] = dwr[1][h] = 0.f;
  }

  const int ndt = (N + kDTile - 1) / kDTile;
  const int nsg = (rows_t + kStageRows - 1) / kStageRows;
  const int stages = ndt * nsg * hps;
  // stage st: pass (innermost), then source group, then dest tile
  auto pass_of = [&](int st) { return dw_only ? hpd : st % hps; };
  // slot j of this thread in a stage: tile row (K3: pair, K4: h) and its
  // first column, the same in every stage; the stage's source rows and
  // dest tile move the device address
  auto slot = [&](int j, int& row, int& col) {
    const int i = tid + j * nthr;
    row = i / (L::kCols / 4);
    col = 4 * (i % (L::kCols / 4));
  };
  auto issue = [&](int st) {   // cp.async of stage st, zero-filled past the tile, N and H
    const int sq = st / hps, hq = pass_of(st) * kChanTile;
    const int d0 = (sq / nsg) * kDTile, s0 = s_lo + (sq % nsg) * kStageRows;
    float* dst32 = tile32 + (BF16 ? 0 : (st & 1) * L::kTile32);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int row, col, nvalid;
      const float* src;
      slot(j, row, col);
      if (CM) {   // row h, pairs col .. col + 3 of the stage
        const int s = s0 + col / kDTile, d = d0 + col % kDTile;
        nvalid = (hq + row < H && s < s_hi) ? max(0, min(4, N - d)) : 0;
        src = gb + static_cast<size_t>(hq + row) * nn + s * N + d;
      } else {    // pair row, h col .. col + 3
        const int s = s0 + row / kDTile, d = d0 + row % kDTile;
        nvalid = (s < s_hi && d < N) ? max(0, min(4, H - hq - col)) : 0;
        src = gb + (s * N + d) * H + hq + col;
      }
      float* dst = dst32 + row * L::FS + col;
      if (vec) {
        hopper::cp_async16n(dst, nvalid ? src : g, 4 * nvalid);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hopper::cp_async4(dst + e, e < nvalid ? src + e : g, e < nvalid ? 4 : 0);
      }
    }
  };
  // this thread's slots of stage st, once its copies have landed: db's
  // unrounded sums (K3, chunk 0: a thread's slots keep one column of 4 h),
  // and in bf16 mode the rounding into the bf16 tile
  float db4[4] = {0.f, 0.f, 0.f, 0.f};
  auto settle = [&](int st) {
    const bool db_stage = db_block && pass_of(st) == hpd;
    if (!BF16 && !db_stage) return;
    const float* src32 = tile32 + (BF16 ? 0 : (st & 1) * L::kTile32);
    __nv_bfloat16* dst16 = tile16 + (st & 1) * L::kTile16;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int row, col;
      slot(j, row, col);
      const float4 v = *reinterpret_cast<const float4*>(src32 + row * L::FS + col);
      if (db_stage) {
        db4[0] += v.x;
        db4[1] += v.y;
        db4[2] += v.z;
        db4[3] += v.w;
      }
      if constexpr (BF16) {
        uint2 u;
        u.x = pack_bf16(v.x, v.y);
        u.y = pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(dst16 + row * L::BS + col) = u;
      }
    }
  };
  // the lane's values at its accumulator positions [m tile][nt][e] of a
  // tile: channel cl[mt][e >> 1], dest d0 + 8 nt + 2 r4 + (e & 1)
  float ccr[MT][2][4], dcr[MT][2][4];
  auto finish_dc = [&](int dt) {   // half 0: half 1's dc of dest tile dt added, stored
    if (half != 0) return;
    const float* x = dcx + (dt & 1) * kDTile * CH;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dl = 8 * nt + 2 * r4 + (e & 1), c_l = cl[mt][e >> 1];
          const int d = dt * kDTile + dl, c = c0 + c_l;
          const float v = dcr[mt][nt][e] + x[dl * CH + c_l];
          if (d < N && c < C) {
            if (tiles == 1)
              dc[(static_cast<size_t>(b) * N + d) * C + c] = v;
            else
              dc_part[((static_cast<size_t>(b) * tiles + tile) * N + d) * C + c] = v;
          }
        }
  };

  PHASE_MARK(1);
  issue(0);
  for (int st = 0; st < stages; ++st) {
    hopper::cp_async_wait_all();
    settle(st);
    __syncthreads();   // stage st in place; stage st - 1 consumed by every warp
    if (st + 1 < stages) issue(st + 1);
    const int hi_ = st % hps, sq = st / hps, dt = sq / nsg, sg = sq - dt * nsg;
    const int hp = dw_only ? hpd : hi_;
    const bool first = hi_ == 0, last = hi_ == hps - 1;   // the stage's first / last pass
    if (HP > 1 && !dw_only) {   // W of this stage's pass
      h0 = hp * kChanTile;
      load_w();
    }
    if (sg == 0 && first) {   // a new dest tile: the last one's dc out, this one's cc in
      if (dt > 0 && !dw_only) finish_dc(dt - 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = dt * kDTile + 8 * nt + 2 * r4 + (e & 1), c = c0 + cl[mt][e >> 1];
            const float v = (d < N && c < C) ? cb[static_cast<size_t>(d) * C + c] : 0.f;
            ccr[mt][nt][e] = round_halves ? round_bf16(v) : v;
            dcr[mt][nt][e] = 0.f;
          }
    }
    for (int i = 0; i < kStageRows / 2; ++i) {
      const int sl = half * (kStageRows / 2) + i;   // the row within the stage
      const int s = sg * kStageRows + sl;           // within the tile
      if (s >= rows_t) break;                       // warp-uniform
      const int p0 = sl * kDTile;                   // its first pair in the stage
      float pair[MT][2][4], rl[MT][2][4], dr[MT][2][4];
      float av[2 * MT];   // a[s] at the lane's channels, in chan_slot order
      if constexpr (MT == 2) {
        const float4 v = *reinterpret_cast<const float4*>(as + s * CH + slot0);
        av[0] = v.x;
        av[1] = v.y;
        av[2] = v.z;
        av[3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(as + s * CH + slot0);
        av[0] = v.x;
        av[1] = v.y;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float av0 = av[2 * mt], av1 = av[2 * mt + 1];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pair[mt][nt][e] = (e < 2 ? av0 : av1) + ccr[mt][nt][e];
            rl[mt][nt][e] = fmaxf(pair[mt][nt][e], 0.f);
            dr[mt][nt][e] = 0.f;
          }
      }
      // the lane's dpair sums of the earlier passes (their f32 sum over h
      // continues across passes)
      auto dr_at = [&](int mt, int nt, int e) -> float& {
        return drx[(sl * kDTile + 8 * nt + 2 * r4 + (e & 1)) * CH + cl[mt][e >> 1]];
      };
      if (HP > 1 && !first && !dw_only) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dr[mt][nt][e] = dr_at(mt, nt, e);
      }
      if constexpr (BF16) {
        const __nv_bfloat16* t16 = tile16 + (st & 1) * L::kTile16;
        // dpair^T (m = channel, n = pair) = W (k = h) @ g^T; each g
        // fragment feeds both m tiles
#pragma unroll
        for (int ks = 0; ks < 2 && !dw_only; ++ks) {
          uint32_t bq[4];
          if (CM)   // g stored [h][pair]: [k][n]
            hopper::ldsm_x4_t(bq, t16 + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * L::BS +
                                      p0 + ((lane >> 4) & 1) * 8);
          else      // g stored [pair][h]: [n][k]
            hopper::ldsm_x4(bq, t16 + (p0 + (lane & 7) + ((lane >> 4) & 1) * 8) * L::BS +
                                    16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            hopper::mma_bf16(dr[mt][0], wa[mt][ks], {bq[0], bq[1]});
            hopper::mma_bf16(dr[mt][1], wa[mt][ks], {bq[2], bq[3]});
          }
        }
        // dW (m = channel, n = h) += relu(pair)^T (k = pair, from these
        // registers: an accumulator's layout is an A fragment's) @ g, in
        // the block's own pass of h
        uint32_t ra[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ra[mt][0] = pack_relu_bf16(pair[mt][0][0], pair[mt][0][1]);
          ra[mt][1] = pack_relu_bf16(pair[mt][0][2], pair[mt][0][3]);
          ra[mt][2] = pack_relu_bf16(pair[mt][1][0], pair[mt][1][1]);
          ra[mt][3] = pack_relu_bf16(pair[mt][1][2], pair[mt][1][3]);
        }
#pragma unroll
        for (int nh = 0; nh < 2 && hp == hpd; ++nh) {
          uint32_t bq[4];
          if (CM)   // [n][k]
            hopper::ldsm_x4(bq, t16 + (16 * nh + (lane & 7) + ((lane >> 4) & 1) * 8) * L::BS +
                                    p0 + ((lane >> 3) & 1) * 8);
          else      // [k][n]
            hopper::ldsm_x4_t(bq, t16 + (p0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::BS +
                                      16 * nh + ((lane >> 4) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            hopper::mma_bf16(dwa[mt][2 * nh], ra[mt], {bq[0], bq[1]});
            hopper::mma_bf16(dwa[mt][2 * nh + 1], ra[mt], {bq[2], bq[3]});
          }
        }
      } else {
        // the same products as f32 FMAs: the lane's 8 dpair values over h,
        // and its dW partial over its 4 pairs, from g's rows 4 h at a time
        // (dpair only, or dW only, where the block's pass says so)
        const float* t32 = tile32 + (st & 1) * L::kTile32;
        const bool do_dr = !dw_only, do_dw = hp == hpd;
#pragma unroll
        for (int h4 = 0; h4 < kChanTile / 4; ++h4) {
          float gv[2][2][4];   // [nt][pair j][h]
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int p = p0 + 8 * nt + 2 * r4;
            if (CM) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float2 v = *reinterpret_cast<const float2*>(t32 + (4 * h4 + k) * L::FS + p);
                gv[nt][0][k] = v.x;
                gv[nt][1][k] = v.y;
              }
            } else {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float4 v = *reinterpret_cast<const float4*>(t32 + (p + j) * L::FS + 4 * h4);
                gv[nt][j][0] = v.x;
                gv[nt][j][1] = v.y;
                gv[nt][j][2] = v.z;
                gv[nt][j][3] = v.w;
              }
            }
          }
          if (do_dr && do_dw) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const float gk = gv[nt][e & 1][k];
                  dr[0][nt][e] = fmaf(wr[e >> 1][4 * h4 + k], gk, dr[0][nt][e]);
                  dwr[e >> 1][4 * h4 + k] = fmaf(rl[0][nt][e], gk, dwr[e >> 1][4 * h4 + k]);
                }
          } else if (do_dr) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  dr[0][nt][e] = fmaf(wr[e >> 1][4 * h4 + k], gv[nt][e & 1][k], dr[0][nt][e]);
          } else {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  dwr[e >> 1][4 * h4 + k] =
                      fmaf(rl[0][nt][e], gv[nt][e & 1][k], dwr[e >> 1][4 * h4 + k]);
          }
        }
      }
      if (dw_only) continue;
      if (!last) {   // more passes of h to come: keep the sums
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dr_at(mt, nt, e) = dr[mt][nt][e];
        continue;
      }
      // dpair = 1[pair > 0] * dr (K4 bf16: rounded), summed into da and dc
      float dsum[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        dsum[mt][0] = dsum[mt][1] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dp = pair[mt][nt][e] > 0.f ? dr[mt][nt][e] : 0.f;
            if (round_halves) dp = round_bf16(dp);
            dsum[mt][e >> 1] += dp;
            dcr[mt][nt][e] += dp;
          }
      }
      // da: the quad's lanes hold the row's other pairs.  A reduce-scatter
      // over the quad leaves lane r4 the sum of its channel 2 mt + hi = r4
      // (with MT = 1, lanes r4 and r4 ^ 2 both hold channel r4 & 1), which
      // it adds to the row in shared memory.
      float v = (r4 & 1) ? dsum[0][1] : dsum[0][0];
      float u = (r4 & 1) ? dsum[0][0] : dsum[0][1];
      if constexpr (MT == 2) {
        const bool b1 = r4 & 2;
        const float keep0 = b1 ? dsum[1][0] : dsum[0][0], keep1 = b1 ? dsum[1][1] : dsum[0][1];
        const float send0 = b1 ? dsum[0][0] : dsum[1][0], send1 = b1 ? dsum[0][1] : dsum[1][1];
        const float w0 = keep0 + __shfl_xor_sync(0xffffffffu, send0, 2);
        const float w1 = keep1 + __shfl_xor_sync(0xffffffffu, send1, 2);
        v = (r4 & 1) ? w1 : w0;
        u = (r4 & 1) ? w0 : w1;
        v += __shfl_xor_sync(0xffffffffu, u, 1);
      } else {
        v += __shfl_xor_sync(0xffffffffu, u, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
      }
      if (r4 < 2 * MT) das[s * CH + slot0 + r4] += v;
    }
    if (st < 3) PHASE_MARK(2 + st);
    // the dest tile's last stage: half 1's dc
    if (sg == nsg - 1 && last && !dw_only && half == 1) {
      float* x = dcx + (dt & 1) * kDTile * CH;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[(8 * nt + 2 * r4 + (e & 1)) * CH + cl[mt][e >> 1]] = dcr[mt][nt][e];
    }
  }
  __syncthreads();
  PHASE_MARK(5);
  if (!dw_only) finish_dc(ndt - 1);

  // dW: the lane's values (f32: summed over the quad's pairs first), half
  // 1's through the stage area, added by half 0 and stored; db's columns
  // summed over the threads in thread order
  float* xw = stage;                    // [CH][kChanTile]
  float* xdb = stage + CH * kChanTile;  // [nthr][4]
  if constexpr (!BF16) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int h = 0; h < kChanTile; ++h) {
        dwr[hi][h] += __shfl_xor_sync(0xffffffffu, dwr[hi][h], 1);
        dwr[hi][h] += __shfl_xor_sync(0xffffffffu, dwr[hi][h], 2);
      }
  }
  // the lane's dW values: fn(channel in the chunk, h, value)
  auto dw_each = [&](auto&& fn) {
    if constexpr (BF16) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nh = 0; nh < 4; ++nh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fn(cl[mt][e >> 1], 8 * nh + 2 * r4 + (e & 1), dwa[mt][nh][e]);
    } else {
#pragma unroll
      for (int h = 0; h < kChanTile; ++h)
        if ((h >> 3) == r4) {
          fn(cl[0][0], h, dwr[0][h]);
          fn(cl[0][1], h, dwr[1][h]);
        }
    }
  };
  if (half == 1) dw_each([&](int c_l, int h, float v) { xw[c_l * kChanTile + h] = v; });
  if (db_block) {
#pragma unroll
    for (int k = 0; k < 4; ++k) xdb[tid * 4 + k] = db4[k];
  }
  __syncthreads();
  const int hw = hpd * kChanTile;   // the block's pass of dW and db
  const size_t prow = static_cast<size_t>(b) * tiles + tile;
  if (half == 0) {
    float* pw = dw_part + (prow * C + c0) * H + hw;
    dw_each([&](int c_l, int h, float v) {
      if (c0 + c_l < C && hw + h < H) pw[c_l * H + h] = v + xw[c_l * kChanTile + h];
    });
  }
  if (db_block && tid < kChanTile && hw + tid < H) {
    float v = 0.f;
    for (int t = (tid >> 2); t < nthr; t += kChanTile / 4) v += xdb[t * 4 + (tid & 3)];
    db_part[prow * H + hw + tid] = v;
  }
  for (int i = tid; i < rows_t * CH && !dw_only; i += nthr) {
    const int r = i / CH, k = i - r * CH;
    if (c0 + k < C)
      da[(static_cast<size_t>(b) * N + s_lo + r) * C + c0 + k] = das[r * CH + chan_slot<BF16>(k)];
  }
  PHASE_MARK(6);
}

// Shared memory of the backward with CH channels and RS source rows a
// block and HP passes of h: a's columns and the da sums [RS][CH] each, half
// 1's dc [2][16][CH], dpair between passes [128][CH] (HP > 1), the stage
// area.  Mirrored by ops/pair_block.py::bwd_plan.
size_t bwd_smem(int RS, int CH, int HP) {
  return (2 * static_cast<size_t>(RS) * CH + 2 * kDTile * CH +
          (HP > 1 ? static_cast<size_t>(kStagePairs) * CH : 0)) * sizeof(float) +
         kStageBytes;
}

constexpr int kTileRows = 128;         // source rows a block of the tiled plan (one pass)
constexpr int kTileRowsPasses = 64;    // the same with passes of h (two blocks an SM)

// The backward's plan: CH channels and RS source rows a block, `tiles`
// row tiles a graph, HP passes of 32 h.  The whole-graph plan (tiles = 1,
// RS = N, HP = 1) with CH = 64 or 32, the most whose shared memory fits,
// wherever H <= 32 and one fits (N <= 748); else the tiled plan: CH = 64,
// RS = 128 rows (64 with passes), HP = ceil(H / 32).
struct BwdPlan {
  int ch, rs, tiles, hp;
  size_t smem;
};

BwdPlan make_bwd_plan(int N, int H) {
  const int hp = H <= kChanTile ? 1 : (H + kChanTile - 1) / kChanTile;
  if (hp == 1)
    for (int ch = 64; ch >= 32; ch /= 2)
      if (bwd_smem(N, ch, 1) <= kSmemLimit) return BwdPlan{ch, N, 1, 1, bwd_smem(N, ch, 1)};
  const int cap = hp == 1 ? kTileRows : kTileRowsPasses;
  const int n8 = (N + kStageRows - 1) / kStageRows * kStageRows;
  const int rs = n8 < cap ? (n8 > 0 ? n8 : kStageRows) : cap;
  return BwdPlan{64, rs, (N + rs - 1) / rs, hp, bwd_smem(rs, 64, hp)};
}

// Channels per block of the whole-graph plan at H <= 32: 64 or 32, the
// most whose shared memory fits; 0 if neither does.
int bwd_chunk(int N) {
  for (int ch = 64; ch >= 32; ch /= 2)
    if (bwd_smem(N, ch, 1) <= kSmemLimit) return ch;
  return 0;
}

template <bool CM, bool BF16, int CH, bool TILED>
int launch_bwd_chunk(const float* a, const float* cc, const float* w, const float* g, float* da,
                     float* dc, float* dw_part, float* db_part, float* dc_part, int B, int N,
                     int C, int H, const BwdPlan& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      pair_relu_project_bwd_kernel<CM, BF16, CH, TILED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (C + CH - 1) / CH;
  const long long blocks = static_cast<long long>(B) * p.tiles * p.hp * chunks;
  pair_relu_project_bwd_kernel<CM, BF16, CH, TILED>
      <<<static_cast<unsigned>(blocks), kBwdThreads<BF16, CH>, p.smem, s>>>(
          a, cc, w, g, da, dc, dw_part, db_part, dc_part, N, C, H, chunks, p.rs, p.tiles, p.hp);
  return static_cast<int>(cudaGetLastError());
}

// dc[b, i] = sum_t part[b, t, i], the row tiles in order (M = N * C).
__global__ void sum_tiles_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int B, int tiles, int M) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * M) return;
  const size_t b = i / M, m = i - b * M;
  const float* p = part + b * tiles * M + m;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) acc += p[static_cast<size_t>(t) * M];
  out[i] = acc;
}

// The backward in the mode and with the plan make_bwd_plan picks; the
// row tiles' dc partials (dc_part, tiles > 1) added in tile order.
template <bool CM>
int launch_bwd(const float* a, const float* cc, const float* w, const float* g, float* da,
               float* dc, float* dw_part, float* db_part, float* dc_part, int B, int N, int C,
               int H, int bf16, cudaStream_t s) {
  const BwdPlan p = make_bwd_plan(N, H);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const bool tiled = p.tiles > 1 || p.hp > 1;   // the tiled plan: 64 channels a block
  int rc;
  if (bf16)
    rc = tiled ? launch_bwd_chunk<CM, true, 64, true>(a, cc, w, g, da, dc, dw_part, db_part,
                                                      dc_part, B, N, C, H, p, s)
         : p.ch == 64 ? launch_bwd_chunk<CM, true, 64, false>(a, cc, w, g, da, dc, dw_part,
                                                              db_part, dc_part, B, N, C, H, p, s)
                      : launch_bwd_chunk<CM, true, 32, false>(a, cc, w, g, da, dc, dw_part,
                                                              db_part, dc_part, B, N, C, H, p, s);
  else
    rc = tiled ? launch_bwd_chunk<CM, false, 64, true>(a, cc, w, g, da, dc, dw_part, db_part,
                                                       dc_part, B, N, C, H, p, s)
         : p.ch == 64 ? launch_bwd_chunk<CM, false, 64, false>(a, cc, w, g, da, dc, dw_part,
                                                               db_part, dc_part, B, N, C, H, p,
                                                               s)
                      : launch_bwd_chunk<CM, false, 32, false>(a, cc, w, g, da, dc, dw_part,
                                                               db_part, dc_part, B, N, C, H, p,
                                                               s);
  if (rc != 0 || p.tiles == 1) return rc;
  const size_t total = static_cast<size_t>(B) * N * C;
  sum_tiles_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(dc_part, dc, B,
                                                                              p.tiles, N * C);
  return static_cast<int>(cudaGetLastError());
}

// ---- forward (K3 and K4): see the header ----

constexpr int kFwdTS = 32;     // source rows a unit where they fit (else 16, then 8; 32 ran faster)
constexpr int kFwdRows = 2;    // bf16 mode: source rows a warp (4 ran slower)

// Threads of a forward block: bf16 TS / kFwdRows warps; f32 a thread's 2 x
// 2 pairs x 8 h.
template <int TS>
constexpr int kFwdThreads = 16 * TS;
static_assert(kFwdThreads<32> == 32 * 32 / kFwdRows, "bf16 warps of kFwdRows rows");

__host__ __device__ constexpr int fwd_cpad(int C) { return (C + 15) / 16 * 16; }
// A staged row's floats: C' or C' + 16, so that rows 1 apart fall 64 bytes
// apart in the banks (a lane's cc loads of rows q and q + 1 do not collide).
__host__ __device__ constexpr int fwd_stride(int C) {
  return fwd_cpad(C) % 32 ? fwd_cpad(C) : fwd_cpad(C) + 16;
}
__host__ __device__ constexpr int fwd_hp(int H) { return (H + 31) / 32 * 32; }

// Where channel k sits in a staged row: within its 16-channel group, lane
// r4's A-fragment channels 2 r4, 2 r4 + 1, 2 r4 + 8, 2 r4 + 9 at slots 4 r4
// .. 4 r4 + 3.  Even k and k + 1 stay neighbours (8-byte copies).
__host__ __device__ constexpr int fwd_slot(int k) {
  return (k & ~15) + 4 * ((k & 7) >> 1) + 2 * ((k >> 3) & 1) + (k & 1);
}

// Shared memory of the forward: W, then two stages of TS a rows and 16 cc
// rows.  Mirrored by ops/pair_block.py::fwd_plan.
size_t fwd_smem(int C, int H, bool bf16, int TS) {
  const size_t w = bf16 ? static_cast<size_t>(fwd_cpad(C)) * (fwd_hp(H) + 8) * 2
                        : static_cast<size_t>(fwd_cpad(C)) * fwd_hp(H) * 4;
  return w + 2 * static_cast<size_t>(TS + kDTile) * fwd_stride(C) * sizeof(float);
}

// Source rows a unit: kFwdTS where its shared memory fits, else 16, else 8;
// 0 if none fits.
int fwd_ts(int C, int H, bool bf16) {
  const int candidates[3] = {kFwdTS, 16, 8};
  for (const int ts : candidates)
    if (fwd_smem(C, H, bf16, ts) <= kSmemLimit) return ts;
  return 0;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool CM, bool BF16, int TS>
__global__ void __launch_bounds__(kFwdThreads<TS>, TS == 16 ? 2 : 1)
pair_relu_project_fwd_kernel(const float* __restrict__ a, const float* __restrict__ cc,
                             const float* __restrict__ w, const float* __restrict__ bias,
                             float* __restrict__ out, int B, int N, int C, int H) {
  constexpr int nthr = kFwdThreads<TS>;
  constexpr int kRows = TS + kDTile;                // staged rows a unit
  extern __shared__ __align__(16) float smem[];
  const int CP = fwd_cpad(C), stride = fwd_stride(C), HP = fwd_hp(H);
  const int HB = HP + 8;                            // a bf16 W row, halves
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem);   // [CP][HB], channel order
  float* wf = smem;                                 // [CP][HP], fwd_slot order
  float* stage = smem + (BF16 ? CP * HB / 2 : CP * HP);
  const int buf_floats = kRows * stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ndt = (N + kDTile - 1) / kDTile, nst = (N + TS - 1) / TS;
  const int per_graph = ndt * nst;
  const int units = B * per_graph;
  const int nn = N * N;                             // B N^2 H < 2^31: the wrapper's check
  const bool vec = (C % 2 == 0) &&
                   ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(cc)) % 8 == 0);

  // this thread's 8-byte staging slots, the same in every unit: columns
  // col0, col0 + nthr, ... of C' / 2, rows row0, row0 + rstep, ...
  const int half_c = CP / 2;
  const int rstep = nthr >= half_c ? nthr / half_c : 1;
  const int col0 = nthr >= half_c ? tid % half_c : tid;
  const int row0 = nthr >= half_c ? tid / half_c : 0;
  const bool stager = row0 < rstep;
  auto origin = [&](int u, int& b, int& s0, int& d0) {
    b = u / per_graph;
    const int r = u - b * per_graph, dt = r / nst;
    d0 = dt * kDTile;
    s0 = (r - dt * nst) * TS;
  };
  // cp.async of unit u's rows into buffer buf, zero-filled past N and C
  auto issue = [&](int u, int buf) {
    if (!stager) return;
    int b, s0, d0;
    origin(u, b, s0, d0);
    const float* ab = a + b * N * C;
    const float* cb = cc + b * N * C;
    float* dst0 = stage + buf * buf_floats;
    for (int col = col0; col < half_c; col += nthr) {
      const int k = 2 * col, slot = fwd_slot(k);
      for (int r = row0; r < kRows; r += rstep) {
        const int node = r < TS ? s0 + r : d0 + r - TS;
        const float* src = (r < TS ? ab : cb) + node * C + k;
        float* dst = dst0 + r * stride + slot;
        const int nvalid = node < N ? max(0, min(2, C - k)) : 0;
        if (vec) {
          hopper::cp_async8(dst, nvalid ? src : a, 4 * nvalid);
        } else {
          hopper::cp_async4(dst, nvalid > 0 ? src : a, nvalid > 0 ? 4 : 0);
          hopper::cp_async4(dst + 1, nvalid > 1 ? src + 1 : a, nvalid > 1 ? 4 : 0);
        }
      }
    }
  };
  // K4's bf16 mode: this thread's slots rounded to bf16 once they landed
  auto settle = [&](int buf) {
    if (!(CM && BF16) || !stager) return;
    float* dst0 = stage + buf * buf_floats;
    for (int col = col0; col < half_c; col += nthr) {
      const int slot = fwd_slot(2 * col);
      for (int r = row0; r < kRows; r += rstep) {
        float2* p = reinterpret_cast<float2*>(dst0 + r * stride + slot);
        const float2 v = *p;
        *p = make_float2(round_bf16(v.x), round_bf16(v.y));
      }
    }
  };

  PHASE_MARK(0);
  if (static_cast<int>(blockIdx.x) < units) issue(blockIdx.x, 0);
  // W once a block, while the first unit's rows fly: elements i = k HP + h
  // at tid, tid + nthr, ..., eight loads in flight at a time
  {
    const int dk = nthr / HP, dh = nthr - dk * HP;
    int k = tid / HP, h = tid - k * HP;
    while (k < CP) {
      float v[8];
      int at[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        at[j] = k < CP ? (BF16 ? k * HB : fwd_slot(k) * HP) + h : -1;
        v[j] = (k < C && h < H) ? w[k * H + h] : 0.f;
        h += dh;
        k += dk;
        if (h >= HP) {
          h -= HP;
          ++k;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (at[j] < 0) continue;
        if constexpr (BF16)
          wb[at[j]] = __float2bfloat16_rn(v[j]);
        else
          wf[at[j]] = v[j];
      }
    }
  }
  PHASE_MARK(1);

  const int q = lane >> 2, r4 = lane & 3;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    const int buf = it & 1;
    hopper::cp_async_wait_all();
    settle(buf);
    __syncthreads();   // unit u in place; the other buffer consumed by every warp
    const bool last = u + static_cast<int>(gridDim.x) >= units;
    if (!last) issue(u + gridDim.x, buf ^ 1);
    if (it == 0) PHASE_MARK(2);
    if (last) PHASE_MARK(4);
    int b, s0, d0;
    origin(u, b, s0, d0);
    const float* as = stage + buf * buf_floats;
    const float* cs = as + TS * stride;
    // the warp's first row in the unit (f32: its threads', 2 rows a thread)
    const int sl = kFwdRows * warp;
    if (s0 + sl < N) {   // warp-uniform; no barrier below
      if constexpr (BF16) {
        const float* c0p = cs + q * stride + 4 * r4;
        const float* c1p = c0p + 8 * stride;
        const float* ap = as + sl * stride + 4 * r4;   // row sl + r at ap + r stride
        const __nv_bfloat16* wl =
            wb + ((lane & 7) + ((lane >> 3) & 1) * 8) * HB + ((lane >> 4) & 1) * 8;
        for (int hp0 = 0; hp0 < HP; hp0 += 32) {
          float acc[kFwdRows][4][4];
#pragma unroll
          for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[r][nt][e] = 0.f;
#pragma unroll 2
          for (int k0 = 0; k0 < CP; k0 += 16) {
            const float4 c0 = lds4(c0p + k0), c1 = lds4(c1p + k0);
            uint32_t blo[4], bhi[4];   // W's B fragments: h 0-15 and 16-31 of the pass
            hopper::ldsm_x4_t(blo, wl + k0 * HB + hp0);
            hopper::ldsm_x4_t(bhi, wl + k0 * HB + hp0 + 16);
#pragma unroll
            for (int r = 0; r < kFwdRows; ++r) {
              const float4 av = lds4(ap + r * stride + k0);
              // rows d0 + q, d0 + q + 8; channels 2 r4, 2 r4 + 1 | 2 r4 + 8, 2 r4 + 9
              const uint32_t fa[4] = {pack_relu_bf16(av.x + c0.x, av.y + c0.y),
                                      pack_relu_bf16(av.x + c1.x, av.y + c1.y),
                                      pack_relu_bf16(av.z + c0.z, av.w + c0.w),
                                      pack_relu_bf16(av.z + c1.z, av.w + c1.w)};
              hopper::mma_bf16(acc[r][0], fa, {blo[0], blo[1]});
              hopper::mma_bf16(acc[r][1], fa, {blo[2], blo[3]});
              hopper::mma_bf16(acc[r][2], fa, {bhi[0], bhi[1]});
              hopper::mma_bf16(acc[r][3], fa, {bhi[2], bhi[3]});
            }
          }
          // accumulator e of n tile nt: dest d0 + q + 8 (e >> 1), h 8 nt + 2 r4 + (e & 1)
#pragma unroll
          for (int r = 0; r < kFwdRows; ++r) {
            const int s = s0 + sl + r;
            if (s >= N) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int h = hp0 + 8 * nt + 2 * r4;
              float b0 = 0.f, b1 = 0.f;
              if (!CM) {
                b0 = h < H ? bias[h] : 0.f;
                b1 = h + 1 < H ? bias[h + 1] : 0.f;
              }
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int d = d0 + q + 8 * hf;
                if (d >= N) continue;
                const float v0 = acc[r][nt][2 * hf], v1 = acc[r][nt][2 * hf + 1];
                if (CM) {
                  float* o = out + (b * H + h) * nn + s * N + d;
                  if (h < H) o[0] = v0;
                  if (h + 1 < H) o[nn] = v1;
                } else {
                  float* o = out + ((b * N + s) * N + d) * H + h;
                  if (H % 2 == 0 && h < H) {
                    *reinterpret_cast<float2*>(o) = make_float2(v0 + b0, v1 + b1);
                  } else {
                    if (h < H) o[0] = v0 + b0;
                    if (h + 1 < H) o[1] = v1 + b1;
                  }
                }
              }
            }
          }
        }
      } else {
        // the thread's rows sl, sl + 1, dests dp, dp + 8, h 8 hg .. 8 hg + 7 of a pass
        const int hg = tid & 3, dp = (tid >> 2) & 7;
        const float* a0p = as + sl * stride;
        const float* a1p = a0p + stride;
        const float* c0p = cs + dp * stride;
        const float* c1p = c0p + 8 * stride;
        for (int hp0 = 0; hp0 < HP; hp0 += 32) {
          const float* wl = wf + hp0 + 8 * hg;
          float acc[2][2][8];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 8; ++h) acc[i][j][h] = 0.f;
#pragma unroll 2
          for (int k0 = 0; k0 < CP; k0 += 4) {
            const float4 a0 = lds4(a0p + k0), a1 = lds4(a1p + k0);
            const float4 c0 = lds4(c0p + k0), c1 = lds4(c1p + k0);
            const float av[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
            const float cv[2][4] = {{c0.x, c0.y, c0.z, c0.w}, {c1.x, c1.y, c1.z, c1.w}};
#pragma unroll
            for (int e = 0; e < 4; ++e) {   // slot k0 + e: W's row of that channel
              const float4 w0 = lds4(wl + (k0 + e) * HP), w1 = lds4(wl + (k0 + e) * HP + 4);
              const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  const float p = fmaxf(av[i][e] + cv[j][e], 0.f);
#pragma unroll
                  for (int h = 0; h < 8; ++h) acc[i][j][h] = fmaf(p, wv[h], acc[i][j][h]);
                }
            }
          }
          const int hb = hp0 + 8 * hg;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int s = s0 + sl + i;
            if (s >= N) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int d = d0 + dp + 8 * j;
              if (d >= N) continue;
              if (CM) {
                float* o = out + (b * H + hb) * nn + s * N + d;
#pragma unroll
                for (int h = 0; h < 8; ++h)
                  if (hb + h < H) o[h * nn] = acc[i][j][h];
              } else {
                float* o = out + ((b * N + s) * N + d) * H + hb;
#pragma unroll
                for (int x = 0; x < 2; ++x) {
                  const int h4 = hb + 4 * x;
                  if (H % 4 == 0 && h4 + 4 <= H) {
                    *reinterpret_cast<float4*>(o + 4 * x) = make_float4(
                        acc[i][j][4 * x] + bias[h4], acc[i][j][4 * x + 1] + bias[h4 + 1],
                        acc[i][j][4 * x + 2] + bias[h4 + 2], acc[i][j][4 * x + 3] + bias[h4 + 3]);
                  } else {
#pragma unroll
                    for (int y = 0; y < 4; ++y)
                      if (h4 + y < H) o[4 * x + y] = acc[i][j][4 * x + y] + bias[h4 + y];
                  }
                }
              }
            }
          }
        }
      }
    }
    if (it == 0) PHASE_MARK(3);
  }
  PHASE_MARK(5);
}

// One forward launch with TS source rows a unit: persistent blocks, as many
// as are resident at once on the ``sms`` SMs, at most one per unit.  With
// ``resident`` set, only the residency query: *resident = blocks an SM x
// sms, nothing launched.  The query runs once per instantiation and shared
// memory size, kept as bytes << 32 | blocks an SM.
template <bool CM, bool BF16, int TS>
int launch_fwd_t(const float* a, const float* cc, const float* w, const float* bias, float* out,
                 int B, int N, int C, int H, int sms, cudaStream_t s, int* resident) {
  const size_t smem = fwd_smem(C, H, BF16, TS);
  auto kernel = pair_relu_project_fwd_kernel<CM, BF16, TS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<unsigned long long> resident_for{0};
  unsigned long long known = resident_for.load(std::memory_order_relaxed);
  int per_sm = static_cast<int>(known & 0xffffffffull);
  if ((known >> 32) != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdThreads<TS>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = per_sm > 0 ? per_sm : 1;
    resident_for.store(static_cast<unsigned long long>(smem) << 32 | per_sm,
                       std::memory_order_relaxed);
  }
  const long long all = static_cast<long long>(per_sm) * sms;
  if (resident) {
    *resident = static_cast<int>(all);
    return 0;
  }
  const long long units = static_cast<long long>(B) * ((N + kDTile - 1) / kDTile) *
                          ((N + TS - 1) / TS);
  const int blocks = static_cast<int>(units < all ? units : all);
  if (blocks == 0) return 0;
  kernel<<<blocks, kFwdThreads<TS>, smem, s>>>(a, cc, w, bias, out, B, N, C, H);
  return static_cast<int>(cudaGetLastError());
}

// The forward in the mode and with the TS that fwd_ts picks; refuses an
// output or input that the int32 index does not reach.
template <bool CM>
int launch_fwd(const float* a, const float* cc, const float* w, const float* bias, float* out,
               int B, int N, int C, int H, int bf16, int sms, cudaStream_t s,
               int* resident = nullptr) {
  const int ts = fwd_ts(C, H, bf16 != 0);
  const long long nout = static_cast<long long>(B) * N * N * H;
  const long long nin = static_cast<long long>(B) * N * C;
  if (ts == 0 || nout > INT_MAX || nin > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    if (ts == 32)
      return launch_fwd_t<CM, true, 32>(a, cc, w, bias, out, B, N, C, H, sms, s, resident);
    if (ts == 16)
      return launch_fwd_t<CM, true, 16>(a, cc, w, bias, out, B, N, C, H, sms, s, resident);
    return launch_fwd_t<CM, true, 8>(a, cc, w, bias, out, B, N, C, H, sms, s, resident);
  }
  if (ts == 32)
    return launch_fwd_t<CM, false, 32>(a, cc, w, bias, out, B, N, C, H, sms, s, resident);
  if (ts == 16)
    return launch_fwd_t<CM, false, 16>(a, cc, w, bias, out, B, N, C, H, sms, s, resident);
  return launch_fwd_t<CM, false, 8>(a, cc, w, bias, out, B, N, C, H, sms, s, resident);
}

}  // namespace

// K3 forward: out [B, N, N, H], bias added.  Refuses (cudaErrorInvalidValue)
// what fwd_ts or the int32 index does not take.
extern "C" int pair_relu_project_fwd(const float* a, const float* cc, const float* w,
                                     const float* bias, float* out, int B, int N, int C,
                                     int H, int bf16, int sms, void* stream) {
  return launch_fwd<false>(a, cc, w, bias, out, B, N, C, H, bf16, sms,
                           static_cast<cudaStream_t>(stream));
}

// K4 forward: out [B, H, N*N] channel-major, no bias; same launch as K3's.
extern "C" int pair_relu_project_cm_fwd(const float* a, const float* cc, const float* w,
                                        float* out, int B, int N, int C, int H, int bf16,
                                        int sms, void* stream) {
  return launch_fwd<true>(a, cc, w, nullptr, out, B, N, C, H, bf16, sms,
                          static_cast<cudaStream_t>(stream));
}

// The forward's plan at one graph of N nodes: returns its shared bytes and
// writes out[0] = TS, out[1] = threads a block, out[2] = resident blocks on
// ``sms`` SMs; -1 where no plan fits (ops/pair_block.py::fwd_plan mirrors
// it), -1000 - the CUDA error where the residency query fails.
extern "C" long long pair_relu_project_fwd_plan(int N, int C, int H, int bf16, int cm, int sms,
                                                int* out) {
  const int ts = fwd_ts(C, H, bf16 != 0);
  if (ts == 0 || static_cast<long long>(N) * N * H > INT_MAX ||
      static_cast<long long>(N) * C > INT_MAX)
    return -1;
  int resident = 0;
  const int rc = cm ? launch_fwd<true>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, N, C, H,
                                       bf16, sms, nullptr, &resident)
                    : launch_fwd<false>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, N, C, H,
                                        bf16, sms, nullptr, &resident);
  if (rc != 0) return -1000 - rc;
  out[0] = ts;
  out[1] = 16 * ts;   // kFwdThreads<ts>
  out[2] = resident;
  return static_cast<long long>(fwd_smem(C, H, bf16 != 0, ts));
}

// da, dc [B, N, C], dw [C, H], db [H]; dw_part (B * tiles * C * H
// floats), db_part (B * tiles * H) and, where tiles > 1, dc_part (B *
// tiles * N * C) are caller-allocated scratch (tiles: make_bwd_plan's, as
// pair_relu_project_bwd_plan gives it).
extern "C" int pair_relu_project_bwd(const float* a, const float* cc,
                                     const float* w, const float* g, float* da,
                                     float* dc, float* dw, float* db,
                                     float* dw_part, float* db_part, float* dc_part, int B,
                                     int N, int C, int H, int bf16,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_bwd<false>(a, cc, w, g, da, dc, dw_part, db_part, dc_part, B, N, C, H,
                                   bf16, s);
  if (rc != 0) return rc;
  const int rows = B * make_bwd_plan(N, H).tiles;
  partials::sum_rows(dw_part, dw, rows, C * H, s);
  partials::sum_rows(db_part, db, rows, H, s);
  return static_cast<int>(cudaGetLastError());
}

// K4 backward: g [B, H, N*N]; da, dc [B, N, C], dw [C, H], no db; dw_part
// and dc_part as K3's.
extern "C" int pair_relu_project_cm_bwd(const float* a, const float* cc,
                                        const float* w, const float* g,
                                        float* da, float* dc, float* dw,
                                        float* dw_part, float* dc_part, int B, int N, int C,
                                        int H, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_bwd<true>(a, cc, w, g, da, dc, dw_part, nullptr, dc_part, B, N, C, H,
                                  bf16, s);
  if (rc != 0) return rc;
  partials::sum_rows(dw_part, dw, B * make_bwd_plan(N, H).tiles, C * H, s);
  return static_cast<int>(cudaGetLastError());
}

// The backward's channels per block of the whole-graph plan at N (H <=
// 32), 0 where none fits (ops/pair_block.py::bwd_plan's "chunk" there).
extern "C" int pair_relu_project_bwd_chunk(int N) { return bwd_chunk(N); }

// The backward's plan at (N, H): out = {channels, source rows a block, row
// tiles, passes of h}; returns its shared memory in bytes
// (ops/pair_block.py::bwd_plan mirrors it).
extern "C" long long pair_relu_project_bwd_plan(int N, int H, int* out) {
  const BwdPlan p = make_bwd_plan(N, H);
  out[0] = p.ch;
  out[1] = p.rs;
  out[2] = p.tiles;
  out[3] = p.hp;
  return static_cast<long long>(p.smem);
}
