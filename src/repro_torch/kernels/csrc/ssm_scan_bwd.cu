// The chunk-recompute backward of the fused selective scan (K10) for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/ssm_scan.py::_bwd_kernel, launched by _bwd_call
// (the backward of ssm_scan_pallas's custom_vjp).
//
// What it computes.  The forward (K9, ssm_scan.cu) is, for every batch row b,
// channel d and state s,
//     h_t = exp(dt_t * a[d, s]) * h_{t-1} + (dt_t * x_t) * B_t[s],  h_{-1} = 0
//     y_t = sum_s h_t[s] * C_t[s]
// and it wrote the state at the start of every 32-step tile (hstart, the
// checkpoints).  Given dy = dL/dy (B, S, D) and dh_final = dL/dh_{S-1}
// (B, D, st), this kernel walks the sequence backwards with
//     g_t = dL/dh_t = g_{t+1} * exp(dt_{t+1} a) + dy_t * C_t      (g_S = dh_final)
//     gdec = g_t * exp(dt_t a) * h_{t-1}                (dL/d(dt_t a) through exp)
//     ddt_t = sum_s gdec * a + x_t * sum_s g_t * B_t,  dx_t = dt_t * sum_s g_t * B_t
//     dB_t[s] = sum_d g_t * dt_t x_t,  dC_t[s] = sum_d h_t * dy_t,
//     dA[d, s] = sum_b sum_t dt_t * gdec
// and writes the five gradients in float32: ddt, dx (B, S, D), dB, dC (B, S, st),
// dA (D, st).  Inputs are read in their own dtypes (float32 or bfloat16, named
// by `flags`) and converted to float32 in registers.
//
// Design.  The TPU kernel walks a (batch, seq chunk, d tile) grid in order,
// the seq chunks reversed, keeps (chunk + 1, d_tile, st) recomputed states in
// VMEM and accumulates dB, dC and dA across grid steps.  Here a block owns one
// (b, 64 channels) and walks the whole sequence itself, tiles of 32 steps
// from the last to the first, as K9 walks it forwards.
//  * Threads.  A warp is one pair of states of 32 channels (lane = channel),
//    so its reads of B and C are one address (a broadcast); a block is st / 2
//    such warps for each half of its 64 channels and nothing else: at st = 16
//    16 warps, 128 registers a thread, 196 KB of shared memory, one block an
//    SM, and B = 1, D = 8192 is 128 blocks, one wave.  A producer warp would
//    cap a thread at 96 registers (17 or 18 warps an SM), which the
//    recompute's states exceed, so its work is spread over the warps, each
//    piece a group (8 steps) or more after the other warps made it possible.
//  * A ring of 2 tiles in shared memory, brought in by the Tensor Memory
//    Accelerator (TMA) as raw bits: dt, x, dy (32 steps x 64 channels), B and
//    C (32 steps x st) and the tile's checkpoint (64 channels x st), through
//    3-D tensor maps that give zeros past the end of S and D.  Each stage has
//    a "loaded" and an "empty" mbarrier; warp 0 refills a stage a tile
//    ahead, a group after every warp was done with it.  Each warp turns its
//    pair's B and C into float32 once per tile, lane = step.
//  * One exponential per state and step.  The recompute forms each decay
//    once with scan_decay and steps the state with scan_step of
//    ssm_scan.cuh (K9's step, so the states are K9's bit for bit), keeps the
//    tile's 32 states before each step in registers (64 floats a thread) and
//    the 32 decays in a slot buffer in shared memory ([step][warp][lane],
//    8 bytes a thread and step, 128 KB at st = 16), which the reverse pass
//    reads back.  dC needs no gradient, so the recompute forms it.
//  * ddt and dx.  The reverse pass writes each thread's parts of a step
//    (over its 2 states: the sum of gdec a + x g B, and of dt g B) into the
//    slot its decay came from.  Once every warp has passed a group of 8 steps
//    ("full" mbarriers), each warp sums its share of the group's (step, half)
//    over the half's warps in warp order and stores ddt and dx; when every
//    warp has ("freed" mbarriers), the next tile's recompute may write the
//    group's slots.  It walks the slots in the opposite order, so that its
//    first slots are the ones the reverse pass filled first.
//  * dB and dC: per group of 8 steps a warp's 16 values (8 steps x 2 states)
//    are summed across its 32 lanes by a butterfly reduce-scatter, into its
//    half's tile of dB and dC; a tile later the warps add the two halves and
//    write one partial per block: (B, D / 64, S, st) of each, half of what
//    32-channel blocks would write.  A second kernel of this source sums the
//    partials, and the B partials of dA (B, D, st), each in a fixed order.
//    Nothing uses atomics, so two launches give the same bits.  (A
//    thread-block cluster summing 32-channel blocks' tiles through
//    distributed shared memory cost more, in its cluster-scope release and
//    acquire per tile, than the partials it saved; PERF.md has the sweep.)
//  * No barrier waits on the whole block after the start: each wait is for
//    one group, one stage or one tile of dB and dC, a group or more after
//    the other warps passed it.
//  * The tail: S need not be a multiple of 32.  The TMA's zeros past the end
//    give dt = 0 (a decay of 1 and an update of 0: the state carries over) and
//    gradients of zero for dB, dC and dA; the stores stop at S and D.
//    Channels past D read zeros and write nothing.  Offsets into the outputs
//    are 64-bit.
//
// What bounds it, at (1, 4096, 8192, 16) with the train step's dtypes (dt
// float32; x, dy, B, C, a bfloat16).  Bytes: dt, x, dy read and ddt, dx
// written (16 bytes per (b, t, d)), the checkpoints (4 bytes per (b, d, s)
// every 32 steps), B, C, dh_final and dA: 606 MB, 0.181 ms at 3.35 TB/s; the
// partials of dB, dC and dA add 135.3 MB written and read.  The
// exponentials: one per (b, t, d, s), 5.4e8, 0.128 ms on the
// special-function units.  Neither binds: per state and step a thread issues
// about 35 instructions (the step and its decay's store, the reverse pass's
// seven products and sums, the parts' store, its share of the input loads
// and of the reduce-scatter), and the shared-memory pipe carries the decay
// written and read, the parts written and summed, the inputs read once per
// pass by each of the st / 2 warps of a channel, and one shuffle per value
// of the reduce-scatter.  PERF.md has the measurements: about 0.95 ms, of
// which the shuffles take about a fifth.

#include "ssm_scan.cuh"
#include "tma.cuh"

namespace {

constexpr int kDyBf16 = 16;  // flags: dy is bfloat16
constexpr int kCh = 32;      // channels per warp: lane = channel
constexpr int kHalves = 2;   // warps per pair of states: a block is 64 channels
constexpr int kBlockCh = kCh * kHalves;
constexpr int kStates = 2;   // states per thread: a block is st / 2 * kHalves warps
constexpr int kStages = 2;   // tiles in the ring
constexpr int kGroup = 8;    // steps per group: one reduce-scatter, one hand-over of parts
constexpr int kGroups = kSteps / kGroup;
constexpr int kBarBytes = 128;  // the mbarriers, ahead of everything else

static_assert(kStates == 2 && kGroup * kStates == 16, "a pair of states a thread; 16 values a reduce-scatter");
static_assert(2 * kStages + 2 * kGroups + 4 <= kBarBytes / 8, "barriers");

// ---- elements in shared memory ----

// Elements i, i + 1 (i even) of a row of float32 or bfloat16, as float32.
template <bool kBf16>
__device__ __forceinline__ float2 lds_pair(const unsigned char* base, int i) {
  if constexpr (kBf16) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(base + 2 * i);
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float2*>(base + 4 * i);
  }
}

// Stage H of a butterfly reduce-scatter of 16 values across a warp: lanes
// that differ in bit 2H exchange half of their values and each keeps the sum
// of the other half.
template <int H>
__device__ __forceinline__ void scatter_stage(float (&v)[16], int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// The sum over the warp's 32 lanes of v[lane >> 1], in a fixed order.
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
  scatter_stage<8>(v, lane);
  scatter_stage<4>(v, lane);
  scatter_stage<2>(v, lane);
  scatter_stage<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// ---- the kernel ----

// Shared memory of one block (every offset a multiple of 128 bytes): the
// mbarriers, the ring's stages, the slots of decays and parts, two tiles of
// dB and dC per half (tile i's are summed while tile i + 1 runs), and each
// warp's B and C of the running tile as float32.
template <int ST, bool kDtB, bool kXB, bool kDyB, bool kBcB>
struct Layout {
  static constexpr int kPairs = ST / kStates;
  static constexpr int kWarps = kPairs * kHalves;
  static constexpr int kDtBytes = kSteps * kBlockCh * (kDtB ? 2 : 4);
  static constexpr int kXBytes = kSteps * kBlockCh * (kXB ? 2 : 4);
  static constexpr int kDyBytes = kSteps * kBlockCh * (kDyB ? 2 : 4);
  static constexpr int kBcBytes = kSteps * ST * (kBcB ? 2 : 4);
  // one stage: every byte comes by TMA
  static constexpr int kDt = 0;
  static constexpr int kX = kDt + kDtBytes;
  static constexpr int kDy = kX + kXBytes;
  static constexpr int kB = kDy + kDyBytes;
  static constexpr int kC = kB + kBcBytes;
  static constexpr int kCk = kC + kBcBytes;  // the checkpoint: [kBlockCh][ST] float32
  static constexpr int kStage = kCk + kBlockCh * ST * 4;
  // the whole block
  static constexpr int kSlots = kBarBytes + kStages * kStage;      // [kSteps][kWarps][kCh] float2
  static constexpr int kDbc = kSlots + kSteps * kWarps * kCh * 8;  // [2][kHalves][dB, dC][kSteps][ST] float32
  static constexpr int kBcw = kDbc + 2 * kHalves * 2 * kSteps * ST * 4;  // [kWarps][kSteps] float4
  static constexpr int kBytes = kBcw + kWarps * kSteps * 16;
  static_assert(kBcBytes % 128 == 0 && kDtBytes % 128 == 0, "tile alignment");
  static_assert(kBytes <= 232448, "a block's shared memory on Hopper");
};

// One step's inputs for one channel and a pair of states.
struct Step {
  float dt, x, dy;
  float4 bc;  // B and C of the pair
  float2 dec;
};

// Step t of the tile in stage `st`: dt, x, dy of this thread's channel (its
// column `col` of the tile), B (and in the reverse pass C and the decays) of
// its pair of states.
template <int ST, bool kDtB, bool kXB, bool kDyB, bool kBcB, bool kRev>
__device__ __forceinline__ Step load_step(const unsigned char* st, int t, int col, const float4* bcw,
                                          const float2* slot) {
  using L = Layout<ST, kDtB, kXB, kDyB, kBcB>;
  Step v;
  v.dt = lds_f32<kDtB>(st + L::kDt, t * kBlockCh + col);
  v.x = lds_f32<kXB>(st + L::kX, t * kBlockCh + col);
  v.dy = lds_f32<kDyB>(st + L::kDy, t * kBlockCh + col);
  if constexpr (kRev) {
    v.bc = bcw[t];
    v.dec = *slot;
  } else {
    const float2 b = *reinterpret_cast<const float2*>(bcw + t);
    v.bc.x = b.x, v.bc.y = b.y;
  }
  return v;
}

template <int ST, bool kDtB, bool kXB, bool kDyB, bool kBcB>
__global__ void __launch_bounds__(32 * ST, 16 / ST)
    ssm_scan_bwd_kernel(const __grid_constant__ CUtensorMap tm_dt, const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_b,
                        const __grid_constant__ CUtensorMap tm_c, const __grid_constant__ CUtensorMap tm_h,
                        const void* __restrict__ a, const float* __restrict__ dh_final, float* __restrict__ ddt,
                        float* __restrict__ dxo, float* __restrict__ part_b, float* __restrict__ part_c,
                        float* __restrict__ part_a, int seq, int d_model, int n_dtiles, int flags) {
  using L = Layout<ST, kDtB, kXB, kDyB, kBcB>;
  constexpr int kPairs = L::kPairs, kWarps = L::kWarps;
  constexpr int kSlotStride = kWarps * kCh;    // float2 per step in the slots
  constexpr int kShare = kGroup * kHalves / kWarps;  // (step, half) of a group whose parts one warp sums
  constexpr int kTile = 2 * kSteps * ST;       // dB and dC of one tile, one half
  constexpr int kPer = kTile / (32 * kWarps);  // values of them a lane sums over the halves
  static_assert(kWarps == ST && kShare * kWarps == kGroup * kHalves && kPer * 32 * kWarps == kTile,
                "thread map");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* loaded = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = loaded + kStages;
  uint64_t* full = empty + kStages;
  uint64_t* freed = full + kGroups;
  uint64_t* tfull = freed + kGroups;
  uint64_t* tfree = tfull + 2;
  unsigned char* ring = smem + kBarBytes;
  float2* slots = reinterpret_cast<float2*>(smem + L::kSlots);
  float* dbc = reinterpret_cast<float*>(smem + L::kDbc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = warp % kPairs, hf = warp / kPairs;  // this warp's pair of states and half of the channels
  const int b = blockIdx.x / n_dtiles;
  const int dtile = blockIdx.x - b * n_dtiles;
  const int d0 = dtile * kBlockCh, col = hf * kCh + lane, d = d0 + col;
  const int n_tiles = (seq - 1) / kSteps + 1;
  float4* const bcw = reinterpret_cast<float4*>(smem + L::kBcw) + warp * kSteps;  // this warp's

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&loaded[s], 1);      // warp 0's arrive.expect_tx, then the copies' bytes
      mbar_init(&empty[s], kWarps);  // one lane of each warp
    }
    for (int r = 0; r < kGroups; ++r) {
      mbar_init(&full[r], kWarps);   // each warp has written the group's parts
      mbar_init(&freed[r], kWarps);  // each warp has summed its share of them
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(&tfull[k], kWarps);  // each warp has its dB and dC of a tile written
      mbar_init(&tfree[k], kWarps);  // each warp has summed its share of them
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier: the mbarriers exist

  // Iteration i runs tile n_tiles - 1 - i, in stage i % kStages; its decays
  // and parts of step t live in slot t (i even) or 31 - t (i odd).
  auto issue = [&](int i) {  // lane 0 of warp 0
    const int s = i % kStages, c = n_tiles - 1 - i;
    unsigned char* st = ring + s * L::kStage;
    mbar_arrive_expect_tx(&loaded[s], L::kStage);
    tma_load(st + L::kDt, &tm_dt, d0, c * kSteps, b, &loaded[s]);
    tma_load(st + L::kX, &tm_x, d0, c * kSteps, b, &loaded[s]);
    tma_load(st + L::kDy, &tm_dy, d0, c * kSteps, b, &loaded[s]);
    tma_load(st + L::kB, &tm_b, 0, c * kSteps, b, &loaded[s]);
    tma_load(st + L::kC, &tm_c, 0, c * kSteps, b, &loaded[s]);
    tma_load(st + L::kCk, &tm_h, 0, d0, b * n_tiles + c, &loaded[s]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages && i < n_tiles; ++i) issue(i);
  }

  // This warp's share of group r of iteration i: the parts of kShare (step,
  // half) of the group summed over the half's warps in warp order, into ddt
  // and dx.
  auto share = [&](int i, int r) {
    mbar_wait(&full[r], i & 1);  // every warp has written the group's parts
    const int64_t t0 = static_cast<int64_t>(n_tiles - 1 - i) * kSteps;
#pragma unroll
    for (int m = 0; m < kShare; ++m) {
      const int c = warp * kShare + m, h = c / kGroup;
      const int t = kSteps - (r + 1) * kGroup + c % kGroup;
      const float2* p = slots + ((i & 1) ? kSteps - 1 - t : t) * kSlotStride + h * kPairs * kCh + lane;
      float2 v[kPairs];
#pragma unroll
      for (int w = 0; w < kPairs; ++w) v[w] = p[w * kCh];
      float2 acc = v[0];
#pragma unroll
      for (int w = 1; w < kPairs; ++w) acc.x += v[w].x, acc.y += v[w].y;
      const int dd = d0 + h * kCh + lane;
      if (dd < d_model && t0 + t < seq) {
        const int64_t o = (b * static_cast<int64_t>(seq) + t0 + t) * d_model + dd;
        ddt[o] = acc.x;
        dxo[o] = acc.y;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&freed[r]);
  };

  // This warp's share of iteration i's dB and dC: kPer values, each the sum
  // of the two halves' tiles, into the block's partials.
  auto reduce = [&](int i) {
    const float* tile = dbc + (i & 1) * kHalves * kTile;
    const int64_t t0 = static_cast<int64_t>(n_tiles - 1 - i) * kSteps;
    mbar_wait(&tfull[i & 1], (i >> 1) & 1);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = (m * kWarps + warp) * 32 + lane;
      const float acc = tile[e] + tile[kTile + e];
      const int kind = e / (kSteps * ST), t = (e / ST) % kSteps, s = e % ST;
      if (t0 + t < seq) (kind ? part_c : part_b)[((static_cast<int64_t>(b) * n_dtiles + dtile) * seq + t0 + t) * ST + s] = acc;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&tfree[i & 1]);
  };

  // ---- a thread: states s0, s0 + 1 (its warp's pair) of channel d ----
  const int s0 = q * kStates;
  const bool live = d < d_model;
  const bool a_bf16 = flags & kABf16;
  float av[kStates], g[kStates], da[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    av[j] = live ? load_f32(a, static_cast<int64_t>(d) * ST + s0 + j, a_bf16) : 0.f;
    g[j] = live ? dh_final[(static_cast<int64_t>(b) * d_model + d) * ST + s0 + j] : 0.f;
    da[j] = 0.f;
  }
  float2* const mine = slots + warp * kCh + lane;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const unsigned char* st = ring + s * L::kStage;
    float2* const slot0 = (i & 1) ? mine + (kSteps - 1) * kSlotStride : mine;  // this thread's slot of step 0
    const int dir = (i & 1) ? -kSlotStride : kSlotStride;
    float* tile = dbc + ((i & 1) * kHalves + hf) * kTile;
    const float a2[kStates] = {av[0] * kLog2e, av[1] * kLog2e};  // as K9 forms it
    mbar_wait(&loaded[s], (i / kStages) & 1);
    {  // this warp's B and C of the tile as float32, once: lane = step
      const float2 bb = lds_pair<kBcB>(st + L::kB, lane * ST + s0), cc = lds_pair<kBcB>(st + L::kC, lane * ST + s0);
      bcw[lane] = make_float4(bb.x, bb.y, cc.x, cc.y);
      __syncwarp();
    }

    // 1) the recompute: h[t] is the state before step t; each decay formed once
    float h[kSteps][kStates];
    {
      const float2 ck = *reinterpret_cast<const float2*>(st + L::kCk + (col * ST + s0) * 4);
      h[0][0] = ck.x, h[0][1] = ck.y;
    }
    float vals[16];
    Step nx = load_step<ST, kDtB, kXB, kDyB, kBcB, false>(st, 0, col, bcw, nullptr);
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const int f = t / kGroup, k = t % kGroup;
      if (k == 0 && i >= 1) mbar_wait(&freed[f], (i - 1) & 1);  // iteration i - 1's parts here are summed
      if (t == 0 && i >= 2) mbar_wait(&tfree[i & 1], ((i - 2) >> 1) & 1);  // and its dB, dC tile two back
      const Step v = nx;
      if (t + 1 < kSteps) nx = load_step<ST, kDtB, kXB, kDyB, kBcB, false>(st, t + 1, col, bcw, nullptr);
      const float dtx = v.dt * v.x;
      const float bj[kStates] = {v.bc.x, v.bc.y};
      float dec[kStates];
#pragma unroll
      for (int j = 0; j < kStates; ++j) {
        dec[j] = scan_decay(v.dt, a2[j]);
        const float hn = scan_step(h[t][j], dec[j], dtx, bj[j]);
        if (t + 1 < kSteps) h[t + 1][j] = hn;
        vals[k * kStates + j] = hn * v.dy;  // dC
      }
      slot0[t * dir] = make_float2(dec[0], dec[1]);
      if (k == kGroup - 1) {
        const float sum = reduce_scatter16(vals, lane);
        if ((lane & 1) == 0) {
          const int m = lane >> 1;
          tile[(kSteps + t - k + (m >> 1)) * ST + s0 + (m & 1)] = sum;
        }
        // Work for iteration i - 1 that waits on the other warps, a group
        // or more after they did their part: the last group's parts, the
        // ring's refill, and the dB and dC tile.
        if (f == 0 && i >= 1) share(i - 1, kGroups - 1);
        if (f == 1 && i >= 1 && warp == 0 && i - 1 + kStages < n_tiles) {
          mbar_wait(&empty[(i - 1) % kStages], ((i - 1) / kStages) & 1);
          if (lane == 0) issue(i - 1 + kStages);
          __syncwarp();
        }
        if (f == kGroups - 1 && i >= 1) reduce(i - 1);
      }
    }

    // 2) the reverse pass, g entering as dL/dh after the tile
    Step nr = load_step<ST, kDtB, kXB, kDyB, kBcB, true>(st, kSteps - 1, col, bcw, slot0 + (kSteps - 1) * dir);
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = kSteps - 1 - u, k = t % kGroup, r = u / kGroup;
      const Step v = nr;
      if (t > 0) nr = load_step<ST, kDtB, kXB, kDyB, kBcB, true>(st, t - 1, col, bcw, slot0 + (t - 1) * dir);
      const float dtx = v.dt * v.x;
      const float bj[kStates] = {v.bc.x, v.bc.y}, cj[kStates] = {v.bc.z, v.bc.w}, dj[kStates] = {v.dec.x, v.dec.y};
      float p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int j = 0; j < kStates; ++j) {
        g[j] = fmaf(v.dy, cj[j], g[j]);
        vals[k * kStates + j] = g[j] * dtx;  // dB
        p2 = fmaf(g[j], bj[j], p2);
        const float gd = g[j] * dj[j];
        const float gdec = gd * h[t][j];
        p1 = fmaf(gdec, av[j], p1);
        da[j] = fmaf(v.dt, gdec, da[j]);
        g[j] = gd;
      }
      slot0[t * dir] = make_float2(fmaf(v.x, p2, p1), v.dt * p2);  // this thread's parts of ddt and dx
      if (k == 0) {
        const float sum = reduce_scatter16(vals, lane);
        if ((lane & 1) == 0) {
          const int m = lane >> 1;
          tile[(t + (m >> 1)) * ST + s0 + (m & 1)] = sum;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[r]);  // the group's parts are written
        if (r >= 1) share(i, r - 1);
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[s]);       // done with the stage
      mbar_arrive(&tfull[i & 1]);   // and with the tile of dB and dC
    }
  }
  share(n_tiles - 1, kGroups - 1);
  reduce(n_tiles - 1);
  if (live) {
#pragma unroll
    for (int j = 0; j < kStates; ++j) part_a[(static_cast<int64_t>(b) * d_model + d) * ST + s0 + j] = da[j];
  }
}

// The second pass: dB and dC (B, S, st) as the sums of the n_dtiles partials of
// each (b, t, s), and dA (D, st) as the sum of the B partials of each (d, s),
// each in index order.
__global__ void __launch_bounds__(256)
    ssm_scan_bwd_reduce(const float* __restrict__ part_b, const float* __restrict__ part_c,
                        const float* __restrict__ part_a, float* __restrict__ db, float* __restrict__ dc,
                        float* __restrict__ da, int64_t batch, int64_t seq_st, int64_t n_dtiles, int64_t d_st) {
  const int64_t n_bc = batch * seq_st, n = n_bc + d_st;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      const int64_t bb = i / seq_st;
      const float* pb = part_b + bb * n_dtiles * seq_st + (i - bb * seq_st);
      const float* pc = part_c + bb * n_dtiles * seq_st + (i - bb * seq_st);
      float sb = 0.f, sc = 0.f;
#pragma unroll 8
      for (int64_t k = 0; k < n_dtiles; ++k) {
        sb += pb[k * seq_st];
        sc += pc[k * seq_st];
      }
      db[i] = sb;
      dc[i] = sc;
    } else {
      const int64_t j = i - n_bc;
      float s = 0.f;
      for (int64_t bb = 0; bb < batch; ++bb) s += part_a[bb * d_st + j];
      da[j] = s;
    }
  }
}

// ---- the host side ----

struct BwdArgs {
  const void *dt, *x, *bm, *cm, *a, *hstart, *dy, *dh_final;
  float *ddt, *dx, *db, *dc, *da, *work;
  int batch, seq, d_model, st, flags;
  cudaStream_t stream;
};

struct BwdMaps {
  CUtensorMap dt, x, dy, b, c, h;
};

int64_t n_tiles_of(int64_t seq) { return (seq + kSteps - 1) / kSteps; }
int64_t n_dtiles_of(int64_t d_model) { return (d_model + kBlockCh - 1) / kBlockCh; }

// Float32 of the workspace: the partials of dB and of dC (B, ceil(D / 64),
// S, st) each, then those of dA (B, D, st).
int64_t work_floats(int64_t batch, int64_t seq, int64_t d_model, int64_t st) {
  return 2 * batch * n_dtiles_of(d_model) * seq * st + batch * d_model * st;
}

bool encode_all(BwdMaps& m, const BwdArgs& s) {
  const bool dt16 = s.flags & kDtBf16, x16 = s.flags & kXBf16, dy16 = s.flags & kDyBf16, bc16 = s.flags & kBcBf16;
  const int64_t d = s.d_model, seq = s.seq, bsz = s.batch;
  return encode3d(&m.dt, s.dt, dt16, d, seq, bsz, kBlockCh, kSteps) &&
         encode3d(&m.x, s.x, x16, d, seq, bsz, kBlockCh, kSteps) &&
         encode3d(&m.dy, s.dy, dy16, d, seq, bsz, kBlockCh, kSteps) &&
         encode3d(&m.b, s.bm, bc16, s.st, seq, bsz, s.st, kSteps) &&
         encode3d(&m.c, s.cm, bc16, s.st, seq, bsz, s.st, kSteps) &&
         encode3d(&m.h, s.hstart, false, s.st, d, bsz * n_tiles_of(seq), s.st, kBlockCh);
}

template <int ST, bool kDtB, bool kXB, bool kDyB, bool kBcB>
int launch_kernel(const BwdMaps& m, const BwdArgs& s) {
  using L = Layout<ST, kDtB, kXB, kDyB, kBcB>;
  const auto kernel = ssm_scan_bwd_kernel<ST, kDtB, kXB, kDyB, kBcB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_dtiles = n_dtiles_of(s.d_model);
  const int64_t n_part = static_cast<int64_t>(s.batch) * n_dtiles * s.seq * ST;
  float *part_b = s.work, *part_c = s.work + n_part, *part_a = s.work + 2 * n_part;
  kernel<<<static_cast<unsigned>(s.batch * n_dtiles), 32 * L::kWarps, L::kBytes, s.stream>>>(
      m.dt, m.x, m.dy, m.b, m.c, m.h, s.a, static_cast<const float*>(s.dh_final), s.ddt, s.dx, part_b, part_c,
      part_a, s.seq, s.d_model, static_cast<int>(n_dtiles), s.flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(s.batch) * s.seq * ST + static_cast<int64_t>(s.d_model) * ST;
  const int64_t blocks = (n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16;
  ssm_scan_bwd_reduce<<<static_cast<unsigned>(blocks), 256, 0, s.stream>>>(
      part_b, part_c, part_a, s.db, s.dc, s.da, s.batch, static_cast<int64_t>(s.seq) * ST, n_dtiles,
      static_cast<int64_t>(s.d_model) * ST);
  return static_cast<int>(cudaGetLastError());
}

template <int ST, bool kDtB, bool kXB, bool kDyB>
int launch_bc(const BwdMaps& m, const BwdArgs& s) {
  return s.flags & kBcBf16 ? launch_kernel<ST, kDtB, kXB, kDyB, true>(m, s)
                           : launch_kernel<ST, kDtB, kXB, kDyB, false>(m, s);
}

template <int ST, bool kDtB, bool kXB>
int launch_dy(const BwdMaps& m, const BwdArgs& s) {
  return s.flags & kDyBf16 ? launch_bc<ST, kDtB, kXB, true>(m, s) : launch_bc<ST, kDtB, kXB, false>(m, s);
}

template <int ST, bool kDtB>
int launch_x(const BwdMaps& m, const BwdArgs& s) {
  return s.flags & kXBf16 ? launch_dy<ST, kDtB, true>(m, s) : launch_dy<ST, kDtB, false>(m, s);
}

template <int ST>
int launch_dt(const BwdMaps& m, const BwdArgs& s) {
  return s.flags & kDtBf16 ? launch_x<ST, true>(m, s) : launch_x<ST, false>(m, s);
}

// What a launch must satisfy: shapes at least 1, st 8 or 16, the rows of dt,
// x and dy and every operand 16-byte aligned (the TMA's rule for its maps),
// and the workspace's size.
bool valid(const BwdArgs& s, int64_t batch, int64_t seq, int64_t work) {
  const void* ptrs[14] = {s.dt, s.x, s.bm, s.cm, s.a, s.hstart, s.dy, s.dh_final,
                          s.ddt, s.dx, s.db, s.dc, s.da, s.work};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  const int64_t d = s.d_model;
  const bool rows = d * (s.flags & kDtBf16 ? 2 : 4) % 16 == 0 && d * (s.flags & kXBf16 ? 2 : 4) % 16 == 0 &&
                    d * (s.flags & kDyBf16 ? 2 : 4) % 16 == 0;
  return batch >= 1 && seq >= 1 && seq <= INT32_MAX - kSteps && d >= 1 && (s.st == 8 || s.st == 16) && rows &&
         batch * n_tiles_of(seq) <= INT32_MAX && batch * n_dtiles_of(d) <= INT32_MAX &&
         work == work_floats(batch, seq, d, s.st);
}

// What K10's block kernel requests: Layout::kBytes of dynamic shared
// memory, and its static shared memory in *static_bytes when not null (-1
// if it cannot be read).  The reduction after it requests none.
template <int ST, bool kDtB, bool kXB, bool kDyB, bool kBcB>
int64_t bwd_query(int64_t* static_bytes) {
  if (static_bytes != nullptr) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, ssm_scan_bwd_kernel<ST, kDtB, kXB, kDyB, kBcB>) != cudaSuccess) return -1;
    *static_bytes = static_cast<int64_t>(attr.sharedSizeBytes);
  }
  return Layout<ST, kDtB, kXB, kDyB, kBcB>::kBytes;
}

template <int ST, bool kDtB, bool kXB, bool kDyB>
int64_t bwd_query_bc(int flags, int64_t* sb) {
  return flags & kBcBf16 ? bwd_query<ST, kDtB, kXB, kDyB, true>(sb) : bwd_query<ST, kDtB, kXB, kDyB, false>(sb);
}

template <int ST, bool kDtB, bool kXB>
int64_t bwd_query_dy(int flags, int64_t* sb) {
  return flags & kDyBf16 ? bwd_query_bc<ST, kDtB, kXB, true>(flags, sb) : bwd_query_bc<ST, kDtB, kXB, false>(flags, sb);
}

template <int ST, bool kDtB>
int64_t bwd_query_x(int flags, int64_t* sb) {
  return flags & kXBf16 ? bwd_query_dy<ST, kDtB, true>(flags, sb) : bwd_query_dy<ST, kDtB, false>(flags, sb);
}

template <int ST>
int64_t bwd_query_dt(int flags, int64_t* sb) {
  return flags & kDtBf16 ? bwd_query_x<ST, true>(flags, sb) : bwd_query_x<ST, false>(flags, sb);
}

}  // namespace

extern "C" {

// The dynamic shared memory one K10 launch requests at state width st with
// the dtype flags of ssm_scan_bwd, 0 for a width the kernel refuses, and its
// static shared memory in *static_bytes when not null:
// kernels/ssm_scan.py's bwd_smem_bytes must give the same.
int64_t ssm_scan_bwd_smem_bytes(int st, int flags, int64_t* static_bytes) {
  if (st == 16) return bwd_query_dt<16>(flags, static_bytes);
  if (st == 8) return bwd_query_dt<8>(flags, static_bytes);
  return 0;
}

// Float32 of the workspace one K10 call on these shapes takes.
int64_t ssm_scan_bwd_work_floats(int64_t batch, int64_t seq, int d_model, int st) {
  return work_floats(batch, seq, d_model, st);
}

// One K10 call on `stream`: the block kernel, then the reduction of its
// partials.  st must be 8 or 16; batch, seq and d_model at least 1, d_model
// times the element size of dt, of x and of dy a multiple of 16 bytes, every
// pointer 16-byte aligned; hstart (B, ceil(seq / 32), D, st) float32 holds
// K9's states at every 32-step tile start; dh_final (B, D, st) float32.  The
// outputs ddt, dx (B, S, D), db, dc (B, S, st), da (D, st) and the workspace
// of `work_size` float32 (ssm_scan_bwd_work_floats) are preallocated.
// Returns a cudaError_t code, 0 when both launches were accepted.
int ssm_scan_bwd(const void* dt, const void* x, const void* bm, const void* cm, const void* a, const void* hstart,
                 const void* dy, const void* dh_final, void* ddt, void* dx, void* db, void* dc, void* da, void* work,
                 int64_t work_size, int64_t batch, int64_t seq, int d_model, int st, int flags, void* stream) {
  const BwdArgs s{dt, x, bm, cm, a, hstart, dy, dh_final,
                  static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(db),
                  static_cast<float*>(dc), static_cast<float*>(da), static_cast<float*>(work),
                  static_cast<int>(batch), static_cast<int>(seq), d_model, st, flags,
                  static_cast<cudaStream_t>(stream)};
  if (!valid(s, batch, seq, work_size)) return static_cast<int>(cudaErrorInvalidValue);
  BwdMaps m;
  if (!encode_all(m, s)) return static_cast<int>(cudaErrorInvalidValue);
  return st == 16 ? launch_dt<16>(m, s) : launch_dt<8>(m, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
