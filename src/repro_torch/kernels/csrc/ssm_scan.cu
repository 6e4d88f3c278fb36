// The fused selective-scan forward (K9) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssm_scan.py::_kernel, launched by _fwd_call
// (through ssm_scan_pallas), together with the host-side identity padding of
// the sequence to a multiple of the chunk (_ssm_scan_launch).
//
// What it computes, for every batch row b, channel d and state s:
//     h_t = exp(dt_t * a[d, s]) * h_{t-1} + (dt_t * x_t) * B_t[s],  h_{-1} = 0
//     y_t = sum_s h_t[s] * C_t[s]
// with dt, x (B, S, D), B, C (B, S, st) and a (D, st).  Every input is read in
// its own dtype (float32 or bfloat16, named by `flags`) and converted to
// float32 when a thread reads it; all arithmetic is float32.  y is written in
// x's dtype (rounded to nearest even for bfloat16), the last state h_final
// (B, D, st) in float32 and, when `hstart` is not null, the state at the start
// of every chunk, hstart (B, ceil(S / chunk), D, st) in float32 (hstart[:, 0]
// = 0); the chunk is then a multiple of the 32-step tile, so that every
// checkpoint falls on a tile start.  The state width is 8 or 16, the widths of
// the configs that run the fused scan.  S need not be a multiple of anything:
// nothing is padded on the host, and h_final is the state after step S - 1.
//
// Design.  The TPU kernel walks a (batch, d-tile, seq-chunk) grid in order and
// carries the state in VMEM from one seq step of the grid to the next.  Blocks
// on Hopper run in no order, so a block owns one (b, CH channels) and walks
// the whole sequence itself, with the state in registers.
//  * Threads.  A consumer warp is one group of kStates = 4 states of all
//    kCh = 32 channels: lane l holds those states of channel l, so a warp's
//    reads of B and C are one address (a broadcast), and its reads of dt and
//    x consecutive words.  A block is st / 4 consumer warps and one producer
//    warp, and B = 1, D = 8192 gives 256 blocks, 8 consumer warps per SM.
//    The thread map and the ring's 4 stages are what a sweep on the card
//    chose (2, 4 or 8 states per thread, 32 or 64 channels per block, 3 or 4
//    stages; PERF.md has the table): this one was the fastest at the
//    prefill's shape and within 0.5 % of the fastest at the others.
//  * A ring of tiles in shared memory.  Each stage holds 32 steps of dt and x
//    (CH channels) and of B and C (all st states), brought in by the Tensor
//    Memory Accelerator (TMA) as raw bits in their own dtype, through 3-D
//    tensor maps over (B, S, D) and (B, S, st): a box past the end of S or D is
//    filled with zeros by the hardware and never reads the next batch row.
//    Each stage has three mbarriers: "loaded" (the copies' bytes landed),
//    "ready" (the producer has turned B and C into float32: one conversion per
//    block, not one per thread and state) and "empty" (every consumer warp is
//    done with the stage).  Nothing waits on the whole block after the start:
//    a consumer warp waits only for the stage it needs next, the producer for
//    the stage it retires.
//  * y.  Each thread writes its part of y_t (the sum over its 4 states) to a
//    buffer of parts; one tile later, each consumer warp sums its share of the
//    tile's y in warp order into a y tile in x's dtype, and the producer
//    writes the tile back with one TMA store.  The sum is fixed in order and
//    there are no atomics, so two launches give the same bits.
//  * Latency.  At B = 1 an SM holds 8 consumer warps, two per scheduler, so
//    one warp's stalls are not hidden for long.  A group of 4 steps' inputs
//    comes into registers while the group before it runs; the loads must be
//    issued ahead of that group's stores of its parts by hand, because the
//    compiler does not move a load past a store into the same shared array.
//  * The step, scan_step of ssm_scan.cuh (shared with K10): exp on the
//    special-function unit (SFU) as ex2.approx.ftz of dt * (a * log2 e), the
//    update dx * b, one fma.  Past the end of S the zero-filled dt gives a
//    decay of 1 and an update of 0, so the state carries over unchanged and
//    the last tile needs no other path; the TMA store drops y past the end.
//  * Offsets into hstart and h_final are 64-bit; S and B * D / 32 fit in 32.
//
// What bounds it, at (1, 32768, 8192, 16) with the model path's dtypes (dt
// float32; x, y, B, C, a bfloat16).  Bytes: dt, x and y once each, B, C, a and
// h_final: 2.15 GB, 0.642 ms at 3.35 TB/s.  Float32 operations: 7 per (b, t,
// d, s) and one per (b, t, d), 3.0e10, 0.453 ms at 67 TFLOP/s.  The
// exponentials: one per (b, t, d, s), 4.29e9, at 16 per SM per clock (132 SMs,
// 1.98 GHz) 1.027 ms.  That last floor binds: no design gets under it unless
// it moves exponentials onto the FMA pipes, and per element the FMA pipes
// already carry four of the five instructions an SFU-bound step issues.
// Splitting the sequence across blocks (a chunk pass, a carry pass, then y)
// would apply each carried state to the later segments' steps, a second
// exponential per state and step (the recurrence rerun from the carry, or
// exp(a * cumsum dt)), so the SFU floor would rise to about 1.5 ms with two
// segments; the design keeps one pass per block and raises what an SM gets
// done per clock instead.  Measured on an H100 (PERF.md): about 1.5x the SFU
// floor.  What is left is latency: with two consumer warps per scheduler,
// neither the SFU nor the issue slots are kept full.

#include "ssm_scan.cuh"
#include "tma.cuh"

namespace {

// ---- elements in shared memory ----

// Four consecutive floats, 16-byte aligned.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Four y values of consecutive channels into a row of x's dtype (bfloat16
// rounded to nearest even, as torch rounds finite values).
template <bool kBf16>
__device__ __forceinline__ void sts_y4(unsigned char* base, int i, float4 v) {
  if constexpr (kBf16) {
    uint32_t lo, hi;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(lo) : "f"(v.y), "f"(v.x));
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(hi) : "f"(v.w), "f"(v.z));
    *reinterpret_cast<uint2*>(base + 2 * i) = make_uint2(lo, hi);
  } else {
    *reinterpret_cast<float4*>(base + 4 * i) = v;
  }
}

// ---- the kernel ----

constexpr int kStates = 4;  // states per consumer thread
constexpr int kCh = 32;     // channels per block, one per lane
constexpr int kStages = 4;  // tiles in the ring
constexpr int kBarBytes = 128;  // the ring's mbarriers, ahead of everything else

constexpr int kParts = 3;  // buffers of the consumer warps' parts of y: tile i's are summed after tile i + 1
constexpr int kYTiles = 4;  // y tiles between the consumers' sums and the producer's TMA stores

// Shared memory of one block: the ring's stages, then the buffers of the
// consumer warps' parts of y, then the y tiles (every size a multiple of 128
// bytes).  A block is kCh channels and ST / kStates consumer warps.
template <int ST, bool kDtB, bool kXB>
struct Layout {
  static constexpr int kWarps = ST / kStates;
  static constexpr int kDtBytes = kSteps * kCh * (kDtB ? 2 : 4);
  static constexpr int kXBytes = kSteps * kCh * (kXB ? 2 : 4);  // x, and a y tile in x's dtype
  static constexpr int kBcRawBytes = kSteps * ST * 2;            // B or C as bfloat16 bits
  static constexpr int kBcBytes = kSteps * ST * 4;               // B or C as float32
  // one stage
  static constexpr int kDt = 0;
  static constexpr int kX = kDt + kDtBytes;
  static constexpr int kBRaw = kX + kXBytes;
  static constexpr int kCRaw = kBRaw + kBcRawBytes;
  static constexpr int kB = kCRaw + kBcRawBytes;
  static constexpr int kC = kB + kBcBytes;
  static constexpr int kStage = kC + kBcBytes;
  // the whole block
  static constexpr int kPart = kBarBytes + kStages * kStage;  // [kParts][kSteps][kWarps][kCh] float32
  static constexpr int kPartFloats = kSteps * kWarps * kCh;
  static constexpr int kY = kPart + kParts * 4 * kPartFloats;  // [kYTiles][kSteps][kCh] in x's dtype
  static constexpr int kBytes = kY + kYTiles * kXBytes;
  static_assert(kBytes <= 232448, "a block's shared memory on Hopper");  // 120 KB with every operand float32
  static_assert(kDtBytes % 128 == 0 && kXBytes % 128 == 0 && kBcRawBytes % 128 == 0, "tile alignment");
};

constexpr int kGroup = 4;  // steps whose inputs are loaded together, a group ahead of their use

// The inputs of one group of steps, as float32, for one channel and kStates states.
struct Group {
  float dt[kGroup], x[kGroup], b[kGroup][kStates], c[kGroup][kStates];
};

// Group g of the tile in stage `st`: dt and x of this thread's channel, B and
// C of its warp's states (one address for the whole warp: a broadcast).
template <int ST, bool kDtB, bool kXB, class L>
__device__ __forceinline__ void load_group(Group& in, const unsigned char* st, int g, int q, int lane) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int t = g * kGroup + u;
    in.dt[u] = lds_f32<kDtB>(st + L::kDt, t * kCh + lane);
    in.x[u] = lds_f32<kXB>(st + L::kX, t * kCh + lane);
    load4(reinterpret_cast<const float*>(st + L::kB) + t * ST + q * kStates, in.b[u]);
    load4(reinterpret_cast<const float*>(st + L::kC) + t * ST + q * kStates, in.c[u]);
  }
}

template <int ST, bool kDtB, bool kXB, bool kCkpt>
__global__ void __launch_bounds__(32 * (ST / kStates + 1))
    ssm_scan_kernel(const __grid_constant__ CUtensorMap tm_dt, const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_b, const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_y, const void* __restrict__ a,
                    float* __restrict__ h_final, float* __restrict__ hstart, int seq, int d_model, int chunk,
                    int n_dtiles, int flags) {
  using L = Layout<ST, kDtB, kXB>;
  constexpr int kWarps = L::kWarps, kGroups = kSteps / kGroup;
  constexpr int kSums = kSteps * kCh / 4 / (32 * kWarps);  // y values of 4 channels a lane sums per tile
  static_assert(ST % kStates == 0 && 3 * kStages * 8 <= kBarBytes, "thread map");
  static_assert(kSums >= 1 && kSums * 32 * kWarps * 4 == kSteps * kCh, "tile split");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* loaded = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ready = loaded + kStages;
  uint64_t* empty = ready + kStages;
  unsigned char* ring = smem + kBarBytes;
  float* parts = reinterpret_cast<float*>(smem + L::kPart);
  unsigned char* ytiles = smem + L::kY;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / n_dtiles;
  const int d0 = (blockIdx.x - b * n_dtiles) * kCh;
  const int n_tiles = (seq - 1) / kSteps + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&loaded[s], 1);      // the producer's arrive.expect_tx, then the copies' bytes
      mbar_init(&ready[s], 32);      // every lane of the producer warp
      mbar_init(&empty[s], kWarps);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier: the mbarriers exist

  // Stage s = i % kStages holds tile i.  Its "empty" barrier completes a phase
  // when every consumer warp has run tile i, stored its parts of tile i's y
  // and summed its share of tile i - 1's y; after the last tile each warp
  // sums its share of that tile's y and completes one more phase, as if for
  // a tile n_tiles.
  if (warp == kWarps) {
    // ---- the producer warp: TMA loads, B and C to float32, TMA stores of y ----
    const bool bc_bf16 = flags & kBcBf16;
    const uint32_t tx = L::kDtBytes + L::kXBytes + 2 * kSteps * ST * (bc_bf16 ? 2 : 4);
    auto issue = [&](int j) {  // tile j's inputs into stage j % kStages
      if (lane == 0) {
        const int s = j % kStages;
        unsigned char* st = ring + s * L::kStage;
        mbar_arrive_expect_tx(&loaded[s], tx);
        tma_load(st + L::kDt, &tm_dt, d0, j * kSteps, b, &loaded[s]);
        tma_load(st + L::kX, &tm_x, d0, j * kSteps, b, &loaded[s]);
        tma_load(st + (bc_bf16 ? L::kBRaw : L::kB), &tm_b, 0, j * kSteps, b, &loaded[s]);
        tma_load(st + (bc_bf16 ? L::kCRaw : L::kC), &tm_c, 0, j * kSteps, b, &loaded[s]);
      }
    };
    for (int j = 0; j < kStages && j < n_tiles; ++j) issue(j);
    // Iteration i readies tile i and retires tile i - 2: by then the
    // consumers are on tile i - 1, so neither side waits on the other.
    for (int i = 0; i < n_tiles + 3; ++i) {
      const int j = i - 2;
      if (j >= 0 && j <= n_tiles) {
        mbar_wait(&empty[j % kStages], (j / kStages) & 1);  // tile j run, tile j - 1's y summed
        if (j + kStages < n_tiles) issue(j + kStages);
        if (lane == 0 && j >= 1) {
          tma_store(&tm_y, ytiles + ((j - 1) % kYTiles) * L::kXBytes, d0, (j - 1) * kSteps, b);
          bulk_commit();
        }
      }
      if (i < n_tiles) {
        const int s = i % kStages;
        unsigned char* st = ring + s * L::kStage;
        mbar_wait(&loaded[s], (i / kStages) & 1);
        if (bc_bf16) {  // 4 values per lane and pass: 8-byte reads, 16-byte writes
          const uint2* rb = reinterpret_cast<const uint2*>(st + L::kBRaw);
          const uint2* rc = reinterpret_cast<const uint2*>(st + L::kCRaw);
          float4* wb = reinterpret_cast<float4*>(st + L::kB);
          float4* wc = reinterpret_cast<float4*>(st + L::kC);
          for (int e = lane; e < kSteps * ST / 4; e += 32) {
            const uint2 u = rb[e], v = rc[e];
            wb[e] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                                __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
            wc[e] = make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                                __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
          }
        }
        // During tile i the consumers write tile i - 1's y into the y tile whose
        // last store, of tile i - 1 - kYTiles, is at least the third most recent:
        // at most the most recent may still read shared memory.
        if (lane == 0) bulk_wait_read<1>();
        __syncwarp();
        mbar_arrive(&ready[s]);
      }
    }
    if (lane == 0) bulk_wait_all();
    return;
  }

  // ---- a consumer thread: kStates states (its warp's group q) of channel d0 + lane ----
  const int q = warp;
  const bool live = d0 + lane < d_model;
  const bool a_bf16 = flags & kABf16;
  float a2[kStates], h[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    a2[j] = live ? load_f32(a, static_cast<int64_t>(d0 + lane) * ST + q * kStates + j, a_bf16) * kLog2e : 0.f;
    h[j] = 0.f;
  }
  const int n_chunks = (seq - 1) / chunk + 1;
  float* ck = kCkpt ? hstart + (static_cast<int64_t>(b) * n_chunks * d_model + d0 + lane) * ST + q * kStates : nullptr;
  const int64_t ck_step = static_cast<int64_t>(d_model) * ST;

  // This warp's share of tile j's y: the parts of the kWarps warps summed in
  // warp order, 4 channels at a time, into a y tile in x's dtype.
  auto sum_y = [&](int j) {
    mbar_wait(&empty[j % kStages], (j / kStages) & 1);  // every warp's parts of tile j are written
    const float4* pt = reinterpret_cast<const float4*>(parts + (j % kParts) * L::kPartFloats);
    unsigned char* yt = ytiles + (j % kYTiles) * L::kXBytes;
    float4 v[kSums];
#pragma unroll
    for (int r = 0; r < kSums; ++r) {  // every load ahead of every store
      const int e = lane + 32 * (q + kWarps * r), t = e / (kCh / 4), c4 = e % (kCh / 4);
      v[r] = pt[(t * kWarps) * (kCh / 4) + c4];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 u = pt[(t * kWarps + w) * (kCh / 4) + c4];
        v[r].x += u.x, v[r].y += u.y, v[r].z += u.z, v[r].w += u.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kSums; ++r) {
      const int e = lane + 32 * (q + kWarps * r);
      sts_y4<kXB>(yt, (e / (kCh / 4)) * kCh + 4 * (e % (kCh / 4)), v[r]);
    }
    fence_proxy_async();  // this lane's y, visible to the producer's TMA store
  };

  auto stage_of = [&](int tile) { return ring + (tile % kStages) * L::kStage; };
  Group cur, next;
  mbar_wait(&ready[0], 0);
  load_group<ST, kDtB, kXB, L>(cur, ring, 0, q, lane);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    if (kCkpt && (i * kSteps) % chunk == 0) {  // the state at the start of a chunk
      if (live) store4(ck, h);
      ck += ck_step;
    }
    float* part = parts + (i % kParts) * L::kPartFloats + q * kCh + lane;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      // The next group's inputs, this tile's or the next one's, come into
      // registers while this group runs: their loads go out ahead of this
      // group's stores of its parts, past which the compiler would not move
      // them (one shared array, so it cannot tell the parts from the inputs).
      if (g + 1 < kGroups) {
        load_group<ST, kDtB, kXB, L>(next, stage_of(i), g + 1, q, lane);
      } else if (i + 1 < n_tiles) {
        mbar_wait(&ready[(i + 1) % kStages], ((i + 1) / kStages) & 1);
        load_group<ST, kDtB, kXB, L>(next, stage_of(i + 1), 0, q, lane);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float dx = cur.dt[u] * cur.x[u];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          h[j] = scan_step(h[j], cur.dt[u], a2[j], dx, cur.b[u][j]);
          acc = fmaf(h[j], cur.c[u][j], acc);
        }
        part[(g * kGroup + u) * kWarps * kCh] = acc;
      }
      cur = next;
    }
    if (i >= 1) sum_y(i - 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // tile i run, its parts written, tile i - 1's y summed
  }
  sum_y(n_tiles - 1);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[n_tiles % kStages]);  // the last tile's y summed
  if (live) store4(h_final + (static_cast<int64_t>(b) * d_model + d0 + lane) * ST + q * kStates, h);
}

// ---- the host side ----

struct ScanArgs {
  const void *dt, *x, *bm, *cm, *a;
  void* y;
  float *h_final, *hstart;
  int batch, seq, d_model, st, chunk, flags;
  cudaStream_t stream;
};

struct Maps {
  CUtensorMap dt, x, b, c, y;
};

// Every operand is a (batch, seq, inner) tensor, in boxes of (1, 32, inner
// slice): 32 channels of dt, x and y, all st states of B and C.
bool encode_all(Maps& m, const ScanArgs& s) {
  const bool dt16 = s.flags & kDtBf16, x16 = s.flags & kXBf16, bc16 = s.flags & kBcBf16;
  return encode3d(&m.dt, s.dt, dt16, s.d_model, s.seq, s.batch, kCh, kSteps) &&
         encode3d(&m.x, s.x, x16, s.d_model, s.seq, s.batch, kCh, kSteps) &&
         encode3d(&m.b, s.bm, bc16, s.st, s.seq, s.batch, s.st, kSteps) &&
         encode3d(&m.c, s.cm, bc16, s.st, s.seq, s.batch, s.st, kSteps) &&
         encode3d(&m.y, s.y, x16, s.d_model, s.seq, s.batch, kCh, kSteps);
}

template <int ST, bool kDtB, bool kXB, bool kCkpt>
int launch_kernel(const Maps& m, const ScanArgs& s) {
  using L = Layout<ST, kDtB, kXB>;
  const auto kernel = ssm_scan_kernel<ST, kDtB, kXB, kCkpt>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_dtiles = (s.d_model + kCh - 1) / kCh;
  if (static_cast<int64_t>(s.batch) * n_dtiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(s.batch * n_dtiles), 32 * (L::kWarps + 1), L::kBytes, s.stream>>>(
      m.dt, m.x, m.b, m.c, m.y, s.a, s.h_final, s.hstart, s.seq, s.d_model, s.chunk, n_dtiles, s.flags);
  return static_cast<int>(cudaGetLastError());
}

template <int ST, bool kDtB, bool kXB>
int launch_ck(const Maps& m, const ScanArgs& s) {
  return s.hstart ? launch_kernel<ST, kDtB, kXB, true>(m, s) : launch_kernel<ST, kDtB, kXB, false>(m, s);
}

template <int ST>
int launch_dtypes(const Maps& m, const ScanArgs& s) {
  switch (s.flags & (kDtBf16 | kXBf16)) {
    case 0: return launch_ck<ST, false, false>(m, s);
    case kDtBf16: return launch_ck<ST, true, false>(m, s);
    case kXBf16: return launch_ck<ST, false, true>(m, s);
    default: return launch_ck<ST, true, true>(m, s);
  }
}

// What a launch must satisfy: shapes at least 1, st 8 or 16, the (B, S, D)
// rows and every operand 16-byte aligned (the TMA's rule for its maps), and
// with checkpoints a chunk that is a multiple of the tile.
bool valid(const void* dt, const void* x, const void* bm, const void* cm, const void* a, const void* y,
           const void* hstart, int64_t batch, int64_t seq, int d_model, int st, int64_t chunk, int flags) {
  const int64_t row_dt = static_cast<int64_t>(d_model) * (flags & kDtBf16 ? 2 : 4);
  const int64_t row_x = static_cast<int64_t>(d_model) * (flags & kXBf16 ? 2 : 4);
  const void* ptrs[6] = {dt, x, bm, cm, a, y};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return batch >= 1 && batch <= INT32_MAX && seq >= 1 && seq <= INT32_MAX - kSteps && d_model >= 1 && chunk >= 1 &&
         chunk <= INT32_MAX && (st == 8 || st == 16) && row_dt % 16 == 0 && row_x % 16 == 0 &&
         (hstart == nullptr || chunk % kSteps == 0);
}

// What K9's launch requests: Layout::kBytes of dynamic shared memory, and
// in *static_bytes (when not null) the larger static shared memory of the
// two kernels (with and without checkpoints); -1 if it cannot be read.
template <int ST, bool kDtB, bool kXB>
int64_t scan_query(int64_t* static_bytes) {
  if (static_bytes != nullptr) {
    cudaFuncAttributes a0, a1;
    if (cudaFuncGetAttributes(&a0, ssm_scan_kernel<ST, kDtB, kXB, false>) != cudaSuccess ||
        cudaFuncGetAttributes(&a1, ssm_scan_kernel<ST, kDtB, kXB, true>) != cudaSuccess) {
      return -1;
    }
    *static_bytes = static_cast<int64_t>(a0.sharedSizeBytes > a1.sharedSizeBytes ? a0.sharedSizeBytes
                                                                                  : a1.sharedSizeBytes);
  }
  return Layout<ST, kDtB, kXB>::kBytes;
}

template <int ST>
int64_t scan_query_dtypes(int flags, int64_t* static_bytes) {
  switch (flags & (kDtBf16 | kXBf16)) {
    case 0: return scan_query<ST, false, false>(static_bytes);
    case kDtBf16: return scan_query<ST, true, false>(static_bytes);
    case kXBf16: return scan_query<ST, false, true>(static_bytes);
    default: return scan_query<ST, true, true>(static_bytes);
  }
}

}  // namespace

extern "C" {

// The dynamic shared memory one K9 launch requests at state width st with
// the dtype flags of ssm_scan_fwd, 0 for a width the kernel refuses, and
// its static shared memory in *static_bytes when not null:
// kernels/ssm_scan.py's smem_bytes must give the same.
int64_t ssm_scan_smem_bytes(int st, int flags, int64_t* static_bytes) {
  if (st == 16) return scan_query_dtypes<16>(flags, static_bytes);
  if (st == 8) return scan_query_dtypes<8>(flags, static_bytes);
  return 0;
}

// One K9 launch on `stream`.  st must be 8 or 16; batch, seq and d_model at
// least 1, d_model times the element size of dt and of x a multiple of 16
// bytes, every operand 16-byte aligned; chunk a positive multiple of 32 when
// hstart is not null; y, h_final and hstart (or null) preallocated.  Returns
// a cudaError_t code, 0 when the launch was accepted.
int ssm_scan_fwd(const void* dt, const void* x, const void* bm, const void* cm, const void* a, void* y,
                 void* h_final, void* hstart, int64_t batch, int64_t seq, int d_model, int st, int64_t chunk,
                 int flags, void* stream) {
  if (!valid(dt, x, bm, cm, a, y, hstart, batch, seq, d_model, st, chunk, flags)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScanArgs s{dt, x, bm, cm, a, y, static_cast<float*>(h_final), static_cast<float*>(hstart),
                   static_cast<int>(batch), static_cast<int>(seq), d_model, st, static_cast<int>(chunk), flags,
                   static_cast<cudaStream_t>(stream)};
  Maps m;
  if (!encode_all(m, s)) return static_cast<int>(cudaErrorInvalidValue);
  return st == 16 ? launch_dtypes<16>(m, s) : launch_dtypes<8>(m, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
