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
// float32 in registers; all arithmetic is float32.  y is written in x's dtype
// (rounded to nearest even for bfloat16), the last state h_final (B, D, st) in
// float32 and, when `hstart` is not null, the state at the start of every
// chunk, hstart (B, ceil(S / chunk), D, st) in float32 (hstart[:, 0] = 0);
// the chunk is then a multiple of the 32-step tile, so that every checkpoint
// falls on a tile start.  The state width is 8 or 16, the widths of the
// configs that run the fused scan.
// S need not be a multiple of the chunk: the last tile of a block is short,
// nothing is padded on the host, and h_final is the state after step S - 1.
//
// Design.  The TPU kernel walks a (batch, d-tile, seq-chunk) grid in order and
// carries the state in VMEM from one seq step of the grid to the next.  Blocks
// on Hopper run in no order, so here a block owns one (b, 32 channels) and
// loops over the whole sequence itself, with the state in registers; nothing
// of the state goes to device memory except h_final and the checkpoints.
//  * Parallelism is B * D * st lanes of state (131,072 at B = 1, D = 8192,
//    st = 16), and the sequence is the one axis that cannot be split without
//    a second pass.  A thread holds 2 states of one channel; a warp is the 32
//    channels of the block for one pair of states (lane = channel), and a
//    block is st / 2 warps (256 threads at st = 16).  B = 1 gives 256
//    blocks, 16 warps per SM.
//  * The sequence is staged through shared memory in tiles of 32 steps,
//    converted to float32 on the way in: (dt, x) pairs per channel and the B
//    and C values of each warp's states side by side.  Tile k + 1 is loaded
//    into registers (4 channels or 2 states per load) while tile k runs; the
//    loads return raw bits and are converted only when staged, so that no
//    conversion waits on its load.  Each step writes each thread's part of y
//    (the sum over its 2 states) to shared memory; after the tile, y is the
//    sum of the st / 2 parts, written 4 channels per store.
//  * Groups of 4 steps first do what does not depend on the state (the
//    loads, the exponentials, the update terms), then the 4 state updates:
//    a warp issues in order, so this keeps several exponentials in flight.
//  * exp runs on the special-function unit as ex2.approx.ftz of dt * (a *
//    log2 e): one MUFU op and one multiply per state and step (a * log2 e is
//    formed once per thread).  Its relative error is a few float32 ulps where
//    the decay matters (|dt * a| of order 1); results below 2^-126 flush to 0.
//    chip_smoke.py states the tolerance against the plain version.
//  * Element offsets are 64-bit: B * S * D passes 2^31 at (4, 32768, 8192).
//
// What bounds it.  Bytes: dt, x and y once each (8 bytes per (b, t, d) on the
// model path: dt float32, x and y bfloat16), plus B, C, a and h_final:
// 2.15 GB at (1, 32768, 8192, 16), 0.64 ms at 3.35 TB/s.  Operations: 7 float32
// operations per (b, t, d, s) (dt * a, exp, the update product, the two of the
// state update, the product with C and its sum), 3.0e10 at that shape, 0.45 ms
// at the card's 67 TFLOP/s outside the tensor cores: so by the published
// rates the bytes bound it.  The exponentials alone are 4.3e9 MUFU ops, about
// 1.03 ms at 16 per SM per clock (132 SMs, 1.98 GHz).  What this design meets
// first is neither: it is shared memory's delivery to the lanes, 128 bytes per
// SM per clock.  Each thread takes 28 bytes per step (its (dt, x), its 2 B
// and 2 C values, its y part), 14 per state, about 112 clocks per step on an
// SM at B = 1, about 1.9 ms at S = 32768 (PERF.md has the measurements).
// More states or channels per thread cut those bytes but leave too few warps
// per SM at B = 1; splitting the sequence across blocks (a second pass that
// carries the states) and TMA staging are left for later work.

#include "ssm_scan.cuh"

namespace {

constexpr int kGroup = 4;   // steps whose exponentials are in flight together

// float32 -> bfloat16 bits, rounded to nearest even, NaN kept quiet (as torch rounds)
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// Elements i .. i + 3 (i a multiple of 4) from float32, in one store.
__device__ __forceinline__ void store4(void* p, int64_t i, float4 v, bool bf16) {
  if (bf16) {
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(p) + i) =
        make_uint2(bf16_bits(v.x) | bf16_bits(v.y) << 16, bf16_bits(v.z) | bf16_bits(v.w) << 16);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
  }
}

template <int ST, bool kCheckpoints>
__global__ void __launch_bounds__(kDt * ST / kSpt)
    ssm_scan_kernel(const void* __restrict__ dt, const void* __restrict__ x,
                    const void* __restrict__ bm, const void* __restrict__ cm,
                    const void* __restrict__ a, void* __restrict__ y, float* __restrict__ h_final,
                    float* __restrict__ hstart, int64_t seq, int d_model, int64_t chunk,
                    int n_dtiles, int flags) {
  constexpr int kTpd = ST / kSpt;                      // threads per channel: one per warp
  constexpr int kThreads = kDt * kTpd;                 // threads per block
  constexpr int kRowLoads = kSteps * kDt / 4 / kThreads;  // 4-channel groups of dt (and x) per thread per tile
  constexpr int kStLoads = kSteps * ST / 2 / kThreads;     // state pairs of B (and C) per thread per tile
  static_assert(kRowLoads * kThreads * 4 == kSteps * kDt && kStLoads * kThreads * 2 == kSteps * ST, "tile split");
  static_assert(kDt == 32 && kSpt == 2, "a warp is the block's 32 channels; one float4 of B and C");

  // A warp is one group of kSpt states of all 32 channels (lane = channel),
  // so its B and C reads are one address for the whole warp and its dt/x
  // reads and y-part writes are consecutive words, free of bank conflicts.
  // A step moves 28 bytes per lane (8 + 16 in, 4 out).
  __shared__ __align__(16) float2 s_dtx[kSteps][kDt];
  __shared__ __align__(16) float s_bc[kSteps][kTpd][2 * kSpt];
  __shared__ __align__(16) float s_part[kSteps][kTpd][kDt];

  const bool dt_bf16 = flags & kDtBf16, x_bf16 = flags & kXBf16;
  const bool bc_bf16 = flags & kBcBf16, a_bf16 = flags & kABf16;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / n_dtiles;
  const int d0 = (blockIdx.x - static_cast<int>(b) * n_dtiles) * kDt;
  const int dl = tid % kDt;  // this thread's channel in the block (its lane)
  const int q = tid / kDt;   // and its group of kSpt states (its warp)
  const int d = d0 + dl;
  const bool live = d < d_model;

  float a2[kSpt], h[kSpt];
#pragma unroll
  for (int j = 0; j < kSpt; ++j) {
    a2[j] = live ? load_f32(a, static_cast<int64_t>(d) * ST + q * kSpt + j, a_bf16) * kLog2e : 0.f;
    h[j] = 0.f;
  }

  // Tile loads: each thread takes groups of 4 channels of one step (one 16-
  // or 8-byte load each of dt and x) and pairs of states (one load each of B
  // and C); stage() converts them to float32 into shared memory.
  uint4 p_dt[kRowLoads], p_x[kRowLoads];
  uint2 p_b[kStLoads], p_c[kStLoads];
  auto prefetch = [&](int64_t t0) {
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int e = tid + j * kThreads;
      const int64_t t = t0 + e / (kDt / 4);
      const int dd = d0 + 4 * (e % (kDt / 4));
      const bool ok = t < seq && dd < d_model;  // d_model is a multiple of 4
      const int64_t i = (b * seq + t) * d_model + dd;
      p_dt[j] = ok ? raw4(dt, i, dt_bf16) : make_uint4(0u, 0u, 0u, 0u);
      p_x[j] = ok ? raw4(x, i, x_bf16) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kStLoads; ++j) {
      const int e = tid + j * kThreads;
      const int64_t t = t0 + e / (ST / 2);
      const int64_t i = (b * seq + t) * ST + 2 * (e % (ST / 2));
      p_b[j] = t < seq ? raw2(bm, i, bc_bf16) : make_uint2(0u, 0u);
      p_c[j] = t < seq ? raw2(cm, i, bc_bf16) : make_uint2(0u, 0u);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int e = tid + j * kThreads;
      const float4 vd = cvt4(p_dt[j], dt_bf16), vx = cvt4(p_x[j], x_bf16);
      float4* row = reinterpret_cast<float4*>(&s_dtx[e / (kDt / 4)][4 * (e % (kDt / 4))]);
      row[0] = make_float4(vd.x, vx.x, vd.y, vx.y);
      row[1] = make_float4(vd.z, vx.z, vd.w, vx.w);
    }
#pragma unroll
    for (int j = 0; j < kStLoads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / (ST / 2), s = 2 * (e % (ST / 2));
      *reinterpret_cast<float2*>(&s_bc[r][s / kSpt][s % kSpt]) = cvt2(p_b[j], bc_bf16);
      *reinterpret_cast<float2*>(&s_bc[r][s / kSpt][kSpt + s % kSpt]) = cvt2(p_c[j], bc_bf16);
    }
  };
  // kGroup steps: first everything that does not depend on the state (the
  // loads, the exponentials, the update terms), for all of them, then the
  // state updates and this thread's parts of y into s_part.  A warp issues
  // in order, so this is what keeps several exponentials and loads in flight.
  auto steps = [&](int i0, int n) {
    float dec[kGroup][kSpt], upd[kGroup][kSpt], cc[kGroup][kSpt];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k < n) {
        const float2 v = s_dtx[i0 + k][dl];
        const float dx = v.x * v.y;
        const float4 w = *reinterpret_cast<const float4*>(&s_bc[i0 + k][q][0]);
        const float bc[2 * kSpt] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < kSpt; ++j) {
          dec[k][j] = ex2_approx(v.x * a2[j]);
          upd[k][j] = dx * bc[j];
          cc[k][j] = bc[kSpt + j];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k < n) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kSpt; ++j) {
          h[j] = fmaf(dec[k][j], h[j], upd[k][j]);
          acc = fmaf(h[j], cc[k][j], acc);
        }
        s_part[i0 + k][q][dl] = acc;
      }
    }
  };

  const int64_t n_chunks = (seq + chunk - 1) / chunk;
  float* ck = kCheckpoints ? hstart + (b * n_chunks * d_model + d) * ST + q * kSpt : nullptr;
  const int64_t ck_step = static_cast<int64_t>(d_model) * ST;

  prefetch(0);
  stage();
  __syncthreads();
  for (int64_t t0 = 0; t0 < seq; t0 += kSteps) {
    if (t0 + kSteps < seq) prefetch(t0 + kSteps);  // in flight while this tile runs
    if (kCheckpoints && t0 % chunk == 0) {  // the state at the start of a chunk
      if (live) {
#pragma unroll
        for (int j = 0; j < kSpt; ++j) ck[j] = h[j];
      }
      ck += ck_step;
    }
    if (t0 + kSteps <= seq) {  // a whole tile: fixed trip count
#pragma unroll 2
      for (int i = 0; i < kSteps; i += kGroup) steps(i, kGroup);
    } else {  // the short last tile
      const int n = static_cast<int>(seq - t0);
      for (int i = 0; i < n; ++i) steps(i, 1);
    }
    __syncthreads();  // s_part is whole; nobody reads this tile's inputs any more
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {  // y of 4 channels of one step: the sums of the parts
      const int e = tid + j * kThreads;
      const int r = e / (kDt / 4), c = 4 * (e % (kDt / 4));
      const int64_t t = t0 + r;
      if (t < seq && d0 + c < d_model) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int m = 0; m < kTpd; ++m) {
          const float4 w = *reinterpret_cast<const float4*>(&s_part[r][m][c]);
          v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
        }
        store4(y, (b * seq + t) * d_model + d0 + c, v, x_bf16);
      }
    }
    stage();  // tile k + 1 (unused past the end)
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kSpt; ++j) h_final[(b * d_model + d) * ST + q * kSpt + j] = h[j];
  }
}

template <int ST, bool kCheckpoints>
int launch_ck(const void* dt, const void* x, const void* bm, const void* cm, const void* a,
              void* y, void* h_final, void* hstart, int64_t batch, int64_t seq, int d_model,
              int64_t chunk, int flags, void* stream) {
  const int64_t n_dtiles = (d_model + kDt - 1) / kDt;
  if (batch * n_dtiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  ssm_scan_kernel<ST, kCheckpoints><<<static_cast<unsigned>(batch * n_dtiles), kDt * ST / kSpt, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      dt, x, bm, cm, a, y, static_cast<float*>(h_final), static_cast<float*>(hstart), seq, d_model,
      chunk, static_cast<int>(n_dtiles), flags);
  return static_cast<int>(cudaGetLastError());
}

template <int ST>
int launch(const void* dt, const void* x, const void* bm, const void* cm, const void* a, void* y,
           void* h_final, void* hstart, int64_t batch, int64_t seq, int d_model, int64_t chunk,
           int flags, void* stream) {
  if (hstart == nullptr) {
    return launch_ck<ST, false>(dt, x, bm, cm, a, y, h_final, hstart, batch, seq, d_model, chunk, flags, stream);
  }
  return launch_ck<ST, true>(dt, x, bm, cm, a, y, h_final, hstart, batch, seq, d_model, chunk, flags, stream);
}

}  // namespace

extern "C" {

// One K9 launch on `stream`.  st must be 8 or 16; batch, seq and d_model at
// least 1, d_model a multiple of 4; chunk a positive multiple of 32 when
// hstart is not null; y, h_final and hstart (or null) preallocated.  Returns
// a cudaError_t code, 0 when the launch was accepted.
int ssm_scan_fwd(const void* dt, const void* x, const void* bm, const void* cm, const void* a,
                 void* y, void* h_final, void* hstart, int64_t batch, int64_t seq, int d_model,
                 int st, int64_t chunk, int flags, void* stream) {
  if (batch < 1 || seq < 1 || d_model < 1 || d_model % 4 || chunk < 1 ||
      (hstart != nullptr && chunk % kSteps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (st) {
    case 8: return launch<8>(dt, x, bm, cm, a, y, h_final, hstart, batch, seq, d_model, chunk, flags, stream);
    case 16: return launch<16>(dt, x, bm, cm, a, y, h_final, hstart, batch, seq, d_model, chunk, flags, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
