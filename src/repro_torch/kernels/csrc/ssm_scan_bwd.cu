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
//     gdec = g_t * h_{t-1} * exp(dt_t a)                (dL/d(dt_t a) through exp)
//     ddt_t = sum_s gdec * a + x_t * sum_s g_t * B_t,  dx_t = dt_t * sum_s g_t * B_t
//     dB_t[s] = sum_d g_t * dt_t x_t,  dC_t[s] = sum_d h_t * dy_t,
//     dA[d, s] = sum_b sum_t dt_t * gdec
// and writes the five gradients in float32: ddt, dx (B, S, D), dB, dC (B, S, st),
// dA (D, st).  Inputs are read in their own dtypes (float32 or bfloat16, named
// by `flags`), as K9 reads them, and converted to float32 in registers.
//
// Design.  The TPU kernel walks a (batch, seq chunk, d tile) grid in order,
// the seq chunks reversed, keeps (chunk + 1, d_tile, st) recomputed states in
// VMEM and accumulates dB, dC and dA across grid steps.  Here, as in K9, a
// block owns one (b, 32 channels) and walks the whole sequence itself, tiles
// of 32 steps from the last to the first; a thread holds 2 states of one
// channel (lane = channel, warp = pair of states, st / 2 warps).
//  * Recompute.  The checkpoints are K9's at every tile start (the caller asks
//    K9 for a chunk of 32), so a tile's 33 states are recomputed from one
//    checkpoint into registers (66 floats per thread) by K9's own step
//    function, scan_step of ssm_scan.cuh (and the backward's decay by its
//    scan_decay): the recomputed states are K9's, bit for bit.  The TPU's (chunk + 1, 32,
//    st) buffer at chunk 128 would be 264 KB, more than a block's 227 KB of
//    shared memory; a 32-step interval costs K9 one more write of the state
//    per tile and this kernel one read (4 bytes per (b, d, s) every 32 steps:
//    67 MB at (1, 4096, 8192, 16), a quarter of K9's other bytes there).
//  * The tile's inputs (dt, x, dy per channel, B and C per state) are staged in
//    shared memory as float32 while the next tile back is loaded into
//    registers as raw bits.
//  * Reductions, none with atomics, so that two launches give the same bits:
//    - over the st states of a channel (ddt, dx): each thread writes its part
//      (sum over its 2 states) per step to shared memory, and after the tile
//      the parts are summed in warp order;
//    - over the 32 channels of the block (dB, dC): per group of 4 steps a
//      warp's 16 values (4 steps x {dB, dC} x 2 states) are summed across the
//      lanes by a butterfly reduce-scatter (15 + 1 shuffles), then written
//      per block to a partial (B, D / 32, S, st), one per kind;
//    - over the blocks' partials: a second kernel of this source sums the
//      D / 32 partials of dB and dC, and the B partials of dA (B, D, st),
//      each in a fixed order.
//  * The tail: S need not be a multiple of 32.  A short last tile is staged
//    with zeros past the end (dt = 0 gives exp = 1 and an update of 0, so the
//    state is carried unchanged), and nothing past the end is written.
//    Channels past D (D a multiple of 4, not of 32) read zeros and write
//    nothing.  Element offsets are 64-bit.
//
// What bounds it (PERF.md has the measurements).  Bytes: dt, x, dy read and
// ddt, dx written (20 bytes per (b, t, d) on the model path: dt float32, x and
// dy bfloat16, the gradients float32), the checkpoints (1/32 of a state per
// step), B and C, and the partials of dB and dC (written once, read once).
// Operations: about 22 float32 operations per (b, t, d, s), the recompute
// included, and two exponentials on the special-function units.

#include "ssm_scan.cuh"

namespace {

constexpr int kDyBf16 = 16;  // flags: dy is bfloat16
constexpr int kDt = 32;      // channels per block
constexpr int kSpt = 2;      // states per thread: a block is st / 2 warps

// The loads below return raw bits and the conversion to float32 is separate:
// a conversion next to its load (inside the dtype branch) would wait for the
// load there, where the tile's prefetch must stay in flight.

// Elements i, i + 1 (i even): one 8-byte (float32) or 4-byte (bfloat16) load.
__device__ __forceinline__ uint2 raw2(const void* p, int64_t i, bool bf16) {
  uint2 r;
  if (bf16) {
    r.x = *reinterpret_cast<const uint32_t*>(static_cast<const uint16_t*>(p) + i);
  } else {
    r = *reinterpret_cast<const uint2*>(static_cast<const float*>(p) + i);
  }
  return r;
}

__device__ __forceinline__ float2 cvt2(uint2 r, bool bf16) {
  return bf16 ? make_float2(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u))
              : make_float2(__uint_as_float(r.x), __uint_as_float(r.y));
}

// Elements i .. i + 3 (i a multiple of 4): one 16-byte or 8-byte load.
__device__ __forceinline__ uint4 raw4(const void* p, int64_t i, bool bf16) {
  uint4 r;
  if (bf16) {
    const uint2 w = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(p) + i);
    r.x = w.x, r.y = w.y;
  } else {
    r = *reinterpret_cast<const uint4*>(static_cast<const float*>(p) + i);
  }
  return r;
}

__device__ __forceinline__ float4 cvt4(uint4 r, bool bf16) {
  return bf16 ? make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                            __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u))
              : make_float4(__uint_as_float(r.x), __uint_as_float(r.y), __uint_as_float(r.z),
                            __uint_as_float(r.w));
}

template <int ST>
struct alignas(16) BwdShared {
  float4 in[kSteps][kDt];               // (dt, x, dy, 0) per step and channel
  float4 bc[kSteps][ST / kSpt];         // (B, B, C, C) of each warp's 2 states per step
  float2 part[kSteps][ST / kSpt][kDt];  // per thread and step: (sum_j gdec_j a_j, sum_j g_j B_j)
  float dbc[2][kSteps][ST];             // dB, dC of the block's 32 channels per step and state
};

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

template <int ST>
__global__ void __launch_bounds__(kDt * ST / kSpt)
    ssm_scan_bwd_kernel(const void* __restrict__ dt, const void* __restrict__ x,
                        const void* __restrict__ bm, const void* __restrict__ cm,
                        const void* __restrict__ a, const float* __restrict__ hstart,
                        const void* __restrict__ dy, const float* __restrict__ dh_final,
                        float* __restrict__ ddt, float* __restrict__ dxo, float* __restrict__ part_b,
                        float* __restrict__ part_c, float* __restrict__ part_a, int64_t seq,
                        int d_model, int n_dtiles, int flags) {
  constexpr int kTpd = ST / kSpt;                          // threads per channel: one per warp
  constexpr int kThreads = kDt * kTpd;                     // threads per block
  constexpr int kRowLoads = kSteps * kDt / 4 / kThreads;  // 4-channel groups of dt, x, dy per thread per tile
  constexpr int kStLoads = kSteps * ST / 2 / kThreads;     // state pairs of B and C per thread per tile
  static_assert(kRowLoads * kThreads * 4 == kSteps * kDt && kStLoads * kThreads * 2 == kSteps * ST, "tile split");
  static_assert(kDt == 32 && kSpt == 2 && kSteps % 4 == 0, "lane = channel; one float4 of B and C; groups of 4 steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdShared<ST>& sm = *reinterpret_cast<BwdShared<ST>*>(smem_raw);

  const bool dt_bf16 = flags & kDtBf16, x_bf16 = flags & kXBf16, bc_bf16 = flags & kBcBf16;
  const bool a_bf16 = flags & kABf16, dy_bf16 = flags & kDyBf16;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / n_dtiles;
  const int dtile = blockIdx.x - static_cast<int>(b) * n_dtiles;
  const int d0 = dtile * kDt;
  const int dl = tid % kDt;  // this thread's channel in the block (its lane)
  const int q = tid / kDt;   // and its pair of states (its warp)
  const int d = d0 + dl;
  const bool live = d < d_model;
  const int64_t n_tiles = (seq + kSteps - 1) / kSteps;  // = checkpoints per row

  float av[kSpt], a2[kSpt], g[kSpt], da[kSpt];
#pragma unroll
  for (int j = 0; j < kSpt; ++j) {
    av[j] = live ? load_f32(a, static_cast<int64_t>(d) * ST + q * kSpt + j, a_bf16) : 0.f;
    a2[j] = av[j] * kLog2e;  // as K9 forms it
    g[j] = live ? dh_final[(b * d_model + d) * ST + q * kSpt + j] : 0.f;
    da[j] = 0.f;
  }

  uint4 p_dt[kRowLoads], p_x[kRowLoads], p_dy[kRowLoads];
  uint2 p_b[kStLoads], p_c[kStLoads];
  float2 p_h;
  auto prefetch = [&](int64_t c) {  // tile c into registers, as raw bits
    const int64_t t0 = c * kSteps;
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int e = tid + j * kThreads;
      const int64_t t = t0 + e / (kDt / 4);
      const int dd = d0 + 4 * (e % (kDt / 4));
      const bool ok = t < seq && dd < d_model;  // d_model is a multiple of 4
      const int64_t i = (b * seq + t) * d_model + dd;
      p_dt[j] = ok ? raw4(dt, i, dt_bf16) : make_uint4(0u, 0u, 0u, 0u);
      p_x[j] = ok ? raw4(x, i, x_bf16) : make_uint4(0u, 0u, 0u, 0u);
      p_dy[j] = ok ? raw4(dy, i, dy_bf16) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kStLoads; ++j) {
      const int e = tid + j * kThreads;
      const int64_t t = t0 + e / (ST / 2);
      const int64_t i = (b * seq + t) * ST + 2 * (e % (ST / 2));
      p_b[j] = t < seq ? raw2(bm, i, bc_bf16) : make_uint2(0u, 0u);
      p_c[j] = t < seq ? raw2(cm, i, bc_bf16) : make_uint2(0u, 0u);
    }
    p_h = live ? *reinterpret_cast<const float2*>(hstart + ((b * n_tiles + c) * d_model + d) * ST + q * kSpt)
               : make_float2(0.f, 0.f);
  };
  auto stage = [&]() {  // the prefetched tile into shared memory, as float32
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / (kDt / 4), c = 4 * (e % (kDt / 4));
      const float4 vd = cvt4(p_dt[j], dt_bf16), vx = cvt4(p_x[j], x_bf16), vy = cvt4(p_dy[j], dy_bf16);
      sm.in[r][c + 0] = make_float4(vd.x, vx.x, vy.x, 0.f);
      sm.in[r][c + 1] = make_float4(vd.y, vx.y, vy.y, 0.f);
      sm.in[r][c + 2] = make_float4(vd.z, vx.z, vy.z, 0.f);
      sm.in[r][c + 3] = make_float4(vd.w, vx.w, vy.w, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kStLoads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / (ST / 2), s = 2 * (e % (ST / 2));
      const float2 vb = cvt2(p_b[j], bc_bf16), vc = cvt2(p_c[j], bc_bf16);
      sm.bc[r][s / kSpt] = make_float4(vb.x, vb.y, vc.x, vc.y);
    }
  };

  prefetch(n_tiles - 1);
  stage();
  float h0[kSpt] = {p_h.x, p_h.y};  // the checkpoint of the staged tile
  __syncthreads();
  for (int64_t c = n_tiles - 1; c >= 0; --c) {
    const int64_t t0 = c * kSteps;
    if (c > 0) prefetch(c - 1);  // in flight while this tile runs

    // 1) the tile's states from its checkpoint: h[i] is the state before step i
    float h[kSteps + 1][kSpt];
#pragma unroll
    for (int j = 0; j < kSpt; ++j) h[0][j] = h0[j];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const float4 v = sm.in[i][dl];
      const float4 w = sm.bc[i][q];
      const float dtx = v.x * v.y;
      const float bj[kSpt] = {w.x, w.y};
#pragma unroll
      for (int j = 0; j < kSpt; ++j) h[i + 1][j] = scan_step(h[i][j], v.x, a2[j], dtx, bj[j]);
    }

    // 2) the reverse recurrence, 4 steps at a time; g enters as dL/dh after the tile
#pragma unroll
    for (int grp = kSteps / 4 - 1; grp >= 0; --grp) {
      float vals[16];  // per step k of the group: dB of the 2 states, then dC of the 2 states
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const int i = grp * 4 + k;
        const float4 v = sm.in[i][dl];
        const float4 w = sm.bc[i][q];
        const float dtx = v.x * v.y;
        const float bj[kSpt] = {w.x, w.y}, cj[kSpt] = {w.z, w.w};
        float p1 = 0.f, p2 = 0.f;
#pragma unroll
        for (int j = 0; j < kSpt; ++j) {
          vals[4 * k + 2 + j] = h[i + 1][j] * v.z;
          g[j] = fmaf(v.z, cj[j], g[j]);
          const float dec = scan_decay(v.x, a2[j]);
          const float gdec = g[j] * h[i][j] * dec;
          p1 = fmaf(gdec, av[j], p1);
          p2 = fmaf(g[j], bj[j], p2);
          vals[4 * k + j] = g[j] * dtx;
          da[j] = fmaf(v.x, gdec, da[j]);
          g[j] *= dec;
        }
        sm.part[i][q][dl] = make_float2(p1, p2);
      }
      const float sum = reduce_scatter16(vals, dl);
      if ((dl & 1) == 0) {
        const int idx = dl >> 1, k = idx >> 2, m = idx & 3;
        sm.dbc[m >> 1][grp * 4 + k][q * kSpt + (m & 1)] = sum;
      }
    }
    __syncthreads();  // the parts and dB/dC of the tile are whole

    // 3) ddt and dx of 4 channels of one step: the parts summed in warp order
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / (kDt / 4), c4 = 4 * (e % (kDt / 4));
      const int64_t t = t0 + r;
      if (t < seq && d0 + c4 < d_model) {
        float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < kTpd; ++m) {
          const float4 u0 = *reinterpret_cast<const float4*>(&sm.part[r][m][c4]);
          const float4 u1 = *reinterpret_cast<const float4*>(&sm.part[r][m][c4 + 2]);
          s1[0] += u0.x, s2[0] += u0.y, s1[1] += u0.z, s2[1] += u0.w;
          s1[2] += u1.x, s2[2] += u1.y, s1[3] += u1.z, s2[3] += u1.w;
        }
        float o1[4], o2[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 v = sm.in[r][c4 + k];
          o1[k] = s1[k] + v.y * s2[k];
          o2[k] = v.x * s2[k];
        }
        const int64_t o = (b * seq + t) * d_model + d0 + c4;
        *reinterpret_cast<float4*>(ddt + o) = make_float4(o1[0], o1[1], o1[2], o1[3]);
        *reinterpret_cast<float4*>(dxo + o) = make_float4(o2[0], o2[1], o2[2], o2[3]);
      }
    }
    // 4) this block's partial dB and dC of the tile: (steps, st) rows, contiguous
    {
      const int n_valid = static_cast<int>(seq - t0 < kSteps ? seq - t0 : kSteps);
      const int64_t base = ((b * n_dtiles + dtile) * seq + t0) * ST;
      const float* sb = &sm.dbc[0][0][0];
      const float* sc = &sm.dbc[1][0][0];
      for (int e = tid; e < n_valid * ST; e += kThreads) {
        part_b[base + e] = sb[e];
        part_c[base + e] = sc[e];
      }
    }
#pragma unroll
    for (int j = 0; j < kSpt; ++j) h0[j] = j == 0 ? p_h.x : p_h.y;  // the checkpoint of tile c - 1
    __syncthreads();  // nobody reads this tile's shared memory any more
    stage();          // tile c - 1 (unused after the first tile)
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kSpt; ++j) part_a[(b * d_model + d) * ST + q * kSpt + j] = da[j];
  }
}

// The second pass: dB and dC (B, S, st) as the sums of the n_dtiles partials
// of each (b, t, s), and dA (D, st) as the sum of the B partials of each
// (d, s), each in index order.
__global__ void __launch_bounds__(256)
    ssm_scan_bwd_reduce(const float* __restrict__ part_b, const float* __restrict__ part_c,
                        const float* __restrict__ part_a, float* __restrict__ db,
                        float* __restrict__ dc, float* __restrict__ da, int64_t batch,
                        int64_t seq_st, int64_t n_dtiles, int64_t d_st) {
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

template <int ST>
int launch(const void* dt, const void* x, const void* bm, const void* cm, const void* a,
           const void* hstart, const void* dy, const void* dh_final, void* ddt, void* dx, void* db,
           void* dc, void* da, void* part_b, void* part_c, void* part_a, int64_t batch, int64_t seq,
           int d_model, int flags, void* stream) {
  const int64_t n_dtiles = (d_model + kDt - 1) / kDt;
  if (batch * n_dtiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = ssm_scan_bwd_kernel<ST>;
  const int smem = static_cast<int>(sizeof(BwdShared<ST>));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<unsigned>(batch * n_dtiles), kDt * ST / kSpt, smem, s>>>(
      dt, x, bm, cm, a, static_cast<const float*>(hstart), dy, static_cast<const float*>(dh_final),
      static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(part_b),
      static_cast<float*>(part_c), static_cast<float*>(part_a), seq, d_model,
      static_cast<int>(n_dtiles), flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = batch * seq * ST + static_cast<int64_t>(d_model) * ST;
  const int64_t blocks = (n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16;
  ssm_scan_bwd_reduce<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(part_b), static_cast<const float*>(part_c),
      static_cast<const float*>(part_a), static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(da), batch, seq * ST, n_dtiles, static_cast<int64_t>(d_model) * ST);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One K10 call on `stream`: the block kernel, then the reduction of its
// partials.  st must be 8 or 16; batch, seq and d_model at least 1, d_model a
// multiple of 4; hstart (B, ceil(seq / 32), D, st) float32 holds K9's states
// at every 32-step tile start; dh_final (B, D, st) float32.  The outputs ddt,
// dx (B, S, D), db, dc (B, S, st), da (D, st) and the workspaces part_b,
// part_c (B, ceil(D / 32), S, st) and part_a (B, D, st) are float32 and
// preallocated.  Returns a cudaError_t code, 0 when both launches were
// accepted.
int ssm_scan_bwd(const void* dt, const void* x, const void* bm, const void* cm, const void* a,
                 const void* hstart, const void* dy, const void* dh_final, void* ddt, void* dx,
                 void* db, void* dc, void* da, void* part_b, void* part_c, void* part_a,
                 int64_t batch, int64_t seq, int d_model, int st, int flags, void* stream) {
  if (batch < 1 || seq < 1 || d_model < 1 || d_model % 4) return static_cast<int>(cudaErrorInvalidValue);
  switch (st) {
    case 8: return launch<8>(dt, x, bm, cm, a, hstart, dy, dh_final, ddt, dx, db, dc, da, part_b, part_c,
                             part_a, batch, seq, d_model, flags, stream);
    case 16: return launch<16>(dt, x, bm, cm, a, hstart, dy, dh_final, ddt, dx, db, dc, da, part_b, part_c,
                               part_a, batch, seq, d_model, flags, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
