// What the selective-scan kernels share: K9 (ssm_scan.cu) and K10
// (ssm_scan_bwd.cu).  The tile length, the dtype flags, the loads of one
// element as float32, and the step of one state.  K10 recomputes the states
// that K9 ran with scan_step itself, so the recomputed states are K9's own,
// bit for bit, whatever thread map either kernel takes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 32;  // time steps per tile: K9's checkpoints fall on tile starts
constexpr float kLog2e = 1.4426950408889634f;

// flags: which inputs are bfloat16 (the others are float32)
constexpr int kDtBf16 = 1;
constexpr int kXBf16 = 2;  // and so y
constexpr int kBcBf16 = 4;
constexpr int kABf16 = 8;

__device__ __forceinline__ float load_f32(const void* p, int64_t i, bool bf16) {
  return bf16 ? __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i]) << 16)
              : static_cast<const float*>(p)[i];
}

// One value of a row in shared memory of float32 or bfloat16, as float32.
template <bool kBf16>
__device__ __forceinline__ float lds_f32(const unsigned char* base, int i) {
  return kBf16 ? __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(base)[i]) << 16)
               : reinterpret_cast<const float*>(base)[i];
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// exp(dt * a) with a2 = a * log2(e): one multiply and one ex2.approx.ftz on
// the special-function unit.  Its relative error is a few float32 ulps where
// the decay matters (|dt * a| of order 1); results below 2^-126 flush to 0.
__device__ __forceinline__ float scan_decay(float dt, float a2) { return ex2_approx(dt * a2); }

// One state's step of the recurrence, h <- exp(dt * a) * h + (dt * x) * b,
// with dx = dt * x formed once per (b, t, d): K9's and K10's states come from
// this function alone.  Past the end of the sequence the inputs are zeros:
// dt = 0 gives a decay of 1 and an update of 0, and the state carries over
// unchanged.  The four-argument form takes the decay, scan_decay(dt, a2),
// already formed: K10 keeps it for its reverse pass, so the step and the
// gradient share one exponential and the state is the same bits.
__device__ __forceinline__ float scan_step(float h, float dec, float dx, float b) { return fmaf(dec, h, dx * b); }

__device__ __forceinline__ float scan_step(float h, float dt, float a2, float dx, float b) {
  return scan_step(h, scan_decay(dt, a2), dx, b);
}

}  // namespace
