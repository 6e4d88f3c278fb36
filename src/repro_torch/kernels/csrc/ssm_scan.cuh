// What the selective-scan kernels share: K9 (ssm_scan.cu) and K10
// (ssm_scan_bwd.cu).  The tile and block shape, the dtype flags, the loads that
// return raw bits and their conversions, and the exponential.  K10 recomputes
// the states that K9 ran with these same functions and the same expressions,
// so that the recomputed states are K9's own, bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 32;  // time steps staged per tile
constexpr int kDt = 32;     // channels per block
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSpt = 2;     // states per thread: a block is st / 2 warps

// flags: which inputs are bfloat16 (the others are float32)
constexpr int kDtBf16 = 1;
constexpr int kXBf16 = 2;  // and so y
constexpr int kBcBf16 = 4;
constexpr int kABf16 = 8;

__device__ __forceinline__ float load_f32(const void* p, int64_t i, bool bf16) {
  return bf16 ? __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i]) << 16)
              : static_cast<const float*>(p)[i];
}

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

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

}  // namespace
