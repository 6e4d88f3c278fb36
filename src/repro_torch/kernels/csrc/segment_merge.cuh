// The paper's per-thread segment merge in shared memory, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge_path.py::_hier_merge_window (the
// two-level tile body that every Pallas merge kernel runs: S-leaves by
// Algorithm 2, then a co-rank per output slot), together with the per-tile
// start tables that _prepare and _sort_round_starts compute in a separate
// pass.  Every merge-path kernel runs this instead: the 1-D merges K1 and K2
// and the row merges K5-K8 (merge.cu), the flat sort rounds K3 and K4
// (sort_round.cu) and the tile sort S1 (sort_tiles.cu), over keys of 2 or 4
// bytes (int16, int32, float32, bfloat16) and 32-bit values.
//
// A block finds its place on the merge path by a warp-cooperative Algorithm
// 2 bisection in device memory (co_rank_warp), so there is no start-table
// pass and no host round trip.  Each thread owns E consecutive outputs of a
// merge: it finds its diagonal with one co-rank (Algorithm 2) over the two
// sorted inputs in shared memory, then merges its E outputs sequentially
// into registers with one comparison and one shared-memory read each (the
// Segmented Parallel Merge of the paper, one core per thread).  The merge is
// stable with A-priority: among keys that compare equal under the raw `<=`
// (so -0.0 == +0.0), A's come first.  Sides end by index, never by comparing
// against a sentinel, so keys equal to iinfo.max are data.
//
// Keys are compared with the raw `<=` of their type, as the reference's
// `la > lb` does: no total-order transform.  bfloat16 keys travel as their
// bits and compare through float, which is exact.  Values are 32-bit words
// and are only moved (int32 and float32 alike).
//
// Shared-memory layout: element i of a buffer lives at slot spad<T>(i), with
// one 4-byte word of padding after every 128 bytes.  A thread's E outputs
// (stride E between lanes, E a power of two up to 16 4-byte keys) and the
// striped copies to and from device memory then hit 32 distinct banks.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// bfloat16 as its 16 bits.
struct bf16 {
  uint16_t bits;
};

template <typename K>
__device__ __forceinline__ bool key_le(K x, K y) {
  return x <= y;
}

template <>
__device__ __forceinline__ bool key_le<bf16>(bf16 x, bf16 y) {
  return __uint_as_float(static_cast<uint32_t>(x.bits) << 16) <=
         __uint_as_float(static_cast<uint32_t>(y.bits) << 16);
}

// The sentinel that pads sorted data: the largest key of the type, +inf for
// floats (the port's max_sentinel).  It fills the flat sort rounds' tail and
// the slots of a ragged merge past each row's valid total.
template <typename K>
__device__ __forceinline__ K key_max();
template <>
__device__ __forceinline__ int16_t key_max<int16_t>() {
  return INT16_MAX;
}
template <>
__device__ __forceinline__ int32_t key_max<int32_t>() {
  return INT32_MAX;
}
template <>
__device__ __forceinline__ float key_max<float>() {
  return __int_as_float(0x7f800000);  // +inf
}
template <>
__device__ __forceinline__ bf16 key_max<bf16>() {
  return bf16{0x7f80};  // +inf
}

// Co-rank (Algorithm 2) over device memory: the number of A elements among
// the first d outputs of the stable A-priority merge of a[0:na] and
// b[0:nb], 0 <= d <= na + nb, searched by a whole warp with 64-bit offsets.
// The predicate a[i] <= b[d - 1 - i] holds for i below the answer and fails
// from it on, so 32 evenly spaced probes and a ballot narrow [lo, hi] to one
// step's width: a span of 2^24 takes 5 dependent steps instead of 24.  Must
// be called by all 32 lanes of a warp with the same arguments.
template <typename K>
__device__ int64_t co_rank_warp(const K* __restrict__ a, int64_t na, const K* __restrict__ b,
                                int64_t nb, int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d - nb > 0 ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t i = lo + lane * step;
    const bool pred = i < hi && key_le(a[i], b[d - 1 - i]);
    const int c = __popc(__ballot_sync(0xffffffffu, pred));  // probes 0..c-1 hold
    const int64_t new_lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    const int64_t cut = lo + c * step;  // probe c failed, or lies past hi
    hi = cut < hi ? cut : hi;
    lo = new_lo;
  }
  return lo;
}

// Opt in to more than 48 KB of dynamic shared memory where a block needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// What a `<kernel>_smem_bytes` entry returns: the dynamic shared memory
// `smem` that the kernel's launch requests, and, when `static_bytes` is not
// null, the kernel's static shared memory there (cudaFuncGetAttributes); -1
// if the attributes cannot be read.
template <typename Kernel>
inline int64_t smem_query(Kernel kernel, size_t smem, int64_t* static_bytes) {
  if (static_bytes != nullptr) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
    *static_bytes = static_cast<int64_t>(attr.sharedSizeBytes);
  }
  return static_cast<int64_t>(smem);
}

// The slot of element i in a padded shared-memory buffer of T.
template <typename T>
__device__ __forceinline__ int spad(int i) {
  constexpr int kRow = 128 / sizeof(T);
  constexpr int kPad = 4 / sizeof(T);
  return i + (i / kRow) * kPad;
}

// Slots a padded buffer of n elements needs, rounded up to 16 bytes so that
// buffers laid end to end keep their banks.
template <typename T>
__host__ __device__ constexpr int spad_slots(int n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  return (n + (n / (128 / static_cast<int>(sizeof(T))) + 1) * (4 / static_cast<int>(sizeof(T))) + kVec - 1) /
         kVec * kVec;
}

// Co-rank over a padded buffer: the number of A elements among the first d
// outputs of the merge of A = s[a0 : a0 + na] and B = s[b0 : b0 + nb].
template <typename K>
__device__ __forceinline__ int co_rank_padded(const K* s, int a0, int na, int b0, int nb, int d) {
  int lo = max(0, d - nb);
  int hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_le(s[spad<K>(a0 + mid)], s[spad<K>(b0 + d - 1 - mid)])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Outputs d .. d + e - 1 (e <= E, d + e <= na + nb) of the stable A-priority
// merge of A = sk[a0 : a0 + na] and B = sk[b0 : b0 + nb] into ok[0 : e] (and
// the values of sv into ov).  The element after each side's end is read but
// never used, so the buffer holds one slot past max(a0 + na, b0 + nb).
template <typename K, bool kValues, int E>
__device__ __forceinline__ void merge_segment(const K* sk, const uint32_t* sv, int a0, int na, int b0,
                                              int nb, int d, int e, K (&ok)[E], uint32_t (&ov)[E]) {
  int ai = co_rank_padded(sk, a0, na, b0, nb, d);
  int bi = d - ai;
  K ka = sk[spad<K>(a0 + ai)];
  K kb = sk[spad<K>(b0 + bi)];
  uint32_t va = 0, vb = 0;
  if (kValues) {
    va = sv[spad<uint32_t>(a0 + ai)];
    vb = sv[spad<uint32_t>(b0 + bi)];
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (j < e) {
      const bool take_a = ai < na && (bi >= nb || key_le(ka, kb));
      ok[j] = take_a ? ka : kb;
      if (kValues) ov[j] = take_a ? va : vb;
      // one read: the next element of the side taken
      const int next = take_a ? a0 + ai + 1 : b0 + bi + 1;
      ai += take_a;
      bi += !take_a;
      const K kn = sk[spad<K>(next)];
      ka = take_a ? kn : ka;
      kb = take_a ? kb : kn;
      if (kValues) {
        const uint32_t vn = sv[spad<uint32_t>(next)];
        va = take_a ? vn : va;
        vb = take_a ? vb : vn;
      }
    }
  }
}

// 16 bytes of T, as one vector access.
template <typename T>
union Vec16 {
  int4 q;
  T x[16 / sizeof(T)];
};

// Copy g[gs : gs + cnt] into the padded buffer s at dst .. dst + cnt - 1,
// by the whole block: 16-byte loads of the window's cover by 16-byte-aligned
// addresses, the elements outside the window dropped by index.  A vector
// that would reach outside g[0 : n_total] is read element by element, so g
// need only be aligned to its element.
template <typename T>
__device__ __forceinline__ void stage_window(T* s, int dst, const T* __restrict__ g, int64_t gs, int cnt,
                                             int64_t n_total) {
  constexpr int kVec = 16 / sizeof(T);
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(g + gs) & 15) / sizeof(T));
  const int64_t c0 = gs - lead;
  const int nvec = (lead + cnt + kVec - 1) / kVec;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int64_t gi = c0 + static_cast<int64_t>(v) * kVec;
    Vec16<T> x;
    if (gi >= 0 && gi + kVec <= n_total) {
      x.q = __ldg(reinterpret_cast<const int4*>(g + gi));
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) x.x[c] = gi + c >= 0 && gi + c < n_total ? g[gi + c] : T{};
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const int li = v * kVec + c - lead;
      if (li >= 0 && li < cnt) s[spad<T>(dst + li)] = x.x[c];
    }
  }
}

// Store the padded buffer's first n elements to g[0 : n] (g 16-byte
// aligned) with 16-byte stores by the whole block.
template <typename T>
__device__ __forceinline__ void store_span(T* __restrict__ g, const T* s, int n) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = n / kVec;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    Vec16<T> x;
#pragma unroll
    for (int c = 0; c < kVec; ++c) x.x[c] = s[spad<T>(v * kVec + c)];
    *reinterpret_cast<int4*>(g + static_cast<int64_t>(v) * kVec) = x.q;
  }
  for (int i = nvec * kVec + threadIdx.x; i < n; i += blockDim.x) g[i] = s[spad<T>(i)];
}

// Write elem(0) .. elem(n - 1) to g[0 : n] by the whole block: 16-byte
// stores over the 16-byte-aligned interior, the head and the tail element
// by element, so g need only be aligned to its element (store_span's
// counterpart of stage_window, for rows that start anywhere).
template <typename T, typename F>
__device__ __forceinline__ void store_window(T* __restrict__ g, int n, F elem) {
  constexpr int kVec = 16 / sizeof(T);
  const int lead = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) / sizeof(T));
  const int head = lead < n ? lead : n;
  const int nvec = (n - head) / kVec;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int i0 = head + v * kVec;
    Vec16<T> x;
#pragma unroll
    for (int c = 0; c < kVec; ++c) x.x[c] = elem(i0 + c);
    *reinterpret_cast<int4*>(g + i0) = x.q;
  }
  const int tail = head + nvec * kVec;
  for (int i = threadIdx.x; i < head + n - tail; i += blockDim.x) {
    const int j = i < head ? i : tail + (i - head);
    g[j] = elem(j);
  }
}

// Write a thread's e outputs to the padded buffer at j0 .. j0 + e - 1.
template <typename T, int E>
__device__ __forceinline__ void put_segment(T* s, int j0, int e, const T (&r)[E]) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (j < e) s[spad<T>(j0 + j)] = r[j];
  }
}

}  // namespace repro

// Every merge-path library exports it: kernels/merge_path.py turns a launch's
// error code into its message.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
