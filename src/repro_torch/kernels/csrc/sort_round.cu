// One flat merge-sort round for Hopper (sm_90a): keys only (K3) and with
// 32-bit values (K4), one kernel template, sort_round_seg_kernel<K, kValues>.
//
// Replaces: src/repro/kernels/merge_path.py::_sort_round_kernel (launched by
// sort_round_pallas, K3) and ::_sort_round_kv_kernel (launched by
// sort_round_kv_pallas, K4), with the start table of _sort_round_starts.
// The layout is the reference's: m + T keys, the m data keys in sorted runs
// of `width`, then T iinfo.max sentinels (and, with values, m + T values,
// zeros in the tail).  The round merges run pairs (A, B) = (run 2p, run
// 2p + 1) into runs of 2 * width, stably with A-priority, and rewrites the
// tail.  Integer keys only (int16, int32), as the reference's sorts give
// them; values are int32 words and are only moved.
//
// What bounds it: memory.  A round reads the m data keys (and values) once
// and writes all m + T once: (2 * m + T) * (sizeof(K) + 4 if values) bytes.
// At m = 2^24 int32 keys that is 134 MB, 0.040 ms at 3.35 TB/s, and with
// int32 values 268 MB, 0.080 ms, far past the 50 MB L2.  A round of the
// serving sampler's row (32768 int16 keys and int32 values, 0.4 MB) is
// bound by the latency of its launch and of its dependent loads instead.
//
// What the design does about that (the paper's Segmented Parallel Merge):
//  * a block writes span = kThreads * e consecutive outputs, e outputs a
//    thread: kE (16 keys only, 8 with values), halved while the round
//    would have fewer than kMinBlocks blocks, so that a small round still
//    spreads over the card, and never more than a pair (2 * width).
//    Where a pair is wider than a span, the block lies inside one pair:
//    warp 0 bisects the block's first diagonal and warp 1 its last in
//    device memory, in parallel (co_rank_warp, at most 5 dependent steps at
//    width 2^23), so the block reads exactly its two windows, span keys (and
//    values) in all.  Neighbouring blocks take their shared diagonal from
//    the same search over the same runs, so equal keys keep their order
//    across the seam.  Where pairs are narrower, the block holds whole
//    pairs, reads them as one window and searches nothing in device memory;
//  * the windows go to shared memory by 16-byte loads of their aligned
//    covers, the keys' and the values' each at their own alignment, every
//    load of a thread issued before its first shared store; the extra
//    elements are dropped by index;
//  * each thread finds its own diagonal by one co-rank in shared memory and
//    merges its e outputs sequentially, one comparison each, the values
//    riding along (segment_merge.cuh), into registers;
//  * the outputs go back through shared memory and out by 16-byte stores,
//    or, at one output a thread, straight from the registers (coalesced);
//  * the extra last block writes the T sentinels (and T zero values).
// `tile` fixes only the tail; the kernel's span does not depend on it, and
// the level-2 leaf of the reference is not used: the stable merge has one
// output, so neither changes a bit.  Element offsets are 64-bit.

#include "segment_merge.cuh"

namespace repro {
namespace {

// Block shapes, from sweeps of 128 and 256 threads by 8 and 16 outputs a
// thread on an H100 (PERF.md): K3 256 x 16, K4 256 x 8; kMinBlocks
// from a sweep of 64, 128 and 256 on the sampler's rows.
constexpr int kThreads = 256;  // threads per block
template <bool kValues>
constexpr int kE = kValues ? 8 : 16;  // outputs per thread at most
constexpr int kMinBlocks = 128;  // data blocks a round keeps, down to one output a thread

// Outputs per thread of a round of m data elements in runs of `width`: kE,
// halved while the round would have fewer than kMinBlocks blocks (a small
// round then spreads over the card), and never more than a pair.
template <bool kValues>
__host__ __device__ constexpr int outputs_per_thread(int64_t m, int64_t width) {
  int e = kE<kValues>;
  while (e > 1 && m < static_cast<int64_t>(kMinBlocks) * kThreads * e) e >>= 1;
  return 2 * width < e ? static_cast<int>(2 * width) : e;
}

// 16-byte vectors a thread holds while it stages two windows of T (their
// aligned covers, at most span / (16 / sizeof(T)) + 2 vectors, over
// kThreads threads).
template <typename T, bool kValues>
constexpr int kStageVecs = (kE<kValues> * static_cast<int>(sizeof(T)) + 15) / 16 + 1;

// The windows g[ga : ga + ca] and g[gb : gb + cb] of one array, loaded as
// the 16-byte vectors of their aligned covers (vector v of the two covers
// in slot v / kThreads of thread v % kThreads) by load_windows, then written
// to the padded buffer s at 0 .. ca + cb - 1 by store_windows.  Every load
// of a thread is issued before its first store to shared memory, so the
// loads of both windows, keys and values, are in flight together.  A
// vector that would reach outside g[0 : n_total] is read element by
// element, so g need only be aligned to its element.
template <typename T>
struct WindowPair {
  static constexpr int kVec = 16 / sizeof(T);
  int64_t c0a, c0b;  // the first element of each cover
  int lead_a, lead_b, ca, cb, nva, nv;

  __device__ __forceinline__ WindowPair(const T* g, int64_t ga, int ca_, int64_t gb, int cb_)
      : ca(ca_), cb(cb_) {
    lead_a = static_cast<int>((reinterpret_cast<uintptr_t>(g + ga) & 15) / sizeof(T));
    lead_b = static_cast<int>((reinterpret_cast<uintptr_t>(g + gb) & 15) / sizeof(T));
    c0a = ga - lead_a;
    c0b = gb - lead_b;
    nva = (lead_a + ca + kVec - 1) / kVec;
    nv = nva + (lead_b + cb + kVec - 1) / kVec;
  }
};

template <typename T, int R>
__device__ __forceinline__ void load_windows(Vec16<T> (&x)[R], const WindowPair<T>& w, const T* __restrict__ g,
                                             int64_t n_total) {
  constexpr int kVec = WindowPair<T>::kVec;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int v = threadIdx.x + r * kThreads;
    if (v < w.nv) {
      const int64_t gi = v < w.nva ? w.c0a + static_cast<int64_t>(v) * kVec
                                   : w.c0b + static_cast<int64_t>(v - w.nva) * kVec;
      if (gi >= 0 && gi + kVec <= n_total) {
        x[r].q = __ldg(reinterpret_cast<const int4*>(g + gi));
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) x[r].x[c] = gi + c >= 0 && gi + c < n_total ? g[gi + c] : T{};
      }
    }
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_windows(T* s, const Vec16<T> (&x)[R], const WindowPair<T>& w) {
  constexpr int kVec = WindowPair<T>::kVec;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int v = threadIdx.x + r * kThreads;
    if (v < w.nv) {
      const bool in_a = v < w.nva;
      const int li0 = in_a ? v * kVec - w.lead_a : (v - w.nva) * kVec - w.lead_b;
      const int cnt = in_a ? w.ca : w.cb;
      const int dst = in_a ? 0 : w.ca;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const int li = li0 + c;
        if (li >= 0 && li < cnt) s[spad<T>(dst + li)] = x[r].x[c];
      }
    }
  }
}

template <typename K, bool kValues>
__global__ void __launch_bounds__(kThreads)
    sort_round_seg_kernel(const K* __restrict__ kf, const uint32_t* __restrict__ vf, K* __restrict__ ko,
                          uint32_t* __restrict__ vo, int64_t m, int64_t width, int tile) {
  constexpr int E = kE<kValues>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int64_t win[2];

  // width, two_w and span are powers of two: masks, no 64-bit divisions
  const int64_t two_w = 2 * width;
  const int e = outputs_per_thread<kValues>(m, width);
  const int span = kThreads * e;
  K* const s = reinterpret_cast<K*>(smem_raw);
  uint32_t* const sv = reinterpret_cast<uint32_t*>(s + spad_slots<K>(span + 1));

  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * span;
  if (o0 >= m) {  // the extra last block: the sentinel tail
    for (int j = threadIdx.x; j < tile; j += kThreads) {
      ko[m + j] = key_max<K>();
      if (kValues) vo[m + j] = 0;
    }
    return;
  }
  const int n = static_cast<int>(m - o0 < span ? m - o0 : span);
  const int64_t n_total = m + tile;
  // the windows g[ga : ga + ca] and g[gb : gb + cb] of the keys, and of the
  // values, to 0 .. ca + cb - 1 of their buffers, every load issued first
  const auto stage = [&](int64_t ga, int ca, int64_t gb, int cb) {
    const WindowPair<K> wk(kf, ga, ca, gb, cb);
    Vec16<K> xk[kStageVecs<K, kValues>];
    load_windows(xk, wk, kf, n_total);
    if (kValues) {
      const WindowPair<uint32_t> wv(vf, ga, ca, gb, cb);
      Vec16<uint32_t> xv[kStageVecs<uint32_t, kValues>];
      load_windows(xv, wv, vf, n_total);
      store_windows(s, xk, wk);
      store_windows(sv, xv, wv);
    } else {
      store_windows(s, xk, wk);
    }
  };
  const int j0 = threadIdx.x * e;
  int a0, na, b0, nb, d;  // this thread's merge, over the staged buffers
  if (two_w > span) {
    // inside one pair: the block's windows from its first and last diagonal
    const int64_t base = o0 & ~(two_w - 1);
    const int64_t dg = o0 - base;
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int64_t r = co_rank_warp(kf + base, width, kf + base + width, width, dg + warp * span);
      if ((threadIdx.x & 31) == 0) win[warp] = r;
    }
    __syncthreads();
    // Sorted runs give 0 <= wa <= span; the clamp keeps unsorted ones (whose
    // merge is unspecified) inside the buffers, keys and values alike.
    const int64_t wa64 = win[1] - win[0];
    const int wa = static_cast<int>(wa64 < 0 ? 0 : (wa64 < span ? wa64 : span));
    stage(base + win[0], wa, base + width + (dg - win[0]), span - wa);
    a0 = 0;
    na = wa;
    b0 = wa;
    nb = span - wa;
    d = j0;
  } else {
    // whole pairs: one contiguous window, each thread inside one pair
    stage(o0, n, o0 + n, 0);
    a0 = j0 & ~(static_cast<int>(two_w) - 1);
    na = static_cast<int>(width);
    b0 = a0 + na;
    nb = na;
    d = j0 - a0;
  }
  __syncthreads();

  K out[E];
  uint32_t vout[E];
  if (j0 < n) merge_segment<K, kValues, E>(s, sv, a0, na, b0, nb, d, e, out, vout);
  if (e == 1) {  // one output a thread: stored straight from its registers
    if (j0 < n) {
      ko[o0 + j0] = out[0];
      if (kValues) vo[o0 + j0] = vout[0];
    }
    return;
  }
  __syncthreads();  // every thread's reads of the windows are done
  if (j0 < n) {
    put_segment(s, j0, e, out);
    if (kValues) put_segment(sv, j0, e, vout);
  }
  __syncthreads();
  store_span(ko + o0, s, n);
  if (kValues) store_span(vo + o0, sv, n);
}

// The dynamic shared memory of a round's block: the padded key buffer (and
// value buffer) of span + 1 slots.
template <typename K, bool kValues>
size_t round_smem(int64_t m, int64_t width) {
  const int span = kThreads * outputs_per_thread<kValues>(m, width);
  return static_cast<size_t>(spad_slots<K>(span + 1)) * sizeof(K) +
         (kValues ? static_cast<size_t>(spad_slots<uint32_t>(span + 1)) * sizeof(uint32_t) : 0);
}

template <typename K, bool kValues>
int launch(const void* kf, const void* vf, void* ko, void* vo, int width, int tile, int n_data_tiles,
           void* stream) {
  const int64_t m = static_cast<int64_t>(n_data_tiles) * tile;
  const int span = kThreads * outputs_per_thread<kValues>(m, width);
  const int64_t n_blocks = (m + span - 1) / span;
  const size_t smem = round_smem<K, kValues>(m, width);
  const cudaError_t err = allow_smem(sort_round_seg_kernel<K, kValues>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_round_seg_kernel<K, kValues><<<static_cast<unsigned>(n_blocks + 1), kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(kf), static_cast<const uint32_t*>(vf), static_cast<K*>(ko),
      static_cast<uint32_t*>(vo), m, width, tile);
  return static_cast<int>(cudaGetLastError());
}

template <bool kValues>
int64_t round_query(int key, int64_t m, int64_t width, int64_t* static_bytes) {
  if (key == 0) {
    return smem_query(sort_round_seg_kernel<int16_t, kValues>, round_smem<int16_t, kValues>(m, width), static_bytes);
  }
  if (key == 1) {
    return smem_query(sort_round_seg_kernel<int32_t, kValues>, round_smem<int32_t, kValues>(m, width), static_bytes);
  }
  return -1;
}

}  // namespace
}  // namespace repro

extern "C" {

// The dynamic shared memory a K3 (K4) round of m data keys in runs of
// `width` requests, keys int16 (key 0) or int32 (key 1), and the kernel's
// static shared memory in *static_bytes when not null: kernels/merge_path.py's
// smem_bytes("round", ..., span=round_span(m, width, values)) must agree.
int64_t sort_round_smem_bytes(int key, int64_t m, int64_t width, int64_t* static_bytes) {
  return repro::round_query<false>(key, m, width, static_bytes);
}

int64_t sort_round_kv_smem_bytes(int key, int64_t m, int64_t width, int64_t* static_bytes) {
  return repro::round_query<true>(key, m, width, static_bytes);
}

// `leaf` is the reference's level-2 leaf width; these kernels have no leaves
// and ignore it (the round's output does not depend on it).
int sort_round_i16(const void* kf, void* ko, int width, int tile, int leaf, int n_data_tiles,
                   void* stream) {
  (void)leaf;
  return repro::launch<int16_t, false>(kf, nullptr, ko, nullptr, width, tile, n_data_tiles, stream);
}

int sort_round_i32(const void* kf, void* ko, int width, int tile, int leaf, int n_data_tiles,
                   void* stream) {
  (void)leaf;
  return repro::launch<int32_t, false>(kf, nullptr, ko, nullptr, width, tile, n_data_tiles, stream);
}

int sort_round_kv_i16(const void* kf, const void* vf, void* ko, void* vo, int width, int tile,
                      int leaf, int n_data_tiles, void* stream) {
  (void)leaf;
  return repro::launch<int16_t, true>(kf, vf, ko, vo, width, tile, n_data_tiles, stream);
}

int sort_round_kv_i32(const void* kf, const void* vf, void* ko, void* vo, int width, int tile,
                      int leaf, int n_data_tiles, void* stream) {
  (void)leaf;
  return repro::launch<int32_t, true>(kf, vf, ko, vo, width, tile, n_data_tiles, stream);
}

}  // extern "C"
