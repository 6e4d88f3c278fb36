// One flat keys-only merge-sort round (K3) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge_path.py::_sort_round_kernel, launched by
// sort_round_pallas, with the start table of _sort_round_starts.  The layout
// is the reference's: m + T keys, the m data keys in sorted runs of `width`,
// then T iinfo.max sentinels.  The round merges run pairs (A, B) = (run 2p,
// run 2p + 1) into runs of 2 * width, stably with A-priority, and rewrites the
// tail.  Integer keys only (int16, int32), as the reference's ops.sort gives
// them.  K4 (sort_round_kv.cu) keeps merge_tile.cuh's tile body.
//
// What bounds it: memory.  A round reads the m data keys once and writes all
// m + T once: (2 * m + T) * sizeof(K) bytes.  At m = 2^24 int32 keys that is
// 134 MB, 0.040 ms at 3.35 TB/s, far past the 50 MB L2.
//
// What the design does about that (the paper's Segmented Parallel Merge):
//  * a block writes span = kThreads * e consecutive outputs, e = min(kE,
//    2 * width) per thread.  Where a pair is wider than a span, the block
//    lies inside one pair: warp 0 bisects the block's first diagonal and
//    warp 1 its last in device memory, in parallel (co_rank_warp, at most 5
//    dependent steps at width 2^23), so the block reads exactly its two
//    windows, span keys in all.  Where pairs are narrower, the block holds
//    whole pairs, reads them as one window and searches nothing in device
//    memory;
//  * the windows go to shared memory by 16-byte loads of their aligned
//    cover; the extra elements are dropped by index;
//  * each thread finds its own diagonal by one co-rank in shared memory and
//    merges its e outputs sequentially, one comparison each
//    (segment_merge.cuh), into registers;
//  * the outputs go back through shared memory and out by 16-byte stores;
//  * the extra last block writes the T sentinels.
// `tile` fixes only the tail; the kernel's span does not depend on it, and
// the level-2 leaf of the reference is not used: the stable merge has one
// output, so neither changes a bit.

#include "segment_merge.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kE = 16;         // outputs per thread: a span of 4096 keys

template <typename K>
__global__ void __launch_bounds__(kThreads)
    sort_round_seg_kernel(const K* __restrict__ kf, K* __restrict__ ko, int64_t m, int64_t width, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  __shared__ int64_t win[2];

  const int64_t two_w = 2 * width;
  const int e = static_cast<int>(two_w < kE ? two_w : kE);
  const int span = kThreads * e;
  const int64_t n_blocks = (m + span - 1) / span;

  if (static_cast<int64_t>(blockIdx.x) >= n_blocks) {  // the sentinel tail
    for (int j = threadIdx.x; j < tile; j += kThreads) ko[m + j] = key_max<K>();
    return;
  }

  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * span;
  const int n = static_cast<int>(m - o0 < span ? m - o0 : span);
  const int64_t n_total = m + tile;
  const int j0 = threadIdx.x * e;
  int a0, na, b0, nb, d;  // this thread's merge, over the staged buffer
  if (two_w > span) {
    // inside one pair: the block's windows from its first and last diagonal
    const int64_t base = o0 - o0 % two_w;
    const int64_t dg = o0 - base;
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int64_t r = co_rank_warp(kf + base, width, kf + base + width, width, dg + warp * span);
      if ((threadIdx.x & 31) == 0) win[warp] = r;
    }
    __syncthreads();
    // Sorted runs give 0 <= wa <= span; the clamp keeps unsorted ones (whose
    // merge is unspecified) inside the buffer.
    const int64_t wa64 = win[1] - win[0];
    const int wa = static_cast<int>(wa64 < 0 ? 0 : (wa64 < span ? wa64 : span));
    stage_window(s, 0, kf, base + win[0], wa, n_total);
    stage_window(s, wa, kf, base + width + (dg - win[0]), span - wa, n_total);
    a0 = 0;
    na = wa;
    b0 = wa;
    nb = span - wa;
    d = j0;
  } else {
    // whole pairs: one contiguous window, each thread inside one pair
    stage_window(s, 0, kf, o0, n, n_total);
    a0 = j0 - j0 % static_cast<int>(two_w);
    na = static_cast<int>(width);
    b0 = a0 + na;
    nb = na;
    d = j0 - a0;
  }
  __syncthreads();

  K out[kE];
  uint32_t unused[kE];
  if (j0 < n) merge_segment<K, false, kE>(s, nullptr, a0, na, b0, nb, d, e, out, unused);
  __syncthreads();  // every thread's reads of the windows are done
  if (j0 < n) put_segment(s, j0, e, out);
  __syncthreads();
  store_span(ko + o0, s, n);
}

template <typename K>
int launch(const void* kf, void* ko, int width, int tile, int n_data_tiles, void* stream) {
  const int64_t m = static_cast<int64_t>(n_data_tiles) * tile;
  const int64_t two_w = 2 * static_cast<int64_t>(width);
  const int span = kThreads * static_cast<int>(two_w < kE ? two_w : kE);
  const int64_t n_blocks = (m + span - 1) / span;
  const size_t smem = static_cast<size_t>(spad_slots<K>(span + 1)) * sizeof(K);
  sort_round_seg_kernel<K><<<static_cast<unsigned>(n_blocks + 1), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(kf), static_cast<K*>(ko), m, width, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

extern "C" {

// `leaf` is the reference's level-2 leaf width; this kernel has no leaves and
// ignores it (the round's output does not depend on it).
int sort_round_i16(const void* kf, void* ko, int width, int tile, int leaf, int n_data_tiles,
                   void* stream) {
  (void)leaf;
  return repro::launch<int16_t>(kf, ko, width, tile, n_data_tiles, stream);
}

int sort_round_i32(const void* kf, void* ko, int width, int tile, int leaf, int n_data_tiles,
                   void* stream) {
  (void)leaf;
  return repro::launch<int32_t>(kf, ko, width, tile, n_data_tiles, stream);
}

}  // extern "C"
