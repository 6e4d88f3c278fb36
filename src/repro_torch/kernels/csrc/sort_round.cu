// One flat keys-only merge-sort round (K3) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge_path.py::_sort_round_kernel, launched by
// sort_round_pallas, with the start table of _sort_round_starts.  It is K4's
// round without values: the same flat layout of m + T elements (sorted runs
// of `width`, then T iinfo.max sentinels), the same kernel
// (sort_round_kernel<K, false> in merge_tile.cuh) and the same tail block.
// Integer keys only (int16, int32), as the reference's ops.sort gives it.
//
// What bounds it: memory.  A round reads the m data keys once and writes all
// m + T once: (2 * m + T) * sizeof(K) bytes.  At m = 2^24 int32 keys that is
// 134 MB, 0.040 ms at 3.35 TB/s, far past the 50 MB L2.
//
// What the design does about that: each key is read from device memory once
// into shared memory by coalesced loads (the valid prefix of the block's two
// windows only) and written once by coalesced stores; every search after the
// block's start runs in shared memory.  The start itself costs one
// warp-cooperative bisection of at most 5 dependent steps at width 2^23.
// TMA staging and one launch for all rounds are left for later work.

#include "merge_tile.cuh"

extern "C" {

int sort_round_i16(const void* kf, void* ko, int width, int tile, int leaf, int n_data_tiles,
                   void* stream) {
  return repro::launch_sort_round<int16_t, false>(kf, nullptr, ko, nullptr, width, tile, leaf, n_data_tiles, stream);
}

int sort_round_i32(const void* kf, void* ko, int width, int tile, int leaf, int n_data_tiles,
                   void* stream) {
  return repro::launch_sort_round<int32_t, false>(kf, nullptr, ko, nullptr, width, tile, leaf, n_data_tiles, stream);
}

}  // extern "C"
