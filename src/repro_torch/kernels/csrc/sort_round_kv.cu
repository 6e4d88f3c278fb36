// One flat key-value merge-sort round (K4) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge_path.py::_sort_round_kv_kernel, launched
// by sort_round_kv_pallas, together with the tile body it runs
// (_hier_merge_window) and the start table of _sort_round_starts.  The
// kernel itself, sort_round_kernel<K, true>, and the tile body live in
// merge_tile.cuh, which no other kernel runs.
//
// Layout, as in the reference: one flat buffer of m + T elements.  The m
// data elements hold sorted runs of `width`; the last T are sentinel keys
// (iinfo.max) with zero values.  The round merges run pairs (A, B) =
// (run 2p, run 2p + 1) into runs of 2 * width and writes the same layout.
// The merge is stable with A-priority: among equal keys, A's come first.
//
// What bounds it: memory.  A round must read the m data keys and values once
// and write all m + T once (the tail is written from constants):
// (2 * m + T) * (sizeof(K) + 4) bytes, about 0.4 MB at m = 32768 with int16
// keys, which takes about 0.118 us at 3.35 TB/s.  So at the
// serving sampler's size one launch is bound by launch latency and by the
// latency of the dependent loads of its searches, not by bandwidth.
//
// What the design does about that: one launch per round, one block per
// T-output tile, each block finding its own start by a warp-cooperative
// Algorithm 2 bisection (a width of 16384 takes 3 dependent steps instead of
// 15), valid prefixes staged in shared memory with coalesced loads, coalesced
// writes, and an extra last block that writes the T sentinel keys and zero
// values.  TMA staging and a persistent grid are left for later work.

#include "merge_tile.cuh"

extern "C" {

int sort_round_kv_i16(const void* kf, const void* vf, void* ko, void* vo, int width, int tile,
                      int leaf, int n_data_tiles, void* stream) {
  return repro::launch_sort_round<int16_t, true>(kf, vf, ko, vo, width, tile, leaf, n_data_tiles, stream);
}

int sort_round_kv_i32(const void* kf, const void* vf, void* ko, void* vo, int width, int tile,
                      int leaf, int n_data_tiles, void* stream) {
  return repro::launch_sort_round<int32_t, true>(kf, vf, ko, vo, width, tile, leaf, n_data_tiles, stream);
}

}  // extern "C"
