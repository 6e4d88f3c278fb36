// Stable merges of two sorted 1-D arrays (K1 keys only, K2 key-value) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge_path.py::_merge_kernel (launched by
// merge_pallas) and ::_merge_kv_kernel (launched by merge_kv_pallas), with
// the start tables of _prepare and the host-side sentinel padding of both
// inputs.
//
// The grid has cdiv(na + nb, T) blocks.  Block t bisects diagonal t * T over
// (a, na, b, nb) in global memory (block_co_rank), takes the valid prefixes
// va = min(na - a0, T) and vb = min(nb - b0, T) of its two windows, and runs
// the tile body of merge_tile.cuh.  The last block writes n - t * T outputs:
// the output has exactly n elements and the inputs are not padded or copied
// on the host.  Keys are compared with the raw `<=` of their type (int16,
// int32, float32, bfloat16), so -0.0 and +0.0 tie and A's comes first, as in
// the reference.  K2's values are 32-bit words (int32 or float32) and are only
// moved.  Element offsets are 64-bit.
//
// What bounds it: memory.  K1 reads n keys and writes n: 2 * n * sizeof(K)
// bytes, 0.080 ms for 2 x 2^24 float32 keys at 3.35 TB/s.  K2 moves the values
// too: 2 * n * (sizeof(K) + 4) bytes, 0.160 ms for int32 keys and values.
//
// What the design does about that: every input element is read from device
// memory once, by coalesced loads into shared memory, and every output written
// once by coalesced stores; the searches inside a tile run in shared memory.
// The start search reads 32 probes per step in at most 5 dependent steps at
// 2^24.  TMA staging and a persistent grid are left for later work.

#include "merge_tile.cuh"

namespace {

template <typename K, bool kValues>
__global__ void merge_kernel(const K* __restrict__ a, const uint32_t* __restrict__ av, int64_t na,
                             const K* __restrict__ b, const uint32_t* __restrict__ bv, int64_t nb,
                             K* __restrict__ ok, uint32_t* __restrict__ ov, int tile, int leaf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t d = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t a0 = repro::block_co_rank(a, na, b, nb, d);
  const int64_t b0 = d - a0;
  const int64_t t = tile;
  const int va = static_cast<int>(na - a0 < t ? na - a0 : t);
  const int vb = static_cast<int>(nb - b0 < t ? nb - b0 : t);
  const int n_out = static_cast<int>(na + nb - d < t ? na + nb - d : t);
  repro::merge_tile<K, kValues>(a + a0, kValues ? av + a0 : nullptr, va, b + b0,
                                kValues ? bv + b0 : nullptr, vb, ok + d, kValues ? ov + d : nullptr,
                                n_out, tile, leaf, smem);
}

template <typename K, bool kValues>
int launch(const void* a, const void* av, int64_t na, const void* b, const void* bv, int64_t nb,
           void* ok, void* ov, int tile, int leaf, void* stream) {
  const int64_t n = na + nb;
  if (n == 0) return 0;
  const size_t smem = repro::merge_tile_smem<K, kValues>(tile, leaf);
  const cudaError_t err = repro::allow_smem(merge_kernel<K, kValues>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((n + tile - 1) / tile);
  merge_kernel<K, kValues><<<grid, repro::block_threads(tile), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(a), static_cast<const uint32_t*>(av), na, static_cast<const K*>(b),
      static_cast<const uint32_t*>(bv), nb, static_cast<K*>(ok), static_cast<uint32_t*>(ov), tile,
      leaf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_MERGE_SYMBOLS(SUFFIX, K)                                                            \
  int merge_##SUFFIX(const void* a, int64_t na, const void* b, int64_t nb, void* out, int tile,  \
                     int leaf, void* stream) {                                                    \
    return launch<K, false>(a, nullptr, na, b, nullptr, nb, out, nullptr, tile, leaf, stream);    \
  }                                                                                               \
  int merge_kv_##SUFFIX(const void* ak, const void* av, int64_t na, const void* bk,               \
                        const void* bv, int64_t nb, void* ok, void* ov, int tile, int leaf,       \
                        void* stream) {                                                           \
    return launch<K, true>(ak, av, na, bk, bv, nb, ok, ov, tile, leaf, stream);                   \
  }

extern "C" {
REPRO_MERGE_SYMBOLS(i16, int16_t)
REPRO_MERGE_SYMBOLS(i32, int32_t)
REPRO_MERGE_SYMBOLS(f32, float)
REPRO_MERGE_SYMBOLS(bf16, repro::bf16)
}  // extern "C"
