// The Merge Path tile body shared by the hand-written Hopper kernels (sm_90a).
//
// Replaces: src/repro/kernels/merge_path.py::_hier_merge_window (the level-2
// split, _leaf_ranks / _leaf_ranks_masked and the gather apply of
// _tile_merge), which every Pallas merge kernel runs, together with the
// per-tile start tables that _prepare and _sort_round_starts compute in a
// separate pass.
//
// K4 (sort_round_kv.cu) is the one kernel that still runs the tile body; the
// others include this header for key_le, key_max, co_rank_warp and
// allow_smem.  The tile body writes one tile of T outputs per block:
//  * the block finds its own start (a0, b0) on the merge path by a
//    warp-cooperative Algorithm 2 bisection in global memory
//    (block_co_rank), so there is no start-table pass and no host round trip;
//  * it stages the valid prefixes of its two T-windows in shared memory,
//    valid_a = min(na - a0, T) and valid_b likewise.  Pads and neighbouring
//    runs are excluded by index, never by comparing against a sentinel, so
//    real keys equal to the sentinel keep their values;
//  * it splits the tile into leaves of S outputs by Algorithm 2 over the
//    shared windows, and each thread finds its output slot by a co-rank
//    search of at most log2(S) steps inside its leaf, then gathers.
// The merge is stable with A-priority: among keys that compare equal under
// the raw `<=` (so -0.0 == +0.0), A's come first.  The output of such a merge
// is unique, so the result does not depend on (T, S).
//
// Keys are compared with the raw `<=` of their type, as the reference's
// `la > lb` does: no total-order transform.  bfloat16 keys travel as their
// bits and compare through float, which is exact.  Values are 32-bit words
// and are only moved (int32 and float32 alike).

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

// Co-rank (Algorithm 2): the number of A elements among the first d outputs
// of the stable A-priority merge of a[0:na] and b[0:nb], 0 <= d <= na + nb.
// Every probe lies inside both arrays, so no clipping is needed.
template <typename K>
__device__ __forceinline__ int co_rank(const K* a, int na, const K* b, int nb, int d) {
  int lo = max(0, d - nb);
  int hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_le(a[mid], b[d - 1 - mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same co-rank over global memory, searched by a whole warp with 64-bit
// offsets.  The predicate a[i] <= b[d - 1 - i] holds for i below the answer
// and fails from it on, so 32 evenly spaced probes and a ballot narrow
// [lo, hi] to one step's width: a span of 2^24 takes 5 dependent steps
// instead of 24.  Must be called by all 32 lanes of a warp with the same
// arguments.
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

// This block's start on the merge path of a[0:na] and b[0:nb] at diagonal d
// (level 1).  Warp 0 searches; every thread of the block gets the answer.
template <typename K>
__device__ int64_t block_co_rank(const K* __restrict__ a, int64_t na, const K* __restrict__ b,
                                 int64_t nb, int64_t d) {
  __shared__ int64_t start_a;
  if (threadIdx.x < 32) {
    const int64_t a0 = co_rank_warp(a, na, b, nb, d);
    if (threadIdx.x == 0) start_a = a0;
  }
  __syncthreads();
  return start_a;
}

// Dynamic shared memory of merge_tile: [values of A | values of B] when
// values ride along, the leaf starts, then [keys of A | keys of B].
template <typename K, bool kValues>
inline size_t merge_tile_smem(int tile, int leaf) {
  const size_t nleaf = (tile + leaf - 1) / leaf;
  return static_cast<size_t>(tile) * 2 * (sizeof(K) + (kValues ? sizeof(uint32_t) : 0)) +
         nleaf * sizeof(int32_t);
}

// One tile: merge the valid window prefixes a[0:va] and b[0:vb]
// (va, vb <= tile) into out[0:n_out], n_out <= min(tile, va + vb).  Called
// by every thread of the block; smem holds merge_tile_smem<K, kValues>.
template <typename K, bool kValues>
__device__ void merge_tile(const K* __restrict__ ak, const uint32_t* __restrict__ av, int va,
                           const K* __restrict__ bk, const uint32_t* __restrict__ bv, int vb,
                           K* __restrict__ ok, uint32_t* __restrict__ ov, int n_out, int tile,
                           int leaf, unsigned char* smem) {
  const int nleaf = (tile + leaf - 1) / leaf;
  uint32_t* wa_v = reinterpret_cast<uint32_t*>(smem);
  uint32_t* wb_v = wa_v + (kValues ? tile : 0);
  int32_t* leaf_a = reinterpret_cast<int32_t*>(wb_v + (kValues ? tile : 0));
  K* wa_k = reinterpret_cast<K*>(leaf_a + nleaf);
  K* wb_k = wa_k + tile;

  for (int i = threadIdx.x; i < va; i += blockDim.x) {
    wa_k[i] = ak[i];
    if (kValues) wa_v[i] = av[i];
  }
  for (int i = threadIdx.x; i < vb; i += blockDim.x) {
    wb_k[i] = bk[i];
    if (kValues) wb_v[i] = bv[i];
  }
  __syncthreads();

  // Level 2: split the tile's outputs into leaves of S.  A diagonal is
  // clamped to va + vb, which is below T only in a merge's last tile.
  const int total = va + vb;
  for (int l = threadIdx.x; l < nleaf; l += blockDim.x) {
    leaf_a[l] = co_rank(wa_k, va, wb_k, vb, min(l * leaf, total));
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    const int l = j / leaf;
    const int jj = j - l * leaf;
    const int sa = leaf_a[l];
    const int sb = l * leaf - sa;
    const int ai = sa + co_rank(wa_k + sa, min(va - sa, leaf), wb_k + sb, min(vb - sb, leaf), jj);
    const int bi = j - ai;
    const bool take_a = ai < va && (bi >= vb || key_le(wa_k[ai], wb_k[bi]));
    ok[j] = take_a ? wa_k[ai] : wb_k[bi];
    if (kValues) ov[j] = take_a ? wa_v[ai] : wb_v[bi];
  }
}

// One flat bottom-up merge-sort round (the reference's _sort_round_kernel and
// _sort_round_kv_kernel).  The buffer holds m + T elements: the m data
// elements in sorted runs of `width`, then T sentinel keys (zero values).
// Block t < n_data_tiles merges output tile t of its pair of runs
// (A, B) = (run 2p, run 2p + 1); the extra last block rewrites the tail.
template <typename K, bool kValues>
__global__ void sort_round_kernel(const K* __restrict__ kf, const uint32_t* __restrict__ vf,
                                  K* __restrict__ ko, uint32_t* __restrict__ vo, int width,
                                  int tile, int leaf, int n_data_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t out0 = static_cast<int64_t>(blockIdx.x) * tile;

  if (static_cast<int>(blockIdx.x) >= n_data_tiles) {  // the sentinel/zero tail
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      ko[out0 + j] = key_max<K>();
      if (kValues) vo[out0 + j] = 0;
    }
    return;
  }

  const int tiles_per_pair = (2 * width) / tile;
  const int pair = blockIdx.x / tiles_per_pair;
  const int d = (blockIdx.x - pair * tiles_per_pair) * tile;  // diagonal inside the pair
  const int64_t base = static_cast<int64_t>(pair) * 2 * width;

  const int a0 = static_cast<int>(block_co_rank(kf + base, width, kf + base + width, width, d));
  const int b0 = d - a0;
  const int64_t fa = base + a0;
  const int64_t fb = base + width + b0;
  // va + vb >= T holds for every data tile, so the tile is full.
  merge_tile<K, kValues>(kf + fa, kValues ? vf + fa : nullptr, min(width - a0, tile),
                         kf + fb, kValues ? vf + fb : nullptr, min(width - b0, tile),
                         ko + out0, kValues ? vo + out0 : nullptr, tile, tile, leaf, smem);
}

// Threads per block: one per output slot up to 512, at least one warp.
inline int block_threads(int tile) { return tile >= 512 ? 512 : (tile >= 32 ? (tile + 31) / 32 * 32 : 32); }

// Opt in to more than 48 KB of dynamic shared memory where a tile needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename K, bool kValues>
int launch_sort_round(const void* kf, const void* vf, void* ko, void* vo, int width, int tile,
                      int leaf, int n_data_tiles, void* stream) {
  const size_t smem = merge_tile_smem<K, kValues>(tile, leaf);
  const cudaError_t err = allow_smem(sort_round_kernel<K, kValues>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_round_kernel<K, kValues><<<n_data_tiles + 1, block_threads(tile), smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(kf), static_cast<const uint32_t*>(vf), static_cast<K*>(ko),
      static_cast<uint32_t*>(vo), width, tile, leaf, n_data_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
