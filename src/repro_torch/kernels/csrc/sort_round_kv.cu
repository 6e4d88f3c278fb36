// One flat key-value merge-sort round (K4) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge_path.py::_sort_round_kv_kernel, launched
// by sort_round_kv_pallas, together with the tile body it runs
// (_hier_merge_window: level-2 split, leaf ranks, gather apply) and the
// start table of _sort_round_starts.
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
// What the design does about that:
//  * one block per T-output tile; every block finds its own start (a0, b0)
//    by the Algorithm 2 diagonal bisection over its pair of runs (the
//    paper's "each core computes its start point").  No separate start-table
//    pass and no host round trip: one launch per round.
//  * that global-memory bisection is warp-cooperative: 32 probes per step
//    cut the interval 32-fold, so a width of 16384 takes 3 dependent steps
//    instead of 15.
//  * the block stages only the valid prefixes of its two T-windows (keys and
//    values) in shared memory, with coalesced loads.  valid_a =
//    min(width - a0, T) and valid_b likewise: the neighbouring run and the
//    pads are excluded by index, never by comparing against the sentinel,
//    so real keys equal to iinfo.max keep their values.
//  * inside the tile, the level-2 split cuts the T outputs into leaves of S
//    (S = 32: one warp) by Algorithm 2 over the shared windows; each thread
//    then finds its output slot by a co-rank search of at most log2(S) steps
//    inside its leaf and gathers key and value.  The writes are coalesced.
//  * the extra last block writes the T sentinel keys and zero values.
// The output of a stable merge is unique, so the result is bit-identical to
// the plain version for any (T, S).  TMA staging and a persistent grid are
// left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename K>
struct KeyMax;
template <>
struct KeyMax<int16_t> {
  static constexpr int16_t value = INT16_MAX;
};
template <>
struct KeyMax<int32_t> {
  static constexpr int32_t value = INT32_MAX;
};

// Co-rank (Algorithm 2): the number of A elements among the first d outputs
// of the stable A-priority merge of a[0:na] and b[0:nb], 0 <= d <= na + nb.
// Every probe lies inside both arrays, so no clipping is needed.
template <typename K>
__device__ __forceinline__ int co_rank(const K* a, int na, const K* b, int nb, int d) {
  int lo = max(0, d - nb);
  int hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same co-rank, searched by a whole warp.  The predicate
// a[i] <= b[d - 1 - i] holds for i below the answer and fails from it on, so
// 32 evenly spaced probes and a ballot narrow [lo, hi] to one step's width.
// Must be called by all 32 lanes of a warp with the same arguments.
template <typename K>
__device__ int co_rank_warp(const K* __restrict__ a, int na, const K* __restrict__ b, int nb, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - nb);
  int hi = min(d, na);
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const bool pred = i < hi && a[i] <= b[d - 1 - i];
    const int c = __popc(__ballot_sync(0xffffffffu, pred));  // probes 0..c-1 hold
    const int new_lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = min(hi, lo + c * step);  // probe c failed, or lies past hi
    lo = new_lo;
  }
  return lo;
}

template <typename K>
__global__ void sort_round_kv_kernel(const K* __restrict__ kf, const int32_t* __restrict__ vf,
                                     K* __restrict__ ko, int32_t* __restrict__ vo, int width,
                                     int tile, int leaf, int n_data_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int start_a;
  const int64_t out0 = static_cast<int64_t>(blockIdx.x) * tile;

  if (static_cast<int>(blockIdx.x) >= n_data_tiles) {  // the sentinel/zero tail
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      ko[out0 + j] = KeyMax<K>::value;
      vo[out0 + j] = 0;
    }
    return;
  }

  const int tiles_per_pair = (2 * width) / tile;
  const int pair = blockIdx.x / tiles_per_pair;
  const int d = (blockIdx.x - pair * tiles_per_pair) * tile;  // diagonal inside the pair
  const int64_t base = static_cast<int64_t>(pair) * 2 * width;

  // Level 1: this tile's start on the pair's merge path.
  if (threadIdx.x < 32) {
    const int a0 = co_rank_warp(kf + base, width, kf + base + width, width, d);
    if (threadIdx.x == 0) start_a = a0;
  }
  __syncthreads();
  const int a0 = start_a;
  const int b0 = d - a0;
  const int va = min(width - a0, tile);
  const int vb = min(width - b0, tile);

  const int nleaf = (tile + leaf - 1) / leaf;
  int32_t* wa_v = reinterpret_cast<int32_t*>(smem);
  int32_t* wb_v = wa_v + tile;
  int32_t* leaf_a = wb_v + tile;
  K* wa_k = reinterpret_cast<K*>(leaf_a + nleaf);
  K* wb_k = wa_k + tile;

  const int64_t fa = base + a0;
  const int64_t fb = base + width + b0;
  for (int i = threadIdx.x; i < va; i += blockDim.x) {
    wa_k[i] = kf[fa + i];
    wa_v[i] = vf[fa + i];
  }
  for (int i = threadIdx.x; i < vb; i += blockDim.x) {
    wb_k[i] = kf[fb + i];
    wb_v[i] = vf[fb + i];
  }
  __syncthreads();

  // Level 2: split the tile's T outputs into leaves of S.  va + vb >= T
  // holds for every data tile, so each diagonal l * S lies on the path.
  for (int l = threadIdx.x; l < nleaf; l += blockDim.x) {
    leaf_a[l] = co_rank(wa_k, va, wb_k, vb, l * leaf);
  }
  __syncthreads();

  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const int l = j / leaf;
    const int jj = j - l * leaf;
    const int sa = leaf_a[l];
    const int sb = l * leaf - sa;
    const int ai = sa + co_rank(wa_k + sa, min(va - sa, leaf), wb_k + sb, min(vb - sb, leaf), jj);
    const int bi = j - ai;
    const bool take_a = ai < va && (bi >= vb || wa_k[ai] <= wb_k[bi]);
    ko[out0 + j] = take_a ? wa_k[ai] : wb_k[bi];
    vo[out0 + j] = take_a ? wa_v[ai] : wb_v[bi];
  }
}

template <typename K>
int launch(const void* kf, const void* vf, void* ko, void* vo, int width, int tile, int leaf,
           int n_data_tiles, void* stream) {
  const int nleaf = (tile + leaf - 1) / leaf;
  const size_t smem =
      static_cast<size_t>(tile) * (2 * sizeof(int32_t) + 2 * sizeof(K)) + nleaf * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_round_kv_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = tile >= 512 ? 512 : (tile >= 32 ? tile : 32);
  sort_round_kv_kernel<K><<<n_data_tiles + 1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(kf), static_cast<const int32_t*>(vf), static_cast<K*>(ko),
      static_cast<int32_t*>(vo), width, tile, leaf, n_data_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sort_round_kv_i16(const void* kf, const void* vf, void* ko, void* vo, int width, int tile,
                      int leaf, int n_data_tiles, void* stream) {
  return launch<int16_t>(kf, vf, ko, vo, width, tile, leaf, n_data_tiles, stream);
}

int sort_round_kv_i32(const void* kf, const void* vf, void* ko, void* vo, int width, int tile,
                      int leaf, int n_data_tiles, void* stream) {
  return launch<int32_t>(kf, vf, ko, vo, width, tile, leaf, n_data_tiles, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
