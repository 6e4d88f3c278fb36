// Stable merges for Hopper (sm_90a): two sorted 1-D arrays (K1 keys only, K2
// key-value) and B independent pairs of sorted rows (K5-K8).
//
// Replaces: src/repro/kernels/merge_path.py::_merge_kernel (launched by
// merge_pallas) and ::_merge_kv_kernel (launched by merge_kv_pallas), with
// the start tables of _prepare and the host-side sentinel padding of both
// inputs; and ::_merge_batched_kernel (merge_batched_pallas, K5),
// ::_merge_kv_batched_kernel (merge_kv_batched_pallas, K6),
// ::_merge_batched_ragged_kernel (merge_batched_ragged_pallas, K7) and
// ::_merge_kv_batched_ragged_kernel (merge_kv_batched_ragged_pallas, K8),
// with the start tables of _prepare_batched{,_ragged}, the host-side masking
// of the ragged tails (_mask_rows) and the host-side padding of every row.
//
// K1/K2: the grid has cdiv(na + nb, T) blocks.  Block t bisects diagonal t * T
// over (a, na, b, nb) in global memory (block_co_rank), takes the valid
// prefixes va = min(na - a0, T) and vb = min(nb - b0, T) of its two windows,
// and runs the tile body of merge_tile.cuh.  The last block writes n - t * T
// outputs: the output has exactly n elements and the inputs are not padded or
// copied on the host.
//
// K5-K8 (merge_rows_kernel<K, kValues, kRagged>): the same body over rows.
// The grid has B * cdiv(na + nb, T) blocks, (row, tile) linearised over
// blockIdx.x, since gridDim.y stops at 65535.  Rows are read at strides
// a_stride and b_stride (elements; values share their keys' stride) and
// written at out_stride, so the k-way tournament reads the even and odd rows
// of the previous round in place.  Row r merges la = na and lb = nb elements
// (K5, K6), or, ragged (K7, K8), la = clamp(a_lens[r], 0, na) and lb
// likewise.  Tile t covers diagonals d = t * T .. d + n_out with n_out =
// min(na + nb - d, T), so the last tile of a row is short and never touches
// the next row.  A tile past the row's total (d >= la + lb) writes n_out
// sentinel keys and zero values and returns: no search, no staging.
// Otherwise the start search is bounded by la and lb, so it never probes a
// tail, whatever the tail holds; the tile body writes min(la + lb - d, T)
// outputs and the block fills the rest of its n_out slots with the sentinel
// (+inf for floats, the largest int) and zero values.  Pads are excluded by
// index, never by comparison, so real keys equal to the sentinel keep their
// values.  K1 and K2 stay a kernel of their own: as the one-row case of this
// one they measured 5-7 % slower (PERF.md).
//
// Keys are compared with the raw `<=` of their type (int16, int32, float32,
// bfloat16), so -0.0 and +0.0 tie and A's comes first, as in the reference.
// Values are 32-bit words (int32 or float32) and are only moved.  Element
// offsets are 64-bit.
//
// What bounds it: memory.  K1 reads n keys and writes n: 2 * n * sizeof(K)
// bytes, 0.080 ms for 2 x 2^24 float32 keys at 3.35 TB/s.  K2 moves the values
// too: 2 * n * (sizeof(K) + 4) bytes, 0.160 ms for int32 keys and values.  K5
// and K6 move the same bytes for B rows of n; K7 and K8 read only the valid
// prefixes and write every slot: (sum_r (la + lb) + B * n) * sizeof(K) bytes
// (K8: sizeof(K) + 4).
//
// What the design does about that: every input element is read from device
// memory once, by coalesced loads into shared memory, and every output written
// once by coalesced stores; the searches inside a tile run in shared memory.
// The start search reads 32 probes per step in at most 5 dependent steps at
// 2^24.  TMA staging, a separate start pass and a persistent grid are left
// for later work.

#include "merge_tile.cuh"

namespace {

// K1/K2: one tile per block; see the note at the top.
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

// K5-K8: one (row, tile) per block; see the note at the top.
template <typename K, bool kValues, bool kRagged>
__global__ void merge_rows_kernel(const K* __restrict__ a, const uint32_t* __restrict__ av,
                                  int64_t na, int64_t a_stride, const int32_t* __restrict__ a_lens,
                                  const K* __restrict__ b, const uint32_t* __restrict__ bv,
                                  int64_t nb, int64_t b_stride, const int32_t* __restrict__ b_lens,
                                  K* __restrict__ ok, uint32_t* __restrict__ ov, int64_t out_stride,
                                  unsigned tiles_per_row, int tile, int leaf) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The launch keeps the grid below 2^31 blocks: 32-bit block arithmetic is exact.
  const unsigned row = blockIdx.x / tiles_per_row;
  const int64_t t = tile;
  const int64_t d = static_cast<int64_t>(blockIdx.x - row * tiles_per_row) * t;
  const int n_out = static_cast<int>(na + nb - d < t ? na + nb - d : t);
  int64_t la = na;
  int64_t lb = nb;
  if (kRagged) {
    const int64_t ra = a_lens[row];
    const int64_t rb = b_lens[row];
    la = ra < 0 ? 0 : (ra < na ? ra : na);
    lb = rb < 0 ? 0 : (rb < nb ? rb : nb);
  }
  const int64_t tot = la + lb;
  K* orow = ok + row * out_stride + d;
  uint32_t* ovrow = kValues ? ov + row * out_stride + d : nullptr;
  int n_valid = 0;
  if (d < tot) {  // the same for every thread of the block
    const K* ar = a + row * a_stride;
    const K* br = b + row * b_stride;
    const int64_t a0 = repro::block_co_rank(ar, la, br, lb, d);
    const int64_t b0 = d - a0;
    const int va = static_cast<int>(la - a0 < t ? la - a0 : t);
    const int vb = static_cast<int>(lb - b0 < t ? lb - b0 : t);
    n_valid = static_cast<int>(tot - d < t ? tot - d : t);
    repro::merge_tile<K, kValues>(ar + a0, kValues ? av + row * a_stride + a0 : nullptr, va,
                                  br + b0, kValues ? bv + row * b_stride + b0 : nullptr, vb, orow,
                                  ovrow, n_valid, tile, leaf, smem);
  }
  for (int j = n_valid + threadIdx.x; j < n_out; j += blockDim.x) {  // past the row's total
    orow[j] = repro::key_max<K>();
    if (kValues) ovrow[j] = 0;
  }
}

template <typename K, bool kValues, bool kRagged>
int launch_rows(const void* a, const void* av, int64_t na, int64_t a_stride, const void* a_lens,
                const void* b, const void* bv, int64_t nb, int64_t b_stride, const void* b_lens,
                void* ok, void* ov, int64_t out_stride, int64_t rows, int tile, int leaf,
                void* stream) {
  const int64_t n = na + nb;
  if (n == 0 || rows == 0) return 0;
  const int64_t tiles_per_row = (n + tile - 1) / tile;
  if (rows * tiles_per_row > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = repro::merge_tile_smem<K, kValues>(tile, leaf);
  const cudaError_t err = repro::allow_smem(merge_rows_kernel<K, kValues, kRagged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_rows_kernel<K, kValues, kRagged>
      <<<static_cast<unsigned>(rows * tiles_per_row), repro::block_threads(tile), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const K*>(a), static_cast<const uint32_t*>(av), na, a_stride,
          static_cast<const int32_t*>(a_lens), static_cast<const K*>(b),
          static_cast<const uint32_t*>(bv), nb, b_stride, static_cast<const int32_t*>(b_lens),
          static_cast<K*>(ok), static_cast<uint32_t*>(ov), out_stride,
          static_cast<unsigned>(tiles_per_row), tile, leaf);
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
  }                                                                                               \
  int merge_batched_##SUFFIX(const void* a, int64_t na, int64_t a_stride, const void* b,         \
                             int64_t nb, int64_t b_stride, void* out, int64_t out_stride,        \
                             int64_t rows, int tile, int leaf, void* stream) {                   \
    return launch_rows<K, false, false>(a, nullptr, na, a_stride, nullptr, b, nullptr, nb,       \
                                        b_stride, nullptr, out, nullptr, out_stride, rows, tile, \
                                        leaf, stream);                                           \
  }                                                                                               \
  int merge_kv_batched_##SUFFIX(const void* ak, const void* av, int64_t na, int64_t a_stride,    \
                                const void* bk, const void* bv, int64_t nb, int64_t b_stride,    \
                                void* ok, void* ov, int64_t out_stride, int64_t rows, int tile,  \
                                int leaf, void* stream) {                                        \
    return launch_rows<K, true, false>(ak, av, na, a_stride, nullptr, bk, bv, nb, b_stride,      \
                                       nullptr, ok, ov, out_stride, rows, tile, leaf, stream);   \
  }                                                                                               \
  int merge_batched_ragged_##SUFFIX(const void* a, int64_t na, int64_t a_stride,                 \
                                    const void* a_lens, const void* b, int64_t nb,               \
                                    int64_t b_stride, const void* b_lens, void* out,             \
                                    int64_t out_stride, int64_t rows, int tile, int leaf,        \
                                    void* stream) {                                              \
    return launch_rows<K, false, true>(a, nullptr, na, a_stride, a_lens, b, nullptr, nb,         \
                                       b_stride, b_lens, out, nullptr, out_stride, rows, tile,   \
                                       leaf, stream);                                            \
  }                                                                                               \
  int merge_kv_batched_ragged_##SUFFIX(const void* ak, const void* av, int64_t na,               \
                                       int64_t a_stride, const void* a_lens, const void* bk,     \
                                       const void* bv, int64_t nb, int64_t b_stride,             \
                                       const void* b_lens, void* ok, void* ov,                   \
                                       int64_t out_stride, int64_t rows, int tile, int leaf,     \
                                       void* stream) {                                           \
    return launch_rows<K, true, true>(ak, av, na, a_stride, a_lens, bk, bv, nb, b_stride,        \
                                      b_lens, ok, ov, out_stride, rows, tile, leaf, stream);     \
  }

extern "C" {
REPRO_MERGE_SYMBOLS(i16, int16_t)
REPRO_MERGE_SYMBOLS(i32, int32_t)
REPRO_MERGE_SYMBOLS(f32, float)
REPRO_MERGE_SYMBOLS(bf16, repro::bf16)
}  // extern "C"
