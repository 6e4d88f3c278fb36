// Stable merges for Hopper (sm_90a): two sorted 1-D arrays (K1 keys only, K2
// key-value) and B independent pairs of sorted rows (K5-K8).
//
// Replaces: src/repro/kernels/merge_path.py::_merge_kernel (launched by
// merge_pallas) and ::_merge_kv_kernel (launched by merge_kv_pallas), with
// the start tables of _prepare and the host-side sentinel padding of both
// inputs (K1 and K2 on the per-thread segment merge of segment_merge.cuh);
// ::_merge_batched_kernel (merge_batched_pallas, K5) and
// ::_merge_batched_ragged_kernel (merge_batched_ragged_pallas, K7), with the
// start tables of _prepare_batched{,_ragged}, the host-side masking of the
// ragged tails (_mask_rows) and the host-side padding of every row; and
// ::_merge_kv_batched_kernel (merge_kv_batched_pallas, K6) and
// ::_merge_kv_batched_ragged_kernel (merge_kv_batched_ragged_pallas, K8),
// likewise (K5-K8 on the same segment merge, per row).
//
// K1/K2 (merge_span_kernel): what bounds them is memory.  K1 reads n = na +
// nb keys and writes n: 2 * n * sizeof(K) bytes, 0.080 ms for 2 x 2^24
// float32 keys at 3.35 TB/s.  K2 moves the values too: 2 * n * (sizeof(K) +
// 4) bytes, 0.160 ms for int32 keys and values.  What the design does about
// that (the paper's Segmented Parallel Merge, as K3's wide rounds run it):
//  * a block writes kSpan = kThreads * kE consecutive outputs (8192 for K1,
//    4096 for K2), o0 .. o1 = min(o0 + kSpan, n): the grid has cdiv(n,
//    kSpan) blocks and the output has exactly n elements, with no padding
//    and no host copy;
//  * warp 0 bisects diagonal o0 and warp 1 diagonal o1 over (a, na, b, nb)
//    in device memory, in parallel (co_rank_warp, at most 5 dependent steps
//    at 2^24).  Neighbouring blocks evaluate their shared diagonal with the
//    same function over the same arrays, so the windows tile both inputs
//    exactly and the merge stays stable across the seam;
//  * the block reads exactly its two windows, a[a_lo : a_hi] and
//    b[o0 - a_lo : o1 - a_hi], o1 - o0 keys in all (and their values), by
//    16-byte loads of each window's aligned cover into padded shared
//    memory; the extra elements are dropped by index, so the inputs may
//    start at any element;
//  * each thread finds its diagonal by one co-rank in shared memory and
//    merges its kE outputs sequentially, one comparison and one shared
//    read each (segment_merge.cuh), into registers;
//  * the outputs go back through shared memory and out by 16-byte stores
//    (o0 is a multiple of kSpan and the output is the wrapper's own).
// `tile` and `leaf` are the reference's and do not change a bit of the
// stable merge's one output, so the kernel ignores them.
//
// K5-K8 (merge_rows_span_kernel<K, kValues, kRagged>): K1's block over rows,
// the paper's Segmented Parallel Merge applied per row; K6 and K8 carry the
// values as K2 does.  The grid has B * cdiv(na + nb, span) blocks (span =
// kRowsSpan for K5/K7, kRowsKvSpan for K6/K8), (row, span) linearised over
// blockIdx.x, since gridDim.y stops at 65535.  Row r merges la = na and lb =
// nb keys (K5, K6), or, ragged (K7, K8), la = clamp(a_lens[r], 0, na) and lb
// likewise.  A block covers outputs o0 .. o0 + n_out of its row, n_out =
// min(na + nb - o0, span), and merges the first n_valid = clamp(la + lb -
// o0, 0, n_out) of them as K1 does, over (a + r * a_stride, la, b + r *
// b_stride, lb) and the values at the same offsets (values share their keys'
// row stride): the two searches by warps 0 and 1, exactly its two windows
// staged (never past la or lb, so a tail is never read, whatever it holds),
// one co-rank and span / threads outputs a thread.  The slots after n_valid
// are sentinel keys (+inf for floats, the largest int) and zero values; a
// block with n_valid = 0, most of the blocks of merge_k's combine, only
// stores them.  Rows are read at strides a_stride and b_stride (elements)
// and at any element offset, so the k-way tournament reads the even and odd
// rows of the previous round in place; the output rows start at r *
// out_stride, which need not be a multiple of 16 bytes (and 2-byte keys
// with 4-byte values start at different offsets of their 16 bytes), so one
// pass of 16-byte stores per array covers each block's aligned interior and
// its head and tail go element by element (store_window).  Pads are
// excluded by index, never by comparison, so real keys equal to the
// sentinel are data.  `tile` and `leaf` do not change the output, so these
// kernels ignore them too.
//
// Keys are compared with the raw `<=` of their type (int16, int32, float32,
// bfloat16; bfloat16 through float), so -0.0 and +0.0 tie and A's comes
// first, as in the reference.  Values are 32-bit words (int32 or float32)
// and are only moved.  Element offsets are 64-bit.
//
// What bounds K5-K8: memory.  K5 and K6 move K1's and K2's bytes for B rows
// of n; K7 and K8 read only the valid prefixes and write every slot: (sum_r
// (la + lb) + B * n) * sizeof(K) bytes (K8: sizeof(K) + 4).  Every input
// element is read from device memory once, by coalesced loads into shared
// memory, and every output written once by coalesced stores; the searches
// inside a block run in shared memory.

#include "segment_merge.cuh"

namespace {

// Block shapes, from a sweep of 128, 256 and 512 threads by 8 and 16 outputs
// a thread at 2 x 2^24 on an H100 (PERF.md): K1 is fastest at 512 x 16; K2,
// whose values take 48 registers a thread (57 at 512 threads), at 256 x 16.
constexpr int kE = 16;  // outputs per thread
template <bool kValues>
constexpr int kThreads = kValues ? 256 : 512;
// Outputs per block: kernels/merge_path.py's MERGE_SPAN (K1) and MERGE_KV_SPAN (K2).
template <bool kValues>
constexpr int kSpan = kThreads<kValues> * kE;
// K5-K8: threads per block; K5/K7: outputs per block, kernels/merge_path.py's
// MERGE_ROWS_SPAN.  From a sweep of 256 and 512 threads by 8 and 16 outputs
// a thread on phase 5's row shapes (PERF.md): 256 x 16 is fastest on the
// wide rows and on the k-way merge of full runs; 8 outputs a thread win by
// 4-15 % on the combine, k = 5 and the small rows, which weigh less.
constexpr int kRowsThreads = 256;
constexpr int kRowsSpan = 4096;
// K6/K8: outputs per block, kernels/merge_path.py's MERGE_ROWS_KV_SPAN.
// From a sweep of 128, 256 and 512 threads by 8 and 16 outputs a thread
// (PERF.md): 256 x 8 is fastest on int32 keys and values at (64, 2^18) x 2,
// ragged or not (by 1.5-2 % over 256 x 16), and on rows of 4096 (by 14 %);
// 128 x 16 wins bfloat16 keys by 9 %.
constexpr int kRowsKvSpan = 2048;
template <bool kValues>
constexpr int kRowsSpanOf = kValues ? kRowsKvSpan : kRowsSpan;

// Outputs o0 .. o0 + n (n > 0) of the stable A-priority merge of a[0 : na]
// and b[0 : nb] (and their values) into the padded buffers sk[0 : n] and
// sv[0 : n], by the whole block, each thread merging E of them (K1's block;
// see the note at the top).  Ends at a barrier.
template <typename K, bool kValues, int E>
__device__ __forceinline__ void merge_block(const K* __restrict__ a, const uint32_t* __restrict__ av,
                                            int64_t na, const K* __restrict__ b,
                                            const uint32_t* __restrict__ bv, int64_t nb, int64_t o0,
                                            int n, K* sk, uint32_t* sv, int64_t (&win)[2]) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // the block's first and last diagonal, in parallel
    const int64_t r = repro::co_rank_warp(a, na, b, nb, o0 + warp * n);
    if ((threadIdx.x & 31) == 0) win[warp] = r;
  }
  __syncthreads();
  const int64_t a_lo = win[0];
  // Sorted inputs give 0 <= wa <= n; the clamp keeps unsorted ones (whose
  // merge is unspecified) inside the buffers.
  const int64_t wa64 = win[1] - a_lo;
  const int wa = static_cast<int>(wa64 < 0 ? 0 : (wa64 < n ? wa64 : n));
  repro::stage_window(sk, 0, a, a_lo, wa, na);
  repro::stage_window(sk, wa, b, o0 - a_lo, n - wa, nb);
  if (kValues) {
    repro::stage_window(sv, 0, av, a_lo, wa, na);
    repro::stage_window(sv, wa, bv, o0 - a_lo, n - wa, nb);
  }
  __syncthreads();

  const int j0 = threadIdx.x * E;
  const int e = n - j0 < E ? n - j0 : E;
  K out[E];
  uint32_t vout[E];
  if (e > 0) repro::merge_segment<K, kValues, E>(sk, sv, 0, wa, wa, n - wa, j0, e, out, vout);
  __syncthreads();  // every thread's reads of the windows are done
  if (e > 0) {
    repro::put_segment(sk, j0, e, out);
    if (kValues) repro::put_segment(sv, j0, e, vout);
  }
  __syncthreads();
}

// K1/K2: kSpan outputs per block; see the note at the top.
template <typename K, bool kValues>
__global__ void __launch_bounds__(kThreads<kValues>)
    merge_span_kernel(const K* __restrict__ a, const uint32_t* __restrict__ av, int64_t na,
                      const K* __restrict__ b, const uint32_t* __restrict__ bv, int64_t nb,
                      K* __restrict__ ok, uint32_t* __restrict__ ov) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kSpanK = kSpan<kValues>;
  constexpr int kSlotsK = repro::spad_slots<K>(kSpanK + 1);
  K* const sk = reinterpret_cast<K*>(smem_raw);
  uint32_t* const sv = reinterpret_cast<uint32_t*>(sk + kSlotsK);
  __shared__ int64_t win[2];

  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * kSpanK;
  const int n = static_cast<int>(na + nb - o0 < kSpanK ? na + nb - o0 : kSpanK);
  merge_block<K, kValues, kE>(a, av, na, b, bv, nb, o0, n, sk, sv, win);
  repro::store_span(ok + o0, sk, n);
  if (kValues) repro::store_span(ov + o0, sv, n);
}

// The dynamic shared memory of one block that merges `span` outputs: the
// padded key buffer (and value buffer) of span + 1 slots.
template <typename K, bool kValues>
constexpr size_t span_smem(int span) {
  return repro::spad_slots<K>(span + 1) * sizeof(K) +
         (kValues ? repro::spad_slots<uint32_t>(span + 1) * sizeof(uint32_t) : 0);
}

template <typename K, bool kValues>
int launch(const void* a, const void* av, int64_t na, const void* b, const void* bv, int64_t nb,
           void* ok, void* ov, void* stream) {
  const int64_t n = na + nb;
  if (n == 0) return 0;
  constexpr int kSpanK = kSpan<kValues>;
  constexpr size_t kSmem = span_smem<K, kValues>(kSpanK);
  const cudaError_t err = repro::allow_smem(merge_span_kernel<K, kValues>, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (n + kSpanK - 1) / kSpanK;
  merge_span_kernel<K, kValues><<<static_cast<unsigned>(grid), kThreads<kValues>, kSmem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(a), static_cast<const uint32_t*>(av), na, static_cast<const K*>(b),
      static_cast<const uint32_t*>(bv), nb, static_cast<K*>(ok), static_cast<uint32_t*>(ov));
  return static_cast<int>(cudaGetLastError());
}

// K5-K8: one (row, span) per block; see the note at the top.
template <typename K, bool kValues, bool kRagged>
__global__ void __launch_bounds__(kRowsThreads)
    merge_rows_span_kernel(const K* __restrict__ a, const uint32_t* __restrict__ av, int64_t na,
                           int64_t a_stride, const int32_t* __restrict__ a_lens, const K* __restrict__ b,
                           const uint32_t* __restrict__ bv, int64_t nb, int64_t b_stride,
                           const int32_t* __restrict__ b_lens, K* __restrict__ ok,
                           uint32_t* __restrict__ ov, int64_t out_stride, unsigned spans_per_row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kSpanR = kRowsSpanOf<kValues>;
  constexpr int kER = kSpanR / kRowsThreads;  // outputs per thread
  K* const sk = reinterpret_cast<K*>(smem_raw);
  uint32_t* const sv = reinterpret_cast<uint32_t*>(sk + repro::spad_slots<K>(kSpanR + 1));
  __shared__ int64_t win[2];

  // The launch keeps the grid below 2^31 blocks: 32-bit block arithmetic is exact.
  const unsigned row = blockIdx.x / spans_per_row;
  const int64_t o0 = static_cast<int64_t>(blockIdx.x - row * spans_per_row) * kSpanR;
  const int n_out = static_cast<int>(na + nb - o0 < kSpanR ? na + nb - o0 : kSpanR);
  int64_t la = na;
  int64_t lb = nb;
  if (kRagged) {
    const int64_t ra = a_lens[row];
    const int64_t rb = b_lens[row];
    la = ra < 0 ? 0 : (ra < na ? ra : na);
    lb = rb < 0 ? 0 : (rb < nb ? rb : nb);
  }
  const int64_t left = la + lb - o0;
  const int n_valid = left <= 0 ? 0 : (left < n_out ? static_cast<int>(left) : n_out);
  const int64_t ra0 = static_cast<int64_t>(row) * a_stride;
  const int64_t rb0 = static_cast<int64_t>(row) * b_stride;
  if (n_valid > 0) {  // the same for every thread of the block
    merge_block<K, kValues, kER>(a + ra0, kValues ? av + ra0 : nullptr, la, b + rb0,
                                 kValues ? bv + rb0 : nullptr, lb, o0, n_valid, sk, sv, win);
  }
  const int64_t out0 = static_cast<int64_t>(row) * out_stride + o0;
  repro::store_window(ok + out0, n_out, [&](int i) {
    return !kRagged || i < n_valid ? sk[repro::spad<K>(i)] : repro::key_max<K>();
  });
  if (kValues) {  // their own row alignment: 2-byte keys, 4-byte values
    repro::store_window(ov + out0, n_out, [&](int i) {
      return !kRagged || i < n_valid ? sv[repro::spad<uint32_t>(i)] : 0u;
    });
  }
}

template <typename K, bool kValues, bool kRagged>
int launch_rows_span(const void* a, const void* av, int64_t na, int64_t a_stride, const void* a_lens,
                     const void* b, const void* bv, int64_t nb, int64_t b_stride, const void* b_lens,
                     void* ok, void* ov, int64_t out_stride, int64_t rows, void* stream) {
  const int64_t n = na + nb;
  if (n == 0 || rows == 0) return 0;
  constexpr int kSpanR = kRowsSpanOf<kValues>;
  const int64_t spans_per_row = (n + kSpanR - 1) / kSpanR;
  if (rows * spans_per_row > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr size_t kSmem = span_smem<K, kValues>(kSpanR);
  const cudaError_t err = repro::allow_smem(merge_rows_span_kernel<K, kValues, kRagged>, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_rows_span_kernel<K, kValues, kRagged>
      <<<static_cast<unsigned>(rows * spans_per_row), kRowsThreads, kSmem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const K*>(a), static_cast<const uint32_t*>(av), na, a_stride,
          static_cast<const int32_t*>(a_lens), static_cast<const K*>(b),
          static_cast<const uint32_t*>(bv), nb, b_stride, static_cast<const int32_t*>(b_lens),
          static_cast<K*>(ok), static_cast<uint32_t*>(ov), out_stride,
          static_cast<unsigned>(spans_per_row));
  return static_cast<int>(cudaGetLastError());
}

// What the K1/K2 (K5-K8) launch on keys K requests (repro::smem_query).
template <typename K, bool kValues>
int64_t span_query(int64_t* static_bytes) {
  return repro::smem_query(merge_span_kernel<K, kValues>, span_smem<K, kValues>(kSpan<kValues>), static_bytes);
}

template <typename K, bool kValues, bool kRagged>
int64_t rows_query(int64_t* static_bytes) {
  return repro::smem_query(merge_rows_span_kernel<K, kValues, kRagged>, span_smem<K, kValues>(kRowsSpanOf<kValues>),
                           static_bytes);
}

}  // namespace

// Keys by code, as kernels/merge_path.py numbers them: 0 int16, 1 int32,
// 2 float32, 3 bfloat16.
#define REPRO_BY_KEY(CODE, CALL)  \
  switch (CODE) {                 \
    case 0: {                     \
      using K = int16_t;          \
      return CALL;                \
    }                             \
    case 1: {                     \
      using K = int32_t;          \
      return CALL;                \
    }                             \
    case 2: {                     \
      using K = float;            \
      return CALL;                \
    }                             \
    case 3: {                     \
      using K = repro::bf16;      \
      return CALL;                \
    }                             \
    default:                      \
      return -1;                  \
  }

#define REPRO_MERGE_SYMBOLS(SUFFIX, K)                                                            \
  int merge_##SUFFIX(const void* a, int64_t na, const void* b, int64_t nb, void* out, int tile,  \
                     int leaf, void* stream) {                                                    \
    (void)tile;                                                                                   \
    (void)leaf;                                                                                   \
    return launch<K, false>(a, nullptr, na, b, nullptr, nb, out, nullptr, stream);                \
  }                                                                                               \
  int merge_kv_##SUFFIX(const void* ak, const void* av, int64_t na, const void* bk,               \
                        const void* bv, int64_t nb, void* ok, void* ov, int tile, int leaf,       \
                        void* stream) {                                                           \
    (void)tile;                                                                                   \
    (void)leaf;                                                                                   \
    return launch<K, true>(ak, av, na, bk, bv, nb, ok, ov, stream);                               \
  }                                                                                               \
  int merge_batched_##SUFFIX(const void* a, int64_t na, int64_t a_stride, const void* b,         \
                             int64_t nb, int64_t b_stride, void* out, int64_t out_stride,        \
                             int64_t rows, int tile, int leaf, void* stream) {                   \
    (void)tile;                                                                                   \
    (void)leaf;                                                                                   \
    return launch_rows_span<K, false, false>(a, nullptr, na, a_stride, nullptr, b, nullptr, nb,   \
                                             b_stride, nullptr, out, nullptr, out_stride, rows,   \
                                             stream);                                             \
  }                                                                                               \
  int merge_kv_batched_##SUFFIX(const void* ak, const void* av, int64_t na, int64_t a_stride,    \
                                const void* bk, const void* bv, int64_t nb, int64_t b_stride,    \
                                void* ok, void* ov, int64_t out_stride, int64_t rows, int tile,  \
                                int leaf, void* stream) {                                        \
    (void)tile;                                                                                   \
    (void)leaf;                                                                                   \
    return launch_rows_span<K, true, false>(ak, av, na, a_stride, nullptr, bk, bv, nb, b_stride,  \
                                            nullptr, ok, ov, out_stride, rows, stream);           \
  }                                                                                               \
  int merge_batched_ragged_##SUFFIX(const void* a, int64_t na, int64_t a_stride,                 \
                                    const void* a_lens, const void* b, int64_t nb,               \
                                    int64_t b_stride, const void* b_lens, void* out,             \
                                    int64_t out_stride, int64_t rows, int tile, int leaf,        \
                                    void* stream) {                                              \
    (void)tile;                                                                                   \
    (void)leaf;                                                                                   \
    return launch_rows_span<K, false, true>(a, nullptr, na, a_stride, a_lens, b, nullptr, nb,     \
                                            b_stride, b_lens, out, nullptr, out_stride, rows,     \
                                            stream);                                              \
  }                                                                                               \
  int merge_kv_batched_ragged_##SUFFIX(const void* ak, const void* av, int64_t na,               \
                                       int64_t a_stride, const void* a_lens, const void* bk,     \
                                       const void* bv, int64_t nb, int64_t b_stride,             \
                                       const void* b_lens, void* ok, void* ov,                   \
                                       int64_t out_stride, int64_t rows, int tile, int leaf,     \
                                       void* stream) {                                           \
    (void)tile;                                                                                   \
    (void)leaf;                                                                                   \
    return launch_rows_span<K, true, true>(ak, av, na, a_stride, a_lens, bk, bv, nb, b_stride,    \
                                           b_lens, ok, ov, out_stride, rows, stream);             \
  }

extern "C" {
// The dynamic shared memory each merge kernel's launch requests on keys of
// `key` (the code above), and its static shared memory in *static_bytes
// when not null: kernels/merge_path.py's smem_bytes must give the same.
int64_t merge_smem_bytes(int key, int64_t* static_bytes) { REPRO_BY_KEY(key, (span_query<K, false>(static_bytes))) }
int64_t merge_kv_smem_bytes(int key, int64_t* static_bytes) { REPRO_BY_KEY(key, (span_query<K, true>(static_bytes))) }
int64_t merge_batched_smem_bytes(int key, int64_t* static_bytes) {
  REPRO_BY_KEY(key, (rows_query<K, false, false>(static_bytes)))
}
int64_t merge_kv_batched_smem_bytes(int key, int64_t* static_bytes) {
  REPRO_BY_KEY(key, (rows_query<K, true, false>(static_bytes)))
}
int64_t merge_batched_ragged_smem_bytes(int key, int64_t* static_bytes) {
  REPRO_BY_KEY(key, (rows_query<K, false, true>(static_bytes)))
}
int64_t merge_kv_batched_ragged_smem_bytes(int key, int64_t* static_bytes) {
  REPRO_BY_KEY(key, (rows_query<K, true, true>(static_bytes)))
}

REPRO_MERGE_SYMBOLS(i16, int16_t)
REPRO_MERGE_SYMBOLS(i32, int32_t)
REPRO_MERGE_SYMBOLS(f32, float)
REPRO_MERGE_SYMBOLS(bf16, repro::bf16)
}  // extern "C"
