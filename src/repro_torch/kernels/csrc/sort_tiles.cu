// The tile sort (S1) for Hopper (sm_90a): every narrow round of a flat merge
// sort in one launch.
//
// Replaces: the narrow rounds of src/repro/kernels/ops.py::_sort_rounds and
// ::_sort_rounds_kv (l.558-561 and l.581-586), which run outside any Pallas
// kernel, in XLA: log2(C) rounds of batched rank merges over the whole
// buffer, C = min(m, tile).  It has no pl.pallas_call counterpart.  The port
// ran the same loop in plain PyTorch (a rank, a scatter and a scatter per
// round over all keys).
//
// Function: sort each consecutive chunk of C keys of a flat (n,) buffer
// stably (C a power of two, 2 <= C <= 4096), with int32 values riding along
// where there are values.  A stable sort has one output, so this is exactly
// what the rounds from width 1 to C / 2 compute.  Keys int16 or int32,
// compared with the raw `<=`.
//
// What bounds it: memory.  Each key (and value) is read once and written
// once: 2 * n * (sizeof(K) + 4 if values) bytes, 0.040 ms for 2^24 int32 keys
// at 3.35 TB/s.
//
// What the design does about that: a block of kThreads threads takes
// kThreads * kE consecutive elements, whole chunks: one warp for chunks up to
// 512 (the sorts' default tile), 256 threads above.  Each thread loads its
// kE consecutive keys with 16-byte loads, sorts each run of min(C, kE) of
// them stably in registers (odd-even transposition with a strict `>` swap),
// then the block runs log2(C / kE) merge passes in shared memory: in each,
// every thread finds its diagonal in its pair of runs by one co-rank and
// merges its kE outputs sequentially (segment_merge.cuh), and writes them to
// the other of two buffers, so a pass costs one block barrier.  The last
// pass's outputs go from registers to device memory with 16-byte stores.
// Nothing between the load and the store touches device memory.  Small
// blocks keep a pass's barrier short: on an H100 SXM at 700 W, 2^24 int32
// keys in chunks of 512 took 0.141, 0.142, 0.142 and 0.148 ms in blocks of
// 32, 64, 128 and 256 threads, and 0.183, 0.186, 0.194 and 0.236 ms with
// int32 values (PERF.md).

#include "segment_merge.cuh"

namespace repro {
namespace {

constexpr int kE = 16;          // elements per thread
constexpr int kWarpSpan = 32 * kE;  // the largest chunk a one-warp block takes
constexpr int kMaxChunk = 4096;  // MAX_TILE: blocks of 256 threads

// Load a thread's kE elements at g[0 : kE], of which the first `valid` are
// real: 16-byte vectors when all are and g is 16-byte aligned, else element
// by element.
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ g, int valid, T (&r)[kE], T pad) {
  constexpr int kVec = 16 / sizeof(T);
  if (valid >= kE && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
#pragma unroll
    for (int v = 0; v < kE / kVec; ++v) {
      Vec16<T> x;
      x.q = __ldg(reinterpret_cast<const int4*>(g) + v);
#pragma unroll
      for (int c = 0; c < kVec; ++c) r[v * kVec + c] = x.x[c];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) r[j] = j < valid ? g[j] : pad;
  }
}

// Store them to g (the wrapper's own output, 16-byte aligned).
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ g, int valid, const T (&r)[kE]) {
  constexpr int kVec = 16 / sizeof(T);
  if (valid >= kE) {
#pragma unroll
    for (int v = 0; v < kE / kVec; ++v) {
      Vec16<T> x;
#pragma unroll
      for (int c = 0; c < kVec; ++c) x.x[c] = r[v * kVec + c];
      reinterpret_cast<int4*>(g)[v] = x.q;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (j < valid) g[j] = r[j];
    }
  }
}

template <typename K, bool kValues, int kThreads>
__global__ void __launch_bounds__(kThreads)
    sort_tiles_kernel(const K* __restrict__ kin, const uint32_t* __restrict__ vin, K* __restrict__ kout,
                      uint32_t* __restrict__ vout, int64_t n, int chunk) {
  constexpr int kSpan = kThreads * kE;  // elements per block, whole chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kSlotsK = spad_slots<K>(kSpan + 1);
  constexpr int kSlotsV = spad_slots<uint32_t>(kSpan + 1);
  K* const sk = reinterpret_cast<K*>(smem_raw);                        // two key buffers
  uint32_t* const sv = reinterpret_cast<uint32_t*>(sk + 2 * kSlotsK);  // two value buffers

  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * kSpan;
  const int nb = static_cast<int>(n - o0 < kSpan ? n - o0 : kSpan);  // whole chunks
  const int j0 = threadIdx.x * kE;
  const int valid = nb - j0;

  K k[kE];
  uint32_t v[kE];
  if (valid > 0) {
    load_run(kin + o0 + j0, valid, k, key_max<K>());
    if (kValues) load_run(vin + o0 + j0, valid, v, 0u);
  }

  // 1. each run of min(chunk, kE) keys in registers: `run` rounds of
  // odd-even transposition, swapping neighbours of one run on a strict `>`
  const int run = chunk < kE ? chunk : kE;
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    if (r < run) {
#pragma unroll
      for (int i = r & 1; i + 1 < kE; i += 2) {
        const bool swap = ((i + 1) & (run - 1)) != 0 && !key_le(k[i], k[i + 1]);
        const K lo = swap ? k[i + 1] : k[i];
        const K hi = swap ? k[i] : k[i + 1];
        k[i] = lo;
        k[i + 1] = hi;
        if (kValues) {
          const uint32_t vl = swap ? v[i + 1] : v[i];
          const uint32_t vh = swap ? v[i] : v[i + 1];
          v[i] = vl;
          v[i + 1] = vh;
        }
      }
    }
  }

  // 2. merge passes in shared memory, runs of s into runs of 2 * s; a
  // thread's kE outputs lie inside one pair of runs (kE <= s)
  int buf = 0;
  for (int s = kE; s < chunk; s *= 2) {
    K* const bk = sk + buf * kSlotsK;
    uint32_t* const bv = sv + buf * kSlotsV;
    if (valid > 0) {
      put_segment(bk, j0, kE, k);
      if (kValues) put_segment(bv, j0, kE, v);
    }
    __syncthreads();
    if (valid > 0) {
      const int a0 = j0 & ~(2 * s - 1);
      merge_segment<K, kValues, kE>(bk, bv, a0, s, a0 + s, s, j0 - a0, kE, k, v);
    }
    buf ^= 1;
  }

  if (valid > 0) {
    store_run(kout + o0 + j0, valid, k);
    if (kValues) store_run(vout + o0 + j0, valid, v);
  }
}

// The dynamic shared memory of a block of kThreads: two padded key buffers
// (and two value buffers) of kThreads * kE + 1 slots.
template <typename K, bool kValues, int kThreads>
constexpr size_t tiles_smem() {
  constexpr int kSpan = kThreads * kE;
  return 2 * (spad_slots<K>(kSpan + 1) * sizeof(K) +
              (kValues ? spad_slots<uint32_t>(kSpan + 1) * sizeof(uint32_t) : 0));
}

template <typename K, bool kValues, int kThreads>
int launch_blocks(const void* kin, const void* vin, void* kout, void* vout, int64_t n, int chunk,
                  void* stream) {
  constexpr int kSpan = kThreads * kE;
  constexpr size_t kSmem = tiles_smem<K, kValues, kThreads>();
  const cudaError_t err = allow_smem(sort_tiles_kernel<K, kValues, kThreads>, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_blocks = (n + kSpan - 1) / kSpan;
  sort_tiles_kernel<K, kValues, kThreads><<<static_cast<unsigned>(n_blocks), kThreads, kSmem,
                                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(kin), static_cast<const uint32_t*>(vin), static_cast<K*>(kout),
      static_cast<uint32_t*>(vout), n, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename K, bool kValues>
int launch(const void* kin, const void* vin, void* kout, void* vout, int64_t n, int chunk, void* stream) {
  if (chunk <= kWarpSpan) return launch_blocks<K, kValues, 32>(kin, vin, kout, vout, n, chunk, stream);
  static_assert(kMaxChunk == 256 * kE, "a chunk must fit one block");
  return launch_blocks<K, kValues, 256>(kin, vin, kout, vout, n, chunk, stream);
}

// What the launch at `chunk` requests (the block `launch` picks for it).
template <typename K, bool kValues>
int64_t tiles_query(int chunk, int64_t* static_bytes) {
  if (chunk <= kWarpSpan) {
    return smem_query(sort_tiles_kernel<K, kValues, 32>, tiles_smem<K, kValues, 32>(), static_bytes);
  }
  return smem_query(sort_tiles_kernel<K, kValues, 256>, tiles_smem<K, kValues, 256>(), static_bytes);
}

}  // namespace
}  // namespace repro

extern "C" {

// The dynamic shared memory S1's launch at `chunk` requests, keys int16
// (key 0) or int32 (key 1), and the kernel's static shared memory in
// *static_bytes when not null: kernels/merge_path.py's smem_bytes("tiles")
// must agree.
int64_t sort_tiles_smem_bytes(int key, int chunk, int64_t* static_bytes) {
  if (key == 0) return repro::tiles_query<int16_t, false>(chunk, static_bytes);
  return key == 1 ? repro::tiles_query<int32_t, false>(chunk, static_bytes) : -1;
}

int64_t sort_tiles_kv_smem_bytes(int key, int chunk, int64_t* static_bytes) {
  if (key == 0) return repro::tiles_query<int16_t, true>(chunk, static_bytes);
  return key == 1 ? repro::tiles_query<int32_t, true>(chunk, static_bytes) : -1;
}

int sort_tiles_i16(const void* kin, void* kout, int64_t n, int chunk, void* stream) {
  return repro::launch<int16_t, false>(kin, nullptr, kout, nullptr, n, chunk, stream);
}

int sort_tiles_i32(const void* kin, void* kout, int64_t n, int chunk, void* stream) {
  return repro::launch<int32_t, false>(kin, nullptr, kout, nullptr, n, chunk, stream);
}

int sort_tiles_kv_i16(const void* kin, const void* vin, void* kout, void* vout, int64_t n, int chunk,
                      void* stream) {
  return repro::launch<int16_t, true>(kin, vin, kout, vout, n, chunk, stream);
}

int sort_tiles_kv_i32(const void* kin, const void* vin, void* kout, void* vout, int64_t n, int chunk,
                      void* stream) {
  return repro::launch<int32_t, true>(kin, vin, kout, vout, n, chunk, stream);
}

}  // extern "C"
