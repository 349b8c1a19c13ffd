// Shared pieces of the deterministic record reductions (seg_sum, pair_sum,
// time_bin): keyed records, stably sorted by key, reduced in two passes
// whose summation order is fixed by N alone.
//
// Pass 1 ("walk"): records are cut into chunks of CHUNK consecutive sorted
// positions, one CTA per chunk. A thread owns output columns; for each it
// walks the chunk's records in order and writes the sum of every run of
// equal keys into the partial slot (chunk + key). Keys are sorted, so the
// keys of chunk c+1 start at or after the last key of chunk c, and
// (c + key) never collides between chunks: the partial array holds
// (chunks + n_keys) slots per column, each written at most once.
//
// Pass 2 ("gather"): one thread per (key, column) finds the key's run
// [lo, hi) by binary search and adds the partial slots of the chunks it
// spans in chunk order.
//
// No float atomics: the same sorted input gives the same bits on every
// launch, on any number of SMs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 1024;       // sorted records per CTA in the walk pass
constexpr int WALK_THREADS = 128;
constexpr int GATHER_THREADS = 256;

inline int64_t n_chunks(int64_t n) { return (n + CHUNK - 1) / CHUNK; }

__device__ __forceinline__ int chunk_len(int64_t n, int64_t base) {
  int64_t rem = n - base;
  return rem < CHUNK ? (int)rem : CHUNK;
}

__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ keys,
                                               int64_t n, int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Walk one column of a chunk: sk[i] are the chunk's sorted keys, val(i) the
// value record i adds to this column. Keys outside [0, n_keys) are skipped.
template <typename Val>
__device__ __forceinline__ void walk_column(const int32_t* sk, int m,
                                            int64_t chunk, int32_t n_keys,
                                            int32_t ncols, int32_t col,
                                            Val val, float* __restrict__ partial) {
  float acc = 0.f;
  int32_t cur = -1;
  for (int i = 0; i < m; ++i) {
    int32_t key = sk[i];
    if (key < 0 || key >= n_keys) continue;
    if (key != cur) {
      if (cur >= 0) partial[(chunk + cur) * ncols + col] = acc;
      cur = key;
      acc = 0.f;
    }
    acc += val(i);
  }
  if (cur >= 0) partial[(chunk + cur) * ncols + col] = acc;
}

__global__ void gather_runs(const int32_t* __restrict__ skeys, int64_t n,
                            const float* __restrict__ partial, int32_t n_keys,
                            int32_t ncols, float* __restrict__ out) {
  int64_t cell = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (cell >= (int64_t)n_keys * ncols) return;
  int32_t key = (int32_t)(cell / ncols);
  int32_t col = (int32_t)(cell % ncols);
  int64_t lo = lower_bound(skeys, n, key);
  int64_t hi = lower_bound(skeys, n, key + 1);
  float acc = 0.f;
  if (lo < hi) {
    for (int64_t c = lo / CHUNK; c <= (hi - 1) / CHUNK; ++c)
      acc += partial[(c + key) * ncols + col];
  }
  out[cell] = acc;
}

inline cudaError_t launch_gather(const int32_t* skeys, int64_t n,
                                 const float* partial, int32_t n_keys,
                                 int32_t ncols, float* out, cudaStream_t s) {
  int64_t cells = (int64_t)n_keys * ncols;
  if (cells == 0) return cudaGetLastError();
  unsigned blocks = (unsigned)((cells + GATHER_THREADS - 1) / GATHER_THREADS);
  gather_runs<<<blocks, GATHER_THREADS, 0, s>>>(skeys, n, partial, n_keys,
                                                ncols, out);
  return cudaGetLastError();
}

}  // namespace
