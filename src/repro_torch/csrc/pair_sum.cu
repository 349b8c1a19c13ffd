// pair_sum: out[a[i], b[i]] += w[i] over N records; records with a or b
// outside [0, n_a) x [0, n_b) contribute nothing.
//
// Replaces the TPU kernel src/repro/kernels/pair_sum.py::pair_sum (a pair of
// one-hot matmuls, onehot(a)^T @ (onehot(b) * w), on the MXU).
//
// Bound on the H100: memory. Each record is 12 bytes in and one float add;
// no tensor-core work. The output can be 1024 x 1024 or more, so per-CTA
// dense copies of it would not fit in shared memory.
//
// Design: pipit_pair_keys forms the flat cell key a * n_b + b (-1 when the
// record is ignored); the wrapper stably sorts the keys on the device (data
// movement ahead of the sum); pipit_pair_sum reduces the sorted runs with
// the two-pass, fixed-order scheme of runs.cuh, the same one seg_sum uses
// with one column. Deterministic: no float atomics, partition by N alone.
#include "runs.cuh"

namespace {

__global__ void pair_keys(const int32_t* __restrict__ a,
                          const int32_t* __restrict__ b, int64_t n,
                          int32_t n_a, int32_t n_b, int32_t* __restrict__ keys) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t x = a[i], y = b[i];
  keys[i] = (x >= 0 && y >= 0 && x < n_a && y < n_b) ? x * n_b + y : -1;
}

__global__ void pair_walk(const int32_t* __restrict__ skeys,
                          const int64_t* __restrict__ perm,
                          const float* __restrict__ w, int64_t n,
                          int32_t n_cells, float* __restrict__ partial) {
  __shared__ int32_t sk[CHUNK];
  __shared__ float sw[CHUNK];
  int64_t chunk = blockIdx.x;
  int64_t base = chunk * CHUNK;
  int m = chunk_len(n, base);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sk[i] = skeys[base + i];
    sw[i] = w[perm[base + i]];
  }
  __syncthreads();
  if (threadIdx.x == 0)
    walk_column(sk, m, chunk, n_cells, 1, 0, [&](int i) { return sw[i]; },
                partial);
}

}  // namespace

extern "C" int pipit_pair_keys(int device, const void* a, const void* b,
                               int64_t n, int n_a, int n_b, void* keys,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((n + 255) / 256);
  pair_keys<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, n, n_a, n_b, (int32_t*)keys);
  return (int)cudaGetLastError();
}

extern "C" int pipit_pair_sum(int device, const void* skeys, const void* perm,
                              const void* w, int64_t n, int n_cells,
                              void* partial, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sk = (const int32_t*)skeys;
  pair_walk<<<(unsigned)n_chunks(n), WALK_THREADS, 0, s>>>(
      sk, (const int64_t*)perm, (const float*)w, n, n_cells, (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gather(sk, n, (const float*)partial, n_cells, 1,
                            (float*)out, s);
}
