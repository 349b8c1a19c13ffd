// seg_sum: out[code[i], :] += values[i, :] over N records; codes outside
// [0, n_seg) contribute nothing.
//
// Replaces the TPU kernel src/repro/kernels/seg_sum.py::seg_sum (one-hot
// matmul on the MXU, accumulated over a sequential grid).
//
// Bound on the H100: memory. Each record is a 4-byte code plus K 4-byte
// values and adds K floats; there is no tensor-core work, and at a few
// bytes per record the card's 3.35 TB/s is the limit.
//
// Design: the wrapper stably sorts the codes on the device (data movement
// ahead of the sum); this file reduces the sorted runs with the two-pass,
// fixed-order scheme of runs.cuh. Pass 1 stages a chunk's keys and its
// gathered values (values[perm[i]]) in shared memory with coalesced key
// reads, then one thread per column walks the chunk. Pass 2 adds the
// per-chunk run sums in chunk order. No float atomics, so the result is
// bit-identical across launches, and the partition depends on N only.
#include "runs.cuh"

namespace {

constexpr int MAX_COLS = 8;  // columns staged per walk launch

__global__ void seg_walk(const int32_t* __restrict__ skeys,
                         const int64_t* __restrict__ perm,
                         const float* __restrict__ values, int64_t n,
                         int32_t k, int32_t j0, int32_t kg, int32_t n_seg,
                         float* __restrict__ partial) {
  __shared__ int32_t sk[CHUNK];
  __shared__ float sv[CHUNK * MAX_COLS];
  int64_t chunk = blockIdx.x;
  int64_t base = chunk * CHUNK;
  int m = chunk_len(n, base);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sk[i] = skeys[base + i];
    int64_t r = perm[base + i];
    for (int j = 0; j < kg; ++j) sv[i * kg + j] = values[r * k + j0 + j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kg; j += blockDim.x) {
    walk_column(sk, m, chunk, n_seg, k, j0 + j,
                [&](int i) { return sv[i * kg + j]; }, partial);
  }
}

}  // namespace

extern "C" int pipit_seg_sum(int device, const void* skeys, const void* perm,
                             const void* values, int64_t n, int k, int n_seg,
                             void* partial, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sk = (const int32_t*)skeys;
  unsigned chunks = (unsigned)n_chunks(n);
  for (int j0 = 0; j0 < k; j0 += MAX_COLS) {
    int kg = k - j0 < MAX_COLS ? k - j0 : MAX_COLS;
    seg_walk<<<chunks, WALK_THREADS, 0, s>>>(
        sk, (const int64_t*)perm, (const float*)values, n, k, j0, kg, n_seg,
        (float*)partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_gather(sk, n, (const float*)partial, n_seg, k,
                            (float*)out, s);
}
