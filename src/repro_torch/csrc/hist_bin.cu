// hist_bin: counts of clip(floor(x), 0, n_bins - 1) over the coordinates
// x >= 0 (negative and NaN coordinates contribute nothing).
//
// Replaces the TPU kernel src/repro/kernels/hist_bin.py::hist_bin (a
// one-hot [BE, NB] block summed on the MXU into f32 counts).
//
// Bound on the H100: memory. One 4-byte coordinate in per record and an
// integer increment; no tensor-core work.
//
// Design: a grid-stride loop over a grid sized by N alone; each CTA counts
// into a shared-memory histogram with integer atomics, then adds its
// non-zero bins into the global 64-bit counts with integer atomics. Integer
// sums are exact and order-free, so the counts are exact everywhere (the
// reference's f32 counts only below 2^24 per bin) and identical on every
// launch. Histograms too wide for shared memory count straight into global
// memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;
constexpr int SHARED_BINS = 8192;  // 32 KB of 32-bit counts

__global__ void hist_count(const float* __restrict__ x, int64_t n,
                           int32_t n_bins, unsigned long long* __restrict__ out) {
  __shared__ unsigned int sh[SHARED_BINS];
  const bool shared = n_bins <= SHARED_BINS;
  if (shared) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0u;
    __syncthreads();
  }
  const float top = (float)(n_bins - 1);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = x[i];
    if (!(v >= 0.f)) continue;
    int b = (int)fminf(floorf(v), top);
    if (shared) atomicAdd(&sh[b], 1u);
    else atomicAdd(&out[b], 1ull);
  }
  if (shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
      if (sh[b]) atomicAdd(&out[b], (unsigned long long)sh[b]);
  }
}

}  // namespace

extern "C" int pipit_hist_bin(int device, const void* coords, int64_t n,
                              int n_bins, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int64_t want = (n + THREADS - 1) / THREADS;
  unsigned blocks = (unsigned)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  hist_count<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)coords, n, n_bins, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
