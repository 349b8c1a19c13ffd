// time_bin: out[f, j] = sum over records with func f of
//   rate * max(0, min(end, lo_j + bw) - max(start, lo_j)),  lo_j = t0 + bw * j,
// for n_bins equal bins; funcs outside [0, n_funcs) contribute nothing.
// Coordinates come in bin units (the caller divides by the bin width), as
// the ns timestamps of a large trace exceed f32's exact range.
//
// Replaces the TPU kernel src/repro/kernels/time_bin.py::time_bin (the dense
// [BE, NB] overlap block lifted onto [F, NB] by a one-hot matmul).
//
// Bound on the H100: memory. A record is 16 bytes in and adds to the few
// bins its span overlaps; the dense evaluation over all bins is a handful
// of f32 operations per (record, bin) and no tensor-core work.
//
// Design: the wrapper stably sorts the records by func on the device (data
// movement ahead of the sum; canonical order is kept within each func). The
// walk pass stages a chunk's keys, starts, ends and rates in shared memory;
// each thread owns bins and walks the chunk in order, writing each func
// run's per-bin sum into the partial slot (chunk + func) of runs.cuh; the
// gather pass adds those in chunk order. Deterministic: no float atomics,
// partition by N alone; the overlap arithmetic is the reference's, in f32.
#include "runs.cuh"

namespace {

__global__ void time_walk(const int32_t* __restrict__ skeys,
                          const int64_t* __restrict__ perm,
                          const float* __restrict__ start,
                          const float* __restrict__ end,
                          const float* __restrict__ rate, int64_t n,
                          int32_t n_funcs, int32_t n_bins, float t0, float bw,
                          float* __restrict__ partial) {
  __shared__ int32_t sk[CHUNK];
  __shared__ float ss[CHUNK], se[CHUNK], sr[CHUNK];
  int64_t chunk = blockIdx.x;
  int64_t base = chunk * CHUNK;
  int m = chunk_len(n, base);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sk[i] = skeys[base + i];
    int64_t r = perm[base + i];
    ss[i] = start[r];
    se[i] = end[r];
    sr[i] = rate[r];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    float lo = t0 + bw * (float)j;
    float hi = lo + bw;
    walk_column(sk, m, chunk, n_funcs, n_bins, j,
                [&](int i) {
                  float ov = fminf(se[i], hi) - fmaxf(ss[i], lo);
                  return fmaxf(ov, 0.f) * sr[i];
                },
                partial);
  }
}

}  // namespace

extern "C" int pipit_time_bin(int device, const void* skeys, const void* perm,
                              const void* start, const void* end,
                              const void* rate, int64_t n, int n_funcs,
                              int n_bins, float t0, float bw, void* partial,
                              void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sk = (const int32_t*)skeys;
  time_walk<<<(unsigned)n_chunks(n), WALK_THREADS, 0, s>>>(
      sk, (const int64_t*)perm, (const float*)start, (const float*)end,
      (const float*)rate, n, n_funcs, n_bins, t0, bw, (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gather(sk, n, (const float*)partial, n_funcs, n_bins,
                            (float*)out, s);
}
