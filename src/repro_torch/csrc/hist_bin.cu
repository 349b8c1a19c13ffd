// hist_bin: counts of clip(floor(x), 0, n_bins - 1) over the coordinates
// x >= 0. Negative and NaN coordinates contribute nothing, -0.0 counts in
// bin 0, and the clamp is taken in float before the cast to int, so +inf
// and coordinates past the top bin land in the top bin.
//
// Replaces the TPU kernel src/repro/kernels/hist_bin.py::hist_bin (a
// one-hot [BE, NB] block summed on the MXU into f32 counts).
//
// Bound on the H100: at the path's shape, a launch. message_histogram at
// main-10M counts 579,328 coordinates into 10 bins: 2.3 MB in, 0.7 us at
// 3.35 TB/s, and a few integer operations a record, where one launch costs
// a few us. So a call is one device operation and nothing else.
//
// Two paths, picked by kernels/hist_bin.py::path from n_bins alone:
//
// - "narrow", up to NARROW_BINS = 32 bins: hist_narrow<NB>, NB the padded
//   width (8, 16 or 32). A CTA of 256 threads takes TILE = 4,096 records,
//   four 16-byte loads a thread (scalar loads for a head up to the first
//   16-byte boundary and for a tail of at most 3), so the grid is a
//   function of N alone: 142 CTAs at the main shape. A thread counts its
//   records in registers, four bits a bin packed into 64-bit words: one
//   shift and one add a record, where a counter a bin costs a compare and
//   an add per bin and record, more instructions than the loads take.
//   Unpacked, a warp adds the counts
//   with __reduce_add_sync per bin, the CTA its warps, and the CTA adds
//   its non-zero bins into 32 u64 accumulators with integer atomics. Then
//   one thread takes a ticket with acquire-release order at device scope;
//   the CTA that takes the last one exchanges the accumulators for 0 into
//   the int64 output (every bin, so no fill runs before it) and resets the
//   ticket. The accumulators and the ticket are scratch the wrapper keeps
//   per device and stream, 0 between launches, so two streams never share
//   them. Measured at the main shape (PERF.md §6): CTA rows of u32
//   partials added by the last CTA, or a cooperative launch whose CTA 0
//   adds them after a grid sync, each take 0.7 us more, and __threadfence
//   (a sequentially consistent fence) in place of the acquire-release
//   ticket 0.8 us more.
// - "wide", above: hist_count, a grid-stride loop whose CTAs count into a
//   shared-memory histogram with integer atomics and add their non-zero
//   bins into the zeroed global counts with 64-bit integer atomics;
//   histograms too wide for shared memory count straight into global
//   memory.
//
// Integer sums are exact and order-free, so both paths give exact counts
// (the reference's f32 counts are exact only below 2^24 per bin), the same
// on every launch.
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;      // the wide path's grid, at most
constexpr int SHARED_BINS = 8192;     // 32 KB of 32-bit counts
constexpr int NARROW_BINS = 32;
constexpr int VECS = 4;               // 16-byte loads a thread: TILE = 4,096

// The bin of coordinate v, or -1 when it is ignored (negative or NaN).
__device__ __forceinline__ int bin_of(float v, float top) {
  return v >= 0.f ? (int)fminf(floorf(v), top) : -1;
}

// Counts packed four bits a bin, 16 bins a 64-bit word: a record adds one
// shifted 1 (nothing when it is ignored). A field holds at most 15, so a
// thread keeps two sets of words, each fed at most 11 records.
template <int W>
__device__ __forceinline__ void count(unsigned long long (&a)[W], int b) {
  const unsigned long long inc = b >= 0 ? 1ull << (4 * (b & 15)) : 0ull;
  if (W == 1) {
    a[0] += inc;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) a[w] += (b >> 4) == w ? inc : 0ull;
  }
}

// A ticket: add 1 with acquire-release order at device scope. The CTA's
// barrier before it orders its threads' accumulator adds before the
// release; the barrier after it hands the last CTA's acquire to all of its
// threads.
__device__ __forceinline__ unsigned take_ticket(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
hist_narrow(const float* __restrict__ x, int64_t n, int head, int64_t n_vec,
            int32_t n_bins, unsigned long long* __restrict__ acc,
            unsigned* __restrict__ ticket,
            unsigned long long* __restrict__ out) {
  constexpr int WARPS = THREADS / 32;
  constexpr int W = (NB + 15) / 16;   // packed words a set
  __shared__ unsigned warp_rows[WARPS][NB];
  __shared__ bool last;
  const float top = (float)(n_bins - 1);
  unsigned long long a[2][W];         // vectors 0-1 (+ head), 2-3 (+ tail)
#pragma unroll
  for (int w = 0; w < W; ++w) a[0][w] = a[1][w] = 0ull;
  // the body: four 16-byte loads a thread, all in flight before counting
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const int64_t v0 = (int64_t)blockIdx.x * (THREADS * VECS) + threadIdx.x;
  float4 f[VECS];
#pragma unroll
  for (int q = 0; q < VECS; ++q) {
    const int64_t v = v0 + q * THREADS;
    f[q] = v < n_vec ? __ldcs(xv + v) : make_float4(-1.f, -1.f, -1.f, -1.f);
  }
#pragma unroll
  for (int q = 0; q < VECS; ++q) {
    unsigned long long (&s)[W] = a[q / (VECS / 2)];
    count(s, bin_of(f[q].x, top));
    count(s, bin_of(f[q].y, top));
    count(s, bin_of(f[q].z, top));
    count(s, bin_of(f[q].w, top));
  }
  // the head (before the first 16-byte boundary) and the tail (after the
  // last whole vector), at most 3 records each
  if (blockIdx.x == 0 && (int)threadIdx.x < head)
    count(a[0], bin_of(x[threadIdx.x], top));
  const int64_t done = head + 4 * n_vec;
  if (blockIdx.x == gridDim.x - 1 && (int64_t)threadIdx.x < n - done)
    count(a[1], bin_of(x[done + threadIdx.x], top));
  unsigned c[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int sh = 4 * (j % 16);
    c[j] = (unsigned)((a[0][j / 16] >> sh) & 15u) +
           (unsigned)((a[1][j / 16] >> sh) & 15u);
  }
  // warp sums, then the CTA's into the accumulators
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const unsigned s = __reduce_add_sync(0xffffffffu, c[j]);
    if (lane == j) warp_rows[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < NB) {
    unsigned s = 0u;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_rows[w][threadIdx.x];
    if (s) atomicAdd(acc + threadIdx.x, (unsigned long long)s);
  }
  __syncthreads();
  if (threadIdx.x == 0) last = take_ticket(ticket) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last CTA: every CTA's adds are visible; hand the totals out and
  // leave the scratch at 0 for the next launch on this stream
  if ((int)threadIdx.x < n_bins)
    out[threadIdx.x] = atomicExch(acc + threadIdx.x, 0ull);
  if (threadIdx.x == 0) *ticket = 0u;
}

template <int NB>
cudaError_t launch_narrow(const float* x, int64_t n, int head, int64_t n_vec,
                          int n_bins, unsigned blocks,
                          unsigned long long* acc, unsigned* ticket,
                          unsigned long long* out, cudaStream_t s) {
  hist_narrow<NB><<<blocks, THREADS, 0, s>>>(x, n, head, n_vec, n_bins, acc,
                                             ticket, out);
  return cudaGetLastError();
}

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
    const int b = bin_of(x[i], top);
    if (b < 0) continue;
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

// The narrow path: n >= 1, 1 <= n_bins <= 32, coords 4-byte aligned;
// `scratch` is NARROW_BINS u64 accumulators, then the u32 ticket, all 0
// between launches on `stream` (the wrapper keeps one per device and
// stream). Writes all n_bins int64 counts.
extern "C" int pipit_hist_bin_narrow(int device, const void* coords, int64_t n,
                                     int n_bins, void* scratch, void* out,
                                     void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t addr = (uintptr_t)coords;
  if (n < 1 || n_bins < 1 || n_bins > NARROW_BINS || addr % 4)
    return (int)cudaErrorInvalidValue;
  int64_t head = (int64_t)((16 - addr % 16) % 16 / 4);
  if (head > n) head = n;
  const int64_t n_vec = (n - head) / 4;
  const int64_t blocks =
      n_vec > 0 ? (n_vec + THREADS * VECS - 1) / (THREADS * VECS) : 1;
  const int nb = n_bins <= 8 ? 8 : n_bins <= 16 ? 16 : 32;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)coords;
  unsigned long long* p = (unsigned long long*)scratch;
  unsigned* tk = (unsigned*)(p + NARROW_BINS);
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = (unsigned)blocks;
  const int h = (int)head;
  if (nb == 8) return (int)launch_narrow<8>(x, n, h, n_vec, n_bins, b, p, tk, o, s);
  if (nb == 16) return (int)launch_narrow<16>(x, n, h, n_vec, n_bins, b, p, tk, o, s);
  return (int)launch_narrow<32>(x, n, h, n_vec, n_bins, b, p, tk, o, s);
}

// The wide path: adds into `out`, which the wrapper zeroes.
extern "C" int pipit_hist_bin(int device, const void* coords, int64_t n,
                              int n_bins, void* out, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  int64_t want = (n + THREADS - 1) / THREADS;
  unsigned blocks = (unsigned)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  hist_count<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)coords, n, n_bins, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
