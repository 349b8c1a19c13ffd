// topk_gating: MoE router top-k. logits [T, E] f32 -> idx [T, k] i32 (the k
// largest logits of each row, largest first, the lowest index on ties) and
// gates [T, k] f32 (the softmax over those k logits).
//
// Replaces the TPU kernel src/repro/kernels/topk_gating.py::topk_gating (a
// [256, E] logit tile in VMEM, k unrolled select-and-mask sweeps).
//
// Bound on the H100: memory, and at serving sizes launch latency: a row of
// E = 60 logits is 240 bytes in and 32 out, a few hundred operations.
//
// Design: one warp per token row. Round r of k: every lane scans its
// columns (lane, lane + 32, ...) in ascending order, reading a column chosen
// in an earlier round as -1e30 (the Pallas kernel's mask), and keeps the
// first largest; five xor-shuffles then pick the largest value, the lowest
// column on ties. That order is total, so all 32 lanes agree, the result is
// jnp.argmax's and lax.top_k's, and a relaunch gives the same bits. Any E
// works (the row is re-read from L1 each round); k <= 8 is unrolled. The
// softmax is f32: exp(v - max v) / sum, summed in selection order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // token rows per CTA
constexpr float NEG = -1e30f;

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
topk_gate(const float* __restrict__ logits, int64_t T, int E,
          int32_t* __restrict__ idx, float* __restrict__ gates) {
  const int lane = threadIdx.x % 32;
  const int64_t t = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= T) return;                  // the whole warp leaves together
  const float* row = logits + t * E;
  int chosen[K];
  float val[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float best = 0.f;
    int bi = -1;                         // -1: this lane holds no column
    for (int e = lane; e < E; e += 32) {
      float x = row[e];
#pragma unroll
      for (int p = 0; p < r; ++p)
        if (chosen[p] == e) x = NEG;
      if (bi < 0 || x > best) {
        best = x;
        bi = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (oi >= 0 && (bi < 0 || ob > best || (ob == best && oi < bi))) {
        best = ob;
        bi = oi;
      }
    }
    chosen[r] = bi;
    val[r] = best;
  }
  float mx = val[0];
#pragma unroll
  for (int r = 1; r < K; ++r) mx = fmaxf(mx, val[r]);
  float ev[K], sum = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    ev[r] = expf(val[r] - mx);
    sum += ev[r];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      idx[t * K + r] = chosen[r];
      gates[t * K + r] = ev[r] / sum;
    }
  }
}

}  // namespace

// T >= 1, 1 <= k <= 8, k <= E (the wrapper checks).
extern "C" int pipit_topk_gating(int device, const void* logits, int64_t T,
                                 int E, int k, void* idx, void* gates,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((T + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)logits;
  int32_t* i = (int32_t*)idx;
  float* g = (float*)gates;
  switch (k) {
#define PIPIT_TOPK(K) \
  case K: topk_gate<K><<<blocks, WARPS * 32, 0, s>>>(x, T, E, i, g); break;
    PIPIT_TOPK(1) PIPIT_TOPK(2) PIPIT_TOPK(3) PIPIT_TOPK(4)
    PIPIT_TOPK(5) PIPIT_TOPK(6) PIPIT_TOPK(7) PIPIT_TOPK(8)
#undef PIPIT_TOPK
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
