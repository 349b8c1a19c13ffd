// topk_gating: MoE router top-k. logits [T, E] f32 -> idx [T, k] i32 (the k
// largest logits of each row, largest first, the lowest index on ties) and
// gates [T, k] f32 (the softmax over those k logits).
//
// Replaces the TPU kernel src/repro/kernels/topk_gating.py::topk_gating (a
// [256, E] logit tile in VMEM, k unrolled select-and-mask sweeps).
//
// Bound on the H100: at the path's shape, a launch. The f32 router's
// 3,488 rows of E = 60 logits are 0.84 MB in and 0.11 MB out (0.3 us at
// 3.35 TB/s) and a few hundred operations a row, where one launch costs a
// few us.
//
// Round r of k picks the first largest logit of the row, the lowest column
// on ties (+0 and -0 equal), reading a column chosen in an earlier round as
// -1e30 (the Pallas kernel's mask: a row of -inf selects a chosen column
// again). That order is total on non-NaN values, so every lane of a row
// agrees, the result is jnp.argmax's and lax.top_k's, and a relaunch gives
// the same bits. The softmax is f32: exp(v - max v) / sum, summed in
// selection order. k <= 8 is unrolled. Two paths, picked by
// kernels/topk_gating.py::path from E alone, give the same bits:
//
// - "narrow", E <= NARROW_E = 128: topk_narrow<K, G>, G lanes a row, G the
//   smallest of 8, 16 and 32 with 4G >= E (G = 16 at E = 60: two rows a
//   warp). Lane r loads its columns 4r .. 4r + 3 once into registers (one
//   16-byte load when E % 4 == 0 and the logits are 16-byte aligned). Each
//   round scans the lane's registers in ascending column, then takes
//   log2(G) xor-shuffles inside the row's G-lane segment on the (value,
//   column) pair; the lane that owns the winner sets that register to
//   -1e30. Lane r of the segment stores slot r of idx and gates.
// - "wide", above: topk_gate<K>, one warp a row. Each round every lane
//   scans its columns lane, lane + 32, ... from L1 (a column chosen earlier
//   reads -1e30), then five xor-shuffles pick the winner. csrc/
//   router_topk.cu's epilogue keeps a copy of this selection.
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int WARPS = 8;             // warps a CTA
constexpr int NARROW_E = 128;
constexpr float NEG = -1e30f;

// The (value, column) pair that wins between this lane's and another's:
// the larger value, the lower column on ties; column -1 holds nothing.
__device__ __forceinline__ void take(float& best, int& bi, float ob, int oi) {
  if (oi >= 0 && (bi < 0 || ob > best || (ob == best && oi < bi))) {
    best = ob;
    bi = oi;
  }
}

// The f32 softmax over the k selected values, in selection order.
template <int K>
__device__ __forceinline__ void softmax(const float (&val)[K], float (&ev)[K],
                                        float& sum) {
  float mx = val[0];
#pragma unroll
  for (int r = 1; r < K; ++r) mx = fmaxf(mx, val[r]);
  sum = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    ev[r] = expf(val[r] - mx);
    sum += ev[r];
  }
}

template <int K, int G>
__global__ void __launch_bounds__(WARPS * 32)
topk_narrow(const float* __restrict__ logits, int64_t T, int E, bool vec,
            int32_t* __restrict__ idx, float* __restrict__ gates) {
  constexpr int ROWS = 32 / G;         // rows a warp
  const int lane = threadIdx.x % 32;
  const int seg = lane % G;            // this lane's place in its row's segment
  const int64_t t0 = ((int64_t)blockIdx.x * WARPS + threadIdx.x / 32) * ROWS;
  if (t0 >= T) return;                 // the whole warp leaves together
  const int64_t t = t0 + lane / G;
  const bool live = t < T;             // a segment past T shuffles, holds nothing
  const int c0 = 4 * seg;
  float v[4];
  bool has[4];
  if (vec && live && c0 < E) {         // E % 4 == 0: four columns or none
    const float4 f = __ldg(reinterpret_cast<const float4*>(logits + t * E + c0));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
#pragma unroll
    for (int q = 0; q < 4; ++q) has[q] = true;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      has[q] = live && c0 + q < E;
      v[q] = has[q] ? __ldg(logits + t * E + c0 + q) : 0.f;
    }
  }
  int chosen[K];
  float val[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float best = 0.f;
    int bi = -1;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (has[q] && (bi < 0 || v[q] > best)) {
        best = v[q];
        bi = c0 + q;
      }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off, G);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off, G);
      take(best, bi, ob, oi);
    }
    chosen[r] = bi;
    val[r] = best;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (bi == c0 + q) v[q] = NEG;
  }
  float ev[K], sum;
  softmax(val, ev, sum);
  if (live && seg < K) {
    int oi = 0;
    float og = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (r == seg) {
        oi = chosen[r];
        og = ev[r] / sum;
      }
    idx[t * K + seg] = oi;
    gates[t * K + seg] = og;
  }
}

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
      take(best, bi, ob, oi);
    }
    chosen[r] = bi;
    val[r] = best;
  }
  float ev[K], sum;
  softmax(val, ev, sum);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      idx[t * K + r] = chosen[r];
      gates[t * K + r] = ev[r] / sum;
    }
  }
}

template <int K>
cudaError_t launch_narrow(const float* x, int64_t T, int E, int32_t* i,
                          float* g, cudaStream_t s) {
  const int G = E <= 32 ? 8 : E <= 64 ? 16 : 32;
  const int64_t rows = WARPS * (32 / G);     // rows a CTA
  const unsigned blocks = (unsigned)((T + rows - 1) / rows);
  const bool vec = E % 4 == 0 && (uintptr_t)x % 16 == 0;
  if (G == 8) topk_narrow<K, 8><<<blocks, WARPS * 32, 0, s>>>(x, T, E, vec, i, g);
  else if (G == 16) topk_narrow<K, 16><<<blocks, WARPS * 32, 0, s>>>(x, T, E, vec, i, g);
  else topk_narrow<K, 32><<<blocks, WARPS * 32, 0, s>>>(x, T, E, vec, i, g);
  return cudaGetLastError();
}

}  // namespace

// The narrow path: T >= 1, 1 <= k <= 8, k <= E <= 128 (the wrapper checks).
extern "C" int pipit_topk_gating_narrow(int device, const void* logits,
                                        int64_t T, int E, int k, void* idx,
                                        void* gates, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1 || k < 1 || k > 8 || E < k || E > NARROW_E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)logits;
  int32_t* i = (int32_t*)idx;
  float* g = (float*)gates;
  switch (k) {
#define PIPIT_TOPK(K) \
  case K: return (int)launch_narrow<K>(x, T, E, i, g, s);
    PIPIT_TOPK(1) PIPIT_TOPK(2) PIPIT_TOPK(3) PIPIT_TOPK(4)
    PIPIT_TOPK(5) PIPIT_TOPK(6) PIPIT_TOPK(7) PIPIT_TOPK(8)
#undef PIPIT_TOPK
  }
  return (int)cudaErrorInvalidValue;
}

// The wide path: T >= 1, 1 <= k <= 8, k <= E (the wrapper checks).
extern "C" int pipit_topk_gating(int device, const void* logits, int64_t T,
                                 int E, int k, void* idx, void* gates,
                                 void* stream) {
  cudaError_t err = use_device(device);
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
