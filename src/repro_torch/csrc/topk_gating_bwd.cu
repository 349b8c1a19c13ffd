// topk_gating_bwd: the gradient of the MoE router's top-k gating. From
// topk_gating's outputs idx [T, k] i32 and gates [T, k] f32, the gates'
// gradient dgates [T, k] f32 and, where the logits have one of their own,
// dlogits_in [T, E] f32, it writes dlogits [T, E] f32:
//
//   dlogits[t, c] = dlogits_in[t, c] (or 0)
//                   + g_j (dg_j - S) for each j with idx[t, j] == c,
//                     added in j order,
//   S = g_0 dg_0 + g_1 dg_1 + ... + g_{k-1} dg_{k-1}, summed in that order,
//
// the softmax's backward scattered onto the chosen columns.
//
// Replaces no TPU kernel: src/repro/kernels/topk_gating.py::topk_gating is
// forward-only, and the reference trains through route_topk (lax.top_k, then
// a softmax; src/repro/models/moe.py) by autodiff. It is the backward of both
// router routes on the card: kernels/topk_gating.py's autograd Function
// (the f32 route) and kernels/router_topk.py's (the fused bf16 route, which
// then multiplies dlogits by the router weight and the activations).
//
// Bound on the H100: memory, and at the training shapes a launch. A row
// reads k triples (12 k bytes) and writes E floats (plus E read with an
// incoming gradient): at qwen2-moe's 2,048 tokens of E = 60, k = 4 that is
// 0.59 MB, 0.18 us at 3.35 TB/s, where one launch costs a few us.
//
// Design: one warp a row, 8 warps a CTA. Every lane loads the row's k
// (index, gate, gradient) triples (one address a load for the whole warp),
// sums S in i order, then writes its columns lane, lane + 32, ...: the
// incoming gradient (or 0) plus, in j order, each contribution whose index
// is that column. A row with fewer finite logits than k selects a chosen
// column again (topk_gating's rule, the Pallas kernel's), so one column may
// take several contributions: they are added, never overwritten. Products
// and sums are rounded one at a time (no fused multiply-add), as the plain
// version's PyTorch ops round them. Each output is written once, by one lane,
// with no atomics: a relaunch gives the same bits.
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int WARPS = 8;             // warps (rows) a CTA
constexpr int MAX_K = 8;

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
topk_bwd(const int32_t* __restrict__ idx, const float* __restrict__ gates,
         const float* __restrict__ dgates, const float* __restrict__ din,
         int64_t T, int E, float* __restrict__ dlogits) {
  const int lane = threadIdx.x % 32;
  const int64_t t = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= T) return;                  // the whole warp leaves together
  int col[K];
  float g[K], dg[K];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    col[j] = __ldg(idx + t * K + j);
    g[j] = __ldg(gates + t * K + j);
    dg[j] = __ldg(dgates + t * K + j);
    s = __fadd_rn(s, __fmul_rn(g[j], dg[j]));
  }
  float c[K];
#pragma unroll
  for (int j = 0; j < K; ++j) c[j] = __fmul_rn(g[j], __fsub_rn(dg[j], s));
  const float* in = din ? din + t * E : nullptr;
  float* out = dlogits + t * E;
  for (int e = lane; e < E; e += 32) {
    float v = in ? __ldg(in + e) : 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (col[j] == e) v = __fadd_rn(v, c[j]);
    out[e] = v;
  }
}

}  // namespace

// T >= 1, 1 <= k <= 8, k <= E (the wrapper checks); dlogits_in may be null.
extern "C" int pipit_topk_gating_bwd(int device, const void* idx,
                                     const void* gates, const void* dgates,
                                     const void* dlogits_in, int64_t T, int E,
                                     int k, void* dlogits, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1 || k < 1 || k > MAX_K || E < k) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* i = (const int32_t*)idx;
  const float* g = (const float*)gates;
  const float* dg = (const float*)dgates;
  const float* din = (const float*)dlogits_in;
  float* out = (float*)dlogits;
  switch (k) {
#define PIPIT_TOPK_BWD(K) \
  case K:                                                                \
    topk_bwd<K><<<blocks, WARPS * 32, 0, s>>>(i, g, dg, din, T, E, out); \
    break;
    PIPIT_TOPK_BWD(1) PIPIT_TOPK_BWD(2) PIPIT_TOPK_BWD(3) PIPIT_TOPK_BWD(4)
    PIPIT_TOPK_BWD(5) PIPIT_TOPK_BWD(6) PIPIT_TOPK_BWD(7) PIPIT_TOPK_BWD(8)
#undef PIPIT_TOPK_BWD
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
