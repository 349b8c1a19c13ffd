// flash_attention: blocked online-softmax attention in the GQA layout.
// q [B, Sq, H, D], k/v [B, Sk, KVH, D] (bf16 or f32) -> out [B, Sq, H, D] in
// q's dtype. Query head h reads KV head h / (H / KVH), so nothing is
// broadcast in memory. Row i sits at position q_offset + i and key c at c;
// with d = position - c a key is visible when
//   c < Sk  and  (!causal or d >= 0)
//   and (no window or d < window or (c < prefix_len and d >= 0)),
// the mask of src/repro/models/attention.py::_mask (prefix keys stay
// visible, causally, outside the window).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (grid (BH, nq, nk) with the KV axis sequential and the
// online-softmax state carried in VMEM scratch; GQA broadcast beforehand by
// repro/kernels/ops.py::flash_attention_gqa).
//
// Bound on the H100: operations. A causal prefill of S = 1024, D = 128
// does ~64 flops per byte it must move, far above the bytes line.
//
// Design (simple first; no wgmma, TMA or tensor cores yet): one CTA per
// (q-block of 64 rows, head, batch). Four threads share a query row; thread
// j of a row owns the dims 16*i + 4*j + {0..3}, so its slice of the scaled
// query row and of the f32 accumulator stays in registers and each of its
// shared-memory reads is one 16-byte load that the row's four threads make
// on 64 contiguous bytes. K and V tiles of 32 keys are staged in shared
// memory as f32. A thread's partial dot products are summed across the four
// threads with two xor-shuffles (the same bits on all four), so every
// thread holds the row's 32 scores and runs the softmax update itself:
//   m' = max(m, max s), p = exp(s - m'), l = l e^(m - m') + sum p,
//   acc = acc e^(m - m') + p V,     out = acc / max(l, 1e-30).
// Masked scores are -1e30 as in the reference, and a tile that no row of
// the block can see is skipped; that is exact for every row with a visible
// key (a row that sees no key at all has no defined output here, nor in
// the Pallas kernel, whose result depends on its block sizes).
//
// The query is scaled in its own dtype first (round(q * scale)), as
// attention.py::chunked_attention does; the Pallas kernel scales after the
// f32 cast. Everything after is f32 with expf and IEEE division, and the
// order of every sum is fixed, so a relaunch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per CTA
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 256
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
          int H, int KVH, int causal, int has_window, int window,
          int prefix_len, int q_offset, float scale) {
  constexpr int G4 = D / (4 * TPR);  // float4 groups per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvh = h / (H / KVH);
  const int r = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const int row = q0 + r;
  const bool live = row < Sq;
  const int64_t qs = (int64_t)H * D;     // stride between positions
  const int64_t kvs = (int64_t)KVH * D;
  const T* kb = k + (int64_t)b * Sk * kvs + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * Sk * kvs + (int64_t)kvh * D;
  const int64_t qrow = ((int64_t)b * Sq + row) * qs + (int64_t)h * D;

  float qr[4 * G4], acc[4 * G4];
#pragma unroll
  for (int g = 0; g < G4; ++g) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 16 * g + 4 * j + t;
      qr[4 * g + t] =
          live ? to_f(from_f<T>(to_f(q[qrow + d]) * scale)) : 0.f;
      acc[4 * g + t] = 0.f;
    }
  }
  float m = NEG, l = 0.f;
  const int pos = q_offset + row;
  const int p_lo = q_offset + q0;                          // block's rows
  const int p_hi = q_offset + (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;

  for (int c0 = 0; c0 < Sk; c0 += BK) {
    const int c1 = (c0 + BK < Sk ? c0 + BK : Sk) - 1;
    if (causal && c0 > p_hi) break;                 // every d < 0 from here
    if (has_window && c1 <= p_lo - window &&
        !(c0 < prefix_len && c0 <= p_hi))
      continue;                                     // all d >= window
    __syncthreads();                                // last tile's reads done
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const bool in = c0 + c < Sk;
      ks[c][d] = in ? to_f(kb[(int64_t)(c0 + c) * kvs + d]) : 0.f;
      vs[c][d] = in ? to_f(vb[(int64_t)(c0 + c) * kvs + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      float a = 0.f;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&ks[c][16 * g + 4 * j]);
        a = fmaf(qr[4 * g + 0], kv.x, a);
        a = fmaf(qr[4 * g + 1], kv.y, a);
        a = fmaf(qr[4 * g + 2], kv.z, a);
        a = fmaf(qr[4 * g + 3], kv.w, a);
      }
      s[c] = a;
    }
    float mt = m;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
      s[c] += __shfl_xor_sync(0xffffffffu, s[c], 2);
      const int col = c0 + c, d = pos - col;
      bool ok = col < Sk;
      if (causal) ok = ok && d >= 0;
      if (has_window)
        ok = ok && (d < window || (col < prefix_len && d >= 0));
      s[c] = ok ? s[c] : NEG;
      mt = fmaxf(mt, s[c]);
    }
    const float corr = expf(m - mt);
    float ps = 0.f;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      s[c] = expf(s[c] - mt);
      ps += s[c];
    }
    l = l * corr + ps;
    m = mt;
#pragma unroll
    for (int i = 0; i < 4 * G4; ++i) acc[i] *= corr;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[c][16 * g + 4 * j]);
        acc[4 * g + 0] = fmaf(s[c], vv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(s[c], vv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(s[c], vv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(s[c], vv.w, acc[4 * g + 3]);
      }
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int g = 0; g < G4; ++g) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 16 * g + 4 * j + t;
      out[qrow + d] = from_f<T>(acc[4 * g + t] / den);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KVH, int D, int causal,
                   int has_window, int window, int prefix_len, int q_offset,
                   float scale, cudaStream_t s) {
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
#define PIPIT_FLASH(DIM)                                                     \
  flash_fwd<T, DIM><<<grid, THREADS, 0, s>>>(                                \
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, KVH,        \
      causal, has_window, window, prefix_len, q_offset, scale)
  switch (D) {
    case 16: PIPIT_FLASH(16); break;
    case 32: PIPIT_FLASH(32); break;
    case 64: PIPIT_FLASH(64); break;
    case 128: PIPIT_FLASH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef PIPIT_FLASH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Sq, Sk >= 1; H % KVH == 0; D in
// {16, 32, 64, 128} (the wrapper checks all of it).
extern "C" int pipit_flash_attention(int device, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KVH, int D, int dtype,
                                     int causal, int has_window, int window,
                                     int prefix_len, int q_offset,
                                     float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KVH, D, causal,
                                has_window, window, prefix_len, q_offset,
                                scale, s);
  else
    err = launch<float>(q, k, v, out, B, Sq, Sk, H, KVH, D, causal,
                        has_window, window, prefix_len, q_offset, scale, s);
  return (int)err;
}
