// flash_attention_bwd: the gradient of flash attention in the GQA layout.
// q, o, dO [B, Sq, H, D], k/v [B, Sk, KVH, D] (bf16 or f32) and the f32
// row log-sum-exp lse [B, H, Sq] that the forward kernel wrote -> dq
// [B, Sq, H, D], dk / dv [B, Sk, KVH, D] in the input dtype. The mask and
// the tiles skipped are the forward's: both include flash_mask.cuh.
//
// Replaces no TPU kernel: the TPU kernel src/repro/kernels/flash_attention.py
// ::flash_attention is forward-only, and the reference trains by JAX
// autodiff through the plain chunked scan (src/repro/models/attention.py::
// chunked_attention). This is that gradient for the port's forward kernel,
// so a training step on the card never leaves the hand-written kernels.
//
// With qq = round(q * scale) in the input dtype (the forward's query), every
// visible pair (row i of head h, key c of its KV head h / G) has
//   P  = exp(qq_i . k_c - lse_i)             (masked pairs: P = 0)
//   dP = dO_i . v_c,   Delta_i = sum_d dO_i[d] O_i[d],   dS = P (dP - Delta_i)
//   dv_c += P dO_i,    dk_c += dS qq_i,    dq_i += scale dS k_c
// all in f32 (no TF32: SIMT FMAs), summed over the G query heads of a KV
// head for dk and dv.
//
// Bound on the H100: at the training shape (q/k/v [16, 256, 12, 64] bf16,
// causal) it must read q, k, v, o, dO and lse and write dq, dk, dv (50.5
// MB, 0.0151 ms at 3.35 TB/s) and do the five products of the recompute
// and the gradient, 2 flops a MAC over the visible pairs (about 4.1 GFLOP:
// 0.004 ms at 989 TFLOP/s on the tensor cores). This first kernel runs off
// the tensor cores (67 TFLOP/s in f32: 0.06 ms), so the operations bound
// it; a tensor-core redesign is later work.
//
// Three launches, no atomics:
//   bwd_delta  four threads a (row, head): Delta in a fixed order (each
//              thread's dims, then two xor-shuffles), into f32 scratch
//              [B, H, Sq];
//   bwd_dkdv   one CTA per (64 keys, KV head, batch), four threads a key:
//              a thread keeps its quarter of k_c and v_c and of the dk / dv
//              sums in registers and walks the G query heads, then the
//              32-row query tiles that can see its key block (scaled q,
//              dO, lse and Delta staged in shared memory as f32); the two
//              dot products of a pair are summed over the four threads by
//              xor-shuffles, so each thread holds P and dS;
//   bwd_dq     one CTA per (64 query rows, head, batch), four threads a row,
//              the forward SIMT kernel's shape: 32-key K / V tiles in
//              shared memory, the tiles no row can see skipped.
// Every sum has one order, so a relaunch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace {

constexpr int TPR = 4;               // threads per row (or key)
constexpr int BQ = 64;               // query rows per dq CTA
constexpr int BK = 32;               // keys per shared-memory tile (dq)
constexpr int BKC = 64;              // keys per dk / dv CTA
constexpr int BQT = 32;              // query rows per shared tile (dk / dv)
constexpr int THREADS = 256;         // BQ * TPR = BKC * TPR
constexpr int DELTA_THREADS = 256;

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

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, int B, int Sq, int H) {
  constexpr int G4 = D / (4 * TPR);
  const int64_t n = (int64_t)B * Sq * H;
  const int64_t e = ((int64_t)blockIdx.x * DELTA_THREADS + threadIdx.x) / TPR;
  const int j = threadIdx.x % TPR;
  const bool live = e < n;
  const int64_t base = (live ? e : 0) * D;          // [B, Sq, H] row e
  float a = 0.f;
#pragma unroll
  for (int g = 0; g < G4; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 16 * g + 4 * j + t;
      a = fmaf(to_f(dout[base + d]), to_f(o[base + d]), a);
    }
  a = quad_sum(a);
  if (!live || j != 0) return;
  const int h = (int)(e % H), i = (int)((e / H) % Sq), b = (int)(e / H / Sq);
  delta[((int64_t)b * H + h) * Sq + i] = a;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
         int KVH, int causal, int has_window, int window, int prefix_len,
         int q_offset, float scale) {
  constexpr int G4 = D / (4 * TPR);
  constexpr int NR = 4 * G4;           // dims a thread owns
  __shared__ __align__(16) float qs[BQT][D];
  __shared__ __align__(16) float dos[BQT][D];
  __shared__ float ls[BQT], dl[BQT];

  const int b = blockIdx.z, kvh = blockIdx.y, c0 = blockIdx.x * BKC;
  const int G = H / KVH;
  const int r = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const int col = c0 + r;
  const bool live = col < Sk;
  const int c1 = (c0 + BKC < Sk ? c0 + BKC : Sk) - 1;
  const int64_t kvs = (int64_t)KVH * D, qstr = (int64_t)H * D;
  const int64_t krow = ((int64_t)b * Sk + col) * kvs + (int64_t)kvh * D;

  float kr[NR], vr[NR], dka[NR], dva[NR];
#pragma unroll
  for (int g = 0; g < G4; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 16 * g + 4 * j + t;
      kr[4 * g + t] = live ? to_f(k[krow + d]) : 0.f;
      vr[4 * g + t] = live ? to_f(v[krow + d]) : 0.f;
      dka[4 * g + t] = 0.f;
      dva[4 * g + t] = 0.f;
    }

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* lse_h = lse + ((int64_t)b * H + h) * Sq;
    const float* del_h = delta + ((int64_t)b * H + h) * Sq;
    for (int i0 = 0; i0 < Sq; i0 += BQT) {
      const int p_lo = q_offset + i0;
      const int p_hi = q_offset + (i0 + BQT < Sq ? i0 + BQT : Sq) - 1;
      if (past_causal(c0, p_hi, causal) ||
          past_window(p_lo, p_hi, c0, c1, has_window, window, prefix_len))
        continue;
      __syncthreads();                              // last tile's reads done
      for (int e = threadIdx.x; e < BQT * D; e += THREADS) {
        const int rr = e / D, d = e % D;
        const bool in = i0 + rr < Sq;
        const int64_t at = ((int64_t)b * Sq + i0 + rr) * qstr +
                           (int64_t)h * D + d;
        qs[rr][d] = in ? to_f(from_f<T>(to_f(q[at]) * scale)) : 0.f;
        dos[rr][d] = in ? to_f(dout[at]) : 0.f;
      }
      if (threadIdx.x < BQT) {
        const bool in = i0 + threadIdx.x < Sq;
        ls[threadIdx.x] = in ? lse_h[i0 + threadIdx.x] : 0.f;
        dl[threadIdx.x] = in ? del_h[i0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      const int rows = (i0 + BQT < Sq ? BQT : Sq - i0);
      for (int rr = 0; rr < rows; ++rr) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&qs[rr][16 * g + 4 * j]);
          const float4 dv4 =
              *reinterpret_cast<const float4*>(&dos[rr][16 * g + 4 * j]);
          s = fmaf(qv.x, kr[4 * g + 0], s);
          s = fmaf(qv.y, kr[4 * g + 1], s);
          s = fmaf(qv.z, kr[4 * g + 2], s);
          s = fmaf(qv.w, kr[4 * g + 3], s);
          dp = fmaf(dv4.x, vr[4 * g + 0], dp);
          dp = fmaf(dv4.y, vr[4 * g + 1], dp);
          dp = fmaf(dv4.z, vr[4 * g + 2], dp);
          dp = fmaf(dv4.w, vr[4 * g + 3], dp);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const bool ok = visible(p_lo + rr, col, Sk, causal, has_window,
                                window, prefix_len);
        const float p = ok ? expf(s - ls[rr]) : 0.f;
        const float dsv = p * (dp - dl[rr]);
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&qs[rr][16 * g + 4 * j]);
          const float4 dv4 =
              *reinterpret_cast<const float4*>(&dos[rr][16 * g + 4 * j]);
          dva[4 * g + 0] = fmaf(p, dv4.x, dva[4 * g + 0]);
          dva[4 * g + 1] = fmaf(p, dv4.y, dva[4 * g + 1]);
          dva[4 * g + 2] = fmaf(p, dv4.z, dva[4 * g + 2]);
          dva[4 * g + 3] = fmaf(p, dv4.w, dva[4 * g + 3]);
          dka[4 * g + 0] = fmaf(dsv, qv.x, dka[4 * g + 0]);
          dka[4 * g + 1] = fmaf(dsv, qv.y, dka[4 * g + 1]);
          dka[4 * g + 2] = fmaf(dsv, qv.z, dka[4 * g + 2]);
          dka[4 * g + 3] = fmaf(dsv, qv.w, dka[4 * g + 3]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int g = 0; g < G4; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 16 * g + 4 * j + t;
      dk[krow + d] = from_f<T>(dka[4 * g + t]);
      dv[krow + d] = from_f<T>(dva[4 * g + t]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int Sq, int Sk, int H, int KVH, int causal,
       int has_window, int window, int prefix_len, int q_offset,
       float scale) {
  constexpr int G4 = D / (4 * TPR);
  constexpr int NR = 4 * G4;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvh = h / (H / KVH);
  const int r = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const int row = q0 + r;
  const bool live = row < Sq;
  const int64_t kvs = (int64_t)KVH * D;
  const T* kb = k + (int64_t)b * Sk * kvs + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * Sk * kvs + (int64_t)kvh * D;
  const int64_t qrow = ((int64_t)b * Sq + (live ? row : 0)) * H * D +
                       (int64_t)h * D;
  const int64_t lrow = ((int64_t)b * H + h) * Sq + (live ? row : 0);
  const float lse_r = live ? lse[lrow] : 0.f;
  const float del_r = live ? delta[lrow] : 0.f;

  float qr[NR], dor[NR], acc[NR];
#pragma unroll
  for (int g = 0; g < G4; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 16 * g + 4 * j + t;
      qr[4 * g + t] = live ? to_f(from_f<T>(to_f(q[qrow + d]) * scale)) : 0.f;
      dor[4 * g + t] = live ? to_f(dout[qrow + d]) : 0.f;
      acc[4 * g + t] = 0.f;
    }
  const int pos = q_offset + row;
  const int p_lo = q_offset + q0;
  const int p_hi = q_offset + (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;

  for (int c0 = 0; c0 < Sk; c0 += BK) {
    const int c1 = (c0 + BK < Sk ? c0 + BK : Sk) - 1;
    if (past_causal(c0, p_hi, causal)) break;       // every d < 0 from here
    if (past_window(p_lo, p_hi, c0, c1, has_window, window, prefix_len))
      continue;                                     // all d >= window
    __syncthreads();                                // last tile's reads done
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const bool in = c0 + c < Sk;
      ks[c][d] = in ? to_f(kb[(int64_t)(c0 + c) * kvs + d]) : 0.f;
      vs[c][d] = in ? to_f(vb[(int64_t)(c0 + c) * kvs + d]) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&ks[c][16 * g + 4 * j]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[c][16 * g + 4 * j]);
        s = fmaf(qr[4 * g + 0], kv.x, s);
        s = fmaf(qr[4 * g + 1], kv.y, s);
        s = fmaf(qr[4 * g + 2], kv.z, s);
        s = fmaf(qr[4 * g + 3], kv.w, s);
        dp = fmaf(dor[4 * g + 0], vv.x, dp);
        dp = fmaf(dor[4 * g + 1], vv.y, dp);
        dp = fmaf(dor[4 * g + 2], vv.z, dp);
        dp = fmaf(dor[4 * g + 3], vv.w, dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const bool ok = live && visible(pos, c0 + c, Sk, causal, has_window,
                                      window, prefix_len);
      const float p = ok ? expf(s - lse_r) : 0.f;
      const float dsv = p * (dp - del_r);
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&ks[c][16 * g + 4 * j]);
        acc[4 * g + 0] = fmaf(dsv, kv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(dsv, kv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(dsv, kv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(dsv, kv.w, acc[4 * g + 3]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int g = 0; g < G4; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 16 * g + 4 * j + t;
      dq[qrow + d] = from_f<T>(acc[4 * g + t] * scale);
    }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     void* dq, void* dk, void* dv, float* delta, int B,
                     int Sq, int Sk, int H, int KVH, int causal,
                     int has_window, int window, int prefix_len, int q_offset,
                     float scale, cudaStream_t s) {
  const long long rows = (long long)B * Sq * H;
  const long long dblocks = (rows * TPR + DELTA_THREADS - 1) / DELTA_THREADS;
  if (dblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwd_delta<T, D><<<(unsigned)dblocks, DELTA_THREADS, 0, s>>>(
      (const T*)o, (const T*)dout, delta, B, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gkv((unsigned)((Sk + BKC - 1) / BKC), (unsigned)KVH, (unsigned)B);
  bwd_dkdv<T, D><<<gkv, THREADS, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Sq, Sk, H, KVH, causal, has_window, window, prefix_len,
      q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gq((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  bwd_dq<T, D><<<gq, THREADS, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Sq, Sk, H, KVH, causal, has_window, window, prefix_len,
      q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk,
                   void* dv, float* delta, int B, int Sq, int Sk, int H,
                   int KVH, int D, int causal, int has_window, int window,
                   int prefix_len, int q_offset, float scale,
                   cudaStream_t s) {
#define PIPIT_FLASH_BWD(DIM)                                                 \
  return launch_d<T, DIM>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq,   \
                          Sk, H, KVH, causal, has_window, window, prefix_len, \
                          q_offset, scale, s)
  switch (D) {
    case 16: PIPIT_FLASH_BWD(16);
    case 32: PIPIT_FLASH_BWD(32);
    case 64: PIPIT_FLASH_BWD(64);
    case 128: PIPIT_FLASH_BWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef PIPIT_FLASH_BWD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. delta: f32 scratch of B * H * Sq. Sq,
// Sk >= 1; H % KVH == 0; D in {16, 32, 64, 128}; every tensor contiguous
// (the wrapper checks all of it).
extern "C" int pipit_flash_attention_bwd(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int Sq, int Sk, int H, int KVH, int D, int dtype,
    int causal, int has_window, int window, int prefix_len, int q_offset,
    float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (B > 65535 || H > 65535 || KVH > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse, dq, dk,
                                dv, (float*)delta, B, Sq, Sk, H, KVH, D,
                                causal, has_window, window, prefix_len,
                                q_offset, scale, s);
  else
    err = launch<float>(q, k, v, o, dout, (const float*)lse, dq, dk, dv,
                        (float*)delta, B, Sq, Sk, H, KVH, D, causal,
                        has_window, window, prefix_len, q_offset, scale, s);
  return (int)err;
}
