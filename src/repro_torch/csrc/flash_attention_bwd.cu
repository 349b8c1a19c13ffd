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
// summed over the G query heads of a KV head for dk and dv.
//
// Bound on the H100: at the training shape (q/k/v [16, 256, 12, 64] bf16,
// causal) it must read q, k, v, o, dO and lse and write dq, dk, dv (50.5
// MB, 0.0151 ms at 3.35 TB/s) and do the five products of the recompute
// and the gradient, 2 flops a MAC over the visible pairs (about 4.1 GFLOP:
// 0.004 ms at 989 TFLOP/s on the tensor cores), so the bytes bound it on
// the tensor cores; off them (67 TFLOP/s in f32) the operations would, at
// 0.06 ms. At phi-3-vision's training shape ([2, 1168, 32, 96] causal) the
// five products are 41.9 GFLOP (0.0424 ms) against 115 MB (0.0344 ms): the
// operations bound it.
//
// Two designs; the wrapper picks one by (dtype, D) alone
// (kernels/flash_attention.py::variant_bwd), as the forward does. Both are
// three launches: bwd_delta (four threads a (row, head): Delta in a fixed
// order, each thread's dims then two xor-shuffles, into f32 scratch
// [B, H, Sq]), then a dk / dv kernel and a dq kernel. No atomics: one CTA
// owns a key block over all G query heads of its KV head (dk, dv) or a
// query block (dq), and every sum has one order, so a relaunch gives the
// same bits.
//
// "wgmma" (bf16 at D = 64, 96 or 128): all products on the tensor cores.
// What held the SIMT design back, and what this one does about it:
//  - Its products were f32 FMAs on the CUDA cores (67 TFLOP/s, and bwd_dq
//    computed S and dP again): here each is a wgmma m64nNk16 with f32
//    accumulators (989 TFLOP/s). dq still recomputes S and dP (7 products
//    in all, about 5.6 GFLOP at the training shape, far under the byte
//    bound) rather than summing per-key-block partials: that would write
//    and read an f32 [Sk / 64, B, Sq, H, D] buffer, 50 MB at the training
//    shape, as much again as the bound's bytes, and one more launch.
//  - Four threads shared a key or a row, with two pairs of xor-shuffles a
//    pair and the exp, P and dS done four times: here the accumulator
//    fragments hold each score once, and a thread computes P and dS for its
//    own elements with no shuffle at all.
//  - Tiles were staged as f32 by scalar 2-byte loads between two
//    __syncthreads: here one producer warp loads column boxes with TMA
//    (cp.async.bulk.tensor over the 3-D view [B, S, heads * D], swizzled,
//    zero-filled past S, completion counted on mbarriers) into a ring of
//    two stages, so the next tile's copy overlaps this tile's products.
//    The boxes are the forward's (hopper.cuh, Cols<D>): 64 columns under
//    128-byte swizzle at D = 64 and 128; at D = 96 (phi-3-vision's) three
//    32-column boxes under 64-byte swizzle, so no column is padded or read
//    twice, S^T and dP^T take six k-steps and the N = 96 products (dV, dK,
//    dQ) one wgmma m64n96k16 each.
//  - Registers: 128 with a spill (D = 64), 188 (D = 96) and 234 (D = 128)
//    a thread of the SIMT dk / dv kernel. Here a consumer thread holds dK
//    and dV (D / 2 f32 each) and S^T and dP^T of one query tile (QT / 2
//    each, QT = 64 query rows at D = 64, 32 at D = 96 and 128). Each CTA is
//    one consumer warpgroup and one producer warp (160 threads), which
//    ptxas lets use up to 255 registers a thread: 168 (dk / dv) and 122
//    (dq) at D = 64, 168 and 141 at D = 96, 202 and 154 at D = 128, no
//    spill (PERF.md). At D = 96 a 64-row tile took 202 and ran the dk / dv
//    kernel 1.5x slower (0.3319 against 0.2171 ms at phi-3-vision's
//    training shape on an H100 at 700 W, the same bits): above 168 a CTA's
//    five warps hold more than half the SM's registers, so two CTAs no
//    longer share it. Two consumer warpgroups a CTA
//    cap a thread at 168 (ptxas counts 288 threads as three warpgroups):
//    the dk / dv kernel at D = 128 then spilled 388 bytes and serialized
//    its wgmma, and at D = 64 both kernels ran slower than with one
//    (0.0900-0.1004 against 0.0761 ms of device time a backward at the
//    training shape on an H100 at 700 W), since one warpgroup lets two
//    CTAs share an SM.
// bwd_dkdv_wgmma: one CTA per (64 keys, KV head, batch), lowest key blocks
//   (the most causal rows) first. The producer's lane 0 loads the K and V
//   block once, then for each query head of the group and each QT-row
//   query tile that can see the block (flash_mask.cuh's skips) the Q and
//   dO tiles, while its 32 lanes copy the tile's lse and Delta into the
//   stage. Per tile the consumer warpgroup first scales the Q tile in
//   place (round(q * scale) in bf16, then fence.proxy.async and a named
//   barrier), then, with keys as the M dimension:
//     S^T = K qq^T, dP^T = V dO^T  wgmma, both operands from shared memory,
//                                  K-major (the forward's S = Q K^T);
//     P^T, dS^T                    on the f32 fragments in registers, the
//                                  mask only on tiles some pair of the
//                                  warpgroup does not see;
//     dV += P^T dO, dK += dS^T qq  wgmma with P^T and dS^T rounded to bf16
//                                  pairs as the register A operand (the
//                                  m64nN accumulator layout is the A layout
//                                  of m64nDk16) and dO or qq from shared
//                                  memory, MN-major (the forward's O += P V).
//   dK and dV stay in f32 registers over all tiles and are written once.
// bwd_dq_wgmma: one CTA per (64 query rows, head, batch), heaviest causal
//   blocks first, the forward's walk: Q and dO loaded once, Q scaled in
//   place, then per 64-key K / V tile S = qq K^T and dP = dO V^T
//   (shared-memory wgmma), P and dS in registers (a thread's two rows' lse
//   and Delta in registers too), dQ += dS K (register A, K MN-major); dQ is
//   scaled once and written once.
// P and dS are rounded to bf16 before the three gradient products, as in
// every tensor-core flash backward; dS is formed from the f32 P. That is
// where it differs from the SIMT kernel and the plain version (within the
// bf16 gate, 3e-2 x each gradient's largest magnitude).
//
// "simt" (f32, and bf16 at D = 16 or 32; bf16 at every D by name, the
// yardstick of the tensor-core kernels): f32 FMAs, P and dS in f32:
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
// f32 is held to 2e-5, which no tensor-core rounding meets.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

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
    case 96: PIPIT_FLASH_BWD(96);
    case 128: PIPIT_FLASH_BWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef PIPIT_FLASH_BWD
}


// ---------------------------------------------------------------------------
// the tensor-core kernels (bf16, D = 64, 96 or 128)
// ---------------------------------------------------------------------------
namespace tc {

// One consumer warpgroup and one producer warp a CTA. ptxas gives a thread
// of a wgmma kernel at most 65,536 registers over the CTA's threads rounded
// up to whole warpgroups: 255 here, 168 with two consumer warpgroups (288
// threads count as 384), where the dk / dv kernel at D = 128 spilled and
// serialized its wgmma. One warpgroup also lets two CTAs share an SM.
constexpr int CONSUMER_WARPS = 4;
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int THREADS = CONSUMERS + 32;               // + the producer warp
constexpr int STAGES = 2;                             // ring depth
constexpr int KV_KEYS = 64;      // keys per dk / dv CTA
constexpr int DQ_ROWS = 64;      // query rows per dq CTA
constexpr int DQ_KEYS = 64;      // keys per K / V tile of the dq kernel
enum { LIVE, SKIP, STOP };

// query rows per streamed tile of the dk / dv kernel: a consumer thread
// holds dK and dV (D / 2 f32 each) and S^T and dP^T (QT / 2 each); 32
// rows keep D = 96 at 168 registers, two CTAs an SM (see the note above)
template <int D>
constexpr int QT = D == 64 ? 64 : 32;

// dk / dv kernel's dynamic shared memory: [K][V], then per stage [Q][dO],
// then per stage the tile's lse and Delta (f32), then the mbarriers.
template <int D>
struct KvLayout {
  static constexpr int KV_BYTES = KV_KEYS * D * 2;
  static constexpr int T_BYTES = QT<D> * D * 2;       // a Q or dO tile
  static constexpr int STAGE_OFF = 2 * KV_BYTES;
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int ROW_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 2 * QT<D> * 4;
  static constexpr int NBARS = 1 + 2 * STAGES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * NBARS;  // + alignment
};

// dq kernel's: [Q][dO], then per stage [K][V], then the mbarriers.
template <int D>
struct QLayout {
  static constexpr int Q_BYTES = DQ_ROWS * D * 2;
  static constexpr int KV_BYTES = DQ_KEYS * D * 2;
  static constexpr int STAGE_OFF = 2 * Q_BYTES;
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int NBARS = 1 + 2 * STAGES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * NBARS;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// the first barrier, then STAGES full and STAGES empty ones (each
// consumer warp releases a stage)
__device__ __forceinline__ void init_ring(uint32_t bars, int first_count,
                                          int full_count) {
  mbar_init(bars, first_count);
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(bars + 8 * (1 + s), full_count);
    mbar_init(bars + 8 * (1 + STAGES + s), CONSUMER_WARPS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// round(x * scale) in bf16 for the rows of shared memory [p, p + bytes),
// `threads` threads from thread t; then visible to wgmma (async proxy)
__device__ __forceinline__ void scale_rows(uint8_t* p, int bytes, float scale,
                                           int t, int threads) {
  uint4* rows = reinterpret_cast<uint4*>(p);
  for (int e = t; e < bytes / 16; e += threads) {
    uint4 x = rows[e];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      h[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    rows[e] = x;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Whether the query rows [i0, i0 + QT) (positions from q_offset + i0) see
// no key of [c0, c1]: the tile the dk / dv kernel skips, in one order for
// its producer and consumers.
__device__ __forceinline__ bool rows_blind(int i0, int rows, int Sq, int c0,
                                           int c1, int causal, int has_window,
                                           int window, int prefix_len,
                                           int q_offset) {
  const int p_lo = q_offset + i0;
  const int p_hi = q_offset + (i0 + rows < Sq ? i0 + rows : Sq) - 1;
  return past_causal(c0, p_hi, causal) ||
         past_window(p_lo, p_hi, c0, c1, has_window, window, prefix_len);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int B, int Sq, int Sk, int H, int KVH, int causal,
               int has_window, int window, int prefix_len, int q_offset,
               float scale) {
  using L = KvLayout<D>;
  using C = Cols<D>;
  constexpr int R = QT<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const uint32_t sk = smem_u32(base), sv = sk + L::KV_BYTES;
  auto sq = [&](int s) { return sk + L::STAGE_OFF + s * L::STAGE_BYTES; };
  float* rows = reinterpret_cast<float*>(base + L::ROW_OFF);  // lse, Delta
  const uint32_t bars = sk + L::BAR_OFF;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  // lowest key blocks first: block index -> (key block, KV head, batch)
  const int kb = KVH * B;
  const int c0 = (int)(blockIdx.x / kb) * KV_KEYS;
  const int kvh = (int)(blockIdx.x % kb) % KVH, b = (int)(blockIdx.x % kb) / KVH;
  const int c1 = (c0 + KV_KEYS < Sk ? c0 + KV_KEYS : Sk) - 1;
  const int G = H / KVH;

  if (threadIdx.x == 0) init_ring(bars, 1, 32);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMER_WARPS) {
    // ---- producer: lane 0 issues the copies, all 32 lanes the rows ----
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
      for (int nb = 0; nb < C::NB; ++nb) {
        tma_load(sk + nb * KV_KEYS * C::ROW, &tk, kv_full,
                 kvh * D + C::W * nb, c0, b);
        tma_load(sv + nb * KV_KEYS * C::ROW, &tv, kv_full,
                 kvh * D + C::W * nb, c0, b);
      }
    }
    int i = 0;
    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      const int64_t lrow = ((int64_t)b * H + h) * Sq;
      for (int i0 = 0; i0 < Sq; i0 += R) {
        if (rows_blind(i0, R, Sq, c0, c1, causal, has_window, window,
                       prefix_len, q_offset))
          continue;
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // first pass: free
        float* ls = rows + 2 * R * s;
        for (int r = lane; r < R; r += 32) {
          const bool in = i0 + r < Sq;
          ls[r] = in ? lse[lrow + i0 + r] : 0.f;
          ls[R + r] = in ? delta[lrow + i0 + r] : 0.f;
        }
        if (lane == 0) {                  // counts as lane 0's arrival
          mbar_expect_tx(full(s), L::STAGE_BYTES);
          for (int nb = 0; nb < C::NB; ++nb) {
            tma_load(sq(s) + nb * R * C::ROW, &tq, full(s),
                     h * D + C::W * nb, i0, b);
            tma_load(sq(s) + L::T_BYTES + nb * R * C::ROW, &tdo, full(s),
                     h * D + C::W * nb, i0, b);
          }
        } else {
          mbar_arrive(full(s));
        }
        ++i;
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns keys c0 + [0, 64) ----
  const int r0 = 16 * warp + lane / 4;             // this thread's keys:
  const int col = 2 * (lane % 4);                  // r0, r0 + 8

  float dka[D / 2], dva[D / 2], s[R / 2], dp[R / 2];
  uint32_t pp[R / 4], pd[R / 4];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dka[e] = dva[e] = 0.f;
#pragma unroll
  for (int e = 0; e < R / 2; ++e) s[e] = dp[e] = 0.f;
  mbar_wait(kv_full, 0);

  int i = 0;
  for (int gi = 0; gi < G; ++gi) {
    for (int i0 = 0; i0 < Sq; i0 += R) {
      if (rows_blind(i0, R, Sq, c0, c1, causal, has_window, window,
                     prefix_len, q_offset))
        continue;
      const int stage = i % STAGES;
      const uint32_t qs = sq(stage), dos = qs + L::T_BYTES;
      const float* ls = rows + 2 * R * stage;
      const float* dl = ls + R;
      mbar_wait(full(stage), (i / STAGES) & 1);
      // qq = round(q * scale), by the 128 threads in turn
      scale_rows(base + (qs - sk), L::T_BYTES, scale, threadIdx.x, CONSUMERS);
      asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
      __syncwarp();

      // S^T = K qq^T and dP^T = V dO^T: D / 16 steps each, one group
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<R>(s, kdesc<D>(sk, KV_KEYS, kk), kdesc<D>(qs, R, kk),
                    kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<R>(dp, kdesc<D>(sv, KV_KEYS, kk), kdesc<D>(dos, R, kk),
                    kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // element 4j + e sits at key c0 + r0 + 8 (e / 2) and query row
      // i0 + 8j + col + e % 2; the mask only where some pair is hidden
      const int p_lo = q_offset + i0;
      const bool all = c0 + KV_KEYS <= Sk && i0 + R <= Sq &&
                       (!causal || c0 + KV_KEYS - 1 <= p_lo) &&
                       (!has_window || p_lo + R - 1 - c0 < window);
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 8 * j + col + (e & 1);
          const bool ok =
              all || (i0 + n < Sq &&
                      visible(p_lo + n, c0 + r0 + 8 * (e >> 1), Sk, causal,
                              has_window, window, prefix_len));
          const float p = ok ? expf(s[4 * j + e] - ((e & 1) ? l2.y : l2.x))
                             : 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
          s[4 * j + e] = p;
        }
      }
#pragma unroll
      for (int e = 0; e < R / 4; ++e) {
        pp[e] = pack_bf16(s[2 * e], s[2 * e + 1]);
        pd[e] = pack_bf16(dp[2 * e], dp[2 * e + 1]);
      }

      // dV += P^T dO and dK += dS^T qq: R / 16 steps of 16 query rows each
      __syncwarp();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pp);
      fence_regs(pd);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        wgmma_rs<D>(dva, pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2],
                    pp[4 * kk + 3], mndesc<D>(dos, R, kk));
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        wgmma_rs<D>(dka, pd[4 * kk], pd[4 * kk + 1], pd[4 * kk + 2],
                    pd[4 * kk + 3], mndesc<D>(qs, R, kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pp);
      fence_regs(pd);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));   // this warp is done with it
      ++i;
    }
  }

  // dk, dv: keys < Sk only; element 4j + 2 h2 + {0, 1} at dims 8j + col
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = c0 + r0 + 8 * h2;
    if (key >= Sk) continue;
    const int64_t at = (((int64_t)b * Sk + key) * KVH + kvh) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * h2], dka[4 * j + 2 * h2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * h2], dva[4 * j + 2 * h2 + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int B, int Sq, int Sk, int H,
             int KVH, int causal, int has_window, int window, int prefix_len,
             int q_offset, float scale) {
  using L = QLayout<D>;
  using C = Cols<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const uint32_t sq = smem_u32(base), sdo = sq + L::Q_BYTES;
  auto skv = [&](int s) { return sq + L::STAGE_OFF + 2 * s * L::KV_BYTES; };
  const uint32_t bars = sq + L::BAR_OFF;           // V right after its K
  const uint32_t q_full = bars;
  auto kv_full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  // heaviest causal q-blocks first: block index -> (q-block, head, batch)
  const int nq = (Sq + DQ_ROWS - 1) / DQ_ROWS, hb = H * B;
  const int qb = nq - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % H, b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / (H / KVH);
  const int q0 = qb * DQ_ROWS;
  const int p_lo = q_offset + q0;
  const int p_hi = q_offset + (q0 + DQ_ROWS < Sq ? q0 + DQ_ROWS : Sq) - 1;
  // the KV tiles the block walks, in one order for producer and consumers
  auto state = [&](int c0) {
    const int c1 = (c0 + DQ_KEYS < Sk ? c0 + DQ_KEYS : Sk) - 1;
    if (past_causal(c0, p_hi, causal)) return STOP;
    if (past_window(p_lo, p_hi, c0, c1, has_window, window, prefix_len))
      return SKIP;
    return LIVE;
  };

  if (threadIdx.x == 0) init_ring(bars, 1, 1);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMER_WARPS) {
    // ---- producer: lane 0 keeps the ring full ----
    if (lane != 0) return;
    mbar_expect_tx(q_full, 2 * L::Q_BYTES);
    for (int nb = 0; nb < C::NB; ++nb) {
      tma_load(sq + nb * DQ_ROWS * C::ROW, &tq, q_full, h * D + C::W * nb,
               q0, b);
      tma_load(sdo + nb * DQ_ROWS * C::ROW, &tdo, q_full,
               h * D + C::W * nb, q0, b);
    }
    int i = 0;
    for (int c0 = 0; c0 < Sk; c0 += DQ_KEYS) {
      const int st = state(c0);
      if (st == STOP) break;
      if (st == SKIP) continue;
      const int s = i % STAGES;
      mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
      const uint32_t ks = skv(s), vs = ks + L::KV_BYTES;
      mbar_expect_tx(kv_full(s), 2 * L::KV_BYTES);
      for (int nb = 0; nb < C::NB; ++nb) {
        tma_load(ks + nb * DQ_KEYS * C::ROW, &tk, kv_full(s),
                 kvh * D + C::W * nb, c0, b);
        tma_load(vs + nb * DQ_KEYS * C::ROW, &tv, kv_full(s),
                 kvh * D + C::W * nb, c0, b);
      }
      ++i;
    }
    return;
  }

  // ---- consumers: the warpgroup owns query rows q0 + [0, 64) ----
  const int r0 = 16 * warp + lane / 4;             // this thread's rows:
  const int col = 2 * (lane % 4);                  // r0, r0 + 8
  const bool rows_in = q0 + DQ_ROWS <= Sq;         // all 64 rows < Sq

  float lr[2], dr[2];                               // lse and Delta by row
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + r0 + 8 * h2;
    const int64_t at = ((int64_t)b * H + h) * Sq + row;
    lr[h2] = row < Sq ? lse[at] : 0.f;
    dr[h2] = row < Sq ? delta[at] : 0.f;
  }

  // scale the query rows in place: round(q * scale) in bf16
  mbar_wait(q_full, 0);
  scale_rows(base, L::Q_BYTES, scale, threadIdx.x, CONSUMERS);
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

  float acc[D / 2], s[DQ_KEYS / 2], dp[DQ_KEYS / 2];
  uint32_t pd[DQ_KEYS / 4];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < DQ_KEYS / 2; ++e) s[e] = dp[e] = 0.f;

  int i = 0;
  for (int c0 = 0; c0 < Sk; c0 += DQ_KEYS) {
    const int st = state(c0);
    if (st == STOP) break;
    if (st == SKIP) continue;
    const int stage = i % STAGES;
    const uint32_t ks = skv(stage), vs = ks + L::KV_BYTES;
    mbar_wait(kv_full(stage), (i / STAGES) & 1);
    __syncwarp();

    // S = qq K^T and dP = dO V^T: D / 16 steps each, one group
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DQ_KEYS>(s, kdesc<D>(sq, DQ_ROWS, kk),
                        kdesc<D>(ks, DQ_KEYS, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DQ_KEYS>(dp, kdesc<D>(sdo, DQ_ROWS, kk),
                        kdesc<D>(vs, DQ_KEYS, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // element 4j + e sits at row r0 + 8 (e / 2), key c0 + 8j + col + e % 2
    const bool all = rows_in && c0 + DQ_KEYS <= Sk &&
                     (!causal || c0 + DQ_KEYS - 1 <= p_lo) &&
                     (!has_window || p_hi - c0 < window);
#pragma unroll
    for (int j = 0; j < DQ_KEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1;
        const bool ok =
            all || (q0 + r0 + 8 * h2 < Sq &&
                    visible(p_lo + r0 + 8 * h2, c0 + 8 * j + col + (e & 1),
                            Sk, causal, has_window, window, prefix_len));
        const float p = ok ? expf(s[4 * j + e] - lr[h2]) : 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dr[h2]);
      }
    }
#pragma unroll
    for (int e = 0; e < DQ_KEYS / 4; ++e)
      pd[e] = pack_bf16(dp[2 * e], dp[2 * e + 1]);

    // dQ += dS K: DQ_KEYS / 16 steps of 16 keys; K MN-major
    __syncwarp();
    fence_regs(acc);
    fence_regs(pd);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_KEYS / 16; ++kk)
      wgmma_rs<D>(acc, pd[4 * kk], pd[4 * kk + 1], pd[4 * kk + 2],
                  pd[4 * kk + 3], mndesc<D>(ks, DQ_KEYS, kk));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(pd);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    ++i;
  }

  // dq = scale * acc, rows < Sq only
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + r0 + 8 * h2;
    if (row >= Sq) continue;
    __nv_bfloat16* dst = dq + (((int64_t)b * Sq + row) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h2] * scale, acc[4 * j + 2 * h2 + 1] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk,
                   void* dv, float* delta, int B, int Sq, int Sk, int H,
                   int KVH, int causal, int has_window, int window,
                   int prefix_len, int q_offset, float scale,
                   cudaStream_t s) {
  using KL = KvLayout<D>;
  using QL = QLayout<D>;
  // box rows: the dk / dv kernel's query tiles and key block, the dq
  // kernel's query block and key tiles
  constexpr int W = Cols<D>::W;
  CUtensorMap tq_t, tdo_t, tk_b, tv_b, tq_b, tdo_b, tk_t, tv_t;
  if (!tensor_map(&tq_t, q, B, Sq, H * D, QT<D>, W) ||
      !tensor_map(&tdo_t, dout, B, Sq, H * D, QT<D>, W) ||
      !tensor_map(&tk_b, k, B, Sk, KVH * D, KV_KEYS, W) ||
      !tensor_map(&tv_b, v, B, Sk, KVH * D, KV_KEYS, W) ||
      !tensor_map(&tq_b, q, B, Sq, H * D, DQ_ROWS, W) ||
      !tensor_map(&tdo_b, dout, B, Sq, H * D, DQ_ROWS, W) ||
      !tensor_map(&tk_t, k, B, Sk, KVH * D, DQ_KEYS, W) ||
      !tensor_map(&tv_t, v, B, Sk, KVH * D, DQ_KEYS, W))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KL::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QL::BYTES);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * Sq * H;
  const long long dblocks = (rows * TPR + DELTA_THREADS - 1) / DELTA_THREADS;
  const long long kv_blocks = (long long)((Sk + KV_KEYS - 1) / KV_KEYS) *
                              KVH * B;
  const long long q_blocks = (long long)((Sq + DQ_ROWS - 1) / DQ_ROWS) * H *
                             B;
  if (dblocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  bwd_delta<__nv_bfloat16, D><<<(unsigned)dblocks, DELTA_THREADS, 0, s>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, delta, B, Sq, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_wgmma<D><<<(unsigned)kv_blocks, THREADS, KL::BYTES, s>>>(
      tq_t, tdo_t, tk_b, tv_b, lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, B, Sq, Sk, H, KVH, causal, has_window, window,
      prefix_len, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma<D><<<(unsigned)q_blocks, THREADS, QL::BYTES, s>>>(
      tq_b, tdo_b, tk_t, tv_t, lse, delta, (__nv_bfloat16*)dq, B, Sq, Sk, H,
      KVH, causal, has_window, window, prefix_len, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; variant: 0 = the SIMT kernels, 1 = the
// tensor-core kernels (bf16 at D = 64, 96 or 128 only, 16-byte aligned q,
// k, v, dout). delta: f32 scratch of B * H * Sq. Sq, Sk >= 1; H % KVH == 0; D in
// {16, 32, 64, 96, 128}; every tensor contiguous (the wrapper checks all of
// it).
extern "C" int pipit_flash_attention_bwd(
    int device, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int Sq, int Sk, int H, int KVH, int D, int dtype,
    int variant, int causal, int has_window, int window, int prefix_len,
    int q_offset, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (B > 65535 || H > 65535 || KVH > 65535) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D == 128)
      err = tc::launch<128>(q, k, v, o, dout, (const float*)lse, dq, dk, dv,
                            (float*)delta, B, Sq, Sk, H, KVH, causal,
                            has_window, window, prefix_len, q_offset, scale,
                            s);
    else if (D == 96)
      err = tc::launch<96>(q, k, v, o, dout, (const float*)lse, dq, dk, dv,
                           (float*)delta, B, Sq, Sk, H, KVH, causal,
                           has_window, window, prefix_len, q_offset, scale,
                           s);
    else if (D == 64)
      err = tc::launch<64>(q, k, v, o, dout, (const float*)lse, dq, dk, dv,
                           (float*)delta, B, Sq, Sk, H, KVH, causal,
                           has_window, window, prefix_len, q_offset, scale,
                           s);
    else
      err = cudaErrorInvalidValue;
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse, dq, dk,
                                dv, (float*)delta, B, Sq, Sk, H, KVH, D,
                                causal, has_window, window, prefix_len,
                                q_offset, scale, s);
  } else {
    err = launch<float>(q, k, v, o, dout, (const float*)lse, dq, dk, dv,
                        (float*)delta, B, Sq, Sk, H, KVH, D, causal,
                        has_window, window, prefix_len, q_offset, scale, s);
  }
  return (int)err;
}
