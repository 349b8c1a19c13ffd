// flash_attention: blocked online-softmax attention in the GQA layout.
// q [B, Sq, H, D], k/v [B, Sk, KVH, D] (bf16 or f32) -> out [B, Sq, H, D] in
// q's dtype. Query head h reads KV head h / (H / KVH), so nothing is
// broadcast in memory. Row i sits at position q_offset + i and key c at c;
// which keys a row sees is the mask of flash_mask.cuh (causal, window,
// prefix, c < Sk), shared with the backward kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (grid (BH, nq, nk) with the KV axis sequential and the
// online-softmax state carried in VMEM scratch; GQA broadcast beforehand by
// repro/kernels/ops.py::flash_attention_gqa).
//
// Bound on the H100: at the serving shape (q/k/v [4, 872, 16, 128] bf16,
// causal) the 57 MB it must read and write take 0.017 ms at 3.35 TB/s and
// its 12.5 GFLOP of QK^T and PV 0.013 ms at 989 TFLOP/s on the tensor
// cores, so it sits near the ridge; off the tensor cores (67 TFLOP/s in
// f32) the operations bound it at 0.19 ms. At phi-3-vision's prefill
// (q/k/v [4, 1016, 32, 96] bf16, causal) the bytes bound it: 99.9 MB,
// 0.0298 ms, against 25.4 GFLOP, 0.0257 ms.
//
// Two kernels; the wrapper picks one by (dtype, D) alone
// (kernels/flash_attention.py::variant):
//
// flash_wgmma ("wgmma": bf16 at D = 64, 96 or 128) runs both products on
// the tensor cores. One CTA per (128 query rows, head, batch), heaviest
// causal q-blocks launched first; two consumer warpgroups of 64 rows each
// and one producer warp. The producer's lane 0 loads the query tile once
// and then each 128-key K and V tile into a ring of two stages with TMA
// (cp.async.bulk.tensor over the 3-D view [B, S, heads * D], boxes
// [1, 128, W] from column head * D, so GQA reads its KV head in place and a
// tail tile is zero-filled, never read from the next batch), swizzled,
// completion counted on mbarriers (full: one per stage for K and for V;
// empty: the eight consumer warps release a stage). A tile is D / W column
// blocks (hopper.cuh, Cols<D>): W = 64 under 128-byte swizzle at D = 64
// and 128; at D = 96 (phi-3-vision's) W = 32 under 64-byte swizzle, three
// blocks, rather than two 128-byte blocks with 32 columns of zeros: no
// padding to load or hold (120 KB of shared memory, not D = 128's 160 KB),
// and 96 columns are whole swizzle atoms of the MN-major V operand, which
// the N = 96 product reads (a 64-column atom would leave half of one).
// Each consumer
// warpgroup scales its query rows in shared memory once (round(q * scale)
// in bf16, then fence.proxy.async so wgmma sees the writes), and per tile:
//   S = Q K^T      wgmma m64n128k16, both operands from shared memory,
//                  K-major (D / 16 instructions: 6 at D = 96);
//   softmax        on the f32 accumulator fragments in registers: each
//                  thread holds two rows, row max and sum meet by two quad
//                  xor-shuffles; the mask is applied only on tiles that
//                  straddle Sk, the diagonal or the window edge;
//   O += P V       wgmma m64nDk16 (m64n96k16 at D = 96: O is 48 f32 a
//                  thread) with P as the register A operand (the f32
//                  fragments rounded to bf16 pairs: the accumulator layout
//                  of m64nN is the A-fragment layout of m64nDk16) and V from
//                  shared memory, MN-major (transposed B).
// The Hopper helpers (mbarriers, TMA loads, wgmma descriptors and
// products, tensor maps) are in hopper.cuh, shared with the backward's
// tensor-core kernels.
// BK = 128 at every D: one S shape (m64n128k16) and half the tile round
// trips of BK = 64; S and O at D = 128 take 64 + 64 accumulator registers,
// which fit the 168 a thread that 288 threads leave (ptxas spills 8 bytes,
// and 8 at D = 96). Shared memory: Q 32 KB + 2 x (K + V) 128 KB at D =
// 128, 24 + 96 KB at D = 96.
// P is rounded to bf16 before P V, as in every tensor-core flash kernel;
// l is summed from the f32 P. This is the one place it differs from the
// SIMT kernel and the reference, which keep P in f32 (within the bf16
// gate of 3e-2).
//
// flash_fwd ("simt": f32, and bf16 at D = 16 or 32; bf16 at any D by name,
// the tensor-core kernel's yardstick) is f32 FMAs off the tensor cores:
// one CTA per (64 query rows, head, batch). Four threads
// share a query row; thread j of a row owns the dims 16*i + 4*j + {0..3},
// so its slice of the scaled query row and of the f32 accumulator stays in
// registers and each of its shared-memory reads is one 16-byte load that
// the row's four threads make on 64 contiguous bytes. K and V tiles of 32
// keys are staged in shared memory as f32. A thread's partial dot products
// are summed across the four threads with two xor-shuffles (the same bits
// on all four), so every thread holds the row's 32 scores and runs the
// softmax update itself. f32 is held to 2e-5, which no tensor-core rounding
// meets. D = 96 is six such 16-dim groups.
//
// Both run  m' = max(m, max s), p = exp(s - m'), l = l e^(m - m') + sum p,
// acc = acc e^(m - m') + p V,  out = acc / max(l, 1e-30),  with masked
// scores at -1e30 as in the reference, and skip a tile that no row of the
// block can see (the causal break and the window skip, prefix keys kept);
// that is exact for every row with a visible key (a row that sees no key
// at all has no defined output here, nor in the Pallas kernel, whose result
// depends on its block sizes). The query is scaled in its own dtype first
// (round(q * scale)), as attention.py::chunked_attention does; the Pallas
// kernel scales after the f32 cast. Everything after is f32 with expf and
// IEEE division; no atomics, and the order of every sum is fixed, so a
// relaunch gives the same bits. Given an lse pointer (the training forward),
// both also write each row's log-sum-exp m + log(max(l, 1e-30)) in f32 for
// the backward kernel (csrc/flash_attention_bwd.cu); serving passes null,
// and flash_wgmma then runs an instantiation without that epilogue.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

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
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
          int causal, int has_window, int window, int prefix_len,
          int q_offset, float scale) {
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
      const bool ok = visible(pos, c0 + c, Sk, causal, has_window, window,
                              prefix_len);
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
  if (lse != nullptr && j == 0)
    lse[((int64_t)b * H + h) * Sq + row] = m + logf(den);
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
                   float* lse, int B, int Sq, int Sk, int H, int KVH, int D,
                   int causal, int has_window, int window, int prefix_len,
                   int q_offset, float scale, cudaStream_t s) {
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
#define PIPIT_FLASH(DIM)                                                     \
  flash_fwd<T, DIM><<<grid, THREADS, 0, s>>>(                                \
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, Sq, Sk, H, KVH,   \
      causal, has_window, window, prefix_len, q_offset, scale)
  switch (D) {
    case 16: PIPIT_FLASH(16); break;
    case 32: PIPIT_FLASH(32); break;
    case 64: PIPIT_FLASH(64); break;
    case 96: PIPIT_FLASH(96); break;
    case 128: PIPIT_FLASH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef PIPIT_FLASH
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_wgmma: the tensor-core kernel (bf16, D = 64, 96 or 128)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;              // query rows per CTA: 2 warpgroups x 64
constexpr int BK = 128;              // keys per K / V tile
constexpr int STAGES = 2;            // K / V ring depth
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = CONSUMER_WARPS * 32 + 32;   // + the producer warp
constexpr int NBARS = 1 + 3 * STAGES;
enum { LIVE, SKIP, STOP };

// Dynamic shared memory: [Q][K0][V0][K1][V1] then the mbarriers. A tile of
// R rows x D is Cols<D>::NB column blocks of [R][W] bf16, each swizzled by
// TMA (hopper.cuh); every block starts on 1024 bytes.
template <int D>
struct Layout {
  using C = Cols<D>;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * NBARS;  // + alignment
};

// The KV tiles a CTA whose rows sit at positions [p_lo, p_hi] walks, in the
// same order for the producer and the consumers (flash_fwd's skipping).
__device__ __forceinline__ int tile_state(int c0, int Sk, int causal,
                                          int has_window, int window,
                                          int prefix_len, int p_lo,
                                          int p_hi) {
  const int c1 = (c0 + BK < Sk ? c0 + BK : Sk) - 1;
  if (past_causal(c0, p_hi, causal)) return STOP; // every d < 0 from here
  if (past_window(p_lo, p_hi, c0, c1, has_window, window, prefix_len))
    return SKIP;                                    // all d >= window
  return LIVE;
}

// LSE: write each row's log-sum-exp to lse (the training forward); the
// serving instantiation compiles without that epilogue.
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int B,
            int Sq, int Sk, int H, int KVH, int causal, int has_window,
            int window, int prefix_len, int q_offset, float scale) {
  using L = Layout<D>;
  using C = Cols<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sq = smem_u32(base);
  const uint32_t skv = sq + L::Q_BYTES;   // stage s: K at skv + 2s KV_BYTES
  const uint32_t bars = sq + L::BAR_OFF;  // V right after its K
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  // heaviest causal q-blocks first: block index -> (q-block, head, batch)
  const int nq = (Sq + BQ - 1) / BQ, hb = H * B;
  const int qb = nq - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % H, b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / (H / KVH);
  const int q0 = qb * BQ;
  const int p_lo = q_offset + q0;
  const int p_hi = q_offset + (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMER_WARPS) {
    // ---- producer: lane 0 keeps the ring full ----
    if (lane != 0) return;
    mbar_expect_tx(q_full, L::Q_BYTES);
    for (int nb = 0; nb < C::NB; ++nb)
      tma_load(sq + nb * BQ * C::ROW, &tq, q_full, h * D + C::W * nb, q0, b);
    int i = 0;
    for (int c0 = 0; c0 < Sk; c0 += BK) {
      const int st = tile_state(c0, Sk, causal, has_window, window,
                                prefix_len, p_lo, p_hi);
      if (st == STOP) break;
      if (st == SKIP) continue;
      const int s = i % STAGES;
      mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // first pass: free
      const uint32_t ks = skv + 2 * s * L::KV_BYTES, vs = ks + L::KV_BYTES;
      mbar_expect_tx(k_full(s), L::KV_BYTES);
      for (int nb = 0; nb < C::NB; ++nb)
        tma_load(ks + nb * BK * C::ROW, &tk, k_full(s),
                 kvh * D + C::W * nb, c0, b);
      mbar_expect_tx(v_full(s), L::KV_BYTES);
      for (int nb = 0; nb < C::NB; ++nb)
        tma_load(vs + nb * BK * C::ROW, &tv, v_full(s),
                 kvh * D + C::W * nb, c0, b);
      ++i;
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64) ----
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int r0 = 16 * (warp % 4) + lane / 4;       // this thread's rows:
  const int col = 2 * (lane % 4);                  // r0, r0 + 8
  const int wg_lo = p_lo + 64 * wg;                // the warpgroup's rows
  const int wg_hi = (p_hi < wg_lo + 63 ? p_hi : wg_lo + 63);

  // scale the warpgroup's query rows in place: round(q * scale) in bf16
  mbar_wait(q_full, 0);
#pragma unroll
  for (int nb = 0; nb < C::NB; ++nb) {
    uint4* rows = reinterpret_cast<uint4*>(base + nb * BQ * C::ROW +
                                           wg * 64 * C::ROW);
#pragma unroll
    for (int e = t; e < 64 * C::ROW / 16; e += 128) {
      uint4 x = rows[e];
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(p[u]);
        p[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      rows[e] = x;
    }
  }
  // generic-proxy writes -> visible to wgmma (async proxy), then all 128
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

  float o[D / 2], s[64];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 64; ++e) s[e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  uint32_t p[32];
  const uint32_t qa = sq + wg * 64 * C::ROW;

  int i = 0;
  for (int c0 = 0; c0 < Sk; c0 += BK) {
    const int st = tile_state(c0, Sk, causal, has_window, window, prefix_len,
                              p_lo, p_hi);
    if (st == STOP) break;
    if (st == SKIP) continue;
    const int stage = i % STAGES;
    const uint32_t par = (i / STAGES) & 1;
    const uint32_t ks = skv + 2 * stage * L::KV_BYTES, vs = ks + L::KV_BYTES;

    // S = Q K^T: D / 16 steps of 16 dims, both operands K-major (kdesc)
    mbar_wait(k_full(stage), par);
    __syncwarp();
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, kdesc<D>(qa, BQ, kk), kdesc<D>(ks, BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // mask only a tile that some row of the warpgroup does not fully see;
    // accumulator element 4j + e sits at row r0 + 8 (e / 2), column
    // c0 + 8j + col + e % 2
    const bool full = c0 + BK <= Sk && (!causal || c0 + BK - 1 <= wg_lo) &&
                      (!has_window || wg_hi - c0 < window) && wg_lo <= wg_hi;
    if (!full) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!visible(wg_lo + r0 + 8 * (e >> 1), c0 + 8 * j + col + (e & 1),
                       Sk, causal, has_window, window, prefix_len))
            s[4 * j + e] = NEG;
        }
      }
    }

    // online softmax on the fragments; row r = r0 + 8 h2 holds elements
    // 4j + 2 h2 + {0, 1}, spread over the quad of lanes 4 (lane / 4) + [0, 4)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mt = m[h2];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mt = fmaxf(mt, fmaxf(s[4 * j + 2 * h2], s[4 * j + 2 * h2 + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float corr = expf(m[h2] - mt);
      m[h2] = mt;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float a = expf(s[4 * j + 2 * h2] - mt);
        const float c = expf(s[4 * j + 2 * h2 + 1] - mt);
        s[4 * j + 2 * h2] = a;
        s[4 * j + 2 * h2 + 1] = c;
        ps += a + c;
      }
      l[h2] = l[h2] * corr + ps;     // this thread's share of the row sum
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h2] *= corr;
        o[4 * j + 2 * h2 + 1] *= corr;
      }
    }
    // P as the A operand of k-step kk (keys 16 kk + [0, 16)): registers
    // (r0, col), (r0 + 8, col), (r0, col + 8), (r0 + 8, col + 8), each a
    // bf16 pair: the accumulator elements 8 kk + [0, 8) in order
#pragma unroll
    for (int e = 0; e < 32; ++e) p[e] = pack_bf16(s[2 * e], s[2 * e + 1]);

    // O += P V: BK / 16 steps of 16 keys = 16 rows of every column block;
    // V is MN-major (mndesc), N = D.
    mbar_wait(v_full(stage), par);
    __syncwarp();
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                  mndesc<D>(vs, BK, kk));
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));     // this warp is done with it
    ++i;
  }

  // out = acc / max(l, 1e-30), rows < Sq only
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float den = l[h2];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = q0 + 64 * wg + r0 + 8 * h2;
    if (row >= Sq) continue;
    if constexpr (LSE) {
      if ((lane & 3) == 0)
        lse[((int64_t)b * H + h) * Sq + row] = m[h2] + logf(den);
    }
    __nv_bfloat16* dst = out + (((int64_t)b * Sq + row) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h2] / den, o[4 * j + 2 * h2 + 1] / den);
  }
}

template <int D, bool LSE>
cudaError_t launch_lse(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int Sq, int Sk, int H,
                       int KVH, int causal, int has_window, int window,
                       int prefix_len, int q_offset, float scale,
                       cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  constexpr int W = Cols<D>::W;
  if (!tensor_map(&tq, q, B, Sq, H * D, BQ, W) ||
      !tensor_map(&tk, k, B, Sk, KVH * D, BK, W) ||
      !tensor_map(&tv, v, B, Sk, KVH * D, BK, W))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<D>::BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_wgmma<D, LSE><<<(unsigned)blocks, THREADS, Layout<D>::BYTES, s>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, B, Sq, Sk, H, KVH, causal,
      has_window, window, prefix_len, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int KVH,
                   int causal, int has_window, int window, int prefix_len,
                   int q_offset, float scale, cudaStream_t s) {
  return lse != nullptr
             ? launch_lse<D, true>(q, k, v, out, lse, B, Sq, Sk, H, KVH,
                                   causal, has_window, window, prefix_len,
                                   q_offset, scale, s)
             : launch_lse<D, false>(q, k, v, out, lse, B, Sq, Sk, H, KVH,
                                    causal, has_window, window, prefix_len,
                                    q_offset, scale, s);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; variant: 0 = flash_fwd (SIMT), 1 =
// flash_wgmma (tensor cores; bf16 at D = 64, 96 or 128 only, 16-byte
// aligned q, k, v). Sq, Sk >= 1; H % KVH == 0; D in {16, 32, 64, 96, 128} (the
// wrapper checks all of it). lse: null, or f32 [B, H, Sq] that receives
// each row's log-sum-exp m + log(max(l, 1e-30)) (the training forward saves
// it for csrc/flash_attention_bwd.cu; serving passes null and writes none).
extern "C" int pipit_flash_attention(int device, const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int Sq, int Sk, int H, int KVH,
                                     int D, int dtype, int variant,
                                     int causal, int has_window, int window,
                                     int prefix_len, int q_offset,
                                     float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D == 128)
      err = tc::launch<128>(q, k, v, out, (float*)lse, B, Sq, Sk, H, KVH,
                            causal, has_window, window, prefix_len, q_offset,
                            scale, s);
    else if (D == 96)
      err = tc::launch<96>(q, k, v, out, (float*)lse, B, Sq, Sk, H, KVH,
                           causal, has_window, window, prefix_len, q_offset,
                           scale, s);
    else if (D == 64)
      err = tc::launch<64>(q, k, v, out, (float*)lse, B, Sq, Sk, H, KVH,
                           causal, has_window, window, prefix_len, q_offset,
                           scale, s);
    else
      err = cudaErrorInvalidValue;
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, out, (float*)lse, B, Sq, Sk, H, KVH,
                                D, causal, has_window, window, prefix_len,
                                q_offset, scale, s);
  } else {
    err = launch<float>(q, k, v, out, (float*)lse, B, Sq, Sk, H, KVH, D,
                        causal, has_window, window, prefix_len, q_offset,
                        scale, s);
  }
  return (int)err;
}
