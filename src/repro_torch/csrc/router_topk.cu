// router_topk: the MoE router in one launch. From x [T, d] bf16 and
// w [d, E] bf16 it writes logits [T, E] f32 = x @ w (each bf16 x bf16
// product exact in f32, accumulated in f32), idx [T, k] i32 (the k largest
// logits of each row, largest first, the lowest index on ties) and
// gates [T, k] f32 (the softmax over those k logits).
//
// Replaces the router of the reference's moe_ffn (src/repro/models/moe.py:
// the f32 einsum of the router product, then route_topk), whose top-k is the
// TPU kernel src/repro/kernels/topk_gating.py::topk_gating. The unfused route
// (einsum, then csrc/topk_gating.cu) stays for every other dtype and shape.
//
// Bound on the H100: memory. The product does 2 E flops per bf16 of x: at
// E = 60, 60 flops a byte, far below the bf16 tensor cores' ridge (~295), so
// on the tensor cores the kernel is bound by reading x once (14.3 MB at
// T = 3,488, d = 2,048: 4.3 us at 3.35 TB/s). The same product in f32 FMAs
// (67 TFLOP/s) would take ~13 us, three times that bound.
//
// Design: a CTA of 16 warps owns BM = 16 token rows, so prefill
// (T = 3,488) gives 218 CTAs, two on most of the 132 SMs. Four warps split
// the expert columns (padded to N_WARPS x NT x 8) and four K groups split
// each stage's k16 steps; each runs mma.sync.m16n8k16 (bf16 in, f32
// accumulators). x rows [16, 256] and w blocks [256, E] come in by TMA
// bulk copies through a two-stage ring paced by mbarriers: a block of 256
// rows of w is one contiguous, 16-byte aligned stretch whatever E is, so
// it is copied as it lies (it stays in L2, read by every CTA) and B
// fragments are assembled from 16-bit loads. One CTA alone cannot stream
// w fast enough for a decode step, so when a launch has at most
// SPLIT_TILES row tiles (T <= 256: decode, short prefills) a cluster of
// KSPLIT = 8 CTAs splits the depth of each tile instead. The partial tiles
// are added in a fixed order: K groups in group order, then the cluster's
// ranks in rank order through distributed shared memory. The epilogue
// writes the f32 logit rows, and runs the warp-per-row selection of
// csrc/topk_gating.cu's wide path on them in shared memory (same
// comparisons, same softmax order, so idx and gates equal topk_gating's on
// these logits, on either of its paths). No
// atomics: the result is bit-identical on relaunch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int BK = 256;       // depth of one pipeline stage (bf16 elements)
constexpr int STAGES = 2;     // TMA ring depth
constexpr int XS = BK + 8;    // staged x row stride: 528 bytes spread banks
constexpr int BM = 16;        // token rows of a tile: one m16 row block
constexpr int N_WARPS = 4;    // warps across the expert columns
constexpr int KG = 4;         // K groups: warps across each stage's depth
constexpr int WARPS = N_WARPS * KG;
constexpr int THREADS = WARPS * 32;
constexpr int KSPLIT = 8;     // CTAs of a cluster, one depth slice each,
constexpr int SPLIT_TILES = 16;  // when the launch has this few row tiles
constexpr int MAX_K = 8;
constexpr float NEG = -1e30f;

namespace cg = cooperative_groups;

// NT n8 column tiles per warp.
template <int NT>
struct Tile {
  static constexpr int NPAD = N_WARPS * NT * 8;           // columns covered
  // the ring, or the epilogue's tiles where larger; then the mbarriers
  __host__ __device__ static int bar_offset(int E) {
    const int ring = STAGES * (BM * XS + BK * E) * 2;
    const int epilogue = (KG * BM * NPAD + BM * (E + 1)) * 4;
    return ((ring > epilogue ? ring : epilogue) + 7) / 8 * 8;
  }
  __host__ __device__ static int smem_bytes(int E) {
    return bar_offset(E) + STAGES * 8;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Returns once the phase of parity `parity` has completed; a phase that
// never completes traps after 4 s, so a fault fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > 4000000000ull) __trap();
}
// One TMA bulk copy of `bytes` (a multiple of 16; both ends 16-byte
// aligned) from global memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The selection of csrc/topk_gating.cu's wide path (one warp a row) for one
// row held in shared memory, with k <= MAX_K a run-time bound: k rounds of
// a lane-strided scan (a column chosen earlier reads -1e30) and a shuffle
// argmax that breaks ties to the lower column; then the f32 softmax over
// the k, summed in selection order. Its narrow path gives the same bits, so
// idx and gates equal topk_gating's on either path.
__device__ __forceinline__ void select_row(const float* row, int E, int k,
                                           int lane, int32_t* idx,
                                           float* gates) {
  int chosen[MAX_K];
  float val[MAX_K];
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    chosen[r] = -1;
    val[r] = NEG;
    if (r >= k) continue;
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
  for (int r = 1; r < MAX_K; ++r)
    if (r < k) mx = fmaxf(mx, val[r]);
  float ev[MAX_K], sum = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r < k) {
      ev[r] = expf(val[r] - mx);
      sum += ev[r];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MAX_K; ++r) {
      if (r < k) {
        idx[r] = chosen[r];
        gates[r] = ev[r] / sum;
      }
    }
  }
}

// Warp w computes the columns of n group w % 4 and the k16 steps s of every
// stage with s % KG == w / 4; the K groups' partial tiles are added in group
// order in the epilogue.
template <int NT>
__global__ void __launch_bounds__(THREADS)
router_topk(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w, int64_t T, int d, int E,
            int k, float* __restrict__ logits, int32_t* __restrict__ idx,
            float* __restrict__ gates) {
  using Tl = Tile<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sx = reinterpret_cast<uint16_t*>(smem);      // [STAGES][BM][XS]
  uint16_t* sw = sx + STAGES * BM * XS;                   // [STAGES][BK * E]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int ng = warp % N_WARPS;
  const int kg = warp / N_WARPS;
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t m0 = (int64_t)(blockIdx.x / ks) * BM;
  const int rows = T - m0 < BM ? (int)(T - m0) : BM;
  // this rank's depth slice [kbeg, kend), a multiple of 16 wide
  const int dk = (d + ks * 16 - 1) / (ks * 16) * 16;
  const int kbeg = rank * dk < d ? rank * dk : d;
  const int kend = kbeg + dk < d ? kbeg + dk : d;
  const int nk = (kend - kbeg + BK - 1) / BK;
  const int wstage = BK * E;

  const uint32_t bars = smem_u32(smem + Tl::bar_offset(E));
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Stage kt, issued by warp 0 as TMA bulk copies: x[m0 + r, k0 : k0 + kb]
  // for each row r < rows (rows past T are left as they are: they feed
  // only accumulator rows that are never stored), and w[k0 : k0 + kb, :],
  // one contiguous block of kb * E bf16.
  auto load = [&](int kt) {
    const int slot = kt % STAGES;
    const int k0 = kbeg + kt * BK;
    const int kb = kend - k0 < BK ? kend - k0 : BK;
    const uint32_t bar = bars + 8 * slot;
    if (lane == 0) mbar_expect_tx(bar, (uint32_t)(rows + E) * kb * 2);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_load(smem_u32(sx + (slot * BM + r) * XS), x + (m0 + r) * d + k0,
                kb * 2, bar);
    if (lane == 0)
      bulk_load(smem_u32(sw + slot * wstage), w + (int64_t)k0 * E,
                kb * E * 2, bar);
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (warp == 0)
    for (int s = 0; s < STAGES - 1 && s < nk; ++s) load(s);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();                       // every warp is done with kt - 1
    if (warp == 0 && kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    const int slot = kt % STAGES;
    mbar_wait(bars + 8 * slot, (kt / STAGES) & 1);
    const int kb = kend - kbeg - kt * BK < BK ? kend - kbeg - kt * BK : BK;
    const uint16_t* xs = sx + (slot * BM + g) * XS + 2 * tig;
    const uint16_t* ws = sw + slot * wstage;
#pragma unroll
    for (int i = 0; i < BK / 16 / KG; ++i) {
      const int kk = (kg + i * KG) * 16;
      if (kk >= kb) break;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xs + kk);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xs + 8 * XS + kk);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xs + kk + 8);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(xs + 8 * XS + kk + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = (ng * NT + j) * 8 + g;
        uint32_t b0 = 0u, b1 = 0u;
        if (n < E) {
          const uint16_t* wk = ws + (kk + 2 * tig) * E + n;
          b0 = (uint32_t)wk[0] | ((uint32_t)wk[E] << 16);
          b1 = (uint32_t)wk[8 * E] | ((uint32_t)wk[9 * E] << 16);
        }
        mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
      }
    }
  }
  __syncthreads();                         // every warp is done with the ring

  // Epilogue: each K group's partial tile into shared memory, added in
  // group order into this CTA's partial over its depth slice. Then rank r
  // of the cluster adds the ranks' partials of its rows, in rank order,
  // into the f32 logit tile (rows of E + 1 floats), stores it, and one
  // warp per row selects its top k.
  float* part = reinterpret_cast<float*>(smem);          // [KG][BM][NPAD]
  float* slog = part + KG * BM * Tl::NPAD;            // [BM][E + 1]
  const int ls = E + 1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* p = part + (kg * BM + g) * Tl::NPAD + (ng * NT + j) * 8 + 2 * tig;
    p[0] = acc[j][0];
    p[1] = acc[j][1];
    p[8 * Tl::NPAD] = acc[j][2];
    p[8 * Tl::NPAD + 1] = acc[j][3];
  }
  __syncthreads();
  for (int i = tid; i < BM * Tl::NPAD; i += THREADS) {
    float v = part[i];
#pragma unroll
    for (int q = 1; q < KG; ++q) v += part[q * BM * Tl::NPAD + i];
    part[i] = v;
  }
  cluster.sync();                          // every rank's partial is ready
  const int per_rank = (BM + ks - 1) / ks;
  const int r0 = rank * per_rank;
  const int r1 = r0 + per_rank < rows ? r0 + per_rank : rows;
  for (int i = tid; i < (r1 - r0) * E; i += THREADS) {
    const int r = r0 + i / E, n = i % E;
    float v = 0.f;
    for (int q = 0; q < ks; ++q) {
      const float pv = cluster.map_shared_rank(part, q)[r * Tl::NPAD + n];
      v = q == 0 ? pv : v + pv;
    }
    slog[(r - r0) * ls + n] = v;
    logits[(m0 + r) * E + n] = v;
  }
  __syncthreads();
  for (int r = r0 + warp; r < r1; r += WARPS)
    select_row(slog + (r - r0) * ls, E, k, lane, idx + (m0 + r) * k,
               gates + (m0 + r) * k);
  cluster.sync();                          // keep `part` until all have read
}

template <int NT>
cudaError_t launch(const void* x, const void* w, int64_t T, int d, int E,
                   int k, void* logits, void* idx, void* gates, int device,
                   cudaStream_t s) {
  static int granted[MAX_DEVICES] = {};
  const int bytes = Tile<NT>::smem_bytes(E);
  cudaError_t err =
      allow_smem(router_topk<NT>, bytes, device, granted);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (T + BM - 1) / BM;
  const int ks = tiles <= SPLIT_TILES ? KSPLIT : 1;
  const int64_t blocks = tiles * ks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
  if (ks == 1) {
    router_topk<NT><<<(unsigned)blocks, THREADS, bytes, s>>>(
        xb, wb, T, d, E, k, (float*)logits, (int32_t*)idx, (float*)gates);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, router_topk<NT>, xb, wb, T, d, E, k,
                           (float*)logits, (int32_t*)idx, (float*)gates);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [T, d] and w [d, E] bf16, 16-byte aligned; T >= 1, d % 16 == 0,
// 1 <= E <= 128, 1 <= k <= min(E, 8) (the wrapper checks all of it).
extern "C" int pipit_router_topk(int device, const void* x, const void* w,
                                 int64_t T, int d, int E, int k, void* logits,
                                 void* idx, void* gates, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1 || d < 16 || d % 16 || E < 1 || E > 128 || k < 1 || k > MAX_K ||
      k > E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 32)
    err = launch<1>(x, w, T, d, E, k, logits, idx, gates, device, s);
  else if (E <= 64)
    err = launch<2>(x, w, T, d, E, k, logits, idx, gates, device, s);
  else
    err = launch<4>(x, w, T, d, E, k, logits, idx, gates, device, s);
  return (int)err;
}
