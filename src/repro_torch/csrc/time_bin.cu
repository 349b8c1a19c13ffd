// time_bin: out[f, j] = sum over records with func f of
//   rate * max(0, min(end, hi_j) - max(start, lo_j)),
//   lo_j = t0 + bw * j, hi_j = lo_j + bw,
// for n_bins equal bins; funcs outside [0, n_funcs) contribute nothing.
// Coordinates come in bin units (the caller divides by the bin width), as
// the ns timestamps of a large trace exceed f32's exact range.
//
// Replaces the TPU kernel src/repro/kernels/time_bin.py::time_bin (the dense
// [BE, NB] overlap block lifted onto [F, NB] by a one-hot matmul).
//
// Bound on the H100: memory. A record is 16 bytes in and adds to the few
// bins its span overlaps: a handful of f32 operations per (record, bin)
// touched and no tensor-core work. At N = 4.7M that is 75 MB, 22 us at
// 3.35 TB/s. What holds the private path at about three times that is the
// work each record costs: its span, and the warp-level votes, shuffles and
// shared-memory atomics of its grouping and tree.
//
// On the private path every (record, bin) term is the plain version's
// (kernels/time_bin.py): lo_j and hi_j rounded as it rounds them (no fused
// multiply-add). The sorted path keeps the arithmetic of its first version
// (the compiler may fuse a term's multiply into its run's sum). On both a
// NaN coordinate gives NaN, as torch.minimum / maximum / clamp_min do
// (fminf / fmaxf would drop it), in its own func's row only: the
// reference's one-hot product spreads a NaN term over every row.
//
// Design: two paths, both deterministic (no float atomics; the summation
// order is fixed by N and the grid's size), picked by
// kernels/time_bin.py::path from (N, n_funcs * n_bins):
//
// - "private", up to PRIVATE_CELLS = 6,144 cells, with no sort:
//   private.cuh's per-warp copies of the n_funcs x n_bins grid, in CTAs of
//   at most TIME_WARPS warps over `tile` records (the wrapper's
//   PRIVATE_TILE, 4,096), several to an SM; four records a lane in 16-byte
//   loads of each array, the next step's in flight. A record's term is
//   other than 0 only on the bins [first, first + count) that span()
//   finds, so it adds there alone (a term of 0 adds nothing). The first
//   bin of the four records of a step goes through one grouping and tree
//   side by side: the lanes on one cell (func x bin) find each other and
//   add their terms in a fixed tree. Only where a vote says a record of
//   the step has more bins: the second bin of spans over at most
//   SHORT_BINS bins, a record at a time; then each record over more bins
//   (an outer call over the whole trace), or whose terms are all NaN or
//   undefined (a NaN coordinate, a rate that is not finite), in a loop of
//   the whole warp over its bins, 32 bins a turn, each lane the sole
//   writer of its bin, so no warp waits on one lane's long span.
// - "sorted", above that: the wrapper stably sorts the records by func on
//   the device; time_walk stages a chunk's keys, starts, ends and rates in
//   shared memory, each thread owns bins and walks the chunk in order,
//   writing each func run's per-bin sum into runs.cuh's partial slot
//   (chunk + func); the gather pass adds those in chunk order.
#include "launch.cuh"
#include "private.cuh"
#include "runs.cuh"

namespace {

constexpr int SHORT_BINS = 2;    // longer spans take the whole warp's loop
constexpr int TIME_WARPS = 8;    // warps of a private-path CTA, at most

// lo_j, rounded as the plain version's t0 + bw * arange(n_bins) is.
__device__ __forceinline__ float bin_lo(float t0, float bw, int j) {
  return __fadd_rn(t0, __fmul_rn(bw, (float)j));
}

// rate * max(0, min(e, hi) - max(s, lo)) as the plain version computes it,
// NaN coordinates included; hi, lo finite.
__device__ __forceinline__ float overlap(float s, float e, float r, float lo,
                                        float hi) {
  const float a = isnan(e) ? e : fminf(e, hi);
  const float b = isnan(s) ? s : fmaxf(s, lo);
  const float ov = __fsub_rn(a, b);
  return __fmul_rn(ov < 0.f ? 0.f : ov, r);   // keeps a NaN, as clamp_min
}

// The bins [first, first + count) where the record's term can be other
// than 0. With a finite rate and no NaN coordinate the term of bin j is
// positive exactly where e > s, hi_j > s, lo_j < e and hi_j > lo_j; lo_j
// and hi_j do not fall as j grows, so that is one run of bins. floor / ceil
// of the coordinates in bin units, clamped in float before the conversion
// to int, guess its ends, and two short walks make them exact for any t0
// and bw; with unit bins (t0 = 0, bw = 1, as the ops call it: lo_j = j and
// hi_j = j + 1 exactly) the guesses are exact and the walks are skipped.
// Otherwise (a NaN coordinate, or a rate of NaN or inf, where a term of 0
// overlap is NaN) every bin. tests/test_torch_private.py holds a plain
// mirror of this arithmetic against the dense form term by term.
__device__ __forceinline__ void span(float s, float e, float r, float t0,
                                     float bw, float inv_bw, bool unit,
                                     int n_bins, int& first, int& count) {
  first = 0;
  count = n_bins;
  if (isnan(s) || isnan(e) || !isfinite(r)) return;
  count = 0;
  if (!(e > s) || !(bw > 0.f)) return;
  const float top = (float)(n_bins - 1);
  int a = (int)fminf(fmaxf(floorf((s - t0) * inv_bw), 0.f), top);
  int b = (int)fminf(fmaxf(ceilf((e - t0) * inv_bw) - 1.f, 0.f), top);
  if (!unit) {
    while (a > 0 && __fadd_rn(bin_lo(t0, bw, a - 1), bw) > s) --a;
    while (a < n_bins && !(__fadd_rn(bin_lo(t0, bw, a), bw) > s)) ++a;
    while (b < n_bins - 1 && bin_lo(t0, bw, b + 1) < e) ++b;
    while (b >= 0 && !(bin_lo(t0, bw, b) < e)) --b;
  } else if (s >= (float)n_bins || e <= 0.f) {
    return;                          // past either end: the clamps miss it
  }
  first = a;
  count = b >= a ? b - a + 1 : 0;
}

// Four consecutive records from i (a multiple of 4): start, end, func (-1
// when ignored or at or past `end_i`) and rate; one 16-byte load an array
// when all four lie before `end_i`.
__device__ __forceinline__ void time_read4(
    const float* __restrict__ start, const float* __restrict__ end,
    const int32_t* __restrict__ func, const float* __restrict__ rate,
    int64_t i, int64_t end_i, int32_t n_funcs, float (&s)[4], float (&e)[4],
    int (&f)[4], float (&r)[4]) {
  if (i + 4 <= end_i) {
    const float4 vs = __ldcs(reinterpret_cast<const float4*>(start + i));
    const float4 ve = __ldcs(reinterpret_cast<const float4*>(end + i));
    const int4 vf = __ldcs(reinterpret_cast<const int4*>(func + i));
    const float4 vr = __ldcs(reinterpret_cast<const float4*>(rate + i));
    s[0] = vs.x; s[1] = vs.y; s[2] = vs.z; s[3] = vs.w;
    e[0] = ve.x; e[1] = ve.y; e[2] = ve.z; e[3] = ve.w;
    f[0] = vf.x; f[1] = vf.y; f[2] = vf.z; f[3] = vf.w;
    r[0] = vr.x; r[1] = vr.y; r[2] = vr.z; r[3] = vr.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i + j < end_i;
      s[j] = in ? start[i + j] : 0.f;
      e[j] = in ? end[i + j] : 0.f;
      f[j] = in ? func[i + j] : -1;
      r[j] = in ? rate[i + j] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (f[j] < 0 || f[j] >= n_funcs) f[j] = -1;
}

// One CTA per `tile` records, blockDim.x / 32 warps, each with its
// own copy of the [n_funcs][n_bins] grid. A CTA step covers warps x 128
// consecutive records, warp w the w-th 128, lane l records 4l..4l+3 of
// those; the next step's loads go out before this step is added.
template <bool MASKS>
__global__ void __launch_bounds__(TIME_WARPS * 32)
time_private(const float* __restrict__ start, const float* __restrict__ end,
             const int32_t* __restrict__ func,
             const float* __restrict__ rate, int64_t n, int32_t n_funcs,
             int32_t n_bins, float t0, float bw, float inv_bw, int32_t tile,
             float* __restrict__ partial) {
  extern __shared__ float sgrid[];  // [warps][n_cells], then [warps][4]
                                    // mask tables of n_cells words
  const int n_cells = n_funcs * n_bins;
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < (MASKS ? 5 : 1) * warps * n_cells;
       i += blockDim.x)
    sgrid[i] = 0.f;
  __syncthreads();
  float* mine = sgrid + warp * n_cells;
  unsigned* masks = reinterpret_cast<unsigned*>(sgrid + warps * n_cells) +
                    warp * 4 * n_cells;
  const int64_t begin = (int64_t)blockIdx.x * tile;
  const int64_t end_i = begin + tile < n ? begin + tile : n;
  const int64_t stride = (int64_t)warps * WARP_RECS;
  const bool unit = t0 == 0.f && bw == 1.f && n_bins <= (1 << 24);
  int64_t i = begin + warp * WARP_RECS + lane * 4;
  float s[4], e[4], r[4], ns[4], ne[4], nr[4];
  int f[4], nf[4];
  time_read4(start, end, func, rate, i, end_i, n_funcs, ns, ne, nf, nr);
  for (; i - lane * 4 < end_i; i += stride) {   // the same for every lane
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = ns[j];
      e[j] = ne[j];
      f[j] = nf[j];
      r[j] = nr[j];
    }
    time_read4(start, end, func, rate, i + stride, end_i, n_funcs, ns, ne,
               nf, nr);
    // The first bin of each record's span, the four records side by side.
    int key[4];
    float v[4][1];
    bool more = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int first, count;
      span(s[j], e[j], r[j], t0, bw, inv_bw, unit, n_bins, first, count);
      if (f[j] < 0) count = 0;
      const bool on = count >= 1 && count <= SHORT_BINS;
      key[j] = on ? f[j] * n_bins + first : -1;
      v[j][0] = 0.f;
      if (on) {
        const float lo = bin_lo(t0, bw, first);
        v[j][0] = overlap(s[j], e[j], r[j], lo, __fadd_rn(lo, bw));
      }
      more |= count > 1;
    }
    unsigned group[4];
    lane_groups<4, MASKS>(key, masks, n_cells, lane, group);
    group_sums(group, lane, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (group_first(group[j], lane) && key[j] >= 0) mine[key[j]] += v[j][0];
      __syncwarp();
    }
    if (!__any_sync(0xffffffffu, more)) continue;
    // Rarely: the other bins of the short spans, a record at a time, then
    // the long spans, each over the whole warp.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int first, count;
      span(s[j], e[j], r[j], t0, bw, inv_bw, unit, n_bins, first, count);
      if (f[j] < 0) count = 0;
      const bool few = count <= SHORT_BINS;
      for (int t = 1; __any_sync(0xffffffffu, few && t < count); ++t) {
        const bool on = few && t < count;
        const int cell[1] = {on ? f[j] * n_bins + first + t : -1};
        float w[1][1] = {{0.f}};
        if (on) {
          const float lo = bin_lo(t0, bw, first + t);
          w[0][0] = overlap(s[j], e[j], r[j], lo, __fadd_rn(lo, bw));
        }
        unsigned g[1];
        lane_groups<1, MASKS>(cell, masks, n_cells, lane, g);
        group_sums(g, lane, w);
        if (group_first(g[0], lane) && on) mine[cell[0]] += w[0][0];
        __syncwarp();
      }
      unsigned many = __ballot_sync(0xffffffffu, !few);
      while (many) {                  // the whole warp over one long span
        const int src = __ffs(many) - 1;
        many &= many - 1;
        const float ls = __shfl_sync(0xffffffffu, s[j], src);
        const float le = __shfl_sync(0xffffffffu, e[j], src);
        const float lr = __shfl_sync(0xffffffffu, r[j], src);
        const int lrow = __shfl_sync(0xffffffffu, f[j], src) * n_bins;
        const int lfirst = __shfl_sync(0xffffffffu, first, src);
        const int lcount = __shfl_sync(0xffffffffu, count, src);
        for (int b = lane; b < lcount; b += 32) {
          const float lo = bin_lo(t0, bw, lfirst + b);
          mine[lrow + lfirst + b] +=
              overlap(ls, le, lr, lo, __fadd_rn(lo, bw));
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  float* row = partial + (int64_t)blockIdx.x * n_cells;
  copies_to_row(sgrid, warps, n_cells, [&](int c, float v) { row[c] = v; });
}

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
    const float lo = t0 + bw * (float)j;
    const float hi = lo + bw;
    walk_column(sk, m, chunk, n_funcs, n_bins, j,
                [&](int i) {
                  const float a = isnan(se[i]) ? se[i] : fminf(se[i], hi);
                  const float b = isnan(ss[i]) ? ss[i] : fmaxf(ss[i], lo);
                  const float ov = a - b;
                  return (ov < 0.f ? 0.f : ov) * sr[i];
                },
                partial);
  }
}

}  // namespace

// start, end, func, rate 16-byte aligned; n >= 1; 1 <= n_funcs * n_bins <=
// PRIVATE_CELLS; t0, bw finite; `tile` records per CTA, a multiple of 4
// (the wrapper checks them).
extern "C" int pipit_time_bin_private(int device, const void* start,
                                      const void* end, const void* func,
                                      const void* rate, int64_t n,
                                      int n_funcs, int n_bins, float t0,
                                      float bw, int tile, void* partial,
                                      void* out, void* stream) {
  static int granted[MAX_DEVICES] = {}, granted_match[MAX_DEVICES] = {};
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int n_cells = n_funcs * n_bins;
  if (n < 1 || n_funcs < 1 || n_bins < 1 || n_cells > PRIVATE_CELLS ||
      tile < 4 || tile % 4)
    return (int)cudaErrorInvalidValue;
  const bool masks = use_masks(n_cells);
  err = masks ? allow_smem(time_private<true>, COPIES_BYTES, device, granted)
              : allow_smem(time_private<false>, COPIES_BYTES, device,
                           granted_match);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned ctas = private_ctas(n, tile);
  const int each = warp_bytes(n_cells, n_cells, 4);
  const int warps = private_warps(each, TIME_WARPS);
  const float inv_bw = bw > 0.f ? 1.f / bw : 0.f;
  if (masks)
    time_private<true><<<ctas, warps * 32, warps * each, s>>>(
        (const float*)start, (const float*)end, (const int32_t*)func,
        (const float*)rate, n, n_funcs, n_bins, t0, bw, inv_bw, tile,
        (float*)partial);
  else
    time_private<false><<<ctas, warps * 32, warps * each, s>>>(
        (const float*)start, (const float*)end, (const int32_t*)func,
        (const float*)rate, n, n_funcs, n_bins, t0, bw, inv_bw, tile,
        (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_private_sum((const float*)partial, (int64_t)ctas,
                                 n_cells, (float*)out, s);
}

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
