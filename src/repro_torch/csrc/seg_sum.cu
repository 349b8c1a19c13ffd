// seg_sum: out[code[i], :] += values[i, :] over N records; codes outside
// [0, n_seg) contribute nothing.
//
// Replaces the TPU kernel src/repro/kernels/seg_sum.py::seg_sum (one-hot
// matmul on the MXU, accumulated over a sequential grid).
//
// Bound on the H100: memory. Each record is a 4-byte code plus K 4-byte
// values and adds K floats; there is no tensor-core work. At N = 4.7M and
// K = 2 that is 56 MB, 17 us at 3.35 TB/s. What holds the private path at
// twice that is the warp-level votes and shuffles each record costs.
//
// Design: two paths, both deterministic (no float atomics; the summation
// order is fixed by N and the grid's size), picked by
// kernels/seg_sum.py::path from (N, n_seg * K):
//
// - "private", up to PRIVATE_CELLS = 6,144 cells (flat_profile's names x
//   metrics), with no sort: private.cuh's per-warp copies of the
//   n_seg x K grid, in CTAs of at most SEG_WARPS warps over `tile` records
//   (the wrapper's PRIVATE_TILE, 8,192), several to an SM, so that the
//   last of them end close together. A lane reads its four records' codes
//   in one 16-byte load and, at K = 1, 2, 4 or 8, their 4K values in K
//   more (other K read values one at a time), the next step's loads in
//   flight. The lanes on one code find each other once per record (by
//   votes on the code's bits up to 15 names, as flat_profile's 6), the
//   four records of a step side by side, and sum all K columns in one
//   tree. K above 8 is cut into groups of 8 columns, one CTA row of the
//   grid (blockIdx.y) for each, so a warp copy holds n_seg x 8 floats.
// - "sorted", above that: the wrapper stably sorts the codes on the
//   device; seg_walk stages a chunk's keys and its gathered values
//   (values[perm[i]]) in shared memory, one thread per column walks the
//   chunk (runs.cuh), and the gather pass adds the per-chunk run sums in
//   chunk order.
#include "launch.cuh"
#include "private.cuh"
#include "runs.cuh"

namespace {

constexpr int MAX_COLS = 8;  // columns staged per walk launch
constexpr int SEG_WARPS = 16;  // warps of a private-path CTA, at most

// Four consecutive records from i (a multiple of 4): code (-1 when ignored
// or at or past `end`) and the values of columns j0 .. j0 + kg (0 past
// kg). VEC: k == KG, so the four records' values are 4 KG consecutive
// floats, read in KG 16-byte loads.
template <int KG, bool VEC>
__device__ __forceinline__ void seg_read4(const int32_t* __restrict__ code,
                                          const float* __restrict__ values,
                                          int64_t i, int64_t end, int32_t k,
                                          int32_t j0, int32_t kg,
                                          int32_t n_seg, int (&key)[4],
                                          float (&v)[4][KG]) {
  if (i + 4 <= end) {
    const int4 c = __ldcs(reinterpret_cast<const int4*>(code + i));
    key[0] = c.x; key[1] = c.y; key[2] = c.z; key[3] = c.w;
    if (VEC) {
      const float4* src = reinterpret_cast<const float4*>(values + i * KG);
      float f[4 * KG];
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        const float4 x = __ldcs(src + q);
        f[4 * q] = x.x; f[4 * q + 1] = x.y; f[4 * q + 2] = x.z;
        f[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c2 = 0; c2 < KG; ++c2) v[r][c2] = f[r * KG + c2];
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c2 = 0; c2 < KG; ++c2)
          v[r][c2] = c2 < kg ? __ldcs(values + (i + r) * k + j0 + c2) : 0.f;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool in = i + r < end;
      key[r] = in ? code[i + r] : -1;
#pragma unroll
      for (int c2 = 0; c2 < KG; ++c2)
        v[r][c2] = in && c2 < kg ? values[(i + r) * k + j0 + c2] : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (key[r] < 0 || key[r] >= n_seg) key[r] = -1;
}

// One CTA per (`tile` records, group of KG columns), blockDim.x / 32
// warps, each with its own [n_seg][KG] copy of the group's grid. A CTA
// step covers warps x 128 consecutive records, warp w the w-th 128, lane l
// records 4l..4l+3 of those; the next step's loads go out before this
// step is added. The CTA's row of partials is [n_seg][k]; its group's
// columns are j0 .. j0 + kg.
template <int KG, bool VEC, bool MASKS>
__global__ void __launch_bounds__(SEG_WARPS * 32)
seg_private(const int32_t* __restrict__ code,
            const float* __restrict__ values, int64_t n, int32_t k,
            int32_t n_seg, int32_t tile, int32_t bits,
            float* __restrict__ partial) {
  extern __shared__ float sgrid[];  // [warps][n_seg][KG], then [warps][4]
                                    // mask tables of n_seg words
  const int n_cells = n_seg * KG;
  const int j0 = blockIdx.y * KG;
  const int kg = k - j0 < KG ? k - j0 : KG;
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < warps * (n_cells + (MASKS ? 4 * n_seg : 0));
       i += blockDim.x)
    sgrid[i] = 0.f;
  __syncthreads();
  float* mine = sgrid + warp * n_cells;
  unsigned* masks = reinterpret_cast<unsigned*>(sgrid + warps * n_cells) +
                    warp * 4 * n_seg;
  const int64_t begin = (int64_t)blockIdx.x * tile;
  const int64_t end = begin + tile < n ? begin + tile : n;
  const int64_t stride = (int64_t)warps * WARP_RECS;
  int64_t i = begin + warp * WARP_RECS + lane * 4;
  int key[4], next_key[4];
  float v[4][KG], next_v[4][KG];
  seg_read4<KG, VEC>(code, values, i, end, k, j0, kg, n_seg, next_key,
                     next_v);
  for (; i - lane * 4 < end; i += stride) {   // the same for every lane
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      key[r] = next_key[r];
#pragma unroll
      for (int c = 0; c < KG; ++c) v[r][c] = next_v[r][c];
    }
    seg_read4<KG, VEC>(code, values, i + stride, end, k, j0, kg, n_seg,
                       next_key, next_v);
    unsigned group[4];
    if (bits)
      ballot_groups(key, bits, group);
    else
      lane_groups<4, MASKS>(key, masks, n_seg, lane, group);
    group_sums(group, lane, v);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (group_first(group[r], lane) && key[r] >= 0) {
#pragma unroll
        for (int c = 0; c < KG; ++c) mine[key[r] * KG + c] += v[r][c];
      }
      __syncwarp();
    }
  }
  __syncthreads();
  float* row = partial + (int64_t)blockIdx.x * n_seg * k + j0;
  copies_to_row(sgrid, warps, n_cells, [&](int cell, float sum) {
    const int seg = cell / KG, c = cell % KG;
    if (c < kg) row[(int64_t)seg * k + c] = sum;
  });
}

// Launch seg_private at KG columns a group over ceil(k / KG) groups, and
// the pass that adds the CTA rows.
template <int KG, bool VEC>
cudaError_t launch_seg_private(int device, const int32_t* code,
                               const float* values, int64_t n, int k,
                               int n_seg, int tile, float* partial,
                               float* out, cudaStream_t s) {
  static int granted[MAX_DEVICES] = {}, granted_match[MAX_DEVICES] = {};
  const int bits = ballot_bits(n_seg);
  const bool masks = !bits && use_masks(n_seg);
  cudaError_t err =
      masks ? allow_smem(seg_private<KG, VEC, true>, COPIES_BYTES, device,
                         granted)
            : allow_smem(seg_private<KG, VEC, false>, COPIES_BYTES, device,
                         granted_match);
  if (err != cudaSuccess) return err;
  const unsigned ctas = private_ctas(n, tile);
  const int each = warp_bytes(n_seg * KG, n_seg, masks ? 4 : 0);
  const int warps = private_warps(each, SEG_WARPS);
  const dim3 grid(ctas, (unsigned)((k + KG - 1) / KG));
  if (masks)
    seg_private<KG, VEC, true><<<grid, warps * 32, warps * each, s>>>(
        code, values, n, k, n_seg, tile, bits, partial);
  else
    seg_private<KG, VEC, false><<<grid, warps * 32, warps * each, s>>>(
        code, values, n, k, n_seg, tile, bits, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_private_sum(partial, (int64_t)ctas, n_seg * k, out, s);
}

__global__ void seg_walk(const int32_t* __restrict__ skeys,
                         const int64_t* __restrict__ perm,
                         const float* __restrict__ values, int64_t n,
                         int32_t k, int32_t j0, int32_t kg, int32_t n_seg,
                         float* __restrict__ partial) {
  __shared__ int32_t sk[CHUNK];
  __shared__ float sv[CHUNK * MAX_COLS];
  int64_t chunk = blockIdx.x;
  int64_t base = chunk * CHUNK;
  int m = chunk_len(n, base);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sk[i] = skeys[base + i];
    int64_t r = perm[base + i];
    for (int j = 0; j < kg; ++j) sv[i * kg + j] = values[r * k + j0 + j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kg; j += blockDim.x) {
    walk_column(sk, m, chunk, n_seg, k, j0 + j,
                [&](int i) { return sv[i * kg + j]; }, partial);
  }
}

}  // namespace

// code, values 16-byte aligned; n >= 1; 1 <= n_seg * k <= PRIVATE_CELLS;
// `tile` records per CTA, a multiple of 4 (the wrapper checks them).
extern "C" int pipit_seg_sum_private(int device, const void* code,
                                     const void* values, int64_t n, int k,
                                     int n_seg, int tile, void* partial,
                                     void* out, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || k < 1 || n_seg < 1 || (int64_t)n_seg * k > PRIVATE_CELLS ||
      tile < 4 || tile % 4)
    return (int)cudaErrorInvalidValue;
  const int32_t* c = (const int32_t*)code;
  const float* v = (const float*)values;
  float* p = (float*)partial;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: err = launch_seg_private<1, true>(device, c, v, n, k, n_seg, tile, p, o, s); break;
    case 2: err = launch_seg_private<2, true>(device, c, v, n, k, n_seg, tile, p, o, s); break;
    case 3: err = launch_seg_private<4, false>(device, c, v, n, k, n_seg, tile, p, o, s); break;
    case 4: err = launch_seg_private<4, true>(device, c, v, n, k, n_seg, tile, p, o, s); break;
    case 8: err = launch_seg_private<8, true>(device, c, v, n, k, n_seg, tile, p, o, s); break;
    default: err = launch_seg_private<8, false>(device, c, v, n, k, n_seg, tile, p, o, s);
  }
  return (int)err;
}

extern "C" int pipit_seg_sum(int device, const void* skeys, const void* perm,
                             const void* values, int64_t n, int k, int n_seg,
                             void* partial, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sk = (const int32_t*)skeys;
  unsigned chunks = (unsigned)n_chunks(n);
  for (int j0 = 0; j0 < k; j0 += MAX_COLS) {
    int kg = k - j0 < MAX_COLS ? k - j0 : MAX_COLS;
    seg_walk<<<chunks, WALK_THREADS, 0, s>>>(
        sk, (const int64_t*)perm, (const float*)values, n, k, j0, kg, n_seg,
        (float*)partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_gather(sk, n, (const float*)partial, n_seg, k,
                            (float*)out, s);
}
