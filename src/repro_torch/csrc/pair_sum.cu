// pair_sum: out[a[i], b[i]] += w[i] over N records; records with a or b
// outside [0, n_a) x [0, n_b) contribute nothing.
//
// Replaces the TPU kernel src/repro/kernels/pair_sum.py::pair_sum (a pair of
// one-hot matmuls, onehot(a)^T @ (onehot(b) * w), on the MXU).
//
// Bound on the H100: memory. Each record is 12 bytes in and one float add;
// no tensor-core work. At N = 4.7M that is 56 MB, 17 us at 3.35 TB/s.
//
// Design: two paths, both deterministic (no float atomics; the summation
// order is fixed by N and the grid's size), picked by
// kernels/pair_sum.py::path from (N, n_a * n_b):
//
// - "private", up to PRIVATE_CELLS = 6,144 cells (the analyses' grids:
//   names x ranks, ranks x ranks), with no sort. Each CTA owns a fixed tile
//   of PRIVATE_TILE consecutive records and as many warps as 192 KB of
//   shared memory holds copies of the grid (and mask tables, below), up
//   to 32 (32 at 6 x 64, 12 at 64 x 64, 8 at 6,144 cells); each warp owns
//   one copy. A CTA step reads
//   warps x 128 consecutive records, four a lane in one 16-byte load of
//   each array, and the next step's loads go out before this step is
//   added. For each of a lane's four records, the lanes on one cell find
//   each other (one vote when the whole warp agrees, as in runs of sorted
//   records; else, up to 768 cells, by OR-ing their bits into a per-warp
//   mask table, and above that by __match_any_sync, the slower of the
//   two), add their weights in a pairwise tree over their lane order, and
//   the group's first lane adds the sum to its warp's copy. The CTA adds
//   its warps' copies in warp order into its row of partials, and a second
//   launch adds the rows in CTA order. Every record is read once. The
//   grouping, the tree and both passes over the copies are private.cuh's,
//   shared with seg_sum and time_bin.
// - "sorted", above that: pipit_pair_keys forms the flat cell key
//   a * n_b + b (-1 when ignored), the wrapper stably sorts the keys on
//   the device, pair_walk sums each 1,024-record chunk's runs of equal keys
//   with a block-wide segmented scan (each thread eight records, then a
//   fixed shuffle tree across threads), and runs.cuh's gather adds the
//   chunks' run sums in chunk order.
#include "launch.cuh"
#include "private.cuh"
#include "runs.cuh"

namespace {

constexpr int PRIVATE_TILE = 16384;  // records per CTA (kernels/pair_sum.py)
constexpr int ITEMS = CHUNK / WALK_THREADS;

// Four consecutive records from i (a multiple of 4): cell (-1 when ignored
// or at or past `end`) and weight; one 16-byte load an array when all four
// lie before `end`.
__device__ __forceinline__ void read4(const int32_t* __restrict__ a,
                                      const int32_t* __restrict__ b,
                                      const float* __restrict__ w, int64_t i,
                                      int64_t end, int32_t n_a, int32_t n_b,
                                      int (&cell)[4], float (&wv)[4]) {
  int x[4], y[4];
  if (i + 4 <= end) {
    const int4 va = __ldcs(reinterpret_cast<const int4*>(a + i));
    const int4 vb = __ldcs(reinterpret_cast<const int4*>(b + i));
    const float4 vw = __ldcs(reinterpret_cast<const float4*>(w + i));
    x[0] = va.x; x[1] = va.y; x[2] = va.z; x[3] = va.w;
    y[0] = vb.x; y[1] = vb.y; y[2] = vb.z; y[3] = vb.w;
    wv[0] = vw.x; wv[1] = vw.y; wv[2] = vw.z; wv[3] = vw.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i + j < end;
      x[j] = in ? a[i + j] : -1;
      y[j] = in ? b[i + j] : -1;
      wv[j] = in ? w[i + j] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cell[j] = (x[j] >= 0 && y[j] >= 0 && x[j] < n_a && y[j] < n_b)
                  ? x[j] * n_b + y[j] : -1;
}

// One CTA per PRIVATE_TILE records, blockDim.x / 32 warps, each with its
// own copy of the grid (private.cuh). A CTA step covers warps x 128
// consecutive records, warp w the w-th 128, lane l records 4l..4l+3 of
// those; the next step's loads go out before this step is added. MASKS:
// lanes are grouped through the warp's mask table, else by
// __match_any_sync (lane_groups), one record at a time.
template <bool MASKS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
pair_private(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             const float* __restrict__ w, int64_t n, int32_t n_a, int32_t n_b,
             float* __restrict__ partial) {
  extern __shared__ float sgrid[];     // [warps][n_cells], then the masks
  const int n_cells = n_a * n_b;
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < (MASKS ? 2 : 1) * warps * n_cells;
       i += blockDim.x)
    sgrid[i] = 0.f;
  __syncthreads();
  float* mine = sgrid + warp * n_cells;
  unsigned* masks = reinterpret_cast<unsigned*>(sgrid + warps * n_cells) +
                    warp * n_cells;
  const int64_t tile = (int64_t)blockIdx.x * PRIVATE_TILE;
  const int64_t end = tile + PRIVATE_TILE < n ? tile + PRIVATE_TILE : n;
  const int64_t stride = (int64_t)warps * WARP_RECS;
  int64_t i = tile + warp * WARP_RECS + lane * 4;
  int cell[4], next_cell[4];
  float wv[4], next_wv[4];
  read4(a, b, w, i, end, n_a, n_b, next_cell, next_wv);
  for (; i - lane * 4 < end; i += stride) {   // the same for every lane
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cell[j] = next_cell[j];
      wv[j] = next_wv[j];
    }
    read4(a, b, w, i + stride, end, n_a, n_b, next_cell, next_wv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key[1] = {cell[j]};
      unsigned group[1];
      lane_groups<1, MASKS>(key, masks, n_cells, lane, group);
      float v[1][1] = {{wv[j]}};
      group_sums(group, lane, v);
      if (group_first(group[0], lane) && cell[j] >= 0)
        mine[cell[j]] += v[0][0];
    }
  }
  __syncthreads();
  float* row = partial + (int64_t)blockIdx.x * n_cells;
  copies_to_row(sgrid, warps, n_cells, [&](int c, float v) { row[c] = v; });
}

__global__ void pair_keys(const int32_t* __restrict__ a,
                          const int32_t* __restrict__ b, int64_t n,
                          int32_t n_a, int32_t n_b, int32_t* __restrict__ keys) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t x = a[i], y = b[i];
  keys[i] = (x >= 0 && y >= 0 && x < n_a && y < n_b) ? x * n_b + y : -1;
}

// (flag, sum) pairs of a segmented scan: flag says a run starts inside.
__device__ __forceinline__ void seg_combine(int& f, float& s, int of,
                                            float os) {
  if (!f) s = os + s;                  // continue the earlier open run
  f |= of;
}

// One chunk of sorted keys: the sum of every run of equal keys into the
// partial slot (chunk + key), as runs.cuh's walk writes it. Thread t owns
// positions [8t, 8t + 8): a sequential segmented scan over them, then a
// Kogge-Stone scan of the threads' (flag, sum) within each warp and the
// warps' totals in warp order give each thread the sum of the run open at
// its first position. The tree is fixed, so the bits are too.
__global__ void __launch_bounds__(WALK_THREADS)
pair_walk(const int32_t* __restrict__ skeys, const int64_t* __restrict__ perm,
          const float* __restrict__ w, int64_t n, int32_t n_cells,
          float* __restrict__ partial) {
  __shared__ int32_t sk[CHUNK];
  __shared__ float sw[CHUNK];
  __shared__ float wsum[WALK_THREADS / 32];
  __shared__ int wflag[WALK_THREADS / 32];
  const int64_t chunk = blockIdx.x;
  const int64_t base = chunk * CHUNK;
  const int m = chunk_len(n, base);
  for (int i = threadIdx.x; i < m; i += WALK_THREADS) {
    sk[i] = skeys[base + i];
    sw[i] = w[perm[base + i]];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = threadIdx.x * ITEMS;
  float s[ITEMS];
  int any = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {   // positions >= m add 0 to the last run
    const int p = p0 + j;
    const float v = p < m ? sw[p] : 0.f;
    const bool head = p < m && (p == 0 || sk[p] != sk[p - 1]);
    s[j] = (head || j == 0) ? v : s[j > 0 ? j - 1 : 0] + v;
    any |= head;
  }
  int f = any;
  float t = s[ITEMS - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float os = __shfl_up_sync(0xffffffffu, t, off);
    const int of = __shfl_up_sync(0xffffffffu, f, off);
    if (lane >= off) seg_combine(f, t, of, os);
  }
  float ex = __shfl_up_sync(0xffffffffu, t, 1);
  int exf = __shfl_up_sync(0xffffffffu, f, 1);
  if (lane == 0) {
    ex = 0.f;
    exf = 0;
  }
  if (lane == 31) {
    wsum[warp] = t;
    wflag[warp] = f;
  }
  __syncthreads();
  int pf = 0;
  float ps = 0.f;
  for (int v = 0; v < warp; ++v) {    // the warps before, in warp order
    int vf = wflag[v];
    float vs = wsum[v];
    seg_combine(vf, vs, pf, ps);
    pf = vf;
    ps = vs;
  }
  seg_combine(exf, ex, pf, ps);        // the run open before this thread
  bool seen = false;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int p = p0 + j;
    if (p >= m) break;
    const int32_t key = sk[p];
    seen = seen || p == 0 || key != sk[p - 1];
    const bool end = p == m - 1 || sk[p + 1] != key;
    if (end && key >= 0 && key < n_cells)
      partial[chunk + key] = seen ? s[j] : ex + s[j];
  }
}

}  // namespace

// a, b, w 16-byte aligned; 1 <= n_a * n_b <= PRIVATE_CELLS (the wrapper
// checks both).
extern "C" int pipit_pair_sum_private(int device, const void* a,
                                      const void* b, const void* w, int64_t n,
                                      int n_a, int n_b, void* partial,
                                      void* out, void* stream) {
  static int granted[MAX_DEVICES] = {}, granted_match[MAX_DEVICES] = {};
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int n_cells = n_a * n_b;
  if (n < 1 || n_cells < 1 || n_cells > PRIVATE_CELLS)
    return (int)cudaErrorInvalidValue;
  const bool masks = use_masks(n_cells);
  err = masks ? allow_smem(pair_private<true>, COPIES_BYTES, device, granted)
              : allow_smem(pair_private<false>, COPIES_BYTES, device,
                           granted_match);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned ctas = private_ctas(n, PRIVATE_TILE);
  const int each = warp_bytes(n_cells, n_cells, 1);
  const int warps = private_warps(each, MAX_WARPS);
  const int bytes = warps * each;
  if (masks)
    pair_private<true><<<ctas, warps * 32, bytes, s>>>(
        (const int32_t*)a, (const int32_t*)b, (const float*)w, n, n_a, n_b,
        (float*)partial);
  else
    pair_private<false><<<ctas, warps * 32, bytes, s>>>(
        (const int32_t*)a, (const int32_t*)b, (const float*)w, n, n_a, n_b,
        (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_private_sum((const float*)partial, (int64_t)ctas,
                                 n_cells, (float*)out, s);
}

extern "C" int pipit_pair_keys(int device, const void* a, const void* b,
                               int64_t n, int n_a, int n_b, void* keys,
                               void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((n + 255) / 256);
  pair_keys<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, n, n_a, n_b, (int32_t*)keys);
  return (int)cudaGetLastError();
}

extern "C" int pipit_pair_sum(int device, const void* skeys, const void* perm,
                              const void* w, int64_t n, int n_cells,
                              void* partial, void* out, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sk = (const int32_t*)skeys;
  pair_walk<<<(unsigned)n_chunks(n), WALK_THREADS, 0, s>>>(
      sk, (const int64_t*)perm, (const float*)w, n, n_cells, (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gather(sk, n, (const float*)partial, n_cells, 1,
                            (float*)out, s);
}
