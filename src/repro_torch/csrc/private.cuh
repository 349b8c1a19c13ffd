// Shared pieces of the "private" path of the record reductions (seg_sum,
// pair_sum, time_bin): keyed records in the caller's order, no sort, summed
// into per-warp copies of a small grid in shared memory.
//
// Each CTA owns a tile of consecutive records (its size is the kernel's,
// a function of nothing but the kernel) and as many warps as COPIES_BYTES
// of shared memory holds copies of the grid (and mask tables, below), up
// to the kernel's own limit; each warp owns one copy. A warp step takes
// 128 consecutive records, four a lane read in 16-byte loads. For each of
// a lane's four records, the lanes whose record adds to one cell find each
// other (ballot_groups for keys of a few bits, else lane_groups), add
// their values in a pairwise tree over lane order (group_sums), and the
// group's first lane adds the sum to its warp's copy, record by record. A
// kernel may take its four records side by side (R = 4), so that their
// latencies overlap. The CTA adds its warps' copies in warp order into its
// row of partials (copies_to_row), and a second launch adds the rows in
// CTA order (private_sum).
//
// No float atomics: the summation order is fixed by N and the grid's size,
// so the same input gives the same bits on every launch. The warp-level
// votes, shuffles and reductions a record costs, not its bytes, bound
// these kernels (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRIVATE_CELLS = 6144;  // the largest grid (kernels/*.py)
constexpr int COPIES_BYTES = 192 * 1024;  // the warps' grid copies, at most
constexpr int MAX_WARPS = 32;
constexpr int WARP_RECS = 128;       // records a warp takes a step: 4 a lane
constexpr int SUM_ROWS = 8;          // rows a lane loads a batch

// Keys of at most this many bits are grouped by ballot_groups.
constexpr int BALLOT_BITS = 4;

// Grids of at most this many keys also keep a group-mask table per warp
// (see lane_groups) and still fit MAX_WARPS copies in the budget.
constexpr int MASK_CELLS = COPIES_BYTES / (8 * MAX_WARPS);   // 768

// Whether a grid whose lanes group by `keys` distinct keys keeps a mask
// table per warp.
inline bool use_masks(int keys) { return keys <= MASK_CELLS; }

// Bytes of shared memory a private-path warp takes: its copy of `cells`
// floats, and its `tables` mask tables of `keys` words where it has them.
inline int warp_bytes(int cells, int keys, int tables) {
  return 4 * cells + (use_masks(keys) ? 4 * keys * tables : 0);
}

// Warps of a private-path CTA: as many as the budget holds at `bytes` a
// warp, up to `most`.
inline int private_warps(int bytes, int most) {
  const int w = COPIES_BYTES / bytes;
  return w < most ? w : most;
}

// For each of R keys a lane holds (one a record of its step), the lanes
// of this warp whose key equals this lane's, as a lane mask (the lanes
// with key < 0 form one group, which adds nothing). One vote when the
// whole warp agrees, as in runs of sorted records; else, with MASKS, by
// OR-ing the lanes' bits into the warp's table for that record (`masks` +
// r * `keys`; an order-free shared-memory atomic, far cheaper than
// __match_any_sync), which the group's first lane clears after use; else
// by __match_any_sync. Both give the same groups, so the same bits. The R
// records share the table's three syncs, so their latencies overlap.
template <int R, bool MASKS>
__device__ __forceinline__ void lane_groups(const int (&key)[R],
                                            unsigned* masks, int keys,
                                            int lane, unsigned (&group)[R]) {
  const unsigned below = (1u << lane) - 1u;
  bool split[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int first = __shfl_sync(0xffffffffu, key[r], 0);
    split[r] = !__all_sync(0xffffffffu, key[r] == first);
    group[r] = 0xffffffffu;
    any |= split[r];
  }
  if (!any) return;
  if (!MASKS) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (split[r]) group[r] = __match_any_sync(0xffffffffu, key[r]);
    return;
  }
  unsigned ignored[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ignored[r] = __ballot_sync(0xffffffffu, key[r] < 0);
    if (split[r] && key[r] >= 0)
      atomicOr(masks + r * keys + key[r], 1u << lane);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (split[r]) group[r] = key[r] >= 0 ? masks[r * keys + key[r]]
                                         : ignored[r];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (split[r] && key[r] >= 0 && (group[r] & below) == 0)
      masks[r * keys + key[r]] = 0u;
  __syncwarp();
}

// Bits a key takes in ballot_groups for `keys` keys (and -1), or 0 where
// that is more than BALLOT_BITS.
inline int ballot_bits(int keys) {
  int b = 1;
  while ((1 << b) < keys + 1) ++b;
  return b <= BALLOT_BITS ? b : 0;
}

// lane_groups' groups by `bits` votes, one a bit of the key (-1, the
// ignored records, taken as all ones): a lane's group is the lanes whose
// votes match its own on every bit. No shared memory and no syncs, so for
// a key of a few bits it is the cheapest of the three.
template <int R>
__device__ __forceinline__ void ballot_groups(const int (&key)[R], int bits,
                                              unsigned (&group)[R]) {
  const unsigned all = (1u << bits) - 1u;
#pragma unroll
  for (int r = 0; r < R; ++r) group[r] = 0xffffffffu;
#pragma unroll 1
  for (int b = 0; b < bits; ++b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool one = ((unsigned)key[r] & all) >> b & 1u;
      const unsigned vote = __ballot_sync(0xffffffffu, one);
      group[r] &= one ? vote : ~vote;
    }
  }
}

// For each r, sum v[r][c] over the lanes of group[r] for every c, in a
// pairwise tree over the members' ranks (lane order), walked by pointer
// jumping: `nxt` is the member 2^round ranks up, -1 past the last. The
// group's first lane ends with the sums; the tree is fixed by the group,
// so the bits are too. The R trees run side by side (a round past a
// group's size leaves it as it is).
template <int R, int K>
__device__ __forceinline__ void group_sums(const unsigned (&group)[R],
                                           int lane, float (&v)[R][K]) {
  const unsigned below = (1u << lane) - 1u;
  int rank[R], nxt[R];
  int most = 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned up = group[r] & ~below & ~(1u << lane);
    rank[r] = __popc(group[r] & below);
    nxt[r] = up ? __ffs(up) - 1 : -1;
    most = max(most, (int)__reduce_max_sync(0xffffffffu, __popc(group[r])));
  }
  for (int step = 1; step < most; step <<= 1) {
    float o[R][K];
    int nn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int src = nxt[r] < 0 ? lane : nxt[r];
#pragma unroll
      for (int c = 0; c < K; ++c)
        o[r][c] = __shfl_sync(0xffffffffu, v[r][c], src);
      nn[r] = __shfl_sync(0xffffffffu, nxt[r], src);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((rank[r] & (2 * step - 1)) == 0 && nxt[r] >= 0) {
#pragma unroll
        for (int c = 0; c < K; ++c) v[r][c] += o[r][c];
      }
      nxt[r] = nxt[r] < 0 ? -1 : nn[r];
    }
  }
}

// True on the first lane of its group: the one that adds the group's sum.
__device__ __forceinline__ bool group_first(unsigned group, int lane) {
  return (group & ((1u << lane) - 1u)) == 0;
}

// The CTA's warp copies (`warps` of `n_cells` floats from `sgrid`) added
// in warp order; put(c, sum) stores cell c's sum in the CTA's row of
// partials. Call after a __syncthreads().
template <typename Put>
__device__ __forceinline__ void copies_to_row(const float* sgrid, int warps,
                                              int n_cells, Put put) {
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) {
    float acc = 0.f;
    for (int v = 0; v < warps; ++v) acc += sgrid[v * n_cells + c];
    put(c, acc);
  }
}

// out[c] = the CTAs' partial rows of cell c added in CTA order, one warp
// (and CTA) a cell, so that few share an SM's shuffles. Lane l loads rows
// l, l + 32, ... of a batch of 32 SUM_ROWS rows, the next batch's loads in
// flight while this one is added; every lane adds the batch's rows one by
// one in row order, each taken from its lane by a shuffle, so the sum is
// that of a plain loop over the rows.
__global__ void __launch_bounds__(32)
private_sum(const float* __restrict__ partial, int64_t ctas,
            int32_t n_cells, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int c = blockIdx.x;
  float v[SUM_ROWS], next[SUM_ROWS];
  auto load = [&](int64_t p0) {
#pragma unroll
    for (int q = 0; q < SUM_ROWS; ++q) {
      const int64_t p = p0 + q * 32 + lane;
      next[q] = p < ctas ? partial[p * n_cells + c] : 0.f;
    }
  };
  float acc = 0.f;
  load(0);
  for (int64_t p0 = 0; p0 < ctas; p0 += 32 * SUM_ROWS) {
#pragma unroll
    for (int q = 0; q < SUM_ROWS; ++q) v[q] = next[q];
    load(p0 + 32 * SUM_ROWS);
#pragma unroll
    for (int q = 0; q < SUM_ROWS; ++q) {
      const int64_t left = ctas - (p0 + q * 32);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float x = __shfl_sync(0xffffffffu, v[q], t);
        if (t < left) acc += x;
      }
    }
  }
  if (lane == 0) out[c] = acc;
}

inline cudaError_t launch_private_sum(const float* partial, int64_t ctas,
                                      int n_cells, float* out,
                                      cudaStream_t s) {
  private_sum<<<(unsigned)n_cells, 32, 0, s>>>(partial, ctas, n_cells, out);
  return cudaGetLastError();
}

inline unsigned private_ctas(int64_t n, int tile) {
  return (unsigned)((n + tile - 1) / tile);
}

}  // namespace
