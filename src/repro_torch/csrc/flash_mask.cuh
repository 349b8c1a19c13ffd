// The mask of flash attention, one definition for the forward kernels
// (flash_attention.cu) and the backward kernel (flash_attention_bwd.cu), so
// that the backward differentiates the function the forward computes.
//
// Row i sits at position q_offset + i and key c at c; with d = position - c
// a key is visible when
//   c < Sk  and  (!causal or d >= 0)
//   and (no window or d < window or (c < prefix_len and d >= 0)),
// the mask of src/repro/models/attention.py::_mask (prefix keys stay
// visible, causally, outside the window). kernels/flash_attention.py::mask
// is the same rule for the plain versions.
#pragma once

namespace {

// Whether key `col` is visible from the row at position `pos`.
__device__ __forceinline__ bool visible(int pos, int col, int Sk, int causal,
                                        int has_window, int window,
                                        int prefix_len) {
  const int d = pos - col;
  bool ok = col < Sk;
  if (causal) ok = ok && d >= 0;
  if (has_window) ok = ok && (d < window || (col < prefix_len && d >= 0));
  return ok;
}

// Rows at positions up to p_hi see no key from c0 on (every d < 0).
__device__ __forceinline__ bool past_causal(int c0, int p_hi, int causal) {
  return causal && c0 > p_hi;
}

// Rows at positions [p_lo, p_hi] see no key of [c0, c1]: every d >= window
// and no prefix key a row reaches.
__device__ __forceinline__ bool past_window(int p_lo, int p_hi, int c0,
                                            int c1, int has_window,
                                            int window, int prefix_len) {
  return has_window && c1 <= p_lo - window &&
         !(c0 < prefix_len && c0 <= p_hi);
}

}  // namespace
