"""Operations and bytes that the benchmark's shares of peak are taken
against, and the H100's published peaks.

Every count follows from the configuration and the shapes of the call,
never from which kernel ran: a matrix product of [m, k] by [k, n] is 2 m
k n operations, causal attention over S positions visits S (S + 1) / 2
query-key pairs, and a kernel's bytes count each input read once and
each output written once.  The peaks are NVIDIA's data sheet for the SXM
H100 at its 700 W limit: 989 TFLOP/s dense bf16 on the tensor cores and
3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Tuple

BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def layer_params_per_token(a) -> int:
    """Matrix parameters one token goes through in one layer (a
    ``reference.model.Arch``): attention's four projections, then the
    dense SwiGLU, or the router, the k chosen experts, the shared experts
    and their gate."""
    attn = a.d * a.heads * a.hd * 2 + a.d * a.kv_heads * a.hd * 2
    if a.experts:
        return (attn + a.d * a.experts + a.topk * 3 * a.d * a.moe_ff
                + 3 * a.d * a.shared_ff + a.d)
    return attn + 3 * a.d * a.ff


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_fwd_flops(a, s: int) -> int:
    """QK^T and PV over the causal pairs of one sequence, all layers."""
    return 4 * a.hd * a.heads * causal_pairs(s) * a.layers


def train_step_flops(a, batch: int, seq: int) -> int:
    """Forward and backward (3 times the forward) of one step: the
    layers' products, the head over the padded vocabulary, attention."""
    tokens = batch * seq
    dense = 2 * tokens * (a.layers * layer_params_per_token(a)
                          + a.d * a.padded_vocab)
    return 3 * (dense + batch * attention_fwd_flops(a, seq))


def flash_bwd(batch: int, s: int, heads: int, kv_heads: int, hd: int,
              elt: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one causal flash backward: the products S,
    dP, dV, dQ, dK over the causal pairs; q, o, dO, dq and k, v, dk, dv
    once each, and the float32 log-sum-exp read."""
    ops = 5 * 2.0 * hd * causal_pairs(s) * batch * heads
    nbytes = (4 * batch * s * heads * hd + 4 * batch * s * kv_heads * hd) \
        * elt + 4 * batch * heads * s
    return ops, float(nbytes)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES)
