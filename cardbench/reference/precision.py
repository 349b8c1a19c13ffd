"""The control's precision: the reference's matrix products (the
projections and attention's two) computed as a float8 training step
computes them, the step below the bfloat16 that the
configurations state.  Forward, both operands of each projection are
rounded to e4m3; backward, the gradient of its output is rounded to e5m2
before the two products that carry it back.  Each rounding takes one
scale a tensor, its largest magnitude at the format's largest value."""

from __future__ import annotations

import torch

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def round_to(x: torch.Tensor, fmt) -> torch.Tensor:
    """x rounded to a float8 format under a per-tensor scale, in x's
    dtype."""
    dtype, top = fmt
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_to(a, E4M3), round_to(b, E4M3)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_to(g, E5M2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., m, k] @ b [..., k, n] in float8."""
    return _Fp8Matmul.apply(a, b)
