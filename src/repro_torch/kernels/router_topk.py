"""The MoE router on the card in one launch: the router product and its
top-k.

Fuses what the reference's ``moe_ffn`` does at ``repro/models/moe.py``
(the float32 einsum of the router product, then ``route_topk``, whose TPU
kernel is :mod:`repro.kernels.topk_gating`): from ``x [T, d]`` and the
router weight ``w [d, E]`` it returns ``logits [T, E]`` float32 (``x @ w``
with f32 accumulation), ``idx [T, k]`` int32 (the k largest logits of each
row, largest first, the lowest index on ties) and ``gates [T, k]`` float32
(the softmax over those k).

:func:`router_variant` picks the route from the dtype and the shape alone:

- ``"fused"`` (bfloat16, ``d % 16 == 0``, ``E <= 128``, ``k <= 8``): the
  hand-written kernel in ``csrc/router_topk.cu``, the product on the
  tensor cores and the selection in its epilogue;
- ``"unfused"`` (every other case, float32 among them): the float32
  product, then the ``topk_gating`` kernel.

On a CPU tensor :func:`router_topk` runs :func:`router_topk_plain` in
place of the fused kernel and ``topk_gating``'s plain version in place of
its kernel.  With grad on and an input that requires it, both routes are
differentiable on either device, through ``autograd.Function`` classes whose
backward is ``topk_gating.topk_gating_bwd`` (``csrc/topk_gating_bwd.cu``
on the card):

- ``"fused"``: :class:`_RouterFused`, whose backward turns the gates'
  gradient (plus the logits' own, where there is one) into ``dlogits``,
  then ``dx = dlogits @ w^T`` and ``dw = x^T @ dlogits`` in float32 (the
  transposes of the reference's f32 einsum; plain matrix products), cast
  to the inputs' dtypes;
- ``"unfused"``: the float32 product under autograd, then
  ``topk_gating``'s Function.

The gradient follows the indices the forward chose (saved), never a new
selection.  Under a mesh the router gets a rank's local tokens and a
weight whose gradient is a partial sum (``models/moe.py::_moe_sharded``):
``dw`` is that rank's share.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from . import topk_gating as _topk

__all__ = ["router_topk", "router_topk_plain", "router_variant",
           "logit_tolerance", "LAUNCHES", "VARIANT_CALLS", "MAX_E"]

#: fused kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: calls on the card by route; an "unfused" call launches ``topk_gating``
VARIANT_CALLS = {"fused": 0, "unfused": 0}
#: the most experts the fused kernel's column tiles cover
MAX_E = 128


def router_variant(dtype: torch.dtype, d: int, E: int, k: int) -> str:
    """The route a CUDA call with this activation dtype and shape takes:
    ``"fused"`` for bfloat16 with ``d % 16 == 0`` (the tensor cores' k16
    steps), ``E <= 128`` and ``k <= 8``; else ``"unfused"``."""
    if (dtype == torch.bfloat16 and d % 16 == 0 and E <= MAX_E
            and k <= _topk.MAX_K):
        return "fused"
    return "unfused"


def logit_tolerance(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[T, E] bound on the difference between two float32 sums of the same
    d exact bf16 × bf16 products taken in different orders:
    ``d · 2^-22 · (|x| @ |w|)``, twice the worst-case rounding of one sum
    (``d · u · Σ|x w|``) with u = 2^-23, the unit of an adder that
    truncates, as the tensor cores' may."""
    d = x.shape[-1]
    return (x.float().abs() @ w.float().abs()) * (d * 2.0 ** -22)


def router_topk_plain(x: torch.Tensor, w: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the float32 product, then ``topk_gating_plain``."""
    logits = x.float() @ w.float()
    idx, gates = _topk.topk_gating_plain(logits, k)
    return logits, idx, gates


def router_topk(x: torch.Tensor, w: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, d], w [d, E] (float32 or bfloat16) → (logits [T, E] float32,
    idx [T, k] int32, gates [T, k] float32)."""
    build.refuse_wrapped("router_topk", x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"router_topk: x [T, d] and w [d, E] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"router_topk: float32 or bfloat16 x and w "
                        f"expected, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError("router_topk: x and w on different devices")
    T, d = x.shape
    E = w.shape[1]
    if not 1 <= k <= min(E, _topk.MAX_K):
        raise ValueError(f"router_topk: k = {k} outside [1, min(E = {E}, "
                         f"{_topk.MAX_K})]")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"router_topk: unsupported device {x.device}")
    cuda = x.device.type == "cuda"
    if w.dtype != x.dtype or router_variant(x.dtype, d, E, k) == "unfused":
        if cuda:
            with build.COUNT_LOCK:
                VARIANT_CALLS["unfused"] += 1
        logits = x.float() @ w.float()
        idx, gates = _topk.topk_gating(logits, k)
        return logits, idx, gates
    if cuda:
        if not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError("router_topk: contiguous x and w expected")
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("router_topk: the kernel's 16-byte copies "
                             "need 16-byte aligned x and w")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RouterFused.apply(x, w, k)
    return _fused(x, w, k)


def _fused(x: torch.Tensor, w: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused route's forward on checked inputs: the plain version on
    the CPU, one launch of the kernel on the card."""
    global LAUNCHES
    if x.device.type == "cpu":
        return router_topk_plain(x, w, k)
    T, d = x.shape
    E = w.shape[1]
    # one allocation for the three outputs: logits, gates, then idx
    out = torch.empty(T * (E + 2 * k), dtype=torch.float32, device=x.device)
    logits = out[:T * E].view(T, E)
    gates = out[T * E:T * (E + k)].view(T, k)
    idx = out[T * (E + k):].view(torch.int32).view(T, k)
    if T == 0:
        return logits, idx, gates
    dev = x.device.index
    build.check(build.library().pipit_router_topk(
        dev, x.data_ptr(), w.data_ptr(), T, d, E, k, logits.data_ptr(),
        idx.data_ptr(), gates.data_ptr(), build.raw_stream(dev)),
        "router_topk")
    with build.COUNT_LOCK:
        LAUNCHES += 1
        VARIANT_CALLS["fused"] += 1
    return logits, idx, gates


class _RouterFused(torch.autograd.Function):
    """The fused route's forward (saving x, w, idx and gates) and its
    backward: ``topk_gating_bwd`` from the gates' gradient and the logits'
    own (None where the logits are unused: no zeros are made for them),
    then the two f32 products of the router's transpose.  idx is not
    differentiable."""

    @staticmethod
    def forward(ctx, x, w, k):
        logits, idx, gates = _fused(x, w, k)
        ctx.save_for_backward(x, w, idx, gates)
        ctx.mark_non_differentiable(idx)
        ctx.set_materialize_grads(False)
        return logits, idx, gates

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dlogits, _didx, dgates):
        x, w, idx, gates = ctx.saved_tensors
        dl = dlogits if dgates is None else _topk.topk_gating_bwd(
            idx, gates, dgates, dlogits, E=w.shape[1])
        dx = (dl @ w.float().T).to(x.dtype) if ctx.needs_input_grad[0] \
            else None
        dw = (x.float().T @ dl).to(w.dtype) if ctx.needs_input_grad[1] \
            else None
        return dx, dw, None
