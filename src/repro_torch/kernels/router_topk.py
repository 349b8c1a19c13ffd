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

On a CPU tensor :func:`router_topk` runs :func:`router_topk_plain`, which
is differentiable.  Neither kernel has a backward yet: on the card the
wrapper raises when autograd would need one (``build.refuse_grad``), on
either route.
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
    global LAUNCHES
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
    if x.device.type == "cpu":
        return router_topk_plain(x, w, k)
    if x.device.type != "cuda":
        raise ValueError(f"router_topk: unsupported device {x.device}")
    build.refuse_grad("router_topk", x, w)
    if w.dtype != x.dtype or router_variant(x.dtype, d, E, k) == "unfused":
        with build.COUNT_LOCK:
            VARIANT_CALLS["unfused"] += 1
        logits = x.float() @ w.float()
        idx, gates = _topk.topk_gating(logits, k)
        return logits, idx, gates
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("router_topk: contiguous x and w expected")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("router_topk: the kernel's 16-byte copies need "
                         "16-byte aligned x and w")
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
