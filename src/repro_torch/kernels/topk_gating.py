"""MoE router top-k gating on the card.

Port of the TPU kernel :mod:`repro.kernels.topk_gating` (reached in the
reference through ``repro.kernels.ops.router_topk``): for each row of
``[T, E]`` float32 logits, the k largest by iterative argmax — largest
first, the lowest index on ties, as ``lax.top_k`` — and the softmax over
those k values.  On a CUDA tensor :func:`topk_gating` launches the
hand-written kernel in ``csrc/topk_gating.cu`` (one warp per row); on a
CPU tensor it runs :func:`topk_gating_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

__all__ = ["topk_gating", "topk_gating_plain", "LAUNCHES", "MAX_K"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: the largest k the kernel unrolls
MAX_K = 8

_NEG = -1e30


def topk_gating_plain(logits: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: k rounds of ``argmax`` (the first maximum) with the
    chosen column masked to -1e30, then a float32 softmax over the k."""
    x = logits.clone()
    rows = torch.arange(x.shape[0], device=x.device)
    idx, vals = [], []
    for _ in range(k):
        a = torch.argmax(x, dim=1)
        idx.append(a)
        vals.append(x[rows, a])
        x[rows, a] = _NEG
    v = torch.stack(vals, dim=1)
    ev = torch.exp(v - v.amax(dim=1, keepdim=True))
    gates = ev / ev.sum(dim=1, keepdim=True)
    return torch.stack(idx, dim=1).to(torch.int32), gates


def topk_gating(logits: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] float32 → (idx [T, k] int32, gates [T, k] float32)."""
    global LAUNCHES
    if logits.dim() != 2:
        raise ValueError(f"topk_gating: logits [T, E] expected, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"topk_gating: float32 logits expected, got "
                        f"{logits.dtype}")
    T, E = logits.shape
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"topk_gating: k = {k} outside [1, min(E = {E}, "
                         f"{MAX_K})]")
    if logits.device.type == "cpu":
        return topk_gating_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gating: unsupported device {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("topk_gating: contiguous logits expected")
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    gates = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    if T == 0:
        return idx, gates
    build.check(build.library().pipit_topk_gating(
        logits.device.index or 0, logits.data_ptr(), T, E, k,
        idx.data_ptr(), gates.data_ptr(), build.stream_of(logits)),
        "topk_gating")
    LAUNCHES += 1
    return idx, gates
