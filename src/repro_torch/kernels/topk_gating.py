"""MoE router top-k gating on the card.

Port of the TPU kernel :mod:`repro.kernels.topk_gating` (reached in the
reference through ``repro.kernels.ops.router_topk``): for each row of
``[T, E]`` float32 logits, the k largest by iterative argmax — largest
first, the lowest index on ties, as ``lax.top_k`` — and the softmax over
those k values; a column chosen in an earlier round reads as -1e30, so a
row of ``-inf`` selects a chosen column again, as the Pallas kernel does.
On a CUDA tensor :func:`topk_gating` launches the hand-written kernels in
``csrc/topk_gating.cu`` on the path :func:`path` picks from E alone:

- ``"narrow"`` (E up to :data:`NARROW_E`): 8, 16 or 32 lanes a row, the
  row's logits loaded once into registers;
- ``"wide"`` (more columns): one warp a row, the row re-read each round.

The two give the same bits.  The kernels have no backward: on the card the
wrapper raises when autograd would need one (``build.refuse_grad``).  On a
CPU tensor it runs :func:`topk_gating_plain`, which is differentiable.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

__all__ = ["topk_gating", "topk_gating_plain", "topk_gating_path", "path",
           "LAUNCHES", "PATH_LAUNCHES", "MAX_K", "NARROW_E"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: the same launches by path
PATH_LAUNCHES = {"narrow": 0, "wide": 0}
#: the largest k the kernels unroll
MAX_K = 8
#: the most columns the narrow path holds: 4 registers on each of 32 lanes
NARROW_E = 128

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


def path(E: int) -> str:
    """The kernel path a CUDA call over rows of ``E`` logits takes:
    ``"narrow"`` up to :data:`NARROW_E` columns, else ``"wide"``."""
    return "narrow" if E <= NARROW_E else "wide"


def topk_gating(logits: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] float32 → (idx [T, k] int32, gates [T, k] float32); on
    the card through the path :func:`path` picks."""
    E = logits.shape[-1] if logits.dim() else 0
    return topk_gating_path(path(E), logits, k)


def topk_gating_path(name: str, logits: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_gating` through the named path (``"narrow"`` or
    ``"wide"``) whatever :func:`path` would pick, to compare the two on the
    same inputs; a CPU tensor still runs the plain version."""
    global LAUNCHES
    if name not in PATH_LAUNCHES:
        raise ValueError(f"topk_gating: unknown path {name!r}")
    build.refuse_wrapped("topk_gating", logits)
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
    if name == "narrow" and E > NARROW_E:
        raise ValueError(f"topk_gating: the narrow path takes at most "
                         f"{NARROW_E} columns, got {E}")
    if logits.device.type == "cpu":
        return topk_gating_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gating: unsupported device {logits.device}")
    build.refuse_grad("topk_gating", logits)
    if not logits.is_contiguous():
        raise ValueError("topk_gating: contiguous logits expected")
    # one allocation for both outputs: gates, then idx
    out = torch.empty(2 * T * k, dtype=torch.float32, device=logits.device)
    gates = out[:T * k].view(T, k)
    idx = out[T * k:].view(torch.int32).view(T, k)
    if T == 0:
        return idx, gates
    dev = logits.device.index
    lib = build.library()
    entry = (lib.pipit_topk_gating_narrow if name == "narrow"
             else lib.pipit_topk_gating)
    build.check(entry(dev, logits.data_ptr(), T, E, k, idx.data_ptr(),
                      gates.data_ptr(), build.raw_stream(dev)),
                f"topk_gating ({name})")
    with build.COUNT_LOCK:
        LAUNCHES += 1
        PATH_LAUNCHES[name] += 1
    return idx, gates
