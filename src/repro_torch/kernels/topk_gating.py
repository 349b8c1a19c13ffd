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

The two give the same bits.  On a CPU tensor the wrapper runs
:func:`topk_gating_plain`.  With grad on and logits that require it, either
device goes through one ``autograd.Function``: the forward above, and
:func:`topk_gating_bwd` as its backward (on the card the hand-written
kernel in ``csrc/topk_gating_bwd.cu``, counted in :data:`LAUNCHES_BWD`; on
the CPU :func:`topk_gating_bwd_plain`).  The indices are not
differentiable; the gradient follows the columns the forward chose.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

__all__ = ["topk_gating", "topk_gating_plain", "topk_gating_path", "path",
           "topk_gating_bwd", "topk_gating_bwd_plain", "LAUNCHES",
           "LAUNCHES_BWD", "PATH_LAUNCHES", "MAX_K", "NARROW_E"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: the same launches by path
PATH_LAUNCHES = {"narrow": 0, "wide": 0}
#: backward kernel launches since import (one per :func:`topk_gating_bwd`
#: call that launches)
LAUNCHES_BWD = 0
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
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_gating: unsupported device {logits.device}")
    if logits.device.type == "cuda" and not logits.is_contiguous():
        raise ValueError("topk_gating: contiguous logits expected")
    if torch.is_grad_enabled() and logits.requires_grad:
        return _TopkGating.apply(logits, k, name)
    return _forward(name, logits, k)


def _forward(name: str, logits: torch.Tensor,
             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on checked inputs: the plain version on the CPU, one
    launch of the path ``name`` on the card."""
    global LAUNCHES
    if logits.device.type == "cpu":
        return topk_gating_plain(logits, k)
    T, E = logits.shape
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


class _TopkGating(torch.autograd.Function):
    """The forward of the path ``name`` (saving idx and gates) and
    :func:`topk_gating_bwd` backward; idx is not differentiable."""

    @staticmethod
    def forward(ctx, logits, k, name):
        idx, gates = _forward(name, logits, k)
        ctx.save_for_backward(idx, gates)
        ctx.mark_non_differentiable(idx)
        ctx.E = logits.shape[1]
        return idx, gates

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _didx, dgates):
        idx, gates = ctx.saved_tensors
        return topk_gating_bwd(idx, gates, dgates, E=ctx.E), None, None


def topk_gating_bwd_plain(idx: torch.Tensor, gates: torch.Tensor,
                          dgates: torch.Tensor,
                          dlogits: Optional[torch.Tensor] = None, *,
                          E: Optional[int] = None) -> torch.Tensor:
    """Plain version of the backward: ``dlogits`` (or zeros ``[T, E]``)
    plus, at column ``idx[t, j]``, ``g_j (dg_j - S)`` with ``S`` the sum of
    ``g_i dg_i`` over i = 0..k-1 in that order, added in j order as a loop
    over j (a column chosen twice takes both contributions)."""
    T, k = idx.shape
    if dlogits is None:
        out = torch.zeros((T, E), dtype=torch.float32, device=idx.device)
    else:
        out = dlogits.float().clone()
    s = torch.zeros(T, dtype=torch.float32, device=idx.device)
    for i in range(k):
        s = s + gates[:, i] * dgates[:, i]
    contrib = gates * (dgates - s[:, None])
    rows = torch.arange(T, device=idx.device)
    for j in range(k):
        col = idx[:, j].long()
        out[rows, col] = out[rows, col] + contrib[:, j]
    return out


def topk_gating_bwd(idx: torch.Tensor, gates: torch.Tensor,
                    dgates: torch.Tensor,
                    dlogits: Optional[torch.Tensor] = None, *,
                    E: Optional[int] = None) -> torch.Tensor:
    """The gradient of :func:`topk_gating`'s gates with respect to its
    logits: idx [T, k] int32, gates and their gradient ``dgates`` [T, k]
    float32, and the logits' own gradient ``dlogits`` [T, E] float32 where
    there is one (else ``E`` gives the width) → dlogits [T, E] float32.
    On the card one launch of ``csrc/topk_gating_bwd.cu``, on a CPU
    tensor :func:`topk_gating_bwd_plain`."""
    global LAUNCHES_BWD
    ts = (idx, gates, dgates) + (() if dlogits is None else (dlogits,))
    build.refuse_wrapped("topk_gating_bwd", *ts)
    if idx.dim() != 2 or gates.shape != idx.shape or \
            dgates.shape != idx.shape:
        raise ValueError(f"topk_gating_bwd: idx, gates and dgates [T, k] "
                         f"expected, got {tuple(idx.shape)}, "
                         f"{tuple(gates.shape)}, {tuple(dgates.shape)}")
    T, k = idx.shape
    if dlogits is not None:
        if dlogits.dim() != 2 or dlogits.shape[0] != T or \
                (E is not None and dlogits.shape[1] != E):
            raise ValueError(f"topk_gating_bwd: dlogits [{T}, E] expected, "
                             f"got {tuple(dlogits.shape)}")
        E = dlogits.shape[1]
    if E is None:
        raise ValueError("topk_gating_bwd: give dlogits or E")
    if idx.dtype != torch.int32 or any(t.dtype != torch.float32
                                       for t in ts[1:]):
        raise TypeError("topk_gating_bwd: int32 idx and float32 gates, "
                        "dgates and dlogits expected")
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"topk_gating_bwd: k = {k} outside [1, min(E = "
                         f"{E}, {MAX_K})]")
    if any(t.device != idx.device for t in ts):
        raise ValueError("topk_gating_bwd: inputs on different devices")
    if idx.device.type == "cpu":
        return topk_gating_bwd_plain(idx, gates, dgates, dlogits, E=E)
    if idx.device.type != "cuda":
        raise ValueError(f"topk_gating_bwd: unsupported device "
                         f"{idx.device}")
    # autograd may hand over a strided gradient
    idx, gates, dgates = (t.contiguous() for t in (idx, gates, dgates))
    if dlogits is not None:
        dlogits = dlogits.contiguous()
    out = torch.empty((T, E), dtype=torch.float32, device=idx.device)
    if T == 0:
        return out
    dev = idx.device.index
    build.check(build.library().pipit_topk_gating_bwd(
        dev, idx.data_ptr(), gates.data_ptr(), dgates.data_ptr(),
        None if dlogits is None else dlogits.data_ptr(), T, E, k,
        out.data_ptr(), build.raw_stream(dev)), "topk_gating_bwd")
    with build.COUNT_LOCK:
        LAUNCHES_BWD += 1
    return out
