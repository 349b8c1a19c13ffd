"""Pipit's ``time_profile`` overlap histogram on the card.

Port of the TPU kernel :mod:`repro.kernels.time_bin`: for every call record
(start, end, func, rate) and each of ``n_bins`` equal bins from ``t0``,
``out[func, j] += rate · |[start, end) ∩ bin_j|``; funcs outside
``[0, n_funcs)`` ignored.  Callers pass coordinates in bin units (see
``ops_summary._kernel_profile``).  On a CUDA tensor :func:`time_bin` stably
sorts the records by func on the device and launches the hand-written
kernel in ``csrc/time_bin.cu``; on a CPU tensor it runs
:func:`time_bin_plain`, the dense overlap form of the reference's
``time_bin_ref`` (:mod:`repro.kernels.ref`), chunked over N.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["time_bin", "time_bin_plain", "LAUNCHES"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0

_PLAIN_ROWS = 1 << 16  # records per dense [rows, n_bins] block


def time_bin_plain(start: torch.Tensor, end: torch.Tensor,
                   func: torch.Tensor, rate: torch.Tensor, n_funcs: int,
                   n_bins: int, t0: float, t1: float) -> torch.Tensor:
    """Plain version: f32 overlaps as the kernel computes them, accumulated
    in float64 with ``index_put_``; float32 ``[n_funcs, n_bins]``."""
    bw = (t1 - t0) / n_bins
    lo = t0 + bw * torch.arange(n_bins, dtype=torch.float32,
                                device=start.device)
    hi = lo + bw
    out = torch.zeros((n_funcs, n_bins), dtype=torch.float64,
                      device=start.device)
    for i in range(0, start.shape[0], _PLAIN_ROWS):
        sl = slice(i, i + _PLAIN_ROWS)
        f = func[sl]
        keep = (f >= 0) & (f < n_funcs)
        s, e, r = start[sl][keep], end[sl][keep], rate[sl][keep]
        ov = (torch.minimum(e[:, None], hi[None, :])
              - torch.maximum(s[:, None], lo[None, :])).clamp_min(0.0)
        out.index_put_((f[keep].long(),), (ov * r[:, None]).double(),
                       accumulate=True)
    return out.float()


def time_bin(start: torch.Tensor, end: torch.Tensor, func: torch.Tensor,
             rate: torch.Tensor, n_funcs: int, n_bins: int, t0: float,
             t1: float) -> torch.Tensor:
    """start, end, rate [N] float32, func [N] int32 → [n_funcs, n_bins]
    float32 rate-weighted overlap."""
    global LAUNCHES
    if not (start.dim() == 1
            and start.shape == end.shape == func.shape == rate.shape):
        raise ValueError("time_bin: start, end, func, rate of one shape [N] "
                         "expected")
    if func.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (start, end, rate)):
        raise TypeError("time_bin: float32 start/end/rate and int32 func "
                        "expected")
    if not (start.device == end.device == func.device == rate.device):
        raise ValueError("time_bin: inputs on different devices")
    if n_bins <= 0:
        raise ValueError(f"time_bin: n_bins must be positive, got {n_bins}")
    if start.device.type == "cpu":
        return time_bin_plain(start, end, func, rate, n_funcs, n_bins, t0, t1)
    if start.device.type != "cuda":
        raise ValueError(f"time_bin: unsupported device {start.device}")
    if not all(t.is_contiguous() for t in (start, end, func, rate)):
        raise ValueError("time_bin: contiguous inputs expected")
    out = torch.zeros((n_funcs, n_bins), dtype=torch.float32,
                      device=start.device)
    n = start.shape[0]
    if n == 0 or n_funcs == 0:
        return out
    skeys, perm = torch.sort(func, stable=True)
    chunks = -(-n // build.CHUNK)
    partial = torch.empty(((chunks + n_funcs) * n_bins,),
                          dtype=torch.float32, device=start.device)
    lib = build.library()
    build.check(lib.pipit_time_bin(
        start.device.index or 0, skeys.data_ptr(), perm.data_ptr(),
        start.data_ptr(), end.data_ptr(), rate.data_ptr(), n, n_funcs,
        n_bins, float(t0), float((t1 - t0) / n_bins), partial.data_ptr(),
        out.data_ptr(), build.stream_of(start)), "time_bin")
    LAUNCHES += 1
    return out
