"""Histogram binning on the card: the ``message_histogram`` reduction.

Port of the TPU kernel :mod:`repro.kernels.hist_bin`: counts of
``clip(floor(x), 0, n_bins - 1)`` over coordinates ``x >= 0`` (negative
coordinates ignored).  Callers feed exact host-computed bin indices
centered at ``idx + 0.5``, so the floor recovers them exactly.  On a CUDA
tensor :func:`hist_bin` launches the hand-written kernel in
``csrc/hist_bin.cu`` (integer counts, exact everywhere); on a CPU tensor
it runs :func:`hist_bin_plain`.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["hist_bin", "hist_bin_plain", "LAUNCHES"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0


def hist_bin_plain(coords: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain version: int64 counts accumulated with ``index_put_``."""
    x = coords[coords >= 0]
    idx = torch.floor(x).clamp_max(n_bins - 1).long()
    out = torch.zeros((n_bins,), dtype=torch.int64, device=coords.device)
    out.index_put_((idx,), torch.ones_like(idx), accumulate=True)
    return out


def hist_bin(coords: torch.Tensor, n_bins: int) -> torch.Tensor:
    """coords [N] float32 bin coordinates → [n_bins] int64 counts."""
    global LAUNCHES
    if coords.dim() != 1:
        raise ValueError(f"hist_bin: coords [N] expected, got "
                         f"{tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"hist_bin: float32 coords expected, got "
                        f"{coords.dtype}")
    if n_bins <= 0:
        raise ValueError(f"hist_bin: n_bins must be positive, got {n_bins}")
    if coords.device.type == "cpu":
        return hist_bin_plain(coords, n_bins)
    if coords.device.type != "cuda":
        raise ValueError(f"hist_bin: unsupported device {coords.device}")
    if not coords.is_contiguous():
        raise ValueError("hist_bin: contiguous coords expected")
    out = torch.zeros((n_bins,), dtype=torch.int64, device=coords.device)
    n = coords.shape[0]
    if n == 0:
        return out
    build.check(build.library().pipit_hist_bin(
        coords.device.index or 0, coords.data_ptr(), n, n_bins,
        out.data_ptr(), build.stream_of(coords)), "hist_bin")
    LAUNCHES += 1
    return out
