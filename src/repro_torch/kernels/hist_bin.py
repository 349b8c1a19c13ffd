"""Histogram binning on the card: the ``message_histogram`` reduction.

Port of the TPU kernel :mod:`repro.kernels.hist_bin`: counts of
``clip(floor(x), 0, n_bins - 1)`` over coordinates ``x >= 0`` (negative and
NaN coordinates ignored, ``-0.0`` in bin 0; the clamp is taken in float
before the cast to int, so ``+inf`` lands in the top bin).  Callers feed
exact host-computed bin indices centered at ``idx + 0.5``, so the floor
recovers them exactly.  On a CUDA tensor :func:`hist_bin` launches the
hand-written kernels in ``csrc/hist_bin.cu`` on the path :func:`path`
picks from the bin count alone:

- ``"narrow"`` (up to :data:`NARROW_BINS` bins): one launch, counts in
  registers, each CTA's added into scratch accumulators that the last CTA
  to finish hands out into every bin of the output and resets;
- ``"wide"`` (more bins): a zeroed output, then shared-memory counts added
  into it with integer atomics.

Both count in integers, exact everywhere.  On a CPU tensor it runs
:func:`hist_bin_plain`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import build

__all__ = ["hist_bin", "hist_bin_plain", "hist_bin_path", "path",
           "LAUNCHES", "PATH_LAUNCHES", "NARROW_BINS"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: the same launches by path
PATH_LAUNCHES = {"narrow": 0, "wide": 0}
#: the most bins the narrow path counts in registers (csrc/hist_bin.cu)
NARROW_BINS = 32

#: the narrow path's scratch per (device, stream): NARROW_BINS u64
#: accumulators, then a u32 ticket; 0 between launches, which reset it
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def path(n_bins: int) -> str:
    """The kernel path a CUDA call into ``n_bins`` bins takes: ``"narrow"``
    up to :data:`NARROW_BINS` bins, else ``"wide"``."""
    return "narrow" if n_bins <= NARROW_BINS else "wide"


def hist_bin_plain(coords: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain version: int64 counts accumulated with ``index_put_``."""
    x = coords[coords >= 0]
    idx = torch.floor(x).clamp_max(n_bins - 1).long()
    out = torch.zeros((n_bins,), dtype=torch.int64, device=coords.device)
    out.index_put_((idx,), torch.ones_like(idx), accumulate=True)
    return out


def hist_bin(coords: torch.Tensor, n_bins: int) -> torch.Tensor:
    """coords [N] float32 bin coordinates → [n_bins] int64 counts; on the
    card through the path :func:`path` picks."""
    return hist_bin_path(path(n_bins), coords, n_bins)


def hist_bin_path(name: str, coords: torch.Tensor,
                  n_bins: int) -> torch.Tensor:
    """:func:`hist_bin` through the named path (``"narrow"`` or ``"wide"``)
    whatever :func:`path` would pick, to compare the two on the same
    inputs; a CPU tensor still runs the plain version."""
    global LAUNCHES
    if name not in PATH_LAUNCHES:
        raise ValueError(f"hist_bin: unknown path {name!r}")
    if coords.dim() != 1:
        raise ValueError(f"hist_bin: coords [N] expected, got "
                         f"{tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"hist_bin: float32 coords expected, got "
                        f"{coords.dtype}")
    if n_bins <= 0:
        raise ValueError(f"hist_bin: n_bins must be positive, got {n_bins}")
    if name == "narrow" and n_bins > NARROW_BINS:
        raise ValueError(f"hist_bin: the narrow path takes at most "
                         f"{NARROW_BINS} bins, got {n_bins}")
    if coords.device.type == "cpu":
        return hist_bin_plain(coords, n_bins)
    if coords.device.type != "cuda":
        raise ValueError(f"hist_bin: unsupported device {coords.device}")
    if not coords.is_contiguous():
        raise ValueError("hist_bin: contiguous coords expected")
    n = coords.shape[0]
    if n == 0:
        return torch.zeros((n_bins,), dtype=torch.int64, device=coords.device)
    dev = coords.device.index
    stream = build.raw_stream(dev)
    lib = build.library()
    if name == "narrow":
        out = torch.empty((n_bins,), dtype=torch.int64, device=coords.device)
        with build.COUNT_LOCK:
            scratch = _SCRATCH.get((dev, stream))
            if scratch is None:
                scratch = _SCRATCH[dev, stream] = torch.zeros(
                    (NARROW_BINS + 1,), dtype=torch.int64,
                    device=coords.device)
        build.check(lib.pipit_hist_bin_narrow(
            dev, coords.data_ptr(), n, n_bins, scratch.data_ptr(),
            out.data_ptr(), stream), "hist_bin (narrow)")
    else:
        out = torch.zeros((n_bins,), dtype=torch.int64, device=coords.device)
        build.check(lib.pipit_hist_bin(
            dev, coords.data_ptr(), n, n_bins, out.data_ptr(), stream),
            "hist_bin (wide)")
    with build.COUNT_LOCK:
        LAUNCHES += 1
        PATH_LAUNCHES[name] += 1
    return out
