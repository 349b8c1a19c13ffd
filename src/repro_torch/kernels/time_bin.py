"""Pipit's ``time_profile`` overlap histogram on the card.

Port of the TPU kernel :mod:`repro.kernels.time_bin`: for every call record
(start, end, func, rate) and each of ``n_bins`` equal bins from ``t0``,
``out[func, j] += rate · |[start, end) ∩ bin_j|``; funcs outside
``[0, n_funcs)`` ignored.  Callers pass coordinates in bin units (see
``ops_summary._kernel_profile``).  On a CUDA tensor :func:`time_bin`
launches the hand-written kernels in ``csrc/time_bin.cu`` on the path
:func:`path` picks from the record count and the grid's size
(``n_funcs * n_bins`` cells), by the rule ``pair_sum`` uses:

- ``"private"`` (up to :data:`PRIVATE_CELLS` cells): per-warp copies of the
  grid in shared memory; each record adds only to the bins its span
  touches; no sort;
- ``"sorted"`` (larger grids): a stable device sort of the records by
  func, and a fixed-order walk of each func's run over every bin.

Both are deterministic and give each (record, bin) term exactly as
:func:`time_bin_plain` does, NaN and infinite coordinates included: a
NaN term stays in its record's row, where the reference's one-hot product
spreads it over every row.  On a CPU tensor it runs
:func:`time_bin_plain`, the dense overlap form of the reference's
``time_bin_ref`` (:mod:`repro.kernels.ref`), chunked over N.
"""

from __future__ import annotations

import math

import torch

from . import build
from . import pair_sum
from .pair_sum import PRIVATE_CELLS, PRIVATE_PARTIALS

__all__ = ["time_bin", "time_bin_plain", "time_bin_path", "path", "LAUNCHES", "PATH_LAUNCHES", "PRIVATE_CELLS", "PRIVATE_PARTIALS",
           "PRIVATE_TILE"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: the same launches by path
PATH_LAUNCHES = {"private": 0, "sorted": 0}
#: records per CTA of the private path: small CTAs, several to an SM
PRIVATE_TILE = 4096


def path(n: int, n_cells: int) -> str:
    """The kernel path a CUDA call over ``n`` records into ``n_cells`` cells
    takes: ``pair_sum.path``'s rule at :data:`PRIVATE_TILE` records a
    CTA."""
    return pair_sum.path(n, n_cells, PRIVATE_TILE)

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
    float32 rate-weighted overlap; on the card through the path
    :func:`path` picks."""
    return time_bin_path(path(start.shape[0], n_funcs * n_bins), start, end,
                         func, rate, n_funcs, n_bins, t0, t1)


def time_bin_path(name: str, start: torch.Tensor, end: torch.Tensor,
                  func: torch.Tensor, rate: torch.Tensor, n_funcs: int,
                  n_bins: int, t0: float, t1: float) -> torch.Tensor:
    """:func:`time_bin` through the named path (``"private"`` or
    ``"sorted"``) whatever :func:`path` would pick, to compare the two on
    the same inputs; a CPU tensor still runs the plain version."""
    global LAUNCHES
    if name not in PATH_LAUNCHES:
        raise ValueError(f"time_bin: unknown path {name!r}")
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
    if not (math.isfinite(t0) and math.isfinite(t1)):
        raise ValueError(f"time_bin: finite bin edges expected, got "
                         f"[{t0}, {t1}]")
    if name == "private" and n_funcs * n_bins > PRIVATE_CELLS:
        raise ValueError(f"time_bin: the private path takes at most "
                         f"{PRIVATE_CELLS} cells, got {n_funcs} x {n_bins}")
    if start.device.type == "cpu":
        return time_bin_plain(start, end, func, rate, n_funcs, n_bins, t0, t1)
    if start.device.type != "cuda":
        raise ValueError(f"time_bin: unsupported device {start.device}")
    if not all(t.is_contiguous() for t in (start, end, func, rate)):
        raise ValueError("time_bin: contiguous inputs expected")
    n = start.shape[0]
    if n == 0 or n_funcs == 0:
        return torch.zeros((n_funcs, n_bins), dtype=torch.float32,
                           device=start.device)
    out = torch.empty((n_funcs, n_bins), dtype=torch.float32,
                      device=start.device)
    lib = build.library()
    dev, stream = start.device.index, build.stream_of(start)
    bw = float((t1 - t0) / n_bins)
    if name == "private":
        if any(t.data_ptr() % 16 for t in (start, end, func, rate)):
            raise ValueError("time_bin: the private path's 16-byte loads "
                             "need 16-byte aligned start, end, func, rate")
        ctas = -(-n // PRIVATE_TILE)
        partial = torch.empty((ctas * n_funcs * n_bins,),
                              dtype=torch.float32, device=start.device)
        build.check(lib.pipit_time_bin_private(
            dev, start.data_ptr(), end.data_ptr(), func.data_ptr(),
            rate.data_ptr(), n, n_funcs, n_bins, float(t0), bw,
            PRIVATE_TILE, partial.data_ptr(), out.data_ptr(), stream),
            "time_bin (private)")
    else:
        skeys, perm = torch.sort(func, stable=True)
        chunks = -(-n // build.CHUNK)
        partial = torch.empty(((chunks + n_funcs) * n_bins,),
                              dtype=torch.float32, device=start.device)
        build.check(lib.pipit_time_bin(
            dev, skeys.data_ptr(), perm.data_ptr(), start.data_ptr(),
            end.data_ptr(), rate.data_ptr(), n, n_funcs, n_bins, float(t0),
            bw, partial.data_ptr(), out.data_ptr(), stream),
            "time_bin (sorted)")
    with build.COUNT_LOCK:
        LAUNCHES += 1
        PATH_LAUNCHES[name] += 1
    return out
