"""NumPy-facing adapters over the port's record-reduction kernels, plus the
canonical record ordering they share.

Mirrors :mod:`repro.core.accel`.  The analysis ops reduce a flat *record
set* — completed calls or send instants — with f32 kernel arithmetic.  f32
sums are order-dependent, so every op sorts its records into one canonical
order on the host (:func:`canonical_order`, an exact copy of the
reference's) and calls the kernel once.  :func:`block_size`,
:func:`alpha_positions` and :func:`canonical_order` are copied unchanged;
:func:`seg_sum`, :func:`pair_sum` and :func:`hist_counts` move the records
to ``device``, launch the kernel there (or its plain PyTorch version when
``device`` is the CPU) and widen the result to float64 on the way back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import hist_bin as _hist_bin
from ..kernels import pair_sum as _pair_sum
from ..kernels import seg_sum as _seg_sum

__all__ = ["resolve_device", "canonical_order", "alpha_positions",
           "block_size", "seg_sum", "pair_sum", "hist_counts"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device on a machine without
    one raises: the port never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device and none is "
            f"available; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def block_size(n: int) -> int:
    """Deterministic event-block size of the reference's Pallas kernels
    (:func:`repro.core.accel.block_size`), kept for parity: 256 for small
    inputs, doubled until the grid stays under ~512 steps.  The Hopper
    kernels partition records by their own fixed chunk size — also a pure
    function of N."""
    be = 256
    while n > be * 512 and be < 65536:
        be *= 2
    return be


def alpha_positions(names) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sorted names, gather order, code→alphabetical-position map) for a
    code-aligned name table — the code-space-independent axis every kernel
    op keys on.  ``arr[order]`` re-orders a code-indexed axis
    alphabetically; ``inv[code]`` is a code's alphabetical position."""
    names = np.asarray(list(names), dtype=object).astype(str)
    order = np.argsort(names, kind="stable")
    inv = np.empty(len(names), np.int64)
    inv[order] = np.arange(len(names))
    return names[order], order, inv


def canonical_order(start, end, proc, code, value) -> np.ndarray:
    """The shared sort of every kernel op: primary key ``start``, then
    ``end``, ``proc``, ``code`` (alphabetical name position — pass
    ``inv[raw_code]``), and ``value`` as the final tiebreak.  Records equal
    on *all* keys are interchangeable, so two paths that hold the same
    record multiset feed the kernel bit-identical inputs."""
    return np.lexsort((np.asarray(value, np.float64),
                       np.asarray(code, np.int64),
                       np.asarray(proc, np.int64),
                       np.asarray(end, np.float64),
                       np.asarray(start, np.float64)))


def _host(x, dtype) -> torch.Tensor:
    """``x`` as a contiguous host tensor of ``dtype``.  A read-only array
    (a pack column mapped from disk) is copied first: ``torch.from_numpy``
    would otherwise share, and warn about, memory it cannot write."""
    a = np.ascontiguousarray(x, dtype)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def _ids(x, dev: torch.device) -> torch.Tensor:
    return _host(x, np.int32).to(dev)


def _f32(x, dev: torch.device) -> torch.Tensor:
    return _host(x, np.float32).to(dev)


def seg_sum(code: np.ndarray, values: np.ndarray, n_seg: int,
            device="cuda") -> np.ndarray:
    """Per-segment column sums: code [N] (<0 ignored), values [N] or
    [N, K] → float64 [n_seg] / [n_seg, K] (f32 kernel arithmetic, widened
    on the way out)."""
    dev = resolve_device(device)
    values = np.asarray(values, np.float64)
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    if n_seg <= 0 or values.shape[1] == 0:
        out = np.zeros((max(n_seg, 0), values.shape[1]))
        return out[:, 0] if squeeze else out
    out = _seg_sum.seg_sum(_ids(code, dev), _f32(values, dev),
                           int(n_seg)).cpu().numpy().astype(np.float64)
    return out[:, 0] if squeeze else out


def pair_sum(a: np.ndarray, b: np.ndarray, w: np.ndarray, n_a: int,
             n_b: int, device="cuda") -> np.ndarray:
    """Weighted 2-D scatter-add: a, b [N] (<0 ignored), w [N] → float64
    [n_a, n_b]."""
    dev = resolve_device(device)
    if n_a <= 0 or n_b <= 0:
        return np.zeros((max(n_a, 0), max(n_b, 0)))
    return _pair_sum.pair_sum(
        _ids(a, dev), _ids(b, dev), _f32(np.asarray(w, np.float64), dev),
        int(n_a), int(n_b)).cpu().numpy().astype(np.float64)


def hist_counts(idx: np.ndarray, n_bins: int, device="cuda") -> np.ndarray:
    """Exact histogram counts: host-computed bin indices go in centered at
    ``idx + 0.5`` (f32-exact below 2²³), the in-kernel floor recovers them
    exactly, and the kernel counts in integers, so the int64 counts match
    ``np.histogram`` bit for bit."""
    dev = resolve_device(device)
    if n_bins <= 0:
        return np.zeros(max(n_bins, 0), np.int64)
    coords = np.asarray(idx, np.float64) + 0.5
    return _hist_bin.hist_bin(_f32(coords, dev),
                              int(n_bins)).cpu().numpy().astype(np.int64)
