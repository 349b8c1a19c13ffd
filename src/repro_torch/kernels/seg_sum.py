"""Segment sum on the card: the ``flat_profile`` reduction.

Port of the TPU kernel :mod:`repro.kernels.seg_sum`:
``out[code[i], :] += values[i, :]``, codes outside ``[0, n_seg)`` ignored.
On a CUDA tensor :func:`seg_sum` launches the hand-written kernels in
``csrc/seg_sum.cu`` on the path :func:`path` picks from the record count
and the grid's size (``n_seg * K`` cells), by the rule ``pair_sum`` uses:

- ``"private"`` (up to :data:`PRIVATE_CELLS` cells): per-warp copies of the
  grid in shared memory, summed in a fixed order; no sort;
- ``"sorted"`` (larger grids): a stable device sort of the codes, and a
  fixed-order reduction of the sorted runs.

Both are deterministic (no float atomics).  On a CPU tensor it runs
:func:`seg_sum_plain`, the plain PyTorch version of the same function.
"""

from __future__ import annotations

import torch

from . import build
from . import pair_sum
from .pair_sum import PRIVATE_CELLS, PRIVATE_PARTIALS

__all__ = ["seg_sum", "seg_sum_plain", "seg_sum_path", "path", "LAUNCHES",
           "PATH_LAUNCHES", "PRIVATE_CELLS", "PRIVATE_PARTIALS",
           "PRIVATE_TILE"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: the same launches by path
PATH_LAUNCHES = {"private": 0, "sorted": 0}
#: records per CTA of the private path: small CTAs, several to an SM
PRIVATE_TILE = 8192


def path(n: int, n_cells: int) -> str:
    """The kernel path a CUDA call over ``n`` records into ``n_cells`` cells
    takes: ``pair_sum.path``'s rule at :data:`PRIVATE_TILE` records a
    CTA."""
    return pair_sum.path(n, n_cells, PRIVATE_TILE)


def seg_sum_plain(code: torch.Tensor, values: torch.Tensor,
                  n_seg: int) -> torch.Tensor:
    """Plain version: accumulate in float64 with ``index_put_``, return
    float32 ``[n_seg, K]``."""
    keep = (code >= 0) & (code < n_seg)
    out = torch.zeros((n_seg, values.shape[1]), dtype=torch.float64,
                      device=values.device)
    out.index_put_((code[keep].long(),), values[keep].double(),
                   accumulate=True)
    return out.float()


def seg_sum(code: torch.Tensor, values: torch.Tensor,
            n_seg: int) -> torch.Tensor:
    """code [N] int32, values [N, K] float32 → [n_seg, K] float32; on the
    card through the path :func:`path` picks."""
    k = values.shape[1] if values.dim() == 2 else 0
    return seg_sum_path(path(code.shape[0], n_seg * k), code, values, n_seg)


def seg_sum_path(name: str, code: torch.Tensor, values: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """:func:`seg_sum` through the named path (``"private"`` or
    ``"sorted"``) whatever :func:`path` would pick, to compare the two on
    the same inputs; a CPU tensor still runs the plain version."""
    global LAUNCHES
    if name not in PATH_LAUNCHES:
        raise ValueError(f"seg_sum: unknown path {name!r}")
    if code.dim() != 1 or values.dim() != 2 or values.shape[0] != code.shape[0]:
        raise ValueError(f"seg_sum: code [N] and values [N, K] expected, got "
                         f"{tuple(code.shape)} and {tuple(values.shape)}")
    if code.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(f"seg_sum: int32 code and float32 values expected, "
                        f"got {code.dtype} and {values.dtype}")
    if code.device != values.device:
        raise ValueError("seg_sum: code and values on different devices")
    n, k = values.shape
    if name == "private" and n_seg * k > PRIVATE_CELLS:
        raise ValueError(f"seg_sum: the private path takes at most "
                         f"{PRIVATE_CELLS} cells, got {n_seg} x {k}")
    if code.device.type == "cpu":
        return seg_sum_plain(code, values, n_seg)
    if code.device.type != "cuda":
        raise ValueError(f"seg_sum: unsupported device {code.device}")
    if not (code.is_contiguous() and values.is_contiguous()):
        raise ValueError("seg_sum: contiguous inputs expected")
    if n == 0 or n_seg == 0 or k == 0:
        return torch.zeros((n_seg, k), dtype=torch.float32,
                           device=code.device)
    out = torch.empty((n_seg, k), dtype=torch.float32, device=code.device)
    lib = build.library()
    dev, stream = code.device.index, build.stream_of(code)
    if name == "private":
        if code.data_ptr() % 16 or values.data_ptr() % 16:
            raise ValueError("seg_sum: the private path's 16-byte loads "
                             "need 16-byte aligned code and values")
        ctas = -(-n // PRIVATE_TILE)
        partial = torch.empty((ctas * n_seg * k,), dtype=torch.float32,
                              device=code.device)
        build.check(lib.pipit_seg_sum_private(
            dev, code.data_ptr(), values.data_ptr(), n, k, n_seg,
            PRIVATE_TILE, partial.data_ptr(), out.data_ptr(), stream),
            "seg_sum (private)")
    else:
        skeys, perm = torch.sort(code, stable=True)
        chunks = -(-n // build.CHUNK)
        partial = torch.empty(((chunks + n_seg) * k,), dtype=torch.float32,
                              device=code.device)
        build.check(lib.pipit_seg_sum(
            dev, skeys.data_ptr(), perm.data_ptr(), values.data_ptr(), n, k,
            n_seg, partial.data_ptr(), out.data_ptr(), stream),
            "seg_sum (sorted)")
    with build.COUNT_LOCK:
        LAUNCHES += 1
        PATH_LAUNCHES[name] += 1
    return out
