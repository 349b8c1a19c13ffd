"""Weighted 2-D scatter-add on the card: the ``comm_matrix`` sender ×
receiver reduction, also ``load_imbalance``'s and the per-process
``flat_profile``'s function × rank sums.

Port of the TPU kernel :mod:`repro.kernels.pair_sum`:
``out[a[i], b[i]] += w[i]``, records with ``a`` or ``b`` outside the output
ignored.  On a CUDA tensor :func:`pair_sum` launches the hand-written
kernels in ``csrc/pair_sum.cu`` on the path :func:`path` picks from the
record count and the grid's size:

- ``"private"`` (up to :data:`PRIVATE_CELLS` cells): per-warp copies of the
  grid in shared memory, summed in a fixed order; no sort;
- ``"sorted"`` (larger grids): flat cell keys, a stable device sort, and a
  fixed-order reduction of the sorted runs.

Both are deterministic.  On a CPU tensor it runs :func:`pair_sum_plain`.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["pair_sum", "pair_sum_plain", "pair_sum_path", "path",
           "LAUNCHES", "PATH_LAUNCHES", "PRIVATE_CELLS", "PRIVATE_TILE"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: the same launches by path
PATH_LAUNCHES = {"private": 0, "sorted": 0}
#: the largest grid the private path takes: a CTA keeps one copy of the
#: grid per warp in 192 KB of the 227 KB of shared memory it may use, and
#: needs eight warps (8 x 6,144 floats) to keep its loads in flight
PRIVATE_CELLS = 6144
#: records per CTA of the private path (csrc/pair_sum.cu, keep in step)
PRIVATE_TILE = 16384
#: the most CTA partials (floats) the private path allocates: 256 MiB
PRIVATE_PARTIALS = 1 << 26


def pair_sum_plain(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                   n_a: int, n_b: int) -> torch.Tensor:
    """Plain version: accumulate in float64 with ``index_put_``, return
    float32 ``[n_a, n_b]``."""
    keep = (a >= 0) & (b >= 0) & (a < n_a) & (b < n_b)
    out = torch.zeros((n_a, n_b), dtype=torch.float64, device=w.device)
    out.index_put_((a[keep].long(), b[keep].long()), w[keep].double(),
                   accumulate=True)
    return out.float()


def path(n: int, n_cells: int, tile: int = PRIVATE_TILE) -> str:
    """The kernel path a CUDA call over ``n`` records into ``n_cells`` cells
    takes: ``"private"`` when the grid fits the per-warp shared-memory
    copies and its per-CTA partials (one row of ``n_cells`` floats per
    ``tile`` records, :data:`PRIVATE_TILE` here) stay under
    :data:`PRIVATE_PARTIALS`; else ``"sorted"``.  ``seg_sum`` and
    ``time_bin`` pick by the same rule at their own tiles."""
    ctas = -(-n // tile)
    if n_cells <= PRIVATE_CELLS and ctas * n_cells <= PRIVATE_PARTIALS:
        return "private"
    return "sorted"


def pair_sum(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, n_a: int,
             n_b: int) -> torch.Tensor:
    """a, b [N] int32, w [N] float32 → [n_a, n_b] float32; on the card
    through the path :func:`path` picks."""
    return pair_sum_path(path(a.shape[0], n_a * n_b), a, b, w, n_a, n_b)


def pair_sum_path(name: str, a: torch.Tensor, b: torch.Tensor,
                  w: torch.Tensor, n_a: int, n_b: int) -> torch.Tensor:
    """:func:`pair_sum` through the named path (``"private"`` or
    ``"sorted"``) whatever :func:`path` would pick, to compare the two on
    the same inputs; a CPU tensor still runs the plain version."""
    global LAUNCHES
    if name not in PATH_LAUNCHES:
        raise ValueError(f"pair_sum: unknown path {name!r}")
    if not (a.dim() == b.dim() == w.dim() == 1
            and a.shape == b.shape == w.shape):
        raise ValueError(f"pair_sum: a, b, w of one shape [N] expected, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(w.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 \
            or w.dtype != torch.float32:
        raise TypeError(f"pair_sum: int32 a, b and float32 w expected, got "
                        f"{a.dtype}, {b.dtype}, {w.dtype}")
    if not (a.device == b.device == w.device):
        raise ValueError("pair_sum: inputs on different devices")
    n_cells = n_a * n_b
    if name == "private" and n_cells > PRIVATE_CELLS:
        raise ValueError(f"pair_sum: the private path takes at most "
                         f"{PRIVATE_CELLS} cells, got {n_a} x {n_b}")
    if a.device.type == "cpu":
        return pair_sum_plain(a, b, w, n_a, n_b)
    if a.device.type != "cuda":
        raise ValueError(f"pair_sum: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous() and w.is_contiguous()):
        raise ValueError("pair_sum: contiguous inputs expected")
    if n_cells >= 2 ** 31:
        raise ValueError(f"pair_sum: {n_a} x {n_b} output exceeds the "
                         f"kernel's 32-bit cell keys")
    n = a.shape[0]
    if n == 0 or n_cells == 0:
        return torch.zeros((n_a, n_b), dtype=torch.float32, device=a.device)
    out = torch.empty((n_a, n_b), dtype=torch.float32, device=a.device)
    lib = build.library()
    dev, stream = a.device.index, build.stream_of(a)
    if name == "private":
        if any(x.data_ptr() % 16 for x in (a, b, w)):
            raise ValueError("pair_sum: the private path's 16-byte loads "
                             "need 16-byte aligned a, b, w")
        ctas = -(-n // PRIVATE_TILE)
        partial = torch.empty((ctas * n_cells,), dtype=torch.float32,
                              device=a.device)
        build.check(lib.pipit_pair_sum_private(
            dev, a.data_ptr(), b.data_ptr(), w.data_ptr(), n, n_a, n_b,
            partial.data_ptr(), out.data_ptr(), stream), "pair_sum (private)")
    else:
        keys = torch.empty((n,), dtype=torch.int32, device=a.device)
        build.check(lib.pipit_pair_keys(dev, a.data_ptr(), b.data_ptr(), n,
                                        n_a, n_b, keys.data_ptr(), stream),
                    "pair_sum keys")
        skeys, perm = torch.sort(keys, stable=True)
        chunks = -(-n // build.CHUNK)
        partial = torch.empty((chunks + n_cells,), dtype=torch.float32,
                              device=a.device)
        build.check(lib.pipit_pair_sum(dev, skeys.data_ptr(),
                                       perm.data_ptr(), w.data_ptr(), n,
                                       n_cells, partial.data_ptr(),
                                       out.data_ptr(), stream),
                    "pair_sum (sorted)")
    with build.COUNT_LOCK:
        LAUNCHES += 1
        PATH_LAUNCHES[name] += 1
    return out
