"""Weighted 2-D scatter-add on the card: the ``comm_matrix`` sender ×
receiver reduction, also ``load_imbalance``'s and the per-process
``flat_profile``'s function × rank sums.

Port of the TPU kernel :mod:`repro.kernels.pair_sum`:
``out[a[i], b[i]] += w[i]``, records with ``a`` or ``b`` outside the output
ignored.  On a CUDA tensor :func:`pair_sum` forms flat cell keys with a
small kernel, stably sorts them on the device and reduces the sorted runs
with the hand-written kernel in ``csrc/pair_sum.cu``; on a CPU tensor it
runs :func:`pair_sum_plain`.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["pair_sum", "pair_sum_plain", "LAUNCHES"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0


def pair_sum_plain(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                   n_a: int, n_b: int) -> torch.Tensor:
    """Plain version: accumulate in float64 with ``index_put_``, return
    float32 ``[n_a, n_b]``."""
    keep = (a >= 0) & (b >= 0) & (a < n_a) & (b < n_b)
    out = torch.zeros((n_a, n_b), dtype=torch.float64, device=w.device)
    out.index_put_((a[keep].long(), b[keep].long()), w[keep].double(),
                   accumulate=True)
    return out.float()


def pair_sum(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, n_a: int,
             n_b: int) -> torch.Tensor:
    """a, b [N] int32, w [N] float32 → [n_a, n_b] float32."""
    global LAUNCHES
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
    if a.device.type == "cpu":
        return pair_sum_plain(a, b, w, n_a, n_b)
    if a.device.type != "cuda":
        raise ValueError(f"pair_sum: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous() and w.is_contiguous()):
        raise ValueError("pair_sum: contiguous inputs expected")
    n_cells = n_a * n_b
    if n_cells >= 2 ** 31:
        raise ValueError(f"pair_sum: {n_a} x {n_b} output exceeds the "
                         f"kernel's 32-bit cell keys")
    out = torch.zeros((n_a, n_b), dtype=torch.float32, device=a.device)
    n = a.shape[0]
    if n == 0 or n_cells == 0:
        return out
    lib = build.library()
    dev, stream = a.device.index or 0, build.stream_of(a)
    keys = torch.empty((n,), dtype=torch.int32, device=a.device)
    build.check(lib.pipit_pair_keys(dev, a.data_ptr(), b.data_ptr(), n, n_a,
                                    n_b, keys.data_ptr(), stream),
                "pair_sum keys")
    skeys, perm = torch.sort(keys, stable=True)
    chunks = -(-n // build.CHUNK)
    partial = torch.empty((chunks + n_cells,), dtype=torch.float32,
                          device=a.device)
    build.check(lib.pipit_pair_sum(dev, skeys.data_ptr(), perm.data_ptr(),
                                   w.data_ptr(), n, n_cells,
                                   partial.data_ptr(), out.data_ptr(),
                                   stream), "pair_sum")
    LAUNCHES += 1
    return out
