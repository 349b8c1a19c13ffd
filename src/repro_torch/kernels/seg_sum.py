"""Segment sum on the card: the ``flat_profile`` reduction.

Port of the TPU kernel :mod:`repro.kernels.seg_sum`:
``out[code[i], :] += values[i, :]``, codes outside ``[0, n_seg)`` ignored.
On a CUDA tensor :func:`seg_sum` stably sorts the codes on the device and
launches the hand-written kernel in ``csrc/seg_sum.cu`` (two fixed-order
passes, no float atomics — see the note in that file); on a CPU tensor it
runs :func:`seg_sum_plain`, the plain PyTorch version of the same function.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["seg_sum", "seg_sum_plain", "LAUNCHES"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0


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
    """code [N] int32, values [N, K] float32 → [n_seg, K] float32."""
    global LAUNCHES
    if code.dim() != 1 or values.dim() != 2 or values.shape[0] != code.shape[0]:
        raise ValueError(f"seg_sum: code [N] and values [N, K] expected, got "
                         f"{tuple(code.shape)} and {tuple(values.shape)}")
    if code.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(f"seg_sum: int32 code and float32 values expected, "
                        f"got {code.dtype} and {values.dtype}")
    if code.device != values.device:
        raise ValueError("seg_sum: code and values on different devices")
    if code.device.type == "cpu":
        return seg_sum_plain(code, values, n_seg)
    if code.device.type != "cuda":
        raise ValueError(f"seg_sum: unsupported device {code.device}")
    if not (code.is_contiguous() and values.is_contiguous()):
        raise ValueError("seg_sum: contiguous inputs expected")
    n, k = values.shape
    out = torch.zeros((n_seg, k), dtype=torch.float32, device=code.device)
    if n == 0 or n_seg == 0 or k == 0:
        return out
    skeys, perm = torch.sort(code, stable=True)
    chunks = -(-n // build.CHUNK)
    partial = torch.empty(((chunks + n_seg) * k,), dtype=torch.float32,
                          device=code.device)
    lib = build.library()
    build.check(lib.pipit_seg_sum(
        code.device.index or 0, skeys.data_ptr(), perm.data_ptr(),
        values.data_ptr(), n, k, n_seg, partial.data_ptr(), out.data_ptr(),
        build.stream_of(code)), "seg_sum")
    LAUNCHES += 1
    return out
