"""Communication ops on the card: ``comm_matrix`` and
``message_histogram`` (paper §IV-C).

Mirrors the kernel paths of :mod:`repro.core.ops_comm`
(``_comm_matrix_pallas``, ``_message_histogram_pallas``) with their
``_wrap_partners`` and ``_hist_indices`` rules: send records go through
the ``pair_sum`` kernel in canonical order, and exact host-computed bin
indices through the ``hist_bin`` kernel, on ``device`` — the card by
default, the kernels' plain versions with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import accel
from .constants import MPI_SEND, MSG_SIZE, NAME, PARTNER, PROC, TS
from .frame import EventFrame
from .registry import register_op

__all__ = ["comm_matrix", "message_histogram"]


def _sends(trace) -> EventFrame:
    ev = trace.events
    if PARTNER not in ev:
        return EventFrame({TS: np.asarray([], np.int64)})
    return ev.mask(ev.cat(NAME).mask_eq(MPI_SEND))


def _wrap_partners(src, dst, n: int, op: str):
    """Negative partner ids wrap like numpy fancy indexing (``-1`` is the
    last process); out-of-range ids raise the same IndexError the
    reference raises instead of silently dropping."""
    if len(dst) and (int(src.max()) >= n or int(dst.max()) >= n
                     or int(src.min()) < 0 or int(dst.min()) < -n):
        raise IndexError(
            f"{op}: message endpoints outside the selected trace's "
            f"0..{n - 1} process range")
    return np.where(dst < 0, dst + n, dst)


@register_op("comm_matrix", needs_messages=True)
def comm_matrix(trace, output: str = "size", device="cuda") -> np.ndarray:
    """Process-to-process communication matrix (§IV-C, Fig. 3): every send
    instant aggregated by (sender, receiver) in the ``pair_sum`` kernel.

    Args:
        output: ``"size"`` (default) sums message bytes; any other value
            counts messages.
        device: where the kernel runs (``"cuda"`` or ``"cpu"``).

    Returns:
        ``(nprocs, nprocs)`` float array; ``M[i, j]`` is the bytes (or
        number of messages) process i sent to process j.
    """
    s = _sends(trace)
    n = trace.num_processes
    if len(s) == 0 or n == 0:
        return np.zeros((n, n))
    src = np.asarray(s[PROC], np.int64)
    dst = np.asarray(s[PARTNER], np.int64)
    w = np.nan_to_num(np.asarray(s[MSG_SIZE], np.float64)) \
        if output == "size" else np.ones(len(s))
    dst = _wrap_partners(src, dst, n, "comm_matrix")
    ts = np.asarray(s[TS], np.float64)
    o = accel.canonical_order(ts, ts, src, dst, w)
    return accel.pair_sum(src[o], dst[o], w[o], n, n, device=device)


def _hist_indices(sizes: np.ndarray, edges: np.ndarray,
                  bins: int) -> np.ndarray:
    """Exact ``np.histogram`` bin assignment: half-open bins with the last
    bin closed — ``searchsorted(side="right") - 1`` over the edge array,
    clipped so the top edge lands in the final bin."""
    return np.clip(np.searchsorted(edges, sizes, side="right") - 1,
                   0, bins - 1)


@register_op("message_histogram")
def message_histogram(trace, bins: int = 10, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Distribution of message sizes (§IV-C, Fig. 4): exact host-side bin
    indices counted by the ``hist_bin`` kernel, so the counts equal
    ``np.histogram``'s.

    Returns:
        ``(counts, edges)`` à la ``np.histogram``.
    """
    s = _sends(trace)
    if len(s) == 0:
        return np.zeros(bins, np.int64), np.linspace(0, 1, bins + 1)
    sizes = np.nan_to_num(np.asarray(s[MSG_SIZE], np.float64))
    edges = np.histogram_bin_edges(sizes, bins=bins)
    return (accel.hist_counts(_hist_indices(sizes, edges, bins), bins,
                              device=device), edges)
