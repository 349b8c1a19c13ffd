"""Communication ops on the card: ``comm_matrix`` and
``message_histogram`` (paper §IV-C).

Mirrors the kernel paths of :mod:`repro.core.ops_comm`
(``_comm_matrix_pallas``, ``_message_histogram_pallas``) with their
``_wrap_partners`` and ``_hist_indices`` rules: send records go through
the ``pair_sum`` kernel in canonical order, and exact host-computed bin
indices through the ``hist_bin`` kernel, on ``device`` — the card by
default, the kernels' plain versions with ``device="cpu"``.  Their
streaming forms (the reference's ``backend="pallas"`` branch of
``_CommMatrixAgg`` and ``_MessageHistogramAgg``) buffer the send records
and make the same one kernel call at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import accel
from .constants import MPI_SEND, MSG_SIZE, NAME, PARTNER, PROC, TS
from .frame import EventFrame
from .registry import register_op, register_streaming
from .streaming import StreamAgg

__all__ = ["comm_matrix", "message_histogram"]


def _sends(ev: EventFrame, output: str = "size"):
    """(sender, partner, weight, timestamp) of a frame's send instants, or
    None when it has none.  The weight is the message bytes (NaN as 0) for
    ``output="size"``, else 1."""
    if PARTNER not in ev:
        return None
    sel = ev.cat(NAME).mask_eq(MPI_SEND)
    if not sel.any():
        return None
    w = (np.nan_to_num(np.asarray(ev[MSG_SIZE], np.float64)[sel])
         if output == "size" else np.ones(int(sel.sum())))
    return (np.asarray(ev[PROC], np.int64)[sel],
            np.asarray(ev[PARTNER], np.int64)[sel], w,
            np.asarray(ev[TS], np.float64)[sel])


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


def _matrix(sends, n: int, op: str, device) -> np.ndarray:
    """The ``pair_sum`` kernel over canonically ordered send records."""
    if sends is None or n == 0:
        return np.zeros((n, n))
    src, dst, w, ts = sends
    dst = _wrap_partners(src, dst, n, op)
    o = accel.canonical_order(ts, ts, src, dst, w)
    return accel.pair_sum(src[o], dst[o], w[o], n, n, device=device)


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
    return _matrix(_sends(trace.events, output), trace.num_processes,
                   "comm_matrix", device)


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
    s = _sends(trace.events)
    return _histogram(None if s is None else s[2], bins, device)


def _histogram(sizes, bins: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """``np.histogram``'s edges over ``sizes`` and its counts by the
    ``hist_bin`` kernel."""
    if sizes is None:
        return np.zeros(bins, np.int64), np.linspace(0, 1, bins + 1)
    edges = np.histogram_bin_edges(sizes, bins=bins)
    return (accel.hist_counts(_hist_indices(sizes, edges, bins), bins,
                              device=device), edges)


# ---------------------------------------------------------------------------
# streaming forms: buffer the send records, one kernel call in result()
# ---------------------------------------------------------------------------

class _SendsAgg(StreamAgg):
    """Send records of every chunk, kept for one kernel call at the end."""

    def __init__(self, output: str, device):
        self.output = output
        self.device = device
        self._parts = []

    def update(self, chunk) -> None:
        s = _sends(chunk.events, self.output)
        if s is not None:
            self._parts.append(s)

    def sends(self):
        """(sender, partner, weight, timestamp) over the stream, or None."""
        if not self._parts:
            return None
        return tuple(np.concatenate(c) for c in zip(*self._parts))


@register_streaming("comm_matrix")
class _CommMatrixAgg(_SendsAgg):
    """Streaming comm matrix: the in-memory op's one ``pair_sum`` call on
    the stream's send records."""

    def __init__(self, output: str = "size", device="cuda"):
        super().__init__(output, device)

    def result(self, ctx) -> np.ndarray:
        return _matrix(self.sends(), ctx.num_processes,
                       "streaming comm_matrix", self.device)


@register_streaming("message_histogram")
class _MessageHistogramAgg(_SendsAgg):
    """Streaming message histogram: the in-memory op's edges and one
    ``hist_bin`` call over the stream's message sizes."""

    def __init__(self, bins: int = 10, device="cuda"):
        super().__init__("size", device)
        self.bins = bins

    def result(self, ctx) -> Tuple[np.ndarray, np.ndarray]:
        s = self.sends()
        return _histogram(None if s is None else s[2], self.bins,
                          self.device)
